"""The torch port's plain render (ops/trace.py) against the JAX package.

The plain version is what the CUDA kernel is held against on the card, so
it is held here against every reference the JAX package trusts: the lax
render, the Pallas megakernel itself (interpret mode, as
tests/test_pallas_parity.py runs it), and the committed goldens.  The lax
renders are stored (tests/jax_refs.py); config1's is re-derived live.
"""
import os

import numpy as np
import pytest
import torch

import euclider_tpu as et
from euclider_tpu.ops.pallas_kernel import render_image_pallas

import euclider_tpu_torch as ett
from euclider_tpu_torch.ops import cuda_kernel, trace
from euclider_tpu_torch.oracle.native_oracle import render_native
from euclider_tpu_torch.utils.validate import assert_oracle_match

import jax_refs
from conftest import assert_images_close

H, W = 16, 128   # the jit shapes of tests/test_pallas_parity.py
GOLDENS = os.path.join(os.path.dirname(__file__), "goldens.npz")
SLICE = ("config1_sphere_room", "config2_mirror_glass", "grad_probe",
         "fresnel_probe")
OLD_TEX_SIDE = 16384   # texels a side the CUDA kernels once took at most


def port_inputs(compiled_scenes, name):
    """The JAX package's compiled scene, carried onto the CPU for torch."""
    _, static, tables, cam = compiled_scenes[name]
    return (static, ett.tables_to_torch(tables, "cpu"),
            ett.camera_to_torch(cam, "cpu"))


@jax_refs.stored("trace.lax", SLICE)
def lax_ref(name):
    """The jit'd lax render of the library scene at H x W."""
    sc = et.get_scene(name)
    static, tables = et.compile_scene(sc)
    cam = et.compile_camera(sc.camera)
    return ({"scene": sc, "H": H, "W": W},
            lambda: {"rgb": et.render_image_jit(static, tables, cam, H, W)})


@pytest.mark.parametrize("name", SLICE)
def test_plain_matches_lax(compiled_scenes, name):
    ref = lax_ref.load(name)["rgb"]
    got = trace.render_image(*port_inputs(compiled_scenes, name), H, W)
    assert got.shape == (H, W, 3) and got.dtype == torch.float32
    # rsqrt and fused products may differ by an ulp between XLA and torch,
    # which can flip a silhouette pixel: allow 0.2% of pixels
    assert_images_close(ref, got.numpy(), atol=1e-5, max_bad_frac=0.002,
                        msg=f"torch-vs-lax {name}")


def test_lax_reference_is_the_jax_render():
    """The stored lax render is the JAX package's, to the bit (the cheapest
    case)."""
    jax_refs.assert_live_is_stored(lax_ref, "config1_sphere_room")


def test_plain_matches_pallas_kernel(compiled_scenes):
    name = "config1_sphere_room"
    _, static, tables, cam = compiled_scenes[name]
    ref = np.asarray(render_image_pallas(
        static, tables, cam, H, W, (8, 128), "while", True))
    got = trace.render_image(*port_inputs(compiled_scenes, name), H, W)
    assert_images_close(ref, got.numpy(), atol=1e-5,
                        msg=f"torch-vs-pallas {name}")


@pytest.mark.parametrize("name", SLICE)
def test_plain_matches_golden(compiled_scenes, name):
    gold = np.load(GOLDENS)[name]
    got = trace.render_image(*port_inputs(compiled_scenes, name), 48, 64)
    err = np.abs(got.numpy() - gold).max(axis=-1)
    bad = (err > 2e-3).mean()
    assert bad <= 0.01, (f"{name}: {bad:.4f} of pixels beyond 2e-3 from the "
                         f"golden (max {err.max():.2e})")


@pytest.mark.parametrize("name", SLICE)
def test_plain_passes_oracle_gate(compiled_scenes, name):
    """The port's own oracle wrapper: it renders the goldens from torch
    tables, and the plain version passes its gate."""
    inputs = port_inputs(compiled_scenes, name)
    gold = np.load(GOLDENS)[name]
    assert np.abs(render_native(*inputs, 48, 64) - gold).max() <= 1e-6
    assert assert_oracle_match(*inputs, trace.render_image, h=48, w=128,
                               label=name) >= 0.99


@pytest.mark.parametrize("y0, rows", [(0, 5), (5, 7), (12, 4)])
def test_row_slab_matches_full_frame(compiled_scenes, y0, rows):
    inputs = port_inputs(compiled_scenes, "config2_mirror_glass")
    full = trace.render_image(*inputs, H, W)
    slab = trace.render_image(*inputs, H, W, y0=y0, rows=rows)
    assert slab.shape == (rows, W, 3)
    torch.testing.assert_close(slab, full[y0:y0 + rows], rtol=0, atol=0)


def beyond_limits(compiled_scenes, name):
    """A library scene grown past one of the CUDA kernels' limits:
    config3's blob a union of 32 spheres (one node more than the default
    build's membership bits hold), perlin_probe's terrain textured by a
    texture one texel wider than the 16,384 a side the kernels once took.
    -> (static, torch tables, camera)."""
    from dataclasses import replace
    from euclider_tpu.scene import ir
    sc = compiled_scenes[name][0]
    if name == "config3_csg_textured":
        blob = ir.Csg("union", tuple(
            ir.Sphere((0.04 * i, -0.1, -4.6), 0.3)
            for i in range(cuda_kernel.CAPACITIES["nodes"][0])))
        ents = tuple(replace(e, shape=blob) if e.name == "blob" else e
                     for e in sc.entities)
        sc = replace(sc, entities=ents)
    else:
        tex = np.full((2, OLD_TEX_SIDE + 1, 3), 0.5, np.float32)
        ents = tuple(replace(e, surface=ir.TextureSurface(texture_id=0))
                     if e.name == "terrain" else e for e in sc.entities)
        sc = replace(sc, entities=ents, textures=(tex.tolist(),))
    static, tables = et.compile_scene(sc)
    return (static, ett.tables_to_torch(tables, "cpu"),
            ett.camera_to_torch(et.compile_camera(sc.camera), "cpu"))


@pytest.mark.parametrize("name", ["config3_csg_textured", "perlin_probe"])
def test_cuda_encoder_refuses_unsupported_features(compiled_scenes, name):
    """The kernels render every feature of the library scenes, and refuse
    neither of these scenes, each once refused.  An entity of more shape
    nodes than the default build's membership bits encodes and takes the
    builds of 64; a texture past 16,384 texels on a side goes into the
    texel buffer whole, in the default build.  The plain version renders
    both."""
    static, tables, cam = beyond_limits(compiled_scenes, name)
    cuda_kernel.encode_scene(compiled_scenes[name][1])   # the scene itself
    if name == "config3_csg_textured":
        cuda_kernel.encode_scene(static)
        assert cuda_kernel.capacities(static) == (("nodes", 64),)
        assert cuda_kernel.library("trace_fwd", static) == \
            "trace_fwd_shapes+nodes64"
    else:
        cuda_kernel.encode_scene(static)
        assert cuda_kernel.capacities(static) == ()
        buf = cuda_kernel._check_tables(static, tables,
                                        torch.device("cpu"))[-1]
        assert buf.dtype == torch.float32
        assert torch.equal(buf, tables.textures[0].reshape(-1))
    img = trace.render_image(static, tables, cam, 8, 8)
    assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())
