"""Warped space and portals in the torch port against the JAX package.

The march's pieces (ops/march.py: warp_accel, one step, the bisection
finish), the plain render of config5 and config7 (ops/trace.py), its
gradients, and the reversible-march probe (ops/probes.py) are held against
their JAX counterparts on seeded inputs.  The plain versions are what the
CUDA kernels (csrc/trace_fwd.cu, csrc/trace_bwd.cu, csrc/probe_rev.cu) are
held against on the card (tests/test_torch_cuda.py, chip_smoke.py).  The
JAX package's lax renders and jax.vjp leaves are stored
(tests/jax_refs.py).
"""
import os
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import euclider_tpu as et
from euclider_tpu.ops import march as jmarch
from euclider_tpu.ops import trace as jtrace
from euclider_tpu.ops.vec import Vec as JVec

import euclider_tpu_torch as ett
from euclider_tpu_torch.ops import march, probes, trace
from euclider_tpu_torch.ops.vec import Vec
from euclider_tpu_torch.ops.vjp import vjp_blocked
from euclider_tpu_torch.oracle.native_oracle import render_native
from euclider_tpu_torch.utils.validate import assert_oracle_match

import jax_refs
from conftest import assert_images_close

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens.npz")
WARP_SCENES = ("config5_warp_portal", "config7_warp4d")
WARP_FIELDS = ("mat_warp_center", "mat_warp_strength", "mat_warp_step",
               "portal_lin", "portal_tr")


def port_inputs(compiled_scenes, name):
    _, static, tables, cam = compiled_scenes[name]
    return (static, ett.tables_to_torch(tables, "cpu"),
            ett.camera_to_torch(cam, "cpu"))


def seeded_rays(seed, n, center, spread):
    """n seeded points around ``center`` (4-vector) and unit directions,
    as numpy [4, n] arrays."""
    rng = np.random.default_rng(seed)
    x = (np.asarray(center, np.float32)[:, None]
         + rng.uniform(-spread, spread, size=(4, n)).astype(np.float32))
    d = rng.normal(size=(4, n)).astype(np.float32)
    x[3] = 0.0
    d[3] = 0.0
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return x, d


def jvec(a):
    return JVec(*(jnp.asarray(c) for c in a))


def tvec(a):
    return Vec(*(torch.from_numpy(np.ascontiguousarray(c)) for c in a))


def carry_arrays(carry):
    """A march carry's leaves as numpy arrays (bools as bools)."""
    x, v, done, sx0, sx1, sv, sides, crossed, dist = carry
    out = [np.asarray(c) for vec in (x, v, sx0, sx1, sv) for c in vec]
    out += [np.asarray(done).astype(bool), np.asarray(dist)]
    out += [np.asarray(s).astype(bool) for s in sides + crossed]
    return out


def config5_jax_and_port(compiled_scenes):
    _, static, tables, _ = compiled_scenes["config5_warp_portal"]
    return (static, jax.tree.map(jnp.asarray, tables),
            ett.tables_to_torch(tables, "cpu"))


def test_warp_accel_matches_jax():
    x, _ = seeded_rays(0, 512, (0.0, 0.2, -5.0, 0.0), 1.6)
    c = np.asarray([0.0, 0.2, -5.0, 0.0], np.float32)
    ref = jmarch.warp_accel(jvec(c), jnp.float32(0.35), jvec(x))
    got = march.warp_accel(Vec(*torch.from_numpy(c)), torch.tensor(0.35),
                           tvec(x))
    for a, b in zip(ref, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-6)


def marching_rays(static, seed):
    """Seeded rays inside config5's warp region, between 0.4 and 1.5 from
    its attractor (closer in, the 1/r^3 field amplifies float32 rounding
    without bound), one in seven of them in the ambient material (they do
    not march) -> (x, d, jax mats, torch mats)."""
    rng = np.random.default_rng(seed)
    x, d = seeded_rays(seed, 256, (0.0, 0.0, 0.0, 0.0), 1.0)
    x = x[:3] / np.linalg.norm(x[:3], axis=0, keepdims=True)
    x = x * rng.uniform(0.4, 1.5, size=256).astype(np.float32)
    x = np.concatenate([x + np.asarray([[0.0], [0.2], [-5.0]], np.float32),
                        np.zeros((1, 256), np.float32)])
    mats = np.full(256, static.entities[0].material, np.int32)
    mats[::7] = static.ambient
    return x, d, jnp.asarray(mats), torch.from_numpy(mats)


def test_march_step_matches_jax(compiled_scenes):
    """One make_march_body step from march_init on seeded rays: every
    carry leaf within 1e-6, every flag equal."""
    static, jt, tt = config5_jax_and_port(compiled_scenes)
    x, d, jm, tm = marching_rays(static, 1)
    jc = jmarch.march_init(static, jt, jvec(x), jvec(d),
                           jtrace.warp_mask(static, jm))
    tc = march.march_init(static, tt, tvec(x), tvec(d),
                          trace.warp_mask(static, tm))
    jc = jmarch.make_march_body(static, jt, jtrace.make_accel(static, jt, jm),
                                jtrace.warp_step(static, jt, jm))(jc)
    tc = march.make_march_body(static, tt, trace.make_accel(static, tt, tm),
                               trace.warp_step(static, tt, tm))(tc)
    for a, b in zip(carry_arrays(jc), carry_arrays(tc)):
        if a.dtype == bool:
            assert np.array_equal(a, b)
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
    assert bool(tc[2].any()) and not bool(tc[2].all())


def test_march_finish_matches_jax(compiled_scenes):
    """march_finish on one carry (60 steps of the port's march, so most
    rays crossed a boundary, handed to both): hit flags and entities equal,
    points, directions, normals and uv within 1e-6."""
    static, jt, tt = config5_jax_and_port(compiled_scenes)
    x, d, jm, tm = marching_rays(static, 2)
    body = march.make_march_body(static, tt, trace.make_accel(static, tt, tm),
                                 trace.warp_step(static, tt, tm))
    carry = march.march_init(static, tt, tvec(x), tvec(d),
                             trace.warp_mask(static, tm))
    for _ in range(60):
        carry = body(carry)
    jcarry = jax.tree.map(lambda t: jnp.asarray(t.numpy()), carry)
    ref = jmarch.march_finish(static, jt, jvec(x), jcarry)
    got = march.march_finish(static, tt, tvec(x), carry)
    hit = np.asarray(ref[0])
    assert hit.mean() > 0.5
    assert np.array_equal(hit, got[0].numpy())
    assert np.array_equal(np.asarray(ref[3])[hit], got[3].numpy()[hit])
    for a, b in zip(list(ref[1]) + list(ref[2]) + list(ref[4]) + [ref[5], ref[6]],
                    list(got[1]) + list(got[2]) + list(got[4]) + [got[5], got[6]]):
        np.testing.assert_allclose(b.numpy()[hit], np.asarray(a)[hit],
                                   rtol=0, atol=1e-6)


@jax_refs.stored("march.lax", WARP_SCENES)
def lax_ref(name):
    """The jit'd lax render of the library scene at 16 x 128."""
    sc = et.get_scene(name)
    static, tables = et.compile_scene(sc)
    cam = et.compile_camera(sc.camera)
    return ({"scene": sc, "H": 16, "W": 128},
            lambda: {"rgb": et.render_image_jit(static, tables, cam, 16,
                                                128)})


@pytest.mark.parametrize("name", WARP_SCENES)
def test_plain_matches_lax(compiled_scenes, name):
    """The rule of tests/test_torch_trace.py at its shapes (16 x 128, the
    jit shape tests/test_pallas_parity.py renders config5 at)."""
    ref = lax_ref.load(name)["rgb"]
    got = trace.render_image(*port_inputs(compiled_scenes, name), 16, 128)
    assert got.shape == (16, 128, 3) and got.dtype == torch.float32
    assert_images_close(ref, got.numpy(), atol=1e-5, max_bad_frac=0.002,
                        msg=f"torch-vs-lax {name}")


@pytest.mark.parametrize("name", WARP_SCENES)
def test_plain_matches_golden(compiled_scenes, name):
    gold = np.load(GOLDENS)[name]
    got = trace.render_image(*port_inputs(compiled_scenes, name), 48, 64)
    err = np.abs(got.numpy() - gold).max(axis=-1)
    bad = (err > 2e-3).mean()
    assert bad <= 0.01, (f"{name}: {bad:.4f} of pixels beyond 2e-3 from the "
                         f"golden (max {err.max():.2e})")


@pytest.mark.parametrize("name", WARP_SCENES)
def test_plain_passes_oracle_gate(compiled_scenes, name):
    inputs = port_inputs(compiled_scenes, name)
    gold = np.load(GOLDENS)[name]
    assert np.abs(render_native(*inputs, 48, 64) - gold).max() <= 1e-6
    assert assert_oracle_match(*inputs, trace.render_image, h=48, w=128,
                               label=name) >= 0.99


def test_tables_to_torch_carries_warp_and_portal_tables(compiled_scenes):
    for name in WARP_SCENES:
        _, _, tables, _ = compiled_scenes[name]
        tt = ett.tables_to_torch(tables, "cpu")
        for k in WARP_FIELDS:
            a, b = np.asarray(getattr(tables, k)), getattr(tt, k)
            assert b.dtype == torch.float32 and b.shape == a.shape
            assert np.array_equal(b.numpy(), a.astype(np.float32)), k
        assert np.abs(np.asarray(tables.mat_warp_strength)).max() > 0
        assert np.abs(np.asarray(tables.portal_tr)).max() > 0


# --- gradients ----------------------------------------------------------------

def warp_gradient_scene(ir, march_steps):
    """tests/test_gradients.py::test_grad_warp_strength's scene: a warp
    sphere in front of a smooth hyperplane wall (uniform and checker
    surfaces give warp gradients that are zero almost everywhere)."""
    region = ir.Entity(ir.Sphere((0, 0, -4), 1.8),
                       material=ir.WarpSpace(center=(0, 0, -4), strength=0.4,
                                             step=0.05),
                       surface=ir.UniformSurface((0, 0, 0, 0.0)))
    wall = ir.Entity(ir.Hyperplane((0, 0, 1), -8.0),
                     surface=ir.SmoothSurface(uv_scale=0.5))
    return ir.Scene(dim=3, entities=(region, wall),
                    settings=ir.RenderSettings(max_depth=3,
                                               march_steps=march_steps,
                                               background=(0.1, 0.1, 0.2)))


def gradient_case(case):
    """(scene, static, numpy tables, numpy camera, H, W), compiled by the
    JAX package, cut to march_steps 23 (test_gradients.py:454-456).  The
    warp scene is also cut to max_nodes 3, which no ray of it exceeds (its
    surfaces reflect nothing: region, march, wall), for the time of the
    op-by-op JAX reverse pass."""
    from euclider_tpu.scene import ir
    if case == "warp_scene":
        sc, (H, W) = warp_gradient_scene(ir, 23), (12, 16)
        sc = replace(sc, settings=replace(sc.settings, max_nodes=3))
    else:
        sc = et.get_scene("config5_warp_portal")
        sc = replace(sc, settings=replace(sc.settings, max_depth=2,
                                          march_steps=23))
        H, W = 16, 24
    static, tables = et.compile_scene(sc)
    return sc, static, tables, et.compile_camera(sc.camera), H, W


def gradient_cotangent(H, W):
    return np.random.default_rng(5).normal(size=(H, W, 3)).astype(np.float32)


@jax_refs.stored("march.vjp", ["warp_scene", "config5"])
def vjp_ref(case):
    """jax.vjp of the lax render (jit disabled, as tests/test_torch_grad.py
    runs it): the leaves by name."""
    sc, static, tables, cam, H, W = gradient_case(case)
    g = gradient_cotangent(H, W)

    def run():
        t32 = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), tables)
        with jax.disable_jit():
            _, vjp = jax.vjp(lambda t, c: et.render_image(static, t, c, H, W,
                                                          True), t32, cam)
            return jax_refs.leaves(*vjp(jnp.asarray(g)))
    return {"scene": sc, "H": H, "W": W, "seed": 5, "cotangent": g}, run


@pytest.mark.parametrize("case", ["warp_scene", "config5"])
def test_vjp_matches_jax(case):
    """The port's autograd VJP against jax.vjp of the lax render (jit
    disabled, as tests/test_torch_grad.py runs it), every leaf within
    1e-3 * max(max |ref|, 1), the warp and portal tables included."""
    _, static, tables, cam, H, W = gradient_case(case)
    g = gradient_cotangent(H, W)
    ref = vjp_ref.load(case)
    gt, gc, _ = vjp_blocked(static, ett.tables_to_torch(tables, "cpu"),
                            ett.camera_to_torch(cam, "cpu"), H, W,
                            torch.from_numpy(g))
    got = jax_refs.leaves(gt, gc)
    assert sorted(ref) == sorted(got)
    for k, b in got.items():
        a, b = np.asarray(ref[k], np.float64), np.asarray(b, np.float64)
        tol = 1e-3 * max(np.abs(a).max(), 1.0)
        assert np.abs(a - b).max() <= tol, (k, np.abs(a - b).max(), tol)
    if case == "warp_scene":
        for k in WARP_FIELDS[:3]:      # the march really gets gradients
            assert np.abs(ref[k]).max() > 1e-3, k


# --- the reversible-march probe -------------------------------------------------

def test_rev_march_plain_matches_jax_probe():
    """rev_march_plain against the VJP of tools/mosaic_probe.py's
    make_rev_march (the custom-VJP reverse sweep by step inversion) inside
    the probe's outer function, accumulated twice as its kernel does."""
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    import mosaic_probe as mp

    x = (np.random.default_rng(7).normal(size=(8, 128)) * 0.8).astype(
        np.float32)
    g = np.random.default_rng(8).normal(size=(8, 128)).astype(np.float32)
    w = 1.1
    rm = mp.make_rev_march()

    def outer(x, w):
        y = rm(w, x * 0.3, x * 0.2 + 0.1)
        return jnp.cos(y) + y * 0.25

    _, vjp = jax.vjp(outer, jnp.asarray(x), jnp.float32(w))
    dx_ref, dw_ref = (2.0 * np.asarray(v) for v in vjp(jnp.asarray(g)))
    assert (mp.R_STEPS, mp.R_CB, mp.R_H) == (probes.R_STEPS, probes.R_CB,
                                             probes.R_H)
    dx, dw = probes.rev_march_vjp(torch.from_numpy(x), w, torch.from_numpy(g))
    np.testing.assert_allclose(dx.numpy(), dx_ref, rtol=0,
                               atol=1e-5 * np.abs(dx_ref).max())
    assert abs(float(dw) - float(dw_ref)) <= 1e-5 * abs(float(dw_ref))
