"""The CUDA kernels' device code, built for the CPU by
euclider_tpu_torch/tools/kernel_harness.py (g++ under the stand-ins of
tools/cuda_stub/), against the plain versions: the forward kernel's body
against ops/trace.py, pixel_backward against ops/vjp.py::vjp_blocked and
the segmented kernels' (K6 over the frame, then K7) against
ops/vjp.py::vjp_segmented, on scenes of each build (straight, BUILD_SHAPES,
the march and the expression VM) and past the tape's 63 nodes, the march's 32 entities and a
thread's 159 gradient entries; the block's sums of the threads' gradient
vectors against float64; the probes' device code
(csrc/probe_mosaic.cu, csrc/probe_rev.cu, csrc/probe_march.cu) against
ops/probes.py and ops/march_probe.py.
Without contraction the device code rounds as the plain version's separate
torch operations do, so the forward matches it to the last bit here.
"""
import shutil
from dataclasses import replace

import numpy as np
import pytest
import torch

from euclider_tpu_torch.ops import march_probe as MP
from euclider_tpu_torch.scene import ir
from euclider_tpu_torch.scene.library import get_scene
from euclider_tpu_torch.tools import kernel_harness as KH
from test_torch_cuda import (config7_smooth, deep_scene, spheres_scene,
                             warp32_scene)


@pytest.fixture(scope="module")
def harness():
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    KH.build()
    return KH


@pytest.mark.parametrize("name, H, W", [("config3_csg_textured", 48, 64),
                                        ("perlin_probe", 48, 64),
                                        ("config2_mirror_glass", 24, 32),
                                        ("config6_expr_space", 24, 32),
                                        ("warp32", 16, 24),
                                        ("config4_hypersphere", 24, 32),
                                        ("config7_warp4d", 36, 64),
                                        ("config7_smooth", 36, 64)])
def test_device_code_matches_plain(harness, name, H, W):
    """Forward exact; every leaf's gradient (texels, camera and time
    included) within 1e-3 * max(max |ref|, 1) under a seeded cotangent.
    warp32 marches at the side table's 32-entity cap (its last entity,
    the side mask's top bit, is crossed by marched rays); config4 and
    config7 are 4D, and config7's rays march at this size (with smooth
    surfaces the warp's parameters get a gradient)."""
    sc = {"warp32": warp32_scene, "config7_smooth": config7_smooth}.get(
        name, lambda: get_scene(name))()
    if name.startswith("config7"):
        from euclider_tpu_torch.scene.compile import (
            camera_to_torch, compile_camera, compile_scene, tables_to_torch)
        from euclider_tpu_torch.tools.march_simt import steps_by_trip
        static, t = compile_scene(sc)
        steps = steps_by_trip(static, tables_to_torch(t, "cpu"),
                              camera_to_torch(compile_camera(sc.camera),
                                              "cpu"), H, W)
        assert int((steps.sum(0) > 0).sum()) > 0, "no pixel marches"
    out = harness.compare(sc, H, W)
    assert out["fwd_bad"] == 0 and out["fwd_max"] <= 1e-6, out
    assert out["bwd_worst"] <= 1.0, out


def test_device_code_of_a_csg_bounded_warp_region(harness):
    """A warp region bounded by a sphere cut by a half-space, before a
    cylinder and a perlin wall: the march's side tests over a composite,
    the leaf it picks by boundary distance, cylinder and perlin adjoints in
    the shapes-and-march build."""
    region = ir.Entity(
        ir.Csg("intersection", (ir.Sphere((0, 0, -4), 1.8),
                                ir.HalfSpace((0, -1, 0), 0.6))),
        material=ir.WarpSpace(center=(0, 0, -4), strength=0.4, step=0.05),
        surface=ir.UniformSurface((0, 0, 0, 0.0)))
    pillar = ir.Entity(ir.Cylinder((1.6, 0.0, -6.0), (0.0, 1.0, 0.0), 0.4),
                       surface=ir.SmoothSurface(uv_scale=1.5))
    wall = ir.Entity(ir.Hyperplane((0, 0, 1), -8.0),
                     surface=ir.PerlinSurface(uv_scale=0.5, octaves=2))
    sc = ir.Scene(dim=3, entities=(region, pillar, wall),
                  settings=ir.RenderSettings(max_depth=3, march_steps=120,
                                             background=(0.1, 0.1, 0.2)))
    out = harness.compare(sc, 24, 32)
    assert out["fwd_bad"] == 0 and out["fwd_max"] <= 1e-5, out
    assert out["bwd_worst"] <= 1.0, out


@pytest.mark.parametrize("name, H, W, chunk_trips", [
    ("config2_mirror_glass", 24, 32, 1), ("config5_warp_portal", 9, 16, 2),
    ("config6_expr_space", 12, 16, 3), ("config2_deep", 12, 16, 16),
    ("config2_mirror_glass", 24, 32, 16), ("config2_mirror_glass", 24, 32, 21),
    ("config2_deep", 12, 16, 63), ("config2_capped", 24, 32, 2)])
def test_segmented_device_code_matches_plain(harness, name, H, W,
                                             chunk_trips):
    """K6 then K7's device code against vjp_segmented at the same chunks:
    boundaries after every trip (config2), in a marching build and in the
    VM build, and a tree past the tape kernel's 63 nodes (config2 at
    max_depth 8 and max_nodes 255 with a smooth floor); chunk_trips 16
    (config2's 62 trips in chunks of 16, 16, 16 and 14), 21 (21, 21 and
    20) and 63, the most a tape holds (config2_deep's 254 trips in 5
    chunks); and
    config2 at max_nodes 6, whose trees the cap cuts, so that the last
    chunk ends with slots on the stack that no trip shades."""
    sc = deep_scene(smooth=True) if name == "config2_deep" else name
    if name == "config2_capped":
        sc = get_scene("config2_mirror_glass")
        sc = replace(sc, settings=replace(sc.settings, max_nodes=6))
    out = harness.compare(sc, H, W, chunk_trips=chunk_trips)
    assert out["fwd_bad"] == 0 and out["fwd_max"] <= 1e-6, out
    assert out["bwd_worst"] <= 1.0, out


def test_device_code_past_the_entity_and_parameter_caps(harness):
    """pixel_backward on 48 entities and 797 parameters (entries from the
    160th on go to the block's partial sums), against vjp_blocked."""
    out = harness.compare(spheres_scene(), 24, 32)
    assert out["fwd_bad"] == 0 and out["fwd_max"] <= 1e-6, out
    assert out["bwd_worst"] <= 1.0, out


@pytest.mark.parametrize("local", [False, True])
@pytest.mark.parametrize("n", [78, 142, 160])
def test_block_sums_match_float64(harness, n, local):
    """The block's sums of 256 threads' gradient vectors (trace_adj.cuh
    block_partials' phases: shared columns, or local vectors through the
    warps' tiles) on a seeded [256 x n] matrix: to the bit the fixed order
    they document, in float32 (each warp's 32 threads in order, then the 8
    warps in order), and within 38 u sum |x| of the float64 sum,
    u = 2^-24: the first-order bound of that order's 31 + 7 rounded
    additions."""
    rng = np.random.default_rng(n + 1000 * local)
    mat = (rng.normal(size=(256, n)) *
           rng.uniform(0.0, 3.0, size=n)).astype(np.float32)
    got = harness.block_sums(torch.from_numpy(mat), local).numpy()
    warps = mat.reshape(8, 32, n)
    order = warps[:, 0]
    for k in range(1, 32):
        order = (order + warps[:, k]).astype(np.float32)
    want = order[0]
    for w in range(1, 8):
        want = (want + order[w]).astype(np.float32)
    assert np.array_equal(got, want)
    ref = mat.astype(np.float64).sum(0)
    bound = 38 * 2.0 ** -24 * np.abs(mat).astype(np.float64).sum(0)
    assert np.all(np.abs(got - ref) <= bound)


def test_mosaic_probe_device_code_matches_plain(harness):
    """probe_mosaic.cu's four kernels on the mosaic tool's tiles (P3 in both
    branches, P5 also dead) against the plain versions: within 1e-5
    relative, P3 within 1e-6."""
    errs = harness.compare_mosaic()
    assert len(errs) == 6, errs
    for name, err in errs.items():
        assert err <= (1e-6 if name.startswith("probe_cond") else 1e-5), errs


def test_rev_probe_device_code_matches_plain(harness):
    """probe_rev.cu's lanes (its reverse sweep by step inversion) on the
    probe's tile, dw summed in the lanes' order, against rev_march_plain:
    dx and dw within 1e-5 relative."""
    errs = harness.compare_rev()
    assert errs["dx"] <= 1e-5 and errs["dw"] <= 1e-5, errs


@pytest.mark.parametrize("tile", ["tool", "crossing"])
@pytest.mark.parametrize("stage", MP.STAGES)
def test_march_probe_device_code_matches_plain(harness, stage, tile):
    """probe_march.cu's stage on the tool's and the crossing tile, its
    tile sum in the kernel's order (march_probe.tile_sum), against
    march_probe_plain: every lane within 1e-5 * max(max |ref|, 1), no lane
    marching otherwise, the crossings reached on the crossing tile and
    none on the tool's."""
    out = harness.compare_march(tile, stage)
    assert out["flipped"] == 0 and out["max_err"] <= out["limit"], out
    crossing = tile == "crossing"
    assert (0.25 <= out["crossed"] < 0.75) if crossing else (
        out["crossed"] == 0.0), out
    assert (out["dsv"] != 0.0) == (crossing and stage in ("vjp", "finish")), out


def test_march_probe_rebuild_matches_the_stored_tape(harness):
    """The vjp stage (K4's rebuild) against the finish stage (a stored tape
    of every step's state) on the crossing tile: within 1e-5 relative."""
    static, tables = MP.probe_scene()
    org, d = MP.crossing_tile()
    a = harness.march_probe(static, tables, org, d, "vjp")
    b = harness.march_probe(static, tables, org, d, "finish")
    assert float((a.out - b.out).abs().max()) <= 1e-5 * float(
        b.out.abs().max())
