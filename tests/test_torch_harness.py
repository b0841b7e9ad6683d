"""The CUDA kernels' device code, built for the CPU by
euclider_tpu_torch/tools/kernel_harness.py (g++ under the stand-ins of
tools/cuda_stub/), against the plain versions: the forward kernel's body
against ops/trace.py and pixel_backward against ops/vjp.py, on scenes of
each build (straight, BUILD_SHAPES, the march and the expression VM).
Without contraction the device code rounds as the plain version's separate
torch operations do, so the forward matches it to the last bit here.
"""
import shutil

import pytest

from euclider_tpu_torch.scene import ir
from euclider_tpu_torch.tools import kernel_harness as KH


@pytest.fixture(scope="module")
def harness():
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    KH.build()
    return KH


@pytest.mark.parametrize("name, H, W", [("config3_csg_textured", 48, 64),
                                        ("perlin_probe", 48, 64),
                                        ("config2_mirror_glass", 24, 32),
                                        ("config6_expr_space", 24, 32)])
def test_device_code_matches_plain(harness, name, H, W):
    """Forward exact; every leaf's gradient (texels, camera and time
    included) within 1e-3 * max(max |ref|, 1) under a seeded cotangent."""
    out = harness.compare(name, H, W)
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
