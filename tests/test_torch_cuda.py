"""The CUDA kernel (csrc/trace_fwd.cu) against its plain torch version.

The card tests carry the ``cuda`` marker and skip without a CUDA device.
This file imports neither jax nor the JAX package, so on the card (which has
no jax) it runs on its own:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

chip_smoke.py makes the same comparison at 1280x720.
"""
from dataclasses import replace

import pytest
import torch

import euclider_tpu_torch as ett
from euclider_tpu_torch.ops import cuda_kernel, trace

# 16 rows x 256 columns: ragged against the kernel's 32x8 blocks on neither
# axis; the slab cases below are ragged on both
H, W = 16, 256


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def scene_on(name, device, **settings):
    sc = ett.get_scene(name)
    if settings:
        sc = replace(sc, settings=replace(sc.settings, **settings))
    static, tables = ett.compile_scene(sc)
    return (static, ett.tables_to_torch(tables, device),
            ett.camera_to_torch(ett.compile_camera(sc.camera), device))


def test_encoder_refuses_a_tree_deeper_than_the_stack():
    static, _ = ett.compile_scene(replace(
        ett.get_scene("config2_mirror_glass"),
        settings=replace(ett.get_scene("config2_mirror_glass").settings,
                         max_depth=cuda_kernel.MAX_SLOTS)))
    with pytest.raises(ValueError, match="stack slots"):
        cuda_kernel.encode_scene(static)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["config1_sphere_room",
                                  "config2_mirror_glass",
                                  "config4_hypersphere"])
def test_kernel_matches_plain(cuda, name):
    static, tables, cam = scene_on(name, cuda)
    before = cuda_kernel.LAUNCHES
    got = cuda_kernel.render_image_cuda(static, tables, cam, H, W)
    ref = trace.render_image(static, tables, cam, H, W)
    torch.cuda.synchronize()
    assert cuda_kernel.LAUNCHES == before + 1
    assert got.shape == (H, W, 3) and bool(torch.isfinite(got).all())
    # FMA contraction in the kernel moves a few edge pixels (tolerance of
    # chip_smoke.py: 99.9% of pixels within 1e-4)
    bad = ((got - ref).abs().amax(dim=-1) > 1e-4).float().mean()
    assert float(bad) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("y0, rows", [(0, 5), (5, 7), (9, 7)])
def test_kernel_row_slab(cuda, y0, rows):
    static, tables, cam = scene_on("config2_mirror_glass", cuda)
    full = cuda_kernel.render_image_cuda(static, tables, cam, H, W - 3)
    slab = cuda_kernel.render_image_cuda(static, tables, cam, H, W - 3,
                                         y0=y0, rows=rows)
    assert slab.shape == (rows, W - 3, 3)
    torch.testing.assert_close(slab, full[y0:y0 + rows], rtol=0, atol=0)


@pytest.mark.cuda
def test_kernel_depth_cap(cuda):
    """A truncated tree (max_nodes below the full tree) is cut exactly where
    the plain version cuts it."""
    static, tables, cam = scene_on("config2_mirror_glass", cuda, max_nodes=5)
    got = cuda_kernel.render_image_cuda(static, tables, cam, H, W)
    ref = trace.render_image(static, tables, cam, H, W)
    bad = ((got - ref).abs().amax(dim=-1) > 1e-4).float().mean()
    assert float(bad) <= 1e-3
