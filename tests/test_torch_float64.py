"""The port's float64 plain path (the JAX package's x64 render,
tests/test_float64.py): tables and camera cast to float64
(``cast_tables``, ``cast_camera``, ``tables_to_torch(..., dtype=
torch.float64)``) render in float64 and closer to the float64 oracle than
the float32 render.  Torch has no global x64 flag, so no subprocess.
"""
import numpy as np
import torch

import euclider_tpu_torch as ett
from euclider_tpu_torch.oracle.cpu_oracle import render_oracle
from euclider_tpu_torch.ops.cuda_kernel import FLOAT_FIELDS, _check_tables
from euclider_tpu_torch.ops.trace import render_image, render_rays

H, W = 12, 20


def _f64(name):
    sc = ett.get_scene(name)
    static, tables = ett.compile_scene(sc)
    cam = ett.compile_camera(sc.camera)
    t64 = ett.tables_to_torch(ett.cast_tables(tables, np.float64), "cpu",
                              torch.float64)
    c64 = ett.camera_to_torch(ett.cast_camera(cam, np.float64), "cpu",
                              torch.float64)
    return static, tables, cam, t64, c64


def test_render_float64_against_the_oracle():
    # grad_probe: smooth UV-dependent colours and reflections, so pixel
    # values involve real arithmetic
    static, tables, cam, t64, c64 = _f64("grad_probe")
    img64 = render_image(static, t64, c64, H, W)
    assert img64.dtype == torch.float64 and img64.shape == (H, W, 3)
    gold = render_oracle(static, tables, cam, H, W)
    err64 = np.abs(img64.numpy() - gold).max()
    assert err64 < 1e-6, f"f64 err {err64}"
    img32 = render_image(static, ett.tables_to_torch(tables, "cpu"),
                         ett.camera_to_torch(cam, "cpu"), H, W)
    assert img32.dtype == torch.float32
    err32 = np.abs(img32.numpy().astype(np.float64) - gold).max()
    assert err64 < err32, (err64, err32)   # doubling precision must help


def test_render_rays_and_time_follow_the_tables_dtype():
    """The pixel grid of render_rays and an expression scene's time (and
    its constants) are float64 with float64 tables: the rays equal the
    frame's pixels."""
    static, _, _, t64, c64 = _f64("config6_expr_space")
    img = render_image(static, t64, c64, 4, 6, time=0.3)
    assert img.dtype == torch.float64
    yi, xi = np.meshgrid(np.arange(4.0), np.arange(6.0), indexing="ij")
    r, g, b = render_rays(static, t64, c64, xi, yi, 6, 4, time=0.3)
    assert r.dtype == torch.float64
    assert torch.equal(torch.stack([r, g, b], dim=-1), img)


def test_cast_helpers_are_exported_and_the_kernels_stay_float32():
    """The kernels compute in float32: their wrappers cast float64 tables
    and textures to float32 (the bits of the same tables cast), as the
    Pallas kernel does, and the float tables they read stay float32."""
    static, tables, _, t64, c64 = _f64("config3_csg_textured")
    assert ett.cast_tables(tables, np.float64).shape_vec.dtype == np.float64
    assert all(v.dtype == torch.float64 for v in c64)
    floats = _check_tables(static, t64, t64.surf_color.device)
    t32 = ett.tables_to_torch(tables, "cpu")
    assert all(f.dtype == torch.float32 for f in floats)
    for f, k in zip(floats, FLOAT_FIELDS):
        assert torch.equal(f, getattr(t64, k).to(torch.float32)), k
        assert torch.equal(f, getattr(t32, k)), k
    assert torch.equal(floats[-1], t32.textures[0].reshape(-1))
