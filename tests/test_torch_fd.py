"""The port's gradients against finite differences of its float64 oracle,
and the march step's analytic inverse: the port of
tests/test_gradients.py's oracle cases (:64-127) and of its
``test_march_step_analytic_inverse``.

The JVP d(img)/d(theta) of the port's plain float32 render
(``differentiable=True``) is taken as a double backward (theta's gradient
under a cotangent u, differentiated by u: J v), because a custom autograd
function in the plain code has no forward-mode rule.  It is held against
central differences of ``oracle/cpu_oracle.render_oracle`` in float64 with
the JAX test's ``h``, ``tol``, ``bad_frac`` and silhouette mask.
"""
import numpy as np
import pytest
import torch

import euclider_tpu_torch as ett
from euclider_tpu_torch.oracle.cpu_oracle import render_oracle
from euclider_tpu_torch.ops import march as M
from euclider_tpu_torch.ops import vec as V
from euclider_tpu_torch.ops.trace import render_image
from euclider_tpu_torch.ops.vec import Vec
from euclider_tpu_torch.scene.compile import cast_camera, cast_tables

H, W = 16, 24


def _jvp(static, tables, cam, where):
    """d(img)/d(theta) of the float32 plain render, theta the entry
    ``where`` = (tables or cam field, index) -> [H, W, 3] float64."""
    field, idx = where
    t32 = ett.tables_to_torch(tables, "cpu")
    c32 = ett.camera_to_torch(cam, "cpu")
    on_cam = field in c32._fields
    leaf = getattr(c32 if on_cam else t32, field).clone().requires_grad_()
    if on_cam:
        c32 = c32._replace(**{field: leaf})
    else:
        t32 = t32._replace(**{field: leaf})
    img = render_image(static, t32, c32, H, W, differentiable=True)
    u = torch.zeros_like(img, requires_grad=True)
    (g,) = torch.autograd.grad(img, leaf, u, create_graph=True)
    (jv,) = torch.autograd.grad(g[idx], u)
    return jv.double().numpy()


def _fd_vs_jvp(name, where, h, tol, bad_frac=0.03):
    sc = ett.get_scene(name)
    static, tables = ett.compile_scene(sc)
    cam = ett.compile_camera(sc.camera)
    t64, c64 = cast_tables(tables, np.float64), cast_camera(cam, np.float64)
    field, idx = where
    on_cam = field in c64._fields
    th0 = float(getattr(c64 if on_cam else t64, field)[idx])

    def render_orc(theta):
        arr = getattr(c64 if on_cam else t64, field).copy()
        arr[idx] = theta
        if on_cam:
            return render_oracle(static, t64, c64._replace(**{field: arr}),
                                 H, W)
        return render_oracle(static, t64._replace(**{field: arr}), c64, H, W)

    img_p, img_m, img_0 = (render_orc(th0 + h), render_orc(th0 - h),
                           render_orc(th0))
    fd = (img_p - img_m) / (2 * h)
    jv = _jvp(static, tables, cam, where)

    # mask silhouette pixels: second-difference blowup marks discontinuities
    nonsmooth = (np.abs(img_p + img_m - 2 * img_0).max(axis=-1)
                 > 10 * h * h + 1e-4 * h)
    mask = ~nonsmooth
    assert mask.mean() > 0.5, "silhouette mask ate the whole image"
    err = np.abs(fd - jv).max(axis=-1) * mask
    scale = max(np.abs(fd[mask]).max(), 1.0)
    bad = (err > tol * scale).mean()
    assert bad <= bad_frac, (
        f"grad mismatch on {bad:.3f} of pixels (tol {tol}, scale {scale:.3f}, "
        f"max err {err.max():.4f})")
    assert np.abs(jv).max() > 0


@pytest.mark.parametrize("name, where, h, tol", [
    ("grad_probe", ("shape_vec", (0, 2)), 1e-4, 0.02),     # sphere centre
    ("grad_probe", ("shape_sc", (0,)), 1e-4, 0.02),        # sphere radius
    ("grad_probe", ("position", (0,)), 1e-4, 0.02),        # camera position
    ("grad_probe", ("surf_color", (0, 0)), 1e-3, 0.01),    # surface colour
    ("fresnel_probe", ("surf_fresnel", (0,)), 1e-3, 0.02),  # Schlick term
], ids=["sphere_center", "sphere_radius", "camera_position",
        "surface_color", "fresnel_coefficient"])
def test_grad_against_oracle_finite_differences(name, where, h, tol):
    _fd_vs_jvp(name, where, h, tol)


def test_march_step_analytic_inverse():
    """One march step of ops/march.py forward, then x = x1 - h v1 and v
    from the |v| = 1 quadratic recover the step's start to float32
    precision: the invariant the reversible march backward (K4,
    csrc/trace_adj.cuh::march_reverse) rests on."""
    rng = np.random.default_rng(0)
    n = 64

    def mk(s):
        return torch.from_numpy((rng.normal(size=(n,)) * s)
                                .astype(np.float32))

    x = Vec(mk(1.0), mk(1.0), mk(1.0) - 3.0, mk(0.0))
    v = V.normalize(Vec(mk(1.0), mk(1.0), -torch.abs(mk(1.0)) - 0.2,
                        mk(0.0)))
    h = torch.tensor(0.12)
    center = Vec(*(torch.tensor(c) for c in (0.0, 0.0, -3.0, 0.0)))

    def accel(p):
        return M.warp_accel(center, torch.tensor(0.8), p)

    # forward step (the march body's float core)
    v1 = V.normalize(V.madd(v, h, accel(x)))
    x1 = V.madd(x, h, v1)

    # analytic inverse
    xp = V.madd(x1, -h, v1)
    a = accel(xp)
    va = V.dot(v1, a)
    disc = torch.clamp((h * va) ** 2 - h * h * V.norm2(a) + 1.0, min=0.0)
    s = h * va + torch.sqrt(disc)
    vp = V.madd(V.scale(v1, s), -h, a)

    for got, ref in [(xp, x), (vp, v)]:
        for c in "xyzw":
            err = float((getattr(got, c) - getattr(ref, c)).abs().max())
            assert err < 5e-6, (c, err)
