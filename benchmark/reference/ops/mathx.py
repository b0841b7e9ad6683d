# Frozen copy of euclider_tpu_torch/ops/mathx.py at commit ee5cc13d71e7, part of the
# benchmark's plain reference: it is never edited to follow the program.
"""Polynomial ``atan``, ``atan2``, ``asin`` and ``acos`` on torch tensors.

Port of ``euclider_tpu/ops/mathx.py``.  The JAX package computes sphere UV
through these polynomials in both of its backends, not through libm, so the
port keeps them too: the plain version then agrees with the lax render to
float32 rounding, and its gradients are those of the same polynomials.  The
CUDA kernels carry the same coefficients (``csrc/trace_common.cuh``).

atan core: odd degree-19 polynomial in x on [-1, 1] (max error 1.8e-9),
range-reduced via atan(x) = pi/2 - atan(1/x).

``abs`` is torch.abs with jax's gradient: jax differentiates |x| as
select(x >= 0, g, -g), so d|x|/dx is 1 at 0 where torch.abs gives 0.  The
polynomials take |x| through it, so their gradients at 0 are jax's too
(atan'(0) = the first coefficient, not 0).
"""
from __future__ import annotations

import torch

ATAN_COEFFS = (
    9.999999975460e-01, -3.333328229551e-01, 1.999823064038e-01,
    -1.426157368032e-01, 1.094019896528e-01, -8.372063948415e-02,
    5.746355785479e-02, -3.071750891086e-02, 1.068071944976e-02,
    -1.743701144660e-03,
)

HALF_PI = 1.5707963267948966
PI = 3.141592653589793


class _Abs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def abs(x):  # noqa: A001 - jax.numpy's name
    """|x| with jax's gradient (1 at x == 0)."""
    return _Abs.apply(x)


def _atan_core(x):
    """atan on |x| <= 1."""
    t = x * x
    acc = torch.full_like(x, ATAN_COEFFS[-1])
    for c in ATAN_COEFFS[-2::-1]:
        acc = acc * t + c
    return x * acc


def atan(x):
    ax = abs(x)
    big = ax > 1.0
    inv = 1.0 / torch.where(big, ax, 1.0)    # safe reciprocal
    core = _atan_core(torch.where(big, inv, ax))
    res = torch.where(big, HALF_PI - core, core)
    return torch.where(x < 0, -res, res)


def atan2(y, x):
    """Quadrant-correct atan2 with the libm convention; atan2(0, 0) = 0."""
    safe_x = torch.where(x == 0.0, 1.0, x)
    base = atan(y / safe_x)
    res = torch.where(
        x > 0.0, base,
        torch.where(x < 0.0,
                    base + torch.where(y < 0.0, -PI, PI),
                    torch.where(y == 0.0, 0.0,
                                torch.where(y < 0.0, -HALF_PI, HALF_PI))))
    return res


def asin(x):
    """asin via atan(x / sqrt(1 - x^2)); callers pre-clip |x| < 1."""
    s = torch.sqrt(torch.clamp(1.0 - x * x, min=1e-12))
    return atan(x / s)


def acos(x):
    return HALF_PI - asin(x)
