# Frozen copy of euclider_tpu_torch/ops/vec.py at commit ee5cc13d71e7, part of the
# benchmark's plain reference: it is never edited to follow the program.
"""Component-SoA 4-vector math on torch tensors.

Port of ``euclider_tpu/ops/vec.py``: every vector is four separate tensors
(x, y, z, w) of one batch shape; 3D scenes carry a zero ``w``.  The
arithmetic order of every function matches the JAX version, so the two agree
to float32 rounding.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Vec(NamedTuple):
    """A (possibly batched) 4-vector as four component tensors."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    w: torch.Tensor


def from_array(a: torch.Tensor) -> Vec:
    """Build a Vec from a trailing-axis-4 (or -3) tensor."""
    if a.shape[-1] == 3:
        return Vec(a[..., 0], a[..., 1], a[..., 2], torch.zeros_like(a[..., 0]))
    return Vec(a[..., 0], a[..., 1], a[..., 2], a[..., 3])


def splat(v: Vec, batch_shape) -> Vec:
    """Broadcast a scalar Vec to a batch shape."""
    return Vec(*(c.expand(batch_shape) for c in v))


def add(a: Vec, b: Vec) -> Vec:
    return Vec(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w)


def sub(a: Vec, b: Vec) -> Vec:
    return Vec(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w)


def scale(a: Vec, s) -> Vec:
    return Vec(a.x * s, a.y * s, a.z * s, a.w * s)


def madd(a: Vec, s, b: Vec) -> Vec:
    """a + s * b  (ray-advance primitive)."""
    return Vec(a.x + s * b.x, a.y + s * b.y, a.z + s * b.z, a.w + s * b.w)


def dot(a: Vec, b: Vec):
    return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w


def norm2(a: Vec):
    return dot(a, a)


def norm(a: Vec):
    return torch.sqrt(norm2(a))


def normalize(a: Vec, eps: float = 1e-20) -> Vec:
    return scale(a, torch.rsqrt(norm2(a) + eps))


def const(v, like):
    """The Python number v as a 0-dim tensor on ``like``'s device, to divide
    by: torch divides by a Python number on a CUDA device as a product with
    its rounded reciprocal, where the kernels and the JAX package divide."""
    return torch.full((), v, dtype=like.dtype, device=like.device)


def where(mask, a: Vec, b: Vec) -> Vec:
    return Vec(torch.where(mask, a.x, b.x), torch.where(mask, a.y, b.y),
               torch.where(mask, a.z, b.z), torch.where(mask, a.w, b.w))


def reflect(d: Vec, n: Vec) -> Vec:
    """Mirror d about the plane with (unit) normal n."""
    k = 2.0 * dot(d, n)
    return Vec(d.x - k * n.x, d.y - k * n.y, d.z - k * n.z, d.w - k * n.w)


def refract(d: Vec, n: Vec, eta):
    """Snell refraction of unit d at unit normal n (facing against d).

    eta = ior_from / ior_to.  Returns (dir, valid); valid=False marks total
    internal reflection, whose transmitted contribution is dropped."""
    cos_i = -dot(d, n)
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    valid = k > 0.0
    k_safe = torch.sqrt(torch.where(valid, k, 1.0))
    coef = eta * cos_i - k_safe
    out = Vec(eta * d.x + coef * n.x, eta * d.y + coef * n.y,
              eta * d.z + coef * n.z, eta * d.w + coef * n.w)
    return normalize(out), valid


def matvec(m, v: Vec) -> Vec:
    """Apply a 4x4 matrix (a [4, 4] tensor, e.g. one portal's linear part)
    to a Vec."""
    return Vec(
        m[0, 0] * v.x + m[0, 1] * v.y + m[0, 2] * v.z + m[0, 3] * v.w,
        m[1, 0] * v.x + m[1, 1] * v.y + m[1, 2] * v.z + m[1, 3] * v.w,
        m[2, 0] * v.x + m[2, 1] * v.y + m[2, 2] * v.z + m[2, 3] * v.w,
        m[3, 0] * v.x + m[3, 1] * v.y + m[3, 2] * v.z + m[3, 3] * v.w,
    )
