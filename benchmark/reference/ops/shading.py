# Frozen copy of euclider_tpu_torch/ops/shading.py at commit ee5cc13d71e7, part of the
# benchmark's plain reference: it is never edited to follow the program.
"""Surface shading: per-surface-kind colour evaluation on torch tensors.

Port of ``euclider_tpu/ops/shading.py``: the ``uniform``, ``checker``,
``smooth``, ``perlin`` and ``texture`` surfaces.  The texture is sampled by
the gather bilinear filter (the JAX package's matmul sampler exists only for
Mosaic, which has no gathers).
"""
from __future__ import annotations

import math

import torch

# ---------------------------------------------------------------------------
# Perlin gradient noise: the integer lattice hash of the JAX package, whose
# uint32 wraparound is emulated in int64 (torch has no uint32 arithmetic):
# every product and sum is masked back to 32 bits, and the products of a
# 32-bit value with a constant below 2^31 stay below 2^63.
# ---------------------------------------------------------------------------

_U32 = 0xFFFFFFFF
_INV_SQRT2 = 0.7071067811865476

# (gx, gy) per 3-bit hash value
_PERLIN_DIRS = ((1.0, 0.0), (-1.0, 0.0), (0.0, 1.0), (0.0, -1.0),
                (_INV_SQRT2, _INV_SQRT2), (-_INV_SQRT2, _INV_SQRT2),
                (_INV_SQRT2, -_INV_SQRT2), (-_INV_SQRT2, -_INV_SQRT2))


def _hash2(xi, yi, seed: int):
    """The uint32 lattice hash; xi, yi int64 tensors holding uint32 values
    -> int64 tensor holding the uint32 hash."""
    n = (((xi * 374761393) & _U32) + ((yi * 668265263) & _U32)
         + ((seed * 974711) & _U32)) & _U32
    n = ((n ^ (n >> 13)) * 1274126177) & _U32
    return n ^ (n >> 16)


def _grad_dot(h3, dx, dy):
    """dot(gradient[h3], (dx, dy)) by a where-chain over the 8 directions."""
    gx, gy = _PERLIN_DIRS[0]
    out = gx * dx + gy * dy
    for k in range(1, 8):
        gx, gy = _PERLIN_DIRS[k]
        out = torch.where(h3 == k, gx * dx + gy * dy, out)
    return out


def _fade(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def perlin2(pu, pv, seed: int):
    """One octave of 2D Perlin noise at (pu, pv); range ~[-0.71, 0.71]."""
    x0f = torch.floor(pu)
    y0f = torch.floor(pv)
    xf = pu - x0f
    yf = pv - y0f
    # float -> int32 -> uint32, as the JAX package converts
    x0 = x0f.to(torch.int32).to(torch.int64) & _U32
    y0 = y0f.to(torch.int32).to(torch.int64) & _U32
    h = [_hash2((x0 + cx) & _U32, (y0 + cy) & _U32, seed) & 7
         for cy in (0, 1) for cx in (0, 1)]
    n00 = _grad_dot(h[0], xf, yf)
    n01 = _grad_dot(h[1], xf - 1.0, yf)
    n10 = _grad_dot(h[2], xf, yf - 1.0)
    n11 = _grad_dot(h[3], xf - 1.0, yf - 1.0)
    sx = _fade(xf)
    sy = _fade(yf)
    nx0 = n00 + sx * (n01 - n00)
    nx1 = n10 + sx * (n11 - n10)
    return nx0 + sy * (nx1 - nx0)


def clip01(x):
    """clip(x, 0, 1) with jax's gradient: 1 strictly inside, 0 outside, and
    at a bound, half (jnp.clip is maximum then minimum, whose gradients
    split a tie)."""
    lo = torch.maximum(x, torch.zeros_like(x))
    return torch.minimum(lo, torch.ones_like(x))


def perlin_field(u, v, scale, octaves: int, seed: int):
    """fBm over ``octaves`` (lacunarity 2, gain 0.5), mapped to [0, 1]."""
    acc = 0.0
    amp = 1.0
    freq = 1.0
    for o in range(octaves):
        acc = acc + amp * perlin2(u * scale * freq, v * scale * freq,
                                  seed + o)
        amp *= 0.5
        freq *= 2.0
    return clip01(0.5 + 0.5 * acc)


def mod1(x):
    """jnp.mod(x, 1.0): the remainder with the sign of the divisor, exactly
    (fmod, plus 1 where it is negative); its gradient is 1."""
    r = torch.fmod(x, 1.0)
    return torch.where(r < 0.0, r + 1.0, r)


def sample_texture(tex, u, v, sc):
    """Bilinear sample of the [th, tw, 3] texture at the wrapped (u, v)
    scaled by sc, clamped at the far edge -> (r, g, b)."""
    th, tw = tex.shape[0], tex.shape[1]
    fu = mod1(u * sc) * (tw - 1)
    fv = mod1(v * sc) * (th - 1)
    x0 = torch.floor(fu)
    y0 = torch.floor(fv)
    dx = fu - x0
    dy = fv - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    x1i = torch.clamp(x0i + 1, max=tw - 1)
    y1i = torch.clamp(y0i + 1, max=th - 1)
    out = []
    for c in range(3):
        v00 = tex[y0i, x0i, c]
        v01 = tex[y0i, x1i, c]
        v10 = tex[y1i, x0i, c]
        v11 = tex[y1i, x1i, c]
        out.append((v00 * (1 - dx) + v01 * dx) * (1 - dy)
                   + (v10 * (1 - dx) + v11 * dx) * dy)
    return out


def eval_surface(static, tables, s: int, u, v):
    """Evaluate surface index ``s`` (static) at batched UV -> (r, g, b, a)."""
    kind = static.surf_kinds[s]
    col = tables.surf_color[s]
    if kind == "uniform":
        shape = u.shape
        return tuple(col[c].expand(shape) for c in range(4))
    if kind == "checker":
        sc = tables.surf_uv_scale[s]
        # floor-mod (sign of the divisor) like jnp.mod, not truncating fmod:
        # the parity of a negative odd sum is 1, not -1
        par = torch.remainder(torch.floor(u * sc) + torch.floor(v * sc), 2.0)
        sel = par >= 0.5
        col2 = tables.surf_color2[s]
        return tuple(torch.where(sel, col2[c], col[c]) for c in range(4))
    if kind == "smooth":
        sc = tables.surf_uv_scale[s]
        two_pi = 2.0 * math.pi
        f = 0.25 * (1.0 + torch.sin(two_pi * u * sc)) \
                 * (1.0 + torch.sin(two_pi * v * sc))
        col2 = tables.surf_color2[s]
        return tuple(col[c] + (col2[c] - col[c]) * f for c in range(4))
    if kind == "perlin":
        octaves, seed = static.surf_perlin[s]
        f = perlin_field(u, v, tables.surf_uv_scale[s], octaves, seed)
        col2 = tables.surf_color2[s]
        return tuple(col[c] + (col2[c] - col[c]) * f for c in range(4))
    if kind == "texture":
        tex = tables.textures[static.surf_texture[s]]
        r, g, b = sample_texture(tex, u, v, tables.surf_uv_scale[s])
        return r, g, b, col[3].expand(u.shape)
    raise ValueError(f"unknown surface kind {kind!r}")
