"""Surface shading: per-surface-kind colour evaluation on torch tensors.

Port of ``euclider_tpu/ops/shading.py`` for the ``uniform``, ``checker`` and
``smooth`` surfaces.  Perlin and texture surfaces raise
``NotImplementedError``: they come with later slices.
"""
from __future__ import annotations

import math

import torch


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
    raise NotImplementedError(
        f"the torch port does not render {kind!r} surfaces yet")
