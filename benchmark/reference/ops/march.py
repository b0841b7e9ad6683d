# Frozen copy of euclider_tpu_torch/ops/march.py at commit ee5cc13d71e7, part of the
# benchmark's plain reference: it is never edited to follow the program.
"""Non-Euclidean ray propagation: a bounded-step march through warped space.

Port of ``euclider_tpu/ops/march.py``.  Rays inside a warped-space material
do not travel straight; each step bends them toward an attractor:

    a(x) = strength * (c - x) / (|c - x|^2 + 1e-4)^1.5
    v'   = normalize(v + h * a(x));   x' = x + h * v'

Each entity's side predicate (``geometry.side``) is compared before and after
a step; a flip marks a crossing, which is refined after the loop by
bisection on the stored step segment.  The carries are plain bool tensors
(the JAX package's int32 flags exist only for Mosaic).  This is the plain
version of the march inside ``csrc/trace_fwd.cu`` and of its reverse sweep
(K4) inside the backward kernels (``csrc/trace_adj.cuh``).
"""
from __future__ import annotations

import torch

from . import geometry as G
from . import vec as V
from .vec import Vec

BISECT_ITERS = 10


def warp_accel(center: Vec, strength, x: Vec) -> Vec:
    d = V.sub(center, x)
    r2 = V.norm2(d) + 1e-4
    inv_r3 = r2 ** -1.5
    return V.scale(d, strength * inv_r3)


def march_init(static, tables, org: Vec, d0: Vec, active=None):
    """Initial march carry: (x, v, done, sx0, sx1, sv, sides, crossed, dist)."""
    ents = static.entities
    zero = torch.zeros_like(org.x)
    no = torch.zeros_like(org.x, dtype=torch.bool)
    sides0 = tuple(G.side(e.shape, tables, org) for e in ents)
    crossed0 = tuple(no for _ in ents)
    done0 = no if active is None else ~active
    return (org, d0, done0,                               # x, v, done
            org, org, d0,                                 # seg x0, x1, v
            sides0, crossed0, zero)                       # sides, crossed, dist


def make_march_body(static, tables, accel_fn, h):
    """One march step: body(carry) -> carry."""
    ents = static.entities

    def body(carry):
        x, v, done, sx0, sx1, sv, sides, crossed, dist = carry
        a = accel_fn(x)
        v1 = V.normalize(V.madd(v, h, a))
        x1 = V.madd(x, h, v1)
        new_sides = tuple(G.side(e.shape, tables, x1) for e in ents)
        cr = tuple(s != ns for s, ns in zip(sides, new_sides))
        any_cr = cr[0]
        for c in cr[1:]:
            any_cr = any_cr | c
        newly = ~done & any_cr
        sx0 = V.where(newly, x, sx0)
        sx1 = V.where(newly, x1, sx1)
        sv = V.where(newly, v1, sv)
        crossed = tuple(torch.where(newly, c, old)
                        for c, old in zip(cr, crossed))
        done_next = done | newly | (dist > static.t_max)
        x = V.where(done, x, x1)
        v = V.where(done, v, v1)
        sides = tuple(torch.where(done, s, ns)
                      for s, ns in zip(sides, new_sides))
        dist = torch.where(done, dist, dist + h)
        return (x, v, done_next, sx0, sx1, sv, sides, crossed, dist)

    return body


def march_finish(static, tables, org: Vec, carry):
    """Bisection refinement of the first crossing recorded in ``carry``.

    Returns (hit, p, dir_at_hit, ent_sel, normal, u, v), the march_hit
    output contract."""
    zero = torch.zeros_like(org.x)
    _, _, _, sx0, sx1, sv, _, crossed, _ = carry

    hit = torch.zeros_like(org.x, dtype=torch.bool)
    best_lam = torch.full_like(org.x, 2.0)
    best_p = org
    best_n = Vec(zero, zero, zero, zero)
    best_u = zero
    best_v = zero
    ent_sel = torch.zeros_like(org.x, dtype=torch.int32)

    for ei, e in enumerate(static.entities):
        node = e.shape
        need_uv = (static.surf_need_uv[e.surface]
                   if static.surf_need_uv else True)
        s0 = G.side(node, tables, sx0)
        lo = torch.zeros_like(org.x)
        hi = torch.ones_like(org.x)
        for _ in range(BISECT_ITERS):
            mid = 0.5 * (lo + hi)
            pm = V.add(V.scale(sx0, 1.0 - mid), V.scale(sx1, mid))
            same = G.side(node, tables, pm) == s0
            lo = torch.where(same, mid, lo)
            hi = torch.where(same, hi, mid)
        lam = hi
        p = V.add(V.scale(sx0, 1.0 - lam), V.scale(sx1, lam))
        # leaf-level normal/uv: the leaf whose boundary is nearest at p
        lvs = G.leaves(node)
        n_e = G.leaf_normal(lvs[0], tables, p)
        babs = G.boundary_abs(lvs[0], tables, p)
        if need_uv:
            u_e, v_e = G.leaf_uv(lvs[0], tables, p, static.dim)
        else:
            u_e = v_e = zero
        for leaf in lvs[1:]:
            b = G.boundary_abs(leaf, tables, p)
            take = b < babs
            babs = torch.where(take, b, babs)
            n_e = V.where(take, G.leaf_normal(leaf, tables, p), n_e)
            if need_uv:
                uu, vv = G.leaf_uv(leaf, tables, p, static.dim)
                u_e = torch.where(take, uu, u_e)
                v_e = torch.where(take, vv, v_e)
        take = crossed[ei] & (lam < best_lam)
        best_lam = torch.where(take, lam, best_lam)
        best_p = V.where(take, p, best_p)
        best_n = V.where(take, n_e, best_n)
        best_u = torch.where(take, u_e, best_u)
        best_v = torch.where(take, v_e, best_v)
        hit = hit | crossed[ei]
        ent_sel = torch.where(take, ei, ent_sel)

    return hit, best_p, sv, ent_sel, best_n, best_u, best_v


def march_hit(static, tables, org: Vec, d0: Vec, accel_fn, h, active=None):
    """March a batch of rays; returns the first entity-boundary crossing as
    (hit, p, dir_at_hit, ent_sel, normal, u, v), ent_sel an int32 entity
    index (0 where ~hit) and the normal unoriented.

    ``accel_fn(x) -> Vec`` is the per-ray acceleration field and ``h`` the
    per-ray step size; ``active`` masks the rays that march.  At most
    ``static.march_steps`` steps run, and the loop stops once every ray is
    done (the JAX package's early-exit while loop): a step on done rays is
    a no-op for values and gradients alike, so the early stop serves
    autograd too."""
    carry = march_init(static, tables, org, d0, active)
    body = make_march_body(static, tables, accel_fn, h)
    for _ in range(static.march_steps):
        if not bool(torch.any(~carry[2])):
            break
        carry = body(carry)
    return march_finish(static, tables, org, carry)
