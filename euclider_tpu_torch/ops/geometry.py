"""Primitive geometry on batched torch Vecs.

Port of ``euclider_tpu/ops/geometry.py`` for spheres, half-spaces and
hyperplanes, with their UV maps and the side predicates the march tests.
Shape nodes are the static tuples of
``scene.compile`` (``('sphere', row)`` ...); parameters come from
SceneTables by static row.  CSG composites and cylinders raise
``NotImplementedError``: they come with later slices.
"""
from __future__ import annotations

import torch

from . import mathx
from . import vec as V
from .vec import Vec

EPS_T = 1e-4      # minimum accepted hit distance along a ray

PRIMS = ("sphere", "hyperplane", "halfspace")


def _unsupported(node):
    kind = node[0]
    what = "cylinders" if kind == "cylinder" else f"CSG {kind!r} nodes"
    raise NotImplementedError(f"the torch port does not render {what} yet")


def leaves(node):
    """Primitive leaves of a shape node: the node itself (CSG composites,
    which have several, come with their slice)."""
    if node[0] not in PRIMS:
        _unsupported(node)
    return [node]


def row_vec(tables, row: int) -> Vec:
    r = tables.shape_vec[row]
    return Vec(r[0], r[1], r[2], r[3])


def member(node, tables, p: Vec):
    """Is point p inside the (volumetric) shape?  Hyperplanes are measure-zero
    and never contain points."""
    kind = node[0]
    if kind == "sphere":
        c = row_vec(tables, node[1])
        r = tables.shape_sc[node[1]]
        return V.norm2(V.sub(p, c)) < r * r
    if kind == "hyperplane":
        return torch.zeros_like(p.x, dtype=torch.bool)
    if kind == "halfspace":
        n = row_vec(tables, node[1])
        c = tables.shape_sc[node[1]]
        return V.dot(n, p) < c
    _unsupported(node)


def side(node, tables, p: Vec):
    """Boolean side predicate whose flips mark boundary crossings: membership
    for volumetric shapes, the half-space side for a bare hyperplane (so the
    march detects sheet crossings too)."""
    if node[0] == "hyperplane":
        n = row_vec(tables, node[1])
        c = tables.shape_sc[node[1]]
        return V.dot(n, p) < c
    return member(node, tables, p)


def boundary_abs(leaf, tables, p: Vec):
    """|signed distance-ish| to a leaf's boundary: picks the leaf that
    generated a marched crossing."""
    kind, row = leaf
    if kind == "sphere":
        c = row_vec(tables, row)
        r = tables.shape_sc[row]
        return torch.abs(V.norm(V.sub(p, c)) - r)
    if kind in ("hyperplane", "halfspace"):
        n = row_vec(tables, row)
        c = tables.shape_sc[row]
        return torch.abs(V.dot(n, p) - c)
    _unsupported(leaf)


def leaf_crossings(leaf, tables, org: Vec, d: Vec):
    """All boundary crossings of a ray with one primitive: a list of
    (t, valid), two for a sphere and one for a plane.  ``d`` is unit."""
    kind, row = leaf
    if kind == "sphere":
        c = row_vec(tables, row)
        r = tables.shape_sc[row]
        oc = V.sub(org, c)
        b = V.dot(oc, d)                    # half-b; a == 1
        q = V.norm2(oc) - r * r
        disc = b * b - q
        ok = disc > 0.0
        s = torch.sqrt(torch.where(ok, disc, 1.0))
        return [(-b - s, ok), (-b + s, ok)]
    if kind in ("hyperplane", "halfspace"):
        n = row_vec(tables, row)
        c = tables.shape_sc[row]
        nd = V.dot(n, d)
        safe = torch.abs(nd) > 1e-12
        t = (c - V.dot(n, org)) / torch.where(safe, nd, 1.0)
        return [(t, safe)]
    _unsupported(leaf)


def leaf_normal(leaf, tables, p: Vec) -> Vec:
    """Unoriented geometric unit normal at point p on the leaf's boundary."""
    kind, row = leaf
    if kind == "sphere":
        return V.normalize(V.sub(p, row_vec(tables, row)))
    if kind in ("hyperplane", "halfspace"):
        return row_vec(tables, row)  # unit normal (normalised at compile time)
    _unsupported(leaf)


def _axis_vec(i, like):
    comps = [torch.zeros_like(like) for _ in range(4)]
    comps[i] = torch.ones_like(like)
    return Vec(*comps)


def plane_tangent_frame(n: Vec, dim: int):
    """Two orthonormal tangents of a (hyper)plane: Gram-Schmidt the two
    coordinate axes with the smallest |n| components (strict ``<`` argmin
    over the first ``dim`` components, then over the rest)."""
    comps = [torch.abs(n.x), torch.abs(n.y), torch.abs(n.z), torch.abs(n.w)]
    big = torch.full_like(comps[0], 1e9)
    vals = [comps[i] if i < dim else big for i in range(4)]

    def argmin(exclude=None):
        best_i = torch.zeros_like(comps[0], dtype=torch.int32)
        best_v = big + 1.0
        for i, v in enumerate(vals):
            vv = v if exclude is None else torch.where(exclude == i, big, v)
            take = vv < best_v
            best_v = torch.where(take, vv, best_v)
            best_i = torch.where(take, i, best_i)
        return best_i

    a = argmin()
    b = argmin(exclude=a)

    def pick_axis(idx):
        out = _axis_vec(0, comps[0])
        for i in range(1, 4):
            out = V.where(idx == i, _axis_vec(i, comps[0]), out)
        return out

    ea, eb = pick_axis(a), pick_axis(b)
    t1 = V.normalize(V.madd(ea, -V.dot(n, ea), n))
    t2 = V.madd(eb, -V.dot(n, eb), n)
    t2 = V.normalize(V.madd(t2, -V.dot(t1, t2), t1))
    return t1, t2


def leaf_uv(leaf, tables, p: Vec, dim: int):
    """UV coordinates at p.  Sphere: longitude/latitude of the local x, y, z
    components (w ignored).  Plane: coordinates in its tangent frame."""
    kind, row = leaf
    if kind in ("hyperplane", "halfspace"):
        t1, t2 = plane_tangent_frame(row_vec(tables, row), dim)
        return V.dot(p, t1), V.dot(p, t2)
    if kind == "sphere":
        loc = V.sub(p, row_vec(tables, row))
        # pole guards: the atan2 gradient is NaN at (0, 0) and the acos
        # gradient infinite at +-1; the 1e-6 clip is part of the semantics
        # (the oracles clip the same way)
        safe_x = torch.where((torch.abs(loc.x) + torch.abs(loc.y)) < 1e-12,
                             1.0, loc.x)
        u = mathx.atan2(loc.y, safe_x) * (0.5 / mathx.PI) + 0.5
        rlen = V.norm(loc)
        cz = torch.clamp(loc.z / torch.clamp(rlen, min=1e-12),
                         -1.0 + 1e-6, 1.0 - 1e-6)
        v = mathx.acos(cz) / mathx.PI
        return u, v
    _unsupported(leaf)


def entity_hit_straight(node, tables, org: Vec, d: Vec, dim: int,
                        t_max: float, need_uv: bool = True):
    """Nearest valid boundary crossing of a straight ray with one primitive.

    Returns (t, hit, normal, u, v), each batched like org.x; the normal is
    the unoriented leaf normal.  ``need_uv=False`` returns zero u, v."""
    if node[0] not in PRIMS:
        _unsupported(node)
    best_t = torch.full_like(org.x, t_max)
    best_hit = torch.zeros_like(org.x, dtype=torch.bool)
    zf = torch.zeros_like(org.x)
    best_n = Vec(zf, zf, zf, zf)
    best_u = zf
    best_v = zf
    for t, ok in leaf_crossings(node, tables, org, d):
        valid = ok & (t > EPS_T) & (t < t_max)
        p = V.madd(org, t, d)
        n = leaf_normal(node, tables, p)
        if need_uv:
            u, v = leaf_uv(node, tables, p, dim)
        else:
            u = v = torch.zeros_like(t)
        take = valid & (t < best_t)
        best_t = torch.where(take, t, best_t)
        best_hit = best_hit | take
        best_n = V.where(take, n, best_n)
        best_u = torch.where(take, u, best_u)
        best_v = torch.where(take, v, best_v)
    return best_t, best_hit, best_n, best_u, best_v
