# Frozen copy of euclider_tpu_torch/ops/geometry.py at commit ee5cc13d71e7, part of the
# benchmark's plain reference: it is never edited to follow the program.
"""Primitive and CSG geometry on batched torch Vecs.

Port of ``euclider_tpu/ops/geometry.py``: spheres, half-spaces, hyperplanes
and cylinders with their UV maps, the CSG composites (union, intersection,
difference, symdiff, complement) and the side predicates the march tests.
Shape nodes are the static tuples of ``scene.compile`` (``('sphere',
row)``, ``('union', (child, ...))`` ...); parameters come from SceneTables
by static row.  A composite's candidate crossings are every leaf's boundary
crossings, each kept where the composite's membership flips across it (the
probe at t -+ PROBE).
"""
from __future__ import annotations

import torch

from . import mathx
from . import vec as V
from .vec import Vec

EPS_T = 1e-4      # minimum accepted hit distance along a ray
PROBE = 2e-4      # CSG membership probe offset around a candidate crossing

# ('cylinder', row) takes two rows: [row] the centre (radius in shape_sc),
# [row + 1] the unit axis
PRIMS = ("sphere", "hyperplane", "halfspace", "cylinder")


def is_primitive(node) -> bool:
    return node[0] in PRIMS


def leaves(node):
    """Primitive leaves of a shape node, in deterministic order."""
    if is_primitive(node):
        return [node]
    out = []
    for c in node[1]:
        out.extend(leaves(c))
    return out


def row_vec(tables, row: int) -> Vec:
    r = tables.shape_vec[row]
    return Vec(r[0], r[1], r[2], r[3])


def _cyl_radial(tables, row: int, p: Vec) -> Vec:
    """Component of (p - center) perpendicular to the cylinder axis."""
    c = row_vec(tables, row)
    a = row_vec(tables, row + 1)
    pc = V.sub(p, c)
    return V.madd(pc, -V.dot(pc, a), a)


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
    if kind == "cylinder":
        r = tables.shape_sc[node[1]]
        return V.norm2(_cyl_radial(tables, node[1], p)) < r * r
    ms = [member(ch, tables, p) for ch in node[1]]
    if kind == "union":
        out = ms[0]
        for m in ms[1:]:
            out = out | m
        return out
    if kind == "intersection":
        out = ms[0]
        for m in ms[1:]:
            out = out & m
        return out
    if kind == "difference":
        return ms[0] & ~ms[1]
    if kind == "symdiff":
        out = ms[0]
        for m in ms[1:]:
            out = out ^ m
        return out
    if kind == "complement":
        return ~ms[0]
    raise ValueError(f"unknown node {kind!r}")


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
    if kind == "cylinder":
        r = tables.shape_sc[row]
        return torch.abs(V.norm(_cyl_radial(tables, row, p)) - r)
    n = row_vec(tables, row)
    c = tables.shape_sc[row]
    return torch.abs(V.dot(n, p) - c)


def leaf_crossings(leaf, tables, org: Vec, d: Vec):
    """All boundary crossings of a ray with one primitive: a list of
    (t, valid), two for a sphere or a cylinder and one for a plane.  ``d``
    is unit."""
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
    if kind == "cylinder":
        # |q + t w|^2 = r^2 with q, w the radial parts of (o - c), d
        c = row_vec(tables, row)
        a = row_vec(tables, row + 1)
        r = tables.shape_sc[row]
        oc = V.sub(org, c)
        q = V.madd(oc, -V.dot(oc, a), a)
        w = V.madd(d, -V.dot(d, a), a)
        w2 = V.norm2(w)
        para = w2 < 1e-12                  # ray parallel to the axis
        w2s = torch.where(para, 1.0, w2)
        b = V.dot(q, w) / w2s
        cc = (V.norm2(q) - r * r) / w2s
        disc = b * b - cc
        ok = (disc > 0.0) & ~para
        s = torch.sqrt(torch.where(ok, disc, 1.0))
        return [(-b - s, ok), (-b + s, ok)]
    # hyperplane / halfspace boundary: n . (o + t d) = c
    n = row_vec(tables, row)
    c = tables.shape_sc[row]
    nd = V.dot(n, d)
    safe = torch.abs(nd) > 1e-12
    t = (c - V.dot(n, org)) / torch.where(safe, nd, 1.0)
    return [(t, safe)]


def leaf_normal(leaf, tables, p: Vec) -> Vec:
    """Unoriented geometric unit normal at point p on the leaf's boundary."""
    kind, row = leaf
    if kind == "sphere":
        return V.normalize(V.sub(p, row_vec(tables, row)))
    if kind == "cylinder":
        return V.normalize(_cyl_radial(tables, row, p))
    return row_vec(tables, row)  # unit normal (normalised at compile time)


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
    components (w ignored).  Cylinder: the angle around the axis in the
    axis's tangent frame, and the axial coordinate.  Plane: coordinates in
    its tangent frame."""
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
        v = mathx.acos(cz) / V.const(mathx.PI, cz)
        return u, v
    # cylinder: the same atan2 pole guard as the sphere
    c = row_vec(tables, row)
    a = row_vec(tables, row + 1)
    pc = V.sub(p, c)
    ax = V.dot(pc, a)
    q = V.madd(pc, -ax, a)
    t1, t2 = plane_tangent_frame(a, dim)
    qx = V.dot(q, t1)
    qy = V.dot(q, t2)
    safe_x = torch.where((torch.abs(qx) + torch.abs(qy)) < 1e-12, 1.0, qx)
    u = mathx.atan2(qy, safe_x) * (0.5 / mathx.PI) + 0.5
    return u, ax


def entity_hit_straight(node, tables, org: Vec, d: Vec, dim: int,
                        t_max: float, need_uv: bool = True):
    """Nearest valid boundary crossing of a straight ray with one shape.

    Every root of a primitive with t in (EPS_T, t_max) is a boundary; a leaf
    crossing of a CSG composite is one where the composite's membership
    flips across it.  Returns (t, hit, normal, u, v), each batched like
    org.x; the normal is the unoriented leaf normal.  ``need_uv=False``
    returns zero u, v."""
    csg = not is_primitive(node)
    best_t = torch.full_like(org.x, t_max)
    best_hit = torch.zeros_like(org.x, dtype=torch.bool)
    zf = torch.zeros_like(org.x)
    best_n = Vec(zf, zf, zf, zf)
    best_u = zf
    best_v = zf
    for leaf in leaves(node):
        for t, ok in leaf_crossings(leaf, tables, org, d):
            valid = ok & (t > EPS_T) & (t < t_max)
            if csg:
                pm = V.madd(org, t - PROBE, d)
                pp = V.madd(org, t + PROBE, d)
                valid = valid & (member(node, tables, pm)
                                 ^ member(node, tables, pp))
            p = V.madd(org, t, d)
            n = leaf_normal(leaf, tables, p)
            if need_uv:
                u, v = leaf_uv(leaf, tables, p, dim)
            else:
                u = v = torch.zeros_like(t)
            take = valid & (t < best_t)
            best_t = torch.where(take, t, best_t)
            best_hit = best_hit | take
            best_n = V.where(take, n, best_n)
            best_u = torch.where(take, u, best_u)
            best_v = torch.where(take, v, best_v)
    return best_t, best_hit, best_n, best_u, best_v
