# Frozen copy of euclider_tpu_torch/ops/trace.py at commit ee5cc13d71e7, part of the
# benchmark's plain reference: it is never edited to follow the program.
"""The tracing core on batched torch tensors: the plain version of the
forward kernel.

Port of ``euclider_tpu/ops/trace.py`` (its lax backend): straight space,
attractor- and expression-warped space (``ops/march.py``), portals, CSG
composites and every surface kind; with
``differentiable=True`` it is autograd's reference for the backward kernel
(``ops/vjp.py``).  A ray tree becomes a masked depth-first stack
loop: each ray carries at most ``max_depth + 1`` deferred branches (origin,
direction, path weight, material, remaining depth); a trip pops one branch,
shades it and pushes up to two children, transmission first and reflection
second.  The scene topology is unrolled in Python over the static entity
list; only float parameters come from the tables.

``render_image`` here is what ``ops/cuda_kernel.render_image_cuda`` is held
against on the card, and what the package renders with on the CPU.
"""
from __future__ import annotations

import torch

from ..scene import expr as E
from . import geometry as G
from . import march as M
from . import shading
from . import vec as V
from .vec import Vec

PUSH = 1e-3    # offset to escape a surface when spawning a secondary ray
W_EPS = 1e-4   # path-weight cutoff: branches below this contribute nothing


# ---------------------------------------------------------------------------
# material queries
# ---------------------------------------------------------------------------

def material_at(static, tables, p: Vec):
    """Material id at a point: first entity (scene order) containing it wins,
    else the ambient material."""
    mat = torch.full(p.x.shape, static.ambient, dtype=torch.int32,
                     device=p.x.device)
    for ei in reversed(range(len(static.entities))):
        e = static.entities[ei]
        inside = G.member(e.shape, tables, p)
        mat = torch.where(inside, e.material, mat)
    return mat


def mat_lookup(tables_column, mat_ids):
    """column[mat_ids] with a static where-chain."""
    out = tables_column[0].expand(mat_ids.shape)
    for m in range(1, tables_column.shape[0]):
        out = torch.where(mat_ids == m, tables_column[m], out)
    return out


WARP_KINDS = ("warp", "expr")   # material kinds that march instead of flying


def warp_mask(static, mat_ids):
    mask = torch.zeros_like(mat_ids, dtype=torch.bool)
    for m, kind in enumerate(static.mat_kinds):
        if kind in WARP_KINDS:
            mask = mask | (mat_ids == m)
    return mask


def warp_step(static, tables, mat_ids):
    """Per-ray march step size h, selected from the material tables."""
    h = torch.full(mat_ids.shape, 0.05, dtype=tables.mat_warp_step.dtype,
                   device=mat_ids.device)
    for m, kind in enumerate(static.mat_kinds):
        if kind in WARP_KINDS:
            h = torch.where(mat_ids == m, tables.mat_warp_step[m], h)
    return h


def make_accel(static, tables, mat_ids, time=0.0):
    """Acceleration field a(x) of the marching rays, dispatched per ray over
    the scene's warped materials: 'warp' materials contribute the attractor
    field, 'expr' materials their expression field (scene/expr.py), which
    reads the scene ``time`` as ``t``.

    The expressions run with ``torch_lib(safe=True)``: the field is
    evaluated at every ray position and selected by material afterwards,
    and a NaN on an unselected ray would ride 0*NaN through the where's
    backward into every gradient.  A constant component (config6's "0") is
    broadcast to the batch."""
    dev = mat_ids.device
    dt = tables.mat_warp_step.dtype
    zf = torch.zeros(mat_ids.shape, dtype=dt, device=dev)
    wc = Vec(zf, zf, zf, zf)
    ws = zf
    any_attractor = "warp" in static.mat_kinds
    for m, kind in enumerate(static.mat_kinds):
        if kind == "warp":
            sel = mat_ids == m
            row = tables.mat_warp_center[m]
            wc = V.where(sel, Vec(row[0], row[1], row[2], row[3]), wc)
            ws = torch.where(sel, tables.mat_warp_strength[m], ws)
    expr_mats = [m for m, k in enumerate(static.mat_kinds) if k == "expr"]
    lib = E.torch_lib(safe=True, device=dev, dtype=dt) if expr_mats else None
    # the time as a tensor of the tables' dtype (the kernels read float32,
    # cam_row[17])
    tm = torch.as_tensor(time, dtype=dt, device=dev)

    def accel(x: Vec) -> Vec:
        if any_attractor:
            a = M.warp_accel(wc, ws, x)   # ws == 0 where not an attractor
        else:
            z = torch.zeros_like(x.x)
            a = Vec(z, z, z, z)
        for m in expr_mats:
            env = {"x": x.x, "y": x.y, "z": x.z, "w": x.w, "t": tm}
            for i in range(8):
                env[f"p{i}"] = tables.mat_expr_params[m, i]
            comps = (torch.as_tensor(E.eval_ast(c, env, lib), dtype=dt,
                                     device=dev).expand(x.x.shape)
                     for c in static.mat_exprs[m])
            a = V.where(mat_ids == m, Vec(*comps), a)
        return a

    return accel


# ---------------------------------------------------------------------------
# segment propagation: nearest hit in the current space
# ---------------------------------------------------------------------------

def nearest_hit_straight(static, tables, org: Vec, d: Vec):
    zf = torch.zeros_like(org.x)
    best_t = torch.full_like(org.x, static.t_max)
    hit = torch.zeros_like(org.x, dtype=torch.bool)
    ent = torch.zeros_like(org.x, dtype=torch.int32)
    n = Vec(zf, zf, zf, zf)
    u = zf
    v = zf
    for ei, e in enumerate(static.entities):
        need_uv = (static.surf_need_uv[e.surface]
                   if static.surf_need_uv else True)
        t_e, hit_e, n_e, u_e, v_e = G.entity_hit_straight(
            e.shape, tables, org, d, static.dim, static.t_max, need_uv)
        take = hit_e & (t_e < best_t)
        best_t = torch.where(take, t_e, best_t)
        hit = hit | take
        ent = torch.where(take, ei, ent)
        n = V.where(take, n_e, n)
        u = torch.where(take, u_e, u)
        v = torch.where(take, v_e, v)
    return best_t, hit, ent, n, u, v


def propagate(static, tables, org: Vec, d: Vec, mat_ids, time=0.0):
    """One segment: from org along d inside material mat_ids until the first
    entity boundary.  Returns (hit, p, dir_at_hit, ent, normal, u, v).  Rays
    in a warped material march (ops/march.py) through the field at scene
    time ``time``; the march replaces their analytic hit."""
    t, hit, ent, n, u, v = nearest_hit_straight(static, tables, org, d)
    p = V.madd(org, t, d)
    dout = d
    if static.has_warp:
        wm = warp_mask(static, mat_ids)
        h = warp_step(static, tables, mat_ids)
        accel_fn = make_accel(static, tables, mat_ids, time)
        mh_hit, mh_p, mh_d, mh_ent, mh_n, mh_u, mh_v = M.march_hit(
            static, tables, org, d, accel_fn, h, active=wm)
        hit = torch.where(wm, mh_hit, hit)
        p = V.where(wm, mh_p, p)
        dout = V.where(wm, mh_d, dout)
        ent = torch.where(wm, mh_ent, ent)
        n = V.where(wm, mh_n, n)
        u = torch.where(wm, mh_u, u)
        v = torch.where(wm, mh_v, v)
    return hit, p, dout, ent, n, u, v


# ---------------------------------------------------------------------------
# DFS stack machinery (per-ray, masked; capacity = max_depth + 1)
# ---------------------------------------------------------------------------

def _slot_where(m, a, b):
    return (V.where(m, a[0], b[0]), V.where(m, a[1], b[1]),
            torch.where(m, a[2], b[2]), torch.where(m, a[3], b[3]),
            torch.where(m, a[4], b[4]))


def read_slot(slots, idx):
    out = slots[0]
    for k in range(1, len(slots)):
        out = _slot_where(idx == k, slots[k], out)
    return out


def write_slot(slots, idx, mask, val, kmax=None):
    """Masked write of ``val`` into slot ``idx``; ``kmax`` statically bounds
    which slots can be targeted."""
    kmax = len(slots) if kmax is None else min(kmax, len(slots))
    return tuple(_slot_where(mask & (idx == k), val, slots[k])
                 if k < kmax else slots[k]
                 for k in range(len(slots)))


# ---------------------------------------------------------------------------
# the trace loop
# ---------------------------------------------------------------------------

def _shade_node(static, tables, org: Vec, d: Vec, wgt, mat, depth, active,
                differentiable, used_surfs, do_transmit, do_reflect,
                depth_ge2, time=0.0):
    """Shade one DFS node: propagate to the nearest boundary, accumulate the
    local colour term, and emit up to two deferred branches.

    Returns (dr, dg, db, branches) with branches a list of
    (push_mask, (org, dir, weight, material, depth)), transmission first.
    ``depth_ge2`` is None when depth >= 2 is statically known (the peeled
    primary node), else the per-ray boolean.
    """
    ents = static.entities
    zf = torch.zeros_like(org.x)

    hit, p, dout, ent, n, u, v = propagate(static, tables, org, d, mat, time)
    hit = hit & active
    miss = active & ~hit

    bg = tables.background
    dr = torch.where(miss, wgt * bg[0], 0.0)
    dg = torch.where(miss, wgt * bg[1], 0.0)
    db = torch.where(miss, wgt * bg[2], 0.0)

    # orient the geometric normal against the incoming direction
    flip = V.dot(n, dout) > 0.0
    n = V.where(flip, V.scale(n, -1.0), n)

    # surface colour / reflectivity of the winning entity
    cols = {s: shading.eval_surface(static, tables, s, u, v)
            for s in used_surfs}
    cr, cg, cb, ca, refl = zf, zf, zf, torch.ones_like(zf), zf
    fres = zf
    # fresnel == 0 leaves the ratio unchanged exactly, so the forward skips
    # the Schlick block then; its gradient w.r.t. fresnel is not zero
    fres0 = static.surf_fres0 or (False,) * len(static.surf_kinds)
    any_fres = differentiable or any(not fres0[e.surface] for e in ents)
    for ei, e in enumerate(ents):
        sel = ent == ei
        c = cols[e.surface]
        cr = torch.where(sel, c[0], cr)
        cg = torch.where(sel, c[1], cg)
        cb = torch.where(sel, c[2], cb)
        ca = torch.where(sel, c[3], ca)
        refl = torch.where(sel, tables.surf_refl[e.surface], refl)
        if any_fres:
            fres = torch.where(sel, tables.surf_fresnel[e.surface], fres)

    if any_fres:
        # Schlick reflection ratio against the oriented normal:
        # ratio = rho + (1-rho) * fresnel * (1 - cos_i)^5
        cos_i = torch.clamp(-V.dot(dout, n), 0.0, 1.0)
        m1 = 1.0 - cos_i
        m2 = m1 * m1
        refl = refl + (1.0 - refl) * fres * (m2 * m2 * m1)

    # local emitted term: weight * (1-ratio) * alpha * surface_colour
    lw = wgt * (1.0 - refl) * ca
    dr = dr + torch.where(hit, lw * cr, 0.0)
    dg = dg + torch.where(hit, lw * cg, 0.0)
    db = db + torch.where(hit, lw * cb, 0.0)

    branches = []

    if do_transmit:
        p_past = V.madd(p, PUSH, dout)
        m_to = material_at(static, tables, p_past)
        eta = mat_lookup(tables.mat_ior, mat) / mat_lookup(tables.mat_ior, m_to)
        tdir, tok = V.refract(dout, n, eta)
        t_org = V.madd(p, PUSH, tdir)
        t_mat = m_to
        if static.has_portal:
            # a portal's transmitted ray is teleported: p' = lin p + tr,
            # d' = normalize(lin d), and always transmits (no TIR)
            any_portal = torch.zeros_like(hit)
            for ei, e in enumerate(ents):
                if e.portal is None:
                    continue
                selp = ent == ei
                lin = tables.portal_lin[e.portal]
                tr = tables.portal_tr[e.portal]
                pp = V.add(V.matvec(lin, p), Vec(tr[0], tr[1], tr[2], tr[3]))
                pd = V.normalize(V.matvec(lin, dout))
                t_org = V.where(selp, V.madd(pp, PUSH, pd), t_org)
                tdir = V.where(selp, pd, tdir)
                tok = tok | selp
                any_portal = any_portal | selp
            # teleported rays land in a fresh region: re-resolve their material
            t_mat = torch.where(any_portal, material_at(static, tables, t_org),
                                t_mat)
        w_t = wgt * (1.0 - refl) * (1.0 - ca)
        push_t = hit & tok & (w_t > W_EPS)
        if depth_ge2 is not None:
            push_t = push_t & depth_ge2
        branches.append((push_t, (t_org, tdir, w_t, t_mat, depth - 1)))

    if do_reflect:
        rdir = V.reflect(dout, n)
        r_org = V.madd(p, PUSH, rdir)
        w_r = wgt * refl
        push_r = hit & (w_r > W_EPS)
        if depth_ge2 is not None:
            push_r = push_r & depth_ge2
        branches.append((push_r, (r_org, rdir, w_r, mat, depth - 1)))

    return dr, dg, db, branches


def _bounce_plan(static, differentiable):
    """Static branch-liveness plan: which deferred branches can exist at all.

    Pruning on the opaque/matte hints is value-exact (the elided branches
    have weight exactly 0) but not gradient-exact: d/d alpha of an opaque
    surface and d/d reflectivity of a matte one are not zero.  So the
    differentiable render keeps every branch."""
    ents = static.entities
    D = static.max_depth
    prune = not differentiable
    sa1 = static.surf_alpha1 or (False,) * len(static.surf_kinds)
    sr0 = static.surf_refl0 or (False,) * len(static.surf_kinds)
    any_transmit = any((e.portal is not None) or not sa1[e.surface]
                       for e in ents)
    any_reflect = any(not sr0[e.surface] for e in ents)
    used_surfs = sorted({e.surface for e in ents})
    return (used_surfs, D >= 2 and (any_transmit or not prune),
            D >= 2 and (any_reflect or not prune))


def bounce_init(static, tables, org0: Vec, d0: Vec, differentiable=False,
                time=0.0):
    """Peel the primary node; returns (ar, ag, ab, slots, sp), with
    slots = sp = None when the scene statically has no deferred branches."""
    used_surfs, do_transmit, do_reflect = _bounce_plan(static,
                                                       differentiable)
    D = static.max_depth
    zf = torch.zeros_like(org0.x)
    zi = torch.zeros_like(org0.x, dtype=torch.int32)
    zvec = Vec(zf, zf, zf, zf)

    ar, ag, ab, branches = _shade_node(
        static, tables, org0, d0, torch.ones_like(zf),
        torch.full_like(zi, static.ambient), torch.full_like(zi, D),
        torch.ones_like(zf, dtype=torch.bool), differentiable,
        used_surfs, do_transmit, do_reflect, depth_ge2=None, time=time)
    if not branches:
        return ar, ag, ab, None, None

    empty = (zvec, zvec, zf, zi, zi)
    slots = tuple(empty for _ in range(D + 1))
    sp = zi
    for k, (mask, val) in enumerate(branches):
        slots = write_slot(slots, sp, mask, val, kmax=k + 1)
        sp = sp + mask.to(torch.int32)
    return ar, ag, ab, slots, sp


def make_bounce_body(static, tables, differentiable=False, time=0.0):
    """One trip of the DFS loop: body(carry) with
    carry = (sp, ar, ag, ab, slots)."""
    used_surfs, do_transmit, do_reflect = _bounce_plan(static,
                                                       differentiable)

    def body(carry):
        sp, ar, ag, ab, slots = carry
        active = sp > 0
        top = torch.clamp(sp - 1, min=0)
        org, d, wgt, mat, depth = read_slot(slots, top)
        sp = torch.where(active, sp - 1, sp)

        dr, dg, db, branches = _shade_node(
            static, tables, org, d, wgt, mat, depth, active,
            differentiable, used_surfs, do_transmit, do_reflect,
            depth_ge2=(depth >= 2), time=time)
        ar, ag, ab = ar + dr, ag + dg, ab + db

        for mask, val in branches:
            slots = write_slot(slots, sp, mask, val)
            sp = sp + mask.to(torch.int32)
        return sp, ar, ag, ab, slots

    return body


def trace_batch(static, tables, org0: Vec, d0: Vec,
                differentiable: bool = False, time=0.0):
    """Trace a batch of primary rays; returns (r, g, b) shaped like org0.x.

    The primary node is peeled out of the loop; then at most
    ``max_nodes - 1`` trips run, stopping early once every stack is empty.
    A trip on empty stacks is a no-op for values and gradients alike, so the
    early stop serves autograd too (the JAX package runs every trip there
    only because lax.while_loop has no reverse-mode rule).
    ``differentiable=True`` turns off the pruning that is exact for values
    but not for gradients (``_bounce_plan`` and the Schlick skip); pass it
    when taking gradients through the render.  ``time`` is the scene time
    the expression materials read as ``t``.
    """
    ar, ag, ab, slots, sp = bounce_init(static, tables, org0, d0,
                                        differentiable, time)
    if slots is None:
        return ar, ag, ab
    body = make_bounce_body(static, tables, differentiable, time)
    carry = (sp, ar, ag, ab, slots)
    it = 0
    while it < static.max_nodes - 1 and bool(torch.any(carry[0] > 0)):
        carry = body(carry)
        it += 1
    _, ar, ag, ab, _ = carry
    return ar, ag, ab


# ---------------------------------------------------------------------------
# camera rays + whole-image renderer
# ---------------------------------------------------------------------------

def camera_rays(cam, xi, yi, W: int, H: int):
    """Pinhole rays; the camera frame is re-orthonormalised (Gram-Schmidt)."""
    f = V.normalize(V.from_array(cam.forward))
    r0 = V.from_array(cam.right)
    r = V.normalize(V.madd(r0, -V.dot(r0, f), f))
    u0 = V.from_array(cam.up)
    u1 = V.madd(u0, -V.dot(u0, f), f)
    u = V.normalize(V.madd(u1, -V.dot(u1, r), r))

    aspect = W / H
    t = cam.tan_half_fov
    ndx = ((xi + 0.5) / V.const(W, xi) * 2.0 - 1.0) * (aspect * t)
    ndy = (1.0 - (yi + 0.5) / V.const(H, yi) * 2.0) * t
    d = V.normalize(Vec(f.x + ndx * r.x + ndy * u.x,
                        f.y + ndx * r.y + ndy * u.y,
                        f.z + ndx * r.z + ndy * u.z,
                        f.w + ndx * r.w + ndy * u.w))
    org = V.splat(V.from_array(cam.position), xi.shape)
    return org, d


def render_image(static, tables, cam, H: int, W: int, time=0.0, y0: int = 0,
                 rows: int | None = None,
                 differentiable: bool = False) -> torch.Tensor:
    """Render rows [y0, y0 + rows) of the H x W frame -> [rows or H, W, 3]
    in the tables' dtype on their device.  The camera's NDC mapping stays the full
    frame's, so slabs tile the frame exactly.  ``time`` is the scene time
    of time-dependent (expression) materials, a float or a float32 tensor
    that autograd differentiates.  Pass ``differentiable=True`` when taking
    gradients (``trace_batch``)."""
    dev, dt = tables.surf_color.device, tables.surf_color.dtype
    R = H if rows is None else rows
    yi = (torch.arange(R, dtype=dt, device=dev) + float(y0))
    xi = torch.arange(W, dtype=dt, device=dev)
    yi, xi = yi[:, None].expand(R, W), xi[None, :].expand(R, W)
    org, d = camera_rays(cam, xi, yi, W, H)
    r, g, b = trace_batch(static, tables, org, d, differentiable, time)
    return torch.stack([r, g, b], dim=-1)


def render_rays(static, tables, cam, xi, yi, W: int, H: int,
                differentiable: bool = False, time=0.0):
    """Trace an arbitrary batch of pixel coordinates (sub-tile / sparse)
    -> (r, g, b), each shaped like ``xi``, in the tables' dtype on their
    device.

    The counterpart of ``euclider_tpu/ops/trace.py::render_rays``, which
    runs outside the Pallas kernel: ``camera_rays`` + ``trace_batch`` of
    this plain version, on whatever device the tables are (no kernel takes
    a sparse batch of pixels).  No viewer or CLI path calls it."""
    dev, dt = tables.surf_color.device, tables.surf_color.dtype
    xi = torch.as_tensor(xi, dtype=dt, device=dev)
    yi = torch.as_tensor(yi, dtype=dt, device=dev)
    org, d = camera_rays(cam, xi, yi, W, H)
    return trace_batch(static, tables, org, d, differentiable, time)
