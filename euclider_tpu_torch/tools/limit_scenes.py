"""Scenes past the CUDA kernels' old fixed limits, and the counts that show
each limit is passed.

Until the kernels took a wider build for a scene that needs one
(``ops/cuda_kernel.py::capacities``), they refused five kinds of scene
that the JAX package renders and differentiates: a ray tree of more than
16 stack slots, an entity of more than 32 shape nodes, an expression
material of more than 128 VM instructions, a marching scene of more than
32 entities, and a march of more than 512 steps in the backward.  They
also refused a texture of more than 16,384 texels on a side, which needs
no wider build.  Each scene here passes one of these limits, built from
the port's own scene IR:

    config2_d24        config2 at max_depth 24, max_nodes 63 (the tape
                       backward), its glass sphere made more reflective
                       (0.7) so that chains of internal reflections keep
                       more than 16 branches pending: the stack
    config2_d24_deep   the same at max_nodes 255 (the segmented backward)
    csg48              a CSG body of 48 nodes (24 spheres less 21), smooth,
                       over config3's floor: membership
    config6_long       config6 with harmonics of its own parameters added
                       to its field, 328 VM instructions: the VM
    config5_crowd      config5 with a ring of 40 small spheres around the
                       attractor inside its warp region, 45 entities: the
                       side mask
    config5_fine       config5 at march_steps 1,280 and a quarter of its
                       warp step: the march checkpoints
    csg80, config5_crowd72   past 64 nodes and 64 marching entities (the
                       C++ oracle stops at 64), for the CPU tests
    config3_strips     config3 with its blob textured by a strip of 2 x
                       40,961 texels and its cut sphere by one of 40,961 x
                       2, a walk from a fixed seed: the texture side (past
                       2^15 texels, float32 texel coordinates keep 8
                       fractional bits)

``passed`` counts, on the plain version's render of a slab, what shows
the old limit passed there, and what of it the slab's pixels reach.  CPU
or CUDA tables; no JAX.
"""
from __future__ import annotations

import math
from dataclasses import replace

import numpy as np
import torch

OLD_SLOTS = 16          # the stack's old capacity
OLD_NODES = 32          # shape nodes of one entity
OLD_EXPR = 128          # VM instructions of one material
OLD_ENTITIES = 32       # entities of a marching scene
OLD_MARCH_STEPS = 512   # march steps the backward held (16 x 32 checkpoints)
OLD_TEX_SIDE = 16384    # texels on a side of a texture
STRIP = (2, 40961)      # config3_strips' textures: texels across and along


def _config2_glassy(max_nodes):
    from ..scene import ir
    from ..scene.library import get_scene
    sc = get_scene("config2_mirror_glass")
    ents = tuple(replace(e, surface=ir.UniformSurface(
        (0.9, 0.95, 1.0, 0.08), reflectivity=0.7)) if e.name == "glass"
        else e for e in sc.entities)
    return replace(sc, name="config2_d24" if max_nodes == 63
                   else "config2_d24_deep", entities=ents,
                   settings=replace(sc.settings, max_depth=24,
                                    max_nodes=max_nodes))


def _csg(n_in, n_out, name):
    """difference(union of n_in spheres, union of n_out spheres): a
    knobbly arch over config3's floor, 1 + (n_in + 1) + (n_out + 1) nodes,
    its smooth surface giving the geometry a gradient."""
    from ..scene import ir
    from ..scene.library import get_scene
    c3 = get_scene("config3_csg_textured")
    body = ir.Csg("union", tuple(
        ir.Sphere((-1.8 + 3.6 * i / (n_in - 1),
                   -0.2 + 0.5 * math.sin(math.pi * i / (n_in - 1)), -4.8),
                  0.42) for i in range(n_in)))
    holes = ir.Csg("union", tuple(
        ir.Sphere((-1.7 + 3.4 * i / (n_out - 1),
                   0.05 + 0.5 * math.sin(math.pi * i / (n_out - 1)), -4.4),
                  0.22) for i in range(n_out)))
    ent = ir.Entity(ir.Csg("difference", (body, holes)),
                    surface=ir.SmoothSurface(uv_scale=1.5, reflectivity=0.1),
                    name="arch")
    floor = next(e for e in c3.entities if e.name == "floor")
    return replace(c3, name=name, entities=(ent, floor), textures=())


def _config6_long():
    """config6 with harmonics k = 2..12 of its own field added to ax and
    ay, each from its parameters p0, p1 and new amplitudes p2, p3."""
    from ..scene import ir
    from ..scene.library import get_scene
    sc = get_scene("config6_expr_space")
    mat = next(e.material for e in sc.entities
               if isinstance(e.material, ir.ExprSpace))
    ks = range(2, 13)
    ax = mat.ax + "".join(f" + p2 / {k} * sin({k} * p1 * y + p1 * z)"
                          for k in ks)
    ay = mat.ay + "".join(f" + p3 / {k} * cos({k} * p1 * x) * 0.5"
                          for k in ks)
    long = replace(mat, ax=ax, ay=ay, params=tuple(mat.params) + (0.2, 0.1))
    return replace(sc, name="config6_long", entities=tuple(
        replace(e, material=long) if e.material is mat else e
        for e in sc.entities))


def _config5_crowd(n, name):
    """config5 with a ring of n small spheres around the attractor, inside
    the warp region, each with its own uniform surface, so that marched
    rays pass and cross them.  The ring comes first: config5's own
    entities, the warp region's boundary that every march crosses among
    them, take the side mask's bits past the 32nd."""
    from ..scene import ir
    from ..scene.library import get_scene
    sc = get_scene("config5_warp_portal")
    balls = tuple(ir.Entity(
        ir.Sphere((1.15 * math.cos(2 * math.pi * i / n),
                   0.2 + 1.15 * math.sin(2 * math.pi * i / n), -5.0), 0.09),
        surface=ir.UniformSurface((0.3 + 0.6 * i / n, 0.8 - 0.5 * i / n,
                                   0.4, 1.0)),
        name=f"ring{i}") for i in range(n))
    return replace(sc, name=name, entities=balls + sc.entities)


def _config5_fine():
    from ..scene import ir
    from ..scene.library import get_scene
    sc = get_scene("config5_warp_portal")
    ents = tuple(replace(e, material=replace(e.material,
                                             step=e.material.step / 4))
                 if isinstance(e.material, ir.WarpSpace) else e
                 for e in sc.entities)
    return replace(sc, name="config5_fine", entities=ents,
                   settings=replace(sc.settings, march_steps=1280))


def strip_texels(shape, rng) -> np.ndarray:
    """[h, w, 3] float32 texels, row-major, a walk in [0.05, 0.95]: each
    step 0.0036 to 0.0108 up or down (drawn from ``rng``) in each channel,
    folded back at the ends, so that every texel differs from the one
    before it and a wrong texel shows in the frame's bits.  A walk, not
    independent draws: sampled by 32 x 24 pixels, independent texels
    40,961 a strip make the geometry's gradients so large that the
    camera's up vector, whose gradient is zero in 3D, sums them to float32
    noise past the gradient rule (1.8 and 4.5 times it for two seeds of
    config3_strips; the plain version's float32 sum against the harness's
    float64).  The walk keeps it within a fifth of the rule."""
    n = shape[0] * shape[1]
    steps = rng.uniform(0.004, 0.012, (n, 3)) * rng.choice([-1.0, 1.0],
                                                           (n, 3))
    x = np.mod(0.5 + np.cumsum(steps, axis=0), 2.0)
    tri = 1.0 - np.abs(x - 1.0)                   # folded into [0, 1]
    return (0.05 + 0.9 * tri).reshape(shape + (3,)).astype(np.float32)


def _config3_strips():
    """config3 with its blob textured by a wide strip (texture 0, [2,
    40961, 3]) and its cut sphere by a tall one (texture 1, [40961, 2,
    3]), their texels a walk from a fixed seed (``strip_texels``).  The
    floor keeps its checker: textured, its grazing far hits give
    per-pixel gradients whose float32 noise alone reaches two thirds of
    the gradient rule."""
    from ..scene import ir
    from ..scene.library import get_scene
    sc = get_scene("config3_csg_textured")
    rng = np.random.default_rng(16)
    across, along = STRIP
    wide = strip_texels((across, along), rng)
    tall = strip_texels((along, across), rng)
    ents = tuple(replace(e, surface=ir.TextureSurface(texture_id=1,
                                                      uv_scale=2.0))
                 if e.name == "cut_sphere" else e for e in sc.entities)
    return replace(sc, name="config3_strips", entities=ents,
                   textures=(wide.tolist(), tall.tolist()))


BUILDERS = {
    "config2_d24": lambda: _config2_glassy(63),
    "config2_d24_deep": lambda: _config2_glassy(255),
    "csg48": lambda: _csg(24, 21, "csg48"),
    "config6_long": _config6_long,
    "config5_crowd": lambda: _config5_crowd(40, "config5_crowd"),
    "config5_fine": _config5_fine,
    "csg80": lambda: _csg(40, 37, "csg80"),
    "config5_crowd72": lambda: _config5_crowd(67, "config5_crowd72"),
    "config3_strips": _config3_strips,
}
# the slab the CPU tests take of every scene, (H, W, y0, rows): rows where
# each passes its old limit
SLAB = (24, 32, 8, 4)
# which old limit each scene passes
LIMIT = {"config2_d24": "stack", "config2_d24_deep": "stack",
         "csg48": "membership", "csg80": "membership", "config6_long": "vm",
         "config5_crowd": "side mask", "config5_crowd72": "side mask",
         "config5_fine": "march checkpoints",
         "config3_strips": "texture side"}


def get_scene(name: str):
    if name in BUILDERS:
        return BUILDERS[name]()
    raise KeyError(f"unknown scene {name!r}; have {sorted(BUILDERS)}")


def _rays(cam, H, W, y0, rows, device):
    from ..ops import trace
    yi = torch.arange(y0, y0 + rows, dtype=torch.float32,
                      device=device)[:, None].expand(rows, W)
    xi = torch.arange(W, dtype=torch.float32,
                      device=device)[None, :].expand(rows, W)
    return trace.camera_rays(cam, xi, yi, W, H)


def stack_peak(static, tables, cam, H, W, y0=0, rows=None) -> torch.Tensor:
    """The most branches a pixel's stack held at once in the plain render
    of rows [y0, y0 + rows) -> int32 [rows, W]."""
    from ..ops import trace
    rows = H if rows is None else rows
    org, d = _rays(cam, H, W, y0, rows, tables.surf_color.device)
    ar, ag, ab, slots, sp = trace.bounce_init(static, tables, org, d)
    if slots is None:
        return torch.zeros((rows, W), dtype=torch.int32)
    peak = sp.clone()
    body = trace.make_bounce_body(static, tables)
    carry = (sp, ar, ag, ab, slots)
    for _ in range(static.max_nodes - 1):
        if not bool((carry[0] > 0).any()):
            break
        carry = body(carry)
        peak = torch.maximum(peak, carry[0])
    return peak


def march_lengths(static, tables, cam, H, W, y0=0, rows=None
                  ) -> torch.Tensor:
    """Steps of every march of the plain render of rows [y0, y0 + rows):
    one entry a marching ray of each march (a shaded node) -> int32 [n]."""
    from ..ops import march as M
    from ..ops import trace
    rows = H if rows is None else rows
    make_body = M.make_march_body
    counts = []

    def counting(*args):
        body = make_body(*args)
        live = []
        counts.append(live)

        def step(carry):
            n = (~carry[2]).to(torch.int32)
            if live:
                live[0] += n
            else:
                live.append(n)
            return body(carry)

        return step

    M.make_march_body = counting
    try:
        trace.render_image(static, tables, cam, H, W, y0=y0, rows=rows)
    finally:
        M.make_march_body = make_body
    live = [c[0][c[0] > 0] for c in counts if c]
    return torch.cat(live) if live else torch.zeros(0, dtype=torch.int32)


def _shaded_hits(static, tables, cam, H, W, y0, rows, visit) -> None:
    """Render rows [y0, y0 + rows) with the plain version, calling
    ``visit(hit, out)`` on every shaded node: ``out`` its ``propagate``
    result (hit, p, dir, ent, normal, u, v), ``hit`` its hits among the
    node's active rays."""
    from ..ops import trace
    shade_node, propagate = trace._shade_node, trace.propagate
    active = [None]

    def shading(*args, **kw):
        active[0] = args[7]          # _shade_node's `active`
        return shade_node(*args, **kw)

    def propagating(*args, **kw):
        out = propagate(*args, **kw)
        visit(out[0] & active[0], out)
        return out

    trace._shade_node, trace.propagate = shading, propagating
    try:
        trace.render_image(static, tables, cam, H, W, y0=y0, rows=rows)
    finally:
        trace._shade_node, trace.propagate = shade_node, propagate


def entity_hits(static, tables, cam, H, W, y0=0, rows=None) -> list:
    """Shaded nodes of the plain render of rows [y0, y0 + rows) that hit
    each entity, marched or not -> [n_ent] ints."""
    hits = torch.zeros(len(static.entities), dtype=torch.int64,
                       device=tables.surf_color.device)

    def visit(hit, out):
        hits.add_(torch.bincount(out[3][hit].long(), minlength=len(hits)))

    _shaded_hits(static, tables, cam, H, W, y0, rows, visit)
    return hits.tolist()


def texel_hits(static, tables, cam, H, W, y0=0, rows=None) -> tuple:
    """Shaded nodes of the plain render of rows [y0, y0 + rows) that hit a
    textured entity -> (their count, the count of them whose bilinear
    cell (shading.sample_texture's x0, y0) lies at a texel column or row
    of OLD_TEX_SIDE or past it, that count by texture)."""
    from ..ops import shading
    hits = torch.zeros(2 + len(tables.textures), dtype=torch.int64,
                       device=tables.surf_color.device)

    def visit(hit, out):
        ent, u, v = out[3], out[5], out[6]
        for ei, e in enumerate(static.entities):
            s = e.surface
            if static.surf_kinds[s] != "texture":
                continue
            tid = static.surf_texture[s]
            th, tw = tables.textures[tid].shape[:2]
            sc = tables.surf_uv_scale[s]
            x0 = torch.floor(shading.mod1(u * sc) * (tw - 1))
            yc = torch.floor(shading.mod1(v * sc) * (th - 1))
            on = hit & (ent == ei)
            past = (on & ((x0 >= OLD_TEX_SIDE) | (yc >= OLD_TEX_SIDE))).sum()
            hits[0] += on.sum()
            hits[1] += past
            hits[2 + tid] += past

    _shaded_hits(static, tables, cam, H, W, y0, rows, visit)
    textured, past, *by_texture = hits.tolist()
    return textured, past, by_texture


def passed(name, static, tables, cam, H, W, y0=0, rows=None) -> dict:
    """The count that shows scene ``name`` passes its old limit on rows
    [y0, y0 + rows) of the H x W frame: {"limit", "count", "old", "what",
    ...}; ``count`` > 0 (or > ``old``) where the limit is passed."""
    from ..ops.cuda_kernel import needs
    limit = LIMIT[name]
    if limit == "stack":
        peak = stack_peak(static, tables, cam, H, W, y0, rows)
        return {"limit": limit, "old": OLD_SLOTS,
                "count": int((peak > OLD_SLOTS).sum()),
                "what": f"pixels whose stack held more than {OLD_SLOTS} "
                        "pending branches",
                "peak": int(peak.max()), "pixels": int(peak.numel())}
    if limit == "membership":
        hits = entity_hits(static, tables, cam, H, W, y0, rows)
        return {"limit": limit, "old": OLD_NODES,
                "count": needs(static)["nodes"],
                "what": "shape nodes of the largest entity",
                "hits": hits[0]}
    if limit == "texture side":
        textured, past, by_texture = texel_hits(static, tables, cam, H, W,
                                                y0, rows)
        return {"limit": limit, "old": OLD_TEX_SIDE, "count": past,
                "what": "textured hits at a texel column or row of "
                        f"{OLD_TEX_SIDE} or past it",
                "textured_hits": textured, "by_texture": by_texture,
                "sides": [list(t.shape[:2]) for t in tables.textures]}
    lengths = march_lengths(static, tables, cam, H, W, y0, rows)
    if limit == "vm":
        return {"limit": limit, "old": OLD_EXPR,
                "count": needs(static)["expr"],
                "what": "VM instructions of the expression material",
                "marches": int(lengths.numel())}
    if limit == "side mask":
        hits = entity_hits(static, tables, cam, H, W, y0, rows)
        return {"limit": limit, "old": OLD_ENTITIES,
                "count": len(static.entities), "what": "entities",
                "marches": int(lengths.numel()),
                "hits_past_old": sum(hits[OLD_ENTITIES:])}
    return {"limit": limit, "old": OLD_MARCH_STEPS,
            "count": int((lengths > OLD_MARCH_STEPS).sum()),
            "what": f"marches longer than {OLD_MARCH_STEPS} steps",
            "longest": int(lengths.max()) if lengths.numel() else 0,
            "marches": int(lengths.numel())}


def is_passed(rec: dict) -> bool:
    """Whether a ``passed`` record shows the old limit passed by the slab's
    pixels: the CSG body hit, the expression region marched, an entity past
    the old count hit by the march, a texel past the old side sampled."""
    if rec["limit"] in ("stack", "march checkpoints", "texture side"):
        return rec["count"] > 0
    seen = {"membership": rec.get("hits"), "vm": rec.get("marches"),
            "side mask": min(rec.get("marches", 0),
                             rec.get("hits_past_old", 0))}[rec["limit"]]
    return rec["count"] > rec["old"] and seen > 0
