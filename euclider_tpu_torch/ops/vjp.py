"""The plain versions of the backward kernels: row-blocked autograd VJPs.

``vjp_blocked`` is the port of ``euclider_tpu/ops/pallas_kernel.py::
vjp_blocked``.  Autograd of the
whole-frame differentiable render would keep the trace loop's tape for every
pixel at once; the pixel sum in any loss is linear over rows, so the VJP is
taken one block of rows at a time and the blocks' gradients are summed.
Peak memory is one block's tape, and the result is the autograd VJP of
``trace.render_image(..., differentiable=True)`` up to the order of the
float32 sums.

``csrc/trace_bwd.cu`` (through ``ops/cuda_bwd.py``) is held against this
function on the card; on the CPU it is the backward the port runs.

``vjp_segmented`` computes the same VJP with the structure of the JAX
package's ``vjp_pallas_segmented``: the peel and chunks of bounce trips
run without a graph and keep every boundary carry, then each chunk is re-run
from its carry under autograd in reverse order, passing the cotangent of
its carry to the chunk before.  It is the plain version of the segmented
kernels (K6, K7) and nothing else runs it.
"""
from __future__ import annotations

import torch

from ..scene.compile import CameraParams, SceneTables
from . import trace
from .cuda_kernel import FLOAT_FIELDS   # the tables that get gradients
from .vec import Vec

# Autograd through a march keeps every step of every marching pixel of the
# block: a 64-row block of config5's 1280-wide frame peaked at 6.3 GiB on
# the H100 (PERF.md), far within its 80 GB.
BWD_BLOCK_ROWS = 64
# bounce trips per chunk of the segmented backward (pallas_kernel.py
# CHUNK_TRIPS)
CHUNK_TRIPS = 16


def zero_grads(tables, cam):
    """Zero cotangents shaped like (tables, cam): the fields that get no
    gradient keep these."""
    zt = SceneTables(**{k: torch.zeros_like(v)
                        for k, v in tables._asdict().items()
                        if k != "textures"},
                     textures=tuple(torch.zeros_like(t)
                                    for t in tables.textures))
    return zt, CameraParams(*(torch.zeros_like(v) for v in cam))


def vjp_blocked(static, tables, cam, H: int, W: int, g,
                block_rows: int = BWD_BLOCK_ROWS, time=0.0, y0: int = 0,
                rows: int | None = None):
    """VJP of the render of rows [y0, y0 + rows) of the H x W frame under
    the cotangent ``g`` [rows or H, W, 3] -> (d_tables, d_cam, d_time).

    Gradients flow to the float tables of ``FLOAT_FIELDS``, to every texel
    of the textures, to every camera field and to ``time`` (through the
    expression materials that read ``t``); the other tables get zeros."""
    R = H if rows is None else rows
    if tuple(g.shape) != (R, W, 3):
        raise ValueError(f"cotangent shape {tuple(g.shape)} != {(R, W, 3)}")
    d_tables, d_cam = zero_grads(tables, cam)
    d_time = torch.zeros((), dtype=torch.float32, device=g.device)
    n, nt = len(FLOAT_FIELDS), len(tables.textures)
    acc = ([getattr(d_tables, k) for k in FLOAT_FIELDS]
           + list(d_tables.textures) + list(d_cam) + [d_time])
    for by0 in range(0, R, block_rows):
        bh = min(block_rows, R - by0)
        with torch.enable_grad():
            leaves = [getattr(tables, k).detach().requires_grad_(True)
                      for k in FLOAT_FIELDS]
            texs = [t.detach().requires_grad_(True) for t in tables.textures]
            cam_l = [v.detach().requires_grad_(True) for v in cam]
            time_l = torch.as_tensor(time, dtype=torch.float32,
                                     device=g.device).detach().requires_grad_(
                                         True)
            tab = tables._replace(**dict(zip(FLOAT_FIELDS, leaves)),
                                  textures=tuple(texs))
            img = trace.render_image(static, tab, CameraParams(*cam_l), H, W,
                                     time_l, y0 + by0, bh,
                                     differentiable=True)
            grads = torch.autograd.grad(img, leaves + texs + cam_l + [time_l],
                                        g[by0:by0 + bh].to(img.dtype),
                                        allow_unused=True)
        for a, gr in zip(acc, grads):
            if gr is not None:
                a += gr
    d_tables = d_tables._replace(**dict(zip(FLOAT_FIELDS, acc[:n])),
                                 textures=tuple(acc[n:n + nt]))
    return d_tables, CameraParams(*acc[n + nt:-1]), acc[-1]


def chunk_sizes(max_nodes: int, chunk_trips: int = CHUNK_TRIPS) -> list:
    """The trips of each chunk of the segmented backward: the
    ``max_nodes - 1`` bounce trips in K = ceil(trips / chunk_trips) chunks
    of c = ceil(trips / K), the last one taking the rest, so the chunks sum
    to the trips exactly (``vjp_pallas_segmented``; more would pop nodes the
    forward never shaded)."""
    trips = max_nodes - 1
    if trips <= 0:
        return []
    K = -(-trips // chunk_trips)
    c = -(-trips // K)
    return [c] * (K - 1) + [trips - (K - 1) * c]


def _carry_floats(carry):
    """The float leaves of a (sp, ar, ag, ab, slots) carry: the colour
    sums, then each slot's origin, direction and weight."""
    _, ar, ag, ab, slots = carry
    return [ar, ag, ab] + [x for org, d, w, _, _ in slots
                           for x in (*org, *d, w)]


def _with_floats(carry, fl):
    """``carry`` with its float leaves replaced by ``fl``."""
    it = iter(fl[3:])
    slots = tuple((Vec(*(next(it) for _ in range(4))),
                   Vec(*(next(it) for _ in range(4))), next(it), mat, depth)
                  for _, _, _, mat, depth in carry[4])
    return (carry[0], fl[0], fl[1], fl[2], slots)


def _run_chunk(body, carry, trips: int):
    """``trips`` bounce trips; the stacks' emptying ends them early, as
    ``trace.trace_batch`` does (an empty trip changes nothing)."""
    for _ in range(trips):
        if not bool(torch.any(carry[0] > 0)):
            break
        carry = body(carry)
    return carry


def _grad(outs, inputs, gouts):
    """torch.autograd.grad over the outputs that carry a graph."""
    pairs = [(o, g) for o, g in zip(outs, gouts) if o.requires_grad]
    if not pairs:
        return [None] * len(inputs)
    return torch.autograd.grad([o for o, _ in pairs], inputs,
                               [g for _, g in pairs], allow_unused=True)


def _peel(static, tab, cam, xi, yi, W: int, H: int, time):
    """The primary node of pixels (xi, yi): its colour sums, or the carry
    (sp, ar, ag, ab, slots) of a scene with deferred branches."""
    org, d = trace.camera_rays(cam, xi, yi, W, H)
    ar, ag, ab, slots, sp = trace.bounce_init(static, tab, org, d, True, time)
    return [ar, ag, ab] if slots is None else (sp, ar, ag, ab, slots)


def _carries(static, tab, carry, sizes, time) -> list:
    """Each chunk's start carry, from the peel's ``carry``: the bounce
    trips of ``sizes`` run chunk after chunk."""
    carries = []
    if isinstance(carry, tuple):
        body = trace.make_bounce_body(static, tab, True, time)
        for trips in sizes:
            carries.append(carry)
            carry = _run_chunk(body, carry, trips)
    return carries


def segmented_forward(static, tables, cam, H: int, W: int, time=0.0,
                      chunk_trips: int = CHUNK_TRIPS) -> list:
    """The plain version of K6 on the H x W frame: the peel and the chunks
    of bounce trips without a graph -> each chunk's start carry (none for
    a scene without deferred branches).  ``vjp_segmented`` runs the same
    per block of rows."""
    dev = tables.surf_color.device
    yi = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    xi = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    with torch.no_grad():
        return _carries(static, tables,
                        _peel(static, tables, cam, xi, yi, W, H, time),
                        chunk_sizes(static.max_nodes, chunk_trips), time)


def vjp_segmented(static, tables, cam, H: int, W: int, g,
                  block_rows: int = BWD_BLOCK_ROWS, time=0.0, y0: int = 0,
                  rows: int | None = None, chunk_trips: int = CHUNK_TRIPS):
    """``vjp_blocked``'s VJP, taken chunk by chunk as the segmented kernels
    take it: per block of rows, the peel and the chunks of
    ``chunk_sizes(max_nodes, chunk_trips)`` trips run without a graph and
    keep each chunk's start carry; then, last chunk first, a chunk is re-run
    from its carry under autograd and differentiated with respect to the
    carry's floats and the parameters under the cotangent of its end carry
    (the colour sums get ``g``, the slots of the last carry zero), and the
    peel comes last.  -> (d_tables, d_cam, d_time)."""
    R = H if rows is None else rows
    if tuple(g.shape) != (R, W, 3):
        raise ValueError(f"cotangent shape {tuple(g.shape)} != {(R, W, 3)}")
    sizes = chunk_sizes(static.max_nodes, chunk_trips)
    d_tables, d_cam = zero_grads(tables, cam)
    d_time = torch.zeros((), dtype=torch.float32, device=g.device)
    n, nt = len(FLOAT_FIELDS), len(tables.textures)
    acc = ([getattr(d_tables, k) for k in FLOAT_FIELDS]
           + list(d_tables.textures) + list(d_cam) + [d_time])

    def add(grads):
        for a, gr in zip(acc, grads):
            if gr is not None:
                a += gr

    for by0 in range(0, R, block_rows):
        bh = min(block_rows, R - by0)
        leaves = [getattr(tables, k).detach().requires_grad_(True)
                  for k in FLOAT_FIELDS]
        texs = [t.detach().requires_grad_(True) for t in tables.textures]
        cam_l = [v.detach().requires_grad_(True) for v in cam]
        time_l = torch.as_tensor(time, dtype=torch.float32,
                                 device=g.device).detach().requires_grad_(True)
        params = leaves + texs + cam_l + [time_l]
        tab = tables._replace(**dict(zip(FLOAT_FIELDS, leaves)),
                              textures=tuple(texs))
        yi = (torch.arange(bh, dtype=torch.float32, device=g.device)
              + float(y0 + by0))[:, None].expand(bh, W)
        xi = torch.arange(W, dtype=torch.float32,
                          device=g.device)[None, :].expand(bh, W)

        def peel():
            return _peel(static, tab, CameraParams(*cam_l), xi, yi, W, H,
                         time_l)

        with torch.no_grad():
            carries = _carries(static, tab, peel(), sizes, time_l)
        gb = g[by0:by0 + bh].to(torch.float32)
        dfl = [gb[..., 0], gb[..., 1], gb[..., 2]]
        if carries:
            dfl += [torch.zeros_like(x) for x in _carry_floats(carries[0])[3:]]
        for k in reversed(range(len(carries))):
            with torch.enable_grad():
                fl = [x.detach().requires_grad_(True)
                      for x in _carry_floats(carries[k])]
                body = trace.make_bounce_body(static, tab, True, time_l)
                out = _run_chunk(body, _with_floats(carries[k], fl), sizes[k])
                grads = _grad(_carry_floats(out), fl + params, dfl)
            dfl = [torch.zeros_like(x) if gr is None else gr
                   for x, gr in zip(fl, grads)]
            add(grads[len(fl):])
        with torch.enable_grad():
            out = peel()
            out = out if isinstance(out, list) else _carry_floats(out)
            add(_grad(out, params, dfl))
    d_tables = d_tables._replace(**dict(zip(FLOAT_FIELDS, acc[:n])),
                                 textures=tuple(acc[n:n + nt]))
    return d_tables, CameraParams(*acc[n + nt:-1]), acc[-1]
