"""The backward render as hand-written CUDA kernels (``csrc/trace_bwd.cu``,
``csrc/trace_seg.cu``).

Counterpart of the Pallas kernels of the JAX package that compute the
reverse-mode VJP of the render.  The tape kernel ``trace_bwd``:
``pallas_vjp.py::_ckpt_kernel`` plain (K3, ``vjp_pallas_ckpt``) and
``pallas_kernel.py::_bwd_kernel`` (K5, ``vjp_pallas``) become ``vjp_cuda``;
``_ckpt_kernel`` fused (K2, ``train_step_pallas``) becomes
``train_step_cuda``.  One kernel serves both, in two modes, for trees of up
to ``MAX_TAPE`` nodes.  The segmented kernels ``trace_seg_fwd`` and
``trace_seg_bwd`` (K6 ``_seg_fwd_kernel`` and K7 ``_seg_bwd_kernel`` of
``pallas_kernel.py::vjp_pallas_segmented``) serve both modes too, for trees
of any ``max_nodes``: K6 stores the boundary carry of every chunk of
``chunk_trips`` bounce trips, K7 re-runs the chunks in reverse from it.
``backward="auto"`` takes the tape kernel up to ``MAX_TAPE`` nodes and the
segmented kernels beyond.  The march backward that K2 and K3 nest for warped
space (K4, ``pallas_vjp.py::make_march_ckpt``) runs inside every one of
them, through the attractor field or an expression material's VM program
(gradients of ``mat_expr_params`` and of the scene time).  The textures'
gradient comes from the kernels too, summed with atomics in its own buffer.
``render_image_diff`` is the port of ``render_image_pallas_diff``: the
forward kernel, then ``vjp_cuda``.

The wrappers take CUDA tensors only and never fall back: on any other
device they raise.  Tables, textures and camera of any floating dtype go
in as float32 (``cuda_kernel._check_tables``, ``_pack_camera``), and the
gradients come back in each primal's dtype, as the Pallas backward hands
them back (``pallas_kernel._grads_from_rows``); the loss is float32.
Each launch takes the build whose capacities hold its scene
(``cuda_kernel.library``): a deeper stack, more shape nodes, a longer
expression, more marching entities or more march checkpoints (one every
16 steps) than the default build's.  The plain versions are
``ops/vjp.py::vjp_blocked`` and, for the segmented kernels,
``ops/vjp.py::vjp_segmented``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..scene.compile import CameraParams
from . import cuda_kernel as CK
from .cuda_kernel import FLOAT_FIELDS
from .vjp import CHUNK_TRIPS, chunk_sizes, zero_grads

LAUNCHES = 0       # launches of trace_bwd made by vjp_cuda / train_step_cuda
SEG_LAUNCHES = 0   # launches of the segmented kernels, K6 then K7 (one a call)

MAX_TAPE = 63      # nodes of trace_bwd's tape, and of a segmented chunk
BLOCK = (32, 8)    # the kernels' block: one column of partial sums per block
SLOT_WORDS = 11    # a stack slot in the segmented carry (trace_seg.cu)
BACKWARDS = ("auto", "tape", "segmented")

_ARGS = ([ctypes.c_void_p] * 3 + [ctypes.c_float] + [ctypes.c_void_p] * 2
         + [ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_float,
                                 ctypes.c_int])


@functools.lru_cache(maxsize=None)
def _entry(name: str, segmented: bool):
    """The C entry point of the tape kernel (euclider_trace_bwd) or of the
    segmented kernels (euclider_trace_seg) in library ``name``, built and
    loaded once."""
    lib = ctypes.CDLL(CK.build((name,))[name])
    if segmented:
        fn = lib.euclider_trace_seg
        fn.argtypes = _ARGS + [ctypes.c_int] + [ctypes.c_void_p,
                                               ctypes.c_longlong] * 3 + [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    else:
        fn = lib.euclider_trace_bwd
        fn.argtypes = _ARGS + [ctypes.c_void_p, ctypes.c_longlong,
                               ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _config_entry(name: str):
    """euclider_trace_bwd_config of the tape kernel's library ``name``."""
    fn = ctypes.CDLL(CK.build((name,))[name]).euclider_trace_bwd_config
    fn.argtypes = [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    return fn


def launch_config(static, tables) -> dict:
    """The launch configuration trace_bwd takes for the scene on the
    tables' CUDA device, chosen by size at each launch (trace_adj.cuh
    bwd_plan): threads a block, dynamic shared memory, active blocks an SM
    and where each thread's gradient vector lives ("shared": a column of
    the block's shared memory, where that keeps two blocks an SM, or one in
    a build without the expression VM; else "local")."""
    device = _device(tables, "launch_config")
    floats = CK._check_tables(static, tables, device)
    _, _, params, _ = CK.scene_args(static, floats, device,
                                    CK.tex_shapes(tables))
    sizes, _ = grad_layout(static, floats)
    info = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        rc = _config_entry(CK.library("trace_bwd", static))(params, sizes,
                                                            info)
    if rc != 0:
        raise RuntimeError(f"euclider_trace_bwd_config failed: cudaError {rc}")
    return {"threads": info[0], "dyn_smem_bytes": info[1],
            "blocks_per_sm": info[2],
            "grad_storage": {1: "shared", 2: "local"}[info[3]]}


def _device(tables, what):
    device = tables.surf_color.device
    if device.type != "cuda":
        raise ValueError(f"{what} takes tables on a CUDA device, got "
                         f"{device}; ops.vjp.vjp_blocked is the plain "
                         "version")
    return device


MARCH_TABLES = ("mat_warp_center", "mat_warp_strength", "mat_warp_step",
                "portal_lin", "portal_tr")


def _in_grad(static, name) -> bool:
    """Whether the kernel's gradient vector holds the table: not the tables
    a scene's build never reads (their gradient is zero), the march's and
    the portals' in the straight build and mat_expr_params outside the VM
    build.  Every thread reduces the whole vector in the kernel's epilogue,
    so its length is paid per pixel."""
    if name in MARCH_TABLES:
        return CK.marches(static)
    return name != "mat_expr_params" or CK.has_expr(static)


def _grad_sizes(static, floats):
    """numel of each float table in the kernel's gradient vector."""
    return [t.numel() if _in_grad(static, k) else 0
            for k, t in zip(FLOAT_FIELDS, floats)]


def route(static, backward: str = "auto",
          chunk_trips: int = CHUNK_TRIPS) -> str:
    """The kernels a backward of ``static`` takes: 'tape' (trace_bwd) or
    'segmented' (K6, K7).  'auto' is the tape up to MAX_TAPE nodes and the
    segmented kernels beyond; a tape asked for past MAX_TAPE nodes, or a
    chunk of more trips than a tape holds, raises ``ValueError``."""
    if backward not in BACKWARDS:
        raise ValueError(f"backward {backward!r} not in {BACKWARDS}")
    if backward == "auto":
        backward = "tape" if static.max_nodes <= MAX_TAPE else "segmented"
    if backward == "tape" and static.max_nodes > MAX_TAPE:
        raise ValueError(f"max_nodes {static.max_nodes} exceeds the tape "
                         f"kernel's {MAX_TAPE} nodes; backward='segmented' "
                         "or 'auto' takes it")
    if backward == "segmented" and not 1 <= chunk_trips <= MAX_TAPE:
        raise ValueError(f"chunk_trips {chunk_trips} is not in 1..{MAX_TAPE}")
    return backward


def grad_layout(static, floats):
    """(the table rows the kernels' ``sizes`` argument takes, the length of
    their gradient vector: the camera row, ``_grad_sizes``, the loss)."""
    fields = dict(zip(FLOAT_FIELDS, floats))
    sizes = (ctypes.c_int * 6)(*(
        fields[k].shape[0] if _in_grad(static, k) else 0
        for k in ("shape_vec", "mat_ior", "surf_color", "mat_warp_strength",
                  "portal_tr", "mat_expr_params")))
    return sizes, 24 + sum(_grad_sizes(static, floats)) + 1


def _carry(static, rows, W, chunk_trips, device):
    """The segmented kernels' carry buffer (trace_seg.cu: K chunks of
    1 + 11 (max_depth + 1) words a pixel), allocated once per call."""
    K = len(chunk_sizes(static.max_nodes, chunk_trips))
    words = K * (1 + SLOT_WORDS * (static.max_depth + 1)) * rows * W
    try:
        return torch.empty(max(words, 1), dtype=torch.float32, device=device)
    except torch.cuda.OutOfMemoryError as e:
        raise MemoryError(
            f"the segmented backward's carry takes {4 * words / 2 ** 30:.2f} "
            f"GiB ({K} chunks of {chunk_trips} trips, "
            f"{1 + SLOT_WORDS * (static.max_depth + 1)} words a pixel, "
            f"{rows}x{W} pixels), more than the device has free; take the "
            "backward in row slabs (y0, rows) or with a larger chunk_trips")\
            from e


def _launch(static, floats, cam_row, H, W, rows, gin, norm, fused,
            tex_shapes, backward="auto", chunk_trips=CHUNK_TRIPS):
    """Run the backward kernels ``route`` picks on the slab with the float
    tables in FLOAT_FIELDS order and the texel buffer
    (``CK._check_tables``) -> (the flat gradient vector [P + 1]: the camera
    row (24, the scene time's gradient at 17), the float tables in
    FLOAT_FIELDS order (``_grad_sizes``), the loss; the texel buffer's
    gradient)."""
    global LAUNCHES, SEG_LAUNCHES
    device = cam_row.device
    kind = route(static, backward, chunk_trips)
    sizes, n = grad_layout(static, floats)
    if tuple(gin.shape) != (rows, W, 3):
        raise ValueError(f"{'target' if fused else 'cotangent'} shape "
                         f"{tuple(gin.shape)} != {(rows, W, 3)}")
    gin = gin.detach().to(device=device, dtype=torch.float32).contiguous()
    iptr, fptr, params, _ints = CK.scene_args(static, floats, device,
                                              tex_shapes)
    n_blocks = -(-W // BLOCK[0]) * -(-rows // BLOCK[1])
    partials = torch.empty(n * n_blocks, dtype=torch.float32, device=device)
    out = torch.zeros(n, dtype=torch.float32, device=device)
    gtex = torch.zeros_like(floats[-1])
    args = (iptr, fptr, params, static.t_max, sizes, CK.camera_ptr(cam_row),
            H, W, rows, gin.data_ptr(), float(norm), int(fused))
    tail = (partials.data_ptr(), partials.numel(), out.data_ptr(),
            gtex.data_ptr(), device.index,
            torch.cuda.current_stream(device).cuda_stream)
    if kind == "tape":
        rc = _entry(CK.library("trace_bwd", static), False)(*args, *tail)
        CK.check_launch("trace_bwd", rc)
        LAUNCHES += 1
    else:
        carry = _carry(static, rows, W, chunk_trips, device)
        acc = torch.empty(4 * rows * W, dtype=torch.float32, device=device)
        rc = _entry(CK.library("trace_seg", static), True)(
            *args, chunk_trips, carry.data_ptr(), carry.numel(),
            acc.data_ptr(), acc.numel(), *tail)
        CK.check_launch("trace_seg", rc)
        SEG_LAUNCHES += 1
    return out, gtex


def _split(static, flat, floats):
    """Flat gradient -> (d_cam_row [24], [d_table per FLOAT_FIELDS], loss)."""
    parts, i = [], 24
    for t, k in zip(floats, _grad_sizes(static, floats)):
        parts.append(flat[i:i + k].view(t.shape) if k else
                     torch.zeros_like(t))
        i += k
    return flat[:24], parts, flat[i]


def _grads(static, tables, cam, time, flat, gtex, floats):
    """(d_tables, d_cam, d_time, loss) with shapes and dtypes matching the
    primals: the inverse of _pack_camera and of the table order on the
    cotangents (pallas_kernel._grads_from_rows), the texel buffer's
    gradient cut into the textures', each cast from the kernels' float32
    to its primal's dtype (d_time to the time's where it is a tensor; the
    loss stays float32).  y0 gets no gradient."""
    dc, dts, loss = _split(static, flat, floats)
    d_tables, _ = zero_grads(tables, cam)
    texs, i = [], 0
    for t in tables.textures:
        texs.append(gtex[i:i + t.numel()].view(t.shape).to(t.dtype))
        i += t.numel()
    d_tables = d_tables._replace(**{
        k: d.to(getattr(tables, k).dtype) for k, d in zip(FLOAT_FIELDS, dts)},
        textures=tuple(texs))
    d_cam = CameraParams(*(dc[a:b].view_as(c).to(c.dtype) for (a, b), c in
                           zip(((0, 4), (4, 8), (8, 12), (12, 16), (16, 17)),
                               cam)))
    d_time = dc[17]
    if isinstance(time, torch.Tensor):
        d_time = d_time.to(time.dtype)
    return d_tables, d_cam, d_time, loss


def vjp_cuda(static, tables, cam, H: int, W: int, g, time=0.0, y0: int = 0,
             rows: int | None = None, backward: str = "auto",
             chunk_trips: int = CHUNK_TRIPS):
    """VJP of the render of rows [y0, y0 + rows) of the H x W frame under
    the cotangent ``g`` [rows or H, W, 3] -> (d_tables, d_cam, d_time),
    through the backward kernels in vjp mode: trace_bwd (K3/K5) or the
    segmented K6/K7 with chunks of ``chunk_trips`` trips (``route``)."""
    device = _device(tables, "vjp_cuda")
    R = H if rows is None else rows
    floats = CK._check_tables(static, tables, device)
    cam_row = CK._pack_camera(cam, time, y0, device)
    flat, gtex = _launch(static, floats, cam_row, H, W, R, g, 0.0, False,
                         CK.tex_shapes(tables), backward, chunk_trips)
    return _grads(static, tables, cam, time, flat, gtex, floats)[:3]


def train_step_cuda(static, tables, cam, target, H: int, W: int, time=0.0,
                    y0: int = 0, rows: int | None = None, norm=None,
                    backward: str = "auto", chunk_trips: int = CHUNK_TRIPS):
    """The whole gradient of a training step in one call of the backward
    kernels in fused mode (K2, or K6/K7 by ``route``): render rows
    [y0, y0 + rows), the loss
    ``norm * sum((img - target)^2)`` and its gradients.  ``norm`` defaults
    to 1/(H*W*3), the mean over the full frame.  -> (loss, d_tables, d_cam,
    d_time)."""
    device = _device(tables, "train_step_cuda")
    R = H if rows is None else rows
    if norm is None:
        norm = 1.0 / (H * W * 3)
    floats = CK._check_tables(static, tables, device)
    cam_row = CK._pack_camera(cam, time, y0, device)
    flat, gtex = _launch(static, floats, cam_row, H, W, R, target, norm,
                         True, CK.tex_shapes(tables), backward, chunk_trips)
    d_tables, d_cam, d_time, loss = _grads(static, tables, cam, time, flat,
                                           gtex, floats)
    return loss, d_tables, d_cam, d_time


class RenderImageFn(torch.autograd.Function):
    """Differentiable render on the card: trace_fwd forward, the backward
    kernels of ``route`` (vjp mode) backward.  Inputs: the textures' shapes,
    the backward and its chunk_trips, the 24-float camera
    row (built with differentiable torch ops, so autograd maps its cotangent
    back to the camera and time), the float tables in FLOAT_FIELDS order and
    the texel buffer (concatenated by differentiable torch ops too)."""

    @staticmethod
    def forward(ctx, static, H, W, rows, tex_shapes, backward, chunk_trips,
                cam_row, *floats):
        ctx.static, ctx.shape = static, (H, W, rows, tex_shapes)
        ctx.backward = backward, chunk_trips
        ctx.save_for_backward(cam_row, *floats)
        return CK.launch_forward(static, list(floats), cam_row, H, W, rows,
                                 tex_shapes)

    @staticmethod
    def backward(ctx, g):
        cam_row, *floats = ctx.saved_tensors
        H, W, rows, tex_shapes = ctx.shape
        flat, gtex = _launch(ctx.static, floats, cam_row, H, W, rows, g, 0.0,
                             False, tex_shapes, *ctx.backward)
        d_cam_row, d_tables, _ = _split(ctx.static, flat, floats)
        return (None,) * 7 + (d_cam_row, *d_tables, gtex)


def render_image_diff(static, tables, cam, H: int, W: int, time=0.0,
                      y0: int = 0, rows: int | None = None,
                      backward: str = "auto",
                      chunk_trips: int = CHUNK_TRIPS) -> torch.Tensor:
    """Differentiable render of rows [y0, y0 + rows) -> [rows or H, W, 3].

    CUDA tables: the forward kernel, with ``vjp_cuda``'s kernels (``route``
    of ``backward`` and ``chunk_trips``) as its backward.  CPU tables: the
    plain render with ``differentiable=True`` under autograd.  Gradients
    reach the float tables, the camera and ``time``; ``y0`` is a frame
    coordinate and gets none.  On CUDA tables of any floating dtype the
    render is float32 and the cast to it is part of the graph, so that
    autograd hands each leaf its gradient in its own dtype."""
    device = tables.surf_color.device
    R = H if rows is None else rows
    if device.type != "cuda":
        from .trace import render_image
        return render_image(static, tables, cam, H, W, time, y0, R,
                            differentiable=True)
    route(static, backward, chunk_trips)
    floats = CK._check_tables(static, tables, device)
    cam_row = CK._pack_camera(cam, time, y0, device)
    return RenderImageFn.apply(static, H, W, R, CK.tex_shapes(tables),
                               backward, chunk_trips, cam_row, *floats)
