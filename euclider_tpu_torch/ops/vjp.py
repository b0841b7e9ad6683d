"""The plain version of the backward kernel: a row-blocked autograd VJP.

Port of ``euclider_tpu/ops/pallas_kernel.py::vjp_blocked``.  Autograd of the
whole-frame differentiable render would keep the trace loop's tape for every
pixel at once; the pixel sum in any loss is linear over rows, so the VJP is
taken one block of rows at a time and the blocks' gradients are summed.
Peak memory is one block's tape, and the result is the autograd VJP of
``trace.render_image(..., differentiable=True)`` up to the order of the
float32 sums.

``csrc/trace_bwd.cu`` (through ``ops/cuda_bwd.py``) is held against this
function on the card; on the CPU it is the backward the port runs.
"""
from __future__ import annotations

import torch

from ..scene.compile import CameraParams, SceneTables
from . import trace
from .cuda_kernel import FLOAT_FIELDS   # the tables that get gradients

# Autograd through a march keeps every step of every marching pixel of the
# block: a 64-row block of config5's 1280-wide frame peaked at 6.3 GiB on
# the H100 (PERF.md), far within its 80 GB.
BWD_BLOCK_ROWS = 64


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
