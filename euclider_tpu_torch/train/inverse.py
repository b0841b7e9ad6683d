"""Inverse rendering: fit scene and camera parameters to a target image.

Port of ``euclider_tpu/train/inverse.py`` on one device (the row-sharded
mesh waits for the multi-device slice; the kernels already take the
``y0``/``rows`` slab it needs).  Where JAX takes an optax optimizer, the
port takes ``torch.optim.Adam``.  Backends:

- ``torch``: the plain render with ``differentiable=True`` under autograd
  (the JAX package's ``lax``), on any device;
- ``cuda``: the forward kernel with the backward kernel as its autograd
  backward (``ops.cuda_bwd.render_image_diff``; JAX's ``pallas``);
- ``cuda-fused``: render, MSE and gradient in one launch of the backward
  kernel (``ops.cuda_bwd.train_step_cuda``; JAX's ``pallas-fused``).

    params = InverseParams(tables, cam)
    step, opt = make_train_step(static, H, W, params, lr=2e-2)
    loss = step(target)          # updates params' tensors in place
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.cuda_kernel import FLOAT_FIELDS
from ..ops.vjp import zero_grads
from ..scene.compile import CameraParams

BACKENDS = ("torch", "cuda", "cuda-fused")


class InverseParams(NamedTuple):
    tables: object   # SceneTables
    cam: object      # CameraParams


def make_loss_fn(static, H: int, W: int, backend: str = "cuda"):
    """MSE loss against a target [H, W, 3], differentiable by autograd:
    ``loss(params, target, time=0.0)``.  backend 'torch' or 'cuda'.  The
    scene ``time`` may be a float32 tensor that requires grad: the
    expression materials read it, and it gets its gradient through both
    backends (the backward kernel's camera-row slot 17 on 'cuda')."""
    if backend == "torch":
        from ..ops.trace import render_image

        def render(tables, cam, time):
            return render_image(static, tables, cam, H, W, time,
                                differentiable=True)
    elif backend == "cuda":
        from ..ops.cuda_bwd import render_image_diff

        def render(tables, cam, time):
            if tables.surf_color.device.type != "cuda":
                raise ValueError("backend 'cuda' takes tables on a CUDA "
                                 "device")
            return render_image_diff(static, tables, cam, H, W, time)
    else:
        raise ValueError(f"make_loss_fn: backend {backend!r} is not "
                         "'torch' or 'cuda'")

    def loss(params: InverseParams, target, time=0.0):
        img = render(params.tables, params.cam, time)
        return torch.mean((img - target) ** 2)

    return loss


def make_fused_value_and_grad(static, H: int, W: int,
                              backend: str = "cuda-fused"):
    """``value_and_grad(params, target, time=0.0) -> (loss, grads)`` with
    grads an InverseParams shaped like params (zeros for the tables the
    render does not read).  'cuda-fused' is one kernel launch; 'torch' and
    'cuda' take autograd through make_loss_fn.  As in the JAX package, the
    time's gradient is not returned here: ``make_loss_fn`` gives it, and
    ``ops.cuda_bwd.train_step_cuda`` returns it."""
    if backend == "cuda-fused":
        from ..ops.cuda_bwd import train_step_cuda

        def value_and_grad(params, target, time=0.0):
            loss, gt, gc, _ = train_step_cuda(static, params.tables,
                                              params.cam, target, H, W, time)
            return loss, InverseParams(gt, gc)

        return value_and_grad
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    loss_fn = make_loss_fn(static, H, W, backend)

    def value_and_grad(params, target, time=0.0):
        with torch.enable_grad():
            leaves = [getattr(params.tables, k).detach().requires_grad_(True)
                      for k in FLOAT_FIELDS]
            texs = [t.detach().requires_grad_(True)
                    for t in params.tables.textures]
            cam_l = [v.detach().requires_grad_(True) for v in params.cam]
            p = InverseParams(
                params.tables._replace(**dict(zip(FLOAT_FIELDS, leaves)),
                                       textures=tuple(texs)),
                CameraParams(*cam_l))
            loss = loss_fn(p, target, time)
            grads = torch.autograd.grad(loss, leaves + texs + cam_l,
                                        allow_unused=True)
        zt, zc = zero_grads(params.tables, params.cam)
        grads = [z if g is None else g
                 for z, g in zip([getattr(zt, k) for k in FLOAT_FIELDS]
                                 + list(zt.textures) + list(zc), grads)]
        n, nt = len(FLOAT_FIELDS), len(texs)
        d_tables = zt._replace(**dict(zip(FLOAT_FIELDS, grads)),
                               textures=tuple(grads[n:n + nt]))
        return loss.detach(), InverseParams(
            d_tables, CameraParams(*grads[n + nt:]))

    return value_and_grad


def make_train_step(static, H: int, W: int, params: InverseParams,
                    lr: float = 2e-2, backend: str = "cuda-fused",
                    fit=None):
    """Returns ``(step, optimizer)``: ``step(target, time=0.0) -> loss``
    (the loss before the update) takes one Adam step and updates params'
    table tensors in place.

    ``fit`` maps the names of the tables to fit to a 0/1 mask that
    multiplies their gradient, or None for the whole table; entries with a
    zero mask stay where they are (Adam moves an entry whose gradient is
    always 0 by exactly 0), and so do the tables not named and the camera.
    The default fits every float table."""
    fit = dict.fromkeys(FLOAT_FIELDS) if fit is None else fit
    vg = make_fused_value_and_grad(static, H, W, backend)
    leaves = [getattr(params.tables, k) for k in fit]
    opt = torch.optim.Adam(leaves, lr=lr)

    def step(target, time=0.0):
        loss, g = vg(params, target, time)
        for t, (k, mask) in zip(leaves, fit.items()):
            gr = getattr(g.tables, k)
            t.grad = gr if mask is None else gr * mask
        opt.step()
        return loss

    return step, opt
