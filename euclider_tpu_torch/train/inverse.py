"""Inverse rendering: fit scene and camera parameters to a target image.

Port of ``euclider_tpu/train/inverse.py``.  Where JAX takes an optax
optimizer, the port takes ``torch.optim.Adam``.  With a ``mesh``
(``parallel/mesh.py``) each rank renders its slab of rows against its rows
of the target (``shard_target``) and the loss and every gradient are the
full frame's on every rank, the same bits on each: the fused step's
loss and gradients are summed over the ranks (``Mesh.sum``), and under
autograd the parameters enter the render through ``Mesh.replicated``,
whose backward sums their gradients as the transpose of JAX's
``shard_map`` does.  Without a mesh (or on a mesh of one without a process
group) it is one device, the same code with no collective.  Backends:

- ``torch``: the plain render with ``differentiable=True`` under autograd
  (the JAX package's ``lax``), on any device;
- ``cuda``: the forward kernel with the backward kernel as its autograd
  backward (``ops.cuda_bwd.render_image_diff``; JAX's ``pallas``);
- ``cuda-fused``: render, MSE and gradient in one launch of the backward
  kernel (``ops.cuda_bwd.train_step_cuda``; JAX's ``pallas-fused``).

    params = InverseParams(tables, cam)
    step, opt = make_train_step(static, H, W, params, lr=2e-2)
    loss = step(target)          # updates params' tensors in place

    mesh = make_mesh()           # every rank, after distributed.initialize
    step, opt = make_train_step(static, H, W, params, mesh=mesh)
    loss = step(shard_target(target, mesh))
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.cuda_kernel import FLOAT_FIELDS
from ..ops.vjp import zero_grads
from ..parallel.distributed import replicate
from ..parallel.mesh import Mesh, local_mesh, slab_rows
from ..scene.compile import CameraParams
from ..utils.tree import leaves, unflatten

BACKENDS = ("torch", "cuda", "cuda-fused")


class InverseParams(NamedTuple):
    tables: object   # SceneTables
    cam: object      # CameraParams


def _mesh(mesh: Mesh | None) -> Mesh:
    """The mesh of one (no collective) where none is given."""
    return local_mesh() if mesh is None else mesh


def shard_target(target, mesh: Mesh | None = None):
    """This rank's rows of a target image [H, W, 3] (a view)."""
    y0, rows = slab_rows(target.shape[0], _mesh(mesh))
    return target[y0:y0 + rows]


def make_loss_fn(static, H: int, W: int, backend: str = "cuda",
                 mesh: Mesh | None = None):
    """MSE loss of the full frame against a target, differentiable by
    autograd: ``loss(params, target, time=0.0)``, where ``target`` is this
    rank's rows of it (``shard_target``; the whole [H, W, 3] without a
    mesh).  backend 'torch' or 'cuda'.  On a mesh the value is the full
    frame's on every rank and so is autograd's gradient (module
    docstring).  The scene ``time`` may be a float32 tensor that requires
    grad: the expression materials read it, and it gets its gradient
    through both backends (the backward kernel's camera-row slot 17 on
    'cuda')."""
    mesh = _mesh(mesh)
    y0, rows = slab_rows(H, mesh)
    if backend == "torch":
        from ..ops.trace import render_image

        def render(tables, cam, time):
            return render_image(static, tables, cam, H, W, time, y0, rows,
                                differentiable=True)
    elif backend == "cuda":
        from ..ops.cuda_bwd import render_image_diff

        def render(tables, cam, time):
            if tables.surf_color.device.type != "cuda":
                raise ValueError("backend 'cuda' takes tables on a CUDA "
                                 "device")
            return render_image_diff(static, tables, cam, H, W, time, y0,
                                     rows)
    else:
        raise ValueError(f"make_loss_fn: backend {backend!r} is not "
                         "'torch' or 'cuda'")

    def loss(params: InverseParams, target, time=0.0):
        if target.shape[0] != rows:
            raise ValueError(f"target has {target.shape[0]} rows; this "
                             f"rank's slab has {rows} (shard_target)")
        tables, cam, time = mesh.replicated((params.tables, params.cam,
                                             time))
        mse = torch.mean((render(tables, cam, time) - target) ** 2)
        if rows != H:           # the slab's share of the frame's mean
            mse = mse * (rows / H)
        return mesh.sum_out(mse)

    return loss


def make_fused_value_and_grad(static, H: int, W: int,
                              backend: str = "cuda-fused",
                              mesh: Mesh | None = None):
    """``value_and_grad(params, target, time=0.0) -> (loss, grads)`` with
    grads an InverseParams shaped like params (zeros for the tables the
    render does not read); ``target`` as ``make_loss_fn`` takes it.
    'cuda-fused' is one kernel launch on this rank's slab (``norm``
    1/(H W 3)), its loss and gradients (the time's too) then summed over
    the mesh; 'torch' and 'cuda' take autograd through make_loss_fn.  As
    in the JAX package, the time's gradient is not returned here:
    ``make_loss_fn`` gives it, and ``ops.cuda_bwd.train_step_cuda``
    returns it."""
    mesh = _mesh(mesh)
    if backend == "cuda-fused":
        from ..ops.cuda_bwd import train_step_cuda
        y0, rows = slab_rows(H, mesh)

        def value_and_grad(params, target, time=0.0):
            out = train_step_cuda(static, params.tables, params.cam, target,
                                  H, W, time, y0, rows, 1.0 / (H * W * 3))
            loss, gt, gc, _ = unflatten(out, mesh.sum(leaves(out)))
            return loss, InverseParams(gt, gc)

        return value_and_grad
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    loss_fn = make_loss_fn(static, H, W, backend, mesh)

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
                    fit=None, mesh: Mesh | None = None):
    """Returns ``(step, optimizer)``: ``step(target, time=0.0) -> loss``
    (the loss before the update) takes one Adam step and updates params'
    table tensors in place; ``target`` as ``make_loss_fn`` takes it.  On a
    mesh the parameters start as rank 0's (``replicate``) and, their
    gradients the same bits on every rank, stay the same bits through the
    steps.

    ``fit`` maps the names of the tables to fit to a 0/1 mask that
    multiplies their gradient, or None for the whole table; entries with a
    zero mask stay where they are (Adam moves an entry whose gradient is
    always 0 by exactly 0), and so do the tables not named and the camera.
    The default fits every float table."""
    fit = dict.fromkeys(FLOAT_FIELDS) if fit is None else fit
    vg = make_fused_value_and_grad(static, H, W, backend, mesh)
    if mesh is not None:
        replicate(params)
    fitted = [getattr(params.tables, k) for k in fit]
    opt = torch.optim.Adam(fitted, lr=lr)

    def step(target, time=0.0):
        loss, g = vg(params, target, time)
        for t, (k, mask) in zip(fitted, fit.items()):
            gr = getattr(g.tables, k)
            t.grad = gr if mask is None else gr * mask
        opt.step()
        return loss

    return step, opt
