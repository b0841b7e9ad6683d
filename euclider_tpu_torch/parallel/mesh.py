"""Row-sharded rendering over torch.distributed: one rank a device, each
rendering one slab of rows of the frame.

Port of ``euclider_tpu/parallel/mesh.py``.  The JAX package lays a 1-D
``rows`` mesh over the devices of one program and renders under
``shard_map``; the port runs one process a device (launched by
``torch.distributed.run``; ``parallel/distributed.py`` joins the group).
The rank at position i of an n-rank mesh renders rows [i H/n, (i+1) H/n)
through the kernels' ``y0``/``rows`` slab (``trace_fwd``; differentiable:
``render_image_diff``, ``trace_fwd`` forward and ``trace_bwd`` backward)
with the tables and camera the same on every rank
(``distributed.replicate``): no collective in the forward render.
``gather_frame`` assembles the frame on every rank.

A ``Mesh`` made without a process group, and ``local_mesh()`` (this rank
alone, as the one-device trainer takes it), are one rank and run the same
code with no collective: the "mesh of one".  Sums over a mesh
(``Mesh.sum``) gather every rank's part and add them in rank order, so
every rank gets the same bits, and a mesh of one returns its part as is.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..utils.tree import leaves, unflatten


@dataclass(frozen=True, eq=False)
class Mesh:
    """Global ranks laid out on named axes (host-major), with this rank's
    process group along each axis (None: the default group).  ``local``:
    this rank alone, whatever group it is in."""

    devices: np.ndarray
    axis_names: tuple
    groups: tuple
    local: bool = False

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def collective(self) -> bool:
        """Whether sums and gathers over this mesh talk to other ranks."""
        return not self.local and dist.is_initialized()

    def index(self) -> int:
        """This rank's position on the mesh, axes flattened host-major."""
        if not self.collective():
            self._alone()
            return 0
        hits = np.flatnonzero(self.devices.reshape(-1) == dist.get_rank())
        if not hits.size:
            raise ValueError(f"rank {dist.get_rank()} is not on the mesh")
        return int(hits[0])

    def _alone(self):
        if self.size != 1:
            raise RuntimeError(f"a mesh of {self.size} ranks needs a "
                               "process group (distributed.initialize)")

    def _group(self, axis):
        if axis is None:
            if len(self.axis_names) != 1:
                raise ValueError(f"name an axis of {self.axis_names}")
            return self.groups[0]
        return self.groups[self.axis_names.index(axis)]

    def sum(self, xs, axis=None) -> list:
        """The tensors ``xs`` each summed over the ranks along ``axis`` (the
        only axis of a 1-D mesh): one all_gather a dtype, the parts added in
        the group's rank order, so the result is the same bits on every
        rank.  Without a process group the mesh is one rank and ``xs``
        come back as they are."""
        xs = list(xs)
        if not self.collective():
            self._alone()
            return xs
        group = self._group(axis)
        n = dist.get_world_size(group)
        by_kind = {}
        for i, x in enumerate(xs):
            by_kind.setdefault((x.dtype, x.device), []).append(i)
        for idx in by_kind.values():
            flat = torch.cat([xs[i].detach().reshape(-1) for i in idx])
            parts = [torch.empty_like(flat) for _ in range(n)]
            dist.all_gather(parts, flat, group=group)
            acc = parts[0]
            for p in parts[1:]:
                acc = acc + p
            off = 0
            for i in idx:
                k = xs[i].numel()
                xs[i] = acc[off:off + k].view_as(xs[i])
                off += k
        return xs

    def replicated(self, tree):
        """``tree`` as the input of a function replicated over the mesh: the
        same tensors forward; backward, each tensor leaf's gradient summed
        over the ranks (the transpose of JAX's replicated ``shard_map``
        input, which inserts the psum).  Identity on a mesh of one without
        a process group."""
        if not self.collective():
            return tree
        flat = leaves(tree)
        at = [i for i, x in enumerate(flat)
              if isinstance(x, torch.Tensor) and x.is_floating_point()]
        outs = _Replicated.apply(self, *(flat[i] for i in at))
        for i, y in zip(at, outs):
            flat[i] = y
        return unflatten(tree, flat)

    def sum_out(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the ranks, its gradient passed to each rank's
        own part unchanged (with ``replicated`` on the inputs, the gradient
        of the sum is summed once, in ``replicated``'s backward)."""
        if not self.collective():
            return x
        return _SumOut.apply(self, x)


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, *xs):
        ctx.mesh = mesh
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        return (None, *ctx.mesh.sum(gs))


class _SumOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, x):
        return mesh.sum([x])[0]

    @staticmethod
    def backward(ctx, g):
        return None, g


def local_mesh() -> Mesh:
    """This rank alone: the mesh of one, with no collective."""
    return Mesh(np.arange(1), ("rows",), (None,), local=True)


def make_mesh(n_devices: int | None = None) -> Mesh:
    """1-D ``rows`` mesh over every rank of the process group, in rank
    order (one rank, with no group).  ``n_devices`` may only name that
    count: a rank outside the mesh would have no rows to render."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} ranks: the process group "
                         f"has {world}, one rank a device")
    return Mesh(np.arange(world), ("rows",), (None,))


def slab_rows(H: int, mesh: Mesh) -> tuple:
    """(y0, rows) of this rank's slab of an H-row frame."""
    n = mesh.size
    if H % n:
        raise ValueError(f"H={H} not divisible by mesh size {n}")
    rows = H // n
    return mesh.index() * rows, rows


def render_image_sharded(static, tables, cam, H: int, W: int,
                         mesh: Mesh | None = None,
                         differentiable: bool = False,
                         backend: str = "cuda", time=0.0) -> torch.Tensor:
    """This rank's slab of the H x W frame -> [H/n, W, 3]: rows
    [i H/n, (i+1) H/n) for the rank at position i of an n-rank mesh (by
    default ``make_mesh()``, every rank).

    ``backend='cuda'`` runs ``render_image_cuda`` (``trace_fwd``), or with
    ``differentiable=True`` ``render_image_diff`` (``trace_fwd`` forward,
    ``trace_bwd`` backward; its gradients are the slab's, which
    ``train/inverse.py`` sums over the ranks); ``'torch'`` the plain render
    on the tables' device."""
    mesh = make_mesh() if mesh is None else mesh
    y0, rows = slab_rows(H, mesh)
    if backend == "cuda":
        if differentiable:
            from ..ops.cuda_bwd import render_image_diff
            return render_image_diff(static, tables, cam, H, W, time, y0,
                                     rows)
        from ..ops.cuda_kernel import render_image_cuda
        return render_image_cuda(static, tables, cam, H, W, time, y0, rows)
    if backend == "torch":
        from ..ops.trace import render_image
        return render_image(static, tables, cam, H, W, time, y0, rows,
                            differentiable)
    raise ValueError(f"backend {backend!r} is not 'cuda' or 'torch'")


def gather_frame(slab: torch.Tensor, mesh: Mesh | None = None
                 ) -> torch.Tensor:
    """The full frame [H, W, 3] on every rank, from each rank's slab
    (all_gather, the slabs stacked in mesh order), on the slab's device."""
    mesh = make_mesh() if mesh is None else mesh
    if not mesh.collective():
        return slab
    parts = [torch.empty_like(slab) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, slab.contiguous())
    return torch.cat([parts[r] for r in mesh.devices.reshape(-1)])
