"""Process-group set-up, host-major and hybrid meshes, replication and the
host gather: the port of ``euclider_tpu/parallel/distributed.py``.

The JAX package joins a ``jax.distributed`` group of one process a host;
the port runs one process a device under ``torch.distributed.run``
(torchrun), which sets ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE`` and ``GROUP_RANK``
(the host's, torchrun's node rank).  NCCL joins the ranks on CUDA devices,
gloo on the CPU.  With nothing configured ``initialize`` is a no-op and
every mesh is one rank, as in the JAX package.

    python -m torch.distributed.run --nproc_per_node 2 \\
        -m euclider_tpu_torch.train.fit --device cpu --backend torch
"""
from __future__ import annotations

import os
import socket
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils.tree import leaves
from .mesh import Mesh, gather_frame


def initialize(device: str = "cuda", init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None) -> bool:
    """Join the process group -> True, or False (a no-op) when nothing is
    configured: neither ``init_method`` nor torchrun's ``WORLD_SIZE`` and
    ``RANK``.  Already joined: True.

    ``device='cuda'`` joins over NCCL and makes card ``LOCAL_RANK`` (0 by
    default) the current device; without a card it raises, and it never
    falls back to gloo or the CPU.  ``device='cpu'`` joins over gloo.  The
    arguments override the environment (``init_method`` such as
    ``tcp://127.0.0.1:29500``)."""
    if dist.is_initialized():
        return True
    env = os.environ
    if init_method is None and not ("WORLD_SIZE" in env and "RANK" in env):
        return False
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize(device='cuda'): no CUDA device")
        torch.cuda.set_device(int(env.get("LOCAL_RANK", 0)))
        backend = "nccl"
    elif device == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"device {device!r} is not 'cuda' or 'cpu'")
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        world_size=int(env["WORLD_SIZE"]) if world_size is None
        else world_size,
        rank=int(env["RANK"]) if rank is None else rank)
    return True


def process_info() -> Tuple[int, int]:
    """(rank, world size); (0, 1) without a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def hybrid_layout(hosts: Sequence) -> np.ndarray:
    """The ranks laid out [host, chip], host-major, from each rank's host
    (``hosts[r]`` is rank r's): hosts in the order of their lowest rank,
    each row its host's ranks in order.  A layout with uneven counts of
    ranks a host raises RuntimeError: the chip axis would cross hosts."""
    order = list(dict.fromkeys(hosts))
    rows = [[r for r, h in enumerate(hosts) if h == key] for key in order]
    counts = {len(r) for r in rows}
    if len(counts) != 1:
        raise RuntimeError(
            f"hybrid mesh needs a uniform rank count per host: "
            f"{[len(r) for r in rows]} ranks on {len(rows)} hosts")
    return np.asarray(rows)


def _hosts() -> list:
    """Every rank's host key: torchrun's node rank and the host name."""
    key = (os.environ.get("GROUP_RANK", ""), socket.gethostname())
    if not dist.is_initialized():
        return [key]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, key)
    return out


def make_render_mesh() -> Mesh:
    """1-D ``rows`` mesh over every rank, host-major, so each host's rows of
    the frame are one contiguous block."""
    return Mesh(hybrid_layout(_hosts()).reshape(-1), ("rows",), (None,))


def make_hybrid_mesh(ici_axis: str = "chip", dcn_axis: str = "host") -> Mesh:
    """2-D (host, chip) mesh: row h holds the ranks of host h, so sums over
    ``ici_axis`` stay within a host.  Raises on a layout it cannot
    represent (uneven ranks a host).

    ``torch.distributed.device_mesh.init_device_mesh`` is not used: it
    joins a default process group itself where none exists, and the port's
    mesh of one runs without one.  The axis groups come from
    ``dist.new_group``, which every rank calls for every group."""
    devs = hybrid_layout(_hosts())
    if not dist.is_initialized():
        return Mesh(devs, (dcn_axis, ici_axis), (None, None))
    rank = dist.get_rank()
    host_group = chip_group = None
    for c in range(devs.shape[1]):      # the ranks of one chip index
        g = dist.new_group([int(r) for r in devs[:, c]])
        if rank in devs[:, c]:
            host_group = g
    for h in range(devs.shape[0]):      # the ranks of one host
        g = dist.new_group([int(r) for r in devs[h]])
        if rank in devs[h]:
            chip_group = g
    return Mesh(devs, (dcn_axis, ici_axis), (host_group, chip_group))


def replicate(tree, src: int = 0):
    """Every rank ends up holding rank ``src``'s tensors: each tensor leaf
    of ``tree`` (tables, camera, ``InverseParams``) is broadcast in place.
    Returns ``tree``.  A no-op without a process group."""
    if dist.is_initialized():
        for x in leaves(tree):
            if isinstance(x, torch.Tensor):
                if not x.is_contiguous():
                    raise ValueError("replicate broadcasts in place: "
                                     "its tensors must be contiguous")
                dist.broadcast(x.detach(), src)
    return tree


def host_gather_image(slab: torch.Tensor, mesh: Mesh | None = None
                      ) -> np.ndarray:
    """The full frame as a numpy array on every rank, from each rank's
    slab (``gather_frame``, then one copy to the host)."""
    return gather_frame(slab, mesh).cpu().numpy()
