"""Checkpoint and restore trees of parameters: the port of
``euclider_tpu/utils/checkpointing.py``.

The JAX package saves through orbax, or an ``.npz`` where it has none; the
card has no orbax, so the port saves the leaves with ``torch.save`` to
``path + ".pt"`` (beside where the JAX package would write its own) and
loads them with ``torch.load(..., weights_only=True)``.  The leaves are
stored in ``jax.tree.leaves`` order of the JAX package's same structure
(``utils/tree.py``), on the CPU, and ``restore`` rebuilds them into the
structure of ``like`` on its leaves' devices and dtypes.  Every leaf is a
tensor.

    save("/tmp/fit_ckpt", params)                 # writes /tmp/fit_ckpt.pt
    params = restore("/tmp/fit_ckpt", like=params)
"""
from __future__ import annotations

import os
from typing import Any

import torch

from .tree import leaves, unflatten

SUFFIX = ".pt"


def _tensors(tree) -> list:
    flat = leaves(tree)
    for i, x in enumerate(flat):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"leaf {i} is a {type(x).__name__}, not a "
                            "tensor")
    return flat


def save(path: str, tree: Any) -> str:
    """Write the leaves of ``tree`` to ``path + ".pt"`` -> that file's path.
    The file is written beside and then renamed over, so a reader never
    sees half of one."""
    target = os.path.abspath(path) + SUFFIX
    os.makedirs(os.path.dirname(target), exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    torch.save([x.detach().cpu() for x in _tensors(tree)], tmp)
    os.replace(tmp, target)
    return target


def restore(path: str, like: Any) -> Any:
    """Read a checkpoint written by ``save`` into the structure of ``like``,
    each leaf on the device and in the dtype of ``like``'s.  A checkpoint
    whose leaves differ from ``like``'s in number or shape raises
    ValueError."""
    saved = torch.load(os.path.abspath(path) + SUFFIX, map_location="cpu",
                       weights_only=True)
    ref = _tensors(like)
    if len(saved) != len(ref):
        raise ValueError(f"checkpoint {path} holds {len(saved)} leaves; the "
                         f"tree takes {len(ref)}")
    for i, (t, x) in enumerate(zip(saved, ref)):
        if t.shape != x.shape:
            raise ValueError(f"checkpoint {path}: leaf {i} has shape "
                             f"{tuple(t.shape)}, the tree's "
                             f"{tuple(x.shape)}")
    return unflatten(like, [t.to(device=x.device, dtype=x.dtype)
                            for t, x in zip(saved, ref)])
