"""Correctness gates: compare a backend render against the C++ oracle.

Port of ``euclider_tpu/utils/validate.py`` with the same contract.
``render_fn(static, tables, cam, h, w, time)`` may return a numpy array or a
torch tensor on any device; a timed scene goes through this gate before any
number is printed for it.
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np


def oracle_check(static, tables, cam, render_fn: Callable,
                 h: int = 48, w: int = 128, tol: float = 2e-3,
                 time: float = 0.0) -> Tuple[float, float]:
    """Render ``render_fn(static, tables, cam, h, w, time)`` and the native
    C++ oracle at h×w; return (frac_ok, maxerr) where frac_ok is the
    fraction of pixels within ``tol`` of the oracle (per-pixel max over
    channels)."""
    from ..oracle.native_oracle import render_native

    img = render_fn(static, tables, cam, h, w, time)
    if hasattr(img, "detach"):
        img = img.detach().cpu().numpy()
    img = np.asarray(img, np.float64)
    gold = render_native(static, tables, cam, h, w, time=time)
    err = np.abs(img - gold).max(axis=-1)
    return float((err < tol).mean()), float(err.max())


def assert_oracle_match(static, tables, cam, render_fn: Callable,
                        h: int = 48, w: int = 128, tol: float = 2e-3,
                        min_frac: float = 0.99, label: str = "") -> float:
    """oracle_check that raises AssertionError below ``min_frac`` — the
    loud-failure form the perf tools call before printing any number."""
    frac, maxerr = oracle_check(static, tables, cam, render_fn, h, w, tol)
    assert frac >= min_frac, (
        f"correctness gate FAILED{' for ' + label if label else ''}: "
        f"frac_ok={frac:.4f} < {min_frac} (maxerr {maxerr:.2e})")
    return frac


def seams(img, tau: float = 0.02):
    """Pixels of an [H, W, 3] torch image within one pixel of a seam (a
    second difference above ``tau`` along a row or a column): silhouettes,
    total internal reflection and weight cuts, checker and texel edges,
    where a per-pixel gradient turns float32 rounding into arbitrary values
    (the gradient checks zero their cotangent there) -> bool [H, W]."""
    import torch
    d2x = (img[:, 2:] + img[:, :-2] - 2 * img[:, 1:-1]).abs().amax(-1)
    d2y = (img[2:] + img[:-2] - 2 * img[1:-1]).abs().amax(-1)
    m = torch.zeros(img.shape[:2], dtype=torch.bool, device=img.device)
    m[:, 1:-1] |= d2x > tau
    m[1:-1] |= d2y > tau
    return torch.nn.functional.max_pool2d(m[None, None].float(), 3, 1,
                                          1)[0, 0] > 0
