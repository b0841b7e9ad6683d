"""The reversible-march probe: the reverse sweep of K4 in isolation.

Port of ``tools/mosaic_probe.py::_rev_kernel`` (probe 6), which the JAX
package uses to pin down the analytic step inversion of its march backward
(``ops/pallas_vjp.py::march_bwd_rev``) apart from the ray tracer.  It
computes, per element of x, ``outer(x, w) = cos(y) + 0.25 y`` with
``y = 2 x_T + v_T`` the end of a done-masked leapfrog march of ``R_STEPS``
steps of size ``R_H`` from ``(0.3 x, 0.2 x + 0.1)``:

    v' = v + h * 0.3 sin(w x);   x' = x + h v';   done once x' > 1

and its VJP under a cotangent g, accumulated twice (the probe's loop of two
``jax.vjp`` calls): ``dx`` per element and ``dw`` summed over all of them.

``rev_march_plain`` is the plain version (autograd through the march);
``csrc/probe_rev.cu`` is the kernel, which walks the steps backwards by
inverting them (``x = x1 - h v1``, ``v = v1 - h a(x)``) from checkpoints
taken every ``R_CB`` steps.  ``rev_march_vjp`` runs the kernel on CUDA
tensors and the plain version on CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools

import torch

R_STEPS = 24
R_CB = 8
R_H = 0.11
VJP_REPEATS = 2      # the probe accumulates its VJP this many times

LAUNCHES = 0         # launches of probe_rev made by rev_march_vjp


def rev_march(x, w):
    """outer(x, w) through the plain done-masked march -> shaped like x."""
    h = R_H
    xx, v = x * 0.3, x * 0.2 + 0.1
    done = torch.zeros_like(x, dtype=torch.bool)
    for _ in range(R_STEPS):
        v1 = v + h * (0.3 * torch.sin(w * xx))
        x1 = xx + h * v1
        live = ~done
        newly = live & (x1 > 1.0)
        xx = torch.where(live, x1, xx)
        v = torch.where(live, v1, v)
        done = done | newly
    y = xx * 2.0 + v
    return torch.cos(y) + y * 0.25


def rev_march_plain(x, w, g):
    """The probe's VJP by autograd -> (dx shaped like x, dw 0-d)."""
    with torch.enable_grad():
        xl = x.detach().requires_grad_(True)
        wl = torch.as_tensor(w, dtype=x.dtype,
                             device=x.device).detach().requires_grad_(True)
        dx, dw = torch.autograd.grad(rev_march(xl, wl), (xl, wl), g)
    return dx * VJP_REPEATS, dw * VJP_REPEATS


@functools.lru_cache(maxsize=None)
def _entry():
    from . import cuda_kernel as CK
    fn = ctypes.CDLL(CK.build(("probe_rev",))["probe_rev"]).euclider_probe_rev
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def rev_march_cuda(x, w, g):
    """The probe's VJP through csrc/probe_rev.cu -> (dx, dw); CUDA tensors
    only."""
    global LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"rev_march_cuda takes CUDA tensors, got {x.device}")
    if g.shape != x.shape:
        raise ValueError(f"cotangent shape {tuple(g.shape)} != "
                         f"{tuple(x.shape)}")
    x = x.detach().to(torch.float32).contiguous()
    g = g.detach().to(device=x.device, dtype=torch.float32).contiguous()
    dx = torch.empty_like(x)
    dw = torch.empty((), dtype=torch.float32, device=x.device)
    rc = _entry()(x.data_ptr(), float(w), g.data_ptr(), x.numel(),
                  dx.data_ptr(), dw.data_ptr(), x.device.index,
                  torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"probe_rev launch failed: cudaError {rc}")
    LAUNCHES += 1
    return dx, dw


def rev_march_vjp(x, w, g):
    """The probe's VJP: the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if x.device.type == "cuda":
        return rev_march_cuda(x, w, g)
    return rev_march_plain(x, w, g)
