"""The Mosaic capability probes P2-P6: small recurrences on one tile that
pin down the mechanisms of the march backward (K4) apart from the tracer.

Ports of the kernels of ``tools/mosaic_probe.py``; each has a plain version
(autograd through the same recurrence, with the tool's constants), a
``_cuda`` wrapper that launches its hand-written kernel on CUDA tensors and
counts the launch, and a dispatcher that takes the kernel for CUDA tensors
and the plain version for CPU tensors:

- P2 ``_ckpt_kernel``: ``ckpt_scratch_vjp(x, w, g) -> (dx, dw)``, the VJP of
  K * C = 24 steps of ``x + 0.1 tanh(w x)`` (``csrc/probe_mosaic.cu``: 6
  checkpoints, each chunk re-run before its reverse);
- P3 ``_cond_kernel``: ``cond_vjp(x, g) -> (y, dx)``, one tile-wide branch
  on ``sum(x) > 0``: ``y = 2 x + sin x`` or ``0.5 x``;
- P4 ``_nested_kernel``: ``nested_march_vjp(x, w, g) -> (dx, dw)``, the VJP
  of ``cos y + 0.25 y``, ``y`` 12 such steps from ``1.5 x``, accumulated
  over 2 trips;
- P5 ``_gated_kernel``: ``gated_march_vjp(x, w, g, act=None) -> (dx, dw)``,
  the same outer VJP of ``y = 2 x_T + v_T`` after 12 steps of
  ``(x, v) -> (x + 0.1 tanh(w v), v + 0.05 sin x)`` from ``(1.2 x, 0.5 x)``,
  gated tile-wide by ``any(act > 0.5)`` (a dead tile gives ``y = 1.2 x``;
  ``act=None`` is the tool's all-live gate), accumulated over 2 trips;
- P6 ``_rev_kernel``: ``rev_march_vjp`` below.

The reversible-march probe P6: the reverse sweep of K4 in isolation.

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

The kernels of P2, P4, P5 and P6 run a lane a thread in one thread-block
cluster (``csrc/probe_cluster.cuh``), and P3's a lane a thread in one
block of up to 1024 threads, so each takes at most ``MAX_LANES``
elements, one (8, 128) tile, as the tool's kernels do; their wrappers
refuse more (or none) with ``ValueError`` before any launch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

# P6 (tools/mosaic_probe.py make_rev_march)
R_STEPS = 24
R_CB = 8
R_H = 0.11

LAUNCHES = 0         # launches of probe_rev made by rev_march_vjp
MAX_LANES = 1024     # P2, P4-P6: a cluster of 8 blocks of 128 lanes;
                     # P3: one block of 1024

# P2-P5 (tools/mosaic_probe.py)
K = 6                # P2: checkpoints
C = 4                # P2: steps per chunk
N_STEPS = 12         # P4, P5: steps of the inner march
CB = 4               # P4, P5: steps per chunk (the kernel's scratch)
TRIPS = 2            # P4-P6: the outer loop's VJPs, accumulated
# launches of csrc/probe_mosaic.cu's kernels made by the _cuda wrappers
MOSAIC_LAUNCHES = dict.fromkeys(("probe_ckpt", "probe_cond", "probe_nested",
                                 "probe_gated"), 0)


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
    """The probe's VJP by autograd, accumulated over TRIPS -> (dx shaped
    like x, dw 0-d)."""
    dx, dw = _grad(rev_march, x, w, g)
    return dx * TRIPS, dw * TRIPS


@functools.lru_cache(maxsize=None)
def _entry():
    from . import cuda_kernel as CK
    fn = ctypes.CDLL(CK.build(("probe_rev",))["probe_rev"]).euclider_probe_rev
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _lanes(name, x, holder="one cluster"):
    """Refuse a tile that one cluster (P3: one block) does not hold, before
    any launch."""
    if not 1 <= x.numel() <= MAX_LANES:
        raise ValueError(f"{x.numel()} elements; {name} takes 1 to "
                         f"{MAX_LANES} ({holder})")


def rev_march_cuda(x, w, g):
    """The probe's VJP through csrc/probe_rev.cu -> (dx, dw); CUDA tensors
    of at most MAX_LANES elements only."""
    global LAUNCHES
    _lanes("probe_rev", x)
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


# --- P2-P5: tools/mosaic_probe.py's _ckpt_kernel, _cond_kernel,
# _nested_kernel, _gated_kernel ----------------------------------------------

def _step(x, w):
    return x + 0.1 * torch.tanh(w * x)


def _grad(fn, x, w, g):
    """autograd of fn(x, w) under g -> (dx, dw 0-d; zero where fn does not
    read w: P5's dead tile)."""
    with torch.enable_grad():
        xl = x.detach().requires_grad_(True)
        wl = torch.as_tensor(w, dtype=x.dtype,
                             device=x.device).detach().requires_grad_(True)
        return torch.autograd.grad(fn(xl, wl), (xl, wl), g,
                                   allow_unused=True, materialize_grads=True)


def ckpt_scratch(x, w):
    """P2's function: K * C steps of x + 0.1 tanh(w x)."""
    for _ in range(K * C):
        x = _step(x, w)
    return x


def ckpt_scratch_plain(x, w, g):
    """P2's VJP by autograd -> (dx, dw)."""
    return _grad(ckpt_scratch, x, w, g)


def cond(x):
    """P3's function: one branch for the whole tile on sum(x) > 0."""
    if bool(x.sum() > 0.0):
        return x * 2.0 + torch.sin(x)
    return x * 0.5


def cond_plain(x, g):
    """P3's value and VJP by autograd -> (y, dx)."""
    with torch.enable_grad():
        xl = x.detach().requires_grad_(True)
        y = cond(xl)
        dx, = torch.autograd.grad(y, xl, g)
    return y.detach(), dx


def nested_march(x, w):
    """P4's outer function: cos y + 0.25 y, y = N_STEPS steps from 1.5 x."""
    y = x * 1.5
    for _ in range(N_STEPS):
        y = _step(y, w)
    return torch.cos(y) + y * 0.25


def nested_march_plain(x, w, g):
    """P4's VJP by autograd, accumulated over TRIPS -> (dx, dw)."""
    dx, dw = _grad(nested_march, x, w, g)
    return dx * TRIPS, dw * TRIPS


def _live(x, act):
    """P5's tile-wide gate; act=None is the tool's all-live (x > -1e9)."""
    if act is None:
        act = (x > -1e9).to(x.dtype)
    return bool((act > 0.5).any())


def gated_march(x, w, live: bool):
    """P5's outer function: cos y + 0.25 y, y = 2 x_T + v_T after N_STEPS
    two-variable steps from (1.2 x, 0.5 x) on a live tile, y = 1.2 x on a
    dead one."""
    xx, v = x * 1.2, x * 0.5
    if live:
        for _ in range(N_STEPS):
            xx, v = xx + 0.1 * torch.tanh(w * v), v + 0.05 * torch.sin(xx)
        y = xx * 2.0 + v
    else:
        y = xx
    return torch.cos(y) + y * 0.25


def gated_march_plain(x, w, g, act=None):
    """P5's VJP by autograd, accumulated over TRIPS -> (dx, dw)."""
    live = _live(x, act)
    dx, dw = _grad(lambda a, b: gated_march(a, b, live), x, w, g)
    return dx * TRIPS, dw * TRIPS


@functools.lru_cache(maxsize=None)
def _mosaic(name: str):
    """The C entry point euclider_<name> of csrc/probe_mosaic.cu."""
    from . import cuda_kernel as CK
    fn = getattr(ctypes.CDLL(CK.build(("probe_mosaic",))["probe_mosaic"]),
                 f"euclider_{name}")
    p, f, i = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
    fn.argtypes = {"probe_cond": [p, p, i, p, p, i, p],
                   "probe_gated": [p, f, p, p, i, p, p, i, p]}.get(
        name, [p, f, p, i, p, p, i, p])
    fn.restype = ctypes.c_int
    return fn


def _on_card(name, x, *others):
    """x and the tensors of others as contiguous float32 on x's CUDA device;
    raises ValueError for anything else."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}_cuda takes CUDA tensors, got {x.device}")
    out = [x.detach().to(torch.float32).contiguous()]
    for t in others:
        if t.device != x.device or t.shape != x.shape:
            raise ValueError(f"{name}: a tensor of shape {tuple(t.shape)} on "
                             f"{t.device}; expected {tuple(x.shape)} on "
                             f"{x.device}")
        out.append(t.detach().to(torch.float32).contiguous())
    return out


def _launch(name, *args, device):
    rc = _mosaic(name)(*args, device.index,
                       torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    MOSAIC_LAUNCHES[name] += 1


def _vjp_cuda(name, x, w, g, *extra):
    """P2's, P4's or P5's kernel, one cluster over x -> (dx, dw)."""
    _lanes(name, x)
    x, g, *extra = _on_card(name, x, g, *extra)
    dx = torch.empty_like(x)
    dw = torch.empty((), dtype=torch.float32, device=x.device)
    _launch(name, x.data_ptr(), float(w), g.data_ptr(),
            *(t.data_ptr() for t in extra), x.numel(), dx.data_ptr(),
            dw.data_ptr(), device=x.device)
    return dx, dw


def ckpt_scratch_cuda(x, w, g):
    """P2 through csrc/probe_mosaic.cu -> (dx, dw); CUDA tensors of at most
    MAX_LANES elements only."""
    return _vjp_cuda("probe_ckpt", x, w, g)


def cond_cuda(x, g):
    """P3 through csrc/probe_mosaic.cu -> (y, dx); CUDA tensors of at most
    MAX_LANES elements only (a lane a thread in one block)."""
    _lanes("probe_cond", x, "one block")
    x, g = _on_card("probe_cond", x, g)
    y, dx = torch.empty_like(x), torch.empty_like(x)
    _launch("probe_cond", x.data_ptr(), g.data_ptr(), x.numel(),
            y.data_ptr(), dx.data_ptr(), device=x.device)
    return y, dx


def nested_march_cuda(x, w, g):
    """P4 through csrc/probe_mosaic.cu -> (dx, dw); CUDA tensors of at most
    MAX_LANES elements only."""
    return _vjp_cuda("probe_nested", x, w, g)


def gated_march_cuda(x, w, g, act=None):
    """P5 through csrc/probe_mosaic.cu -> (dx, dw); CUDA tensors of at most
    MAX_LANES elements only."""
    if act is None:
        act = (x > -1e9).to(torch.float32)
    return _vjp_cuda("probe_gated", x, w, g, act)


def ckpt_scratch_vjp(x, w, g):
    """P2: the kernel for CUDA tensors, the plain version for CPU ones."""
    if x.device.type == "cuda":
        return ckpt_scratch_cuda(x, w, g)
    return ckpt_scratch_plain(x, w, g)


def cond_vjp(x, g):
    """P3: the kernel for CUDA tensors, the plain version for CPU ones."""
    if x.device.type == "cuda":
        return cond_cuda(x, g)
    return cond_plain(x, g)


def nested_march_vjp(x, w, g):
    """P4: the kernel for CUDA tensors, the plain version for CPU ones."""
    if x.device.type == "cuda":
        return nested_march_cuda(x, w, g)
    return nested_march_plain(x, w, g)


def gated_march_vjp(x, w, g, act=None):
    """P5: the kernel for CUDA tensors, the plain version for CPU ones."""
    if x.device.type == "cuda":
        return gated_march_cuda(x, w, g, act)
    return gated_march_plain(x, w, g, act)
