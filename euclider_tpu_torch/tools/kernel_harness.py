"""The CUDA kernels' device code on the CPU, against the plain versions.

There is no nvcc off the card, but the device code of ``csrc/`` is C++
under a few stand-ins (``tools/cuda_stub/cuda_runtime.h``).  This module
cuts each source at its ``extern "C"`` entry point, appends a host entry
that runs the kernel body element by element (the forward kernel under
looped block and thread indices, ``pixel_backward`` summing every pixel's
gradient in float64, the segmented kernels' K6 over every pixel, then K7
as ``pixel_backward``; the probes' lanes in order, with their tile-wide
sums and decisions taken over the lanes in order), and builds it with g++
into ``euclider_tpu_torch/build/``, without contraction, as nvcc builds
every library with ``-fmad=false``.  It finds before a chip call what the
card would show: a wrong adjoint (the gradients against
``ops/vjp.py::vjp_blocked``, the probes against their plain versions) and
an out-of-bounds read (``--asan``).  A scene past the default build's
capacities (``ops/cuda_kernel.py::capacities``) is run in a build of the
same wider capacities, as the card would take.

    python -m euclider_tpu_torch.tools.kernel_harness --scene perlin_probe \\
        --size 160x90 [--asan] [--seams]
    python -m euclider_tpu_torch.tools.kernel_harness --probes
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import hashlib
import os
import subprocess
import sys

import numpy as np
import torch

from ..ops import cuda_bwd as CB
from ..ops import cuda_kernel as CK
from ..ops import march_probe as MP
from ..ops import probes as PR
from ..ops import vjp as vjp_mod

STUB = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda_stub")
CPU = torch.device("cpu")
BUILDS = (0, 1, 3, 4, 5, 7)   # every kB of trace_common.cuh
TAPE = 8                      # trace_common.cuh BUILD_TAPE: the tape
                              # kernel's builds, its march recorded

def _cases(builds):
    return "".join(f"case {k}: {{call}}<{k}>({{args}}); break; "
                   for k in builds)


# the backward's: the gradient vector in a shared-memory column (ACC_SHARED)
# or, where it is longer than a thread holds, local with atomics past
# MAX_PARAMS (ACC_WIDE)
def _acc_cases(builds, tag=0):
    return "".join(
        f"case {k}: if (wide) {{call}}<{k | tag}, ACC_WIDE>({{args}}); "
        f"else {{call}}<{k | tag}, {{narrow}}>({{args}}); break; "
        for k in builds)

# included by the backward entries: a pixel's gradient vector
_PIXEL_GRAD = """
#include <vector>

// one pixel's gradient vector, long enough for every entry, entry i at
// v[i * stride]: grad's own part and, from MAX_PARAMS on (stride 1), the
// part gadd sends to ext_col
struct PixelGrad {
    std::vector<float> v;
    int stride;
    PixelGrad(int n, int stride)
        : v((size_t)std::max(n, MAX_PARAMS) * stride), stride(stride) {
        ext_col = v.data() + MAX_PARAMS;
        ext_stride = 1;
    }
    void zero() { std::fill(v.begin(), v.end(), 0.0f); }
    void sum_into(double* out, int n) const {
        for (int p = 0; p < n; ++p) out[p] += v[(size_t)p * stride];
    }
};

"""

def _entry_sources(builds=BUILDS) -> dict:
    """Each source's host entries, whose switches instantiate the kernel
    builds ``builds`` (kB values of trace_common.cuh)."""
    return {
    "trace_fwd": """
extern "C" int harness_fwd(const int32_t* const* ints,
                           const float* const* floats, const int* params,
                           float t_max, const float* cam, int H, int W,
                           int rows, float* out) {
    const Scene s = make_scene(ints, floats, params, t_max, cam);
    load_side_rows(s, 0, 1);
    const int build = scene_build(params);
    blockDim = fwd_block(build);
    for (int y = 0; y < rows; ++y)
        for (int x = 0; x < W; ++x) {
            blockIdx = dim3(x / blockDim.x, y / blockDim.y);
            threadIdx = dim3(x % blockDim.x, y % blockDim.y);
            switch (build) { CASES default: return 1; }
        }
    return 0;
}
""".replace("CASES", _cases(builds).format(call="trace_fwd_kernel",
                                   args="s, cam, H, W, rows, out")),
    "trace_bwd": _PIXEL_GRAD + """
extern "C" int harness_bwd(const int32_t* const* ints,
                           const float* const* floats, const int* params,
                           float t_max, const int* sizes, const float* cam,
                           int H, int W, int rows, const float* gin,
                           double* out, float* gtex) {
    const Scene s = make_scene(ints, floats, params, t_max, cam);
    load_side_rows(s, 0, 1);
    const Offs off = make_offs(sizes);
    const int build = scene_build(params);
    const bool wide = off.n > MAX_PARAMS;
    PixelGrad pg(off.n, wide ? 1 : ACC_STRIDE);
    float* grad = pg.v.data();
    for (int y = 0; y < rows; ++y)
        for (int x = 0; x < W; ++x) {
            pg.zero();
            switch (build) { CASES default: return -1; }
            pg.sum_into(out, off.n);
        }
    return off.n;
}

// The block's sums of NTHREADS threads' gradient vectors mat[t * n + p] ->
// out[p], through the kernel's device code: each phase of block_partials
// (between two of its __syncthreads or __syncwarp) over every thread of
// the block or the warp before the next; local: the vectors go through
// each warp's tile as local ones do (ACC_LOCAL, ACC_WIDE), else they lie
// in the threads' columns as gadd leaves them (ACC_SHARED).
extern "C" void harness_block_sums(const float* mat, int n, int local,
                                   float* out) {
    if (!local) {
        std::vector<float> acc((size_t)n * ACC_STRIDE);
        for (int t = 0; t < NTHREADS; ++t)
            for (int p = 0; p < n; ++p)
                acc[(size_t)p * ACC_STRIDE + t] = mat[(size_t)t * n + p];
        for (int t = 0; t < NTHREADS; ++t) warp_row_sums(acc.data(), n, t);
        for (int t = 0; t < NTHREADS; ++t)
            block_row_sums(acc.data(), ACC_STRIDE, 32, n, t, out, 1);
        return;
    }
    std::vector<float> work(LOCAL_SUMS_FLOATS);
    for (int w = 0; w < NWARPS; ++w) {
        float* tile = work.data() + NWARPS * MAX_PARAMS +
                      w * TILE_ROWS * TILE_STRIDE;
        for (int p0 = 0; p0 < n; p0 += TILE_ROWS) {
            const int m = std::min(TILE_ROWS, n - p0);
            for (int l = 0; l < 32; ++l)
                tile_put(tile, mat + (size_t)(32 * w + l) * n, p0, m, l);
            for (int l = 0; l < 32; ++l)
                tile_sums(tile, m, l, work.data() + w * MAX_PARAMS + p0);
        }
    }
    for (int t = 0; t < NTHREADS; ++t)
        block_row_sums(work.data(), 1, MAX_PARAMS, n, t, out, 1);
}

""".replace("CASES", _acc_cases(builds, TAPE).format(
        call="pixel_backward", narrow="ACC_SHARED",
        args="s, off, cam, x, y, H, W, gin, 0.0f, false, grad, gtex")),
    "trace_seg": _PIXEL_GRAD + """
extern "C" int harness_seg(const int32_t* const* ints,
                           const float* const* floats, const int* params,
                           float t_max, const int* sizes, const float* cam,
                           int H, int W, int rows, const float* gin,
                           int chunk_trips, float* carry, float* acc,
                           double* out, float* gtex) {
    const Scene s = make_scene(ints, floats, params, t_max, cam);
    load_side_rows(s, 0, 1);
    const Offs off = make_offs(sizes);
    const int build = scene_build(params);
    const Chunks ch = make_chunks(s.max_nodes, chunk_trips);
    for (int y = 0; y < rows; ++y)
        for (int x = 0; x < W; ++x)
            switch (build) { FWD_CASES default: return -1; }
    const bool wide = off.n > MAX_PARAMS;
    PixelGrad pg(off.n, wide ? 1 : ACC_STRIDE);
    float* grad = pg.v.data();
    for (int y = 0; y < rows; ++y)
        for (int x = 0; x < W; ++x) {
            pg.zero();
            switch (build) { BWD_CASES default: return -1; }
            pg.sum_into(out, off.n);
        }
    return off.n;
}
""".replace("BWD_CASES", _acc_cases(builds).format(
        call="pixel_seg_bwd", narrow="ACC_SHARED",
        args="s, off, cam, x, y, H, W, rows, ch, carry, acc, gin, 0.0f, "
             "false, grad, gtex")).replace("FWD_CASES", _cases(builds).format(
        call="pixel_seg_fwd",
        args="s, cam, x, y, H, W, rows, ch, carry, acc")),
    "probe_mosaic": """
extern "C" void harness_probe(int probe, const float* x, float w,
                              const float* g, const float* act, int n,
                              float* y, float* dx, float* dw) {
    float acc = 0.0f;
    int any = 0;
    for (int i = 0; i < n; ++i) {
        acc += probe == 1 ? x[i] : 0.0f;
        any |= probe == 3 && act[i] > 0.5f;
    }
    const bool live = probe == 1 ? acc > 0.0f : any != 0;
    acc = 0.0f;
    for (int i = 0; i < n; ++i) {
        float dwi = 0.0f;
        switch (probe) {
            case 0: ckpt_element(x[i], w, g[i], dx + i, &dwi); break;
            case 1: cond_element(x[i], g[i], live, y + i, dx + i); break;
            case 2: nested_element(x[i], w, g[i], dx + i, &dwi); break;
            default: gated_element(x[i], w, g[i], live, dx + i, &dwi);
        }
        acc += dwi;
    }
    *dw = acc;
}
""",
    "probe_march": """
// The lanes in order, each writing its output before the tile's sum and
// its share of sum(d shape_vec) into part[i]; march_probe() adds the sum.
extern "C" int harness_probe_march(const int32_t* const* ints,
                                   const float* const* floats,
                                   const int* params, float t_max,
                                   const float* cam, int stage, int mat,
                                   const float* org, const float* dir, int n,
                                   float* out, int* steps, int* ent,
                                   float* part) {
    const Scene s = make_scene(ints, floats, params, t_max, cam);
    load_side_rows(s, 0, 1);
    if (scene_build(params) != BUILD_WARP || s.march_steps > TAPE_STEPS ||
        n <= 0 || n > CLUSTER_LANES)
        return 1;
    for (int i = 0; i < n; ++i)
        probe_lane(s, stage, mat, load4(org + 4 * i), load4(dir + 4 * i),
                   out + i, steps + i, ent + i, part + i);
    return 0;
}
""",
    "probe_rev": """
extern "C" void harness_probe_rev(const float* x, float w, const float* g,
                                  int n, float* dx, float* dw) {
    float acc = 0.0f;
    for (int i = 0; i < n; ++i) {
        float dwi;
        element(x[i], w, g[i], dx + i, &dwi);
        acc += dwi;
    }
    *dw = acc;
}
""",
    }


_ENTRY = _entry_sources()
MOSAIC = ("probe_ckpt", "probe_cond", "probe_nested", "probe_gated")


def _flags(asan: bool) -> list:
    flags = ["-O2", "-std=c++17", "-shared", "-fPIC", "-w", "-I", STUB,
             "-I", CK.CSRC, "-ffp-contract=off"]
    if asan:
        flags += ["-fsanitize=address", "-fno-omit-frame-pointer"]
    return flags


def build(asan: bool = False, caps=(), names=tuple(_ENTRY),
          builds=BUILDS) -> dict:
    """Build the host libraries of the named sources of _ENTRY (one g++
    process each, started together) unless built already -> {name: path},
    with the capacities ``caps`` ((name, value) pairs of CK.CAPACITIES)
    where the source reads them and the kernel builds ``builds``."""
    out, procs = {}, {}
    sources = _entry_sources(builds)
    for name in names:
        entry = sources[name]
        flags = _flags(asan) + [
            f"-D{CK.CAPACITIES[k][1]}={v}" for k, v in caps
            if k in CK.SOURCE_CAPACITIES.get(name, ())]
        with open(CK.SOURCES[name]) as f:
            src = f.read()
        src = src[:src.index('extern "C"')] + entry
        h = hashlib.sha256((" ".join(flags) + src).encode())
        for path in CK.HEADERS + tuple(os.path.join(STUB, f) for f in (
                "cuda_runtime.h", "cooperative_groups.h")):
            with open(path, "rb") as f:
                h.update(f.read())
        tag = h.hexdigest()[:16]
        lib = os.path.join(CK.BUILD_DIR, f"harness_{name}-{tag}.so")
        out[name] = lib
        if os.path.exists(lib):
            continue
        os.makedirs(CK.BUILD_DIR, exist_ok=True)
        cpp = f"{lib[:-3]}-{os.getpid()}.cpp"
        with open(cpp, "w") as f:
            f.write(src)
        tmp = f"{lib[:-3]}-{os.getpid()}.so"
        procs[name] = (cpp, tmp, subprocess.Popen(
            ["g++", *flags, "-o", tmp, cpp], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    errors = []
    for name, (cpp, tmp, proc) in procs.items():
        _, err = proc.communicate()
        os.remove(cpp)
        if proc.returncode != 0:
            errors.append(f"g++ failed on {name}:\n{err}")
        else:
            os.replace(tmp, out[name])
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def _caps(static, caps=None) -> tuple:
    """The capacities of the build the harness runs ``static`` in: the
    card's (CK.capacities), raised to ``caps`` ({name: value}) where
    given."""
    out = dict(CK.capacities(static))
    for k, v in (caps or {}).items():
        out[k] = max(v, out.get(k, CK.CAPACITIES[k][0]))
    return tuple(sorted(out.items()))


def _build_of(static, caps=None) -> dict:
    """The harness build a scene runs in, as _entry's keywords: its
    capacities (``_caps``) and, in a wider build, only the scene's kernel
    build (trace_common.cuh scene_build), so that g++ compiles one build
    of each kernel instead of every one."""
    caps = _caps(static, caps)
    if not caps:
        return {"caps": caps}
    warp = (3 if CK.has_expr(static) else 1) if CK.marches(static) else 0
    return {"caps": caps, "builds": (warp | 4 * CK.has_shapes(static),)}


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_HEAD = [_P] * 3 + [_F] + [_P] * 2 + [_I] * 3 + [_P]
# the host entries: kind -> (source, C function, argument types, result)
_HOST = {
    "fwd": ("trace_fwd", "harness_fwd",
            [_P] * 3 + [_F, _P] + [_I] * 3 + [_P], _I),
    "bwd": ("trace_bwd", "harness_bwd", _HEAD + [_P] * 2, _I),
    "seg": ("trace_seg", "harness_seg", _HEAD + [_I] + [_P] * 4, _I),
    "sums": ("trace_bwd", "harness_block_sums", [_P, _I, _I, _P], None),
    "mosaic": ("probe_mosaic", "harness_probe",
               [_I, _P, _F, _P, _P, _I, _P, _P, _P], None),
    "march": ("probe_march", "harness_probe_march",
              [_P, _P, _P, _F, _P, _I, _I, _P, _P, _I, _P, _P, _P, _P], _I),
    "rev": ("probe_rev", "harness_probe_rev", [_P, _F, _P, _I, _P, _P],
            None),
}


@functools.lru_cache(maxsize=None)
def _entry(kind: str, asan: bool = False, caps=(), builds=BUILDS):
    """Host entry ``kind`` of _HOST, its source built once (only it) at
    the capacities ``caps`` with the kernel builds ``builds``."""
    src, fn, argtypes, restype = _HOST[kind]
    fn = getattr(ctypes.CDLL(build(asan, caps, (src,), builds)[src]), fn)
    fn.argtypes, fn.restype = argtypes, restype
    return fn


def _scene(static, tables, cam, time, y0):
    floats = CK._check_tables(static, tables, CPU)
    cam_row = CK._pack_camera(cam, time, y0, CPU)
    iptr, fptr, params, ints = CK.scene_args(static, floats, CPU,
                                             CK.tex_shapes(tables))
    return floats, cam_row, (iptr, fptr, params, ints)


def render(static, tables, cam, H, W, time=0.0, y0=0, rows=None,
           asan=False, caps=None) -> torch.Tensor:
    """The forward kernel's body on CPU tables -> [rows or H, W, 3], in
    the build of the scene's capacities (``_caps``)."""
    R = H if rows is None else rows
    _, cam_row, (iptr, fptr, params, _ints) = _scene(static, tables, cam,
                                                     time, y0)
    out = torch.zeros((R, W, 3), dtype=torch.float32)
    rc = _entry("fwd", asan, **_build_of(static, caps))(
        iptr, fptr, params, static.t_max, CK.camera_ptr(cam_row), H, W, R,
        out.data_ptr())
    if rc != 0:
        raise RuntimeError(f"harness_fwd: build {rc} is not compiled")
    return out


def vjp(static, tables, cam, H, W, g, time=0.0, y0=0, rows=None,
        asan=False, chunk_trips=None, caps=None):
    """The backward's device code in vjp mode on CPU tables under the
    cotangent g -> (d_tables, d_cam, d_time), the pixels' gradients summed
    in float64: pixel_backward (the tape kernel, its marches recorded in
    the forward sweep) or, with ``chunk_trips``, K6 (pixel_seg_fwd) over
    every pixel, then K7 (pixel_seg_bwd)."""
    R = H if rows is None else rows
    floats, cam_row, (iptr, fptr, params, _ints) = _scene(static, tables,
                                                          cam, time, y0)
    sizes, n = CB.grad_layout(static, floats)
    acc = np.zeros(n, np.float64)
    gtex = torch.zeros_like(floats[-1])
    g = g.detach().to(torch.float32).contiguous()
    args = (iptr, fptr, params, static.t_max, sizes, CK.camera_ptr(cam_row),
            H, W, R, g.data_ptr())
    build = _build_of(static, caps)
    if chunk_trips is None:
        got = _entry("bwd", asan, **build)(*args, acc.ctypes.data,
                                           gtex.data_ptr())
    else:
        K = len(vjp_mod.chunk_sizes(static.max_nodes, chunk_trips))
        carry = torch.zeros(max(1, K * (1 + CB.SLOT_WORDS
                                        * (static.max_depth + 1)) * R * W))
        col = torch.zeros(4 * R * W)
        got = _entry("seg", asan, **build)(
            *args, chunk_trips, carry.data_ptr(), col.data_ptr(),
            acc.ctypes.data, gtex.data_ptr())
    if got != n:
        raise RuntimeError("the harness refused the scene")
    flat = torch.from_numpy(acc.astype(np.float32))
    return CB._grads(static, tables, cam, time, flat, gtex, floats)[:3]


def compare(sc, H, W, asan=False, seams=False, chunk_trips=None,
            caps=None, y0=0, rows=None) -> dict:
    """Forward and vjp of the harness against the plain versions on rows
    [y0, y0 + rows) of the H x W frame of the scene ``sc`` (an ir.Scene or
    a library scene's name), in the build of its capacities raised to
    ``caps`` ({name: value}, or None): {"fwd_max",
    "fwd_bad" (pixels beyond 1e-4), "bwd_worst" (the worst leaf's error
    over 1e-3 * max(max |ref|, 1)), "leaf", "caps"}.  The backward is the tape
    kernel's against ``vjp_blocked`` or, with ``chunk_trips``, K6 then K7
    against ``vjp_segmented``.  The cotangent is seeded, zero where the
    forwards differ beyond 1e-4 and, with ``seams``, on image seams
    (chip_smoke.py's rule)."""
    from ..ops import trace
    from ..ops.vjp import vjp_blocked, vjp_segmented
    from ..scene.compile import (camera_to_torch, compile_camera,
                                 compile_scene, tables_to_torch)
    from ..scene.library import get_scene
    from ..utils import validate
    if isinstance(sc, str):
        sc = get_scene(sc)
    static, t = compile_scene(sc)
    tables = tables_to_torch(t, CPU)
    cam = camera_to_torch(compile_camera(sc.camera), CPU)
    R = H if rows is None else rows
    got = render(static, tables, cam, H, W, y0=y0, rows=R, asan=asan,
                 caps=caps)
    ref = trace.render_image(static, tables, cam, H, W, y0=y0, rows=R)
    err = (got - ref).abs().amax(-1)
    keep = ~(err > 1e-4)
    if seams:
        keep &= ~validate.seams(ref)
    g = torch.from_numpy(np.random.default_rng(0).normal(
        size=(R, W, 3)).astype(np.float32)) * keep[..., None]
    if chunk_trips is None:
        a = vjp_blocked(static, tables, cam, H, W, g, y0=y0, rows=R)
    else:
        a = vjp_segmented(static, tables, cam, H, W, g, y0=y0, rows=R,
                          chunk_trips=chunk_trips)
    b = vjp(static, tables, cam, H, W, g, y0=y0, rows=R, asan=asan,
            chunk_trips=chunk_trips, caps=caps)
    worst = (0.0, "")
    pairs = ([(k, getattr(a[0], k), getattr(b[0], k))
              for k in CK.FLOAT_FIELDS]
             + [(f"textures[{i}]", x, y)
                for i, (x, y) in enumerate(zip(a[0].textures, b[0].textures))]
             + [(f"cam.{k}", x, y)
                for k, x, y in zip(a[1]._fields, a[1], b[1])]
             + [("time", a[2], b[2])])
    for k, x, y in pairs:
        if x.numel():
            e = float((x.double() - y.double()).abs().max())
            worst = max(worst, (e / (1e-3 * max(float(x.abs().max()), 1.0)),
                                k))
    return {"fwd_max": float(err.max()), "fwd_bad": int((err > 1e-4).sum()),
            "bwd_worst": worst[0], "leaf": worst[1],
            "caps": dict(_caps(static, caps))}


def block_sums(mat, local: bool, asan=False) -> torch.Tensor:
    """The backward kernels' block reduction (trace_adj.cuh
    block_partials: warp_row_sums and block_row_sums, or for local vectors
    tile_put, tile_sums and block_row_sums) of 256 threads' gradient
    vectors ``mat`` [256, n] -> [n] float32; ``local``: the vectors go
    through the warps' tiles as local ones do, else they lie in
    shared-memory columns."""
    mat = mat.detach().to(torch.float32).contiguous()
    out = torch.zeros(mat.shape[1], dtype=torch.float32)
    _entry("sums", asan)(mat.data_ptr(), mat.shape[1], int(local),
                         out.data_ptr())
    return out


def mosaic(name, x, w, g, act=None, asan=False):
    """probe_mosaic.cu's kernel ``name`` (one of MOSAIC) on CPU tensors ->
    (dx, dw), or (y, dx) for probe_cond."""
    x = x.detach().to(torch.float32).contiguous()
    g = g.detach().to(torch.float32).contiguous()
    if act is None:
        act = (x > -1e9).to(torch.float32)
    act = act.detach().to(torch.float32).contiguous()
    y, dx = torch.zeros_like(x), torch.zeros_like(x)
    dw = torch.zeros((), dtype=torch.float32)
    _entry("mosaic", asan)(MOSAIC.index(name), x.data_ptr(), float(w),
                           g.data_ptr(), act.data_ptr(), x.numel(),
                           y.data_ptr(), dx.data_ptr(), dw.data_ptr())
    return (y, dx) if name == "probe_cond" else (dx, dw)


def march_probe(static, tables, org, d, stage, asan=False) -> MP.ProbeOut:
    """probe_march.cu's lanes on CPU tables -> ProbeOut, the tile's
    sum(d shape_vec) taken from the lanes' shares in the kernel's order
    (march_probe.tile_sum) and added to every lane, as the kernel does."""
    floats = CK._check_tables(static, tables, CPU)
    iptr, fptr, params, _ints = CK.scene_args(static, floats, CPU,
                                              CK.tex_shapes(tables))
    cam = torch.zeros(24, dtype=torch.float32)
    cam[17] = MP.TIME
    org, d = org.contiguous(), d.contiguous()
    shape = org.shape[:-1]
    out = torch.zeros(shape, dtype=torch.float32)
    steps = torch.zeros(shape, dtype=torch.int32)
    ent = torch.zeros(shape, dtype=torch.int32)
    part = torch.zeros(shape, dtype=torch.float32)
    rc = _entry("march", asan, **_build_of(static))(
        iptr, fptr, params, static.t_max, cam.data_ptr(),
        MP.STAGES.index(stage), MP.WARP_MAT, org.data_ptr(), d.data_ptr(),
        out.numel(), out.data_ptr(), steps.data_ptr(), ent.data_ptr(),
        part.data_ptr())
    if rc != 0:
        raise RuntimeError("harness_probe_march refused the scene")
    if stage == "fwd":   # the kernel takes no sum
        return MP.ProbeOut(out, steps, ent, torch.zeros(()))
    dsv = MP.tile_sum(part)
    return MP.ProbeOut(out + dsv, steps, ent, dsv)


def compare_mosaic(asan=False) -> dict:
    """probe_mosaic.cu's kernels against the plain versions on the mosaic
    tool's seeded tiles (P3 in both branches, P5 also dead) -> {name:
    error}: dx's (and y's) largest difference over max |ref|, and dw's
    relative difference."""
    rng = np.random.default_rng
    t = lambda a: torch.from_numpy(a.astype(np.float32))
    errs = {}

    def rel(ref, got):
        return max(float((r - x).abs().max() / max(float(r.abs().max()), 1e-30))
                   for r, x in zip(ref, got))

    x, g = t(rng(0).normal(size=(8, 128))), t(rng(1).normal(size=(8, 128)))
    errs["probe_ckpt"] = rel(PR.ckpt_scratch_plain(x, 0.7, g),
                             mosaic("probe_ckpt", x, 0.7, g, asan=asan))
    r = rng(2)
    for shift in (1.0, -1.0):
        x = t(r.normal(size=(8, 128)) + shift)
        g = t(r.normal(size=(8, 128)))
        errs[f"probe_cond{shift:+.0f}"] = rel(PR.cond_plain(x, g),
                                              mosaic("probe_cond", x, 0.0, g,
                                                     asan=asan))
    x, g = t(rng(3).normal(size=(8, 128)) * 0.3), t(rng(4).normal(size=(8, 128)))
    errs["probe_nested"] = rel(PR.nested_march_plain(x, 0.9, g),
                               mosaic("probe_nested", x, 0.9, g, asan=asan))
    x, g = t(rng(5).normal(size=(8, 128)) * 0.3), t(rng(6).normal(size=(8, 128)))
    for tag, act in (("", None), ("_dead", torch.zeros_like(x))):
        errs["probe_gated" + tag] = rel(
            PR.gated_march_plain(x, 0.8, g, act),
            mosaic("probe_gated", x, 0.8, g, act, asan))
    return errs


def rev(x, w, g, asan=False):
    """probe_rev.cu's lanes on CPU tensors, dw summed in the lanes' order
    -> (dx, dw)."""
    x = x.detach().to(torch.float32).contiguous()
    g = g.detach().to(torch.float32).contiguous()
    dx = torch.zeros_like(x)
    dw = torch.zeros((), dtype=torch.float32)
    _entry("rev", asan)(x.data_ptr(), float(w), g.data_ptr(), x.numel(),
                        dx.data_ptr(), dw.data_ptr())
    return dx, dw


def compare_rev(asan=False) -> dict:
    """probe_rev.cu against rev_march_plain on the probe's seeded tile
    (chip_smoke.py phase 9's) -> {"dx": dx's largest difference over
    max |ref|, "dw": dw's relative difference}."""
    rng = np.random.default_rng
    x = torch.from_numpy((rng(7).normal(size=(8, 128)) * 0.8).astype(
        np.float32))
    g = torch.from_numpy(rng(8).normal(size=(8, 128)).astype(np.float32))
    (pdx, pdw), (dx, dw) = PR.rev_march_plain(x, 1.1, g), rev(x, 1.1, g, asan)
    return {"dx": float((dx - pdx).abs().max() / pdx.abs().max()),
            "dw": abs(float(dw) - float(pdw)) / abs(float(pdw))}


def compare_march(tile, stage, asan=False) -> dict:
    """probe_march.cu's stage against march_probe_plain on the tool's or
    the crossing tile -> march_probe.compare's dict."""
    static, tables = MP.probe_scene()
    org, d = MP.tool_tile() if tile == "tool" else MP.crossing_tile()
    return MP.compare(MP.march_probe_plain(static, tables, org, d, stage),
                      march_probe(static, tables, org, d, stage, asan))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="euclider_tpu_torch.tools.kernel_harness",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--scene", default="config3_csg_textured")
    p.add_argument("--size", default="160x90", help="WxH")
    p.add_argument("--asan", action="store_true",
                   help="build with AddressSanitizer (re-runs itself with "
                        "libasan preloaded)")
    p.add_argument("--seams", action="store_true",
                   help="zero the cotangent on image seams too")
    p.add_argument("--probes", action="store_true",
                   help="the probes instead of a scene: probe_mosaic.cu's "
                        "kernels on the mosaic tool's tiles, probe_rev.cu's "
                        "on its tile, probe_march.cu's stages on both tiles")
    p.add_argument("--chunk-trips", type=int, default=None,
                   help="run the segmented backward (K6 then K7) with chunks "
                        "of this many trips, against vjp_segmented")
    args = p.parse_args(argv)
    if args.asan and "libasan" not in os.environ.get("LD_PRELOAD", ""):
        lib = subprocess.run(["g++", "-print-file-name=libasan.so"],
                             capture_output=True, text=True).stdout.strip()
        env = dict(os.environ, LD_PRELOAD=lib,
                   ASAN_OPTIONS="detect_leaks=0")
        return subprocess.run([sys.executable, "-m", __spec__.name,
                               *(argv if argv is not None else sys.argv[1:])],
                              env=env).returncode
    W, H = (int(v) for v in args.size.lower().split("x"))
    if args.probes:
        print("mosaic", compare_mosaic(args.asan))
        print("rev", compare_rev(args.asan))
        for tile in ("tool", "crossing"):
            for stage in MP.STAGES:
                print("march", tile, stage,
                      compare_march(tile, stage, args.asan))
        return 0
    print(args.scene, compare(args.scene, H, W, args.asan, args.seams,
                              args.chunk_trips))
    return 0


if __name__ == "__main__":
    sys.exit(main())
