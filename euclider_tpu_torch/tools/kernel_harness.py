"""The CUDA kernels' device code on the CPU, against the plain versions.

There is no nvcc off the card, but the device code of ``csrc/trace_fwd.cu``,
``csrc/trace_bwd.cu`` and ``csrc/trace_seg.cu`` is C++ under a few
stand-ins (``tools/cuda_stub/cuda_runtime.h``).  This module cuts each
source at its ``extern "C"`` entry point, appends a host entry that runs
the kernel body pixel by pixel (the forward kernel under looped block and
thread indices, ``pixel_backward`` summing every pixel's gradient in
float64, the segmented kernels' K6 over every pixel, then K7 as
``pixel_backward``), and builds it with g++ into
``euclider_tpu_torch/build/``.  It finds before a chip
call what the card would show: a wrong adjoint (the gradients against
``ops/vjp.py::vjp_blocked``), an out-of-bounds read (``--asan``), and the
pixels that nvcc's FMA contraction moves (``--fma``: contraction allowed,
as in the builds without ``BUILD_SHAPES``; without it every operation
rounds separately, as in the ``_shapes`` libraries built with
``-fmad=false``).

    python -m euclider_tpu_torch.tools.kernel_harness --scene perlin_probe \\
        --size 160x90 [--fma] [--asan] [--seams]
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
from ..ops import vjp as vjp_mod

STUB = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda_stub")
CPU = torch.device("cpu")
BUILDS = (0, 1, 3, 4, 5, 7)   # every kB of trace_common.cuh

_CASES = "".join(f"case {k}: {{call}}<{k}>({{args}}); break; "
                 for k in BUILDS)
# the backward's: the wide instantiation (kWide) where the gradient vector
# is longer than a thread holds
_WIDE_CASES = "".join(
    f"case {k}: if (wide) {{call}}<{k}, true>({{args}}); "
    f"else {{call}}<{k}, false>({{args}}); break; " for k in BUILDS)

# included by the backward entries: a pixel's gradient vector
_PIXEL_GRAD = """
#include <vector>

// one pixel's gradient vector, long enough for every entry: grad's own
// part and, from MAX_PARAMS on, the part gadd sends to ext_col (stride 1)
struct PixelGrad {
    std::vector<float> v;
    explicit PixelGrad(int n) : v(std::max(n, MAX_PARAMS)) {
        ext_col = v.data() + MAX_PARAMS;
        ext_stride = 1;
    }
    void zero() { std::fill(v.begin(), v.end(), 0.0f); }
    void sum_into(double* out, int n) const {
        for (int p = 0; p < n; ++p) out[p] += v[p];
    }
};

"""

_ENTRY = {
    "trace_fwd": """
extern "C" int harness_fwd(const int32_t* const* ints,
                           const float* const* floats, const int* params,
                           float t_max, const float* cam, int H, int W,
                           int rows, float* out) {
    const Scene s = make_scene(ints, floats, params, t_max, cam);
    const int build = scene_build(params);
    blockDim = dim3(32, 8);
    for (int y = 0; y < rows; ++y)
        for (int x = 0; x < W; ++x) {
            blockIdx = dim3(x / 32, y / 8);
            threadIdx = dim3(x % 32, y % 8);
            switch (build) { CASES default: return 1; }
        }
    return 0;
}
""".replace("CASES", _CASES.format(call="trace_fwd_kernel",
                                   args="s, cam, H, W, rows, out")),
    "trace_bwd": _PIXEL_GRAD + """
extern "C" int harness_bwd(const int32_t* const* ints,
                           const float* const* floats, const int* params,
                           float t_max, const int* sizes, const float* cam,
                           int H, int W, int rows, const float* gin,
                           double* out, float* gtex) {
    const Scene s = make_scene(ints, floats, params, t_max, cam);
    const Offs off = make_offs(sizes);
    const int build = scene_build(params);
    const bool wide = off.n > MAX_PARAMS;
    PixelGrad pg(off.n);
    float* grad = pg.v.data();
    for (int y = 0; y < rows; ++y)
        for (int x = 0; x < W; ++x) {
            pg.zero();
            switch (build) { CASES default: return -1; }
            pg.sum_into(out, off.n);
        }
    return off.n;
}

""".replace("CASES", _WIDE_CASES.format(
        call="pixel_backward",
        args="s, off, cam, x, y, H, W, gin, 0.0f, false, grad, gtex")),
    "trace_seg": _PIXEL_GRAD + """
extern "C" int harness_seg(const int32_t* const* ints,
                           const float* const* floats, const int* params,
                           float t_max, const int* sizes, const float* cam,
                           int H, int W, int rows, const float* gin,
                           int chunk_trips, float* carry, float* acc,
                           double* out, float* gtex) {
    const Scene s = make_scene(ints, floats, params, t_max, cam);
    const Offs off = make_offs(sizes);
    const int build = scene_build(params);
    const Chunks ch = make_chunks(s.max_nodes, chunk_trips);
    for (int y = 0; y < rows; ++y)
        for (int x = 0; x < W; ++x)
            switch (build) { FWD_CASES default: return -1; }
    const bool wide = off.n > MAX_PARAMS;
    PixelGrad pg(off.n);
    float* grad = pg.v.data();
    for (int y = 0; y < rows; ++y)
        for (int x = 0; x < W; ++x) {
            pg.zero();
            switch (build) { BWD_CASES default: return -1; }
            pg.sum_into(out, off.n);
        }
    return off.n;
}
""".replace("BWD_CASES", _WIDE_CASES.format(
        call="pixel_seg_bwd",
        args="s, off, cam, x, y, H, W, rows, ch, carry, acc, gin, 0.0f, "
             "false, grad, gtex")).replace("FWD_CASES", _CASES.format(
        call="pixel_seg_fwd",
        args="s, cam, x, y, H, W, rows, ch, carry, acc")),
}


def _flags(fma: bool, asan: bool) -> list:
    flags = ["-O2", "-std=c++17", "-shared", "-fPIC", "-w", "-I", STUB,
             "-I", CK.CSRC]
    flags += (["-ffp-contract=fast", "-mfma", "-DFMA_EMU"] if fma
              else ["-ffp-contract=off"])
    if asan:
        flags += ["-fsanitize=address", "-fno-omit-frame-pointer"]
    return flags


def build(fma: bool = False, asan: bool = False) -> dict:
    """Build the host libraries (one g++ process each, started together)
    unless built already -> {"trace_fwd": path, "trace_bwd": path,
    "trace_seg": path}."""
    flags = _flags(fma, asan)
    out, procs = {}, {}
    for name, entry in _ENTRY.items():
        with open(CK.SOURCES[name]) as f:
            src = f.read()
        src = src[:src.index('extern "C"')] + entry
        h = hashlib.sha256((" ".join(flags) + src).encode())
        for path in CK.HEADERS + (os.path.join(STUB, "cuda_runtime.h"),):
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


@functools.lru_cache(maxsize=None)
def _entries(fma: bool, asan: bool):
    libs = build(fma, asan)
    fwd = ctypes.CDLL(libs["trace_fwd"]).harness_fwd
    fwd.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_float, ctypes.c_void_p]
                    + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    head = ([ctypes.c_void_p] * 3 + [ctypes.c_float] + [ctypes.c_void_p] * 2
            + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    bwd = ctypes.CDLL(libs["trace_bwd"]).harness_bwd
    bwd.argtypes = head + [ctypes.c_void_p] * 2
    seg = ctypes.CDLL(libs["trace_seg"]).harness_seg
    seg.argtypes = head + [ctypes.c_int] + [ctypes.c_void_p] * 4
    return fwd, bwd, seg


def _scene(static, tables, cam, time, y0):
    floats = CK._check_tables(static, tables, CPU)
    cam_row = CK._pack_camera(cam, time, y0, CPU)
    iptr, fptr, params, ints = CK.scene_args(static, floats, CPU,
                                             CK.tex_shapes(tables))
    return floats, cam_row, (iptr, fptr, params, ints)


def render(static, tables, cam, H, W, time=0.0, y0=0, rows=None,
           fma=False, asan=False) -> torch.Tensor:
    """The forward kernel's body on CPU tables -> [rows or H, W, 3]."""
    R = H if rows is None else rows
    _, cam_row, (iptr, fptr, params, _ints) = _scene(static, tables, cam,
                                                     time, y0)
    out = torch.zeros((R, W, 3), dtype=torch.float32)
    rc = _entries(fma, asan)[0](iptr, fptr, params, static.t_max,
                                cam_row.data_ptr(), H, W, R, out.data_ptr())
    if rc != 0:
        raise RuntimeError(f"harness_fwd: build {rc} is not compiled")
    return out


def vjp(static, tables, cam, H, W, g, time=0.0, y0=0, rows=None,
        fma=False, asan=False, chunk_trips=None):
    """The backward's device code in vjp mode on CPU tables under the
    cotangent g -> (d_tables, d_cam, d_time), the pixels' gradients summed
    in float64: pixel_backward (the tape kernel) or, with ``chunk_trips``,
    K6 (pixel_seg_fwd) over every pixel, then K7 (pixel_seg_bwd)."""
    R = H if rows is None else rows
    floats, cam_row, (iptr, fptr, params, _ints) = _scene(static, tables,
                                                          cam, time, y0)
    sizes, n = CB.grad_layout(static, floats)
    acc = np.zeros(n, np.float64)
    gtex = torch.zeros_like(floats[-1])
    g = g.detach().to(torch.float32).contiguous()
    args = (iptr, fptr, params, static.t_max, sizes, cam_row.data_ptr(), H,
            W, R, g.data_ptr())
    _, bwd, seg = _entries(fma, asan)
    if chunk_trips is None:
        got = bwd(*args, acc.ctypes.data, gtex.data_ptr())
    else:
        K = len(vjp_mod.chunk_sizes(static.max_nodes, chunk_trips))
        carry = torch.zeros(max(1, K * (1 + CB.SLOT_WORDS
                                        * (static.max_depth + 1)) * R * W))
        col = torch.zeros(3 * R * W)
        got = seg(*args, chunk_trips, carry.data_ptr(), col.data_ptr(),
                  acc.ctypes.data, gtex.data_ptr())
    if got != n:
        raise RuntimeError("the harness refused the scene")
    flat = torch.from_numpy(acc.astype(np.float32))
    return CB._grads(static, tables, cam, flat, gtex, floats)[:3]


def compare(sc, H, W, fma=False, asan=False, seams=False,
            chunk_trips=None) -> dict:
    """Forward and vjp of the harness against the plain versions on the
    scene ``sc`` (an ir.Scene or a library scene's name): {"fwd_max",
    "fwd_bad" (pixels beyond 1e-4), "bwd_worst" (the worst leaf's error
    over 1e-3 * max(max |ref|, 1)), "leaf"}.  The backward is the tape
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
    got = render(static, tables, cam, H, W, fma=fma, asan=asan)
    ref = trace.render_image(static, tables, cam, H, W)
    err = (got - ref).abs().amax(-1)
    keep = ~(err > 1e-4)
    if seams:
        keep &= ~validate.seams(ref)
    g = torch.from_numpy(np.random.default_rng(0).normal(
        size=(H, W, 3)).astype(np.float32)) * keep[..., None]
    if chunk_trips is None:
        a = vjp_blocked(static, tables, cam, H, W, g)
    else:
        a = vjp_segmented(static, tables, cam, H, W, g,
                          chunk_trips=chunk_trips)
    b = vjp(static, tables, cam, H, W, g, fma=fma, asan=asan,
            chunk_trips=chunk_trips)
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
            "bwd_worst": worst[0], "leaf": worst[1]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="euclider_tpu_torch.tools.kernel_harness",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--scene", default="config3_csg_textured")
    p.add_argument("--size", default="160x90", help="WxH")
    p.add_argument("--fma", action="store_true",
                   help="allow FMA contraction, as nvcc's default does")
    p.add_argument("--asan", action="store_true",
                   help="build with AddressSanitizer (re-runs itself with "
                        "libasan preloaded)")
    p.add_argument("--seams", action="store_true",
                   help="zero the cotangent on image seams too")
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
    print(args.scene, compare(args.scene, H, W, args.fma, args.asan,
                              args.seams, args.chunk_trips))
    return 0


if __name__ == "__main__":
    sys.exit(main())
