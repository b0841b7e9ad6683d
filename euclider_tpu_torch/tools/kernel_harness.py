"""The CUDA kernels' device code on the CPU, against the plain versions.

There is no nvcc off the card, but the device code of ``csrc/trace_fwd.cu``
and ``csrc/trace_bwd.cu`` is C++ under a few stand-ins
(``tools/cuda_stub/cuda_runtime.h``).  This module cuts each source at its
``extern "C"`` entry point, appends a host entry that runs the kernel body
pixel by pixel (the forward kernel under looped block and thread indices,
``pixel_backward`` summing every pixel's gradient in float64), and builds
it with g++ into ``euclider_tpu_torch/build/``.  It finds before a chip
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

STUB = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda_stub")
CPU = torch.device("cpu")
BUILDS = (0, 1, 3, 4, 5, 7)   # every kB of trace_common.cuh

_CASES = "".join(f"case {k}: {{call}}<{k}>({{args}}); break; "
                 for k in BUILDS)

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
    "trace_bwd": """
extern "C" int harness_bwd(const int32_t* const* ints,
                           const float* const* floats, const int* params,
                           float t_max, const int* sizes, const float* cam,
                           int H, int W, int rows, const float* gin,
                           double* out, float* gtex) {
    const Scene s = make_scene(ints, floats, params, t_max, cam);
    const int n_shape = sizes[0], n_mat = sizes[1], n_surf = sizes[2],
              n_warp = sizes[3], n_portal = sizes[4], n_expr = sizes[5];
    const int build = scene_build(params);
    Offs off;  // the layout of euclider_trace_bwd
    off.sv = 24;
    off.ssc = off.sv + 4 * n_shape;
    off.ior = off.ssc + n_shape;
    off.col = off.ior + n_mat;
    off.col2 = off.col + 4 * n_surf;
    off.refl = off.col2 + 4 * n_surf;
    off.fres = off.refl + n_surf;
    off.uvs = off.fres + n_surf;
    off.bg = off.uvs + n_surf;
    off.wc = off.bg + 3;
    off.ws = off.wc + 4 * n_warp;
    off.wh = off.ws + n_warp;
    off.plin = off.wh + n_warp;
    off.ptr = off.plin + 16 * n_portal;
    off.ep = off.ptr + 4 * n_portal;
    off.loss = off.ep + 8 * n_expr;
    off.n = off.loss + 1;
    if (off.n > MAX_PARAMS) return -1;
    for (int y = 0; y < rows; ++y)
        for (int x = 0; x < W; ++x) {
            float grad[MAX_PARAMS];
            for (int p = 0; p < off.n; ++p) grad[p] = 0.0f;
            switch (build) { CASES default: return -1; }
            for (int p = 0; p < off.n; ++p) out[p] += grad[p];
        }
    return off.n;
}
""".replace("CASES", _CASES.format(
        call="pixel_backward",
        args="s, off, cam, x, y, H, W, gin, 0.0f, false, grad, gtex")),
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
    """Build both host libraries (one g++ process each, started together)
    unless built already -> {"trace_fwd": path, "trace_bwd": path}."""
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
    bwd = ctypes.CDLL(libs["trace_bwd"]).harness_bwd
    bwd.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_float]
                    + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                    + [ctypes.c_void_p] * 3)
    return fwd, bwd


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
        fma=False, asan=False):
    """pixel_backward in vjp mode on CPU tables under the cotangent g ->
    (d_tables, d_cam, d_time), the pixels' gradients summed in float64."""
    R = H if rows is None else rows
    floats, cam_row, (iptr, fptr, params, _ints) = _scene(static, tables,
                                                          cam, time, y0)
    fields = dict(zip(CK.FLOAT_FIELDS, floats))
    sizes = (ctypes.c_int * 6)(*(
        fields[k].shape[0] if CB._in_grad(static, k) else 0
        for k in ("shape_vec", "mat_ior", "surf_color", "mat_warp_strength",
                  "portal_tr", "mat_expr_params")))
    acc = np.zeros(CB.MAX_PARAMS, np.float64)
    gtex = torch.zeros_like(floats[-1])
    g = g.detach().to(torch.float32).contiguous()
    n = _entries(fma, asan)[1](iptr, fptr, params, static.t_max, sizes,
                               cam_row.data_ptr(), H, W, R, g.data_ptr(),
                               acc.ctypes.data, gtex.data_ptr())
    if n <= 0:
        raise RuntimeError("harness_bwd refused the scene")
    flat = torch.from_numpy(acc[:n].astype(np.float32))
    return CB._grads(static, tables, cam, flat, gtex, floats)[:3]


def compare(sc, H, W, fma=False, asan=False, seams=False) -> dict:
    """Forward and vjp of the harness against the plain versions on the
    scene ``sc`` (an ir.Scene or a library scene's name): {"fwd_max",
    "fwd_bad" (pixels beyond 1e-4), "bwd_worst" (the worst leaf's error
    over 1e-3 * max(max |ref|, 1)), "leaf"}.  The cotangent is seeded,
    zero where the forwards differ beyond 1e-4 and, with ``seams``, on
    image seams (chip_smoke.py's rule)."""
    from ..ops import trace
    from ..ops.vjp import vjp_blocked
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
    a = vjp_blocked(static, tables, cam, H, W, g)
    b = vjp(static, tables, cam, H, W, g, fma=fma, asan=asan)
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
                              args.seams))
    return 0


if __name__ == "__main__":
    sys.exit(main())
