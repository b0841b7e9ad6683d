"""Two source trees of the port on one card, in turns: the trace kernels'
device times and their ptxas resource lines.

    python euclider_tpu_torch/tools/ab_trees.py \\
        --tree parent=OLD --tree parent_nofma=OLD:nofma --tree change=. \\
        --order parent,parent_nofma,change,change,parent_nofma,parent

Each ``--tree NAME=PATH[:nofma]`` is a checkout of the repository; ``:nofma``
builds that tree's libraries with ``-fmad=false`` added where its own flags
lack it, so that a tree from before every library was built so can be
compared with one after at equal flags.  The script first builds every
tree's libraries (``--libs``, by default the six trace libraries), one
process a tree, all started together (each tree's
``ops/cuda_kernel.build``: one nvcc a library, in parallel, into the
tree's own ``euclider_tpu_torch/build/``), and prints their ``-Xptxas -v``
lines (none for a library already built) and, per kernel, the count of
local, shared and shuffle instructions in its SASS (``cuobjdump -sass``:
LDL, STL, LDS, STS, SHFL, and the generic LD and ST); then runs one timing
process per entry of ``--order``, in that order.  A process imports the
package of its tree alone (this file imports nothing of the package
itself) and times, at 1280x720, the forward kernel ``trace_fwd`` on
config1, config2, config5 and config6, the tape backward ``trace_bwd`` in
vjp mode under a seeded cotangent on grad_probe, config2, config5 and
config6, and the segmented backward K6 + K7 (``trace_seg_fwd_kernel`` +
``trace_seg_bwd_kernel``, vjp mode) on config2: the mean device time of a
launch over 5 calls after 3 warm-up calls, from torch.profiler.  Beside
each ``trace_bwd`` time it prints the launch configuration of the
instantiation the scene takes (threads a block, dynamic shared memory,
where the gradient vector lives, active blocks per SM from
``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), through the tree's C
entry ``euclider_trace_bwd_config`` (null for a tree without it).  Every
result is one JSON line; the last line holds them all, with the card's
name and power limit.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

H, W = 720, 1280
FWD_SCENES = ("config1_sphere_room", "config2_mirror_glass",
              "config5_warp_portal", "config6_expr_space")
BWD_SCENES = ("grad_probe", "config2_mirror_glass", "config5_warp_portal",
              "config6_expr_space")
SEG_SCENES = ("config2_mirror_glass",)
SEG_KEYS = ("trace_seg_fwd_kernel", "trace_seg_bwd_kernel")
# SASS opcodes counted per kernel: local, shared and generic memory, shuffles
SASS_OPS = ("LDL", "STL", "LDS", "STS", "SHFL", "LD", "ST")
LIBS = ("trace_fwd", "trace_bwd", "trace_seg", "trace_fwd_shapes",
        "trace_bwd_shapes", "trace_seg_shapes")


def _package(path: str, nofma: bool):
    """Import the package of the tree at path; with nofma, its libraries
    are built with -fmad=false added -> cuda_kernel module."""
    sys.path.insert(0, os.path.abspath(path))
    from euclider_tpu_torch.ops import cuda_kernel as CK
    assert os.path.dirname(os.path.dirname(CK.__file__)) == os.path.join(
        os.path.abspath(path), "euclider_tpu_torch"), CK.__file__
    if nofma:
        own = CK._flags
        CK._flags = lambda name: own(name) + (
            () if "-fmad=false" in own(name) else ("-fmad=false",))
    return CK


def _anon(line: str) -> str:
    """A ptxas line without the anonymous namespace's per-file hash."""
    return re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]+", "ANON",
                  line)


def _kernel_name(mangled: str) -> str:
    """kernel<template arguments> from a mangled SASS function name."""
    m = re.search(r"([a-z_]+_kernel)(I(?:L[ib]\d+E)+E)?", mangled)
    if not m:
        return mangled
    args = re.findall(r"L([ib])(\d+)E", m.group(2) or "")
    return m.group(1) + ("<" + ", ".join(
        v if k == "i" else ("true" if v == "1" else "false")
        for k, v in args) + ">" if args else "")


def sass_counts(lib: str) -> dict:
    """{kernel: {opcode: count}} of SASS_OPS in the library's SASS, from
    cuobjdump -sass (static instruction counts; {} without cuobjdump)."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {}
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            cur = out.setdefault(_kernel_name(line.split(":", 1)[1].strip()),
                                 dict.fromkeys(SASS_OPS, 0))
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                     line)
        if cur is not None and m and m.group(1) in cur:
            cur[m.group(1)] += 1
    return out


def build_worker(path: str, nofma: bool, names) -> dict:
    CK = _package(path, nofma)
    libs = CK.build(tuple(names))
    return {"libs": {k: os.path.basename(v) for k, v in libs.items()},
            "ptxas": {k: [_anon(x) for x in v] for k, v in CK.PTXAS.items()},
            "sass": {k: sass_counts(v) for k, v in libs.items()}}


def launch_config(CK, cuda_bwd, static, tables, device):
    """The tape kernel's launch configuration for the scene, from the
    tree's C entry euclider_trace_bwd_config -> dict, or None for a tree
    without it."""
    import ctypes
    name = CK.library("trace_bwd", static)
    fn = getattr(ctypes.CDLL(CK.build((name,))[name]),
                 "euclider_trace_bwd_config", None)
    if fn is None:
        return None
    floats = CK._check_tables(static, tables, device)
    _, _, params, _ = CK.scene_args(static, floats, device,
                                    CK.tex_shapes(tables))
    sizes, _ = cuda_bwd.grad_layout(static, floats)
    out = (ctypes.c_int * 4)()
    fn.argtypes = [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    rc = fn(params, sizes, out)
    if rc != 0:
        raise RuntimeError(f"euclider_trace_bwd_config: cudaError {rc}")
    return {"threads": out[0], "dyn_smem_bytes": out[1],
            "blocks_per_sm": out[2],
            "grad_storage": {1: "shared", 2: "local"}[out[3]]}


def time_worker(path: str, nofma: bool) -> dict:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    CK = _package(path, nofma)
    import euclider_tpu_torch as et
    from euclider_tpu_torch.ops import cuda_bwd

    device = torch.device("cuda", 0)

    def load(name):
        sc = et.get_scene(name)
        static, tables = et.compile_scene(sc)
        return (static, et.tables_to_torch(tables, device),
                et.camera_to_torch(et.compile_camera(sc.camera), device))

    def device_ms(fn, key, n=5, warm=3, tries=3):
        """ms of one launch of the kernel named key, or {k: ms} for a
        tuple of names (None for a kernel no profile recorded)."""
        keys = key if isinstance(key, tuple) else (key,)
        got = dict.fromkeys(keys)
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        for _ in range(tries):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
            for k in keys:
                evts = [e for e in prof.key_averages() if k in e.key]
                us = sum(getattr(e, "device_time_total", 0.0) for e in evts)
                calls = sum(e.count for e in evts)
                if got[k] is None and us > 0 and calls:
                    got[k] = us / calls / 1e3
            if None not in got.values():
                break
        return got if isinstance(key, tuple) else got[key]

    out = {"fwd": {}, "bwd": {}, "bwd_config": {}, "seg": {}}
    for name in FWD_SCENES:
        static, tables, cam = load(name)
        out["fwd"][name] = device_ms(
            lambda: CK.render_image_cuda(static, tables, cam, H, W),
            "trace_fwd_kernel")
    g = torch.from_numpy(np.random.default_rng(3).normal(
        size=(H, W, 3)).astype(np.float32)).to(device)
    for name in BWD_SCENES:
        static, tables, cam = load(name)
        out["bwd"][name] = device_ms(
            lambda: cuda_bwd.vjp_cuda(static, tables, cam, H, W, g),
            "trace_bwd_kernel")
        out["bwd_config"][name] = launch_config(CK, cuda_bwd, static, tables,
                                                device)
    for name in SEG_SCENES:
        static, tables, cam = load(name)
        ms = device_ms(lambda: cuda_bwd.vjp_cuda(
            static, tables, cam, H, W, g, backward="segmented"), SEG_KEYS)
        out["seg"][name] = dict(ms, total=None if None in ms.values()
                                else sum(ms.values()))
    return out


def _worker(mode: str, spec: str, libs: str) -> dict:
    path, _, opt = spec.partition(":")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--worker", mode, "--path", path, "--libs", libs]
                          + (["--nofma"] if opt == "nofma" else []),
                          capture_output=True, text=True, timeout=1800)
    if proc.returncode != 0:
        raise RuntimeError(f"{mode} worker on {spec} failed:\n"
                           f"{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=PATH[:nofma], a checkout of the repository")
    ap.add_argument("--order", default="",
                    help="comma-separated tree names, timed in this order")
    ap.add_argument("--libs", default=",".join(LIBS),
                    help="the libraries to build (comma-separated)")
    ap.add_argument("--worker", choices=("build", "time"))
    ap.add_argument("--path")
    ap.add_argument("--nofma", action="store_true")
    args = ap.parse_args(argv)
    if args.worker == "build":
        out = build_worker(args.path, args.nofma, args.libs.split(","))
    elif args.worker == "time":
        out = time_worker(args.path, args.nofma)
    if args.worker:
        print(json.dumps(out), flush=True)
        return 0
    trees = dict(t.split("=", 1) for t in args.tree)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(trees)) as pool:
        builds = dict(zip(trees, pool.map(
            lambda s: _worker("build", s, args.libs), trees.values())))
    for name, b in builds.items():
        print(json.dumps({"tree": name, "build": b}), flush=True)
    runs = []
    for name in filter(None, args.order.split(",")):
        t = _worker("time", trees[name], args.libs)
        runs.append({"tree": name, **t})
        print(json.dumps(runs[-1]), flush=True)
    print(json.dumps({"card": card, "trees": trees, "builds": builds,
                      "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
