"""Two source trees of the port on one card, in turns: the trace kernels'
device times and their ptxas resource lines.

    python euclider_tpu_torch/tools/ab_trees.py \\
        --tree parent=OLD --tree parent_nofma=OLD:nofma --tree change=. \\
        --order parent,parent_nofma,change,change,parent_nofma,parent

Each ``--tree NAME=PATH[:nofma]`` is a checkout of the repository; ``:nofma``
builds that tree's libraries with ``-fmad=false`` added where its own flags
lack it, so that a tree from before every library was built so can be
compared with one after at equal flags.  The script first builds every
tree's libraries (``--libs``, by default every library: the six trace
libraries and the three probes'), one process a tree, all started
together (each tree's
``ops/cuda_kernel.build``: one nvcc a library, in parallel, into the
tree's own ``euclider_tpu_torch/build/``), and prints their ``-Xptxas -v``
lines (none for a library already built) and, per kernel, the count of
local, shared and shuffle instructions in its SASS (``cuobjdump -sass``:
LDL, STL, LDS, STS, SHFL, and the generic LD and ST); then runs one timing
process per entry of ``--order``, in that order.  A process imports the
package of its tree alone (this file imports nothing of the package
itself) and times, at 1280x720, the groups that ``--only`` names (all by
default):

- ``fwd``: the forward kernel ``trace_fwd`` on FWD_SCENES;
- ``bwd``: the tape backward ``trace_bwd`` in vjp mode under a seeded
  cotangent on BWD_SCENES, each beside the launch configuration of the
  instantiation the scene takes (threads a block, dynamic shared memory,
  where the gradient vector lives, active blocks per SM from
  ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), through the tree's C
  entry ``euclider_trace_bwd_config`` (null for a tree without it);
- ``seg``: the segmented backward in vjp mode on SEG_SCENES (config5
  forced onto it, so that K6's and K7's marching builds are timed), K6
  (``trace_seg_fwd_kernel``), K7 (``trace_seg_bwd_kernel``) and the
  partials' sum each timed apart, each call after a frame of the forward
  kernel, whose time (``trace_fwd_kernel``) the same profiles give;
- ``probe``: the march-bisect probe P1 (``probe_march_kernel``), every
  stage on its crossing tile and (``<stage>_lane``) on the tile's longest
  lane alone (``longest_lane``), and the tree's empty kernel of one warp
  (``march_probe.empty_cuda``, where the tree has one); the Mosaic probes
  P2-P5 (``probe_mosaic.cu``) on ``chip_smoke.py`` phase 9's tiles (P3 on
  both branches, ``cond`` and ``cond_dead``, on the first 1000 elements
  and on one element alone, ``cond_lane``; P5 live, dead and
  ``gated_lane``: one lane alone, every lane walking the same steps) and P6 (``probe_rev.cu``) on its tile and
  (``rev_lane``) on the lane that walks the most steps (``rev_steps``);
  P2 and P4 also on the tile's first 1000 elements (``ckpt_1000``,
  ``nested_1000``) and on one element alone (``ckpt_lane``,
  ``nested_lane``: every lane walks the same steps); beside each Mosaic probe's time, a
  hash of its outputs' bits (``probe_bits``, one ``bits`` line a call at
  the end), so that trees can be held to the same bits;

each the mean device time of a launch over ``--calls`` calls (5 by
default) after 3 warm-up calls, from torch.profiler; and

- ``e2e``: the calls of E2E_CELLS as a user makes them, host work
  included (a frame of ``render_image_cuda``, one fused training step
  ``make_fused_value_and_grad(..., "cuda-fused")``, one segmented vjp
  call), the median of 20 calls after 3 warm-up calls by CUDA events,
  each call synchronised; beside it (``e2e_host``) the median host time
  from the start event's record to the call's return, which is the host
  work that the events count where the card waits on it;
- ``host``: the host steps of one ``render_image_cuda`` call on
  HOST_SCENES, each timed alone (the float tables' checks, the camera
  row, the scene arguments, the C entry that launches the kernel, and
  the whole call), the median of 300 calls after 30, each after a
  synchronise, on the host's clock.

Every result is one JSON line.  Then one line a
kernel and scene holds its times in the order of the runs (``time``
lines: K6 and K7 on lines of their own, so that either can be read
alone), and the last line holds everything, with the card's name and
power limit.  Needs a CUDA card.
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
              "config3_csg_textured", "config5_warp_portal",
              "config6_expr_space", "config7_warp4d", "config2_deep")
BWD_SCENES = ("grad_probe", "config2_mirror_glass", "config5_warp_portal",
              "config6_expr_space")
# config2 at max_depth 8 and max_nodes 255 (chip_smoke.py's config2_deep)
SEG_SCENES = ("config2_mirror_glass", "config2_deep", "config5_warp_portal")
SEG_KEYS = ("trace_seg_fwd_kernel", "trace_seg_bwd_kernel",
            "sum_partials_kernel")
# (call, scene) timed end to end: "frame", "step" (fused) or "seg" (vjp)
E2E_CELLS = (("frame", "config2_mirror_glass"),
             ("frame", "config5_warp_portal"), ("step", "grad_probe"),
             ("step", "config6_expr_space"), ("seg", "config2_mirror_glass"))
HOST_SCENES = ("config1_sphere_room", "config2_mirror_glass",
               "config5_warp_portal")
GROUPS = ("fwd", "bwd", "seg", "probe", "e2e", "host")
# SASS opcodes counted per kernel: local, shared and generic memory, shuffles
SASS_OPS = ("LDL", "STL", "LDS", "STS", "SHFL", "LD", "ST")
LIBS = ("trace_fwd", "trace_bwd", "trace_seg", "trace_fwd_shapes",
        "trace_bwd_shapes", "trace_seg_shapes", "probe_march", "probe_mosaic",
        "probe_rev")


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
    """{kernel: {opcode: count, "digest": hash}} of SASS_OPS in the
    library's SASS, from cuobjdump -sass (static instruction counts; {}
    without cuobjdump); the digest hashes the kernel's instructions without
    their addresses and encodings, so two builds of one kernel with equal
    digests run the same code."""
    import hashlib
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {}
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True).stdout
    out, hashes, cur = {}, {}, None
    for line in text.splitlines():
        if "Function :" in line:
            cur = _kernel_name(line.split(":", 1)[1].strip())
            out.setdefault(cur, dict.fromkeys(SASS_OPS, 0))
            hashes[cur] = hashlib.sha256()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+((?:@!?U?P\w+\s+)?"
                     r"([A-Z0-9_]+)[^;]*;)", line)
        if cur is not None and m:
            hashes[cur].update(m.group(1).encode())
            if m.group(2) in out[cur]:
                out[cur][m.group(2)] += 1
    for k, h in hashes.items():
        out[k]["digest"] = h.hexdigest()[:12]
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


def longest_lane(MP, static, tables, org, d) -> int:
    """The lane of the tile whose march walks the most steps, among the
    lanes that cross if any does (those also bisect and run the reverse
    sweep), from the kernel's fwd stage."""
    import torch
    got = MP.march_probe_cuda(static, tables, org, d, "fwd")
    steps = got.steps.reshape(-1).to(torch.int64)
    crossed = got.ent.reshape(-1) >= 0
    return int(torch.argmax(steps + crossed.to(torch.int64) * (1 << 20)))


def seeded(shape, seed, device):
    """chip_smoke.py's seeded normal tile."""
    import numpy as np
    import torch
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=shape).astype(np.float32)).to(device)


def rev_steps(P, x, w):
    """The steps each element of P6's march walks (P.R_STEPS of size
    P.R_H, done once x' > 1), from the plain forward -> int tensor shaped
    like x."""
    import torch
    xx, v = x * 0.3, x * 0.2 + 0.1
    done = torch.zeros_like(x, dtype=torch.bool)
    steps = torch.zeros_like(x, dtype=torch.int64)
    for _ in range(P.R_STEPS):
        steps += (~done).to(torch.int64)
        v1 = v + P.R_H * (0.3 * torch.sin(w * xx))
        x1 = xx + P.R_H * v1
        xx, v = torch.where(done, xx, x1), torch.where(done, v, v1)
        done = done | (x1 > 1.0)
    return steps


def probe_calls(P, device) -> dict:
    """{name: (kernel, call)} of the Mosaic probes P2-P6 through the
    tree's probes module P, on chip_smoke.py phase 9's tiles."""
    x0, g0 = seeded((8, 128), 0, device), seeded((8, 128), 1, device)
    x2, g2 = seeded((8, 128), 2, device) + 1.0, seeded((8, 128), 3, device)
    xd = x2 - 2.0        # P3's dead branch: chip_smoke.py's shift of -1
    x3, g3 = seeded((8, 128), 3, device) * 0.3, seeded((8, 128), 4, device)
    x5, g5 = seeded((8, 128), 5, device) * 0.3, seeded((8, 128), 6, device)
    xr, gr = seeded((8, 128), 7, device) * 0.8, seeded((8, 128), 8, device)
    lane = int(rev_steps(P, xr, 1.1).reshape(-1).argmax())
    x1, g1 = (t.reshape(-1)[lane:lane + 1] for t in (xr, gr))
    return {
        "ckpt": ("probe_ckpt_kernel",
                 lambda: P.ckpt_scratch_cuda(x0, 0.7, g0)),
        "ckpt_1000": ("probe_ckpt_kernel", lambda: P.ckpt_scratch_cuda(
            x0.reshape(-1)[:1000], 0.7, g0.reshape(-1)[:1000])),
        "ckpt_lane": ("probe_ckpt_kernel", lambda: P.ckpt_scratch_cuda(
            x0.reshape(-1)[:1], 0.7, g0.reshape(-1)[:1])),
        "cond": ("probe_cond_kernel", lambda: P.cond_cuda(x2, g2)),
        "cond_dead": ("probe_cond_kernel", lambda: P.cond_cuda(xd, g2)),
        "cond_1000": ("probe_cond_kernel", lambda: P.cond_cuda(
            x2.reshape(-1)[:1000], g2.reshape(-1)[:1000])),
        "cond_lane": ("probe_cond_kernel", lambda: P.cond_cuda(
            x2.reshape(-1)[:1], g2.reshape(-1)[:1])),
        "nested": ("probe_nested_kernel",
                   lambda: P.nested_march_cuda(x3, 0.9, g3)),
        "nested_1000": ("probe_nested_kernel", lambda: P.nested_march_cuda(
            x3.reshape(-1)[:1000], 0.9, g3.reshape(-1)[:1000])),
        "nested_lane": ("probe_nested_kernel", lambda: P.nested_march_cuda(
            x3.reshape(-1)[:1], 0.9, g3.reshape(-1)[:1])),
        "gated": ("probe_gated_kernel",
                  lambda: P.gated_march_cuda(x5, 0.8, g5)),
        "gated_dead": ("probe_gated_kernel",
                       lambda: P.gated_march_cuda(x5, 0.8, g5, 0 * x5)),
        "gated_lane": ("probe_gated_kernel", lambda: P.gated_march_cuda(
            x5.reshape(-1)[:1], 0.8, g5.reshape(-1)[:1])),
        "rev": ("probe_rev_kernel", lambda: P.rev_march_cuda(xr, 1.1, gr)),
        "rev_lane": ("probe_rev_kernel",
                     lambda: P.rev_march_cuda(x1, 1.1, g1))}


def bits(tensors) -> list:
    """A hash of each tensor's bytes, so that two trees' outputs can be
    compared to the bit across processes."""
    import hashlib
    return [hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes())
            .hexdigest()[:12] for t in tensors]


def _scene(et, name):
    """A library scene, or config2_deep: config2 at max_depth 8 and
    max_nodes 255, past the tape kernel's 63 nodes."""
    if name == "config2_deep":
        from dataclasses import replace
        sc = et.get_scene("config2_mirror_glass")
        return replace(sc, name=name, settings=replace(
            sc.settings, max_depth=8, max_nodes=255))
    return et.get_scene(name)


def time_worker(path: str, nofma: bool, groups=GROUPS, calls=5) -> dict:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    CK = _package(path, nofma)
    import euclider_tpu_torch as et
    from euclider_tpu_torch.ops import cuda_bwd

    device = torch.device("cuda", 0)

    def load(name):
        sc = _scene(et, name)
        static, tables = et.compile_scene(sc)
        return (static, et.tables_to_torch(tables, device),
                et.camera_to_torch(et.compile_camera(sc.camera), device))

    def device_ms(fn, key, n=calls, warm=3, tries=3):
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

    def events_ms(fn, n=20, warm=3):
        """Median ms of one call of fn by CUDA events, host work included,
        and the median host ms from the start event's record to fn's
        return."""
        import statistics
        import time
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        ms, host = [], []
        for _ in range(n):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            fn()
            host.append((time.perf_counter() - t0) * 1e3)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
        return statistics.median(ms), statistics.median(host)

    def host_ms(fn, n=300, warm=30):
        """Median host ms of one call of fn, each after a synchronise."""
        import statistics
        import time
        ms = []
        for i in range(warm + n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            if i >= warm:
                ms.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ms)

    out = {"fwd": {}, "bwd": {}, "bwd_config": {}, "seg": {}, "probe": {},
           "probe_bits": {}, "e2e": {}, "e2e_host": {}, "host": {}}
    for name in FWD_SCENES if "fwd" in groups else ():
        static, tables, cam = load(name)
        out["fwd"][name] = device_ms(
            lambda: CK.render_image_cuda(static, tables, cam, H, W),
            "trace_fwd_kernel")
    g = torch.from_numpy(np.random.default_rng(3).normal(
        size=(H, W, 3)).astype(np.float32)).to(device)
    for name in BWD_SCENES if "bwd" in groups else ():
        static, tables, cam = load(name)
        out["bwd"][name] = device_ms(
            lambda: cuda_bwd.vjp_cuda(static, tables, cam, H, W, g),
            "trace_bwd_kernel")
        out["bwd_config"][name] = launch_config(CK, cuda_bwd, static, tables,
                                                device)
    for name in SEG_SCENES if "seg" in groups else ():
        static, tables, cam = load(name)

        def frame_and_seg():
            CK.render_image_cuda(static, tables, cam, H, W)
            cuda_bwd.vjp_cuda(static, tables, cam, H, W, g,
                              backward="segmented")

        ms = device_ms(frame_and_seg, SEG_KEYS + ("trace_fwd_kernel",))
        seg = [ms[k] for k in SEG_KEYS]
        out["seg"][name] = dict(ms, total=None if None in seg else sum(seg))
    if "probe" in groups:
        from euclider_tpu_torch.ops import march_probe as MP
        static, tables = MP.probe_scene(device)
        org, d = MP.crossing_tile(device)
        lane = longest_lane(MP, static, tables, org, d)
        for stage in MP.STAGES:
            out["probe"][stage] = device_ms(
                lambda: MP.march_probe_cuda(static, tables, org, d, stage),
                "probe_march_kernel")
            o1, d1 = (t.reshape(-1, 4)[lane:lane + 1] for t in (org, d))
            out["probe"][f"{stage}_lane"] = device_ms(
                lambda: MP.march_probe_cuda(static, tables, o1, d1, stage),
                "probe_march_kernel")
        empty = getattr(MP, "empty_cuda", None)   # None in older trees
        if empty is not None:
            out["probe"]["empty"] = device_ms(lambda: empty(device),
                                              "probe_empty_kernel")
        from euclider_tpu_torch.ops import probes as P
        for name, (key, fn) in probe_calls(P, device).items():
            out["probe"][name] = device_ms(fn, key)
            out["probe_bits"][name] = bits(fn())
    if "e2e" in groups:
        from euclider_tpu_torch.train.inverse import (
            InverseParams, make_fused_value_and_grad)
        target = torch.from_numpy(np.random.default_rng(2).uniform(
            size=(H, W, 3)).astype(np.float32)).to(device)
    for call, name in E2E_CELLS if "e2e" in groups else ():
        static, tables, cam = load(name)
        if call == "frame":
            fn = lambda: CK.render_image_cuda(static, tables, cam, H, W)
        elif call == "step":
            vg = make_fused_value_and_grad(static, H, W, "cuda-fused")
            params = InverseParams(tables, cam)
            fn = lambda: vg(params, target)
        else:
            fn = lambda: cuda_bwd.vjp_cuda(static, tables, cam, H, W, g,
                                           backward="segmented")
        out["e2e"][f"{call}:{name}"], out["e2e_host"][f"{call}:{name}"] = \
            events_ms(fn)
    for name in HOST_SCENES if "host" in groups else ():
        static, tables, cam = load(name)
        floats = CK._check_tables(static, tables, device)
        cam_row = CK._pack_camera(cam, 0.0, 0, device)
        args = CK.scene_args(static, floats, device, CK.tex_shapes(tables))
        frame = torch.empty((H, W, 3), dtype=torch.float32, device=device)
        entry = CK._entry(CK.library("trace_fwd", static))
        stream = torch.cuda.current_stream(device).cuda_stream
        out["host"][name] = {k: host_ms(fn) for k, fn in (
            ("check_tables", lambda: CK._check_tables(static, tables,
                                                      device)),
            ("pack_camera", lambda: CK._pack_camera(cam, 0.0, 0, device)),
            ("scene_args", lambda: CK.scene_args(static, floats, device,
                                                 CK.tex_shapes(tables))),
            ("c_entry", lambda: entry(*args[:3], static.t_max,
                                      cam_row.data_ptr(), H, W, H,
                                      frame.data_ptr(), device.index,
                                      stream)),
            ("render", lambda: CK.render_image_cuda(static, tables, cam, H,
                                                    W)))}
    return out


def time_lines(runs) -> list:
    """One line a kernel and scene: its times (ms a launch) in the order
    of the runs, tagged with each run's tree."""
    keys = []
    for r in runs:
        for group in ("fwd", "bwd", "probe", "e2e", "e2e_host"):
            keys += [(group, k, None) for k in r.get(group, {})]
        for group in ("seg", "host"):
            for name, ms in r.get(group, {}).items():
                keys += [(group, name, k) for k in ms]
    lines = []
    for key in dict.fromkeys(keys):
        group, name, kernel = key
        ts = [(r["tree"], r.get(group, {}).get(name)) for r in runs]
        if kernel is not None:
            ts = [(t, (v or {}).get(kernel)) for t, v in ts]
        lines.append(" ".join(
            [group, name] + ([kernel] if kernel else [])
            + [f"{t}={'-' if v is None else f'{v:.4f}'}" for t, v in ts]))
    return lines


def _worker(mode: str, spec: str, libs: str, only: str = "",
            calls: int = 5) -> dict:
    path, _, opt = spec.partition(":")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--worker", mode, "--path", path, "--libs", libs,
                           "--calls", str(calls)]
                          + (["--only", only] if only else [])
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
    ap.add_argument("--only", default="",
                    help="comma-separated groups to time, of "
                         f"{', '.join(GROUPS)} (default: all)")
    ap.add_argument("--calls", type=int, default=5,
                    help="calls a kernel's device time is averaged over")
    ap.add_argument("--worker", choices=("build", "time"))
    ap.add_argument("--path")
    ap.add_argument("--nofma", action="store_true")
    args = ap.parse_args(argv)
    groups = tuple(filter(None, args.only.split(","))) or GROUPS
    if set(groups) - set(GROUPS):
        ap.error(f"--only takes groups of {GROUPS}, got {args.only}")
    if args.worker == "build":
        out = build_worker(args.path, args.nofma, args.libs.split(","))
    elif args.worker == "time":
        out = time_worker(args.path, args.nofma, groups, args.calls)
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
        t = _worker("time", trees[name], args.libs, args.only, args.calls)
        runs.append({"tree": name, **t})
        print(json.dumps(runs[-1]), flush=True)
    for line in time_lines(runs):
        print("time", line, flush=True)
    for name in dict.fromkeys(k for r in runs for k in r["probe_bits"]):
        print("bits", name, " ".join(
            f"{r['tree']}={','.join(r['probe_bits'].get(name, ['-']))}"
            for r in runs), flush=True)
    print(json.dumps({"card": card, "trees": trees, "builds": builds,
                      "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
