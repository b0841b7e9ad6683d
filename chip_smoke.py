#!/usr/bin/env python3
"""Smoke run of the torch port on one CUDA card: builds the CUDA kernel,
checks it, drives the main path and times it.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):
  1. device  - a CUDA device is required; never falls back to the CPU.
  2. build   - nvcc builds csrc/trace_fwd.cu for sm_90a.
  3. kernel  - render_image_cuda against the plain torch version on the card,
               config1 and config2 at 1280x720: at least 99.9% of pixels
               within 1e-4 (max over channels).
  4. truth   - the kernel against tests/goldens.npz at 48x64 (at most 1% of
               pixels beyond 2e-3) and against the float64 C++ oracle at
               48x128 (at least 99% within 2e-3).
  5. main    - euclider_tpu_torch.render_image at 1280x720 for both scenes
               and the CLI with --backend cuda; the kernel's launch count
               must rise on this path.
  6. time    - ms/frame and Mrays/s from CUDA events around one render call,
               median of 5 after warm-up, kernel and plain; the kernel's
               own device time from torch.profiler.
The second-to-last line is a JSON record of the kernel; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SCENES = ("config1_sphere_room", "config2_mirror_glass")
H, W = 720, 1280
TOL, MAX_BAD = 1e-4, 1e-3            # kernel vs plain on the card
GOLD_TOL, GOLD_BAD = 2e-3, 0.01      # goldens gate (tests/test_goldens.py)
ORACLE_TOL, ORACLE_FRAC = 2e-3, 0.99  # oracle gate (utils/validate.py)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def load(name, device):
    import euclider_tpu_torch as et
    sc = et.get_scene(name)
    static, tables = et.compile_scene(sc)
    return (static, et.tables_to_torch(tables, device),
            et.camera_to_torch(et.compile_camera(sc.camera), device))


def kernel_vs_plain(name, device):
    """Phase 3 for one scene -> (max_abs_err, bad_frac)."""
    import torch
    from euclider_tpu_torch.ops import cuda_kernel, trace

    static, tables, cam = load(name, device)
    got = cuda_kernel.render_image_cuda(static, tables, cam, H, W)
    ref = trace.render_image(static, tables, cam, H, W)
    torch.cuda.synchronize()
    assert got.shape == (H, W, 3) and bool(torch.isfinite(got).all()), name
    err = (got - ref).abs().amax(dim=-1)
    max_err, bad = float(err.max()), float((err > TOL).float().mean())
    say("kernel", f"{name}: max_abs_err={max_err:.3e} "
        f"bad_frac(>{TOL:g})={bad:.6f} (limit {MAX_BAD:g})")
    assert bad <= MAX_BAD, f"{name}: kernel disagrees with the plain version"
    return max_err, bad


def ground_truth(name, device, goldens):
    """Phase 4 for one scene: goldens and C++ oracle gates."""
    import numpy as np
    from euclider_tpu_torch.ops import cuda_kernel
    from euclider_tpu_torch.utils.validate import assert_oracle_match

    static, tables, cam = load(name, device)
    img = cuda_kernel.render_image_cuda(static, tables, cam, 48, 64)
    err = np.abs(img.cpu().numpy() - goldens[name]).max(axis=-1)
    bad = float((err > GOLD_TOL).mean())
    say("truth", f"{name}: goldens 48x64 bad_frac(>{GOLD_TOL:g})={bad:.4f} "
        f"(limit {GOLD_BAD:g}), max_err={err.max():.3e}")
    assert bad <= GOLD_BAD, f"{name}: goldens gate failed"
    frac = assert_oracle_match(static, tables, cam,
                               cuda_kernel.render_image_cuda, h=48, w=128,
                               tol=ORACLE_TOL, min_frac=ORACLE_FRAC,
                               label=name)
    say("truth", f"{name}: oracle 48x128 frac_ok(<{ORACLE_TOL:g})="
        f"{frac:.4f} (limit {ORACLE_FRAC:g})")


def main_path(device):
    """Phase 5 -> launches of the kernel made by the main path."""
    import torch
    import euclider_tpu_torch as et
    from euclider_tpu_torch.ops import cuda_kernel

    scenes = [load(name, device) for name in SCENES]
    cuda_kernel.LAUNCHES = 0
    imgs = [et.render_image(static, tables, cam, H, W)
            for static, tables, cam in scenes]
    torch.cuda.synchronize()
    launches = cuda_kernel.LAUNCHES
    for name, img in zip(SCENES, imgs):
        assert img.shape == (H, W, 3) and img.device.type == "cuda", name
        assert bool(torch.isfinite(img).all()), f"{name}: non-finite pixels"
        say("main", f"{name}: render_image {W}x{H} finite, mean rgb "
            f"{[round(float(c), 4) for c in img.mean(dim=(0, 1))]}")
    say("main", f"kernel launches on the main path: {launches}")
    assert launches >= len(SCENES), "the main path did not run the kernel"

    png = os.path.join(ROOT, "euclider_tpu_torch", "build", "smoke_cli.png")
    if os.path.exists(png):
        os.remove(png)
    cmd = [sys.executable, "-m", "euclider_tpu_torch", "--scene", SCENES[1],
           "--size", f"{W}x{H}", "--backend", "cuda", "--out", png]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, f"CLI failed:\n{proc.stdout}{proc.stderr}"
    with open(png, "rb") as f:
        head = f.read(24)
    assert head[:8] == b"\x89PNG\r\n\x1a\n", "CLI wrote no PNG"
    size = (int.from_bytes(head[16:20], "big"), int.from_bytes(head[20:24], "big"))
    assert size == (W, H), f"CLI PNG is {size}"
    say("main", f"CLI --backend cuda wrote {os.path.relpath(png, ROOT)} "
        f"({size[0]}x{size[1]})")
    return launches


def kernel_device_ms(render, n=5):
    """Device time of one trace_fwd launch, from torch.profiler (None when
    the profiler records no device time for it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            render()
        torch.cuda.synchronize()
    evts = [e for e in prof.key_averages() if "trace_fwd_kernel" in e.key]
    us = sum(getattr(e, "device_time_total", 0.0) for e in evts)
    calls = sum(e.count for e in evts)
    return us / calls / 1e3 if us > 0 and calls == n else None


def timing(name, device, card):
    """Phase 6 for one scene -> (kernel ms/frame, plain ms/frame, kernel
    device ms).  A frame is one render call, timed by CUDA events around it,
    so its time includes the wrapper's own launches and host work."""
    from euclider_tpu_torch.cli import time_render
    from euclider_tpu_torch.ops import cuda_kernel, trace

    static, tables, cam = load(name, device)
    out = {}
    for label, fn, warm in (("kernel", cuda_kernel.render_image_cuda, 3),
                            ("plain", trace.render_image, 1)):
        def render():
            return fn(static, tables, cam, H, W)
        for _ in range(warm):
            render()
        out[label] = time_render(render, device, 5)
        say("time", f"{name} {label}: {out[label]:.3f} ms/frame, "
            f"{H * W / out[label] / 1e3:.2f} Mrays/s at {W}x{H} "
            f"(median of 5; {card})")
    dev_ms = kernel_device_ms(
        lambda: cuda_kernel.render_image_cuda(static, tables, cam, H, W))
    say("time", f"{name} trace_fwd_kernel device time: "
        + ("not measured (no profiler device time)" if dev_ms is None else
           f"{dev_ms:.4f} ms/launch (torch.profiler, mean of 5; {card})"))
    return out["kernel"], out["plain"], dev_ms


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np
    from euclider_tpu_torch.ops import cuda_kernel

    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say("device", f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}"
        f", CUDA {torch.version.cuda}; {torch.cuda.device_count()} device(s)")
    print(card, flush=True)

    t0 = time.perf_counter()
    lib = cuda_kernel.build()
    say("build", f"{os.path.relpath(lib, ROOT)} in "
        f"{time.perf_counter() - t0:.2f} s")

    errs = {name: kernel_vs_plain(name, device) for name in SCENES}
    goldens = np.load(os.path.join(ROOT, "tests", "goldens.npz"))
    for name in SCENES:
        ground_truth(name, device, goldens)
    launches = main_path(device)
    times = {name: timing(name, device, card) for name in SCENES}

    per_scene = {name: {"ms": times[name][0], "plain_ms": times[name][1],
                        "kernel_device_ms": times[name][2],
                        "max_abs_err": errs[name][0],
                        "bad_frac": errs[name][1]} for name in SCENES}
    print(json.dumps({"kernels": [{
        "name": "trace_fwd", "route": "cuda",
        "source": "euclider_tpu_torch/csrc/trace_fwd.cu",
        "replaces": "euclider_tpu/ops/pallas_kernel.py:127",
        "launches": launches,
        "max_abs_err": max(e[0] for e in errs.values()),
        "ms": times[SCENES[0]][0], "plain_ms": times[SCENES[0]][1],
        "ms_scene": SCENES[0], "shape": [H, W, 3],
        "tolerance": {"atol": TOL, "max_bad_frac": MAX_BAD},
        "card": card, "scenes": per_scene}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
