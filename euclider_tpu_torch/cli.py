"""Command-line interface of the torch port.

    python -m euclider_tpu_torch --scene config2_mirror_glass \\
        --size 1280x720 --backend cuda --out frame.png --time
    python -m euclider_tpu_torch --scene scenes/config1_sphere_room.json \\
        --backend torch --device cpu --size 64x48 --out small.png
    python -m euclider_tpu_torch --scene config5_warp_portal --animate 48
    python -m euclider_tpu_torch --scene config4_hypersphere --view

Backends: ``cuda`` (the CUDA kernel; needs a CUDA device, and fails rather
than fall back when there is none or the kernel does not build), ``torch``
(the plain batched-torch version, on ``--device cuda``, the default, or
``cpu``), ``oracle`` (the float64 C++ oracle, native/oracle.cpp) and
``numpy`` (the float64 scalar twin, oracle/cpu_oracle.py); the last two
run on the host.  ``--time`` prints the median ms/frame and Mrays/s
(primary rays, H*W per frame), from CUDA events on a CUDA device, and the
RenderMeter's JSON record (utils/profiling.py); ``--profile-dir`` writes a
torch.profiler trace of the timed frames.  ``--animate N`` writes an orbit
of N frames (viewer/simulation.py render_orbit), ``--view`` runs the
interactive terminal viewer (viewer/terminal.py), both with the cuda or
the torch backend.  The flags and backends are those of
``euclider_tpu/cli.py``, with ``cuda`` and ``torch`` in place of ``lax``
and ``pallas``, and ``--cpu`` the same as ``--device cpu``.
"""
from __future__ import annotations

import argparse
import os
import statistics
import struct
import sys
import zlib

import numpy as np
import torch

TIME_FRAMES = 5    # frames timed by --time, after one warm-up frame
BACKENDS = ("cuda", "torch", "oracle", "numpy")
HOST_BACKENDS = ("oracle", "numpy")   # float64 on the host, no tensors


def _parse_size(s: str):
    try:
        w, h = s.lower().split("x")
        return int(h), int(w)
    except ValueError:
        raise SystemExit(f"error: --size wants WxH (e.g. 640x480), got {s!r}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="euclider_tpu_torch",
        description="non-Euclidean ray tracer, PyTorch + CUDA port")
    p.add_argument("--scene", required=True,
                   help="library scene name or path to a scene .json")
    p.add_argument("--size", default="640x480", help="WxH (default 640x480)")
    p.add_argument("--out", default="out.png", help="output PNG path")
    p.add_argument("--backend", default="cuda", choices=BACKENDS)
    p.add_argument("--device", default="cuda", choices=["cpu", "cuda"],
                   help="tensor device of the cuda and torch backends "
                        "(default cuda)")
    p.add_argument("--cpu", action="store_true",
                   help="the same as --device cpu")
    p.add_argument("--depth", type=int, default=None,
                   help="override max bounce depth")
    p.add_argument("--animate", type=int, default=0, metavar="N",
                   help="render N frames (orbiting camera) to out_%%04d.png")
    p.add_argument("--orbit-radius", type=float, default=None,
                   help="accepted as by the reference's CLI; the orbit "
                        "keeps the camera's distance")
    p.add_argument("--time", action="store_true",
                   help="print the median ms/frame and Mrays/s and the "
                        "RenderMeter JSON record (utils/profiling.py)")
    p.add_argument("--time-frames", type=int, default=TIME_FRAMES,
                   help=f"frames timed by --time (default {TIME_FRAMES})")
    p.add_argument("--profile-dir", default=None, metavar="DIR",
                   help="write a torch.profiler trace (Chrome/Perfetto) of "
                        "the timed frames to DIR")
    p.add_argument("--view", action="store_true",
                   help="interactive terminal viewer (ANSI half-blocks; "
                        "wasdqe move, jl/ik/uo look, nm/,. 4D, x quit)")
    p.add_argument("--view-frames", type=int, default=None,
                   help="with --view: stop after N frames (scripted runs)")
    return p


def load_scene(spec: str):
    from .scene import jsonio, library
    if os.path.exists(spec):
        return jsonio.load_scene(spec)
    return library.get_scene(spec)


def save_png(img, path: str) -> None:
    """8-bit RGB PNG of an [H, W, 3] image in [0, 1] (stdlib only)."""
    arr = (np.clip(np.asarray(img), 0.0, 1.0) * 255).astype(np.uint8)
    h, w = arr.shape[:2]

    def chunk(tag, data):
        raw = tag + data
        return (struct.pack(">I", len(data)) + raw
                + struct.pack(">I", zlib.crc32(raw) & 0xFFFFFFFF))

    rows = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(rows, 6)))
        f.write(chunk(b"IEND", b""))


def time_render(render, device: torch.device, frames: int,
                meter=None) -> float:
    """Median ms/frame of ``render()`` over ``frames`` runs (after the
    caller's warm-up), each timed by ``meter.frame()``: CUDA events on a
    CUDA device, the host clock on the CPU.  The runs' times go into
    ``meter`` (by default a new RenderMeter on ``device``)."""
    from .utils.profiling import RenderMeter
    if meter is None:
        meter = RenderMeter(0, 0, device=device)
    n0 = len(meter.times)
    for _ in range(frames):
        with meter.frame():
            render()
    return statistics.median(meter.times[n0:]) * 1e3


def make_render(scene, H: int, W: int, backend: str, device: torch.device):
    """The frame of ``scene`` through ``backend`` as a function of no
    arguments -> an [H, W, 3] tensor on ``device`` (cuda, torch) or a
    float64 numpy array (oracle, numpy)."""
    from .scene.compile import (camera_to_torch, compile_camera,
                                compile_scene, tables_to_torch)
    static, tables = compile_scene(scene)
    cam = compile_camera(scene.camera)
    if backend == "oracle":
        from .oracle.native_oracle import render_native
        return lambda: render_native(static, tables, cam, H, W)
    if backend == "numpy":
        from .oracle.cpu_oracle import render_oracle
        return lambda: render_oracle(static, tables, cam, H, W)
    tables = tables_to_torch(tables, device)
    cam = camera_to_torch(cam, device)
    if backend == "cuda":
        from .ops.cuda_kernel import render_image_cuda as render_fn
    else:
        from .ops.trace import render_image as render_fn
    return lambda: render_fn(static, tables, cam, H, W)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    H, W = _parse_size(args.size)
    device = "cpu" if args.cpu else args.device
    on_host = args.backend in HOST_BACKENDS
    if args.backend == "cuda" and device != "cuda":
        raise SystemExit("error: --backend cuda renders on --device cuda")
    if device == "cuda" and not on_host and not torch.cuda.is_available():
        raise SystemExit("error: no CUDA device: --device cuda and "
                         "--backend cuda need one")
    if on_host and (args.view or args.animate):
        raise SystemExit("error: --view and --animate render with --backend "
                         "cuda or torch")
    try:
        scene = load_scene(args.scene)
    except KeyError as e:
        raise SystemExit(f"error: {e.args[0]}")
    except Exception as e:
        raise SystemExit(f"error: cannot load scene {args.scene!r}: {e}")
    if args.depth is not None:
        from dataclasses import replace
        scene = replace(scene, settings=replace(scene.settings,
                                                max_depth=args.depth))

    if args.view:
        from .viewer.simulation import Simulation
        from .viewer.terminal import run_interactive
        sim = Simulation(scene, H, W, backend=args.backend, device=device)
        n = run_interactive(sim, max_frames=args.view_frames)
        print(f"viewed {n} frames at {sim.fps:.1f} fps "
              f"({W}x{H}, backend={args.backend})")
        return 0

    if args.animate:
        from .viewer.simulation import render_orbit
        paths = render_orbit(scene, H, W, args.animate, args.out,
                             backend=args.backend,
                             radius=args.orbit_radius, device=device)
        print(f"wrote {len(paths)} frames: {paths[0]} .. {paths[-1]}")
        return 0

    dev = torch.device("cpu" if on_host else device)
    render = make_render(scene, H, W, args.backend, dev)
    img = render()   # builds the kernel on first use; also the warm-up
    save_png(img.cpu().numpy() if isinstance(img, torch.Tensor) else img,
             args.out)
    if args.time:
        from .utils.profiling import RenderMeter, profile_trace
        meter = RenderMeter(H, W, device=dev)
        frames = max(args.time_frames, 1)
        with profile_trace(args.profile_dir):
            ms = time_render(render, dev, frames, meter)
        name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu (host clock)")
        print(f"time: {ms:.3f} ms/frame, {H * W / ms / 1e3:.2f} Mrays/s "
              f"({W}x{H}, backend={args.backend}, device={name}, "
              f"median of {frames})")
        meter.log(args.backend)
    print(f"wrote {args.out} ({W}x{H}, backend={args.backend}, "
          f"device={dev.type})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
