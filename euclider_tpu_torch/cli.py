"""Command-line interface of the torch port.

    python -m euclider_tpu_torch --scene config2_mirror_glass \\
        --size 1280x720 --backend cuda --out frame.png --time
    python -m euclider_tpu_torch --scene scenes/config1_sphere_room.json \\
        --backend torch --device cpu --size 64x48 --out small.png

Backends: ``cuda`` (the CUDA kernel; needs a CUDA device, and fails rather
than fall back when there is none or the kernel does not build) and
``torch`` (the plain batched-torch version, on ``--device cuda``, the
default, or ``cpu``).  ``--time`` prints the median ms/frame and Mrays/s (primary rays,
H*W per frame), from CUDA events on a CUDA device.
"""
from __future__ import annotations

import argparse
import os
import statistics
import struct
import sys
import time as _time
import zlib

import numpy as np
import torch

TIME_FRAMES = 5    # frames timed by --time, after one warm-up frame


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
    p.add_argument("--backend", default="cuda", choices=["cuda", "torch"])
    p.add_argument("--device", default="cuda", choices=["cpu", "cuda"],
                   help="tensor device (default cuda, for both backends)")
    p.add_argument("--time", action="store_true",
                   help=f"print the median ms/frame and Mrays/s over "
                        f"{TIME_FRAMES} frames")
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


def time_render(render, device: torch.device, frames: int) -> float:
    """Median ms/frame of ``render()`` over ``frames`` runs (after the
    caller's warm-up): CUDA events on a CUDA device, the host clock on the
    CPU."""
    ms = []
    for _ in range(frames):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            render()
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
        else:
            t0 = _time.perf_counter()
            render()
            ms.append((_time.perf_counter() - t0) * 1e3)
    return statistics.median(ms)


def main(argv=None) -> int:
    from .ops import trace
    from .scene.compile import (camera_to_torch, compile_camera,
                                compile_scene, tables_to_torch)

    args = build_parser().parse_args(argv)
    H, W = _parse_size(args.size)
    device = args.device
    if args.backend == "cuda" and device != "cuda":
        raise SystemExit("error: --backend cuda renders on --device cuda")
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("error: no CUDA device: --device cuda and "
                         "--backend cuda need one")
    try:
        scene = load_scene(args.scene)
    except KeyError as e:
        raise SystemExit(f"error: {e.args[0]}")
    except Exception as e:
        raise SystemExit(f"error: cannot load scene {args.scene!r}: {e}")

    static, tables = compile_scene(scene)
    dev = torch.device(device)
    tables = tables_to_torch(tables, dev)
    cam = camera_to_torch(compile_camera(scene.camera), dev)
    if args.backend == "cuda":
        from .ops.cuda_kernel import render_image_cuda as render_fn
    else:
        render_fn = trace.render_image

    def render():
        return render_fn(static, tables, cam, H, W)

    img = render()   # builds the kernel on first use; also the warm-up
    save_png(img.cpu().numpy(), args.out)
    if args.time:
        ms = time_render(render, dev, TIME_FRAMES)
        name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu (host clock)")
        print(f"time: {ms:.3f} ms/frame, {H * W / ms / 1e3:.2f} Mrays/s "
              f"({W}x{H}, backend={args.backend}, device={name}, "
              f"median of {TIME_FRAMES})")
    print(f"wrote {args.out} ({W}x{H}, backend={args.backend}, "
          f"device={device})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
