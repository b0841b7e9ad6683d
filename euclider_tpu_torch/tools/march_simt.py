"""The march's SIMT efficiency in the forward kernel, from the plain
version's per-pixel counts of live march steps.

    python -m euclider_tpu_torch.tools.march_simt \\
        [--scene config5_warp_portal ...] [--size 1280x720]

The forward kernel (``csrc/trace_fwd.cu``) runs one thread a pixel, and a
pixel's ray tree one node a trip of its DFS loop: the lanes of a warp
shade their trip-t nodes together, and a marching node repeats its step
until its ray crosses a boundary, so the warp's march in trip t takes as
many steps as its longest lane.  This tool drives the plain version
(``ops/trace.py::render_image``, whose ``ops/march.py`` step runs on every
pixel at once) on the CPU, counts each pixel's live steps in each trip
(``steps_by_trip``), and works out, for a warp that holds a tile of
tx x ty pixels, the share of the warp's lanes that step (``efficiency``):

    sum of the steps over the frame / (32 sum over warps and trips of the
    warp's most steps in that trip)

for the kernel's warp shape (32 x 1: a block of 32 x 8 threads) and 2-D
tiles (8 x 4, 4 x 8, 16 x 2).  It also gives the same share over whole
trees (the pixels' step totals against each warp's largest total), which
would hold if lanes marched at different trips in step.  What it leaves
out: everything but the march's steps (the straight nodes, the bisection,
shading), and that lanes of a warp may shade a marching and a straight
node in one trip.  Prints one JSON line a scene.  CPU only, no card.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

TILES = ((32, 1), (8, 4), (4, 8), (16, 2))
SCENES = ("config5_warp_portal", "config7_warp4d", "config6_expr_space")


def steps_by_trip(static, tables, cam, H: int, W: int) -> np.ndarray:
    """Live march steps of each pixel in each march of the plain render,
    one march a trip (``ops/trace.py::propagate`` marches once a shaded
    node) -> int32 [trips that march, H, W]."""
    from ..ops import march as M
    from ..ops import trace
    make_body = M.make_march_body
    counts = []

    def counting(*args):
        body = make_body(*args)
        live = torch.zeros((H, W), dtype=torch.int32)
        counts.append(live)

        def step(carry):
            live.add_((~carry[2]).to(torch.int32).reshape(H, W).cpu())
            return body(carry)

        return step

    M.make_march_body = counting
    try:
        with torch.no_grad():
            trace.render_image(static, tables, cam, H, W)
    finally:
        M.make_march_body = make_body
    if not counts:
        return np.zeros((0, H, W), np.int32)
    return torch.stack(counts).numpy()


def _warp_max(counts: np.ndarray, tx: int, ty: int) -> np.ndarray:
    """Each warp's largest count in each trip: counts [T, H, W], H a
    multiple of ty and W of tx -> [T, H / ty, W / tx]."""
    T, H, W = counts.shape
    return counts.reshape(T, H // ty, ty, W // tx, tx).max(axis=(2, 4))


def efficiency(counts: np.ndarray, tile=(32, 1)) -> float:
    """The share of a warp's lanes that step while the warp marches, for
    warps of tile = (tx, ty) pixels (tx ty = 32): counts [T, H, W] live
    steps of each pixel in each trip (a 2-D array is one trip); frames
    whose sides are not multiples of the tile are padded with idle pixels,
    as the kernel's edge warps are.  1.0 for a frame that does not march."""
    tx, ty = tile
    if tx * ty != 32:
        raise ValueError(f"a warp holds 32 lanes, not {tx} x {ty}")
    c = np.asarray(counts, dtype=np.int64)
    if c.ndim == 2:
        c = c[None]
    T, H, W = c.shape
    c = np.pad(c, ((0, 0), (0, -H % ty), (0, -W % tx)))
    total = int(c.sum())
    if total == 0:
        return 1.0
    return total / (32 * int(_warp_max(c, tx, ty).sum()))


def report(name: str, H: int, W: int, device: str = "cpu") -> dict:
    """The scene's step counts and efficiencies, by trip and by tree."""
    import euclider_tpu_torch as et
    sc = et.get_scene(name)
    static, t = et.compile_scene(sc)
    dev = torch.device(device)
    counts = steps_by_trip(static, et.tables_to_torch(t, dev),
                           et.camera_to_torch(et.compile_camera(sc.camera),
                                              dev), H, W)
    per_pixel = counts.sum(axis=0)
    return {"scene": name, "size": f"{W}x{H}", "trips": int(counts.shape[0]),
            "steps_per_pixel": float(per_pixel.mean()),
            "max_steps": int(per_pixel.max(initial=0)),
            "marching_pixels": float((per_pixel > 0).mean()),
            "by_trip": {f"{tx}x{ty}": efficiency(counts, (tx, ty))
                        for tx, ty in TILES},
            "by_tree": {f"{tx}x{ty}": efficiency(per_pixel, (tx, ty))
                        for tx, ty in TILES}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="euclider_tpu_torch.tools.march_simt",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", action="append", default=None,
                    help=f"a library scene (repeatable; default {SCENES})")
    ap.add_argument("--size", default="1280x720", help="WxH")
    args = ap.parse_args(argv)
    W, H = (int(v) for v in args.size.lower().split("x"))
    for name in args.scene or SCENES:
        print(json.dumps(report(name, H, W)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
