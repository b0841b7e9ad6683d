"""The trainer: recover scene parameters from a target image.

Port of ``examples/inverse_fit.py``, fitting what it fits.  Renders the
target from the scene as it is, moves the first sphere and tints every
surface (``perturb``, the example's perturbation), then takes Adam steps
(learning rate 2e-2) on all of shape_vec and surf_color with the camera and
every other table frozen, and prints the loss of every step and the
sphere-position error before and after.  The example's criterion of
recovery is that error falling below half its start.

    python -m euclider_tpu_torch.train.fit                       # on the card
    python -m euclider_tpu_torch.train.fit --device cpu --backend torch \\
        --size 32x16 --steps 2
"""
from __future__ import annotations

import argparse
import math
import sys

import torch

FIT = ("shape_vec", "surf_color")   # the tables the example optimises


def perturb(tables):
    """The example's perturbation: the first sphere moves by (+0.35, 0,
    -0.3) and every surface colour gains +0.15 on r, g and b."""
    sv = tables.shape_vec.clone()
    sv[0, 0] += 0.35
    sv[0, 2] -= 0.3
    col = tables.surf_color.clone()
    col[:, :3] += 0.15
    return tables._replace(shape_vec=sv, surf_color=col)


def build_parser() -> argparse.ArgumentParser:
    from .inverse import BACKENDS

    p = argparse.ArgumentParser(
        prog="euclider_tpu_torch.train.fit",
        description="inverse rendering: fit a perturbed scene to its render")
    p.add_argument("--scene", default="grad_probe",
                   help="library scene name or path to a scene .json")
    p.add_argument("--size", default="1280x720", help="WxH (default 1280x720)")
    p.add_argument("--steps", type=int, default=120)
    p.add_argument("--lr", type=float, default=2e-2)
    p.add_argument("--backend", default="cuda-fused", choices=BACKENDS)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


def main(argv=None) -> dict:
    """Run the fit; returns {"losses", "error": (before, after),
    "recovered": the example's criterion, "launches": kernel launches
    during the steps}."""
    from ..cli import _parse_size, load_scene
    from ..ops import cuda_bwd, cuda_kernel
    from ..ops.trace import render_image
    from ..scene.compile import (camera_to_torch, compile_camera,
                                 compile_scene, tables_to_torch)
    from .inverse import InverseParams, make_train_step

    args = build_parser().parse_args(argv)
    H, W = _parse_size(args.size)
    if args.backend != "torch" and args.device != "cuda":
        raise SystemExit(f"error: --backend {args.backend} trains on "
                         "--device cuda")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("error: no CUDA device: --device cuda needs one")
    dev = torch.device(args.device)
    scene = load_scene(args.scene)
    static, tables = compile_scene(scene)
    truth = tables_to_torch(tables, dev)
    cam = camera_to_torch(compile_camera(scene.camera), dev)
    with torch.no_grad():
        if dev.type == "cuda":
            target = cuda_kernel.render_image_cuda(static, truth, cam, H, W)
        else:
            target = render_image(static, truth, cam, H, W)

    params = InverseParams(perturb(truth), cam)
    step, _ = make_train_step(static, H, W, params, args.lr, args.backend,
                              fit=dict.fromkeys(FIT))

    def sphere_error():
        return float((params.tables.shape_vec[0]
                      - truth.shape_vec[0]).abs().max())

    print(f"fit {static.name} at {W}x{H}: backend={args.backend}, "
          f"device={args.device}, {args.steps} Adam steps, lr {args.lr}",
          flush=True)
    err0 = sphere_error()
    fwd0, bwd0 = cuda_kernel.LAUNCHES, cuda_bwd.LAUNCHES
    seg0 = cuda_bwd.SEG_LAUNCHES
    losses = []
    for i in range(args.steps):
        losses.append(float(step(target)))
        print(f"step {i:4d}  loss {losses[-1]:.6f}", flush=True)
    launches = {"trace_fwd": cuda_kernel.LAUNCHES - fwd0,
                "trace_bwd": cuda_bwd.LAUNCHES - bwd0,
                "trace_seg": cuda_bwd.SEG_LAUNCHES - seg0}
    err1 = sphere_error()
    ok = err1 < 0.5 * err0      # the example's criterion of recovery
    print(f"sphere-position error: {err0:.4f} -> {err1:.4f} "
          f"({'recovered' if ok else 'not recovered'}: below half the "
          "start is the example's criterion)")
    print(f"kernel launches during the steps: {launches}")
    return {"losses": losses, "error": (err0, err1), "recovered": ok,
            "launches": launches}


if __name__ == "__main__":
    out = main()
    sys.exit(0 if all(math.isfinite(x) for x in out["losses"]) else 1)
