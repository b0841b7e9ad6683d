"""The trainer: recover scene parameters from a target image.

Port of ``examples/inverse_fit.py``, fitting what it fits.  Renders the
target from the scene as it is, moves the first sphere and tints every
surface (``perturb``, the example's perturbation), then takes Adam steps
(learning rate 2e-2) on all of shape_vec and surf_color with the camera and
every other table frozen, and prints the loss of every step and the
sphere-position error before and after.  The example's criterion of
recovery is that error falling below half its start.  At the end it
writes a checkpoint of the parameters (``utils/checkpointing.py``, to
``--checkpoint`` + ".pt"), as the example does, and reads it back.

It runs as one process, or one process a device under torchrun: each rank
renders its rows of the target and takes the sharded steps
(``train/inverse.py`` on ``make_render_mesh()``), its parameters the same
bits as every other rank's; rank 0 prints and writes the checkpoint.

    python -m euclider_tpu_torch.train.fit                       # on the card
    python -m euclider_tpu_torch.train.fit --device cpu --backend torch \\
        --size 32x16 --steps 2
    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        -m euclider_tpu_torch.train.fit --device cpu --backend torch \\
        --size 32x16 --steps 2                                   # gloo
"""
from __future__ import annotations

import argparse
import math
import os
import sys
import tempfile

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
    p.add_argument("--checkpoint",
                   default=os.path.join(tempfile.gettempdir(),
                                        "inverse_fit_ckpt"),
                   help="where the fitted parameters are saved, + '.pt' "
                        "(default: inverse_fit_ckpt in the temporary "
                        "directory, the example's /tmp/inverse_fit_ckpt)")
    return p


def main(argv=None) -> dict:
    """Run the fit; returns {"losses", "error": (before, after),
    "recovered": the example's criterion, "launches": kernel launches
    during the steps, "params": the fitted InverseParams, "checkpoint": the
    file written (rank 0; None elsewhere), "restored": whether it reads
    back to the parameters' bits, "world": the number of ranks}."""
    import torch.distributed as dist

    from ..cli import _parse_size, load_scene
    from ..ops import cuda_bwd, cuda_kernel
    from ..parallel.distributed import initialize, make_render_mesh
    from ..parallel.mesh import render_image_sharded
    from ..scene.compile import (camera_to_torch, compile_camera,
                                 compile_scene, tables_to_torch)
    from ..utils import checkpointing
    from ..utils.tree import leaves
    from .inverse import InverseParams, make_train_step

    args = build_parser().parse_args(argv)
    H, W = _parse_size(args.size)
    if args.backend != "torch" and args.device != "cuda":
        raise SystemExit(f"error: --backend {args.backend} trains on "
                         "--device cuda")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("error: no CUDA device: --device cuda needs one")
    joined = initialize(args.device)
    try:
        mesh = make_render_mesh() if joined else None
        rank = dist.get_rank() if joined else 0
        say = print if rank == 0 else (lambda *a, **k: None)
        dev = (torch.device("cuda", torch.cuda.current_device())
               if args.device == "cuda" else torch.device("cpu"))
        scene = load_scene(args.scene)
        static, tables = compile_scene(scene)
        truth = tables_to_torch(tables, dev)
        cam = camera_to_torch(compile_camera(scene.camera), dev)
        with torch.no_grad():    # this rank's rows of the target
            target = render_image_sharded(
                static, truth, cam, H, W, mesh,
                backend="cuda" if dev.type == "cuda" else "torch")

        params = InverseParams(perturb(truth), cam)
        step, _ = make_train_step(static, H, W, params, args.lr,
                                  args.backend, fit=dict.fromkeys(FIT),
                                  mesh=mesh)

        def sphere_error():
            return float((params.tables.shape_vec[0]
                          - truth.shape_vec[0]).abs().max())

        world = mesh.size if mesh is not None else 1
        say(f"fit {static.name} at {W}x{H}: backend={args.backend}, "
            f"device={args.device}, {world} rank(s), {args.steps} Adam "
            f"steps, lr {args.lr}", flush=True)
        err0 = sphere_error()
        fwd0, bwd0 = cuda_kernel.LAUNCHES, cuda_bwd.LAUNCHES
        seg0 = cuda_bwd.SEG_LAUNCHES
        losses = []
        for i in range(args.steps):
            losses.append(float(step(target)))
            say(f"step {i:4d}  loss {losses[-1]:.6f}", flush=True)
        launches = {"trace_fwd": cuda_kernel.LAUNCHES - fwd0,
                    "trace_bwd": cuda_bwd.LAUNCHES - bwd0,
                    "trace_seg": cuda_bwd.SEG_LAUNCHES - seg0}
        err1 = sphere_error()
        ok = err1 < 0.5 * err0      # the example's criterion of recovery
        say(f"sphere-position error: {err0:.4f} -> {err1:.4f} "
            f"({'recovered' if ok else 'not recovered'}: below half the "
            "start is the example's criterion)")
        say(f"kernel launches during the steps: {launches}")
        path, restored = None, True
        if rank == 0:
            path = checkpointing.save(args.checkpoint, params)
            back = checkpointing.restore(args.checkpoint, params)
            restored = all(torch.equal(a, b) for a, b in
                           zip(leaves(params), leaves(back)))
            say(f"checkpoint saved to {path}; it restores to the "
                f"parameters' bits: {restored}", flush=True)
    finally:
        if joined:
            dist.destroy_process_group()
    return {"losses": losses, "error": (err0, err1), "recovered": ok,
            "launches": launches, "params": params, "checkpoint": path,
            "restored": restored, "world": world}


if __name__ == "__main__":
    out = main()
    sys.exit(0 if out["restored"] and all(math.isfinite(x)
                                          for x in out["losses"]) else 1)
