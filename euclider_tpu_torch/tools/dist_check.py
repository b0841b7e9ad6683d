"""One launch of the multi-device path, each rank's results to an .npz for
the caller to compare.

Run under torchrun, one process a device: gloo ranks on the CPU, NCCL on
the cards.  Each case compiles its scene, spoils the tables and camera on
every rank but 0 and ``replicate``s them, renders its slab
(``render_image_sharded``), assembles the frame (``gather_frame``,
``host_gather_image``), takes the loss (``make_loss_fn``) and its value and
gradients (``make_fused_value_and_grad``) against its rows of a seeded
target (``shard_target``), three Adam steps (``make_train_step``) and a
checkpoint round trip; ``--hybrid`` lays the ranks out (host, chip) and
sums over both axes instead.  Rank r writes ``OUT/rank{r}.npz``, keys
``case/what``.

    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        -m euclider_tpu_torch.tools.dist_check --device cpu --out /tmp/dc
    python -m torch.distributed.run --standalone --nproc_per_node 1 \\
        -m euclider_tpu_torch.tools.dist_check --device cuda \\
        --size 1280x720 --out /tmp/dc                     # on the card
"""
from __future__ import annotations

import argparse
import os
from dataclasses import replace

import numpy as np
import torch

FIT = ("shape_vec", "surf_color")
STEPS = 3
LR = 2e-2


def animated_scene():
    """tests/test_parallel.py::test_animated_scene_sharded_train's scene:
    an expression region whose field moves with the time, before smooth
    surfaces."""
    from ..scene.ir import (Camera, Entity, ExprSpace, HalfSpace,
                            RenderSettings, Scene, SmoothSurface, Sphere,
                            UniformSurface)
    wobble = ExprSpace(ax="p0 * sin(3.0 * t + z)", ay="0", az="0", aw="0",
                       step=0.15, params=(0.8,))
    return Scene(
        dim=3, name="animated_probe",
        entities=(
            Entity(Sphere((0.0, 0.0, -4.0), 1.4), material=wobble,
                   surface=UniformSurface((0.0, 0.0, 0.0, 0.0)),
                   name="wobble_region"),
            Entity(Sphere((0.0, 0.0, -7.0), 1.0),
                   surface=SmoothSurface(uv_scale=2.0), name="backdrop"),
            Entity(HalfSpace((0.0, -1.0, 0.0), 1.2),
                   surface=SmoothSurface(uv_scale=0.5), name="floor")),
        camera=Camera(position=(0.0, 0.3, 1.0, 0.0),
                      forward=(0.0, -0.1, -0.99, 0.0),
                      up=(0.0, 1.0, 0.0, 0.0), right=(1.0, 0.0, 0.0, 0.0),
                      fov_deg=60.0),
        settings=RenderSettings(max_depth=3, march_steps=32,
                                background=(0.05, 0.05, 0.08)))


def _cut(name, **settings):
    from ..scene.library import get_scene
    sc = get_scene(name)
    return replace(sc, settings=replace(sc.settings, **settings))


# case -> (scene, (H, W), target seed); grad_probe is
# tests/test_torch_train.py's problem (depth 1, tinted, target seed 11) and
# config5 tests/test_parallel.py's cut (depth 2, 23 march steps)
CASES = {
    "config1": (lambda: _cut("config1_sphere_room"), (16, 32), 3),
    "config2": (lambda: _cut("config2_mirror_glass"), (16, 32), 3),
    "config5": (lambda: _cut("config5_warp_portal", max_depth=2,
                             march_steps=23), (16, 32), 3),
    "grad_probe": (lambda: _cut("grad_probe", max_depth=1), (16, 24), 11),
    "animated": (animated_scene, (16, 32), 3),
}
TINT = np.asarray([0.1, -0.05, 0.08, 0.0], np.float32)   # grad_probe's


def named(params) -> dict:
    """The tensor leaves of InverseParams by name."""
    out = {k: v for k, v in params.tables._asdict().items()
           if k != "textures"}
    out.update({f"textures{i}": t
                for i, t in enumerate(params.tables.textures)})
    out.update({f"cam.{k}": v for k, v in params.cam._asdict().items()})
    return out


def problem(case, device, size=None):
    """(static, InverseParams on device, target [H, W, 3] float32 numpy,
    H, W) of a case, as rank 0 builds them."""
    from ..scene.compile import (camera_to_torch, compile_camera,
                                 compile_scene, tables_to_torch)
    from ..train.inverse import InverseParams
    build, (H, W), seed = CASES[case]
    if size is not None:
        H, W = size
    sc = build()
    static, tables = compile_scene(sc)
    if case == "grad_probe":
        tables = tables._replace(surf_color=tables.surf_color + TINT)
    target = np.random.default_rng(seed).uniform(size=(H, W, 3)).astype(
        np.float32)
    return (static, InverseParams(tables_to_torch(tables, device),
                                  camera_to_torch(compile_camera(sc.camera),
                                                  device)), target, H, W)


def run_case(case, device, mesh, rank, out_dir, size=None) -> dict:
    from ..parallel.distributed import host_gather_image, replicate
    from ..parallel.mesh import gather_frame, render_image_sharded
    from ..train.inverse import (make_fused_value_and_grad, make_loss_fn,
                                 make_train_step, shard_target)
    from ..utils import checkpointing
    from ..utils.tree import leaves, unflatten

    static, fresh, target, H, W = problem(case, device, size)
    cuda = device.type == "cuda"
    params = unflatten(fresh, [t.clone() for t in leaves(fresh)])
    if rank:                 # spoil; replicate must bring back rank 0's
        for t in leaves(params):
            t.add_(float(rank))
    replicate(params)
    rec = {"replicated": all(torch.equal(a, b) for a, b in
                             zip(leaves(params), leaves(fresh)))}
    tables, cam = params
    with torch.no_grad():
        slab = render_image_sharded(static, tables, cam, H, W, mesh,
                                    backend="cuda" if cuda else "torch")
        rec["slab"] = slab
        rec["frame"] = gather_frame(slab, mesh)
        rec["host_frame"] = host_gather_image(slab, mesh)
    try:
        render_image_sharded(static, tables, cam, H + 1, W, mesh)
        rec["uneven_raised"] = mesh.size == 1
    except ValueError as e:
        rec["uneven_raised"] = "not divisible" in str(e)
    tgt = shard_target(torch.from_numpy(target).to(device), mesh)
    loss_fn = make_loss_fn(static, H, W, "cuda" if cuda else "torch", mesh)
    rec["loss_fn"] = loss_fn(params, tgt).detach()
    for backend in (("cuda-fused", "cuda") if cuda else ("torch",)):
        loss, g = make_fused_value_and_grad(static, H, W, backend,
                                            mesh)(params, tgt)
        rec[f"{backend}/loss"] = loss
        rec.update({f"{backend}/grad/{k}": v for k, v in named(g).items()})
    if case == "animated":
        rec["loss_t0"] = loss_fn(params, tgt, 0.0).detach()
        rec["loss_t09"] = loss_fn(params, tgt, 0.9).detach()
        tm = torch.tensor(0.4, device=device, requires_grad=True)
        rec["time_grad"] = torch.autograd.grad(loss_fn(params, tgt, tm),
                                               tm)[0]
    step, _ = make_train_step(static, H, W, params, LR,
                              "cuda-fused" if cuda else "torch",
                              fit=dict.fromkeys(FIT), mesh=mesh)
    rec["steps/loss"] = torch.stack([step(tgt) for _ in range(STEPS)])
    rec.update({f"steps/{k}": v for k, v in named(params).items()})
    path = os.path.join(out_dir, f"ckpt_{case}_rank{rank}")
    checkpointing.save(path, params)
    back = checkpointing.restore(path, params)
    rec["checkpoint_bits"] = all(torch.equal(a, b) for a, b in
                                 zip(leaves(params), leaves(back)))
    return rec


def run_hybrid() -> dict:
    import torch.distributed as dist

    from ..parallel.distributed import (hybrid_layout, make_hybrid_mesh,
                                        make_render_mesh)
    render = make_render_mesh()
    hybrid = make_hybrid_mesh()
    host = int(np.flatnonzero((hybrid.devices == dist.get_rank())
                              .any(axis=1))[0])
    x = torch.tensor([float(host + 1)])
    (s,) = hybrid.sum(hybrid.sum([x], "chip"), "host")
    try:
        hybrid_layout(["a", "a", "a", "b"])
        uneven = False
    except RuntimeError:
        uneven = True
    return {"render_devices": render.devices, "hybrid_devices":
            hybrid.devices, "sum": s, "uneven_raised": uneven}


def main(argv=None) -> int:
    import torch.distributed as dist

    from ..cli import _parse_size
    from ..parallel.distributed import (initialize, make_render_mesh,
                                        process_info)
    p = argparse.ArgumentParser(prog="euclider_tpu_torch.tools.dist_check",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--out", required=True, help="directory of the .npz")
    p.add_argument("--size", default=None,
                   help="WxH for every case (default: each case's own)")
    p.add_argument("--hybrid", action="store_true",
                   help="the (host, chip) layout and its sums instead")
    args = p.parse_args(argv)
    if not initialize(args.device):
        raise SystemExit("error: run under torch.distributed.run")
    try:
        rank, world = process_info()
        device = (torch.device("cuda", torch.cuda.current_device())
                  if args.device == "cuda" else torch.device("cpu"))
        os.makedirs(args.out, exist_ok=True)
        if args.hybrid:
            rec = run_hybrid()
        else:
            mesh = make_render_mesh()
            size = _parse_size(args.size) if args.size else None
            rec = {f"{case}/{k}": v
                   for case in CASES
                   for k, v in run_case(case, device, mesh, rank, args.out,
                                        size).items()}
            rec["mesh_devices"] = mesh.devices
        rec["world"] = world
        np.savez(os.path.join(args.out, f"rank{rank}.npz"),
                 **{k: v.detach().cpu().numpy()
                    if isinstance(v, torch.Tensor) else np.asarray(v)
                    for k, v in rec.items()})
        print(f"dist_check rank {rank}/{world}: {len(rec)} results to "
              f"{args.out}", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
