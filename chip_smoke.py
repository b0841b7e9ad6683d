#!/usr/bin/env python3
"""Smoke run of the torch port on one CUDA card: builds the CUDA kernels,
checks them against their plain versions, drives the render and training
paths and times them.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):
  1. device  - a CUDA device is required; never falls back to the CPU.
  2. build   - nvcc builds csrc/trace_fwd.cu, csrc/trace_bwd.cu,
               csrc/trace_seg.cu, csrc/probe_rev.cu, csrc/probe_mosaic.cu and
               csrc/probe_march.cu for sm_90a with -fmad=false, one process
               each, started together.
  3. kernel  - render_image_cuda against the plain torch version on the card
               at 1280x720, config1, config2, grad_probe, fresnel_probe,
               config5, config7, config6 (expression space), config3 (CSG
               and a texture), perlin_probe, the cylinder scene of
               tests/test_cylinder.py and config4 (4D): at least 99.9% of
               pixels within 1e-4 (max over channels).
  4. truth   - the kernel against tests/goldens.npz at 48x64 (at most 1% of
               pixels beyond 2e-3) and against the float64 C++ oracle at
               48x128 (at least 99% within 2e-3), same scenes (the cylinder
               scene has no golden: the oracle only).
  5. main    - the render path: euclider_tpu_torch.render_image at 1280x720
               for config1, config2, config5, config6 and config3 and the
               CLI with --backend cuda on config2, config5, config6 and
               config3; the forward kernel's launch count must rise on this
               path.
  6. bwd     - grad_probe, config2, config3 (every texel of its texture
               too, whose gradient must be nonzero), perlin_probe, the
               cylinder scene with smooth surfaces (its cylinders' rows of
               shape_vec must get a nonzero gradient) and config4 (4D) at
               1280x720, and a 64-row slab of the 1280x720 frame across the
               warp or expression region (its rays must march:
               march_count) of the warp gradient scene, of config5, of
               config5 with smooth surfaces, of the expression gradient
               scene (at scene time 0.3; its mat_expr_params' and time's
               gradients must be nonzero), of config6, of config7 (4D) and
               of config7 with smooth surfaces (its warp parameters'
               gradients must be nonzero): vjp_cuda against the plain
               row-blocked backward under a seeded cotangent, every leaf
               (and the time) within 1e-3 * max(max |ref|, 1); then
               train_step_cuda against the forward kernel + MSE + vjp_cuda
               (loss within 1e-5 relative, gradients by the same rule).
  7. train   - the training path: python -m euclider_tpu_torch.train.fit on
               grad_probe at 1280x720, the example's 120 fused steps (finite
               losses, the sphere-position error below half its start,
               trace_bwd launched once a step and trace_fwd not at all),
               then 2 steps with --backend cuda (both kernels launch), then
               5 fused steps on config5, config6 and config3 (finite,
               falling losses), and one config6 step through the unfused cuda
               backend against the fused one (loss within 1e-5 relative,
               gradients by phase 6's rule).
  8. time    - ms/frame of the render, ms/step of the fused and unfused
               training steps (CUDA events, median of 5 after warm-up), the
               kernels' device time from torch.profiler, and the plain
               versions' times; beside trace_bwd's, its launch
               configuration (threads a block, dynamic shared memory,
               active blocks an SM, where the gradient vector lives:
               cuda_bwd.launch_config).
  9. probe   - probe_rev (csrc/probe_rev.cu, a thread-block cluster)
               against rev_march_plain on one (8, 128) tile and on its
               first 1000 elements: dx and dw within 1e-5 relative, two
               launches the same bits; its times.
               The probes' path: every stage of the march-bisect probe P1
               (csrc/probe_march.cu, ops/march_probe.py) on the tool's and
               the crossing tile, and the Mosaic probes P2-P5
               (csrc/probe_mosaic.cu, ops/probes.py) on the mosaic tool's
               tiles (P3 in both branches, also on 1000 elements; P5
               also dead, and live and dead on 1000 elements), through the
               dispatchers: P1 (a thread-block cluster) every lane whose
               march agrees within
               1e-5 * max(max |ref|, 1) of the plain version, at most 1% of
               lanes marching otherwise, vjp (K4's rebuild) against finish
               (a stored tape) within 1e-5 relative, the crossing tile
               crossing on 25-75% of lanes with sum(d shape_vec) != 0,
               the tile's sum the same bits in two launches and on every
               lane, in march_probe.tile_sum's fixed order; P2-P5
               within 1e-5 relative (P3 1e-6), each the same bits in two
               launches (P3, one block, in both branches); then the entry
               points python
               -m euclider_tpu_torch.tools.mosaic_probe and .march_bisect
               STAGE (every stage) as subprocesses: exit 0 and a launch of
               every kernel they cover; the probes' times and bounds,
               P1's-P6's beside their tile's longest lane run alone, P1's
               and P3's beside an empty kernel's.
 10. seg     - the segmented backward (K6, K7 in csrc/trace_seg.cu) and the
               lifted caps at 1280x720: config2 (the straight builds),
               config5 and config5 with smooth surfaces (the builds that
               march) through backward='segmented' against the tape
               kernel in both modes (every leaf within 1e-5 * max(max
               |ref|, 1), the fused loss within 1e-5 relative), config2
               against its plain version vjp_segmented (phase 6's rule);
               config2_deep (config2 at
               max_depth 8, max_nodes 255) rendered by the forward kernel,
               differentiated through backward='auto' on a 64-row slab
               against vjp_blocked (phase 6's rule), and 5 fused training
               steps through train/inverse.py with the loss falling;
               spheres48 (config2 and 44 small spheres: 48 entities, 797
               parameters) rendered and differentiated on a 64-row
               slab, as phases 3 and 6 hold theirs; the segmented kernels'
               device times on config2, config2_deep and config5 forced
               onto backward='segmented' (K6's and K7's march builds), K6
               beside trace_fwd's time on the same scene.
 11. viewer  - the viewer slice at 1280x720 on config1 and config5: a
               scripted Simulation.run (--backend cuda) of 20 frames with
               keys and mouse moves, trace_fwd launched once a frame and
               nothing synchronising the device on the way, the flushed
               last frame render_image_cuda's at the final camera to the
               bit, frames before and after a move different; its steady
               ms a frame and fps beside one render_image_cuda and one
               synchronous render + .cpu(); render_orbit of 4 frames; the
               CLI as subprocesses: --animate 3, --view --view-frames 3
               (stdin not a tty), --time --profile-dir (the trace holds a
               trace_fwd launch), --backend numpy and --backend oracle at
               a small size, each exit 0.
 12. dist    - multi-device rendering and training (parallel/,
               train/inverse.py's mesh) at world size 1 over NCCL (one
               card; NCCL takes no two ranks on one device), 1280x720:
               render_image_sharded, gather_frame and host_gather_image on
               config1, config2, config5 and config6 render_image_cuda's
               bits; the sharded cuda-fused value and grad on grad_probe
               and config5 train_step_cuda's bits, the sharded cuda one
               render_image_diff + autograd's; trace_fwd and trace_bwd
               launched on this path; the sharding tax (the sharded render
               + gather and fused step beside the unsharded ones on config1
               and grad_probe, CUDA events, median of 5, two turns each).
               Then under python -m torch.distributed.run --standalone
               --nproc_per_node 1, together: the trainer on grad_probe (the
               example's 120 fused steps, its criterion of recovery,
               trace_bwd once a step, a checkpoint that restores to the
               bits of the same fit in this process) and
               tools/dist_check.py on its five cases at 1280x720 (the frame
               and the fused value and grad this process's unsharded bits,
               replicate, three Adam steps, a checkpoint round trip).
 13. limits  - the scenes past the kernels' old fixed limits
               (tools/limit_scenes.py): config2_d24 and config2_d24_deep
               (a stack of more than 16 slots; the tape and the segmented
               backward), csg48 (48 shape nodes in one entity),
               config6_long (328 VM instructions), config5_crowd (45
               marching entities) and config5_fine (marches of more than
               512 steps), each in the build of the capacities it needs,
               built at first use in a thread from phase 2 on.  The plain
               side of each scene runs in a process of its own
               (--limit-reference), in two batches of processes started
               together: its frame, its slab's count past the old limit,
               its slab's vjp_blocked.  Then for each, in this process:
               the 1280x720 frame through euclider_tpu_torch.render_image
               (K1) by phase 3's rule; the 64-row slab's gradients through
               the kernels route() picks, by phase 6's rule, and the fused
               step against the unfused one; trace_fwd and the backward
               kernel launched on this path; one fused training step of
               config5_fine at 1280x720 (trace_bwd once); config5_fine
               with smooth surfaces at 1024 and 2048 march steps on a
               16-row slab by phase 6's rule, its warp parameters'
               gradients nonzero (the march backward's drift from its
               checkpoints); each build's ptxas lines, each kernel's
               device time and bound.  config3_strips (textures of 2 x
               40,961 and 40,961 x 2 texels, past the 16,384 a side the
               kernels once took) in the default builds: its frame the
               plain version's to the bit (max_abs_err 0), the slab's
               textured hits past the old side counted.
 14. dtype   - float64 inputs, cast to float32 as the Pallas kernels cast
               them, at 1280x720 on grad_probe and config3 (textures):
               float64 tables and camera through
               euclider_tpu_torch.render_image (K1) the float32 run's
               frame to the bit, a float64 camera with float32 tables the
               float32 camera's; vjp_cuda, train_step_cuda (float64 time)
               and autograd through render_image_diff (float64 leaves)
               give float64 gradients with the float32 run's bits, the
               texels' (summed by atomicAdd) by phase 6's rule, the loss
               float32 and the same; trace_fwd and trace_bwd launched on
               this path; the cast's host cost: a frame and a fused step
               of grad_probe, float32 beside float64 (CUDA events, median
               of 5, two turns), and the wrapper's table check and camera
               row alone (host clock, median of 200).
The second-to-last line is a JSON record of the kernels; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SCENES = ("config1_sphere_room", "config2_mirror_glass")
PROBES = ("grad_probe", "fresnel_probe")
WARP = ("config5_warp_portal", "config7_warp4d")
EXPR = ("config6_expr_space",)
# CSG, cylinders, perlin and textures (the kernels' BUILD_SHAPES), and 4D
SHAPES = ("config3_csg_textured", "perlin_probe", "cylinder_test",
          "config4_hypersphere")
BWD_SCENES = ("grad_probe", "config2_mirror_glass", "config3_csg_textured",
              "perlin_probe", "cylinder_smooth", "config4_hypersphere")
# timed training steps
TRAIN_SCENES = BWD_SCENES[:2] + WARP[:1] + EXPR + SHAPES[:2]
# marching scenes of phase 6: a 64-row slab [y0, y0 + 64) across the warp
# or expression region (the plain backward keeps every march step of every
# pixel; each slab must march), and the scene time it is taken at; config7
# is 4D (rows 212-467 march, most around 300)
SLAB_SCENES = {"warp_gradient_scene": (328, 0.0),
               "config5_warp_portal": (300, 0.0),
               "config5_smooth": (300, 0.0),
               "expr_gradient_scene": (328, 0.3),
               "config6_expr_space": (300, 0.0),
               "config7_warp4d": (300, 0.0),
               "config7_smooth": (300, 0.0)}
# slabs whose warp parameters must get a nonzero gradient
WARP_GRAD_SCENES = ("config7_smooth",)
# scenes of SLAB_SCENES with smooth surfaces, and the library scene of each
SMOOTH = {"config5_smooth": "config5_warp_portal",
          "config7_smooth": "config7_warp4d"}
SLAB_ROWS = 64
# phase 10: scenes past the tape's 63 nodes, and past 32 entities and 159
# gradient entries, with the slab of each that phase 10 differentiates
DEEP_SLABS = {"config2_deep": 328, "spheres48": 328}
# phase 13: the scenes past the kernels' old fixed limits
# (tools/limit_scenes.py), and the first row of the 64-row slab of each that
# it differentiates: across the glass sphere's chains of internal
# reflections, the arch, the expression region, the ring and the warp region
LIMIT_SLABS = dict.fromkeys(("config2_d24", "config2_d24_deep", "csg48",
                             "config6_long", "config5_crowd",
                             "config5_fine", "config3_strips"), 300)
# config5_fine with smooth surfaces (on its own the warp's gradient is
# zero almost everywhere) at other march lengths, on 16 rows from row 300:
# the march backward's drift from its checkpoints
DRIFT = {"config5_fine_smooth_1024": 1024, "config5_fine_smooth_2048": 2048}
DRIFT_ROWS = 16
LIMIT_REFERENCE = "--limit-reference"   # a reference process of phase 13
# the reference processes in two batches, each under about 45 GiB of the
# card at its peak (config5_fine's plain backward alone takes 24 GiB), the
# longest (config5_fine, the 2048 steps' slab, config2_d24_deep) spread
LIMIT_BATCHES = (("config5_fine", "config5_fine_smooth_2048", "config2_d24",
                  "csg48", "config6_long"),
                 ("config2_d24_deep", "config5_crowd",
                  "config5_fine_smooth_1024", "config3_strips"))
# phase 14: float64 inputs, and the scene whose cast is timed
DTYPE_SCENES = ("grad_probe", "config3_csg_textured")
SEG_RTOL = 1e-5                      # segmented against the tape kernel
H, W = 720, 1280
TOL, MAX_BAD = 1e-4, 1e-3            # kernel vs plain on the card
GOLD_TOL, GOLD_BAD = 2e-3, 0.01      # goldens gate (tests/test_goldens.py)
ORACLE_TOL, ORACLE_FRAC = 2e-3, 0.99  # oracle gate (utils/validate.py)
GRAD_RTOL = 1e-3                     # tests/test_gradients.py rule
LOSS_RTOL = 1e-5
SMOOTH_TAU = 0.02                    # image second difference of a seam
TRAIN_STEPS = 5
EXAMPLE_STEPS = 120                  # examples/inverse_fit.py
PROBE_RTOL = 1e-5

# H100 SXM published peaks (NVIDIA H100 datasheet): FP32 outside the
# tensor cores and HBM bandwidth, at the full 700 W power limit
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def ptxas(*libs):
    """ptxas's resource lines of the libraries built in this run, one
    entry an entry function: {lib: {"kernel<template arguments>":
    "registers, stack frame B (spill stores B, spill loads B)"}}."""
    import re
    from euclider_tpu_torch.ops import cuda_kernel
    out = {}
    for lib in libs:
        funcs, name, frame = {}, None, ""
        for line in cuda_kernel.PTXAS.get(lib, []):
            m = re.search(r"([a-z_]+_kernel)(I\w*?EEv)?", line)
            if "entry function" in line and m:
                args = re.findall(r"Li(\d+)E", m.group(2) or "")
                name = m.group(1) + (f"<{', '.join(args)}>" if args else "")
            elif "stack frame" in line:
                frame = line
            elif "Used" in line and name:
                regs = re.search(r"Used (\d+) registers", line)
                st = re.findall(r"(\d+) bytes", frame)
                funcs[name] = (f"{regs.group(1) if regs else '?'} registers, "
                               f"{st[0] if st else '?'} B stack (spill "
                               f"stores {st[1] if len(st) > 1 else '?'} B, "
                               f"loads {st[2] if len(st) > 2 else '?'} B)")
                name = None
        out[lib] = funcs
    return out


def build_scene(name):
    """A library scene, or one of phase 6's marching gradient scenes:
    tests/test_gradients.py::test_grad_warp_strength's warp sphere before a
    smooth wall, tests/test_expr_space.py::_tiny_expr_scene with the
    time-dependent field p0 sin(p1 z + t), and config5 and config7 (4D)
    with smooth surfaces on the marker, the backdrop and the floor (on
    uniform and checker surfaces the warp's, the expression's and the
    portal's gradients are zero almost everywhere)."""
    from dataclasses import replace
    import euclider_tpu_torch as et
    from euclider_tpu_torch.scene import ir
    if name == "warp_gradient_scene":
        region = ir.Entity(ir.Sphere((0, 0, -4), 1.8),
                           material=ir.WarpSpace(center=(0, 0, -4),
                                                 strength=0.4, step=0.05),
                           surface=ir.UniformSurface((0, 0, 0, 0.0)))
        wall = ir.Entity(ir.Hyperplane((0, 0, 1), -8.0),
                         surface=ir.SmoothSurface(uv_scale=0.5))
        return ir.Scene(dim=3, entities=(region, wall),
                        settings=ir.RenderSettings(
                            max_depth=3, march_steps=200,
                            background=(0.1, 0.1, 0.2)))
    if name == "expr_gradient_scene":
        region = ir.Entity(ir.Sphere((0, 0, -4), 1.8),
                           material=ir.ExprSpace(ax="p0 * sin(p1 * z + t)",
                                                 ay="0", step=0.06,
                                                 params=(0.5, 2.0)),
                           surface=ir.UniformSurface((0, 0, 0, 0.0)))
        wall = ir.Entity(ir.Hyperplane((0, 0, 1), -8.0),
                         surface=ir.SmoothSurface(uv_scale=0.5))
        return ir.Scene(dim=3, entities=(region, wall),
                        settings=ir.RenderSettings(
                            max_depth=3, march_steps=96,
                            background=(0.1, 0.1, 0.2)))
    if name in ("cylinder_test", "cylinder_smooth"):
        # tests/test_cylinder.py::_cyl_scene (a pillar, a sphere bored out
        # by a cylinder, a floor); cylinder_smooth puts smooth surfaces on
        # all three (on checker and uniform ones the geometry's gradient is
        # zero, as in JAX)
        smooth = name == "cylinder_smooth"
        pillar = ir.Entity(
            ir.Cylinder((1.2, 0.0, -5.0), (0.0, 1.0, 0.0), 0.5),
            surface=ir.SmoothSurface(uv_scale=3.0) if smooth
            else ir.CheckerSurface(uv_scale=3.0), name="pillar")
        bored = ir.Csg("difference", (
            ir.Sphere((-1.2, 0.0, -4.5), 1.0),
            ir.Cylinder((-1.2, 0.0, -4.5), (0.0, 0.0, 1.0), 0.45)))
        ring = ir.Entity(bored, surface=ir.SmoothSurface(
            uv_scale=2.0, reflectivity=0.1) if smooth else ir.UniformSurface(
                (0.8, 0.5, 0.2, 1.0), reflectivity=0.1), name="ring")
        floor = ir.Entity(ir.HalfSpace((0.0, -1.0, 0.0), 1.2),
                          surface=ir.SmoothSurface(uv_scale=0.8) if smooth
                          else ir.CheckerSurface(uv_scale=0.8), name="floor")
        return ir.Scene(
            dim=3, name=name, entities=(pillar, ring, floor),
            camera=ir.Camera(position=(0.0, 0.4, 1.0),
                             forward=(0.0, -0.12, -1.0)),
            settings=ir.RenderSettings(max_depth=3,
                                       background=(0.05, 0.06, 0.1)))
    if name == "config2_deep":
        # config2 with a tree of up to 255 nodes: past the tape kernel's 63
        sc = et.get_scene("config2_mirror_glass")
        return replace(sc, name=name, settings=replace(
            sc.settings, max_depth=8, max_nodes=255))
    if name == "spheres48":
        # config2's floor and three spheres and 44 small spheres on the
        # floor behind them, each with its own uniform surface (every other
        # one reflective): 48 entities, 797 parameters
        sc = et.get_scene("config2_mirror_glass")
        balls = tuple(ir.Entity(
            ir.Sphere((-3.0 + 0.6 * (i % 11), -0.82, -6.5 - 0.9 * (i // 11)),
                      0.18),
            surface=ir.UniformSurface(
                (0.2 + 0.15 * (i % 5), 0.3 + 0.25 * (i % 3),
                 0.9 - 0.1 * (i % 7), 1.0),
                reflectivity=0.3 if i % 2 else 0.0),
            name=f"ball{i}") for i in range(44))
        return replace(sc, name=name, entities=sc.entities + balls)
    if name in DRIFT:
        # config5_fine with smooth surfaces at another march length
        sc = build_scene("config5_fine")
        return replace(sc, name=name, entities=tuple(
            replace(e, surface=ir.SmoothSurface(uv_scale=0.8))
            if e.name in ("portal_marker", "backdrop_sphere", "floor")
            else e for e in sc.entities), settings=replace(
                sc.settings, march_steps=DRIFT[name]))
    from euclider_tpu_torch.tools import limit_scenes
    if name in limit_scenes.BUILDERS:
        return limit_scenes.get_scene(name)
    if name in SMOOTH:
        sc = et.get_scene(SMOOTH[name])
        return replace(sc, entities=tuple(
            replace(e, surface=ir.SmoothSurface(uv_scale=0.8))
            if e.name in ("portal_marker", "backdrop_sphere", "floor",
                          "portal_marker4d", "backdrop_hypersphere")
            else e for e in sc.entities))
    return et.get_scene(name)


def load(name, device):
    import euclider_tpu_torch as et
    sc = build_scene(name)
    static, tables = et.compile_scene(sc)
    return (static, et.tables_to_torch(tables, device),
            et.camera_to_torch(et.compile_camera(sc.camera), device))


def seeded(shape, seed, device, kind="normal"):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    a = rng.normal(size=shape) if kind == "normal" else rng.uniform(size=shape)
    return torch.from_numpy(a.astype(np.float32)).to(device)


# --- phase 3 -----------------------------------------------------------------

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


# --- phase 4 -----------------------------------------------------------------

def ground_truth(name, device, goldens):
    """Phase 4 for one scene: goldens and C++ oracle gates."""
    import numpy as np
    from euclider_tpu_torch.ops import cuda_kernel
    from euclider_tpu_torch.utils.validate import assert_oracle_match

    static, tables, cam = load(name, device)
    if name in goldens:
        img = cuda_kernel.render_image_cuda(static, tables, cam, 48, 64)
        err = np.abs(img.cpu().numpy() - goldens[name]).max(axis=-1)
        bad = float((err > GOLD_TOL).mean())
        say("truth", f"{name}: goldens 48x64 bad_frac(>{GOLD_TOL:g})="
            f"{bad:.4f} (limit {GOLD_BAD:g}), max_err={err.max():.3e}")
        assert bad <= GOLD_BAD, f"{name}: goldens gate failed"
    frac = assert_oracle_match(static, tables, cam,
                               cuda_kernel.render_image_cuda, h=48, w=128,
                               tol=ORACLE_TOL, min_frac=ORACLE_FRAC,
                               label=name)
    say("truth", f"{name}: oracle 48x128 frac_ok(<{ORACLE_TOL:g})="
        f"{frac:.4f} (limit {ORACLE_FRAC:g})")


# --- phase 5 -----------------------------------------------------------------

def run_together(cmds, timeout=600):
    """The commands as subprocesses from the repository's root, stdin
    empty, all started together (each spends seconds reaching the card)
    -> [(exit code, stdout, stderr)] in order.  Every process is waited
    for, and killed if waiting for any fails."""
    procs = [subprocess.Popen(c, cwd=ROOT, stdin=subprocess.DEVNULL,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    out = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=timeout)
            out.append((p.returncode, o, e))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def cli_renders(names):
    """The CLI with --backend cuda at 1280x720 on each scene, the
    processes run together; each must write its PNG."""
    pngs = [os.path.join(ROOT, "euclider_tpu_torch", "build",
                         f"smoke_cli_{name}.png") for name in names]
    for png in pngs:
        if os.path.exists(png):
            os.remove(png)
    done = run_together([[sys.executable, "-m", "euclider_tpu_torch",
                          "--scene", name, "--size", f"{W}x{H}", "--backend",
                          "cuda", "--out", png]
                         for name, png in zip(names, pngs)])
    for name, png, (rc, out, err) in zip(names, pngs, done):
        assert rc == 0, f"CLI failed on {name}:\n{out}{err}"
        with open(png, "rb") as f:
            head = f.read(24)
        assert head[:8] == b"\x89PNG\r\n\x1a\n", "CLI wrote no PNG"
        size = (int.from_bytes(head[16:20], "big"),
                int.from_bytes(head[20:24], "big"))
        assert size == (W, H), f"CLI PNG is {size}"
        say("main", f"CLI --backend cuda --scene {name} wrote "
            f"{os.path.relpath(png, ROOT)} ({size[0]}x{size[1]})")


def main_path(device):
    """Phase 5, the render path -> (launches of the forward kernel on it,
    {scene: its launches})."""
    import torch
    import euclider_tpu_torch as et
    from euclider_tpu_torch.ops import cuda_bwd, cuda_kernel

    names = SCENES + WARP[:1] + EXPR + SHAPES[:1]
    scenes = [load(name, device) for name in names]
    cuda_kernel.LAUNCHES = cuda_bwd.LAUNCHES = 0
    imgs, by_scene = [], {}
    for name, (static, tables, cam) in zip(names, scenes):
        before = cuda_kernel.LAUNCHES
        imgs.append(et.render_image(static, tables, cam, H, W))
        by_scene[name] = cuda_kernel.LAUNCHES - before
    torch.cuda.synchronize()
    launches = cuda_kernel.LAUNCHES
    for name, img in zip(names, imgs):
        assert img.shape == (H, W, 3) and img.device.type == "cuda", name
        assert bool(torch.isfinite(img).all()), f"{name}: non-finite pixels"
        say("main", f"{name}: render_image {W}x{H} finite, mean rgb "
            f"{[round(float(c), 4) for c in img.mean(dim=(0, 1))]}")
    say("main", f"kernel launches on the render path: {launches} "
        f"{by_scene}")
    assert launches >= len(names), "the render path did not run the kernel"
    assert min(by_scene.values()) >= 1, "a scene's render skipped the kernel"
    cli_renders((SCENES[1], WARP[0], EXPR[0], SHAPES[0]))
    return launches, by_scene


# --- phase 6 -----------------------------------------------------------------

def leaves(d_tables, d_cam):
    from euclider_tpu_torch.ops.cuda_kernel import FLOAT_FIELDS
    return ([(k, getattr(d_tables, k)) for k in FLOAT_FIELDS]
            + [(f"textures[{i}]", t) for i, t in enumerate(d_tables.textures)]
            + [(f"cam.{k}", v) for k, v in d_cam._asdict().items()])


def grads_err(ref, got, rtol=GRAD_RTOL):
    """Worst leaf under the rule max|diff| <= rtol * max(max|ref|, 1)
    -> (ratio of error to tolerance, leaf, error)."""
    worst = (0.0, "", 0.0)
    for (k, a), (_, b) in zip(leaves(*ref), leaves(*got)):
        e = float((a.double() - b.double()).abs().max())
        tol = rtol * max(float(a.abs().max()), 1.0)
        worst = max(worst, (e / tol, k, e))
    return worst


def backward_check(name, device, y0=0, rows=H, tm=0.0, backward="auto",
                   ref_fn="vjp_blocked"):
    """Phase 6 for one scene on rows [y0, y0 + rows) at scene time tm ->
    numbers for the record: vjp_cuda with ``backward`` against the plain
    version ``ref_fn`` of ops/vjp.py, then train_step_cuda against the
    forward kernel + MSE + vjp_cuda, both with ``backward``."""
    import torch
    from euclider_tpu_torch.ops import cuda_bwd, cuda_kernel, trace, vjp
    from euclider_tpu_torch.ops import geometry as G
    from euclider_tpu_torch.utils.validate import seams

    static, tables, cam = load(name, device)
    k1 = cuda_kernel.render_image_cuda(static, tables, cam, H, W, tm, y0=y0,
                                       rows=rows)
    plain = trace.render_image(static, tables, cam, H, W, tm, y0=y0,
                               rows=rows)
    # The cotangent is zero where the comparison measures float32 noise, not
    # the kernel: where the two forwards took different branches, and at
    # seams, where per-pixel gradients like dt/dr ~ 1/sqrt(disc) amplify a
    # rounding without bound (tests/test_gradients.py masks silhouettes
    # alike).
    flips = (k1 - plain).abs().amax(-1) > TOL
    keep = ~(flips | seams(plain, SMOOTH_TAU))
    g = seeded((rows, W, 3), 0, device) * keep[..., None]
    got = cuda_bwd.vjp_cuda(static, tables, cam, H, W, g, tm, y0=y0,
                            rows=rows, backward=backward)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    ref = getattr(vjp, ref_fn)(static, tables, cam, H, W, g, time=tm,
                               y0=y0, rows=rows)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    peak_gib = torch.cuda.max_memory_allocated(device) / 2 ** 30
    ratio, leaf, err = grads_err(ref[:2], got[:2])
    where = f"rows {y0}-{y0 + rows - 1} of {W}x{H}" if rows < H else f"{W}x{H}"
    say("bwd", f"{name}: vjp_cuda ({backward}) vs {ref_fn} on {where}, "
        "cotangent "
        f"zero on {float((~keep).float().mean()):.4f} of pixels ({int(flips.sum())} "
        f"branch flips + seams): worst leaf {leaf} err {err:.4g} = "
        f"{ratio:.3f} of its tolerance; plain backward {plain_ms:.1f} ms, "
        f"peak {peak_gib:.2f} GiB")
    if static.has_warp:
        pairs = [(k, a, b) for (k, a), (_, b) in zip(leaves(*ref[:2]),
                                                     leaves(*got[:2]))
                 if k.startswith(("mat_warp", "portal", "mat_expr"))]
        pairs.append(("time", ref[2], got[2]))
        for k, a, b in pairs:
            e = float((a.double() - b.double()).abs().max())
            say("bwd", f"{name}: {k} max|ref| {float(a.abs().max()):.4g}"
                f" err {e:.4g} = "
                f"{e / (GRAD_RTOL * max(float(a.abs().max()), 1.0)):.4f}"
                " of its tolerance")
    t_err = abs(float(got[2]) - float(ref[2]))
    t_ratio = t_err / (GRAD_RTOL * max(abs(float(ref[2])), 1.0))
    assert ratio <= 1.0, f"{name}: vjp_cuda disagrees with the plain backward"
    assert t_ratio <= 1.0, f"{name}: the time's gradient disagrees"
    extra = {}
    if name in SLAB_SCENES:
        _, steps, marches, _ = march_count(static, tables, cam, y0, rows)
        extra.update(marched_nodes=marches, march_steps=steps)
        say("bwd", f"{name}: {marches} nodes of the slab march, {steps} live "
            "march steps")
        assert marches > 0, f"{name}: no ray of the slab marches"
    if name in WARP_GRAD_SCENES:
        for k in ("mat_warp_center", "mat_warp_strength", "mat_warp_step"):
            assert float(getattr(ref[0], k).abs().max()) > 0 and \
                float(getattr(got[0], k).abs().max()) > 0, \
                f"{name}: {k} got no gradient"
    if name == "expr_gradient_scene":
        assert float(ref[0].mat_expr_params.abs().max()) > 0 and \
            float(got[0].mat_expr_params.abs().max()) > 0, \
            f"{name}: mat_expr_params got no gradient"
        assert float(ref[2]) != 0.0 and float(got[2]) != 0.0, \
            f"{name}: the scene time got no gradient"
    for i, (a, b) in enumerate(zip(ref[0].textures, got[0].textures)):
        extra[f"textures[{i}]_max"] = (float(a.abs().max()),
                                       float(b.abs().max()))
        say("bwd", f"{name}: textures[{i}] ({a.numel()} texels x channels) "
            f"max|ref| {extra[f'textures[{i}]_max'][0]:.4g}, max|kernel| "
            f"{extra[f'textures[{i}]_max'][1]:.4g}")
        assert min(extra[f"textures[{i}]_max"]) > 0, \
            f"{name}: the texture got no gradient"
    for e in static.entities:
        for leaf in (G.leaves(e.shape)):
            if leaf[0] != "cylinder":
                continue
            cyl_rows = slice(leaf[1], leaf[1] + 2)   # centre and axis
            a = float(ref[0].shape_vec[cyl_rows].abs().max())
            b = float(got[0].shape_vec[cyl_rows].abs().max())
            extra[f"cylinder_rows_{leaf[1]}_max"] = (a, b)
            say("bwd", f"{name}: cylinder at shape_vec rows {leaf[1]}-"
                f"{leaf[1] + 1}: max|ref| {a:.4g}, max|kernel| {b:.4g}")
            if name == "cylinder_smooth":
                assert min(a, b) > 0, f"{name}: a cylinder got no gradient"

    target = seeded((rows, W, 3), 1, device, "uniform")
    loss, gt, gc, _ = cuda_bwd.train_step_cuda(
        static, tables, cam, target, H, W, tm, y0=y0, rows=rows,
        norm=1.0 / (rows * W * 3), backward=backward)
    ref_loss = torch.mean((k1 - target) ** 2)
    ref2 = cuda_bwd.vjp_cuda(static, tables, cam, H, W,
                             2.0 * (k1 - target) / k1.numel(), tm, y0=y0,
                             rows=rows, backward=backward)
    torch.cuda.synchronize()
    lrel = abs(float(loss) - float(ref_loss)) / float(ref_loss)
    ratio2, leaf2, err2 = grads_err(ref2[:2], (gt, gc))
    say("bwd", f"{name}: train_step_cuda vs trace_fwd + MSE + vjp_cuda: loss "
        f"{float(loss):.6f} vs {float(ref_loss):.6f} (rel {lrel:.2e}, limit "
        f"{LOSS_RTOL:g}); worst leaf {leaf2} = {ratio2:.3f} of its tolerance")
    assert lrel <= LOSS_RTOL, f"{name}: fused loss disagrees"
    assert ratio2 <= 1.0, f"{name}: fused gradients disagree"
    return {"vjp_err_over_tol": ratio, "vjp_leaf": leaf, "vjp_err": err,
            **extra,
            "time_grad": float(got[2]), "time_err_over_tol": t_ratio,
            "masked_frac": float((~keep).float().mean()),
            "fused_loss_rel": lrel, "fused_err_over_tol": ratio2,
            "plain_ms": plain_ms, "plain_peak_gib": peak_gib,
            "rows": [y0, y0 + rows], "scene_time": tm}


# --- phase 7 -----------------------------------------------------------------

def fused_vs_unfused(name, device):
    """One training step of ``name`` at 1280x720 through the 'cuda-fused'
    and the 'cuda' backends of train/inverse.py from the same parameters:
    the losses within LOSS_RTOL, the gradients by phase 6's rule."""
    from euclider_tpu_torch.train.inverse import (InverseParams,
                                                  make_fused_value_and_grad)
    static, tables, cam = load(name, device)
    target = seeded((H, W, 3), 9, device, "uniform")
    params = InverseParams(tables, cam)
    lf, gf = make_fused_value_and_grad(static, H, W, "cuda-fused")(params,
                                                                   target)
    lu, gu = make_fused_value_and_grad(static, H, W, "cuda")(params, target)
    lrel = abs(float(lf) - float(lu)) / float(lu)
    ratio, leaf, _ = grads_err((gu.tables, gu.cam), (gf.tables, gf.cam))
    say("train", f"{name}: one step, fused loss {float(lf):.6f} vs unfused "
        f"{float(lu):.6f} (rel {lrel:.2e}, limit {LOSS_RTOL:g}); worst leaf "
        f"{leaf} = {ratio:.3f} of its tolerance")
    assert lrel <= LOSS_RTOL, f"{name}: fused and unfused losses disagree"
    assert ratio <= 1.0, f"{name}: fused and unfused gradients disagree"
    return {"loss_rel": lrel, "err_over_tol": ratio, "leaf": leaf}


def train_path(device):
    """Phase 7, the training path -> kernel launches on it."""
    from euclider_tpu_torch.ops import cuda_bwd, cuda_kernel
    from euclider_tpu_torch.train import fit

    by_scene = {}

    def counted(name, run, *args):
        """run(*args), its launches added to by_scene[name] (fit.main's
        target render included)."""
        fwd0, bwd0 = cuda_kernel.LAUNCHES, cuda_bwd.LAUNCHES
        out = run(*args)
        got = by_scene.setdefault(name, {"trace_fwd": 0, "trace_bwd": 0})
        got["trace_fwd"] += cuda_kernel.LAUNCHES - fwd0
        got["trace_bwd"] += cuda_bwd.LAUNCHES - bwd0
        return out

    cuda_kernel.LAUNCHES = cuda_bwd.LAUNCHES = 0
    fused = counted("grad_probe", fit.main,
                    ["--scene", "grad_probe", "--steps", str(EXAMPLE_STEPS)])
    unfused = counted("grad_probe", fit.main,
                      ["--scene", "grad_probe", "--steps", "2",
                       "--backend", "cuda"])
    warp, expr, shapes = (counted(name, fit.main, ["--scene", name,
                                                   "--steps",
                                                   str(TRAIN_STEPS)])
                          for name in (WARP[0], EXPR[0], SHAPES[0]))
    step = counted(EXPR[0], fused_vs_unfused, EXPR[0], device)
    launches = {"trace_fwd": cuda_kernel.LAUNCHES,
                "trace_bwd": cuda_bwd.LAUNCHES,
                **{f"{k}_by_scene": {n: c[k] for n, c in by_scene.items()}
                   for k in ("trace_fwd", "trace_bwd")}}
    assert sum(launches["trace_fwd_by_scene"].values()) == \
        launches["trace_fwd"], "a training launch went uncounted"
    losses = fused["losses"]
    say("train", f"grad_probe fused, {EXAMPLE_STEPS} steps: losses "
        f"{[round(x, 6) for x in losses[:5]]} ... {losses[-1]:.6f}; "
        f"launches during the steps {fused['launches']}; sphere error "
        f"{fused['error'][0]:.4f} -> {fused['error'][1]:.4f} (the example's "
        f"criterion, below half: {fused['recovered']})")
    say("train", f"grad_probe unfused (--backend cuda): launches during the "
        f"steps {unfused['launches']}")
    runs = ((WARP[0], warp), (EXPR[0], expr), (SHAPES[0], shapes))
    for name, run in runs:
        say("train", f"{name} fused: losses "
            f"{[round(x, 6) for x in run['losses']]}, launches during the "
            f"steps {run['launches']}")
    say("train", f"launches on the training path {launches}")
    assert all(x == x and abs(x) != float("inf")
               for x in losses + unfused["losses"] + warp["losses"]
               + expr["losses"] + shapes["losses"])
    assert fused["recovered"], "the example's criterion failed"
    assert fused["launches"] == {"trace_fwd": 0, "trace_bwd": EXAMPLE_STEPS,
                                 "trace_seg": 0}
    assert min(unfused["launches"][k] for k in ("trace_fwd", "trace_bwd")) \
        >= 2, "an unfused kernel idled"
    for name, run in runs:
        assert run["launches"] == {"trace_fwd": 0, "trace_bwd": TRAIN_STEPS,
                                   "trace_seg": 0}
        assert all(b < a for a, b in zip(run["losses"], run["losses"][1:])), \
            f"{name}: the fused steps did not lower the loss"
    return launches, {"grad_probe": losses, WARP[0]: warp["losses"],
                      EXPR[0]: expr["losses"], SHAPES[0]: shapes["losses"],
                      "grad_probe_error": fused["error"],
                      f"{EXPR[0]}_fused_vs_unfused": step}


# --- phase 8 -----------------------------------------------------------------

EVENT_TIMED = set()   # kernels that some profile missed, timed by padded_ms


def device_ms(fn, keys, n=5, tries=3):
    """Mean device time of one launch of each kernel named in keys over n
    calls of fn, from torch.profiler: over the launches it recorded.  A
    profile that recorded no launch of one of the kernels is taken again,
    up to ``tries`` profiles (on the card torch.profiler now and then
    returns profiles without them, in runs of several).  Kernels that no
    profile recorded are timed by CUDA events instead (padded_ms: the whole
    call, so an upper bound): the call's time less the profiled kernels'
    goes to the first of them and 0 to the rest, and each is added to
    EVENT_TIMED."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = dict.fromkeys(keys)
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        for key in keys:
            evts = [e for e in prof.key_averages() if key in e.key]
            us = sum(getattr(e, "device_time_total", 0.0) for e in evts)
            calls = sum(e.count for e in evts)
            if out[key] is None and us > 0 and calls:
                out[key] = us / calls / 1e3
        if all(v is not None for v in out.values()):
            return out
    missing = [k for k in keys if out[k] is None]
    call = padded_ms(fn)
    say("time", f"torch.profiler recorded no launch of {missing} in "
        f"{tries} profiles: CUDA events time the whole call, {call:.6f} ms")
    rest = call - sum(v for v in out.values() if v is not None)
    for i, key in enumerate(missing):
        out[key] = max(rest, 0.0) if i == 0 else 0.0
    EVENT_TIMED.update(missing)
    return out


def padded_ms(fn, n=20):
    """Median device time of one call of fn by CUDA events, each pair
    recorded behind a spin kernel (torch.cuda._sleep) that outlasts the
    call's host work, so the events and the call's launches queue back to
    back and the host's time between them does not count; the events' own
    cost (about 4 us on the H100 80GB HBM3: P2-P5's records, ``ms``
    beside ``padded_ms``) does."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(max(1e-3, 4 * host_s) * 2e9)   # at most ~2 GHz SM clock
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def events_ms(fn, device, warm=3):
    from euclider_tpu_torch.cli import time_render
    for _ in range(warm):
        fn()
    return time_render(fn, device, 5)


def counted_render(static, tables, cam, y0=0, rows=H):
    """The plain render of rows [y0, y0 + rows) and its work, counted by
    wrapping the plain version's node shading, propagation and march step
    for the length of the render, on the device (no synchronising call a
    step) -> (image, ray-tree nodes shaded at each pixel [rows, W], the
    primary node included; live march steps summed over the slab; marched
    nodes; [nodes that hit each entity])."""
    import torch
    from euclider_tpu_torch.ops import march, trace
    dev = tables.surf_color.device
    nodes = torch.zeros((rows, W), dtype=torch.int32, device=dev)
    counts = {k: torch.zeros((), dtype=torch.int64, device=dev)
              for k in ("steps", "marches")}
    hits = torch.zeros(len(static.entities), dtype=torch.int64, device=dev)
    make_body = march.make_march_body
    shade_node, propagate = trace._shade_node, trace.propagate
    active = [None]

    def shading(*args, **kw):
        active[0] = args[7]          # _shade_node's `active`
        nodes.add_(active[0].to(torch.int32))
        return shade_node(*args, **kw)

    def propagating(*args, **kw):
        out = propagate(*args, **kw)
        hit = out[0] & active[0]
        hits.add_(torch.bincount(out[3][hit].long(), minlength=len(hits)))
        return out

    def counting(*args):
        body = make_body(*args)
        first = [True]

        def step(carry):
            live = (~carry[2]).sum()
            counts["steps"] += live
            if first[0]:
                counts["marches"] += live
                first[0] = False
            return body(carry)

        return step

    march.make_march_body = counting
    trace._shade_node, trace.propagate = shading, propagating
    try:
        img = trace.render_image(static, tables, cam, H, W, y0=y0, rows=rows)
    finally:
        march.make_march_body = make_body
        trace._shade_node, trace.propagate = shade_node, propagate
    return (img, nodes, int(counts["steps"]), int(counts["marches"]),
            hits.tolist())


def march_count(static, tables, cam, y0=0, rows=H):
    """counted_render's work without its image -> (nodes [rows, W], live
    march steps, marched nodes, hits [n_ent])."""
    return counted_render(static, tables, cam, y0, rows)[1:]


# FP32 operations of the kernels' code (trace_common.cuh), counted as one
# per add, multiply, compare-free select, sqrt, rsqrt, divide, sine, pow
# or floor:
CAMERA_OPS = 125          # camera_ray: 4 normalize, 3 projections, NDC
# nearest(): one leaf's roots
TEST_OPS = {"sphere": 25, "halfspace": 16, "hyperplane": 16, "cylinder": 70}
MISS_OPS = 6              # the cheapest shading: w * background
MARCH_STEP_OPS = 47       # march_step: the field (18), v + h a, normalize, x + h v
ATTRACTOR_OPS = 18        # the attractor field of march_step
# leaf_member() / side(): one leaf; a bare hyperplane's side is a
# half-space test, inside a composite it is free
SIDE_OPS = {"sphere": 12, "halfspace": 8, "hyperplane": 8, "cylinder": 27}
BISECT_OPS = 240          # bisect(): 10 halvings of lerp + side, one entity
PROBE_POINT_OPS = 9       # csg_flips(): t -+ PROBE and o + t d, per point
PERLIN_OCTAVE_OPS = 45    # perlin_sum(): one octave (scale, floor, fraction,
                          # 4 gradient dots, 2 fades, 3 lerps, the sum)
TEXTURE_OPS = 39          # tex_cell() and 3 channels of bilinear()


def side_ops(node):
    """Operations of member() or side() on a shape: its leaves' tests."""
    from euclider_tpu_torch.ops import geometry as G
    if G.is_primitive(node):
        return SIDE_OPS[node[0]]
    return sum(0 if leaf[0] == "hyperplane" else SIDE_OPS[leaf[0]]
               for leaf in G.leaves(node))


def field_ops(static):
    """Operations of the cheapest field a march step of this scene
    evaluates: the attractor's, or an expression material's VM program,
    one per instruction that computes (constants and variables are free,
    an integer power counts its multiplications and, for a negative
    exponent, its division)."""
    from euclider_tpu_torch.ops import cuda_kernel
    from euclider_tpu_torch.scene.expr import OPS, to_postfix
    ops = []
    for m, kind in enumerate(static.mat_kinds):
        if kind == "warp":
            ops.append(ATTRACTOR_OPS)
        elif kind == "expr":
            code, _ = cuda_kernel.expr_program(
                [to_postfix(a) for a in static.mat_exprs[m]])
            ops.append(sum(max(abs(n) - 1 + (n < 0), 0) if op == OPS["powi"]
                           else int(op not in (OPS["const"], OPS["var"]))
                           for op, _, _, n in code.tolist()))
    return min(ops, default=ATTRACTOR_OPS)


def bound(static, nodes, backward, steps=0, marches=0, hits=(),
          tex_bytes=0, pixels=H * W):
    """Least time for the frame (or a slab of ``pixels``, the counts being
    the slab's): the larger of the bytes (12 B/pixel: the
    image out, or the cotangent or target in; the textures read once) over
    HBM bandwidth and a lower bound on the FP32 operations over the FP32
    peak.  The operations count the camera ray, every straight node's
    nearest-hit test over every leaf of every entity, every live march step
    with its field (``field_ops``) and its side tests over every entity,
    one bisection per marched node, and the cheapest shading of every node;
    for each node that hits an entity (``hits``), the membership probe of
    its winning crossing where that entity is a composite (two member()
    evaluations), and the octaves of a perlin surface or the bilinear
    sample of a texture.  The backward counts them twice (its forward sweep
    and the recompute of its reverse sweep) and no adjoint arithmetic.
    -> (ms, bound_by, ops)."""
    from euclider_tpu_torch.ops import geometry as G
    test = sum(TEST_OPS[leaf[0]] for e in static.entities
               for leaf in G.leaves(e.shape))
    side = sum(side_ops(e.shape) for e in static.entities)
    step = MARCH_STEP_OPS - ATTRACTOR_OPS + field_ops(static)
    ops = (pixels * CAMERA_OPS + nodes * MISS_OPS + (nodes - marches) * test
           + steps * (step + side) + marches * BISECT_OPS)
    perlin = static.surf_perlin or (None,) * len(static.surf_kinds)
    for e, n in zip(static.entities, hits):
        if not G.is_primitive(e.shape):
            ops += n * 2 * (PROBE_POINT_OPS + side_ops(e.shape))
        kind = static.surf_kinds[e.surface]
        if kind == "perlin":
            ops += n * perlin[e.surface][0] * PERLIN_OCTAVE_OPS
        elif kind == "texture":
            ops += n * TEXTURE_OPS
    if backward:
        ops *= 2
    t_ops = ops / PEAK_FP32 * 1e3
    t_bytes = (pixels * 12 + tex_bytes) / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                 else "bytes"), ops


def timing(name, device, card):
    """Phase 8 for one scene."""
    from euclider_tpu_torch.ops import cuda_bwd, cuda_kernel, trace
    from euclider_tpu_torch.train.inverse import (InverseParams,
                                                  make_fused_value_and_grad)

    static, tables, cam = load(name, device)
    out = {}

    def fwd():
        return cuda_kernel.render_image_cuda(static, tables, cam, H, W)

    out["frame_ms"] = events_ms(fwd, device)
    out["plain_frame_ms"] = events_ms(
        lambda: trace.render_image(static, tables, cam, H, W), device, 1)
    out["fwd_device_ms"] = device_ms(fwd, ["trace_fwd_kernel"])[
        "trace_fwd_kernel"]
    nodes, steps, marches, hits = march_count(static, tables, cam)
    nodes = int(nodes.sum())
    tex_bytes = 4 * sum(t.numel() for t in tables.textures)
    out["nodes_per_pixel"] = nodes / (H * W)
    out["march_steps_per_pixel"] = steps / (H * W)
    out["hits_per_pixel"] = {e.name or f"entity{i}": n / (H * W)
                             for i, (e, n) in enumerate(zip(static.entities,
                                                            hits))}
    out["fwd_bound_ms"], out["fwd_bound_by"], out["fwd_ops"] = bound(
        static, nodes, False, steps, marches, hits, tex_bytes)
    out["bwd_bound_ms"], out["bwd_bound_by"], out["bwd_ops"] = bound(
        static, nodes, True, steps, marches, hits, tex_bytes)
    if name in TRAIN_SCENES:
        target = seeded((H, W, 3), 2, device, "uniform")
        params = InverseParams(tables, cam)
        fused = make_fused_value_and_grad(static, H, W, "cuda-fused")
        unfused = make_fused_value_and_grad(static, H, W, "cuda")
        out["fused_step_ms"] = events_ms(lambda: fused(params, target),
                                         device)
        out["unfused_step_ms"] = events_ms(lambda: unfused(params, target),
                                           device)
        dev_ms = device_ms(lambda: fused(params, target),
                           ["trace_bwd_kernel", "sum_partials_kernel"])
        out["bwd_device_ms"] = dev_ms["trace_bwd_kernel"]
        out["sum_device_ms"] = dev_ms["sum_partials_kernel"]
        g = seeded((H, W, 3), 3, device)
        out["vjp_device_ms"] = device_ms(
            lambda: cuda_bwd.vjp_cuda(static, tables, cam, H, W, g),
            ["trace_bwd_kernel"])["trace_bwd_kernel"]
        out["bwd_config"] = cuda_bwd.launch_config(static, tables)
    for k, v in out.items():
        if isinstance(v, float):
            say("time", f"{name} {k}: {v:.4f}" + (
                "" if k.endswith("per_pixel") else f" ({card})"))
        else:
            say("time", f"{name} {k}: {v}")
    return out


# --- phase 9 -----------------------------------------------------------------

PROBE_STEP_OPS = 9        # probe_rev.cu, one forward step of one element
PROBE_REV_OPS = 19        # one reverse step (rebuild + adjoint)


def probe_check(device, card):
    """Phase 9: probe_rev against rev_march_plain on the probe's tile and
    on its first 1000 elements (a cluster whose last block is part empty);
    two launches give the same bits."""
    import torch
    from euclider_tpu_torch.ops import probes
    from euclider_tpu_torch.tools.ab_trees import rev_steps

    x = seeded((8, 128), 7, device) * 0.8
    g = seeded((8, 128), 8, device)
    w = 1.1
    probes.LAUNCHES = 0
    dx, dw = probes.rev_march_vjp(x, w, g)
    torch.cuda.synchronize()
    launches = probes.LAUNCHES
    pdx, pdw = probes.rev_march_plain(x, w, g)
    err_dx = float((dx - pdx).abs().max() / pdx.abs().max())
    err_dw = abs(float(dw) - float(pdw)) / abs(float(pdw))
    say("probe", f"probe_rev vs rev_march_plain on (8, 128): dx rel "
        f"{err_dx:.3e}, dw {float(dw):.7f} vs {float(pdw):.7f} (rel "
        f"{err_dw:.3e}; limit {PROBE_RTOL:g}); launches {launches}")
    assert launches == 1, "rev_march_vjp did not run the kernel"
    assert err_dx <= PROBE_RTOL and err_dw <= PROBE_RTOL, "probe_rev disagrees"
    x1k, g1k = x.reshape(-1)[:1000], g.reshape(-1)[:1000]
    rel = rel_errs(probes.rev_march_cuda(x1k, w, g1k),
                   probes.rev_march_plain(x1k, w, g1k))
    again = probes.rev_march_cuda(x, w, g)
    same = torch.equal(again[0], dx) and torch.equal(again[1], dw)
    say("probe", f"probe_rev on 1000 elements vs plain: rel {rel:.3e} (limit "
        f"{PROBE_RTOL:g}); two launches the same bits {same}")
    assert rel <= PROBE_RTOL and same, "probe_rev disagrees or is not fixed"

    walked = rev_steps(probes, x, w)   # the steps each element walks
    steps = int(walked.sum())
    lane = int(walked.reshape(-1).argmax())
    xl, gl = x.reshape(-1)[lane:lane + 1], g.reshape(-1)[lane:lane + 1]
    ops = steps * (PROBE_STEP_OPS + PROBE_REV_OPS)
    t_ops = ops / PEAK_FP32 * 1e3
    t_bytes = 3 * x.numel() * 4 / PEAK_BYTES * 1e3
    out = {"max_abs_err": float((dx - pdx).abs().max()), "dx_rel": err_dx,
           "dw_rel": err_dw, "launches": launches,
           "ms": device_ms(lambda: probes.rev_march_cuda(x, w, g),
                           ["probe_rev_kernel"])["probe_rev_kernel"],
           "lane_ms": device_ms(lambda: probes.rev_march_cuda(xl, w, gl),
                                ["probe_rev_kernel"])["probe_rev_kernel"],
           "longest_lane": lane, "ragged_rel": rel, "fixed_bits": same,
           "plain_ms": events_ms(lambda: probes.rev_march_plain(x, w, g),
                                 device, 1),
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops > t_bytes else "bytes",
           "steps_per_element": steps / x.numel()}
    for k in ("ms", "lane_ms", "plain_ms", "bound_ms"):
        say("time", f"probe_rev {k}: {out[k]:.6f} ({card})")
    return out


def rel_errs(got, ref):
    """The largest of each output's max |got - ref| over max |ref|."""
    return max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
               for a, b in zip(got, ref))


def march_probe_bound(static, steps, ent, stage):
    """Least time of one probe_march launch on these lanes -> (ms,
    bound_by): the bytes of the rays in and the tile out (44 B a lane), and
    the FP32 operations this run's march needs: every lane's walked steps
    with their side tests, the bisection of every lane that crossed and,
    but for fwd, the march of those lanes twice more (march_replay, and the
    rebuild of march_reverse; no adjoint arithmetic counted)."""
    import torch
    side = sum(side_ops(e.shape) for e in static.entities)
    crossed = ent >= 0
    ops = (int(steps.sum()) * (MARCH_STEP_OPS + side)
           + int(crossed.sum()) * BISECT_OPS)
    if stage != "fwd":
        ops += 2 * int(steps[crossed].sum()) * MARCH_STEP_OPS
    t_ops = ops / PEAK_FP32 * 1e3
    t_bytes = steps.numel() * 44 / PEAK_BYTES * 1e3
    return max((t_ops, "operations"), (t_bytes, "bytes"),
               key=lambda t: t[0])


def march_probe_check(device, card):
    """P1 on the card: the probes' path for probe_march (every stage on both
    tiles through march_probe), then each stage against the plain version,
    vjp against finish, the crossing tile's shares, the times."""
    import torch
    from euclider_tpu_torch.ops import march_probe as MP

    static, tables = MP.probe_scene(device)
    tiles = {"tool": MP.tool_tile(device), "crossing": MP.crossing_tile(device)}
    MP.LAUNCHES = 0
    got = {(tile, st): MP.march_probe(static, tables, org, d, st)
           for tile, (org, d) in tiles.items() for st in MP.STAGES}
    torch.cuda.synchronize()
    launches = MP.LAUNCHES
    say("probe", f"probe_march: the probes' path launched it {launches} times")
    assert launches == len(got), "march_probe did not run the kernel"
    stages, worst = {}, 0.0
    for (tile, st), k in got.items():
        ref = MP.march_probe_plain(static, tables, *tiles[tile], st)
        res = MP.compare(ref, k)
        say("probe", f"probe_march {st} on the {tile} tile vs plain: max err "
            f"{res['max_err']:.3e} (limit {res['limit']:.3e}), "
            f"{res['flipped']} lanes marching otherwise (limit "
            f"{MP.MAX_FLIPPED:.0%}), sum {float(k.out.double().sum()):.4f} "
            f"(plain {float(ref.out.double().sum()):.4f}), crossed "
            f"{res['crossed']:.4f}, sum(d shape_vec) {res['dsv']:.4f} "
            f"(plain {res['plain_dsv']:.4f})")
        assert MP.passes(res, k.out.numel()), \
            f"probe_march {st} on the {tile} tile disagrees"
        worst = max(worst, res["max_err"])
        stages[f"{st}_{tile}"] = res
    for tile in tiles:
        a, b = got[tile, "vjp"].out, got[tile, "finish"].out
        rel = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        say("probe", f"probe_march vjp (rebuild) vs finish (stored tape) on "
            f"the {tile} tile: rel {rel:.3e} (limit {MP.RTOL:g})")
        assert rel <= MP.RTOL, "the rebuild disagrees with the tape"
        stages[f"vjp_vs_finish_{tile}"] = rel
    cross = stages["vjp_crossing"]
    assert 0.25 <= cross["crossed"] < 0.75 and cross["dsv"] != 0.0, \
        "the crossing tile does not cross as it should"
    org, d = tiles["crossing"]
    # the cluster's fixed-order sum: the same bits in two launches and on
    # every lane, equal to march_probe.tile_sum of the lanes' shares
    n = org.numel() // 4
    checks = [torch.empty(2 * n, device=device) for _ in range(2)]
    a, b = (MP.march_probe_cuda(static, tables, org, d, "vjp", check=c)
            for c in checks)
    torch.cuda.synchronize()
    same = (torch.equal(a.out, b.out) and torch.equal(a.dsv, b.dsv)
            and bool((checks[0][n:] == a.dsv).all())
            and bool((checks[1][n:] == b.dsv).all()))
    ordered = torch.equal(MP.tile_sum(checks[0][:n]), a.dsv.cpu())
    say("probe", f"probe_march vjp on the crossing tile: two launches and "
        f"every lane the same bits {same}; the sum in tile_sum's order to "
        f"the bit {ordered}")
    assert same and ordered, "probe_march's tile sum is not fixed"
    stages["fixed_order_sum"] = same and ordered
    ref = got["crossing", "fwd"]
    # the tile's longest lane (the most steps, among the lanes that cross),
    # run alone: the floor of a lane a thread
    key = ref.steps.reshape(-1).long() + (ref.ent.reshape(-1) >= 0).long() \
        * (1 << 20)
    lane = int(torch.argmax(key))
    o1, d1 = (t.reshape(-1, 4)[lane:lane + 1] for t in (org, d))
    empty_ms = device_ms(lambda: MP.empty_cuda(device),
                         ["probe_empty_kernel"])["probe_empty_kernel"]
    times = {"longest_lane": lane, "empty_ms": empty_ms}
    for st in MP.STAGES:
        ms = device_ms(lambda: MP.march_probe_cuda(static, tables, org, d, st),
                       ["probe_march_kernel"])["probe_march_kernel"]
        lane_ms = device_ms(
            lambda: MP.march_probe_cuda(static, tables, o1, d1, st),
            ["probe_march_kernel"])["probe_march_kernel"]
        bound, by = march_probe_bound(static, ref.steps, ref.ent, st)
        times[st] = {"ms": ms, "lane_ms": lane_ms, "bound_ms": bound,
                     "bound_by": by}
        say("time", f"probe_march {st} (crossing tile): {ms:.6f} ms; its "
            f"longest lane ({lane}) alone {lane_ms:.6f} ms; an empty kernel "
            f"{empty_ms:.6f} ms; bound {bound:.6g} ms ({by}) ({card})")
    plain_ms = events_ms(
        lambda: MP.march_probe_plain(static, tables, org, d, "vjp"), device,
        1)
    say("time", f"probe_march plain vjp: {plain_ms:.4f} ms ({card})")
    return {"name": "probe_march", "route": "cuda",
            "source": "euclider_tpu_torch/csrc/probe_march.cu",
            "replaces": "tools/march_bisect.py:52",
            "launches": launches, "max_abs_err": worst,
            "ms": times["vjp"]["ms"], "plain_ms": plain_ms,
            "bound_ms": times["vjp"]["bound_ms"],
            "bound_by": times["vjp"]["bound_by"], "library_ms": None,
            "ms_stage": "vjp on the crossing tile", "shape": [8, 128],
            "lane_ms": times["vjp"]["lane_ms"], "empty_ms": empty_ms,
            "launches_by": "the probes' path (the probe tool and this "
                           "phase); no user path runs P1",
            "tolerance": {"rtol": MP.RTOL, "max_flipped_frac": MP.MAX_FLIPPED,
                          "vjp_vs_finish_rtol": MP.RTOL},
            "card": card, "stages": stages, "times": times}


MOSAIC_REPLACES = {"probe_ckpt": "tools/mosaic_probe.py:56",
                   "probe_cond": "tools/mosaic_probe.py:119",
                   "probe_nested": "tools/mosaic_probe.py:216",
                   "probe_gated": "tools/mosaic_probe.py:344"}
MOSAIC_RTOL = {"probe_cond": 1e-6}   # else PROBE_RTOL
# FP32 operations per element on the timed inputs (probe_mosaic.cu): P2 24
# steps of x + 0.1 tanh(w x) (4) forward, recomputed, and their adjoint
# (6); P3 the tile sum and the live branch (2 v + sin v: 3; its VJP: 4);
# P4 one trip of 12 such steps forward, recomputed and transposed; P5 the
# same with the two-variable step (8 forward, 16 adjoint).  P4's and P5's
# second trip repeats the first on the same inputs, so the work their
# inputs need is one trip (P6's count is one repeat too)
MOSAIC_OPS = {"probe_ckpt": 24 * (4 + 4 + 6), "probe_cond": 1 + 3 + 4,
              "probe_nested": 12 * (4 + 4 + 6),
              "probe_gated": 12 * (8 + 8 + 16)}
# bytes per element: the tiles in and out (P3: x, g, y, dx; P5: x, g, act,
# dx; the others x, g, dx)
MOSAIC_BYTES = {"probe_ckpt": 12, "probe_cond": 16, "probe_nested": 12,
                "probe_gated": 16}


def mosaic_check(device, card, empty_ms):
    """P2-P5 on the card: the probes' path through the dispatchers on the
    mosaic tool's tiles (P3 in both branches, P5 also dead; P2-P5 also on
    their first 1000 elements, P3 in both branches, P5 live and dead: a
    cluster or a block whose last warps are part empty), each against its
    plain version; two launches of each give the same bits (P3 in both
    branches); then their times (beside one lane alone, P3 also beside
    ``empty_ms``, an empty kernel's) -> the kernels' records."""
    import torch
    from euclider_tpu_torch.ops import probes as P

    def tile(seed, scale=1.0, shift=0.0):
        return seeded((8, 128), seed, device) * scale + shift

    x0, g0 = tile(0), tile(1)
    x3, g3 = tile(3, 0.3), tile(4)
    x5, g5 = tile(5, 0.3), tile(6)
    cases = {   # case: (kernel, dispatcher call, plain call)
        "ckpt": ("probe_ckpt", lambda: P.ckpt_scratch_vjp(x0, 0.7, g0),
                 lambda: P.ckpt_scratch_plain(x0, 0.7, g0)),
        "nested": ("probe_nested", lambda: P.nested_march_vjp(x3, 0.9, g3),
                   lambda: P.nested_march_plain(x3, 0.9, g3)),
        "gated": ("probe_gated", lambda: P.gated_march_vjp(x5, 0.8, g5),
                  lambda: P.gated_march_plain(x5, 0.8, g5)),
        "gated_dead": ("probe_gated",
                       lambda: P.gated_march_vjp(x5, 0.8, g5, 0 * x5),
                       lambda: P.gated_march_plain(x5, 0.8, g5, 0 * x5))}
    x1k, g1k = x5.reshape(-1)[:1000], g5.reshape(-1)[:1000]
    for case, act in (("gated_1000", None), ("gated_dead_1000", 0 * x1k)):
        cases[case] = ("probe_gated",
                       lambda act=act: P.gated_march_vjp(x1k, 0.8, g1k, act),
                       lambda act=act: P.gated_march_plain(x1k, 0.8, g1k,
                                                           act))
    xc, gc = x0.reshape(-1)[:1000], g0.reshape(-1)[:1000]
    xn, gn = x3.reshape(-1)[:1000], g3.reshape(-1)[:1000]
    cases["ckpt_1000"] = ("probe_ckpt",
                          lambda: P.ckpt_scratch_vjp(xc, 0.7, gc),
                          lambda: P.ckpt_scratch_plain(xc, 0.7, gc))
    cases["nested_1000"] = ("probe_nested",
                            lambda: P.nested_march_vjp(xn, 0.9, gn),
                            lambda: P.nested_march_plain(xn, 0.9, gn))
    cond_in = {}
    for shift in (1.0, -1.0):
        x, g = tile(2, 1.0, shift), tile(3)
        cond_in[shift] = (x, g)
        for case, (xs, gs) in ((f"cond{shift:+.0f}", (x, g)),
                               (f"cond{shift:+.0f}_1000",
                                (x.reshape(-1)[:1000],
                                 g.reshape(-1)[:1000]))):
            cases[case] = ("probe_cond",
                           lambda x=xs, g=gs: P.cond_vjp(x, g),
                           lambda x=xs, g=gs: P.cond_plain(x, g))
    for k in P.MOSAIC_LAUNCHES:
        P.MOSAIC_LAUNCHES[k] = 0
    got = {case: call() for case, (_, call, _) in cases.items()}
    torch.cuda.synchronize()
    launches = dict(P.MOSAIC_LAUNCHES)
    say("probe", f"probe_mosaic: the probes' path launched {launches}")
    assert all(launches[k] >= 1 for k in MOSAIC_REPLACES), \
        "a probe dispatcher did not run its kernel"
    abs_err, rel_err = dict.fromkeys(MOSAIC_REPLACES, 0.0), {}
    for case, (name, _, plain) in cases.items():
        rtol = MOSAIC_RTOL.get(name, PROBE_RTOL)
        diffs = [((a - b).abs().max(), b.abs().max())
                 for a, b in zip(got[case], plain())]
        rel = max(float(d) / max(float(m), 1e-30) for d, m in diffs)
        say("probe", f"{name} ({case}) vs plain: max rel {rel:.3e} (limit "
            f"{rtol:g})")
        assert rel <= rtol, f"{name} ({case}) disagrees with its plain version"
        abs_err[name] = max(abs_err[name], *(float(d) for d, _ in diffs))
        rel_err[case] = rel
    timed = {"probe_ckpt": ("ckpt", lambda: P.ckpt_scratch_cuda(x0, 0.7, g0)),
             "probe_cond": ("cond+1", lambda: P.cond_cuda(*cond_in[1.0])),
             "probe_nested": ("nested",
                              lambda: P.nested_march_cuda(x3, 0.9, g3)),
             "probe_gated": ("gated",
                             lambda: P.gated_march_cuda(x5, 0.8, g5))}
    # P2, P4 and P5, one cluster each, and P3, one block: a second launch
    # gives the same bits (dw and P3's branch summed in a fixed order; P3
    # in both branches), dx against the plain version's (P4's and P5's one
    # trip of autograd, doubled) in bits and units in the last place, and
    # (lane_ms) one element alone: every lane walks the same steps
    lanes = {"probe_ckpt": lambda: P.ckpt_scratch_cuda(x0[0, :1], 0.7,
                                                       g0[0, :1]),
             "probe_cond": lambda: P.cond_cuda(cond_in[1.0][0][0, :1],
                                               cond_in[1.0][1][0, :1]),
             "probe_nested": lambda: P.nested_march_cuda(x3[0, :1], 0.9,
                                                         g3[0, :1]),
             "probe_gated": lambda: P.gated_march_cuda(x5[0, :1], 0.8,
                                                       g5[0, :1])}
    fixed = {}
    for name in lanes:
        case, kernel = timed[name]
        again = kernel()
        same = all(torch.equal(a, b) for a, b in zip(again, got[case]))
        if name == "probe_cond":
            same = same and all(torch.equal(a, b) for a, b in zip(
                P.cond_cuda(*cond_in[-1.0]), got["cond-1"]))
        dx_bits, dx_ulps = {}, {}
        for c in (case, f"{case}_dead"):
            if c in cases:
                dx, pdx = got[c][0], cases[c][2]()[0]
                ulps = (dx.view(torch.int32) - pdx.view(torch.int32)).abs()
                dx_bits[c] = torch.equal(dx, pdx)
                dx_ulps[c] = {"max": int(ulps.max()),
                              "elements": int((ulps > 0).sum())}
        say("probe", f"{name}: two launches the same bits {same}; dx the "
            f"plain version's bits {dx_bits}, units in the last place "
            f"{dx_ulps}")
        assert same, f"{name}'s sum is not fixed"
        fixed[name] = {"fixed_bits": same, "dx_plain_bits": dx_bits,
                       "dx_plain_ulps": dx_ulps}
    records = []
    for name, (case, kernel) in timed.items():
        ms = device_ms(kernel, [f"{name}_kernel"])[f"{name}_kernel"]
        events = padded_ms(kernel)
        plain_ms = events_ms(cases[case][2], device, 1)
        n = x0.numel()
        t_ops = n * MOSAIC_OPS[name] / PEAK_FP32 * 1e3
        t_bytes = n * MOSAIC_BYTES[name] / PEAK_BYTES * 1e3
        bound, by = max((t_ops, "operations"), (t_bytes, "bytes"),
                        key=lambda t: t[0])
        say("time", f"{name}: {ms:.6f} ms, by CUDA events {events:.6f} ms, "
            f"plain {plain_ms:.4f} ms, bound {bound:.3g} ms ({by}) ({card})")
        extra = fixed.get(name, {})
        if name in lanes:
            extra["lane_ms"] = device_ms(lanes[name], [f"{name}_kernel"])[
                f"{name}_kernel"]
            say("time", f"{name} one lane alone: {extra['lane_ms']:.6f} ms "
                f"({card})")
        if name == "probe_cond":
            extra["empty_ms"] = empty_ms
            extra["ms_1000"] = device_ms(
                cases["cond+1_1000"][1], [f"{name}_kernel"])[f"{name}_kernel"]
            say("time", f"{name} on 1000 elements {extra['ms_1000']:.6f} ms; "
                f"an empty kernel {empty_ms:.6f} ms ({card})")
        records.append({
            "name": name, "route": "cuda",
            "source": "euclider_tpu_torch/csrc/probe_mosaic.cu",
            "replaces": MOSAIC_REPLACES[name], "launches": launches[name],
            "max_abs_err": abs_err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "padded_ms": events, "ms_case": case, "shape": [8, 128],
            "tolerance": {"rtol": MOSAIC_RTOL.get(name, PROBE_RTOL)},
            "card": card, **extra,
            "rel_errs": {c: v for c, v in rel_err.items()
                         if cases[c][0] == name}})
    return records


def probe_tools():
    """The probes' entry points as a user runs them, each a subprocess on
    the card, run together: mosaic_probe (P2-P6 against their plain
    versions) and march_bisect for every stage; each must exit 0 and
    launch every kernel it covers."""
    from euclider_tpu_torch.ops import march_probe as MP

    runs = [("mosaic_probe",)] + [("march_bisect", st) for st in MP.STAGES]
    done = run_together([[sys.executable, "-m",
                          f"euclider_tpu_torch.tools.{args[0]}", *args[1:]]
                         for args in runs])
    last = {}
    for args, (rc, out, err) in zip(runs, done):
        for line in out.splitlines():
            say("probe", f"{' '.join(args)}: {line}")
        assert rc == 0, f"{' '.join(args)}: exit {rc}\n{err[-2000:]}"
        last[args] = json.loads(out.splitlines()[-1])
    launches = last["mosaic_probe",]["launches"]
    assert all(n >= 1 for n in launches.values()) and len(launches) == 5, \
        f"mosaic_probe did not launch every kernel: {launches}"
    for st in MP.STAGES:
        assert last["march_bisect", st]["launches"] == 1, \
            f"march_bisect {st} did not launch probe_march"



# --- phase 10 ----------------------------------------------------------------

SEG_KEYS = ["trace_seg_fwd_kernel", "trace_seg_bwd_kernel",
            "sum_partials_kernel"]


def carry_traffic(static, tables, cam, y0=0, rows=H):
    """Words of boundary carry the segmented kernels move over rows [y0,
    y0 + rows) of the frame on this data, worked out from trace_seg.cu: K6
    stores for every pixel and
    chunk that starts with a nonempty stack the stack pointer and the 11
    words of each slot live at the chunk's start (counted by driving the
    plain version's loop), the 3 colour sums and the count of stored
    chunks; K7 loads the same and the 3 words of g or the target ->
    (stored, loaded)."""
    import torch
    from euclider_tpu_torch.ops import cuda_bwd, trace, vjp
    sizes = vjp.chunk_sizes(static.max_nodes)
    dev = tables.surf_color.device
    yi = torch.arange(y0, y0 + rows, dtype=torch.float32,
                      device=dev)[:, None].expand(rows, W)
    xi = torch.arange(W, dtype=torch.float32,
                      device=dev)[None, :].expand(rows, W)
    org, d = trace.camera_rays(cam, xi, yi, W, H)
    ar, ag, ab, slots, sp = trace.bounce_init(static, tables, org, d)
    live = chunks = 0
    if slots is not None:
        body = trace.make_bounce_body(static, tables)
        carry = (sp, ar, ag, ab, slots)
        for trips in sizes:
            live += int(carry[0].sum())
            chunks += int((carry[0] > 0).sum())
            for _ in range(trips):
                if not bool((carry[0] > 0).any()):
                    break
                carry = body(carry)
    stored = chunks + cuda_bwd.SLOT_WORDS * live + 4 * rows * W
    return stored, stored + 3 * rows * W


def seg_vs_tape(name, device):
    """The scene at 1280x720 through backward='segmented' against the tape
    kernel under the same cotangent and target: every leaf (and the time)
    within SEG_RTOL * max(max |ref|, 1), the fused loss within LOSS_RTOL."""
    from euclider_tpu_torch.ops import cuda_bwd
    static, tables, cam = load(name, device)
    g = seeded((H, W, 3), 0, device)
    target = seeded((H, W, 3), 1, device, "uniform")
    out = {}
    for mode in ("vjp", "fused"):
        if mode == "vjp":
            tape, seg = (cuda_bwd.vjp_cuda(static, tables, cam, H, W, g,
                                           backward=b)
                         for b in ("tape", "segmented"))
            lrel = 0.0
        else:
            (lt, *tape), (ls, *seg) = (cuda_bwd.train_step_cuda(
                static, tables, cam, target, H, W, backward=b)
                for b in ("tape", "segmented"))
            lrel = abs(float(ls) - float(lt)) / float(lt)
        ratio, leaf, err = grads_err(tape[:2], seg[:2], SEG_RTOL)
        t_ratio = abs(float(seg[2]) - float(tape[2])) / (
            SEG_RTOL * max(abs(float(tape[2])), 1.0))
        say("seg", f"{name} {mode}: segmented vs tape kernel, worst leaf "
            f"{leaf} err {err:.4g} = {ratio:.4f} of {SEG_RTOL:g} * "
            f"max(max|ref|, 1); time {t_ratio:.4f}; loss rel {lrel:.2e} "
            f"(limit {LOSS_RTOL:g})")
        assert ratio <= 1.0 and t_ratio <= 1.0, \
            f"{name} {mode}: the segmented kernels disagree with the tape " \
            "kernel"
        assert lrel <= LOSS_RTOL, f"{name}: the segmented fused loss disagrees"
        out[mode] = {"err_over_tol": ratio, "leaf": leaf, "err": err,
                     "loss_rel": lrel}
    return out


def deep_training(device):
    """5 fused training steps on config2_deep through train/inverse.py (the
    trainer's perturbation and fitted tables) -> losses, falling."""
    from euclider_tpu_torch.ops import cuda_kernel
    from euclider_tpu_torch.train import fit
    from euclider_tpu_torch.train.inverse import InverseParams, make_train_step
    static, truth, cam = load("config2_deep", device)
    target = cuda_kernel.render_image_cuda(static, truth, cam, H, W)
    params = InverseParams(fit.perturb(truth), cam)
    step, _ = make_train_step(static, H, W, params, 2e-2, "cuda-fused",
                              fit=dict.fromkeys(fit.FIT))
    losses = [float(step(target)) for _ in range(TRAIN_STEPS)]
    say("seg", f"config2_deep fused (backward auto): losses "
        f"{[round(x, 6) for x in losses]}")
    assert all(x == x and abs(x) != float("inf") for x in losses)
    assert all(b < a for a, b in zip(losses, losses[1:])), \
        "config2_deep: the fused steps did not lower the loss"
    return losses


def seg_times(name, device, card, fwd_ops, bwd_ops):
    """Device times of the segmented kernels on one scene at 1280x720, vjp
    and fused (torch.profiler), K6 and K7 each apart, the times of the
    calls (CUDA events, median of 5 after warm-up; the tape kernel's fused
    call beside them where the tape takes the scene), and each kernel's
    bound, worked out from trace_seg.cu: K6, the larger of the forward's
    operations (``fwd_ops``: it shades every node once) over the FP32 peak
    and the bytes it stores (carry_traffic) over HBM bandwidth; K7, the
    larger of the tape kernel's operations (``bwd_ops``) and the bytes it
    loads; the pair's bound is their sum."""
    from euclider_tpu_torch.ops import cuda_bwd, vjp
    static, tables, cam = load(name, device)
    g = seeded((H, W, 3), 3, device)
    target = seeded((H, W, 3), 2, device, "uniform")
    def vjp_seg():
        return cuda_bwd.vjp_cuda(static, tables, cam, H, W, g,
                                 backward="segmented")

    def step(backward):
        return lambda: cuda_bwd.train_step_cuda(static, tables, cam, target,
                                                H, W, backward=backward)

    vjp_ms = device_ms(vjp_seg, SEG_KEYS)
    fused_ms = device_ms(step("segmented"), SEG_KEYS)
    stored, loaded = carry_traffic(static, tables, cam)
    out = {"vjp_ms": vjp_ms, "fused_ms": fused_ms,
           "vjp_call_events_ms": events_ms(vjp_seg, device),
           "fused_call_events_ms": events_ms(step("segmented"), device),
           "ms": sum(vjp_ms[k] or 0.0 for k in SEG_KEYS),
           "fused_total_ms": sum(fused_ms[k] or 0.0 for k in SEG_KEYS),
           "carry_words_stored": stored, "carry_words_loaded": loaded,
           "chunks": vjp.chunk_sizes(static.max_nodes),
           "k6_plain_ms": events_ms(lambda: vjp.segmented_forward(
               static, tables, cam, H, W), device, 1)}
    for k, ops, words in (("k6", fwd_ops, stored), ("k7", bwd_ops, loaded)):
        t_ops = ops / PEAK_FP32 * 1e3
        t_bytes = 4 * words / PEAK_BYTES * 1e3
        out[f"{k}_bound_ms"] = max(t_ops, t_bytes)
        out[f"{k}_bound_by"] = "bytes" if t_bytes > t_ops else "operations"
    out["bound_ms"] = out["k6_bound_ms"] + out["k7_bound_ms"]
    out["bound_by"] = out["k7_bound_by"]
    if static.max_nodes <= cuda_bwd.MAX_TAPE:
        out["tape_fused_call_events_ms"] = events_ms(step("tape"), device)
    for k, v in out.items():
        say("time", f"{name} segmented {k}: {v}" + (
            f" ({card})" if k.endswith("ms") else ""))
    return out


def seg_phase(device, card, times):
    """Phase 10 -> the record of the segmented kernels."""
    from euclider_tpu_torch.ops import cuda_bwd, cuda_kernel
    from euclider_tpu_torch.ops.cuda_kernel import _check_tables

    # the straight builds on config2, K6's and K7's march builds on config5
    # (its gradients zero almost everywhere) and config5 with smooth
    # surfaces, before phase 10 times them
    tape = {name: seg_vs_tape(name, device)
            for name in (SCENES[1], WARP[0], "config5_smooth")}
    plain = backward_check(SCENES[1], device, backward="segmented",
                           ref_fn="vjp_segmented")
    errs = {name: kernel_vs_plain(name, device) for name in DEEP_SLABS}
    static, tables, _ = load("spheres48", device)
    n_params = cuda_bwd.grad_layout(
        static, _check_tables(static, tables, device))[1] - 1
    say("seg", f"spheres48: {len(static.entities)} entities, {n_params} "
        "parameters")
    assert len(static.entities) > 32 and n_params > 159
    # the main path of this phase: a scene past the tape through the
    # routing a user gets (vjp_cuda and train_step_cuda, backward='auto')
    cuda_kernel.LAUNCHES = cuda_bwd.LAUNCHES = cuda_bwd.SEG_LAUNCHES = 0
    deep = backward_check("config2_deep", device, DEEP_SLABS["config2_deep"],
                          SLAB_ROWS)
    losses = deep_training(device)
    launches = {"trace_fwd": cuda_kernel.LAUNCHES,
                "trace_bwd": cuda_bwd.LAUNCHES,
                "trace_seg": cuda_bwd.SEG_LAUNCHES}
    say("seg", f"launches on config2_deep's path {launches}")
    assert launches["trace_bwd"] == 0 and \
        launches["trace_seg"] >= 1 + TRAIN_STEPS, \
        "config2_deep did not go through the segmented kernels"
    many = backward_check("spheres48", device, DEEP_SLABS["spheres48"],
                          SLAB_ROWS)
    c2 = times[SCENES[1]]
    deep_nodes, steps, marches, hits = march_count(*load("config2_deep",
                                                         device))
    deep_ops = [bound(load("config2_deep", device)[0], int(deep_nodes.sum()),
                      backward, steps, marches, hits)[2]
                for backward in (False, True)]
    say("seg", f"config2_deep: {float(deep_nodes.float().mean()):.2f} nodes "
        f"a pixel, at most {int(deep_nodes.max())}; pixels past 63 nodes "
        f"{int((deep_nodes > 63).sum())}")
    c5 = times[WARP[0]]
    t = {SCENES[1]: seg_times(SCENES[1], device, card, c2["fwd_ops"],
                              c2["bwd_ops"]),
         "config2_deep": seg_times("config2_deep", device, card, *deep_ops),
         # config5 forced onto the segmented path: K6's and K7's march
         # builds
         WARP[0]: seg_times(WARP[0], device, card, c5["fwd_ops"],
                            c5["bwd_ops"])}
    say("time", f"{SCENES[1]} trace_bwd (tape, same run): vjp "
        f"{c2['vjp_device_ms']:.4f}, fused {c2['bwd_device_ms']:.4f} ms "
        f"({card})")
    for name in (SCENES[1], WARP[0]):
        k6 = t[name]["vjp_ms"]["trace_seg_fwd_kernel"]
        say("time", f"{name} segmented: K6 {k6:.4f} ms = "
            f"{k6 / times[name]['fwd_device_ms']:.3f} x trace_fwd's "
            f"{times[name]['fwd_device_ms']:.4f} ms (same run) ({card})")
    return {
        "name": "trace_seg", "route": "cuda",
        "source": "euclider_tpu_torch/csrc/trace_seg.cu",
        "replaces": "euclider_tpu/ops/pallas_kernel.py:433 (K6), :472 (K7)",
        "covers": "K6 (trace_seg_fwd_kernel: the boundary carry of every "
                  "chunk of 16 bounce trips that starts with a nonempty "
                  "stack, and their count) and K7 (trace_seg_bwd_kernel: "
                  "the stored chunks re-run and swept in reverse, one "
                  "launch), both modes, every build; the tape kernel's "
                  "parameter and entity caps lifted (spheres48); "
                  "redesigned for the H100: the virtual entries zeroed only "
                  "where the tree's last chunk needs them, no load of an "
                  "empty chunk, K6's builds that march in warps of 8 x 4 "
                  "pixels under a launch bound of one block an SM, its "
                  "straight builds under one of four",
        "launches": launches["trace_seg"],
        "launches_by_scene": {"config2_deep": launches["trace_seg"]},
        "max_abs_err": plain["vjp_err"],
        "ms": t[SCENES[1]]["ms"], "plain_ms": plain["plain_ms"],
        "bound_ms": t[SCENES[1]]["bound_ms"],
        "bound_by": t[SCENES[1]]["bound_by"], "library_ms": None,
        "k6": {"ms": t[SCENES[1]]["vjp_ms"]["trace_seg_fwd_kernel"],
               "bound_ms": t[SCENES[1]]["k6_bound_ms"],
               "bound_by": t[SCENES[1]]["k6_bound_by"],
               "plain_ms": t[SCENES[1]]["k6_plain_ms"],
               "plain": "ops/vjp.py segmented_forward"},
        "k7": {"ms": t[SCENES[1]]["vjp_ms"]["trace_seg_bwd_kernel"],
               "bound_ms": t[SCENES[1]]["k7_bound_ms"],
               "bound_by": t[SCENES[1]]["k7_bound_by"],
               "plain_ms": plain["plain_ms"],
               "plain": "ops/vjp.py vjp_segmented (its forward carries "
                        "included)"},
        "ptxas": ptxas("trace_seg", "trace_seg_shapes"),
        "ms_scene": SCENES[1], "shape": [H, W, 3],
        "tolerance": {"vs_tape_rtol": SEG_RTOL, "grad_rtol": GRAD_RTOL,
                      "loss_rtol": LOSS_RTOL},
        "card": card, "vs_tape": tape, "vs_plain": plain,
        "path_launches": launches, "config2_deep_losses": losses,
        "scenes": {"config2_deep": dict(deep, **t["config2_deep"],
                                        max_abs_err=errs["config2_deep"][0],
                                        bad_frac=errs["config2_deep"][1]),
                   "spheres48": dict(many, n_params=n_params,
                                     max_abs_err=errs["spheres48"][0],
                                     bad_frac=errs["spheres48"][1]),
                   SCENES[1]: t[SCENES[1]],
                   WARP[0]: dict(t[WARP[0]], forced="backward='segmented'",
                                 trace_fwd_ms=c5["fwd_device_ms"],
                                 vs_tape=tape[WARP[0]],
                                 vs_tape_smooth=tape["config5_smooth"])}}


# --- phase 13 ----------------------------------------------------------------

def limit_kernels(static):
    """The kernels a scene's render and backward take (route)."""
    from euclider_tpu_torch.ops import cuda_bwd
    return ("trace_fwd", "trace_bwd" if cuda_bwd.route(static) == "tape"
            else "trace_seg")


def start_limit_builds():
    """Start building, in a thread, the libraries of phase 13's scenes past
    the default builds, so that nvcc runs beside phases 3-12 -> a function
    that waits for the builds and returns their names (raising what the
    build raised)."""
    import euclider_tpu_torch as et
    from euclider_tpu_torch.ops import cuda_kernel
    names = sorted({cuda_kernel.library(k, static)
                    for static in (et.compile_scene(build_scene(n))[0]
                                   for n in (*LIMIT_SLABS, *DRIFT))
                    for k in limit_kernels(static)} - set(cuda_kernel.SOURCES))
    out = {}

    def run():
        try:
            out["libs"] = cuda_kernel.build(names)
        except BaseException as e:   # re-raised by wait()
            out["error"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def wait():
        thread.join()
        if "error" in out:
            raise out["error"]
        return names

    return wait


def limit_slab(name):
    """(y0, rows): the slab phase 13 differentiates of the scene."""
    return (LIMIT_SLABS.get(name, 300),
            SLAB_ROWS if name in LIMIT_SLABS else DRIFT_ROWS)


def limit_reference(name, out):
    """A reference process of phase 13 (``chip_smoke.py --limit-reference
    NAME OUT``): the plain version's side of one scene, which is
    launch-bound, run beside the other scenes' in processes of their own;
    saved to OUT (torch.save): the frame and its work (counted_render),
    not for a DRIFT scene; on the slab, the count past the old limit, the
    slab's work, the cotangent (seeded, zero where the kernel's and the
    plain forward differ and at seams: backward_check's), vjp_blocked's
    gradient leaves under it and their time; the segmented kernels'
    carry traffic where route takes them."""
    import torch
    from euclider_tpu_torch.ops import cuda_bwd, cuda_kernel, vjp
    from euclider_tpu_torch.tools import limit_scenes as LS
    from euclider_tpu_torch.utils.validate import seams

    device = torch.device("cuda", 0)
    static, tables, cam = load(name, device)
    y0, rows = limit_slab(name)
    rec = {}
    if name in LIMIT_SLABS:
        t0 = time.perf_counter()
        img, nodes, *work = counted_render(static, tables, cam)
        torch.cuda.synchronize()
        rec.update(frame=img.cpu(), frame_work=[int(nodes.sum()), *work],
                   frame_ms=(time.perf_counter() - t0) * 1e3)
        rec["count"] = LS.passed(name, static, tables, cam, H, W, y0, rows)
    else:
        steps = LS.march_lengths(static, tables, cam, H, W, y0, rows)
        rec["count"] = {
            "limit": "march checkpoints", "old": DRIFT[name] // 2,
            "count": int((steps > DRIFT[name] // 2).sum()),
            "what": f"marches longer than {DRIFT[name] // 2} steps",
            "longest": int(steps.max()), "marches": int(steps.numel())}
    plain, nodes, *work = counted_render(static, tables, cam, y0, rows)
    rec["slab_work"] = [int(nodes.sum()), *work]
    k1 = cuda_kernel.render_image_cuda(static, tables, cam, H, W, y0=y0,
                                       rows=rows)
    flips = (k1 - plain).abs().amax(-1) > TOL
    keep = ~(flips | seams(plain, SMOOTH_TAU))
    g = seeded((rows, W, 3), 0, device) * keep[..., None]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    ref = vjp.vjp_blocked(static, tables, cam, H, W, g, y0=y0, rows=rows)
    torch.cuda.synchronize()
    rec.update(g=g.cpu(), flips=int(flips.sum()),
               masked=float((~keep).float().mean()),
               ref=[(k, t.cpu()) for k, t in leaves(*ref[:2])],
               ref_time=float(ref[2]),
               plain_ms=(time.perf_counter() - t0) * 1e3,
               plain_peak_gib=torch.cuda.max_memory_allocated(device)
               / 2 ** 30)
    if cuda_bwd.route(static) == "segmented":
        rec["carry"] = carry_traffic(static, tables, cam, y0, rows)
    torch.save(rec, out)


def limit_references():
    """The reference processes of phase 13, one a scene, each batch of
    LIMIT_BATCHES started together -> {name: record}."""
    import torch
    tmp = os.path.join(ROOT, "euclider_tpu_torch", "build", "limit_refs")
    os.makedirs(tmp, exist_ok=True)
    refs = {}
    for names in LIMIT_BATCHES:
        outs = {n: os.path.join(tmp, f"{n}.pt") for n in names}
        done = run_together([[sys.executable, os.path.abspath(__file__),
                              LIMIT_REFERENCE, n, outs[n]] for n in names],
                            timeout=900)
        for n, (rc, out, err) in zip(names, done):
            assert rc == 0, f"{n}: the reference process failed:\n{out}{err}"
            refs[n] = torch.load(outs[n])
    return refs


def limit_scene(name, ref, device, card):
    """Phase 13 for one scene, against its reference process's record:
    the count past its old limit; the 1280x720 frame through
    euclider_tpu_torch.render_image (K1) by phase 3's rule (not for a DRIFT
    scene); the slab's vjp_cuda by phase 6's rule, through the kernels
    route() picks, and train_step_cuda against trace_fwd + MSE + vjp_cuda
    (backward_check's rules); the launches of this path; then the
    kernels' device times and bounds -> its record."""
    import torch
    import euclider_tpu_torch as et
    from euclider_tpu_torch.ops import cuda_bwd, cuda_kernel
    from euclider_tpu_torch.tools import limit_scenes as LS

    static, tables, cam = load(name, device)
    y0, rows = limit_slab(name)
    fwd_k, bwd_k = limit_kernels(static)
    libs = {k: cuda_kernel.library(k, static) for k in (fwd_k, bwd_k)}
    count = ref["count"]
    more = {k: v for k, v in count.items()
            if k not in ("limit", "old", "count", "what")}
    say("limits", f"{name}: {count['what']}: {count['count']} (old limit "
        f"{count['old']}) on rows {y0}-{y0 + rows - 1} of {W}x{H}; {more}; "
        f"capacities {dict(cuda_kernel.capacities(static))}, libraries "
        f"{libs}, backward {cuda_bwd.route(static)}")
    passed = LS.is_passed(count) if name in LIMIT_SLABS else count["count"] > 0
    assert passed, f"{name}: the slab does not pass the old limit"
    rec = {"libraries": libs, "capacities": dict(cuda_kernel.capacities(
        static)), "route": cuda_bwd.route(static), "passed": count,
        "plain_ms": ref["plain_ms"], "plain_peak_gib": ref["plain_peak_gib"]}
    cuda_kernel.LAUNCHES = cuda_bwd.LAUNCHES = cuda_bwd.SEG_LAUNCHES = 0
    if name in LIMIT_SLABS:
        got = et.render_image(static, tables, cam, H, W)
        torch.cuda.synchronize()
        assert got.shape == (H, W, 3) and bool(torch.isfinite(got).all())
        err = (got - ref["frame"].to(device)).abs().amax(dim=-1)
        rec.update(max_abs_err=float(err.max()),
                   bad_frac=float((err > TOL).float().mean()),
                   plain_frame_ms=ref["frame_ms"])
        say("limits", f"{name}: render_image {W}x{H} (K1) vs plain: "
            f"max_abs_err={rec['max_abs_err']:.3e} bad_frac(>{TOL:g})="
            f"{rec['bad_frac']:.6f} (limit {MAX_BAD:g})")
        assert rec["bad_frac"] <= MAX_BAD, \
            f"{name}: the kernel disagrees with the plain version"
        if LS.LIMIT[name] == "texture side":   # texel addressing: bits
            assert rec["max_abs_err"] == 0.0, \
                f"{name}: the kernel samples other texels than plain"
    g = ref["g"].to(device)
    got = cuda_bwd.vjp_cuda(static, tables, cam, H, W, g, y0=y0, rows=rows)
    worst = (0.0, "", 0.0)
    for (k, a), (_, b) in zip(ref["ref"], leaves(*got[:2])):
        a = a.to(device)
        e = float((a.double() - b.double()).abs().max())
        tol = GRAD_RTOL * max(float(a.abs().max()), 1.0)
        worst = max(worst, (e / tol, k, e))
        if k.startswith("mat_warp") and static.has_warp:
            say("limits", f"{name}: {k} max|ref| {float(a.abs().max()):.4g}"
                f" err {e:.4g} = {e / tol:.4f} of its tolerance")
            rec[f"{k}_err_over_tol"] = e / tol
            if name in DRIFT:
                assert float(a.abs().max()) > 0, f"{name}: {k} is zero"
    t_ratio = abs(float(got[2]) - ref["ref_time"]) / (
        GRAD_RTOL * max(abs(ref["ref_time"]), 1.0))
    rec.update(vjp_err_over_tol=worst[0], vjp_leaf=worst[1],
               vjp_err=worst[2], time_err_over_tol=t_ratio,
               masked_frac=ref["masked"])
    say("limits", f"{name}: vjp_cuda vs vjp_blocked on rows {y0}-"
        f"{y0 + rows - 1}, cotangent zero on {ref['masked']:.4f} of pixels "
        f"({ref['flips']} branch flips + seams): worst leaf {worst[1]} err "
        f"{worst[2]:.4g} = {worst[0]:.4f} of its tolerance; time "
        f"{t_ratio:.4f}; plain backward {ref['plain_ms']:.1f} ms, peak "
        f"{ref['plain_peak_gib']:.2f} GiB (beside the other scenes' "
        "reference processes)")
    assert worst[0] <= 1.0 and t_ratio <= 1.0, \
        f"{name}: vjp_cuda disagrees with the plain backward"
    target = seeded((rows, W, 3), 1, device, "uniform")
    loss, gt, gc, _ = cuda_bwd.train_step_cuda(
        static, tables, cam, target, H, W, y0=y0, rows=rows,
        norm=1.0 / (rows * W * 3))
    k1 = cuda_kernel.render_image_cuda(static, tables, cam, H, W, y0=y0,
                                       rows=rows)
    ref_loss = torch.mean((k1 - target) ** 2)
    ref2 = cuda_bwd.vjp_cuda(static, tables, cam, H, W,
                             2.0 * (k1 - target) / k1.numel(), y0=y0,
                             rows=rows)
    torch.cuda.synchronize()
    lrel = abs(float(loss) - float(ref_loss)) / float(ref_loss)
    ratio2, leaf2, _ = grads_err(ref2[:2], (gt, gc))
    rec.update(fused_loss_rel=lrel, fused_err_over_tol=ratio2)
    say("limits", f"{name}: train_step_cuda vs trace_fwd + MSE + vjp_cuda: "
        f"loss rel {lrel:.2e} (limit {LOSS_RTOL:g}); worst leaf {leaf2} = "
        f"{ratio2:.3f} of its tolerance")
    assert lrel <= LOSS_RTOL and ratio2 <= 1.0, \
        f"{name}: the fused step disagrees"
    rec["launches"] = {"trace_fwd": cuda_kernel.LAUNCHES,
                       "trace_bwd": cuda_bwd.LAUNCHES,
                       "trace_seg": cuda_bwd.SEG_LAUNCHES}
    say("limits", f"{name}: launches on this path {rec['launches']}")
    assert rec["launches"][fwd_k] >= 1 and rec["launches"][bwd_k] >= 3, \
        f"{name}: a kernel of its path was not launched"
    assert rec["launches"][{"trace_bwd": "trace_seg",
                            "trace_seg": "trace_bwd"}[bwd_k]] == 0

    # device times and bounds, after the path's launches were read
    keys = ["trace_bwd_kernel"] if bwd_k == "trace_bwd" else SEG_KEYS
    dev = device_ms(lambda: cuda_bwd.vjp_cuda(static, tables, cam, H, W, g,
                                              y0=y0, rows=rows), keys)
    rec["bwd_device_ms"] = sum(v or 0.0 for v in dev.values())
    rec["bwd_device_ms_by_kernel"] = dev
    tex_bytes = 4 * sum(t.numel() for t in tables.textures)
    nodes, steps, marches, hits = ref["slab_work"]
    rec["bwd_bound_ms"], rec["bwd_bound_by"], ops = bound(
        static, nodes, True, steps, marches, hits, tex_bytes, rows * W)
    if bwd_k == "trace_seg":
        # K6 and K7: each the larger of its operations (the forward's half
        # of the backward's count, and all of it) and its carry's bytes
        stored, loaded = ref["carry"]
        k6 = max(ops / 2 / PEAK_FP32, 4 * stored / PEAK_BYTES) * 1e3
        k7 = max(ops / PEAK_FP32, 4 * loaded / PEAK_BYTES) * 1e3
        rec["bwd_bound_ms"] = k6 + k7
    if name in LIMIT_SLABS:
        rec["fwd_device_ms"] = device_ms(
            lambda: cuda_kernel.render_image_cuda(static, tables, cam, H, W),
            ["trace_fwd_kernel"])["trace_fwd_kernel"]
        nodes, steps, marches, hits = ref["frame_work"]
        rec["fwd_bound_ms"], rec["fwd_bound_by"], _ = bound(
            static, nodes, False, steps, marches, hits, tex_bytes)
        say("time", f"{name} trace_fwd ({libs[fwd_k]}) {W}x{H}: "
            f"{rec['fwd_device_ms']:.4f} ms, bound {rec['fwd_bound_ms']:.4f}"
            f" ms ({rec['fwd_bound_by']}), plain {rec['plain_frame_ms']:.1f}"
            f" ms ({card})")
    say("time", f"{name} {bwd_k} ({libs[bwd_k]}) vjp of rows {y0}-"
        f"{y0 + rows - 1}: {rec['bwd_device_ms']:.4f} ms {dev}, bound "
        f"{rec['bwd_bound_ms']:.4f} ms, plain {ref['plain_ms']:.1f} ms "
        f"({card})")
    return rec


def fine_training(device, card):
    """One fused training step of config5_fine at 1280x720 through
    train/inverse.py (make_fused_value_and_grad 'cuda-fused'): a finite
    loss and gradients, trace_bwd launched once -> its record."""
    import torch
    from euclider_tpu_torch.ops import cuda_bwd, cuda_kernel
    from euclider_tpu_torch.train.inverse import (InverseParams,
                                                  make_fused_value_and_grad)
    static, tables, cam = load("config5_fine", device)
    target = seeded((H, W, 3), 9, device, "uniform")
    step = make_fused_value_and_grad(static, H, W, "cuda-fused")
    params = InverseParams(tables, cam)
    cuda_kernel.LAUNCHES = cuda_bwd.LAUNCHES = cuda_bwd.SEG_LAUNCHES = 0
    loss, grads = step(params, target)
    torch.cuda.synchronize()
    launches = {"trace_fwd": cuda_kernel.LAUNCHES,
                "trace_bwd": cuda_bwd.LAUNCHES,
                "trace_seg": cuda_bwd.SEG_LAUNCHES}
    finite = all(bool(torch.isfinite(t).all())
                 for _, t in leaves(grads.tables, grads.cam))
    ms = events_ms(lambda: step(params, target), device)
    say("limits", f"config5_fine: one fused training step at {W}x{H}: loss "
        f"{float(loss):.6f}, gradients finite {finite}, launches "
        f"{launches}; {ms:.3f} ms a step ({card})")
    assert launches == {"trace_fwd": 0, "trace_bwd": 1, "trace_seg": 0}
    assert finite and float(loss) == float(loss)
    return {"loss": float(loss), "launches": launches, "step_ms": ms}


def limits_phase(device, card, wait_builds):
    """Phase 13 -> {scene: record}, the training step's, the wide builds'
    ptxas lines and the launches of the phase's path."""
    from euclider_tpu_torch.ops import cuda_kernel
    t0 = time.perf_counter()
    libs = wait_builds()
    say("limits", f"wider builds {libs} ready "
        f"{time.perf_counter() - t0:.1f} s after the phase began")
    for lib in libs:
        for line in cuda_kernel.PTXAS.get(lib, []):
            say("build", f"{lib}: {line}")
    names = (*LIMIT_SLABS, *DRIFT)
    assert sorted(names) == sorted(sum(LIMIT_BATCHES, ()))
    t1 = time.perf_counter()
    refs = limit_references()
    say("limits", f"the plain references of {len(names)} scenes, one "
        f"process each in {len(LIMIT_BATCHES)} batches: "
        f"{time.perf_counter() - t1:.1f} s")
    out = {name: limit_scene(name, refs[name], device, card)
           for name in names}
    training = fine_training(device, card)
    launches = {k: sum(r["launches"][k] for r in out.values())
                + training["launches"][k]
                for k in ("trace_fwd", "trace_bwd", "trace_seg")}
    say("limits", f"launches on the limits path {launches}; phase 13 took "
        f"{time.perf_counter() - t0:.1f} s")
    return {"scenes": out, "training": training, "launches": launches,
            "ptxas": ptxas(*libs)}


# --- phase 14 ----------------------------------------------------------------

def as_float64(tables, cam):
    """The tables (textures too) and the camera cast to float64."""
    return (tables._replace(**{k: v.double() for k, v in tables._asdict()
                               .items() if k != "textures"},
                            textures=tuple(t.double()
                                           for t in tables.textures)),
            type(cam)(*(v.double() for v in cam)))


def diff_grads(static, tables, cam, g):
    """render_image_diff of leaves made from (tables, cam), differentiated
    by autograd under g -> (the frame, (d_tables, d_cam))."""
    import torch
    from euclider_tpu_torch.ops.cuda_bwd import render_image_diff
    from euclider_tpu_torch.ops.cuda_kernel import FLOAT_FIELDS
    tl = [getattr(tables, k).clone().requires_grad_(True)
          for k in FLOAT_FIELDS]
    texs = [t.clone().requires_grad_(True) for t in tables.textures]
    cl = [v.clone().requires_grad_(True) for v in cam]
    img = render_image_diff(
        static, tables._replace(**dict(zip(FLOAT_FIELDS, tl)),
                                textures=tuple(texs)), type(cam)(*cl), H, W)
    gs = torch.autograd.grad(img, tl + texs + cl, g, allow_unused=True)
    gs = [torch.zeros_like(x) if d is None else d
          for x, d in zip(tl + texs + cl, gs)]
    n, m = len(FLOAT_FIELDS), len(texs)
    return img.detach(), (tables._replace(**dict(zip(FLOAT_FIELDS, gs[:n])),
                                          textures=tuple(gs[n:n + m])),
                          type(cam)(*gs[n + m:]))


def float32_run(got, ref):
    """Gradients of float64 primals (got) against the float32 run's (ref),
    (d_tables, d_cam) each: every leaf float64; the texels' (summed by
    atomicAdd in no fixed order) by phase 6's rule, every other leaf the
    float32 run's bits -> (all float64, other leaves' bits, the texels'
    worst ratio to their tolerance)."""
    import torch
    f64, same, tex = True, True, 0.0
    for (k, a), (_, b) in zip(leaves(*got), leaves(*ref)):
        f64 &= a.dtype == torch.float64
        if k.startswith("textures"):
            e = float((a - b.double()).abs().max())
            tex = max(tex, e / (GRAD_RTOL * max(float(b.abs().max()), 1.0)))
        else:
            same &= torch.equal(a, b.double())
    return f64, same, tex


def dtype_scene(name, device):
    """Phase 14 for one scene -> (its record, its launches)."""
    import torch
    import euclider_tpu_torch as et
    from euclider_tpu_torch.ops import cuda_bwd, cuda_kernel
    static, t32, c32 = load(name, device)
    t64, c64 = as_float64(t32, c32)
    floats = cuda_kernel._check_tables(static, t32, device)
    assert cuda_bwd.grad_layout(static, floats)[1] <= 160, \
        "entries past MAX_PARAMS are summed by atomics"
    time64 = torch.tensor(0.0, dtype=torch.float64, device=device)
    g = seeded((H, W, 3), 14, device)
    target = seeded((H, W, 3), 15, device, "uniform")
    # the float32 runs first: their launches do not count
    frame = cuda_kernel.render_image_cuda(static, t32, c32, H, W)
    vjp32 = cuda_bwd.vjp_cuda(static, t32, c32, H, W, g)
    step32 = cuda_bwd.train_step_cuda(static, t32, c32, target, H, W)
    diff32 = diff_grads(static, t32, c32, g)
    torch.cuda.synchronize()
    cuda_kernel.LAUNCHES = cuda_bwd.LAUNCHES = cuda_bwd.SEG_LAUNCHES = 0
    got = et.render_image(static, t64, c64, H, W)
    mixed = cuda_kernel.render_image_cuda(static, t32, c64, H, W)
    vjp64 = cuda_bwd.vjp_cuda(static, t64, c64, H, W, g, time=time64)
    step64 = cuda_bwd.train_step_cuda(static, t64, c64, target.double(), H,
                                      W, time=time64)
    diff64 = diff_grads(static, t64, c64, g)
    torch.cuda.synchronize()
    launches = {"trace_fwd": cuda_kernel.LAUNCHES,
                "trace_bwd": cuda_bwd.LAUNCHES,
                "trace_seg": cuda_bwd.SEG_LAUNCHES}
    rec = {"frame_bits": got.dtype == torch.float32
           and torch.equal(got, frame),
           "frame_max_abs_err": float((got - frame).abs().max()),
           "camera64_bits": torch.equal(mixed, frame),
           "diff_frame_bits": torch.equal(diff64[0], diff32[0]),
           "loss_bits": step64[0].dtype == torch.float32
           and torch.equal(step64[0], step32[0]),
           "time_grad_dtype": str(vjp64[2].dtype).split(".")[-1],
           "launches": launches}
    for path, a, b in (("vjp", vjp64[:2], vjp32[:2]),
                       ("fused", step64[1:3], step32[1:3]),
                       ("autograd", diff64[1], diff32[1])):
        f64, same, tex = float32_run(a, b)
        rec[path] = {"float64": f64, "bits": same, "texels_over_tol": tex}
    say("dtype", f"{name} at {W}x{H}: float64 tables and camera through "
        f"render_image: the float32 frame's bits {rec['frame_bits']} "
        f"(max_abs_err {rec['frame_max_abs_err']:.3e}); float64 camera "
        f"alone {rec['camera64_bits']}; render_image_diff's frame "
        f"{rec['diff_frame_bits']}; fused loss {rec['loss_bits']}; "
        f"gradients (float64, the float32 run's bits outside the texels, "
        f"the texels' worst / tolerance): vjp {rec['vjp']}, fused "
        f"{rec['fused']}, autograd {rec['autograd']}; d_time "
        f"{rec['time_grad_dtype']}; launches {launches}")
    ok = (rec["frame_bits"] and rec["camera64_bits"]
          and rec["diff_frame_bits"] and rec["loss_bits"]
          and rec["time_grad_dtype"] == "float64"
          and all(rec[p]["float64"] and rec[p]["bits"]
                  and rec[p]["texels_over_tol"] <= 1.0
                  for p in ("vjp", "fused", "autograd")))
    assert ok, f"{name}: float64 inputs are not the float32 run"
    assert launches["trace_fwd"] >= 3 and launches["trace_bwd"] >= 3 and \
        launches["trace_seg"] == 0, f"{name}: {launches}"
    return rec, launches


def host_ms(fn, n=200, warm=20):
    """Median host time of fn alone (ms), each call after a synchronise."""
    import torch
    for _ in range(warm):
        fn()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def cast_cost(device, card):
    """The float64 cast's host cost on grad_probe at 1280x720: a frame
    (render_image_cuda) and a fused step (train_step_cuda) of float32 and
    of float64 inputs (CUDA events, median of 5, turns float32, float64,
    float64, float32), and the wrapper's table check and camera row alone
    (host clock, median of 200) -> its record."""
    from euclider_tpu_torch.ops import cuda_bwd, cuda_kernel
    static, t32, c32 = load(DTYPE_SCENES[0], device)
    t64, c64 = as_float64(t32, c32)
    target = seeded((H, W, 3), 15, device, "uniform")
    inputs = {"float32": (t32, c32), "float64": (t64, c64)}
    calls = {
        "frame": lambda t, c: cuda_kernel.render_image_cuda(static, t, c, H,
                                                            W),
        "fused_step": lambda t, c: cuda_bwd.train_step_cuda(
            static, t, c, target, H, W),
        "check_tables": lambda t, c: cuda_kernel._check_tables(static, t,
                                                               device),
        "pack_camera": lambda t, c: cuda_kernel._pack_camera(c, 0.0, 0,
                                                             device)}
    out = {}
    for call, fn in calls.items():
        timer = ((lambda f: events_ms(f, device))
                 if call in ("frame", "fused_step") else host_ms)
        got = {"float32": [], "float64": []}
        for dt in ("float32", "float64", "float64", "float32"):
            got[dt].append(timer(lambda: fn(*inputs[dt])))
        out[call] = got
        say("time", f"{DTYPE_SCENES[0]} {call} at {W}x{H}, ms, float32 / "
            f"float64 (two turns; "
            f"{'CUDA events' if timer is not host_ms else 'host clock'}): "
            f"{got['float32'][0]:.4f} / {got['float64'][0]:.4f}, "
            f"{got['float32'][1]:.4f} / {got['float64'][1]:.4f} ({card})")
    return out


def dtype_phase(device, card):
    """Phase 14 -> {scene: record}, its launches and the cast's cost."""
    out, launches = {}, {"trace_fwd": 0, "trace_bwd": 0, "trace_seg": 0}
    for name in DTYPE_SCENES:
        out[name], n = dtype_scene(name, device)
        launches = {k: launches[k] + n[k] for k in launches}
    say("dtype", f"launches on the dtype path {launches}")
    return {"scenes": out, "launches": launches,
            "cast_cost": cast_cost(device, card)}


# --- phase 11 ----------------------------------------------------------------

VIEWER_SCENES = ("config1_sphere_room", "config5_warp_portal")
VIEWER_FRAMES = 20
VIEWER_STEADY = 5         # frames past the loop's start: its steady state
ORBIT_FRAMES = 4
# a scripted session: keys at some frames (script(sim, i) runs before
# step(i)), a mouse move every fourth
VIEWER_KEYS = {2: "ww", 6: "l", 9: "ik", 12: "a", 15: "jj", 18: "s"}


def viewer_script(sim, i):
    if i in VIEWER_KEYS:
        sim.handle_keys(VIEWER_KEYS[i])
    if i % 4 == 3:
        sim.mouse_look(2, -1)


def viewer_frames(name, device, card, fwd_ms):
    """One scripted Simulation.run of VIEWER_FRAMES frames through the
    kernel at 1280x720: trace_fwd launched once a frame, nothing
    synchronising the device on the way (torch's sync debug mode), the
    flushed frame the bits of render_image_cuda at the final camera, the
    frames before and after the first move different; then its steady
    ms a frame beside one render_image_cuda and one synchronous render
    plus .cpu() (CUDA events and the host's clock), the frame's copy into
    pinned host memory alone and a step's host work alone."""
    import warnings

    import numpy as np
    import torch
    from euclider_tpu_torch.ops import cuda_kernel
    from euclider_tpu_torch.scene.compile import camera_to_torch
    from euclider_tpu_torch.viewer.simulation import Simulation

    kept = {}
    sim = Simulation(build_scene(name), H, W, backend="cuda", device=device,
                     on_frame=lambda img, i: kept.update({i: img.copy()})
                     if i in (1, 4) else None)
    torch.cuda.synchronize()
    cuda_kernel.LAUNCHES = 0
    with warnings.catch_warnings(record=True) as syncs:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            last = sim.run(VIEWER_FRAMES, viewer_script)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    launches = cuda_kernel.LAUNCHES
    syncs = [str(w.message) for w in syncs
             if "called a synchronizing" in str(w.message)]
    say("viewer", f"{name}: Simulation.run({VIEWER_FRAMES}) launched "
        f"trace_fwd {launches} times; synchronising calls on the way: "
        f"{len(syncs)} {syncs[:2]}")
    assert launches == VIEWER_FRAMES, "a viewer frame skipped the kernel"
    assert not syncs, "the viewer's frame loop synchronised the device"
    static, tables = sim.static, sim.tables
    cam = camera_to_torch(sim.cam, device)
    ref = cuda_kernel.render_image_cuda(static, tables, cam, H, W)
    ref = ref.cpu().numpy()
    same = last.shape == (H, W, 3) and np.array_equal(last, ref)
    moved = float(np.abs(kept[4] - kept[1]).max())
    say("viewer", f"{name}: the flushed frame is render_image_cuda's at the "
        f"final camera to the bit: {same}; frames 0 and 3 (before and after "
        f"the first move) differ by up to {moved:.4f}")
    assert same, "the viewer's last frame is not the kernel's render"
    assert moved > 1e-3, "the camera's move did not change the frame"

    steady = sim.frame_times[VIEWER_STEADY:]
    frame_ms = statistics.median(steady) * 1e3
    # a step's host work alone: each step after a synchronise, so the
    # frame it returns is already on the host
    idle = []
    for i in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.step(i)
        idle.append((time.perf_counter() - t0) * 1e3)
    sim.flush()
    step_host_ms = statistics.median(idle)

    def render():
        return cuda_kernel.render_image_cuda(static, tables, cam, H, W)

    def render_and_copy():
        return render().cpu()

    frame = render()
    pinned = torch.empty(frame.shape, dtype=frame.dtype, pin_memory=True)
    render_ms = events_ms(render, device)
    copy_ms = events_ms(lambda: pinned.copy_(frame, non_blocking=True),
                        device)
    sync_ms = events_ms(render_and_copy, device)
    host = []
    for _ in range(10):
        t0 = time.perf_counter()
        render_and_copy()
        host.append((time.perf_counter() - t0) * 1e3)
    sync_host_ms = statistics.median(host)
    out = {"frames": VIEWER_FRAMES, "launches": launches,
           "frame_ms": frame_ms, "frame_ms_min": min(steady) * 1e3,
           "frame_ms_max": max(steady) * 1e3, "fps": sim.fps,
           "steady_fps": 1e3 / frame_ms, "render_ms": render_ms,
           "copy_ms": copy_ms, "step_host_ms": step_host_ms,
           "trace_fwd_ms": fwd_ms, "sync_render_copy_ms": sync_ms,
           "sync_render_copy_host_ms": sync_host_ms,
           "frame_bytes": H * W * 3 * 4, "bits_equal": same,
           "moved_max_abs": moved}
    say("time", f"viewer {name}: {frame_ms:.4f} ms a frame (median of "
        f"frames {VIEWER_STEADY}-{VIEWER_FRAMES - 1}, host clock; "
        f"{out['frame_ms_min']:.4f}-{out['frame_ms_max']:.4f}), "
        f"{out['steady_fps']:.1f} fps steady, {sim.fps:.1f} fps over the "
        f"run; a step's host work alone {step_host_ms:.4f} ms; one "
        f"render_image_cuda {render_ms:.4f} ms (CUDA events), "
        f"trace_fwd {fwd_ms:.4f} ms; the frame's copy into pinned host "
        f"memory {copy_ms:.4f} ms; a synchronous render + .cpu() "
        f"{sync_ms:.4f} ms (CUDA events), {sync_host_ms:.4f} ms (host "
        f"clock) ({card})")
    return out


def viewer_cli(tmp):
    """The CLI's new paths as subprocesses, run together: --animate,
    --view (stdin not a tty), --time with --profile-dir (the trace must
    hold a trace_fwd launch), --backend numpy and --backend oracle at a
    small size; each must exit 0."""
    base = [sys.executable, "-m", "euclider_tpu_torch", "--scene",
            VIEWER_SCENES[0]]
    full = ["--size", f"{W}x{H}"]
    prof = os.path.join(tmp, "prof")
    runs = {
        "animate": base + full + ["--backend", "cuda", "--animate", "3",
                                  "--out", os.path.join(tmp, "anim.png")],
        "view": base + full + ["--backend", "cuda", "--view",
                               "--view-frames", "3"],
        "time": base + full + ["--backend", "cuda", "--time",
                               "--time-frames", "20", "--profile-dir", prof,
                               "--out", os.path.join(tmp, "timed.png")],
        "numpy": base + ["--size", "32x24", "--backend", "numpy", "--out",
                         os.path.join(tmp, "numpy.png")],
        "oracle": base + ["--size", "64x48", "--backend", "oracle", "--out",
                          os.path.join(tmp, "oracle.png")]}
    done = run_together(list(runs.values()))
    for (what, cmd), (rc, out, err) in zip(runs.items(), done):
        tail = out.strip().splitlines()[-1] if out.strip() else ""
        say("viewer", f"CLI {' '.join(cmd[3:])}: exit {rc}; {tail[-160:]}")
        assert rc == 0, f"CLI {what} failed:\n{out[-2000:]}{err[-2000:]}"
    anim = sorted(f for f in os.listdir(tmp) if f.startswith("anim_"))
    assert anim == [f"anim_{i:04d}.png" for i in range(3)], anim
    time_out = done[list(runs).index("time")][1]
    rec = json.loads([ln for ln in time_out.splitlines()
                      if ln.startswith("{")][-1])
    assert rec["frames"] == 20 and rec["mrays_per_s"] > 0, rec
    traces = [f for f in os.listdir(prof) if f.endswith(".pt.trace.json")]
    assert len(traces) == 1, traces
    with open(os.path.join(prof, traces[0])) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"
               and "trace_fwd" in e.get("name", "")]
    say("viewer", f"CLI --time --profile-dir: {traces[0]} holds "
        f"{len(kernels)} trace_fwd launches; RenderMeter {rec}")
    assert kernels, "the profile trace holds no trace_fwd launch"
    return {"time_record": rec, "trace_fwd_in_trace": len(kernels)}


def viewer_check(device, card, times):
    """Phase 11: the viewer slice at 1280x720 -> {scene: the frame loop's
    record}, its launches of trace_fwd and the CLI's record."""
    import tempfile

    from euclider_tpu_torch.ops import cuda_kernel
    from euclider_tpu_torch.viewer.simulation import render_orbit

    out = {name: viewer_frames(name, device, card,
                               times[name]["fwd_device_ms"])
           for name in VIEWER_SCENES}
    with tempfile.TemporaryDirectory() as tmp:
        before = cuda_kernel.LAUNCHES
        paths = render_orbit(build_scene(VIEWER_SCENES[0]), H, W,
                             ORBIT_FRAMES, os.path.join(tmp, "orbit.png"),
                             backend="cuda", device=device)
        orbit = cuda_kernel.LAUNCHES - before
        assert len(paths) == ORBIT_FRAMES and orbit == ORBIT_FRAMES
        assert all(os.path.getsize(p) > 1000 for p in paths)
        say("viewer", f"render_orbit wrote {len(paths)} PNGs, trace_fwd "
            f"launched {orbit} times")
        cli = viewer_cli(tmp)
    return out, {name: rec["launches"] for name, rec in out.items()}, cli


# --- phase 12 ----------------------------------------------------------------

DIST_RENDER = ("config1_sphere_room", "config2_mirror_glass",
               "config5_warp_portal", "config6_expr_space")
DIST_TRAIN = ("grad_probe", "config5_warp_portal")
DIST_TAX = ("config1_sphere_room", "grad_probe")


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def same_bits(a, b):
    """Whether two trees of tensors hold the same leaves to the bit."""
    import torch
    from euclider_tpu_torch.utils.tree import leaves
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def unfused_reference(static, params, target):
    """render_image_diff, the MSE and autograd of every leaf, unsharded ->
    (loss, InverseParams of the gradients)."""
    import torch
    from euclider_tpu_torch.ops.cuda_bwd import render_image_diff
    from euclider_tpu_torch.utils.tree import leaves, unflatten
    xs = [t.detach().clone().requires_grad_(True) for t in leaves(params)]
    p = unflatten(params, xs)
    loss = torch.mean((render_image_diff(static, p.tables, p.cam, H, W)
                       - target) ** 2)
    gs = torch.autograd.grad(loss, xs, allow_unused=True)
    return loss.detach(), unflatten(params, [
        torch.zeros_like(x) if g is None else g for x, g in zip(xs, gs)])


def dist_sharded(device):
    """Phase 12 in this process, a process group of one rank over NCCL: the
    sharded render, gather and fused and unfused value and grad against
    their unsharded counterparts, to the bit -> (record, launches on the
    sharded path)."""
    import torch
    import torch.distributed as dist
    from euclider_tpu_torch.ops import cuda_bwd, cuda_kernel
    from euclider_tpu_torch.parallel import distributed as D
    from euclider_tpu_torch.parallel.mesh import (gather_frame, make_mesh,
                                                  render_image_sharded)
    from euclider_tpu_torch.train.inverse import (InverseParams,
                                                  make_fused_value_and_grad,
                                                  shard_target)
    assert D.initialize("cuda", f"tcp://127.0.0.1:{free_port()}", 1, 0)
    try:
        assert dist.get_backend() == "nccl" and D.process_info() == (0, 1)
        mesh = make_mesh()
        scenes = {n: load(n, device) for n in DIST_RENDER + DIST_TRAIN}
        target = seeded((H, W, 3), 12, device, "uniform")
        # the unsharded counterparts first: their launches do not count
        frames = {n: cuda_kernel.render_image_cuda(*scenes[n], H, W)
                  for n in DIST_RENDER}
        fused_ref = {n: cuda_bwd.train_step_cuda(*scenes[n], target, H, W)
                     for n in DIST_TRAIN}
        unfused_ref = {n: unfused_reference(
            scenes[n][0], InverseParams(*scenes[n][1:]), target)
            for n in DIST_TRAIN}
        torch.cuda.synchronize()
        cuda_kernel.LAUNCHES = cuda_bwd.LAUNCHES = 0
        slabs = {n: render_image_sharded(*scenes[n], H, W, mesh)
                 for n in DIST_RENDER}
        gathered = {n: gather_frame(s, mesh) for n, s in slabs.items()}
        hosts = {n: D.host_gather_image(s, mesh) for n, s in slabs.items()}
        tgt = shard_target(target, mesh)
        fused = {n: make_fused_value_and_grad(
            scenes[n][0], H, W, "cuda-fused", mesh)(
                InverseParams(*scenes[n][1:]), tgt) for n in DIST_TRAIN}
        unfused = {n: make_fused_value_and_grad(
            scenes[n][0], H, W, "cuda", mesh)(
                InverseParams(*scenes[n][1:]), tgt) for n in DIST_TRAIN}
        torch.cuda.synchronize()
        launches = {"trace_fwd": cuda_kernel.LAUNCHES,
                    "trace_bwd": cuda_bwd.LAUNCHES}
        rec = {"render": {}, "fused": {}, "unfused": {},
               "launches": launches}
        for n in DIST_RENDER:
            ref = frames[n]
            rec["render"][n] = bits = (
                torch.equal(slabs[n], ref) and torch.equal(gathered[n], ref)
                and bool((hosts[n] == ref.cpu().numpy()).all()))
            say("dist", f"{n}: render_image_sharded, gather_frame and "
                f"host_gather_image at world size 1 over NCCL are "
                f"render_image_cuda's bits: {bits}")
        for n in DIST_TRAIN:
            loss, gt, gc, _ = fused_ref[n]
            rec["fused"][n] = bits = same_bits(fused[n], (loss, (gt, gc)))
            say("dist", f"{n}: sharded cuda-fused loss "
                f"{float(fused[n][0]):.6f} and gradients are "
                f"train_step_cuda's bits: {bits}")
            rec["unfused"][n] = bits = same_bits(unfused[n], unfused_ref[n])
            say("dist", f"{n}: sharded cuda loss {float(unfused[n][0]):.6f} "
                f"and gradients are render_image_diff + autograd's bits: "
                f"{bits}")
        say("dist", f"launches on the sharded path: {launches}")
        assert all(all(v.values()) for k, v in rec.items()
                   if k != "launches"), "sharded and unsharded differ"
        assert launches["trace_fwd"] >= len(DIST_RENDER) + len(DIST_TRAIN)
        assert launches["trace_bwd"] >= 2 * len(DIST_TRAIN)
        rec["tax"] = sharding_tax(scenes, target, mesh, device)
    finally:
        dist.destroy_process_group()
    return rec, launches


def sharding_tax(scenes, target, mesh, device):
    """ms of the sharded render + gather and fused step at world size 1
    beside the unsharded ones (CUDA events, median of 5 after warm-up), in
    turns unsharded, sharded, sharded, unsharded."""
    from euclider_tpu_torch.ops.cuda_kernel import render_image_cuda
    from euclider_tpu_torch.parallel.mesh import (gather_frame,
                                                  render_image_sharded)
    from euclider_tpu_torch.train.inverse import (InverseParams,
                                                  make_fused_value_and_grad)
    out = {}
    for n in DIST_TAX:
        static, tables, cam = scenes[n]
        params = InverseParams(tables, cam)
        calls = {
            "render": lambda: render_image_cuda(static, tables, cam, H, W),
            "render_sharded": lambda: gather_frame(render_image_sharded(
                static, tables, cam, H, W, mesh), mesh),
            "fused_step": lambda vg=make_fused_value_and_grad(
                static, H, W, "cuda-fused"): vg(params, target),
            "fused_step_sharded": lambda vg=make_fused_value_and_grad(
                static, H, W, "cuda-fused", mesh): vg(params, target)}
        got = {k: [] for k in calls}
        for k in ("render", "render_sharded", "render_sharded", "render",
                  "fused_step", "fused_step_sharded", "fused_step_sharded",
                  "fused_step"):
            got[k].append(events_ms(calls[k], device))
        out[n] = got
        say("dist", f"{n} sharding tax at world size 1, ms (two turns): "
            + ", ".join(f"{k} {v[0]:.4f} / {v[1]:.4f}"
                        for k, v in got.items()))
    return out


def dist_processes(device, fit_params, tmp):
    """Phase 12's torchrun runs, one rank each, together: the trainer on
    grad_probe (120 fused steps, its checkpoint) and dist_check on every
    case at 1280x720, each checked against this process's unsharded
    calls (``fit_params``: the trainer's parameters in this process)."""
    import numpy as np
    import torch
    from euclider_tpu_torch.ops import cuda_bwd, cuda_kernel
    from euclider_tpu_torch.tools.dist_check import CASES, named, problem
    from euclider_tpu_torch.train.inverse import InverseParams
    from euclider_tpu_torch.utils import checkpointing

    run = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "1", "-m"]
    ckpt = os.path.join(tmp, "fit")
    (rc, out, err), (rc2, out2, err2) = run_together([
        run + ["euclider_tpu_torch.train.fit", "--scene", "grad_probe",
               "--steps", str(EXAMPLE_STEPS), "--checkpoint", ckpt],
        run + ["euclider_tpu_torch.tools.dist_check", "--device", "cuda",
               "--size", f"{W}x{H}", "--out", tmp]], timeout=600)
    assert rc == 0, f"the torchrun trainer failed:\n{out}{err}"
    assert rc2 == 0, f"dist_check failed:\n{out2}{err2}"
    lines = out.splitlines()
    say("dist", "torchrun trainer: " + " | ".join(
        l for l in lines if not l.startswith("step ")))
    launches = next(l for l in lines if l.startswith("kernel launches"))
    restored = checkpointing.restore(ckpt, fit_params)
    trainer = {
        "recovered": "(recovered:" in out, "one_rank": "1 rank(s)" in out,
        "launches": launches.split(": ", 1)[1],
        "checkpoint_restores": "parameters' bits: True" in out,
        "checkpoint_is_in_process_fit": same_bits(restored, fit_params)}
    say("dist", f"torchrun trainer {trainer}")
    assert all(v for k, v in trainer.items() if k != "launches"), trainer
    assert trainer["launches"] == str({"trace_fwd": 0, "trace_bwd":
                                       EXAMPLE_STEPS, "trace_seg": 0})
    res = dict(np.load(os.path.join(tmp, "rank0.npz")))
    check = {}
    f0, b0 = cuda_kernel.LAUNCHES, cuda_bwd.LAUNCHES
    for case in CASES:
        static, params, target, h, w = problem(case, device, (H, W))
        frame = cuda_kernel.render_image_cuda(static, *params, h, w)
        loss, gt, gc, _ = cuda_bwd.train_step_cuda(
            static, *params, torch.from_numpy(target).to(device), h, w)
        ok = {
            "frame": np.array_equal(res[f"{case}/frame"],
                                    frame.cpu().numpy()),
            "fused": float(res[f"{case}/cuda-fused/loss"]) == float(loss)
            and all(np.array_equal(res[f"{case}/cuda-fused/grad/{k}"],
                                   v.cpu().numpy())
                    for k, v in named(InverseParams(gt, gc)).items()),
            **{k: bool(res[f"{case}/{k}"]) for k in (
                "replicated", "checkpoint_bits", "uneven_raised")},
            "steps_finite": bool(np.isfinite(
                res[f"{case}/steps/loss"]).all())}
        check[case] = ok
        say("dist", f"dist_check {case} at {W}x{H}: {ok}")
    cuda_kernel.LAUNCHES, cuda_bwd.LAUNCHES = f0, b0   # comparisons
    assert all(all(v.values()) for v in check.values()), check
    t = check["animated"] and (
        float(res["animated/loss_t0"]) != float(res["animated/loss_t09"])
        and float(res["animated/time_grad"]) != 0.0)
    assert t, "the animated scene did not move with time"
    return {"trainer": trainer, "dist_check": check}


def dist_check(device, card):
    """Phase 12 -> its record and its launches in this process."""
    import contextlib
    import io
    import tempfile

    from euclider_tpu_torch.train import fit
    rec, launches = dist_sharded(device)
    with tempfile.TemporaryDirectory() as tmp:
        with contextlib.redirect_stdout(io.StringIO()):   # its 120 steps
            fit_params = fit.main(["--scene", "grad_probe", "--steps",
                                   str(EXAMPLE_STEPS), "--checkpoint",
                                   os.path.join(tmp, "in_process")])["params"]
        rec.update(dist_processes(device, fit_params, tmp))
    rec["card"] = card
    return rec, launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    if sys.argv[1:2] == [LIMIT_REFERENCE]:
        limit_reference(*sys.argv[2:4])
        return 0
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
    libs = cuda_kernel.build()
    say("build", f"{', '.join(os.path.relpath(p, ROOT) for p in libs.values())}"
        f" in {time.perf_counter() - t0:.2f} s")
    for name, lines in cuda_kernel.PTXAS.items():
        for line in lines:
            say("build", f"{name}: {line}")
    wait_limit_builds = start_limit_builds()

    errs = {name: kernel_vs_plain(name, device)
            for name in SCENES + PROBES + WARP + EXPR + SHAPES}
    goldens = np.load(os.path.join(ROOT, "tests", "goldens.npz"))
    for name in SCENES + PROBES + WARP + EXPR + SHAPES:
        ground_truth(name, device, goldens)
    fwd_launches, fwd_by_scene = main_path(device)
    bwd = {name: backward_check(name, device) for name in BWD_SCENES}
    bwd.update({name: backward_check(name, device, y0, SLAB_ROWS, tm)
                for name, (y0, tm) in SLAB_SCENES.items()})
    train_launches, losses = train_path(device)
    times = {name: timing(name, device, card)
             for name in SCENES + ("grad_probe",) + WARP + EXPR + SHAPES[:2]}
    probe = probe_check(device, card)
    seg = seg_phase(device, card, times)
    march = march_probe_check(device, card)
    mosaic = mosaic_check(device, card, march["empty_ms"])
    probe_tools()
    viewer, viewer_launches, viewer_cli_rec = viewer_check(device, card,
                                                           times)
    dist_rec, dist_launches = dist_check(device, card)
    limits = limits_phase(device, card, wait_limit_builds)
    lim = limits["scenes"]
    dtype = dtype_phase(device, card)

    gp, c2 = times["grad_probe"], times[SCENES[1]]
    record = [{
        "name": "trace_fwd", "route": "cuda",
        "source": "euclider_tpu_torch/csrc/trace_fwd.cu",
        "replaces": "euclider_tpu/ops/pallas_kernel.py:127",
        "covers": "K1, every feature: straight space, CSG, cylinders, "
                  "uniform/checker/smooth/perlin/texture surfaces, the "
                  "march through the attractor field and the expression VM "
                  "(trace_common.cuh vm_eval), portals; redesigned for the "
                  "H100: the march's side tests read a per-block table in "
                  "shared memory, and the builds that march launch warps of "
                  "8 x 4 pixels",
        "launches": (fwd_launches + train_launches["trace_fwd"]
                     + sum(viewer_launches.values())
                     + dist_launches["trace_fwd"]
                     + limits["launches"]["trace_fwd"]
                     + dtype["launches"]["trace_fwd"]),
        "launches_by_scene": {"render_path": fwd_by_scene,
                              "training_path":
                              train_launches["trace_fwd_by_scene"],
                              "viewer_path": viewer_launches,
                              "dist_path": dist_launches["trace_fwd"],
                              "limits_path": {
                                  n: r["launches"]["trace_fwd"]
                                  for n, r in lim.items()},
                              "dtype_path": {
                                  n: r["launches"]["trace_fwd"]
                                  for n, r in dtype["scenes"].items()}},
        "limits": {n: {k: r.get(k) for k in (
            "libraries", "capacities", "passed", "max_abs_err", "bad_frac",
            "fwd_device_ms", "fwd_bound_ms", "fwd_bound_by",
            "plain_frame_ms")} for n, r in lim.items() if n in LIMIT_SLABS},
        "limits_ptxas": limits["ptxas"],
        "dtype": {n: {k: v for k, v in r.items() if k not in (
            "vjp", "fused", "autograd")} for n, r in dtype["scenes"].items()},
        "cast_cost": dtype["cast_cost"],
        "viewer": viewer, "viewer_cli": viewer_cli_rec, "dist": dist_rec,
        "ptxas": ptxas("trace_fwd", "trace_fwd_shapes"),
        "max_abs_err": max(e[0] for e in errs.values()),
        "ms": c2["fwd_device_ms"], "plain_ms": c2["plain_frame_ms"],
        "bound_ms": c2["fwd_bound_ms"], "bound_by": c2["fwd_bound_by"],
        "library_ms": None, "ms_scene": SCENES[1], "shape": [H, W, 3],
        "tolerance": {"atol": TOL, "max_bad_frac": MAX_BAD}, "card": card,
        "scenes": {n: {"frame_ms": t["frame_ms"],
                       "device_ms": t["fwd_device_ms"],
                       "plain_ms": t["plain_frame_ms"],
                       "bound_ms": t["fwd_bound_ms"],
                       "nodes_per_pixel": t["nodes_per_pixel"],
                       "march_steps_per_pixel": t["march_steps_per_pixel"],
                       "max_abs_err": errs[n][0], "bad_frac": errs[n][1]}
                   for n, t in times.items()}}, {
        "name": "trace_bwd", "route": "cuda",
        "source": "euclider_tpu_torch/csrc/trace_bwd.cu",
        "replaces": "euclider_tpu/ops/pallas_vjp.py:611 (fused, K2), "
                    "euclider_tpu/ops/pallas_vjp.py:611 (plain, K3), "
                    "euclider_tpu/ops/pallas_vjp.py:173 (K4), "
                    "euclider_tpu/ops/pallas_kernel.py:270 (K5)",
        "covers": "K2/K3/K5: the backward of straight space, CSG (through "
                  "the winning leaf), cylinders, perlin and texture surfaces "
                  "(the texels' gradient by atomics) and portals; K4: the "
                  "reversible march backward through the attractor field and "
                  "the expression VM's adjoint (trace_adj.cuh vm_adjoint: "
                  "mat_expr_params and the scene time); redesigned for the "
                  "H100: the gradient vector in the block's shared memory "
                  "where it fits, chosen by size (bwd_config), the march's "
                  "checkpoints recorded in the forward sweep",
        "launches": (train_launches["trace_bwd"] + dist_launches["trace_bwd"]
                     + limits["launches"]["trace_bwd"]
                     + dtype["launches"]["trace_bwd"]),
        "launches_by_scene": {"training_path":
                              train_launches["trace_bwd_by_scene"],
                              "dist_path": dist_launches["trace_bwd"],
                              "limits_path": {
                                  n: r["launches"]["trace_bwd"]
                                  for n, r in lim.items()},
                              "dtype_path": {
                                  n: r["launches"]["trace_bwd"]
                                  for n, r in dtype["scenes"].items()}},
        "limits": {n: r for n, r in lim.items() if r["route"] == "tape"},
        "dtype": {n: {k: r[k] for k in ("vjp", "fused", "autograd",
                                        "time_grad_dtype", "loss_bits")}
                  for n, r in dtype["scenes"].items()},
        "limits_training": limits["training"],
        "max_abs_err": max(b["vjp_err"] for b in bwd.values()),
        "ms": gp["bwd_device_ms"], "plain_ms": bwd["grad_probe"]["plain_ms"],
        "bound_ms": gp["bwd_bound_ms"], "bound_by": gp["bwd_bound_by"],
        "library_ms": None, "ms_scene": "grad_probe", "shape": [H, W, 3],
        "tolerance": {"grad_rtol": GRAD_RTOL, "loss_rtol": LOSS_RTOL},
        "card": card, "train_losses": losses,
        "scenes": {n: dict(bwd[n], **{k: times[n][k] for k in (
            "fused_step_ms", "unfused_step_ms", "bwd_device_ms",
            "sum_device_ms", "vjp_device_ms", "bwd_bound_ms", "bwd_config")
            if k in times.get(n, {})}) for n in bwd}}, {
        "name": "probe_rev", "route": "cuda",
        "source": "euclider_tpu_torch/csrc/probe_rev.cu",
        "replaces": "tools/mosaic_probe.py:502",
        "launches": probe["launches"], "max_abs_err": probe["max_abs_err"],
        "ms": probe["ms"], "plain_ms": probe["plain_ms"],
        "bound_ms": probe["bound_ms"], "bound_by": probe["bound_by"],
        "library_ms": None, "shape": [8, 128],
        "tolerance": {"rtol": PROBE_RTOL}, "card": card,
        "dx_rel": probe["dx_rel"], "dw_rel": probe["dw_rel"],
        **{k: probe[k] for k in ("lane_ms", "longest_lane", "ragged_rel",
                                 "fixed_bits", "steps_per_element")}},
        seg, march,
        *mosaic]
    seg["launches"] += limits["launches"]["trace_seg"]
    seg["launches_by_scene"]["limits_path"] = {
        n: r["launches"]["trace_seg"] for n, r in lim.items()}
    seg["limits"] = {n: r for n, r in lim.items() if r["route"] != "tape"}
    for rec in record:
        keys = SEG_KEYS if rec["name"] == "trace_seg" else [
            rec["name"] + "_kernel"]
        rec["ms_by"] = ("CUDA events (padded_ms) where torch.profiler "
                        "recorded no launch, see the [time] lines"
                        if EVENT_TIMED.intersection(keys) else
                        "torch.profiler")
    print(json.dumps({"kernels": record}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
