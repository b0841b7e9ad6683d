"""The viewer: one user, closed loop, one frame in flight.

Each frame the camera moves to the next pose of an orbit about the
scene's first sphere (2 pi every ``orbit_frames`` frames, from a start
angle drawn from the seed) and ``Simulation.step`` dispatches it and
returns the frame before it from pinned host memory.  A frame's time is
the host time of that call.

The check: at times drawn from the seed, ``check_frames`` frames are
copied as they reach the host; once the window has closed they are held
against the reference's render of their poses, pixel by pixel.  The
viewer gathers frame after frame into its two pinned buffers in turn, so
the j-th checked frame is the first one due whose number in the window
has the parity of j: half the checked frames passed through each
buffer.  One still owed when the window closes is the next frame of its
buffer, rendered after the window and not timed.  A traced
run also counts the work of ``count_poses`` frames evenly spaced around
the orbit from angle 0, the same for every seed, for the kernels'
roofline."""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from .. import tracing
from ..harness import Cell, Record
from ..reference import camera as rcam
from ..reference import render as ref

WARM_FRAMES = 8


def orbit(config: dict):
    """-> (static, numpy tables, the scene's camera, the orbit's center:
    the first sphere's)."""
    static, tables, cam0 = ref.load(config["scene"])
    center = next(e["shape"]["center"][:3]
                  for e in config["scene"]["entities"]
                  if e["shape"]["type"] == "sphere")
    return static, tables, cam0, center


def poses(config: dict, traffic: dict, seed: int):
    """The orbit's poses, one a frame of one turn, from the seed's start
    angle -> (list of reference CameraParams, static, numpy tables)."""
    static, tables, cam0, center = orbit(config)
    a0 = 2 * math.pi * float(torch.rand(
        (), generator=torch.Generator().manual_seed(seed % 2 ** 63),
        dtype=torch.float64))
    n = traffic["orbit_frames"]
    return ([rcam.orbit(cam0, center, a0 + 2 * math.pi * k / n)
             for k in range(n)], static, tables)


def sample_times(seed: int, n: int, seconds: float):
    """When, in the window, the checked frames are taken: n times drawn
    from the seed, in its middle nine tenths."""
    g = torch.Generator().manual_seed((seed + 1) % 2 ** 63)
    u = torch.rand(n, generator=g, dtype=torch.float64).sort().values
    return (0.05 + 0.9 * u).mul(seconds).tolist()


def takes(j: int, number: int) -> bool:
    """Whether the j-th checked frame may be the frame of this number in
    the window (0 the first): one of the viewer's two buffers in turn."""
    return number % 2 == j % 2


def compare(frame: np.ndarray, want: np.ndarray, tol: float) -> dict:
    """The readings of one frame against the reference's."""
    d = np.abs(frame.astype(np.float64) - want.astype(np.float64))
    d = np.where(np.isfinite(d), d, np.inf)
    return {"bad_share": float((d > tol).mean()), "max_abs": float(d.max())}


def run(cell: Cell) -> Record:
    from euclider_tpu_torch.scene import jsonio
    from euclider_tpu_torch.viewer.simulation import Simulation

    tr = cell.traffic
    W, H = cell.size or (tr["width"], tr["height"])
    cuda = torch.device(cell.device).type == "cuda"
    stamps = {"imported": time.perf_counter() - cell.t0}
    path, static, tables = poses(cell.config, tr, cell.seed)
    period = len(path)
    window = (min(cell.seconds, tracing.TRACE_SECONDS) if cell.trace
              else cell.seconds)
    due = sample_times(cell.seed, tr["check_frames"], window)

    sim = Simulation(jsonio.scene_from_dict(cell.config["scene"]), H, W,
                     cell.backend or tr["backend"], cell.device)
    stamps["program"] = time.perf_counter() - cell.t0
    for i in range(WARM_FRAMES):     # builds the kernel on a first run
        sim.cam = path[i % period]
        sim.step(i)
    sim.flush()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - cell.t0

    times, kept, traced = [], [], []
    shown = 0                        # the pose of the frame step returns
    i = 0                            # its number is max(i - 1, 0)

    def keep(img, since):
        """Keep the frame step returned where a checked frame is due."""
        if due and since >= due[0] and takes(len(kept), max(i - 1, 0)):
            due.pop(0)
            kept.append((np.array(img), shown, max(i - 1, 0)))

    with tracing.profiled(cell.trace, cuda, traced):
        with torch.profiler.record_function(tracing.WINDOW):
            w0 = time.perf_counter()
            end = w0 + window
            while True:
                k = i % period
                sim.cam = path[k]
                t = time.perf_counter()
                img = sim.step(i)
                t1 = time.perf_counter()
                times.append(t1 - t)
                keep(img, t1 - w0)
                shown = k
                i += 1
                if t1 >= end:
                    break
            w1 = time.perf_counter()
    while due:      # one owed at the close: its buffer's next frame, untimed
        sim.cam = path[i % period]
        keep(sim.step(i), math.inf)
        shown = i % period
        i += 1
    sim.flush()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    del sim, img
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    # the check, on the reference's own tables at the sampled poses
    c0 = time.perf_counter()
    dev = torch.device(cell.device)
    rt, _ = ref.to_device(tables, path[0], dev)
    worst = {"bad_share": 0.0, "max_abs": 0.0}
    failed = 0
    lim = tr["limits"]
    for frame, k, _ in kept:
        _, rc = ref.to_device(tables, path[k], dev)
        want = ref.render(static, rt, rc, H, W, tr["block_rows"])
        got = compare(frame, want.cpu().numpy(), tr["tolerance"])
        cell.log(f"check frame of pose {k}: bad_share {got['bad_share']!r} "
                 f"max_abs {got['max_abs']!r}")
        failed += got["bad_share"] > lim["bad_share"]
        worst = {key: max(worst[key], got[key]) for key in worst}
    if not kept:
        worst["bad_share"] = math.inf     # nothing was checked
    rec = Record("view", setup_s, w1 - w0, len(times), times, peak,
                 {"bad_share": (worst["bad_share"], lim["bad_share"])},
                 failed, traced[0] if traced else None)
    q = np.percentile(np.asarray(times) * 1e3, [5, 50, 95, 99])
    rec.notes.update(checked=len(kept), frames=[n for _, _, n in kept],
                     frame_ms_p5_p50_p95_p99=q.tolist(),
                     max_abs=worst["max_abs"],
                     check_s=time.perf_counter() - c0, setup_stamps=stamps)
    if cuda:
        rec.notes["check_peak_bytes"] = torch.cuda.max_memory_allocated()
    if cell.trace:                   # the work of an orbit's frame
        from ..roofline import bound
        counts = ref.Counts(static, dev)
        _, _, cam0, center = orbit(cell.config)
        n = tr["count_poses"]
        for k in range(n):           # the same poses whatever the seed
            _, rc = ref.to_device(
                tables, rcam.orbit(cam0, center, 2 * math.pi * k / n), dev)
            ref.render(static, rt, rc, H, W, tr["block_rows"], counts)
        c = counts.as_dict()
        rec.bound_ms, rec.bound_by, _ = bound(
            static, c["nodes"] / n, False, c["steps"] / n, c["marches"] / n,
            [h / n for h in c["hits"]], 0, H * W)
    return rec


def control(cell: Cell, dtype=torch.bfloat16) -> dict:
    """The check's control: the reference computed in ``dtype`` put in the
    program's place, at poses drawn from the seed, held against the
    float32 reference as the program's frames are -> the worst readings."""
    tr = cell.traffic
    W, H = cell.size or (tr["width"], tr["height"])
    dev = torch.device(cell.device)
    path, static, tables = poses(cell.config, tr, cell.seed)
    g = torch.Generator().manual_seed((cell.seed + 2) % 2 ** 63)
    picks = torch.randint(len(path), (tr["check_frames"],), generator=g)
    rt, _ = ref.to_device(tables, path[0], dev)
    lo, _ = ref.to_device(tables, path[0], dev, dtype)
    worst = {"bad_share": 0.0, "max_abs": 0.0}
    for k in picks.tolist():
        _, rc = ref.to_device(tables, path[k], dev)
        _, lc = ref.to_device(tables, path[k], dev, dtype)
        frame = ref.render(static, lo, lc, H, W, tr["block_rows"])
        want = ref.render(static, rt, rc, H, W, tr["block_rows"])
        got = compare(frame.float().cpu().numpy(), want.cpu().numpy(),
                      tr["tolerance"])
        worst = {key: max(worst[key], got[key]) for key in worst}
    return worst
