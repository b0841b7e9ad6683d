"""Observability: rays/s counters, per-frame timers, torch.profiler traces.

Port of ``euclider_tpu/utils/profiling.py``: a RenderMeter producing the
structured per-step log (rays/s/chip, Mrays/s aggregate, step time) with
the same fields and report keys, and a context manager around
``torch.profiler`` that writes a Chrome/Perfetto trace of the render.
A meter given a CUDA device times each ``frame()`` with CUDA events on the
current stream (the device's time from the block's first launch to its
last, waited for at the block's end); without one, with the host clock.
"""
from __future__ import annotations

import contextlib
import json
import os
import socket
import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch


@dataclass
class RenderMeter:
    """Accumulates per-frame timings and reports rays/s."""

    H: int
    W: int
    n_chips: int = 1
    times: List[float] = field(default_factory=list)
    device: Optional[torch.device] = None

    @contextlib.contextmanager
    def frame(self):
        dev = None if self.device is None else torch.device(self.device)
        if dev is None or dev.type != "cuda":
            t0 = time.perf_counter()
            yield
            self.times.append(time.perf_counter() - t0)
            return
        stream = torch.cuda.current_stream(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        yield
        end.record(stream)
        end.synchronize()
        self.times.append(start.elapsed_time(end) / 1e3)

    def add(self, seconds: float, frames: int = 1) -> None:
        """Record a timing that covered ``frames`` frames in one measurement;
        stored as the per-frame average."""
        self.times.extend([seconds / frames] * frames)

    @property
    def rays_per_frame(self) -> int:
        return self.H * self.W

    def mrays_per_sec(self) -> float:
        if not self.times:
            return 0.0
        dt = sum(self.times) / len(self.times)
        return self.rays_per_frame / dt / 1e6

    def mrays_per_sec_per_chip(self) -> float:
        return self.mrays_per_sec() / max(self.n_chips, 1)

    def report(self, label: str = "render") -> dict:
        rec = {
            "label": label,
            "frames": len(self.times),
            "resolution": f"{self.W}x{self.H}",
            "ms_per_frame": (1000 * sum(self.times) / len(self.times)
                             if self.times else None),
            "mrays_per_s": round(self.mrays_per_sec(), 2),
            "mrays_per_s_per_chip": round(self.mrays_per_sec_per_chip(), 2),
            "chips": self.n_chips,
        }
        return rec

    def log(self, label: str = "render") -> None:
        print(json.dumps(self.report(label)))


@contextlib.contextmanager
def profile_trace(logdir: Optional[str] = None):
    """torch.profiler over the block (the host's operations, and the CUDA
    kernels where a card is present), written into ``logdir`` as a
    Chrome/Perfetto trace ``<host>_<pid>.<ns>.pt.trace.json`` when the block
    ends; no-op if logdir is None."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        logdir, f"{socket.gethostname()}_{os.getpid()}."
                f"{time.time_ns()}.pt.trace.json"))
