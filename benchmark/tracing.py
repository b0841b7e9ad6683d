"""The traced window: ``torch.profiler`` around the measured loop, read
into a few arrays that the per-layer metrics take apart.

The window is the host range ``bench.window`` that the loop records
around its frames or steps.  Device work is every kernel, copy and memset
the profiler saw start inside it; host work is every operation of the
thread that ran the loop.  No metric here names a kernel of the program:
a later change may rename, merge or split them."""
from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np

WINDOW = "bench.window"
# a traced run measures this long at most: its metrics are shares and
# rates a frame or a step, and a longer trace only costs its reading
TRACE_SECONDS = 5.0
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
# the runtime calls in which the host waits for the device
SYNC_CALLS = ("cudaEventSynchronize", "cudaStreamSynchronize",
              "cudaDeviceSynchronize")


@contextlib.contextmanager
def profiled(enabled: bool, cuda: bool, sink: list):
    """Profile the body when ``enabled``; the read ``Trace`` is appended
    to ``sink`` on the way out."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        yield
    sink.append(Trace.read(prof.profiler.kineto_results.events()))


def _kind(e) -> str:
    try:
        return e.activity_type()
    except AttributeError:       # an older profiler: by device and name
        if str(e.device_type()).endswith("CUDA"):
            name = e.name()
            return ("gpu_memcpy" if name.startswith("Memcpy") else
                    "gpu_memset" if name.startswith("Memset") else "kernel")
        return "cuda_runtime" if e.name().startswith("cuda") else "cpu_op"


@dataclass
class Trace:
    w0: int                    # the window, ns on the profiler's clock
    w1: int
    dev_start: np.ndarray      # device operations that started in it
    dev_end: np.ndarray
    dev_kind: np.ndarray       # DEVICE_KINDS
    dev_name: np.ndarray
    host_start: np.ndarray     # the loop thread's operations in it
    host_end: np.ndarray
    host_name: np.ndarray

    @classmethod
    def read(cls, events) -> "Trace":
        rows, window, tid = [], None, None
        for e in events:
            kind, name = _kind(e), e.name()
            start, dur = e.start_ns(), e.duration_ns()
            on_device = str(e.device_type()).endswith("CUDA")
            if name == WINDOW and not on_device:
                window, tid = (start, start + dur), e.start_thread_id()
                continue
            rows.append((kind, name, start, start + dur, on_device,
                         None if on_device else e.start_thread_id()))
        if window is None:
            raise RuntimeError(f"the trace has no {WINDOW!r} range")
        w0, w1 = window
        # a host range (record_function) has a copy on the device's
        # timeline, under the same name: no work of the device
        marks = {WINDOW} | {r[1] for r in rows if not r[4]}
        dev = [r for r in rows if r[4] and r[0] in DEVICE_KINDS
               and r[1] not in marks and w0 <= r[2] <= w1]
        host = [r for r in rows if not r[4] and r[5] == tid
                and r[3] >= w0 and r[2] <= w1]

        def col(rs, i, dtype=None):
            return np.asarray([r[i] for r in rs], dtype=dtype)

        return cls(w0, w1, col(dev, 2, np.int64), col(dev, 3, np.int64),
                   col(dev, 0, object), col(dev, 1, object),
                   col(host, 2, np.int64), col(host, 3, np.int64),
                   col(host, 1, object))

    # -- what the metrics read -------------------------------------------
    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) * 1e-9

    def busy_gaps(self):
        """(seconds in which some device operation ran inside the window,
        [(gap start ns, gap end ns)] of the window's idle stretches)."""
        if not len(self.dev_start):
            return 0.0, [(self.w0, self.w1)]
        order = np.argsort(self.dev_start, kind="stable")
        s = np.clip(self.dev_start[order], self.w0, self.w1)
        e = np.clip(self.dev_end[order], self.w0, self.w1)
        reach = np.maximum.accumulate(e)
        starts = np.concatenate([[self.w0], reach])
        ends = np.concatenate([s, [self.w1]])
        idle = ends > starts
        gaps = list(zip(starts[idle].tolist(), ends[idle].tolist()))
        idle_ns = sum(b - a for a, b in gaps)
        return (self.w1 - self.w0 - idle_ns) * 1e-9, gaps

    def kernel_s(self) -> float:
        """Device seconds of the kernels (copies and memsets left out)."""
        k = self.dev_kind == "kernel"
        return float((self.dev_end[k] - self.dev_start[k]).sum()) * 1e-9

    def launches(self) -> int:
        """Kernels, copies and memsets that ran on the device."""
        return int(len(self.dev_start))

    def sync_s(self) -> float:
        """Seconds the loop's thread spent in the runtime's synchronising
        calls, inside the window."""
        m = np.isin(self.host_name, SYNC_CALLS)
        s = np.clip(self.host_start[m], self.w0, self.w1)
        e = np.clip(self.host_end[m], self.w0, self.w1)
        return float((e - s).sum()) * 1e-9

    def host_at(self, t_ns: int) -> str:
        """The innermost operation of the loop's thread under way at t."""
        m = (self.host_start <= t_ns) & (self.host_end >= t_ns)
        if not m.any():
            return "host: outside any profiled operation"
        i = np.flatnonzero(m)[np.argmax(self.host_start[m])]
        return str(self.host_name[i])

    def breakdown(self, n: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps, each named by what the host was doing in its middle."""
        total = {}
        for name, d in zip(self.dev_name.tolist(),
                           (self.dev_end - self.dev_start).tolist()):
            total[name] = total.get(name, 0) + d
        ops = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        _, gaps = self.busy_gaps()
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
        return {"device_ops": [[k, v * 1e-9] for k, v in ops],
                "idle_gaps": [[self.host_at((a + b) // 2), (b - a) * 1e-9]
                              for a, b in gaps]}
