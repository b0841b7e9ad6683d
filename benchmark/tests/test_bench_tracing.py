"""The trace reader and the per-layer metrics on a synthetic timeline."""
import pytest

from benchmark import harness, tracing


class Ev:
    def __init__(self, name, start, dur, device=False, kind=None, tid=1):
        self._n, self._s, self._d, self._dev = name, start, dur, device
        self._k, self._t = kind, tid

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return "DeviceType.CUDA" if self._dev else "DeviceType.CPU"

    def start_thread_id(self):
        return self._t

    def activity_type(self):
        return self._k


def timeline():
    """A 1,000 ns window of two steps: the device busy 100-300 (kernel),
    250-400 (copy) and 600-700 (kernel); the host waiting 300-450 in
    cudaStreamSynchronize and 700-800 in cudaEventSynchronize; a host
    range 'step' whose copy on the device must not count."""
    return [
        Ev(tracing.WINDOW, 0, 1000, kind="user_annotation"),
        Ev(tracing.WINDOW, 0, 1000, device=True, kind="kernel"),
        Ev("step", 50, 400, kind="user_annotation"),
        Ev("step", 60, 380, device=True, kind="kernel"),
        Ev("aten::copy_", 40, 30, kind="cpu_op"),
        Ev("cudaLaunchKernel", 90, 10, kind="cuda_runtime"),
        Ev("cudaStreamSynchronize", 300, 150, kind="cuda_runtime"),
        Ev("cudaEventSynchronize", 700, 100, kind="cuda_runtime"),
        Ev("cudaEventSynchronize", 700, 100, kind="cuda_runtime", tid=2),
        Ev("fwd_kernel", 100, 200, device=True, kind="kernel"),
        Ev("Memcpy DtoH", 250, 150, device=True, kind="gpu_memcpy"),
        Ev("fwd_kernel", 600, 100, device=True, kind="kernel"),
        Ev("late_kernel", 1200, 100, device=True, kind="kernel"),
    ]


def record(kind="view", units=2, bound_ms=None):
    t = tracing.Trace.read(timeline())
    return harness.Record(kind, 1.0, t.window_s, units, [0.5e-6] * units,
                          0, {}, trace=t, bound_ms=bound_ms)


def test_busy_idle_and_gaps():
    t = tracing.Trace.read(timeline())
    busy, gaps = t.busy_gaps()
    assert busy == pytest.approx(400e-9)          # 100-400 and 600-700
    assert gaps == [(0, 100), (400, 600), (700, 1000)]
    assert t.launches() == 3                       # late_kernel is outside
    assert t.kernel_s() == pytest.approx(300e-9)
    assert t.sync_s() == pytest.approx(250e-9)     # thread 1 only
    assert t.host_at(200) == "step"
    assert t.host_at(420) == "cudaStreamSynchronize"     # the innermost
    assert t.host_at(900).startswith("host: outside")


def test_metric_readers():
    r = record()
    read = {m: harness.reader(m)(r) for m in (
        "host_busy_ms.view", "launches.view", "device_idle_pct.view",
        "roofline_pct.view")}
    assert read["host_busy_ms.view"] == pytest.approx((1000 - 250) / 2 * 1e-6)
    assert read["launches.view"] == 1.5
    assert read["device_idle_pct.view"] == pytest.approx(60.0)
    assert read["roofline_pct.view"] is None       # no bound counted
    r = record(bound_ms=75e-6)                     # 75 ns a frame
    # 75 ns against 150 ns of kernels a frame
    assert harness.reader("roofline_pct.view")(r) == pytest.approx(50.0)


@pytest.mark.parametrize("base", ["host_busy_ms", "launches",
                                  "device_idle_pct", "roofline_pct"])
def test_one_reader_serves_every_kind(base):
    """``<base>.<kind>`` without a file of its own is read by
    ``metrics/<base>.py``, whatever the kind: a later kind of cell lists
    the metric and adds no file."""
    r = record(kind="step", bound_ms=75e-6)
    assert (harness.reader(f"{base}.view")(r)
            == harness.reader(f"{base}.fit")(r)
            == harness.reader(base)(r) is not None)


def test_untraced_run_has_no_per_layer_reading():
    r = harness.Record("view", 1.0, 1.0, 2, [0.5, 0.5], 0, {})
    for base in ("host_busy_ms", "launches", "device_idle_pct",
                 "roofline_pct"):
        assert harness.reader(f"{base}.view")(r) is None


def test_breakdown():
    b = tracing.Trace.read(timeline()).breakdown()
    assert b["device_ops"][0] == ["fwd_kernel", pytest.approx(300e-9)]
    assert [n for n, _ in b["device_ops"]] == ["fwd_kernel", "Memcpy DtoH"]
    assert b["idle_gaps"][0][1] == pytest.approx(300e-9)
    assert len(b["idle_gaps"]) == 3


def test_no_window_is_an_error():
    with pytest.raises(RuntimeError):
        tracing.Trace.read([Ev("x", 0, 1)])
