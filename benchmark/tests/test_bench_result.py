"""The last line a run prints, and a run on a machine without a card."""
import json
import subprocess
import sys

from benchmark import harness
from benchmark.tests.helpers import small_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def line_of(workload, trace):
    spec = harness.load_spec()
    record = harness.loop(
        harness.find_cell(spec, workload)[2]["kind"]).run(
            small_cell(workload, trace=trace))
    metrics = harness.read_metrics(
        harness.metrics_of(spec, workload, trace), record)
    device = {"platform": "gpu", "kind": "a test", "count": 1,
              "memory_peak_bytes": record.memory_peak_bytes}
    return record, json.loads(json.dumps(harness.result(record, metrics,
                                                        device)))


def test_untraced_line():
    record, line = line_of("view.config5_warp_portal", False)
    assert list(line) == KEYS + ["checks"]          # the checks come last
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] == record.units >= 1
    assert set(line["metrics"]) == {"frames_per_s", "frame_ms_p95",
                                    "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert line["checks"] == {"bad_share": {"value": 0.0, "limit": 0.001}}


def test_traced_line():
    _, line = line_of("view.config5_warp_portal", True)
    assert list(line) == KEYS + ["breakdown", "checks"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    # on the CPU no kernel runs: the kernels' share is left out, not 0
    assert "roofline_pct.view" not in line["metrics"]
    assert {"host_busy_ms.view", "launches.view",
            "device_idle_pct.view"} == set(line["metrics"])
    assert set(line["checks"]) == {"bad_share"}


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "view.config5_warp_portal", "--seed", str(2 ** 31 + 5),
         "--seconds", "1", "--trace", "0"], cwd=harness.ROOT,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA" in out.stderr


def test_unknown_workload_exits():
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "nope",
         "--seed", "1", "--seconds", "1"], cwd=harness.ROOT,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
