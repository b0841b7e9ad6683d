"""Discovery and the result: what ``run.py`` finds by the names in
``BENCHMARK.json``, and the line it prints.

Everything that belongs to one cell sits in files of its own, found by
name: a configuration is the ``file`` its entry names, a traffic mix is
``traffic/<traffic>.json`` (its ``kind`` names the loop,
``loops/<kind>.py``), and every metric, end-to-end or per-layer, is
``metrics/<metric name>.py`` with a ``read(record)`` that returns a number
or None.  A metric named ``<base>.<kind>`` without a file of its own, as
``launches.view``, is read by ``metrics/<base>.py``: one reader serves
the quantity in every kind of cell that lists it."""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
from dataclasses import dataclass, field
from typing import Callable, Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# top-level modules that no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "euclider_tpu")


@dataclass
class Cell:
    """One run of one workload: what a loop is given."""
    name: str
    config: dict               # the configuration's file
    traffic: dict              # the traffic mix's file
    seed: int
    seconds: float
    trace: bool
    t0: float                  # perf_counter() when the process started
    device: str = "cuda"
    backend: Optional[str] = None   # the program's backend; traffic's if None
    size: Optional[tuple] = None    # (W, H) in place of the traffic's: tests
    log: Callable = field(default=lambda msg: print(msg, file=sys.stderr,
                                                    flush=True))


@dataclass
class Record:
    """What a loop hands back: the window on the host clock, the traced
    window where there was one, and the check."""
    kind: str
    setup_s: float
    window_s: float
    units: int                 # frames or steps completed in the window
    unit_times: list           # host seconds of each
    memory_peak_bytes: int
    checks: dict               # name -> (value, limit)
    failed: int = 0            # checked answers beyond a limit
    trace: object = None       # tracing.Trace of the traced run
    bound_ms: Optional[float] = None   # least time of one unit's work
    bound_by: str = ""
    notes: dict = field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return all(v <= lim for v, lim in self.checks.values())


def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _named(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"error: no {what} named {name!r} in BENCHMARK.json")


def find_cell(spec: dict, workload: str, root: str = ROOT):
    """-> (workload entry, configuration file's content, traffic's)."""
    w = _named(spec["workloads"], workload, "workload")
    c = _named(spec["configs"], w["config"], "configuration")
    with open(os.path.join(root, c["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "benchmark", "traffic",
                           f"{w['traffic']}.json")) as f:
        traffic = json.load(f)
    return w, config, traffic


def metrics_of(spec: dict, workload: str, trace: bool) -> list:
    """The metric entries a run of ``workload`` reports: its end-to-end
    metrics with ``--trace 0``, its per-layer ones with ``--trace 1``.  An
    entry with ``workloads`` counts where it lists the cell; a per-layer one
    without counts wherever the metric it moves is reported."""
    e2e = [m for m in spec["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if workload in m.get("workloads", [workload])
            and ("workloads" in m or m["moves"] in moved)]


def reader(name: str, root: str = ROOT):
    """``metrics/<name>.py``'s ``read``, else ``metrics/<base>.py``'s for a
    name ``<base>.<kind>``."""
    base = os.path.join(root, "benchmark", "metrics")
    path = os.path.join(base, f"{name}.py")
    if not os.path.exists(path):
        path = os.path.join(base, f"{name.split('.')[0]}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics._{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def loop(kind: str):
    return importlib.import_module(f"benchmark.loops.{kind}")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def read_metrics(entries: list, record: Record, root: str = ROOT) -> dict:
    out = {}
    for m in entries:
        value = reader(m["name"], root)(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result(record: Record, metrics: dict, device: dict) -> dict:
    """The last line: the contract's keys, then the checks, last."""
    out = {"correct": record.correct, "attempted": record.units,
           "failed": record.failed, "metrics": metrics, "device": device}
    if record.trace is not None:
        out["breakdown"] = record.trace.breakdown()
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in record.checks.items()}
    return out
