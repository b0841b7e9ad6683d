"""Small CPU runs of the benchmark's cells: the program's plain torch
version on the CPU stands in for the card."""
import json
import os
import time

from benchmark import harness

SMALL = (32, 18)          # W, H of the CPU runs


def small_cell(workload, seed=2 ** 31 + 17, seconds=0.2, trace=False,
               root=harness.ROOT):
    spec = harness.load_spec(root)
    _, config, traffic = harness.find_cell(spec, workload, root)
    # a CPU frame takes most of a second: one checked frame, the first
    traffic = dict(traffic, block_rows=9, check_frames=1)
    return harness.Cell(workload, config, traffic, seed, seconds, trace,
                        time.perf_counter(), "cpu", "torch", SMALL,
                        log=lambda msg: None)


def read_json(path):
    with open(path) as f:
        return json.load(f)


def bench_files(root):
    """Every file of the benchmark under ``root``: relative path -> bytes."""
    out = {}
    base = os.path.join(root, "benchmark")
    for d, _, names in os.walk(base):
        if "__pycache__" in d:
            continue
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out
