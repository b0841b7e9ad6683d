"""The readings that the check's limits are set from, in one process a
cell: the program's sound runs on many seeds, its control (the reference
computed in bfloat16 in the program's place) and the planted faults, each
at the cell's own size with a short window.

    python3 -m benchmark.calibrate --workload view.config5_warp_portal \\
        --seeds 11,12,13 --control-seeds 21,22,23 --faults half,one_buffer \\
        --fault-seeds 31,32,33 --seconds 5

One JSON line a reading on standard output.  The benchmark's own runs do
not run this."""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import faults, harness


def ints(s: str) -> list:
    return [int(x) for x in s.split(",") if x]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=ints, default=[])
    p.add_argument("--control-seeds", type=ints, default=[])
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", type=ints, default=[])
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)

    spec = harness.load_spec()
    _, config, traffic = harness.find_cell(spec, args.workload)
    kind = traffic["kind"]
    loop = harness.loop(kind)

    def cell(seed):
        return harness.Cell(args.workload, config, traffic, seed,
                            args.seconds, False, time.perf_counter())

    def say(mode, seed, checks, t0, extra=None):
        out = {"mode": mode, "seed": seed, "checks": checks,
               "seconds": time.perf_counter() - t0}
        if extra:
            out.update(extra)
        print(json.dumps(out), flush=True)

    def program(mode, seed):
        t0 = time.perf_counter()
        rec = loop.run(cell(seed))
        say(mode, seed, {k: v for k, (v, _) in rec.checks.items()}, t0,
            {"correct": rec.correct, "units": rec.units,
             "notes": rec.notes})

    for seed in args.seeds:
        program("program", seed)
    for seed in args.control_seeds:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        got = loop.control(cell(seed))
        say("control", seed, got, t0,
            {"peak_bytes": torch.cuda.max_memory_allocated()})
    for name in [f for f in args.faults.split(",") if f]:
        for seed in args.fault_seeds:
            with faults.planted(name, kind):
                program(f"fault:{name}", seed)
    bad = harness.forbidden_modules()
    if bad:
        print(f"error: loaded {bad}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
