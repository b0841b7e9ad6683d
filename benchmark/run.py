"""Run one cell of the benchmark once, on this machine's GPUs.

    python3 -m benchmark.run --workload view.config5_warp_portal --seed 7 \\
        --seconds 10 --trace 0

Prints the cell's end-to-end metrics (``--trace 0``) or its per-layer
metrics read from ``torch.profiler`` (``--trace 1``) as the last line of
standard output, one JSON object, and the numbers its check compared,
each beside its limit, as the last lines of standard error.  Exits
nonzero with no result where the machine has fewer CUDA devices than the
cell asks for, or where JAX or the JAX package was loaded."""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

# No library may load JAX in this process (the result is refused if one
# did); the program's kernels build into euclider_tpu_torch/build/ of the
# checkout, a fixed path, so only a checkout's first run compiles.
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark import harness
    spec = harness.load_spec()
    work, config, traffic = harness.find_cell(spec, args.workload)

    import torch
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < work["chips"]:
        print(f"error: the cell asks for {work['chips']} CUDA devices, the "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2

    cell = harness.Cell(args.workload, config, traffic, args.seed,
                        args.seconds, bool(args.trace), T0)
    record = harness.loop(traffic["kind"]).run(cell)

    bad = harness.forbidden_modules()
    if bad:
        print(f"error: the run loaded {bad}", file=sys.stderr)
        return 3
    metrics = harness.read_metrics(
        harness.metrics_of(spec, args.workload, bool(args.trace)), record)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": work["chips"],
              "memory_peak_bytes": record.memory_peak_bytes}
    if record.trace is not None:
        device["busy_s"] = record.trace.busy_gaps()[0]
        device["window_s"] = record.trace.window_s
    line = harness.result(record, metrics, device)

    sys.stderr.write(f"card: {power_limit()}; window {record.window_s!r} s, "
                     f"{record.units} {record.kind} units; notes "
                     f"{json.dumps(record.notes)}\n")
    if record.bound_ms is not None:
        sys.stderr.write(f"least time of one unit {record.bound_ms!r} ms "
                         f"({record.bound_by})\n")
    for k, (v, lim) in record.checks.items():
        sys.stderr.write(f"{k} {v!r} limit {lim!r}\n")
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
