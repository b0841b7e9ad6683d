"""The port's counterpart of ``tools/mosaic_probe.py``: the probes P2-P6 on
the tool's seeded (8, 128) tiles.

    python -m euclider_tpu_torch.tools.mosaic_probe [--only NAME] [--device cpu]

On the card (the default) each probe's hand-written kernel
(``csrc/probe_mosaic.cu``, ``csrc/probe_rev.cu``) runs on the tool's inputs
and is held against its plain version (``ops/probes.py``) on the same
inputs, at the tool's tolerance, measured as the tool measures it (dx's
largest difference; dw's relative to max(|dw|, 1)).  Prints
``NAME OK|FAIL maxerr=...`` per probe under the tool's names, then the
kernels' launches as one JSON line, and exits 1 on any FAIL.  A build or
launch that fails raises: there is no fallback.  ``--device cpu`` runs the
plain versions alone (through the dispatchers, which take them for CPU
tensors) and says so: no kernel is checked there.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..ops import probes as P

# name, tolerance (tools/mosaic_probe.py:582-586)
PROBES = (("ckpt_scratch_fori_vjp", 1e-5), ("cond_in_kernel_vjp", 1e-6),
          ("nested_custom_vjp_scoped", 1e-4),
          ("gated_march_custom_vjp", 1e-4),
          ("reversible_march_custom_vjp", 1e-4))
NAMES = tuple(n for n, _ in PROBES)


def _normal(seed, device, scale=1.0):
    a = np.random.default_rng(seed).normal(size=(8, 128)) * scale
    return torch.from_numpy(a.astype(np.float32)).to(device)


def _vjp_err(ref, got) -> float:
    """The tool's error of (dx, dw): max(max |ddx|, |ddw| / max(|dw|, 1))."""
    e1 = float((got[0] - ref[0]).abs().max())
    e2 = abs(float(got[1]) - float(ref[1]))
    return max(e1, e2 / max(abs(float(ref[1])), 1.0))


def run(name: str, device) -> float:
    """One probe on the tool's inputs: the kernel (or, on the CPU, the plain
    version through the dispatcher) against the plain version -> error."""
    plain = device.type != "cuda"
    if name == "cond_in_kernel_vjp":
        rng = np.random.default_rng(2)
        err = 0.0
        for shift in (1.0, -1.0):      # both branches
            x = torch.from_numpy((rng.normal(size=(8, 128)) + shift).astype(
                np.float32)).to(device)
            g = torch.from_numpy(rng.normal(size=(8, 128)).astype(
                np.float32)).to(device)
            got = P.cond_vjp(x, g) if plain else P.cond_cuda(x, g)
            ref = P.cond_plain(x, g)
            err = max(err, *(float((a - b).abs().max())
                             for a, b in zip(got, ref)))
        return err
    seeds, scale, w, kernel, ref_fn, vjp = {
        "ckpt_scratch_fori_vjp": ((0, 1), 1.0, 0.7, P.ckpt_scratch_cuda,
                                  P.ckpt_scratch_plain, P.ckpt_scratch_vjp),
        "nested_custom_vjp_scoped": ((3, 4), 0.3, 0.9, P.nested_march_cuda,
                                     P.nested_march_plain,
                                     P.nested_march_vjp),
        "gated_march_custom_vjp": ((5, 6), 0.3, 0.8, P.gated_march_cuda,
                                   P.gated_march_plain, P.gated_march_vjp),
        "reversible_march_custom_vjp": ((7, 8), 0.8, 1.1, P.rev_march_cuda,
                                        P.rev_march_plain, P.rev_march_vjp),
    }[name]
    x, g = _normal(seeds[0], device, scale), _normal(seeds[1], device)
    got = vjp(x, w, g) if plain else kernel(x, w, g)
    return _vjp_err(ref_fn(x, w, g), got)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="euclider_tpu_torch.tools.mosaic_probe",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", help="run the probes whose name holds this")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("mosaic_probe: no CUDA device; pass --device cpu "
                             "for the plain versions")
        print(f"device: {torch.cuda.get_device_name(device)}",
              file=sys.stderr)
    else:
        print("device: cpu: the plain versions only, no kernel is checked",
              file=sys.stderr)
    before = dict(P.MOSAIC_LAUNCHES, probe_rev=P.LAUNCHES)
    failed = False
    for name, tol in PROBES:
        if args.only and args.only not in name:
            continue
        err = run(name, device)
        ok = err < tol
        failed |= not ok
        print(f"{name:28s} {'OK ' if ok else 'FAIL'} maxerr={err:.2e}",
              flush=True)
    now = dict(P.MOSAIC_LAUNCHES, probe_rev=P.LAUNCHES)
    print(json.dumps({"launches": {k: now[k] - before[k] for k in now}}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
