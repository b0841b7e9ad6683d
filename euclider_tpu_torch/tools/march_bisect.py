"""The port's counterpart of ``tools/march_bisect.py``: the march-bisect
probe P1 (``ops/march_probe.py``) by stage.

    python -m euclider_tpu_torch.tools.march_bisect fwd|vjp|finish|loop \\
        [--tile tool|crossing] [--device cpu]

Runs the stage on the tool's tile (or the seeded crossing tile) and prints
the tool's line, ``STAGE: ok, finite=..., sum=...``, of the output tile.
On the card (the default) that tile is the kernel's
(``csrc/probe_march.cu``); the next line holds it against the plain
version on the same tile: the largest difference over the lanes whose
march agrees, its limit 1e-5 * max(max |ref|, 1), the lanes whose march
crossed at another step or entity (at most 1% of the tile) and the
launches, as one JSON object.  Exits 1 past either limit.  A build or
launch that fails raises: there is no fallback.  ``--device cpu`` runs the
plain version alone and says so.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from ..ops import march_probe as MP

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="euclider_tpu_torch.tools.march_bisect",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("stage", nargs="?", default="vjp", choices=MP.STAGES)
    ap.add_argument("--tile", default="tool", choices=("tool", "crossing"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernel) or cpu (the plain version)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("march_bisect: no CUDA device; pass --device cpu for "
                         "the plain version")
    static, tables = MP.probe_scene(device)
    org, d = (MP.tool_tile(device) if args.tile == "tool"
              else MP.crossing_tile(device))
    before = MP.LAUNCHES
    got = MP.march_probe(static, tables, org, d, args.stage)
    launches = MP.LAUNCHES - before
    out = got.out.double().cpu()
    print(f"{args.stage}: ok, finite={bool(torch.isfinite(out).all())}, "
          f"sum={float(out.sum()):.4f}", flush=True)
    if device.type != "cuda":
        print("device: cpu: the plain version only, no kernel is checked")
        return 0
    res = MP.compare(MP.march_probe_plain(static, tables, org, d,
                                          args.stage), got)
    ok = MP.passes(res, out.numel())
    res.update(ok=ok, launches=launches,
               device=torch.cuda.get_device_name(device))
    print(json.dumps(res))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
