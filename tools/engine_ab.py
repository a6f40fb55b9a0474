#!/usr/bin/env python3
"""Time the single-tree engine's flows of two checkouts in turns, on one card.

    python3 tools/engine_ab.py PARENT_ROOT [CHANGE_ROOT] [--writes N]
                               [--pairs P]

Each run is a fresh process that imports one checkout's
`chip_smoke.main_phase` (and that checkout's `src/repro_torch`, whose
kernels it builds into its own `build/`) and drives the paper-geometry
engine through N writes and the lookups, scans and aggregates that scale
with them, every answer checked against the numpy oracle. It prints one
JSON line of rates. The runs go parent, change, change, parent for each
pair, so both checkouts meet the same card and the same drift; the last
line is the JSON list of every run. CHANGE_ROOT defaults to this
checkout. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
RATES = ("insert_ops_per_s", "lookup_ops_per_s", "scans_per_s",
         "aggregates_per_s")


def child(root: str, writes: int) -> int:
    """One run: the checkout at `root`, its main phase at `writes`."""
    sys.path[:0] = [root, str(Path(root) / "src")]
    import torch
    import chip_smoke as CS
    if not torch.cuda.is_available():
        print("engine_ab: no CUDA device", file=sys.stderr)
        return 2
    _, rec = CS.main_phase(torch.device("cuda"), 0, writes)
    print(json.dumps({"root": root, **{k: rec[k] for k in RATES}}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("parent")
    ap.add_argument("change", nargs="?", default=str(HERE))
    ap.add_argument("--writes", type=int, default=2_000_000)
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.parent, args.writes)
    runs = []
    order = [args.parent, args.change, args.change, args.parent]
    for i in range(args.pairs):
        for root in order if i % 2 == 0 else order[::-1]:
            root = str(Path(root).resolve())
            out = subprocess.run(
                [sys.executable, __file__, root, "--child", "--writes",
                 str(args.writes)], capture_output=True, text=True,
                timeout=900)
            if out.returncode:
                print(out.stdout[-2000:], out.stderr[-4000:], file=sys.stderr)
                return out.returncode
            rec = json.loads(out.stdout.strip().splitlines()[-1])
            rec["side"] = "parent" if root == str(
                Path(args.parent).resolve()) else "change"
            print(json.dumps(rec), flush=True)
            runs.append(rec)
    print(json.dumps(runs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
