"""Roofline table generator: reads the dry run's records, emits the
roofline markdown table and each cell's bottleneck (port of
`repro.launch.roofline`; the same text from the same records).

    python -m repro_torch.launch.roofline [--mesh pod16x16]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch.dryrun import RESULTS_DIR

FIX_HINTS = {
    "compute": "already compute-bound: raise tensor-core utilization "
               "(larger tiles, fewer recomputed checkpoints)",
    "memory": "cut HBM traffic: fuse the elementwise glue, bf16 "
              "master-weight reads, fewer recomputed checkpoints",
    "collective": "re-shard to cut collective payloads (local expert/block "
                  "top-k, reduce-scatter instead of all-gather, overlap)",
}


def load(mesh: str = "pod16x16") -> list[dict]:
    recs = []
    for f in sorted(glob.glob(os.path.join(RESULTS_DIR, "*.json"))):
        with open(f) as fh:
            r = json.load(fh)
        if r.get("mesh") == mesh:
            recs.append(r)
    return recs


def fmt_s(x):
    if x is None:
        return "-"
    if x == 0:
        return "0"
    return f"{x:.2e}"


def table(mesh: str = "pod16x16") -> str:
    rows = [
        "| arch | shape | t_compute (s) | t_memory (s) | t_collective (s) "
        "| bottleneck | MODEL_FLOPs/HLO | roofline frac | note |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in load(mesh):
        if "skipped" in r:
            rows.append(f"| {r['arch']} | {r['shape']} | - | - | - | - | - "
                        f"| - | SKIP: {r['skipped'][:60]}... |")
            continue
        if "error" in r:
            rows.append(f"| {r['arch']} | {r['shape']} | - | - | - | - | - "
                        f"| - | ERROR |")
            continue
        note = r.get("decode_kind") or ""
        if note == "lsm":
            note = "sLSM-KV tiered decode"
        frac = r.get("roofline_fraction")
        rows.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(r['t_compute'])} | "
            f"{fmt_s(r['t_memory'])} | {fmt_s(r['t_collective'])} | "
            f"{r['bottleneck']} | "
            f"{r['useful_flops_ratio']:.3f} | "
            f"{frac:.3f} | {note} |")
    return "\n".join(rows)


def pick_hillclimb(mesh: str = "pod16x16") -> dict:
    recs = [r for r in load(mesh) if "t_compute" in r]
    worst = min(recs, key=lambda r: r.get("roofline_fraction") or 1)
    coll = max(recs, key=lambda r: (r["t_collective"] /
                                    max(max(r["t_compute"], r["t_memory"]),
                                        1e-30)))
    lsm = [r for r in recs if r.get("decode_kind") == "lsm"]
    rep = max(lsm, key=lambda r: r["t_collective"]) if lsm else None
    return {"worst_fraction": worst, "most_collective_bound": coll,
            "paper_representative": rep}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="pod16x16")
    args = ap.parse_args(argv)
    print(table(args.mesh))
    print()
    picks = pick_hillclimb(args.mesh)
    for why, r in picks.items():
        if r:
            print(f"hillclimb[{why}]: {r['arch']} x {r['shape']} "
                  f"(bottleneck={r['bottleneck']}, "
                  f"frac={r.get('roofline_fraction'):.3f})")


if __name__ == "__main__":
    main()
