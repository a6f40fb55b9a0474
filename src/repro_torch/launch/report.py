"""Report sections from the dry run's records: the roofline table, a
before/after table of two record sets and the sweep's summary (port of
`repro.launch.report`; the same text from the same records). A record
set is a directory under BASE (`build/`), the dry run's own being
`dryrun_torch`.
"""
from __future__ import annotations

import glob
import json
import os

from repro_torch.launch.dryrun import RESULTS_DIR

BASE = str(RESULTS_DIR.parent)


def load(d, mesh=None):
    recs = {}
    for f in sorted(glob.glob(os.path.join(BASE, d, "*.json"))):
        with open(f) as fh:
            r = json.load(fh)
        if mesh and r.get("mesh") != mesh:
            continue
        recs[(r["arch"], r["shape"], r["mesh"])] = r
    return recs


def _fmt(x, digits=2):
    if x is None:
        return "-"
    return f"{x:.{digits}e}"


def roofline_table(recs: dict, mesh: str) -> str:
    rows = ["| arch | shape | t_compute | t_memory | t_collective | "
            "bottleneck | useful-FLOP ratio | roofline frac | note |",
            "|---|---|---|---|---|---|---|---|---|"]
    for (arch, shape, m), r in sorted(recs.items()):
        if m != mesh:
            continue
        if "skipped" in r:
            rows.append(f"| {arch} | {shape} | - | - | - | - | - | - | "
                        f"SKIP (documented) |")
            continue
        if "error" in r:
            rows.append(f"| {arch} | {shape} | - | - | - | - | - | - | "
                        f"ERROR |")
            continue
        note = "sLSM-KV decode" if r.get("decode_kind") == "lsm" else ""
        rows.append(
            f"| {arch} | {shape} | {_fmt(r['t_compute'])} | "
            f"{_fmt(r['t_memory'])} | {_fmt(r['t_collective'])} | "
            f"{r['bottleneck']} | {r['useful_flops_ratio']:.3f} | "
            f"{r.get('roofline_fraction', 0):.3f} | {note} |")
    return "\n".join(rows)


def before_after(base: dict, opt: dict, cells) -> str:
    rows = ["| cell | metric | baseline | optimized | delta |",
            "|---|---|---|---|---|"]
    for arch, shape in cells:
        b = base.get((arch, shape, "pod16x16"), {})
        o = opt.get((arch, shape, "pod16x16"), {})
        if not b or not o or "t_compute" not in b or "t_compute" not in o:
            continue
        for key, label in (("t_collective", "t_collective (s)"),
                           ("t_memory", "t_memory (s)"),
                           ("t_compute", "t_compute (s)")):
            bb, oo = b[key], o[key]
            delta = (f"{bb/oo:,.0f}x lower" if oo and bb > oo * 1.05 else
                     (f"{oo/bb:.2f}x higher" if bb and oo > bb * 1.05
                      else "~same"))
            rows.append(f"| {arch} x {shape} | {label} | {_fmt(bb)} | "
                        f"{_fmt(oo)} | {delta} |")
        bd = max(b["t_compute"], b["t_memory"], b["t_collective"])
        od = max(o["t_compute"], o["t_memory"], o["t_collective"])
        rows.append(f"| {arch} x {shape} | **step-time bound (s)** | "
                    f"{_fmt(bd)} | {_fmt(od)} | **{bd/od:,.1f}x faster** |")
    return "\n".join(rows)


def dryrun_summary(opt: dict) -> str:
    """The sweep in a few lines; `compile_s` is a cell's trace time."""
    ok = sum(1 for r in opt.values()
             if "error" not in r and "skipped" not in r)
    skip = sum(1 for r in opt.values() if "skipped" in r)
    fail = sum(1 for r in opt.values() if "error" in r)
    heavy = sorted((r for r in opt.values() if "memory" in r),
                   key=lambda r: -r["memory"].get("temp_size_in_bytes", 0))
    lines = [f"- cells: **{ok} compiled ok**, {skip} documented skips, "
             f"{fail} failures, across meshes (16,16) and (2,16,16).",
             "- heaviest per-device temp footprints (optimized):"]
    for r in heavy[:5]:
        t = r["memory"]["temp_size_in_bytes"] / 1e9
        lines.append(f"  - {r['arch']} x {r['shape']} ({r['mesh']}): "
                     f"temp {t:.1f} GB/device, args "
                     f"{r['memory']['argument_size_in_bytes']/1e9:.1f} GB")
    comp = sorted((r for r in opt.values() if "compile_s" in r),
                  key=lambda r: -r["compile_s"])[:3]
    lines.append("- slowest compiles: " + ", ".join(
        f"{r['arch']}x{r['shape']} {r['compile_s']:.0f}s" for r in comp))
    return "\n".join(lines)
