#!/usr/bin/env python3
"""Where a range_merge CTA spends its time, on one CUDA card.

    python3 tools/range_merge_phases.py [--seed N]

Builds an instrumented copy of `src/repro_torch/csrc/range_merge.cu`
into `build/range_merge_phases/` — thread 0 of every CTA reads the
card's `%globaltimer` at the end of each phase — runs `range_merge` on
the `chip_smoke.py` scan rows (32 rows of 91 segments, 512 lanes and
16,384 lanes), checks the result against the plain version, and prints
one JSON line per case: each phase's median and largest time over the
CTAs (µs), the CTAs' start times, and the device time per kernel. The
phases of `range_split_kernel`: the row's offsets and sample bounds,
loading the samples, the shared-memory merge, the rank table, the tile
boundaries. Of `range_tile_kernel`: offsets, tile count, the tile's
bounds (lane counts, prefix, next key), loading the lanes, the
shared-memory merge, writing. The stamps are placed by matching lines of the source; the
script fails if one is not found. The shipped kernels carry no stamps.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "range_merge_phases"

_PRELUDE = r'''
__device__ long long g_tile[8192][8];
__device__ long long g_split[1024][6];
__device__ __forceinline__ long long gtime() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define TSTAMP(i) if (threadIdx.x == 0) \
  g_tile[blockIdx.y * gridDim.x + blockIdx.x][i] = gtime();
#define SSTAMP(i) if (threadIdx.x == 0) g_split[blockIdx.y][i] = gtime();
'''

_READER = r'''
extern "C" int range_phases_clear() {
  void *tile, *split;
  cudaGetSymbolAddress(&tile, g_tile);
  cudaGetSymbolAddress(&split, g_split);
  cudaMemset(tile, 0, sizeof(g_tile));
  cudaMemset(split, 0, sizeof(g_split));
  return static_cast<int>(cudaGetLastError());
}
extern "C" int range_phases_read(void* tile, void* split) {
  cudaMemcpyFromSymbol(tile, g_tile, sizeof(g_tile));
  cudaMemcpyFromSymbol(split, g_split, sizeof(g_split));
  return static_cast<int>(cudaGetLastError());
}
'''

# (a piece of the source, found once, and what it becomes)
_STAMPS = [
    ("  const int n_samp = row_samples(offsets, q, n_seg, step, off, base);"
     "\n  for (int x0",
     "  SSTAMP(0)\n  const int n_samp = row_samples(offsets, q, n_seg, "
     "step, off, base);\n  SSTAMP(1)\n  for (int x0"),
    ("  const int cur = slsm::merge_in_shared(buf, cap, base, n_seg, "
     "n_samp);",
     "  SSTAMP(2)\n  const int cur = slsm::merge_in_shared(buf, cap, base, "
     "n_seg, n_samp);\n  SSTAMP(3)"),
    ("  const int n_tiles = (n_samp + group - 1) / group;\n  for (int b = "
     "threadIdx.x >> 5",
     "  SSTAMP(4)\n  const int n_tiles = (n_samp + group - 1) / group;\n"
     "  for (int b = threadIdx.x >> 5"),
    ("                split + (static_cast<int64_t>(q) * tiles + b)"
     " * n_seg);\n  }\n}",
     "                split + (static_cast<int64_t>(q) * tiles + b)"
     " * n_seg);\n  }\n  __syncthreads();\n  SSTAMP(5)\n}"),
    ("  int32_t* bnd = hi + n_seg;                // (n_seg + 1,) tile "
     "bounds\n",
     "  int32_t* bnd = hi + n_seg;\n  TSTAMP(0)\n"),
    ("  const int total = off[n_seg];\n  auto seg_len",
     "  TSTAMP(1)\n  const int total = off[n_seg];\n  auto seg_len"),
    ("  if (j < n_tiles) {\n", "  TSTAMP(2)\n  if (j < n_tiles) {\n"),
    ("    const int n = bnd[n_seg];\n",
     "    TSTAMP(3)\n    const int n = bnd[n_seg];\n"),
    ("    const int4* out = buf + slsm::merge_in_shared(buf, tile, bnd, "
     "n_seg, n)\n                            * tile;",
     "    TSTAMP(4)\n    const int4* out = buf + slsm::merge_in_shared(buf, "
     "tile, bnd, n_seg, n) * tile;\n    TSTAMP(5)"),
    ("  // the row's lanes past `total` are padding, shared by its CTAs",
     "  __syncthreads();\n  TSTAMP(6)\n"
     "  // the row's lanes past `total` are padding, shared by its CTAs"),
]


def instrumented_source() -> str:
    src = (ROOT / "src/repro_torch/csrc/range_merge.cu").read_text()
    src = src.replace("namespace {\n", "namespace {\n" + _PRELUDE, 1)
    for piece, stamped in _STAMPS:
        if src.count(piece) != 1:
            raise SystemExit(f"stamp anchor not found once: {piece!r}")
        src = src.replace(piece, stamped)
    return src + _READER


def phases(stamps: np.ndarray) -> list[dict]:
    d = np.diff(stamps, axis=1) / 1e3
    return [dict(median_us=float(np.median(d[:, i])),
                 max_us=float(d[:, i].max())) for i in range(d.shape[1])]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("range_merge_phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as CS
    from repro_torch.kernels import _build
    from repro_torch.kernels import range_merge as KRM

    OUT.mkdir(parents=True, exist_ok=True)
    cu = OUT / "range_merge_phases.cu"
    cu.write_text(instrumented_source())
    so = OUT / "librange_merge_phases.so"
    built = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                            str(_build.CSRC), "-o", str(so), str(cu)],
                           capture_output=True, text=True)
    if built.returncode:
        raise SystemExit(f"nvcc failed:\n{built.stdout}{built.stderr}")
    _build.build_all()
    lib = ctypes.CDLL(str(so))
    _build._LIBS["range_merge"] = lib       # the wrapper launches this copy
    _build._BOUND.clear()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    rng = np.random.default_rng(args.seed)
    dev = torch.device("cuda")
    for name, c_n in (("main", 512), ("wide", CS.RANGE_WIDE)):
        q_n, n_seg = CS.SCAN_BATCH, 91
        lanes = [torch.from_numpy(a).to(dev)
                 for a in CS.scan_rows(rng, q_n, c_n, n_seg)]
        for _ in range(5):                  # warm up, L2 as the smoke has it
            got = KRM.range_merge(*lanes, True)
        torch.cuda.synchronize()
        for g, w in zip(got, KRM.range_merge_plain(*lanes, True)):
            if not torch.equal(g, w):
                raise AssertionError(f"{name}: differs from plain")
        tile = np.zeros((8192, 8), np.int64)
        split = np.zeros((1024, 6), np.int64)
        lib.range_phases_clear()
        KRM.range_merge(*lanes, True)
        torch.cuda.synchronize()
        lib.range_phases_read(ctypes.c_void_p(tile.ctypes.data),
                              ctypes.c_void_p(split.ctypes.data))
        geo = KRM.ops.range_geometry(c_n, n_seg)
        tile = tile[:geo[3] * q_n]
        real = tile[:, 3] > 0                # CTAs that merged a tile
        t0 = tile[:, 0].min()
        rec = dict(case=name, shape=f"Q={q_n} C={c_n} P={n_seg}",
                   tile_ctas=len(tile), tiles_merged=int(real.sum()))
        if geo[1]:
            split = split[:q_n]
            t0 = min(t0, split[:, 0].min())
            rec["split_phases"] = dict(zip(
                ("row bounds", "load samples", "merge", "rank table",
                 "boundaries"), phases(split)))
            rec["split_end_us"] = float((split[:, 5].max() - t0) / 1e3)
        rec["tile_phases"] = dict(zip(
            ("offsets", "tile count", "tile bounds", "load lanes", "merge",
             "write"), phases(tile[real][:, :7])))
        start = (tile[:, 0] - t0) / 1e3
        rec["tile_start_us"] = dict(min=float(start.min()),
                                    median=float(np.median(start)),
                                    max=float(start.max()))
        rec["tile_end_us"] = float((tile[:, 6].max() - t0) / 1e3)
        rec["device_ms_by_kernel"] = {
            CS.kernel_name(k): v for k, v in CS.device_ms_by_name(
                lambda: KRM.range_merge(*lanes, True), 20).items()}
        print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
