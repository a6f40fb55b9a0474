#!/usr/bin/env python3
"""bloom_probe's compile-time schedules side by side, on one CUDA card.

    git show <commit>:src/repro_torch/csrc/bloom_probe.cu \\
        > build/bloom_parent/bloom_probe.cu            # optional
    python3 tools/bloom_probe_schedules.py \\
        [--parent-src build/bloom_parent/bloom_probe.cu] [--seed N] \\
        [--schedules 1,32,8,256 4,4,8,128 ...]

`csrc/bloom_probe.cu` takes four compile-time constants: BLOOM_GROUP (R,
the runs a thread probes together), BLOOM_BURST (J, the probes after
which a surviving chain loads the rest at once; 32 or more: never),
BLOOM_CHUNK (C, the probes a burst loads a batch) and BLOOM_BLOCK (B,
threads a CTA). The tool builds the file once for each schedule R,J,C,B
given (default: R in 1, 2, 4 by J in 3, 4, 5, off, C = 8, B = 128; and
the shipped R = 2, J = 4, C = 8 at B = 256) into
`build/bloom_probe_schedules/`, all nvcc processes at once, and, at each
`chip_smoke.py` bloom_probe shape (`bloom_shapes`), holds every build
bitwise against the plain version and prints one JSON line: the device
time a call of each build (torch.profiler, as `chip_smoke.py` takes it),
and, with `--parent-src` (a previous source with the one-level entry
`bloom_probe_launch`), the parent and the shipped build in turns
(parent, shipped, shipped, parent), one parent launch a level. The
card's name and power limit come first.
"""
from __future__ import annotations

import argparse
import array
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "bloom_probe_schedules"
DEFAULT = ([(r, j, 8, 128) for r in (1, 2, 4) for j in (3, 4, 5, 32)]
           + [(2, 4, 8, 256)])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent-src", type=Path,
                    help="a previous csrc/bloom_probe.cu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--schedules", nargs="*", default=None,
                    help="R,J,C,B quadruples (default: the grid above)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bloom_probe_schedules: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as CS
    from repro_torch.configs.slsm_paper import paper_params
    from repro_torch.kernels import _build
    from repro_torch.kernels import bloom_probe as KBP

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    schedules = ([tuple(int(x) for x in s.split(","))
                  for s in args.schedules] if args.schedules else DEFAULT)
    OUT.mkdir(parents=True, exist_ok=True)
    src = _build.CSRC / "bloom_probe.cu"
    jobs = {}
    for r, j, c, b in schedules:
        lib = OUT / f"libbloom_probe_r{r}_j{j}_c{c}_b{b}.so"
        jobs[(r, j, c, b)] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, f"-DBLOOM_GROUP={r}",
             f"-DBLOOM_BURST={j}", f"-DBLOOM_CHUNK={c}",
             f"-DBLOOM_BLOCK={b}", "-I",
             str(_build.CSRC), "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    parent_job = None
    if args.parent_src:
        lib = OUT / "libbloom_probe_parent.so"
        parent_job = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(lib), str(args.parent_src.resolve())],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    _build.build_all()
    builds = {}
    for key, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on schedule {key}:\n{log}")
        regs = [w for w in log.split("\n") if "registers" in w]
        so = ctypes.CDLL(str(lib))
        got = [ctypes.c_int() for _ in range(4)]
        so.bloom_probe_schedule(*(ctypes.byref(g) for g in got))
        if tuple(g.value for g in got) != key:
            raise AssertionError(f"build {lib.name} reports "
                                 f"{[g.value for g in got]}")
        fn = so.bloom_probe_levels_launch
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        builds["R={},J={},C={},B={}".format(*key)] = fn
        print(f"schedule {key}: {regs[-1].strip() if regs else log[-200:]}",
              flush=True)
    parent = None
    if parent_job is not None:
        log, _ = parent_job[1].communicate()
        if parent_job[1].returncode:
            raise RuntimeError(f"nvcc failed on the parent:\n{log}")
        parent = CS.parent_bloom_levels(parent_job[0])

    device = torch.device("cuda")
    p = paper_params(merge_budget=1, range_cand=512)
    rng = np.random.default_rng(args.seed)
    keys1, _, qs1 = CS.level1_data(p, device, rng)
    shapes = CS.bloom_shapes(p, device, rng, keys1, qs1)
    for shape, (stacks, qs) in shapes.items():
        want = [KBP.bloom_probe_plain(b, qs, k, bits) for b, k, bits in stacks]
        probes, ids = CS.bloom_need(stacks, qs)
        rec = dict(shape=shape, levels=[
            f"D={b.shape[0]} W={b.shape[1]} k={k} bits={bits}"
            for b, k, bits in stacks], q=qs.shape[0],
            members=sum(int(w.sum()) for w in want), chain_probes=probes,
            distinct_words=int(ids.numel()))

        rows = [b.shape[0] for b, _, _ in stacks]
        table = array.array("q", [     # as bloom_probe_levels passes it
            v for b, k, bits in stacks
            for v in (b.data_ptr(), b.shape[0], b.shape[1], k, bits)])

        def variant(fn, table=table, qs=qs, rows=rows):
            def call():
                out = torch.empty((sum(rows), qs.shape[0]), dtype=torch.bool,
                                  device=qs.device)
                _build.check(fn(qs.data_ptr(), out.data_ptr(),
                                table.buffer_info()[0], len(rows),
                                qs.shape[0],
                                torch.cuda.current_stream().cuda_stream),
                             "bloom_probe (schedule)")
                return out.split(rows)
            return call

        def shipped(stacks=stacks, qs=qs):
            return KBP.bloom_probe_levels(stacks, qs)

        for name, fn in builds.items():
            got = variant(fn)()
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"{name} differs from the plain "
                                     f"version at {shape}")
            rec[name] = CS.device_ms(variant(fn), 50)
        if parent is not None:
            def old(stacks=stacks, qs=qs):
                return parent(stacks, qs)
            if not all(torch.equal(g, w) for g, w in zip(old(), want)):
                raise AssertionError(f"the parent differs at {shape}")
            turns = [old, shipped, shipped, old]
            rec["turns"] = "parent, shipped, shipped, parent"
            rec["turns_ms"] = [CS.device_ms(f, 50) for f in turns]
            rec["turns_wall_ms"] = [CS.wall_ms(f, 50) for f in turns]
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
