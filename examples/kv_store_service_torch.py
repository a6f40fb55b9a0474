"""End to end: serve a mixed key-value workload through the sLSM —
the paper's system under its intended load (Section 3.8's update:lookup
mixes), with batched requests, as a service loop (the twin of
`examples/kv_store_service.py`, on the PyTorch port).

Run:  PYTHONPATH=src python examples/kv_store_service_torch.py [--requests 200000]
      (on the CUDA card; --device cpu runs the plain PyTorch path)
"""
import argparse
import time

import numpy as np

from repro_torch.configs.slsm_paper import paper_params
from repro_torch.core import SLSM
from repro_torch.data import make_kv_workload


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=200_000)
    ap.add_argument("--lookup-frac", type=float, default=0.5)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    params = paper_params(R=8, Rn=512, D=4, mu=64, max_levels=4,
                          max_range=4096)
    store = SLSM(params, device=args.device)
    w = make_kv_workload("uniform", args.requests, seed=0,
                         lookup_frac=args.lookup_frac)

    n_ins = len(w.keys)
    n_lkp = (len(w.lookups) // args.batch) * args.batch
    print(f"serving {n_ins:,} inserts + {n_lkp:,} lookups "
          f"(batch={args.batch}) ...")

    t0 = time.perf_counter()
    ins_done = lkp_done = 0
    lkp_off = 0
    # interleave: service loop alternates insert chunks and lookup batches
    for off in range(0, n_ins, args.batch * 4):
        store.insert(w.keys[off:off + args.batch * 4],
                     w.vals[off:off + args.batch * 4])
        ins_done += min(args.batch * 4, n_ins - off)
        if lkp_off + args.batch <= n_lkp:
            got, found = store.lookup(w.lookups[lkp_off:lkp_off + args.batch])
            lkp_done += args.batch
            lkp_off += args.batch
    # drain remaining lookups
    while lkp_off + args.batch <= n_lkp:
        store.lookup(w.lookups[lkp_off:lkp_off + args.batch])
        lkp_done += args.batch
        lkp_off += args.batch
    dt = time.perf_counter() - t0

    total = ins_done + lkp_done
    print(f"done in {dt:.2f}s: {total/dt:,.0f} ops/s "
          f"({ins_done/dt:,.0f} ins/s + {lkp_done/dt:,.0f} lkp/s)")
    print(f"store: {store.n_levels} levels, ~{store.n_live:,} entries")

    # verification pass
    sample = np.random.default_rng(1).choice(n_ins, 2000, replace=False)
    got, found = store.lookup(w.keys[sample])
    # duplicate keys in the stream: newest value wins — verify via dict
    truth = {}
    for k, v in zip(w.keys.tolist(), w.vals.tolist()):
        truth[k] = v
    expect = np.asarray([truth[k] for k in w.keys[sample].tolist()])
    assert found.all() and (got == expect).all()
    print("verification: 2,000 sampled keys all correct (newest-wins)")


if __name__ == "__main__":
    main()
