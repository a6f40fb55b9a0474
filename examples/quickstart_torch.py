"""Quickstart: the Skiplist-Based LSM Tree as a PyTorch key-value engine
(the twin of `examples/quickstart.py`, on the port).

Run:  PYTHONPATH=src python examples/quickstart_torch.py
      (on the CUDA card, where the hot primitives are the port's CUDA
      kernels; --device cpu runs their plain PyTorch versions)

Every section asserts its output, so this file doubles as a smoke test.
The engine API lives in `repro_torch.engine`.
"""
import argparse

import numpy as np

from repro_torch.configs.slsm_paper import paper_params
from repro_torch.engine import SLSM

def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    # The paper's tuned baseline (Section 3), scaled to laptop size:
    # mu=512 -> 64, R=50 -> 8, Rn=800 -> 256, D=20 -> 4, eps=1e-3 kept.
    params = paper_params(R=8, Rn=256, D=4, mu=64, max_levels=3)
    store = SLSM(params, device=args.device)

    rng = np.random.default_rng(0)
    keys = rng.choice(2**24, size=50_000, replace=False).astype(np.int32)
    vals = rng.integers(0, 2**20, size=keys.shape).astype(np.int32)

    print(f"inserting {len(keys):,} keys on {store.device} "
          f"(R={params.R}, Rn={params.Rn}, eps={params.eps}, "
          f"D={params.D}, m={params.m}, mu={params.mu}) ...")
    store.insert(keys, vals)
    assert store.n_levels >= 1 and store.n_live >= len(keys) // 2
    print(f"  -> {store.n_levels} disk levels, ~{store.n_live:,} stored "
          f"entries, "
          f"merges: {dict(store.stats)}")

    # batched point lookups: all 1,000 queries in one batch (one Bloom probe
    # launch over every disk level, min/max gates, a fence-pointer page
    # search a level — paper 2.3/2.4/2.7)
    got, found = store.lookup_many(keys[:1000])
    assert found.all() and (got == vals[:1000]).all()
    print("lookup_many of 1,000 present keys: all found, all correct")

    absent = (keys[:1000].astype(np.int64) + 2**25).astype(np.int32)
    _, found = store.lookup_many(absent)
    assert not found.any()  # Bloom FPs are filtered by the exact key match
    print("lookup_many of 1,000 absent keys: none found")

    # deletes are weight -1 records (paper 2.8's tombstones recast as Z-set
    # retractions, DESIGN.md §13); merges annihilate matched insert/delete
    # pairs without ever touching their payloads
    store.delete(keys[:10])
    _, found = store.lookup(keys[:10])
    assert not found.any()
    print("deleted 10 keys: lookups now miss")

    # range query (paper 2.9): newest-wins, deleted keys elided, key-sorted
    lo, hi = 2**20, 2**20 + 2**16
    rk, rv = store.range(lo, hi)
    expect = np.sort(keys[(keys >= lo) & (keys < hi)])
    expect = expect[~np.isin(expect, keys[:10])]
    assert (rk == expect).all()
    kv = dict(zip(keys.tolist(), vals.tolist()))  # keys are drawn unique
    assert all(kv[k] == v for k, v in zip(rk.tolist(), rv.tolist()))
    print(f"range [{lo}, {hi}): {len(rk)} results, key-sorted, values "
          f"verified")

    # batched aggregates (DESIGN.md §13): count/sum over a key range ride
    # the fence-pruned scan machinery without materializing the rows
    cnt, total = store.count(lo, hi), store.sum(lo, hi)
    assert cnt == len(rk)
    # int32 wraparound
    assert total == int(rv.astype(np.int32).sum(dtype=np.int32))
    print(f"count/sum over [{lo}, {hi}): {cnt} rows, sum {total}")
    print("quickstart OK")


if __name__ == "__main__":
    main()
