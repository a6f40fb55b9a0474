"""Data pipeline (port of `repro.data.pipeline`).

`TokenStream` — deterministic synthetic LM batches, seeded by
(seed, step, host_id) and split by (host_id, n_hosts): each host draws
only its slice, with no cross-host data motion. Its batches are numpy,
bit for bit the reference's; a train step moves them to the model's
device.

`KVWorkload` and `make_kv_workload`, the per-figure KV workload
generator, live in `repro_torch.bench.workloads`; this module re-exports
them, as the reference's does.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np


class TokenStream:
    """Deterministic sharded synthetic token batches: {"tokens",
    "labels"} int32 (B / n_hosts, seq), labels the tokens shifted by
    one."""

    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0,
                 host_id: int = 0, n_hosts: int = 1):
        if batch % n_hosts:
            raise ValueError(f"batch {batch} does not split over {n_hosts} "
                             f"hosts")
        self.vocab, self.batch, self.seq = vocab, batch, seq
        self.local_batch = batch // n_hosts
        self.host_id, self.n_hosts = host_id, n_hosts
        self.seed = seed
        self.step = 0

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        rng = np.random.default_rng((self.seed, self.step, self.host_id))
        toks = rng.integers(0, self.vocab,
                            size=(self.local_batch, self.seq + 1),
                            dtype=np.int32)
        self.step += 1
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


# The KV workload generators live in `repro_torch.bench.workloads` (the
# benchmark's package owns workload definitions); re-exported here as
# the reference re-exports its own.
from repro_torch.bench.workloads import KVWorkload, make_kv_workload  # noqa: E402,F401
