"""Reference semantics model: a plain dict with LSM-visible behaviour.

A copy of `repro.core.oracle.DictOracle`, kept in the port so that
`chip_smoke.py` can check the engine's answers without importing the
JAX package. The engine and this model take identical op sequences and must
give identical observable results (lookup values / found flags, range
contents, windowed aggregates).

Presence is tracked explicitly: a delete removes the key rather than
storing a reserved value, so every int32 is a legal payload.
"""
from __future__ import annotations

import numpy as np


class DictOracle:
    def __init__(self):
        self.d: dict[int, int] = {}

    def insert(self, keys, vals) -> None:
        for k, v in zip(np.asarray(keys).reshape(-1).tolist(),
                        np.asarray(vals).reshape(-1).tolist()):
            self.d[int(k)] = int(v)

    def delete(self, keys) -> None:
        for k in np.asarray(keys).reshape(-1).tolist():
            self.d.pop(int(k), None)

    def apply(self, keys, vals, wts) -> None:
        """Weighted write chunk (the WAL replay form): weight +1 inserts
        the pair, weight <= 0 deletes the key."""
        for k, v, w in zip(np.asarray(keys).reshape(-1).tolist(),
                           np.asarray(vals).reshape(-1).tolist(),
                           np.asarray(wts).reshape(-1).tolist()):
            if int(w) > 0:
                self.d[int(k)] = int(v)
            else:
                self.d.pop(int(k), None)

    def lookup(self, keys):
        vals, found = [], []
        for k in np.asarray(keys).reshape(-1).tolist():
            v = self.d.get(int(k))
            ok = v is not None
            vals.append(v if ok else 0)
            found.append(ok)
        return np.asarray(vals, np.int32), np.asarray(found, bool)

    def range(self, lo: int, hi: int):
        items = sorted((k, v) for k, v in self.d.items() if lo <= k < hi)
        if not items:
            return np.zeros(0, np.int32), np.zeros(0, np.int32)
        ks, vs = zip(*items)
        return np.asarray(ks, np.int32), np.asarray(vs, np.int32)

    def aggregate(self, lo: int, hi: int):
        """(count, sum) over the live keys in [lo, hi); the sum matches
        the engine's int32 wraparound arithmetic."""
        total = 0
        count = 0
        for k, v in self.d.items():
            if lo <= k < hi:
                count += 1
                total += v
        return count, (total + 2 ** 31) % 2 ** 32 - 2 ** 31
