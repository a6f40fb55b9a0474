"""Paper-faithful skiplist (Section 2.2): the CPU oracle, the port's own
copy of `repro.core.skiplist_ref` (numpy only).

It implements the two optimizations as published:
  * 2.2.1 Fast Random Levels: draw MAXLEVEL random bits, level =
    find-first-set => geometric(p=0.5) in O(1), MAXLEVEL = 16.
  * 2.2.2 Vertical Arrays, Horizontal Pointers: a node owns one key, one
    value and a dense *array* of forward pointers (the vertical column);
    descending a level reads the next array slot instead of chasing a
    pointer.

This is not the engine's path (pointer chasing does not map to a GPU
either: the engine keeps runs as dense sorted tensors); it documents the
paper's structure, oracle-tests buffer semantics and checks
`fast_geometric_levels` against an independent implementation. Given
the same seed and ops it draws the same levels as the reference's copy.
"""
from __future__ import annotations

import numpy as np

MAXLEVEL = 16


def ffs_level(rng: np.random.Generator, maxlevel: int = MAXLEVEL) -> int:
    """Paper 2.2.1: MAXLEVEL random bits -> find-first-set (1-based)."""
    bits = int(rng.integers(0, 1 << maxlevel))
    if bits == 0:
        return maxlevel
    return min((bits & -bits).bit_length(), maxlevel)


class _Node:
    __slots__ = ("key", "val", "fwd")

    def __init__(self, key, val, level):
        self.key = key
        self.val = val
        self.fwd: list = [None] * level  # the vertical pointer column


class SkipListRef:
    """Ordered map with paper-exact insert/lookup/range (update-in-place on
    duplicate keys, per 3.9.1)."""

    def __init__(self, seed: int = 0, maxlevel: int = MAXLEVEL):
        self.maxlevel = maxlevel
        self.rng = np.random.default_rng(seed)
        self.head = _Node(None, None, maxlevel)
        self.level = 1
        self.n = 0

    def _find_update(self, key):
        update = [self.head] * self.maxlevel
        x = self.head
        for lvl in range(self.level - 1, -1, -1):
            while x.fwd[lvl] is not None and x.fwd[lvl].key < key:
                x = x.fwd[lvl]
            update[lvl] = x
        return update

    def insert(self, key: int, val: int) -> None:
        update = self._find_update(key)
        nxt = update[0].fwd[0]
        if nxt is not None and nxt.key == key:  # paper 3.9.1: update in place
            nxt.val = val
            return
        lvl = ffs_level(self.rng, self.maxlevel)
        self.level = max(self.level, lvl)
        node = _Node(key, val, lvl)
        for i in range(lvl):
            node.fwd[i] = update[i].fwd[i]
            update[i].fwd[i] = node
        self.n += 1

    def lookup(self, key: int):
        x = self.head
        for lvl in range(self.level - 1, -1, -1):
            while x.fwd[lvl] is not None and x.fwd[lvl].key < key:
                x = x.fwd[lvl]
        x = x.fwd[0]
        if x is not None and x.key == key:
            return x.val
        return None

    def range(self, lo: int, hi: int):
        """Paper 2.9: locate smallest key >= lo, walk level-0 until >= hi."""
        x = self.head
        for lvl in range(self.level - 1, -1, -1):
            while x.fwd[lvl] is not None and x.fwd[lvl].key < lo:
                x = x.fwd[lvl]
        x = x.fwd[0]
        out = []
        while x is not None and x.key < hi:
            out.append((x.key, x.val))
            x = x.fwd[0]
        return out

    def items(self):
        out = []
        x = self.head.fwd[0]
        while x is not None:
            out.append((x.key, x.val))
            x = x.fwd[0]
        return out
