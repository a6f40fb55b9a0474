"""Shape-only runs: the one hook between the port's code and a cost
counter, so that the kernels and the models know nothing of the tool
that counts them.

A `FakeTensor` holds a shape and a dtype and no data. Where the port's
code needs data that a fake input lacks — a hand-written kernel's
launch, a value read to the host — it asks `active(*tensors)`. That is
False for real tensors. For fake ones it is True while a counter has
installed itself here (`install`), and raises otherwise: no run outside
a counter takes a shape-only path, so none can return an empty output
as if it were a result. The entry point then records its kernel's work
(`record_kernel`) with every installed counter.
"""
from __future__ import annotations

import torch

_COUNTERS: list = []


def install(counter) -> None:
    """Make `counter` (it has `add_kernel(name, flops, bytes)`) active."""
    _COUNTERS.append(counter)


def remove(counter) -> None:
    _COUNTERS.remove(counter)


def active(*ts) -> bool:
    """Whether this call is shape-only: some input is a `FakeTensor`
    (a DTensor over fake shards too). Raises RuntimeError for fake
    inputs while no counter is installed."""
    from torch._subclasses.fake_tensor import is_fake
    if not any(isinstance(t, torch.Tensor) and is_fake(t) for t in ts):
        return False
    if not _COUNTERS:
        raise RuntimeError(
            "FakeTensor inputs outside a cost counter: a shape-only run "
            "computes no values and is taken only while one counts")
    return True


def record_kernel(name: str, flops: float, n_bytes: float) -> None:
    """Add one call of hand-written kernel `name` to every counter."""
    for c in _COUNTERS:
        c.add_kernel(name, flops, n_bytes)


def host_ints(t: torch.Tensor) -> list[int]:
    """`t`'s values on the host (a DTensor's gathered whole). In a
    shape-only run (`active`) there are none: they read as 0."""
    if active(t):
        return [0] * t.shape[0]
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.tolist()
