"""Carry parameters and state between the reference and the port.

The reference's state is a pytree whose leaves, in
`jax.tree_util.tree_leaves` order, are the `SLSMState` fields in order
with each `LevelState` flattened in place — the order its snapshots are
written in. The port's `SLSMState` keeps the same field order, so the
leaf lists line up one to one. Blooms are uint32 in the reference and
int32 words holding the same bits here (trap T6).

Nothing here imports the reference: parameters travel as the dict of
`dataclasses.asdict`, state as numpy arrays.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.params import SLSMParams, TuningPolicy
from repro_torch.engine.levels import LevelState
from repro_torch.engine.memtable import SLSMState

_N_TOP = len(SLSMState._fields) - 1      # leaves before the levels tuple
_N_LEVEL = len(LevelState._fields)


def params_from_dict(d: dict) -> SLSMParams:
    """The port's `SLSMParams` from `dataclasses.asdict` of a reference
    parameter set: `backend` is dropped, `tuning` rebuilt."""
    d = dict(d)
    d.pop("backend", None)
    if isinstance(d.get("tuning"), dict):
        d["tuning"] = TuningPolicy(**d["tuning"])
    if d.get("eps_per_level") is not None:
        d["eps_per_level"] = tuple(d["eps_per_level"])
    return SLSMParams(**d)


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.tensor(np.ascontiguousarray(a), dtype=torch.int32,
                        device=device)


def state_from_leaves(params: SLSMParams, leaves: Sequence,
                      device) -> SLSMState:
    """The port's state from numpy leaves in reference leaf order; the
    number of disk levels follows from the leaf count."""
    del params  # the geometry is carried by the leaves' shapes
    extra = len(leaves) - _N_TOP
    if extra < 0 or extra % _N_LEVEL:
        raise ValueError(f"{len(leaves)} leaves do not form an SLSMState")
    top = [_tensor(a, device) for a in leaves[:_N_TOP]]
    levels = tuple(
        LevelState(*(_tensor(a, device)
                     for a in leaves[_N_TOP + i * _N_LEVEL:
                                     _N_TOP + (i + 1) * _N_LEVEL]))
        for i in range(extra // _N_LEVEL))
    return SLSMState(*top, levels)


def state_to_leaves(state: SLSMState) -> list[np.ndarray]:
    """Numpy leaves in reference leaf order (blooms as int32 words)."""
    out = [t.cpu().numpy() for t in state[:_N_TOP]]
    for lv in state.levels:
        out += [t.cpu().numpy() for t in lv]
    return out
