"""Carry parameters and state between the reference and the port.

The reference's state is a pytree whose leaves, in
`jax.tree_util.tree_leaves` order, are the `SLSMState` fields in order
with each `LevelState` flattened in place — the order its snapshots are
written in. The port's `SLSMState` keeps the same field order, so the
leaf lists line up one to one. Blooms are uint32 in the reference and
int32 words holding the same bits here (trap T6); `state_to_leaves` and
`state_from_leaves` are the one place that carries state out of and
into the port, in the reference's order and dtypes, and the snapshot
codec (`engine.wal`) calls them.

The LM's parameters and decode caches travel as the reference's nested
dicts of numpy arrays (`lm_params_from_numpy`, `caches_from_numpy` and
their inverses).

Nothing here imports the reference: parameters travel as the dict of
`dataclasses.asdict`, state as numpy arrays.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.params import SLSMParams
from repro_torch.device import resolve_device
from repro_torch.engine.levels import LevelState
from repro_torch.engine.memtable import SLSMState, init_state
from repro_torch.engine.wal import params_from_dict  # noqa: F401

_N_TOP = len(SLSMState._fields) - 1      # leaves before the levels tuple
_N_LEVEL = len(LevelState._fields)
# the leaves the reference holds as uint32 (trap T6), by leaf position
_BLOOM_TOP = SLSMState._fields.index("buf_blooms")
_BLOOM_LEVEL = LevelState._fields.index("blooms")


def _is_bloom(i: int) -> bool:
    return (i == _BLOOM_TOP if i < _N_TOP
            else (i - _N_TOP) % _N_LEVEL == _BLOOM_LEVEL)


def _flat(state: SLSMState) -> list:
    """The state's tensors in reference leaf order."""
    out = list(state[:_N_TOP])
    for lv in state.levels:
        out += list(lv)
    return out


def _tensor(a, device) -> torch.Tensor:
    """The int32 tensor of leaf `a` (numpy array or tensor, int32 or the
    reference's uint32 words) on `device`; a 0-d leaf stays 0-d. Any
    other dtype raises."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.array(a, copy=True))
    if t.dtype == torch.uint32:
        t = t.view(torch.int32)
    if t.dtype != torch.int32:
        raise ValueError(f"state leaf of dtype {t.dtype}, expected int32 "
                         "(uint32 for blooms)")
    return t.to(device)


def state_from_leaves(params: SLSMParams, leaves: Sequence, device,
                      n_levels: int | None = None,
                      n_shards: int | None = None) -> SLSMState:
    """The port's state from leaves in reference leaf order (numpy arrays
    or tensors). The number of disk levels follows from the leaf count,
    and must equal `n_levels` where it is given; every leaf must have
    the shape `init_state(params)` gives it — with a leading dimension
    of `n_shards` for the sharded engine's stacked state. Raises
    otherwise."""
    extra = len(leaves) - _N_TOP
    if extra < 0 or extra % _N_LEVEL or (
            n_levels is not None and extra != n_levels * _N_LEVEL):
        raise ValueError(f"{len(leaves)} leaves do not form an SLSMState"
                         + ("" if n_levels is None
                            else f" of {n_levels} disk levels"))
    want = _flat(init_state(params, "meta", extra // _N_LEVEL, n_shards))
    for i, (a, w) in enumerate(zip(leaves, want)):
        if tuple(a.shape) != tuple(w.shape):
            raise ValueError(f"state leaf {i} has shape {tuple(a.shape)}, "
                             f"expected {tuple(w.shape)}")
    ts = [_tensor(a, device) for a in leaves]
    levels = tuple(LevelState(*ts[_N_TOP + i * _N_LEVEL:
                                  _N_TOP + (i + 1) * _N_LEVEL])
                   for i in range(extra // _N_LEVEL))
    return SLSMState(*ts[:_N_TOP], levels)


def state_to_leaves(state: SLSMState) -> list[np.ndarray]:
    """The state's leaves as numpy arrays in reference leaf order and
    dtypes (blooms as uint32 views of the int32 words); a stacked state
    keeps its leading shard dimension."""
    out = [t.cpu().numpy() for t in _flat(state)]
    return [a.view(np.uint32) if _is_bloom(i) else a
            for i, a in enumerate(out)]


# --------------------------------------------------------------------------
# LM parameters and decode caches
# --------------------------------------------------------------------------
#
# The reference's LM parameters are a nested dict of arrays with layer
# weights stacked on a leading L axis, and dense weights stored (d_in,
# d_out) for `x @ W`. The port's `LM` keeps one module per layer and
# `nn.Linear` weights (d_out, d_in), so every projection is transposed
# on the way in and out. Norm weights are `w`, q/k/v biases `bq`/`bk`/
# `bv` in the reference and the Linear's `bias` here. A moe block's
# `router`, `w_gate`, `w_up` and `w_down` and a Mamba-2 mixer's leaves
# (`in_proj`, `conv_w`, `conv_b`, `A_log`, `dt_bias`, `D`, `out_norm`,
# `out_proj`) are plain parameters in the reference's layout
# (`layers.<i>.moe.w_up` is `layers/moe/w_up[i]`), stacked on L and not
# transposed. The hybrid family's `shared` attention block is one block,
# not stacked. The encdec family's encoder blocks are stacked as the
# decoder's are (`enc_layers.<i>.x` is `enc_layers/x[i]`); its decoder
# blocks add `cross` (an attention) and `ln3`, and its LayerNorms a bias
# `b`, a plain leaf like `dec_pos` and `enc_norm`'s.

def _from_numpy(a, dtype=None, device="cpu") -> torch.Tensor:
    a = np.array(a)           # a copy: the port writes caches in place
    if a.dtype.name == "bfloat16":          # ml_dtypes' bfloat16
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _lm_source(name: str):
    """Port parameter name -> (reference path, layer index or None,
    transposed)."""
    parts = name.split(".")
    layer = None
    if parts[0] in ("layers", "enc_layers"):      # layers.<i>.x -> layers/x[i]
        layer, parts = int(parts[1]), [parts[0]] + parts[2:]
    *sub, leaf = parts
    if leaf == "bias":                            # attn.wq.bias -> attn.bq
        return (*sub[:-1], "b" + sub[-1][1:]), layer, False
    if leaf == "weight":
        return tuple(sub), layer, True
    return tuple(parts), layer, False


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (k,)))
        return out
    return {prefix: tree}


def lm_params_from_numpy(cfg, tree: dict, device=None):
    """The port's `LM` from the reference's parameter tree (numpy leaves,
    `layers` stacked on L). Raises on a missing or unused leaf and on any
    shape that does not match after transposition."""
    from repro_torch.models.lm import LM

    flat = _flatten(tree)
    used = set()
    model = LM(cfg, resolve_device(device))
    with torch.no_grad():
        for name, t in model.named_parameters():
            path, layer, transposed = _lm_source(name)
            if path not in flat:
                raise KeyError(f"{name}: no reference leaf {'/'.join(path)}")
            used.add(path)
            a = np.asarray(flat[path])
            if layer is not None:
                a = a[layer]
            if transposed:
                a = a.T
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError(f"{name}: reference leaf {'/'.join(path)} "
                                 f"gives {tuple(a.shape)}, expected "
                                 f"{tuple(t.shape)}")
            t.copy_(_from_numpy(a, t.dtype, t.device))
    extra = sorted("/".join(p) for p in set(flat) - used)
    if extra:
        raise KeyError(f"reference leaves with no port parameter: {extra}")
    return model.requires_grad_(False)


def lm_params_to_numpy(model) -> dict:
    """The reference's parameter tree (numpy, layers stacked) from an
    `LM`."""
    stacked: dict = {}
    tree: dict = {}
    for name, t in model.named_parameters():
        path, layer, transposed = _lm_source(name)
        a = _to_numpy(t.T if transposed else t)
        if layer is None:
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = a
        else:
            stacked.setdefault(path, []).append(a)
    for path, arrays in stacked.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.stack(arrays)
    return tree


def caches_from_numpy(tree: dict, device=None) -> dict:
    """Decode caches (dense or lsm dict of numpy leaves, the hybrid
    family's `shared` dict nested, the encdec family's `enc_k`/`enc_v`
    beside `k`/`v`) as tensors; dtypes kept (counters int32, K/V and the
    conv state in the model dtype, the ssm state f32)."""
    device = resolve_device(device)
    return {k: caches_from_numpy(v, device) if isinstance(v, dict)
            else _from_numpy(v, device=device) for k, v in tree.items()}


def caches_to_numpy(caches: dict) -> dict:
    """Decode caches as numpy leaves, in the reference's layout."""
    return {k: caches_to_numpy(v) if isinstance(v, dict) else _to_numpy(v)
            for k, v in caches.items()}
