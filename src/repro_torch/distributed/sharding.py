"""Sharding rules: DP / TP / EP / SP over a device mesh, as DTensor
layouts (port of `repro.distributed.sharding`).

The rules choose layouts that keep the big products local and push
collectives onto activations:

  * TP (model axis): attention QKVO, FFN in/out, vocab/embedding, and the
    MoE expert axis (EP == experts over the model axis);
  * DP (pod+data axes): batch; ZeRO-1 shards optimizer moments over DP;
  * SP (data axis): sequence/KV-block axis when the batch cannot fill DP.

Dims that don't divide their axis stay replicated (e.g. kv=4 heads on a
16-way model axis — KV projections replicate, the standard GQA-TP rule).

A spec (`P`) is the reference's `PartitionSpec`: one entry a tensor
dimension, each a mesh axis name, a tuple of names or None. `named`
turns specs into DTensor placements (`Shard(d)` / `Replicate()`, one a
mesh dimension) and `distribute` lays tensors out by them.

Parameters: the reference stacks layer weights on a leading L axis and
stores dense weights (d_in, d_out); the port keeps one module a layer
and `nn.Linear` weights (d_out, d_in) (`convert._lm_source` maps the
names). So each rule runs on the leaf's reference name and its
unstacked reference-oriented shape, and the spec's two dims are swapped
back for a transposed leaf. A stacked leaf's spec is then its
reference spec without the L entry. Decode caches and batches keep the
reference's layout and names, so their rules apply as they are.

ZeRO-1 shards each moment on the first free axis that divides |DP|, in
reference orientation. The port's per-layer moments have no L axis, so
they differ from the reference's stacked ones wherever the reference
chose L; and the reference computes its moments' base layout with the
leaf's stacking lost under the optimizer state's `mu`/`nu` key (its row
and expert rules then read L as the first axis), where the port's base
is the parameter's own layout. Layouts only: results are the same.
"""
from __future__ import annotations

from repro_torch.launch.mesh import axis_size, dp_axes


class P(tuple):
    """A partition spec: `P("model", None)`; `P()` is replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple(self)!r}"


def _div(n: int, d: int) -> bool:
    return d > 0 and n % d == 0


def _pad(spec, rank: int) -> P:
    return P(*spec, *(None,) * (rank - len(spec)))


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------

_COL = {"wq", "wk", "wv", "w_gate", "w_up", "in_proj", "conv_w"}
_ROW = {"wo", "w_down", "out_proj"}


def _param_spec(name: str, shape: tuple[int, ...], tp: int) -> P:
    """The reference's rule for an unstacked leaf of reference name
    `name` and reference-oriented `shape`."""
    def col(ix):  # shard output/column dim
        return P(*(None,) * ix, "model") if _div(shape[ix], tp) else P()

    if name == "embed":
        return P("model", None) if _div(shape[0], tp) else P()
    if name == "lm_head":
        return P(None, "model") if _div(shape[1], tp) else P()
    if name in ("dec_pos", "router"):
        return P()
    if name in ("w_gate", "w_up", "w_down") and len(shape) == 3:
        # MoE expert stacks (E, d, f): expert-parallel over model axis
        return P("model", None, None) if _div(shape[0], tp) else P()
    if name in _COL:
        return col(len(shape) - 1)
    if name in _ROW:
        if _div(shape[0], tp):
            return P("model", *(None,) * (len(shape) - 1))
        return P()
    return P()  # norms, biases, scalars: replicated


def _named_shapes(params) -> dict:
    """{port name: shape} of an `LM` (any device, "meta" included) or a
    dict of tensors or shapes."""
    from torch import nn
    if isinstance(params, nn.Module):
        params = dict(params.named_parameters())
    return {k: tuple(getattr(v, "shape", v)) for k, v in params.items()}


def _leaf_rule(name: str, shape: tuple[int, ...], rule) -> P:
    """Run `rule(reference name, reference shape) -> spec` on port leaf
    `name` and return the spec in the port's orientation, full rank."""
    from repro_torch.convert import _lm_source
    path, _layer, transposed = _lm_source(name)
    ref_shape = shape[::-1] if transposed else shape
    spec = _pad(rule(path[-1], ref_shape), len(shape))
    return P(*spec[::-1]) if transposed else spec


def param_pspecs(cfg, params, mesh) -> dict:
    """{port parameter name: spec} for an `LM` or a dict of its
    parameters (tensors or shapes)."""
    tp = axis_size(mesh, "model")
    return {k: _leaf_rule(k, s, lambda n, sh: _param_spec(n, sh, tp))
            for k, s in _named_shapes(params).items()}


def zero1_pspecs(cfg, params_or_state, mesh):
    """ZeRO-1: each moment laid out as its parameter and, besides, sharded
    over DP on the first free axis (reference orientation) that divides
    |DP|. Takes an `AdamWState` (-> one of specs, step replicated) or
    the parameters (-> {name: spec})."""
    from repro_torch.train.optimizer import AdamWState
    dp = dp_axes(mesh)
    dpn = axis_size(mesh, *dp)
    tp = axis_size(mesh, "model")
    dp_s = dp if len(dp) > 1 else (dp[0] if dp else None)

    def rule(name, shape):
        spec = list(_pad(_param_spec(name, shape, tp), len(shape)))
        for i, s in enumerate(shape):
            if dp_s is not None and spec[i] is None and _div(s, dpn):
                spec[i] = dp_s
                break
        return P(*spec)

    def tree(params):
        return {k: _leaf_rule(k, s, rule)
                for k, s in _named_shapes(params).items()}

    if isinstance(params_or_state, AdamWState):
        return AdamWState(mu=tree(params_or_state.mu),
                          nu=tree(params_or_state.nu), step=P())
    return tree(params_or_state)


# --------------------------------------------------------------------------
# batches / caches
# --------------------------------------------------------------------------

def _map(tree: dict, rule):
    """Apply rule(last key, shape) over a nested dict of tensors/shapes."""
    return {k: _map(v, rule) if isinstance(v, dict)
            else rule(k, tuple(getattr(v, "shape", v)))
            for k, v in tree.items()}


def batch_pspecs(cfg, batch: dict, mesh) -> dict:
    """Shard batch dim over DP when divisible; else sequence over data."""
    dp = dp_axes(mesh)
    dpn = axis_size(mesh, *dp)
    dp_s = dp if len(dp) > 1 else dp[0]

    def rule(name, shape):
        if name == "positions3":  # (3, B, S)
            if _div(shape[1], dpn):
                return P(None, dp_s, None)
            return (P(None, None, "data")
                    if _div(shape[2], axis_size(mesh, "data")) else P())
        if len(shape) >= 1 and _div(shape[0], dpn):
            return P(dp_s, *(None,) * (len(shape) - 1))
        if len(shape) >= 2 and _div(shape[1], axis_size(mesh, "data")):
            return P(None, "data", *(None,) * (len(shape) - 2))
        return P()
    return _map(batch, rule)


def cache_pspecs(cfg, caches: dict, mesh) -> dict:
    """Decode caches (stacked (L, B, ...) leaves): batch over DP when it
    divides; otherwise shard the long axis (sequence / block-count /
    heads) — SP for decode."""
    dp = dp_axes(mesh)
    dpn = axis_size(mesh, *dp)
    dp_s = dp if len(dp) > 1 else dp[0]
    data_n = axis_size(mesh, "data")
    tp = axis_size(mesh, "model")

    def rule(name, shape):
        if name == "pos" or len(shape) <= 1:
            return P()
        if name in ("hot_len", "n_blocks"):
            return P()
        if _div(shape[1], dpn):
            # KV heads over model where they divide (attention stays
            # local), else the sequence axis: the cache never replicates
            # across the model axis
            if name in ("k", "v", "enc_k", "enc_v", "hot_k", "hot_v") \
                    and len(shape) == 5:
                if _div(shape[3], tp):
                    return P(None, dp_s, None, "model", None)
                if _div(shape[2], tp):
                    return P(None, dp_s, "model", None, None)
            if name in ("blk_k", "blk_v") and len(shape) == 6:
                if _div(shape[4], tp):
                    return P(None, dp_s, None, None, "model", None)
                if _div(shape[3], tp):
                    return P(None, dp_s, None, "model", None, None)
            return P(None, dp_s, *(None,) * (len(shape) - 2))
        # batch too small: the long axis over data (+ kv heads over model
        # when they divide)
        if name in ("k", "v", "hot_k", "hot_v") and _div(shape[2], data_n):
            kv_ax = "model" if _div(shape[3], tp) else None
            return P(None, None, "data", kv_ax,
                     *(None,) * (len(shape) - 4))
        if name in ("blk_k", "blk_v") and _div(shape[2], data_n):
            kv_ax = "model" if _div(shape[4], tp) else None
            return P(None, None, "data", None, kv_ax,
                     *(None,) * (len(shape) - 5))
        if name == "summ" and _div(shape[2], data_n):
            return P(None, None, "data", *(None,) * (len(shape) - 3))
        if name in ("enc_k", "enc_v") and _div(shape[2], data_n):
            return P(None, None, "data", *(None,) * (len(shape) - 3))
        if name == "ssm" and _div(shape[2], tp):
            return P(None, None, "model", *(None,) * (len(shape) - 3))
        if name == "conv" and _div(shape[-1], tp):
            return P(*(None,) * (len(shape) - 1), "model")
        return P()
    return _map(caches, rule)


# --------------------------------------------------------------------------
# specs -> DTensor placements
# --------------------------------------------------------------------------

def placements(mesh, spec) -> tuple:
    """The DTensor placements of `spec` on a `DeviceMesh`: for each mesh
    dimension, `Shard(d)` for the tensor dim whose entry names it (alone
    or in a tuple, whose axes then split that dim outer to inner in mesh
    order), else `Replicate()`."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def named(mesh, spec_tree):
    """A tree of specs -> the same tree of placement tuples."""
    if isinstance(spec_tree, P):
        return placements(mesh, spec_tree)
    if isinstance(spec_tree, dict):
        return {k: named(mesh, v) for k, v in spec_tree.items()}
    if isinstance(spec_tree, tuple) and hasattr(spec_tree, "_fields"):
        return type(spec_tree)(*(named(mesh, v) for v in spec_tree))
    raise TypeError(f"not a spec tree: {type(spec_tree)}")


def distribute(tree, mesh, spec_tree):
    """Tensors (a nested dict or an `AdamWState` of them, or one tensor)
    laid out on `mesh` by the matching specs. Every rank passes the same
    full tensors; each keeps its shards."""
    from torch.distributed.tensor import distribute_tensor
    if isinstance(spec_tree, P):
        return distribute_tensor(tree, mesh, placements(mesh, spec_tree))
    if isinstance(tree, dict):
        return {k: distribute(v, mesh, spec_tree[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(distribute(v, mesh, s)
                            for v, s in zip(tree, spec_tree)))
    raise TypeError(f"not a tensor tree: {type(tree)}")


def distribute_model(model, mesh, specs: dict):
    """Replace each parameter of `model` by a DTensor parameter laid out
    by `specs[name]` (in place; returns the model)."""
    from torch import nn
    from torch.distributed.tensor import distribute_tensor
    for name, p in list(model.named_parameters()):
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        d = distribute_tensor(p.detach(), mesh, placements(mesh, specs[name]))
        setattr(mod, leaf, nn.Parameter(d, requires_grad=p.requires_grad))
    return model

