"""Pipeline parallelism: the GPipe schedule over one mesh axis (port of
`repro.distributed.pipeline`).

Stage s holds the parameters of layers [s*L/P, (s+1)*L/P); microbatches
flow stage to stage with `batch_isend_irecv` to the neighbour rank (the
reference's `ppermute`). The schedule is the classic GPipe trapezoid:
T = n_micro + n_stages - 1 ticks, bubble fraction (P-1)/(M+P-1).
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def gpipe_forward(stage_fn, stage_params, x_micro, mesh, axis: str = "pipe"):
    """Run a GPipe forward pass; every rank of `mesh` calls it.

    stage_fn: (stage_params_slice, x (mb, ...)) -> y (mb, ...)
    stage_params: tree with leading axis == n_stages — full tensors, or
      DTensors sharded on that axis over `axis` (each rank reads its own
      slice either way)
    x_micro: (n_micro, mb, ...) microbatched input, the same on every rank
    Returns (n_micro, mb, ...) outputs, the same on every rank (the last
    stage's, shared by an all-reduce over the axis, the reference's
    psum).
    """
    names = mesh.mesh_dim_names
    n_stages = mesh.size(names.index(axis))
    stage = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    n_micro = x_micro.shape[0]
    ticks = n_micro + n_stages - 1

    def local(p):
        if hasattr(p, "to_local"):
            p = p.to_local()
            return p[0]
        return p[stage]
    pl = _tree_map(local, stage_params)
    nxt = (dist.get_global_rank(group, stage + 1)
           if stage < n_stages - 1 else None)
    prv = dist.get_global_rank(group, stage - 1) if stage > 0 else None

    buf = torch.zeros_like(x_micro[0])
    outs = torch.zeros_like(x_micro)
    for t in range(ticks):
        mb = t - stage
        active = 0 <= mb < n_micro
        if active:
            y = stage_fn(pl, x_micro[mb] if stage == 0 else buf)
            if stage == n_stages - 1:
                outs[mb] = y
        else:
            y = buf
        ops = []
        if nxt is not None:
            ops.append(dist.P2POp(dist.isend, y.contiguous(), nxt, group))
        recv = torch.zeros_like(buf)
        if prv is not None:
            ops.append(dist.P2POp(dist.irecv, recv, prv, group))
        for req in dist.batch_isend_irecv(ops) if ops else ():
            req.wait()
        buf = recv
    # only the last stage holds real outputs; share them
    if stage != n_stages - 1:
        outs.zero_()
    dist.all_reduce(outs, group=group)
    return outs


def split_layers_into_stages(stacked_params, n_stages: int):
    """(L, ...) stacked layer params -> (n_stages, L/n_stages, ...)."""
    def resh(p):
        n = p.shape[0]
        assert n % n_stages == 0, (n, n_stages)
        return p.reshape(n_stages, n // n_stages, *p.shape[1:])
    return _tree_map(resh, stacked_params)


def bubble_fraction(n_micro: int, n_stages: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)
