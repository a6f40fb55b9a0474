"""Ambient logical-axis registry for in-model sharding (port of
`repro.distributed.runtime`).

Model code cannot know mesh axis names (tests run on one device, meshes
are (data, model) or (pod, data, model)). The launcher registers the
logical -> mesh axis mapping and the `DeviceMesh` here; with nothing
registered every helper is a no-op or a size of 1, so model code stays
mesh-agnostic.

The reference's constructs map so:
- `with_sharding_constraint` -> `constrain`: `DTensor.redistribute` to
  the spec's placements (a plain tensor passes through);
- a `shard_map` body -> per-rank code on `to_local()` shards, with the
  collectives below over one mesh axis's process group: `psum` ->
  `psum` (an all-reduce whose gradient passes through; `all_reduce_` where
  no gradient is taken), `pmax` -> `all_reduce_(MAX)`, `pmean` -> the sum
  over the size, `axis_index` -> `axis_rank`.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

SUM, MAX = dist.ReduceOp.SUM, dist.ReduceOp.MAX

_DP: tuple[str, ...] | None = None
_MODEL: str | None = None
_MESH = None


def set_axes(dp: tuple[str, ...] | None, model: str | None,
             mesh=None) -> None:
    global _DP, _MODEL, _MESH
    _DP, _MODEL, _MESH = dp, model, mesh


def clear() -> None:
    set_axes(None, None, None)


def mesh():
    return _MESH


def dp_axes() -> tuple[str, ...] | None:
    return _DP


def model_axis() -> str | None:
    return _MODEL


def _axis(name: str) -> int:
    return _MESH.size(_MESH.mesh_dim_names.index(name))


def dp_size() -> int:
    if _MESH is None or not _DP:
        return 1
    n = 1
    for a in _DP:
        n *= _axis(a)
    return n


def model_size() -> int:
    if _MESH is None or not _MODEL:
        return 1
    return _axis(_MODEL)


def data_size() -> int:
    if _MESH is None or "data" not in (_MESH.mesh_dim_names or ()):
        return 1
    return _axis("data")


def axis_rank(name: str) -> int:
    """This rank's coordinate along mesh axis `name` (`axis_index`)."""
    return _MESH.get_local_rank(name)


def group(name: str):
    """The process group of mesh axis `name` through this rank."""
    return _MESH.get_group(name)


def all_reduce_(x: torch.Tensor, names, op=SUM):
    """Reduce `x` in place over the mesh axes `names` (one name or a
    tuple), one collective an axis (sum and max compose so); returns x."""
    for name in ((names,) if isinstance(names, str) else names):
        dist.all_reduce(x, op=op, group=group(name))
    return x


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, names):
        return all_reduce_(x.clone(), names)

    @staticmethod
    def backward(ctx, g):
        return g, None


def psum(x: torch.Tensor, names) -> torch.Tensor:
    """The reference's `psum` in a shard_map body whose output is
    replicated over `names`: the sum of the ranks' `x` over those mesh
    axes; its gradient passes through unchanged, so each rank's part
    gets the whole gradient of the replicated sum."""
    return _SumOver.apply(x, names)


class _GradSumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, names):
        ctx.names = names
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.names), None


def grad_sum(x: torch.Tensor, names) -> torch.Tensor:
    """`x` unchanged, its gradient summed over the mesh axes `names`: for
    an input each rank holds whole over those axes (replicated) but uses
    for its own part of the work there (its batch rows, its experts);
    each rank's gradient is its part's, and the gradient of the
    replicated input is their sum (what a shard_map's transpose adds)."""
    return _GradSumOver.apply(x, names)


def all_gather(x: torch.Tensor, name: str, dim: int) -> torch.Tensor:
    """The ranks' `x` along mesh axis `name`, concatenated on `dim` in
    axis order."""
    parts = [torch.empty_like(x) for _ in range(_axis(name))]
    dist.all_gather(parts, x.contiguous(), group=group(name))
    return torch.cat(parts, dim=dim)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain(x, *dims: str | None):
    """dims entries: 'dp' | 'model' | None per tensor axis. A DTensor is
    redistributed to that layout; a plain tensor, or any tensor with no
    axes registered, is returned as it is."""
    if (_DP is None and _MODEL is None) or not is_dtensor(x):
        return x
    from repro_torch.distributed.sharding import placements
    spec = []
    for d in dims:
        if d == "dp":
            spec.append(_DP if _DP and len(_DP) > 1 else
                        (_DP[0] if _DP else None))
        elif d == "model":
            spec.append(_MODEL)
        else:
            spec.append(None)
    return x.redistribute(x.device_mesh, placements(x.device_mesh, spec))


@contextlib.contextmanager
def spmd():
    """The context model code runs in on DTensors: plain tensors made
    inside it (positions, masks, schedules) join DTensor ops as
    replicated (`implicit_replication`, restored to its earlier state on
    exit, so the context nests). Does nothing with no mesh registered."""
    if _MESH is None:
        yield
        return
    from torch.distributed.tensor import DTensor
    disp = DTensor._op_dispatcher
    was = disp._allow_implicit_replication
    disp._allow_implicit_replication = True
    try:
        yield
    finally:
        disp._allow_implicit_replication = was
