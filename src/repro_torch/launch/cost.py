"""One step's FLOPs, bytes, collectives and memory per device, counted
from what eager PyTorch dispatches (the port's counterpart of
`repro.launch.hlo_cost`), and one count of each hand-written kernel's
work (`kernel_cost`).

`CostCounter` is a `TorchDispatchMode`. Run a step inside it — on real
tensors, or on `FakeTensor`s (no memory, no card: `launch.dryrun`) —
and it adds up, op by op:

  flops       — products at 2·M·N·K by `torch.utils.flop_counter`'s
                formulas (mm, bmm, addmm, baddbmm, SDPA, convolutions),
                kept apart as `dot_flops`, plus 1 FLOP an element for the
                pointwise ops of the reference's `_ELEMWISE` list;
  bytes       — the operands plus the result of every op that is not a
                view. This is eager's traffic: each op reads its inputs
                from device memory and writes its output back. It is
                the counterpart of XLA's fusion-boundary bytes, and it is
                larger, since eager fuses nothing;
  collectives — the result bytes of each collective by type: all-reduce,
                all-gather, reduce-scatter, all-to-all, and send/recv as
                collective-permute; both the `_c10d_functional` ops that
                DTensor issues and the in-place `c10d` ops of per-rank
                code (`distributed/runtime.py`); one over a group of one
                rank moves nothing and is left out;
  memory      — with `track_memory`, the peak of live storages made
                during the step, beside the arguments' storages.

Counts are per device. On a mesh, DTensor ops are passed on to DTensor
(the mode returns `NotImplemented` for them), so the mode counts the
local ops each rank runs on its shards and the collectives DTensor
issues; the ops DTensor's sharding propagation runs on global shapes to
learn an output's shape are not counted. Loops need no trip count: each
layer, microbatch and recomputed checkpoint issues its own ops.

A counter installs itself in `repro_torch.shape_only` while it is
active. A kernel entry point that meets fake inputs there runs nothing:
it records its kernel's work (its `ops.work`, which `kernel_cost` reads
too) with the counter (`kernels` holds each kernel's calls, FLOPs and
bytes). Outside a counter, fake inputs to an entry point raise.

The H100 SXM peaks (NVIDIA's data sheet) are the module's constants.
"""
from __future__ import annotations

import importlib
import sys
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch import shape_only

PEAK_BF16_FLOPS = 989e12        # H100 SXM, bf16 dense tensor cores
PEAK_F32_FLOPS = 67e12          # H100 SXM, f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
NVLINK_BYTES_PER_S = 450e9      # H100 SXM NVLink, each way
NVLINK_DOMAIN = 8               # cards one NVLink switch joins (one host)

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# the reference's hlo_cost._ELEMWISE, by aten name (in-place `_` forms too)
ELEMWISE = {
    "add", "sub", "rsub", "mul", "div", "pow", "tanh", "exp", "log",
    "rsqrt", "sqrt", "maximum", "minimum", "clamp_min", "clamp_max", "neg",
    "abs", "floor", "cos", "sin", "sigmoid", "eq", "ne", "lt", "le", "gt",
    "ge", "where", "logical_and", "logical_or", "logical_xor",
    "bitwise_and", "bitwise_or", "bitwise_xor",
}

_COLLECTIVE_OPS = {
    "all-reduce": ("all_reduce", "all_reduce_", "all_reduce_coalesced",
                   "all_reduce_coalesced_", "allreduce_",
                   "allreduce_coalesced_"),
    "all-gather": ("all_gather_into_tensor", "all_gather_into_tensor_out",
                   "all_gather_into_tensor_coalesced", "allgather_",
                   "_allgather_base_", "allgather_coalesced_",
                   "allgather_into_tensor_coalesced_"),
    "reduce-scatter": ("reduce_scatter_tensor",
                       "reduce_scatter_tensor_coalesced", "reduce_scatter_",
                       "_reduce_scatter_base_",
                       "reduce_scatter_tensor_coalesced_"),
    "all-to-all": ("all_to_all_single", "alltoall_", "alltoall_base_"),
    "collective-permute": ("send", "recv_", "recv_any_source_"),
}
_COLLECTIVE_OF = {(ns, op): kind for kind, ops in _COLLECTIVE_OPS.items()
                  for op in ops for ns in ("_c10d_functional", "c10d")}
_COLLECTIVE_OF["_dtensor", "shard_dim_alltoall"] = "all-to-all"
# ops that move no data: allocation without a write, metadata, scalars
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "empty_permuted",
               "_local_scalar_dense", "lift_fresh", "wait_tensor",
               "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
               "broadcast_", "broadcast", "barrier", "set_"}


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _is_view(func) -> bool:
    """Whether `func` is a view: every result aliases an input that it
    does not write (an in-place op's result is written, so not one)."""
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


def _in_shape_propagation() -> bool:
    """Whether DTensor's sharding propagation is running this op on
    global shapes (to learn its output's shape), not a rank."""
    f = sys._getframe(2)
    for _ in range(12):
        if f is None:
            return False
        if f.f_code.co_name.startswith("_propagate_tensor_meta"):
            return True
        f = f.f_back
    return False


def _in_alltoall_fallback() -> bool:
    """Whether DTensor's all-to-all is running as its CPU stand-in (an
    all-gather, then this rank's chunk: gloo has no all-to-all)."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name == "shard_dim_alltoall":
            return True
        f = f.f_back
    return False


def _group_size(args) -> int | None:
    """The size of the process group a collective's arguments name (a
    group name, or a ProcessGroup), if one can be read."""
    from torch.distributed import ProcessGroup
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in args:
        try:
            if isinstance(a, str):
                return _resolve_process_group(a).size()
            if isinstance(a, ProcessGroup):
                return a.size()
            if isinstance(a, torch.ScriptObject):
                return ProcessGroup.unbox(a).size()
        except RuntimeError:        # a string that names no group
            continue
    return None


def _caller() -> str:
    """The innermost frame of the port's own code: `module:function`."""
    f = sys._getframe(2)
    while f is not None:
        name = f.f_globals.get("__name__", "")
        if name.startswith("repro_torch.") and name != __name__:
            return f"{name.removeprefix('repro_torch.')}:{f.f_code.co_name}"
        f = f.f_back
    return "?"


class CostCounter(TorchDispatchMode):
    """Per-device counts of the ops run inside it (see the module's
    docstring). `track_memory` follows live storages; `tracker` (a
    `torch.utils.module_tracker.ModuleTracker`, entered by the caller)
    names each collective by the module path that issued it, beside the
    port's function (`collective_log`). Ops on "meta" tensors (shapes
    only) are left out, and with `fake_only` those on real tensors: in a
    fake run those are host metadata, not the device's work."""

    def __init__(self, track_memory: bool = False, tracker=None,
                 fake_only: bool = False):
        super().__init__()
        self.fake_only = fake_only
        self.flops = 0.0
        self.dot_flops = 0.0
        self.bytes = 0.0
        self.coll = {c: 0.0 for c in COLLECTIVES}
        self.coll_counts = {c: 0 for c in COLLECTIVES}
        self.kernels: dict = {}
        self.collective_log: list = []
        self.ops = 0
        self.track_memory = track_memory
        self.tracker = tracker
        self._live = 0
        self.peak = 0
        self.argument_bytes = 0
        self._seen = weakref.WeakKeyDictionary()
        self._args = weakref.WeakKeyDictionary()

    def __enter__(self):
        shape_only.install(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            shape_only.remove(self)

    # -- bookkeeping -------------------------------------------------------
    def mark_arguments(self, tree) -> None:
        """Count the storages of `tree`'s tensors (DTensors by their local
        shards) as the step's arguments (`argument_bytes`)."""
        for t in _tensors(tree):
            st = _local(t).untyped_storage()
            if st not in self._args:
                self._args[st] = True
                self.argument_bytes += st.nbytes()

    def new_storages(self, tree) -> int:
        """Bytes of `tree`'s storages that are not the arguments'."""
        seen, total = set(), 0
        for t in _tensors(tree):
            st = _local(t).untyped_storage()
            if st in self._args or id(st) in seen:
                continue
            seen.add(id(st))
            total += st.nbytes()
        return total

    def _freed(self, n: int) -> None:
        self._live -= n

    def _track(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            if st in self._seen or st in self._args:
                continue
            n = st.nbytes()
            self._seen[st] = True
            self._live += n
            weakref.finalize(st, self._freed, n)
        self.peak = max(self.peak, self._live)

    def add_kernel(self, name: str, flops: float, n_bytes: float) -> None:
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                           "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += n_bytes
        self.flops += flops
        self.dot_flops += flops
        self.bytes += n_bytes

    # -- the mode ----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if _in_shape_propagation() or not any(
                t.device.type != "meta" and (_is_fake(t) or not self.fake_only)
                for t in _tensors((args, kwargs, out))):
            return out
        self._count(func, args, kwargs, out)
        if self.track_memory and not _is_view(func):
            self._track(out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry
        ns = func.namespace
        name = func.overloadpacket.__name__
        if ns in ("_c10d_functional", "c10d", "_dtensor"):
            kind = _COLLECTIVE_OF.get((ns, name))
            if kind is None or _group_size(args) == 1:
                return      # not a collective, or a group of one card
            res = _tensors(out) or _tensors(args[0])
            if kind == "all-gather" and _in_alltoall_fallback():
                # counted as the all-to-all it stands for, as on the card:
                # its result is the size of its input
                kind, res = "all-to-all", _tensors(args[0])
            n = sum(nbytes(t) for t in res)
            self.coll[kind] += n
            self.coll_counts[kind] += 1
            self.bytes += n
            where = _caller()
            if self.tracker is not None:
                mods = [p for p in self.tracker.parents if p != "Global"]
                where = (max(mods, key=len) if mods else "Global") \
                    + " " + where
            self.collective_log.append((kind, n, where))
            return
        if ns != "aten" or name in _NO_TRAFFIC or _is_view(func):
            return
        self.ops += 1
        packet = func.overloadpacket
        if packet in flop_registry:
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops += f
            self.dot_flops += f
        elif name.rstrip("_") in ELEMWISE:
            self.flops += sum(t.numel() for t in _tensors(out))
        self.bytes += sum(nbytes(t) for t in _tensors((args, kwargs))) \
            + sum(nbytes(t) for t in _tensors(out))

    def result(self) -> dict:
        """The counts as the reference's `hlo_cost.analyze` names them,
        with `dot_flops`, the collective counts and the kernels."""
        return {"flops": self.flops, "dot_flops": self.dot_flops,
                "bytes": self.bytes,
                "collective_bytes": sum(self.coll.values()),
                "collectives": dict(self.coll),
                "collective_counts": dict(self.coll_counts),
                "kernels": {k: dict(v) for k, v in self.kernels.items()}}

    def top_collectives(self, n: int = 15) -> list:
        """[(bytes x count, bytes, count, type, issued by)] of the
        largest collectives by their total bytes."""
        agg = defaultdict(int)
        for kind, b, where in self.collective_log:
            agg[(kind, b, where)] += 1
        rows = [(b * c, b, c, kind, where)
                for (kind, b, where), c in agg.items()]
        return sorted(rows, reverse=True)[:n]


def _is_fake(t: torch.Tensor) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (read without dispatching an op), or t."""
    from torch.distributed.tensor import DTensor
    return t._local_tensor if isinstance(t, DTensor) else t


# --------------------------------------------------------------------------
# the hand-written kernels' work
# --------------------------------------------------------------------------

KERNELS = ("bloom_probe", "fence_lookup", "heap_merge", "range_merge",
           "lsm_attention")


def kernel_cost(name: str, **shape) -> tuple[float, float]:
    """(FLOPs, bytes) of one call of hand-written kernel `name` at
    `shape`, from the `work` formula beside its wrapper
    (`repro_torch.kernels.<name>.ops.work`, which names the arguments):
    each byte of input the function needs read once, each byte of output
    written once (the roofline bound). Where the work depends on the
    data, the caller passes what this call's data needs."""
    if name not in KERNELS:
        raise KeyError(f"no hand-written kernel {name!r}")
    ops = importlib.import_module(f"repro_torch.kernels.{name}.ops")
    return ops.work(**shape)


def bound_ms(flops: float, n_bytes: float) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over
    HBM's rate and the FLOPs over the f32 peak (the hand-written kernels
    compute outside the tensor cores) -> (ms, "bytes" or
    "operations")."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def peak_flops(dtype) -> float:
    """The card's peak for products in `dtype` (a torch dtype or its
    name): bf16/f16 on the tensor cores, f32 outside them."""
    name = str(dtype).removeprefix("torch.")
    return PEAK_BF16_FLOPS if name in ("bfloat16", "float16") \
        else PEAK_F32_FLOPS
