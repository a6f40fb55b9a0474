"""Elastic scaling + straggler mitigation (port of
`repro.distributed.elastic`).

Elastic: checkpoints are mesh-agnostic (host numpy per leaf); on
restore, `make_elastic_mesh` factors whatever rank count survived into
(data, model), preserving the TP degree when possible, and `reshard`
lays the tree out under the new mesh. Losing ranks or growing is a
restore, not a retrain.

Stragglers: `StragglerMonitor` tracks per-step wall times; a step beyond
`threshold x` the rolling median marks its host as suspect, and the
policy answers `skip` (drop the step) or `quarantine` (exclude the host
at the next elastic re-mesh).
"""
from __future__ import annotations

import collections
import statistics
from dataclasses import dataclass, field

import numpy as np
import torch


def factor_devices(n_devices: int, prefer_model: int = 16) -> tuple[int, int]:
    """(data, model) factoring of an arbitrary surviving device count,
    preserving the preferred TP degree when it divides."""
    model = min(prefer_model, n_devices)
    while n_devices % model:
        model -= 1
    return n_devices // model, model


def make_elastic_mesh(n_devices: int, prefer_model: int = 16, device=None):
    """A (data, model) `DeviceMesh` over the first `n_devices` ranks of
    the default process group (every rank calls it; ranks outside the
    mesh get a mesh they are not part of)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch.mesh import init_process_group
    device = init_process_group(device)
    if n_devices > dist.get_world_size():
        raise ValueError(f"{n_devices} ranks asked of a world of "
                         f"{dist.get_world_size()}")
    data, model = factor_devices(n_devices, prefer_model)
    ranks = torch.arange(n_devices).reshape(data, model)
    return DeviceMesh(device.type, ranks, mesh_dim_names=("data", "model"))


def reshard(host_tree, mesh, spec_tree):
    """Host numpy tree (nested dicts) -> DTensors under `mesh` with the
    matching specs; every rank passes the same host tree."""
    from repro_torch.distributed.sharding import distribute

    def to_tensor(t):
        if isinstance(t, dict):
            return {k: to_tensor(v) for k, v in t.items()}
        return torch.from_numpy(np.array(t, copy=True)).to(mesh.device_type)
    return distribute(to_tensor(host_tree), mesh, spec_tree)


@dataclass
class StragglerMonitor:
    threshold: float = 2.0       # x rolling median
    window: int = 32
    min_samples: int = 8
    times: collections.deque = field(default_factory=lambda:
                                     collections.deque(maxlen=256))
    suspects: collections.Counter = field(default_factory=collections.Counter)
    quarantine_after: int = 3

    def record(self, host_id: int, step_time: float) -> str:
        """Returns action: 'ok' | 'skip' | 'quarantine'."""
        recent = list(self.times)[-self.window:]
        self.times.append(step_time)
        if len(recent) < self.min_samples:
            return "ok"
        med = statistics.median(recent)
        if step_time <= self.threshold * med:
            return "ok"
        self.suspects[host_id] += 1
        if self.suspects[host_id] >= self.quarantine_after:
            return "quarantine"
        return "skip"

    def healthy_hosts(self, all_hosts: list[int]) -> list[int]:
        return [h for h in all_hosts
                if self.suspects[h] < self.quarantine_after]
