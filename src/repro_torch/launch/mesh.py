"""Device meshes (port of `repro.launch.mesh`).

Single pod : (data=16, model=16)            — 256 ranks
Multi-pod  : (pod=2, data=16, model=16)     — 512 ranks

`pod` is an outer data-parallel axis: gradients all-reduce over
("pod", "data"); model parallelism never crosses the pod boundary.

A mesh here is a `torch.distributed.device_mesh.DeviceMesh` over the
default process group, whose world size must equal the product of the
dimensions. `MeshShape` is the same (names, sizes) without any process
group, so that the sharding rules run anywhere; `dp_axes` and
`axis_size` take either. The backend follows the device (NCCL for
`cuda`, gloo for `cpu`); asking for `cuda` without a card raises, as
`device.resolve_device` does.

`fake=True` opens a world of the mesh's size on torch's "fake" backend
instead, as rank 0 (`launch.dryrun`; the counterpart of the reference's
`--xla_force_host_platform_device_count=512`): collectives return at
once and move nothing, so a step over `FakeTensor`s traces each rank's
shapes and collectives without the ranks or the cards.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device


@dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, with no devices behind it (the
    reference's `AbstractMesh`)."""
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))


def _names(mesh) -> tuple[str, ...]:
    if isinstance(mesh, MeshShape):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names or ())


def _size(mesh, name: str) -> int:
    if isinstance(mesh, MeshShape):
        return mesh.shape[name]
    return mesh.size(_names(mesh).index(name))


def init_process_group(device=None, *, rank: int | None = None,
                       world_size: int | None = None,
                       init_method: str | None = None) -> torch.device:
    """Open the default process group on the backend of `device` (the
    card unless ``device="cpu"``) if none is open; rank, world size and
    address come from the arguments or the environment
    (`torch.distributed.run`). On the card each rank takes device
    `rank % device_count`. Returns the rank's device."""
    device = resolve_device(device)
    if not dist.is_initialized():
        kw = {}
        if rank is not None:
            kw.update(rank=rank, world_size=world_size)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method=init_method, **kw)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", dist.get_rank()
                              % torch.cuda.device_count())
        torch.cuda.set_device(device)
    return device


def init_fake_world(world_size: int) -> None:
    """Open the default process group on the "fake" backend, rank 0 of
    `world_size`; a fake world of another size is closed first, and any
    other open group raises."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group is open; a fake world "
                               "needs a process of its own")
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _make(shape: tuple[int, ...], names: tuple[str, ...], device,
          fake: bool = False):
    from torch.distributed.device_mesh import init_device_mesh

    if fake:
        init_fake_world(math.prod(shape))
        device = torch.device(device or "cuda")
    else:
        device = init_process_group(device)
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {dict(zip(names, shape))} needs "
                         f"{math.prod(shape)} ranks; the world has {world}")
    return init_device_mesh(device.type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device=None,
                         fake: bool = False):
    """(16, 16) over (data, model), or (2, 16, 16) over (pod, data,
    model); raises unless the world has 256 or 512 ranks to match. With
    `fake`, over a fake world of 256 or 512 ranks of `device`'s type
    (the card's unless given)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make(shape, axes, device, fake)


def make_host_mesh(data: int = 1, model: int = 1, pod: int = 0,
                   device=None, fake: bool = False):
    """Small meshes: (data, model), or (pod, data, model) when `pod` is
    given; the world size must equal the product (with `fake`, a fake
    world of that size is opened)."""
    if pod:
        return _make((pod, data, model), ("pod", "data", "model"), device,
                     fake)
    return _make((data, model), ("data", "model"), device, fake)


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes of a mesh (includes 'pod' when present)."""
    return tuple(a for a in _names(mesh) if a in ("pod", "data"))


def axis_size(mesh, *names) -> int:
    """The product of the named axes' sizes (an absent axis counts 1)."""
    n = 1
    for a in names:
        if a in _names(mesh):
            n *= _size(mesh, a)
    return n
