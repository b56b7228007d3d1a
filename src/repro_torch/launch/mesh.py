"""Data meshes for sharded search plans.

The reference builds a 1-D ``("data",)`` JAX mesh; in the port a mesh is
the list of ``torch.device``s that a plan's shards run on, shard ``d`` on
``mesh[d]`` (the bank level of the paper's hierarchy).  A shard program
is a range of row tiles searched on its device; the candidate lists merge
on the plan's device.

:func:`forced_devices` is the test hook that stands in for the
reference's child process under ``--xla_force_host_platform_device_count``:
while it is active, the device count of its device type is ``n`` and the
mesh is ``n`` stand-ins of one physical device (``cpu`` x 8, or
``cuda:0`` x 4), so sharded plans run as row-tile ranges on one device.
It is an explicit context manager, not an environment knob.

The LM's meshes are named ``DeviceMesh``es over a process group with one
rank per device (``torchrun`` or ``torch.multiprocessing.spawn``):
:func:`make_local_mesh` ``(data, model)`` over the current group, and
:func:`make_production_mesh` the 16 x 16 ``(data, model)`` and 2 x 16 x
16 ``(pod, data, model)`` meshes of the reference's launch spec, as a
shape-only :class:`..models.sharding.AbstractMesh`, or as a
``DeviceMesh`` when a group of that size is open (the dry run's fake
group).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, List, Optional

import torch

__all__ = ["device_count", "make_data_mesh", "forced_devices",
           "make_local_mesh", "make_production_mesh"]

_LOCK = threading.Lock()
#: the active stand-in devices of :func:`forced_devices`, or None
_FORCED: Optional[List[torch.device]] = None


def device_count(device_type: str = "cuda") -> int:
    """Devices of ``device_type`` that shards may use: the stand-ins of an
    active :func:`forced_devices` of that type, else
    ``torch.cuda.device_count()`` for ``"cuda"`` and 1 for anything
    else."""
    forced = _FORCED
    if forced is not None and forced[0].type == device_type:
        return len(forced)
    if device_type == "cuda":
        return torch.cuda.device_count()
    return 1


def make_data_mesh(data: int = 0, device="cuda") -> List[torch.device]:
    """The devices of a ``data``-way shard split of ``device``'s type:
    ``min(data, count)`` of them (``data <= 0`` takes every one).
    Requests beyond the host's count clamp rather than fail, as the
    reference's mesh does.  Without a stand-in mesh, CUDA devices are
    ``cuda:0 .. cuda:{n-1}`` and the CPU is one device."""
    dtype = torch.device(device).type
    n = device_count(dtype)
    data = n if data <= 0 else min(int(data), n)
    forced = _FORCED
    if forced is not None and forced[0].type == dtype:
        return list(forced[:data])
    if dtype == "cuda":
        return [torch.device("cuda", i) for i in range(data)]
    return [torch.device(device)] * data


@contextlib.contextmanager
def forced_devices(n: int, device="cpu") -> Iterator[List[torch.device]]:
    """Test hook: while active, ``device``'s type counts ``n`` devices,
    every one of them ``device`` itself, so a plan built inside runs its
    ``n`` shards as row-tile ranges on that one device.  Plans built
    inside keep their mesh after the hook ends (the plan cache keys on
    the clamped shard count)."""
    global _FORCED
    if n < 1:
        raise ValueError(f"forced_devices needs n >= 1, got {n}")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    with _LOCK:
        if _FORCED is not None:
            raise RuntimeError("forced_devices is already active")
        _FORCED = [dev] * int(n)
    try:
        yield list(_FORCED)
    finally:
        with _LOCK:
            _FORCED = None


def _device_mesh(shape, names, device_type: str):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=names)


def make_local_mesh(data: int = 1, model: int = 1, device="cuda"):
    """A ``(data, model)`` mesh over the current process group, one rank
    per device of ``device``'s type.  A request larger than the group
    clamps to ``(world, 1)``, as the reference's does.  With no group
    open (one process) it is a shape-only ``AbstractMesh(data=1,
    model=1)``."""
    import torch.distributed as dist
    from ..models.sharding import AbstractMesh
    if not dist.is_initialized():
        return AbstractMesh(data=1, model=1)
    n = dist.get_world_size()
    if data * model > n:
        data, model = n, 1
    return _device_mesh((data, model), ("data", "model"),
                        torch.device(device).type)


def make_production_mesh(*, multi_pod: bool = False):
    """16 x 16 ``(data, model)``, or with ``multi_pod`` 2 x 16 x 16
    ``(pod, data, model)``: a ``DeviceMesh`` when the open process group
    has exactly that many ranks (the dry run's fake group, which traces
    CPU tensors), else an ``AbstractMesh``."""
    import torch.distributed as dist
    from ..models.sharding import AbstractMesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for v in shape:
        n *= v
    if dist.is_initialized() and dist.get_world_size() == n:
        return _device_mesh(shape, names, "cpu")
    return AbstractMesh(**dict(zip(names, shape)))
