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
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, List, Optional

import torch

__all__ = ["device_count", "make_data_mesh", "forced_devices"]

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
