"""Atomic, async checkpoint I/O (see the package docstring)."""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..tree import leaves_with_paths, tree_map, unflatten

__all__ = ["save_pytree", "restore_pytree", "latest_step", "AsyncCheckpointer"]

_STEP_RE = re.compile(r"^step_(\d+)$")


def _is_dt(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _host_copy(leaf: Any) -> Any:
    """A host copy of a leaf that later in-place updates cannot reach; a
    DTensor is gathered whole first (a collective: every rank calls)."""
    if _is_dt(leaf):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


def _to_numpy(leaf: Any):
    """(array to store, logical dtype name); bfloat16 as raw uint16."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for d in os.listdir(ckpt_dir)
             if (m := _STEP_RE.match(d)) and
             os.path.exists(os.path.join(ckpt_dir, d, "manifest.json"))]
    return max(steps) if steps else None


def save_pytree(tree: Any, ckpt_dir: str, step: int,
                extra_metadata: Optional[Dict[str, Any]] = None) -> str:
    """Atomic save.  Returns the committed directory path.  DTensor leaves
    are gathered whole (a collective: every rank calls) and rank 0
    writes."""
    final = os.path.join(ckpt_dir, f"step_{step:09d}")
    if any(_is_dt(x) for _, x in leaves_with_paths(tree)):
        tree = tree_map(_host_copy, tree)
        if _rank() != 0:
            return final
    tmp = final + ".tmp.0"
    os.makedirs(tmp, exist_ok=True)

    arrays: Dict[str, np.ndarray] = {}
    manifest_arrays = {}
    for name, leaf in leaves_with_paths(tree):
        arr, dtype = _to_numpy(leaf)
        arrays[name] = arr
        manifest_arrays[name] = {"shape": list(arr.shape), "dtype": dtype}
    path = os.path.join(tmp, "host_0.npz")
    with open(path, "wb") as f:
        np.savez(f, **{k.replace("/", "|"): v for k, v in arrays.items()})
        f.flush()
        os.fsync(f.fileno())

    manifest = {"step": step, "arrays": manifest_arrays,
                "process_count": 1, "structure": "flat-names",
                **(extra_metadata or {})}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())

    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _check_shape(arr: np.ndarray, like: Any, name: str) -> None:
    want = tuple(like.shape) if hasattr(like, "shape") else \
        tuple(np.shape(like))
    if tuple(arr.shape) != want:
        raise ValueError(f"shape mismatch for {name}: ckpt {arr.shape} vs "
                         f"{want}")


def _host_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _leaf_from(arr: np.ndarray, dtype: str, like: Any, name: str,
               placements=None, mesh=None) -> Any:
    """The stored array as ``like``'s kind of leaf: a tensor on its device
    and dtype (keeping its ``requires_grad``), else a numpy array.  A
    DTensor ``like`` (or given ``placements`` on ``mesh``) gets the whole
    array distributed onto its mesh and placements: each rank keeps its
    block, whatever mesh wrote the checkpoint."""
    if placements is not None or _is_dt(like):
        from torch.distributed.tensor import distribute_tensor
        grad = bool(getattr(like, "requires_grad", False))
        if placements is None:
            mesh, placements = like.device_mesh, like.placements
            dev = like.to_local().device
        else:
            dev = mesh.device_type
        _check_shape(arr, like, name)
        t = _host_tensor(arr, dtype).to(device=dev, dtype=like.dtype)
        d = distribute_tensor(t, mesh, placements, src_data_rank=None)
        return d.requires_grad_(grad)
    _check_shape(arr, like, name)
    t = _host_tensor(arr, dtype)
    if not isinstance(like, torch.Tensor):
        return t.numpy() if t.dtype != torch.bfloat16 else t
    t = t.to(device=like.device, dtype=like.dtype)
    return t.requires_grad_(like.requires_grad)


def restore_pytree(template: Any, ckpt_dir: str,
                   step: Optional[int] = None,
                   shardings: Optional[Any] = None, mesh=None) -> Any:
    """Restore into the structure, devices and dtypes of ``template``.

    ``shardings``: a tree of DTensor placements of ``template``'s
    structure (None leaves stay plain) on ``mesh`` — the elastic-restore
    path: the saved whole arrays are placed onto the *new* mesh
    regardless of the writer's topology.  A DTensor leaf of ``template``
    is restored onto its own mesh and placements."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)

    data: Dict[str, np.ndarray] = {}
    for fn in sorted(os.listdir(d)):
        if fn.startswith("host_") and fn.endswith(".npz"):
            with np.load(os.path.join(d, fn)) as z:
                for k in z.files:
                    data[k.replace("|", "/")] = z[k]

    meta = manifest.get("arrays", {})
    named = leaves_with_paths(template)
    places = [None] * len(named) if shardings is None else \
        _placement_leaves(shardings, template)
    new = []
    for (name, leaf), pl in zip(named, places):
        if name not in data:
            raise KeyError(f"checkpoint missing array {name!r}")
        arr = data[name]
        new.append(_leaf_from(arr, meta.get(name, {}).get("dtype",
                                                          str(arr.dtype)),
                              leaf, name, pl, mesh))
    return unflatten(template, new)


def _placement_leaves(shardings: Any, template: Any) -> list:
    """``shardings``' entry for each leaf of ``template``, in leaf order
    (a placements tuple is a leaf there, not a container)."""
    if isinstance(template, dict):
        return [x for k, v in template.items()
                for x in _placement_leaves(shardings[k], v)]
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return [x for f in template._fields
                for x in _placement_leaves(getattr(shardings, f),
                                           getattr(template, f))]
    if isinstance(template, (list, tuple)):
        return [x for i, v in enumerate(template)
                for x in _placement_leaves(shardings[i], v)]
    return [] if template is None else [shardings]


class AsyncCheckpointer:
    """Non-blocking saver: device -> host copy now, file I/O on a thread.

    After each write the newest ``keep`` step directories stay (0: all).
    ``keep=1`` holds one checkpoint on disk at a time: the one before is
    deleted before the next is written, so a state of more than half the
    disk fits, and a crash during that write leaves none.  ``log`` gets
    each finished save's step, host-copy seconds and write seconds.

    A tree of DTensors (a sharded train state) is gathered whole on every
    rank, and rank 0 writes it; after a save, :meth:`wait` is a barrier
    of the process group, so every rank reads a finished checkpoint."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.log: list = []
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._sharded = False

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._sharded:
            import torch.distributed as dist
            dist.barrier()
            self._sharded = False
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, tree: Any, step: int,
             extra_metadata: Optional[Dict[str, Any]] = None) -> None:
        self.wait()
        t0 = time.perf_counter()
        self._sharded = any(_is_dt(x) for _, x in leaves_with_paths(tree))
        host_tree = tree_map(_host_copy, tree)
        copy_s = time.perf_counter() - t0
        if _rank() != 0:
            return
        if self.keep == 1:
            self._gc(0)

        def work():
            t1 = time.perf_counter()
            try:
                save_pytree(host_tree, self.ckpt_dir, step, extra_metadata)
                if self.keep:
                    self._gc(self.keep)
                self.log.append({"step": step, "host_copy_s": copy_s,
                                 "write_s": time.perf_counter() - t1})
            except BaseException as e:   # surfaced at next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _gc(self, keep: int) -> None:
        """Delete all but the newest ``keep`` step directories."""
        if not os.path.isdir(self.ckpt_dir):
            return
        steps = sorted(int(m.group(1)) for d in os.listdir(self.ckpt_dir)
                       if (m := _STEP_RE.match(d)))
        for s in steps[:max(len(steps) - keep, 0)]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:09d}"),
                          ignore_errors=True)
