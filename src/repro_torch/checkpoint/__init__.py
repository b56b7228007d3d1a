"""Atomic, async checkpointing of trees of tensors (the port of the
reference's ``checkpoint/``).

* **step-numbered directories** ``ckpt_dir/step_000123/`` holding one
  ``host_0.npz`` (every leaf under its path name) and ``manifest.json``
  (step, each leaf's shape and dtype);
* **atomic commit**: writes go to ``step_X.tmp.0`` and are renamed only
  after the arrays and the manifest are fsynced, so a crash mid-write
  never corrupts the latest checkpoint;
* **async save**: ``AsyncCheckpointer`` copies the tensors to host memory
  at once (the train step updates them in place afterwards) and writes
  the files on a worker thread; ``wait()`` joins before the next save;
  it keeps the newest ``keep`` checkpoints, and with ``keep=1`` deletes
  the last one before writing the next (one state on disk at a time);
* **restore into any state**: leaves are matched by path name and placed
  on the template's device and dtype, so a checkpoint restores into a
  freshly built state.  bfloat16 leaves are stored as their raw 16 bits
  with the dtype named in the manifest (numpy has no bfloat16);
* **sharded states**: DTensor leaves are gathered whole and rank 0 writes
  them; ``restore_pytree`` places each array onto the template's (or
  ``shardings=``'s) mesh and placements, whatever mesh wrote it.
"""

from .checkpointer import (AsyncCheckpointer, latest_step, restore_pytree,
                           save_pytree)

__all__ = ["AsyncCheckpointer", "save_pytree", "restore_pytree", "latest_step"]
