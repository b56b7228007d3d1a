"""Persistent on-disk plan store: tuned plan configs.

The engine's process-wide plan cache (``repro_torch.core.engine.cache``)
dies with the process, so every fresh server would pay autotuning again.
This module persists the autotuner's winners under a directory named by
``REPRO_PLAN_STORE``:

* **config records** (``cfg-<backend>-<workload>.json``) — the winning
  knob settings the autotuner found for a workload (tile geometry,
  micro-batch, pack, unroll, shards), keyed by
  :func:`~repro_torch.core.engine.spec.workload_digest` (the spec with its
  tile geometry normalised away: the tuner searches over geometry, so
  the key must not depend on it).  Loading a config skips the search.
  The record format is the reference's; the backends are ``"torch"``
  and ``"cuda"``, so the port never reads a reference ``"jnp"`` /
  ``"pallas"`` record, even in a directory both packages share.

The reference's second tier, AOT-serialized executables, has no
counterpart here, by the reference's own eligibility rule: it
serializes only single-device non-tiny ``"jnp"`` plans and leaves
``"pallas"`` plans out because their kernels carry their own
compilation pipeline.  The port's ``"cuda"`` plans are those: their
libraries already persist across processes, named by a hash of their
sources and flags (:mod:`repro_torch.kernels.build`).  The port's
``"torch"`` plans run eagerly and have nothing compiled to persist.  So
:meth:`PlanStore.persist_executables` counts a skip for every plan and
:meth:`PlanStore.adopt_executables` adopts nothing.

Every load/save is counted process-wide (:func:`plan_store_stats`, the
reference's eight counters).
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
from typing import Any, Dict, Optional

from ..core.engine.base import PlanBase
from ..core.engine.spec import workload_digest
from ..core.envcfg import env_path
from ..obs.trace import instant, tracer

__all__ = ["PlanStore", "active_store", "plan_store_stats",
           "reset_plan_store_stats"]

_LOCK = threading.Lock()
_STORES: Dict[str, "PlanStore"] = {}
_STATS = {"config_hits": 0, "config_misses": 0, "config_saves": 0,
          "exec_hits": 0, "exec_misses": 0, "exec_saves": 0,
          "exec_fallbacks": 0, "exec_skips": 0}


def plan_store_stats() -> Dict[str, int]:
    """Process-wide store counters (hits/misses/saves/fallbacks/skips)."""
    with _LOCK:
        return dict(_STATS)


def reset_plan_store_stats() -> None:
    with _LOCK:
        for k in _STATS:
            _STATS[k] = 0


def _bump(key: str, n: int = 1) -> None:
    with _LOCK:
        _STATS[key] += n


def active_store() -> Optional["PlanStore"]:
    """The store named by ``REPRO_PLAN_STORE``, or ``None`` when unset.

    A blank value raises (shell quoting accident, see ``envcfg``); a
    set value creates the directory on first use.  One :class:`PlanStore`
    instance is shared per resolved path.
    """
    path = env_path("REPRO_PLAN_STORE")
    if path is None:
        return None
    path = os.path.abspath(path)
    with _LOCK:
        store = _STORES.get(path)
        if store is None:
            store = _STORES[path] = PlanStore(path)
        return store


def _atomic_write(path: str, data: bytes) -> None:
    """Write-then-rename so a concurrent reader never sees a torn file
    (two processes racing on the same store is the normal warm-start
    topology: a tuner writing while servers read)."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                               prefix=".tmp-", suffix=".part")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class PlanStore:
    """One on-disk plan store directory (see module docstring)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    # -- tuned-config records ---------------------------------------------

    def _config_path(self, spec, backend: str) -> str:
        return os.path.join(
            self.root, f"cfg-{backend}-{workload_digest(spec)}.json")

    def load_config(self, spec, backend: str) -> Optional[Dict[str, Any]]:
        """The tuned config for this workload + backend, or ``None``."""
        path = self._config_path(spec, backend)
        try:
            with open(path) as f:
                cfg = json.load(f)
        except (OSError, ValueError):
            _bump("config_misses")
            if tracer.enabled:
                instant("store.config_miss", pid="engine",
                        args={"backend": backend})
            return None
        _bump("config_hits")
        if tracer.enabled:
            instant("store.config_hit", pid="engine",
                    args={"backend": backend,
                          "speedup": cfg.get("speedup")})
        return cfg

    def save_config(self, spec, backend: str,
                    config: Dict[str, Any]) -> str:
        path = self._config_path(spec, backend)
        rec = dict(config)
        rec.setdefault("version", 1)
        rec["workload"] = workload_digest(spec)
        _atomic_write(path, json.dumps(rec, indent=1,
                                       sort_keys=True).encode())
        _bump("config_saves")
        return path

    # -- executables: config-only (see module docstring) ------------------

    @staticmethod
    def _exec_eligible(plan: PlanBase) -> bool:
        """No port plan has an executable to persist: ``"cuda"`` kernel
        libraries persist in the build directory, ``"torch"`` plans are
        eager."""
        return False

    def persist_executables(self, plan: PlanBase, stored=()) -> bool:
        """The reference's AOT save (``stored``: the operands it lowers
        at): here every plan is config-only, so it counts an
        ``exec_skips`` and returns ``False``."""
        if not self._exec_eligible(plan):
            _bump("exec_skips")
        return False

    def adopt_executables(self, plan: PlanBase) -> bool:
        """The reference's AOT adoption: nothing to adopt, ``False``."""
        return self._exec_eligible(plan)
