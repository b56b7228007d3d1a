"""Randomized multi-tenant chaos soak of the port's gateway, on the CPU:
the twin of ``tests/test_chaos.py``.

Concurrent clients x tenants x live ``update_gallery`` flips x replica
kills x maintenance healing x ``stop()`` — the invariants:

* every submitted future resolves (no hang, no leak);
* every *successful* result is bit-identical to one of the two clean
  single-plan oracles (the gallery only ever holds version A or B, and
  a request spans exactly one version — never a mix); the port's
  oracles equal the reference plan's on the same inputs (index swaps
  only between float64 near-ties);
* every failure is one of the allowed shapes (admission rejection,
  tenant unavailability, deadline, stopped gateway).

Case count is CI-bounded via ``REPRO_CHAOS_CASES`` (0 skips).
"""

import threading
import time

import numpy as np
import pytest

import repro.core as R
from repro_torch.core import ArchSpec, compile_fn
from repro_torch.core.envcfg import env_int
from repro_torch.serving import (AdmissionError, CamServingGateway,
                                 TenantUnavailable)
from test_torch_kernels import _assert_eucl_close

N, DIM, K = 64, 16, 3
CASES = env_int("REPRO_CHAOS_CASES", 3, min_value=0)


def _knn(q, gallery):
    d = q.unsqueeze(1).sub(gallery).norm(p=2, dim=-1)
    return d.topk(K, largest=False)


@pytest.fixture(scope="module")
def compiled():
    gal = np.zeros((N, DIM), np.float32)
    ex = [np.zeros((4, DIM), np.float32), gal]
    prog = compile_fn(_knn, ex, ArchSpec(rows=32, cols=DIM), device="cpu")
    rprog = R.compile_fn(_knn, ex, R.ArchSpec(rows=32, cols=DIM))
    return prog, rprog


ALLOWED = (AdmissionError, TenantUnavailable, TimeoutError)


@pytest.mark.skipif(CASES == 0, reason="REPRO_CHAOS_CASES=0")
@pytest.mark.parametrize("case", range(CASES))
def test_chaos_soak(compiled, case):
    prog, rprog = compiled
    plan = prog.engine_plan
    rng = np.random.default_rng(1000 + case)
    gal_a = rng.standard_normal((N, DIM)).astype(np.float32)
    gal_b = rng.standard_normal((N, DIM)).astype(np.float32)
    queries = {t: rng.standard_normal((4, DIM)).astype(np.float32)
               for t in ("t0", "t1")}
    # clean oracles: the gallery is only ever wholly A or wholly B
    oracle = {t: {v: plan.execute(queries[t], g)[1].numpy()
                  for v, g in (("a", gal_a), ("b", gal_b))}
              for t in ("t0", "t1")}
    for t in ("t0", "t1"):
        for g in (gal_a, gal_b):
            pv, pi = (x.numpy() for x in plan.execute(queries[t], g))
            rv, ri = (np.asarray(x)
                      for x in rprog.engine_plan.execute(queries[t], g))
            _assert_eucl_close(queries[t], g, rv, ri, pv, pi)

    gw = CamServingGateway(maint_ms=5.0)
    for t in ("t0", "t1"):
        gw.register_tenant(t, prog, gal_a.copy(), replicas=2,
                           unhealthy_k=2, queue_limit=64,
                           max_outstanding=4)

    stop_evt = threading.Event()
    handles = []
    handles_lock = threading.Lock()
    failures = []

    def client(tenant):
        while not stop_evt.is_set():
            try:
                h = gw.submit(tenant, queries[tenant])
            except ALLOWED:
                continue
            except RuntimeError as e:
                if "stopped" in str(e):
                    return
                failures.append(repr(e))
                return
            with handles_lock:
                handles.append((tenant, h))

    def updater(tenant):
        flip = False
        idx = np.arange(N)
        while not stop_evt.is_set():
            src = gal_b if flip else gal_a
            try:
                gw.update_gallery(tenant, idx, src)
            except Exception as e:          # noqa: BLE001 — recorded
                failures.append(f"update: {e!r}")
                return
            flip = not flip
            time.sleep(0.01)

    def chaos():
        k = 0
        while not stop_evt.is_set():
            time.sleep(0.15)
            try:
                gw.kill_replica("t0" if k % 2 else "t1", k % 2)
            except Exception as e:          # noqa: BLE001 — recorded
                failures.append(f"kill: {e!r}")
                return
            k += 1

    threads = [threading.Thread(target=client, args=(t,))
               for t in ("t0", "t1") for _ in range(2)]
    threads += [threading.Thread(target=updater, args=(t,))
                for t in ("t0", "t1")]
    threads.append(threading.Thread(target=chaos))
    for th in threads:
        th.start()
    time.sleep(1.2)
    stop_evt.set()
    stuck = []
    for th in threads:
        th.join(30)
        if th.is_alive():
            stuck.append(th.name)
    if stuck:
        import faulthandler
        faulthandler.dump_traceback()       # name the wedged thread
        raise AssertionError(f"chaos workers failed to stop: {stuck}")

    assert not failures, failures[:5]

    mismatches = 0
    resolved = 0
    for tenant, h in handles:
        res = h.wait(60)                    # every future must resolve
        resolved += 1
        if res.error is None:
            ok = any(np.array_equal(np.asarray(res.indices), want)
                     for want in oracle[tenant].values())
            if not ok:
                mismatches += 1
        else:
            assert isinstance(res.error, ALLOWED + (RuntimeError,)), \
                repr(res.error)
    assert mismatches == 0, \
        f"{mismatches}/{resolved} successful results match no clean oracle"
    assert resolved > 0
    gw.stop()
