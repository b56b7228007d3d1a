"""The port's multi-tenant gateway (``repro_torch.serving``: tenants,
replica sets, ``CamServingGateway``) on the CPU.

Twins of the 30 tests of ``tests/test_gateway.py``, the gateway / tenant
/ replica knobs of ``tests/test_env.py`` and
``tests/test_trace.py::TestGatewayFollowability``.  Served results equal
the port plan's bit for bit (batching and routing change scheduling,
never arithmetic), and the port plan's equal the reference plan's on the
same numpy inputs: eucl to the stated tolerance, index swaps only between
float64 near-ties.  The reference's ``server_kwargs={"max_retries": 0,
"breaker_threshold": 0}`` has no twin: the port's retries and breaker are
constants.  Every wait, join and stop is bounded.
"""

import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro_torch import obs
from repro_torch.faults import FaultModel
from repro_torch.serving import (AdmissionError, CamServingGateway,
                                 TenantUnavailable)
from repro_torch.serving.tenant import (AdmissionConfig, _PendingQueue,
                                        _TokenBucket)
from test_torch_kernels import _assert_eucl_close

N, DIM, K = 96, 16, 3
#: bound of every wait in this file (seconds)
WAIT = 30
ROOT = Path(__file__).resolve().parents[1]


def _knn(q, gallery):
    d = q.unsqueeze(1).sub(gallery).norm(p=2, dim=-1)
    return d.topk(K, largest=False)


@pytest.fixture(scope="module")
def compiled():
    """(port program, gallery, reference program) — the reference's
    ``compiled`` fixture, compiled by both packages."""
    rng = np.random.default_rng(5)
    gal = rng.standard_normal((N, DIM)).astype(np.float32)
    ex = [np.zeros((8, DIM), np.float32), gal]
    prog = T.compile_fn(_knn, ex, T.ArchSpec(rows=32, cols=DIM),
                        device="cpu")
    assert prog.engine_plan is not None
    rprog = R.compile_fn(_knn, ex, R.ArchSpec(rows=32, cols=DIM))
    return prog, gal, rprog


@pytest.fixture()
def gw():
    g = CamServingGateway(maint_ms=0.0)     # no background thread: tests
    yield g                                 # drive maintenance explicitly
    g.stop()


def _direct(prog, q, gal):
    v, i = prog.engine_plan.execute(q, gal)
    return v.numpy(), i.numpy()


def _assert_reference(rprog, q, gal, v, i):
    """The served result against the reference plan on the same inputs."""
    rv, ri = (np.asarray(x) for x in rprog.engine_plan.execute(q, gal))
    _assert_eucl_close(q, gal, rv, ri, v, i)


# -- admission primitives ---------------------------------------------------

class TestAdmissionPrimitives:
    def test_token_bucket_limits_and_refills(self):
        b = _TokenBucket(rate=100.0, burst=10)
        assert b.try_acquire(10)
        assert not b.try_acquire(1)
        time.sleep(0.05)                    # ~5 tokens back
        assert b.try_acquire(2)

    def test_token_bucket_unlimited_when_rate_zero(self):
        b = _TokenBucket(rate=0.0, burst=1)
        assert all(b.try_acquire(1000) for _ in range(100))

    def test_pending_queue_sheds_lowest_priority_newest(self):
        q = _PendingQueue(limit=2)
        assert q.push(1, "a") is None
        assert q.push(1, "b") is None
        # full; incoming priority 0 ranks below everything -> bounced
        assert q.push(0, "c") == "c"
        # incoming priority 2 evicts the NEWEST of the priority-1 pair
        assert q.push(2, "d") == "b"
        assert q.pop() == "d" and q.pop() == "a" and q.pop() is None

    def test_pending_queue_fifo_within_priority(self):
        q = _PendingQueue(limit=4)
        for item in ["a", "b", "c"]:
            q.push(0, item)
        assert [q.pop() for _ in range(3)] == ["a", "b", "c"]


# -- registry ---------------------------------------------------------------

class TestRegistry:
    def test_duplicate_name_rejected(self, compiled, gw):
        prog, gal, _ = compiled
        gw.register_tenant("a", prog, gal)
        with pytest.raises(ValueError, match="already registered"):
            gw.register_tenant("a", prog, gal)

    def test_share_with_unknown_peer(self, compiled, gw):
        with pytest.raises(KeyError, match="unknown tenant"):
            gw.register_tenant("a", share_with="ghost")

    def test_share_with_excludes_gallery(self, compiled, gw):
        prog, gal, _ = compiled
        gw.register_tenant("a", prog, gal)
        with pytest.raises(ValueError, match="share_with"):
            gw.register_tenant("b", gallery=gal, share_with="a")

    def test_register_needs_program_and_gallery(self, gw):
        with pytest.raises(ValueError, match="program"):
            gw.register_tenant("a")

    def test_shared_tenants_share_one_replica_set(self, compiled, gw):
        prog, gal, _ = compiled
        gw.register_tenant("a", prog, gal, replicas=2)
        gw.register_tenant("b", share_with="a")
        ta, tb = gw._tenant("a"), gw._tenant("b")
        assert ta.rset is tb.rset and ta.rset.refs == 2
        assert gw.tenants == ["a", "b"]

    def test_unknown_tenant_submit(self, compiled, gw):
        with pytest.raises(KeyError, match="unknown tenant"):
            gw.submit("ghost", np.zeros((1, DIM), np.float32))


# -- serving parity + replicas ----------------------------------------------

class TestServing:
    def test_search_bit_identical_to_plan(self, compiled, gw, rng):
        prog, gal, rprog = compiled
        gw.register_tenant("t", prog, gal, replicas=2)
        q = rng.standard_normal((5, DIM)).astype(np.float32)
        v, i = gw.search("t", q, timeout=WAIT)
        ev, ei = _direct(prog, q, gal)
        np.testing.assert_array_equal(i, ei)
        np.testing.assert_array_equal(v, ev)
        _assert_reference(rprog, q, gal, v, i)

    def test_replicas_share_one_pattern_memo(self, compiled, gw, rng):
        prog, gal, _ = compiled
        plan = prog.engine_plan
        before = plan.counters()["pattern_misses"]
        gw.register_tenant("t", prog, gal, replicas=3)
        q = rng.standard_normal((2, DIM)).astype(np.float32)
        for _ in range(6):                  # bounce across replicas
            gw.search("t", q, timeout=WAIT)
        after = plan.counters()["pattern_misses"]
        # one warm() prepare for the whole 3-replica fleet
        assert after - before <= 1

    def test_result_carries_device_group(self, compiled, gw, rng):
        prog, gal, _ = compiled
        gw.register_tenant("t", prog, gal, replicas=2,
                           device_groups=["dg-A", "dg-B"])
        q = rng.standard_normal((2, DIM)).astype(np.float32)
        seen = {gw.submit("t", q).wait(WAIT).replica for _ in range(12)}
        assert seen <= {"dg-A", "dg-B"} and seen

    def test_read_your_writes_across_shared_set(self, compiled, gw, rng):
        prog, gal, rprog = compiled
        gw.register_tenant("w", prog, gal, replicas=2)
        gw.register_tenant("r", share_with="w")
        q = rng.standard_normal((4, DIM)).astype(np.float32)
        cur = gal.copy()
        for step in range(4):
            rows = rng.standard_normal((3, DIM)).astype(np.float32)
            idx = rng.choice(N, 3, replace=False)
            assert gw.update_gallery("w", idx, rows) == 3
            cur[idx] = rows
            v, got = gw.search("r", q, timeout=WAIT)  # right after the write
            _, want = _direct(prog, q, cur)
            np.testing.assert_array_equal(got, want)
            _assert_reference(rprog, q, cur, v, got)


# -- admission control ------------------------------------------------------

class TestAdmission:
    def test_rate_limit_rejects(self, compiled, gw, rng):
        prog, gal, _ = compiled
        gw.register_tenant("t", prog, gal, rate=1.0, burst=2)
        q = rng.standard_normal((1, DIM)).astype(np.float32)
        gw.search("t", q, timeout=WAIT)     # burst token 1
        gw.search("t", q, timeout=WAIT)     # burst token 2
        with pytest.raises(AdmissionError, match="rate limit"):
            gw.submit("t", q)
        st = gw.health()["tenants"]["t"]["stats"]
        assert st["rejected_rate"] == 1 and st["completed"] == 2

    def test_queue_full_rejects_submitter(self, compiled, gw, rng):
        prog, gal, _ = compiled
        # 1 outstanding slot + 1 queued; block the slot with a fault
        # injector that stalls dispatch
        gate = threading.Event()
        gw.register_tenant("t", prog, gal, queue_limit=1,
                           max_outstanding=1,
                           fault_injectors=[lambda lvl: gate.wait(10)],
                           server_kwargs={"max_wait_ms": 0.0})
        q = rng.standard_normal((1, DIM)).astype(np.float32)
        h1 = gw.submit("t", q)              # occupies the slot
        h2 = gw.submit("t", q)              # queued
        with pytest.raises(AdmissionError, match="queue full"):
            gw.submit("t", q)
        gate.set()
        assert h1.wait(WAIT).error is None
        assert h2.wait(WAIT).error is None

    def test_shed_prefers_low_priority(self, compiled, gw, rng):
        prog, gal, _ = compiled
        gate = threading.Event()
        gw.register_tenant("t", prog, gal, queue_limit=1,
                           max_outstanding=1,
                           fault_injectors=[lambda lvl: gate.wait(10)],
                           server_kwargs={"max_wait_ms": 0.0})
        q = rng.standard_normal((1, DIM)).astype(np.float32)
        h1 = gw.submit("t", q)              # slot
        low = gw.submit("t", q, priority=0)  # queued
        high = gw.submit("t", q, priority=5)  # evicts low
        res = low.wait(WAIT)
        assert isinstance(res.error, AdmissionError)
        gate.set()
        assert h1.wait(WAIT).error is None
        assert high.wait(WAIT).error is None
        assert gw.health()["tenants"]["t"]["stats"]["shed"] == 1

    def test_per_tenant_budgets_are_independent(self, compiled, gw, rng):
        prog, gal, _ = compiled
        gw.register_tenant("free", prog, gal)
        gw.register_tenant("capped", share_with="free", rate=1.0, burst=1)
        q = rng.standard_normal((1, DIM)).astype(np.float32)
        gw.search("capped", q, timeout=WAIT)
        with pytest.raises(AdmissionError):
            gw.submit("capped", q)
        for _ in range(5):                  # the peer is untouched
            gw.search("free", q, timeout=WAIT)


# -- failover / health ------------------------------------------------------

class TestFailover:
    def test_failover_to_healthy_replica(self, compiled, gw, rng):
        prog, gal, _ = compiled
        gw.register_tenant("t", prog, gal, replicas=2, unhealthy_k=3)
        q = rng.standard_normal((3, DIM)).astype(np.float32)
        _, want = _direct(prog, q, gal)
        gw.kill_replica("t", 0)
        for _ in range(8):                  # all served by replica 1
            _, got = gw.search("t", q, timeout=WAIT)
            np.testing.assert_array_equal(got, want)
        h = gw.health()["tenants"]["t"]
        assert h["stats"]["failovers"] > 0
        assert h["stats"]["completed"] >= 8

    def test_kill_drain_heal_readmit(self, compiled, gw, rng):
        prog, gal, _ = compiled
        gw.register_tenant("t", prog, gal, replicas=2, unhealthy_k=2)
        q = rng.standard_normal((2, DIM)).astype(np.float32)
        gw.kill_replica("t", 0)
        for _ in range(4):
            gw.search("t", q, timeout=WAIT)  # failures drain replica 0
        rep0 = gw._tenant("t").rset.replicas[0]
        assert rep0.state == "draining"
        report = gw.check_tenant("t")
        assert [h["mode"] for h in report["healed"]] == ["rebuild"]
        assert rep0.state == "serving" and rep0.generation == 1
        assert rep0.rebuilds == 1 and not rep0._killed
        # the rebuilt replica serves again, bit-identically
        _, i1 = gw.search("t", q, timeout=WAIT)
        _, want = _direct(prog, q, gal)
        np.testing.assert_array_equal(i1, want)

    def test_heal_hashes_only_replicas_off_the_shared_tensors(
            self, compiled, gw, rng, monkeypatch):
        """A replica that serves the set's shared tensors has diverged by
        0 rows without a hash; one that holds its own copy is hashed."""
        prog, gal, _ = compiled
        gw.register_tenant("t", prog, gal, replicas=2, unhealthy_k=2)
        rset = gw._tenant("t").rset
        hashed = []
        real = rset._divergence
        monkeypatch.setattr(rset, "_divergence",
                            lambda r: hashed.append(r.idx) or real(r))
        q = rng.standard_normal((2, DIM)).astype(np.float32)
        gw.kill_replica("t", 0)
        for _ in range(4):
            gw.search("t", q, timeout=WAIT)  # failures drain replica 0
        assert rset.replicas[0].state == "draining"
        report = gw.check_tenant("t")
        assert [(h["mode"], h["rows_resynced"])
                for h in report["healed"]] == [("rebuild", 0)]
        assert hashed == []
        wrong = gal.copy()
        wrong[:3] += 1.0
        rset.replicas[1].server.adopt_gallery(torch.from_numpy(wrong))
        report = gw.check_tenant("t")
        assert hashed == [1]
        assert {e["replica"]: e["rows_resynced"]
                for e in report["checked"]} == {0: 0, 1: 3}
        _, got = gw.search("t", q, timeout=WAIT)
        np.testing.assert_array_equal(got, _direct(prog, q, gal)[1])

    def test_all_replicas_down_is_unavailable(self, compiled, gw, rng):
        prog, gal, _ = compiled
        gw.register_tenant("t", prog, gal, replicas=1, unhealthy_k=1,
                           breaker_threshold=0)
        q = rng.standard_normal((1, DIM)).astype(np.float32)
        gw.kill_replica("t", 0)
        h = gw.submit("t", q)
        assert isinstance(h.wait(WAIT).error, TenantUnavailable)

    def test_breaker_opens_after_unavailability(self, compiled, gw, rng):
        prog, gal, _ = compiled
        gw.register_tenant("t", prog, gal, replicas=1, unhealthy_k=1,
                           breaker_threshold=1,
                           breaker_cooldown_ms=60_000.0)
        q = rng.standard_normal((1, DIM)).astype(np.float32)
        gw.kill_replica("t", 0)
        assert isinstance(gw.submit("t", q).wait(WAIT).error,
                          TenantUnavailable)
        with pytest.raises(TenantUnavailable, match="breaker"):
            gw.submit("t", q)
        h = gw.health()
        assert h["status"] == "degraded"
        assert h["tenants"]["t"]["breaker"]["state"] == "open"
        assert h["tenants"]["t"]["stats"]["rejected_breaker"] == 1

    def test_divergence_detected_and_resynced(self, compiled, gw, rng):
        prog, gal, _ = compiled
        gw.register_tenant("t", prog, gal, replicas=2)
        rset = gw._tenant("t").rset
        # sabotage replica 1's served copy behind the gateway's back
        wrong = gal.copy()
        wrong[:5] += 1.0
        rset.replicas[1].server.adopt_gallery(torch.from_numpy(wrong))
        report = gw.check_tenant("t")
        resynced = {e["replica"]: e["rows_resynced"]
                    for e in report["checked"]}
        assert resynced[1] == 5 and resynced[0] == 0
        # both replicas serve canonical content again
        q = rng.standard_normal((2, DIM)).astype(np.float32)
        _, want = _direct(prog, q, gal)
        for _ in range(6):
            _, got = gw.search("t", q, timeout=WAIT)
            np.testing.assert_array_equal(got, want)

    def test_fault_degraded_replica_is_drained_and_scrubbed(
            self, compiled, gw, rng):
        prog, gal, _ = compiled
        # drift-only aging: a rewrite restarts drift from t=0, so the
        # heal mode must be "scrub", not "rebuild"
        fm = FaultModel(seed=99, drift=0.05, t=50)
        gw.register_tenant("t", prog, gal, replicas=2,
                           fault_models=[fm, None], max_fault_rows=0)
        rset = gw._tenant("t").rset
        report = gw.check_tenant("t")
        drained = [e for e in report["checked"] if e.get("drained")]
        assert [e["replica"] for e in drained] == [0]
        healed = {h["replica"]: h["mode"] for h in report["healed"]}
        assert healed.get(0) == "scrub"
        r0 = rset.replicas[0]
        assert r0.state == "serving" and r0.generation == 0
        assert r0.fault_model is not None and r0.fault_model.epoch == 1

    def test_maintenance_thread_heals(self, compiled, rng):
        prog, gal, _ = compiled
        g = CamServingGateway(maint_ms=5.0)
        try:
            g.register_tenant("t", prog, gal, replicas=2, unhealthy_k=1)
            q = rng.standard_normal((1, DIM)).astype(np.float32)
            g.kill_replica("t", 0)
            g.search("t", q, timeout=WAIT)  # drains replica 0
            deadline = time.perf_counter() + 10
            r0 = g._tenant("t").rset.replicas[0]
            while time.perf_counter() < deadline:
                if r0.state == "serving" and r0.rebuilds > 0:
                    break
                time.sleep(0.01)
            assert r0.state == "serving" and r0.rebuilds == 1
        finally:
            g.stop()


# -- lifecycle --------------------------------------------------------------

class TestLifecycle:
    def test_stop_settles_everything(self, compiled, rng):
        prog, gal, _ = compiled
        gate = threading.Event()
        g = CamServingGateway(maint_ms=0.0)
        g.register_tenant("t", prog, gal, max_outstanding=1,
                          queue_limit=8,
                          fault_injectors=[lambda lvl: gate.wait(10)],
                          server_kwargs={"max_wait_ms": 0.0})
        q = rng.standard_normal((1, DIM)).astype(np.float32)
        handles = [g.submit("t", q) for _ in range(5)]
        stopper = threading.Thread(target=g.stop)
        stopper.start()
        gate.set()
        stopper.join(15)
        assert not stopper.is_alive()
        for h in handles:
            h.wait(WAIT)                    # every future resolves
        with pytest.raises(RuntimeError, match="stopped"):
            g.submit("t", q)

    def test_context_manager(self, compiled, rng):
        prog, gal, _ = compiled
        q = rng.standard_normal((1, DIM)).astype(np.float32)
        with CamServingGateway(maint_ms=0.0) as g:
            g.register_tenant("t", prog, gal)
            g.search("t", q, timeout=WAIT)


# -- telemetry --------------------------------------------------------------

class TestHealth:
    def test_health_shape_and_ok_status(self, compiled, gw, rng):
        prog, gal, _ = compiled
        gw.register_tenant("t", prog, gal, replicas=2)
        q = rng.standard_normal((2, DIM)).astype(np.float32)
        for _ in range(3):
            gw.search("t", q, timeout=WAIT)
        h = gw.health()
        assert h["status"] == "ok" and h["accepting"]
        e = h["tenants"]["t"]
        assert e["stats"]["completed"] == 3
        assert e["stats"]["queries"] == 6
        assert "p95_ms" in e["latency"]
        assert e["replicas"]["serving"] == 2
        assert {r["state"] for r in e["replicas"]["replicas"]} \
            == {"serving"}
        assert e["admission"]["queue_limit"] >= 1

    def test_snapshot_includes_server_snapshots(self, compiled, gw, rng):
        prog, gal, _ = compiled
        gw.register_tenant("t", prog, gal, replicas=2)
        gw.search("t", rng.standard_normal((1, DIM)).astype(np.float32),
                  timeout=WAIT)
        snap = gw.snapshot()
        servers = snap["tenants"]["t"]["servers"]
        assert len(servers) == 2
        assert all(s is None or "plan" in s for s in servers)


def test_example_multitenant_serve_runs():
    out = subprocess.run(
        [sys.executable, "examples/port_multitenant_serve.py", "--device",
         "cpu"], capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**__import__("os").environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr[-2000:]
    assert "MULTITENANT-OK" in out.stdout


# -- knobs (tests/test_env.py twins) -----------------------------------------

class TestKnobs:
    def test_tenant_knobs_garbage_fails_at_registration(self, monkeypatch):
        gw = CamServingGateway(maint_ms=0.0)
        monkeypatch.setenv("REPRO_TENANT_RATE", "plenty")
        with pytest.raises(ValueError, match="REPRO_TENANT_RATE"):
            gw.register_tenant("t", object(), object())
        monkeypatch.delenv("REPRO_TENANT_RATE")
        monkeypatch.setenv("REPRO_TENANT_QUEUE", "0")
        with pytest.raises(ValueError, match="REPRO_TENANT_QUEUE"):
            gw.register_tenant("t", object(), object())
        gw.stop()

    def test_replica_knobs_garbage_fails_at_registration(
            self, monkeypatch, compiled):
        prog, gal, _ = compiled
        gw = CamServingGateway(maint_ms=0.0)
        monkeypatch.setenv("REPRO_SERVE_REPLICAS", "many")
        with pytest.raises(ValueError, match="REPRO_SERVE_REPLICAS"):
            gw.register_tenant("t", prog.engine_plan, gal)
        monkeypatch.delenv("REPRO_SERVE_REPLICAS")
        monkeypatch.setenv("REPRO_SERVE_UNHEALTHY_K", "0")
        with pytest.raises(ValueError, match="REPRO_SERVE_UNHEALTHY_K"):
            gw.register_tenant("t", prog.engine_plan, gal)
        gw.stop()

    def test_gateway_maint_garbage_fails_at_construction(self, monkeypatch):
        monkeypatch.setenv("REPRO_SERVE_MAINT_MS", "often")
        with pytest.raises(ValueError, match="REPRO_SERVE_MAINT_MS"):
            CamServingGateway()

    def test_admission_config_matches_reference(self, monkeypatch):
        """The strict ``REPRO_TENANT_*`` defaults resolve as the
        reference's do."""
        from repro.serving.tenant import AdmissionConfig as RConfig
        monkeypatch.setenv("REPRO_TENANT_RATE", "12.5")
        monkeypatch.setenv("REPRO_TENANT_BURST", "7")
        monkeypatch.setenv("REPRO_TENANT_DEADLINE_MS", "250")
        assert AdmissionConfig.from_env(queue_limit=3).view() == \
            RConfig.from_env(queue_limit=3).view()


# -- trace followability (tests/test_trace.py twins) -------------------------

@pytest.fixture()
def clean_tracer():
    obs.stop()
    obs.tracer.clear()
    yield
    obs.stop()
    obs.tracer.clear()


def _events(doc, *, ph, pid, name):
    """Events of one phase, process label and name (pids are numbered
    in the export; the process_name metadata maps labels to them)."""
    pids = {e["args"]["name"]: e["pid"] for e in doc["traceEvents"]
            if e["ph"] == "M" and e["name"] == "process_name"}
    return [e for e in doc["traceEvents"] if e["ph"] == ph
            and e["pid"] == pids.get(pid) and e["name"] == name]


def _assert_valid_chrome(doc):
    """Every B has an E (per pid/tid, LIFO), timestamps non-negative."""
    json.dumps(doc)
    assert doc["displayTimeUnit"] == "ms"
    stacks = {}
    for e in doc["traceEvents"]:
        if e["ph"] == "M":
            continue
        assert e["ts"] >= 0
        if e["ph"] == "B":
            stacks.setdefault((e["pid"], e["tid"]), []).append(e)
        elif e["ph"] == "E":
            assert stacks[(e["pid"], e["tid"])].pop()["name"] == e["name"]
    assert not any(stacks.values())


class TestGatewayFollowability:
    def test_multitenant_request_followable_across_components(
            self, compiled, clean_tracer, rng, tmp_path):
        """A traced multi-tenant run gives a Chrome-tracing export in
        which one request is followable gateway -> serving -> engine via
        the ``gw.route`` link."""
        prog, gal, _ = compiled
        obs.enable()
        gw = CamServingGateway(maint_ms=0.0)
        try:
            gw.register_tenant("alpha", prog, gal)
            gw.register_tenant("beta", prog, gal)
            for tenant in ("alpha", "beta"):
                for _ in range(2):
                    q = rng.standard_normal((2, DIM)).astype(np.float32)
                    gw.search(tenant, q, timeout=WAIT)
            path = gw.dump_trace(str(tmp_path / "gateway.json"))
        finally:
            gw.stop()
            obs.stop()
        with open(path) as f:
            doc = json.load(f)
        _assert_valid_chrome(doc)

        gw_reqs = _events(doc, ph="X", pid="gateway", name="request")
        routes = _events(doc, ph="i", pid="gateway", name="gw.route")
        srv_reqs = _events(doc, ph="X", pid="serving", name="request")
        assert len(gw_reqs) == 4 and len(routes) == 4
        assert {e["args"]["tenant"] for e in gw_reqs} == {"alpha", "beta"}
        for g in gw_reqs:
            route = next(r for r in routes
                         if r["args"]["rid"] == g["args"]["rid"])
            s = [e for e in srv_reqs
                 if e["args"]["rid"] == route["args"]["server_rid"]]
            assert len(s) == 1, \
                f"gateway rid {g['args']['rid']} not followable"
        assert _events(doc, ph="X", pid="gateway", name="gw.admission")
        assert _events(doc, ph="B", pid="engine", name="plan.dispatch")

    def test_reject_instants_carry_reason(self, compiled, clean_tracer):
        prog, gal, _ = compiled
        obs.enable()
        gw = CamServingGateway(maint_ms=0.0)
        try:
            gw.register_tenant("limited", prog, gal, rate=1.0, burst=2)
            q = np.zeros((2, DIM), np.float32)
            gw.search("limited", q, timeout=WAIT)   # drains the burst
            with pytest.raises(AdmissionError):
                gw.submit("limited", q)             # over rate
        finally:
            gw.stop()
            obs.stop()
        rejects = _events(obs.to_chrome(), ph="i", pid="gateway",
                          name="gw.reject")
        assert any(e["args"]["reason"] == "rate" for e in rejects)
