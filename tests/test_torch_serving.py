"""Port continuous-batching CAM search server (``repro_torch.serving``)
on the CPU: twins of every test in ``tests/test_serving.py`` (none needs
sharding, tuning or a composite plan) plus the port's own fallback chain,
finalize rescue and tensor queries.  Served results equal the port
plan's bit for bit, as the reference's test holds its own: batching
changes scheduling, never arithmetic.  The port plan's equal the
reference's on the same numpy inputs: integer metrics and matches bit
for bit, eucl to the stated tolerance with index swaps only between
float64 near-ties.  A degraded level (another backend's arithmetic) is
held to the primary's result by the same eucl tolerance.  Every wait,
join and stop is bounded.
"""

import threading
import time

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.core import cim_dialect as rcd
from repro.serving import CamSearchServer as RServer
from repro_torch.core import cim_dialect as tcd
from repro_torch.faults import FaultModel
from repro_torch.serving import CamSearchServer, ServerStats
from repro_torch.serving.resilience import MAX_RETRIES
from test_torch_faults import _interval_data
from test_torch_kernels import _assert_eucl_close
from test_torch_range import range_module
from test_torch_update_rows import sim_module

#: bound of every wait in this file (seconds)
WAIT = 60


def _knn(q, gallery):
    diff = q.unsqueeze(1).sub(gallery)
    d = diff.norm(p=2, dim=-1)
    return d.topk(4, largest=False)


@pytest.fixture(scope="module")
def compiled():
    """(reference program, port program, gallery) — the reference's
    ``compiled`` fixture, compiled by both packages."""
    rng = np.random.default_rng(11)
    gallery = rng.standard_normal((300, 64)).astype(np.float32)
    example_q = rng.standard_normal((32, 64)).astype(np.float32)
    rprog = R.compile_fn(_knn, [example_q, gallery],
                         R.ArchSpec(rows=32, cols=64))
    prog = T.compile_fn(_knn, [example_q, gallery],
                        T.ArchSpec(rows=32, cols=64), device="cpu")
    assert prog.engine_plan is not None
    return rprog, prog, gallery


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _direct(prog, q, gallery):
    """The port plan's own result, as host numpy."""
    v, i = prog.engine_plan.execute(q, gallery)
    return v.numpy(), i.numpy()


def _assert_like_reference(rprog, q, gallery, v, i):
    rv, ri = (np.asarray(x) for x in rprog.engine_plan.execute(q, gallery))
    _assert_eucl_close(q, gallery, rv, ri, v, i)


def _assert_equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _assert_degraded(q, gallery, got, want):
    """A degraded level's eucl result against the primary's direct one
    (see the module note)."""
    _assert_eucl_close(q, gallery, want[0], want[1], got[0], got[1])


def _same_version(got, want) -> bool:
    """A served response computed on the gallery version of ``want``."""
    return all(np.array_equal(g, w) for g, w in zip(got, want))


def test_search_matches_plan_directly(compiled, rng):
    rprog, prog, gallery = compiled
    q = rng.standard_normal((7, 64)).astype(np.float32)
    with CamSearchServer(prog, gallery) as srv:
        v, i = srv.search(q, timeout=WAIT)
    assert isinstance(v, np.ndarray) and isinstance(i, np.ndarray)
    _assert_equal((v, i), _direct(prog, q, gallery))
    _assert_like_reference(rprog, q, gallery, v, i)
    with RServer(rprog, gallery) as rsrv:
        rv, ri = rsrv.search(q, timeout=WAIT)
    _assert_eucl_close(q, gallery, rv, ri, v, i)


def test_concurrent_clients_coalesce_and_scatter(compiled, rng):
    """Many small concurrent requests share micro-batches, and every
    client gets exactly its own rows back."""
    rprog, prog, gallery = compiled
    n_clients, reps = 6, 5
    queries = {c: [rng.standard_normal((1 + c % 3, 64)).astype(np.float32)
                   for _ in range(reps)] for c in range(n_clients)}
    results = {c: [] for c in range(n_clients)}
    errs = []

    with CamSearchServer(prog, gallery, max_wait_ms=5.0) as srv:
        def client(c):
            try:
                for q in queries[c]:
                    results[c].append(srv.search(q, timeout=WAIT))
            except Exception as e:             # noqa: BLE001
                errs.append(e)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
            assert not t.is_alive()
        snap = srv.snapshot()

    assert not errs, errs[:1]
    for c in range(n_clients):
        for q, (v, i) in zip(queries[c], results[c]):
            _assert_equal((v, i), _direct(prog, q, gallery))
            _assert_like_reference(rprog, q, gallery, v, i)
    total_rows = sum(q.shape[0] for qs in queries.values() for q in qs)
    assert snap["queries"] == total_rows
    assert snap["requests"] == n_clients * reps
    # coalescing must have packed multiple requests per launched batch
    assert snap["batches"] < snap["requests"]
    assert snap["avg_batch_fill"] > 1.0
    assert snap["p50_ms"] > 0
    assert snap["dispatch_p50_ms"] > 0
    assert snap["plan"]["device"] == "cpu"


def test_oversized_request_spans_chunks(compiled, rng):
    """A request bigger than the plan micro-batch still comes back whole
    (plan-side chunking is invisible to the client)."""
    rprog, prog, gallery = compiled
    plan = prog.engine_plan
    q = rng.standard_normal((plan.batch * 2 + 3, 64)).astype(np.float32)
    with CamSearchServer(prog, gallery) as srv:
        v, i = srv.search(q, timeout=WAIT)
    assert v.shape == (q.shape[0], 4) and i.shape == (q.shape[0], 4)
    _assert_equal((v, i), _direct(prog, q, gallery))
    _assert_like_reference(rprog, q, gallery, v, i)


def test_submit_returns_waitable_future(compiled, rng):
    _, prog, gallery = compiled
    q = rng.standard_normal((3, 64)).astype(np.float32)
    with CamSearchServer(prog, gallery) as srv:
        reqs = [srv.submit(q) for _ in range(4)]
        for r in reqs:
            res = r.wait(timeout=WAIT)
            assert res.error is None
            assert res.values.shape == (3, 4)
            assert res.latency_s >= 0


def test_bad_request_rejected_at_submit(compiled, rng):
    """Malformed blocks fail synchronously in submit() — they must never
    reach a batch where they would poison coalesced innocent requests."""
    _, prog, gallery = compiled
    with CamSearchServer(prog, gallery) as srv:
        with pytest.raises(ValueError):
            srv.submit(rng.standard_normal((2, 2, 64)))  # 3-D: rejected
        with pytest.raises(ValueError):
            srv.submit(np.ones((2, 17), np.float32))     # wrong feature dim
        with pytest.raises(ValueError):
            srv.submit(torch.ones((0, 64)))              # empty block
        # the server stays healthy for well-formed traffic
        q = rng.standard_normal((2, 64)).astype(np.float32)
        v, i = srv.search(q, timeout=WAIT)
        assert v.shape == (2, 4)
        assert srv.snapshot()["errors"] == 0


def test_runtime_error_fans_out_to_batch_only(compiled, rng):
    """Execution failures surface through SearchResult.error and leave
    the batcher/completer alive for later traffic."""
    _, prog, gallery = compiled
    srv = CamSearchServer(prog, gallery)
    srv.gallery = np.ones((3,), np.float32)   # sabotage: execution raises
    with srv:
        req = srv.submit(rng.standard_normal((2, 64)).astype(np.float32))
        res = req.wait(timeout=WAIT)
        assert res.error is not None
        assert srv.snapshot()["errors"] >= 1
        srv.gallery = torch.from_numpy(gallery)
        v, _ = srv.search(rng.standard_normal((2, 64)).astype(np.float32),
                          timeout=WAIT)
        assert v.shape == (2, 4)


def test_server_accepts_bare_search_plan(rng):
    """The server works over a bare SearchPlan (not just a compiled
    program), and results stay row-aligned when the coalesced batch
    happens to match the plan's traced query count exactly."""
    m, n, dim, k = 6, 40, 64, 4          # coalesced rows will equal m
    plan = T.get_plan(sim_module(T, tcd, "eucl", k, False, m, n, dim,
                                 T.ArchSpec(rows=16, cols=32)), device="cpu")
    rplan = R.get_plan(sim_module(R, rcd, "eucl", k, False, m, n, dim,
                                  R.ArchSpec(rows=16, cols=32)))
    q = rng.standard_normal((m, dim)).astype(np.float32)
    p = rng.standard_normal((n, dim)).astype(np.float32)
    want_v, want_i = (x.numpy() for x in plan.execute(q, p))

    outs = {}
    with CamSearchServer(plan, p, max_wait_ms=50.0) as srv:
        def client(c):   # 3 clients x 2 rows coalesce to exactly m=6 rows
            outs[c] = srv.search(q[2 * c:2 * c + 2], timeout=WAIT)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
            assert not t.is_alive()

    got_i = np.concatenate([outs[c][1] for c in range(3)])
    got_v = np.concatenate([outs[c][0] for c in range(3)])
    assert got_i.shape == (m, k)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_v, want_v)
    rv, ri = (np.asarray(x) for x in rplan.execute(q, p))
    _assert_eucl_close(q, p, rv, ri, got_v, got_i)


def test_stop_drains_pending_requests(compiled, rng):
    _, prog, gallery = compiled
    srv = CamSearchServer(prog, gallery).start()
    q = rng.standard_normal((2, 64)).astype(np.float32)
    srv.search(q, timeout=WAIT)
    srv.stop()
    with pytest.raises(RuntimeError):
        srv.submit(q)
    # restartable
    srv2 = CamSearchServer(prog, gallery).start()
    try:
        v, _ = srv2.search(q, timeout=WAIT)
        assert v.shape == (2, 4)
    finally:
        srv2.stop()


def test_server_requires_similarity_program():
    prog = T.compile_fn(lambda a, b: a.add(b), [(8, 8), (8, 8)],
                        T.ArchSpec(rows=16, cols=16), device="cpu")
    with pytest.raises(ValueError):
        CamSearchServer(prog, np.ones((8, 8), np.float32))
    with pytest.raises(TypeError):
        CamSearchServer(object(), np.ones((8, 8), np.float32))


def test_linger_launches_partial_batches(compiled, rng):
    """A lone request must not wait for a full batch — the max_wait
    linger bounds its latency."""
    _, prog, gallery = compiled
    q = rng.standard_normal((1, 64)).astype(np.float32)
    with CamSearchServer(prog, gallery, max_wait_ms=1.0) as srv:
        t0 = time.perf_counter()
        srv.search(q, timeout=WAIT)
        assert time.perf_counter() - t0 < 30   # bounded, not starved
        assert srv.snapshot()["batches"] >= 1


# ---------------------------------------------------------------------------
# failure paths: shutdown with in-flight traffic, double shutdown,
# update_gallery racing concurrent searches
# ---------------------------------------------------------------------------


def test_stop_with_inflight_requests_completes_every_future(compiled, rng):
    """Shutdown under live traffic: every outstanding future completes
    (result or 'server stopped' error — never a hang), worker threads
    join, and both server threads are gone afterwards."""
    _, prog, gallery = compiled
    srv = CamSearchServer(prog, gallery, max_wait_ms=1.0).start()
    q = rng.standard_normal((2, 64)).astype(np.float32)
    outcomes = []

    def client():
        try:
            while True:
                v, _ = srv.search(q, timeout=WAIT)
                outcomes.append(("ok", v.shape))
        except RuntimeError as e:          # stopped mid-traffic
            outcomes.append(("stopped", str(e)))
        except Exception as e:             # noqa: BLE001
            outcomes.append(("unexpected", e))

    threads = [threading.Thread(target=client) for _ in range(6)]
    for t in threads:
        t.start()
    deadline = time.perf_counter() + 30
    while not any(o[0] == "ok" for o in outcomes):
        assert time.perf_counter() < deadline, "no traffic before stop"
        time.sleep(0.001)
    srv.stop()                             # front door closes mid-flight
    for t in threads:
        t.join(timeout=WAIT)
        assert not t.is_alive(), "client deadlocked across shutdown"
    assert srv._thread is None and srv._completer is None
    assert all(kind in ("ok", "stopped") for kind, _ in outcomes), outcomes
    assert sum(1 for kind, _ in outcomes if kind == "stopped") == 6


def test_double_stop_is_idempotent(compiled, rng):
    _, prog, gallery = compiled
    srv = CamSearchServer(prog, gallery)
    srv.stop()                             # stop before start: no-op
    srv.start()
    srv.search(rng.standard_normal((1, 64)).astype(np.float32), timeout=WAIT)
    srv.stop()
    srv.stop()                             # second stop: no-op, no error
    assert srv._thread is None and srv._completer is None
    with pytest.raises(RuntimeError):
        srv.submit(np.zeros((1, 64), np.float32))


@pytest.mark.parametrize("donate", [False, True])
def test_update_gallery_racing_searches_stays_consistent(compiled, rng,
                                                         donate):
    """Concurrent searches racing update_gallery under the writer-
    priority lock: every response must match ONE gallery version
    exactly — a batch must never see a half-applied update, in place
    (``donate=True``) or not."""
    _, prog, gallery = compiled
    n, dim = gallery.shape
    g_a = gallery
    g_b = np.ascontiguousarray(gallery[::-1])   # distinguishable version
    q = rng.standard_normal((3, dim)).astype(np.float32)
    want_a, want_b = _direct(prog, q, g_a), _direct(prog, q, g_b)
    assert not np.array_equal(want_a[1], want_b[1])   # distinguishable

    results, errs = [], []
    stop = threading.Event()

    def searcher():
        try:
            while not stop.is_set():
                results.append(srv.search(q, timeout=WAIT))
        except Exception as e:                  # noqa: BLE001
            errs.append(e)

    with CamSearchServer(prog, gallery, max_wait_ms=0.5) as srv:
        threads = [threading.Thread(target=searcher) for _ in range(4)]
        for t in threads:
            t.start()
        rows = np.arange(n)
        for flip in range(40):                  # hammer full-gallery swaps
            srv.update_gallery(rows, g_b if flip % 2 == 0 else g_a,
                               donate=donate)
        stop.set()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        snap = srv.snapshot()
    assert not errs, errs[:1]
    assert snap["gallery_updates"] == 40
    assert results, "no searches completed during the race"
    for got in results:
        assert _same_version(got, want_a) or _same_version(got, want_b), \
            "response matches neither gallery version (torn update)"


def test_update_gallery_validates_synchronously(compiled, rng):
    _, prog, gallery = compiled
    n, dim = gallery.shape
    with CamSearchServer(prog, gallery) as srv:
        with pytest.raises(ValueError):
            srv.update_gallery([n], rng.standard_normal(
                (1, dim)).astype(np.float32))          # out of range
        with pytest.raises(ValueError):
            srv.update_gallery([0], rng.standard_normal(
                (2, dim)).astype(np.float32))          # row-count mismatch
        # server stays healthy for good traffic and good updates
        srv.update_gallery([0, 1], rng.standard_normal(
            (2, dim)).astype(np.float32))
        v, _ = srv.search(rng.standard_normal((2, dim)).astype(np.float32),
                          timeout=WAIT)
        assert v.shape == (2, 4)
        assert srv.snapshot()["gallery_updates"] == 1


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_update_gallery_interval_range_server(backend, rng):
    """Range-plan servers mutate (lo, hi) rows as a pair, and the served
    matches equal the reference's."""
    m, n, dim = 4, 30, 32
    plan = T.get_plan(range_module(T, tcd, m, n, dim, interval=True,
                                   arch=T.ArchSpec(rows=8, cols=16)),
                      backend=backend, device="cpu")
    rplan = R.get_plan(range_module(R, rcd, m, n, dim, interval=True,
                                    arch=R.ArchSpec(rows=8, cols=16)))
    q, lo, hi = _interval_data(rng, m, n, dim)
    lo2, hi2 = lo.copy(), hi.copy()
    lo2[[0, n - 1]] -= 10.0
    hi2[[0, n - 1]] += 10.0
    with CamSearchServer(plan, (lo, hi), max_wait_ms=1.0) as srv:
        before = srv.match(q, timeout=WAIT)
        with pytest.raises(ValueError, match="lo_rows"):
            srv.update_gallery([0], lo[:1])    # must be a (lo, hi) pair
        srv.update_gallery([0, n - 1], (lo2[[0, n - 1]], hi2[[0, n - 1]]))
        after = srv.match(q, timeout=WAIT)
    assert before.shape == after.shape == (m, n)
    assert before.dtype == np.bool_
    # widened intervals can only add matches on the touched rows
    assert (after[:, [0, n - 1]] >= before[:, [0, n - 1]]).all()
    untouched = [c for c in range(n) if c not in (0, n - 1)]
    np.testing.assert_array_equal(after[:, untouched], before[:, untouched])
    np.testing.assert_array_equal(before, np.asarray(rplan.execute(q, lo,
                                                                   hi)))
    np.testing.assert_array_equal(after, np.asarray(rplan.execute(q, lo2,
                                                                  hi2)))


# ---------------------------------------------------------------------------
# resilience: deadlines, retries, circuit breaker, degraded mode,
# fault models, and shutdown with a wedged completion pipeline
# ---------------------------------------------------------------------------


def test_deadline_miss_is_timeout_not_batch_failure(compiled, rng):
    """An expired deadline costs that request a TimeoutError; requests
    coalesced alongside it still complete."""
    _, prog, gallery = compiled
    with CamSearchServer(prog, gallery, max_wait_ms=20.0) as srv:
        dead = srv.submit(rng.standard_normal((2, 64)).astype(np.float32),
                          deadline_ms=0.001)
        live = srv.submit(rng.standard_normal((2, 64)).astype(np.float32))
        res_d = dead.wait(timeout=WAIT)
        res_l = live.wait(timeout=WAIT)
        snap = srv.health()
    assert isinstance(res_d.error, TimeoutError)
    assert res_l.error is None and res_l.values.shape == (2, 4)
    assert snap["deadline_misses"] >= 1
    assert snap["deadline_miss_rate"] > 0


def test_retry_heals_transient_backend_fault(compiled, rng):
    """A transient dispatch failure is retried on the same level with
    backoff — no degradation, no client-visible error."""
    _, prog, gallery = compiled
    fails = {"primary": 1}

    def injector(level):
        if fails.get(level, 0) > 0:
            fails[level] -= 1
            raise RuntimeError("transient")

    with CamSearchServer(prog, gallery, fault_injector=injector) as srv:
        v, i = srv.search(rng.standard_normal((2, 64)).astype(np.float32),
                          timeout=WAIT)
        h = srv.health()
    assert v.shape == (2, 4)
    assert h["retries"] >= 1
    assert h["degraded_batches"] == 0
    assert h["status"] == "ok"


def test_breaker_trips_degrades_and_recovers(compiled, rng):
    """K consecutive primary failures open the breaker (requests served
    degraded, primary skipped); after the cooldown a probe closes it."""
    rprog, prog, gallery = compiled
    q = rng.standard_normal((2, 64)).astype(np.float32)
    want = _direct(prog, q, gallery)
    fails = {"primary": MAX_RETRIES + 1}   # every attempt of one batch

    def injector(level):
        if fails.get(level, 0) > 0:
            fails[level] -= 1
            raise RuntimeError("injected outage")

    with CamSearchServer(prog, gallery, fault_injector=injector) as srv:
        outs = [srv.search(q, timeout=WAIT) for _ in range(3)]
        mid = srv.health()
        time.sleep(0.25)                   # past the cooldown: probe
        outs.append(srv.search(q, timeout=WAIT))
        after = srv.health()
    for v, i in outs:                      # degraded results stay close
        _assert_degraded(q, gallery, (v, i), want)
        _assert_like_reference(rprog, q, gallery, v, i)
    _assert_equal(outs[-1], want)          # the probe ran the primary
    assert mid["breaker"]["trips"] >= 1
    assert mid["status"] == "degraded"
    assert mid["degraded_batches"] >= 1
    assert after["breaker"]["state"] == "closed"
    assert after["breaker"]["recoveries"] >= 1


def test_interpreter_fallback_serves_when_all_backends_fail(compiled, rng):
    """With every compiled level permanently failing, the IR
    interpreter still serves exact results (last-resort degraded mode)."""
    rprog, prog, gallery = compiled
    q = rng.standard_normal((3, 64)).astype(np.float32)
    want_v, want_i = _direct(prog, q, gallery)

    def injector(level):
        if level != "interpreter":
            raise RuntimeError(f"dead backend {level}")

    with CamSearchServer(prog, gallery, fault_injector=injector) as srv:
        v, i = srv.search(q, timeout=120)
        h = srv.health()
    _assert_degraded(q, gallery, (v, i), (want_v, want_i))
    _assert_like_reference(rprog, q, gallery, v, i)
    assert h["status"] == "degraded"
    assert h["fallback_levels"] == ["torch", "interpreter"]


def test_server_fault_model_matches_plan_execute(compiled, rng):
    """A server-level fault model corrupts exactly like plan.execute
    with the same model (and like the reference's), and health()
    surfaces the realised counts."""
    from repro.faults import FaultModel as RFaultModel

    rprog, prog, gallery = compiled
    plan = prog.engine_plan
    q = rng.standard_normal((2, 64)).astype(np.float32)
    fm = FaultModel(seed=5, p_stuck=0.01, sigma=0.02)
    with CamSearchServer(prog, gallery, fault_model=fm) as srv:
        v, i = srv.search(q, timeout=WAIT)
        h = srv.health()
    want_v, want_i = plan.execute(q, gallery, faults=fm)
    np.testing.assert_array_equal(i, want_i.numpy())
    np.testing.assert_array_equal(v, want_v.numpy())    # one request
    rv, ri = rprog.engine_plan.execute(
        q, gallery, faults=RFaultModel(seed=5, p_stuck=0.01, sigma=0.02))
    _assert_eucl_close(q, gallery, np.asarray(rv), np.asarray(ri), v, i)
    counts = h["fault_model"]["cells"]
    assert counts["stuck0"] + counts["stuck1"] > 0


def test_server_rejects_garbage_fault_model(compiled):
    _, prog, gallery = compiled
    with pytest.raises(TypeError):
        CamSearchServer(prog, gallery, fault_model="p=0.1")


def test_null_fault_model_is_clean(compiled, rng):
    _, prog, gallery = compiled
    q = rng.standard_normal((2, 64)).astype(np.float32)
    with CamSearchServer(prog, gallery, fault_model=FaultModel()) as srv:
        v, i = srv.search(q, timeout=WAIT)
        h = srv.health()
    _assert_equal((v, i), _direct(prog, q, gallery))  # one request
    assert "fault_model" not in h          # normalised away


def test_stop_does_not_hang_with_dead_completer_and_full_queue(
        compiled, rng):
    """Shutdown regression: completer dead, completion queue full
    (bounded, max_inflight=1), batcher wedged mid-hand-off, and an
    update_gallery writer pending — stop() must return promptly and
    every outstanding future must resolve with an error."""
    _, prog, gallery = compiled
    n, dim = gallery.shape
    srv = CamSearchServer(prog, gallery, max_inflight=1,
                          max_wait_ms=1.0).start()
    # kill the completion thread out from under the server
    srv._completions.put(None)
    deadline = time.perf_counter() + 10
    while srv._completer_alive and time.perf_counter() < deadline:
        time.sleep(0.001)
    assert not srv._completer_alive

    q = rng.standard_normal((2, dim)).astype(np.float32)
    reqs = [srv.submit(q) for _ in range(4)]   # wedge the hand-off

    upd_err = []

    def writer():                              # pending gallery update
        try:
            srv.update_gallery([0], rng.standard_normal(
                (1, dim)).astype(np.float32))
        except Exception as e:                 # noqa: BLE001
            upd_err.append(e)

    w = threading.Thread(target=writer)
    w.start()
    time.sleep(0.2)                            # let everything wedge

    t0 = time.perf_counter()
    srv.stop()
    assert time.perf_counter() - t0 < 10, "stop() hung"
    w.join(timeout=10)
    assert not w.is_alive(), "update_gallery writer deadlocked"
    for r in reqs:
        res = r.wait(timeout=10)
        assert res.error is not None           # failed, never stranded
    assert srv._thread is None and srv._completer is None


# -- the port's own: fallback chain, finalize rescue, tensor queries ----------


def _hamming_plan(backend, pack, m=6, n=70, dim=48, k=5, care=False):
    return T.get_plan(sim_module(T, tcd, "hamming", k, False, m, n, dim,
                                 T.ArchSpec(rows=16, cols=32), care=care),
                      backend=backend, pack=pack, device="cpu")


@pytest.mark.parametrize("backend,pack,levels", [
    ("cuda", True, ["torch", "torch-unpacked", "interpreter"]),
    ("cuda", False, ["torch", "interpreter"]),
    ("torch", True, ["torch-unpacked", "interpreter"]),
])
def test_fallback_chain_serves_exact_results_at_every_level(
        backend, pack, levels, rng):
    """The degraded chain below the primary (``"cuda"`` → ``"torch"`` →
    ``"torch"`` unpacked → interpreter) serves hamming bit-identically at
    every level, and each degraded batch is counted."""
    plan = _hamming_plan(backend, pack)
    q = (rng.random((6, 48)) > 0.5).astype(np.float32)
    p = (rng.random((70, 48)) > 0.5).astype(np.float32)
    want = tuple(x.numpy() for x in plan.execute(q, p))
    chain = ["primary"] + levels
    for serve_at in range(len(chain)):
        dead = set(chain[:serve_at])

        def injector(level, dead=dead):
            if level in dead:
                raise RuntimeError(f"dead backend {level}")

        with CamSearchServer(plan, p, fault_injector=injector) as srv:
            got = srv.search(q, timeout=WAIT)
            h = srv.health()
        _assert_equal(got, want)
        assert h["fallback_levels"] == levels
        assert h["degraded_batches"] == (1 if serve_at else 0)
        assert h["backend_errors"] == (MAX_RETRIES + 1) * serve_at


def test_finalize_failure_is_rescued_by_the_next_level(rng):
    """A primary that fails when its result is read (where a failing
    kernel launch surfaces) is rescued synchronously by the levels below,
    and the rescue is counted: a failure is visible, not hidden."""
    plan = _hamming_plan("cuda", True, n=71)
    q = (rng.random((6, 48)) > 0.5).astype(np.float32)
    p = (rng.random((71, 48)) > 0.5).astype(np.float32)
    want = tuple(x.numpy() for x in plan.execute(q, p))

    def broken(pending):
        raise RuntimeError("kernel launch failed")

    plan.finalize = broken
    try:
        with CamSearchServer(plan, p) as srv:
            got = srv.search(q, timeout=WAIT)
            h = srv.health()
    finally:
        del plan.finalize
    _assert_equal(got, want)
    assert h["backend_errors"] == 1 and h["degraded_batches"] == 1
    assert h["breaker"]["consecutive_failures"] == 1
    assert h["status"] == "degraded"


def test_tensor_queries_and_ternary_care_mask(rng):
    """Query blocks may be tensors; a ternary plan serves with its care
    mask; results equal the plan's and the reference's."""
    m, n, dim, k = 6, 70, 48, 5
    plan = _hamming_plan("cuda", True, care=True)
    rplan = R.get_plan(sim_module(R, rcd, "hamming", k, False, m, n, dim,
                                  R.ArchSpec(rows=16, cols=32), care=True))
    q = (rng.random((9, dim)) > 0.5).astype(np.float32)
    p = (rng.random((n, dim)) > 0.5).astype(np.float32)
    care = (rng.random((n, dim)) > 0.2).astype(np.float32)
    want = tuple(x.numpy() for x in plan.execute(q, p, care))
    with pytest.raises(ValueError, match="care_mask"):
        CamSearchServer(plan, p)
    with CamSearchServer(plan, p, care_mask=care) as srv:
        a = srv.submit(torch.from_numpy(q[:4]))
        b = srv.submit(q[4:])
        got = [r.wait(timeout=WAIT) for r in (a, b)]
        assert srv.snapshot()["plan"]["ternary"]
    assert all(r.error is None for r in got)
    _assert_equal((np.concatenate([r.values for r in got]),
                   np.concatenate([r.indices for r in got])), want)
    _assert_equal(want, tuple(np.asarray(x)
                              for x in rplan.execute(q, p, care)))


def test_update_after_dispatch_leaves_the_batch_on_the_old_gallery(
        compiled, rng):
    """A batch dispatched before an in-place ``update_gallery(donate=True)``
    returns the old gallery's rows; later batches see the new ones."""
    _, prog, gallery = compiled
    q = rng.standard_normal((3, 64)).astype(np.float32)
    new = np.ascontiguousarray(gallery[::-1])
    want_old, want_new = _direct(prog, q, gallery), _direct(prog, q, new)
    gate = threading.Event()
    with CamSearchServer(prog, gallery.copy()) as srv:
        complete = srv._complete_one

        def held(item):
            assert gate.wait(WAIT)
            complete(item)

        srv._complete_one = held
        req = srv.submit(q)
        deadline = time.perf_counter() + WAIT
        while srv.stats["batches"] < 1:
            assert time.perf_counter() < deadline
            time.sleep(0.001)
        srv.update_gallery(np.arange(gallery.shape[0]), new, donate=True)
        gate.set()
        res = req.wait(timeout=WAIT)
        later = srv.search(q, timeout=WAIT)
    _assert_equal((res.values, res.indices), want_old)  # one request each
    _assert_equal(later, want_new)


# -- twins of the serving tests in tests/test_packed.py, test_range.py and
# -- test_env.py -------------------------------------------------------------


def test_server_serves_ternary_with_care_mask(rng):
    m, n, dim, k = 6, 37, 100, 5
    plan = T.get_plan(sim_module(T, tcd, "hamming", k, False, m, n, dim,
                                 T.ArchSpec(rows=16, cols=32), care=True),
                      device="cpu")
    q = (rng.random((m, dim)) > 0.5).astype(np.float32)
    p = (rng.random((n, dim)) > 0.5).astype(np.float32)
    care = (rng.random((n, dim)) > 0.3).astype(np.float32)
    want_v, want_i = plan.execute(q, p, care)
    with CamSearchServer(plan, p, care_mask=care, max_wait_ms=1.0) as srv:
        v, i = srv.search(q, timeout=WAIT)
        snap = srv.snapshot()
    np.testing.assert_array_equal(v, want_v.numpy().reshape(m, k))
    np.testing.assert_array_equal(i, want_i.numpy().reshape(m, k))
    assert snap["plan"]["ternary"] and snap["plan"]["packed"]


def test_server_care_mask_validation(rng):
    arch = T.ArchSpec(rows=16, cols=32)
    tplan = T.get_plan(sim_module(T, tcd, "hamming", 3, False, 4, 20, 64,
                                  arch, care=True), device="cpu")
    p = (rng.random((20, 64)) > 0.5).astype(np.float32)
    care = (rng.random((20, 64)) > 0.3).astype(np.float32)
    with pytest.raises(ValueError):             # ternary plan, no mask
        CamSearchServer(tplan, p)
    with pytest.raises(ValueError):             # wrong mask geometry
        CamSearchServer(tplan, p, care_mask=care[:-1])
    bplan = T.get_plan(sim_module(T, tcd, "dot", 2, False, 4, 20, 32, arch),
                       device="cpu")
    with pytest.raises(ValueError):             # mask on a binary plan
        CamSearchServer(bplan, p[:, :32], care_mask=np.ones((20, 32)))


def test_range_plan_served(rng):
    """A range plan served: concurrent clients get the matches the plan
    computes directly (and the reference's); search() refuses."""
    m, n, dim = 16, 48, 64
    plan = T.get_plan(range_module(T, tcd, m, n, dim, interval=True,
                                   arch=T.ArchSpec(rows=16, cols=32)),
                      device="cpu")
    rplan = R.get_plan(range_module(R, rcd, m, n, dim, interval=True,
                                    arch=R.ArchSpec(rows=16, cols=32)))
    q, lo, hi = _interval_data(rng, 64, n, dim)
    direct = plan.execute(q, lo, hi).numpy()
    got = {}
    with CamSearchServer(plan, (lo, hi), max_wait_ms=1.0) as srv:
        with pytest.raises(TypeError):
            srv.search(q[:2])
        parts = np.array_split(np.arange(64), 4)

        def client(c):
            got[c] = srv.match(q[parts[c]], timeout=WAIT)

        ts = [threading.Thread(target=client, args=(c,)) for c in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=WAIT)
            assert not t.is_alive()
        snap = srv.snapshot()
    served = np.concatenate([got[c] for c in range(4)])
    np.testing.assert_array_equal(served, direct)
    np.testing.assert_array_equal(served, np.asarray(rplan.execute(q, lo,
                                                                   hi)))
    assert snap["plan"]["family"] == "range"
    assert snap["plan"]["mode"] == "interval"
    # geometry validation up front
    with pytest.raises(ValueError):
        CamSearchServer(plan, (lo[:, :-1], hi[:, :-1]))
    with pytest.raises(ValueError):
        CamSearchServer(plan, lo)          # interval plan needs (lo, hi)


def test_serve_deadline_garbage_fails_at_construction(monkeypatch, rng):
    plan = T.get_plan(sim_module(T, tcd, "dot", 2, True, 4, 16, 16,
                                 T.ArchSpec(rows=8, cols=16)), device="cpu")
    p = np.where(rng.random((16, 16)) < 0.5, -1.0, 1.0).astype(np.float32)
    monkeypatch.setenv("REPRO_SERVE_DEADLINE_MS", "soon")
    with pytest.raises(ValueError, match="REPRO_SERVE_DEADLINE_MS"):
        CamSearchServer(plan, p)


# -- twins of tests/test_trace.py's served-workload tests --------------------


@pytest.fixture()
def clean_tracer():
    """The port's tracer off and empty before and after; capacity
    restored."""
    from repro_torch import obs
    cap, clock = obs.tracer.capacity, obs.tracer.clock
    obs.stop()
    obs.tracer.clear()
    yield obs.tracer
    obs.stop()
    obs.tracer.clear()
    obs.enable(cap, clock)
    obs.stop()


def test_concurrent_serving_emits_followable_spans(compiled, clean_tracer,
                                                   rng, tmp_path):
    """Batcher/completer spans nest correctly under concurrency and every
    request's queue-wait + service windows land on its own submitter
    thread track."""
    import json

    from repro_torch import obs
    from test_trace import _assert_valid_chrome, _events
    _, prog, gallery = compiled
    obs.enable()
    with CamSearchServer(prog, gallery, max_wait_ms=2.0) as srv:
        errs = []

        def client(c):
            try:
                for _ in range(3):
                    q = rng.standard_normal((2, 64)).astype(np.float32)
                    srv.search(q, timeout=WAIT)
            except Exception as e:      # noqa: BLE001
                errs.append(e)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
            assert not t.is_alive()
        assert not errs, errs[:1]
        path = srv.dump_trace(str(tmp_path / "serve.json"))
    obs.stop()
    with open(path) as f:
        doc = json.load(f)
    _assert_valid_chrome(doc)
    assert _events(doc, ph="X", pid="serving", name="batch.fill")
    for span in ("batch.dispatch", "batch.finalize"):
        assert _events(doc, ph="B", pid="serving", name=span)
    assert _events(doc, ph="B", pid="engine", name="plan.dispatch")
    reqs = _events(doc, ph="X", pid="serving", name="request")
    waits = _events(doc, ph="X", pid="serving", name="request.queue_wait")
    servs = _events(doc, ph="X", pid="serving", name="request.service")
    assert len(reqs) == 12 and len(waits) == 12 and len(servs) == 12
    assert len({e["tid"] for e in reqs}) == 4
    for r in reqs:
        rid = r["args"]["rid"]
        w = [e for e in waits if e["tid"] == r["tid"]
             and r["ts"] <= e["ts"] <= r["ts"] + r["dur"]]
        assert w, f"request {rid} has no queue-wait inside its span"


def test_queue_wait_vs_service_split_in_snapshot(compiled, rng):
    _, prog, gallery = compiled
    with CamSearchServer(prog, gallery) as srv:
        q = rng.standard_normal((4, 64)).astype(np.float32)
        for _ in range(3):
            srv.search(q, timeout=WAIT)
        snap = srv.snapshot()
        health = srv.health()
    for key in ("queue_wait_p50_ms", "queue_wait_p95_ms",
                "service_p50_ms", "service_p95_ms"):
        assert key in snap
        assert key in health["latency"]
    assert snap["service_p50_ms"] > 0
    # each component is pointwise <= the end-to-end latency, so its p50
    # cannot exceed the blended p50
    assert snap["queue_wait_p50_ms"] <= snap["p50_ms"] + 1e-9
    assert snap["service_p50_ms"] <= snap["p50_ms"] + 1e-9


# -- stats consistency (the snapshot/health atomicity regression) -----------

class TestStatsConsistency:
    """``snapshot()``/``health()`` must read a *consistent* view: every
    related counter group lands atomically, so no reader can observe a
    half-applied update."""

    def test_serverstats_multi_key_bump_is_atomic(self):
        stats = ServerStats("a", "b", window=64)
        stop = threading.Event()
        torn = []

        def writer():
            while not stop.is_set():
                stats.bump(a=1, b=2)       # invariant: b == 2a, always

        def reader():
            while not stop.is_set():
                c, _ = stats.view()
                if c["b"] != 2 * c["a"]:
                    torn.append(dict(c))
                    return

        writers = [threading.Thread(target=writer) for _ in range(4)]
        readers = [threading.Thread(target=reader) for _ in range(2)]
        for t in writers + readers:
            t.start()
        time.sleep(0.4)
        stop.set()
        for t in writers + readers:
            t.join(10)
            assert not t.is_alive()
        assert not torn, f"torn read observed: {torn[:3]}"
        c, lat = stats.view()
        assert c["b"] == 2 * c["a"] and c["a"] > 0

    def test_serverstats_rejects_unknown_counter(self):
        stats = ServerStats("a")
        with pytest.raises(KeyError, match="typo"):
            stats.bump(typo=1)
        assert stats.view()[0] == {"a": 0}

    def test_live_snapshot_invariants_under_concurrency(self, compiled,
                                                        rng):
        """Hammer a live server from worker threads while snapshotting:
        every snapshot must satisfy the cross-counter invariants (a
        request is never visible without its rows, the latency window
        never exceeds delivered requests)."""
        _, prog, gallery = compiled
        q = rng.standard_normal((3, 64)).astype(np.float32)
        violations = []
        stop = threading.Event()

        with CamSearchServer(prog, gallery, max_wait_ms=0.5) as srv:
            def client():
                while not stop.is_set():
                    srv.search(q, timeout=WAIT)

            def observer():
                while not stop.is_set():
                    counts, lat = srv._stats.view()
                    snap = srv.snapshot()
                    for src in (counts, snap):
                        if src["queries"] != 3 * src["requests"]:
                            violations.append(
                                ("rows", src["requests"], src["queries"]))
                    if len(lat) > counts["requests"]:
                        violations.append(
                            ("latency", len(lat), counts["requests"]))
                    if counts["batched_rows"] < \
                            counts["queries"] - 3 * 64:
                        # batched rows may run AHEAD of delivered
                        # queries, never meaningfully behind
                        violations.append(
                            ("batch", counts["batched_rows"],
                             counts["queries"]))

            clients = [threading.Thread(target=client) for _ in range(4)]
            obs = [threading.Thread(target=observer) for _ in range(2)]
            for t in clients + obs:
                t.start()
            time.sleep(0.8)
            stop.set()
            for t in clients + obs:
                t.join(10)
                assert not t.is_alive()
            final = srv.stats
        assert not violations, violations[:5]
        assert final["requests"] > 0
        assert final["queries"] == 3 * final["requests"]
