#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Drives the port's main path — ``compile_fn``/``compile_module`` ->
``get_plan`` -> ``SearchPlan.execute`` with the default device (the GPU)
and backend (``"cuda"``) — on the paper's two workloads at full size:

* ``knn_eucl``       — KNN, Euclidean top-5, 180,000 x 1024 gallery
                       (float32, 737 MB on the card), 624 queries:
                       kernel ``fused_topk`` on its "wgmma" route (3xTF32
                       tensor cores; each eucl index swap against the
                       plain version is replayed in the kernel's
                       arithmetic), timed at the 624 rows the path gives
                       it and at the 1024-row padded shape of earlier
                       runs;
* ``hamming_packed`` — hamming top-10 on the same gallery binarised
                       ``> 0``: kernel ``fused_topk_packed``;
* ``tcam_ternary``   — the same with a 10 % wildcard care mask:
                       kernel ``fused_topk_packed`` (ternary);
* ``hdc_quickstart`` — HDC associative-memory recall, dot top-1 over
                       10 x 8192 class hypervectors, 64 queries
                       (auto-packed): kernel ``fused_topk_packed``;
* ``forest_acam``    — decision-forest inference through
                       ``CamForestClassifier.predict``: 512 random trees
                       of depth 8 over 64 features (131,072 aCAM interval
                       rows), 1024 queries: kernel ``acam_match`` (no
                       compares: sign bits of FP32 differences), bound on
                       its issue slots (``acam_issue_slots``);
* ``range_threshold`` — TH-mode range search (``RangePlan``) on the KNN
                       gallery: eucl with tau the median 5th-nearest
                       squared distance, and hamming on float cells
                       (``pack=None`` on the cuda backend) with tau the
                       median 10th-nearest distance: kernel
                       ``range_match`` (3xTF32 tensor cores; each eucl
                       disagreement with the plain version is also
                       replayed in the kernel's arithmetic), on the 624
                       rows the path gives it and on the 1024-row padded
                       shape of earlier runs;
* ``hdc_mnist``      — the paper's HDC/MNIST-8k through ``HdcClassifier``:
                       60,000 training and 10,000 test samples of 784
                       features encoded to 8192 dims (kernel
                       ``hdc_encode``, bit-sliced, on the item memory's
                       bit planes), one-shot fit, packed
                       classification (``fused_topk_packed``) and three
                       retraining epochs whose touched class rows go
                       through ``SearchPlan.update_rows``;
* ``gallery_update`` — ``update_rows`` on the KNN gallery: 1 % of its rows
                       (18 runs of 100) replaced, ``donate=False`` and
                       ``donate=True``, on the eucl plan (``fused_topk``)
                       and the packed hamming plan (``fused_topk_packed``),
                       each result bit-identical to a fresh plan's;
* ``distance_ops``   — the public distance API (``ops.cam_distances`` /
                       ``cam_exact`` / ``cam_range``) on the KNN data:
                       kernel ``distance`` (3xTF32 tensor cores); eucl
                       held to the tolerance over the whole matrix, and
                       one query row plus the ``REPLAY_FURTHEST`` entries
                       furthest from the plain version equal bit for bit
                       to the replay of the kernel's own arithmetic
                       (``cam_search.tf32x3_kernel_eucl``);
* ``tune``           — the plan autotuner (``repro_torch.tune``) on the
                       ``"cuda"`` backend with its default trials and
                       reps, against a fresh temporary plan store:
                       ``knn_eucl``'s and ``hamming_packed``'s programs and
                       ``forest_acam``'s interval range plan, each winner
                       held to its baseline (bit-identical for hamming and
                       the interval match, eucl within the tolerance), and
                       no candidate (each micro-batch, each packing)
                       rejected or refused; a
                       torch-only child process rebuilds the data from the
                       same seeds and warm-starts from the store (no trial,
                       three config hits, no kernel built, bit-identical
                       results); a ``CamSearchServer`` and a gateway tenant
                       built over the heuristic hamming plan serve the
                       stored winner, ``tuned=False`` keeps the heuristic
                       plan;
* ``hier_search``    — the hierarchical two-stage search
                       (``get_hierarchical_plan``, the ``"torch"`` backend:
                       no hand-written kernel on its path): (a) the
                       reference's ``benchmarks/bench_hier.py`` geometry
                       (packed hamming top-10 over a clustered 131,072 x
                       256 gallery, 64 queries, 128 clusters, k-means 4
                       iterations) at nprobe 4, 8, 16 and 128, the last
                       bit-identical to flat B1 and to the flat ``"torch"``
                       plan, recall monotone in nprobe; a 1 % row update
                       with reassignment and an overflow re-layout, each
                       equal to a fresh layout with the same centroids;
                       (c) the nprobe-8 plan served to 8 client threads,
                       equal to the direct call; (b) eucl top-5 at the KNN
                       shape (default clusters, nprobe clusters // 8 and
                       clusters), the latter within the eucl tolerance of
                       flat B2, and two prepares giving bit-identical
                       centroids.  B1 and B2 launch only as the flat
                       oracles;
* ``lm_serve``       — LM serving through ``launch.serve.Server``:
                       qwen2.5-14b at full width and depth in bf16 (random
                       weights from a seed), 4 prompts of 2048 tokens, 32
                       new tokens each, decode batch 2, every attention
                       call on kernel ``flash_attention`` (exactly
                       48 x (4 prefills + 124 decode steps) launches), a
                       second Server giving the same tokens; then the
                       reference's prefill-then-decode contract in float32
                       at full width and depth 4, and B7 against its plain
                       version on the operands of layers 0 and 47 (from
                       an untimed prefill and decode step of the first
                       prompt) and at the ``decode_32k`` cache length
                       (bf16 within 0.05, float32 within 2e-3), each bf16
                       output also held to the Pallas kernel's own
                       recurrence at the route's kv tiles and splits
                       (``flash_attention_recurrence``; scaled to the
                       case: at most 0.1 % of the outputs beyond one bf16
                       step), timed beside
                       ``scaled_dot_product_attention``.

For each phase it sets the kernels' launch counts to 0, runs the path,
reads the counts (a kernel of the path with no launch fails the run),
checks the results, then calls the kernel wrapper and its plain PyTorch
version on the operands of the path's first micro-batch and compares
them (bit-identical for the integer metrics and the interval match;
eucl: every candidate value within ``EUCL_RTOL``/``EUCL_ATOL``, and every
candidate and result index swap, or every range-match disagreement,
confirmed as a float64 near-tie), and times kernel, plain version and
one PyTorch library call with CUDA events (medians).  B1's record also
holds its two main-path shapes under ``shapes`` (``knn`` and
``hdc_predict``: route, event and device times, launches, the bound of
the route's basis and the earlier popcount basis).  The last two lines
of standard output are the ``{"kernels": [...]}`` record and
``{"ok": true, "device": ...}``.

It exits non-zero, printing no result, when no CUDA device is present,
when ``src/repro_torch`` is not beside it, or when any phase fails.
Phase names as arguments run only those phases (the kernels line then
holds only the records they made):

    python3 chip_smoke.py [phase ...]
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))

#: eucl tolerance on squared distances of magnitude 2e3..1e4: float32
#: sums of 1024 products in another order differ by ~0.05 at most here
EUCL_RTOL, EUCL_ATOL = 1e-5, 0.1
#: H100 SXM peaks (NVIDIA data sheet, dense): float32 on the CUDA cores,
#: TF32 and int8 on the tensor cores, HBM3
FP32_PEAK_FLOPS = 67e12
TF32_PEAK_FLOPS = 495e12
INT8_PEAK_OPS = 1979e12
HBM_BYTES_PER_S = 3.35e12
#: 32-bit population counts and compares per clock per SM, compute
#: capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
#: throughput table)
POPC_PER_CLOCK_PER_SM = 16
COMPARES_PER_CLOCK_PER_SM = 64
#: warp instructions issued per clock per SM (four schedulers, one each),
#: and threads per warp
ISSUE_PER_CLOCK_PER_SM, WARP = 4, 32
#: the forest_acam workload: random_forest(default_rng(7), **FOREST),
#: FOREST_QUERIES N(0, 1) queries from default_rng(8)
FOREST = dict(n_trees=512, depth=8, dim=64, n_classes=8, feature_frac=0.5)
FOREST_QUERIES = 1024
#: keyword arguments of knn_dataset() (its defaults: 180,000 x 1024)
KNN_DATA = {}
#: rows of each result checked against a plain oracle on the host
FOREST_CHECKED_ROWS = 256
#: distance_ops: eucl entries furthest from the plain version that are
#: replayed in the kernel's arithmetic (beside one query row's all)
REPLAY_FURTHEST = 4096
#: the hdc_mnist workload: hdc_mnist_dataset(**HDC_MNIST), classes, dims,
#: levels and retraining epochs (the paper's HDC/MNIST-8k).  At 28 x 28
#: the dataset's default class overlap (0.55) separates every class (a
#: one-shot test accuracy of 1.0, so retraining pushes no row); 0.8 puts
#: one-shot training mid-range, where retraining moves class rows
HDC_MNIST = dict(n_train=60000, n_test=10000, side=28, overlap=0.8)
HDC_CLASSES, HDC_DIM, HDC_LEVELS, HDC_EPOCHS = 10, 8192, 16, 3
#: test rows checked against the dense (M, F, H) oracle, and its chunk
HDC_DENSE_ROWS, HDC_DENSE_CHUNK = 256, 16
#: rows checked against the IR interpreter (one micro-batch)
HDC_INTERPRETED_ROWS = 1024
#: device memory the phase may add at its peak (2 GB of training
#: encodings plus temporaries)
HDC_PEAK_GB = 6.0
#: gallery_update: UPDATE_RUNS runs of UPDATE_RUN consecutive rows, drawn
#: from default_rng(UPDATE_SEED)
UPDATE_RUNS, UPDATE_RUN, UPDATE_SEED = 18, 100, 13
#: integer multiply-add class instructions per clock per SM (IMAD, and
#: IDP4A: four int8 products summed into an int32), compute capability 9.0
#: (CUDA C++ Programming Guide, arithmetic instruction throughput table)
IMAD_PER_CLOCK_PER_SM = 64
#: int8 products per IDP4A
DP4A_PRODUCTS = 4
#: 32-bit logical operations (LOP3) per clock per SM, compute capability
#: 9.0 (CUDA C++ Programming Guide: 32-bit bitwise AND, OR, XOR)
LOP_PER_CLOCK_PER_SM = 64
#: lm_serve: LM_ARCH (with LM_OVERRIDES, none on the card) served to
#: SERVE_REQUESTS prompts of SERVE_PROMPT tokens, SERVE_NEW new tokens
#: each, decode batch SERVE_BATCH; DECODE_TIMED_STEPS decode steps timed
#: one by one; the float32 prefill-then-decode check at depth CHECK_LAYERS
#: (CHECK_PREFILL prompt tokens, CHECK_DECODE steps); B7's decode against
#: DECODE_32K_ROWS cache rows (launch/specs.py decode_32k), and in float32
#: against at most F32_CUT_ROWS rows
LM_ARCH, LM_OVERRIDES = "qwen2.5-14b", {}
SERVE_REQUESTS, SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 2, 2048, 32
DECODE_TIMED_STEPS = 16
CHECK_LAYERS, CHECK_PREFILL, CHECK_DECODE = 4, 512, 16
DECODE_32K_ROWS, F32_CUT_ROWS = 32768, 4096
#: B7 against its plain version: the reference's flash-test bounds
B7_BF16_ATOL, B7_F32_ATOL = 0.05, 2e-3
#: B7 in bf16 against the Pallas recurrence: the share of outputs more than
#: one bf16 step (2**-7 of |want|) away, and the largest miss in units of
#: max|v| (one bf16 step of a probability; tests/test_torch_cuda.py)
B7_REC_BEYOND, B7_REC_MAX_OF_V = 1e-3, 2.0 ** -8
#: H100 SXM bf16 tensor-core peak, dense (NVIDIA data sheet)
BF16_PEAK_FLOPS = 989e12
#: cam_serve: CAM_CLIENTS client threads, each submitting CAM_REQUESTS
#: requests of CAM_ROWS consecutive query rows one after another
#: (8 x 6 x 13 = the 624 KNN queries); the faulted packed server's model;
#: the hardened search's replicas, fault seeds and probabilities, and the
#: gallery rows it stores: cut from 180,000 to a quarter, because each
#: faulted execute corrupts every stored cell on the host (553 M at full
#: size: 12-14 s a seed on the H100's host, 80 s for the part, against a
#: 30 s budget); the forest update's share
#: of rows and its racing clients (CAM_RACE_ROWS queries each); the
#: healed interval plan's replicas,
#: spares and model; the bound of every wait
CAM_CLIENTS, CAM_REQUESTS, CAM_ROWS = 8, 6, 13
CAM_SERVE_FAULTS = dict(seed=3, p_stuck=1e-3, p_flip=1e-3)
CAM_HARDEN_REPLICAS, CAM_HARDEN_SEEDS = 3, range(4)
CAM_HARDEN_FAULTS = dict(p_stuck=0.02, p_flip=0.01)
CAM_HARDEN_ROWS = 45000
CAM_UPDATE_FRAC, CAM_RACERS, CAM_RACE_ROWS = 0.01, 4, 64
CAM_HEAL_REPLICAS, CAM_HEAL_SPARES = 2, 512
CAM_HEAL_FAULTS = dict(seed=11, p_stuck=1e-5)
CAM_WAIT_S = 600
#: the hier_search phase, (a): benchmarks/bench_hier.py's geometry
#: (_clustered_gallery(default_rng(0), 131072, 256, 128), 64 perturbed
#: gallery rows as queries, ArchSpec(rows=128, cols=128), packed hamming)
HIER_N, HIER_DIM, HIER_CENTERS, HIER_FLIP = 131072, 256, 128, 0.05
HIER_QUERIES, HIER_K, HIER_CLUSTERS, HIER_ITERS = 64, 10, 128, 4
HIER_NPROBES = (4, 8, 16)
HIER_TIMED_CALLS = 5
#: (a)'s row update: 1 % of the rows with reassignment, then rows copied
#: from one row, enough to overflow its cluster's tiles
HIER_UPDATE_FRAC, HIER_OVERFLOW_ROWS = 0.01, 8192
#: (c): the nprobe-8 plan served, 8 client threads x 2 requests x 4 rows
#: = (a)'s 64 queries
HIER_SERVE_NPROBE, HIER_SERVE_REQUESTS, HIER_SERVE_ROWS = 8, 2, 4
#: (b): a call past this many seconds on the KNN data is timed again on
#: the first HIER_EUCL_CUT_ROWS queries (the cut listed under "reduced")
HIER_EUCL_LIMIT_S, HIER_EUCL_CUT_ROWS = 30.0, 64
#: queue_c: C1's top-k on the default backend past the kernels' window
#: (MAX_K = 384): eucl and packed hamming at the KNN shape; C3's B5 cases
#: through ItemMemory.encode, (rows, features, dims, levels, route): a
#: 256 x 256 image (65,536 features, the 32 count planes), 512 levels
#: (the level planes from global memory), 2,100,000 rows (past one grid
#: dimension's 65,535 blocks of 32 rows: 2.15 GB of output) and
#: HDC/MNIST-8k's test set, which keeps the bit-sliced route
QUEUE_C_EUCL_K, QUEUE_C_PACKED_K = 500, 400
#: the served micro-batch (a gateway request's rows) on the matrix route
QUEUE_C_SMALL_ROWS = 13
QUEUE_C_HDC = {"wide_features": (256, 65536, 8192, 16, "wide"),
               "many_levels": (2000, 784, 8192, 512, "global"),
               "many_rows": (2_100_000, 16, 256, 16, "bitsliced"),
               "mnist_shape": (10000, 784, 8192, 16, "bitsliced")}
#: sharded: shards on cuda:0 stand-ins (launch.mesh.forced_devices)
SHARDS = 4
#: gateway_serve: client threads per tenant, requests per client and rows
#: per request (4 x 12 x 13 = the 624 KNN queries); hamming_gold's token
#: bucket (rows a second, burst) and priority; the isolation victim's
#: requests; failover requests per client and the kill's delay; the
#: maintenance sweep; a rejected submit's back-off
GW_CLIENTS, GW_REQUESTS, GW_ROWS = 4, 12, 13
GW_GOLD_RATE, GW_GOLD_BURST, GW_GOLD_PRIORITY = 2000.0, 104, 5
GW_VICTIM_REPS = 60
GW_FAILOVER_REPS, GW_KILL_AFTER_S = 30, 0.05
GW_MAINT_MS, GW_BACKOFF_S = 10.0, 0.002


def log(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi(fields: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else ""


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def cuda_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` over ``reps`` calls (CUDA events),
    after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def host_ms_per_call(fn, n: int) -> float:
    """Mean host time of ``fn`` over ``n`` calls enqueued back to back
    (no synchronise between them): what a call costs the host."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    took = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * took / n


def device_ms_per_call(fn, n: int) -> float:
    """Device time of one call of ``fn``: ``torch.profiler`` over ``n``
    calls, the device time of every kernel they launched over ``n`` (the
    wrapper's host work, which CUDA events around one call include, is
    left out)."""
    import torch
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(r[0] for r in device_rows(prof)) / n


def device_rows(prof):
    """(device ms, name, count) of each device-side event of a
    ``torch.profiler`` run (kernels, copies, sets) that took time."""
    rows = []
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        if dev_us > 0:
            rows.append((dev_us / 1e3, e.key, e.count))
    return rows


def eucl_index_swaps(q, p, got_i, want_i, what: str) -> int:
    """Count the positions where two eucl top-k index tensors differ,
    after confirming each as a float64 near-tie: the squared distances
    of query row ``r`` to both chosen gallery rows agree within
    ``EUCL_ATOL + EUCL_RTOL * |d|``.  Raises on any other swap."""
    rows, cols = (got_i != want_i).nonzero(as_tuple=True)
    for s in range(0, rows.numel(), 1 << 14):
        r, c = rows[s:s + (1 << 14)], cols[s:s + (1 << 14)]
        qr = q[r].double()
        da = ((qr - p[got_i[r, c].long()].double()) ** 2).sum(1)
        db = ((qr - p[want_i[r, c].long()].double()) ** 2).sum(1)
        bad = ((da - db).abs() > EUCL_ATOL + EUCL_RTOL * db.abs()).nonzero()
        if bad.numel():
            j = int(bad[0, 0])
            raise RuntimeError(
                f"{what}: index swap at ({int(r[j])}, {int(c[j])}) is not a "
                f"float64 near-tie: {float(da[j])} vs {float(db[j])}")
    return int(rows.numel())


def hamming_module(T, cd, m, n, dim, k, care):
    """cim program for hamming (optionally TCAM ternary) top-k: the
    traced front end has no hamming pattern, so it enters the pipeline
    at compile_module, the function compile_fn calls after tracing."""
    types = [T.TensorType((m, dim)), T.TensorType((n, dim))]
    if care:
        types.append(T.TensorType((n, dim), "i8"))
    mod = T.Module("hamming_search", types)
    a = mod.arguments
    b = T.Builder(mod.body)
    dev = cd.make_acquire(b)
    exe = cd.make_execute(b, dev.result, list(a),
                          [T.TensorType((m, k)), T.TensorType((m, k), "i32")])
    blk = exe.region().block()
    sim = cd.make_similarity(blk, a[0], a[1], metric="hamming", k=k,
                             largest=False, care=a[2] if care else None,
                             extra_attrs={"value_bits": 1})
    cd.make_yield(blk, sim.results)
    cd.make_release(b, dev.result)
    b.ret(exe.results)
    return mod


def knn_kernel(q, gallery):                      # benchmarks/table2_knn.py
    diff = q.unsqueeze(1).sub(gallery)
    d = diff.norm(p=2, dim=-1)
    return d.topk(5, largest=False)


def hdc_similarity(queries, class_hvs):          # examples/quickstart.py
    others = class_hvs.transpose(-2, -1)
    scores = queries.matmul(others)
    values, indices = scores.topk(1, largest=True)
    return values, indices


class Smoke:
    def __init__(self, torch, props, max_clock_mhz: float):
        self.torch = torch
        self.props = props
        self.popc_per_s = (POPC_PER_CLOCK_PER_SM * props.multi_processor_count
                           * max_clock_mhz * 1e6)
        self.compare_per_s = (COMPARES_PER_CLOCK_PER_SM
                              * props.multi_processor_count
                              * max_clock_mhz * 1e6)
        self.imad_per_s = (IMAD_PER_CLOCK_PER_SM * props.multi_processor_count
                           * max_clock_mhz * 1e6)
        self.lop_per_s = (LOP_PER_CLOCK_PER_SM * props.multi_processor_count
                          * max_clock_mhz * 1e6)
        self.lane_slots_per_s = (ISSUE_PER_CLOCK_PER_SM * WARP
                                 * props.multi_processor_count
                                 * max_clock_mhz * 1e6)
        self.kernels = {}        # name -> record for the final line
        self.failed = []
        self.topk = {}           # phase -> (values, indices) of its result

    # -- the main path, counted ---------------------------------------------

    def drive(self, name, prog, inputs, expect):
        """Run the compiled program with the launch counts at 0; return
        its result and the counts it left.  Fails if a kernel of the
        path was not launched."""
        from repro_torch.kernels import cam_search
        torch = self.torch
        cam_search.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = prog(*inputs)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        counts = dict(cam_search.LAUNCHES)
        out2 = prog(*inputs)                 # the gallery memo now hits
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if counts[expect] < 1:
            raise RuntimeError(f"{name}: kernel {expect} was not launched "
                               f"on the main path: {counts}")
        pairs = zip(out, out2) if isinstance(out, tuple) else [(out, out2)]
        if not all(torch.equal(a, b) for a, b in pairs):
            raise RuntimeError(f"{name}: a repeated call changed the result")
        return out, counts, t1 - t0, t2 - t1

    def only(self, name, counts, expect, launches):
        """Fail unless the path launched ``expect`` exactly ``launches``
        times and no other kernel at all."""
        self.exactly(name, counts, {expect: launches})

    def exactly(self, name, counts, launches):
        """Fail unless the path launched each kernel of ``launches`` (a
        name -> count dict) that many times and no other kernel at all."""
        want = {k: launches.get(k, 0) for k in counts}
        if counts != want:
            raise RuntimeError(f"{name}: launches {counts}, expected {want}")

    def profile(self, prog, inputs, top: int = 6, classify=None):
        """Where one warm call's time goes: ``torch.profiler`` over a
        call that ends in a synchronise; device time by kernel (and by
        ``classify(kernel name)`` where given), and the share of the wall
        window in which the device ran nothing."""
        torch = self.torch
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            prog(*inputs)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        try:
            rows = device_rows(prof)
        except (AttributeError, RuntimeError) as e:  # the profiler's API only
            return {"not_measured": repr(e)}
        rows.sort(reverse=True)
        device_ms = sum(r[0] for r in rows)
        # negative when the summed device time exceeds the wall window
        out = {"wall_ms": wall_ms, "device_ms": device_ms,
               "device_idle_share": 1 - device_ms / wall_ms,
               "device_ops": sum(r[2] for r in rows),
               "top": [{"ms": ms, "op": key[:80], "count": n}
                       for ms, key, n in rows[:top]]}
        if classify is not None:
            split = {}
            for ms, key, _ in rows:
                c = classify(key)
                split[c] = split.get(c, 0.0) + ms
            out["by_class_ms"] = split
            # the host side: operators by their own CPU time
            host = sorted(((e.self_cpu_time_total / 1e3, e.key, e.count)
                           for e in prof.key_averages()
                           if e.self_cpu_time_total > 0), reverse=True)
            out["host_ms"] = sum(h[0] for h in host)
            out["host_top"] = [{"ms": ms, "op": key[:60], "count": n}
                               for ms, key, n in host[:top]]
        return out

    def kernel_operands(self, prog, inputs):
        """The (args, kwargs) the path's first micro-batch hands its
        kernel wrapper, rebuilt from the plan's own prepared gallery (a
        ragged micro-batch at its own row count, as the engine runs it)."""
        from repro_torch.core.engine.executables import _cuda_operands
        plan = prog.engine_plan
        spec = plan.spec
        chunk = inputs[spec.query_arg][:plan.batch]
        srcs = plan._stored_sources(inputs)
        return _cuda_operands(spec, plan.packed, chunk,
                              plan._prepared_patterns(*srcs))

    def record(self, name, source, replaces, launches, err, ms, plain_ms,
               bound_ms, bound_by, library_ms):
        rec = self.kernels.setdefault(name, {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": 0.0,
            "ms": None, "plain_ms": None, "bound_ms": None,
            "bound_by": bound_by, "library_ms": None})
        rec["launches"] += launches
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        if ms is not None:       # the KNN-scale phase times the kernel
            rec.update(ms=ms, kernel_ms=ms, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=bound_by,
                       library_ms=library_ms)

    # -- bounds ---------------------------------------------------------------

    def float_bound_ms(self, q, p, out_cols, route="wgmma"):
        """B2 on ``route``: ``"wgmma"``, three products of 2 M N D FLOP at
        the TF32 tensor-core peak (3xTF32); ``"fma"``, one at the float32
        CUDA-core peak (the earlier basis).  The norms are 2 (M + N) D
        FLOP on the CUDA cores.  Against the bytes of its operands and its
        candidates."""
        m, d = q.shape
        n = p.shape[0]
        bytes_ = 4.0 * (m * d + n * d) + 8.0 * m * out_cols
        if route == "wgmma":
            t_ops = 3 * 2.0 * m * n * d / TF32_PEAK_FLOPS
        else:
            t_ops = (2.0 * m * n * d + 2.0 * (m + n) * d) / FP32_PEAK_FLOPS
        t_mem = bytes_ / HBM_BYTES_PER_S
        return 1e3 * max(t_ops, t_mem), "operations" if t_ops >= t_mem \
            else "bytes"

    def range_bound_ms(self, q, p, fp32_cuda_cores=False):
        """B4: the product of its route, 3xTF32 on the tensor cores (three
        products of 2 M N D FLOP at the TF32 peak; with
        ``fp32_cuda_cores``, the earlier route's basis: one at the float32
        CUDA-core peak), against the bytes of its operands and its (M, N)
        bool output."""
        m, d = q.shape
        n = p.shape[0]
        bytes_ = 4.0 * (m * d + n * d) + 1.0 * m * n
        t_ops = 2.0 * m * n * d / FP32_PEAK_FLOPS if fp32_cuda_cores \
            else 3 * 2.0 * m * n * d / TF32_PEAK_FLOPS
        t_mem = bytes_ / HBM_BYTES_PER_S
        return 1e3 * max(t_ops, t_mem), "operations" if t_ops >= t_mem \
            else "bytes"

    def acam_bound_ms(self, q, lo, basis="issue"):
        """B3 on ``basis``: ``"issue"``, its route's issue slots per
        (query, row, dim) cell as the kernel's loop counts them
        (``acam_issue_slots``) at four warp instructions per clock per SM;
        ``"compares"``, the earlier kernel's basis (two compares per cell
        at the compare rate).  Against the bytes of q, lo, hi and the
        (M, N) bool output."""
        m, d = q.shape
        n = lo.shape[0]
        cells = float(m) * n * d
        if basis == "issue":
            t_ops = cells * acam_issue_slots() / self.lane_slots_per_s
        else:
            t_ops = 2.0 * cells / self.compare_per_s
        bytes_ = 4.0 * (m * d + 2 * n * d) + 1.0 * m * n
        t_mem = bytes_ / HBM_BYTES_PER_S
        return 1e3 * max(t_ops, t_mem), "operations" if t_ops >= t_mem \
            else "bytes"

    def distance_bound_ms(self, q, p, fp32_cuda_cores=False):
        """B6: the product of its route, 3xTF32 on the tensor cores (three
        products of 2 M N D FLOP at the TF32 peak; with
        ``fp32_cuda_cores``, the earlier route's basis: one at the float32
        CUDA-core peak, with the norms), against the bytes of its operands
        and its (M, N) float32 output."""
        m, d = q.shape
        n = p.shape[0]
        if fp32_cuda_cores:
            t_ops = (2.0 * m * n * d + 2.0 * (m + n) * d) / FP32_PEAK_FLOPS
        else:
            t_ops = 3 * 2.0 * m * n * d / TF32_PEAK_FLOPS
        bytes_ = 4.0 * (m * d + n * d) + 4.0 * m * n
        t_mem = bytes_ / HBM_BYTES_PER_S
        return 1e3 * max(t_ops, t_mem), "operations" if t_ops >= t_mem \
            else "bytes"

    def distance_topk_bound_ms(self, q, p, k):
        """B6's top-k route (``k > MAX_K``): the product on the tensor
        cores as 3xTF32 (three products of 2 M N D FLOP at the TF32
        peak), against the bytes of its operands and its (M, k) values
        and indices; the (M, N) matrix between the two steps is not part
        of the function's input or output."""
        m, d = q.shape
        n = p.shape[0]
        t_ops = 3 * 2.0 * m * n * d / TF32_PEAK_FLOPS
        bytes_ = 4.0 * (m * d + n * d) + 8.0 * m * k
        t_mem = bytes_ / HBM_BYTES_PER_S
        return 1e3 * max(t_ops, t_mem), "operations" if t_ops >= t_mem \
            else "bytes"

    def select_bound_ms(self, m, n_valid, k):
        """K1s: the n_valid live columns of the (M, N) float32 matrix read
        once and the (M, k) values and indices written, at the HBM rate
        (it does no arithmetic beyond a few integer operations a key)."""
        bytes_ = 4.0 * m * n_valid + 8.0 * m * k
        return 1e3 * bytes_ / HBM_BYTES_PER_S, "bytes"

    def packed_distance_bound_ms(self, q, p, care):
        """K1p: one int8 product of 2 M N 32L operations at the int8
        tensor-core peak, against the bytes of its lanes and its (M, N)
        float32 output."""
        m, lanes = q.shape
        n = p.shape[0]
        t_ops = 2.0 * m * n * 32 * lanes / INT8_PEAK_OPS
        bytes_ = 4.0 * (m * lanes + n * lanes * (2 if care is not None
                                                 else 1)) + 4.0 * m * n
        t_mem = bytes_ / HBM_BYTES_PER_S
        return 1e3 * max(t_ops, t_mem), "operations" if t_ops >= t_mem \
            else "bytes"

    def hdc_bound_ms(self, q, planes, basis="bitsliced"):
        """B5 on ``basis``: ``"bitsliced"``, its route's logical operations
        per (query, feature, 32-dim word) as the kernel's loop counts them
        (``hdc_logical_ops``) with the fewest count planes the features
        need (``hdc_count_bits``) at the LOP3 rate; ``"idp4a"``, the earlier
        gather form's basis (one int8 product per (query, feature, dim),
        four to an IDP4A at the integer multiply-add rate).  Against the
        bytes of the int32 ids, the bit planes and the float32 output."""
        from repro_torch.kernels.packing import lanes
        m, f = q.shape
        h = planes.dim
        if basis == "bitsliced":
            steps = float(m) * (-(-f // 16) * 16) * lanes(h)
            t_ops = steps * hdc_logical_ops(hdc_count_bits(f),
                                            planes.has_zero) / self.lop_per_s
        else:
            t_ops = float(m) * f * h / DP4A_PRODUCTS / self.imad_per_s
        bytes_ = (4.0 * m * f + 4.0 * planes.key_planes.numel()
                  + 4.0 * planes.level_planes.numel() + 4.0 * m * h)
        t_mem = bytes_ / HBM_BYTES_PER_S
        return 1e3 * max(t_ops, t_mem), "operations" if t_ops >= t_mem \
            else "bytes"

    def packed_bound_ms(self, q, p, care, out_cols, n_valid, basis):
        """B1's bound on ``basis``: ``"int8"``, its "mma" route (one int8
        product of 2 M N 32L operations, binary or ternary, at the int8
        tensor-core peak); ``"popc_live"``, its "rows" route (one popc
        per (query, row, lane) of the rows below ``n_valid``, the only
        rows it computes and reads); ``"popc"``, the earlier kernel's basis
        (every row).  Against the bytes of the operands it reads and its
        candidates."""
        m, lanes = q.shape
        n = p.shape[0]
        rows = min(n, n_valid) if basis == "popc_live" else n
        bytes_ = 4.0 * (m * lanes + rows * lanes * (2 if care is not None
                                                     else 1)) \
            + 8.0 * m * out_cols
        if basis == "int8":
            t_ops = 2.0 * m * n * 32 * lanes / INT8_PEAK_OPS
        else:
            t_ops = float(m) * rows * lanes / self.popc_per_s
        t_mem = bytes_ / HBM_BYTES_PER_S
        return 1e3 * max(t_ops, t_mem), "operations" if t_ops >= t_mem \
            else "bytes"

    def packed_shape(self, args, kw, launches):
        """B1 at one main-path shape: its route, time, bound on the
        route's basis and on the earlier popcount basis, plain and library
        times."""
        from repro_torch.kernels import cam_search
        torch = self.torch
        qp, pp, cp = args
        k, n_valid = kw["k"], kw["n_valid"]
        route = cam_search.packed_route(qp.shape[0], pp.shape[0], k,
                                        self.props.multi_processor_count)
        cols = (pp.shape[0] // cam_search.window_rows(k)) * k
        bound, by = self.packed_bound_ms(
            qp, pp, cp, cols, n_valid,
            "int8" if route == "mma" else "popc_live")
        old, old_by = self.packed_bound_ms(qp, pp, cp, cols, n_valid, "popc")
        call = lambda: cam_search.fused_topk_packed(*args, **kw)  # noqa: E731
        ms = cuda_ms(call, 20)
        return {"route": route, "ms": ms, "launches": launches,
                "device_ms": device_ms_per_call(call, 20),
                "host_ms": host_ms_per_call(call, 20),
                "bound_ms": bound, "bound_by": by,
                "basis": "int8 tensor cores, 1,979 TOPS" if route == "mma"
                else "popc of the rows below n_valid",
                "bound_ms_popc_all_rows": old, "bound_by_popc_all_rows":
                old_by,
                "shape": {"q": list(qp.shape), "p": list(pp.shape), "k": k,
                          "n_valid": n_valid,
                          "largest": bool(kw["largest"])}}


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_knn_eucl(s: Smoke, data):
    import torch
    from repro_torch.core import ArchSpec, compile_fn
    from repro_torch.kernels import cam_search, ops
    g, g_labels, q, q_labels = data
    gt, qt = torch.from_numpy(g).cuda(), torch.from_numpy(q).cuda()
    prog = compile_fn(knn_kernel, [q, g], ArchSpec(rows=64, cols=64),
                      value_bits=8)
    (v, i), counts, first_s, second_s = s.drive("knn_eucl", prog, [qt, gt],
                                                "fused_topk")
    prof = s.profile(prog, [qt, gt])
    if v.shape != (q.shape[0], 5) or i.dtype != torch.int32 or \
            not bool(torch.isfinite(v).all()):
        raise RuntimeError(f"knn_eucl: bad result {v.shape} {i.dtype}")
    s.topk["knn_eucl"] = (v, i)

    args, kw = s.kernel_operands(prog, [qt, gt])
    qp, pp = args
    got = cam_search.fused_topk(*args, **kw)
    want = cam_search.fused_topk_reference(*args, **kw)
    torch.cuda.synchronize()
    # every candidate of every window, not only those the merge keeps
    off = (got[0] - want[0]).abs()
    if not bool((off <= EUCL_ATOL + EUCL_RTOL * want[0].abs()).all()):
        raise RuntimeError(f"knn_eucl: candidates off the plain version by "
                           f"{float(off.max())}")
    err = float(off.max())
    cand_swaps = eucl_index_swaps(qp, pp, got[1], want[1],
                                  "knn_eucl candidates")
    # end to end: the plain version's candidates through the same merge
    pv, pi = ops._merge(want[0], want[1], kw["k"], kw["largest"])
    pv, pi = pv[:q.shape[0]], pi[:q.shape[0]]
    tol = EUCL_ATOL + EUCL_RTOL * pv.abs()
    if not bool(((v - pv).abs() <= tol).all()):
        raise RuntimeError(f"knn_eucl: values off the plain version by "
                           f"{float((v - pv).abs().max())}")
    swaps = eucl_index_swaps(qp, pp, i, pi, "knn_eucl result")
    # ... and each of them is what the kernel's own arithmetic gives
    _, cand_exact = b2_order_reproduced(qp, pp, got[0], got[1], want[1],
                                        kw["k"], kw["largest"],
                                        "knn_eucl candidates")
    b2_order_reproduced(qp, pp, v, i, pi, kw["k"], kw["largest"],
                        "knn_eucl result")
    gl = torch.from_numpy(g_labels).cuda().long()
    votes = gl[i.long()].sum(1)                  # two classes: 0 / 1
    acc5 = float(((votes >= 3).long().cpu().numpy() == q_labels).mean())

    route = cam_search.float_route(kw["k"])
    out_cols = got[0].shape[1]
    batch = prog.engine_plan.batch
    shapes = {}
    # the rows the path gives the kernel, and the padded micro-batch that
    # earlier runs gave it (the same queries, zero rows after them)
    for name, qx in (("path", qp), (f"padded_{batch}",
                                    torch.nn.functional.pad(
                                        qp, (0, 0, 0, batch - qp.shape[0])))):
        bound, by = s.float_bound_ms(qx, pp, out_cols)
        fma_bound, _ = s.float_bound_ms(qx, pp, out_cols, "fma")
        shapes[name] = {
            "rows": qx.shape[0],
            "ms": cuda_ms(lambda qx=qx: cam_search.fused_topk(qx, pp, **kw),
                          10),
            "bound_ms": bound, "bound_by": by,
            "bound_ms_fp32_cuda_cores": fma_bound,
            "library_ms": cuda_ms(lambda qx=qx: torch.cdist(qx, pp).topk(
                5, largest=False), 5)}
    path = shapes["path"]
    ms, bound, by = path["ms"], path["bound_ms"], path["bound_by"]
    library_ms = path["library_ms"]
    plain_ms = cuda_ms(lambda: cam_search.fused_topk_reference(*args, **kw),
                       5)
    s.record("fused_topk", "src/repro_torch/kernels/csrc/fused_topk.cu",
             "src/repro/kernels/cam_search.py:200", counts["fused_topk"], err,
             ms, plain_ms, bound, by, library_ms)
    rec = s.kernels["fused_topk"]
    rec["kernel_route"] = route
    rec["bound_basis"] = "3xTF32 tensor cores, 495 TFLOP/s"
    rec["bound_ms_fp32_cuda_cores"] = path["bound_ms_fp32_cuda_cores"]
    rec["shapes"] = shapes
    log({"phase": "knn_eucl", "ok": True, "launches": counts,
         "first_call_s": first_s, "second_call_s": second_s,
         "kernel_shape": {"q": list(qp.shape), "p": list(pp.shape),
                          "k": kw["k"]}, "kernel_route": route,
         "candidate_max_abs_err": err,
         "candidate_index_swaps_float64_near_ties": cand_swaps,
         "result_index_swaps_float64_near_ties": swaps,
         "index_swaps_reproduced_in_kernel_order": True,
         "swapped_candidates_equal_to_replay": cand_exact,
         "shapes": shapes,
         "knn5_label_accuracy": acc5,
         "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
         "bound_ms": bound, "bound_by": by, "profile": prof})


def _packed_phase(s: Smoke, name, data, care):
    import numpy as np
    import torch
    from repro_torch.core import ArchSpec, compile_module
    from repro_torch.core import cim_dialect as cd
    import repro_torch.core as T
    from repro_torch.kernels import cam_search
    g, _, q, _ = data
    gb = (torch.from_numpy(g).cuda() > 0).float()
    qb = (torch.from_numpy(q).cuda() > 0).float()
    inputs = [qb, gb]
    if care:
        rng = np.random.default_rng(5)            # 10 % wildcards
        inputs.append(torch.from_numpy(
            (rng.random(g.shape, dtype=np.float32) >= 0.1).astype(np.int8)
        ).cuda())
    k = 10
    mod = hamming_module(T, cd, q.shape[0], g.shape[0], g.shape[1], k, care)
    prog = compile_module(mod, ArchSpec(rows=64, cols=64), value_bits=1)
    expect = "fused_topk_packed_ternary" if care else "fused_topk_packed"
    (v, i), counts, first_s, second_s = s.drive(name, prog, inputs, expect)
    prof = s.profile(prog, inputs)
    if v.shape != (q.shape[0], k) or not bool(torch.isfinite(v).all()):
        raise RuntimeError(f"{name}: bad result {v.shape}")
    s.topk[name] = (v, i)

    args, kw = s.kernel_operands(prog, inputs)
    got = cam_search.fused_topk_packed(*args, **kw)
    want = cam_search.fused_topk_packed_reference(*args, **kw)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise RuntimeError(f"{name}: kernel and plain version differ")
    err = float((got[0] - want[0]).abs().max())
    # end to end against a dense float64 oracle on the unpacked cells
    q64 = qb[:64].double()
    mism = q64 @ (1 - gb.double()).T + (1 - q64) @ gb.double().T
    if care:
        c64 = inputs[2].double()
        mism = (q64 @ ((1 - gb.double()) * c64).T
                + (1 - q64) @ (gb.double() * c64).T)
    ov = torch.sort(mism, dim=1, stable=True)
    if not (torch.equal(ov.values[:, :k].float(), v[:64])
            and torch.equal(ov.indices[:, :k].int(), i[:64])):
        raise RuntimeError(f"{name}: result differs from the float64 oracle")

    qp, pp, cp = args
    shape = s.packed_shape(args, kw, counts[expect])
    # the padded micro-batch of earlier runs (zero rows after the queries)
    batch = prog.engine_plan.batch
    padded = s.packed_shape((torch.nn.functional.pad(
        qp, (0, 0, 0, batch - qp.shape[0])), pp, cp), kw, 0)
    ms, bound, by = shape["ms"], shape["bound_ms"], shape["bound_by"]
    plain_ms = cuda_ms(
        lambda: cam_search.fused_topk_packed_reference(*args, **kw), 3)
    qpm = 2 * qb - 1
    gpm = 2 * gb - 1
    if care:
        gpm = gpm * inputs[2]
    qpm = torch.nn.functional.pad(qpm, (0, 0, 0, qp.shape[0] - qpm.shape[0]))
    library_ms = cuda_ms(lambda: torch.matmul(qpm, gpm.T).topk(k), 5)
    del gpm
    s.record(expect, "src/repro_torch/kernels/csrc/fused_topk_packed.cu",
             "src/repro/kernels/cam_search.py:304", counts[expect], err, ms,
             plain_ms, bound, by, library_ms)
    rec = s.kernels[expect]
    rec.setdefault("shapes", {})["knn"] = dict(shape, plain_ms=plain_ms,
                                               library_ms=library_ms)
    rec["shapes"][f"knn_padded_{batch}"] = padded
    rec["bound_basis"] = shape["basis"]
    rec["bound_ms_popc_all_rows"] = shape["bound_ms_popc_all_rows"]
    log({"phase": name, "ok": True, "launches": counts, "b1_knn": shape,
         "b1_knn_padded": padded,
         "first_call_s": first_s, "second_call_s": second_s,
         "kernel_shape": {"q": list(qp.shape), "p": list(pp.shape),
                          "k": kw["k"]},
         "candidates_bit_identical": True, "float64_oracle_rows": 64,
         "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
         "bound_ms": bound, "bound_by": by, "profile": prof})


def phase_hdc_quickstart(s: Smoke):
    import torch
    from repro_torch.core import CamType, PAPER_BASE_ARCH, compile_fn
    from repro_torch.data import hdc_dataset
    from repro_torch.kernels import cam_search
    classes, queries, labels = hdc_dataset(n_classes=10, dim=8192,
                                           n_queries=64)
    ct, qt = torch.from_numpy(classes).cuda(), torch.from_numpy(queries).cuda()
    prog = compile_fn(hdc_similarity, [queries, classes], PAPER_BASE_ARCH,
                      cam_type=CamType.TCAM, value_bits=1)
    (v, i), counts, first_s, second_s = s.drive(
        "hdc_quickstart", prog, [qt, ct], "fused_topk_packed")
    prof = s.profile(prog, [qt, ct])
    args, kw = s.kernel_operands(prog, [qt, ct])
    got = cam_search.fused_topk_packed(*args, **kw)
    want = cam_search.fused_topk_packed_reference(*args, **kw)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise RuntimeError("hdc_quickstart: kernel and plain version differ")
    # dense bipolar oracle: argmax of the +-1 dot, lowest index on ties
    qpm = 2 * qt.double() - 1
    cpm = 2 * ct.double() - 1
    dots = qpm @ cpm.T
    best = torch.sort(-dots, dim=1, stable=True).indices[:, 0]
    if not (torch.equal(best.int(), i[:, 0])
            and torch.equal(dots.max(1).values.float(), v[:, 0])):
        raise RuntimeError("hdc_quickstart: result differs from the oracle")
    acc = float((i[:, 0].cpu().numpy() == labels).mean())
    rep = prog.cost_report()
    s.record("fused_topk_packed",
             "src/repro_torch/kernels/csrc/fused_topk_packed.cu",
             "src/repro/kernels/cam_search.py:304",
             counts["fused_topk_packed"], 0.0, None, None, None, "operations",
             None)
    log({"phase": "hdc_quickstart", "ok": True, "launches": counts,
         "first_call_s": first_s, "second_call_s": second_s,
         "kernel_shape": {"q": list(args[0].shape),
                          "p": list(args[1].shape), "k": kw["k"]},
         "candidates_bit_identical": True, "recall_accuracy": acc,
         "cost_report": {"latency_us": rep.latency_us,
                         "energy_uj": rep.energy_uj, "power_w": rep.power_w},
         "profile": prof})


def phase_forest_acam(s: Smoke):
    import numpy as np
    import torch
    from repro_torch.core import ArchSpec, CamType
    from repro_torch.forest import CamForestClassifier, random_forest
    from repro_torch.kernels import acam, ops
    t0 = time.perf_counter()
    trees = random_forest(np.random.default_rng(7), **FOREST)
    clf = CamForestClassifier(trees, dim=FOREST["dim"]).compile(
        ArchSpec(rows=64, cols=64, cam_type=CamType.ACAM),
        batch_hint=FOREST_QUERIES)
    compile_s = time.perf_counter() - t0
    plan = clf.plan
    n = clf.intervals.n_rows
    x = np.random.default_rng(8).standard_normal(
        (FOREST_QUERIES, FOREST["dim"])).astype(np.float32)
    xt = torch.from_numpy(x).cuda()
    pred, counts, first_s, second_s = s.drive("forest_acam", clf.predict,
                                              [xt], "acam_match")
    s.only("forest_acam", counts, "acam_match",
           -(-FOREST_QUERIES // plan.batch))
    prof = s.profile(clf.predict, [xt])
    match = clf.matches(xt)

    # the first micro-batch's operands, as the plan hands them to the kernel
    qp = ops.pad_to_blocks(xt[:plan.batch], 1, acam.ACAM_BLOCK_D)
    lo, hi = plan._prepared_patterns(clf._lo, clf._hi)
    got = acam.acam_match(qp, lo, hi, n_valid=n)
    want = acam.acam_match_reference(qp, lo, hi, n_valid=n)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise RuntimeError("forest_acam: kernel and plain version differ in "
                           f"{int((got != want).sum())} places")
    rows = min(len(xt), plan.batch)
    if not torch.equal(match[:rows], want[:rows]):
        raise RuntimeError("forest_acam: the plan's match matrix differs "
                           "from the plain version")
    per_query = match.sum(1)
    if not bool((per_query == FOREST["n_trees"]).all()):
        raise RuntimeError(f"forest_acam: queries match "
                           f"{int(per_query.min())}..{int(per_query.max())} "
                           f"rows, not one leaf per tree")
    checked = FOREST_CHECKED_ROWS
    ref_pred = clf.predict_reference(x[:checked])
    if not np.array_equal(pred[:checked].cpu().numpy(), ref_pred):
        raise RuntimeError("forest_acam: predictions differ from the tree "
                           "traversal")

    bound, by = s.acam_bound_ms(qp, lo)
    bound_compares, _ = s.acam_bound_ms(qp, lo, basis="compares")
    ms = cuda_ms(lambda: acam.acam_match(qp, lo, hi, n_valid=n), 10)
    plain_ms = cuda_ms(
        lambda: acam.acam_match_reference(qp, lo, hi, n_valid=n), 3)
    s.record("acam_match", "src/repro_torch/kernels/csrc/acam_match.cu",
             "src/repro/kernels/acam.py:121", counts["acam_match"], 0.0, ms,
             plain_ms, bound, by, None)
    rec = s.kernels["acam_match"]
    rec["library_note"] = "no single PyTorch call computes an interval match"
    rec["bound_basis"] = (f"{acam_issue_slots()} issue slots a cell (FADD, "
                          f"LOP3), 4 warp instructions per clock per SM")
    rec["bound_ms_compares"] = bound_compares
    rep = clf.cost_report()
    log({"phase": "forest_acam", "ok": True, "launches": counts,
         "compile_s": compile_s, "first_call_s": first_s,
         "second_call_s": second_s,
         "kernel_shape": {"q": list(qp.shape), "lo": list(lo.shape)},
         "rows": n, "wildcard_frac": clf.intervals.wildcard_frac,
         "match_bit_identical": True, "matches_per_query": FOREST["n_trees"],
         "predictions_equal_traversal_rows": checked,
         "ms": ms, "plain_ms": plain_ms, "library_ms": None,
         "bound_ms": bound, "bound_by": by,
         "bound_ms_compares": bound_compares,
         "cost_report": {"latency_us": rep.latency_us,
                         "energy_uj": rep.energy_uj, "power_w": rep.power_w},
         "profile": prof})


def b2_order_reproduced(qp, pp, got_v, got_i, want_i, k, largest, what):
    """Replay each eucl index swap of B2's "wgmma" route against its plain
    version in the kernel's arithmetic (the pipeline it shares with B4 and
    B6, so ``cam_search.tf32x3_kernel_eucl``): where the kernel put row
    ``a`` at a position and the plain version row ``b``, the replayed
    distances must order ``a`` and ``b`` (lower row first on equal
    distances) as the kernel's list does (``b`` later in the same list of
    ``k``, or absent).  Raises on a swap the replay does not give.
    Returns (swaps, candidates whose value equals the replayed distance
    exactly)."""
    import torch
    from repro_torch.kernels.cam_search import tf32x3_kernel_eucl
    rows, cols = (got_i != want_i).nonzero(as_tuple=True)
    if rows.numel() == 0:
        return 0, 0
    a, b = got_i[rows, cols].long(), want_i[rows, cols].long()
    da = tf32x3_kernel_eucl(qp[rows], pp[a])
    db = tf32x3_kernel_eucl(qp[rows], pp[b])
    seg = (cols // k)[:, None] * k + torch.arange(k, device=cols.device)
    in_list = got_i[rows[:, None], seg] == b[:, None].int()
    pos_b = torch.where(in_list.any(1), in_list.int().argmax(1),
                        torch.full_like(cols, k))
    kernel_a_first = (cols % k) < pos_b
    key_a, key_b = (da, db) if largest else (-da, -db)
    replay_a_first = (key_a > key_b) | ((key_a == key_b) & (a < b))
    bad = (kernel_a_first != replay_a_first).nonzero()
    if bad.numel():
        j = int(bad[0, 0])
        raise RuntimeError(
            f"{what}: swap at ({int(rows[j])}, {int(cols[j])}) is not what "
            f"the kernel's own arithmetic gives (tf32x3_kernel_eucl): rows "
            f"{int(a[j])} {float(da[j])}, {int(b[j])} {float(db[j])}")
    return int(rows.numel()), int((got_v[rows, cols] == da).sum())


def acam_issue_slots() -> float:
    """B3's issue slots per (query, row, dim) cell, as the kernel's loop
    counts them (``csrc/acam_match.cu``): per 4 dims of a (query, row)
    pair, eight FADDs (``q - lo``, ``hi - q``) and four 3-input LOP3s that
    fold their bits into the flag word.  The shared-memory loads (16 per
    384 slots) and the staging are left out."""
    fadd, lop3, dims = 8, 4, 4
    return (fadd + lop3) / dims


def hdc_count_bits(n_features: int) -> int:
    """The fewest bit planes a count of ``n_features`` needs (at least
    the 4 a 16-feature adder tree writes below its carry): the bound's
    basis, whatever wider plane count the kernel's route keeps."""
    return max(4, int(n_features).bit_length())


def hdc_logical_ops(planes: int, has_zero: bool) -> float:
    """B5's logical operations per (query, feature, 32-dim word), as the
    kernel's loop counts them (``csrc/hdc_encode.cu``): per 16 features a
    LOP3 for each ``neg`` word (and an AND for each ``care`` word where
    zero cells exist), 15 full adders of two LOP3 each, and two operations
    per half adder of the ripple into planes 4 .. ``planes`` - 1; the care
    counts, where counted, take a second tree."""
    tree = 2 * 15 + 2 * (planes - 4)
    if has_zero:
        return (2 * 16 + 2 * tree) / 16
    return (16 + tree) / 16


def range_module(T, cd, m, n, dim, metric, tau, value_bits):
    """cim program for a TH-mode range search (``dist <= tau``): the
    traced front end has no range pattern, so it enters the pipeline at
    compile_module, like hamming_module."""
    mod = T.Module("range_search", [T.TensorType((m, dim)),
                                    T.TensorType((n, dim))])
    a = mod.arguments
    b = T.Builder(mod.body)
    dev = cd.make_acquire(b)
    exe = cd.make_execute(b, dev.result, list(a),
                          [T.TensorType((m, n), "i1")])
    blk = exe.region().block()
    rs = cd.make_range_search(blk, a[0], patterns=a[1], metric=metric,
                              threshold=tau, below=True,
                              extra_attrs={"value_bits": value_bits})
    cd.make_yield(blk, rs.results)
    cd.make_release(b, dev.result)
    b.ret(exe.results)
    return mod


def _range_part(s: Smoke, name, metric, tau, inputs, value_bits):
    """Drive one range program on the main path and hold its kernel
    against the plain version on the first micro-batch's operands.
    Returns (main-path match, kernel match, plain match, the kernel's
    (q, p, kwargs), the path's launches, the phase record)."""
    import torch
    import repro_torch.core as T
    from repro_torch.core import ArchSpec, compile_module
    from repro_torch.core import cim_dialect as cd
    from repro_torch.kernels import acam, ops
    qt, gt = inputs
    mod = range_module(T, cd, qt.shape[0], gt.shape[0], gt.shape[1], metric,
                       tau, value_bits)
    prog = compile_module(mod, ArchSpec(rows=64, cols=64))
    plan = prog.engine_plan
    if plan.packed or plan.backend != "cuda":
        raise RuntimeError(f"{name}: expected a float-cell cuda plan")
    hit, counts, first_s, second_s = s.drive(name, prog, inputs,
                                             "range_match")
    s.only(name, counts, "range_match", -(-qt.shape[0] // plan.batch))
    prof = s.profile(prog, inputs)
    (pp,) = plan._prepared_patterns(gt)
    qp = ops.pad_to_blocks(qt[:plan.batch], 1, 8)   # the first micro-batch
    kw = dict(metric=metric, threshold=tau, below=True,
              to_logical="identity", dim=gt.shape[1], n_valid=gt.shape[0])
    got = acam.range_match(qp, pp, **kw)
    want = acam.range_match_reference(qp, pp, **kw)
    torch.cuda.synchronize()
    rows = min(qt.shape[0], plan.batch)
    if not torch.equal(hit[:rows], got[:rows]):
        raise RuntimeError(f"{name}: the main path and the kernel differ")
    info = {"launches": counts, "first_call_s": first_s,
            "second_call_s": second_s, "tau": tau, "batch": plan.batch,
            "kernel_shape": {"q": list(qp.shape), "p": list(pp.shape)},
            "matches_per_query_mean": float(hit.sum(1).float().mean()),
            "profile": prof}
    return hit, got, want, (qp, pp, kw), counts["range_match"], info


def phase_range_threshold(s: Smoke, data):
    import torch
    from repro_torch.kernels import acam, cam_search
    g, _, q, _ = data
    gt, qt = torch.from_numpy(g).cuda(), torch.from_numpy(q).cuda()

    # (a) eucl: tau = median 5th-nearest squared distance of knn_eucl
    kv, ki = s.topk["knn_eucl"]
    tau = float(kv[:, 4].median())
    hit, got, want, (qp, pp, kw), launches, info_a = _range_part(
        s, "range_eucl", "eucl", tau, [qt, gt], 8)
    tol = EUCL_ATOL + EUCL_RTOL * abs(tau)

    def disagreements(qx, got, want):
        """The kernel's disagreements with the plain version: each a
        float64 near-tie of tau, and each what the kernel's own arithmetic
        gives in its order (``tf32x3_kernel_eucl``); also how many the 3xTF32
        split as a float32 matrix product reproduces."""
        rows, cols = (got != want).nonzero(as_tuple=True)
        d64 = ((qx[rows].double() - pp[cols].double()) ** 2).sum(1)
        if not bool(((d64 - tau).abs() <= tol).all()):
            j = int(((d64 - tau).abs() > tol).nonzero()[0, 0])
            raise RuntimeError(
                f"range_eucl: kernel and plain version differ at "
                f"({int(rows[j])}, {int(cols[j])}), not a float64 near-tie: "
                f"{float(d64[j])} vs tau {tau}")
        emulated = acam.range_match_reference(qx, pp, tf32x3=True, **kw)
        explained = int((emulated[rows, cols] == got[rows, cols]).sum())
        del emulated
        in_order = cam_search.tf32x3_kernel_eucl(qx[rows], pp[cols]) <= tau
        explained_in_order = int((in_order == got[rows, cols]).sum())
        if explained_in_order != int(rows.numel()):
            raise RuntimeError(
                f"range_eucl: {int(rows.numel()) - explained_in_order} of "
                f"{int(rows.numel())} disagreements are not what the "
                f"kernel's own arithmetic gives (tf32x3_kernel_eucl): a wrong "
                f"operand, not rounding")
        return int(rows.numel()), explained, explained_in_order

    n_dis, explained, explained_in_order = disagreements(qp, got, want)
    # the padded micro-batch of earlier runs (zero rows after the queries)
    batch = info_a["batch"]
    qpad = torch.nn.functional.pad(qp, (0, 0, 0, batch - qp.shape[0]))
    got_pad = acam.range_match(qpad, pp, **kw)
    padded = disagreements(qpad, got_pad,
                           acam.range_match_reference(qpad, pp, **kw))
    if not torch.equal(got_pad[:qp.shape[0]], got):
        raise RuntimeError("range_eucl: the padded rows changed the real "
                           "rows' matches")
    del got_pad
    top = ki[:, :5].long()                     # knn top-5 below tau - tol
    dtop = ((qt[:, None, :].double() - gt[top].double()) ** 2).sum(-1)
    sure = dtop < tau - tol
    if not bool(hit.gather(1, top)[sure].all()):
        raise RuntimeError("range_eucl: a knn top-5 row well inside tau "
                           "was not matched")
    shapes = {}
    for name, qx in (("path", qp), (f"padded_{batch}", qpad)):
        bound, by = s.range_bound_ms(qx, pp)
        bound_fp32, _ = s.range_bound_ms(qx, pp, fp32_cuda_cores=True)
        shapes[name] = {
            "rows": qx.shape[0],
            "ms": cuda_ms(lambda qx=qx: acam.range_match(qx, pp, **kw), 10),
            "bound_ms": bound, "bound_by": by,
            "bound_ms_fp32_cuda_cores": bound_fp32,
            "library_ms": cuda_ms(
                lambda qx=qx: torch.cdist(qx, pp).square_() <= tau, 5)}
    shapes["path"]["disagreements"] = n_dis
    shapes[f"padded_{batch}"]["disagreements"] = padded[0]
    path = shapes["path"]
    ms, bound, by = path["ms"], path["bound_ms"], path["bound_by"]
    bound_fp32, library_ms = path["bound_ms_fp32_cuda_cores"], \
        path["library_ms"]
    plain_ms = cuda_ms(lambda: acam.range_match_reference(qp, pp, **kw), 5)
    s.record("range_match", "src/repro_torch/kernels/csrc/range_match.cu",
             "src/repro/kernels/acam.py:193", launches,
             float((got != want).any()), ms, plain_ms, bound, by, library_ms)
    rec = s.kernels["range_match"]
    rec["mismatches_float64_near_ties"] = n_dis
    rec["mismatches_reproduced_by_tf32x3_emulation"] = explained
    rec["mismatches_reproduced_in_kernel_order"] = explained_in_order
    rec["mismatches_padded_shape"] = list(padded)
    rec["bound_basis"] = "3xTF32 tensor cores, 495 TFLOP/s"
    rec["bound_ms_fp32_cuda_cores"] = bound_fp32
    rec["shapes"] = shapes
    log(dict(info_a, phase="range_threshold", part="eucl", ok=True,
             disagreements_float64_near_ties=n_dis,
             disagreements_reproduced_by_tf32x3_emulation=explained,
             disagreements_reproduced_in_kernel_order=explained_in_order,
             padded_disagreements_near_ties_emulated_in_order=list(padded),
             bound_ms_fp32_cuda_cores=bound_fp32, shapes=shapes,
             knn_top5_inside_tau=int(sure.sum()), ms=ms, plain_ms=plain_ms,
             library_ms=library_ms, bound_ms=bound, bound_by=by))
    del hit, got, want, qp, qpad, pp

    # (b) hamming on float cells: pack=None demotes on the cuda backend
    hv, hi_ = s.topk["hamming_packed"]
    tau = float(hv[:, 9].median())
    gb, qb = (gt > 0).float(), (qt > 0).float()
    del gt, qt
    hit, got, want, (qp, pp, kw), launches, info_b = _range_part(
        s, "range_hamming", "hamming", tau, [qb, gb], 1)
    if not torch.equal(got, want):
        raise RuntimeError("range_hamming: kernel and plain version differ")
    inside = hv <= tau
    if not bool(hit.gather(1, hi_.long())[inside].all()):
        raise RuntimeError("range_hamming: a packed top-10 row within tau "
                           "was not matched")
    ms = cuda_ms(lambda: acam.range_match(qp, pp, **kw), 10)
    s.record("range_match", "src/repro_torch/kernels/csrc/range_match.cu",
             "src/repro/kernels/acam.py:193", launches, 0.0, None, None,
             None, "operations", None)
    log(dict(info_b, phase="range_threshold", part="hamming", ok=True,
             bit_identical=True, packed_top10_inside_tau=int(inside.sum()),
             ms=ms))


def host_ms(fn):
    """Host-clock milliseconds of ``fn()`` to a synchronise, and its
    result."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0), out


def phase_hdc_mnist(s: Smoke):
    import numpy as np
    import torch
    from repro_torch.data import hdc_mnist_dataset
    from repro_torch.hdc import HdcClassifier
    from repro_torch.kernels import cam_search
    from repro_torch.kernels import hdc_encode as khdc
    from repro_torch.kernels import ref as kref
    t0 = time.perf_counter()
    xtr_np, ytr, xte_np, yte = hdc_mnist_dataset(**HDC_MNIST)
    xtr = torch.from_numpy(xtr_np).cuda()     # features held on the card
    xte = torch.from_numpy(xte_np).cuda()
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    clf = HdcClassifier(xtr.shape[1], HDC_CLASSES, dim=HDC_DIM,
                        n_levels=HDC_LEVELS, seed=0)
    item = clf.item
    yte_t = torch.from_numpy(yte).cuda().long()

    # -- the main path, counted: encode, fit, compile, predict, retrain --
    cam_search.reset_launch_counts()
    encode_train_ms, enc_tr = host_ms(lambda: clf.encode(xtr))
    encode_test_ms, enc_te = host_ms(lambda: clf.encode(xte))
    fit_ms, _ = host_ms(lambda: clf.fit(y=ytr, encoded=enc_tr))
    clf.compile(batch_hint=1024)
    plan = clf.plan
    if not plan.packed or plan.backend != "cuda" or \
            plan.device.type != "cuda":
        raise RuntimeError(f"hdc_mnist: expected a packed cuda plan, got "
                           f"{clf.summary()}")
    predict_first_ms, pred = host_ms(lambda: clf.predict(encoded=enc_te))
    predict_ms, pred2 = host_ms(lambda: clf.predict(encoded=enc_te))
    if not torch.equal(pred, pred2):
        raise RuntimeError("hdc_mnist: a repeated predict changed the result")
    want = clf.predict_reference(encoded=enc_te)
    if not torch.equal(pred, want):
        raise RuntimeError(f"hdc_mnist: predictions differ from the dense "
                           f"oracle in {int((pred != want).sum())} rows")
    rows = HDC_INTERPRETED_ROWS
    if not torch.equal(pred[:rows],
                       clf.predict_interpreted(encoded=enc_te[:rows])):
        raise RuntimeError("hdc_mnist: predictions differ from the IR "
                           "interpreter")
    acc0 = float((pred.long() == yte_t).float().mean())

    epochs = []
    update_ms = []
    update = plan.update_rows

    def timed_update(*args, **kw):        # host clock of each row update
        ms, out = host_ms(lambda: update(*args, **kw))
        update_ms.append(ms)
        return out

    plan.update_rows = timed_update
    try:
        for _ in range(HDC_EPOCHS):
            fb0 = plan.row_update_fallbacks
            n_upd = len(update_ms)
            ep_ms, (train_acc, pushed) = host_ms(
                lambda: clf.retrain_epoch(encoded=enc_tr, y=ytr))
            if plan.row_update_fallbacks != fb0:
                raise RuntimeError("hdc_mnist: a row update fell back")
            hits0, miss0 = plan.pattern_hits, plan.pattern_misses
            pred = clf.predict(encoded=enc_te)
            if plan.pattern_hits != hits0 + 1 or \
                    plan.pattern_misses != miss0:
                raise RuntimeError("hdc_mnist: predict after an update was "
                                   "not a pattern-memo hit")
            if not torch.equal(pred, clf.predict_reference(encoded=enc_te)):
                raise RuntimeError("hdc_mnist: predictions after an update "
                                   "differ from the dense oracle")
            epochs.append({
                "train_accuracy_before": train_acc, "rows_pushed": pushed,
                "test_accuracy_after": float(
                    (pred.long() == yte_t).float().mean()),
                "epoch_ms": ep_ms,
                "update_rows_ms": update_ms[n_upd:]})
    finally:
        del plan.update_rows
    if not update_ms or sum(e["rows_pushed"] for e in epochs) == 0:
        raise RuntimeError("hdc_mnist: retraining pushed no row, so "
                           "update_rows went unexercised")
    counts = dict(cam_search.LAUNCHES)
    for name in ("hdc_encode", "fused_topk_packed"):
        if counts[name] < 1:
            raise RuntimeError(f"hdc_mnist: kernel {name} was not launched "
                               f"on the main path: {counts}")
    if counts["hdc_encode"] != 2:
        raise RuntimeError(f"hdc_mnist: expected two encode launches, got "
                           f"{counts}")
    prof = s.profile(lambda e: clf.predict(encoded=e), [enc_te])
    encode_prof = s.profile(clf.encode, [xte])
    encode_second_ms, enc_again = host_ms(lambda: clf.encode(xte))
    if not torch.equal(enc_again, enc_te):
        raise RuntimeError("hdc_mnist: a repeated encode changed the result")
    del enc_again

    # -- B5 against its plain version and the dense oracle -----------------
    planes = item._planes                  # the kernel's bit planes
    if planes.has_zero:
        raise RuntimeError("hdc_mnist: the item memory holds zero cells")
    q_te = torch.from_numpy(item.quantize(xte_np)).cuda()
    chunk = 8192
    for x, enc in ((xtr_np, enc_tr), (xte_np, enc_te)):
        for s0 in range(0, x.shape[0], chunk):
            q = torch.from_numpy(item.quantize(x[s0:s0 + chunk])).cuda()
            if not torch.equal(item.level_ids(x[s0:s0 + chunk]), q):
                raise RuntimeError(
                    f"hdc_mnist: the device quantisation differs from "
                    f"numpy's in rows {s0}..{s0 + chunk}")
            plain = khdc.hdc_encode_reference(q, item._keys_t,
                                              item._levels_t)
            if not torch.equal(enc[s0:s0 + chunk], plain):
                raise RuntimeError(
                    f"hdc_mnist: the encode kernel differs from its plain "
                    f"version in {int((enc[s0:s0 + chunk] != plain).sum())} "
                    f"cells of rows {s0}..{s0 + chunk}")
    for s0 in range(0, HDC_DENSE_ROWS, HDC_DENSE_CHUNK):
        dense = kref.hdc_encode(q_te[s0:s0 + HDC_DENSE_CHUNK], item._keys_t,
                                item._levels_t)
        if not torch.equal(enc_te[s0:s0 + HDC_DENSE_CHUNK], dense):
            raise RuntimeError("hdc_mnist: the encoding differs from the "
                               "dense oracle")
    ties = int((khdc.hdc_sums_reference(q_te, item._keys_t, item._levels_t)
                == 0).sum())
    if ties == 0:
        raise RuntimeError("hdc_mnist: no exact-zero sum in the test set; "
                           "the tie contract went unexercised")

    # -- B1 at the predict shape (one micro-batch of the test set) --------
    import types
    args, kw = s.kernel_operands(types.SimpleNamespace(engine_plan=plan),
                                 [enc_te, clf._gallery])
    got = cam_search.fused_topk_packed(*args, **kw)
    want = cam_search.fused_topk_packed_reference(*args, **kw)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise RuntimeError("hdc_mnist: the packed kernel and its plain "
                           "version differ at the predict shape")
    b1_hdc = s.packed_shape(args, kw, counts["fused_topk_packed"])
    b1_hdc["plain_ms"] = cuda_ms(
        lambda: cam_search.fused_topk_packed_reference(*args, **kw), 5)
    qpm = 2.0 * enc_te[:args[0].shape[0]].float() - 1
    gpm = 2.0 * clf._gallery.float() - 1
    b1_hdc["library_ms"] = cuda_ms(lambda: torch.matmul(qpm, gpm.T).topk(1),
                                   20)
    b1_hdc["bit_identical"] = True
    del qpm, gpm, got, want

    bound, by = s.hdc_bound_ms(q_te, planes)
    bound_idp4a, _ = s.hdc_bound_ms(q_te, planes, "idp4a")
    ms = cuda_ms(lambda: khdc.hdc_encode_planes(q_te, planes), 10)
    plain_ms = cuda_ms(lambda: khdc.hdc_encode_reference(
        q_te, item._keys_t, item._levels_t), 3)
    s.record("hdc_encode", "src/repro_torch/kernels/csrc/hdc_encode.cu",
             "src/repro/kernels/hdc_encode.py:87", counts["hdc_encode"], 0.0,
             ms, plain_ms, bound, by, None)
    rec = s.kernels["hdc_encode"]
    rec["library_note"] = (
        "no single PyTorch call computes a signed gathered bundle")
    rec["kernel_route"] = "bitsliced, no zero cell"
    per_step = hdc_logical_ops(hdc_count_bits(q_te.shape[1]), False)
    rec["bound_basis"] = (f"{per_step} LOP3 per (row, feature, word) at "
                          f"64 a clock per SM")
    rec["bound_ms_idp4a_basis"] = bound_idp4a
    s.record("fused_topk_packed",
             "src/repro_torch/kernels/csrc/fused_topk_packed.cu",
             "src/repro/kernels/cam_search.py:304",
             counts["fused_topk_packed"], 0.0, None, None, None,
             "operations", None)
    s.kernels["fused_topk_packed"].setdefault("shapes", {})[
        "hdc_predict"] = b1_hdc
    del enc_tr, enc_te
    peak_gb = (torch.cuda.max_memory_allocated() - mem0) / 1e9
    if peak_gb > HDC_PEAK_GB:
        raise RuntimeError(f"hdc_mnist: the phase held {peak_gb:.2f} GB "
                           f"at its peak, over {HDC_PEAK_GB} GB")
    log({"phase": "hdc_mnist", "ok": True, "launches": counts,
         "data_s": data_s, "train": list(xtr.shape), "test": list(xte.shape),
         "dim": HDC_DIM, "levels": HDC_LEVELS, "plan": clf.summary(),
         "encode_bit_identical_rows": xtr.shape[0] + xte.shape[0],
         "dense_oracle_rows": HDC_DENSE_ROWS,
         "interpreted_rows": HDC_INTERPRETED_ROWS,
         "exact_zero_sums_test": ties,
         "encode_train_ms": encode_train_ms,
         "encode_ms_per_10k_rows": encode_test_ms * 1e4 / xte.shape[0],
         "encode_second_call_ms_per_10k_rows":
             encode_second_ms * 1e4 / xte.shape[0],
         "fit_ms": fit_ms, "predict_first_ms": predict_first_ms,
         "predict_ms_per_10k_rows": predict_ms * 1e4 / xte.shape[0],
         "one_shot_test_accuracy": acc0, "epochs": epochs,
         "phase_peak_gb": peak_gb, "predict_profile": prof,
         "b1_hdc_predict": b1_hdc,
         "encode_profile": encode_prof,
         "kernel_shape": {"q": list(q_te.shape),
                          "key_planes": list(planes.key_planes.shape),
                          "level_planes": list(planes.level_planes.shape)},
         "kernel_route": "bitsliced, no zero cell",
         "ms": ms, "plain_ms": plain_ms, "library_ms": None,
         "bound_ms": bound, "bound_by": by,
         "bound_ms_idp4a_basis": bound_idp4a})


def _update_part(s: Smoke, name, build, qt, gt, rows, new):
    """``update_rows`` on one plan, both ``donate`` settings: each update
    must leave the next execute a memo hit with no fallback, bit-identical
    to a fresh plan on the mutated gallery; the old gallery keeps its old
    result.  Returns (launches, record)."""
    import torch
    from repro_torch.core import clear_plan_cache
    from repro_torch.kernels import cam_search
    prog = build()
    plan = prog.engine_plan
    cam_search.reset_launch_counts()
    before = prog(qt, gt)
    fb0 = plan.row_update_fallbacks
    upd_ms, g1 = host_ms(lambda: plan.update_rows(gt, rows, new))
    hits0, miss0 = plan.pattern_hits, plan.pattern_misses
    out1 = prog(qt, g1)
    hit1 = (plan.pattern_hits, plan.pattern_misses) == (hits0 + 1, miss0)
    old = prog(qt, gt)
    g2 = gt.clone()
    prog(qt, g2)                                  # prepares the copy
    don_ms, g2r = host_ms(lambda: plan.update_rows(g2, rows, new,
                                                   donate=True))
    hits0, miss0 = plan.pattern_hits, plan.pattern_misses
    out2 = prog(qt, g2)
    hit2 = (plan.pattern_hits, plan.pattern_misses) == (hits0 + 1, miss0)
    # second calls: the same rows again, from the updated galleries
    upd2_ms, g1b = host_ms(lambda: plan.update_rows(g1, rows, new))
    don2_ms, _ = host_ms(lambda: plan.update_rows(g2, rows, new,
                                                  donate=True))
    counts = dict(cam_search.LAUNCHES)
    if not (hit1 and hit2) or plan.row_update_fallbacks != fb0:
        raise RuntimeError(f"{name}: an update was not memo-seeded (hits "
                           f"{hit1}, {hit2}; fallbacks "
                           f"{plan.row_update_fallbacks - fb0})")
    if g2r is not g2 or not torch.equal(g1, g2):
        raise RuntimeError(f"{name}: the donated update differs")
    if not all(torch.equal(a, b) for a, b in zip(old, before)):
        raise RuntimeError(f"{name}: the old gallery lost its old result")
    clear_plan_cache()
    fresh_prog = build()
    fresh_plan = fresh_prog.engine_plan
    fresh = fresh_prog(qt, g1.clone())
    for got, what in ((out1, "donate=False"), (out2, "donate=True")):
        if not all(torch.equal(a, b) for a, b in zip(got, fresh)):
            raise RuntimeError(f"{name}: after the {what} update the result "
                               f"differs from a fresh plan's")
    fresh_plan._prepare(g1b)
    prep_ms, _ = host_ms(lambda: fresh_plan._prepare(g1b))
    del g1, g1b, g2, fresh
    return counts, {"update_ms_donate_false": [upd_ms, upd2_ms],
                    "update_ms_donate_true": [don_ms, don2_ms],
                    "full_prepare_ms": prep_ms,
                    "bit_identical_to_fresh_plan": True,
                    "memo_hit_after_update": True,
                    "old_gallery_keeps_old_result": True}


def phase_gallery_update(s: Smoke, data):
    import numpy as np
    import torch
    import repro_torch.core as T
    from repro_torch.core import ArchSpec, compile_fn, compile_module
    from repro_torch.core import cim_dialect as cd
    g, g_labels, q, _ = data
    n, dim = g.shape
    rng = np.random.default_rng(UPDATE_SEED)
    starts = np.sort(rng.choice(n // UPDATE_RUN, UPDATE_RUNS,
                                replace=False)) * UPDATE_RUN
    rows = (starts[:, None] + np.arange(UPDATE_RUN)).reshape(-1)
    gt, qt = torch.from_numpy(g).cuda(), torch.from_numpy(q).cuda()
    # new rows from the gallery's distribution: their class mean + N(0, 1)
    labels = torch.from_numpy(g_labels).cuda().long()
    means = torch.stack([gt[labels == c].mean(0)
                         for c in range(int(labels.max()) + 1)])
    noise = torch.from_numpy(
        rng.standard_normal((rows.size, dim)).astype(np.float32)).cuda()
    new = means[labels[torch.from_numpy(rows).cuda()]] + noise
    arch = ArchSpec(rows=64, cols=64)

    counts_a, rec_a = _update_part(
        s, "gallery_update_eucl",
        lambda: compile_fn(knn_kernel, [q, g], arch, value_bits=8), qt, gt,
        rows, new)
    gb, qb = (gt > 0).float(), (qt > 0).float()
    del gt, qt
    counts_b, rec_b = _update_part(
        s, "gallery_update_packed",
        lambda: compile_module(hamming_module(T, cd, q.shape[0], n, dim, 10,
                                              False), arch, value_bits=1),
        qb, gb, rows, (new > 0).float())
    if counts_a["fused_topk"] < 1 or counts_b["fused_topk_packed"] < 1:
        raise RuntimeError(f"gallery_update: a kernel of the path was not "
                           f"launched: {counts_a} {counts_b}")
    s.record("fused_topk", "src/repro_torch/kernels/csrc/fused_topk.cu",
             "src/repro/kernels/cam_search.py:200", counts_a["fused_topk"],
             0.0, None, None, None, "operations", None)
    s.record("fused_topk_packed",
             "src/repro_torch/kernels/csrc/fused_topk_packed.cu",
             "src/repro/kernels/cam_search.py:304",
             counts_b["fused_topk_packed"], 0.0, None, None, None,
             "operations", None)
    knn = s.kernels["fused_topk_packed"].get("shapes", {}).get("knn")
    if knn is not None:
        knn["launches"] += counts_b["fused_topk_packed"]
    log({"phase": "gallery_update", "ok": True,
         "rows_updated": int(rows.size), "runs": UPDATE_RUNS,
         "eucl": dict(rec_a, launches=counts_a),
         "packed": dict(rec_b, launches=counts_b)})


def phase_distance_ops(s: Smoke, data):
    import torch
    from repro_torch.kernels import cam_search, ops
    g, _, q, _ = data
    gt, qt = torch.from_numpy(g).cuda(), torch.from_numpy(q).cuda()
    gb, qb = (gt > 0).float(), (qt > 0).float()
    launches = 0

    def counted(fn):
        nonlocal launches
        cam_search.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        if cam_search.LAUNCHES["distance"] != 1 or \
                sum(cam_search.LAUNCHES.values()) != 1:
            raise RuntimeError(f"distance_ops: expected one distance "
                               f"launch, got {cam_search.LAUNCHES}")
        launches += 1
        return out

    d = counted(lambda: ops.cam_distances(qt, gt, metric="eucl"))
    prof = s.profile(lambda a, b: ops.cam_distances(a, b, metric="eucl"),
                     [qt, gt])
    dh = counted(lambda: ops.cam_distances(qb, gb, metric="hamming"))
    exact = counted(lambda: ops.cam_exact(qb, gb))
    tau = float(dh.median())
    within = counted(lambda: ops.cam_range(qb, gb, tau))
    if tuple(d.shape) != (q.shape[0], g.shape[0]) or \
            not bool(torch.isfinite(d).all()):
        raise RuntimeError(f"distance_ops: bad result {tuple(d.shape)}")
    plain = cam_search.distance_reference(qt, gt, metric="eucl")
    off = (d - plain).abs()
    if not bool((off <= EUCL_ATOL + EUCL_RTOL * plain.abs()).all()):
        raise RuntimeError(f"distance_ops: eucl off the plain version by "
                           f"{float(off.max())}")
    err = float(off.max())
    worst_share = float((off / (EUCL_ATOL + EUCL_RTOL * plain.abs())).max())
    mean_err = float((d.double() - plain.double()).mean())
    # the kernel's own arithmetic, replayed: the query row holding the
    # largest error (all its rows) and the REPLAY_FURTHEST entries
    # furthest from the plain version
    n = gt.shape[0]
    flat = off.flatten()
    far = flat.topk(REPLAY_FURTHEST).indices
    row = int(far[0]) // n
    rows = torch.cat([torch.full((n,), row, device=far.device), far // n])
    cols = torch.cat([torch.arange(n, device=far.device), far % n])
    del plain, off, flat
    replay = cam_search.tf32x3_kernel_eucl(qt[rows], gt[cols])
    replay_equal = int((replay == d[rows, cols]).sum())
    if replay_equal != rows.numel():
        raise RuntimeError(
            f"distance_ops: {rows.numel() - replay_equal} of "
            f"{rows.numel()} replayed eucl entries differ from the kernel's "
            f"(tf32x3_kernel_eucl)")
    del replay, rows, cols
    plain_h = cam_search.distance_reference(qb, gb, metric="hamming")
    if not torch.equal(dh, plain_h):
        raise RuntimeError("distance_ops: hamming differs from the plain "
                           "version")
    if not (torch.equal(exact, plain_h == 0)
            and torch.equal(within, plain_h <= tau)):
        raise RuntimeError("distance_ops: cam_exact / cam_range differ from "
                           "the plain version's comparisons")
    exact_pairs, within_pairs = int(exact.sum()), int(within.sum())
    del plain_h, exact, within, dh

    bound, by = s.distance_bound_ms(qt, gt)
    bound_fp32, _ = s.distance_bound_ms(qt, gt, fp32_cuda_cores=True)
    ms = cuda_ms(lambda: cam_search.distance(qt, gt, metric="eucl"), 10)
    plain_ms = cuda_ms(lambda: cam_search.distance_reference(
        qt, gt, metric="eucl"), 5)
    library_ms = cuda_ms(lambda: torch.cdist(qt, gt) ** 2, 5)
    ham_ms = cuda_ms(lambda: cam_search.distance(qb, gb, metric="hamming"),
                     10)
    ham_library_ms = cuda_ms(lambda: torch.cdist(qb, gb, p=0), 3)
    s.record("distance", "src/repro_torch/kernels/csrc/distance.cu",
             "src/repro/kernels/cam_search.py:351", launches, err, ms,
             plain_ms, bound, by, library_ms)
    rec = s.kernels["distance"]
    rec["bound_basis"] = "3xTF32 tensor cores, 495 TFLOP/s"
    rec["bound_ms_fp32_cuda_cores"] = bound_fp32
    rec["eucl_worst_share_of_tolerance"] = worst_share
    rec["replayed_bit_identical"] = [replay_equal, row]
    log({"phase": "distance_ops", "ok": True, "launches": launches,
         "shape": [q.shape[0], g.shape[0], g.shape[1]],
         "output_mb": 4e-6 * q.shape[0] * g.shape[0],
         "eucl_max_abs_err": err, "eucl_mean_err": mean_err,
         "eucl_worst_share_of_tolerance": worst_share,
         "replayed_bit_identical": replay_equal, "replayed_row": row,
         "hamming_bit_identical": True,
         "hamming_tau": tau, "exact_pairs": exact_pairs,
         "within_tau_pairs": within_pairs,
         "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
         "hamming_ms": ham_ms, "hamming_library_ms_cdist_p0": ham_library_ms,
         "bound_ms": bound, "bound_by": by,
         "bound_ms_fp32_cuda_cores": bound_fp32, "profile": prof})


# ---------------------------------------------------------------------------
# queue_c: the repaired refusals (k > MAX_K on the card, B5's size limits)
# ---------------------------------------------------------------------------


def _knn_k(k):
    """``benchmarks/table2_knn.py``'s KNN program at top-``k``."""
    def knn(q, gallery):
        diff = q.unsqueeze(1).sub(gallery)
        return diff.norm(p=2, dim=-1).topk(k, largest=False)
    return knn


def _select_part(s: Smoke, what, dist, k, largest, n_valid):
    """K1s on one matrix of the route: bit for bit against its plain
    version, then its time, the plain version's and ``torch.topk``'s on
    the same matrix, and its bound."""
    import torch
    from repro_torch.kernels import cam_search
    kw = dict(k=k, largest=largest, n_valid=n_valid)
    got = cam_search.topk_select(dist, **kw)
    want = cam_search.topk_select_reference(dist, **kw)
    torch.cuda.synchronize()
    if not (torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
            and torch.equal(got[1], want[1])):
        raise RuntimeError(f"queue_c {what}: topk_select differs from its "
                           f"plain version")
    m = dist.shape[0]
    bound, by = s.select_bound_ms(m, n_valid, k)
    live = dist[:, :n_valid]
    return {"rows": m, "cols": dist.shape[1], "n_valid": n_valid, "k": k,
            "split": cam_search.select_split(
                m, k, n_valid, s.props.multi_processor_count),
            "bit_identical_to_plain": True,
            "ms": cuda_ms(lambda: cam_search.topk_select(dist, **kw), 20),
            "plain_ms": cuda_ms(lambda: cam_search.topk_select_reference(
                dist, **kw), 5),
            "library_ms": cuda_ms(lambda: torch.topk(live, k, largest=largest),
                                  5),
            "bound_ms": bound, "bound_by": by}


def _queue_c_eucl(s: Smoke, data):
    """C1, eucl: top-500 at the KNN shape on the default ("cuda") backend,
    B6's matrix and K1s, against the "torch" backend on the card; the
    route against its plain version, K1s on B6's matrix against its own
    bit for bit, each at the 624 queries and at a 13-row micro-batch."""
    import torch
    from repro_torch.core import ArchSpec, compile_fn
    from repro_torch.kernels import cam_search
    g, _, q, _ = data
    gt, qt = torch.from_numpy(g).cuda(), torch.from_numpy(q).cuda()
    k = QUEUE_C_EUCL_K
    prog = compile_fn(_knn_k(k), [q, g], ArchSpec(rows=64, cols=64),
                      value_bits=8)
    (v, i), counts, first_s, second_s = s.drive(
        "queue_c eucl", prog, [qt, gt], "distance_topk")
    s.exactly("queue_c eucl", counts, {"distance_topk": 1, "topk_select": 1})
    route = cam_search.float_route(k)
    if route != "matrix" or v.shape != (q.shape[0], k) or \
            not bool(torch.isfinite(v).all()):
        raise RuntimeError(f"queue_c eucl: route {route}, result "
                           f"{tuple(v.shape)}")
    torch_ms, (tv, ti) = host_ms(lambda: compile_fn(
        _knn_k(k), [q, g], ArchSpec(rows=64, cols=64), value_bits=8,
        backend="torch")(qt, gt))
    tol = EUCL_ATOL + EUCL_RTOL * tv.abs()
    if not bool(((v - tv).abs() <= tol).all()):
        raise RuntimeError(f"queue_c eucl: values off the torch backend by "
                           f"{float((v - tv).abs().max())}")
    swaps = eucl_index_swaps(qt, gt, i, ti, "queue_c eucl vs torch")
    (qp, pp), kw = s.kernel_operands(prog, [qt, gt])
    got = cam_search.topk_by_distance(qp, pp, **kw)
    want = cam_search.topk_by_distance_reference(qp, pp, **kw)
    torch.cuda.synchronize()
    off = (got[0] - want[0]).abs()
    if not bool((off <= EUCL_ATOL + EUCL_RTOL * want[0].abs()).all()):
        raise RuntimeError(f"queue_c eucl: wrapper off its plain version "
                           f"by {float(off.max())}")
    err = float(off.max())
    plain_swaps = eucl_index_swaps(qp, pp, got[1], want[1],
                                   "queue_c eucl vs plain")
    del got, want, off
    n_valid = kw["n_valid"]
    parts = {}
    for rows in (qp.shape[0], QUEUE_C_SMALL_ROWS):
        qr = qp[:rows].contiguous()
        bound, by = s.distance_topk_bound_ms(qr, pp, k)
        d = cam_search.distance(qr, pp, metric="eucl")
        sel = _select_part(s, f"eucl {rows} rows", d, k, kw["largest"],
                           n_valid)
        del d
        parts[rows] = {
            "ms": cuda_ms(lambda: cam_search.topk_by_distance(qr, pp, **kw),
                          10),
            "distance_ms": cuda_ms(
                lambda: cam_search.distance(qr, pp, metric="eucl"), 10),
            "plain_ms": cuda_ms(lambda: cam_search.topk_by_distance_reference(
                qr, pp, **kw), 3),
            "library_ms": cuda_ms(
                lambda: torch.cdist(qr, pp).topk(k, largest=False), 3),
            "bound_ms": bound, "bound_by": by, "topk_select": sel}
        torch.cuda.empty_cache()
    big, small = parts[qp.shape[0]], parts[QUEUE_C_SMALL_ROWS]
    s.record("distance_topk", "src/repro_torch/kernels/csrc/distance.cu",
             "src/repro/kernels/cam_search.py:200", counts["distance_topk"],
             err, big["ms"], big["plain_ms"], big["bound_ms"],
             big["bound_by"], big["library_ms"])
    rec = s.kernels["distance_topk"]
    rec.update(kernel_route="matrix: B6 (distance.cu, 3xTF32) writes the "
                            "(M, N) matrix, K1s (topk_select.cu) selects",
               bound_basis="3xTF32 tensor cores, 495 TFLOP/s; the output "
                           "(M, k) values and indices",
               distance_ms=big["distance_ms"], rows_13=small,
               shape={"q": list(qp.shape), "p": list(pp.shape), "k": k})
    sel = big["topk_select"]
    s.record("topk_select", "src/repro_torch/kernels/csrc/topk_select.cu",
             "src/repro/kernels/cam_search.py:200", counts["topk_select"],
             0.0, sel["ms"], sel["plain_ms"], sel["bound_ms"],
             sel["bound_by"], sel["library_ms"])
    s.kernels["topk_select"].update(
        kernel_route="radix select, 11-bit digits, then a stable LSD sort "
                     "of the k pairs; clusters of select_split blocks a row",
        bound_basis="the (M, n_valid) float32 read once, the (M, k) output "
                    "written, 3.35 TB/s",
        library_note="torch.topk on the same matrix (its tie order is not "
                     "the reference's)",
        eucl=sel, eucl_13_rows=small["topk_select"])
    return {"k": k, "route": route, "launches": counts,
            "first_call_s": first_s, "second_call_s": second_s,
            "torch_backend_ms": torch_ms,
            "index_swaps_vs_torch_float64_near_ties": swaps,
            "wrapper_max_abs_err": err,
            "wrapper_index_swaps_float64_near_ties": plain_swaps,
            "rows_624": big, "rows_13": small}


def _queue_c_packed(s: Smoke, data):
    """C1, packed hamming: top-400 at the KNN shape on the default
    backend (K1p on the packed lanes, then K1s), bit-identical to the
    "torch" backend (packed popcount tournament) and, with K1p and K1s
    each, to the plain versions; a 13-row micro-batch through the same
    program; the prepared gallery's bytes."""
    import torch
    import repro_torch.core as T
    from repro_torch.core import ArchSpec, compile_module
    from repro_torch.core import cim_dialect as cd
    from repro_torch.kernels import cam_search
    g, _, q, _ = data
    gb = (torch.from_numpy(g).cuda() > 0).float()
    qb = (torch.from_numpy(q).cuda() > 0).float()
    k = QUEUE_C_PACKED_K
    mod = hamming_module(T, cd, q.shape[0], g.shape[0], g.shape[1], k, False)
    prog = compile_module(mod, ArchSpec(rows=64, cols=64), value_bits=1)
    if not prog.engine_plan.packed:
        raise RuntimeError("queue_c packed: the plan is not packed")
    (v, i), counts, _, _ = s.drive("queue_c packed", prog, [qb, gb],
                                   "packed_distance")
    s.exactly("queue_c packed", counts, {"packed_distance": 1,
                                         "topk_select": 1})
    route = cam_search.packed_route(q.shape[0], g.shape[0], k,
                                    s.props.multi_processor_count)
    torch_ms, (tv, ti) = host_ms(lambda: compile_module(
        mod, ArchSpec(rows=64, cols=64), value_bits=1,
        backend="torch")(qb, gb))
    if route != "matrix" or not (torch.equal(v, tv) and torch.equal(i, ti)):
        raise RuntimeError(f"queue_c packed: route {route}; bit-identical "
                           f"to the torch backend: values "
                           f"{torch.equal(v, tv)}, indices "
                           f"{torch.equal(i, ti)}")
    small = QUEUE_C_SMALL_ROWS
    (sv, si), small_counts, _, _ = s.drive(
        "queue_c packed 13 rows", prog, [qb[:small], gb], "packed_distance")
    s.exactly("queue_c packed 13 rows", small_counts,
              {"packed_distance": 1, "topk_select": 1})
    if not (torch.equal(sv, tv[:small]) and torch.equal(si, ti[:small])):
        raise RuntimeError("queue_c packed: the 13-row call differs from "
                           "the torch backend")
    (qp, pp, cp), kw = s.kernel_operands(prog, [qb, gb])
    prepared = prog.engine_plan._prepared_patterns(gb)
    if any(x.dtype != torch.int32 for x in prepared):
        raise RuntimeError("queue_c packed: the prepared gallery is not "
                           "packed lanes")
    prepared_mb = 1e-6 * sum(x.numel() * x.element_size() for x in prepared)
    got = cam_search.topk_by_packed_distance(qp, pp, cp, **kw)
    want = cam_search.topk_by_packed_distance_reference(qp, pp, cp, **kw)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise RuntimeError("queue_c packed: wrapper and plain version "
                           "differ")
    del got, want
    n_valid = kw["n_valid"]
    parts = {}
    for rows in (qp.shape[0], small):
        qr = qp[:rows].contiguous()
        d = cam_search.packed_distance(qr, pp, cp)
        if not torch.equal(d, cam_search.packed_distance_reference(qr, pp,
                                                                   cp)):
            raise RuntimeError(f"queue_c packed: packed_distance differs "
                               f"from its plain version at {rows} rows")
        sel = _select_part(s, f"packed {rows} rows", d, k, kw["largest"],
                           n_valid)
        del d
        bound, by = s.packed_bound_ms(qr, pp, cp, k, n_valid, "int8")
        dbound, dby = s.packed_distance_bound_ms(qr, pp, cp)
        ones = torch.ones(qr.shape[1] * 32, device=qr.device)
        qpm = 2 * ops_unpack(qr) - 1
        gpm = 2 * ops_unpack(pp) - 1
        dim = float(qpm.shape[1])
        parts[rows] = {
            "ms": cuda_ms(lambda: cam_search.topk_by_packed_distance(
                qr, pp, cp, **kw), 10),
            "plain_ms": cuda_ms(
                lambda: cam_search.topk_by_packed_distance_reference(
                    qr, pp, cp, **kw), 3),
            "library_ms": cuda_ms(lambda: torch.matmul(qpm, gpm.T).topk(k),
                                  3),
            "bound_ms": bound, "bound_by": by,
            "packed_distance": {
                "ms": cuda_ms(lambda: cam_search.packed_distance(qr, pp, cp),
                              20),
                "plain_ms": cuda_ms(
                    lambda: cam_search.packed_distance_reference(qr, pp, cp),
                    3),
                "library_ms": cuda_ms(lambda: torch.addmm(
                    ones[:1] * (dim / 2), qpm, gpm.T, alpha=-0.5), 5),
                "bound_ms": dbound, "bound_by": dby,
                "bit_identical_to_plain": True},
            "topk_select": sel}
        del qpm, gpm, ones
        torch.cuda.empty_cache()
    big, sm = parts[qp.shape[0]], parts[small]
    s.record("distance_topk_packed",
             "src/repro_torch/kernels/csrc/fused_topk_packed.cu",
             "src/repro/kernels/cam_search.py:304", counts["packed_distance"],
             0.0, big["ms"], big["plain_ms"], big["bound_ms"],
             big["bound_by"], big["library_ms"])
    s.kernels["distance_topk_packed"].update(
        kernel_route="matrix: K1p (fused_topk_packed.cu, int8 mma.sync on "
                     "the packed lanes) writes the (M, N) matrix, K1s "
                     "(topk_select.cu) selects",
        bound_basis="int8 tensor cores, 1,979 TOPS, on the packed lanes; "
                    "the output (M, k) values and indices",
        library_note="+-1 float matmul + topk",
        prepared_mb=prepared_mb, rows_13=sm,
        shape={"q": list(qp.shape), "p": list(pp.shape), "k": k})
    pd = big["packed_distance"]
    s.record("packed_distance",
             "src/repro_torch/kernels/csrc/fused_topk_packed.cu",
             "src/repro/kernels/cam_search.py:304",
             counts["packed_distance"] + small_counts["packed_distance"],
             0.0, pd["ms"], pd["plain_ms"], pd["bound_ms"], pd["bound_by"],
             pd["library_ms"])
    s.kernels["packed_distance"].update(
        kernel_route="packed_mma_kernel's int8 mma.sync products, the "
                     "distance epilogue; the mma grid at every row count",
        bound_basis="the larger of the int8 products at 1,979 TOPS and the "
                    "lanes read and (M, N) float32 written at 3.35 TB/s",
        library_note="addmm of the unpacked +-1 cells: (D - q.p) / 2",
        rows_13=sm["packed_distance"])
    s.kernels["topk_select"]["launches"] += counts["topk_select"] + \
        small_counts["topk_select"]
    s.kernels["topk_select"].update(packed=big["topk_select"],
                                    packed_13_rows=sm["topk_select"])
    return {"k": k, "route": route, "launches": counts,
            "launches_13_rows": small_counts,
            "bit_identical_to_torch_backend": True,
            "wrapper_bit_identical_to_plain": True,
            "prepared_mb": prepared_mb, "torch_backend_ms": torch_ms,
            "rows_624": big, "rows_13": sm}


def ops_unpack(lanes):
    """{0, 1} float32 cells of int32 lanes (LSB first)."""
    from repro_torch.kernels.packing import LANE_BITS, unpack_bits
    return unpack_bits(lanes, lanes.shape[1] * LANE_BITS).float()


def _queue_c_hdc(s: Smoke):
    """C3: B5 where it refused before — 65,536 features (a 256 x 256
    image) to 8192 dims, 512 levels, and 2,100,000 rows in one call —
    each through ``ItemMemory.encode`` on the card, bit-identical to the
    plain version; and HDC/MNIST-8k's test set on the bit-sliced route."""
    import numpy as np
    import torch
    from repro_torch.hdc import ItemMemory
    from repro_torch.kernels import cam_search
    from repro_torch.kernels import hdc_encode as khdc
    out = {}
    rng = np.random.default_rng(21)
    for name, (m, f, h, levels, expect) in QUEUE_C_HDC.items():
        item = ItemMemory(f, dim=h, n_levels=levels, seed=5)
        x = rng.random((m, f), dtype=np.float32)
        cam_search.reset_launch_counts()
        enc_ms, enc = host_ms(lambda: item.encode(x))
        counts = dict(cam_search.LAUNCHES)
        route = khdc.hdc_route(f, levels)
        want_key = "hdc_encode" if route == "bitsliced" else \
            "hdc_encode_wide"
        s.only(f"queue_c {name}", counts, want_key, 1)
        if route != expect:
            raise RuntimeError(f"queue_c {name}: route {route}, expected "
                               f"{expect}")
        q = item.level_ids(x)
        want = khdc.hdc_encode_reference(q, item._keys_t, item._levels_t)
        if not torch.equal(enc, want) or enc.shape != (m, h):
            raise RuntimeError(f"queue_c {name}: the encoding differs from "
                               f"the plain version")
        del want
        ms = cuda_ms(lambda: khdc.hdc_encode_planes(q, item._planes), 5)
        bound, by = s.hdc_bound_ms(q, item._planes)
        entry = {"rows": m, "features": f, "dim": h, "levels": levels,
                 "route": route, "launches": counts[want_key],
                 "encode_host_ms": enc_ms, "ms": ms, "bound_ms": bound,
                 "bound_by": by, "bit_identical_to_plain": True,
                 "output_gb": 4e-9 * m * h}
        if name == "wide_features":
            plain_ms = cuda_ms(lambda: khdc.hdc_encode_reference(
                q, item._keys_t, item._levels_t), 3)
            entry["plain_ms"] = plain_ms
            s.record("hdc_encode_wide",
                     "src/repro_torch/kernels/csrc/hdc_encode.cu",
                     "src/repro/kernels/hdc_encode.py:87", 0, 0.0, ms,
                     plain_ms, bound, by, None)
            rec = s.kernels["hdc_encode_wide"]
            per_step = hdc_logical_ops(hdc_count_bits(f), False)
            rec.update(kernel_route="32 count planes (F >= 2**16); level "
                                    "planes from global memory past 476 "
                                    "levels",
                       library_note="no single PyTorch call computes a "
                                    "signed gathered bundle",
                       shape={"q": [m, f], "dim": h, "levels": levels},
                       bound_basis=f"{per_step} LOP3 per (row, feature, "
                                   f"word) at 64 a clock per SM, "
                                   f"{hdc_count_bits(f)} count planes")
        if route != "bitsliced":
            s.kernels["hdc_encode_wide"]["launches"] += counts[want_key]
        else:
            s.record("hdc_encode", "src/repro_torch/kernels/csrc/hdc_encode.cu",
                     "src/repro/kernels/hdc_encode.py:87", counts[want_key],
                     0.0, None, None, None, "operations", None)
        out[name] = entry
        del item, x, enc, q
        torch.cuda.empty_cache()
    return out


def phase_queue_c(s: Smoke, data):
    """The repaired refusals on the card: C1 (k > MAX_K on the default
    backend: B6 or K1p, then K1s; eucl k = 500 and packed hamming k = 400
    at the KNN shape, and a 13-row micro-batch) and C3 (B5 at 65,536
    features, 512 levels and 2,100,000 rows), each part's launch counts
    set to 0 before it and read after it."""
    import torch
    parts = {}
    for name, run in (("eucl_k500", lambda: _queue_c_eucl(s, data)),
                      ("hamming_k400", lambda: _queue_c_packed(s, data)),
                      ("hdc", lambda: _queue_c_hdc(s))):
        t0 = time.perf_counter()
        parts[name] = run()
        parts[name]["part_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    log({"phase": "queue_c", "ok": True, **parts})


# ---------------------------------------------------------------------------
# lm_serve: LM serving of qwen2.5-14b through the port's Server (B7)
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# cam_serve: the single-device CAM search server, faults and hardening
# ---------------------------------------------------------------------------


def _serve_blocks(srv, q, requests=CAM_REQUESTS, rows=CAM_ROWS):
    """CAM_CLIENTS threads, each submitting ``requests`` blocks of
    ``rows`` consecutive rows of host queries ``q`` one after another.
    Returns the stacked (values, indices) in query order, each request's
    latency, and the wall seconds of the whole run."""
    import threading
    import numpy as np
    per = requests * rows
    if CAM_CLIENTS * per != q.shape[0]:
        raise RuntimeError(f"serve: {CAM_CLIENTS} x {per} rows do not "
                           f"cover the {q.shape[0]} queries")
    out, lat, errs = {}, [], []

    def client(c):
        try:
            for j in range(requests):
                s0 = c * per + j * rows
                res = srv.submit(q[s0:s0 + rows]).wait(CAM_WAIT_S)
                if res.error is not None:
                    raise res.error
                out[s0] = (res.values, res.indices)
                lat.append(res.latency_s)
        except Exception as e:      # noqa: BLE001 — reported below
            errs.append(e)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(CAM_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(CAM_WAIT_S)
    wall = time.perf_counter() - t0
    if errs or any(t.is_alive() for t in threads):
        raise RuntimeError(f"serve: a client failed or hung: {errs[:1]}")
    keys = sorted(out)
    return (np.concatenate([out[k][0] for k in keys]),
            np.concatenate([out[k][1] for k in keys]), lat, wall)


def _server_health(name, srv):
    """The server's snapshot; fails unless every batch was served by the
    primary (the degraded chain must never hide a failing kernel)."""
    h, snap = srv.health(), srv.snapshot()
    if h["degraded_batches"] or h["backend_errors"] or \
            h["breaker"]["state"] != "closed":
        raise RuntimeError(f"{name}: served degraded: {h}")
    return snap


def _latency_ms(lat):
    import numpy as np
    return {"p50": 1e3 * float(np.percentile(lat, 50)),
            "p99": 1e3 * float(np.percentile(lat, 99)),
            "max": 1e3 * max(lat), "requests": len(lat)}


def _snapshot_log(snap):
    keep = ("requests", "queries", "batches", "avg_batch_fill", "p50_ms",
            "p95_ms", "p99_ms", "queue_wait_p50_ms", "service_p50_ms",
            "dispatch_p50_ms", "dispatch_p95_ms", "dispatch_p99_ms",
            "gallery_updates", "rows_updated", "degraded_batches",
            "backend_errors")
    return {k: snap[k] for k in keep if k in snap}


def _cam_serve_knn(s: Smoke, data):
    """(a) the KNN eucl program served: B2."""
    import numpy as np
    import torch
    from repro_torch.core import ArchSpec, compile_fn
    from repro_torch.kernels import cam_search
    from repro_torch.serving import CamSearchServer
    g, _, q, _ = data
    gt = torch.from_numpy(g).cuda()
    prog = compile_fn(knn_kernel, [q, g], ArchSpec(rows=64, cols=64),
                      value_bits=8)
    plan = prog.engine_plan
    warm_ms, _ = host_ms(lambda: plan.warm(gt))
    cam_search.reset_launch_counts()
    with CamSearchServer(prog, gt, max_wait_ms=2.0) as srv:
        v, i, lat, wall = _serve_blocks(srv, q)
        snap = _server_health("cam_serve knn", srv)
    counts = dict(cam_search.LAUNCHES)
    if counts["fused_topk"] != snap["batches"]:
        raise RuntimeError(f"cam_serve knn: {snap['batches']} batches but "
                           f"launches {counts}")
    direct_ms, (dv, di) = host_ms(lambda: plan.execute(q, gt))
    if not (np.array_equal(v, dv.cpu().numpy())
            and np.array_equal(i, di.cpu().numpy())):
        raise RuntimeError("cam_serve knn: served results differ from the "
                           "plan's direct call")
    prev = s.topk.get("knn_eucl")
    if prev is not None and not (torch.equal(dv, prev[0])
                                 and torch.equal(di, prev[1])):
        raise RuntimeError("cam_serve knn: the direct call differs from "
                           "knn_eucl's")
    # a batch of the served size: the host's dispatch (no wait for the
    # device, so a hidden synchronise would show as host time near the
    # device time) against the device time of the batch's work
    rows = CAM_CLIENTS * CAM_ROWS
    dispatch_host_ms = host_ms_per_call(lambda: plan.dispatch(q[:rows], gt),
                                        20)
    batch_device_ms = cuda_ms(lambda: plan.finalize(plan.dispatch(
        q[:rows], gt)), 20)
    s.record("fused_topk", "src/repro_torch/kernels/csrc/fused_topk.cu",
             "src/repro/kernels/cam_search.py:200", counts["fused_topk"],
             0.0, None, None, None, "operations", None)
    return counts, {"launches": counts, "served_wall_ms": 1e3 * wall,
                    "batch_rows": rows,
                    "dispatch_host_ms": dispatch_host_ms,
                    "batch_device_ms": batch_device_ms,
                    "direct_wall_ms": direct_ms, "warm_ms": warm_ms,
                    "batches": snap["batches"],
                    "rows_per_batch": snap["avg_batch_fill"],
                    "latency_ms": _latency_ms(lat),
                    "snapshot": _snapshot_log(snap),
                    "bit_identical_to_direct": True}


def _packed_plan(data):
    """The hamming top-10 program of ``hamming_packed`` (packed) and the
    binarised KNN data on the card."""
    import torch
    import repro_torch.core as T
    from repro_torch.core import ArchSpec, compile_module
    from repro_torch.core import cim_dialect as cd
    g, _, q, _ = data
    gb = (torch.from_numpy(g).cuda() > 0).float()
    qb = (q > 0).astype("float32")
    prog = compile_module(hamming_module(T, cd, q.shape[0], g.shape[0],
                                         g.shape[1], 10, False),
                          ArchSpec(rows=64, cols=64), value_bits=1)
    if not prog.engine_plan.packed:
        raise RuntimeError("cam_serve: the hamming plan is not packed")
    return prog.engine_plan, qb, gb


def _cam_serve_faulted(s: Smoke, plan, qb, gb):
    """(b) a faulted packed hamming server: B1 on the corrupted gallery."""
    import numpy as np
    import torch
    from repro_torch.core.engine.executables import _cuda_operands
    from repro_torch.faults import FaultModel
    from repro_torch.kernels import cam_search, ops
    from repro_torch.serving import CamSearchServer
    fm = FaultModel(**CAM_SERVE_FAULTS)
    warm_ms, _ = host_ms(lambda: plan.warm(gb, faults=fm))
    cam_search.reset_launch_counts()
    qu = qb[:CAM_ROWS]
    with CamSearchServer(plan, gb, max_wait_ms=2.0, fault_model=fm) as srv:
        v, i, lat, wall = _serve_blocks(srv, qb)
        cells = srv.health()["fault_model"]["cells"]
        update = _faulted_update(srv, plan, qu)
        snap = _server_health("cam_serve faulted", srv)
        updated = srv.gallery
    counts = dict(cam_search.LAUNCHES)
    if counts["fused_topk_packed"] != snap["batches"]:
        raise RuntimeError(f"cam_serve faulted: {snap['batches']} batches "
                           f"but launches {counts}")
    want = tuple(x.cpu().numpy() for x in plan.execute(qu, updated,
                                                        faults=fm))
    for got in update.pop("results"):
        if not all(np.array_equal(g, w) for g, w in zip(got, want)):
            raise RuntimeError("cam_serve faulted: a search after the live "
                               "update differs from plan.execute(faults=) "
                               "on the updated gallery")
    del updated
    dv, di = (x.cpu().numpy() for x in plan.execute(qb, gb, faults=fm))
    if not (np.array_equal(v, dv) and np.array_equal(i, di)):
        raise RuntimeError("cam_serve faulted: served results differ from "
                           "plan.execute(faults=)")
    # B1's plain version on the host-corrupted gallery, merged as the
    # engine merges
    corrupt_ms, (bad,) = host_ms(lambda: fm.corrupt_stored(
        (gb.cpu().numpy(),), plan.spec))
    pp = plan._prepare(torch.from_numpy(bad).cuda())
    args, kw = _cuda_operands(plan.spec, True, torch.from_numpy(qb).cuda(),
                              pp)
    pv, pi = ops._merge(*cam_search.fused_topk_packed_reference(*args, **kw),
                        kw["k"], kw["largest"])
    if not (np.array_equal(v, pv.cpu().numpy())
            and np.array_equal(i, pi.cpu().numpy())):
        raise RuntimeError("cam_serve faulted: served results differ from "
                           "B1's plain version on the corrupted gallery")
    clean = plan.execute(qb, gb)
    null = plan.execute(qb, gb, faults=FaultModel(p_stuck=0))
    if not (torch.equal(clean[0], null[0]) and torch.equal(clean[1], null[1])):
        raise RuntimeError("cam_serve faulted: FaultModel(p_stuck=0) differs "
                           "from faults=None")
    changed = int((clean[1].cpu().numpy() != i).any(axis=1).sum())
    s.record("fused_topk_packed",
             "src/repro_torch/kernels/csrc/fused_topk_packed.cu",
             "src/repro/kernels/cam_search.py:304",
             counts["fused_topk_packed"], 0.0, None, None, None,
             "operations", None)
    return counts, {"launches": counts, "model": CAM_SERVE_FAULTS,
                    "cells": cells, "warm_ms": warm_ms,
                    "host_corruption_ms": corrupt_ms,
                    "served_wall_ms": 1e3 * wall,
                    "batches": snap["batches"],
                    "latency_ms": _latency_ms(lat),
                    "rows_changed_by_faults": changed,
                    "live_update": update,
                    "equal_to_plan_execute_faults": True,
                    "bit_identical_to_b1_plain_on_corrupted": True,
                    "null_model_bit_identical": True}


def _faulted_update(srv, plan, qu):
    """One live ``update_gallery`` of 1 % of the rows on the faulted
    server, then two searches of ``qu``.  The engine's row update
    rewrites only the clean layout, so the first batch after it corrupts
    and prepares the whole gallery again, inside its dispatch and under
    the gallery's read lock: its latency is the stall every client sees.
    The second batch hits the memo."""
    import numpy as np
    n, dim = plan.spec.n, plan.spec.dim
    rng = np.random.default_rng(CAM_SERVE_FAULTS["seed"])
    rows = np.sort(rng.choice(n, int(CAM_UPDATE_FRAC * n), replace=False))
    new = (rng.random((rows.size, dim)) > 0.5).astype(np.float32)
    fb0 = plan.row_update_fallbacks
    update_ms, _ = host_ms(lambda: srv.update_gallery(rows, new))
    first_ms, first = host_ms(lambda: srv.search(qu, timeout=CAM_WAIT_S))
    next_ms, nxt = host_ms(lambda: srv.search(qu, timeout=CAM_WAIT_S))
    return {"rows": int(rows.size), "update_ms": update_ms,
            "first_search_ms": first_ms, "next_search_ms": next_ms,
            "row_update_fallbacks": plan.row_update_fallbacks - fb0,
            "results": [first, nxt]}


def _cam_serve_hardened(s: Smoke, plan, qb, gb):
    """(c) ``HardenedPlan`` search: 3 replicas of the binarised gallery
    (B1 on its int8 "mma" route at k' = 30), top-k agreement with the
    clean result against the raw faulted plan."""
    import dataclasses
    import numpy as np
    from repro_torch.core.engine import get_plan, module_for_spec
    from repro_torch.faults import FaultModel, HardenedPlan
    from repro_torch.kernels import cam_search
    t_part = time.perf_counter()
    reduced = None
    if CAM_HARDEN_ROWS is not None:        # the cut, where one was needed
        reduced = {"gallery_rows": [CAM_HARDEN_ROWS, int(plan.spec.n)]}
        plan = get_plan(module_for_spec(dataclasses.replace(
            plan.spec, n=CAM_HARDEN_ROWS)), backend=plan.backend,
            pack=plan.packed)
        gb = gb[:CAM_HARDEN_ROWS].contiguous()
    k = plan.spec.k
    hp = HardenedPlan(plan, replicas=CAM_HARDEN_REPLICAS, spares=0)
    route = cam_search.packed_route(
        qb.shape[0], -(-hp.n_phys // 128) * 128, hp.plan.spec.k,
        s.props.multi_processor_count)
    if route != "mma" or hp.plan.spec.k != CAM_HARDEN_REPLICAS * k:
        raise RuntimeError(f"cam_serve hardened: k'={hp.plan.spec.k} takes "
                           f"B1's {route!r} route")
    prep_ms, _ = host_ms(lambda: hp.prepare(gb))
    corrupt_ms, _ = host_ms(lambda: FaultModel(
        seed=0, **CAM_HARDEN_FAULTS).corrupt_stored(hp._clean, hp.phys_spec))
    one = HardenedPlan(plan, replicas=1, spares=0)
    one.prepare(gb)
    cam_search.reset_launch_counts()
    clean = tuple(x.cpu().numpy() for x in plan.execute(qb, gb))
    got1 = one.execute(qb)
    raw_scores, rep_scores, seed_ms = [], [], []

    def agree(a):
        return float(np.mean([len(set(a[r]) & set(clean[1][r])) / k
                              for r in range(a.shape[0])]))

    for seed in CAM_HARDEN_SEEDS:
        fm = FaultModel(seed=seed, **CAM_HARDEN_FAULTS)
        t0 = time.perf_counter()
        raw = plan.execute(qb, gb, faults=fm)[1].cpu().numpy()
        t1 = time.perf_counter()
        _, rep_i = hp.execute(qb, faults=fm)
        seed_ms.append({"raw_execute_ms": 1e3 * (t1 - t0),
                        "hardened_execute_ms":
                            1e3 * (time.perf_counter() - t1)})
        raw_scores.append(agree(raw))
        rep_scores.append(agree(rep_i))
    counts = dict(cam_search.LAUNCHES)
    if counts["fused_topk_packed"] < 1:
        raise RuntimeError(f"cam_serve hardened: B1 not launched: {counts}")
    if not (np.array_equal(got1[0], clean[0])
            and np.array_equal(got1[1], clean[1])):
        raise RuntimeError("cam_serve hardened: one replica differs from "
                           "the raw plan")
    if not np.mean(rep_scores) > np.mean(raw_scores):
        raise RuntimeError(f"cam_serve hardened: agreement {rep_scores} not "
                           f"above the raw plan's {raw_scores}")
    s.record("fused_topk_packed",
             "src/repro_torch/kernels/csrc/fused_topk_packed.cu",
             "src/repro/kernels/cam_search.py:304",
             counts["fused_topk_packed"], 0.0, None, None, None,
             "operations", None)
    out = {"launches": counts, "replicas": CAM_HARDEN_REPLICAS,
           "n_phys": hp.n_phys, "k_phys": hp.plan.spec.k, "b1_route": route,
           "prepare_ms": prep_ms, "host_corruption_ms": corrupt_ms,
           "per_seed_ms": seed_ms,
           "agreement_raw": raw_scores, "agreement_hardened": rep_scores,
           "replicas_1_bit_identical": True,
           "part_s": time.perf_counter() - t_part}
    if reduced is not None:
        out["reduced"] = reduced
    del hp, one
    return counts, out


def _cam_serve_forest(s: Smoke):
    """(d) the forest's interval rows served (B3), a live update of 1 % of
    them racing 4 clients, and ``HardenedPlan.heal`` on the intervals."""
    import threading
    import numpy as np
    import torch
    from repro_torch.core import ArchSpec, CamType, clear_plan_cache
    from repro_torch.core.engine import get_plan, module_for_spec
    from repro_torch.faults import FaultModel, HardenedPlan
    from repro_torch.forest import CamForestClassifier, random_forest
    from repro_torch.kernels import cam_search
    from repro_torch.serving import CamSearchServer
    trees = random_forest(np.random.default_rng(7), **FOREST)
    clf = CamForestClassifier(trees, dim=FOREST["dim"]).compile(
        ArchSpec(rows=64, cols=64, cam_type=CamType.ACAM),
        batch_hint=FOREST_QUERIES)
    plan = clf.plan
    n, dim = clf._lo.shape
    x = np.random.default_rng(8).standard_normal(
        (FOREST_QUERIES, FOREST["dim"])).astype(np.float32)
    rng = np.random.default_rng(9)
    rows = np.sort(rng.choice(n, int(CAM_UPDATE_FRAC * n), replace=False))
    new_lo = np.full((rows.size, dim), -np.inf, np.float32)   # wildcards:
    new_hi = np.full((rows.size, dim), np.inf, np.float32)    # match all
    # the comparisons' match matrices: the clean intervals, and the new
    # ones through a fresh plan (a full prepare), before the counted run
    old = plan.execute(x, clf._lo, clf._hi).cpu().numpy()
    lo2, hi2 = clf._lo.clone(), clf._hi.clone()
    ridx = torch.from_numpy(rows).cuda()
    lo2[ridx] = torch.from_numpy(new_lo).cuda()
    hi2[ridx] = torch.from_numpy(new_hi).cuda()
    clear_plan_cache()
    fresh = get_plan(module_for_spec(plan.spec), backend=plan.backend)
    if fresh is plan:
        raise RuntimeError("cam_serve forest: no fresh plan")
    new = fresh.execute(x, lo2, hi2).cpu().numpy()
    del fresh, lo2, hi2
    old_r, new_r = old[:CAM_RACE_ROWS], new[:CAM_RACE_ROWS]
    if np.array_equal(old_r, new_r):
        raise RuntimeError("cam_serve forest: the update is invisible")
    xr = x[:CAM_RACE_ROWS]
    seen, errs = [], []
    stop = threading.Event()

    def racer():
        try:
            while not stop.is_set():
                got = srv.match(xr, timeout=CAM_WAIT_S)
                seen.append("old" if np.array_equal(got, old_r) else
                            "new" if np.array_equal(got, new_r) else "torn")
        except Exception as e:          # noqa: BLE001 — reported below
            errs.append(e)

    cam_search.reset_launch_counts()
    with CamSearchServer(plan, (clf._lo.clone(), clf._hi.clone()),
                         max_wait_ms=2.0) as srv:
        match_ms, before = host_ms(lambda: srv.match(x, timeout=CAM_WAIT_S))
        threads = [threading.Thread(target=racer) for _ in range(CAM_RACERS)]
        for t in threads:
            t.start()
        deadline = time.perf_counter() + CAM_WAIT_S
        while len(seen) < CAM_RACERS and not errs and \
                time.perf_counter() < deadline:
            time.sleep(0.001)
        update_ms, _ = host_ms(lambda: srv.update_gallery(
            rows, (new_lo, new_hi)))
        n_before = len(seen)
        while "new" not in seen[n_before:] and not errs and \
                time.perf_counter() < deadline:
            time.sleep(0.001)
        stop.set()
        for t in threads:
            t.join(CAM_WAIT_S)
        after = srv.match(x, timeout=CAM_WAIT_S)
        snap = _server_health("cam_serve forest", srv)
    if errs or any(t.is_alive() for t in threads):
        raise RuntimeError(f"cam_serve forest: a racer failed: {errs[:1]}")
    served_counts = dict(cam_search.LAUNCHES)
    # heal the clean intervals onto spares, then run under the model
    cam_search.reset_launch_counts()
    hp = HardenedPlan(plan, replicas=CAM_HEAL_REPLICAS,
                      spares=CAM_HEAL_SPARES)
    prep_ms, _ = host_ms(lambda: hp.prepare(clf._lo, clf._hi))
    fm = FaultModel(**CAM_HEAL_FAULTS)
    heal_ms, report = host_ms(lambda: hp.heal(fm))
    healed_ms, healed = host_ms(lambda: hp.execute(x, faults=fm))
    heal_counts = dict(cam_search.LAUNCHES)
    counts = {k: served_counts[k] + heal_counts[k] for k in served_counts}
    if served_counts["acam_match"] != snap["batches"] or \
            heal_counts["acam_match"] < 1:
        raise RuntimeError(f"cam_serve forest: launches {served_counts} "
                           f"{heal_counts}, batches {snap['batches']}")
    if not np.array_equal(before, old):
        raise RuntimeError("cam_serve forest: served matches differ from "
                           "the plan's direct call")
    if not np.array_equal(after, new):
        raise RuntimeError("cam_serve forest: matches after the update "
                           "differ from a fresh plan's on the new intervals")
    n_old, n_new = seen.count("old"), seen.count("new")
    if n_old + n_new != len(seen) or not n_old or not n_new:
        raise RuntimeError(f"cam_serve forest: {len(seen)} racing matches, "
                           f"{n_old} old, {n_new} new: a torn update or an "
                           f"unraced one")
    if not (report.detected > 0 and report.remapped > 0):
        raise RuntimeError(f"cam_serve forest: heal found nothing: {report}")
    healed_equal = None
    if report.unrepairable == 0:
        healed_equal = bool(np.array_equal(healed, old))
        if not healed_equal:
            raise RuntimeError("cam_serve forest: the healed plan under the "
                               "model differs from the clean match matrix")
    s.record("acam_match", "src/repro_torch/kernels/csrc/acam_match.cu",
             "src/repro/kernels/acam.py:121", counts["acam_match"], 0.0,
             None, None, None, "operations", None)
    return counts, {
        "launches": counts, "rows": int(n), "queries": FOREST_QUERIES,
        "match_ms": match_ms, "update_rows": int(rows.size),
        "update_ms": update_ms, "racing_matches": len(seen),
        "racing_old": n_old, "racing_new": n_new,
        "after_update_bit_identical_to_fresh_plan": True,
        "snapshot": _snapshot_log(snap),
        "heal": {"replicas": CAM_HEAL_REPLICAS, "spares": CAM_HEAL_SPARES,
                 "model": CAM_HEAL_FAULTS, "n_phys": hp.n_phys,
                 "report": dict(vars(report)), "prepare_ms": prep_ms,
                 "heal_ms": heal_ms, "execute_ms": healed_ms,
                 "healed_equal_to_clean": healed_equal,
                 "b3_launches": heal_counts["acam_match"]}}


def _cam_serve_hdc(s: Smoke):
    """(e) HDC/MNIST-8k retrained through a live server: B5 encodes, B1
    searches, ``update_gallery`` pushes the rows; equal to offline."""
    import numpy as np
    import torch
    from repro_torch.data import hdc_mnist_dataset
    from repro_torch.hdc import HdcClassifier
    from repro_torch.kernels import cam_search
    from repro_torch.serving import CamSearchServer
    xtr_np, ytr, xte_np, yte = hdc_mnist_dataset(**HDC_MNIST)
    xtr, xte = torch.from_numpy(xtr_np).cuda(), torch.from_numpy(xte_np).cuda()

    def classifier():
        return HdcClassifier(xtr.shape[1], HDC_CLASSES, dim=HDC_DIM,
                             n_levels=HDC_LEVELS, seed=0)

    served = classifier()
    cam_search.reset_launch_counts()
    enc_tr, enc_te = served.encode(xtr), served.encode(xte)
    served.fit(y=ytr, encoded=enc_tr).compile(batch_hint=1024)
    epochs = []
    with CamSearchServer(served.plan, served.gallery,
                         max_wait_ms=1.0) as srv:
        for _ in range(HDC_EPOCHS):
            ms, (acc, pushed) = host_ms(lambda: served.retrain_epoch(
                encoded=enc_tr, y=ytr, server=srv))
            epochs.append({"train_accuracy_before": acc,
                           "rows_pushed": pushed, "epoch_ms": ms})
        _, idx = srv.search(enc_te, timeout=CAM_WAIT_S)
        snap = _server_health("cam_serve hdc", srv)
    counts = dict(cam_search.LAUNCHES)
    if counts["hdc_encode"] != 2 or counts["fused_topk_packed"] < 1:
        raise RuntimeError(f"cam_serve hdc: launches {counts}")
    offline = classifier()
    offline.fit(y=ytr, encoded=enc_tr).compile(batch_hint=1024)
    want = [offline.retrain_epoch(encoded=enc_tr, y=ytr)
            for _ in range(HDC_EPOCHS)]
    pred = offline.predict(encoded=enc_te).cpu().numpy()
    if [(e["train_accuracy_before"], e["rows_pushed"]) for e in epochs] \
            != want:
        raise RuntimeError(f"cam_serve hdc: served epochs {epochs} differ "
                           f"from offline {want}")
    if not torch.equal(served.class_sums, offline.class_sums):
        raise RuntimeError("cam_serve hdc: class sums differ from offline")
    if not np.array_equal(idx[:, 0].astype(np.int32), pred):
        raise RuntimeError("cam_serve hdc: test predictions differ from "
                           "offline")
    if snap["plan"]["row_update_fallbacks"] or \
            sum(e["rows_pushed"] for e in epochs) == 0:
        raise RuntimeError(f"cam_serve hdc: updates {snap['plan']}, "
                           f"epochs {epochs}")
    s.record("hdc_encode", "src/repro_torch/kernels/csrc/hdc_encode.cu",
             "src/repro/kernels/hdc_encode.py:87", counts["hdc_encode"], 0.0,
             None, None, None, "operations", None)
    s.record("fused_topk_packed",
             "src/repro_torch/kernels/csrc/fused_topk_packed.cu",
             "src/repro/kernels/cam_search.py:304",
             counts["fused_topk_packed"], 0.0, None, None, None,
             "operations", None)
    return counts, {"launches": counts, "epochs": epochs,
                    "test_accuracy": float((pred == yte).mean()),
                    "snapshot": _snapshot_log(snap),
                    "row_update_fallbacks": 0,
                    "class_sums_equal_offline": True,
                    "predictions_equal_offline": True}


def phase_cam_serve(s: Smoke, data):
    """The serving slice: the KNN eucl program served to concurrent
    clients (B2), a faulted packed hamming server (B1), hardened search
    (B1), the forest's intervals served with a live update and healed
    (B3), and HDC retrained against the server (B5, B1).  Each part sets
    the launch counts to 0 before its path and reads them after it."""
    import torch
    parts = {}
    t0 = time.perf_counter()
    _, parts["knn"] = _cam_serve_knn(s, data)
    parts["knn"]["part_s"] = time.perf_counter() - t0
    plan, qb, gb = _packed_plan(data)
    t0 = time.perf_counter()
    _, parts["faulted"] = _cam_serve_faulted(s, plan, qb, gb)
    parts["faulted"]["part_s"] = time.perf_counter() - t0
    _, parts["hardened"] = _cam_serve_hardened(s, plan, qb, gb)
    del gb
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _, parts["forest"] = _cam_serve_forest(s)
    parts["forest"]["part_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _, parts["hdc"] = _cam_serve_hdc(s)
    parts["hdc"]["part_s"] = time.perf_counter() - t0
    log({"phase": "cam_serve", "ok": True, **parts})


def clustered_gallery(rng, n, dim, centers, flip=HIER_FLIP):
    """Binary rows drawn around ``centers`` prototypes, as
    ``benchmarks/bench_hier.py::_clustered_gallery`` draws them (that
    module imports JAX, so the smoke keeps its own copy)."""
    protos = (rng.random((centers, dim)) > 0.5)
    owner = rng.integers(centers, size=n)
    rows = protos[owner] ^ (rng.random((n, dim)) < flip)
    return rows.astype("float32")


def _hier_fresh(plan, hs, gallery, assign):
    """Results source for "a fresh plan with the same centroids": the
    state a full layout builds for ``assign`` with ``hs``'s centroids."""
    from repro_torch.core.engine import hier
    return hier._hier_state(plan.spec, plan.packed, gallery, hs.centroid_src,
                            hs.coarse_prepared, assign)


def _recall(got_i, want_i, k):
    got, want = got_i.cpu().numpy(), want_i.cpu().numpy()
    return float(sum(len(set(map(int, a)) & set(map(int, b)))
                     for a, b in zip(got, want)) / (k * want.shape[0]))


def _wall_ms(call):
    """Median host ms of ``call`` to a synchronise, after one warm call."""
    import torch
    call()
    times = []
    for _ in range(HIER_TIMED_CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def _stage_ms(plan, q, g):
    """The ``hier.coarse`` / ``hier.probe`` spans of one traced call (each
    stage waits for its device work while tracing)."""
    import torch
    from repro_torch.obs import trace
    trace.tracer.clear()
    trace.enable()
    try:
        plan.execute(q, g)
        torch.cuda.synchronize()
    finally:
        trace.stop()
    st = trace.span_stats()
    trace.tracer.clear()
    return {k: st[span]["total_ms"] for k, span in
            (("coarse_ms", "hier.coarse"), ("probe_ms", "hier.probe"))
            if span in st}


def _probe_bound(plan, q, hs):
    """The probe's least time: the bytes of the tiles this run's queries
    probe (each query's occupied tiles of its nprobe clusters, read once)
    over the card's memory rate."""
    _, ci = plan.coarse._chunk_fn(q, hs.coarse_prepared)
    tiles = int(hs.cnt[ci.long()].sum())
    leaf = hs.leaves[0]
    tile_bytes = leaf[0].numel() * leaf.element_size()
    return {"probed_tiles": tiles, "tile_bytes": tile_bytes,
            "bound_ms": 1e3 * tiles * tile_bytes / HBM_BYTES_PER_S,
            "bound_by": "bytes"}


def _hier_kernels_idle(name):
    """Fail if the hierarchical plan launched a hand-written kernel: it
    runs the "torch" backend (its twin of the reference's "jnp")."""
    from repro_torch.kernels import cam_search
    if any(cam_search.LAUNCHES.values()):
        raise RuntimeError(f"{name}: the hierarchical path launched "
                           f"kernels: {dict(cam_search.LAUNCHES)}")


def _hier_bench(s: Smoke):
    """(a) the reference's hierarchical benchmark geometry: packed hamming
    over a clustered 131,072 x 256 gallery, flat B1 as the oracle."""
    import numpy as np
    import torch
    import repro_torch.core as T
    from repro_torch.core import ArchSpec, compile_module
    from repro_torch.core import cim_dialect as cd
    from repro_torch.core.engine import get_hierarchical_plan, hier
    from repro_torch.kernels import cam_search
    rng = np.random.default_rng(0)
    g = clustered_gallery(rng, HIER_N, HIER_DIM, HIER_CENTERS)
    qi = rng.choice(HIER_N, size=HIER_QUERIES, replace=False)
    q = (g[qi].astype(bool)
         ^ (rng.random((HIER_QUERIES, HIER_DIM)) < HIER_FLIP)) \
        .astype(np.float32)
    gt, qt = torch.from_numpy(g).cuda(), torch.from_numpy(q).cuda()
    prog = compile_module(hamming_module(T, cd, HIER_QUERIES, HIER_N,
                                         HIER_DIM, HIER_K, False),
                          ArchSpec(rows=128, cols=128), value_bits=1)
    flat, mod = prog.engine_plan, prog.stages["cim_partitioned"]
    if not flat.packed or flat.backend != "cuda":
        raise RuntimeError("hier_search: the flat plan is not packed B1")
    cam_search.reset_launch_counts()
    fv, fi = flat.execute(qt, gt)                     # the flat oracle
    oracle = cam_search.LAUNCHES["fused_topk_packed"]
    tv, ti = T.get_plan(mod, backend="torch").execute(qt, gt)
    if not (torch.equal(fv, tv) and torch.equal(fi, ti)):
        raise RuntimeError("hier_search: flat B1 != flat torch")
    flat_ms = _wall_ms(lambda: flat.execute(qt, gt))
    out = {"oracle_launches": {"fused_topk_packed": oracle},
           "flat_b1_wall_ms": flat_ms,
           "flat_profile": s.profile(flat.execute, [qt, gt]), "nprobe": {}}
    plans = {}
    for nprobe in HIER_NPROBES + (HIER_CLUSTERS,):
        plan = get_hierarchical_plan(mod, clusters=HIER_CLUSTERS,
                                     nprobe=nprobe, kmeans_iters=HIER_ITERS)
        plans[nprobe] = plan
        cam_search.reset_launch_counts()
        prep_ms, _ = host_ms(lambda: plan.warm(gt))
        hs = plan._prepared_patterns(gt)
        v, i = plan.execute(qt, gt)
        torch.cuda.synchronize()
        _hier_kernels_idle(f"hier_search nprobe={nprobe}")
        rec = {"prepare_s": prep_ms / 1e3, "budget": hs.budget,
               "tpc": hs.tpc, "recall": _recall(i, fi, HIER_K)}
        if nprobe == HIER_CLUSTERS:
            if not (torch.equal(v, fv) and torch.equal(i, fi)):
                raise RuntimeError("hier_search: nprobe = clusters is not "
                                   "bit-identical to flat B1")
            rec["bit_identical_to_flat_b1_and_torch"] = True
        rec["wall_ms"] = _wall_ms(lambda: plan.execute(qt, gt))
        rec["stages"] = _stage_ms(plan, qt, gt)
        rec["profile"] = s.profile(plan.execute, [qt, gt])
        rec["probe_bound"] = _probe_bound(plan, qt, hs)
        out["nprobe"][nprobe] = rec
    recalls = [out["nprobe"][n]["recall"] for n in HIER_NPROBES] + [1.0]
    if any(a > b for a, b in zip(recalls, recalls[1:])) or \
            out["nprobe"][HIER_CLUSTERS]["recall"] != 1.0:
        raise RuntimeError(f"hier_search: recall not monotone: {recalls}")
    cents = [plans[n]._prepared_patterns(gt).centroid_src for n in plans]
    if not all(torch.equal(c, cents[0]) for c in cents):
        raise RuntimeError("hier_search: one seed gave different centroids")

    # (c) served: the nprobe-8 plan behind a CamSearchServer, 8 clients
    plan = plans[HIER_SERVE_NPROBE]
    from repro_torch.serving import CamSearchServer
    cam_search.reset_launch_counts()
    dv, di = plan.execute(qt, gt)
    with CamSearchServer(plan, gt, max_wait_ms=2.0) as srv:
        sv, si, lat, wall = _serve_blocks(srv, q, HIER_SERVE_REQUESTS,
                                          HIER_SERVE_ROWS)
        snap = _server_health("hier_search served", srv)
        if [name for name, _ in srv._levels()] != ["primary"]:
            raise RuntimeError("hier_search: a server on the card has a "
                               "degraded level below its primary")
    if not (np.array_equal(sv, dv.cpu().numpy())
            and np.array_equal(si, di.cpu().numpy())):
        raise RuntimeError("hier_search: served results differ from the "
                           "plan's direct call")
    out["served"] = {"nprobe": HIER_SERVE_NPROBE,
                     "served_wall_ms": 1e3 * wall,
                     "batches": snap["batches"],
                     "rows_per_batch": snap["avg_batch_fill"],
                     "latency_ms": _latency_ms(lat),
                     "snapshot": _snapshot_log(snap),
                     "bit_identical_to_direct": True}

    # the row update: 1 % of the rows, reassigned to the stored centroids
    rs = np.random.default_rng(21)
    n_upd = int(round(HIER_UPDATE_FRAC * HIER_N))
    idx = np.sort(rs.choice(HIER_N, size=n_upd, replace=False))
    src = rs.choice(HIER_N, size=n_upd, replace=False)
    new = (g[src].astype(bool)
           ^ (rs.random((n_upd, HIER_DIM)) < HIER_FLIP)).astype(np.float32)
    hs0 = plan._prepared_patterns(gt)
    fb = plan.row_update_fallbacks
    upd_ms, g2 = host_ms(lambda: plan.update_rows(gt, idx, new))
    hs1 = plan._prepared_patterns(g2)
    want_a = hs0.assign.copy()
    want_a[idx] = hier._assign_rows(torch.from_numpy(new).cuda(),
                                    hs0.centroid_src, "hamming")
    fresh = _hier_fresh(plan, hs0, g2, want_a)
    got = plan.execute(qt, g2)
    want = plan._chunk_fn(qt, fresh)
    if plan.row_update_fallbacks != fb or \
            not np.array_equal(hs1.assign, want_a) or \
            not (torch.equal(got[0], want[0])
                 and torch.equal(got[1], want[1])):
        raise RuntimeError("hier_search: the row update differs from a "
                           "fresh layout with the same centroids")
    moved = int((hs1.assign != hs0.assign).sum())
    # ... then rows copied from one row, past its cluster's capacity
    idx2 = np.arange(HIER_OVERFLOW_ROWS)
    new2 = np.tile(g[HIER_N - 1], (HIER_OVERFLOW_ROWS, 1))
    ovf_ms, g3 = host_ms(lambda: plan.update_rows(g2, idx2, new2))
    hs2 = plan._prepared_patterns(g3)
    want_a[idx2] = hier._assign_rows(torch.from_numpy(new2).cuda(),
                                     hs0.centroid_src, "hamming")
    got = plan.execute(qt, g3)
    want = plan._chunk_fn(qt, _hier_fresh(plan, hs0, g3, want_a))
    if hs2.tpc <= hs1.tpc or hs2.centroid_src is not hs0.centroid_src or \
            plan.row_update_fallbacks != fb or \
            not (torch.equal(got[0], want[0])
                 and torch.equal(got[1], want[1])):
        raise RuntimeError("hier_search: the overflow re-layout differs "
                           "from a fresh layout with the same centroids")
    _hier_kernels_idle("hier_search served and updated")
    out["update"] = {"rows": n_upd, "moved_rows": moved,
                     "update_ms": upd_ms, "budget_after": hs1.budget,
                     "equal_to_fresh_layout": True,
                     "overflow_rows": HIER_OVERFLOW_ROWS,
                     "overflow_ms": ovf_ms, "tpc": [hs1.tpc, hs2.tpc],
                     "overflow_equal_to_fresh_layout": True,
                     "row_update_fallbacks": plan.row_update_fallbacks - fb}
    return out


def _hier_eucl(s: Smoke, data):
    """(b) eucl at the KNN shape against flat B2: default clusters,
    nprobe = clusters // 8 and nprobe = clusters."""
    import torch
    from repro_torch.core import ArchSpec, compile_fn
    from repro_torch.core.engine import get_hierarchical_plan
    from repro_torch.kernels import cam_search
    g, _, q, _ = data
    gt, qt = torch.from_numpy(g).cuda(), torch.from_numpy(q).cuda()
    prog = compile_fn(knn_kernel, [q, g], ArchSpec(rows=64, cols=64),
                      value_bits=8)
    flat, mod = prog.engine_plan, prog.stages["cim_partitioned"]
    cam_search.reset_launch_counts()
    fv, fi = flat.execute(qt, gt)                     # the flat oracle
    out = {"oracle_launches": {"fused_topk": cam_search.LAUNCHES[
        "fused_topk"]},
           "flat_b2_wall_ms": _wall_ms(lambda: flat.execute(qt, gt))}
    full = get_hierarchical_plan(mod, nprobe=10 ** 9)
    clusters = full.spec.clusters
    part = get_hierarchical_plan(mod, nprobe=clusters // 8)
    out.update(clusters=clusters, reduced=[])
    cam_search.reset_launch_counts()
    prep_ms, _ = host_ms(lambda: part.warm(gt))
    hs = part._prepared_patterns(gt)
    again = part._prepare(gt)             # a second prepare of one gallery
    if not (torch.equal(again.centroid_src, hs.centroid_src)
            and (again.assign == hs.assign).all()):
        raise RuntimeError("hier_search: two prepares of the KNN gallery "
                           "gave different centroids")
    del again
    sizes = torch.bincount(torch.from_numpy(hs.assign).long(),
                           minlength=clusters)
    for name, plan in (("partial", part), ("all", full)):
        if plan is full:
            plan.warm(gt)
        t_ms, (v, i) = host_ms(lambda: plan.execute(qt, gt))
        _hier_kernels_idle(f"hier_search eucl {name}")
        st = plan._prepared_patterns(gt)
        qw = qt
        if t_ms > 1e3 * HIER_EUCL_LIMIT_S:        # time the cut queries
            qw = qt[:HIER_EUCL_CUT_ROWS]
            out["reduced"].append(f"{name}: timed on {HIER_EUCL_CUT_ROWS} "
                                  f"of {qt.shape[0]} queries (one call of "
                                  f"all took {t_ms / 1e3:.1f} s)")
        rec = {"nprobe": plan.spec.nprobe, "first_call_ms": t_ms,
               "budget": st.budget, "tpc": st.tpc,
               "recall": _recall(i, fi, 5), "timed_rows": qw.shape[0],
               "wall_ms": _wall_ms(lambda: plan.execute(qw, gt)),
               "stages": _stage_ms(plan, qw, gt),
               "probe_bound": _probe_bound(plan, qw, st)}
        if plan is full:
            off = (v - fv).abs()
            if not bool((off <= EUCL_ATOL + EUCL_RTOL * fv.abs()).all()):
                raise RuntimeError(f"hier_search: eucl off flat B2 by "
                                   f"{float(off.max())}")
            rec["max_abs_err_vs_flat_b2"] = float(off.max())
            rec["eucl_index_swaps"] = eucl_index_swaps(
                qt, gt, i, fi, "hier_search eucl nprobe = clusters")
        out[name] = rec
    out.update(prepare_s=prep_ms / 1e3, centroids_repeat=True,
               cluster_rows={"max": int(sizes.max()),
                             "mean": float(sizes.float().mean()),
                             "empty": int((sizes == 0).sum())})
    return out


def phase_hier_search(s: Smoke, data):
    """The hierarchical two-stage search on the "torch" backend (no
    hand-written kernel on its path): (a) the reference's benchmark
    geometry against flat B1, with (c) the served nprobe-8 plan and the
    row updates; (b) eucl at the KNN shape against flat B2.  B1 and B2
    launch only as the flat oracles (counted from 0 around each oracle
    call), and every hierarchical call is checked to launch no kernel."""
    import torch
    parts = {}
    t0 = time.perf_counter()
    parts["bench"] = _hier_bench(s)
    parts["bench"]["part_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    parts["eucl"] = _hier_eucl(s, data)
    parts["eucl"]["part_s"] = time.perf_counter() - t0
    s.record("fused_topk_packed",
             "src/repro_torch/kernels/csrc/fused_topk_packed.cu",
             "src/repro/kernels/cam_search.py:304",
             parts["bench"]["oracle_launches"]["fused_topk_packed"], 0.0,
             None, None, None, "operations", None)
    s.record("fused_topk", "src/repro_torch/kernels/csrc/fused_topk.cu",
             "src/repro/kernels/cam_search.py:200",
             parts["eucl"]["oracle_launches"]["fused_topk"], 0.0, None,
             None, None, "operations", None)
    log({"phase": "hier_search", "ok": True, **parts})


# ---------------------------------------------------------------------------
# sharded: shard counts clamp; 4 shards on cuda:0 stand-ins
# ---------------------------------------------------------------------------


def _sharded_pair(name, one, sh, qt, gt, integer):
    """One unsharded and one sharded ``"torch"`` plan on the same inputs:
    no hand-written kernel may launch, and the results must agree
    (bit for bit on an integer metric; eucl within the tolerance with
    index swaps only at float64 near-ties, reported).  Returns the
    sharded result and its timings."""
    import torch
    from repro_torch.kernels import cam_search
    cam_search.reset_launch_counts()
    one_ms, a = host_ms(lambda: one.execute(qt, gt))
    sh_ms, b = host_ms(lambda: sh.execute(qt, gt))
    if any(cam_search.LAUNCHES.values()):
        raise RuntimeError(f"sharded {name}: the torch backend launched "
                           f"kernels: {dict(cam_search.LAUNCHES)}")
    out = {"unsharded_ms": one_ms, "sharded_ms": sh_ms}
    if integer:
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
            raise RuntimeError(f"sharded {name}: 4 shards differ from the "
                               f"unsharded plan")
        out["bit_identical_to_unsharded"] = True
    else:
        tol = EUCL_ATOL + EUCL_RTOL * a[0].abs()
        if not bool(((a[0] - b[0]).abs() <= tol).all()):
            raise RuntimeError(f"sharded {name}: values off the unsharded "
                               f"plan by {float((a[0] - b[0]).abs().max())}")
        out["index_swaps_float64_near_ties"] = eucl_index_swaps(
            qt, gt, b[1], a[1], f"sharded {name}")
        out["values_bit_identical"] = bool(torch.equal(a[0], b[0]))
    return b, out


def phase_sharded(s: Smoke, data):
    """Sharded plans on the card: ``shards=8`` clamps to this host's
    device count; the ``"cuda"`` backend refuses sharding; through the
    mesh test hook (``launch.mesh.forced_devices(4, "cuda:0")``) 4-shard
    ``"torch"`` plans at the KNN shape (packed hamming, also held to flat
    B1, with a sharded 1 % ``update_rows``; eucl) and a 4-shard
    hierarchical plan at ``bench_hier``'s geometry, each against its
    unsharded plan.  No hand-written kernel is on these paths: B1 runs
    only as the flat oracle."""
    import numpy as np
    import torch
    import repro_torch.core as T
    from repro_torch.core import ArchSpec, compile_fn, compile_module
    from repro_torch.core import cim_dialect as cd
    from repro_torch.core.engine import get_hierarchical_plan, get_plan
    from repro_torch.launch.mesh import forced_devices
    g, _, q, _ = data
    out = {"device_count": torch.cuda.device_count()}
    gb = (torch.from_numpy(g).cuda() > 0).float()
    qb = (torch.from_numpy(q).cuda() > 0).float()
    mod = hamming_module(T, cd, q.shape[0], g.shape[0], g.shape[1], 10,
                         False)
    prog = compile_module(mod, ArchSpec(rows=64, cols=64), value_bits=1)
    mod = prog.stages["cim_partitioned"]
    clamped = get_plan(mod, backend="torch", shards=8)
    if clamped.shards != torch.cuda.device_count() or (
            clamped.shards == 1 and clamped is not get_plan(
                mod, backend="torch")):
        raise RuntimeError(f"sharded: shards=8 gave {clamped.shards} on a "
                           f"{torch.cuda.device_count()}-card host")
    try:
        get_plan(mod, backend="cuda", shards=8)
    except ValueError as e:
        if "'torch'" not in str(e):
            raise
    else:
        raise RuntimeError("sharded: the cuda backend took shards=8")
    out["clamp"] = {"requested": 8, "plan_shards": clamped.shards,
                    "cuda_backend_refused": True}

    # packed hamming, 4 shards on cuda:0 stand-ins
    t0 = time.perf_counter()
    one = get_plan(mod, backend="torch")
    with forced_devices(SHARDS, "cuda:0"):
        sh = get_plan(mod, backend="torch", shards=SHARDS)
    if sh.shards != SHARDS or not sh.packed:
        raise RuntimeError(f"sharded: plan shards {sh.shards}")
    (v, i), rec = _sharded_pair("hamming", one, sh, qb, gb, True)
    fv, fi = prog.engine_plan.execute(qb, gb)                  # flat B1
    if not (torch.equal(v, fv) and torch.equal(i, fi)):
        raise RuntimeError("sharded hamming: 4 shards differ from flat B1")
    rec["bit_identical_to_flat_b1"] = True
    rng = np.random.default_rng(17)
    rows = np.sort(rng.choice(g.shape[0], int(0.01 * g.shape[0]),
                              replace=False))
    new = torch.from_numpy((rng.random((rows.size, g.shape[1])) > 0.5)
                           .astype(np.float32)).cuda()
    upd_ms, g2 = host_ms(lambda: sh.update_rows(gb, rows, new))
    if sh.row_update_fallbacks:
        raise RuntimeError("sharded hamming: update_rows fell back")
    (v2, i2), after = _sharded_pair("hamming after update", one, sh, qb, g2,
                                    True)
    fv2, fi2 = prog.engine_plan.execute(qb, g2.clone())
    if not (torch.equal(v2, fv2) and torch.equal(i2, fi2)):
        raise RuntimeError("sharded hamming: after update_rows, 4 shards "
                           "differ from flat B1 on a fresh gallery")
    rec.update(update_rows=int(rows.size), update_ms=upd_ms,
               after_update=after, part_s=time.perf_counter() - t0)
    out["hamming_k10"] = rec
    del gb, g2, new
    torch.cuda.empty_cache()

    # eucl at the KNN shape
    t0 = time.perf_counter()
    gt, qt = torch.from_numpy(g).cuda(), torch.from_numpy(q).cuda()
    eprog = compile_fn(knn_kernel, [q, g], ArchSpec(rows=64, cols=64),
                       value_bits=8, backend="torch")
    emod = eprog.stages["cim_partitioned"]
    with forced_devices(SHARDS, "cuda:0"):
        esh = get_plan(emod, backend="torch", shards=SHARDS)
    _, rec = _sharded_pair("eucl", eprog.engine_plan, esh, qt, gt, False)
    rec.update(rows=g.shape[0], part_s=time.perf_counter() - t0)
    out["eucl_k5"] = rec
    del gt
    torch.cuda.empty_cache()

    # the hierarchical plan at bench_hier's geometry
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    hg = clustered_gallery(rng, HIER_N, HIER_DIM, HIER_CENTERS)
    qi = rng.choice(HIER_N, size=HIER_QUERIES, replace=False)
    hq = (hg[qi].astype(bool)
          ^ (rng.random((HIER_QUERIES, HIER_DIM)) < HIER_FLIP)) \
        .astype(np.float32)
    hgt, hqt = torch.from_numpy(hg).cuda(), torch.from_numpy(hq).cuda()
    hmod = hamming_module(T, cd, HIER_QUERIES, HIER_N, HIER_DIM, HIER_K,
                          False)
    hprog = compile_module(hmod, ArchSpec(rows=128, cols=128),
                           value_bits=1)
    hmod = hprog.stages["cim_partitioned"]
    out["hier"] = {}
    for nprobe in (HIER_SERVE_NPROBE, HIER_CLUSTERS):
        kw = dict(clusters=HIER_CLUSTERS, nprobe=nprobe,
                  kmeans_iters=HIER_ITERS)
        h1 = get_hierarchical_plan(hmod, **kw)
        with forced_devices(SHARDS, "cuda:0"):
            h4 = get_hierarchical_plan(hmod, shards=SHARDS, **kw)
        if h4.shards != SHARDS:
            raise RuntimeError(f"sharded hier: plan shards {h4.shards}")
        (v, i), rec = _sharded_pair(f"hier nprobe={nprobe}", h1, h4, hqt,
                                    hgt, True)
        if nprobe == HIER_CLUSTERS:
            fv, fi = hprog.engine_plan.execute(hqt, hgt)
            if not (torch.equal(v, fv) and torch.equal(i, fi)):
                raise RuntimeError("sharded hier: nprobe = clusters is not "
                                   "bit-identical to flat B1")
            rec["bit_identical_to_flat_b1"] = True
        rec["wall_ms"] = _wall_ms(lambda: h4.execute(hqt, hgt))
        rec["unsharded_wall_ms"] = _wall_ms(lambda: h1.execute(hqt, hgt))
        out["hier"][nprobe] = rec
    out["hier"]["part_s"] = time.perf_counter() - t0
    log({"phase": "sharded", "ok": True, "shards": SHARDS, **out})


# ---------------------------------------------------------------------------
# gateway_serve: the multi-tenant gateway over replica sets (B1, B2, B3)
# ---------------------------------------------------------------------------


def _gw_search(gw, tenant, q, priority=0):
    """One request through the gateway, retried while admission rejects
    it (a rate-limited tenant backs off); returns the settled result."""
    from repro_torch.serving import AdmissionError
    deadline = time.perf_counter() + CAM_WAIT_S
    while True:
        try:
            return gw.submit(tenant, q, priority=priority).wait(CAM_WAIT_S)
        except AdmissionError:
            if time.perf_counter() > deadline:
                raise
            time.sleep(GW_BACKOFF_S)


def _gw_clients(gw, work, clients=GW_CLIENTS):
    """``clients`` threads per tenant in ``work`` (tenant -> (queries,
    oracle, priority)), each sending its share of the queries as
    GW_ROWS-row requests.  Every result must equal the tenant's oracle
    rows; returns the per-tenant latencies and the wall seconds."""
    import threading
    import numpy as np
    lat = {t: [] for t in work}
    errs = []

    def client(tenant, c):
        q, oracle, prio = work[tenant]
        per = q.shape[0] // clients
        try:
            for s0 in range(c * per, (c + 1) * per, GW_ROWS):
                res = _gw_search(gw, tenant, q[s0:s0 + GW_ROWS], prio)
                if res.error is not None:
                    raise res.error
                got = res.matches if res.matches is not None \
                    else res.indices
                want = oracle[s0:s0 + GW_ROWS]
                if not np.array_equal(got, want) or (
                        res.values is not None and not np.array_equal(
                            res.values, oracle.values[s0:s0 + GW_ROWS])):
                    raise RuntimeError(f"gateway {tenant}: rows {s0}.. "
                                       f"differ from the direct call")
                lat[tenant].append(res.latency_s)
        except Exception as e:          # noqa: BLE001 — reported below
            errs.append(e)

    threads = [threading.Thread(target=client, args=(t, c))
               for t in work for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(CAM_WAIT_S)
    wall = time.perf_counter() - t0
    if errs or any(t.is_alive() for t in threads):
        raise RuntimeError(f"gateway: a client failed or hung: {errs[:1]}")
    return lat, wall


class _Oracle(object):
    """Direct-call results as host numpy: ``[rows]`` gives the indices
    (or the match rows), ``.values`` the values."""

    def __init__(self, out):
        if isinstance(out, tuple):
            self.values, self.main = (x.cpu().numpy() for x in out)
        else:
            self.values, self.main = None, out.cpu().numpy()

    def __getitem__(self, rows):
        return self.main[rows]


def _p95_ms(lat):
    import numpy as np
    return 1e3 * float(np.percentile(lat, 95))


def _drive_victim(search, q, reps):
    """``reps`` sequential GW_ROWS-row requests; their latencies."""
    out = []
    for r in range(reps):
        s0 = (r * GW_ROWS) % (q.shape[0] - GW_ROWS)
        t0 = time.perf_counter()
        search(q[s0:s0 + GW_ROWS])
        out.append(time.perf_counter() - t0)
    return out


def _flood(submit, stop_evt, counters, inflight=32):
    """The hot tenant's flood, bounded in flight (bench_multitenant's)."""
    from repro_torch.serving import AdmissionError, TenantUnavailable
    pending = []
    while not stop_evt.is_set():
        try:
            pending.append(submit())
            counters["accepted"] += 1
        except (AdmissionError, TenantUnavailable):
            counters["rejected"] += 1
            time.sleep(1e-3)
        while len(pending) >= inflight:
            res = pending.pop(0).wait(CAM_WAIT_S)
            if getattr(res, "error", None) is not None and \
                    not isinstance(res.error, AdmissionError):
                counters["errors"] += 1
    for h in pending:
        res = h.wait(CAM_WAIT_S)
        if getattr(res, "error", None) is not None and \
                not isinstance(res.error, AdmissionError):
            counters["errors"] += 1


def _gw_isolation(gw, q, qb, knn_plan, ham_plan, gt, gb):
    """bench_multitenant's isolation: the ``knn`` victim's p95 alone and
    while ``hamming_gold`` floods past its token bucket; then the same
    victim on a bare ``CamSearchServer`` while a bare hamming server on
    the same card takes the flood with no admission layer."""
    import threading
    from repro_torch.serving import CamSearchServer

    def victim(x):
        res = gw.submit("knn", x).wait(CAM_WAIT_S)
        if res.error is not None:
            raise res.error

    solo = _drive_victim(victim, q, GW_VICTIM_REPS)
    stop, counters = threading.Event(), {"accepted": 0, "rejected": 0,
                                         "errors": 0}
    hot_q = qb[:2 * GW_ROWS]
    flooders = [threading.Thread(target=_flood, args=(
        lambda: gw.submit("hamming_gold", hot_q, priority=GW_GOLD_PRIORITY),
        stop, counters)) for _ in range(2)]
    for f in flooders:
        f.start()
    flooded = _drive_victim(victim, q, GW_VICTIM_REPS)
    stop.set()
    for f in flooders:
        f.join(CAM_WAIT_S)
    with CamSearchServer(knn_plan, gt, max_wait_ms=2.0) as vs, \
            CamSearchServer(ham_plan, gb, max_wait_ms=2.0) as hs:
        bare_solo = _drive_victim(lambda x: vs.search(x, CAM_WAIT_S), q,
                                  GW_VICTIM_REPS)
        stop2, naive = threading.Event(), {"accepted": 0, "rejected": 0,
                                           "errors": 0}
        flooders = [threading.Thread(target=_flood, args=(
            lambda: hs.submit(hot_q), stop2, naive)) for _ in range(2)]
        for f in flooders:
            f.start()
        bare_flooded = _drive_victim(lambda x: vs.search(x, CAM_WAIT_S), q,
                                     GW_VICTIM_REPS)
        stop2.set()
        for f in flooders:
            f.join(CAM_WAIT_S)
        for srv in (vs, hs):
            _server_health("gateway_serve bare", srv)
    if counters["errors"] or naive["errors"]:
        raise RuntimeError(f"gateway isolation: flood errors "
                           f"{counters} {naive}")
    rec = {"victim_solo_p95_ms": _p95_ms(solo),
           "victim_flooded_p95_ms": _p95_ms(flooded),
           "bare_solo_p95_ms": _p95_ms(bare_solo),
           "bare_flooded_p95_ms": _p95_ms(bare_flooded),
           "hot_accepted": counters["accepted"],
           "hot_rejected": counters["rejected"],
           "bare_hot_accepted": naive["accepted"]}
    rec["gateway_factor"] = rec["victim_flooded_p95_ms"] / \
        rec["victim_solo_p95_ms"]
    rec["bare_factor"] = rec["bare_flooded_p95_ms"] / rec["bare_solo_p95_ms"]
    return rec


def _gw_failover(gw, q, oracle):
    """bench_multitenant's failover: GW_CLIENTS bit-checking clients on
    ``knn``; replica 0 killed mid-traffic; zero failed requests,
    failovers, and the maintenance loop drains, rebuilds and readmits
    the replica before the part ends."""
    import threading
    import numpy as np
    errors, lat = [], {"before": [], "after": []}
    killed = threading.Event()
    per = q.shape[0] // GW_CLIENTS
    barrier = threading.Barrier(GW_CLIENTS + 1)
    before = gw.health()["tenants"]["knn"]["stats"]["failovers"]

    def client(c):
        barrier.wait()
        for r in range(GW_FAILOVER_REPS):
            s0 = c * per + (r * GW_ROWS) % (per - GW_ROWS)
            t0 = time.perf_counter()
            res = gw.submit("knn", q[s0:s0 + GW_ROWS]).wait(CAM_WAIT_S)
            if res.error is not None:
                errors.append(repr(res.error))
                continue
            lat["after" if killed.is_set() else "before"].append(
                time.perf_counter() - t0)
            if not (np.array_equal(res.indices, oracle[s0:s0 + GW_ROWS])
                    and np.array_equal(res.values,
                                       oracle.values[s0:s0 + GW_ROWS])):
                errors.append(f"mismatch at {s0}")

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(GW_CLIENTS)]
    for t in threads:
        t.start()
    barrier.wait()
    time.sleep(GW_KILL_AFTER_S)
    gw.kill_replica("knn", 0)
    killed.set()
    for t in threads:
        t.join(CAM_WAIT_S)
    t0 = time.perf_counter()
    healed = False
    while time.perf_counter() - t0 < CAM_WAIT_S:
        reps = gw.health()["tenants"]["knn"]["replicas"]["replicas"]
        if all(r["state"] == "serving" for r in reps) and \
                any(r["rebuilds"] > 0 for r in reps):
            healed = True
            break
        time.sleep(0.01)
    heal_s = time.perf_counter() - t0
    h = gw.health()["tenants"]["knn"]
    failovers = h["stats"]["failovers"] - before
    post = gw.submit("knn", q[:GW_ROWS]).wait(CAM_WAIT_S)
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"gateway failover: {len(errors)} failed or "
                           f"mismatched requests: {errors[:3]}")
    if failovers <= 0:
        raise RuntimeError("gateway failover: the kill landed between "
                           "requests: no failover")
    if not healed:
        raise RuntimeError("gateway failover: the killed replica was not "
                           "rebuilt and readmitted")
    if post.error is not None or not np.array_equal(post.indices,
                                                    oracle[:GW_ROWS]):
        raise RuntimeError("gateway failover: after the heal the result "
                           "differs from the direct call")
    return {"clients": GW_CLIENTS, "requests": GW_CLIENTS * GW_FAILOVER_REPS,
            "failed": 0, "failovers": failovers,
            "healed": healed, "heal_wait_s": heal_s,
            "p50_before_kill_ms": _latency_ms(lat["before"])["p50"]
            if lat["before"] else None,
            "p99_after_kill_ms": _latency_ms(lat["after"])["p99"]
            if lat["after"] else None,
            "replicas": [{k: r[k] for k in ("state", "generation",
                                            "rebuilds", "heals", "drains",
                                            "device_group")}
                         for r in h["replicas"]["replicas"]]}


def _gw_update(gw, plan, qb, gb):
    """A live ``update_gallery`` of 1 % of ``hamming``'s rows racing its
    clients: every result equals the version-A or the version-B oracle,
    and every request submitted after the update returns sees B (on the
    shared ``hamming_gold`` tenant too)."""
    import threading
    import numpy as np
    import torch
    rng = np.random.default_rng(23)
    n, dim = gb.shape
    rows = np.sort(rng.choice(n, int(0.01 * n), replace=False))
    new = (rng.random((rows.size, dim)) > 0.5).astype(np.float32)
    qr = qb[:GW_ROWS]
    want_a = plan.execute(qr, gb)[1].cpu().numpy()
    gb2 = gb.clone()
    gb2[torch.from_numpy(rows).cuda()] = torch.from_numpy(new).cuda()
    want_b = plan.execute(qr, gb2)[1].cpu().numpy()
    del gb2
    if np.array_equal(want_a, want_b):
        raise RuntimeError("gateway update: the update is invisible")
    seen, errs = [], []
    stop = threading.Event()

    def racer():
        try:
            while not stop.is_set():
                res = _gw_search(gw, "hamming", qr)
                if res.error is not None:
                    raise res.error
                seen.append("a" if np.array_equal(res.indices, want_a) else
                            "b" if np.array_equal(res.indices, want_b) else
                            "torn")
        except Exception as e:          # noqa: BLE001 — reported below
            errs.append(e)

    threads = [threading.Thread(target=racer) for _ in range(GW_CLIENTS)]
    for t in threads:
        t.start()
    deadline = time.perf_counter() + CAM_WAIT_S
    while len(seen) < GW_CLIENTS and not errs and \
            time.perf_counter() < deadline:
        time.sleep(0.001)
    update_ms, count = host_ms(lambda: gw.update_gallery("hamming", rows,
                                                         new))
    after = [_gw_search(gw, t, qr) for t in ("hamming", "hamming_gold")]
    n_before = len(seen)
    while "b" not in seen[n_before:] and not errs and \
            time.perf_counter() < deadline:
        time.sleep(0.001)
    stop.set()
    for t in threads:
        t.join(CAM_WAIT_S)
    if errs or any(t.is_alive() for t in threads):
        raise RuntimeError(f"gateway update: a racer failed: {errs[:1]}")
    if any(r.error is not None or not np.array_equal(r.indices, want_b)
           for r in after):
        raise RuntimeError("gateway update: a request after the update "
                           "did not read its write")
    if "torn" in seen or "a" not in seen or "b" not in seen:
        raise RuntimeError(f"gateway update: {seen.count('a')} A, "
                           f"{seen.count('b')} B, {seen.count('torn')} "
                           f"mixed results")
    return {"rows": int(count), "update_ms": update_ms,
            "racing_results": len(seen), "version_a": seen.count("a"),
            "version_b": seen.count("b"), "read_your_writes": True}


def phase_gateway_serve(s: Smoke, data):
    """One ``CamServingGateway`` with four tenants at the smoke's widths:
    ``knn`` (``knn_eucl``'s program and gallery, B2, 2 replicas),
    ``hamming`` (``hamming_packed``'s, B1, 2 replicas), ``hamming_gold``
    (``share_with="hamming"``, its own rate and priority) and ``forest``
    (``forest_acam``'s interval rows, ``match``, B3, 2 replicas);
    ``benchmarks/bench_multitenant.py``'s three experiments (aggregate,
    isolation, failover) and a live 1 % update racing its clients.  Fails
    on any mismatch against the direct plan calls, any unexpected error,
    or any degraded batch."""
    import numpy as np
    import torch
    from repro_torch.core import ArchSpec, CamType, compile_fn
    from repro_torch.forest import CamForestClassifier, random_forest
    from repro_torch.kernels import cam_search
    from repro_torch.serving import CamServingGateway
    g, _, q, _ = data
    gt = torch.from_numpy(g).cuda()
    knn = compile_fn(knn_kernel, [q, g], ArchSpec(rows=64, cols=64),
                     value_bits=8).engine_plan
    ham, qb, gb = _packed_plan(data)
    trees = random_forest(np.random.default_rng(7), **FOREST)
    clf = CamForestClassifier(trees, dim=FOREST["dim"]).compile(
        ArchSpec(rows=64, cols=64, cam_type=CamType.ACAM),
        batch_hint=FOREST_QUERIES)
    x = np.random.default_rng(8).standard_normal(
        (FOREST_QUERIES, FOREST["dim"])).astype(np.float32)
    rows = GW_CLIENTS * GW_REQUESTS * GW_ROWS
    qk, qh, xf = q[:rows], qb[:rows], x[:rows]
    oracles = {"knn": _Oracle(knn.execute(qk, gt)),
               "hamming": _Oracle(ham.execute(qh, gb)),
               "forest": _Oracle(clf.plan.execute(xf, clf._lo, clf._hi))}
    oracles["hamming_gold"] = oracles["hamming"]
    cam_search.reset_launch_counts()
    out = {}
    gw = CamServingGateway(maint_ms=GW_MAINT_MS)
    try:
        t0 = time.perf_counter()
        gw.register_tenant("knn", knn, gt, replicas=2, unhealthy_k=2,
                           server_kwargs={"max_wait_ms": 2.0})
        gw.register_tenant("hamming", ham, gb, replicas=2,
                           server_kwargs={"max_wait_ms": 2.0})
        gw.register_tenant("hamming_gold", share_with="hamming",
                           rate=GW_GOLD_RATE, burst=GW_GOLD_BURST,
                           queue_limit=4, max_outstanding=2)
        gw.register_tenant("forest", clf.plan, (clf._lo, clf._hi),
                           replicas=2, server_kwargs={"max_wait_ms": 2.0})
        out["register_s"] = time.perf_counter() - t0

        # (1) aggregate: 4 tenants x GW_CLIENTS clients, 13-row requests
        work = {"knn": (qk, oracles["knn"], 0),
                "hamming": (qh, oracles["hamming"], 0),
                "hamming_gold": (qh, oracles["hamming"], GW_GOLD_PRIORITY),
                "forest": (xf, oracles["forest"], 0)}
        lat, wall = _gw_clients(gw, work)
        out["aggregate"] = {
            "wall_s": wall, "rows": 4 * rows,
            "rows_per_s": 4 * rows / wall,
            "latency_ms": {t: _latency_ms(v) for t, v in lat.items()},
            "bit_identical_to_direct": True}
        # (2) isolation, (3) failover, then the live update
        t0 = time.perf_counter()
        out["isolation"] = _gw_isolation(gw, q, qb, knn, ham, gt, gb)
        out["isolation"]["part_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["failover"] = _gw_failover(gw, qk, oracles["knn"])
        out["failover"]["part_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["update"] = _gw_update(gw, ham, qb, gb)
        out["update"]["part_s"] = time.perf_counter() - t0
        snap = gw.snapshot()
    finally:
        gw.stop()
    counts = dict(cam_search.LAUNCHES)
    for name in ("fused_topk", "fused_topk_packed", "acam_match"):
        if counts[name] < 1:
            raise RuntimeError(f"gateway_serve: kernel {name} was not "
                               f"launched: {counts}")
    tenants = {}
    for t, e in snap["tenants"].items():
        servers = [sv for sv in e["servers"] if sv is not None]
        degraded = sum(sv["degraded_batches"] for sv in servers)
        # the only failures allowed: hamming_gold's flood shed by its own
        # admission budget
        if degraded or e["stats"]["failed"] != e["stats"]["shed"]:
            raise RuntimeError(f"gateway_serve {t}: {degraded} degraded "
                               f"batches, {e['stats']['failed']} failed "
                               f"requests ({e['stats']['shed']} shed)")
        batches = sum(sv["batches"] for sv in servers)
        tenants[t] = {"stats": e["stats"], "latency": e["latency"],
                      "batches": batches,
                      "rows_per_batch": sum(sv["batched_rows"]
                                            for sv in servers)
                      / max(1, batches),
                      "replicas": [{k: r[k] for k in
                                    ("state", "generation", "rebuilds",
                                     "heals", "failures")}
                                   for r in e["replicas"]["replicas"]]}
    for name, src, ref in (
            ("fused_topk", "fused_topk.cu", "cam_search.py:200"),
            ("fused_topk_packed", "fused_topk_packed.cu",
             "cam_search.py:304"),
            ("acam_match", "acam_match.cu", "acam.py:121")):
        s.record(name, f"src/repro_torch/kernels/csrc/{src}",
                 f"src/repro/kernels/{ref}", counts[name], 0.0, None, None,
                 None, "operations", None)
    log({"phase": "gateway_serve", "ok": True, "launches": counts,
         "tenants": tenants, **out})


# ---------------------------------------------------------------------------
# tune: the plan autotuner, the plan store and the served warm start
# ---------------------------------------------------------------------------

#: the child process's time limit, and the served warm start's request
#: rows (a gateway request) and requests
TUNE_CHILD_S = 600
TUNE_SERVE_ROWS, TUNE_SERVE_REQUESTS = 13, 8


def tune_workloads(data):
    """The tune phase's programs, name -> (partitioned module, inputs on
    the card): ``knn_eucl``'s (B2, k = 5), ``hamming_packed``'s (B1,
    k = 10) and ``forest_acam``'s interval range program (B3), from the
    smoke's seeds, so that a second process rebuilds the same data."""
    import numpy as np
    import torch
    import repro_torch.core as T
    from repro_torch.core import (ArchSpec, CamType, compile_fn,
                                  compile_module)
    from repro_torch.core import cim_dialect as cd
    from repro_torch.forest import CamForestClassifier, random_forest
    g, _, q, _ = data
    gt, qt = torch.from_numpy(g).cuda(), torch.from_numpy(q).cuda()
    knn = compile_fn(knn_kernel, [q, g], ArchSpec(rows=64, cols=64),
                     value_bits=8)
    ham = compile_module(hamming_module(T, cd, q.shape[0], g.shape[0],
                                        g.shape[1], 10, False),
                         ArchSpec(rows=64, cols=64), value_bits=1)
    trees = random_forest(np.random.default_rng(7), **FOREST)
    clf = CamForestClassifier(trees, dim=FOREST["dim"]).compile(
        ArchSpec(rows=64, cols=64, cam_type=CamType.ACAM),
        batch_hint=FOREST_QUERIES)
    x = np.random.default_rng(8).standard_normal(
        (FOREST_QUERIES, FOREST["dim"])).astype(np.float32)
    return {"knn_eucl": (knn.stages["cim_partitioned"], (qt, gt)),
            "hamming_packed": (ham.stages["cim_partitioned"],
                               ((qt > 0).float(), (gt > 0).float())),
            "forest_acam": (clf.stages["cim_partitioned"],
                            (torch.from_numpy(x).cuda(), clf._lo, clf._hi))}


def _host_out(out):
    """A plan's result as a tuple of host numpy arrays."""
    outs = out if isinstance(out, tuple) else (out,)
    return tuple(o.cpu().numpy() for o in outs)


def _timed_tune(mod, ins):
    """``tune_plan`` and the winner's first result, timed together on
    the host clock (the start-to-first-result a server pays)."""
    import torch
    from repro_torch.tune import tune_plan
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = tune_plan(mod, *ins)
    out = res.plan.execute(*ins)
    torch.cuda.synchronize()
    return res, out, time.perf_counter() - t0


def tune_child(out_dir: str) -> None:
    """The cold start in a fresh process: the same data from the same
    seeds, ``tune_plan`` against the parent's store (``REPRO_PLAN_STORE``
    inherited), each result held bit for bit to the parent's winner in
    ``out_dir``.  Prints one JSON line."""
    import numpy as np
    import repro_torch.kernels.build as kbuild
    from repro_torch.data import knn_dataset
    from repro_torch.tune import plan_store_stats, tune_stats
    t0 = time.perf_counter()
    built = kbuild.build()
    work = tune_workloads(knn_dataset(**KNN_DATA))
    setup_s = time.perf_counter() - t0
    programs = {}
    for name, (mod, ins) in work.items():
        res, out, took = _timed_tune(mod, ins)
        want = np.load(os.path.join(out_dir, f"{name}.npz"))
        got = _host_out(out)
        programs[name] = {
            "from_store": res.from_store, "trials": res.trials,
            "config": {k: res.config[k] for k in
                       ("tile_rows", "dims_per_tile", "batch", "pack")},
            "start_to_first_result_s": took,
            "bit_identical": len(got) == len(want.files) and all(
                np.array_equal(a, want[f"o{j}"])
                for j, a in enumerate(got))}
    print(json.dumps({"built": built, "setup_s": setup_s,
                      "store": plan_store_stats(), "tune": tune_stats(),
                      "imported": sorted(m for m in sys.modules
                                         if m.split(".")[0] in
                                         ("jax", "repro")),
                      "programs": programs}), flush=True)


def _tune_verify(name, ins, base, win):
    """The winner's result against its baseline's: bit-identical for
    hamming and the interval match; eucl values within the tolerance and
    index swaps only at float64 near-ties.  Returns the swaps."""
    import torch
    if name != "knn_eucl":
        if not all(torch.equal(a, b) for a, b in zip(
                base if isinstance(base, tuple) else (base,),
                win if isinstance(win, tuple) else (win,))):
            raise RuntimeError(f"tune {name}: the winner differs from its "
                               f"baseline")
        return 0
    (bv, bi), (wv, wi) = base, win
    if not bool(((wv - bv).abs() <= EUCL_ATOL + EUCL_RTOL * bv.abs()).all()):
        raise RuntimeError(f"tune {name}: winner values off the baseline by "
                           f"{float((wv - bv).abs().max())}")
    return eucl_index_swaps(ins[0], ins[1], wi, bi, f"tune {name}")


def _tune_serve(plan, heuristic, q, g):
    """(d) a server over the heuristic plan, and a gateway tenant
    registered with the default ``tuned``: both must serve the stored
    winner ``plan``, every request bit-identical to its direct call;
    ``tuned=False`` keeps the heuristic plan."""
    import numpy as np
    from repro_torch.serving import CamSearchServer, CamServingGateway
    rows = TUNE_SERVE_ROWS
    blocks = [q[j * rows:(j + 1) * rows] for j in range(TUNE_SERVE_REQUESTS)]
    want = [_host_out(plan.execute(b, g)) for b in blocks]

    def check(what, results):
        for j, (v, i) in enumerate(results):
            if not (np.array_equal(v, want[j][0])
                    and np.array_equal(i, want[j][1])):
                raise RuntimeError(f"tune {what}: request {j} differs from "
                                   f"the winner's direct call")

    with CamSearchServer(heuristic, g) as srv:
        if srv.plan is not plan:
            raise RuntimeError("tune: the server did not warm-start to the "
                               "stored winner")
        check("server", [srv.search(b, timeout=CAM_WAIT_S) for b in blocks])
        served = {"tile_rows": srv.plan.spec.tile_rows,
                  "batch": srv.plan.batch}
        _server_health("tune server", srv)
    with CamSearchServer(heuristic, g, tuned=False) as srv:
        if srv.plan is not heuristic:
            raise RuntimeError("tune: tuned=False did not keep the plan")
    with CamServingGateway(maint_ms=GW_MAINT_MS) as gw:
        gw.register_tenant("hamming", heuristic, g, replicas=2)
        tenant_plan = gw._tenant("hamming").rset.plan
        if tenant_plan is not plan:
            raise RuntimeError("tune: the gateway tenant did not "
                               "warm-start to the stored winner")
        check("gateway", [gw.search("hamming", b, timeout=CAM_WAIT_S)
                          for b in blocks])
    return {"server_plan": served, "requests": len(blocks), "rows": rows,
            "server_bit_identical": True, "gateway_bit_identical": True,
            "tuned_false_keeps_heuristic": True}


def phase_tune(s: Smoke, data):
    """The plan autotuner on the ``"cuda"`` backend with its default
    trials and reps, against a fresh temporary ``REPRO_PLAN_STORE``:
    (a) ``knn_eucl``'s and ``hamming_packed``'s programs at 624 x 180,000
    x 1024 and (b) ``forest_acam``'s interval range plan, each winner
    held to its baseline; (c) a second process warm-starts from the
    store (no trial, three config hits, nothing built, bit-identical
    results); (d) a server and a gateway tenant built over the heuristic
    hamming plan serve the stored winner."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    import repro_torch.core as T
    from repro_torch.kernels import cam_search
    from repro_torch.tune import (plan_for_config, plan_store_stats,
                                  reset_plan_store_stats, reset_tune_stats)
    T.clear_plan_cache()
    scratch = tempfile.mkdtemp(prefix="chip-smoke-tune-")
    store = os.path.join(scratch, "store")
    old = os.environ.get("REPRO_PLAN_STORE")
    os.environ["REPRO_PLAN_STORE"] = store
    try:
        work = tune_workloads(data)
        reset_tune_stats()
        reset_plan_store_stats()
        cam_search.reset_launch_counts()
        tuned = {name: _timed_tune(mod, ins)
                 for name, (mod, ins) in work.items()}
        counts = dict(cam_search.LAUNCHES)
        for name in ("fused_topk", "fused_topk_packed", "acam_match"):
            if counts[name] < 1:
                raise RuntimeError(f"tune: kernel {name} was not launched: "
                                   f"{counts}")
        programs = {}
        for name, (res, out, took) in tuned.items():
            mod, ins = work[name]
            if res.from_store or res.trials < 1:
                raise RuntimeError(f"tune {name}: no search ran")
            base = plan_for_config(res.plan.spec, res.history[0])
            swaps = _tune_verify(name, ins, base.execute(*ins), out)
            np.savez(os.path.join(scratch, f"{name}.npz"),
                     **{f"o{j}": a for j, a in enumerate(_host_out(out))})
            programs[name] = {
                "baseline": {k: res.history[0][k] for k in
                             ("tile_rows", "dims_per_tile", "batch",
                              "pack")},
                "baseline_ms": 1e3 * res.base_s,
                "winner": {k: res.config[k] for k in
                           ("tile_rows", "dims_per_tile", "batch", "pack")},
                "winner_ms": 1e3 * res.best_s, "speedup": res.speedup,
                "trials": res.trials,
                "rejected": sum(h.get("verified") is False
                                for h in res.history),
                "refused": sum(bool(h.get("error")) for h in res.history),
                "index_swaps_float64_near_ties": swaps,
                "cold_start_to_first_result_s": took,
                "history": [dict({k: v for k, v in h.items()
                                  if k not in ("backend", "wall_s")},
                                 ms=None if h["wall_s"] is None
                                 else 1e3 * h["wall_s"])
                            for h in res.history]}
            if programs[name]["rejected"] or programs[name]["refused"]:
                # every candidate (each batch value: a ragged last
                # micro-batch at m = 624) must run on the kernels and
                # give the baseline's answers
                raise RuntimeError(f"tune {name}: candidates rejected or "
                                   f"refused: {programs[name]['history']}")
        parent_store = plan_store_stats()

        # (c) the cold start in a fresh, torch-only process
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, "-c",
             f"import sys; sys.path[:0] = [{ROOT!r}, "
             f"{os.path.join(ROOT, 'src')!r}]; import chip_smoke; "
             f"chip_smoke.tune_child({scratch!r})"],
            capture_output=True, text=True, timeout=TUNE_CHILD_S)
        child_s = time.perf_counter() - t0
        if child.returncode != 0:
            raise RuntimeError(f"tune: the child failed: "
                               f"{child.stderr[-3000:]}")
        warm = json.loads(child.stdout.strip().splitlines()[-1])
        if warm["built"] or warm["imported"] or \
                warm["store"]["config_hits"] != 3 or \
                warm["store"]["exec_hits"] != 0 or \
                warm["tune"]["trials"] != 0 or not all(
                    p["from_store"] and p["trials"] == 0 and p["bit_identical"]
                    and p["config"] == programs[n]["winner"]
                    for n, p in warm["programs"].items()):
            raise RuntimeError(f"tune: the second process did not "
                               f"warm-start: {warm}")

        # (d) the served warm start, over the heuristic hamming plan
        cam_search.reset_launch_counts()
        mod, (qb, gb) = work["hamming_packed"]
        winner = tuned["hamming_packed"][0].plan
        serve = _tune_serve(winner, T.get_plan(mod), qb, gb)
        serve["launches"] = dict(cam_search.LAUNCHES)
        kernel = "fused_topk_packed" if winner.packed else "fused_topk"
        if serve["launches"][kernel] < 1:
            raise RuntimeError(f"tune: the served warm start did not launch "
                               f"the winner's {kernel}: {serve['launches']}")
    finally:
        if old is None:
            os.environ.pop("REPRO_PLAN_STORE", None)
        else:
            os.environ["REPRO_PLAN_STORE"] = old
        shutil.rmtree(scratch, ignore_errors=True)
        T.clear_plan_cache()
        torch.cuda.empty_cache()
    for name, src, ref in (
            ("fused_topk", "fused_topk.cu", "cam_search.py:200"),
            ("fused_topk_packed", "fused_topk_packed.cu",
             "cam_search.py:304"),
            ("acam_match", "acam_match.cu", "acam.py:121")):
        s.record(name, f"src/repro_torch/kernels/csrc/{src}",
                 f"src/repro/kernels/{ref}", counts[name], 0.0, None, None,
                 None, "operations", None)
    log({"phase": "tune", "ok": True, "launches": counts,
         "programs": programs, "parent_store": parent_store,
         "child": dict(warm, wall_s=child_s), "served": serve})


def _b7_class(key: str) -> str:
    """Kernel class of a profiler row: B7, a matrix product, or other."""
    low = key.lower()
    if "flash_fwd" in low:
        return "b7_flash_attention"
    if any(w in low for w in ("gemm", "gemv", "cublas", "cutlass", "xmma",
                              "nvjet", "matmul", "splitk")):
        return "gemm"
    return "other"


def b7_bound_ms(q, k, kw):
    """B7's bound: 4 * H * dh FLOP per visible (row, column) pair at the
    bf16 tensor-core peak, against the bytes of q, o and the visible K/V
    rows; both counted from this call's masks."""
    b, s, h, dh = q.shape
    kvh = k.shape[2]
    kv_len = kw.get("kv_len") or k.shape[1]
    q_start, prefix = kw.get("q_start", 0), kw.get("prefix_len", 0)
    if kw.get("causal", True):
        rows = [min(kv_len, max(q_start + r + 1, prefix)) for r in range(s)]
    else:
        rows = [kv_len] * s
    flops = 4.0 * b * h * dh * sum(rows)
    bytes_ = (2.0 * q.element_size() * b * s * h * dh
              + 2.0 * k.element_size() * b * max(rows) * kvh * dh)
    t_ops, t_mem = flops / BF16_PEAK_FLOPS, bytes_ / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_mem), "operations" if t_ops >= t_mem \
        else "bytes"


def sdpa_call(q, k, v, kw):
    """The library yardstick for one B7 call: PyTorch's
    ``scaled_dot_product_attention`` over the visible cache rows (timed
    only; the port never calls it)."""
    import torch
    s = q.shape[1]
    kv_len = kw.get("kv_len") or k.shape[1]
    qt = q.transpose(1, 2)
    kt, vt = k[:, :kv_len].transpose(1, 2), v[:, :kv_len].transpose(1, 2)
    # one decode row sees every cached row; a prefill is causal from 0
    causal = s > 1 and kw.get("causal", True)
    if causal and (kw.get("q_start", 0) or kv_len != s
                   or kw.get("prefix_len", 0)):
        raise ValueError(f"sdpa_call: no yardstick for {kw}")
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True)


def phase_lm_serve(s: Smoke):
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import cam_search
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import Request, Server
    from repro_torch.models import model as tm

    # (a) serve, full model, bf16 ------------------------------------------
    cfg = dataclasses.replace(get_config(LM_ARCH), **LM_OVERRIDES)
    torch.cuda.reset_peak_memory_stats()
    init_ms, params = host_ms(lambda: tm.init_params(cfg, seed=0))
    leaves = []
    tm._tree_map(leaves.append, params)
    n_params = sum(t.numel() for t in leaves)
    params_gb = sum(t.numel() * t.element_size() for t in leaves) / 1e9
    dev = leaves[0].device
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, SERVE_PROMPT)
               for _ in range(SERVE_REQUESTS)]
    max_len = SERVE_PROMPT + SERVE_NEW + 1

    def serve():
        srv = Server(cfg, params, batch=SERVE_BATCH, max_len=max_len,
                     temperature=0)
        reqs = [Request(rid=r, prompt=p, max_new=SERVE_NEW)
                for r, p in enumerate(prompts)]
        for r in reqs:
            srv.submit(r)
        cam_search.reset_launch_counts()
        torch.cuda.synchronize()
        stats = srv.run()
        torch.cuda.synchronize()
        return [r.out for r in reqs], stats, dict(cam_search.LAUNCHES)

    n_layers = cfg.n_layers
    tokens, stats, counts = serve()
    expect = n_layers * SERVE_REQUESTS * SERVE_NEW
    s.only("lm_serve", counts, "flash_attention", expect)
    if stats["completed"] != SERVE_REQUESTS or any(
            len(t) != SERVE_NEW or not all(0 <= x < cfg.vocab for x in t)
            for t in tokens):
        raise RuntimeError(f"lm_serve: bad completions {stats}")
    tokens2, stats2, counts2 = serve()
    if tokens2 != tokens:
        raise RuntimeError("lm_serve: a second Server gave other tokens")
    s.only("lm_serve (second server)", counts2, "flash_attention", expect)

    # B7's operands at the model's shapes: layers 0 and L-1 of an untimed
    # prefill of request 0's prompt (calls 0 and L-1) and of its first
    # decode step (calls L and 2L-1), on a cache of the Server's shape
    toks = torch.as_tensor(prompts[0], device=dev)[None]
    wanted = {0: "prefill_layer0", n_layers - 1: "prefill_last_layer",
              n_layers: "decode_layer0", 2 * n_layers - 1: "decode_last_layer"}
    captured, calls = {}, [0]
    real_fa = fa.flash_attention

    def capture(q, k, v, **kw):
        if calls[0] in wanted:
            captured[wanted[calls[0]]] = (q, k, v, dict(kw))
        calls[0] += 1
        return real_fa(q, k, v, **kw)

    fa.flash_attention = capture
    try:
        lg, cache_c = tm.prefill(params, cfg, {"tokens": toks},
                                 tm.init_decode_cache(cfg, 1, max_len))
        tm.decode_step(params, cfg, torch.argmax(lg[:, -1], -1)[:, None],
                       cache_c)
    finally:
        fa.flash_attention = real_fa
    if calls[0] != 2 * n_layers or len(captured) != len(wanted):
        raise RuntimeError(f"lm_serve: captured {sorted(captured)} of "
                           f"{calls[0]} B7 calls")
    if int(torch.argmax(lg[0, -1])) != tokens[0][0]:
        raise RuntimeError("lm_serve: the capture run's first token is not "
                           "the served one")
    del cache_c

    # per-step times, the prefill logits, and where the time goes
    cache = tm.init_decode_cache(cfg, 1, max_len)
    prefill_ms = []
    for _ in range(3):
        ms, (logits, cache2) = host_ms(
            lambda: tm.prefill(params, cfg, {"tokens": toks}, cache))
        prefill_ms.append(ms)
    if tuple(logits.shape) != (1, 1, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise RuntimeError(f"lm_serve: prefill logits {tuple(logits.shape)} "
                           f"not finite")
    nxt = torch.argmax(logits[:, -1], -1)[:, None]
    decode_ms = []
    for _ in range(DECODE_TIMED_STEPS):
        ms, (lg, cache2) = host_ms(
            lambda: tm.decode_step(params, cfg, nxt, cache2))
        decode_ms.append(ms)
        nxt = torch.argmax(lg[:, -1], -1)[:, None]
    prof_prefill = s.profile(
        lambda: tm.prefill(params, cfg, {"tokens": toks}, cache), [],
        classify=_b7_class)
    prof_decode = s.profile(
        lambda: tm.decode_step(params, cfg, nxt, cache2), [],
        classify=_b7_class)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    serve_log = {
        "model": LM_ARCH, "layers": n_layers, "d_model": cfg.d_model,
        "param_count_config": cfg.param_count(), "params": n_params,
        "params_gb": params_gb, "init_ms": init_ms,
        "requests": SERVE_REQUESTS, "batch": SERVE_BATCH,
        "prompt": SERVE_PROMPT, "max_new": SERVE_NEW,
        "b7_launches": counts["flash_attention"],
        "run_wall_s": [stats["wall_s"], stats2["wall_s"]],
        "tokens_per_s": [stats["tokens_per_s"], stats2["tokens_per_s"]],
        "stats": {k: stats[k] for k in ("prefills", "decode_steps",
                                        "tokens")},
        "prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms,
        "decode_ms_median": statistics.median(decode_ms),
        "peak_gb": peak_gb, "tokens_first_request": tokens[0][:8],
        "profile_prefill": prof_prefill, "profile_decode": prof_decode}
    del params, cache, cache2, logits, lg, leaves
    torch.cuda.empty_cache()

    # (c) B7 against its plain version at the model's shapes -------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(32)
    kvh, dh = cfg.n_kv_heads, cfg.head_dim

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    rows = DECODE_32K_ROWS
    captured["decode_32k"] = (rand(1, 1, cfg.n_heads, dh),
                              rand(1, rows, kvh, dh), rand(1, rows, kvh, dh),
                              dict(causal=True, q_start=rows - 1,
                                   kv_len=rows))
    checks, err_bf16 = {}, 0.0
    for name, (q, k, v, kw) in captured.items():
        got = fa.flash_attention(q, k, v, **kw)
        want = fa.flash_attention_reference(q, k, v, **kw)
        err = float((got.float() - want.float()).abs().max())
        if not err <= B7_BF16_ATOL:
            raise RuntimeError(f"lm_serve: B7 {name} off its plain version "
                               f"by {err} (bf16 bound {B7_BF16_ATOL})")
        err_bf16 = max(err_bf16, err)
        # the 0.05 ceiling is as large as a long decode's outputs: hold
        # each case to the Pallas recurrence at its route's kv tiles and
        # splits, in steps of its own outputs' size
        route = fa.flash_route(q.shape, k.shape, q.dtype, **kw)
        rec = fa.flash_attention_recurrence(
            q, k, v, block_k=route.block_k, splits=route.splits, **kw).float()
        off = (got.float() - rec).abs()
        beyond = float((off > 1e-6 + 2.0 ** -7 * rec.abs()).float().mean())
        rec_max, v_max = float(off.max()), float(v.float().abs().max())
        if not (beyond <= B7_REC_BEYOND
                and rec_max <= B7_REC_MAX_OF_V * v_max):
            raise RuntimeError(
                f"lm_serve: B7 {name} off the Pallas recurrence: "
                f"{beyond:.2e} of outputs beyond one bf16 step (bound "
                f"{B7_REC_BEYOND}), max {rec_max} (bound "
                f"{B7_REC_MAX_OF_V * v_max})")
        del rec, off
        # float32 on the same shapes, the cache cut to F32_CUT_ROWS
        cut = min(k.shape[1], F32_CUT_ROWS)
        kw32 = dict(kw)
        kw32["kv_len"] = min(kw["kv_len"], cut)
        kw32["q_start"] = min(kw.get("q_start", 0),
                              kw32["kv_len"] - q.shape[1])
        q32, k32, v32 = (x.float() for x in (q, k[:, :cut], v[:, :cut]))
        got32 = fa.flash_attention(q32, k32, v32, **kw32)
        want32 = fa.flash_attention_reference(q32, k32, v32, **kw32)
        err32 = float((got32 - want32).abs().max())
        if not err32 <= B7_F32_ATOL:
            raise RuntimeError(f"lm_serve: B7 {name} in float32 off its "
                               f"plain version by {err32} (bound "
                               f"{B7_F32_ATOL})")
        checks[name] = {"q": list(q.shape), "kv": list(k.shape),
                        "kw": kw, "route": route.name,
                        "splits": route.splits, "block_k": route.block_k,
                        "max_abs_err": err,
                        "max_abs_want": float(want.float().abs().max()),
                        "recurrence_max_abs_err": rec_max,
                        "recurrence_beyond_one_step": beyond,
                        "f32_kv_rows": cut, "f32_max_abs_err": err32}
    torch.cuda.synchronize()
    shapes = {}
    for name in ("prefill_layer0", "decode_layer0", "decode_32k"):
        q, k, v, kw = captured[name]
        bound, by = b7_bound_ms(q, k, kw)
        lib = sdpa_call(q, k, v, kw)
        lib_err = float((lib().transpose(1, 2).float()
                         - fa.flash_attention_reference(q, k, v, **kw)
                         .float()).abs().max())
        reps = 5 if q.shape[1] > 1 else 20
        route = fa.flash_route(q.shape, k.shape, q.dtype, **kw)
        shapes[name] = {
            "route": route.name, "splits": route.splits,
            "block_k": route.block_k,
            "ms": cuda_ms(lambda: fa.flash_attention(q, k, v, **kw), reps),
            "host_ms": host_ms_per_call(
                lambda: fa.flash_attention(q, k, v, **kw), reps),
            "plain_ms": cuda_ms(
                lambda: fa.flash_attention_reference(q, k, v, **kw), 3),
            "bound_ms": bound, "bound_by": by,
            "library_ms": cuda_ms(lib, reps),
            "library_max_abs_err": lib_err}
    pre = shapes["prefill_layer0"]
    s.record("flash_attention",
             "src/repro_torch/kernels/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:124",
             counts["flash_attention"], err_bf16, pre["ms"],
             pre["plain_ms"], pre["bound_ms"], pre["bound_by"],
             pre["library_ms"])
    s.kernels["flash_attention"]["shapes"] = shapes
    del captured
    torch.cuda.empty_cache()

    # (b) cache consistency, full width, float32, reduced depth ----------
    cfg32 = dataclasses.replace(cfg, n_layers=CHECK_LAYERS,
                                param_dtype="float32",
                                compute_dtype="float32")
    p32 = tm.init_params(cfg32, seed=0)
    t = torch.as_tensor(prompts[0][:CHECK_PREFILL + CHECK_DECODE],
                        device=dev)[None]
    cam_search.reset_launch_counts()
    full = tm.forward(p32, cfg32, {"tokens": t})
    cache = tm.init_decode_cache(cfg32, 1, CHECK_PREFILL + CHECK_DECODE + 1)
    lg, cache = tm.prefill(p32, cfg32, {"tokens": t[:, :CHECK_PREFILL]},
                           cache)
    outs = [lg]
    for i in range(CHECK_PREFILL, CHECK_PREFILL + CHECK_DECODE):
        lg, cache = tm.decode_step(p32, cfg32, t[:, i:i + 1], cache)
        outs.append(lg)
    torch.cuda.synchronize()
    check_launches = cam_search.LAUNCHES["flash_attention"]
    if check_launches != CHECK_LAYERS * (2 + CHECK_DECODE):
        raise RuntimeError(f"lm_serve: float32 check launched B7 "
                           f"{check_launches} times")
    got = torch.cat(outs, dim=1)[0]
    want = full[0, CHECK_PREFILL - 1:]
    diff = (got - want).abs()
    if not bool((diff <= 0.75 + 0.2 * want.abs()).all()):
        raise RuntimeError(f"lm_serve: prefill+decode off forward by "
                           f"{float(diff.max())}")
    pick = got.argmax(-1)
    at_pick = want.gather(-1, pick[:, None])[:, 0]
    gap = want.max(-1).values - at_pick
    flips = int((pick != want.argmax(-1)).sum())
    if bool(((pick != want.argmax(-1)) & (gap >= 5e-3)).any()):
        raise RuntimeError(f"lm_serve: argmax flips beyond near-ties: gaps "
                           f"{gap.tolist()}")
    del p32, cache, full
    torch.cuda.empty_cache()
    log({"phase": "lm_serve", "ok": True, **serve_log,
         "b7_checks": checks, "b7_shapes": shapes,
         "f32_check": {"layers": CHECK_LAYERS, "prefill": CHECK_PREFILL,
                       "decode_steps": CHECK_DECODE,
                       "b7_launches": check_launches,
                       "max_abs_diff": float(diff.max()),
                       "argmax_flips_near_ties": flips}})


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs an NVIDIA GPU")
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        fail(f"the port's package is missing: {src}/repro_torch")
    sys.path.insert(0, src)
    import repro_torch.kernels.build as kbuild

    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions and
    torch.backends.cudnn.allow_tf32 = False         # yardsticks in float32
    # bf16 products accumulate in float32, as the reference's
    # preferred_element_type asks
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    smi = nvidia_smi("name,power.limit")
    print(smi, flush=True)
    clock = nvidia_smi("clocks.max.sm")
    props = torch.cuda.get_device_properties(0)
    max_mhz = float(clock.split()[0]) if clock else props.clock_rate / 1e3 \
        if hasattr(props, "clock_rate") else 1980.0
    log({"device": {"nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
                    "sms": props.multi_processor_count,
                    "max_sm_clock_mhz": max_mhz, "torch": torch.__version__,
                    "cuda": torch.version.cuda}})

    s = Smoke(torch, props, max_mhz)
    t0 = time.perf_counter()
    try:
        built = kbuild.build()
    except Exception:       # noqa: BLE001 — report and stop: nothing runs
        traceback.print_exc()
        fail("the CUDA kernels did not build")
    regs = {n: [ln.split(":", 1)[1].strip()
                for ln in kbuild.build_log(n).splitlines()
                if "registers" in ln] for n in kbuild.SOURCES}
    log({"phase": "build", "ok": True, "seconds": time.perf_counter() - t0,
         "built": built, "ptxas": regs})

    from repro_torch.data import knn_dataset
    t0 = time.perf_counter()
    data = knn_dataset(**KNN_DATA)             # 180,000 x 1024, 624 queries
    log({"phase": "data", "seconds": time.perf_counter() - t0,
         "gallery": list(data[0].shape), "queries": list(data[2].shape)})

    phases = [("knn_eucl", lambda: phase_knn_eucl(s, data)),
              ("hamming_packed",
               lambda: _packed_phase(s, "hamming_packed", data, False)),
              ("tcam_ternary",
               lambda: _packed_phase(s, "tcam_ternary", data, True)),
              ("hdc_quickstart", lambda: phase_hdc_quickstart(s)),
              ("forest_acam", lambda: phase_forest_acam(s)),
              ("range_threshold", lambda: phase_range_threshold(s, data)),
              ("hdc_mnist", lambda: phase_hdc_mnist(s)),
              ("gallery_update", lambda: phase_gallery_update(s, data)),
              ("distance_ops", lambda: phase_distance_ops(s, data)),
              ("queue_c", lambda: phase_queue_c(s, data)),
              ("cam_serve", lambda: phase_cam_serve(s, data)),
              ("gateway_serve", lambda: phase_gateway_serve(s, data)),
              ("tune", lambda: phase_tune(s, data)),
              ("hier_search", lambda: phase_hier_search(s, data)),
              ("sharded", lambda: phase_sharded(s, data)),
              ("lm_serve", lambda: phase_lm_serve(s))]
    wanted = sys.argv[1:]
    unknown = set(wanted) - {name for name, _ in phases}
    if unknown:
        fail(f"unknown phases {sorted(unknown)}")
    phases = [(n, run) for n, run in phases if not wanted or n in wanted]
    for name, run in phases:
        t0 = time.perf_counter()
        try:
            run()
        except Exception as e:  # noqa: BLE001 — a failed phase fails the run
            traceback.print_exc()
            s.failed.append(name)
            log({"phase": name, "ok": False, "error": repr(e)})
        finally:
            torch.cuda.empty_cache()
        log({"phase_seconds": {name: time.perf_counter() - t0}})
    if s.failed:
        fail(f"failed phases: {s.failed}")
    order = ["fused_topk_packed", "fused_topk_packed_ternary", "fused_topk",
             "acam_match", "range_match", "hdc_encode", "hdc_encode_wide",
             "distance", "distance_topk", "distance_topk_packed",
             "topk_select", "packed_distance", "flash_attention"]
    print(smi, flush=True)
    log({"kernels": [s.kernels[n] for n in order
                     if not wanted or n in s.kernels]})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
