#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Drives the port's main path — ``compile_fn``/``compile_module`` ->
``get_plan`` -> ``SearchPlan.execute`` with the default device (the GPU)
and backend (``"cuda"``) — on the paper's two workloads at full size:

* ``knn_eucl``       — KNN, Euclidean top-5, 180,000 x 1024 gallery
                       (float32, 737 MB on the card), 624 queries:
                       kernel ``fused_topk``;
* ``hamming_packed`` — hamming top-10 on the same gallery binarised
                       ``> 0``: kernel ``fused_topk_packed``;
* ``tcam_ternary``   — the same with a 10 % wildcard care mask:
                       kernel ``fused_topk_packed`` (ternary);
* ``hdc_quickstart`` — HDC associative-memory recall, dot top-1 over
                       10 x 8192 class hypervectors, 64 queries
                       (auto-packed): kernel ``fused_topk_packed``.

For each phase it sets the kernels' launch counts to 0, runs the path,
reads the counts (a kernel of the path with no launch fails the run),
checks the results, then calls the kernel wrapper and its plain PyTorch
version on the operands of the path's first micro-batch and compares
them (bit-identical for the integer metrics; eucl: every candidate
value within ``EUCL_RTOL``/``EUCL_ATOL``, and every candidate and result
index swap confirmed as a float64 near-tie), and times kernel, plain version and one PyTorch library call
with CUDA events (medians).  The last two lines of standard output are
the ``{"kernels": [...]}`` record and ``{"ok": true, "device": ...}``.

It exits non-zero, printing no result, when no CUDA device is present,
when ``src/repro_torch`` is not beside it, or when any phase fails.

    python3 chip_smoke.py
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
#: H100 SXM peaks (NVIDIA data sheet): float32 on the CUDA cores, HBM3
FP32_PEAK_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
#: 32-bit population counts per clock per SM, compute capability 9.0
#: (CUDA C++ Programming Guide, arithmetic instruction throughput table)
POPC_PER_CLOCK_PER_SM = 16


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
        self.kernels = {}        # name -> record for the final line
        self.failed = []

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
        if not (torch.equal(out[0], out2[0]) and torch.equal(out[1], out2[1])):
            raise RuntimeError(f"{name}: a repeated call changed the result")
        return out, counts, t1 - t0, t2 - t1

    def profile(self, prog, inputs, top: int = 6):
        """Where one warm call's time goes: ``torch.profiler`` over a
        call that ends in a synchronise; device time by kernel, and the
        share of the wall window in which the device ran nothing."""
        torch = self.torch
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            prog(*inputs)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        rows = []          # device-side events only: kernels, copies, sets
        try:
            for e in prof.key_averages():
                if not str(getattr(e, "device_type", "")).endswith("CUDA"):
                    continue
                dev_us = getattr(e, "self_device_time_total", None)
                if dev_us is None:
                    dev_us = e.self_cuda_time_total
                if dev_us > 0:
                    rows.append((dev_us / 1e3, e.key, e.count))
        except (AttributeError, RuntimeError) as e:  # the profiler's API only
            return {"not_measured": repr(e)}
        rows.sort(reverse=True)
        device_ms = sum(r[0] for r in rows)
        # negative when the summed device time exceeds the wall window
        return {"wall_ms": wall_ms, "device_ms": device_ms,
                "device_idle_share": 1 - device_ms / wall_ms,
                "top": [{"ms": ms, "op": key[:80], "count": n}
                        for ms, key, n in rows[:top]]}

    def kernel_operands(self, prog, inputs):
        """The (args, kwargs) the path's first micro-batch hands its
        kernel wrapper, rebuilt from the plan's own prepared gallery."""
        from repro_torch.core.engine.executables import _cuda_operands
        torch = self.torch
        plan = prog.engine_plan
        spec = plan.spec
        q = inputs[spec.query_arg]
        chunk = q[:plan.batch]
        if chunk.shape[0] < plan.batch:
            chunk = torch.nn.functional.pad(
                chunk, (0, 0, 0, plan.batch - chunk.shape[0]))
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

    def float_bound_ms(self, q, p, out_cols):
        m, d = q.shape
        n = p.shape[0]
        flops = 2.0 * m * n * d + 2.0 * (m + n) * d
        bytes_ = 4.0 * (m * d + n * d) + 8.0 * m * out_cols
        t_ops, t_mem = flops / FP32_PEAK_FLOPS, bytes_ / HBM_BYTES_PER_S
        return 1e3 * max(t_ops, t_mem), "operations" if t_ops >= t_mem \
            else "bytes"

    def packed_bound_ms(self, q, p, care, out_cols):
        m, lanes = q.shape
        n = p.shape[0]
        popc = float(m) * n * lanes
        bytes_ = 4.0 * (m * lanes + n * lanes * (2 if care is not None
                                                  else 1)) \
            + 8.0 * m * out_cols
        t_ops, t_mem = popc / self.popc_per_s, bytes_ / HBM_BYTES_PER_S
        return 1e3 * max(t_ops, t_mem), "operations" if t_ops >= t_mem \
            else "bytes"


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
    if v.shape != (624, 5) or i.dtype != torch.int32 or \
            not bool(torch.isfinite(v).all()):
        raise RuntimeError(f"knn_eucl: bad result {v.shape} {i.dtype}")

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
    pv, pi = pv[:624], pi[:624]
    tol = EUCL_ATOL + EUCL_RTOL * pv.abs()
    if not bool(((v - pv).abs() <= tol).all()):
        raise RuntimeError(f"knn_eucl: values off the plain version by "
                           f"{float((v - pv).abs().max())}")
    swaps = eucl_index_swaps(qp, pp, i, pi, "knn_eucl result")
    gl = torch.from_numpy(g_labels).cuda().long()
    votes = gl[i.long()].sum(1)                  # two classes: 0 / 1
    acc5 = float(((votes >= 3).long().cpu().numpy() == q_labels).mean())

    out_cols = got[0].shape[1]
    bound, by = s.float_bound_ms(qp, pp, out_cols)
    ms = cuda_ms(lambda: cam_search.fused_topk(*args, **kw), 10)
    plain_ms = cuda_ms(lambda: cam_search.fused_topk_reference(*args, **kw),
                       5)
    library_ms = cuda_ms(lambda: torch.cdist(qp, pp).topk(5, largest=False),
                         5)
    s.record("fused_topk", "src/repro_torch/kernels/csrc/fused_topk.cu",
             "src/repro/kernels/cam_search.py:200", counts["fused_topk"], err,
             ms, plain_ms, bound, by, library_ms)
    log({"phase": "knn_eucl", "ok": True, "launches": counts,
         "first_call_s": first_s, "second_call_s": second_s,
         "kernel_shape": {"q": list(qp.shape), "p": list(pp.shape),
                          "k": kw["k"]},
         "candidate_max_abs_err": err,
         "candidate_index_swaps_float64_near_ties": cand_swaps,
         "result_index_swaps_float64_near_ties": swaps,
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
    bound, by = s.packed_bound_ms(qp, pp, cp, got[0].shape[1])
    ms = cuda_ms(lambda: cam_search.fused_topk_packed(*args, **kw), 10)
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
    log({"phase": name, "ok": True, "launches": counts,
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
    data = knn_dataset()                       # 180,000 x 1024, 624 queries
    log({"phase": "data", "seconds": time.perf_counter() - t0,
         "gallery": list(data[0].shape), "queries": list(data[2].shape)})

    phases = [("knn_eucl", lambda: phase_knn_eucl(s, data)),
              ("hamming_packed",
               lambda: _packed_phase(s, "hamming_packed", data, False)),
              ("tcam_ternary",
               lambda: _packed_phase(s, "tcam_ternary", data, True)),
              ("hdc_quickstart", lambda: phase_hdc_quickstart(s))]
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
    order = ["fused_topk_packed", "fused_topk_packed_ternary", "fused_topk"]
    print(smi, flush=True)
    log({"kernels": [s.kernels[n] for n in order]})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
