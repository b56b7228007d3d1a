#!/usr/bin/env python3
"""Digests of kernel outputs on fixed inputs, to hold two trees' kernels
against each other bit for bit on one card.

Loads ``repro_torch`` from ``--tree`` (default: this checkout), builds its
kernels, and runs them on the smoke's KNN data (``knn_dataset()``: 624
queries, 180,000 x 1024 gallery) at the shapes the smoke gives them:

* B4 ``range_match``, eucl, at the 624 rows of the path and at the
  1024-row micro-batch earlier trees padded it to (400 zero rows), with
  ``tau`` the median over the queries of the 5th-nearest squared distance
  in float64 (rounded to float32; printed, so two runs can be seen to use
  the same one); and on the binarised data as float-cell hamming;
* B6 ``distance``, eucl and hamming, at 624 rows;
* B5 ``hdc_encode_planes`` at HDC/MNIST-8k's test shape (10,000 x 784
  features -> 8192 dims, 16 levels, an ``ItemMemory`` of seed 0, features
  from ``default_rng(3)``), with its median CUDA-event time over 50
  launches (``b5_ms``): two trees timed in one call, in turns, compare
  the route they share;
* B7 ``flash_attention`` (bf16, no gradient: the serving path) at the
  smoke's prefill and decode shapes (``B7_SHAPES``), on operands from a
  seeded generator, with its median CUDA-event time over 50 launches
  (``ms``: the wrapper's host work included, as the smoke's), the host
  ms a call of 50 enqueued back to back (``host_ms``) and the device ms
  a call under ``torch.profiler`` (``device_ms``);
* B7's backward (``flash_attention_backward``, bf16) at ``chip_smoke.py``'s
  ``B7B_SHAPES``, from the forward's output and log-sum-exp on seeded
  operands: the digest of (dq, dk, dv), the median CUDA-event ms over 20
  calls (``ms``), its steps' device ms (``kernel_ms``: pre-pass, dK / dV,
  dQ and, at dh 256, the slices' sum) and the route, where the tree has
  ``flash_bwd_route``.

* K1p ``packed_distance`` (binary and, with a seeded 10 % wildcard care
  mask, ternary) on the smoke's binarised KNN lanes (180,096 padded rows
  x 32 lanes) at ``queue_c``'s 624 queries and its 13-row micro-batch;
  K1s ``topk_select`` on B6's eucl matrix (k = 500) and on K1p's packed
  matrix (k = 400) at the same rows (``n_valid`` 180,000), with
  ``torch.topk``'s and, for K1p, ``addmm``'s time on the same inputs; and
  B1 ``fused_topk_packed`` at the KNN shape (k = 10): each with its
  median CUDA-event ms over 20 calls and its device ms under
  ``torch.profiler`` (``--k1-only`` runs these alone).

* M1 ``ssd_scan`` at zamba2-2.7b's widths (bf16, ``chip_smoke.
  m1_long_operands``: a carried state, chunk 256) over 2,048 rows, a
  32,768-row piece and 524,288 rows, and X1 ``slstm_scan`` at batch 1,
  D 768 over 2,048, 16,384 and 524,288 positions on seeded operands:
  each with its digest and median CUDA-event ms over 3 calls after one
  warm-up (``--scan-only`` runs these alone).

``--b7-only`` runs the B7 records alone.  For each it prints the SHA-256 of the output's bytes and, for B4 eucl,
the disagreements with the plain version.  Equal digests from two trees
mean equal results.  Prints one JSON object (and writes it to ``--out``
if given); needs one CUDA card:

    python3 kernel_digest.py --tree build/parent --out parent.json
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def digest(t) -> str:
    import torch       # the output's bytes, bf16 included (numpy has none)
    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes()).hexdigest()


def median_ms(torch, call, reps: int = 50) -> float:
    """Median CUDA-event ms of ``call`` over ``reps`` launches."""
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        call()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


#: B7's serving calls in the smoke: (B, S, T, H, KV, dh) and masks
B7_SHAPES = {
    "qwen_prefill": ((1, 2048, 2048, 40, 8, 128), dict(causal=True)),
    "qwen_decode": ((1, 1, 2049, 40, 8, 128), dict(causal=True,
                                                    q_start=2048)),
    # lm_serve's own calls: a layer's view of a 2,081-row cache
    "qwen_serve_prefill": ((1, 2048, 2081, 40, 8, 128),
                           dict(causal=True, kv_len=2048)),
    "qwen_serve_decode": ((1, 1, 2081, 40, 8, 128),
                          dict(causal=True, kv_len=2049, q_start=2048)),
    "whisper_encoder": ((1, 1500, 1500, 16, 16, 64), dict(causal=False)),
    "zamba2_prefill": ((1, 2048, 2048, 32, 32, 80), dict(causal=True)),
    "paligemma_prefill": ((1, 2304, 2304, 8, 1, 256),
                          dict(causal=True, prefix_len=256)),
}


def flash_records(torch) -> dict:
    """B7 at each of ``B7_SHAPES``: digest and median event ms."""
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    out = {}
    for name, ((b, s, t, h, kvh, dh), kw) in B7_SHAPES.items():
        q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                   .bfloat16() for shape in ((b, s, h, dh), (b, t, kvh, dh),
                                             (b, t, kvh, dh)))

        def call():
            return fa.flash_attention(q, k, v, **kw)

        out[name] = {"sha256": digest(call().view(torch.int16)),
                     "ms": median_ms(torch, call),
                     "host_ms": host_ms(torch, call),
                     "device_ms": device_ms(torch, call)}
    return out


def flash_backward_records(torch) -> dict:
    """B7b at each of ``chip_smoke.B7B_SHAPES`` in bf16: digest, median
    event ms, device ms by step, route."""
    from chip_smoke import B7B_SHAPES, b7b_kernel_ms
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    out = {}
    for name, ((b, s, t, h, kvh, dh), kw) in B7B_SHAPES.items():
        q, k, v, d_out = (torch.randn(shape, generator=gen, device="cuda")
                          .bfloat16() for shape in (
                              (b, s, h, dh), (b, t, kvh, dh), (b, t, kvh, dh),
                              (b, s, h, dh)))
        o, lse = fa._forward_cuda(q, k, v, kw.get("causal", True),
                                  kw.get("prefix_len", 0), kw.get("kv_len"),
                                  kw.get("q_start", 0), want_lse=True)

        def call():
            return fa.flash_attention_backward(q, k, v, o, lse, d_out, **kw)

        grads = call()
        rec = {"sha256": digest(torch.cat([g.reshape(-1) for g in grads])
                                .view(torch.int16)),
               "ms": median_ms(torch, call, 20),
               "kernel_ms": b7b_kernel_ms(
                   call, sliced=fa._padded_dim(dh) == 256)}
        if hasattr(fa, "flash_bwd_route"):
            rec["route"] = fa.flash_bwd_route(q.shape, k.shape, q.dtype,
                                              **kw).name
        out[name] = rec
        del q, k, v, d_out, o, lse, grads
        torch.cuda.empty_cache()
    return out


def host_ms(torch, call, n: int = 50) -> float:
    """Host ms a call of ``n`` calls enqueued back to back."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        call()
    took = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * took / n


def device_ms(torch, call, n: int = 20) -> float:
    """Device ms a call: every kernel's device time under
    ``torch.profiler`` over ``n`` calls, over ``n``."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            total += getattr(e, "self_device_time_total", 0.0)
    return total / 1e3 / n


def hdc_encode_record(torch) -> dict:
    """B5 at HDC/MNIST-8k's test shape: digest and median event ms."""
    import numpy as np
    from repro_torch.hdc import ItemMemory
    from repro_torch.kernels import hdc_encode as khdc
    item = ItemMemory(784, dim=8192, n_levels=16, seed=0)
    x = np.random.default_rng(3).random((10000, 784), dtype=np.float32)
    q = item.level_ids(x)

    def call():
        return khdc.hdc_encode_planes(q, item._planes)

    return {"sha256": digest(call()), "b5_ms": median_ms(torch, call)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--out")
    ap.add_argument("--b7-only", action="store_true",
                    help="only B7's forward and backward records")
    ap.add_argument("--k1-only", action="store_true",
                    help="only K1p's, K1s's and B1's records")
    ap.add_argument("--scan-only", action="store_true",
                    help="only M1's and X1's records")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("kernel_digest: needs a CUDA device")
    sys.path.insert(0, os.path.join(os.path.abspath(args.tree), "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import build
    build.build()
    out = {"tree": os.path.abspath(args.tree),
           "device": torch.cuda.get_device_name(0)}
    if args.scan_only:
        out["scans"] = scan_records(torch)
    elif args.k1_only:
        out["k1"] = k1_records(torch)
    else:
        if not args.b7_only:
            out.update(cam_records(torch))
        out["flash_attention"] = flash_records(torch)
        out["flash_attention_bwd"] = flash_backward_records(torch)
    text = json.dumps(out)
    print(text)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")


#: the scans' shapes: M1's rows at zamba2-2.7b's widths, X1's positions
M1_ROWS, X1_POSITIONS, X1_D = (2048, 32768, 524288), (2048, 16384, 524288), 768


def scan_records(torch) -> dict:
    """M1 and X1 at the smoke's shapes: digests and median ms of 3."""
    from chip_smoke import m1_long_operands
    from repro_torch.kernels import slstm_scan as ksl, ssd_scan as kss
    out = {}
    for rows in M1_ROWS:
        args, kw = m1_long_operands(torch.device("cuda"), rows)
        def call():
            return kss.ssd_scan(*args, **kw)
        y, h = call()
        out[f"m1_{rows}"] = {"sha256": digest(y), "state_sha256": digest(h),
                             "ms": median_ms(torch, call, 3)}
        del args, y, h
        torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    d = X1_D
    pre_all = torch.randn((1, max(X1_POSITIONS), 4 * d), generator=gen,
                          device="cuda")
    wh = torch.randn((d, 4 * d), generator=gen, device="cuda") / d ** 0.5
    n0 = torch.rand((1, d), generator=gen, device="cuda") * 2 + 1
    state = (torch.rand((1, d), generator=gen, device="cuda") * 2 - 1,
             (torch.rand((1, d), generator=gen, device="cuda") * 2 - 1) * n0,
             n0, torch.randn((1, d), generator=gen, device="cuda"))
    for s in X1_POSITIONS:
        pre = pre_all[:, :s].contiguous()
        def call():
            return ksl.slstm_scan(pre, wh, *state)
        hs, _ = call()
        ms = median_ms(torch, call, 3)
        out[f"x1_{s}"] = {"sha256": digest(hs), "ms": ms,
                          "us_per_position": 1e3 * ms / s}
        del pre, hs
    return out


def cam_records(torch) -> dict:
    """B4, B6 and B5 on the smoke's KNN and HDC data: digests (B4's
    disagreements with its plain version, B5's median ms)."""
    from repro_torch.data import knn_dataset
    from repro_torch.kernels import acam, cam_search, ops
    g, _, q, _ = knn_dataset()
    gt, qt = torch.from_numpy(g).cuda(), torch.from_numpy(q).cuda()
    d64 = ((qt.double() ** 2).sum(1, keepdim=True) - 2 * qt.double()
           @ gt.double().T + (gt.double() ** 2).sum(1)[None])
    tau = float(torch.tensor(float(d64.topk(5, largest=False).values[:, 4]
                                   .median()), dtype=torch.float32))
    del d64
    qp, pp = ops.pad_to_blocks(qt, 1, 8), ops.pad_to_blocks(gt, 1, 8)
    qpad = torch.nn.functional.pad(qp, (0, 0, 0, 1024 - qp.shape[0]))
    kw = dict(metric="eucl", threshold=tau, below=True,
              to_logical="identity", dim=gt.shape[1], n_valid=gt.shape[0])
    out = {"tau": tau}
    for name, qx in (("range_eucl_624", qp), ("range_eucl_1024", qpad)):
        got = acam.range_match(qx, pp, **kw)
        want = acam.range_match_reference(qx, pp, **kw)
        out[name] = {"sha256": digest(got),
                     "disagreements": int((got != want).sum())}
    qb, gb = (qp > 0).float(), (pp > 0).float()
    hkw = dict(kw, metric="hamming", threshold=float(gt.shape[1]) / 2)
    out["range_hamming_624"] = {"sha256": digest(acam.range_match(qb, gb,
                                                                  **hkw))}
    for metric, a, b in (("eucl", qp, pp), ("hamming", qb, gb)):
        out[f"distance_{metric}_624"] = {
            "sha256": digest(cam_search.distance(a, b, metric=metric))}
    out["hdc_encode_mnist"] = hdc_encode_record(torch)
    return out


def k1_records(torch) -> dict:
    """K1p, K1s and B1 at ``queue_c``'s shapes: digest, median event ms,
    device ms; ``torch.topk`` and ``addmm`` beside them."""
    import numpy as np
    from repro_torch.data import knn_dataset
    from repro_torch.kernels import cam_search, ops
    from repro_torch.kernels.packing import pack_bits, unpack_bits
    g, _, q, _ = knn_dataset()
    gt, qt = torch.from_numpy(g).cuda(), torch.from_numpy(q).cuda()
    n = g.shape[0]
    rows_g, blk = cam_search.PACKED_ROWS, cam_search.BLOCK_K
    lanes_q = ops.pad_to_blocks(pack_bits(qt > 0), 1, blk)
    lanes_g = ops.pad_to_blocks(pack_bits(gt > 0), rows_g, blk)
    wild = torch.from_numpy(np.random.default_rng(5).random(g.shape) > 0.1)
    care = ops.pad_to_blocks(pack_bits(wild.cuda()), rows_g, blk)
    del wild

    def rec(call, parts):
        res = call()
        flat = torch.cat([t.contiguous().view(torch.int32).reshape(-1)
                          for t in parts(res)])
        return {"sha256": digest(flat), "ms": median_ms(torch, call, 20),
                "device_ms": device_ms(torch, call, 10)}

    out = {}
    for rows in (qt.shape[0], 13):
        qr = lanes_q[:rows].contiguous()
        for name, c in (("binary", None), ("ternary", care)):
            out[f"k1p_{name}_{rows}"] = rec(
                lambda: cam_search.packed_distance(qr, lanes_g, c),
                lambda d: [d])
        # the library yardstick: (D - q.p) / 2 over the +-1 cells
        qpm = 2 * unpack_bits(qr, qr.shape[1] * 32).float() - 1
        gpm = 2 * unpack_bits(lanes_g, lanes_g.shape[1] * 32).float() - 1
        half = torch.full((1,), qpm.shape[1] / 2, device="cuda")
        out[f"k1p_binary_{rows}"]["addmm_ms"] = median_ms(
            torch, lambda: torch.addmm(half, qpm, gpm.T, alpha=-0.5), 5)
        del qpm, gpm
        torch.cuda.empty_cache()
        for kind, k in (("eucl", 500), ("packed", 400)):
            d = cam_search.distance(qt[:rows].contiguous(), gt, metric="eucl") \
                if kind == "eucl" else cam_search.packed_distance(qr, lanes_g)
            r = rec(lambda: cam_search.topk_select(d, k=k, largest=False,
                                                   n_valid=n),
                    lambda vi: list(vi))
            r["topk_ms"] = median_ms(
                torch, lambda: torch.topk(d[:, :n], k, largest=False), 5)
            out[f"k1s_{kind}_{rows}"] = r
            del d
            torch.cuda.empty_cache()
    out["b1_knn_k10"] = rec(
        lambda: cam_search.fused_topk_packed(lanes_q, lanes_g, None, k=10,
                                             largest=False, n_valid=n),
        lambda vi: list(vi))
    return out


if __name__ == "__main__":
    main()
