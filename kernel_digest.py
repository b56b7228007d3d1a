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
  the route they share.

For each it prints the SHA-256 of the output's bytes and, for B4 eucl,
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

ROOT = os.path.dirname(os.path.abspath(__file__))


def digest(t) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


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

    enc = call()
    times = []
    for _ in range(50):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        call()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return {"sha256": digest(enc), "b5_ms": statistics.median(times)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("kernel_digest: needs a CUDA device")
    sys.path.insert(0, os.path.join(os.path.abspath(args.tree), "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.data import knn_dataset
    from repro_torch.kernels import acam, build, cam_search, ops
    build.build()
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
    out = {"tree": os.path.abspath(args.tree), "tau": tau,
           "device": torch.cuda.get_device_name(0)}
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
    text = json.dumps(out)
    print(text)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")


if __name__ == "__main__":
    main()
