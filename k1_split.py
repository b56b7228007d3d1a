#!/usr/bin/env python3
"""K1s (``topk_select``) on the GPU at each cluster split, side by side.

``cam_search.select_split`` picks how many blocks (a thread block
cluster of 1, 2, 4 or 8) select from one row of the (M, N) matrix.  This
script times ``topk_select`` at every split (by standing in for
``select_split``) on the matrices of the
smoke's ``queue_c`` phase: B6's eucl matrix of ``knn_dataset()`` (624
queries x 180,000 rows, k = 500) and K1p's packed hamming matrix of the
same data binarised ``> 0`` (180,096 padded rows, k = 400), each at the
624 queries and at a 13-row micro-batch.  Each split's result is checked
bit for bit against ``topk_select_reference``; times are CUDA-event
medians of ``--reps`` calls, the splits timed in turns (1, 2, 4, 8,
8, 4, 2, 1).  Prints one JSON object (and writes it to ``--out`` if
given); needs one CUDA card:

    PYTHONPATH=src python3 k1_split.py --out k1_split.json
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
SPLITS = (1, 2, 4, 8)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("k1_split: needs a CUDA device")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.data import knn_dataset
    from repro_torch.kernels import cam_search
    from repro_torch.kernels import ops
    from repro_torch.kernels.packing import pack_bits

    g, _, q, _ = knn_dataset()
    gt, qt = torch.from_numpy(g).cuda(), torch.from_numpy(q).cuda()
    n = g.shape[0]
    lanes_q = ops.pad_to_blocks(pack_bits(qt > 0), 1, cam_search.BLOCK_K)
    lanes_g = ops.pad_to_blocks(pack_bits(gt > 0), cam_search.PACKED_ROWS,
                                cam_search.BLOCK_K)
    cases = {"eucl": (lambda qr: cam_search.distance(qr, gt, metric="eucl"),
                      qt, 500),
             "packed": (lambda qr: cam_search.packed_distance(qr, lanes_g),
                        lanes_q, 400)}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out = {"device": smi, "reps": args.reps, "chosen": {}, "ms": {}}
    choose = cam_search.select_split
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def select(dist, split, **kw):
        cam_search.select_split = lambda *a: split
        try:
            return cam_search.topk_select(dist, **kw)
        finally:
            cam_search.select_split = choose

    for name, (matrix, qs, k) in cases.items():
        for rows in (qs.shape[0], 13):
            dist = matrix(qs[:rows].contiguous())
            kw = dict(k=k, largest=False, n_valid=n)
            want = cam_search.topk_select_reference(dist, **kw)
            key = f"{name}_{rows}"
            out["chosen"][key] = choose(rows, k, n, sms)
            times = {c: [] for c in SPLITS}
            for c in SPLITS:
                got = select(dist, c, **kw)
                if not (torch.equal(got[0].view(torch.int32),
                                    want[0].view(torch.int32))
                        and torch.equal(got[1], want[1])):
                    sys.exit(f"k1_split: {key} split {c} differs from the "
                             f"plain version")
            for c in SPLITS + SPLITS[::-1]:
                for _ in range(args.reps):
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e0.record()
                    select(dist, c, **kw)
                    e1.record()
                    e1.synchronize()
                    times[c].append(e0.elapsed_time(e1))
            out["ms"][key] = {c: statistics.median(t) for c, t in times.items()}
            del dist
            torch.cuda.empty_cache()
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
