#!/usr/bin/env python3
"""B6 (``distance``) on the GPU: its two epilogue stores, timed side by side.

``csrc/distance.cu`` stores the distance matrix straight from the
accumulator fragment (a quad of threads owns 32 contiguous bytes of a
row, 8-byte stores).  The alternative stages the fragment through the
freed ring stages and writes 16-byte stores of whole rows.  This script
builds both with ``nvcc`` (the port's flags) into ``build/b6_ablation/``:
the source as it is, and a copy with its store loop replaced by the
staged one (by exact text; the script stops if the source no longer
holds that text).  Each is timed with CUDA events (median of ``--reps``
calls, the two in turns) at the shape of the smoke's ``distance_ops``:
``knn_dataset()`` (624 queries, 180,000 x 1024 gallery), eucl, and the
data binarised ``> 0`` as hamming.  Their outputs are checked equal bit
for bit.  Prints one JSON object (and writes it to ``--out`` if given);
needs one CUDA card:

    PYTHONPATH=src python3 b6_ablation.py --out b6.json
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
#: the store loop of distance.cu, from the accumulator fragment
FRAGMENT_STORE = r"""  const bool vec = (N & 1) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + r0 + 8 * h;
    if (row >= M) continue;
    float* orow = out + size_t(row) * N;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      const float d0 = acc[4 * j + 2 * h], d1 = acc[4 * j + 2 * h + 1];
      if (vec && col + 1 < N) {
        *reinterpret_cast<float2*>(orow + col) = make_float2(d0, d1);
      } else {
        if (col < N) orow[col] = d0;
        if (col + 1 < N) orow[col + 1] = d1;
      }
    }
  }
"""
#: the staged alternative: this warpgroup's 64 rows x 128 floats into the
#: ring (32 KB a warpgroup), 16-byte chunks swizzled by row, then 16-byte
#: stores of whole rows
STAGED_STORE = r"""  unsigned char* tile = smem + w * 64 * 512;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = 8 * j + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = r0 + 8 * h - 64 * w;
      const int chunk = c >> 2;
      const int off = rl * 512 + (((chunk & ~7) | ((chunk ^ rl) & 7)) << 4) + (c & 3) * 4;
      *reinterpret_cast<float2*>(tile + off) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + w) : "memory");
  const bool vec = (N & 3) == 0;
#pragma unroll 4
  for (int i = 0; i < 16; ++i) {
    const int idx = ctid + 128 * i;                 // 64 rows x 32 chunks
    const int rl = idx >> 5, chunk = idx & 31;
    const int row = m0 + 64 * w + rl;
    const int col = n0 + 4 * chunk;
    if (row >= M || col >= N) continue;
    const float4 v = *reinterpret_cast<const float4*>(
        tile + rl * 512 + (((chunk & ~7) | ((chunk ^ rl) & 7)) << 4));
    float* dst = out + size_t(row) * N + col;
    if (vec) {
      *reinterpret_cast<float4*>(dst) = v;
    } else {
      const float f[4] = {v.x, v.y, v.z, v.w};
      for (int e = 0; e < 4 && col + e < N; ++e) dst[e] = f[e];
    }
  }
"""


def build(out_dir: str, nvcc_flags) -> dict:
    """Both libraries, built in parallel: {variant: path}."""
    os.makedirs(out_dir, exist_ok=True)
    source = open(os.path.join(CSRC, "distance.cu")).read()
    if source.count(FRAGMENT_STORE) != 1:
        sys.exit("b6_ablation: distance.cu no longer holds the store loop "
                 "this script replaces; update the script")
    sources = {"fragment": source,
               "staged": source.replace(FRAGMENT_STORE, STAGED_STORE)}
    procs, libs = {}, {}
    for name, text in sources.items():
        src = os.path.join(out_dir, f"distance_{name}.cu")
        with open(src, "w") as fh:
            fh.write(text)
        lib = libs[name] = os.path.join(out_dir, f"libdistance_{name}.so")
        cmd = ["nvcc", *nvcc_flags, "-I", CSRC, "-o", lib, src]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        out, _ = proc.communicate(timeout=600)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
    return libs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("b6_ablation: needs a CUDA device")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.data import knn_dataset
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import cam_search
    flags = [f for f in kbuild.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    libs = build(os.path.join(ROOT, "build", "b6_ablation"), flags)
    fns = {}
    for name, path in libs.items():
        f = ctypes.CDLL(path).c4cam_distance
        f.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        f.restype = ctypes.c_int
        fns[name] = f
    g, _, q, _ = knn_dataset()
    gt, qt = torch.from_numpy(g).cuda(), torch.from_numpy(q).cuda()
    result = {"device": torch.cuda.get_device_name(0), "reps": args.reps,
              "shape": [qt.shape[0], gt.shape[0], gt.shape[1]], "metrics": {}}
    for metric, a, b in (("eucl", qt, gt), ("hamming", (qt > 0).float(),
                                             (gt > 0).float())):
        outs = {name: torch.empty((a.shape[0], b.shape[0]), device="cuda")
                for name in fns}
        stream = torch.cuda.current_stream().cuda_stream
        code = {"hamming": 0, "eucl": 1}[metric]

        def call(name):
            err = fns[name](a.data_ptr(), b.data_ptr(), outs[name].data_ptr(),
                            a.shape[0], b.shape[0], a.shape[1], code, stream)
            if err:
                raise RuntimeError(f"{name}: launch failed ({err})")

        for name in fns:
            call(name)
        torch.cuda.synchronize()
        if not torch.equal(outs["fragment"], outs["staged"]):
            raise RuntimeError(f"{metric}: the two stores give different "
                               f"matrices")
        if metric == "hamming" and not torch.equal(
                outs["fragment"],
                cam_search.distance_reference(a, b, metric=metric)):
            raise RuntimeError("hamming differs from the plain version")
        times = {name: [] for name in fns}
        order = list(fns) + list(fns)[::-1]
        for _ in range(args.reps):
            for name in order:
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                call(name)
                e1.record()
                e1.synchronize()
                times[name].append(e0.elapsed_time(e1))
        result["metrics"][metric] = {name: statistics.median(t)
                                     for name, t in times.items()}
        del outs
    text = json.dumps(result)
    print(text)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")


if __name__ == "__main__":
    main()
