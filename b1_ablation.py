#!/usr/bin/env python3
"""B1 (``fused_topk_packed``) on the GPU: this kernel against the earlier
popcount kernel, and each with its top-k selection cut out.

The earlier kernel (128 x 128 register-tiled ``__popc`` over the lanes,
then k rounds of a warp arg-max a row) is rebuilt here from B2's shared
header ``csrc/fused_topk_common.cuh``, which it used, and the lane traits
it had.  Both are built with ``nvcc`` into ``build/b1_ablation/`` twice:
as they are, and from a patched copy with the selection cut out (each
row writes one key: in this kernel ``select_rows`` returns at once, in
the earlier one the k rounds of the arg-max go).  The copies are patched
by exact text; the script stops if either source no longer holds that
text.  Each is timed with CUDA events (median of ``--reps`` calls, the
four variants in turns) at the two shapes the smoke's paths give B1:

* ``knn``: 1024 queries x 32 lanes against 180,096 rows (180,000 live),
  k = 10 (``hamming_packed``; ``tcam_ternary`` with a care mask);
* ``hdc_predict``: 1024 queries x 256 lanes against one 128-row window
  of 10 live class rows, k = 1 (``hdc_mnist``'s predictions).

The full kernels' candidates are checked equal to each other.  Prints one
JSON object (and writes it to ``--out`` if given); needs one CUDA card:

    PYTHONPATH=src python3 b1_ablation.py --out b1.json
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

#: the earlier kernel's lane traits and entry point (the header is B2's)
EARLIER = r'''
#include "fused_topk_common.cuh"
namespace {
struct BinaryLanes {
  using T = int; using Acc = int;
  static constexpr bool kCare = false; static constexpr bool kNorms = false;
  __device__ static void step(int& acc, int a, int b, int) { acc += __popc(a ^ b); }
  __device__ static float finish(int acc, float, float) { return float(acc); }
};
struct TernaryLanes {
  using T = int; using Acc = int;
  static constexpr bool kCare = true; static constexpr bool kNorms = false;
  __device__ static void step(int& acc, int a, int b, int c) { acc += __popc((a ^ b) & c); }
  __device__ static float finish(int acc, float, float) { return float(acc); }
};
}  // namespace
extern "C" int c4cam_fused_topk_packed(const int* q, const int* p, const int* care,
                                       float* out_v, int* out_i, int M, int N, int L,
                                       int k, int window, int n_valid, int largest,
                                       int route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (care == nullptr)
    return c4cam::launch_fused_topk<BinaryLanes>(q, p, nullptr, out_v, out_i, M, N, L, k,
                                                 window, n_valid, largest, s);
  return c4cam::launch_fused_topk<TernaryLanes>(q, p, care, out_v, out_i, M, N, L, k,
                                                window, n_valid, largest, s);
}
'''
#: the k rounds of the earlier kernel's warp arg-max, cut from its copy
#: of the header (the row's first candidate is written instead)
_ROUNDS = "    for (int t = 0; t < k; ++t) {\n      float wk = bk;"
_ROUNDS_END = "        }\n      }\n    }\n  }\n}\n"
#: the head of this kernel's selection, which its cut copy replaces with
#: one key a row
_SELECT = ("__device__ __forceinline__ void select_rows(const uint32_t* const "
           "(&keys)[R], int k,\n"
           "                                            const Row (&r)[R], "
           "int lane) {\n")
_SELECT_CUT = ("#pragma unroll\n  for (int j = 0; j < R; ++j)\n"
               "    if (lane == 0 && r[j].ov) write_key(keys[j][0], 0, r[j]);\n"
               "  return;\n")

SHAPES = {
    "knn": dict(m=1024, lanes=32, n=180096, n_valid=180000, k=10),
    "hdc_predict": dict(m=1024, lanes=256, n=128, n_valid=10, k=1),
}


def _patched(text: str, what: str, pairs) -> str:
    """``text`` with each (old, new) of ``pairs`` replaced; stops unless
    every ``old`` occurs exactly once."""
    for old, new in pairs:
        if text.count(old) != 1:
            sys.exit(f"b1_ablation: {what} no longer holds the text this "
                     f"script cuts; update the script")
        text = text.replace(old, new)
    return text


def build(out_dir: str, nvcc_flags) -> dict:
    """The four libraries, built in parallel: {(kernel, cut): path}."""
    full_dir, cut_dir = os.path.join(out_dir, "full"), os.path.join(out_dir, "cut")
    header = open(os.path.join(CSRC, "fused_topk_common.cuh")).read()
    this = open(os.path.join(CSRC, "fused_topk_packed.cu")).read()
    sources = {
        full_dir: (header, this),
        cut_dir: (_patched(header, "fused_topk_common.cuh", [
                      (_ROUNDS, "    if (lane == 0) { ov[0] = bk; oi[0] = bi; }\n"
                       "#if 0\n" + _ROUNDS),
                      (_ROUNDS_END, "        }\n      }\n    }\n#endif\n  }\n}\n")]),
                  _patched(this, "fused_topk_packed.cu",
                           [(_SELECT, _SELECT + _SELECT_CUT)])),
    }
    for d, (hdr, src) in sources.items():
        os.makedirs(d, exist_ok=True)
        for name, text in (("fused_topk_common.cuh", hdr), ("earlier.cu", EARLIER),
                           ("this.cu", src)):
            with open(os.path.join(d, name), "w") as f:
                f.write(text)
    procs, libs = {}, {}
    for kernel in ("earlier", "this"):
        for skip in (False, True):
            d = cut_dir if skip else full_dir
            lib = os.path.join(d, f"lib{kernel}.so")
            cmd = ["nvcc", *nvcc_flags, "-I", d, "-o", lib,
                   os.path.join(d, f"{kernel}.cu")]
            procs[(kernel, skip)] = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            libs[(kernel, skip)] = lib
    for key, proc in procs.items():
        out, _ = proc.communicate(timeout=600)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{out}")
    return libs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("b1_ablation: needs a CUDA device")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import cam_search
    flags = [f for f in kbuild.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    libs = build(os.path.join(ROOT, "build", "b1_ablation"), flags)
    fns = {}
    for key, path in libs.items():
        f = ctypes.CDLL(path).c4cam_fused_topk_packed
        f.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        f.restype = ctypes.c_int
        fns[key] = f
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"device": torch.cuda.get_device_name(0), "reps": args.reps,
              "shapes": {}}
    for name, sh in SHAPES.items():
        for ternary in (False, True):
            m, lanes, n, k = sh["m"], sh["lanes"], sh["n"], sh["k"]
            rand = lambda r: torch.randint(-2 ** 31, 2 ** 31 - 1, (r, lanes),
                                           dtype=torch.int32, device="cuda",
                                           generator=gen)
            q, p = rand(m), rand(n)
            c = rand(n) if ternary else None
            window = cam_search.window_rows(k)
            route = cam_search.packed_route(m, n, k, sms)
            cols = (n // window) * k
            outs = {key: (torch.empty((m, cols), device="cuda"),
                          torch.empty((m, cols), dtype=torch.int32, device="cuda"))
                    for key in fns}
            stream = torch.cuda.current_stream().cuda_stream

            def call(key):
                ov, oi = outs[key]
                err = fns[key](q.data_ptr(), p.data_ptr(),
                               None if c is None else c.data_ptr(),
                               ov.data_ptr(), oi.data_ptr(), m, n, lanes, k,
                               window, sh["n_valid"], 0, int(route == "mma"),
                               stream)
                if err:
                    raise RuntimeError(f"{key}: launch failed ({err})")

            for key in fns:
                call(key)
            torch.cuda.synchronize()
            a, b = outs[("earlier", False)], outs[("this", False)]
            if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
                raise RuntimeError(f"{name}: this kernel and the earlier one "
                                   f"give different candidates")
            times = {key: [] for key in fns}
            order = list(fns) + list(fns)[::-1]
            for _ in range(args.reps):
                for key in order:
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e0.record()
                    call(key)
                    e1.record()
                    e1.synchronize()
                    times[key].append(e0.elapsed_time(e1))
            med = {key: statistics.median(v) for key, v in times.items()}
            rec = {"route": route, **sh, "ternary": ternary}
            for kernel in ("earlier", "this"):
                full, cut = med[(kernel, False)], med[(kernel, True)]
                rec[kernel] = {"ms": full, "ms_selection_cut": cut,
                               "selection_share": (full - cut) / full}
            rec["speedup"] = med[("earlier", False)] / med[("this", False)]
            result["shapes"][f"{name}{'_ternary' if ternary else ''}"] = rec
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    result["nvidia_smi"] = smi
    text = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
