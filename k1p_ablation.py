#!/usr/bin/env python3
"""K1p (``packed_distance``) on the GPU: the kernel against copies of it
with parts of its work cut out, to see which part holds it back.

The resident route's kernel (``pd_tiles_kernel``) is rebuilt with
``nvcc`` into ``build/k1p_ablation/`` from copies of
``csrc/packed_distance.cu`` patched by exact text (the script stops if
the source no longer holds that text): ``no_store`` leaves out the
(M, N) stores, ``no_unpack`` the stores of the expanded gallery lanes
into the stages, ``no_mma`` the ``wgmma`` products, ``no_load`` the
lanes' loads;
``only_mma`` keeps the products and the pipeline's barriers, ``only_store``
the stores and the barriers, ``skeleton`` the barriers alone.  Each is
timed with CUDA events (median of ``--reps`` launches, the variants in
turns, twice) at ``queue_c``'s shape: the smoke's binarised KNN lanes,
624 queries x 32 lanes against 180,096 rows.  The full copy's matrix is
checked equal to ``packed_distance_reference``.  Prints one JSON object
(and writes it to ``--out`` if given); needs one CUDA card:

    PYTHONPATH=src python3 k1p_ablation.py --out k1p.json
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

#: switch -> (text in packed_distance.cu, the text guarded by it)
PATCHES = {
    "NOMMA": ("            wgmma_s8<128>(acc, desc128(qb",
              "            if (!NOMMA) wgmma_s8<128>(acc, desc128(qb"),
    "NOUNPACK": ("        store_half_row(wv, st, r, 0);\n",
                 "        if (!NOUNPACK) store_half_row(wv, st, r, 0);\n"),
    "NOUNPACK2": ("        store_half_row(wv, st, r, 1);\n",
                  "        if (!NOUNPACK) store_half_row(wv, st, r, 1);\n"),
    "NOSTORE": ("        if (pm >= 0) store_part(prev, kb, S);",
                "        if (pm >= 0 && !NOSTORE) store_part(prev, kb, S);"),
    "NOLOAD": ("    for (int i = 0; i < kRaw - 1; ++i) issue();",
               "    for (int i = 0; i < kRaw - 1; ++i) if (!NOLOAD) issue();"),
    "NOLOAD2": ("        issue();\n        cp_async_wait<kRaw - 1>();",
                "        if (!NOLOAD) issue();\n        cp_async_wait<kRaw - 1>();"),
}
VARIANTS = {"full": {}, "no_store": {"NOSTORE"}, "no_unpack": {"NOUNPACK"},
            "no_mma": {"NOMMA"}, "no_load": {"NOLOAD"},
            "only_mma": {"NOUNPACK", "NOSTORE"},
            "only_store": {"NOMMA", "NOUNPACK"},
            "skeleton": {"NOMMA", "NOUNPACK", "NOSTORE", "NOLOAD"}}


def patched() -> str:
    with open(os.path.join(CSRC, "packed_distance.cu")) as f:
        src = f.read()
    for name, (old, new) in PATCHES.items():
        if src.count(old) != 1:
            sys.exit(f"k1p_ablation: packed_distance.cu no longer holds "
                     f"the text of {name}")
        src = src.replace(old, new)
    return "".join(f"#ifndef {s}\n#define {s} 0\n#endif\n"
                   for s in ("NOMMA", "NOUNPACK", "NOSTORE", "NOLOAD")) + src


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("k1p_ablation: needs a CUDA device")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.data import knn_dataset
    from repro_torch.kernels import build, cam_search, ops
    from repro_torch.kernels.packing import pack_bits

    out_dir = os.path.join(ROOT, "build", "k1p_ablation")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "packed_distance.cu")
    with open(src, "w") as f:
        f.write(patched())
    procs = {}
    for name, on in VARIANTS.items():
        lib = os.path.join(out_dir, f"lib{name}.so")
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", CSRC,
               *[f"-D{s}=1" for s in sorted(on)], "-o", lib, src]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"k1p_ablation: {name} did not build:\n{log[-3000:]}")
        libs[name] = ctypes.CDLL(lib)

    g, _, q, _ = knn_dataset()
    qt, gt = torch.from_numpy(q).cuda(), torch.from_numpy(g).cuda()
    lanes_q = ops.pad_to_blocks(pack_bits(qt > 0), 1, cam_search.BLOCK_K)
    lanes_g = ops.pad_to_blocks(pack_bits(gt > 0), cam_search.PACKED_ROWS,
                                cam_search.BLOCK_K)
    m, n, lanes = lanes_q.shape[0], lanes_g.shape[0], lanes_q.shape[1]
    route = cam_search.packed_distance_route(
        m, n, lanes, torch.cuda.get_device_properties(0).multi_processor_count)
    out = torch.empty((m, n), device="cuda")
    calls = {}
    for name, lib in libs.items():
        f = lib.c4cam_packed_distance
        f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + \
            [ctypes.c_void_p]
        calls[name] = (lambda f=f: f(
            lanes_q.data_ptr(), lanes_g.data_ptr(), None, out.data_ptr(), m, n,
            lanes, cam_search._PD_ROUTES[route.name], route.grid,
            torch.cuda.current_stream().cuda_stream))
    if calls["full"]() != 0:
        sys.exit("k1p_ablation: the full kernel did not launch")
    torch.cuda.synchronize()
    if not torch.equal(out, cam_search.packed_distance_reference(lanes_q,
                                                                 lanes_g)):
        sys.exit("k1p_ablation: the full kernel differs from its plain "
                 "version")
    times = {name: [] for name in calls}
    for name in list(calls) + list(calls)[::-1]:
        for _ in range(args.reps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            calls[name]()
            e1.record()
            e1.synchronize()
            times[name].append(e0.elapsed_time(e1))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    res = {"device": smi, "route": route._asdict(),
           "shape": [m, n, lanes], "reps": args.reps,
           "ms": {k: statistics.median(v) for k, v in times.items()}}
    print(json.dumps(res))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
