#!/usr/bin/env python3
"""What M1's per-head C.B^T costs, on one card.

``csrc/ssd_scan.cu``'s output kernel runs a block a (chunk, head) and
forms the chunk's C.B^T again in every block (80 times a chunk at
zamba2-2.7b's widths), as a TF32 pass.  This script builds copies of the
production source into ``build/m1_slices/`` with ``nvcc`` (not a launch
of M1 on its path) and times them:

* ``whole``: the source unchanged;
* ``no_cb``: the output kernel's C.B^T product replaced by a fill of its
  accumulator (the mask, W x and the rest unchanged; the output is wrong
  and only timed);
* ``no_cb_no_b``: also B's slab loads in that kernel replaced by zeros
  (the only other work C.B^T needs there).

Each copy runs through M1's own wrapper (``ssd_scan.ssd_scan``) with the
copy's library in place of the built one, at zamba2-2.7b's widths on
``chip_smoke.m1_long_operands`` (a carried state, chunk 256) over 2,048
rows in bf16 and in float32 and a 32,768-row piece in bf16: the median
CUDA-event ms of ``REPS`` calls after one warm-up.  ``whole`` is first
held to the plain version by ``chip_smoke.m1_check``.  The difference
``whole - no_cb`` is what forming C.B^T for every head costs, and an
upper bound on what forming it once a chunk could save.  Prints one JSON
object (and writes it to ``--out`` if given); needs one CUDA card and
``nvcc``:

    python3 m1_slices.py --out m1_slices.json
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
REPS = 5
#: (rows, dtype name) of each timed shape
SHAPES = ((2048, "bfloat16"), (2048, "float32"), (32768, "bfloat16"))
_CB = "    product_ss<!kExact, !kExact>(cb, my_c_hi, my_c_lo, t_hi, t_lo);\n"
_CB_FILL = ("    for (int i = 0; i < 32; ++i) cb[i] = "
            "__int_as_float(0x3c000000 + (lane << 8) + i);\n")
_B_LOAD = ("      load_rows<kTile / kRowStep>(bm + bi * p.b_sb, p.b_ss, p.ds, "
           "row0, kTile * jb, p, bv);\n")
_B_ZERO = "      for (int u = 0; u < kTile / kRowStep; ++u) bv[u] = 0.f;\n"
#: each copy's edits of ``ssd_scan.cu``: (text, replacement), each text
#: found exactly once
VARIANTS = {"whole": (), "no_cb": ((_CB, _CB_FILL),),
            "no_cb_no_b": ((_CB, _CB_FILL), (_B_LOAD, _B_ZERO))}


def build_variants() -> dict:
    """Write and compile every copy (in parallel, once per content);
    returns {name: loaded library}."""
    from repro_torch.kernels import build
    with open(os.path.join(CSRC, "ssd_scan.cu")) as fh:
        text = fh.read()
    with open(os.path.join(CSRC, "tf32_wgmma.cuh"), "rb") as fh:
        header = fh.read()
    out_dir = os.path.join(ROOT, "build", "m1_slices")
    os.makedirs(out_dir, exist_ok=True)
    libs, procs = {}, []
    for name, edits in VARIANTS.items():
        src = text
        for old, new in edits:
            if src.count(old) != 1:
                sys.exit(f"m1_slices: {name}: ssd_scan.cu holds "
                         f"{src.count(old)} copies of {old.strip()!r}")
            src = src.replace(old, new)
        h = hashlib.sha256(" ".join(build.NVCC_FLAGS).encode())
        h.update(src.encode())
        h.update(header)
        lib = os.path.join(out_dir, f"lib{name}-{h.hexdigest()[:16]}.so")
        libs[name] = lib
        if os.path.exists(lib):
            continue
        path = os.path.join(out_dir, f"ssd_scan_{name}.cu")
        with open(path, "w") as fh:
            fh.write(src)
        procs.append((name, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", CSRC, "-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for name, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"m1_slices: {name} did not build:\n{out}")
    return {name: ctypes.CDLL(lib) for name, lib in libs.items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("m1_slices: needs a CUDA device")
    from chip_smoke import m1_check, m1_long_operands
    from repro_torch.kernels import build, ssd_scan as kss
    libs = build_variants()
    real_load = build.load
    dev = torch.device("cuda")

    def timed(call):
        call()
        times = []
        for _ in range(REPS):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            call()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        return statistics.median(times)

    out = {"device": torch.cuda.get_device_name(0), "reps": REPS,
           "widths": {"nh": 80, "dh": 64, "ds": 64, "chunk": 256},
           "shapes": {}}
    try:
        for rows, dtype in SHAPES:
            m_args, kw = m1_long_operands(dev, rows)
            if dtype == "float32":
                m_args = (*(t.float() for t in m_args[:3]), *m_args[3:])
            rec = {}
            for name, lib in libs.items():
                build.load = lambda n, lib=lib: lib if n == "ssd_scan" \
                    else real_load(n)
                if name == "whole":
                    rec["whole_check"] = m1_check(
                        f"m1_slices {rows} {dtype}", m_args, kw, timed=False)
                rec[f"{name}_ms"] = timed(lambda: kss.ssd_scan(*m_args, **kw))
            build.load = real_load
            rec["cb_ms"] = rec["whole_ms"] - rec["no_cb_ms"]
            rec["cb_and_b_ms"] = rec["whole_ms"] - rec["no_cb_no_b_ms"]
            rec["cb_share"] = rec["cb_ms"] / rec["whole_ms"]
            rec["cb_and_b_share"] = rec["cb_and_b_ms"] / rec["whole_ms"]
            out["shapes"][f"{rows}_{dtype}"] = rec
            del m_args
            torch.cuda.empty_cache()
    finally:
        build.load = real_load
    text = json.dumps(out)
    print(text)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")


if __name__ == "__main__":
    main()
