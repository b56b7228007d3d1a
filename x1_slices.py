#!/usr/bin/env python3
"""X1's step in pieces, for the earlier grid-barrier design and the
flagged hand-off design of ``csrc/slstm_scan.cu``, on one card.

Builds ``x1_slices.cu`` (stripped copies of both kernels, with ``nvcc``
into ``build/x1_slices/``; not a launch of X1) and times each copy over
batch 1, D 768 (xlstm-125m's width) at 2,048 and 16,384 positions, on
seeded operands: the median CUDA-event ms of 3 launches after one
warm-up, and the microseconds a position.  The copies stop after a piece
of the step:

* ``old``: 1 the grid barrier alone (``barrier_step_ms``), 2 + the h
  load, 3 + the product, 4 + the slice sum, 5 the whole step;
* ``new``: 1 the flagged hand-off alone (``handoff_step_ms``), 2 + the
  product, 3 + the warp reduction and the gather of the gates, 4 the
  whole step.

Each piece's cost is the difference of two neighbouring stages.  Also
times X1 itself (``slstm_scan``, and its C entry point with its buffers
made once: ``slstm_scan_direct_ms``) and checks that the new design's whole
step is bit-identical to it and the old one within ``X1_TOL`` of it.
Prints one JSON object (and writes it to ``--out`` if given); needs one
CUDA card and ``nvcc``:

    python3 x1_slices.py --out x1_slices.json
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

SOURCE = os.path.join(ROOT, "x1_slices.cu")
D, SEQS, REPS = 768, (2048, 16384), 3
OLD_STAGES = {1: "barrier", 2: "+ h load", 3: "+ product", 4: "+ slice sum",
              5: "whole step"}
NEW_STAGES = {1: "hand-off", 2: "+ product", 3: "+ reduction", 4: "whole step"}


def build_library() -> ctypes.CDLL:
    """Compile ``x1_slices.cu`` (once per content) and load it."""
    from repro_torch.kernels import build
    csrc = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
    h = hashlib.sha256(" ".join(build.NVCC_FLAGS).encode())
    for path in (SOURCE, os.path.join(csrc, "slstm_scan.cu")):
        with open(path, "rb") as fh:
            h.update(fh.read())
    out_dir = os.path.join(ROOT, "build", "x1_slices")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"libx1_slices-{h.hexdigest()[:16]}.so")
    if not os.path.exists(lib):
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", csrc,
                        "-o", lib, SOURCE], check=True)
    return ctypes.CDLL(lib)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("x1_slices: needs a CUDA device")
    from chip_smoke import X1_TOL
    from repro_torch.kernels import slstm_scan as ksl
    lib = build_library()
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.x1s_old.argtypes = [ci] + [vp] * 9 + [ci, ll, ci, vp]
    lib.x1s_new.argtypes = [ci] + [vp] * 8 + [ll, ci, vp]
    lib.c4cam_slstm_scan.argtypes = [vp] * 13 + [ll, ci, ll, ci, vp]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    pre_all = torch.randn((1, max(SEQS), 4 * D), generator=gen, device=dev)
    wh = torch.randn((D, 4 * D), generator=gen, device=dev) / D ** 0.5
    n0 = torch.rand((1, D), generator=gen, device=dev) * 2 + 1
    state = (torch.rand((1, D), generator=gen, device=dev) * 2 - 1,
             (torch.rand((1, D), generator=gen, device=dev) * 2 - 1) * n0,
             n0, torch.randn((1, D), generator=gen, device=dev))
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

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

    out = {"device": torch.cuda.get_device_name(0), "batch": 1, "d": D,
           "reps": REPS, "seqs": {}}
    for s in SEQS:
        pre = pre_all[:, :s].contiguous()
        hs = torch.empty((1, s, D), device=dev)
        rec = {"old": {}, "new": {}}

        def old(stage):
            hbuf = torch.zeros((2, 1, D), device=dev)
            counter = torch.zeros((1,), dtype=torch.int32, device=dev)
            err = lib.x1s_old(stage, pre.data_ptr(), wh.data_ptr(),
                              *(t.data_ptr() for t in state), hs.data_ptr(),
                              hbuf.data_ptr(), counter.data_ptr(), 1, s, D,
                              stream())
            if err:
                raise RuntimeError(f"x1s_old stage {stage}: error {err}")

        def new(stage):
            words = torch.zeros((2, 1, D), dtype=torch.int64, device=dev)
            err = lib.x1s_new(stage, pre.data_ptr(), wh.data_ptr(),
                              *(t.data_ptr() for t in state), hs.data_ptr(),
                              words.data_ptr(), s, D, stream())
            if err:
                raise RuntimeError(f"x1s_new stage {stage}: error {err}")

        for key, fn, stages in (("old", old, OLD_STAGES),
                                ("new", new, NEW_STAGES)):
            prev = 0.0
            for stage, name in stages.items():
                ms = timed(lambda: fn(stage))
                rec[key][name] = {"ms": ms, "us_per_position": 1e3 * ms / s,
                                  "piece_us": 1e3 * (ms - prev) / s}
                prev = ms
        got_hs, _ = ksl.slstm_scan(pre, wh, *state)
        rec["slstm_scan_ms"] = timed(lambda: ksl.slstm_scan(pre, wh, *state))
        rec["slstm_scan_us_per_position"] = 1e3 * rec["slstm_scan_ms"] / s
        outs = [torch.empty((1, D), device=dev) for _ in range(4)]
        words = torch.empty((2, 1, D), dtype=torch.int64, device=dev)

        def direct():        # X1's own entry point, buffers made once
            words.zero_()
            err = lib.c4cam_slstm_scan(
                pre.data_ptr(), wh.data_ptr(), *(t.data_ptr() for t in state),
                hs.data_ptr(), *(t.data_ptr() for t in outs),
                words.data_ptr(), None, 0, 1, s, D, stream())
            if err:
                raise RuntimeError(f"c4cam_slstm_scan: error {err}")
        rec["slstm_scan_direct_ms"] = timed(direct)
        new(4)
        rec["new_whole_step_bit_identical"] = bool(torch.equal(hs, got_hs))
        old(5)
        rec["old_whole_step_max_abs_diff"] = float((hs - got_hs).abs().max())
        rec["barrier_step_ms"] = ksl.barrier_step_ms(1, D, 4096, dev)
        rec["handoff_step_ms"] = ksl.handoff_step_ms(1, D, 4096, dev)
        torch.cuda.synchronize()
        out["seqs"][str(s)] = rec
        if not rec["new_whole_step_bit_identical"] or \
                not rec["old_whole_step_max_abs_diff"] <= X1_TOL:
            print(json.dumps(out))
            sys.exit(f"x1_slices: the whole-step copies disagree with X1 at "
                     f"{s} positions")
    text = json.dumps(out)
    print(text)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")


if __name__ == "__main__":
    main()
