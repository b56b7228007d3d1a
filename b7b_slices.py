#!/usr/bin/env python3
"""B7b's bf16 dh-256 backward at forced slice counts, to hold
``flash_attention.flash_bwd_slices``'s pick against its neighbours on one
card.

At each of ``chip_smoke.py``'s dh-256 ``B7B_SHAPES`` (paligemma-3b's
prefix-LM shape at 1 and 4 batch rows), on seeded operands and the
forward's output and log-sum-exp, runs ``flash_attention_backward`` with
the slice count the rule picks and with each count of ``--slices``: the
dK / dV grid's blocks, the median CUDA-event ms over 20 calls (``ms``),
the device ms of its steps (``kernel_ms``: pre-pass, dK / dV, dQ, the
slices' sum) and the largest gradient difference from the rule's run as a
share of the rule's largest gradient (the slices change the order of the
float32 sums, not the result's tolerance).  It forces a count by
replacing the module global ``flash_attention.flash_bwd_slices`` for the
call, so it relies on ``flash_attention_backward`` looking that name up
in its module at each call.  Prints one JSON object (and writes it to
``--out`` if given); needs one CUDA card:

    python3 b7b_slices.py --slices 1,2,3,4,5,6,7,8,9,11,14 --out s.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--slices", default="1,2,3,4,5,6,7,8,9,11,14")
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("b7b_slices: needs a CUDA device")
    from chip_smoke import B7B_SHAPES, b7b_kernel_ms
    from kernel_digest import median_ms
    from repro_torch.kernels import flash_attention as fa
    rule = fa.flash_bwd_slices
    out = {"device": torch.cuda.get_device_name(0), "shapes": {}}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    for name, ((b, s, t, h, kvh, dh), kw) in B7B_SHAPES.items():
        if dh != 256:
            continue
        q, k, v, d_out = (torch.randn(shape, generator=gen, device="cuda")
                          .bfloat16() for shape in (
                              (b, s, h, dh), (b, t, kvh, dh), (b, t, kvh, dh),
                              (b, s, h, dh)))
        o, lse = fa._forward_cuda(q, k, v, kw.get("causal", True),
                                  kw.get("prefix_len", 0), kw.get("kv_len"),
                                  kw.get("q_start", 0), want_lse=True)
        picked = rule(q.shape, k.shape, **kw)
        n_tiles = -(-t // 64)
        units = (-(-n_tiles // 2) if kw.get("causal", True) else n_tiles) \
            * kvh * b

        def call():
            return fa.flash_attention_backward(q, k, v, o, lse, d_out, **kw)

        base = [g.float() for g in call()]
        scale = max(float(g.abs().max()) for g in base)
        rows = []
        counts = sorted({picked, *(int(x) for x in args.slices.split(","))})
        for n in counts:
            fa.flash_bwd_slices = lambda *a, n=n, **kw_: n
            try:
                diff = max(float((g.float() - w).abs().max())
                           for g, w in zip(call(), base))
                rows.append({"slices": n, "blocks": units * n,
                             "picked": n == picked,
                             "ms": median_ms(torch, call, 20),
                             "kernel_ms": b7b_kernel_ms(call,
                                                        sliced=True),
                             "diff_of_max": diff / scale})
            finally:
                fa.flash_bwd_slices = rule
        out["shapes"][name] = {"shape": [b, s, t, h, kvh, dh], "kw": kw,
                               "picked": picked, "runs": rows}
        del q, k, v, d_out, o, lse, base
        torch.cuda.empty_cache()
    text = json.dumps(out)
    print(text)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")


if __name__ == "__main__":
    main()
