#!/usr/bin/env python3
"""Loss curves of ``chip_smoke.py``'s ``lm_train`` model under several
schedules, to choose one whose loss falls below its early minimum within
the smoke's run.

Trains ``chip_smoke.TRAIN_ARCH`` at full width and the smoke's depth
(``TRAIN_OVERRIDES``) with ``launch.train.TrainLoop`` on
``TokenStream(seed=0)`` batches of ``TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens,
once for each ``--run LR,WARMUP,STEPS``, no checkpoint written, each from
the same seeded state.  Prints and writes (``--out``) one JSON object:
for each run its losses, gradient norms and step ms, the mean of its
first and last three losses and the lowest of the first three.  Needs one
CUDA card:

    python3 train_probe.py --run 3e-4,2,12 --run 3e-4,2,24 \\
        --out chiprun_out/train_probe.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--run", action="append", required=True,
                    help="LR,WARMUP,STEPS (repeatable)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "src"))
    sys.path.insert(0, here)
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.launch.train import TrainLoop

    if not torch.cuda.is_available():
        print("train_probe: no CUDA device", file=sys.stderr)
        return 1
    cfg = dataclasses.replace(get_config(cs.TRAIN_ARCH), **cs.TRAIN_OVERRIDES)
    runs = []
    for spec in args.run:
        lr, warmup, steps = spec.split(",")
        with tempfile.TemporaryDirectory() as ckpt:
            loop = TrainLoop(cfg, batch=cs.TRAIN_BATCH, seq=cs.TRAIN_SEQ,
                             steps=int(steps), lr=float(lr),
                             warmup=int(warmup), ckpt_dir=ckpt,
                             ckpt_every=10 ** 9, seed=0)
            loop.run()
        losses = [h["loss"] for h in loop.history]
        runs.append({
            "lr": float(lr), "warmup": int(warmup), "steps": int(steps),
            "losses": losses,
            "grad_norms": [h["grad_norm"] for h in loop.history],
            "step_ms": [1e3 * h["step_time_s"] for h in loop.history],
            "first3_mean": float(np.mean(losses[:3])),
            "first3_min": float(min(losses[:3])),
            "last3_mean": float(np.mean(losses[-3:]))})
        print(json.dumps(runs[-1]), flush=True)
        del loop
        torch.cuda.empty_cache()
    out = {"model": cs.TRAIN_ARCH, "overrides": cs.TRAIN_OVERRIDES,
           "batch": cs.TRAIN_BATCH, "seq": cs.TRAIN_SEQ,
           "device": torch.cuda.get_device_name(0), "runs": runs}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k != "runs"}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
