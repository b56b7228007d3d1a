"""End-to-end training driver on the PyTorch/CUDA port — the port's twin
of ``examples/train_lm.py``: a ~100M-parameter LM for a few hundred
steps, exercising the full stack — data pipeline, AdamW, checkpointing,
failure injection + recovery, straggler monitor, and (for the MoE
variant) the C4CAM-offloaded router.

On the GPU the MoE variant's attention runs B7 forward and its backward
B7b, and its router B2; xlstm-125m has no attention.  ``--device cpu``
trains on the CPU.  Checkpoints go to ``--ckpt-dir`` (default:
``artifacts/ckpt/<model>``, as the reference's).

    PYTHONPATH=src python examples/port_train_lm.py              # ~100M xlstm
    PYTHONPATH=src python examples/port_train_lm.py --moe        # CAM router
    PYTHONPATH=src python examples/port_train_lm.py --steps 50   # quicker
"""

import argparse
import dataclasses
import json

import numpy as np

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch.train import TrainLoop


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--moe", action="store_true",
                    help="train a reduced deepseek-moe with the C4CAM "
                         "router offload instead of the ~100M xlstm")
    ap.add_argument("--fail-at", type=int, default=120,
                    help="inject a simulated failure at this step "
                         "(recovery is part of the demo); -1 disables")
    ap.add_argument("--ckpt-every", type=int, default=50,
                    help="checkpoint every this many steps (a failure is "
                         "restored from the last checkpoint: one must "
                         "come before --fail-at)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: "
                         "artifacts/ckpt/<model>)")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run without a GPU (default: the GPU)")
    args = ap.parse_args(argv)

    if args.moe:
        cfg = dataclasses.replace(get_smoke_config("deepseek-moe-16b"),
                                  d_model=256, d_ff=512, n_layers=4,
                                  router_offload="cam")
        print(f"training reduced deepseek-moe (CAM-offloaded router), "
              f"{cfg.param_count() / 1e6:.1f}M params")
    else:
        # the full xlstm-125m config IS the ~100M model — train it as-is
        cfg = get_config("xlstm-125m")
        print(f"training xlstm-125m, {cfg.param_count() / 1e6:.1f}M params")

    loop = TrainLoop(cfg, batch=args.batch, seq=args.seq, steps=args.steps,
                     lr=1e-3, ckpt_every=args.ckpt_every,
                     ckpt_dir=args.ckpt_dir,
                     fail_at=None if args.fail_at < 0 else args.fail_at,
                     device=args.device)
    out = loop.run()

    first = np.mean([h["loss"] for h in loop.history[:10]])
    last = np.mean([h["loss"] for h in loop.history[-10:]])
    summary = {
        "loss_first10": round(float(first), 4),
        "loss_last10": round(float(last), 4),
        "restarts": out["restarts"],
        "slow_steps_flagged": len(out["slow_steps"]),
        "median_step_s": round(out["median_step_s"], 3),
    }
    print(json.dumps(summary, indent=1))
    assert last < first, "loss must decrease"
    return summary


if __name__ == "__main__":
    main()
