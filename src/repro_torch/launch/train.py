"""End-to-end training entry point (the port of the reference's
``launch/train.py``).

Wires the substrates together: config -> data stream and loader ->
train step (autograd, B7's forward and backward kernels on the card,
AdamW) -> supervisor (checkpoint / recovery / straggler monitor).  It
runs on one device: the card by default (raising without CUDA), or
``--device cpu``.  A mesh of more than one device raises: sharded
training comes with ``models/sharding.py`` and ``launch/specs.py``
(ROADMAP Queue A item 8e).

    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \\
        --smoke --device cpu --steps 50 --batch 8 --seq 128 \\
        --ckpt-dir /tmp/ckpt
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, Optional

from ..configs import get_config, get_smoke_config
from ..core.engine.base import resolve_device
from ..data import ShardedLoader, TokenStream
from ..distributed import (ErrorFeedbackInt8, ErrorFeedbackTopK,
                           NoCompression, RecoveryConfig, SimulatedFailure,
                           StragglerMonitor, Supervisor)
from ..models import steps as steps_mod
from ..models.config import ModelConfig
from ..optim import AdamWConfig, warmup_cosine

__all__ = ["TrainLoop", "main"]


COMPRESSORS = {"none": lambda: NoCompression(),
               "int8": lambda: ErrorFeedbackInt8(),
               "topk": lambda: ErrorFeedbackTopK(density=0.1)}


def _mesh_size(mesh) -> int:
    if mesh is None:
        return 1
    if isinstance(mesh, int):
        return mesh
    return int(getattr(mesh, "size", len(mesh)))


class TrainLoop:
    """Reusable training harness (the CLI's and the examples')."""

    def __init__(self, cfg: ModelConfig, *, batch: int, seq: int,
                 steps: int, lr: float = 3e-4, warmup: int = 50,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
                 keep: int = 3, compression: str = "none", seed: int = 0,
                 mesh=None, fail_at: Optional[int] = None, device=None):
        if _mesh_size(mesh) > 1:
            raise ValueError(
                "TrainLoop: a mesh of more than one device needs sharded "
                "training (models/sharding.py, launch/specs.py), ROADMAP "
                "Queue A item 8e; the port trains on one device")
        self.cfg = cfg
        self.n_steps = steps
        self.device = resolve_device(device)
        self.compressor = COMPRESSORS[compression]()
        if isinstance(self.compressor, NoCompression):
            self.compressor = None

        self.stream = TokenStream(vocab=cfg.vocab, seq_len=seq,
                                  global_batch=batch, seed=seed)
        self.loader = ShardedLoader(self.stream, device=self.device)
        self.state = steps_mod.init_train_state(
            cfg, seed=seed, device=self.device, compressor=self.compressor)
        schedule = warmup_cosine(lr, warmup, steps)
        self.step_fn = steps_mod.make_train_step(
            cfg, schedule, AdamWConfig(), compressor=self.compressor)

        self.monitor = StragglerMonitor(device=self.device)
        self.fail_at = fail_at
        self.history: list = []
        ckpt_dir = ckpt_dir or os.path.join("artifacts", "ckpt", cfg.name)
        self.supervisor = Supervisor(RecoveryConfig(
            ckpt_dir=ckpt_dir, ckpt_every=ckpt_every, keep=keep))

    # ------------------------------------------------------------------
    def _one_step(self, state, step: int):
        if self.fail_at is not None and step == self.fail_at:
            self.fail_at = None          # fail exactly once
            raise SimulatedFailure(f"injected chip failure at step {step}")
        # batches are addressed BY STEP (a pure function of (seed, step)),
        # so restore-and-replay after a failure sees the same data
        batch = self.loader.batch(step)
        self.monitor.start()
        state, metrics = self.step_fn(state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        metrics["step_time_s"] = self.monitor.stop()
        return state, metrics

    def run(self) -> Dict[str, Any]:
        def on_metrics(step, m):
            self.history.append(m)
            if step % 10 == 0 or step == self.n_steps:
                print(f"step {step:5d} loss={m['loss']:.4f} "
                      f"acc={m['accuracy']:.3f} gnorm={m['grad_norm']:.2f} "
                      f"dt={m['step_time_s'] * 1e3:.0f}ms", flush=True)

        self.state, last = self.supervisor.run(
            self.state, self.n_steps, self._one_step,
            start_step=self.loader.step, on_metrics=on_metrics)
        stats = self.monitor.stats()
        return {"final": last, "restarts": self.supervisor.restarts,
                "slow_steps": self.monitor.slow_steps,
                "median_step_s": stats["median"], "history": self.history}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compression", default="none",
                    choices=list(COMPRESSORS))
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a simulated failure at this step")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: the GPU)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    loop = TrainLoop(cfg, batch=args.batch, seq=args.seq, steps=args.steps,
                     lr=args.lr, ckpt_dir=args.ckpt_dir,
                     ckpt_every=args.ckpt_every,
                     compression=args.compression, fail_at=args.fail_at,
                     device=args.device)
    if args.resume:
        state, step = loop.supervisor.restore(loop.state)
        loop.state = state
        loop.loader.step = step
        print(f"resumed from step {step}")
    out = loop.run()
    print(json.dumps({k: v for k, v in out.items() if k != "history"},
                     indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
