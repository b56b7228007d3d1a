"""End-to-end training entry point (the port of the reference's
``launch/train.py``).

Wires the substrates together: config -> data stream and loader ->
train step (autograd, B7's forward and backward kernels on the card,
AdamW) -> supervisor (checkpoint / recovery / straggler monitor).  It
runs on the card by default (raising without CUDA), or ``--device
cpu``.  Given a mesh of more than one device (a ``DeviceMesh`` over a
process group with one rank per device), it trains sharded: the rules
of :mod:`..models.sharding`, the state distributed as
:func:`.specs.state_sharding` says, each step's batch sharded over the
batch axes; a gradient compressor's residual stays whole on every rank
(the reference's replicated ``P()`` state).  Under ``torchrun`` the CLI
opens that group itself (NCCL on
the cards, gloo on the CPU) with ``--data`` x ``--model`` ranks.

    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \\
        --smoke --device cpu --steps 50 --batch 8 --seq 128 \\
        --ckpt-dir /tmp/ckpt
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch zamba2-2.7b --data 2 --model 2 --steps 100

Each rank builds the whole state from the seed and keeps its own blocks
(:func:`distribute_state`), so the state must fit one device whole.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, Optional

import torch

from ..configs import get_config, get_smoke_config
from ..core.engine.base import resolve_device
from ..data import ShardedLoader, TokenStream
from ..distributed import (ErrorFeedbackInt8, ErrorFeedbackTopK,
                           NoCompression, RecoveryConfig, SimulatedFailure,
                           StragglerMonitor, Supervisor)
from ..models import steps as steps_mod
from ..models.config import ModelConfig
from ..models.sharding import ShardingRules, is_dtensor
from ..optim import AdamWConfig, warmup_cosine
from .specs import state_axes

__all__ = ["TrainLoop", "main"]


COMPRESSORS = {"none": lambda: NoCompression(),
               "int8": lambda: ErrorFeedbackInt8(),
               "topk": lambda: ErrorFeedbackTopK(density=0.1)}


def _mesh_size(mesh) -> int:
    if mesh is None:
        return 1
    if isinstance(mesh, int):
        return mesh
    size = getattr(mesh, "size")
    return int(size() if callable(size) else size)


def _sharding_rules(mesh) -> Optional[ShardingRules]:
    """The rules of a mesh of more than one device (None for one); such a
    mesh must be a ``DeviceMesh`` over an open process group."""
    if _mesh_size(mesh) <= 1:
        return None
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(mesh, DeviceMesh):
        raise ValueError(
            f"TrainLoop: a mesh of more than one device must be a "
            f"DeviceMesh over an open process group, one rank per device "
            f"(launch.mesh.make_local_mesh); got {mesh!r}")
    return ShardingRules(mesh)


def distribute_state(state, rules: ShardingRules, cfg: ModelConfig,
                     opt_cfg: AdamWConfig = AdamWConfig()):
    """A train state built whole on every rank (the same seed) as
    DTensors placed by :func:`.specs.state_sharding`: each rank keeps its
    own blocks (no communication); the parameters require grad."""
    from torch.distributed.tensor import distribute_tensor
    from ..models.sharding import _walk

    def place(t, axes):
        if not isinstance(t, torch.Tensor) or t.dim() == 0:
            return t
        d = distribute_tensor(t.detach(), rules.mesh,
                              rules.placements(axes, tuple(t.shape)),
                              src_data_rank=None)
        return d.requires_grad_(t.requires_grad)
    axes = state_axes(cfg, state.params, opt_cfg)
    return _walk(place, state._replace(comp=()), axes._replace(
        comp=()))._replace(comp=state.comp)


class TrainLoop:
    """Reusable training harness (the CLI's and the examples')."""

    def __init__(self, cfg: ModelConfig, *, batch: int, seq: int,
                 steps: int, lr: float = 3e-4, warmup: int = 50,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
                 keep: int = 3, compression: str = "none", seed: int = 0,
                 mesh=None, fail_at: Optional[int] = None, device=None):
        self.cfg = cfg
        self.n_steps = steps
        self.device = resolve_device(device)
        self.mesh = mesh
        self.rules = _sharding_rules(mesh)
        self.compressor = COMPRESSORS[compression]()
        if isinstance(self.compressor, NoCompression):
            self.compressor = None

        self.stream = TokenStream(vocab=cfg.vocab, seq_len=seq,
                                  global_batch=batch, seed=seed)
        self.loader = ShardedLoader(self.stream, device=self.device,
                                    sharding=self.rules)
        self.state = steps_mod.init_train_state(
            cfg, seed=seed, device=self.device, compressor=self.compressor)
        if self.rules is not None:
            self.state = distribute_state(self.state, self.rules, cfg)
        schedule = warmup_cosine(lr, warmup, steps)
        self.step_fn = steps_mod.make_train_step(
            cfg, schedule, AdamWConfig(), rules=self.rules,
            compressor=self.compressor)

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
        metrics = {k: float(v.full_tensor() if is_dtensor(v) else v)
                   for k, v in metrics.items()}
        metrics["step_time_s"] = self.monitor.stop()
        return state, metrics

    def run(self) -> Dict[str, Any]:
        def on_metrics(step, m):
            self.history.append(m)
            if (step % 10 == 0 or step == self.n_steps) and _rank() == 0:
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
    ap.add_argument("--data", type=int, default=0,
                    help="data-axis size of the mesh (0: every rank)")
    ap.add_argument("--model", type=int, default=1,
                    help="model-axis size of the mesh")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    device, mesh = _launch_group(args)
    loop = TrainLoop(cfg, batch=args.batch, seq=args.seq, steps=args.steps,
                     lr=args.lr, ckpt_dir=args.ckpt_dir,
                     ckpt_every=args.ckpt_every,
                     compression=args.compression, fail_at=args.fail_at,
                     device=device, mesh=mesh)
    if args.resume:
        state, step = loop.supervisor.restore(loop.state)
        loop.state = state
        loop.loader.step = step
        print(f"resumed from step {step}")
    out = loop.run()
    if _rank() == 0:
        print(json.dumps({k: v for k, v in out.items() if k != "history"},
                         indent=1))
    if mesh is not None:
        import torch.distributed as dist
        dist.destroy_process_group()
    return 0


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _launch_group(args):
    """(device, mesh) of this process: under ``torchrun`` (``WORLD_SIZE``
    set) a process group of NCCL on the cards or gloo on the CPU, one
    rank per device, and its ``(data, model)`` mesh; else the one
    device and no mesh."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        return args.device, None
    import torch.distributed as dist
    from .mesh import make_local_mesh
    cpu = torch.device(args.device).type == "cpu"
    local = int(os.environ.get("LOCAL_RANK", "0"))
    device = "cpu" if cpu else f"cuda:{local}"
    if not cpu:
        torch.cuda.set_device(local)
    dist.init_process_group("gloo" if cpu else "nccl")
    model = max(args.model, 1)
    data = args.data or world // model
    return device, make_local_mesh(data, model, device)


if __name__ == "__main__":
    raise SystemExit(main())
