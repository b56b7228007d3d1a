"""Serving driver: continuous-batched prefill + decode (the port of the
reference's ``launch/serve.py``).

A deliberately small but real serving loop:

* fixed-size decode batch; finished sequences are replaced from a request
  queue (continuous batching at step granularity),
* one prefill step + one decode step per config, plain calls (the
  reference jits them); attention runs kernel B7 on the card,
* greedy (argmax) or temperature sampling from a seeded
  ``torch.Generator`` on the device.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-14b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-moe-16b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch paligemma-3b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-14b \\
        --smoke --device cpu --requests 8 --max-new 32

It serves all six families (a vlm request's prefix is zero vision
embeddings, an audio request's encoder runs over zero frame embeddings,
as the reference serves them).
"""

from __future__ import annotations

import argparse
import json
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..configs import get_config, get_smoke_config
from ..core.engine.base import resolve_device
from ..models import model as model_mod, steps as steps_mod
from ..models.config import ModelConfig

__all__ = ["Request", "Server", "main"]


@dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    out: List[int] = field(default_factory=list)
    done: bool = False


class Server:
    """Step-granularity continuous batching over a fixed decode batch.

    ``device`` (default: the current CUDA device; raises without CUDA)
    holds the caches and the sampling generator; ``params`` must be on
    it.
    """

    def __init__(self, cfg: ModelConfig, params, *, batch: int,
                 max_len: int, temperature: float = 0.0, seed: int = 0,
                 device=None):
        self.cfg = cfg
        self.params = params
        self.batch = batch
        self.max_len = max_len
        self.temperature = temperature
        self.device = resolve_device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self.prefill_fn = steps_mod.make_prefill_step(cfg)
        self.decode_fn = steps_mod.make_decode_step(cfg)
        self.queue: List[Request] = []
        self.slots: List[Optional[Request]] = [None] * batch
        self.stats = {"prefills": 0, "decode_steps": 0, "tokens": 0}

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    # -- internals ---------------------------------------------------------
    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        if self.temperature <= 0:
            return torch.argmax(logits, -1)
        probs = torch.softmax(logits / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self.gen)[:, 0]

    def _prefill_one(self, req: Request) -> Any:
        """Prefill a single request; returns (next_token, cache)."""
        toks = torch.as_tensor(np.asarray(req.prompt, np.int64),
                               device=self.device)[None]
        cache = model_mod.init_decode_cache(self.cfg, 1, self.max_len,
                                            device=self.device)
        batch = {"tokens": toks}
        if self.cfg.family == "vlm":
            # the vision tower is a stub: zero patch embeddings, as the
            # reference serves them
            batch["vision"] = torch.zeros(
                (1, self.cfg.n_vision_tokens, self.cfg.d_model),
                dtype=torch.bfloat16, device=self.device)
        if self.cfg.family == "audio":
            # the conv frontend is a stub: zero frame embeddings, as the
            # reference serves them
            batch["frames"] = torch.zeros(
                (1, self.cfg.encoder_seq, self.cfg.d_model),
                dtype=torch.bfloat16, device=self.device)
        logits, cache = self.prefill_fn(self.params, batch, cache)
        self.stats["prefills"] += 1
        return int(self._sample(logits[:, -1])[0]), cache

    def run(self, drain: bool = True) -> Dict[str, Any]:
        """Processes the queue until all requests complete; with
        ``drain=False``, returns after the first step that finds the
        queue empty."""
        caches: List[Any] = [None] * self.batch
        t0 = time.perf_counter()
        completed: List[Request] = []
        while True:
            # fill free slots from the queue (continuous batching)
            for i in range(self.batch):
                if self.slots[i] is None and self.queue:
                    req = self.queue.pop(0)
                    tok, cache = self._prefill_one(req)
                    req.out.append(tok)
                    self.slots[i] = req
                    caches[i] = cache
            live = [i for i in range(self.batch) if self.slots[i] is not None]
            if not live:
                break
            # decode one token for each live slot (one call per slot, as
            # the reference does)
            for i in live:
                req = self.slots[i]
                tok = torch.tensor([[req.out[-1]]], dtype=torch.int64,
                                   device=self.device)
                logits, caches[i] = self.decode_fn(self.params, tok,
                                                   caches[i])
                nxt = int(self._sample(logits[:, -1])[0])
                req.out.append(nxt)
                self.stats["decode_steps"] += 1
                self.stats["tokens"] += 1
                if len(req.out) >= req.max_new:
                    req.done = True
                    completed.append(req)
                    self.slots[i] = None
                    caches[i] = None
            if not drain and not self.queue:
                break
        dt = time.perf_counter() - t0
        return {"completed": len(completed), "wall_s": dt,
                "tokens_per_s": self.stats["tokens"] / max(dt, 1e-9),
                **self.stats}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params = model_mod.init_params(cfg, seed=0, device=args.device)
    srv = Server(cfg, params, batch=args.batch,
                 max_len=args.prompt_len + args.max_new + 1,
                 temperature=args.temperature, device=args.device)
    rng = np.random.default_rng(0)
    for r in range(args.requests):
        srv.submit(Request(rid=r,
                           prompt=rng.integers(1, cfg.vocab,
                                               args.prompt_len),
                           max_new=args.max_new))
    out = srv.run()
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
