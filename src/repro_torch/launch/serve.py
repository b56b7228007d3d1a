"""Serving driver: continuous-batched prefill + decode (the port of the
reference's ``launch/serve.py``).

A deliberately small but real serving loop:

* fixed-size decode batch; finished sequences are replaced from a request
  queue (continuous batching at step granularity),
* one prefill step + one decode step per config; on the card each step
  runs as one captured CUDA graph (the reference jits them): one prefill
  graph per prompt length and one decode graph per slot, replayed over
  buffers allocated once, with each cache's length on the device (the
  reference donates the cache); attention runs kernel B7,
* greedy (argmax) or temperature sampling from a seeded
  ``torch.Generator`` on the device, one host sync a token.

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
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..configs import get_config, get_smoke_config
from ..core.engine.base import resolve_device
from ..models import model as model_mod, steps as steps_mod
from ..models.layers import check_rows
from ..models.config import ModelConfig

__all__ = ["Request", "Server", "main", "PREFILL_GRAPHS"]

#: prefill graphs a Server holds on the card, one a prompt length: a new
#: length past them evicts the least recently used (its pool blocks go
#: back to the shared pool) and is captured anew
PREFILL_GRAPHS = 8


@dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    out: List[int] = field(default_factory=list)
    done: bool = False


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def _settle(dst, src):
    """The buffers a step writes from now on: ``dst``'s leaf where ``src``'s
    has its shape and dtype, else ``src``'s own (a leaf the step returns
    in another dtype, or a new leaf such as audio's cross keys)."""
    if isinstance(src, dict):
        return {k: _settle(dst.get(k), v) for k, v in src.items()}
    if isinstance(dst, torch.Tensor) and dst.shape == src.shape and \
            dst.dtype == src.dtype:
        return dst
    return src


def _copy_into(dst, src) -> None:
    """Each leaf of ``src`` into ``dst``'s, in place; a leaf the step wrote
    in place (the same storage) is skipped."""
    for d, s_ in zip(_leaves(dst), _leaves(src)):
        if d.data_ptr() != s_.data_ptr() or d.shape != s_.shape:
            d.copy_(s_)


class _Graphed:
    """``body`` captured once in a CUDA graph on ``pool``, after ``warm``
    ran once eagerly on the same side stream (which also builds every
    kernel the body launches: nothing compiles inside the capture);
    calling it replays the graph and returns the body's output tensors,
    rewritten by every replay.  A failed capture or replay raises.  The
    capture leaves the allocator's cache as it is (``torch.cuda.graph``
    would empty it at every capture)."""

    def __init__(self, body: Callable[[], Any], warm: Callable[[], Any],
                 pool, device):
        cur = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            warm()
            side.synchronize()
            t0 = time.perf_counter()
            self.graph = torch.cuda.CUDAGraph()
            # another thread's CUDA work (a CAM server's, a checkpoint
            # writer's) must not invalidate this thread's capture
            self.graph.capture_begin(pool=pool,
                                     capture_error_mode="thread_local")
            try:
                self.out = body()
            finally:
                self.graph.capture_end()
        cur.wait_stream(side)
        torch.cuda.synchronize(device)
        self.capture_s = time.perf_counter() - t0

    def __call__(self):
        self.graph.replay()
        return self.out


class Server:
    """Step-granularity continuous batching over a fixed decode batch.

    ``device`` (default: the current CUDA device; raises without CUDA)
    holds the caches and the sampling generator; ``params`` must be on
    it.  Each slot's cache is allocated once, at ``max_len`` (the vlm's
    zero vision rows and the audio's zero frames too), and serves request
    after request (``model.reset_decode_cache``); a prompt prefills into
    one staging cache that is then copied into its slot.  On the card
    each prefill is the replay of one CUDA graph per prompt length, and
    each decode step the replay of its slot's graph, all on one memory
    pool (:meth:`graph_stats`, :meth:`pool_bytes`); at most
    :data:`PREFILL_GRAPHS` prefill graphs are held, the least recently
    used evicted first.  On the CPU the same steps run eagerly.  A
    step that would write past ``max_len`` raises ``ValueError`` before
    any row is written, checked against the host's count of each slot's
    rows.
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
        self.graphed = self.device.type == "cuda"
        self._pool = None
        self._staging = model_mod.init_decode_cache(cfg, 1, max_len,
                                                    device=self.device)
        self._settled = False
        holder = model_mod._len_holder(self._staging, cfg)
        self._rows = None if holder is None else holder["k"].shape[-3]
        self._caches: List[Any] = [None] * batch
        self._lens = [0] * batch
        self._extra = {}
        if cfg.family == "vlm":
            # the vision tower is a stub: zero patch embeddings, as the
            # reference serves them
            self._extra["vision"] = torch.zeros(
                (1, cfg.n_vision_tokens, cfg.d_model), dtype=torch.bfloat16,
                device=self.device)
        if cfg.family == "audio":
            # the conv frontend is a stub: zero frame embeddings, as the
            # reference serves them
            self._extra["frames"] = torch.zeros(
                (1, cfg.encoder_seq, cfg.d_model), dtype=torch.bfloat16,
                device=self.device)
        self._token = [torch.zeros((1, 1), dtype=torch.int64,
                                   device=self.device) for _ in range(batch)]
        # prompt length -> (its static token buffer, its step), least
        # recently used first
        self._prefill_steps: "OrderedDict[int, Any]" = OrderedDict()
        self._decode_steps: List[Any] = [None] * batch
        self._captures: Dict[str, list] = {"prefill": [], "decode": []}

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def graph_stats(self) -> Dict[str, Any]:
        """The graphs captured so far (evicted prefill graphs included)
        and those held: counts, and each capture's seconds (a prefill's
        beside its prompt length)."""
        cap = self._captures
        return {"prefill_graphs": len(cap["prefill"]),
                "decode_graphs": len(cap["decode"]),
                "prefill_graphs_held": sum(
                    isinstance(g, _Graphed)
                    for _, g in self._prefill_steps.values()),
                "capture_s": sum(t for _, t in cap["prefill"] + cap["decode"]),
                "prefill_capture_s": list(cap["prefill"]),
                "decode_capture_s": [t for _, t in cap["decode"]]}

    def pool_bytes(self) -> Optional[int]:
        """The bytes of the card's memory the graphs' shared pool holds
        (the allocator's segments of that pool; None on the CPU, or where
        the allocator's snapshot does not name a segment's pool)."""
        if self._pool is None:
            return None if not self.graphed else 0
        pool, total = tuple(self._pool), 0
        for seg in torch.cuda.memory_snapshot():
            if "segment_pool_id" not in seg:
                return None
            if tuple(seg["segment_pool_id"]) == pool and \
                    seg["device"] == self.device.index:
                total += seg["total_size"]
        return total

    # -- internals ---------------------------------------------------------
    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        if self.temperature <= 0:
            return torch.argmax(logits, -1)
        probs = torch.softmax(logits / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self.gen)[:, 0]

    def _room(self, have: int, rows: int) -> None:
        if self._rows is not None:
            check_rows(have, rows, self._rows)

    def _step(self, kind: str, key: int, body, warm):
        """``body`` as a step: itself on the CPU, a captured graph on the
        card (its capture recorded under ``kind`` with ``key``)."""
        if not self.graphed:
            return body
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        step = _Graphed(body, warm, self._pool, self.device)
        self._captures[kind].append((key, step.capture_s))
        return step

    def _prefill_body(self, toks: torch.Tensor) -> torch.Tensor:
        """Reset the staging cache, prefill ``toks`` into it: the last
        position's logits."""
        cache = model_mod.reset_decode_cache(self._staging, self.cfg)
        logits, out = self.prefill_fn(self.params, {"tokens": toks,
                                                    **self._extra}, cache)
        if not self._settled:
            # the first (eager) prefill fixes the buffers' dtypes
            self._staging, self._settled = _settle(cache, out), True
        _copy_into(self._staging, out)
        return logits

    def _decode_body(self, i: int, cache) -> torch.Tensor:
        logits, out = self.decode_fn(self.params, self._token[i], cache)
        _copy_into(cache, out)
        return logits

    def _prefill_slot(self, i: int, req: Request) -> torch.Tensor:
        """Prefill ``req`` into slot ``i``: logits (1, 1, V)."""
        prompt = np.asarray(req.prompt, np.int64)
        n = prompt.shape[0]
        self._room(0, model_mod._prefix(self.cfg) + n)
        held = self._prefill_steps.get(n)
        if held is None:
            if len(self._prefill_steps) >= PREFILL_GRAPHS:
                self._prefill_steps.popitem(last=False)
            toks = torch.tensor(prompt[None], device=self.device)
            held = (toks, self._step("prefill", n,
                                     lambda: self._prefill_body(toks),
                                     lambda: self._prefill_body(toks)))
            self._prefill_steps[n] = held
        else:
            self._prefill_steps.move_to_end(n)
            held[0].copy_(torch.from_numpy(prompt)[None])
        logits = held[1]()
        if self._caches[i] is None:
            self._caches[i] = model_mod._tree_map(torch.empty_like,
                                                  self._staging)
        _copy_into(self._caches[i], self._staging)
        self._lens[i] = model_mod._prefix(self.cfg) + n
        self.stats["prefills"] += 1
        return logits

    def _decode_slot(self, i: int, token: int) -> torch.Tensor:
        """One decode step of slot ``i`` after ``token``: logits
        (1, 1, V)."""
        self._room(self._lens[i], 1)
        self._token[i].fill_(token)
        step = self._decode_steps[i]
        if step is None:
            cache = self._caches[i]

            def warm():        # on the staging cache, emptied first
                self._decode_body(i, model_mod.reset_decode_cache(
                    self._staging, self.cfg))
            step = self._decode_steps[i] = self._step(
                "decode", i, lambda: self._decode_body(i, cache), warm)
        logits = step()
        self._lens[i] += 1
        self.stats["decode_steps"] += 1
        self.stats["tokens"] += 1
        return logits

    def run(self, drain: bool = True) -> Dict[str, Any]:
        """Processes the queue until all requests complete; with
        ``drain=False``, returns after the first step that finds the
        queue empty."""
        t0 = time.perf_counter()
        completed: List[Request] = []
        while True:
            # fill free slots from the queue (continuous batching)
            for i in range(self.batch):
                if self.slots[i] is None and self.queue:
                    req = self.queue.pop(0)
                    logits = self._prefill_slot(i, req)
                    req.out.append(int(self._sample(logits[:, -1])[0]))
                    self.slots[i] = req
            live = [i for i in range(self.batch) if self.slots[i] is not None]
            if not live:
                break
            # decode one token for each live slot (one call per slot, as
            # the reference does)
            for i in live:
                req = self.slots[i]
                logits = self._decode_slot(i, req.out[-1])
                req.out.append(int(self._sample(logits[:, -1])[0]))
                if len(req.out) >= req.max_new:
                    req.done = True
                    completed.append(req)
                    self.slots[i] = None
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
