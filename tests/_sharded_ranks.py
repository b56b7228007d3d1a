"""The ranks of ``tests/test_torch_sharded_lm.py``: 4 gloo processes on
the CPU over a ``(data 2, model 2)`` ``DeviceMesh``, spawned once per
module.  Imports torch and ``repro_torch`` only.

Each rank runs every case on the same seeded inputs, sharded, and the
unsharded port beside it; rank 0 writes the whole tensors of both to
``results.pt`` in the run's directory, which the tests read.  A case
that raises records its traceback instead, so one failure does not
hide the others.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_smoke_config
from repro_torch.models import model, moe, steps
from repro_torch.models.sharding import ShardingRules
from repro_torch.optim import AdamWConfig, adamw_update, warmup_cosine
from repro_torch.tree import leaves_with_paths

B, S = 4, 16
ARCHS = {"dense": ("qwen2.5-14b", {}),
         # heads that the model axis does not divide: KV-parallel
         # attention, and remat's recompute under the sharded context
         "dense_kv": ("qwen2.5-14b", dict(n_heads=5, n_kv_heads=1,
                                          d_model=80, remat="full")),
         "moe": ("deepseek-moe-16b", dict(capacity_factor=64.0,
                                         router_offload="dense")),
         # 3 experts over a model axis of 2: no expert parallelism, every
         # rank routes all the tokens
         "moe_whole": ("deepseek-moe-16b", dict(
             capacity_factor=64.0, router_offload="dense", n_experts=3)),
         "vlm": ("paligemma-3b", {}),
         "audio": ("whisper-medium", {}),
         "hybrid": ("zamba2-2.7b", {}),
         "ssm": ("xlstm-125m", {})}


def case_cfg(name):
    arch, kw = ARCHS[name]
    return dataclasses.replace(get_smoke_config(arch), param_dtype="float32",
                               compute_dtype="float32", **kw)


def case_batch(cfg, seed: int = 7):
    rng = np.random.default_rng(seed)
    out = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (B, S)).astype(np.int64))}
    if cfg.family == "vlm":
        out["vision"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32))
    if cfg.family == "audio":
        out["frames"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    return out


def _full(tree):
    from torch.distributed.tensor import DTensor
    return {p: (x.full_tensor() if isinstance(x, DTensor) else x)
            .detach().clone()
            for p, x in leaves_with_paths(tree)
            if isinstance(x, torch.Tensor)}


def _shard_batch(rules, batch):
    from repro_torch.data.loader import _shard_rows
    return {k: _shard_rows(rules, v) for k, v in batch.items()}


class _Capture:
    """A pass-through gradient "compressor": keeps the step's gradients
    (whole tensors) for the comparison, so one step gives loss, gradients
    and the updated parameters and optimizer state."""

    def init(self, params):
        return ()

    def __call__(self, grads, state):
        from repro_torch.tree import tree_map
        from torch.distributed.tensor import DTensor
        self.tree = tree_map(lambda g: (g.full_tensor() if isinstance(
            g, DTensor) else g).detach().clone(), grads)
        self.grads = _full(self.tree)
        return grads, state


def _state(prefix, st):
    """The whole tensors of a train state's parameters, moments and
    master weights, keyed ``prefix + "params" / "mu" / "nu" / "master"``
    (``nu``'s factored leaves end in ``/vr`` and ``/vc``)."""
    return {prefix + "params": _full(st.params),
            prefix + "mu": _full(st.opt.mu), prefix + "nu": _full(st.opt.nu),
            prefix + "master": _full(st.opt.master)}


def run_family(name, rules, opt=AdamWConfig()):
    from repro_torch.launch.train import distribute_state
    cfg = case_cfg(name)
    batch = case_batch(cfg)
    sched = warmup_cosine(1e-3, 1, 10)
    out = {}
    state = steps.init_train_state(cfg, seed=0, device="cpu", opt_cfg=opt)
    out["old"] = _full(state.params)
    with torch.no_grad():
        out["logits"] = model.forward(state.params, cfg, batch)
    cap = _Capture()
    new, m = steps.make_train_step(cfg, sched, opt,
                                   compressor=cap)(state, batch)
    out["loss"], out["grads"] = m["loss"], cap.grads
    out.update(_state("", new))

    dstate = distribute_state(steps.init_train_state(cfg, seed=0,
                                                     device="cpu",
                                                     opt_cfg=opt),
                              rules, cfg, opt)
    dbatch = _shard_batch(rules, batch)
    with torch.no_grad():
        out["d_logits"] = model.forward(dstate.params, cfg, dbatch,
                                        rules=rules).full_tensor()
    new, m = steps.make_train_step(cfg, sched, opt, rules=rules,
                                   compressor=cap)(dstate, dbatch)
    out["d_loss"], out["d_grads"] = m["loss"].full_tensor(), cap.grads
    out.update(_state("d_", new))
    out["d_placements"] = {p: str(x.placements)
                           for p, x in leaves_with_paths(new.params)}
    # the unsharded AdamW on the sharded step's own gradients: what the
    # sharded optimizer should have written, free of the gradients' own
    # rounding differences
    again = steps.init_train_state(cfg, seed=0, device="cpu", opt_cfg=opt)
    params, opt_state, _ = adamw_update(cap.tree, again.opt, again.params,
                                        sched(0), opt)
    out.update(_state("r_", again._replace(params=params, opt=opt_state)))
    return out


#: rows of unequal mask counts: a microbatch's loss is the mean over its
#: own masked tokens, so the rows of each microbatch must be the
#: reference's (global rows [i B / k, (i + 1) B / k))
MASK_ROWS = (16, 5, 11, 2)


def ragged_mask():
    return (torch.arange(S)[None, :]
            < torch.tensor(MASK_ROWS)[:, None]).to(torch.float32)


def run_accum(rules, k: int = 2):
    """``make_train_step(microbatches=k)`` on a batch with a ragged
    ``mask``, unsharded and sharded: loss and gradients."""
    from repro_torch.launch.train import distribute_state
    cfg = case_cfg("dense")
    batch = dict(case_batch(cfg), mask=ragged_mask())
    sched, opt = warmup_cosine(1e-3, 1, 10), AdamWConfig()
    out, cap = {}, _Capture()
    state = steps.init_train_state(cfg, seed=0, device="cpu")
    _, m = steps.make_train_step(cfg, sched, opt, compressor=cap,
                                 microbatches=k)(state, batch)
    out["loss"], out["grads"] = m["loss"], cap.grads
    dstate = distribute_state(steps.init_train_state(cfg, seed=0,
                                                     device="cpu"),
                              rules, cfg, opt)
    _, m = steps.make_train_step(cfg, sched, opt, rules=rules,
                                 compressor=cap, microbatches=k)(
        dstate, _shard_batch(rules, batch))
    out["d_loss"], out["d_grads"] = m["loss"].full_tensor(), cap.grads
    return out


def run_moe_drop(rules, tmp):
    """The EP ``moe_ffn`` at a dropping capacity on the parent's inputs
    (``moe_in.npz``: x and the layer's parameters)."""
    from torch.distributed.tensor import distribute_tensor
    d = {k: torch.from_numpy(v)
         for k, v in np.load(os.path.join(tmp, "moe_in.npz")).items()}
    cfg = dataclasses.replace(get_smoke_config("deepseek-moe-16b"),
                              param_dtype="float32", compute_dtype="float32",
                              capacity_factor=1.0, router_offload="dense")
    axes = {"router": ("embed", None), "wi": ("experts", "embed", None),
            "wg": ("experts", "embed", None),
            "wo": ("experts", None, "embed"),
            "shared_wi": ("embed", "ffn"), "shared_wg": ("embed", "ffn"),
            "shared_wo": ("ffn", "embed")}
    p = {k: distribute_tensor(d[k], rules.mesh,
                              rules.placements(axes[k], d[k].shape),
                              src_data_rank=None) for k in axes}
    x = distribute_tensor(d["x"], rules.mesh,
                          rules.placements(("batch", "seq_act", None),
                                           d["x"].shape),
                          src_data_rank=None)
    with torch.no_grad():
        y = moe.moe_ffn(p, x, cfg, rules=rules)
    return {"y": y.full_tensor(), "placements": str(y.placements)}


#: greedy decode steps after the prefill in the serve cases
DECODE_STEPS = 3


def _distribute(rules, tree, axes):
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.models.sharding import _walk

    def place(t, ax):
        if not isinstance(t, torch.Tensor) or t.dim() == 0:
            return t
        return distribute_tensor(t.detach(), rules.mesh,
                                 rules.placements(ax, tuple(t.shape)),
                                 src_data_rank=None)
    return _walk(place, tree, axes)


@contextlib.contextmanager
def _routes(into):
    """Within the block every MoE router call appends its (scores,
    choices) to ``into``: this rank's rows, whole tensors."""
    real = moe.router_topk

    def router(xt, w, k, offload):
        sc, idx = real(xt, w, k, offload)
        xt, w, idx = (x.full_tensor() if hasattr(x, "full_tensor") else x
                      for x in (xt, w, idx))
        into.append((xt.float() @ w.float(), idx))
        return sc, idx
    moe.router_topk = router
    try:
        yield
    finally:
        moe.router_topk = real


def run_serve(name, rules, cache_dtype=None):
    """``prefill`` of the case's batch (B 4, S 16) into the decode cache
    ``init_decode_cache`` makes (bf16 keys and values, the Server's),
    then ``DECODE_STEPS`` greedy decode steps, unsharded and under
    ``rules``: every step's logits, the MoE router's scores and choices
    and the caches' keys and values at the end.  Both decode the
    unsharded run's tokens; the sharded run's own greedy tokens are kept
    beside them.  ``cache_dtype`` recasts the cache's keys and values."""
    from repro_torch.data.loader import _shard_rows
    from repro_torch.tree import tree_map
    cfg = case_cfg(name)
    batch = case_batch(cfg)
    params = model.init_params(cfg, seed=0, device="cpu")

    def cache():
        c = model.init_decode_cache(cfg, B, S + DECODE_STEPS + 1,
                                    device="cpu")
        return c if cache_dtype is None else tree_map(
            lambda t: t.to(cache_dtype) if t.dtype == torch.bfloat16 else t,
            c)

    out = {"logits": [], "d_logits": [], "tokens": [], "d_tokens": [],
           "routes": [], "d_routes": []}
    with torch.no_grad(), _routes(out["routes"]):
        lg, c = model.prefill(params, cfg, batch, cache())
        out["logits"].append(lg)
        for _ in range(DECODE_STEPS):
            nxt = lg[:, -1].argmax(-1)[:, None]
            out["tokens"].append(nxt)
            lg, c = model.decode_step(params, cfg, nxt, c)
            out["logits"].append(lg)
    with torch.no_grad(), _routes(out["d_routes"]):
        dparams = _distribute(rules, params, model.param_axes(cfg))
        dc = _distribute(rules, cache(), model.cache_axes(cfg))
        lg, dc = model.prefill(dparams, cfg, _shard_batch(rules, batch), dc,
                               rules=rules)
        out["d_logits"].append(lg.full_tensor())
        for nxt in out["tokens"]:
            out["d_tokens"].append(out["d_logits"][-1][:, -1].argmax(-1))
            lg, dc = model.decode_step(dparams, cfg, _shard_rows(rules, nxt),
                                       dc, rules=rules)
            out["d_logits"].append(lg.full_tensor())
    out["cache"], out["d_cache"] = _full(c), _full(dc)
    # a router call that saw one data shard's rows: the data shards' rows
    # in order (model rank 0 of each)
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, out["d_routes"])
    shards = ranks[::rules.model_size()]
    out["d_routes"] = [
        parts[0] if parts[0][1].shape[0] == whole[1].shape[0] else
        tuple(torch.cat(x) for x in zip(*parts))
        for whole, parts in zip(out["routes"], zip(*shards))]
    return out


def run_kv_slices(rules):
    """KV-parallel attention (``layers._sharded_attention`` on its
    ``"kv"`` route: 5 query heads over one kv head, the model axis 2)
    against ``flash_attention_recurrence`` with the two key slices as its
    splits, over a float32 and a bf16 cache, at a prefill (S 16 of T 16)
    and a decode (S 1 at q_start 18 of T 20)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.layers import _constrain_attention_layout, \
        _sharded_attention
    rng = np.random.default_rng(11)
    out = {}
    for tag, s, t, kw in (("prefill", S, S, dict(kv_len=S, q_start=0)),
                          ("decode", 1, 20, dict(kv_len=19, q_start=18))):
        q = torch.from_numpy(rng.standard_normal((B, s, 5, 16)).astype(
            np.float32))
        k, v = (torch.from_numpy(rng.standard_normal((B, t, 1, 16)).astype(
            np.float32)) for _ in range(2))
        for dt in (torch.float32, torch.bfloat16):
            kd, vd = k.to(dt), v.to(dt)
            dq, dk, dv = (_distribute(rules, x, ("batch", None, None, None))
                          for x in (q, kd, vd))
            route = _constrain_attention_layout(dq, dk, dv, rules)[0]
            with torch.no_grad():
                got = _sharded_attention(dq, dk, dv, rules, causal=True,
                                         prefix_len=0, **kw).full_tensor()
            half = t // 2
            out[f"{tag}_{str(dt)[6:]}"] = {
                "route": route, "got": got, "v": vd,
                "want": fa.flash_attention_recurrence(
                    q, kd, vd, causal=True, block_k=half,
                    bounds=[0, half], **kw),
                "whole": fa.flash_attention_reference(q, kd, vd, causal=True,
                                                      **kw)}
    return out


def run_compressed_loop(mesh, tmp, compression):
    """``TrainLoop`` for 2 steps with ``compression``, unsharded and at
    2 x 2: losses and the final parameters."""
    from repro_torch.launch.train import TrainLoop
    cfg = case_cfg("dense")
    out = {}
    for tag, m in (("plain", None), ("sharded", mesh)):
        loop = TrainLoop(cfg, batch=B, seq=S, steps=2, lr=1e-3, warmup=1,
                         ckpt_dir=os.path.join(tmp, f"ckpt_{compression}_"
                                                    f"{tag}"),
                         ckpt_every=100, compression=compression, mesh=m,
                         device="cpu")
        res = loop.run()
        out[tag] = {"losses": [h["loss"] for h in res["history"]],
                    "params": _full(loop.state.params),
                    "error": _full(loop.state.comp.error)}
    out["old"] = _full(steps.init_train_state(cfg, seed=0,
                                              device="cpu").params)
    return out


def run_train_loop(mesh, tmp):
    """TrainLoop at 2 x 2 for 3 steps, with and without a failure at
    step 2, and the final state written at 2 x 2."""
    from repro_torch.checkpoint import restore_pytree, save_pytree
    from repro_torch.launch.train import TrainLoop
    cfg = case_cfg("dense")
    out = {}
    for tag, fail in (("plain", None), ("failed", 2)):
        loop = TrainLoop(cfg, batch=B, seq=S, steps=3, lr=1e-3, warmup=1,
                         ckpt_dir=os.path.join(tmp, f"ckpt_{tag}"),
                         ckpt_every=1, mesh=mesh, fail_at=fail,
                         device="cpu")
        res = loop.run()
        out[tag] = {"params": _full(loop.state.params),
                    "losses": [h["loss"] for h in res["history"]],
                    "restarts": res["restarts"]}
    path = os.path.join(tmp, "ckpt_final")
    save_pytree(loop.state, path, 99)
    dist.barrier()
    out["written"] = _full(loop.state)
    # back onto the mesh: each rank's blocks equal the live state's
    back = restore_pytree(loop.state, path, 99)
    same = all(torch.equal(a.to_local(), b.to_local())
               for (_, a), (_, b) in zip(leaves_with_paths(back),
                                         leaves_with_paths(loop.state))
               if isinstance(a, torch.Tensor) and a.dim())
    # onto the mesh from a plain template, by ``shardings=``
    from repro_torch.tree import tree_map
    places = tree_map(lambda t: tuple(t.placements)
                      if hasattr(t, "placements") else None, loop.state)
    plain = steps.init_train_state(cfg, seed=1, device="cpu")
    placed = restore_pytree(plain, path, 99, shardings=places, mesh=mesh)
    for (_, a), (_, b) in zip(leaves_with_paths(placed),
                              leaves_with_paths(loop.state)):
        if hasattr(b, "placements"):
            same = same and a.placements == b.placements and \
                torch.equal(a.to_local(), b.to_local())
    flags = torch.tensor([int(same)])
    dist.all_reduce(flags, op=dist.ReduceOp.MIN)
    out["resharded_equal"] = bool(flags.item())
    out["ckpt_dir"] = path
    return out


def main(rank: int, world: int, tmp: str) -> None:
    from repro_torch.launch.mesh import make_local_mesh
    torch.manual_seed(0)
    torch.set_num_threads(1)            # 4 ranks share the host's cores
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    mesh = make_local_mesh(2, 2, "cpu")
    rules = ShardingRules(mesh)
    results = {}
    jobs = [(name, lambda n=name: run_family(n, rules)) for name in ARCHS]
    # AdamW's factored second moment (bf16 first moment): vr / vc placed
    # as state_sharding places them, their means over shards
    jobs += [("dense_factored", lambda: run_family(
        "dense", rules, AdamWConfig(factored_nu=True, mu_dtype="bfloat16")))]
    jobs += [(f"serve_{name}", lambda n=name: run_serve(n, rules))
             for name in ARCHS]
    jobs += [(f"serve_f32_{name}", lambda n=name: run_serve(
        n, rules, cache_dtype=torch.float32)) for name in ARCHS]
    jobs += [("kv_slices", lambda: run_kv_slices(rules))]
    jobs += [(f"compressed_{c}", lambda c=c: run_compressed_loop(mesh, tmp,
                                                                 c))
             for c in ("int8", "topk")]
    jobs += [("accum", lambda: run_accum(rules)),
             ("moe_drop", lambda: run_moe_drop(rules, tmp)),
             ("train_loop", lambda: run_train_loop(mesh, tmp))]
    for name, job in jobs:
        t0 = time.perf_counter()
        try:
            results[name] = job()
        except Exception:                 # noqa: BLE001  recorded, re-raised
            results[name] = {"error": traceback.format_exc()}
        results[name]["seconds"] = time.perf_counter() - t0
        dist.barrier()
    if rank == 0:
        torch.save(results, os.path.join(tmp, "results.pt"))
    dist.destroy_process_group()
