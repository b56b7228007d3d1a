"""Train and serve steps (the port of the reference's
``models/steps.py``).

``make_train_step(cfg, schedule, opt_cfg)`` builds ``train_step(state,
batch) -> (state, metrics)``: the next-token loss, its gradient by
autograd (attention through B7's forward and backward kernels on the
card), then AdamW.  The loss is cross entropy computed blockwise over
the sequence: each block's ``(B, block, V)`` logits are formed, reduced
and dropped, and formed again in the backward (a checkpoint per block),
so the whole ``(B, S, V)`` logits never exist.  Where the reference's
step is a pure function that ``jit`` compiles, the port's updates the
state's tensors in place (see :mod:`..optim.adamw`) and returns the
state.  ``make_prefill_step`` / ``make_decode_step`` wrap the serve
entry points.

With ``rules`` (a :class:`.sharding.ShardingRules` over a ``DeviceMesh``)
the state's tensors are DTensors placed as ``launch.specs.state_sharding``
says and the batch is sharded over the batch axes: the forward runs
sharded (:mod:`.model`), each gradient is redistributed to its
parameter's placements (the reference's ``constrain_grads``: a
reduce-scatter onto the FSDP shard, where a plain data-parallel step
would all-reduce the whole tensor), and AdamW updates each rank's
blocks.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, NamedTuple, Tuple

import torch
from torch.utils import checkpoint as ckpt

from . import model as model_mod
from .config import ModelConfig
from .layers import cdtype, logits as unembed
from ..kernels.lm_ops import is_fake
from .sharding import is_dtensor
from ..optim import AdamWConfig, OptState, Schedule, adamw_init, adamw_update
from ..tree import leaves, tree_map, unflatten

Params = Dict[str, Any]

__all__ = ["TrainState", "init_train_state", "blockwise_xent", "loss_fn",
           "forward_hidden", "make_train_step", "make_prefill_step",
           "make_decode_step"]


class TrainState(NamedTuple):
    params: Params
    opt: OptState
    step: torch.Tensor      # 0-dim int32 on the host
    comp: Any = ()          # gradient-compression error-feedback state


def init_train_state(cfg: ModelConfig, *, seed: int = 0, device=None,
                     compressor=None,
                     opt_cfg: AdamWConfig = AdamWConfig()) -> TrainState:
    """Random parameters (``model.init_params`` on ``device``; default
    the GPU, raising without one), each a leaf that requires grad, and
    a fresh optimizer and compressor state."""
    params = model_mod.init_params(cfg, seed=seed, device=device)
    for p in leaves(params):
        p.requires_grad_(True)
    comp = compressor.init(params) if compressor is not None else ()
    return TrainState(params=params, opt=adamw_init(params, opt_cfg),
                      step=torch.zeros((), dtype=torch.int32), comp=comp)


# ---------------------------------------------------------------------------
# blockwise cross entropy
# ---------------------------------------------------------------------------


def _xent_block(logits: torch.Tensor, labels: torch.Tensor,
                mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sum of masked token losses + correct-token count for one block.
    A DTensor block runs on each rank's rows with the whole vocab (the
    label gather and argmax read whole rows): partial sums over the
    batch axes."""
    if is_dtensor(logits):
        return _xent_block_sharded(logits, labels, mask)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None])[..., 0]
    loss = (lse - ll) * mask
    acc = (torch.argmax(logits, -1) == labels).float() * mask
    return loss.sum(), acc.sum()


def _xent_block_sharded(logits, labels, mask):
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = labels.device_mesh
    rows = tuple(Shard(0) if isinstance(p, Shard) else Replicate()
                 for p in labels.placements)
    logits = logits.redistribute(mesh, rows)
    labels = labels.redistribute(mesh, rows)
    mask = mask.redistribute(mesh, rows)
    sums = tuple(Partial() if isinstance(p, Shard) else Replicate()
                 for p in rows)
    return local_map(_xent_block, out_placements=(sums, sums),
                     in_placements=(rows, rows, rows),
                     in_grad_placements=(rows, rows, rows),
                     device_mesh=mesh)(logits, labels, mask)


def blockwise_xent(hidden: torch.Tensor, labels: torch.Tensor,
                   mask: torch.Tensor, params: Params, cfg: ModelConfig,
                   block: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross entropy from final *hidden* states, unembedding block by
    block.  hidden: (B, S, D) post-final-norm; labels / mask: (B, S).
    Returns (mean loss, mean accuracy) over mask.  Under autograd each
    block is checkpointed: its logits are formed again in the backward
    rather than kept."""
    b, s, d = hidden.shape
    blk = min(block, s)
    if s % blk:
        pad = blk - s % blk
        hidden = torch.nn.functional.pad(hidden, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad))
        mask = torch.nn.functional.pad(mask, (0, pad))
        s += pad

    def body(h, lab, m):
        return _xent_block(unembed(params["embed"], h.to(cdtype(cfg)), cfg),
                           lab, m)

    remat = torch.is_grad_enabled()
    loss_sum = hidden.new_zeros((), dtype=torch.float32)
    acc_sum = hidden.new_zeros((), dtype=torch.float32)
    for i in range(0, s, blk):
        args = (hidden[:, i:i + blk], labels[:, i:i + blk],
                mask[:, i:i + blk])
        lsum, asum = ckpt.checkpoint(body, *args, use_reentrant=False) \
            if remat else body(*args)
        loss_sum = loss_sum + lsum
        acc_sum = acc_sum + asum
    denom = torch.clamp(mask.sum(), min=1.0)
    return loss_sum / denom, acc_sum / denom


def loss_fn(params: Params, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor], rules=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token LM loss.  ``batch["tokens"]`` (B, S); labels are the
    tokens shifted left; the final position is masked out (and where
    ``batch["mask"]`` is 0).  Extra modality inputs (vision / frames)
    pass through to the model.  Under ``rules`` the loss and metrics are
    replicated DTensor scalars."""
    with model_mod._sharded(rules):
        tokens = batch["tokens"]
        labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1).long()
        mask = torch.ones(tokens.shape, dtype=torch.float32,
                          device=tokens.device)
        mask[:, -1] = 0.0
        if is_dtensor(tokens):
            mask = _like_batch(mask, tokens)
        if "mask" in batch:
            mask = mask * batch["mask"].float()
        hidden = forward_hidden(params, cfg, batch, rules)
        loss, acc = blockwise_xent(hidden, labels, mask, params, cfg)
    return loss, {"loss": loss, "accuracy": acc}


def _like_batch(t: torch.Tensor, like) -> Any:
    """A plain tensor of the whole batch as a DTensor placed as ``like``
    (each rank keeps its own block)."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, like.device_mesh, like.placements,
                             src_data_rank=None)


def forward_hidden(params: Params, cfg: ModelConfig,
                   batch: Dict[str, torch.Tensor], rules=None
                   ) -> torch.Tensor:
    """``model.forward`` minus the unembedding, with the train path's
    remat: the post-final-norm hidden state."""
    return model_mod.forward(params, cfg, batch, train=True,
                             return_hidden=True, rules=rules)


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------


def _grad_of(params: Params, cfg: ModelConfig,
             batch: Dict[str, torch.Tensor], rules=None):
    """((loss, metrics), gradient tree): a parameter the loss does not
    reach gets a zero gradient, as ``jax.grad`` gives it.  Under
    ``rules`` each gradient is redistributed to its parameter's
    placements (the reference's ``constrain_grads``)."""
    flat = leaves(params)
    loss, metrics = loss_fn(params, cfg, batch, rules)
    with model_mod._sharded(rules):
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    if rules is not None:
        grads = [g.redistribute(p.device_mesh, p.placements)
                 if is_dtensor(p) else g for p, g in zip(flat, grads)]
    return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
            unflatten(params, grads))


def _repeated(n: int):
    if n == 1:
        return contextlib.nullcontext()
    from ..launch.roofline import repeated
    return repeated(n)


def _microbatches(batch: Dict[str, torch.Tensor], k: int):
    """``get(i)``: the ``i``-th of ``k`` row slices of a batch, global rows
    ``[i * B / k, (i + 1) * B / k)`` as the reference slices them (each
    microbatch's loss is the mean over its own masked tokens, so the
    rows must be the reference's).  A DTensor leaf is gathered whole once
    (an all-gather of its rows over the data axes) and each slice is
    placed as the leaf was."""
    from torch.distributed.tensor import distribute_tensor
    whole = {n: x.full_tensor() if is_dtensor(x) else x
             for n, x in batch.items()}

    def get(i: int) -> Dict[str, torch.Tensor]:
        out = {}
        for n, x in batch.items():
            m = whole[n].shape[0] // k
            part = whole[n][i * m:(i + 1) * m]
            out[n] = distribute_tensor(part, x.device_mesh, x.placements,
                                       src_data_rank=None) \
                if is_dtensor(x) else part
        return out
    return get


def make_train_step(cfg: ModelConfig, schedule: Schedule,
                    opt_cfg: AdamWConfig = AdamWConfig(), rules=None,
                    compressor=None, microbatches: int = 1,
                    acc_dtype: str = "float32"):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``compressor``: an error-feedback gradient compressor
    (:mod:`repro_torch.distributed.compression`); its residual rides in
    ``state.comp``.  ``microbatches > 1``: gradient accumulation over
    ``k`` sequential slices of the batch's rows, summed as
    ``(acc + g / k)`` in ``acc_dtype`` (float32 arithmetic, as the
    reference's), dividing the live activations by ``k``.  ``rules``:
    the sharded step (the state and batch DTensors; see the module
    docstring)."""
    acc_dt = getattr(torch, acc_dtype)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        if microbatches == 1:
            (loss, metrics), grads = _grad_of(state.params, cfg, batch,
                                              rules)
        else:
            k = microbatches
            tok = batch["tokens"]
            b = (tok.to_local() if is_dtensor(tok) else tok).shape[0]
            if b % k:
                raise ValueError(f"train_step: batch {b} is not a multiple "
                                 f"of {k} microbatches")
            grads = tree_map(lambda p: torch.zeros_like(p, dtype=acc_dt),
                             state.params)
            loss = acc = 0.0
            # a trace on fake tensors runs one microbatch for all k
            fake = is_fake(tok.to_local() if is_dtensor(tok) else tok)
            microbatch = _microbatches(batch, k)
            for i in range(1 if fake else k):
                mb = microbatch(i)
                with _repeated(k if fake else 1):
                    (l_i, m_i), g = _grad_of(state.params, cfg, mb, rules)
                    with torch.no_grad():
                        for a, gi in zip(leaves(grads), leaves(g)):
                            a.copy_(a.float() + gi.float() / k)
                del g
                loss = loss + l_i / k
                acc = acc + m_i["accuracy"] / k
            metrics = {"loss": loss, "accuracy": acc}
        comp_state = state.comp
        if compressor is not None:
            grads, comp_state = compressor(grads, comp_state)
        step = int(state.step)
        params, opt, opt_metrics = adamw_update(grads, state.opt,
                                                state.params,
                                                schedule(step), opt_cfg)
        del grads
        metrics = {**metrics, **opt_metrics, "step": step}
        return TrainState(params, opt,
                          torch.tensor(step + 1, dtype=torch.int32),
                          comp_state), metrics

    return train_step


# ---------------------------------------------------------------------------
# serve steps
# ---------------------------------------------------------------------------


def make_prefill_step(cfg: ModelConfig, rules=None):
    def prefill_step(params: Params, batch: Dict[str, torch.Tensor],
                     cache: Params):
        return model_mod.prefill(params, cfg, batch, cache, rules=rules)
    return prefill_step


def make_decode_step(cfg: ModelConfig, rules=None):
    def decode_step(params: Params, tokens: torch.Tensor, cache: Params):
        return model_mod.decode_step(params, cfg, tokens, cache,
                                     rules=rules)
    return decode_step
