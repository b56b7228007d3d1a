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
entry points.  Left out here: the reference's ``rules`` (sharding
constraints on the gradients), which come with ``models/sharding.py``
(ROADMAP Queue A item 8e).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch
from torch.utils import checkpoint as ckpt

from . import model as model_mod
from .config import ModelConfig
from .layers import cdtype, logits as unembed
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
    """Sum of masked token losses + correct-token count for one block."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None])[..., 0]
    loss = (lse - ll) * mask
    acc = (torch.argmax(logits, -1) == labels).float() * mask
    return loss.sum(), acc.sum()


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
            batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token LM loss.  ``batch["tokens"]`` (B, S); labels are the
    tokens shifted left; the final position is masked out (and where
    ``batch["mask"]`` is 0).  Extra modality inputs (vision / frames)
    pass through to the model."""
    tokens = batch["tokens"]
    labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1).long()
    mask = torch.ones(tokens.shape, dtype=torch.float32,
                      device=tokens.device)
    mask[:, -1] = 0.0
    if "mask" in batch:
        mask = mask * batch["mask"].float()
    hidden = forward_hidden(params, cfg, batch)
    loss, acc = blockwise_xent(hidden, labels, mask, params, cfg)
    return loss, {"loss": loss, "accuracy": acc}


def forward_hidden(params: Params, cfg: ModelConfig,
                   batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``model.forward`` minus the unembedding, with the train path's
    remat: the post-final-norm hidden state."""
    return model_mod.forward(params, cfg, batch, train=True,
                             return_hidden=True)


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------


def _grad_of(params: Params, cfg: ModelConfig,
             batch: Dict[str, torch.Tensor]):
    """((loss, metrics), gradient tree): a parameter the loss does not
    reach gets a zero gradient, as ``jax.grad`` gives it."""
    flat = leaves(params)
    loss, metrics = loss_fn(params, cfg, batch)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
            unflatten(params, grads))


def make_train_step(cfg: ModelConfig, schedule: Schedule,
                    opt_cfg: AdamWConfig = AdamWConfig(), compressor=None,
                    microbatches: int = 1, acc_dtype: str = "float32"):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``compressor``: an error-feedback gradient compressor
    (:mod:`repro_torch.distributed.compression`); its residual rides in
    ``state.comp``.  ``microbatches > 1``: gradient accumulation over
    ``k`` sequential slices of the batch's rows, summed as
    ``(acc + g / k)`` in ``acc_dtype`` (float32 arithmetic, as the
    reference's), dividing the live activations by ``k``."""
    acc_dt = getattr(torch, acc_dtype)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        if microbatches == 1:
            (loss, metrics), grads = _grad_of(state.params, cfg, batch)
        else:
            k = microbatches
            b = batch["tokens"].shape[0]
            if b % k:
                raise ValueError(f"train_step: batch {b} is not a multiple "
                                 f"of {k} microbatches")
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=acc_dt,
                                                   device=p.device),
                             state.params)
            loss = acc = 0.0
            for i in range(k):
                mb = {n: x[i * (b // k):(i + 1) * (b // k)]
                      for n, x in batch.items()}
                (l_i, m_i), g = _grad_of(state.params, cfg, mb)
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


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params: Params, batch: Dict[str, torch.Tensor],
                     cache: Params):
        return model_mod.prefill(params, cfg, batch, cache)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params: Params, tokens: torch.Tensor, cache: Params):
        return model_mod.decode_step(params, cfg, tokens, cache)
    return decode_step
