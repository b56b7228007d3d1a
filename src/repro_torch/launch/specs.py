"""Input and state specs, and their shardings, for every dry-run cell
(the port of the reference's ``launch/specs.py``).

``input_specs(cfg, shape_name)`` returns ``(step_kind, kwargs)`` where the
kwargs are meta-device tensors (shape and dtype, no storage: the twin of
the reference's ``ShapeDtypeStruct``):

* ``train_4k``    -> ``train_step(state, batch)``
* ``prefill_32k`` -> ``prefill_step(params, batch, cache)``
* ``decode_32k`` / ``long_500k`` -> ``decode_step(params, tokens, cache)``
  (one new token against a KV cache of seq_len)

``long_500k`` requires sub-quadratic sequence mixing and is only emitted
for hybrid / ssm families (``cfg.supports_long_context``); full-attention
architectures skip it.  The ``*_sharding`` functions give the reference's
``PartitionSpec`` tuples (:meth:`..models.sharding.ShardingRules.spec`);
:func:`state_axes` and ``model.param_axes`` / ``cache_axes`` give the
logical axes that ``ShardingRules.placements`` turns into DTensor
placements.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from ..models import model as model_mod, steps as steps_mod
from ..models.config import ModelConfig
from ..models.sharding import ShardingRules, logical_spec
from ..optim.adamw import AdamWConfig, OptState
from ..tree import tree_map

__all__ = ["SHAPES", "ShapeSpec", "default_microbatches", "skip_reason",
           "batch_struct", "batch_axes_tree", "params_struct",
           "cache_struct", "train_state_struct", "params_sharding",
           "cache_sharding", "batch_sharding", "state_sharding",
           "state_axes", "input_specs", "cell_shardings"]


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def default_microbatches(cfg: ModelConfig, shape_name: str,
                         rules: ShardingRules,
                         act_budget_bytes: float = 2 * 2**30) -> int:
    """Gradient-accumulation factor for train cells.

    Sizes the remat-saved activation stack (n_layers x B/data x S/model x
    d_model x 2B under sequence-parallel sharding) against a per-device
    budget; k must divide the per-data-shard batch.
    """
    sp = SHAPES[shape_name]
    if sp.kind != "train":
        return 1
    data = rules.data_size()
    model = rules.model_size()
    b_loc = max(1, sp.global_batch // data)
    s_loc = max(1, sp.seq_len // model)
    layers = cfg.n_layers + cfg.n_encoder_layers
    saved = layers * b_loc * s_loc * cfg.d_model * 2
    k = 1
    while saved / k > act_budget_bytes and k < b_loc and \
            (b_loc % (k * 2) == 0):
        k *= 2
    return k


def skip_reason(cfg: ModelConfig, shape_name: str) -> Optional[str]:
    if shape_name == "long_500k" and not cfg.supports_long_context:
        return (f"{cfg.name} is pure full attention (O(S^2) prefill / O(S) "
                f"per-token KV); long_500k requires sub-quadratic mixing "
                f"(run only for hybrid/ssm) — see DESIGN.md")
    return None


# ---------------------------------------------------------------------------
# batch / cache / params specs: meta tensors
# ---------------------------------------------------------------------------


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _to_meta(tree):
    return tree_map(lambda t: _meta(t.shape, t.dtype)
                    if isinstance(t, torch.Tensor) else _meta((), torch.int32),
                    tree)


def batch_struct(cfg: ModelConfig, b: int, s: int,
                 with_mask: bool = False) -> Dict[str, Any]:
    batch = {"tokens": _meta((b, s), torch.int32)}
    if with_mask:
        batch["mask"] = _meta((b, s), torch.float32)
    if cfg.family == "vlm":
        batch["vision"] = _meta((b, cfg.n_vision_tokens, cfg.d_model),
                                torch.bfloat16)
    if cfg.family == "audio":
        batch["frames"] = _meta((b, cfg.encoder_seq, cfg.d_model),
                                torch.bfloat16)
    return batch


def batch_axes_tree(cfg: ModelConfig,
                    with_mask: bool = False) -> Dict[str, Any]:
    axes = {"tokens": ("batch", None)}
    if with_mask:
        axes["mask"] = ("batch", None)
    if cfg.family == "vlm":
        axes["vision"] = ("batch", None, None)
    if cfg.family == "audio":
        axes["frames"] = ("batch", None, None)
    return axes


def _traced(fn):
    """``fn()``'s tree of tensors as meta tensors: it runs under a
    ``FakeTensorMode`` (shapes and dtypes only, nothing allocated)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        out = fn()
    return _to_meta(out)


@functools.lru_cache(maxsize=64)
def params_struct(cfg: ModelConfig) -> Any:
    return _traced(lambda: model_mod.init_params(cfg, seed=0, device="cpu"))


@functools.lru_cache(maxsize=64)
def cache_struct(cfg: ModelConfig, b: int, max_len: int) -> Any:
    """The decode cache's meta tensors (its ``len`` a 0-dim int32, as the
    reference's; the port's caches hold it as a host int).  The struct
    functions are memoised: treat their trees as read-only."""
    return _traced(lambda: model_mod.init_decode_cache(cfg, b, max_len,
                                                       device="cpu"))


@functools.lru_cache(maxsize=64)
def train_state_struct(cfg: ModelConfig,
                       opt_cfg: AdamWConfig = AdamWConfig()
                       ) -> steps_mod.TrainState:
    return _traced(lambda: steps_mod.init_train_state(
        cfg, seed=0, device="cpu", opt_cfg=opt_cfg))


# -- sharding trees ---------------------------------------------------------


def params_sharding(cfg: ModelConfig, rules: ShardingRules) -> Any:
    return logical_spec(rules, params_struct(cfg), model_mod.param_axes(cfg))


def cache_sharding(cfg: ModelConfig, rules: ShardingRules, b: int,
                   max_len: int) -> Any:
    return logical_spec(rules, cache_struct(cfg, b, max_len),
                        model_mod.cache_axes(cfg))


def batch_sharding(cfg: ModelConfig, rules: ShardingRules, b: int, s: int,
                   with_mask: bool = False) -> Any:
    return logical_spec(rules, batch_struct(cfg, b, s, with_mask),
                        batch_axes_tree(cfg, with_mask))


def state_axes(cfg: ModelConfig, params: Any,
               opt_cfg: AdamWConfig = AdamWConfig()) -> steps_mod.TrainState:
    """The train state's tree of logical-axis tuples: the optimizer
    leaves mirror their parameters; a factored second moment's row and
    column statistics keep the parameter axes that survive them (``vr``
    drops the last, ``vc`` the second to last)."""
    axes = model_mod.param_axes(cfg)

    def nu_axes(p, a):
        if isinstance(p, torch.Tensor) and opt_cfg.factored_nu and \
                p.dim() >= 2:
            a = tuple(a)
            return {"vr": a[:-1], "vc": a[:-2] + (a[-1],)}
        return a

    nu = _zip_axes(nu_axes, params, axes)
    return steps_mod.TrainState(
        params=axes, opt=OptState(mu=axes, nu=nu, master=axes, count=()),
        step=(), comp=())


def _zip_axes(fn, tree, axes):
    if isinstance(tree, dict):
        return {k: _zip_axes(fn, v, axes[k]) for k, v in tree.items()}
    return fn(tree, axes)


def state_sharding(cfg: ModelConfig, rules: ShardingRules,
                   opt_cfg: AdamWConfig = AdamWConfig()) -> Any:
    """TrainState sharding: opt-state leaves mirror their parameters.

    Factored second moments (Adafactor mode) shard their row/col stats
    with the corresponding surviving parameter axes."""
    struct = train_state_struct(cfg, opt_cfg)
    return logical_spec(rules, struct, state_axes(cfg, struct.params,
                                                  opt_cfg))


# ---------------------------------------------------------------------------
# the per-cell entry point
# ---------------------------------------------------------------------------


def input_specs(cfg: ModelConfig, shape_name: str,
                opt_cfg: AdamWConfig = AdamWConfig()
                ) -> Tuple[str, Dict[str, Any]]:
    """(kind, kwargs of meta tensors) for one (arch x shape) cell."""
    sp = SHAPES[shape_name]
    b, s = sp.global_batch, sp.seq_len
    if sp.kind == "train":
        return "train", {"state": train_state_struct(cfg, opt_cfg),
                         "batch": batch_struct(cfg, b, s, with_mask=True)}
    if sp.kind == "prefill":
        return "prefill", {"params": params_struct(cfg),
                           "batch": batch_struct(cfg, b, s),
                           "cache": cache_struct(cfg, b, s)}
    # decode: one new token against a cache of seq_len
    return "decode", {"params": params_struct(cfg),
                      "tokens": _meta((b, 1), torch.int32),
                      "cache": cache_struct(cfg, b, s)}


def cell_shardings(cfg: ModelConfig, rules: ShardingRules,
                   shape_name: str,
                   opt_cfg: AdamWConfig = AdamWConfig()) -> Dict[str, Any]:
    sp = SHAPES[shape_name]
    b, s = sp.global_batch, sp.seq_len
    if sp.kind == "train":
        return {"state": state_sharding(cfg, rules, opt_cfg),
                "batch": batch_sharding(cfg, rules, b, s, with_mask=True)}
    if sp.kind == "prefill":
        return {"params": params_sharding(cfg, rules),
                "batch": batch_sharding(cfg, rules, b, s),
                "cache": cache_sharding(cfg, rules, b, s)}
    return {"params": params_sharding(cfg, rules),
            "tokens": (rules.mesh_axes(("batch",), (b,))[0], None),
            "cache": cache_sharding(cfg, rules, b, s)}
