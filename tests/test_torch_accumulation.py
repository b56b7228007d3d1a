"""``make_train_step(microbatches=4)`` (unsharded) against the
reference's accumulated step from the same state (the qwen2.5-14b smoke
config in float32, 8 x 16 tokens, and with a mask of unequal counts a
row): the loss within 1e-5, each gradient leaf within 1e-4 of its norm
with a float32 ``acc_dtype`` and within 2**-7 of its norm with bfloat16
(about one bf16 rounding of a sum in another order)."""

import dataclasses

import numpy as np
import pytest
import torch

LR = 1e-3


class _Capture:
    """A pass-through "compressor" that keeps the step's gradients."""

    def init(self, params):
        return ()

    def __call__(self, grads, state):
        self.grads = grads
        return grads, state


@pytest.mark.parametrize("acc_dtype,tol", [("float32", 1e-4),
                                           ("bfloat16", 2.0 ** -7)])
def test_microbatched_step_equals_the_reference_s(acc_dtype, tol):
    _against_the_reference(acc_dtype, tol)


def test_microbatched_step_with_ragged_masks_equals_the_reference_s():
    """Rows of unequal mask counts: a microbatch's loss is the mean over
    its own masked tokens, so the port's microbatches must hold the
    reference's rows."""
    mask = (np.arange(16)[None, :]
            < np.array([16, 3, 9, 1, 12, 16, 2, 7])[:, None])
    _against_the_reference("float32", 1e-4, mask.astype(np.float32))


def _against_the_reference(acc_dtype, tol, mask=None):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config as r_smoke
    from repro.models import steps as rs
    from repro.optim import AdamWConfig as RAdamW, constant as r_constant
    from repro_torch import convert
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import steps as ts
    from repro_torch.optim import AdamWConfig, constant
    from repro_torch.tree import leaves_with_paths
    kw = dict(param_dtype="float32", compute_dtype="float32")
    rcfg = dataclasses.replace(r_smoke("qwen2.5-14b"), **kw)
    tcfg = dataclasses.replace(get_smoke_config("qwen2.5-14b"), **kw)
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, rcfg.vocab, (8, 16)).astype(np.int32)
    rcap, tcap = _Capture(), _Capture()
    r_state = rs.init_train_state(jax.random.PRNGKey(0), rcfg)
    r_step = rs.make_train_step(rcfg, r_constant(LR), RAdamW(),
                                compressor=rcap, microbatches=4,
                                acc_dtype=acc_dtype)
    r_batch = {"tokens": jnp.asarray(tokens)}
    batch = {"tokens": torch.from_numpy(tokens).long()}
    if mask is not None:
        r_batch["mask"], batch["mask"] = jnp.asarray(mask), \
            torch.from_numpy(mask)
    _, r_m = r_step(r_state, r_batch)
    r_grads = {"/".join(str(k.key) for k in p): np.asarray(g, np.float32)
               for p, g in jax.tree_util.tree_flatten_with_path(
                   rcap.grads)[0]}

    state = convert.train_state_from_reference(
        jax.tree.map(np.asarray, r_state), tcfg, device="cpu")
    step = ts.make_train_step(tcfg, constant(LR), AdamWConfig(),
                              compressor=tcap, microbatches=4,
                              acc_dtype=acc_dtype)
    _, m = step(state, batch)
    assert abs(float(m["loss"]) - float(r_m["loss"])) <= 1e-5
    for path, g in leaves_with_paths(tcap.grads):
        want = r_grads.pop(path)
        assert str(g.dtype) == f"torch.{acc_dtype}"
        err = np.abs(g.float().numpy() - want).max()
        assert err <= tol * np.linalg.norm(want) + 1e-6, (path, err)
    assert not r_grads
