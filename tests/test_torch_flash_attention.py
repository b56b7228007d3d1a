"""Port B7 (attention forward) vs the reference, on the CPU: the plain
version beside the CUDA kernel against ``flash_attention_pallas`` in
interpret mode (as ``tests/test_flash_attention.py`` runs it) and against
the reference's ``models.layers.attn_core``, on the same numpy inputs.

Tolerances are the reference's own: 2e-3 in float32 (also for float32
queries over a bfloat16 cache, the same algorithm on both sides) and 0.05
where bfloat16 operands are involved (its bf16 flash test).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_pallas
from repro.models.layers import attn_core
from repro_torch.kernels import flash_attention as tfa

F32_ATOL, BF16_ATOL = 2e-3, 0.05


def _data(rng, b, s, t, h, kvh, dh):
    q = rng.standard_normal((b, s, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, t, kvh, dh)).astype(np.float32)
    v = rng.standard_normal((b, t, kvh, dh)).astype(np.float32)
    return q, k, v


def _port(q, k, v, dtype=torch.float32, kv_dtype=None, **kw):
    kv_dtype = kv_dtype or dtype
    out = tfa.flash_attention(torch.from_numpy(q).to(dtype),
                              torch.from_numpy(k).to(kv_dtype),
                              torch.from_numpy(v).to(kv_dtype), **kw)
    assert out.dtype == dtype and out.shape == q.shape
    return out.float().numpy()


def _core(q, k, v, dtype=jnp.float32, kv_dtype=None, **kw):
    kv_dtype = kv_dtype or dtype
    b, s, h, dh = q.shape
    out = attn_core(jnp.asarray(q, dtype), jnp.asarray(k, kv_dtype),
                    jnp.asarray(v, kv_dtype), **kw)
    return np.asarray(out.reshape(b, s, h, dh), np.float32)


@pytest.mark.parametrize("shape", [
    (2, 64, 64, 4, 2, 32), (1, 100, 100, 8, 8, 16),
    (2, 32, 96, 4, 1, 64), (1, 257, 257, 2, 2, 128),
    (1, 16, 512, 4, 4, 32), (1, 70, 90, 10, 2, 16),
    (2, 40, 72, 4, 1, 80), (1, 36, 36, 2, 1, 256),
])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_pallas_and_attn_core(shape, causal, rng):
    q, k, v = _data(rng, *shape)
    got = _port(q, k, v, causal=causal)
    pallas = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal,
                                    block_q=32, block_k=64)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=F32_ATOL)
    np.testing.assert_allclose(got, _core(q, k, v, causal=causal),
                               atol=F32_ATOL)


def test_prefix_lm(rng):
    q, k, v = _data(rng, 1, 32, 32, 2, 2, 16)
    got = _port(q, k, v, causal=True, prefix_len=8)
    pallas = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=True,
                                    prefix_len=8, block_q=16, block_k=16)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=F32_ATOL)
    np.testing.assert_allclose(
        got, _core(q, k, v, causal=True, prefix_len=8), atol=F32_ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_kv_len_masking(causal, rng):
    """Cache-style: only the first kv_len rows are valid."""
    q, k, v = _data(rng, 1, 8, 64, 10, 2, 16)
    got = _port(q, k, v, causal=causal, kv_len=40)
    pallas = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal,
                                    kv_len=40, block_q=8, block_k=16)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=F32_ATOL)
    np.testing.assert_allclose(
        got, _core(q, k, v, causal=causal, kv_len=40), atol=F32_ATOL)


@pytest.mark.parametrize("h,kvh", [(10, 2), (4, 4), (6, 1)])
@pytest.mark.parametrize("q_start,s", [(37, 1), (20, 7)])
def test_decode_and_chunk_rows_at_q_start(h, kvh, q_start, s, rng):
    """Decode (S = 1) and a chunk of rows at global position q_start over
    a cache of 48 rows with kv_len = q_start + S, GQA groups 5, 1, 6."""
    q, k, v = _data(rng, 2, s, 48, h, kvh, 32)
    kw = dict(causal=True, kv_len=q_start + s, q_start=q_start)
    np.testing.assert_allclose(_port(q, k, v, **kw), _core(q, k, v, **kw),
                               atol=F32_ATOL)


def test_bf16(rng):
    q, k, v = _data(rng, 1, 64, 64, 10, 2, 32)
    got = _port(q, k, v, torch.bfloat16, causal=True)
    bq, bk, bv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    pallas = flash_attention_pallas(bq, bk, bv, causal=True)
    np.testing.assert_allclose(got, np.asarray(pallas, np.float32),
                               atol=BF16_ATOL)
    np.testing.assert_allclose(got, _core(q, k, v, jnp.bfloat16, causal=True),
                               atol=BF16_ATOL)
    np.testing.assert_allclose(got, _core(q, k, v, causal=True),
                               atol=BF16_ATOL)


def test_float32_queries_over_a_bf16_cache(rng):
    """The float32 model's cache path: q float32, k/v bfloat16, the
    probabilities rounded to bfloat16 on both sides."""
    q, k, v = _data(rng, 1, 5, 40, 10, 2, 16)
    kw = dict(causal=True, kv_len=30, q_start=25)
    got = _port(q, k, v, torch.float32, torch.bfloat16, **kw)
    want = _core(q, k, v, jnp.float32, jnp.bfloat16, **kw)
    np.testing.assert_allclose(got, want, atol=F32_ATOL)


def test_query_chunks_match_one_block(rng):
    """Past _pick_q_chunk's threshold the plain version chunks queries;
    each chunk's rows equal the same rows computed in one block."""
    q, k, v = _data(rng, 1, 600, 3600, 2, 1, 16)
    assert tfa._pick_q_chunk(600, 3600) == 512
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    whole = tfa.flash_attention_reference(qt, kt, vt, causal=True)
    tail = tfa.flash_attention_reference(qt[:, 512:], kt, vt, causal=True,
                                         q_start=512)
    assert torch.equal(whole[:, 512:], tail)


def test_cpu_wrapper_is_the_plain_version_and_checks(rng):
    q, k, v = (torch.from_numpy(x) for x in _data(rng, 1, 6, 9, 4, 2, 16))
    assert torch.equal(tfa.flash_attention(q, k, v, kv_len=7),
                       tfa.flash_attention_reference(q, k, v, kv_len=7))
    with pytest.raises(ValueError, match="kv_len"):
        tfa.flash_attention(q, k, v, kv_len=10)
    with pytest.raises(ValueError, match="kv_len"):
        tfa.flash_attention(q, k, v, kv_len=0)
    with pytest.raises(ValueError, match="multiple"):
        tfa.flash_attention(q, k[:, :, :1].expand(1, 9, 3, 16).contiguous(),
                            v[:, :, :1].expand(1, 9, 3, 16).contiguous())
    with pytest.raises(ValueError, match="dtypes"):
        tfa.flash_attention(q.bfloat16(), k, v)
    with pytest.raises(ValueError, match="q_start"):
        tfa.flash_attention(q, k, v, q_start=-1)
    with pytest.raises(ValueError, match="disagree"):
        tfa.flash_attention(q, k[..., :8], v[..., :8])


# ---------------------------------------------------------------------------
# The recurrence the CUDA routes follow (flash_attention_recurrence) and
# the route rule (flash_route)
# ---------------------------------------------------------------------------

RECURRENCE_CASES = [
    ((1, 200, 200, 4, 2, 32), dict(causal=True)),
    ((2, 64, 300, 10, 2, 16), dict(causal=False, kv_len=250)),
    ((1, 300, 300, 2, 1, 64), dict(causal=True)),
    ((1, 48, 48, 4, 4, 16), dict(causal=True, prefix_len=20)),
    ((1, 150, 150, 4, 1, 80), dict(causal=True, prefix_len=30)),
    ((1, 70, 140, 2, 1, 256), dict(causal=False, kv_len=130)),
]


def _beyond_one_bf16_step(got, want):
    return float(np.mean(np.abs(got - want) > 1e-6 + 2.0 ** -7 * np.abs(want)))


@pytest.mark.parametrize("shape,kw", RECURRENCE_CASES)
def test_recurrence_follows_the_pallas_kernel(shape, kw, rng):
    """Unsplit, at block_k 128, the helper is the Pallas kernel's own
    recurrence: float32 within 1e-5; bf16 with at most 0.1 % of the
    outputs beyond one bf16 step (the same rounding point)."""
    q, k, v = _data(rng, *shape)
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        got = tfa.flash_attention_recurrence(
            *(torch.from_numpy(x).to(dtype) for x in (q, k, v)),
            block_k=128, **kw).float().numpy()
        want = np.asarray(flash_attention_pallas(
            *(jnp.asarray(x, jdtype) for x in (q, k, v)), block_k=128,
            interpret=True, **kw), np.float32)
        if dtype == torch.float32:
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        else:
            assert _beyond_one_bf16_step(got, want) <= 1e-3


@pytest.mark.parametrize("splits", [1, 2, 5, 64])
@pytest.mark.parametrize("shape,kw", RECURRENCE_CASES + [
    ((2, 1, 300, 10, 2, 32), dict(causal=True, q_start=260, kv_len=261)),
    ((1, 9, 140, 10, 2, 16), dict(causal=True, q_start=120, kv_len=129)),
])
def test_split_recurrence_equals_the_unsplit_one(shape, kw, splits, rng):
    """float32 over a float32 cache: the splits, each from m = -1e30 and
    combined in float32, give the unsplit result within 1e-5 (also for
    splits past the last visible tile, and rows a split cannot see)."""
    q, k, v = (torch.from_numpy(x) for x in _data(rng, *shape))
    whole = tfa.flash_attention_recurrence(q, k, v, block_k=64, **kw)
    split = tfa.flash_attention_recurrence(q, k, v, block_k=64,
                                           splits=splits, **kw)
    assert bool(torch.isfinite(split).all())
    torch.testing.assert_close(split, whole, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape,kw", [
    ((2, 1, 300, 10, 2, 32), dict(causal=True, q_start=260, kv_len=261)),
    ((1, 9, 140, 10, 2, 16), dict(causal=True, q_start=120, kv_len=129)),
    ((1, 40, 90, 8, 2, 16), dict(causal=False, kv_len=77)),
])
def test_split_recurrence_in_bf16_is_within_the_bf16_bound(shape, kw, rng):
    q, k, v = (torch.from_numpy(x).bfloat16() for x in _data(rng, *shape))
    got = tfa.flash_attention_recurrence(q, k, v, block_k=64, splits=3, **kw)
    want = tfa.flash_attention_reference(q, k, v, **kw)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), atol=BF16_ATOL,
                               rtol=0)


@pytest.mark.parametrize("b,s,h,kvh,t,kw,name", [
    (1, 2048, 40, 8, 2081, dict(kv_len=2048), "wgmma"),
    (1, 1, 40, 8, 2081, dict(q_start=2048, kv_len=2049), "splitkv"),
    (2, 1, 40, 8, 2081, dict(q_start=2048, kv_len=2049), "splitkv"),
    (1, 1, 40, 8, 32768, dict(q_start=32767, kv_len=32768), "splitkv"),
    (2, 16, 8, 2, 200, dict(q_start=100, kv_len=116), "splitkv"),
    (2, 17, 8, 2, 200, dict(q_start=100, kv_len=117), "wgmma"),
    (1, 64, 4, 4, 64, dict(causal=False), "splitkv"),
    (1, 65, 4, 4, 65, dict(causal=False), "wgmma"),
])
def test_route_rule(b, s, h, kvh, t, kw, name):
    """bf16: split-KV up to FLASH_SPLITKV_ROWS query rows per kv head,
    wgmma above; the splits cut the visible 64-row tiles into non-empty
    runs over at most FLASH_SPLIT_BLOCKS blocks; float32 queries: FMA."""
    route = tfa.flash_route((b, s, h, 128), (b, t, kvh, 128),
                            torch.bfloat16, **kw)
    assert route.name == name
    assert route.block_k == tfa.FLASH_BLOCK_K[name]
    assert tfa.flash_route((b, s, h, 128), (b, t, kvh, 128), torch.float32,
                           **kw) == ("fma", tfa.FLASH_BLOCK_K["fma"], None)
    if name == "wgmma":
        assert s * h // kvh > tfa.FLASH_SPLITKV_ROWS and route.splits is None
        return
    assert s * h // kvh <= tfa.FLASH_SPLITKV_ROWS
    end = tfa._col_end(s, kw.get("kv_len", t), kw.get("causal", True),
                       kw.get("prefix_len", 0), kw.get("q_start", 0))
    tiles = -(-end // route.block_k)
    per = -(-tiles // route.splits)
    assert (route.splits - 1) * per < tiles <= route.splits * per
    assert route.splits == 1 or \
        b * kvh * route.splits <= tfa.FLASH_SPLIT_BLOCKS


@pytest.mark.parametrize("shape,kw", [
    ((1, 150, 150, 2, 1, 256), dict(causal=True, prefix_len=40)),
    ((2, 8, 200, 8, 1, 256), dict(causal=False, kv_len=151)),
    ((1, 100, 100, 4, 4, 80), dict(causal=True)),
])
def test_recurrence_at_64_row_tiles_follows_the_pallas_kernel(shape, kw,
                                                              rng):
    """The tile width of the wgmma route at dh 256 and of split-KV at
    every dim: the recurrence at block_k 64 is the Pallas kernel's at
    block_k 64 (float32 within 1e-5; bf16 at most 0.1 % of the outputs
    beyond one bf16 step)."""
    q, k, v = _data(rng, *shape)
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        got = tfa.flash_attention_recurrence(
            *(torch.from_numpy(x).to(dtype) for x in (q, k, v)),
            block_k=64, **kw).float().numpy()
        want = np.asarray(flash_attention_pallas(
            *(jnp.asarray(x, jdtype) for x in (q, k, v)), block_k=64,
            interpret=True, **kw), np.float32)
        if dtype == torch.float32:
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        else:
            assert _beyond_one_bf16_step(got, want) <= 1e-3


@pytest.mark.parametrize("dh,s,h,kvh,t,kw,name,block_k,max_blocks", [
    (80, 2048, 32, 32, 2081, dict(kv_len=2048), "wgmma", 128, None),
    (80, 1, 32, 32, 2081, dict(q_start=2048, kv_len=2049), "splitkv", 64,
     264),
    (256, 2304, 8, 1, 2337, dict(kv_len=2304, prefix_len=256), "wgmma", 64,
     None),
    (256, 1, 8, 1, 2337, dict(q_start=2304, kv_len=2305, prefix_len=256),
     "splitkv", 64, 132),
    (256, 1, 8, 1, 32768, dict(q_start=32767, kv_len=32768), "splitkv", 64,
     132),
])
def test_route_rule_at_head_dims_80_and_256(dh, s, h, kvh, t, kw, name,
                                            block_k, max_blocks):
    """The route's block_k follows the kernel's tile at the head dim (the
    wgmma route's 64-row tiles at dh 256), and split-KV aims for one
    block an SM at dh 256, where one block fills an SM's shared memory
    (two elsewhere); float32 queries keep the FMA route's 64."""
    for b in (1, 2):
        route = tfa.flash_route((b, s, h, dh), (b, t, kvh, dh),
                                torch.bfloat16, **kw)
        assert route.name == name and route.block_k == block_k
        assert tfa.flash_route((b, s, h, dh), (b, t, kvh, dh),
                               torch.float32, **kw) == ("fma", 64, None)
        if name == "wgmma":
            assert route.splits is None
            continue
        end = tfa._col_end(s, kw["kv_len"], True, kw.get("prefix_len", 0),
                           kw["q_start"])
        tiles = -(-end // block_k)
        per = -(-tiles // route.splits)
        assert (route.splits - 1) * per < tiles <= route.splits * per
        assert b * kvh * route.splits <= max_blocks
        assert route.splits == min(tiles, max_blocks // (b * kvh)) or \
            per > 1


@pytest.mark.parametrize("b,h,kvh,dh,t,prefix", [
    (1, 40, 8, 128, 2081, 0),      # qwen2.5-14b decode
    (2, 40, 8, 128, 2100, 0),      # its batch of 2
    (1, 40, 8, 128, 4200, 0),      # past 64 tiles
    (1, 32, 32, 80, 2081, 0),      # zamba2-2.7b (aim 8)
    (1, 16, 16, 128, 2081, 0),     # deepseek-moe-16b (aim 16)
    (1, 8, 1, 256, 2337, 256),     # paligemma-3b, its vision prefix
    (1, 32, 2, 128, 717, 0),       # chatglm3-6b (16 folded rows)
    (1, 40, 40, 128, 717, 0),      # qwen1.5-32b (MHA)
    (1, 96, 8, 128, 717, 0),       # mistral-large-123b (12 folded rows)
    (1, 32, 2, 128, 32769, 0),     # chatglm3-6b at decode_32k's length
])
def test_device_start_grid_holds_every_live_length(b, h, kvh, dh, t, prefix):
    """A call with a device start sizes the split-KV grid before the live
    length is known: for every live tile count up to the view's capacity
    the kernel's cut (``flash_route``'s splits at that length) fits the
    grid, so no split of live tiles goes unlaunched.  The cut is not
    monotone in the tile count, so the capacity's own cut would not do:
    at zamba2's aim of 8, 33 tiles cut into 7 splits and 8 tiles into 8."""
    q_shape, k_shape = (b, 1, h, dh), (b, t, kvh, dh)
    grid = tfa.device_start_splits(q_shape, k_shape, torch.bfloat16,
                                   causal=True, prefix_len=prefix)
    cap = tfa.flash_route(q_shape, k_shape, torch.bfloat16,
                          prefix_len=prefix, kv_len=t, q_start=t - 1)
    bk, n_cap = cap.block_k, -(-t // cap.block_k)
    assert grid * b * kvh <= max(tfa.FLASH_SPLIT_BLOCKS, b * kvh)
    cuts = []
    for n in range(1, n_cap + 1):
        kv_len = max(min(n * bk, t), prefix + 1)
        route = tfa.flash_route(q_shape, k_shape, torch.bfloat16,
                                prefix_len=prefix, kv_len=kv_len,
                                q_start=kv_len - 1)
        cuts.append(route.splits)
    assert max(cuts) <= grid
    assert max(cuts) == grid
    if (kvh, dh) == (32, 80):
        assert cap.splits == 7 and cuts[7] == 8 == grid
    assert tfa.device_start_splits(
        (b, 65, h, dh), k_shape, torch.bfloat16) is None
    assert tfa.device_start_splits(q_shape, k_shape, torch.float32) is None


# ---------------------------------------------------------------------------
# The backward's route rule (flash_bwd_route)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,t,h,kvh,dh,kw,want", [
    # qwen2.5-14b's causal prefill and its train step's batch of 4
    (1, 2048, 2048, 40, 8, 128, dict(causal=True), ("wgmma", True)),
    (4, 2048, 2048, 40, 8, 128, dict(causal=True), ("wgmma", True)),
    # whisper's non-causal encoder and cross-attention, zamba2's dh 80
    (1, 1500, 1500, 16, 16, 64, dict(causal=False),
     ("wgmma", False)),
    (1, 4, 1500, 16, 16, 64, dict(causal=False), ("wgmma", False)),
    (1, 2048, 2048, 32, 32, 80, dict(causal=True), ("wgmma", True)),
    # a padded head dim (96 -> 128), a cache window
    (1, 1024, 1024, 16, 4, 96, dict(causal=True), ("wgmma", True)),
    (2, 3, 90, 6, 2, 16, dict(causal=True, q_start=70, kv_len=73),
     ("wgmma", True)),
    # paligemma's dh 256 and a dh padded to it take the wgmma route too
    (1, 2304, 2304, 8, 1, 256, dict(causal=True, prefix_len=256),
     ("wgmma", True)),
    (1, 100, 100, 4, 2, 200, dict(causal=True), ("wgmma", True)),
])
def test_bwd_route_rule(b, s, t, h, kvh, dh, kw, want):
    """bf16 takes the wgmma route at every head dim (causal calls pair
    their kv tiles); float32 the FMA route at every dim.  A pure
    function: the same arguments give the same route, and no tensor is
    needed."""
    q_shape, k_shape = (b, s, h, dh), (b, t, kvh, dh)
    route = tfa.flash_bwd_route(q_shape, k_shape, torch.bfloat16, **kw)
    assert tuple(route) == want
    assert route == tfa.flash_bwd_route(q_shape, k_shape, torch.bfloat16,
                                        **kw)
    f32 = tfa.flash_bwd_route(q_shape, k_shape, torch.float32, **kw)
    assert f32 == ("fma", False)
    assert route.name == "wgmma"


def _slice_walks(b, s, t, h, kvh, kw, slices):
    """Each dK / dV block's stages at dh 256 as the kernel walks them:
    slice ``i`` of a unit's stages, the unit's tiles' stages in order
    (``wh::walk_of``, copied by ``_bwd_cut``), over ``b * kvh`` copies
    of the units."""
    units = tfa._bwd_unit_stages(s, t, h // kvh, kw["causal"],
                                 kw.get("prefix_len", 0),
                                 kw.get("kv_len") or t, kw.get("q_start", 0))
    return [n for w in units * (b * kvh) for n in tfa._bwd_cut(w, slices)]


@pytest.mark.parametrize("b,s,t,h,kvh,kw,want", [
    # paligemma-3b's prefix-LM shape: one wave of 126 blocks (144 head
    # slices would take two), and at the train step's batch of 4
    (1, 2304, 2304, 8, 1, dict(causal=True, prefix_len=256), 7),
    (4, 2304, 2304, 8, 1, dict(causal=True, prefix_len=256), 5),
    # and at the smoke's paligemma-3b train step's batch of 2
    (2, 2304, 2304, 8, 1, dict(causal=True, prefix_len=256), 7),
    # small shapes: a slice per stage
    (2, 96, 96, 6, 2, dict(causal=True), 9),
    (2, 300, 300, 8, 1, dict(causal=True, prefix_len=40), 12),
    (2, 5, 300, 8, 1, dict(causal=True, q_start=290, kv_len=295), 8),
])
def test_bwd_slices_rule(b, s, t, h, kvh, kw, want):
    """flash_bwd_slices at dh 256 (1 at every other head dim), and the
    blocks it gives: each block's stages within one of every other
    block's of its unit, at paligemma's shape within 3 a kv head's stages
    (the prefix's 4 tiles see 36 q tiles, so pairs 0-3 walk 37-40 of
    them, the rest 37) and within one wave of the card's SMs at B = 1
    (two at 2, three at 4)."""
    q_shape, k_shape = (b, s, h, 256), (b, t, kvh, 256)
    n = tfa.flash_bwd_slices(q_shape, k_shape, **kw)
    assert n == want
    assert tfa.flash_bwd_slices(q_shape, k_shape, sms=tfa._BWD_SMS,
                                **kw) == n
    assert tfa.flash_bwd_slices((b, s, h, 128), (b, t, kvh, 128), **kw) == 1
    assert tfa.flash_bwd_slices((b, s, h, 200), (b, t, kvh, 200), **kw) == n
    walks = _slice_walks(b, s, t, h, kvh, kw, n)
    units = tfa._bwd_unit_stages(s, t, h // kvh, True,
                                 kw.get("prefix_len", 0),
                                 kw.get("kv_len") or t, kw.get("q_start", 0))
    assert sum(walks) == sum(units) * b * kvh       # every stage once
    for u in range(len(walks) // n):
        own = walks[u * n:(u + 1) * n]
        assert max(own) - min(own) <= 1
    if s == 2304:
        assert max(units) - min(units) == 3 * h
        assert len(walks) <= tfa._BWD_SMS or b > 1
        assert -(-len(walks) // tfa._BWD_SMS) == {1: 1, 2: 2, 4: 3}[b]
