"""The port's launch specs against the reference's
(``repro_torch.launch.specs`` vs ``repro.launch.specs``): the shapes
table, the long-context skips, the gradient-accumulation heuristic, every
(arch, shape) cell's input specs (meta tensors against the reference's
``ShapeDtypeStruct``s: shape and dtype), and the cell shardings against
the reference's ``PartitionSpec``s on both production meshes, with and
without the factored optimizer.  Exact equality throughout."""

import jax
import pytest
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as ref_config
from repro.launch import specs as rs
from repro.models.sharding import ShardingRules as RefRules
from repro.optim import AdamWConfig as RefAdamW
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import specs as ps
from repro_torch.models.sharding import AbstractMesh, ShardingRules
from repro_torch.optim import AdamWConfig
from repro_torch.tree import leaves_with_paths

MESHES = {"16x16": dict(data=16, model=16),
          "2x16x16": dict(pod=2, data=16, model=16)}


class _FakeMesh:
    def __init__(self, **shape):
        self.shape = shape


def _key(k):
    for a in ("key", "name", "idx"):
        if hasattr(k, a):
            return str(getattr(k, a))
    raise TypeError(k)


def _ref_paths(tree, is_leaf=None):
    return {"/".join(_key(k) for k in p): v for p, v in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]}


def test_shapes_table_is_the_reference_s():
    assert {k: tuple(v.__dict__.values()) for k, v in ps.SHAPES.items()} \
        == {k: tuple(v.__dict__.values()) for k, v in rs.SHAPES.items()}


def test_long_context_skips_the_same_eight_archs():
    skipped = [a for a in ARCH_IDS
               if ps.skip_reason(get_config(a), "long_500k")]
    assert len(skipped) == 8
    for a in ARCH_IDS:
        for shape in ps.SHAPES:
            assert ps.skip_reason(get_config(a), shape) == \
                rs.skip_reason(ref_config(a), shape)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_default_microbatches_equal_the_reference_s(mesh):
    port = ShardingRules(AbstractMesh(**MESHES[mesh]))
    ref = RefRules(_FakeMesh(**MESHES[mesh]))
    for a in ARCH_IDS:
        for shape in ps.SHAPES:
            assert ps.default_microbatches(get_config(a), shape, port) == \
                rs.default_microbatches(ref_config(a), shape, ref), (a, shape)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_equal_the_reference_s(arch):
    cfg, rcfg = get_config(arch), ref_config(arch)
    for shape in ps.SHAPES:
        if ps.skip_reason(cfg, shape):
            continue
        kind, mine = ps.input_specs(cfg, shape)
        rkind, theirs = rs.input_specs(rcfg, shape)
        assert kind == rkind
        mine = dict(leaves_with_paths(mine))
        theirs = _ref_paths(theirs)
        assert set(mine) == set(theirs), set(mine) ^ set(theirs)
        for path, t in mine.items():
            want = theirs[path]
            assert t.device.type == "meta", path
            assert tuple(t.shape) == tuple(want.shape), (shape, path)
            assert str(t.dtype) == f"torch.{want.dtype}", (shape, path)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cell_shardings_equal_the_reference_s(arch):
    cfg, rcfg = get_config(arch), ref_config(arch)
    for mesh in MESHES.values():
        port = ShardingRules(AbstractMesh(**mesh))
        ref = RefRules(_FakeMesh(**mesh))
        for factored in (False, True):
            opt = AdamWConfig(factored_nu=factored)
            ropt = RefAdamW(factored_nu=factored)
            for shape in ps.SHAPES:
                if ps.skip_reason(cfg, shape):
                    continue
                mine = ps.cell_shardings(cfg, port, shape, opt)
                theirs = rs.cell_shardings(rcfg, ref, shape, ropt)
                assert set(mine) == set(theirs)
                for part in mine:
                    m = _by_path(mine[part])
                    t = {p: tuple(s) for p, s in _ref_paths(
                        theirs[part],
                        is_leaf=lambda x: isinstance(x, P)).items()}
                    assert m == t, (shape, part, factored)


def _by_path(tree, prefix=""):
    """Path -> spec tuple (a plain tuple is a leaf here; the train
    state's ``comp`` holds none, as in the reference)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_by_path(v, f"{prefix}/{k}" if prefix else k))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = {}
        for f in tree._fields:
            if f != "comp":
                out.update(_by_path(getattr(tree, f),
                                    f"{prefix}/{f}" if prefix else f))
        return out
    return {prefix: tree}


def test_state_sharding_tree_matches_the_state_struct():
    cfg = get_config("chatglm3-6b")
    rules = ShardingRules(AbstractMesh(**MESHES["16x16"]))
    for factored in (False, True):
        opt = AdamWConfig(factored_nu=factored)
        struct = ps.train_state_struct(cfg, opt)
        spec = ps.state_sharding(cfg, rules, opt)
        assert [p for p, _ in leaves_with_paths(struct)] == \
            list(_by_path(spec))


def test_vlm_audio_frontends_are_stub_inputs():
    vlm = ps.batch_struct(get_config("paligemma-3b"), 4, 16)
    assert tuple(vlm["vision"].shape) == (4, 256, 2048)
    audio = ps.batch_struct(get_config("whisper-medium"), 4, 16)
    assert tuple(audio["frames"].shape) == (4, 1500, 1024)
