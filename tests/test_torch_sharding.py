"""The port's sharding rules against the reference's (pure logic, no
process group): ``repro_torch.models.sharding`` resolves every logical
axis to the same mesh axes as ``repro.models.sharding`` on shape-only
meshes, the port's parameter, cache and block axes trees equal the
reference's for every architecture, and the DTensor placements agree
with the spec tuples.  Exact equality throughout (no tolerance: these
are names and integers)."""

import jax
import pytest
from jax.sharding import PartitionSpec as P

from repro.configs import ARCH_IDS, get_config as ref_config
from repro.models import blocks as ref_blocks, model as ref_model
from repro.models.sharding import ShardingRules as RefRules
from repro_torch.configs import get_config
from repro_torch.models import blocks, model
from repro_torch.models.sharding import (LOGICAL_RULES, AbstractMesh,
                                         ShardingRules, logical_spec,
                                         mesh_shape)

MESHES = {"16x16": dict(data=16, model=16),
          "2x16x16": dict(pod=2, data=16, model=16),
          "2x2": dict(data=2, model=2),
          "1x4": dict(data=1, model=4)}


class _FakeMesh:
    def __init__(self, **shape):
        self.shape = shape


def _rules(name):
    return (ShardingRules(AbstractMesh(**MESHES[name])),
            RefRules(_FakeMesh(**MESHES[name])))


def test_logical_rules_are_the_reference_s():
    from repro.models.sharding import LOGICAL_RULES as REF
    assert LOGICAL_RULES == REF


# every logical name, and None, at sizes that divide and that do not
DIMS = (1, 2, 3, 4, 8, 16, 40, 48, 256, 512, 51_865, 152_064)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_axes_equal_the_reference_s(mesh):
    port, ref = _rules(mesh)
    names = list(LOGICAL_RULES) + [None]
    for a in names:
        for d in DIMS:
            assert port.resolve(a, d) == ref.resolve(a, d), (a, d)
    # two- and three-dim tensors: one mesh axis shards one dim only
    for a in names:
        for b in names:
            for shape in ((16, 48), (40, 512), (4, 3)):
                assert port.mesh_axes((a, b), shape) == \
                    ref.mesh_axes((a, b), shape), (a, b, shape)
                assert port.spec((a, b), shape) == \
                    tuple(ref.spec((a, b), shape))
    for c in names:
        assert port.mesh_axes(("batch", "seq_act", c), (256, 4096, 5120)) \
            == ref.mesh_axes(("batch", "seq_act", c), (256, 4096, 5120))
    assert port.batch_axes == ref.batch_axes
    assert port.model_axis == ref.model_axis
    assert port.data_size() == ref.data_size()
    assert port.model_size() == ref.model_size()


def test_rank_mismatch_raises_as_the_reference():
    port, _ = _rules("2x2")
    with pytest.raises(ValueError, match="rank mismatch"):
        port.mesh_axes(("batch",), (4, 4))


def test_a_fake_mesh_with_a_shape_dict_works_as_in_the_reference():
    rules = ShardingRules(_FakeMesh(data=16, model=16))
    assert mesh_shape(rules.mesh) == {"data": 16, "model": 16}
    assert rules.spec(("vocab", "embed"), (152_064, 5120)) == \
        ("model", "data")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_placements_agree_with_spec(mesh):
    from torch.distributed.tensor import Replicate, Shard
    port, _ = _rules(mesh)
    names = list(port.shape)
    for axes, shape in ((("batch", "seq_act", None), (256, 4096, 5120)),
                        (("layers", "embed", "qkv_out"), (4, 5120, 5120)),
                        (("vocab", "embed"), (51_865, 1024)),
                        (("experts", "embed", None), (64, 2048, 1408)),
                        (("cache_batch", "cache_seq", "cache_kv",
                          "cache_dim"), (128, 32768, 1, 256))):
        spec = port.spec(axes, shape)
        pl = port.placements(axes, shape)
        assert len(pl) == len(names)
        want = [Replicate()] * len(names)
        for i, choice in enumerate(spec):
            for a in ((choice,) if isinstance(choice, str)
                      else (choice or ())):
                want[names.index(a)] = Shard(i)
        assert list(pl) == want, (axes, spec, pl)
        local = port.local_shape(axes, shape)
        for i, choice in enumerate(spec):
            parts = 1
            for a in ((choice,) if isinstance(choice, str)
                      else (choice or ())):
                parts *= port.shape[a]
            assert local[i] * parts == shape[i]


def _ref_tuples(tree):
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, tuple))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_cache_axes_equal_the_reference_s(arch):
    cfg, rcfg = get_config(arch), ref_config(arch)
    assert model.param_axes(cfg) == _ref_tuples(ref_model.param_axes(rcfg))
    assert model.cache_axes(cfg) == _ref_tuples(ref_model.cache_axes(rcfg))
    for name in ("dense_block_axes", "moe_block_axes", "mamba_block_axes",
                 "shared_attn_block_axes", "xlstm_pair_axes",
                 "encoder_block_axes", "xdec_block_axes"):
        assert getattr(blocks, name)(cfg) == \
            getattr(ref_blocks, name)(rcfg), name


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "deepseek-moe-16b",
                                  "whisper-medium", "paligemma-3b"])
@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
def test_logical_spec_over_the_params_equals_the_reference_s(arch, mesh):
    from repro.launch.specs import params_struct as ref_struct
    from repro.models.sharding import logical_spec as ref_spec
    from repro_torch.launch.specs import params_struct
    port, ref = _rules(mesh)
    cfg, rcfg = get_config(arch), ref_config(arch)
    mine = _by_path(logical_spec(port, params_struct(cfg),
                                 model.param_axes(cfg)))
    theirs = ref_spec(ref, ref_struct(rcfg), ref_model.param_axes(rcfg))
    flat = jax.tree_util.tree_flatten_with_path(
        theirs, is_leaf=lambda x: isinstance(x, P))[0]
    theirs = {"/".join(str(k.key) for k in p): tuple(s) for p, s in flat}
    assert mine == theirs


def _by_path(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_by_path(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}
