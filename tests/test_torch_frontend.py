"""Port front end vs the reference: for the programs of test_compiler.py,
the quickstart and the KNN benchmark, every IR stage, the matched
patterns, the MappingPlans and the cost report equal the reference's."""

import dataclasses
import re

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.core import cim_dialect as rcd
from repro.core.passes.cam_map import derive_plan as r_derive_plan
from repro.core.passes.partition import tile_grid as r_tile_grid
from repro_torch.core import cim_dialect as tcd
from repro_torch.core.passes.cam_map import derive_plan as t_derive_plan
from repro_torch.core.passes.partition import tile_grid as t_tile_grid


def _dot_sim(inp, weight):
    others = weight.transpose(-2, -1)
    mm = inp.matmul(others)
    return mm.topk(1, largest=False)


def _eucl_sim(inp, weight):
    diff = inp.unsqueeze(1).sub(weight)
    n = diff.norm(p=2, dim=-1)
    return n.topk(3, largest=False)


def _cos_sim(inp, weight):
    qn = inp.norm(dim=-1, keepdim=True)
    wn = weight.norm(dim=-1, keepdim=True)
    mm = inp.matmul(weight.transpose(-2, -1))
    sim = mm / wn.transpose(-2, -1) / qn
    return sim.topk(1, largest=True)


def hdc_similarity(queries, class_hvs):          # examples/quickstart.py
    others = class_hvs.transpose(-2, -1)
    scores = queries.matmul(others)
    values, indices = scores.topk(1, largest=True)
    return values, indices


def knn_kernel(q, gallery):                      # benchmarks/table2_knn.py
    diff = q.unsqueeze(1).sub(gallery)
    d = diff.norm(p=2, dim=-1)
    return d.topk(5, largest=False)


def _add(a, b):
    return a.add(b)


def hamming_module(pkg, cd, m, n, dim, k, care=False, largest=False):
    """Hand-built cim program (hamming / TCAM ternary): the traced front
    end has no hamming pattern, so such programs enter at compile_module."""
    types = [pkg.TensorType((m, dim)), pkg.TensorType((n, dim))]
    if care:
        types.append(pkg.TensorType((n, dim), "i8"))
    mod = pkg.Module("hamming", types)
    a = mod.arguments
    b = pkg.Builder(mod.body)
    dev = cd.make_acquire(b)
    exe = cd.make_execute(b, dev.result, list(a),
                          [pkg.TensorType((m, k)),
                           pkg.TensorType((m, k), "i32")])
    blk = exe.region().block()
    sim = cd.make_similarity(blk, a[0], a[1], metric="hamming", k=k,
                             largest=largest, care=a[2] if care else None)
    cd.make_yield(blk, sim.results)
    cd.make_release(b, dev.result)
    b.ret(exe.results)
    return mod


def _archs(pkg):
    return {
        "paper": pkg.PAPER_BASE_ARCH,
        "kazemi16": pkg.kazemi_arch(16),
        "r64c128": pkg.ArchSpec(rows=64, cols=128),
        "r16c32_power": pkg.ArchSpec(rows=16, cols=32).with_target("power"),
        "r32_density": pkg.ArchSpec(rows=32, cols=32).with_target("density"),
    }


def _canon(text):
    """IR text with SSA ids renumbered by first appearance: each package
    numbers values from its own process-wide counter."""
    ids = {}
    return re.sub(r"%(\d+)",
                  lambda mt: "%v" + str(ids.setdefault(mt.group(1), len(ids))),
                  text)


def _assert_same_program(rp, tp):
    assert tp.matched_patterns == rp.matched_patterns
    assert [(n, _canon(t)) for n, t in tp.snapshots] == \
        [(n, _canon(t)) for n, t in rp.snapshots]
    assert set(tp.stages) == set(rp.stages)
    for stage in rp.stages:
        assert _canon(tp.dump(stage)) == _canon(rp.dump(stage)), stage
    assert [dataclasses.asdict(p) for p in tp.plans] == \
        [dataclasses.asdict(p) for p in rp.plans]
    assert dataclasses.asdict(tp.cost_report()) == \
        dataclasses.asdict(rp.cost_report())


PROGRAMS = {"dot": (_dot_sim, (10, 256), (32, 256)),
            "eucl": (_eucl_sim, (6, 64), (40, 64)),
            "cos": (_cos_sim, (10, 256), (32, 256)),
            "hdc": (hdc_similarity, (64, 512), (10, 512)),
            "knn": (knn_kernel, (32, 96), (300, 96)),
            "add": (_add, (8, 8), (8, 8))}


@pytest.mark.parametrize("arch", ["paper", "kazemi16", "r64c128",
                                  "r16c32_power", "r32_density"])
@pytest.mark.parametrize("program", sorted(PROGRAMS))
def test_traced_program_stages_equal_reference(program, arch):
    fn, qs, ps = PROGRAMS[program]
    rp = R.compile_fn(fn, [qs, ps], _archs(R)[arch])
    tp = T.compile_fn(fn, [qs, ps], _archs(T)[arch], device="cpu")
    _assert_same_program(rp, tp)


@pytest.mark.parametrize("value_bits,unroll_limit", [(1, 64), (8, 64),
                                                     (8, 0)])
def test_knn_options_equal_reference(value_bits, unroll_limit):
    arch_r = R.ArchSpec(rows=64, cols=64, banks=1024)
    arch_t = T.ArchSpec(rows=64, cols=64, banks=1024)
    rp = R.compile_fn(knn_kernel, [(24, 128), (500, 128)], arch_r,
                      value_bits=value_bits, unroll_limit=unroll_limit,
                      cam_type=R.CamType.ACAM)
    tp = T.compile_fn(knn_kernel, [(24, 128), (500, 128)], arch_t,
                      value_bits=value_bits, unroll_limit=unroll_limit,
                      cam_type=T.CamType.ACAM, device="cpu")
    _assert_same_program(rp, tp)


@pytest.mark.parametrize("care", [False, True])
def test_hand_built_hamming_program_equals_reference(care):
    rm = hamming_module(R, rcd, 16, 200, 100, 10, care)
    tm = hamming_module(T, tcd, 16, 200, 100, 10, care)
    rp = R.compile_module(rm, R.ArchSpec(rows=64, cols=64), value_bits=1)
    tp = T.compile_module(tm, T.ArchSpec(rows=64, cols=64), value_bits=1,
                          device="cpu")
    _assert_same_program(rp, tp)
    assert dataclasses.asdict(tp.engine_plan.spec) == \
        dataclasses.asdict(rp.engine_plan.spec)


def test_large_paper_scale_cost_report_equals_reference():
    """Table II's Pneumonia-scale program (shape tuples only: the cost
    model needs no data)."""
    arch_r = R.ArchSpec(rows=32, cols=32, banks=1024).with_target("power")
    arch_t = T.ArchSpec(rows=32, cols=32, banks=1024).with_target("power")
    rp = R.compile_fn(knn_kernel, [(624, 1024), (180_000, 1024)], arch_r,
                      value_bits=8, unroll_limit=0)
    tp = T.compile_fn(knn_kernel, [(624, 1024), (180_000, 1024)], arch_t,
                      value_bits=8, unroll_limit=0, device="cpu")
    _assert_same_program(rp, tp)


def test_trace_reads_tensor_examples_like_numpy():
    q = np.zeros((6, 64), np.float32)
    w = np.zeros((40, 64), np.float32)
    a = _canon(T.trace(_eucl_sim, [q, w]).dump())
    b = _canon(T.trace(_eucl_sim, [torch.from_numpy(q),
                                   torch.from_numpy(w)]).dump())
    assert a == b == _canon(R.trace(_eucl_sim, [q, w]).dump())
    ints = T.trace(_add, [torch.zeros((8, 8), dtype=torch.int32),
                          torch.zeros((8, 8), dtype=torch.int32)])
    assert ints.arguments[0].type.dtype == "i32"


@pytest.mark.parametrize("rows,cols,bits", [(16, 16, 1), (32, 64, 8),
                                            (64, 64, 8), (256, 128, 1),
                                            (128, 256, 8)])
def test_tile_grid_and_mapping_plan_equal_reference(rows, cols, bits):
    for n, dim in ((1, 1), (37, 100), (2000, 9000), (180_000, 1024)):
        for target in R.OptimizationTarget.ALL:
            ra = R.ArchSpec(rows=rows, cols=cols).with_target(target)
            ta = T.ArchSpec(rows=rows, cols=cols).with_target(target)
            grid = r_tile_grid(ra, n, dim, value_bits=bits)
            assert t_tile_grid(ta, n, dim, value_bits=bits) == grid
            gr, gc, cpv, dpt = grid
            part = dict(m=17, n=n, dim=dim, grid_rows=gr, grid_cols=gc,
                        dims_per_tile=dpt, cells_per_value=cpv,
                        value_bits=bits, metric="dot", k=1, largest=True)
            assert dataclasses.asdict(t_derive_plan(ta, dict(part))) == \
                dataclasses.asdict(r_derive_plan(ra, dict(part)))
