"""Multi-device dry run: trace every (arch x shape x mesh) cell on fake
tensors (the port of the reference's ``launch/dryrun.py``).

For each cell the dry run:

1. opens a fake process group of 256 (16 x 16 ``(data, model)``) or 512
   (2 x 16 x 16 ``(pod, data, model)``) ranks in this one process, and
   builds the production ``DeviceMesh`` over it;
2. resolves the sharding rules (logical axes -> mesh axes with
   divisibility fallbacks) for the parameters, optimizer state, batch and
   cache (:mod:`.specs`);
3. builds rank 0's state as DTensors over fake local tensors at the
   per-device shapes, and runs the step once under ``FakeTensorMode``
   inside :func:`.roofline.analyze_step`: the sharding propagation, every
   redistribution's collectives and each kernel call are exercised with
   nothing allocated on any device;
4. records the per-device bytes of the state, batch and cache, the peak
   of live bytes through the traced step (``peak_bytes``: those plus the
   most bytes of the step's own tensors live at once, the temporaries
   the reference's ``memory_analysis`` counts; tallied by
   :func:`.roofline.analyze_step`) and whether that peak fits in the
   card's 80 GB, the gradient-accumulation factor, and the roofline terms
   (analytic seconds at the H100's data-sheet peaks, not measurements),
   into a JSON artifact.

This is the one entry point of the port that allocates nothing on any
device, by design: it traces fake tensors, as the reference compiles
for 512 placeholder host devices.  The fake process group is private
PyTorch API (``torch.testing._internal.distributed.fake_pg``); only this
module imports it, inside :func:`run_cell`, which opens the group and
destroys it after the cell.

Usage::

    python -m repro_torch.launch.dryrun --arch xlstm-125m --shape train_4k
    python -m repro_torch.launch.dryrun --arch all --shape all --mesh both \\
        --out artifacts/dryrun
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
from typing import Any, Dict, Iterator, Optional

import torch

from ..configs import ARCH_IDS, get_config
from ..models import model as model_mod, steps as steps_mod
from ..models.sharding import ShardingRules
from ..optim import AdamWConfig, constant
from ..tree import leaves
from . import roofline as rl
from .mesh import make_production_mesh
from .specs import (SHAPES, batch_axes_tree, default_microbatches,
                    input_specs, skip_reason, state_axes)

__all__ = ["run_cell", "main"]


@contextlib.contextmanager
def _fake_group(world_size: int) -> Iterator[None]:
    """A fake process group of ``world_size`` ranks, this process rank 0
    (its collectives move nothing); destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("dryrun: a process group is already open")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _walk(fn, tree, axes, path=""):
    """``fn(leaf, axes, path)`` over a spec tree (dicts and NamedTuples)."""
    if isinstance(tree, dict):
        return {k: _walk(fn, v, axes[k], f"{path}/{k}" if path else k)
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_walk(fn, getattr(tree, f), getattr(axes, f),
                                  f"{path}/{f}" if path else f)
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(fn, v, a, f"{path}/{i}")
                          for i, (v, a) in enumerate(zip(tree, axes)))
    return fn(tree, axes, path)


def _distribute(rules: ShardingRules, mesh, tree, axes, grad=()):
    """Meta spec tree -> DTensors over fake local blocks (call under a
    ``FakeTensorMode``); 0-dim int32 leaves (step, count, cache length)
    become Python ints, leaves under a path prefix in ``grad`` require
    grad."""
    from torch.distributed.tensor import DTensor

    def one(t, a, path):
        if t.dim() == 0 and t.dtype == torch.int32:
            return 0
        local = torch.empty(rules.local_shape(a, t.shape), dtype=t.dtype)
        d = DTensor.from_local(local, mesh, rules.placements(a, t.shape),
                               run_check=False, shape=t.shape,
                               stride=torch.empty(t.shape,
                                                  device="meta").stride())
        if any(path.startswith(g) for g in grad):
            d.requires_grad_(True)
        return d
    return _walk(one, tree, axes)


def _local_bytes(tree) -> int:
    return sum(t.to_local().numel() * t.element_size()
               for t in leaves(tree) if isinstance(t, torch.Tensor))


def _build_step(cfg, kind: str, rules: ShardingRules, microbatches: int,
                opt_cfg: AdamWConfig, acc_dtype: str):
    if kind == "train":
        return steps_mod.make_train_step(cfg, constant(3e-4), opt_cfg,
                                         rules=rules,
                                         microbatches=microbatches,
                                         acc_dtype=acc_dtype)
    if kind == "prefill":
        return steps_mod.make_prefill_step(cfg, rules=rules)
    return steps_mod.make_decode_step(cfg, rules=rules)


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             microbatches: Optional[int] = None,
             opt_cfg: AdamWConfig = AdamWConfig(),
             acc_dtype: str = "float32", save_ops: Optional[str] = None,
             cfg=None) -> Dict[str, Any]:
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = cfg if cfg is not None else get_config(arch)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_name, "family": cfg.family}
    reason = skip_reason(cfg, shape_name)
    if reason:
        rec["skipped"] = reason
        return rec
    n_dev = 512 if multi_pod else 256
    sp = SHAPES[shape_name]
    kind, specs = input_specs(cfg, shape_name, opt_cfg)
    t0 = time.time()
    with _fake_group(n_dev):
        mesh = make_production_mesh(multi_pod=multi_pod)
        rules = ShardingRules(mesh)
        rec["kind"] = kind
        if microbatches is None:
            microbatches = default_microbatches(cfg, shape_name, rules)
        rec["microbatches"] = microbatches
        step = _build_step(cfg, kind, rules, microbatches, opt_cfg,
                           acc_dtype)
        # the mesh's own rank tensor is real: allow it in
        with FakeTensorMode(allow_non_fake_inputs=True):
            if kind == "train":
                state = _distribute(
                    rules, mesh, specs["state"],
                    state_axes(cfg, specs["state"].params, opt_cfg),
                    grad=("params",))
                batch = _distribute(rules, mesh, specs["batch"],
                                    batch_axes_tree(cfg, True))
                args = (state, batch)
                mem = {"params_bytes": _local_bytes(state.params),
                       "opt_bytes": _local_bytes(state.opt),
                       "batch_bytes": _local_bytes(batch), "cache_bytes": 0}
            else:
                params = _distribute(rules, mesh, specs["params"],
                                     model_mod.param_axes(cfg))
                cache = _distribute(rules, mesh, specs["cache"],
                                    model_mod.cache_axes(cfg))
                if kind == "prefill":
                    inp = _distribute(rules, mesh, specs["batch"],
                                      batch_axes_tree(cfg))
                    _set_len(cache, 0)            # an empty cache
                else:
                    inp = _distribute(rules, mesh, specs["tokens"],
                                      ("batch", None))
                    _set_len(cache, sp.seq_len - 1)    # attend over all
                args = (params, inp, cache)
                mem = {"params_bytes": _local_bytes(params), "opt_bytes": 0,
                       "batch_bytes": _local_bytes(inp),
                       "cache_bytes": _local_bytes(cache)}
            t1 = time.time()
            ctx = torch.enable_grad() if kind == "train" else \
                torch.no_grad()
            with ctx:
                _, rep = rl.analyze_step(step, *args, n_devices=n_dev)
            t_trace = time.time() - t1
    total = sum(mem.values())
    peak = total + rep.temp_peak_bytes
    mf = rl.model_flops(cfg, sp)
    per_dev_mf = mf / n_dev
    rec.update(
        t_setup_s=round(t1 - t0, 2), t_trace_s=round(t_trace, 2),
        memory=dict(mem, total_bytes=total,
                    temp_peak_bytes=rep.temp_peak_bytes, peak_bytes=peak,
                    fits=peak <= rl.HBM_BYTES,
                    note="per device: state, batch and cache (total), and "
                         "peak_bytes = total + the most bytes of the "
                         "step's own tensors live at once (activations, "
                         "gradients, the updated state); fits on the "
                         "peak"),
        roofline=rep.as_dict(), card=rl.CARD,
        advice=rl.bottleneck_advice(rep.bottleneck, kind, cfg.family),
        model_flops_global=mf, model_flops_per_device=per_dev_mf,
        useful_flops_ratio=(per_dev_mf / rep.flops) if rep.flops else None,
        roofline_fraction=(per_dev_mf / rl.PEAK_FLOPS) / rep.t_bound
        if rep.t_bound else None)
    rec["roofline"].pop("op_counts")
    if save_ops:
        os.makedirs(os.path.dirname(save_ops) or ".", exist_ok=True)
        with open(save_ops, "w") as f:
            json.dump(rep.op_counts, f, indent=1, sort_keys=True)
        rec["ops_path"] = save_ops
    return rec


def _set_len(cache, n: int) -> None:
    for c in (cache, cache.get("attn"), cache.get("self")):
        if isinstance(c, dict) and "len" in c:
            c["len"] = n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="all",
                    help=f"architecture id or 'all' ({ARCH_IDS})")
    ap.add_argument("--shape", default="all",
                    help=f"shape name or 'all' ({list(SHAPES)})")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--save-ops", action="store_true",
                    help="write each cell's traced operation tally")
    ap.add_argument("--fail-fast", action="store_true")
    ap.add_argument("--microbatches", type=int, default=None,
                    help="override the gradient-accumulation heuristic")
    ap.add_argument("--factored-opt", action="store_true",
                    help="Adafactor-style factored 2nd moment + bf16 mu")
    ap.add_argument("--acc-dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="gradient-accumulation buffer dtype")
    args = ap.parse_args(argv)
    opt_cfg = AdamWConfig(factored_nu=args.factored_opt,
                          mu_dtype="bfloat16" if args.factored_opt
                          else "float32")

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    t_all = time.time()
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}_{shape}_{'2x16x16' if mp else '16x16'}"
                ops = os.path.join(args.out, tag + ".ops.json") \
                    if args.save_ops else None
                try:
                    rec = run_cell(arch, shape, multi_pod=mp,
                                   microbatches=args.microbatches,
                                   opt_cfg=opt_cfg,
                                   acc_dtype=args.acc_dtype, save_ops=ops)
                except Exception as e:        # noqa: BLE001
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "2x16x16" if mp else "16x16",
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-4000:]}
                    failures += 1
                    print(f"[FAIL] {tag}: {type(e).__name__}: {e}")
                    if args.fail_fast:
                        raise
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(rec, f, indent=1, default=str)
                status = ("SKIP" if rec.get("skipped")
                          else "FAIL" if rec.get("error") else "OK")
                extra = ""
                if status == "OK":
                    m = rec["memory"]
                    extra = (f" state+batch+cache="
                             f"{m['total_bytes'] / 2**30:.2f}GiB "
                             f"peak={m['peak_bytes'] / 2**30:.2f}GiB "
                             f"fits={m['fits']} "
                             f"bottleneck={rec['roofline']['bottleneck']} "
                             f"trace={rec['t_trace_s']}s")
                print(f"[{status}] {tag}{extra}", flush=True)
    print(f"dryrun: {time.time() - t_all:.1f} s, {failures} failed",
          flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
