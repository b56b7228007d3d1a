"""One-shot learning with TCAM wildcards (ternary packed search, served)
on the PyTorch/CUDA port — the port's twin of
``examples/tcam_wildcard.py``.

Store one ternary row per class: cells where a class's few exemplars
*agree* keep their bit and are compared; cells where they *disagree*
become "don't care" wildcards that never mismatch.  A query then matches
the class whose *stable* bits it satisfies best.

The gallery comes from 3 exemplars a class of noisy binary prototypes; a
hand-built ternary ``cim.similarity`` program (the care mask a third
operand) goes through ``Builder`` / ``PassManager`` /
``CompulsoryPartition``, and ``CamSearchServer`` serves concurrent
classification requests.  The plan executes bit-packed
(``popcount((q ^ p) & care)`` over 32-cell lanes: kernel B1, ternary, on
the GPU unless given ``--device cpu``) and the snapshot shows ``packed:
true, ternary: true``.

    PYTHONPATH=src python examples/port_tcam_wildcard.py [--device cpu]
"""

import argparse
import json
import threading

import numpy as np

from repro_torch.core import (ArchSpec, Builder, Module, PassManager,
                              TensorType, get_plan)
from repro_torch.core.cim_dialect import (make_acquire, make_execute,
                                          make_release, make_similarity,
                                          make_yield)
from repro_torch.core.passes import CompulsoryPartition
from repro_torch.serving import CamSearchServer

N_CLASSES = 16
DIM = 512
EXEMPLARS = 3          # one-shot-ish: a handful of examples per class
NOISE = 0.05           # per-bit flip probability
N_QUERIES = 256


def ternary_program(m, n, dim, k, arch):
    """cim IR for a TCAM wildcard search: similarity(q, p, care)."""
    mod = Module("one_shot_tcam",
                 [TensorType((m, dim)), TensorType((n, dim)),
                  TensorType((n, dim), "i8")])
    q, p, c = mod.arguments
    b = Builder(mod.body)
    dev = make_acquire(b)
    exe = make_execute(b, dev.result, [q, p, c],
                       [TensorType((m, k)), TensorType((m, k), "i32")])
    blk = exe.region().block()
    sim = make_similarity(blk, q, p, metric="hamming", k=k, largest=False,
                          care=c, extra_attrs={"value_bits": 1})
    make_yield(blk, sim.results)
    make_release(b, dev.result)
    b.ret(exe.results)
    pm = PassManager()
    pm.add(CompulsoryPartition())
    return pm.run(mod, {"arch": arch})


def learn_ternary_rows(rng):
    """One ternary (pattern, care) row per class from a few exemplars."""
    protos = (rng.random((N_CLASSES, DIM)) > 0.5).astype(np.float32)
    flips = rng.random((N_CLASSES, EXEMPLARS, DIM)) < NOISE
    exemplars = np.abs(protos[:, None, :] - flips.astype(np.float32))
    patterns = exemplars[:, 0, :]                       # any exemplar's bits
    care = (exemplars.min(1) == exemplars.max(1))       # all agree -> compare
    return protos, patterns, care.astype(np.int8)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' to run without a GPU (default: the GPU)")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(0)
    protos, patterns, care = learn_ternary_rows(rng)
    wild = 1.0 - care.mean()
    print(f"gallery: {N_CLASSES} ternary rows x {DIM} cells, "
          f"{100 * wild:.1f}% wildcards")

    mod = ternary_program(64, N_CLASSES, DIM, 1, ArchSpec(rows=32, cols=64))
    plan = get_plan(mod, device=args.device)
    print(f"plan: packed={plan.packed} batch={plan.batch} "
          f"grid={plan.spec.grid_rows}x{plan.spec.grid_cols}")

    labels = rng.integers(0, N_CLASSES, N_QUERIES)
    flips = rng.random((N_QUERIES, DIM)) < NOISE
    queries = np.abs(protos[labels] - flips.astype(np.float32))

    n_clients = 4
    slices = np.array_split(np.arange(N_QUERIES), n_clients)
    preds = {}
    with CamSearchServer(plan, patterns, care_mask=care,
                         max_wait_ms=2.0) as srv:
        def client(cid):
            _, idx = srv.search(queries[slices[cid]])
            preds[cid] = np.asarray(idx)[:, 0]

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        snap = srv.snapshot()

    pred = np.concatenate([preds[c] for c in range(n_clients)])
    acc = float((pred == labels).mean())
    print(f"one-shot TCAM accuracy ({EXEMPLARS} exemplars/class, "
          f"{100 * NOISE:.0f}% bit noise): {acc:.3f}")
    print(json.dumps(snap, indent=1, default=str))
    return {"accuracy": acc, "pred": pred, "served": snap}


if __name__ == "__main__":
    main()
