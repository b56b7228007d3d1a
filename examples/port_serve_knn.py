"""Serving KNN search on the PyTorch/CUDA port: continuous batching over
one single-device SearchPlan.

Compiles the paper's KNN workload once with ``repro_torch``, wraps the
cached SearchPlan in the continuous-batching search server, and drives it
from concurrent client threads — the port's twin of
``examples/serve_knn.py`` (one device, no sharding).  It runs on the GPU
(the ``"cuda"`` backend and its hand-written kernels) unless given
``--device cpu``, compares the served neighbours with the plan's direct
result (on the GPU they must be equal), and prints the 5-NN accuracy and
the server snapshot.
``--trace PATH`` records the served run (``repro_torch.obs``) and writes
the Chrome-tracing export there (Perfetto / ``chrome://tracing``).

    PYTHONPATH=src python examples/port_serve_knn.py [--device cpu]
"""

import argparse
import threading

import numpy as np

from repro_torch.core import ArchSpec, compile_fn
from repro_torch.data import knn_dataset
from repro_torch.obs import enable as enable_tracing
from repro_torch.obs import print_stats
from repro_torch.serving import CamSearchServer


def knn_kernel(queries, gallery):
    diff = queries.unsqueeze(1).sub(gallery)     # (Q,1,D) - (N,D)
    dist = diff.norm(p=2, dim=-1)                # (Q,N)
    return dist.topk(5, largest=False)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' to run without a GPU (default: the GPU)")
    ap.add_argument("--trace", default=None,
                    help="write the served run's Chrome trace here")
    args = ap.parse_args()

    gallery, g_labels, queries, q_labels = knn_dataset(
        n_gallery=8192, dim=256, n_queries=128)
    prog = compile_fn(knn_kernel, [queries[:64], gallery],
                      ArchSpec(rows=64, cols=64), value_bits=8,
                      device=args.device)
    plan = prog.engine_plan
    print(f"plan: batch={plan.batch} backend={plan.backend} "
          f"device={plan.device} metric={plan.spec.metric} "
          f"grid={plan.spec.grid_rows}x{plan.spec.grid_cols}")

    # each client classifies a slice of the query set through the server
    n_clients = 4
    slices = np.array_split(np.arange(len(queries)), n_clients)
    idxs = {}

    if args.trace:
        enable_tracing()
    with CamSearchServer(prog, gallery, max_wait_ms=2.0) as srv:
        def client(cid):
            _, idxs[cid] = srv.search(queries[slices[cid]], timeout=120)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            if t.is_alive():
                raise RuntimeError("a client did not finish in 120 s")
        snap = srv.snapshot()
        if args.trace:
            srv.dump_trace(args.trace)

    idx = np.concatenate([idxs[c] for c in range(n_clients)])
    # batching changes scheduling, not the neighbours found: the GPU
    # kernel computes each query row alone.  (The CPU's plain version
    # takes its products from the BLAS, whose rounding follows the
    # batch's row count, so a float near-tie may swap there.)
    direct = plan.execute(queries, gallery)[1].cpu().numpy()
    same = int((idx == direct).all(axis=1).sum())
    print(f"served rows equal to the direct call: {same}/{len(idx)}")
    if plan.device.type == "cuda" and same != len(idx):
        raise RuntimeError("served neighbours differ from the plan's")
    votes = g_labels[idx]
    pred = np.apply_along_axis(
        lambda v: np.bincount(v, minlength=2).argmax(), 1, votes)
    acc = float((pred == q_labels).mean())
    print(f"5-NN accuracy (served): {acc:.3f}")
    print_stats(snap, title="server snapshot")
    if args.trace:
        print(f"\ntrace: {args.trace} (load in Perfetto / "
              f"chrome://tracing)")


if __name__ == "__main__":
    main()
