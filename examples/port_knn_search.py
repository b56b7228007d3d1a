"""KNN classification through the C4CAM pipeline on the PyTorch/CUDA port
(the paper's second benchmark): Euclidean-distance top-k search on a CAM
accelerator, executed by the port's compiled plan — the twin of
``examples/knn_search.py``.

It runs on the GPU (the ``fused_topk`` CUDA kernel) unless given
``--device cpu`` (its plain PyTorch version).

    PYTHONPATH=src python examples/port_knn_search.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.core import ArchSpec, CamType, compile_fn
from repro_torch.core.engine import resolve_device
from repro_torch.data import knn_dataset
from repro_torch.kernels import ops as kops


def knn_kernel(queries, gallery):
    diff = queries.unsqueeze(1).sub(gallery)     # (Q,1,D) - (N,D)
    dist = diff.norm(p=2, dim=-1)                # (Q,N)
    return dist.topk(5, largest=False)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' to run without a GPU (default: the GPU)")
    args = ap.parse_args()
    gallery, g_labels, queries, q_labels = knn_dataset(
        n_gallery=8192, dim=256, n_queries=128)

    # --- compile to an ACAM (analog CAM: native Euclidean search) -------
    arch = ArchSpec(rows=64, cols=64, cam_type=CamType.ACAM)
    prog = compile_fn(knn_kernel, [queries, gallery], arch,
                      cam_type=CamType.ACAM, value_bits=8,
                      device=args.device)
    print("pattern:", prog.matched_patterns)
    values, indices = prog(queries, gallery)
    indices = indices.cpu().numpy()

    # --- classify by majority vote over the top-5 ------------------------
    votes = g_labels[indices]
    pred = np.apply_along_axis(lambda v: np.bincount(v, minlength=2).argmax(),
                               1, votes)
    acc = float((pred == q_labels).mean())
    print(f"5-NN accuracy (CAM pipeline): {acc:.3f}")

    # --- the same search as one fused kernel call (ops.cam_topk) --------
    dev = resolve_device(args.device)
    v2, i2 = kops.cam_topk(torch.from_numpy(queries).to(dev),
                           torch.from_numpy(gallery).to(dev),
                           metric="eucl", k=5, largest=False)
    agree = float((i2.cpu().numpy() == indices).mean())
    print(f"fused kernel agreement with compiled CAM result: {agree:.3f}")

    rep = prog.cost_report()
    print(f"modelled: {rep.latency_us:.1f} us, {rep.energy_uj:.2f} uJ, "
          f"{rep.power_w:.2f} W on "
          f"{prog.plans[0].banks_used} bank(s)")
    assert acc > 0.9 and agree > 0.99


if __name__ == "__main__":
    main()
