"""Quickstart on the PyTorch/CUDA port: compile a TorchScript-like
similarity kernel to a CAM accelerator with C4CAM, inspect every IR
stage, execute it, and read the latency/energy/power report — the port's
twin of ``examples/quickstart.py``.

It runs on the GPU (the hand-written CUDA kernels) unless given
``--device cpu`` (the kernels' plain PyTorch versions).

    PYTHONPATH=src python examples/port_quickstart.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.core import (CamType, OptimizationTarget, PAPER_BASE_ARCH,
                              compile_fn)
from repro_torch.data import hdc_dataset


# 1. A PyTorch-style similarity kernel (the paper's Fig. 4a HDC example):
#    best-match = largest dot-product similarity.
def hdc_similarity(queries, class_hvs):
    others = class_hvs.transpose(-2, -1)
    scores = queries.matmul(others)
    values, indices = scores.topk(1, largest=True)
    return values, indices


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' to run without a GPU (default: the GPU)")
    args = ap.parse_args()

    # 2. A workload: 8192-d hypervectors, 10 classes, noisy recall queries.
    classes, queries, labels = hdc_dataset(n_classes=10, dim=8192,
                                           n_queries=64)

    # 3. Compile for the paper's base architecture (32x32 subarrays,
    #    8 subarrays/array, 4 arrays/mat, 4 mats/bank).
    prog = compile_fn(hdc_similarity, [queries, classes], PAPER_BASE_ARCH,
                      cam_type=CamType.TCAM, value_bits=1,
                      device=args.device)

    print("pattern matched by Algorithm 1:", prog.matched_patterns)
    print("\n--- torch dialect ---")
    print(prog.dump("torch"))
    print("\n--- cim dialect (fused) ---")
    print(prog.dump("cim_fused"))
    print("\n--- cam dialect (mapped, excerpt) ---")
    print(prog.dump("cam_mapped")[:900], "…")

    # 4. Execute: the compiled plan's packed search (B1 on the GPU).
    plan = prog.engine_plan
    print(f"\nplan: backend={plan.backend} device={plan.device} "
          f"packed={plan.packed}")
    values, indices = prog(queries, classes)
    acc = float((indices.cpu().numpy().ravel() == labels).mean())
    print(f"recall accuracy vs labels: {acc:.3f}")

    # 5. Cost report from the Eva-CAM-analog model.
    rep = prog.cost_report()
    print(f"latency {rep.latency_us:.2f} us | energy {rep.energy_uj:.3f} uJ "
          f"| power {rep.power_w:.2f} W")

    # 6. One-knob design-space exploration: optimization targets.
    for target in OptimizationTarget.ALL:
        r = compile_fn(hdc_similarity, [queries, classes],
                       PAPER_BASE_ARCH.with_target(target), value_bits=1,
                       device=args.device).cost_report()
        print(f"  target={target:14s} latency={r.latency_us:9.2f} us "
              f"power={r.power_w:7.3f} W energy={r.energy_uj:8.3f} uJ")
    assert np.isfinite(values.cpu().numpy()).all()


if __name__ == "__main__":
    main()
