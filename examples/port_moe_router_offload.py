"""The paper's technique inside the LM framework, on the PyTorch/CUDA port
— the port's twin of ``examples/moe_router_offload.py``.  A
DeepSeek-style MoE router is a ``matmul -> topk`` dataflow, exactly
C4CAM's DotProdSimPattern.  This example:

1. traces the router, shows Algorithm 1 matching it, and runs the
   compiled program: a CAM stores the router's columns as bipolar cells
   (``x > 0``), so its dot search ranks experts by the product of the
   operands' signs; with ``pack=False`` it runs on the float path (B2 on
   the GPU), and its top-6 equals the exact signed product's (integer
   sums: exact in any order; ties toward the lowest expert);
2. prices the routing workload on a CAM accelerator against the GPU model
   (``repro_torch.camsim.QUADRO_RTX_6000``);
3. runs the same router inside a real MoE forward pass with
   ``router_offload="cam"`` (B2 as the router on the GPU) and shows the
   outputs equal the ``"dense"`` routing's within 1e-2.

It runs on the GPU unless given ``--device cpu``.

    PYTHONPATH=src python examples/port_moe_router_offload.py [--device cpu]
"""

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.camsim import QUADRO_RTX_6000
from repro_torch.configs import get_smoke_config
from repro_torch.core import PAPER_BASE_ARCH, compile_fn
from repro_torch.core.engine.base import resolve_device
from repro_torch.models import moe as moe_mod

def router_kernel(tokens, router_patterns):
    scores = tokens.matmul(router_patterns.transpose(-2, -1))
    return scores.topk(6, largest=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' to run without a GPU (default: the GPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    d_model, n_experts, n_tokens = 2048, 64, 4096

    rng = np.random.default_rng(0)
    x = rng.standard_normal((n_tokens, d_model)).astype(np.float32)
    w = rng.standard_normal((n_experts, d_model)).astype(np.float32)

    # 1. compile the router through C4CAM, and run it
    prog = compile_fn(router_kernel, [x, w], PAPER_BASE_ARCH, value_bits=8,
                      pack=False, device=dev)
    print("Algorithm 1 match:", prog.matched_patterns)
    values, idx = prog(torch.from_numpy(x).to(dev),
                       torch.from_numpy(w).to(dev))
    signed = np.where(x > 0, 1, -1) @ np.where(w > 0, 1, -1).T
    want_i = np.argsort(-signed, axis=1, kind="stable")[:, :6]
    exact = bool(np.array_equal(values.cpu().numpy(),
                                np.take_along_axis(signed, want_i, 1))
                 and np.array_equal(idx.cpu().numpy(), want_i))
    print(f"compiled router (backend {prog.engine_plan.backend}, packed "
          f"{prog.engine_plan.packed}): top-6 equal to the exact signed "
          f"product's: {exact}")

    # 2. price it: CAM vs GPU-model
    rep = prog.cost_report()
    gpu = QUADRO_RTX_6000.similarity_workload(n_tokens, n_experts, d_model)
    print(f"CAM routing: {rep.latency_us:.1f} us, {rep.energy_uj:.2f} uJ | "
          f"GPU model: {gpu['time_s'] * 1e6:.1f} us, "
          f"{gpu['energy_j'] * 1e6:.1f} uJ")

    # 3. inside the model: deepseek-style MoE block, cam vs dense routing
    cfg_d = dataclasses.replace(get_smoke_config("deepseek-moe-16b"),
                                router_offload="dense")
    cfg_c = dataclasses.replace(cfg_d, router_offload="cam")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    p = moe_mod.init_moe(gen, cfg_d)
    xb = torch.randn((2, 16, cfg_d.d_model), generator=gen, device=dev,
                     dtype=torch.float32)
    yd = moe_mod.moe_ffn(p, xb, cfg_d)
    yc = moe_mod.moe_ffn(p, xb, cfg_c)
    same = bool(torch.allclose(yd.float(), yc.float(), atol=1e-2))
    print(f"MoE outputs identical (cam vs dense routing): {same}")
    assert same and prog.matched_patterns == ["DotProdSimPattern"]
    assert exact, "the compiled router's top-6 differs from the exact one"
    return {"cost": rep, "gpu": gpu}


if __name__ == "__main__":
    main()
