"""Design-space exploration on the PyTorch/CUDA port — the port's twin of
``examples/dse_sweep.py``: one application (HDC similarity), a grid of
architectures (cell type x subarray geometry x optimization mode), one
table: latency / energy / power / subarrays / banks per design point,
plus the Pareto frontier on (latency, power).

Compile and cost only: each point is traced, lowered and priced by the
Eva-CAM-analog model; no search runs, so no kernel launches.  The plans
are built for the GPU unless given ``--device cpu``.

    PYTHONPATH=src python examples/port_dse_sweep.py [--device cpu]
"""

import argparse
import itertools

from repro_torch.core import ArchSpec, CamType, OptimizationTarget, compile_fn

#: the traced shapes: queries, classes, hypervector dimensions
M, N, DIM = 10_000, 10, 8192
SIZES = (16, 32, 64, 128)


def hdc_kernel(inp, weight):
    others = weight.transpose(-2, -1)
    mm = inp.matmul(others)
    return mm.topk(1, largest=False)


def design_points(device=None):
    """Every design point of the grid: its name, latency, energy, power,
    physical subarrays and banks."""
    points = []
    for (size, cam, target) in itertools.product(
            SIZES, (CamType.TCAM, CamType.ACAM), OptimizationTarget.ALL):
        arch = ArchSpec(rows=size, cols=size, cam_type=cam
                        ).with_target(target)
        prog = compile_fn(hdc_kernel, [(M, DIM), (N, DIM)], arch,
                          cam_type=cam, value_bits=1, unroll_limit=0,
                          device=device)
        rep = prog.cost_report()
        plan = prog.plans[0]
        points.append({
            "design": f"{cam}-{size}x{size}-{target}",
            "latency_us": rep.latency_us, "energy_uj": rep.energy_uj,
            "power_w": rep.power_w, "subarrays": plan.physical_subarrays,
            "banks": plan.banks_used,
        })
    return points


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' to run without a GPU (default: the GPU)")
    args = ap.parse_args(argv)

    points = design_points(args.device)
    print(f"{'design':34s} {'lat_us':>9s} {'e_uJ':>8s} {'P_W':>8s} "
          f"{'subarr':>7s} {'banks':>6s}")
    for p in points:
        print(f"{p['design']:34s} {p['latency_us']:9.2f} "
              f"{p['energy_uj']:8.3f} {p['power_w']:8.4f} "
              f"{p['subarrays']:7d} {p['banks']:6d}")

    # Pareto frontier on (latency, power)
    front = [p for p in points
             if not any(q["latency_us"] <= p["latency_us"]
                        and q["power_w"] <= p["power_w"] and q is not p
                        for q in points)]
    front.sort(key=lambda p: p["latency_us"])
    print("\nPareto frontier (latency vs power):")
    for p in front:
        print(f"  {p['design']:34s} {p['latency_us']:9.2f} us "
              f"{p['power_w']:8.4f} W")
    assert len(front) >= 2, "DSE must expose a real trade-off"
    return {"points": points, "front": front}


if __name__ == "__main__":
    main()
