"""Multi-tenant replicated serving on the port: admission control +
failover, live.

Registers two tenants on one :class:`~repro_torch.serving.CamServingGateway`
— a production tenant on two gallery replicas, and a rate-limited
batch tenant sharing the same replica set — then demonstrates the
gateway's three contracts:

1. served results are bit-identical to running the plan directly;
2. a replica killed mid-traffic is transparently failed over, then
   drained, rebuilt onto a fresh device group, and readmitted by the
   maintenance loop;
3. the batch tenant's flood is shed by ITS OWN admission budget while
   the production tenant keeps serving.

    PYTHONPATH=src python examples/port_multitenant_serve.py [--device cpu]

On the card (the default device) the plan runs the hand-written kernels;
``--device cpu`` runs their plain versions.
"""

import argparse
import time

import numpy as np

from repro_torch.core import ArchSpec, compile_fn
from repro_torch.obs import print_stats
from repro_torch.serving import AdmissionError, CamServingGateway


def knn_kernel(queries, gallery):
    d = queries.unsqueeze(1).sub(gallery).norm(p=2, dim=-1)
    return d.topk(5, largest=False)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the GPU)")
    args = ap.parse_args()
    rng = np.random.default_rng(3)
    n, dim = 1024, 64
    gallery = rng.standard_normal((n, dim)).astype(np.float32)
    prog = compile_fn(knn_kernel, [np.zeros((32, dim), np.float32), gallery],
                      ArchSpec(rows=64, cols=64), device=args.device)
    plan = prog.engine_plan

    gw = CamServingGateway(maint_ms=10.0)
    gw.register_tenant("prod", prog, gallery, replicas=2, unhealthy_k=2)
    gw.register_tenant("batch", share_with="prod",
                       rate=64.0, burst=64, queue_limit=4,
                       max_outstanding=2)

    q = rng.standard_normal((8, dim)).astype(np.float32)
    values, idx = gw.search("prod", q)
    ev, ei = (x.cpu().numpy() for x in plan.execute(q, gallery))
    assert np.array_equal(idx, ei) and np.array_equal(values, ev)
    print("prod search: bit-identical to the plan oracle")

    # rewrite a few stored rows; the tenant reads its own writes
    new_rows = rng.standard_normal((4, dim)).astype(np.float32)
    gw.update_gallery("prod", [0, 1, 2, 3], new_rows)
    gallery[[0, 1, 2, 3]] = new_rows
    _, idx = gw.search("batch", q)        # shared set sees the update
    ei = plan.execute(q, gallery)[1].cpu().numpy()
    assert np.array_equal(idx, ei)
    print("update_gallery: read-your-writes across the shared replica set")

    # chaos: lose a device group mid-traffic
    gw.kill_replica("prod", 0)
    for _ in range(20):
        _, idx = gw.search("prod", q)
        assert np.array_equal(idx, ei)
    for _ in range(500):
        reps = gw.health()["tenants"]["prod"]["replicas"]["replicas"]
        if all(r["state"] == "serving" for r in reps) and \
                any(r["rebuilds"] > 0 for r in reps):
            break
        time.sleep(0.01)
    print("replica kill: failed over, rebuilt as",
          [f"{r['device_group']} ({r['state']})" for r in reps])

    # the batch tenant exhausts its own budget, not prod's
    shed = served = 0
    for _ in range(50):
        try:
            gw.submit("batch", q)
            served += 1
        except AdmissionError:
            shed += 1
    _, idx = gw.search("prod", q)
    assert np.array_equal(idx, ei)
    print(f"admission: batch served={served} rejected={shed}; "
          f"prod unaffected")

    health = gw.health()
    print_stats({t: {"stats": e["stats"],
                     "latency": e["latency"],
                     "replicas": [r["state"]
                                  for r in e["replicas"]["replicas"]]}
                 for t, e in health["tenants"].items()},
                title="gateway health")
    gw.stop()
    print("MULTITENANT-OK")


if __name__ == "__main__":
    main()
