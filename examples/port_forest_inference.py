"""In-memory decision-forest inference on an analog CAM, on the
PyTorch/CUDA port — the port's twin of ``examples/forest_inference.py``.

Every root-to-leaf branch of a tree ensemble becomes one aCAM row of
``[lo, hi]`` feature intervals (features the path never tests stay
full-range wildcards); classifying a sample is one interval range search
plus a majority class vote.  A 64-tree ensemble is compiled through the
C4CAM pipeline (partition -> cim-to-cam @ ACAM -> cam-map) and run
through the engine's ``RangePlan``:

* single-device, on the GPU's interval kernel (B3) unless given
  ``--device cpu``, predictions checked against the IR interpreter and
  plain tree traversal;
* sharded over 8 stand-ins of that one device
  (``repro_torch.launch.mesh.forced_devices(8, device)``, the port's
  twin of the reference's 8 forced host devices).  Sharded plans run the
  eager ``"torch"`` backend only, so this leg builds its plan there;
* served concurrently through ``CamSearchServer`` (range requests);
* with the camsim aCAM latency/energy report for the mapping.

    PYTHONPATH=src python examples/port_forest_inference.py [--device cpu]
"""

import argparse
import json
import threading

import numpy as np

from repro_torch.core.arch import ArchSpec, CamType
from repro_torch.core.engine.base import resolve_device
from repro_torch.forest import CamForestClassifier, random_forest, vote
from repro_torch.launch.mesh import forced_devices
from repro_torch.serving import CamSearchServer

DEVICES = 8
N_TREES = 64
DEPTH = 5
DIM = 32
N_CLASSES = 8
N_QUERIES = 512


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' to run without a GPU (default: the GPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(0)
    trees = random_forest(rng, n_trees=N_TREES, dim=DIM, depth=DEPTH,
                          n_classes=N_CLASSES, feature_frac=0.5)
    arch = ArchSpec(rows=64, cols=64, cam_type=CamType.ACAM)
    clf = CamForestClassifier(trees, dim=DIM).compile(arch, batch_hint=128,
                                                      device=dev)
    print("forest:", json.dumps(clf.summary(), default=str))

    x = rng.standard_normal((N_QUERIES, DIM)).astype(np.float32)
    pred = clf.predict(x).cpu().numpy()
    assert np.array_equal(pred, clf.predict_interpreted(x).cpu().numpy()), \
        "engine diverged from the IR interpreter"
    assert np.array_equal(pred, clf.predict_reference(x)), \
        "engine diverged from tree traversal"
    print(f"single-device RangePlan: {N_QUERIES} samples, predictions "
          f"bit-identical to interpreter + traversal oracle "
          f"({100 * clf.intervals.wildcard_frac:.1f}% wildcard cells)")

    # ---- sharded: interval rows split over 8 stand-ins of the device ---
    with forced_devices(DEVICES, dev):
        sclf = CamForestClassifier(trees, dim=DIM).compile(
            arch, batch_hint=128, shards=DEVICES, backend="torch",
            device=dev)
    assert sclf.plan.shards == DEVICES, sclf.plan.shards
    assert np.array_equal(sclf.predict(x).cpu().numpy(), pred), \
        "sharded predictions diverged"
    print(f"sharded RangePlan ({DEVICES} devices): bit-identical")

    # ---- served: concurrent clients against one shared RangePlan -------
    n_clients = 4
    slices = np.array_split(np.arange(N_QUERIES), n_clients)
    preds = {}
    with CamSearchServer(clf.plan, (clf.intervals.lo, clf.intervals.hi),
                         max_wait_ms=2.0) as srv:
        def client(cid):
            matches = srv.match(x[slices[cid]])
            preds[cid] = vote(matches, clf.intervals.leaf_class,
                              clf.intervals.n_classes)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        snap = srv.snapshot()
    served = np.concatenate([preds[c] for c in range(n_clients)])
    assert np.array_equal(served, pred), "served predictions diverged"
    print(f"served ({n_clients} clients): bit-identical; "
          f"p50={snap.get('p50_ms', 0):.2f}ms "
          f"batches={snap['batches']} fill={snap['avg_batch_fill']:.1f}")

    rep = clf.cost_report()
    print(f"camsim aCAM mapping: latency {rep.latency_us:.2f}us, "
          f"energy {rep.energy_uj:.3f}uJ, "
          f"{clf.mapping_plans[0].physical_subarrays} subarrays, "
          f"search_type={clf.mapping_plans[0].search_type}")
    print("FOREST-OK")
    return {"summary": clf.summary(), "pred": pred, "served": snap}


if __name__ == "__main__":
    main()
