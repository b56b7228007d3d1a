"""End-to-end HDC on CAM on the PyTorch/CUDA port: encode -> train ->
retrain online -> serve — the port's twin of ``examples/hdc_mnist.py``.

* **encode** — MNIST-shaped samples quantised and encoded into bipolar
  hypervectors (``repro_torch.hdc``; on the GPU the bit-sliced encode
  kernel, B5);
* **train** — one-shot: encodings bundled into per-class associative-
  memory accumulators;
* **classify** — the AM served through the compiled similarity stack
  (``cim.similarity`` dot/k=1 -> packed XOR+popcount ``SearchPlan``, B1
  on the GPU; bipolar argmax-dot == argmin-hamming);
* **retrain online** — perceptron epochs *against the live server*:
  misclassified encodings are re-bundled, and only the touched class
  rows are pushed through ``CamSearchServer.update_gallery`` (the
  engine's incremental ``update_rows`` path) while concurrent client
  traffic keeps hitting the same plan;
* **parity** — single-device, sharded and served predictions are
  asserted bit-identical, and the engine is checked against the IR
  interpreter and a dense oracle.  The sharded leg runs over 8 stand-ins
  of the one device (``repro_torch.launch.mesh.forced_devices(8,
  device)``, the port's twin of the reference's 8 forced host devices);
  sharded plans run the eager ``"torch"`` backend only, so it builds its
  plan there.

It runs on the GPU unless given ``--device cpu``.

    PYTHONPATH=src python examples/port_hdc_mnist.py [--device cpu]
"""

import argparse
import json
import threading

import numpy as np
import torch

from repro_torch.core.arch import ArchSpec
from repro_torch.core.engine import get_plan
from repro_torch.core.engine.base import resolve_device
from repro_torch.data import hdc_mnist_dataset
from repro_torch.hdc import HdcClassifier
from repro_torch.launch.mesh import forced_devices
from repro_torch.serving import CamSearchServer

DEVICES = 8
N_CLASSES = 10
HV_DIM = 2048
N_LEVELS = 16
EPOCHS = 6
TRAFFIC_CLIENTS = 3


def _host(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' to run without a GPU (default: the GPU)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    train_x, train_y, test_x, test_y = hdc_mnist_dataset()
    clf = HdcClassifier(train_x.shape[1], N_CLASSES, dim=HV_DIM,
                        n_levels=N_LEVELS, seed=0, device=dev)
    clf.fit(train_x, train_y)
    clf.compile(ArchSpec(rows=8, cols=128), batch_hint=128)
    print("hdc:", json.dumps(clf.summary(), default=str))
    assert clf.plan.packed, "bipolar AM should ride the packed fast path"

    enc_tr = clf.encode(train_x)
    enc_te = clf.encode(test_x)
    pred0 = _host(clf.predict(encoded=enc_te))
    assert np.array_equal(pred0,
                          _host(clf.predict_interpreted(encoded=enc_te))), \
        "engine diverged from the IR interpreter"
    assert np.array_equal(pred0,
                          _host(clf.predict_reference(encoded=enc_te))), \
        "engine diverged from the dense oracle"
    acc0 = float((pred0 == test_y).mean())
    print(f"one-shot HDC: test acc {acc0:.3f} "
          f"(engine == interpreter == oracle)")

    # ---- retrain ONLINE through the served gallery -------------------
    stop = threading.Event()
    traffic_errors = []

    def traffic(srv):
        """Background clients keep searching while retraining mutates
        the gallery between micro-batches."""
        rng = np.random.default_rng(17)
        while not stop.is_set():
            pick = torch.as_tensor(rng.integers(0, len(enc_te), size=4),
                                   device=enc_te.device)
            try:
                srv.search(enc_te[pick], timeout=60)
            except Exception as e:             # noqa: BLE001
                traffic_errors.append(e)
                return

    pushed_total = 0
    with CamSearchServer(clf.plan, clf.gallery, max_wait_ms=1.0) as srv:
        threads = [threading.Thread(target=traffic, args=(srv,))
                   for _ in range(TRAFFIC_CLIENTS)]
        for t in threads:
            t.start()
        for ep in range(EPOCHS):
            train_acc, pushed = clf.retrain_epoch(train_x, train_y,
                                                  encoded=enc_tr, server=srv)
            pushed_total += pushed
            print(f"  epoch {ep}: train acc {train_acc:.3f}, "
                  f"{pushed} AM rows pushed live")
        stop.set()
        for t in threads:
            t.join()
        _, idx = srv.search(enc_te)
        served = np.asarray(idx)[:, 0].astype(np.int32)
        snap = srv.snapshot()
    assert not traffic_errors, traffic_errors[:1]
    assert pushed_total > 0, "retraining never updated the gallery"
    # one live update per epoch that still had misclassifications
    # (convergence legitimately stops pushing)
    assert snap["gallery_updates"] >= 1
    assert snap["rows_updated"] == pushed_total
    assert snap["plan"]["row_update_fallbacks"] == 0, \
        "gallery updates fell back to full re-prepare"
    acc_n = float((served == test_y).mean())
    print(f"retrained online: test acc {acc0:.3f} -> {acc_n:.3f} "
          f"({snap['gallery_updates']} live updates, "
          f"{snap['rows_updated']} rows, "
          f"{snap['queries']} served queries, "
          f"p50={snap.get('p50_ms', 0):.2f}ms)")
    assert acc_n >= acc0, "retraining should not lose accuracy here"

    # ---- single-device vs sharded vs served: bit-identical -----------
    single = _host(clf.predict(encoded=enc_te))
    assert np.array_equal(single, served), "served predictions diverged"
    am = clf.am()
    with forced_devices(DEVICES, dev):
        splan = get_plan(clf.stages["cim_partitioned"], shards=DEVICES,
                         backend="torch", device=dev)
    assert splan.shards == DEVICES, splan.shards
    _, sidx = splan.execute(enc_te, am)
    sharded = _host(sidx)[:, 0].astype(np.int32)
    assert np.array_equal(single, sharded), "sharded predictions diverged"
    assert np.array_equal(single,
                          _host(clf.predict_reference(encoded=enc_te)))
    print(f"single-device, sharded ({DEVICES} devices), and served "
          f"predictions bit-identical")
    print("HDC-OK")
    return {"acc0": acc0, "acc": acc_n, "pred0": pred0, "pred": served,
            "rows_pushed": pushed_total, "served": snap}


if __name__ == "__main__":
    main()
