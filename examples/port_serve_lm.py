"""Serving a small LM on the PyTorch/CUDA port: batched requests with
prefill + continuous-batched decode — the port's twin of
``examples/serve_lm.py``.

``launch.serve.Server`` over a reduced config's random weights, with
temperature sampling from a seeded generator on the device.  On the GPU
each prefill and decode step is the replay of one captured CUDA graph and
every attention call runs kernel B7; ``--device cpu`` runs the same
steps eagerly on the kernels' plain versions.

    PYTHONPATH=src python examples/port_serve_lm.py --arch zamba2-2.7b \\
        [--device cpu]
"""

import argparse
import json

import numpy as np

from repro_torch.configs import get_smoke_config
from repro_torch.launch.serve import Request, Server
from repro_torch.models import model


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="zamba2-2.7b",
                    help="any assigned arch id (reduced config)")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--batch", type=int, default=3)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run without a GPU (default: the GPU)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch)
    params = model.init_params(cfg, seed=0, device=args.device)
    srv = Server(cfg, params, batch=args.batch,
                 max_len=args.prompt_len + args.max_new + 1,
                 temperature=args.temperature, device=args.device)

    rng = np.random.default_rng(0)
    reqs = [Request(rid=r, prompt=rng.integers(1, cfg.vocab, args.prompt_len),
                    max_new=args.max_new) for r in range(args.requests)]
    for r in reqs:
        srv.submit(r)
    out = srv.run()
    print(json.dumps(out, indent=1))
    assert out["completed"] == args.requests
    return dict(out, outputs=[r.out for r in reqs])


if __name__ == "__main__":
    main()
