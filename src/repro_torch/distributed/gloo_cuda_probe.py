"""Which collectives the ``gloo`` backend carries on CUDA tensors.

Spawns 4 ranks on ``cuda:0`` (NCCL refuses two ranks on one GPU) with a
``gloo`` group over a ``FileStore`` in a temporary directory, and tries,
on CUDA tensors, each collective the sharded LM path issues through
DTensor and the model: ``_functional_collectives`` all-reduce,
all-gather, reduce-scatter and all-to-all, and a DTensor redistribution
of each kind on a ``(data 2, model 2)`` mesh.  Each collective runs in
ranks of its own, so one that kills a rank (a segmentation fault)
names itself.  Prints one JSON object: each collective's result
(``"ok"`` with the values checked, the error, or how the ranks died).
Needs one card.  Run it again before the sharded smoke's stand-ins
(four gloo ranks on one card) are tried on a newer torch:

    PYTHONPATH=src python3 -m repro_torch.distributed.gloo_cuda_probe
"""

import datetime
import json
import os
import sys
import tempfile


def _try(fn):
    try:
        return fn()
    except Exception as e:               # noqa: BLE001  the probe's answer
        return f"error: {type(e).__name__}: {str(e)[:300]}"


def rank_main(rank: int, world: int, tmp: str, which: str) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed import _functional_collectives as funcol
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    group = dist.group.WORLD
    x = torch.full((8, 4), float(rank + 1), device="cuda")
    total = float(sum(range(1, world + 1)))

    def all_reduce():
        y = funcol.all_reduce(x, "sum", group).wait()
        assert torch.all(y == total), y
        return "ok"

    def all_gather():
        y = funcol.all_gather_tensor(x, 0, group).wait()
        assert y.shape == (8 * world, 4) and float(y[-1, 0]) == world, y
        return "ok"

    def reduce_scatter():
        y = funcol.reduce_scatter_tensor(x, "sum", 0, group).wait()
        assert y.shape == (8 // world, 4) and torch.all(y == total), y
        return "ok"

    def all_to_all():
        y = funcol.all_to_all_single(x, None, None, group).wait()
        assert y.shape == x.shape, y
        return "ok"

    def dtensor_redistributions():
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import (Partial, Replicate, Shard,
                                              distribute_tensor)
        mesh = init_device_mesh("cuda", (2, 2),
                                mesh_dim_names=("data", "model"))
        t = torch.arange(64.0, device="cuda").reshape(8, 8)
        d = distribute_tensor(t, mesh, [Shard(0), Shard(1)])
        full = d.redistribute(mesh, [Replicate(), Replicate()]).to_local()
        assert torch.equal(full, t)
        p = d.redistribute(mesh, [Shard(0), Replicate()])
        q = (p * 1.0).redistribute(mesh, [Shard(0), Shard(1)])
        assert torch.equal(q.full_tensor(), t)
        from torch.distributed.tensor import DTensor
        part = DTensor.from_local(torch.ones(4, 8, device="cuda"), mesh,
                                  [Shard(0), Partial()])
        rs = part.redistribute(mesh, [Shard(0), Shard(1)])
        assert torch.all(rs.to_local() == 2.0)
        return "ok"

    fns = {"all_reduce": all_reduce, "all_gather": all_gather,
           "reduce_scatter": reduce_scatter, "all_to_all": all_to_all,
           "dtensor_redistributions": dtensor_redistributions}
    out = _try(fns[which])
    if rank == 0:
        with open(os.path.join(tmp, f"{which}.json"), "w") as f:
            json.dump(out, f)
    _try(dist.barrier)
    dist.destroy_process_group()


def main() -> int:
    import torch
    import torch.multiprocessing as mp
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    out = {}
    for which in ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
                  "dtensor_redistributions"):
        with tempfile.TemporaryDirectory() as tmp:
            ctx = mp.start_processes(rank_main, args=(4, tmp, which),
                                     nprocs=4, join=False,
                                     start_method="spawn")
            died = None
            try:
                while not ctx.join(timeout=120):
                    pass
            except Exception as e:           # noqa: BLE001  the answer
                died = f"ranks died: {e}"
            finally:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
            path = os.path.join(tmp, f"{which}.json")
            out[which] = json.load(open(path)) if os.path.exists(path) \
                else died or "rank 0 wrote no result"
    print(json.dumps({"gloo_on_cuda": out, "torch": torch.__version__}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
