"""Time a mesh's first placement, op and gather with all seven axes kept
against the axes of size > 1 only, on gloo ranks of this host's CPU.

    python -m ray_tpu_torch.mesh_times      # 4 ranks, fsdp 2 x tp 2

Each rank builds a ``DeviceMesh`` over the same ranks twice: over all seven
axes of ``parallel.mesh.AXIS_ORDER`` (five of them of size 1) and over the
two of size > 1, as ``make_mesh`` builds it; then it places a tensor on the
mesh (the first collectives on its sub-groups), doubles it (DTensor's
sharding propagation, which enumerates placements over every mesh dim) and
gathers it back. Rank 0 prints one JSON line of seconds.
``chip_smoke.py``'s mesh phase times placement and gather on NCCL at world
size 1.
"""

from __future__ import annotations

import datetime
import json
import os
import tempfile
import time

WORLD = 4


def _first_use(mesh) -> dict:
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    placements = [Shard(0) if n == "fsdp" else Shard(1) if n == "tp" else Replicate()
                  for n in mesh.mesh_dim_names]
    t0 = time.perf_counter()
    x = distribute_tensor(torch.arange(16.0).reshape(4, 4), mesh, placements)
    t1 = time.perf_counter()
    y = x * 2
    t2 = time.perf_counter()
    y.full_tensor()
    return {"place_s": t1 - t0, "op_s": t2 - t1, "gather_s": time.perf_counter() - t2}


def _rank(rank: int, store_path: str) -> None:
    import numpy as np
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from ray_tpu_torch.parallel.mesh import AXIS_ORDER, MeshConfig, mesh_ranks

    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD), rank=rank,
                            world_size=WORLD, timeout=datetime.timedelta(seconds=120))
    arr = mesh_ranks(MeshConfig(fsdp=2, tp=2), range(WORLD))
    out = {}
    for name, names, shape in (("seven_dims", AXIS_ORDER, arr.shape),
                               ("pruned", ("fsdp", "tp"), (2, 2))):
        t0 = time.perf_counter()
        mesh = DeviceMesh("cpu", np.asarray(arr).reshape(shape).tolist(), mesh_dim_names=names)
        out[name] = dict(build_s=time.perf_counter() - t0, **_first_use(mesh))
    if rank == 0:
        print(json.dumps(out), flush=True)
    dist.destroy_process_group()


def main() -> int:
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank, args=(r, os.path.join(tmp, "store")))
                 for r in range(WORLD)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(600)
        for p in procs:
            if p.is_alive():
                p.kill()
    return max(p.exitcode or 0 for p in procs)


if __name__ == "__main__":
    raise SystemExit(main())
