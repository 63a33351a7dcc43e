"""Scaling harness: reads/s of the sharded match against the mesh shape
(twin of ``muscato_tpu/bench/scaling.py``).

One process a mesh position, as ``parallel/mesh.py`` runs: start N
processes with torchrun, or with ``--Coordinator host:port
--ProcessCount N --ProcessIndex i`` each; a process started alone runs a
world of one on a free local port.  The backend is NCCL on cards (one a
process) and gloo on the CPU; MUSCATO_DIST_BACKEND=gloo lets processes
share one card.  For each (dp, mp) that fills the world (mp = world,
world/2, ..., 1), every rank builds its gene-range shard on its device
and runs ``run_matching_sharded`` once to warm up, then ``--Repeats``
times after a barrier; rank 0 prints one JSON line ``{"mesh", "devices",
"reads_per_sec"}`` with the best of rank 0's walls.  Processes that share
one card give no scaling figure.

    python -m muscato_tpu_torch.bench.scaling [--NumRead N] [--NumGene N]
        [--ReadLen N] [--GeneLen N] [--Repeats N] [--device cuda|cpu]
        [--Coordinator host:port --ProcessCount N --ProcessIndex i]

Asked for ``cuda`` without a CUDA device it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import time


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def mesh_shapes(world: int) -> list:
    """(dp, mp) for mp = world, world/2, ..., 1 whose product is the world."""
    shapes = []
    mp = world
    while mp >= 1:
        shapes.append((world // mp, mp))
        mp //= 2
    return [(d, m) for d, m in shapes if d * m == world] or [(1, 1)]


def measure(cfg, rs, ts, device, repeats: int, log=print) -> list:
    """Every mesh shape over the initialised world; returns rank 0's rows
    (the other ranks return [])."""
    import torch
    import torch.distributed as dist

    from ..parallel import mesh as pmesh

    world = dist.get_world_size()
    results = []
    for dp, mp in mesh_shapes(world):
        mesh = pmesh.make_mesh(dp, mp, device)
        shard = pmesh.shard_targets(ts, cfg.WindowWidth, mp, mesh.m, mesh.device)

        def run():
            dist.barrier(group=mesh.host_group)
            t0 = time.perf_counter()
            pmesh.run_matching_sharded(cfg, rs, shard, mesh)
            if mesh.device.type == "cuda":
                torch.cuda.synchronize(mesh.device)
            return time.perf_counter() - t0

        run()  # warm-up
        best = min(run() for _ in range(repeats))
        del shard
        if mesh.rank == 0:
            results.append({"mesh": f"{dp}x{mp}", "devices": world,
                            "reads_per_sec": round(rs.num_total / best, 1)})
            log(json.dumps(results[-1]), flush=True)
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--NumRead", type=int, default=100_000)
    p.add_argument("--NumGene", type=int, default=1_000)
    p.add_argument("--ReadLen", type=int, default=100)
    p.add_argument("--GeneLen", type=int, default=1_000)
    p.add_argument("--Repeats", type=int, default=3)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; a bare cuda is cuda:LOCAL_RANK) or cpu")
    p.add_argument("--Coordinator", default="", help="host:port of process 0")
    p.add_argument("--ProcessCount", type=int, default=0)
    p.add_argument("--ProcessIndex", type=int, default=0)
    ns = p.parse_args(argv)

    import torch.distributed as dist

    from ..config import Config
    from ..device import rank_device
    from ..parallel import dist as pdist
    from . import gendat

    dev = rank_device(ns.device)
    backend = os.environ.get("MUSCATO_DIST_BACKEND") or None
    if ns.Coordinator:
        pdist.initialize(ns.Coordinator, ns.ProcessCount or None, ns.ProcessIndex,
                         backend=backend, device=dev)
    elif "WORLD_SIZE" in os.environ:  # torchrun
        pdist.initialize(backend=backend, device=dev)
    else:
        pdist.initialize(f"localhost:{free_port()}", 1, 0, backend=backend, device=dev)
    try:
        cfg = Config(
            Windows=[10, 30, 50, 70], WindowWidth=20, PMatch=0.96, MinDinuc=3,
            MaxReadLength=ns.ReadLen * 2, MMTol=2, MaxMatches=10**6,
            MatchMode="best",
        )
        rs, ts = gendat.generate_arrays(
            ns.NumRead, ns.ReadLen, ns.NumGene, ns.GeneLen, seed=0
        )
        measure(cfg, rs, ts, dev, ns.Repeats)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
