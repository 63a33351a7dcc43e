"""The multi-process runtime (port of ``muscato_tpu/parallel/dist.py`` to
``torch.distributed``).

  - ``initialize()`` starts the process group: on the coordinator's
    address with an explicit process count and index (the driver's
    ``--Coordinator``/``--ProcessCount``/``--ProcessIndex``), or from
    torchrun's environment variables when no address is given;
  - ``pod_mesh(dp, mp)`` builds the dp x mp mesh over the world
    (``parallel/mesh.py``);
  - every process parses the same inputs, or each parses its byte range
    of the read file and the unique sets merge on every process
    (``build_readset_multihost``);
  - rank 0 alone writes the report files.

One process drives one device.  The backend is NCCL when the processes
run on cards, one card each, and gloo on the CPU; processes that share
one card take gloo only when the caller asks for it (``backend``), and
NCCL refuses them otherwise.
"""

from __future__ import annotations

import logging

import numpy as np
import torch
import torch.distributed as dist

from .mesh import TIMEOUT, make_mesh


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None, *, device="cuda") -> None:
    """Start the process group of a multi-process run.

    With ``coordinator_address`` ("host:port"; process 0 listens there)
    the world has ``num_processes`` processes and this one is
    ``process_id``; without it, torchrun's variables (MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK) give all three.  ``backend`` defaults
    to "nccl" when ``device`` is a card and "gloo" on the CPU; ranks that
    share one card must pass "gloo".  Every collective fails after
    ``mesh.TIMEOUT``."""
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    init = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    dist.init_process_group(backend, init_method=init, timeout=TIMEOUT, **kwargs)


def pod_mesh(dp: int | None = None, mp: int | None = None, device="cuda"):
    """A dp x mp mesh over the whole world.

    Defaults: shard the index over every process (mp = world size, dp =
    1); with one factor given, the other is the world size over it."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if dp is None and mp is None:
        dp, mp = 1, n
    elif dp is None:
        dp = n // mp
    elif mp is None:
        mp = n // dp
    return make_mesh(dp, mp, device)


def is_primary() -> bool:
    """True on the process that writes the reports (rank 0, or the one
    process of a run without a process group)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def build_readset_multihost(read_file: str, min_read_length: int,
                            max_read_length: int):
    """Range-sharded read prep: each process parses only the records whose
    name line starts inside its byte range of the read file and dedups
    them, and the per-process unique sets merge into the same global
    ReadSet on every process.  Two exchanges over a gloo group of CPU
    tensors: the line counts (record ownership), then the unique sets,
    padded to the world's largest.  One process builds the plain way."""
    from ..io import reads as reads_io

    nproc = dist.get_world_size() if dist.is_initialized() else 1
    if nproc == 1:
        return reads_io.build_readset(read_file, min_read_length, max_read_length)
    group = None if dist.get_backend() == "gloo" else dist.new_group(backend="gloo")
    try:
        pid = dist.get_rank()

        def gather(a: np.ndarray) -> list:
            t = torch.from_numpy(np.ascontiguousarray(a))
            parts = [torch.empty_like(t) for _ in range(nproc)]
            dist.all_gather(parts, t, group=group)
            return [p.numpy() for p in parts]

        buf = reads_io._map_bytes(read_file)
        size = len(buf)
        bounds = [i * size // nproc for i in range(nproc + 1)]
        lo, hi = bounds[pid], bounds[pid + 1]
        nlines = reads_io.count_lines_range(buf, lo, hi)
        counts = np.concatenate(gather(np.asarray([nlines], np.int64)))
        first_line = int(counts[:pid].sum())
        local = reads_io.build_readset_range(
            buf, min_read_length, max_read_length, lo, hi, first_line
        )
        logging.getLogger("muscato.prep").info(
            "range-sharded read prep: rank %d of %d parsed bytes [%d,%d) of %d: "
            "%d reads, %d unique", pid, nproc, lo, hi, size, local.num_total,
            local.num_unique,
        )

        dims = np.asarray(
            [local.num_unique, local.codes.shape[1], len(local.mem_blob),
             len(local.mem_off) - 1, local.num_total], np.int64
        )
        gdims = np.stack(gather(dims))  # (nproc, 5)
        rmax, wmax, bmax, mmax = (int(gdims[:, i].max()) for i in range(4))

        def pad_to(a, shape, dtype):
            out = np.zeros(shape, dtype)
            out[tuple(slice(0, s) for s in a.shape)] = a
            return out

        g_codes = gather(pad_to(local.codes, (rmax, wmax), np.uint8))
        g_len = gather(pad_to(local.lengths, (rmax,), np.int32))
        g_cnt = gather(pad_to(local.counts, (rmax,), np.int64))
        g_blob = gather(pad_to(local.mem_blob, (bmax,), np.uint8))
        g_moff = gather(pad_to(local.mem_off, (mmax + 1,), np.int64))
        g_rmem = gather(pad_to(local.row_mem, (rmax + 1,), np.int64))
    finally:
        if group is not None:
            dist.destroy_process_group(group)

    parts = []
    for p in range(nproc):
        r, wp, b, m, nt = (int(x) for x in gdims[p])
        parts.append(reads_io.LocalReads(
            codes=g_codes[p][:r, :wp], lengths=g_len[p][:r],
            counts=g_cnt[p][:r], num_total=nt, mem_blob=g_blob[p][:b],
            mem_off=g_moff[p][: m + 1], row_mem=g_rmem[p][: r + 1],
        ))
    return reads_io.merge_local_readsets(parts, max_read_length)
