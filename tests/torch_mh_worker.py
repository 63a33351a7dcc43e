"""One process of a two-process run of the port on the CPU, for
tests/test_torch_multihost.py.

    python torch_mh_worker.py <process_id> <num_processes> <port> <outdir> <tag>...

First it joins a gloo world through
``dist.initialize("localhost:<port>", num_processes, process_id)`` and
builds the ReadSet of <outdir>/mh_reads.fastq with
``build_readset_multihost``, which must equal ``build_readset`` of the
whole file while its own parse covers only part of the file, and
``pod_mesh()`` gives the 1 x num_processes mesh.  Then, for each <tag>,
it runs the ``muscato_torch`` entry point on
<outdir>/config_<tag>_<process_id>.json, whose Coordinator (a port of its
own), ProcessCount and ProcessIndex start the driver's own process group.

This file imports only numpy and the port (no jax, no muscato_tpu).
"""

import os
import sys


def main():
    pid, nproc, port = (int(x) for x in sys.argv[1:4])
    outdir, tags = sys.argv[4], sys.argv[5:]
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.dirname(here))  # the repo root: the port's package

    import numpy as np
    import torch
    import torch.distributed as dist

    from muscato_tpu_torch import cli
    from muscato_tpu_torch.io import reads as reads_io
    from muscato_tpu_torch.parallel import dist as pdist

    torch.set_num_threads(2)
    pdist.initialize(f"localhost:{port}", nproc, pid, device="cpu")
    assert dist.get_backend() == "gloo" and pdist.is_primary() == (pid == 0)
    fq = os.path.join(outdir, "mh_reads.fastq")
    rs_mh = pdist.build_readset_multihost(fq, 0, 40)
    rs_full = reads_io.build_readset(fq, 0, 40)
    np.testing.assert_array_equal(rs_mh.codes, rs_full.codes)
    np.testing.assert_array_equal(rs_mh.lengths, rs_full.lengths)
    np.testing.assert_array_equal(rs_mh.counts, rs_full.counts)
    np.testing.assert_array_equal(rs_mh.name_blob, rs_full.name_blob)
    assert rs_mh.num_total == rs_full.num_total
    # This process's own parse really was a slice of the file.
    buf = reads_io._map_bytes(fq)
    bounds = [i * len(buf) // nproc for i in range(nproc + 1)]
    first = sum(reads_io.count_lines_range(buf, bounds[p], bounds[p + 1]) for p in range(pid))
    local = reads_io.build_readset_range(buf, 0, 40, bounds[pid], bounds[pid + 1], first)
    assert 0 < local.num_total < rs_full.num_total
    mesh = pdist.pod_mesh(device="cpu")  # every process on the index's mp axis
    assert (mesh.dp, mesh.mp, mesh.rank) == (1, nproc, pid)
    dist.destroy_process_group()

    for tag in tags:
        cfg = os.path.join(outdir, f"config_{tag}_{pid}.json")
        assert cli.main_muscato([f"-ConfigFileName={cfg}", "-device=cpu"]) == 0
        assert not dist.is_initialized()  # the driver closed its process group
    print(f"worker {pid} OK", flush=True)


if __name__ == "__main__":
    main()
