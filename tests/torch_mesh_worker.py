"""One world of the port's device mesh on the CPU, for tests/test_torch_mesh.py.

    python torch_mesh_worker.py <dp> <mp> <n_reads> <port> <outdir>

starts dp * mp ranks with torch.multiprocessing (gloo, one CPU process a
mesh position).  Every rank runs the same cases in lockstep and writes its
MatchResult of each to <outdir>/<case>_<rank>.npz:

  default   run_matching_sharded on the test data (with 'device_built':
            the rank's shard was built on its device);
  switched  the same under MUSCATO_PJOIN=0 and MUSCATO_PEXPAND_SUB=1;
  nodedup   the same with NoDedup (the streaming expand);
  regrow    sharded_match_arrays from a survivor capacity of 8, then the
            host cap and rank (the grown capacity rides along as 'cap');
  nrun      the data with an all-N read appended, one window, MinDinuc 0.

This file imports only numpy and the port (no jax, no muscato_tpu), so
that a rank's start-up stays that of a port process; the test imports
``make_arrays`` and ``CFG`` from it to build the same inputs for the JAX
package.
"""

import os
import sys

import numpy as np

WIDTH, MAX_RL = 6, 40
CFG = dict(Windows=[0, 4], WindowWidth=WIDTH, PMatch=0.9, MinDinuc=1,
           MaxReadLength=MAX_RL, MMTol=1, MaxMatches=10**6, MatchMode="best")
NRUN_CFG = dict(CFG, Windows=[0], MinDinuc=0)
CASES = ("default", "switched", "nodedup", "regrow", "nrun")


def make_arrays(seed: int, n_reads: int, n_genes: int = 12, nrun: bool = False) -> dict:
    """Reads drawn from random genes with a few substitutions, and some
    random reads (the generator of tests/test_dist.py), as numpy arrays:
    read codes and lengths, the gene stream and gene starts.  ``nrun``
    appends a read of 20 N bases (codes 4)."""
    from muscato_tpu_torch.io import seqcodec

    rng = np.random.default_rng(seed)
    genes = ["".join(rng.choice(list("ACGT"), size=rng.integers(WIDTH, 80)))
             for _ in range(n_genes)]
    reads = []
    for _ in range(n_reads):
        g = genes[rng.integers(len(genes))]
        if len(g) > WIDTH + 2 and rng.random() < 0.8:
            a = int(rng.integers(0, len(g) - WIDTH))
            b = int(rng.integers(a + WIDTH, min(len(g), a + MAX_RL) + 1))
            frag = list(g[a:b])
            for _ in range(int(rng.integers(0, 3))):
                frag[int(rng.integers(len(frag)))] = "ACGT"[int(rng.integers(4))]
            reads.append("".join(frag))
        else:
            reads.append("".join(rng.choice(list("ACGT"), size=WIDTH + 5)))
    codes, lengths = seqcodec.encode_rows([r.encode() for r in reads], MAX_RL)
    if nrun:
        row = np.zeros((1, codes.shape[1]), codes.dtype)
        row[0, :20] = 4
        codes = np.concatenate([codes, row])
        lengths = np.concatenate([lengths, [20]]).astype(np.int32)
    gene_start = np.zeros(len(genes) + 1, np.int64)
    for i, g in enumerate(genes):
        gene_start[i + 1] = gene_start[i] + len(g)
    tcat = np.concatenate([seqcodec.encode(g.encode()) for g in genes])
    return dict(codes=codes, lengths=lengths, tcat=tcat, gene_start=gene_start)


def port_sets(a: dict):
    """The port's ReadSet and TargetSet of make_arrays' arrays."""
    from muscato_tpu_torch.io.reads import ReadSet
    from muscato_tpu_torch.io.targets import TargetSet

    n = a["codes"].shape[0]
    rs = ReadSet(codes=a["codes"], lengths=a["lengths"], counts=np.ones(n, np.int64),
                 num_total=n)
    g = len(a["gene_start"]) - 1
    ts = TargetSet(tcat=a["tcat"], gene_start=a["gene_start"],
                   names=[b"g%d" % i for i in range(g)], lengths=np.diff(a["gene_start"]))
    return rs, ts


def _rank(rank, dp, mp, n_reads, port, outdir):
    import torch
    import torch.distributed as dist

    from muscato_tpu_torch.config import Config
    from muscato_tpu_torch.engine import pipeline as pl
    from muscato_tpu_torch.parallel import dist as pdist
    from muscato_tpu_torch.parallel import mesh as pmesh

    torch.set_num_threads(1)  # the ranks share the cores
    pdist.initialize(f"localhost:{port}", dp * mp, rank, backend="gloo", device="cpu")
    try:
        mesh = pmesh.make_mesh(dp, mp, "cpu")
        assert (mesh.d, mesh.m) == (rank // mp, rank % mp)
        seed = dp * 31 + mp + n_reads
        rs, ts = port_sets(make_arrays(seed, n_reads))
        shard = pmesh.shard_targets(ts, WIDTH, mp, mesh.m, "cpu")

        def save(case, mr, **extra):
            np.savez(os.path.join(outdir, f"{case}_{rank}.npz"), read_row=mr.read_row,
                     gene=mr.gene, start=mr.start, nmiss=mr.nmiss, **extra)

        cfg = Config(**CFG)
        save("default", pmesh.run_matching_sharded(cfg, rs, shard, mesh),
             device_built=shard.index.host_arrays is None)
        os.environ.update(MUSCATO_PJOIN="0", MUSCATO_PEXPAND_SUB="1")
        save("switched", pmesh.run_matching_sharded(cfg, rs, shard, mesh))
        del os.environ["MUSCATO_PJOIN"], os.environ["MUSCATO_PEXPAND_SUB"]
        save("nodedup", pmesh.run_matching_sharded(Config(**CFG, NoDedup=True), rs, shard, mesh))

        cols, cap = pmesh.sharded_match_arrays(cfg, rs.codes, rs.lengths, shard, mesh,
                                               surv_cap=8)
        r, g, s, nx, grp, grp2, win = cols
        r, g, s, nx = pl._apply_max_matches(cfg, r, g, s, nx, grp, grp2, win)
        save("regrow", pl._dedup_and_rank(cfg, r, g, s, nx), cap=cap)

        rs_n, ts_n = port_sets(make_arrays(seed, n_reads, n_genes=5, nrun=True))
        shard_n = pmesh.shard_targets(ts_n, WIDTH, mp, mesh.m, "cpu")
        save("nrun", pmesh.run_matching_sharded(Config(**NRUN_CFG), rs_n, shard_n, mesh))
    finally:
        dist.destroy_process_group()


def main():
    dp, mp, n_reads, port = (int(x) for x in sys.argv[1:5])
    outdir = sys.argv[5]
    import torch.multiprocessing as tmp

    tmp.start_processes(_rank, args=(dp, mp, n_reads, port, outdir), nprocs=dp * mp,
                        start_method="spawn")


if __name__ == "__main__":
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.dirname(here))  # the repo root: the port's package
    main()
