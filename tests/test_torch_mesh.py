"""The port's device mesh (muscato_tpu_torch.parallel.mesh) against the JAX
package's on the CPU.

The shard partition: for mp in {1, 2, 3, 4, 8} (8 shards of 5 genes
included), each of the port's shards, built alone on its device, has the
first gene, the gene starts and the valid (skeys, spos) of the unpadded
row of JAX's ShardedIndex.

Worlds of gloo processes, one a mesh position, started by
tests/torch_mesh_worker.py with torch.multiprocessing, for (dp, mp) in
{(1, 2), (2, 1), (2, 2), (1, 4)} with the ragged read counts of
tests/test_dist.py (41, 43, 37): every world runs its five cases (the
default path, MUSCATO_PJOIN=0 with MUSCATO_PEXPAND_SUB=1, NoDedup, a
forced survivor regrow, and an all-N read) in one start.  Rank 0's
MatchResult must equal, as a set of (read_row, gene, start, nmiss), JAX's
run_matching_sharded on the same dp x mp mesh (conftest's 8 CPU devices)
and the port's single-device run; every other rank's must be empty, and
every rank's shard must have been built on its device.  The four worlds
run at once, beside the JAX runs of this process.
"""

import functools
import os
import socket
import subprocess
import sys
import types

import numpy as np
import pytest

from muscato_tpu import config as jconfig
from muscato_tpu.io.reads import ReadSet as JReadSet
from muscato_tpu.io.targets import TargetSet as JTargetSet
from muscato_tpu.parallel import mesh as jmesh
from muscato_tpu_torch import config as tconfig
from muscato_tpu_torch.engine import pipeline as tpipeline
from muscato_tpu_torch.parallel import mesh as tmesh

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_mesh_worker as worker  # noqa: E402

WORLDS = {(1, 2): 41, (2, 1): 43, (2, 2): 37, (1, 4): 43}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_sets(a):
    n = a["codes"].shape[0]
    rs = JReadSet(codes=a["codes"], lengths=a["lengths"], counts=np.ones(n, np.int64),
                  names=[b"r%d" % i for i in range(n)], num_total=n)
    g = len(a["gene_start"]) - 1
    ts = JTargetSet(tcat=a["tcat"], gene_start=a["gene_start"],
                    names=[b"g%d" % i for i in range(g)], lengths=np.diff(a["gene_start"]))
    return rs, ts


def _as_set(mr):
    return set(zip(mr.read_row.tolist(), mr.gene.tolist(), mr.start.tolist(),
                   mr.nmiss.tolist()))


@pytest.mark.parametrize("mp,n_genes", [(1, 12), (2, 12), (3, 12), (4, 12), (8, 5)])
def test_shard_partition_matches_jax(mp, n_genes):
    a = worker.make_arrays(100 + mp, 1, n_genes=n_genes)
    _, jts = _jax_sets(a)
    _, tts = worker.port_sets(a)
    sidx = jmesh.shard_targets(jts, worker.WIDTH, mp)
    bounds = tmesh.shard_bounds(tts, mp)
    assert len(bounds) == mp + 1 and bounds[-1] == n_genes
    for si in range(mp):
        shard = tmesh.shard_targets(tts, worker.WIDTH, mp, si, "cpu")
        lo, hi = shard.genes
        assert (lo, hi) == (bounds[si], bounds[si + 1])
        assert shard.gene_base == int(np.asarray(sidx.gene_base)[si])
        np.testing.assert_array_equal(
            shard.index.gene_start_np, np.asarray(sidx.gene_start)[si, : hi - lo + 1])
        spos_j = np.asarray(sidx.spos)[si]
        nvalid = int((spos_j >= 0).sum())
        assert shard.index.num_valid == nvalid
        assert shard.index.host_arrays is None  # built on its device
        k1 = shard.index.skeys.numpy().view(np.uint32)
        sp = shard.index.spos.numpy()
        np.testing.assert_array_equal(k1[:nvalid], np.asarray(sidx.skeys)[si, :nvalid])
        np.testing.assert_array_equal(sp[:nvalid], spos_j[:nvalid])
    if n_genes < mp:
        assert bounds[n_genes:] == [n_genes] * (mp + 1 - n_genes)  # empty shards


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Start every world at once; ``get(dp, mp)`` waits for one and returns
    {case: [MatchResult npz of each rank]}."""
    procs = {}
    for (dp, mp), n in WORLDS.items():
        out = tmp_path_factory.mktemp(f"world_{dp}x{mp}")
        cmd = [sys.executable, os.path.join(HERE, "torch_mesh_worker.py"), str(dp), str(mp),
               str(n), str(_free_port()), str(out)]
        procs[(dp, mp)] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT), out)
    done = {}

    def get(dp, mp):
        if (dp, mp) not in done:
            p, out = procs[(dp, mp)]
            log, _ = p.communicate(timeout=240)
            assert p.returncode == 0, log.decode(errors="replace")[-4000:]
            done[(dp, mp)] = {
                case: [types.SimpleNamespace(**np.load(out / f"{case}_{r}.npz"))
                       for r in range(dp * mp)]
                for case in worker.CASES}
        return done[(dp, mp)]

    yield get
    for p, _ in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


@functools.lru_cache(maxsize=None)
def _expected(dp, mp, case):
    """(JAX run_matching_sharded on a dp x mp mesh, the port's one-device
    run) as sets, for the case's inputs and config."""
    n = WORLDS[(dp, mp)]
    seed = dp * 31 + mp + n
    fields = dict(worker.NRUN_CFG if case == "nrun" else worker.CFG,
                  NoDedup=case == "nodedup")
    a = worker.make_arrays(seed, n, **({"n_genes": 5, "nrun": True} if case == "nrun" else {}))
    jrs, jts = _jax_sets(a)
    jres = jmesh.run_matching_sharded(
        jconfig.Config(**fields), jrs, jmesh.shard_targets(jts, worker.WIDTH, mp),
        jmesh.make_mesh(dp, mp))
    trs, tts = worker.port_sets(a)
    tres = tpipeline.run_matching(tconfig.Config(**fields), trs, tts, device="cpu")
    return _as_set(jres), _as_set(tres)


@pytest.mark.parametrize("case", worker.CASES)
@pytest.mark.parametrize("world", list(WORLDS), ids=lambda w: f"{w[0]}x{w[1]}")
def test_mesh_rank0_matches_jax_and_single_device(worlds, world, case):
    dp, mp = world
    exp_jax, exp_single = _expected(dp, mp, case)
    got = worlds(dp, mp)[case]
    assert _as_set(got[0]) == exp_jax == exp_single
    assert len(exp_jax) > 0
    for r in range(1, dp * mp):
        assert got[r].read_row.size == 0  # only rank 0 ranks and reports
    if case == "default":
        assert all(bool(got[r].device_built) for r in range(dp * mp))
    if case == "regrow":
        assert all(int(got[r].cap) > 8 for r in range(dp * mp))
    if case == "nrun":
        assert max(g for _, g, _, _ in exp_jax) < 5


def test_mesh_of_one_process_matches_single_device():
    """A 1x1 mesh with no process group: the same stages, no collective."""
    a = worker.make_arrays(5, 40)
    rs, ts = worker.port_sets(a)
    cfg = tconfig.Config(**worker.CFG)
    mesh = tmesh.make_mesh(1, 1, "cpu")
    assert mesh.backend is None and mesh.shape == {"dp": 1, "mp": 1}
    timings = {}
    mr = tmesh.run_matching_sharded(cfg, rs, tmesh.shard_targets(ts, worker.WIDTH, 1, 0, "cpu"),
                                    mesh, timings=timings)
    assert _as_set(mr) == _as_set(tpipeline.run_matching(cfg, rs, ts, device="cpu"))
    assert timings["batches"] == 1 and timings["gather_bytes"] == 0
    assert {"probe", "expand_verify", "rank"} <= set(timings["stages"])


@pytest.mark.parametrize("dp,mp", [(2, 1), (1, 3)])
def test_mesh_larger_than_world_raises(dp, mp):
    with pytest.raises(ValueError, match=f"mesh {dp}x{mp} needs {dp * mp} devices, have 1"):
        tmesh.make_mesh(dp, mp, "cpu")
