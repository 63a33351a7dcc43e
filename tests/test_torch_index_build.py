"""The port's device index build (muscato_tpu_torch/engine/index.py
``_index_arrays``, ``build_target_index(..., device_build=True)``), run
here on the CPU, against the port's host build and the JAX package's
device build, array for array; its index file and search aux; and the
window functions behind it (muscato_tpu_torch/ops/windows.py) against
the JAX package's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from muscato_tpu.engine import index as jindex
from muscato_tpu.ops import windows as jwindows
from muscato_tpu_torch import config as tconfig
from muscato_tpu_torch.bench import gendat as tgendat
from muscato_tpu_torch.engine import index as tindex
from muscato_tpu_torch.engine import pipeline as tpipeline
from muscato_tpu_torch.io.targets import TargetSet
from muscato_tpu_torch.ops import packed as tpacked
from muscato_tpu_torch.ops import windows as twindows


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test: the suite runs several workers on the
    host's cores, where small tensor ops on many threads wait on each
    other (micro_verify's CPU run slowed over a hundredfold on 8 threads
    beside 8 busy processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _targets(gene_lengths, seed=0):
    rng = np.random.default_rng(seed)
    gs = np.concatenate([[0], np.cumsum(gene_lengths)]).astype(np.int64)
    tcat = rng.integers(0, 5, int(gs[-1])).astype(np.uint8)
    return TargetSet(tcat=tcat, gene_start=gs, names=[b"g%d" % i for i in range(len(gene_lengths))],
                     lengths=np.asarray(gene_lengths))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _assert_builds_agree(ts, width):
    """The port's device build equals its host build and JAX's device
    build; the port's _index_arrays equals JAX's, invalid tail included.
    Returns the device-built index."""
    host = tindex.build_target_index(ts, width, "cpu")
    dev = tindex.build_target_index(ts, width, "cpu", device_build=True)
    jdev = jindex.build_target_index(ts, width, device_build=True)
    assert dev.host_arrays is None and host.skeys2 is None
    assert dev.num_valid == host.num_valid == jdev.num_valid
    assert set(dev.build_timings) == {"device_keys_sort_s", "pack_s", "upload_s"}
    got = (_u32(dev.skeys), _u32(dev.skeys2), dev.spos.numpy())
    for name, a, b, c in zip(("skeys", "skeys2", "spos"), got, host.host_arrays,
                             (jdev.skeys, jdev.skeys2, jdev.spos)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=name)
        np.testing.assert_array_equal(a, np.asarray(c), err_msg=name)
    for f in ("skeys", "spos", "tpacked", "gene_start"):
        assert torch.equal(getattr(dev, f), getattr(host, f)), f

    s = int(ts.gene_start[-1])
    gs32 = np.asarray(ts.gene_start).astype(np.int32)
    exp = jindex._index_arrays(jnp.asarray(ts.tcat), jnp.asarray(gs32), jnp.int32(s), width)
    arr = tindex._index_arrays(torch.from_numpy(ts.tcat), torch.from_numpy(gs32), s, width)
    assert arr[3] == int(exp[3])
    for a, b in zip(arr[:3], exp[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b).view(np.int32))
    return dev


@pytest.mark.parametrize("width", [4, 8, 13, 20, 40])
def test_device_build_matches_host_and_jax(width):
    """Both key paths: exact base-5 keys (4, 8, 13), hashed with a second
    key word (20, 40); realistic genes, with duplicate windows."""
    _, ts = tgendat.generate_arrays_realistic(200, 100, 60, 400, seed=width)
    dev = _assert_builds_agree(ts, width)
    assert dev.num_valid > 0
    k1, k2 = _u32(dev.skeys).astype(np.int64), _u32(dev.skeys2).astype(np.int64)
    assert (np.diff(k1 << 32 | k2) >= 0).all()
    assert (k2 != 0).any() == twindows.uses_second_key(width)


def test_device_build_genes_shorter_than_width():
    """Genes shorter than the window give no window; the others do, and no
    window crosses a gene boundary."""
    ts = _targets([5, 30, 3, 12, 40, 1, 19], seed=3)
    dev = _assert_builds_agree(ts, 12)
    assert 0 < dev.num_valid


def test_device_build_no_valid_window():
    """No gene is as long as the window: one (0xFFFFFFFF, 0xFFFFFFFF, -1)
    entry, as the host build gives."""
    ts = _targets([5, 9, 3], seed=4)
    dev = _assert_builds_agree(ts, 10)
    assert dev.num_valid == 0
    assert _u32(dev.skeys).tolist() == _u32(dev.skeys2).tolist() == [0xFFFFFFFF]
    assert dev.spos.tolist() == [-1]


@pytest.mark.parametrize("width,chunk,span", [(8, 97, 64), (20, 1000, 300), (13, 4096, 1),
                                              (20, 50, 1)])
def test_device_build_in_chunks_and_groups(width, chunk, span, monkeypatch, tmp_path):
    """Keys computed BUILD_CHUNK positions at a time and sorted in groups
    of at most SORT_SPAN windows (span 1: every top-byte bucket, larger
    than the span, sorted alone) give the host build's arrays; a mesh
    shard's build (keep_k2=False) gives the same skeys and spos and keeps
    no second key word, so it has no index file."""
    monkeypatch.setattr(tindex, "BUILD_CHUNK", chunk)
    monkeypatch.setattr(tindex, "SORT_SPAN", span)
    _, ts = tgendat.generate_arrays_realistic(200, 100, 30, 300, seed=width)
    dev = _assert_builds_agree(ts, width)
    assert dev.num_valid > 2 * max(chunk, span)
    shard = tindex.build_target_index(ts, width, "cpu", device_build=True, keep_k2=False)
    assert shard.skeys2 is None and shard.num_valid == dev.num_valid
    assert torch.equal(shard.skeys, dev.skeys) and torch.equal(shard.spos, dev.spos)
    with pytest.raises(ValueError, match="keep_k2"):
        shard.save(str(tmp_path / "shard.npz"))


@pytest.fixture(scope="module")
def workload():
    return tgendat.generate_arrays_realistic(4000, 100, 150, 1000, seed=2)


def _cfg():
    return tconfig.Config(
        Windows=[10, 30, 50, 70], WindowWidth=20, PMatch=0.96, MinDinuc=3,
        MaxReadLength=200, MMTol=2, MaxMatches=10**6, MatchMode="best",
    )


def test_device_built_save_load_and_search_probe(workload, tmp_path):
    """A device-built index writes the host build's index file (read back
    from the device) and builds the host build's search aux; the
    search-probe and sorted-join MatchResults equal the host-built
    index's."""
    rs, ts = workload
    host = tindex.build_target_index(ts, 20, "cpu")
    dev = tindex.build_target_index(ts, 20, "cpu", device_build=True)
    paths = {}
    for tag, idx in (("host", host), ("dev", dev)):
        paths[tag] = str(tmp_path / f"{tag}.npz")
        idx.save(paths[tag])
    a, b = np.load(paths["host"]), np.load(paths["dev"])
    assert set(a.files) == set(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    loaded = tindex.TargetIndex.load(paths["dev"], ts, 20, "cpu")
    for f in ("skeys", "spos"):
        assert torch.equal(getattr(loaded, f), getattr(dev, f))

    ha, da = host.search_aux(), dev.search_aux()
    assert (ha.mode, ha.bucket_bits, ha.upshift) == (da.mode, da.bucket_bits, da.upshift)
    for f in ("sbucket", "urec", "ukeys", "ukeys2", "ustart", "ucount", "ukk"):
        x, y = getattr(ha, f), getattr(da, f)
        assert (x is None and y is None) or torch.equal(x, y), f

    cfg = _cfg()
    exp = tpipeline.run_matching_indexed(cfg, rs, host, probe="search")
    assert len(exp.read_row) > 0
    for probe in ("search", "sort"):
        tm = {}
        got = tpipeline.run_matching_indexed(cfg, rs, dev, probe=probe, timings=tm)
        for f in ("read_row", "gene", "start", "nmiss"):
            np.testing.assert_array_equal(getattr(got, f), getattr(exp, f), err_msg=f)
    assert tm["probe_kind"] == "sorted_join"


@pytest.mark.parametrize("width,mult", [(8, None), (13, None), (20, None),
                                        (20, jwindows.HASH_MULT2), (31, None)])
def test_window_functions_match_jax(width, mult):
    rng = np.random.default_rng(width)
    tcat = rng.integers(0, 5, 3000).astype(np.uint8)
    exp = np.asarray(jwindows.sliding_window_keys(jnp.asarray(tcat), width, mult))
    got = twindows.sliding_window_keys(torch.from_numpy(tcat), width, mult)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), exp.astype(np.int64))
    codes = rng.integers(0, 5, (400, 80)).astype(np.uint8)
    for q1 in (0, 7, 80 - width):
        exp = np.asarray(jwindows.window_keys_at(jnp.asarray(codes), q1, width, mult))
        got = twindows.window_keys_at(torch.from_numpy(codes), q1, width, mult)
        np.testing.assert_array_equal(got.numpy(), exp.astype(np.int64))
        exp = np.asarray(jwindows.dinucleotide_counts(jnp.asarray(codes), q1, width))
        got = twindows.dinucleotide_counts(torch.from_numpy(codes), q1, width)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), exp)



@pytest.mark.parametrize("nbases", [0, 1, 7, 8, 9, 1000, 4099])
@pytest.mark.parametrize("chunk", [8, 24, 97, 1 << 25])
def test_pack_stream_device_matches_host(nbases, chunk):
    """The device build's stream packing, in chunks of whole words (a
    chunk of 97 bases packs 96 at a time) and a partial last word, gives
    the host pack_stream's words and tail padding, codes 0-15 included."""
    codes = np.random.default_rng(nbases).integers(0, 16, nbases).astype(np.uint8)
    got = tpacked.pack_stream_device(torch.from_numpy(codes), chunk)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), tpacked.pack_stream(codes))
