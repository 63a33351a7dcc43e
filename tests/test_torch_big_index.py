"""The benchmark's blocked plain reference
(``benchmark/harness/reference_blocked.py``, which builds its window index
in blocks of target positions) against the whole-index reference
(``benchmark/harness/reference.py``), and the port's
``run_matching_indexed`` with the search probe, chosen by size as in the
``big-index-w20`` cell, against the blocked reference: at tiny sizes on
the CPU, on the genes and reads the benchmark's generator makes."""

import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.append(ROOT)

from benchmark.harness import reference, reference_blocked, traffic  # noqa: E402

# Gene sets cut to a few hundred genes of each configuration's length; a
# block of BLOCK positions, so that windows straddle many block bounds.
TINY_GENES = {"bigtest-w20": {"count": 200, "length": 1000},
              "docs-w15": {"count": 200, "length": 400},
              "big-index-w20": {"count": 300, "length": 1000}}
BLOCK = 317
SEED = 2**31 + 11


def _spec(config: str) -> dict:
    with open(os.path.join(ROOT, "benchmark", "configs", config + ".json")) as f:
        return json.load(f)


def _data(config: str, reads: int):
    spec = _spec(config)
    with open(os.path.join(ROOT, "benchmark", "traffic", "mapped.json")) as f:
        mix = {**json.load(f), "reads_per_call": reads, "shift_span": 100}
    genes, gene_start, pool = traffic.make_cell_data(TINY_GENES[config], spec["read_length"],
                                                     mix, SEED, "cpu")
    codes = torch.from_numpy(pool[:reads])
    lengths = torch.full((reads,), spec["read_length"], dtype=torch.int32)
    return spec, genes, gene_start, codes, lengths


def _flags(cfg: dict) -> dict:
    return dict(windows=cfg["Windows"], width=cfg["WindowWidth"], pmatch=cfg["PMatch"],
                min_dinuc=cfg["MinDinuc"], max_read_length=cfg["MaxReadLength"],
                mmtol=cfg["MMTol"], max_matches=cfg["MaxMatches"],
                match_mode=cfg["MatchMode"])


@pytest.mark.parametrize("budget_delta", [0, -1])
@pytest.mark.parametrize("config", sorted(TINY_GENES))
def test_blocked_reference_equals_reference(config, budget_delta):
    """Equal row for row, with the control's budget too (at PMatch 1 it
    leaves no read a match)."""
    spec, genes, gene_start, codes, lengths = _data(config, 3000)
    cfg = spec["config"]
    whole = reference.Reference(genes, gene_start, **_flags(cfg))
    want = whole.match(codes, lengths, budget_delta=budget_delta)
    got = reference_blocked.BlockedReference(genes, gene_start, block=BLOCK,
                                             **_flags(cfg)).match(
        codes, lengths, budget_delta=budget_delta)
    assert torch.equal(got, want)
    rows = want if budget_delta == 0 else whole.match(codes, lengths)
    assert rows.shape[0] >= 100
    assert budget_delta == 0 or want.shape[0] < rows.shape[0]  # the control drops matches
    # Some matched placement has a window whose bases straddle a block bound.
    w = cfg["WindowWidth"]
    p = (torch.from_numpy(gene_start)[rows[:, 1]] + rows[:, 2])[:, None] \
        + torch.tensor(cfg["Windows"])
    assert bool((p // BLOCK != (p + w - 1) // BLOCK).any())


@pytest.mark.parametrize("reads,batch", [(1000, 0), (3000, 1024)], ids=["one-batch", "batches"])
@pytest.mark.parametrize("mode", ["direct", "binary"])
def test_port_equals_blocked_reference(mode, reads, batch, monkeypatch):
    """A tiny ``big-index-w20``: an index of more than 64 window keys a
    query of a batch, so the entry takes the search probe on its own, in
    the direct layout or, below a capped bucket width, the binary one."""
    from muscato_tpu_torch.config import Config
    from muscato_tpu_torch.engine import index as tindex
    from muscato_tpu_torch.engine import pipeline
    from muscato_tpu_torch.io.reads import ReadSet
    from muscato_tpu_torch.io.targets import TargetSet

    if mode == "binary":
        monkeypatch.setattr(tindex, "MAX_DIRECT_BITS", 15)
    spec, genes, gene_start, codes, lengths = _data("big-index-w20", reads)
    cfg = spec["config"]
    ts = TargetSet(tcat=genes.numpy(), gene_start=gene_start, names=[],
                   lengths=np.diff(gene_start))
    index = tindex.build_target_index(ts, cfg["WindowWidth"], "cpu", device_build=True)
    rs = ReadSet(codes=codes.numpy(), lengths=lengths.numpy(),
                 counts=np.ones(reads, np.int64), num_total=reads)
    tm = {}
    mr = pipeline.run_matching_indexed(Config(**cfg, ReadBatch=batch), rs, index, timings=tm)
    assert tm["probe_kind"] == mode
    assert tm["batches"] == (1 if batch == 0 else -(-reads // batch))
    got = np.stack([mr.read_row, mr.gene, mr.start, mr.nmiss], 1).astype(np.int64)
    want = reference_blocked.BlockedReference(genes, gene_start, block=BLOCK,
                                              **_flags(cfg)).match(codes, lengths).numpy()
    assert len(want) >= 100
    np.testing.assert_array_equal(got, want)
