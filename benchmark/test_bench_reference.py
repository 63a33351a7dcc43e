"""The plain reference against the port, at a small size on the CPU, for
both configurations' flags and both mixes, and with ragged reads and X
codes."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark.bench_testing import HERE, TINY_GENES
from benchmark.harness import reference, traffic


def _port(cfg: dict, genes: np.ndarray, gene_start: np.ndarray, codes, lengths):
    from muscato_tpu_torch.config import Config
    from muscato_tpu_torch.engine import pipeline
    from muscato_tpu_torch.engine.index import build_target_index
    from muscato_tpu_torch.io.reads import ReadSet
    from muscato_tpu_torch.io.targets import TargetSet

    ts = TargetSet(tcat=genes, gene_start=gene_start, names=[], lengths=np.diff(gene_start))
    index = build_target_index(ts, cfg["WindowWidth"], "cpu", device_build=True)
    rs = ReadSet(codes=codes, lengths=lengths, counts=np.ones(len(codes), np.int64),
                 num_total=len(codes))
    mr = pipeline.run_matching_indexed(Config(**cfg), rs, index)
    return np.stack([mr.read_row, mr.gene, mr.start, mr.nmiss], 1).astype(np.int64)


def _reference(cfg: dict, genes, gene_start, codes, lengths):
    ref = reference.Reference(
        torch.from_numpy(genes), gene_start, windows=cfg["Windows"], width=cfg["WindowWidth"],
        pmatch=cfg["PMatch"], min_dinuc=cfg["MinDinuc"], max_read_length=cfg["MaxReadLength"],
        mmtol=cfg["MMTol"], max_matches=cfg["MaxMatches"], match_mode=cfg["MatchMode"])
    return ref.match(torch.from_numpy(codes), torch.from_numpy(lengths)).numpy()


def _mix(name: str) -> dict:
    with open(os.path.join(HERE, "traffic", name + ".json")) as f:
        return {**json.load(f), "reads_per_call": 6000, "shift_span": 100}


@pytest.mark.parametrize("config,mix,ragged", [
    ("bigtest-w20", "mapped", False), ("bigtest-w20", "gendat", False),
    ("docs-w15", "mapped", False), ("bigtest-w20", "mapped", True),
    ("docs-w15", "mapped", True), ("docs-w15", "gendat", False)])
def test_reference_equals_port(config, mix, ragged):
    with open(os.path.join(HERE, "configs", config + ".json")) as f:
        spec = json.load(f)
    cfg, length = spec["config"], spec["read_length"]
    genes, gene_start, codes = traffic.make_cell_data(TINY_GENES[config], length, _mix(mix),
                                                      2**31 + 5, "cpu")
    genes = genes.numpy()
    lengths = np.full(len(codes), length, np.int32)
    if ragged:
        # Reads of every length from a window past the first to the full
        # length, and X codes (which equal X) in reads and genes.
        rng = np.random.default_rng(7)
        lengths = rng.integers(cfg["Windows"][1] + cfg["WindowWidth"], length + 1,
                               len(codes)).astype(np.int32)
        codes = codes.copy()
        codes[np.arange(length)[None, :] >= lengths[:, None]] = 0
        codes[rng.random(codes.shape) < 0.01] = 4
        genes = genes.copy()
        genes[rng.random(genes.shape) < 0.001] = 4
    got = _port(cfg, genes, gene_start, codes, lengths)
    want = _reference(cfg, genes, gene_start, codes, lengths)
    assert len(want) >= 100
    if cfg["Windows"][0] == 0 and not ragged:
        assert (want[:, 2] == 0).any()  # reads at a gene's start: the position-0 rule
    np.testing.assert_array_equal(got, want)
