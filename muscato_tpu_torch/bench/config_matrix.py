"""The settings beyond the flagship's that the port runs whole.

The flagship (``FLAGSHIP``: bench/runner.py run_bench_big's configuration,
width 20, windows 10,30,50,70, ``best`` mode, 100-base reads) is one
setting.  The reference's users run others: its own test harness runs
windows 0,5 at width 4 with PMatch 1 and MMTol 1 (and one golden against
reverse-complement targets), and its documented flags are windows
0,20,40,60,80 at width 15 with MaxReadLength 300.  ``CASES`` holds those
and the settings that reach the engine's other branches: ``first`` mode
with a MaxMatches cap that binds within and across read batches (and the
search probe), the widest exact width (13), widths 25-40, more than 64
windows (B5 in groups, the streaming expand), and reads of 2,000 and
8,000 bases (B7's narrower staged tiles, then B7's and B10's direct
route).

Each case is the flagship's Config with ``fields`` replaced, on
``gendat.generate_arrays_realistic(*data, seed=0)``.  The shapes (widths,
windows, thresholds, modes, read and gene lengths) are the sources' own;
only the read and gene counts are cut: ``data`` for a run on the card
beside a CPU reference (chip_smoke.py's config_matrix_phase), ``small``
for a CPU run of both packages (tests/test_torch_configs.py).
``write_files`` writes a case's arrays as gendat's files for the run
through the command line on -rev targets, every second read as its
reverse complement, so that both strands' targets match.
"""

from __future__ import annotations

import dataclasses

from ..config import Config

# bench/runner.py run_bench_big's configuration (chip_smoke.py's config()).
FLAGSHIP = dict(Windows=[10, 30, 50, 70], WindowWidth=20, PMatch=0.96, MinDinuc=3,
                MaxReadLength=200, MMTol=2, MaxMatches=10**6, MatchMode="best")


@dataclasses.dataclass(frozen=True)
class Case:
    fields: dict  # the Config fields that differ from FLAGSHIP
    data: tuple  # (reads, read length, genes, gene length) on the card
    small: tuple  # the same at a size for the CPU
    paths: tuple = ("auto",)  # engine_device_check paths run on the card
    rev: bool = False  # through the muscato_torch CLI on -rev targets (write_files)
    # Fields of every CPU run (the card's reference and both packages'
    # small runs): a verify chunk that keeps the CPU's int64 passes over
    # long reads in a few hundred MB.  The chunk size does not change the
    # MatchResult.
    cpu_fields: dict = dataclasses.field(default_factory=dict)
    small_fields: dict = dataclasses.field(default_factory=dict)  # fields of the small run


_GOLDEN = dict(Windows=[0, 5], WindowWidth=4, PMatch=1.0, MMTol=1, MatchMode="best",
               MinDinuc=0)
_ONE_BATCH = (100_000, 100, 20_000, 1_000)
_LONG_CPU = dict(MaxPairChunk=8192)
_SMALL = (2_000, 100, 200, 1_000)

CASES = {
    # SURVEY.md section 4: the reference's test harness
    # (tests/data/muscato/00/config.json); golden 04 runs on -rev targets.
    "golden-w4": Case(_GOLDEN, (4_000, 100, 200, 1_000), _SMALL),
    "golden-w4-rev": Case(_GOLDEN, (4_000, 100, 200, 1_000), _SMALL, rev=True),
    # SURVEY.md section 6: the documented flags (cmd/muscato/main.go:29-31).
    "docs-w15": Case(dict(Windows=[0, 20, 40, 60, 80], WindowWidth=15, MaxReadLength=300),
                     (100_000, 300, 20_000, 1_000), (2_000, 300, 200, 1_000)),
    # The rank's first packing and a cap binding within and across batches
    # (4 batches; 16 on the CPU), on the search probe on the card.
    "first-w10-capped": Case(
        dict(Windows=[0, 20, 45], WindowWidth=10, MinDinuc=0, MatchMode="first",
             MaxMatches=2, ReadBatch=32_768),
        _ONE_BATCH, _SMALL, small_fields=dict(ReadBatch=512)),
    "exact-w13": Case(dict(Windows=[0, 29, 58, 87], WindowWidth=13), _ONE_BATCH, _SMALL),
    "wide-w32": Case(dict(Windows=[0, 34, 68], WindowWidth=32), _ONE_BATCH, _SMALL),
    "wide-w40": Case(dict(Windows=[0, 60], WindowWidth=40), _ONE_BATCH, _SMALL),
    # 66 windows: B5 in two groups, and the streaming expand (B10).
    "windows-66": Case(dict(Windows=list(range(0, 131, 2)), WindowWidth=20,
                            MaxReadLength=300),
                       (20_000, 150, 20_000, 1_000), (2_000, 150, 200, 1_000)),
    # B7's 64-lane tile.
    "long-2k": Case(dict(Windows=[0, 500, 1000, 1500], WindowWidth=20, MaxReadLength=2048),
                    (10_000, 2_000, 4_000, 5_000), (100, 2_000, 20, 5_000),
                    cpu_fields=_LONG_CPU),
    # Past the staged tiles: B7's and B10's direct route.
    "long-8k": Case(dict(Windows=[0, 2000, 4000, 6000], WindowWidth=20, MaxReadLength=8192),
                    (2_000, 8_000, 1_000, 20_000), (100, 8_000, 20, 20_000),
                    paths=("auto", "NoDedup"), cpu_fields=_LONG_CPU),
}


def config(name: str, base: Config | None = None, *, cpu: bool = False,
           small: bool = False) -> Config:
    """Case ``name``'s Config: ``base`` (default the flagship's) with the
    case's fields replaced; for a CPU run (``cpu``) its ``cpu_fields``
    too, and for the small size (``small``, a CPU run) its
    ``small_fields``."""
    case = CASES[name]
    base = Config(**FLAGSHIP) if base is None else base
    fields = {**case.fields, **(case.cpu_fields if cpu or small else {}),
              **(case.small_fields if small else {})}
    return dataclasses.replace(base, **fields)


def write_files(rs, ts, out_dir: str) -> tuple[str, str]:
    """A case's ReadSet and TargetSet (rows of one length each, as
    ``gendat.generate_arrays_realistic`` makes them) as gendat's files in
    ``out_dir`` for a run on -rev targets: reads.fastq, each unique read
    as many times as it was drawn, every second one as its reverse
    complement (so that it matches its gene's _r target), and
    genes.txt.sz under the TargetSet's gene names (gene_<i>).  Returns
    their paths."""
    import os

    import numpy as np

    from ..io.seqcodec import _C2B, _RC
    from .gendat import _fastq_blob, _genes_file

    glen = np.diff(np.asarray(ts.gene_start))
    if len(set(rs.lengths.tolist())) != 1 or len(set(glen.tolist())) != 1:
        raise ValueError("write_files: reads and genes must each have one length")
    codes = rs.codes.copy()
    codes[1::2] = _RC[codes[1::2, ::-1]]
    reads_path = os.path.join(out_dir, "reads.fastq")
    with open(reads_path, "wb") as f:
        f.write(_fastq_blob(_C2B[np.repeat(codes, rs.counts, axis=0)], 0).tobytes())
    return reads_path, _genes_file(_C2B[ts.tcat].reshape(len(glen), -1), out_dir)
