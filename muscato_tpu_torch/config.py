"""Run configuration.

Mirrors the reference's single shared config struct
(/root/reference/utils/config.go:10-101): one JSON-serializable object with
the same field names, the same defaulting rules
(/root/reference/cmd/muscato/main.go:833-904) and the same CLI overlay
semantics (flags override config-file values,
/root/reference/cmd/muscato/main.go:708-831).

Fields that only made sense for the reference's CPU/Bloom/GNU-sort runtime
(BloomSize, NumHash, SortPar, SortTemp, SortMem, MaxConfirmProcs) are kept
for config-file compatibility but only a few still steer this engine; they
are accepted and re-serialized untouched.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import List, Optional


@dataclasses.dataclass
class Config:
    # Field names and JSON spelling follow /root/reference/utils/config.go.
    ReadFileName: str = ""
    GeneFileName: str = ""
    GeneIdFileName: str = ""
    ResultsFileName: str = ""
    Windows: List[int] = dataclasses.field(default_factory=list)
    WindowWidth: int = 0
    BloomSize: int = 0
    NumHash: int = 0
    PMatch: float = 0.0
    MinDinuc: int = 0
    TempDir: str = ""
    LogDir: str = ""
    MinReadLength: int = 0
    MaxReadLength: int = 0
    MaxMatches: int = 0
    MaxConfirmProcs: int = 0
    MMTol: int = 0
    MatchMode: str = ""
    SortPar: int = 0
    SortTemp: str = ""
    SortMem: str = ""
    NoCleanTemp: bool = False
    CPUProfile: bool = False

    # --- muscato_tpu extensions (not in the reference struct). ---
    # Engine batch/chunk sizes; 0 means "auto".  These never change
    # results, only memory/launch shapes.
    TargetChunk: int = 0
    MaxPairChunk: int = 0
    ReadBatch: int = 0
    # Bounded-memory read prep: spill sorted unique runs of this many
    # records to disk and stream-merge them (the analogue of the
    # reference's prep_reads | sort -S 50% external sort,
    # /root/reference/cmd/muscato/main.go:181-189).  0 = one in-memory
    # pass (fastest; peak RSS grows with the read collection).
    PrepChunk: int = 0
    # Resume the match stage from a previous run's TempDir (expects its
    # matches.npz artifact; pair with NoCleanTemp on the producing run).
    ResumeDir: str = ""
    # Device mesh: "" = single device ("auto" when several are visible),
    # "auto", "off", or explicit "DPxMP" (e.g. "2x4": 2-way read data
    # parallelism x 4 gene-range index shards).
    Mesh: str = ""
    # Persist/reuse the sorted target index (npz).  If the file exists it
    # is loaded (skipping the build sort); otherwise it is written after
    # the build.
    IndexFile: str = ""
    # Multi-host runtime (jax.distributed).  Coordinator "host:port" plus
    # process count/index; leave unset on single-host runs.  ProcessIndex
    # is a string so "0" is expressible under the zero-means-unset overlay.
    Coordinator: str = ""
    ProcessCount: int = 0
    ProcessIndex: str = ""
    # Disable the diagonal-dedup verify (A/B hook; results are identical
    # either way — the dedup path just verifies each (read, diagonal)
    # once instead of once per window).
    NoDedup: bool = False

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        return json.dumps(d)

    @classmethod
    def from_json_file(cls, path: str) -> "Config":
        with open(path, "rt") as f:
            d = json.load(f)
        cfg = cls()
        for k, v in d.items():
            if hasattr(cfg, k):
                setattr(cfg, k, v)
        return cfg

    def save(self, path: str) -> None:
        with open(path, "wt") as f:
            f.write(self.to_json())
            f.write("\n")


def apply_defaults(cfg: Config, stderr=None) -> None:
    """Validate and default, mirroring checkArgs
    (/root/reference/cmd/muscato/main.go:833-904)."""
    err = stderr if stderr is not None else sys.stderr

    def fail(msg):
        err.write(msg)
        raise SystemExit(1)

    if not cfg.ReadFileName:
        fail("\nReadFileName not provided, run 'muscato --help' for more information.\n\n")
    if not cfg.GeneFileName:
        fail("\nGeneFileName not provided, run 'muscato --help' for more information.\n\n")
    if not cfg.GeneIdFileName:
        fail("\nGeneIdFileName not provided, run 'muscato --help' for more information.\n\n")
    if not cfg.ResultsFileName:
        cfg.ResultsFileName = "results.txt"
        err.write("ResultsFileName not provided, defaulting to 'results.txt'\n")
    if not cfg.Windows:
        fail("\nWindows not provided, run 'muscato --help' for more information.\n\n")
    if not cfg.WindowWidth:
        fail("\nWindowWidth not provided, run 'muscato --help' for more information.\n\n")
    if not cfg.BloomSize:
        cfg.BloomSize = 4 * 1000 * 1000 * 1000
    if not cfg.NumHash:
        cfg.NumHash = 20
    if not cfg.PMatch:
        cfg.PMatch = 1.0
    if not cfg.MaxReadLength:
        fail("MaxReadLength not provided, run 'muscato --help' for more information.\n\n")
    if not cfg.MaxMatches:
        cfg.MaxMatches = 1000 * 1000
    if not cfg.MaxConfirmProcs:
        cfg.MaxConfirmProcs = 3
    if not cfg.MatchMode:
        cfg.MatchMode = "best"
    if cfg.MatchMode not in ("best", "first"):
        fail("MatchMode must be 'best' or 'first'\n")
    if not cfg.SortPar:
        cfg.SortPar = 8
    if not cfg.SortMem:
        cfg.SortMem = "50%"


_FLAG_SPECS = [
    # (name, type, help) — help strings follow the reference's flag docs
    # (cmd/muscato/main.go:708-733, help.md).
    ("ConfigFileName", str, "JSON file containing configuration parameters"),
    ("ReadFileName", str, "Sequencing read file (fastq format)"),
    ("GeneFileName", str, "Gene file name (processed form, from muscato_prep_targets)"),
    ("GeneIdFileName", str, "Gene ID file name (processed form)"),
    ("ResultsFileName", str, "File name for results"),
    ("Windows", str, "Comma-separated starting position of each window"),
    ("WindowWidth", int, "Width of each window"),
    ("BloomSize", int, "(compat; unused — the screen is exact here)"),
    ("NumHash", int, "(compat; unused — the screen is exact here)"),
    ("PMatch", float, "Required proportion of matching positions"),
    ("MinDinuc", int, "Minimum distinct dinucleotides in a seeding window"),
    ("TempDir", str, "Workspace for temporary files"),
    ("MinReadLength", int, "Reads shorter than this length are skipped"),
    ("MaxReadLength", int, "Reads longer than this length are truncated"),
    ("MaxMatches", int, "Return no more than this many matches per k-mer group"),
    ("MaxConfirmProcs", int, "(compat; windows share one device dispatch here)"),
    ("MMTol", int, "Number of mismatches allowed above the per-read best"),
    ("MatchMode", str, "'first' or 'best' (which MaxMatches survivors to keep)"),
    ("SortPar", int, "(compat; sorting runs on the accelerator)"),
    ("SortTemp", str, "(compat)"),
    ("SortMem", str, "(compat)"),
    ("TargetChunk", int, "Engine target-chunk size override (0 = auto)"),
    ("MaxPairChunk", int, "Verification pair-chunk size override (0 = auto)"),
    ("ReadBatch", int, "Unique-read batch size streamed per device pass (0 = auto)"),
    ("PrepChunk", int, "Reads per spilled prep run; bounds prep RSS (0 = in-memory)"),
    ("ResumeDir", str, "Resume matching from a previous run's TempDir (matches.npz)"),
    ("Mesh", str, "Device mesh: 'auto', 'off', or 'DPxMP' (e.g. '2x4')"),
    ("IndexFile", str, "Persist/reuse the sorted target index (npz path)"),
    ("Coordinator", str, "jax.distributed coordinator address (multi-host)"),
    ("ProcessCount", int, "Number of hosts in the multi-host run"),
    ("ProcessIndex", str, "This host's index in the multi-host run"),
]

_BOOL_FLAGS = [
    ("NoCleanTemp", "Do not delete temporary files from TempDir"),
    ("CPUProfile", "Capture a device profiler trace of the matching stage"),
    ("NoDedup", "Disable the diagonal-dedup verify (A/B; same results)"),
]


def parse_cli(argv: Optional[List[str]] = None) -> Config:
    """Build a Config from command-line flags, with the reference's overlay
    rule: a config file (if given) is loaded first, then any non-zero flag
    overrides it (/root/reference/cmd/muscato/main.go:736-830).

    Go's flag package accepts both -Flag=x and --Flag=x; argparse with
    '--'-prefixed options plus allow_abbrev=False handles '--Flag=x'; we
    normalize a single leading '-' to '--' first.
    """
    if argv is None:
        argv = sys.argv[1:]
    norm = []
    for a in argv:
        if a.startswith("-") and not a.startswith("--") and len(a) > 2:
            norm.append("-" + a)
        else:
            norm.append(a)

    p = argparse.ArgumentParser(
        prog="muscato",
        description=(
            "TPU-native exhaustive multi-mapping of sequencing reads against "
            "target sequences. Flags override values from --ConfigFileName; "
            "zero/empty flag values mean 'not set', as in the reference."
        ),
        allow_abbrev=False,
    )
    for name, typ, hlp in _FLAG_SPECS:
        p.add_argument("--" + name, type=typ, default=None, help=hlp)
    for name, hlp in _BOOL_FLAGS:
        p.add_argument("--" + name, action="store_true", default=False, help=hlp)
    ns = p.parse_args(norm)

    if ns.ConfigFileName:
        cfg = Config.from_json_file(ns.ConfigFileName)
    else:
        cfg = Config()

    for name, typ, _hlp in _FLAG_SPECS:
        if name in ("ConfigFileName", "Windows"):
            continue
        v = getattr(ns, name)
        if v is None:
            continue
        # Reference overlay treats zero-values as "not set".
        if typ is str and v == "":
            continue
        if typ in (int, float) and v == 0:
            continue
        setattr(cfg, name, v)
    for name, _hlp in _BOOL_FLAGS:
        if getattr(ns, name):
            setattr(cfg, name, True)
    if ns.Windows:
        cfg.Windows = [int(x) for x in ns.Windows.split(",")]
    return cfg
