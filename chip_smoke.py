#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (muscato_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --stream-cell  # the streaming flagship alone

Run from the root of a checkout.  It builds the ten CUDA kernels from
muscato_tpu_torch/csrc with nvcc (one process per source, in parallel),
a variant of them built with -DMUSCATO_NO_STAGE (B1 and B4 never stage a
span, B5 stages by a copy loop, B7 reads every word from global memory, B8
and B9 take one thread a query, B3 one thread an output, B10 one thread a
lane reading its rows from global memory) and variants of
csrc/expand.cu built with other constants (B2: tiles a warp, register
cut; B6: ring depth, lo and qid in the ring or not, lanes a warp, register
cut), all at once, then:

  1. prints the card (nvidia-smi name and power limit), torch and CUDA
     versions, the kernel build times, and the integer rate the bounds
     use (the documented lanes a clock at the card's maximum SM clock)
     beside the rates a small kernel of integer chains reaches;
  2. runs each kernel against its plain PyTorch twin on the card at the
     flagship workload's main-path shapes (98.1M index keys, 16.8M
     queries, ~10M pair lanes, a (2**20, 22) row gather, a (2**22, 13)
     packed read batch with short reads and a window past the packed
     width) with duplicate runs, 0xFFFFFFFF keys, dead tails and piecewise
     step-backs; results must be exactly equal; prints each one's time,
     the twin's and, where one PyTorch call computes the same function,
     that call's (CUDA events around one call, median of 5; and around
     10 back-to-back calls), the wrapper's host time a call (100 calls
     with no synchronise), and the least time the card could take: the
     larger of the bytes moved over the memory rate and the integer
     operations over the integer rate, and which of the two it is; B2 and
     B6 also at the flagship's density of one lane a live slot, side by
     side; then holds B1, B2, B4 and B5 exactly against their twins on
     cases that reach each branch of their kernels (unsorted queries, an
     equal-key run longer than B1's staged span, unaligned slices,
     flagship-shaped dense verify chunks of 22- and 28-word rows, also
     timed beside index_select, scattered rows, odd row widths; B7, the
     dedup verify's SWAR body, at the flagship's verify chunk (2**20
     d-sorted lanes of 13-word reads over the 100M-base stream's 22-word
     rows, planted matches, negative diagonals in front, a dead tail),
     measured beside its byte bound and its sector-aware bound, and timed
     in turns against its unstaged build, each also with every live lane
     on read 0, and on 150- and 200-base reads, an even word count, one
     and 31 windows, windows past the packed width, lanes at gene starts
     (the pos-0 quirk), in-word shifts 0 and 28, the last stream
     position, X codes and budgets at nx, a ragged last tile, a 90% dead
     tail, a read a tile, an odd row width, reads of 880, 2000 and 4096
     bases (tiles of 128, 64 and 32 lanes), the widest rows and the
     longest reads whose tile fits shared memory, and one column past
     them, which must take the direct route (no shared memory); dead-tail
     tiles, empty-slot runs longer than B2's stage and B6's ring, warp
     ranges that start inside such runs, a dead tail that starts inside
     a range, slots that own several tiles or ranges, one slot, fewer
     lanes than a range, 4-byte-aligned slot views, the streaming
     expand's chunk windows (a middle chunk, and the last one, short and
     ending in padded slots), B6's variant builds too; even row widths,
     1 and 64 windows, every width class with and without the
     dinucleotide gate, rows of random words); B3 against its unstaged
     variant (its first design) in turns at the postings shape and at a
     2**20-lane gene lookup (one call, back to back and in a CUDA graph),
     beside its sector bound, and exact with its indices and outputs 0-3
     words off 16-byte alignment; then times B1, B4 and B5
     against their unstaged variant, and B2, B6 and their variant builds
     against one another at both densities, in turns; B2 and B6 are also
     timed at the streaming expand's launch shape (131,072 lanes over a
     131,073-slot chunk window); then runs the bench tool
     pallas_device_check (every kernel at its small shapes, exact against
     its twin) and micro_verify (the
     dedup verify's ns a lane in each mode at 2**20 lanes on 100M-base,
     4M-read tables, and in its tuned modes the SWAR body alone: B7
     beside its plain twin);
  3. builds a shard of 1.5e9 random bases, the largest the driver's auto
     mesh gives, on the card by mesh.shard_targets, with its seconds and
     peak memory, its window count, key order, positions and sampled keys
     checked; then the same targets as one card's index (device_build),
     its search aux's peak, and B9 on that aux (binary on its own: hashed
     keys, 22 bucket bits) beside the one-thread build in turns; then
     matches 524,288 reads against that index through
     run_matching_indexed in two batches, in best mode and in first mode
     with MaxMatches 2 (big_index_run_phase), and 524,288 reads through
     pipeline.run_matching against 2,415,919,104 random bases, past
     2**31-1, which it runs as two gene-range shards, each built on the
     card (gene_sharded_run_phase): three quarters of the reads are
     planted in about 1,024 genes (bench/gene_subset.py: the first and
     the last gene, genes past position 2**30 or 2**31, the longest ones,
     the genes at the shard bound, and copies of one read in 2-4 genes,
     also across the bound, with different substitution counts), and
     each MatchResult must equal the port's CPU run over the genes it
     reports and the planted ones, with B9 launched once a batch (once a
     shard), matches past 2**30 (2**31) and in both shards; each run's
     wall, stages, launches, peak memory and each shard's build and match
     seconds are printed; then W2 (world_w2_phase): run B's gene set,
     named and written as prepared gene files, and 524,288 reads planted
     in it (across the mesh's shard bound too) written as fastq, through
     two muscato_torch processes on the card (gloo, Coordinator,
     ProcessCount, ProcessIndex; run_world), Mesh auto: the driver must
     take two index shards (dp=1 mp=2) of more than 2**30 bases, one
     built on the card by each rank, and rank 0's results rows must equal
     the port's CPU run over the genes reported and planted, with matches
     in both shards and past position 2**31; each rank's read prep must
     parse its own byte range, its default path's kernels must launch,
     and its build seconds, peak reserved memory, the card's used memory
     after both builds and its mesh timings are printed;
  4. builds the flagship index on the card (device_build=True, twice),
     each equal to the host build array for array, with both builds'
     times and the device build's peak memory; then B9 on a
     1e8-base AT-rich genome's index at width 13 (exact base-5 keys, a
     skewed aux, binary on its own); then matches
     100k reads of
     the flagship workload against the FULL 100M-base index through
     engine_device_check: the default path, MUSCATO_PJOIN=0 (the
     sort-merge probe), MUSCATO_PEXPAND_SUB=1 (the B6 expand), both, and
     NoDedup (the streaming expand), each on cuda equal to the default
     path's cpu run (the plain twins); then through the streaming expand,
     each on cuda and on cpu: 32 windows (0, 2, ..., 62), and
     _MAX_PAIR_CAP set below the batch's pair total, the last also equal
     to the default run (these runs ask for the sorted join: at 100k
     reads the engine would pick the search probe);
  5. runs the flagship (4M reads x 100 bp against 100,000 genes x 1,000 bp,
     windows 10,30,50,70 at width 20) through run_matching_indexed with
     every launch counter set to 0 first, prints reads/s, matches, the
     pair total, per-stage CUDA-event times and peak device memory, and
     fails unless every kernel of the path launched; then profiles one
     more such run with torch.profiler (every device kernel's time and
     launches, PyTorch's elementwise kernels' launches and time, the
     device's busy share of the stage window, for each
     call site of the port's kernels its launches, time and summed
     bound, and for the postings fetch its step-backs and the 128-byte
     lines it touches; for B7 its sector-aware bound too, and its calls
     replayed through the staged and the unstaged build in turns; it
     fails unless B7 launched once a verify chunk, as B4 does); then the
     same run and profile with both switches
     set (sort-merge probe and B6), whose MatchResult must equal the
     default run's; then the same through the streaming expand
     (NoDedup: B5, B1, one B2, B3 and B10 a chunk of 131,072 pair lanes,
     B3 in the rank), counted, timed and profiled, whose MatchResult must
     equal the default run's, with B10 launched once a chunk (in the
     parity runs through the streaming expand too), its wall,
     expand_verify, the profile's device events in the stage window and
     busy share printed; then B10, the per-pair verify, exact against its
     twin on every lane of that run's first chunk (as the engine called it
     in the profile), timed beside its bound and its sector bound, and in
     turns against its unstaged variant (its first design), the run's 84
     calls replayed through both under torch.profiler; exact on its last
     chunk;
     then B3's calls of the default and the streaming profile replayed
     through both builds in turns;
     then times the probe stage of the flagship
     batch with B5 and with its plain twin, in turns, both probes (the
     sorted join and the sort-merge probe) with their int32 (inactive, lo)
     key and with the int64 key they take from fused.PACKED_LO_LIMIT index
     windows on, in turns, and each probe
     against small sorted prefixes of the index; then matches the 100k
     reads of step 3 through probe="search" in direct mode and in binary
     mode (forced by lowering engine.index.MAX_DIRECT_BITS while the aux
     is built), engine_device_check's last two paths, each on cuda equal
     to the sorted join's cpu run, with every launch counter set to 0
     before the two runs and read after (B8 and B9, csrc/probe.cu, must
     launch), each aux's build seconds on the card, peak memory (built
     once more alone) and device bytes, and prints ENGINE_RESULTS (path
     -> true); then B8 and B9 against their twins at 1,048,576 sorted
     queries of the flagship's reads against the full index's direct and
     binary aux, timed with their bounds, torch.searchsorted's time
     over the same unique keys and a floor (an index_select of one word
     of each table sector any exact probe reads), the one-thread build
     exact and timed against them in turns, and both builds exact on the
     branch cases of tests/probe_cases.py; then times
     the probe stage on the direct and the binary search probe and the
     sorted join
     at 16,384, 65,536, 262,144 and 1,048,576 reads a batch (the first 4
     batches of each), and cuts each probe's stage into its parts at
     262,144 and 1,048,576 reads; then profiles B9 on one binary-mode
     batch of 262,144 reads; then runs the flagship in batches of 262,144 reads
     (16 batches; the engine must auto-select the direct probe, B8 once a
     batch; its profile prints B8's call site) and of
     1,048,576 reads (4 batches, sorted join) with the next batch's probe
     queued ahead of the wait on the current batch's total and under
     MUSCATO_PREFETCH_PROBE=0 (the upload goes ahead in both), in turns,
     each counted, timed and profiled once (busy share), each MatchResult
     equal to the default run's, and times the host's cross-batch cap
     and rank over the union of the 4 batches' rows; then profile_match
     on the flagship index (the top kernels by device time and the stage
     spans of one profiled run of the reads shifted by one); then matches the
     flagship as 3 gene-range shards (run_matching_gene_sharded), equal
     to the default run, with each shard's build and match times; then
     runs the benchmark runner's twin (muscato_tpu_torch.bench.runner):
     _bench_one on the flagship arrays, and its main entry point on the
     small workload, whose JSON line must name reads_per_sec_chip; then
     the device mesh (muscato_tpu_torch.parallel), whose shards are built
     on the card: the flagship over a 1x1 mesh of this process on NCCL,
     its one shard built by shard_targets, in turns with the plain run (mesh, plain, plain,
     mesh), each equal to the default run, and bench/scaling.py's measure
     on the flagship in that world (its 1x1 reads/s); then a 2x2 mesh of four gloo
     processes of this script that share the card (NCCL refuses two
     ranks on one card), each holding half the gene set and half of
     each batch, memory-mapping the flagship arrays this process writes
     once: the flagship, whose rank-0 MatchResult must equal the default
     run's, and the 100k parity reads under both switches and with
     NoDedup, each equal to its single-device run above; every kernel of
     each path must launch on every rank, and each rank's stage times,
     all-gather and rank-0 gather seconds and bytes, peak memory and
     launches are printed; then
     runs the muscato_torch entry point on gendat files prepared by
     prep_targets (same index size, fewer reads) and checks its four
     output files and prints its probe line (the direct probe, the aux's
     bytes and its build's seconds on the card), then runs it with an
     IndexFile that it saves, with the
     same IndexFile that it loads, and with ResumeDir set to the saving
     run's kept TempDir: each run's four files must equal the first's;
     then W1 (world_w1_phase): the same files through two muscato_torch
     processes on the card under Mesh auto (read parallelism, dp=2 mp=1)
     and Mesh=1x2 (two shards), rank 0's four report files byte-identical
     to the plain run's, rank 1 writing none, each world's wall printed
     beside the plain run's; then the config matrix (config_matrix_phase): the settings of
     muscato_tpu_torch/bench/config_matrix.py beyond the flagship's, each
     run whole on the card and held to the CPU run of the same inputs
     (the reference's test setting, windows 0,5 at width 4 with PMatch 1
     and MMTol 1, also through the muscato_torch CLI on -rev targets with
     reads from both strands, its report files byte-equal to the CPU
     run's; the documented flags, windows 0,20,40,60,80 at width 15 on
     300-base reads; first mode with MaxMatches 2 in 4 batches on the
     search probe; widths 13, 32 and 40; 66 windows, B5 in two groups and
     the streaming expand; reads of 2,000 bases, B7 on 64-lane tiles; reads
     of 8,000 bases, B7 and B10 on their direct route), with each run's
     matches, probe, launches and card and CPU seconds; then B7 and B10 on
     reads of 2,000, 7,000 and 8,000 bases, staged against direct in
     turns where both exist, each exact (long_read_routes);
  6. runs the reference-scale job (scale_run_phase): the twin of
     scripts/gen_parallel.py writes 9,437,184 reads (one ReadBatch of
     2**23 and a partial second batch) against the 100,000 x 1,000-base
     gene set, and the twin of scripts/run_100m.py runs the muscato_torch
     driver on them twice, building and saving the IndexFile, then
     loading it, under MUSCATO_STAGE_TIMES=1: each run must exit 0, run 2
     batches with a stage-times line each and launch every kernel of the
     default path, and both must write the same results.txt; then the
     first 100,000 reads run through the driver on the CPU, whose rows'
     first six columns must equal those of the card run's rows of the
     same read sequences; it prints each run's stage walls (the driver's
     logs), peak anonymous RSS, reads/s end to end and the seconds after
     the row fetch;
  7. runs the bench tool bigtest (100k reads x 100k genes through the
     muscato_torch driver) through its entry point.

Every phase checks its results and any failure exits non-zero; each
phase's seconds are printed as it ends, and all of them with the whole
run's before the result.  The line before the last is a JSON object with
each kernel's numbers (its launches_mesh: rank 0's launches on the 2x2
flagship, B6's from its switched run; launches_scale_run: the second scale
run's; launches_config_matrix: summed over the config matrix's runs;
launches_big_index: summed over the two runs against the 1.5e9-base
index; launches_gene_sharded: the run over two gene-range shards;
launches_world: summed over every rank of W1's and W2's worlds, from
each rank's log; long_read_routes_ms for B7 and B10); the last line
is {"ok": true, "device": {...}}.  Without a CUDA device it exits non-zero
and prints no result.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import functools
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types

SEED = 0
ROOT = os.path.dirname(os.path.abspath(__file__))
NUM_READ, READ_LEN, NUM_GENE, GENE_LEN = 4_000_000, 100, 100_000, 1_000
WINDOWS, WIDTH = (10, 30, 50, 70), 20
BATCH = 1 << 22  # the engine's default read batch
PARITY_READS = 100_000
JOIN_LONG_RUN = 100_000  # equal keys, longer than B1's staged span (6,144)
DRIVER_READS = 200_000  # the driver phase cuts the read count only
# The reference-scale run (muscato_tpu_torch/scripts/run_100m.py) at one
# full ReadBatch of 2**23 reads and a partial second batch of 2**20, its
# data written by scripts/gen_parallel.py in chunks of SCALE_GEN_CHUNK
# reads; the first SCALE_GATE_READS reads run again through the driver on
# the CPU.  (With a second batch of 2**22 the phase took 294-349 s on an
# H100 80GB HBM3 at 700 W; the limit it keeps to is 300 s.)
SCALE_READS = (1 << 23) + (1 << 20)
SCALE_BATCHES = 2
SCALE_GEN_CHUNK = 1 << 20
SCALE_GATE_READS = 100_000
SCALE_TIMEOUT = 900  # seconds for each child process of the phase
BRANCH_SLOTS, BRANCH_READS = 1 << 20, 300_007  # sizes of B2's and B5's branch cases
# B6's fewest lanes a warp takes and its ring of slots (csrc/expand.cu
# kSubMinTiles x kExpTile, kSubRing x kSubSlots): the branch cases place
# runs and ends against them (their lane counts stay below 2048 x the
# card's resident warps, so every warp range is SUB_CHUNK lanes).
SUB_CHUNK, SUB_RING = 2048, 512

KERNELS = {
    # name: (source, the TPU kernel's function that reaches pl.pallas_call)
    "sorted_join": ("muscato_tpu_torch/csrc/join.cu", "muscato_tpu/ops/pallas_join.py:156"),
    "expand_owners": ("muscato_tpu_torch/csrc/expand.cu", "muscato_tpu/ops/pallas_expand.py:267"),
    "monotone_gather": ("muscato_tpu_torch/csrc/gather.cu", "muscato_tpu/ops/pallas_gather.py:121"),
    "monotone_gather_rows": ("muscato_tpu_torch/csrc/gather.cu", "muscato_tpu/ops/pallas_gather.py:276"),
    "window_queries": ("muscato_tpu_torch/csrc/windows.cu", "muscato_tpu/ops/pallas_windows.py:69"),
    "expand_owners_sub": ("muscato_tpu_torch/csrc/expand.cu", "muscato_tpu/ops/pallas_expand.py:196"),
    "verify_diagonals_swar": ("muscato_tpu_torch/csrc/verify.cu",
                              "muscato_tpu/ops/packed.py:269 verify_diagonals_packed (an XLA "
                              "body, no pl.pallas_call)"),
    "direct_probe": ("muscato_tpu_torch/csrc/probe.cu",
                     "muscato_tpu/ops/fused.py:595 _probe_windows_direct_impl, its body _chunk "
                     ":626-651 (an XLA body, no pl.pallas_call)"),
    "binary_probe": ("muscato_tpu_torch/csrc/probe.cu",
                     "muscato_tpu/ops/search.py:70 searchsorted2_bucketed and the hit test of "
                     "fused.py:674 _probe_windows_search_impl (XLA bodies, no pl.pallas_call)"),
    "verify_pairs": ("muscato_tpu_torch/csrc/verify.cu",
                     "muscato_tpu/ops/packed.py:432 verify_pairs_packed (an XLA body, no "
                     "pl.pallas_call)"),
}
# The kernels of each driven path: the default one, and the one the two
# switches select (sort-merge probe, so no B1; B6 instead of B2).
DEFAULT_PATH = ("sorted_join", "expand_owners", "monotone_gather",
                "monotone_gather_rows", "window_queries", "verify_diagonals_swar")
SWITCHED_PATH = ("expand_owners_sub", "monotone_gather", "monotone_gather_rows",
                 "window_queries", "verify_diagonals_swar")
SWITCHES = {"MUSCATO_PJOIN": "0", "MUSCATO_PEXPAND_SUB": "1"}
# engine_device_check's paths that the parity phase runs (its search
# paths run after the flagship cells; see search_parity).
ENGINE_PATHS = ("default", "MUSCATO_PJOIN=0", "MUSCATO_PEXPAND_SUB=1",
                "MUSCATO_PJOIN=0 MUSCATO_PEXPAND_SUB=1", "NoDedup")
MICRO_VERIFY_LANES = 1 << 20
# The dedup verify's SWAR body (B7, verify_phase): the flagship's verify
# chunk (the engine's vchunk), and its branch cases at VERIFY_BRANCH_LANES
# lanes over VERIFY_BRANCH_READS reads.
VERIFY_CHUNK = 1 << 20
VERIFY_BRANCH_LANES, VERIFY_BRANCH_READS = 1 << 17, 1 << 16
# The streaming expand's path (NoDedup): B2 a chunk over its slot window,
# B3 for the postings and in the rank, B10 the per-pair verify a chunk (its
# row and gene fetches included: no B4).
STREAM_PATH = ("window_queries", "sorted_join", "expand_owners", "monotone_gather",
               "verify_pairs")
STREAM_CHUNK = 1 << 17  # the engine's pair_chunk when MaxPairChunk is 0
STREAM_WINDOWS = tuple(range(0, 64, 2))  # 32 windows: more than the dedup verify takes
SHARDS = 3
# The search probe's path (the direct or binary probe: no B1), which the
# engine auto-selects when the index holds more than 64 keys a query of a
# batch: the flagship in batches of SMALL_BATCH reads (16 batches).  The
# flagship in MULTI_BATCH batches (4) takes the sorted join; it runs with
# the next batch's probe queued ahead (MUSCATO_PREFETCH_PROBE) and without
# (the next batch's upload goes ahead in both).  The probe stage is timed on each probe at the batch sizes
# of CROSSOVER_BATCHES, over the first CROSSOVER_DEPTH batches of each.
SEARCH_PATH = ("window_queries", "direct_probe", "expand_owners", "monotone_gather",
               "monotone_gather_rows", "verify_diagonals_swar")
SMALL_BATCH, MULTI_BATCH = 1 << 18, 1 << 20
# The path of a batch against the 1.5e9-base index: the binary search probe.
BIG_PATH = ("window_queries", "binary_probe", "expand_owners", "monotone_gather",
            "monotone_gather_rows", "verify_diagonals_swar")
CROSSOVER_BATCHES = (1 << 14, 1 << 16, 1 << 18, 1 << 20)
CROSSOVER_DEPTH = 4
SPLIT_BATCHES = (1 << 18, 1 << 20)  # the probe stage cut into its parts
RUNNER_REPEATS = 2
# The device mesh: a 1x1 mesh of this process on NCCL, and a 2x2 mesh of
# MESH_RANKS gloo processes that share the one card (NCCL refuses two
# ranks on one card); the parent waits MESH_TIMEOUT seconds for them.
MESH_DP, MESH_MP = 2, 2
MESH_RANKS = MESH_DP * MESH_MP
MESH_TIMEOUT = 900
RUNNER_SMALL = ["--Workload", "small", "--NumRead", "1000000", "--Repeats", "2"]
# The largest shard the driver's auto mesh gives (engine/driver.py
# _choose_mesh keeps every shard under 1.5e9 bases), built on the card as a
# mesh rank builds it, in genes of 1,000-19,999 bases.
BIG_SHARD_BASES = 1_500_000_000
# Whole runs past the flagship's gene set, each held to the port's CPU run
# over the genes its reads were planted in (bench/gene_subset.py): BIG_READS
# reads against that index, in batches of BIG_BATCH, in best mode and in
# first mode with a binding cap (big_index_run_phase); then BIG_READS reads
# through pipeline.run_matching against SHARDED_BASES bases, past 2**31-1,
# which it runs as gene-range shards (gene_sharded_run_phase).  The reads
# are planted in PLANTED_GENES genes, GROUPS of them copies of one read in
# 2-4 genes.
BIG_READS, BIG_BATCH = 1 << 19, 1 << 18
SHARDED_BASES = (1 << 31) + (1 << 28)
SHARD_BASES = 3 << 29  # the bases a shard of pipeline.run_matching's sharding
BIG_PAST, SHARDED_PAST = 1 << 30, 1 << 31  # positions that matches must pass in A and B
PLANTED_GENES = 1024
PAST_GENES, LONGEST_GENES = 128, 16  # planted genes past 2**30 (2**31 in B), longest ones
GROUPS = (2, 3, 4) * 16  # the sizes of the groups planted anywhere
CROSS_PAIRS, CROSS_FOURS = 32, 16  # groups across the shard bound (two of four each side)
# Worlds of WORLD_RANKS processes of the muscato_torch entry point, each rank
# started as a user starts one (the driver's flags plus -Coordinator,
# -ProcessCount, -ProcessIndex and -device=cuda), on the one card with gloo
# (NCCL refuses two ranks on one device): W1 on driver_phase's files under
# Mesh auto (read parallelism) and Mesh=1x2, W2 on SHARDED_BASES bases under
# Mesh auto (two index shards).  Each rank has WORLD_TIMEOUT seconds.
WORLD_RANKS = 2
WORLD_TIMEOUT = 600
WORLD_CHILD = "import sys; from muscato_tpu_torch import cli; sys.exit(cli.main_muscato(sys.argv[1:]))"
LAUNCH_LINE = re.compile(r"kernel launches over (\d+) batches: (.*)")
SHARD_BUILT = re.compile(
    r"mesh shard (\d+) of (\d+) \(genes \[(\d+),(\d+)\)\): (\d+) bases -> (\d+) window keys "
    r"built on (\S+) in ([\d.]+)s; peak reserved ([\d.]+) GiB, card used ([\d.]+) of ([\d.]+) GiB")
# The driver's host stages, by the head of the log line that ends "in <s>s".
HOST_STAGES = {"prep": "prepared reads: ", "targets": "loaded ", "report": "wrote "}
PREP_RANGE = re.compile(r"range-sharded read prep: rank (\d+) of (\d+) parsed bytes \[(\d+),(\d+)\) "
                        r"of (\d+): (\d+) reads, (\d+) unique")
# B9 where the binary mode is the fallback for skewed keys: an AT-rich
# genome (codes A, C, G, T drawn 4:1:1:4, as in AT-rich genomes such as
# Plasmodium's) indexed at the widest width whose keys are the windows'
# exact base-5 codes; its direct layout overflows, so its aux is binary.
SKEW_BASES, SKEW_WIDTH = 100_000_000, 13
SKEW_CODES = (0, 0, 0, 0, 1, 2, 3, 3, 3, 3)
PROBE_QUERIES = 1 << 20  # B9's sorted queries on those auxes
# Where the engine calls each kernel wrapper (module, attribute; fused
# reaches B1 through its reference to the join module), and each kernel's
# CUDA symbol as a profile names it.
CALL_POINTS = (("fused", "window_queries"), ("fused", "_join.sorted_join"),
               ("fused", "expand_owners"), ("fused", "monotone_gather"),
               ("packed", "monotone_gather"), ("packed", "monotone_gather_rows"),
               ("packed", "verify_diagonals_swar"), ("fused", "sops.direct_probe"),
               ("fused", "sops.binary_probe"), ("fused", "verify_pairs_packed"))
SYMBOLS = {
    "sorted_join": "sorted_join_kernel", "expand_owners": "expand_owners_kernel",
    "monotone_gather": "gather_kernel", "monotone_gather_rows": "gather_rows_kernel",
    "window_queries": "window_queries_kernel",
    "expand_owners_sub": "expand_owners_sub_kernel",
    "verify_diagonals_swar": "verify_diagonals_kernel",
    "direct_probe": "direct_probe_kernel", "binary_probe": "binary_probe_kernel",
    "verify_pairs": "verify_pairs_kernel",
}
PROFILE_TRIES = 3  # profiled runs kernel_profile makes before a count mismatch fails
HBM_BYTES_PER_S = 3.35e12  # H100 SXM peak memory rate (NVIDIA data sheet)
# 32-bit integer results a clock on one SM, for each of its two integer
# pipes: multiply-add, and add/compare/shift/logic (the table of
# arithmetic throughput for compute capability 9.0 in NVIDIA's CUDA C++
# programming documentation).
INT_LANES_PER_SM = 64
# Builds of csrc/expand.cu timed beside the default one.  B2 (4 tiles a
# warp, registers cut for 4 CTAs an SM): other tile counts, and other
# register cuts.  B6 (a ring of 4 stages carrying oexcl, lo and qid, at
# least 16 tiles a warp, registers uncut): other ring depths, lo and qid
# read from global memory, fewer and longer warp ranges, register cuts.
B2_VARIANTS = {
    **{f"{n} tile{'s' * (n > 1)} a warp": f"-DMUSCATO_EXP_TILES={n}" for n in (1, 2, 8, 16)},
    "registers uncut": "-DMUSCATO_EXP_MIN_BLOCKS=1",
    "registers for 5 CTAs an SM": "-DMUSCATO_EXP_MIN_BLOCKS=5",
}
B6_VARIANTS = {
    **{f"ring of {n} stages": f"-DMUSCATO_SUB_RING={n}" for n in (3, 6)},
    "lo and qid from global memory": "-DMUSCATO_SUB_LOQID=0",
    "at least 64 tiles a warp": "-DMUSCATO_SUB_MIN_TILES=64",
    **{f"registers for {n} CTAs an SM": f"-DMUSCATO_SUB_MIN_BLOCKS={n}" for n in (3, 4)},
}


def ptxas_of(log: str, symbol: str) -> str:
    """nvcc's -Xptxas -v report of one kernel in a build's output: its
    stack frame, spills, registers and static shared memory."""
    lines = log.splitlines()
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln and symbol in ln:
            return " ".join(x.strip() for x in lines[i + 2:i + 4])
    return "not in the build's output"


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def config():
    from muscato_tpu_torch.config import Config

    # bench/runner.py run_bench_big's configuration.
    return Config(
        Windows=list(WINDOWS), WindowWidth=WIDTH, PMatch=0.96, MinDinuc=3,
        MaxReadLength=2 * READ_LEN, MMTol=2, MaxMatches=10**6, MatchMode="best",
    )


def wrappers():
    """{name: kernel wrapper}, each with its launch count."""
    from muscato_tpu_torch.engine import pipeline

    return pipeline.KERNELS


@functools.lru_cache(maxsize=None)
def int_pipe_rate() -> float:
    """Peak 32-bit integer operations a second of one pipe of this card:
    SMs x INT_LANES_PER_SM x the maximum SM clock nvidia-smi reports."""
    import torch

    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout.split()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INT_LANES_PER_SM * float(mhz) * 1e6


# Eight independent chains a thread of multiply-adds (kind 0), of
# shift-and-xor steps (kind 1: two instructions a step) or of both
# (kind 2): what the card issues when nothing but the integer pipes
# limits it.
INT_RATE_SRC = r"""
#include <cstdint>
#include <cuda_runtime.h>
template <int kKind>
__global__ void chains(uint32_t* out, int iters, uint32_t a, uint32_t b) {
  uint32_t x[8], y[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    x[i] = threadIdx.x + i;
    y[i] = blockIdx.x * 977u + threadIdx.x + i;
  }
#pragma unroll 8
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (kKind != 1) x[i] = x[i] * a + b;
      if (kKind != 0) y[i] = (y[i] >> 1) ^ a;
    }
  }
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) acc += x[i] ^ y[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}
extern "C" int muscato_int_chains(int kind, int blocks, int threads, int iters,
                                  unsigned a, unsigned b, void* out, void* stream) {
  auto k = kind == 0 ? chains<0> : kind == 1 ? chains<1> : chains<2>;
  k<<<blocks, threads, 0, (cudaStream_t)stream>>>((uint32_t*)out, iters, a, b);
  return (int)cudaGetLastError();
}
"""


def measured_int_rates(dev) -> dict:
    """Integer operations a second the card reaches on INT_RATE_SRC's
    chains: multiply-adds alone, shift/logic instructions alone, and both
    at once (each pipe's share), to hold int_pipe_rate's table value
    against."""
    import ctypes

    import torch

    from muscato_tpu_torch.ops import _lib

    work = tempfile.mkdtemp(prefix="muscato_int_rate_")
    try:
        src, so = os.path.join(work, "chains.cu"), os.path.join(work, "chains.so")
        with open(src, "w") as f:
            f.write(INT_RATE_SRC)
        _lib._run_all([[_lib._nvcc(), *_lib.NVCC_FLAGS[:6], "-shared", "-o", so, src]])
        fn = ctypes.CDLL(so).muscato_int_chains
    finally:
        shutil.rmtree(work, ignore_errors=True)
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_uint] * 2 + [ctypes.c_void_p] * 2
    blocks = 16 * torch.cuda.get_device_properties(0).multi_processor_count
    threads, iters = 256, 4096
    out = torch.empty(blocks * threads, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    steps = 8 * iters * blocks * threads  # chain steps a launch, of each kind

    def per_s(kind):
        def run():
            check(fn(kind, blocks, threads, iters, 2654435761, 40503,
                     out.data_ptr(), stream) == 0, "integer chains did not launch")
        return steps / (time_ms(run, inner=3) * 1e-3)

    both = per_s(2)
    return {"multiply_add": per_s(0), "shift_logic": 2 * per_s(1),
            "together": {"multiply_add": both, "shift_logic": 2 * both}}


def call_work(kernel: str, args, kw) -> tuple:
    """(bytes, multiply-adds, other integer operations) that one call of a
    kernel's function needs, from its inputs alone.  Bytes: each input
    read once and each output written once; table entries, rows and slots
    count once however often they are fetched, and only those this call's
    data touches.  Operations: what the function does, whatever the
    kernel:
      sorted_join       B1's searches replayed on this call's data
                        (join_replay): a subtract, a shift, an add, a
                        compare and two selects a read of the index.  Its
                        bytes: the distinct 32-byte sectors of the index
                        those searches read (at most the whole index,
                        which dense queries touch; sparse ones touch far
                        less), the queries and the two outputs;
      expand_owners     a compare a slot that owns lanes; a compare and two
                        adds a lane;
      monotone_gather   the clamp's two compares a lane (B4: a row);
      window_queries    a base: a nibble extract, a multiply-add a key,
                        and for the dinucleotide mask a multiply-add, a
                        shift and an or; a popcount and two compares a
                        (window, read);
      verify_diagonals_swar  a word: a funnel shift, an xor, the length
                        mask, three shift-ors, an and, a popcount and an
                        add; an and, a popcount and an add a (window,
                        word); six compares and selects a (window, lane)
                        and ten a lane.  Its bytes: (r, d), the lane's
                        nwords + 1 target words, gstart and gend, the
                        three outputs, and each read row and length the
                        lanes touch, once.
      verify_pairs      B7's work a word with one window (a funnel shift,
                        an xor, the length mask, three shift-ors, an and,
                        a popcount and an add; the window's two masks, an
                        and, a popcount and an add), four a refine step of
                        the gene lookup, thirty a lane (clamps, the fit
                        and the verdict).  Its bytes: (r, p), q1 where it
                        is one a lane, the lane's nwords + 1 target
                        words, the four outputs (keep one byte), each
                        read row and length the lanes touch and each
                        gblock and gene_start entry of their genes
                        (bounds, start, end), once.
      direct_probe      a query: its bucket (two shifts), the validity
                        select; a record of its bucket: a compare a key
                        word and an add.  Its bytes: the queries (key1,
                        key2 where the width uses it, the validity byte),
                        the bucket bounds and the records of each distinct
                        bucket the queries touch, once, the two outputs;
      binary_probe      a round of a query's search (replayed here on its
                        data, each ending once lo == hi): an add, a shift,
                        two compares and two selects; the hit test's four
                        compares.  Its bytes: the queries, the distinct
                        bucket bounds, the distinct key pairs the searches
                        and hit tests read, a count and start a distinct
                        hit, the two outputs.
    """
    import torch

    from muscato_tpu_torch.ops import search as sops
    from muscato_tpu_torch.ops import windows as winops

    if kernel in ("direct_probe", "binary_probe"):
        keyf, key2f, validf, *tables = args
        q, k2 = keyf.numel(), int(kw["use_k2"])
        sbucket = tables[-1]
        b = sops.bucket_of(keyf, kw["upshift"], kw["bucket_bits"])
        ub = torch.unique(b)
        fixed = q * (5 + 4 * k2 + 8) + 4 * torch.unique(torch.cat([ub, ub + 1])).numel()
        if kernel == "direct_probe":
            w = kw["bucket_width"]
            span = lambda x: (sbucket[x + 1] - sbucket[x]).clamp(0, w).long()  # noqa: E731
            return fixed + 16 * int(span(ub).sum()), 0, 3 * q + (2 + k2) * int(span(b).sum())
        read, hits, rounds = binary_replay(args, kw)
        return (fixed + 8 * torch.unique(read).numel() + 8 * torch.unique(hits).numel(), 0,
                6 * rounds + 4 * q)

    if kernel == "verify_pairs":
        from muscato_tpu_torch.ops import packed as pops

        r, p, rpacked, lengths, gene_start, budget, q1 = args[:7]
        smax, trows, gblock, gsteps = args[9:13]
        c, (nreads, nw) = r.numel(), rpacked.shape
        pc = p.clamp(0, smax - 1)
        g = pops.gene_of_pos_block(gene_start, gblock, pc, gsteps)
        b = pc >> pops.GENE_BLOCK_BITS
        uniq = lambda *xs, hi: torch.unique(torch.cat(xs).clamp(0, hi)).numel()  # noqa: E731
        entries = (uniq(b, b + 1, hi=gblock.numel() - 1)
                   + uniq(g, g + 1, hi=gene_start.numel() - 1))
        rows = torch.unique(r.clamp(0, nreads - 1)).numel()
        lane = 8 + 4 * int(torch.is_tensor(q1) and q1.numel() > 1) + 4 * (nw + 1) + 13
        return (c * lane + rows * 4 * (nw + 1) + 4 * entries + 4 * budget.numel(),
                0, c * (nw * 14 + 4 * gsteps + 30))

    if kernel == "verify_diagonals_swar":
        r, _, _, rpacked, _, _, _, budget, q1s = args
        c, (nreads, nw), k = r.numel(), rpacked.shape, len(q1s)
        rows = torch.unique(r.clamp(0, nreads - 1)).numel()
        return (c * (8 + 4 * (nw + 1) + 8 + 12) + rows * 4 * (nw + 1) + 4 * budget.numel(),
                0, c * (nw * (11 + 3 * k) + 6 * k + 10))

    if kernel == "window_queries":
        r, nw = args[0].shape
        k, width, dinuc = len(args[2]), kw["width"], int(kw["min_dinuc"] > 0)
        bases = r * k * width
        return (4 * r * (nw + 1) + 9 * k * r,
                bases * (1 + int(winops.uses_second_key(width)) + dinuc),
                bases * (1 + 2 * dinuc) + 3 * k * r)
    if kernel == "sorted_join":
        sectors, reads = join_replay(*args)
        return 32 * sectors + 12 * args[1].numel(), 0, 6 * reads
    if kernel.startswith("expand_owners"):
        # The slots that own lanes have distinct oexcl values.
        owners, cap = torch.unique(args[0]).numel(), kw["pair_cap"]
        return 12 * owners + 8 * cap, 0, owners + 3 * cap
    table, idx = args
    m = idx.numel()
    touched = torch.unique(idx.clamp(0, table.shape[0] - 1)).numel()
    row = 4 * (table.shape[1] if table.dim() == 2 else 1)  # bytes an entry
    return row * (touched + m) + 4 * m, 0, 2 * m


def binary_replay(args, kw) -> tuple:
    """B9's searches replayed on one call's data: (the key-pair indices
    they read, the rounds and the hit test included; the indices of the
    hits, whose count and start are read; the rounds run, each ending once
    lo == hi)."""
    import torch

    from muscato_tpu_torch.ops import search as sops

    keyf, key2f, validf, ukeys, ukeys2, *_, sbucket = args
    n = ukeys.numel()
    key = packed_keys(keyf, key2f, kw["use_k2"])
    ent = lambda at: packed_keys(ukeys[at], ukeys2[at], kw["use_k2"])  # noqa: E731
    b = sops.bucket_of(keyf, kw["upshift"], kw["bucket_bits"])
    lo, hi = sbucket[b].long(), sbucket[b + 1].long()
    read, rounds = [], 0
    for _ in range(kw["probe_steps"]):
        act = lo < hi
        mid = (lo + hi) >> 1
        read.append(mid[act])
        rounds += int(act.sum())
        right = act & (ent(mid.clamp(max=n - 1)) < key)
        lo = torch.where(right, mid + 1, lo)
        hi = torch.where(act & ~right, mid, hi)
    at = lo.clamp(max=n - 1)
    hit = validf & (lo < n) & (ent(at) == key)
    return torch.cat(read + [at]), at[hit], rounds


JOIN_TILE = 512  # B1's queries a CTA (kJoinTile, csrc/join.cu)


def join_replay(skeys, qkeys) -> tuple:
    """B1's searches replayed on one call's data, as csrc/join.cu makes
    them: each tile of JOIN_TILE queries finds L = lower_bound(its min)
    and H = upper_bound(its max) by a warp's 32-ary search of the whole
    index (search.cuh), then each query its lower bound by bisection of
    [L, H) and its upper bound by galloping from there, then bisection.
    Checks the bounds it finds against the plain twin's.  Returns (the
    distinct 32-byte sectors of the index those searches read, whether a
    tile then stages its span or not, and the reads they make)."""
    import torch

    from muscato_tpu_torch.ops import join

    k, q = join.flip(skeys), join.flip(qkeys)  # signed order: the keys' unsigned order
    v, m, dev = k.numel(), q.numel(), k.device
    head = skeys.data_ptr() % 32 // 4  # the index's first word in its sector
    touched = torch.zeros((head + v + 7) // 8, dtype=torch.bool, device=dev)
    reads = 0

    def read(at):
        nonlocal reads
        touched[(at + head) >> 3] = True
        reads += at.numel()
        return k[at]

    # Each tile's L (its min, not strict) and H (its max, strict).
    t = -(-m // JOIN_TILE)
    tiles = lambda fill: torch.cat([q, q.new_full((t * JOIN_TILE - m,), fill)]).view(t, -1)  # noqa: E731
    x = torch.cat([tiles(2**31 - 1).amin(1), tiles(-2**31).amax(1)])[:, None]
    strict = (torch.arange(2 * t, device=dev) >= t)[:, None]
    above = lambda kv, x, strict: torch.where(strict, kv > x, kv >= x)  # noqa: E731
    lo = torch.zeros(2 * t, dtype=torch.int64, device=dev)
    hi = torch.full_like(lo, v)
    lanes = torch.arange(1, 32, device=dev)
    while bool(((hi - lo) > 32).any()):
        act = (hi - lo) > 32
        a, b = lo[act], hi[act]
        piv = torch.cat([a[:, None] + (b - a)[:, None] * lanes // 32, b[:, None]], 1)
        hit = torch.ones(piv.shape, dtype=torch.bool, device=dev)  # lane 31: hi
        hit[:, :31] = above(read(piv[:, :31].flatten()).view(-1, 31), x[act], strict[act])
        first = hit.to(torch.int32).argmax(1)[:, None]
        lo[act] = torch.where(first[:, 0] > 0, piv.gather(1, (first - 1).clamp(min=0))[:, 0] + 1, a)
        hi[act] = piv.gather(1, first)[:, 0]
    at = lo[:, None] + torch.arange(32, device=dev)
    inside = at < hi[:, None]
    hit = torch.zeros(at.shape, dtype=torch.bool, device=dev)
    hit[inside] = above(read(at[inside]), x.expand(at.shape)[inside],
                        strict.expand(at.shape)[inside])
    bound = torch.where(hit.any(1), lo + hit.to(torch.int32).argmax(1), hi)
    tile = torch.arange(m, device=dev) // JOIN_TILE
    top = bound[t:][tile]

    def bisect(lo, hi, right_of):
        while bool((lo < hi).any()):
            act = lo < hi
            mid = lo + ((hi - lo) >> 1)
            right = torch.zeros_like(act)
            right[act] = right_of(read(mid[act]), q[act])
            lo, hi = torch.where(right, mid + 1, lo), torch.where(act & ~right, mid, hi)
        return lo

    first = bisect(bound[:t][tile], top, lambda kv, qv: kv < qv)
    lo, hi, gal, step = first, top, first < top, 1
    while bool(gal.any()):
        probe = lo + step - 1
        gal &= probe < hi
        over = torch.zeros_like(gal)
        over[gal] = read(probe[gal]) > q[gal]
        hi = torch.where(over, probe, hi)
        lo = torch.where(gal & ~over, probe + 1, lo)
        gal &= ~over & (lo < hi)
        step <<= 1
    last = bisect(lo, hi, lambda kv, qv: kv <= qv)
    exp_lo, exp_cnt, _ = join.sorted_join_torch(skeys, qkeys)
    check(torch.equal(first, exp_lo.long()) and torch.equal(last - first, exp_cnt.long()),
          "join_replay: the replayed searches' bounds differ from the twin's")
    return int(touched.sum()), reads


def sector_ids(first, nbytes):
    """The distinct 32-byte sectors (ascending int64 ids, byte // 32) of the
    byte spans [first, first + nbytes) (int64 tensors; spans of no bytes
    touch none)."""
    import torch

    if torch.is_tensor(nbytes):
        keep = nbytes > 0
        first, nbytes = first[keep], nbytes[keep]
    if first.numel() == 0:
        return first.new_empty(0, dtype=torch.int64)
    a, b = first >> 5, (first + nbytes - 1) >> 5
    at = a[:, None] + torch.arange(int((b - a).max()) + 1, device=a.device)
    return torch.unique(at[at <= b[:, None]])


def sector_count(first, nbytes) -> int:
    """How many distinct 32-byte sectors (sector_ids) the spans touch."""
    return sector_ids(first, nbytes).numel()


def probe_sector_bytes(kernel: str, args, kw) -> int:
    """B8's or B9's bytes counted in the 32-byte sectors the memory system
    moves: the query arrays and the two outputs whole; the distinct
    sectors of the bucket bounds the queries read; B8's the records of
    their buckets (at most bucket_width each), B9's the key pairs its
    searches and hit tests read (binary_replay) and the count and start
    of each hit."""
    import torch

    from muscato_tpu_torch.ops import search as sops

    keyf, key2f, validf, *tables = args
    q, sbucket = keyf.numel(), tables[-1]
    whole = lambda nbytes: -(-nbytes // 32)  # noqa: E731
    n = whole(4 * q) * (3 + int(kw["use_k2"])) + whole(q)
    b = sops.bucket_of(keyf, kw["upshift"], kw["bucket_bits"])
    n += sector_count(b * 4, 8)
    if kernel == "direct_probe":
        lo = sbucket[b].long()
        nb = (sbucket[b + 1].long() - lo).clamp(0, kw["bucket_width"])
        n += sector_count(lo * 16, nb * 16)
    else:
        read, hits, _ = binary_replay(args, kw)
        n += sector_count(read * 8, 8) + 2 * sector_count(hits.long() * 4, 4)
    return 32 * n


def packed_keys(k1, k2, use_k2):
    """(key1, key2) int32 bit patterns as one int64 whose signed order is
    the pairs' unsigned order (key2 left out where the width has none)."""
    from muscato_tpu_torch.ops.join import flip
    from muscato_tpu_torch.ops.packed import u64

    key = flip(k1).long() << 32
    return key | u64(k2) if use_k2 else key


def bounds(work) -> dict:
    """The least time the card could take for ``work`` (call_work): the
    larger of its bytes over the peak memory rate and its integer
    operations over the peak rate of the pipe that has more of them."""
    nbytes, mads, alus = work
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = max(mads, alus) / int_pipe_rate() * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations",
                bytes_bound_ms=by_bytes, ops_bound_ms=by_ops)


@contextlib.contextmanager
def switched(**env):
    """Set engine switches (environment variables) for a block."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def time_ms(fn, reps: int = 5, inner: int = 1) -> float:
    """Time of one call of fn in ms: CUDA events around ``inner``
    back-to-back calls, over ``inner``, median of ``reps``, after one
    warm-up.  With ``inner=1`` a short kernel's time includes the device
    idling while the host launches it; back to back (``inner=10``), the
    host's launch work overlaps the device work."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def measure_case(name, fn, twin, library, work, shapes) -> dict:
    """A kernel's numbers at one shape: exact against its twin, its time
    (one call, and back to back), host time a call, the twin's and the
    library call's times, and its bounds, which must lie below its
    times."""
    got, exp = fn(), twin()
    out = dict(
        max_abs_err=_compare(name, got, exp), ms=time_ms(fn),
        back_to_back_ms=time_ms(fn, inner=10), host_ms=host_ms(fn),
        plain_ms=time_ms(twin),
        library_ms=time_ms(library) if library else None,
        library_back_to_back_ms=time_ms(library, inner=10) if library else None,
        **bounds(work), shapes=shapes,
    )
    check(out["bound_ms"] < min(out["ms"], out["back_to_back_ms"]),
          f"{name} at {shapes}: a bound of {out['bound_ms']:.4f} ms above its time")
    return out


def _compare(name, got, exp) -> float:
    """Exact equality of the kernel's tensors with the twin's; returns the
    max absolute difference (0.0)."""
    import torch

    err = 0.0
    for g, e in zip(got, exp):
        check(g.shape == e.shape and g.dtype == e.dtype, f"{name}: shape/dtype")
        err = max(err, float((g.to(torch.int64) - e.to(torch.int64)).abs().max()))
    check(err == 0.0, f"{name}: kernel differs from its plain twin (max abs {err})")
    return err


def launch_expand(lib, oexcl, lo, qid, pair_cap, name="expand_owners"):
    """B2 (or with ``name="expand_owners_sub"`` B6) of the kernel library
    ``lib`` (a variant build), launched as ops/expand.py launches the
    default one."""
    import torch

    from muscato_tpu_torch.ops import _lib

    q = torch.empty(pair_cap, dtype=torch.int32, device=qid.device)
    s = torch.empty_like(q)
    _lib.launch(name, qid, oexcl.data_ptr(), lo.data_ptr(), qid.data_ptr(),
                oexcl.numel(), pair_cap, q.data_ptr(), s.data_ptr(), lib=lib)
    return q, s


def launch_expand_sub(lib, oexcl, lo, qid, pair_cap):
    """B6 of the kernel library ``lib``, as launch_expand launches B2."""
    return launch_expand(lib, oexcl, lo, qid, pair_cap, name="expand_owners_sub")


def host_ms(fn, calls: int = 100) -> float:
    """Host time of one call of fn in ms: ``calls`` calls on the host's
    clock with no synchronise between them (what the caller's thread
    spends to launch), then one synchronise outside the timing."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return t


def launch_windows(lib, rpacked, lengths, q1s, *, width, min_dinuc):
    """B5 of the kernel library ``lib``, launched as ops/window_queries.py
    launches the default one."""
    import ctypes

    import torch

    from muscato_tpu_torch.ops import _lib, windows as winops
    from muscato_tpu_torch.ops.window_queries import _window_table

    nreads, nw = rpacked.shape
    k1 = torch.empty(len(q1s) * nreads, dtype=torch.int32, device=rpacked.device)
    k2, valid = torch.empty_like(k1), torch.empty_like(k1, dtype=torch.bool)
    table = _window_table(nw, q1s, width)
    params = (ctypes.c_longlong * len(table))(*table)
    _lib.launch("window_queries", rpacked, rpacked.data_ptr(), lengths.data_ptr(),
                nreads, nw, ctypes.addressof(params), len(q1s), width, min_dinuc,
                int(winops.key_multiplier(width)), int(winops.HASH_MULT2),
                int(winops.uses_second_key(width)), k1.data_ptr(), k2.data_ptr(),
                valid.data_ptr(), lib=lib)
    return k1, k2, valid


def expand_branch_cases(dev, g) -> dict:
    """{label: (oexcl, lo, qid, pair_cap)} reaching each branch of B2 and
    B6 at sizes that cross many tiles and many of B6's warp ranges
    (SUB_CHUNK lanes, its ring SUB_RING slots), and the streaming
    expand's chunk windows."""
    import torch

    from muscato_tpu_torch.ops import fused

    def slots(counts, off=0):
        counts = counts.to(torch.int32)
        m = counts.numel()
        oexcl = (torch.cumsum(counts, 0) - counts).to(torch.int32)
        lo = torch.randint(0, 1 << 26, (m,), dtype=torch.int32, device=dev, generator=g)
        qid = torch.randint(0, 1 << 24, (m,), dtype=torch.int32, device=dev, generator=g)
        return oexcl[off:], lo[off:], qid[off:], int(counts.sum())

    def live(n, hi=5):
        return torch.randint(1, hi, (n,), dtype=torch.int32, device=dev, generator=g)

    def zeros(n):
        return torch.zeros(n, dtype=torch.int32, device=dev)

    n = BRANCH_SLOTS
    cases = {}
    o, l, q, total = slots(torch.cat([live(n), zeros(n)]))
    cases["dead tail, 37 tiles past the total"] = (o, l, q, total + 37 * 128 + 13)
    counts = live(2 * n)
    counts[torch.arange(2 * n, device=dev) % 9000 >= 5000] = 0
    o, l, q, total = slots(counts)
    cases["runs of 4,000 empty slots"] = (o, l, q, total + 3)
    counts = live(n)
    counts[::50_000] = 3 * 8192 + 5
    o, l, q, total = slots(counts)
    cases["slots that own several CTAs' lanes"] = (o, l, q, total + 1)
    o, l, q, total = slots(zeros(1))
    cases["one slot"] = (o, l, q, 3 * 8192 + 501)
    o, l, q, total = slots(torch.randint(0, 3, (3 * n,), device=dev, generator=g))
    cases["interior empty slots"] = (o, l, q, total + 1)
    o, l, q, total = slots(torch.randint(0, 4, (4 * n,), device=dev, generator=g) // 3)
    cases["mostly empty slots"] = (o, l, q, total + 2)
    o, l, q, total = slots(live(100))
    cases["fewer lanes than a tile"] = (o, l, q, total - 1)
    o, l, q, total = slots(live(600))
    cases["fewer lanes than a warp range"] = (o, l, q, total + 101)
    o, l, q, total = slots(live(n, 3))
    cases["a ring that wraps many times"] = (o, l, q, total + 77)
    # Runs of empty slots longer than the ring: one starting 3 lanes into a
    # warp range (its first owner lies before the run), one at a range's
    # first lane (the search lands past it), each between live stretches.
    ones = lambda k: torch.ones(k, dtype=torch.int32, device=dev)
    o, l, q, total = slots(torch.cat([
        ones(40 * SUB_CHUNK + 3), zeros(3 * SUB_RING), ones(SUB_CHUNK - 3),
        zeros(SUB_RING + 50), live(n)]))
    cases["warp ranges that start inside empty runs"] = (o, l, q, total + 9)
    counts = live(n)
    counts[-1] += (1000 - int(counts.sum())) % SUB_CHUNK
    o, l, q, total = slots(torch.cat([counts, zeros(n)]))
    cases["a dead tail that starts inside a warp range"] = (o, l, q, total + 2 * SUB_CHUNK + 300)
    for off in (1, 2):
        o, l, q, total = slots(torch.cat([live(n), zeros(999)]), off)
        cases[f"slot views sliced by {off} (not 16-byte aligned)"] = (
            o, l, q, total + 8192 + 2 * 128 + 1)
    # The streaming expand's chunk windows: STREAM_CHUNK lanes over
    # STREAM_CHUNK + 1 slots rebased to the chunk (ops/fused.py
    # _chunk_window), a middle chunk and the last one, short and ending in
    # the padded slots.
    counts = torch.cat([live(n), zeros(1000)])  # fewer dead slots than a window
    total = int(counts.sum())
    lo = torch.sort(torch.randint(0, 1 << 26, (n + 1000,), dtype=torch.int32, device=dev,
                                  generator=g)).values
    qid = torch.randint(0, 1 << 24, (n + 1000,), dtype=torch.int32, device=dev, generator=g)
    qid[n:] = -1
    padded = fused._stream_slots(counts, lo, qid, pair_chunk=STREAM_CHUNK, total=total)
    obs = padded[3]
    check(total % STREAM_CHUNK and len(obs) > 3, "chunk window cases need a short last chunk")
    for label, ci in (("a middle chunk", len(obs) // 2), ("the last chunk, short", len(obs) - 1)):
        cases[f"chunk window, {label}"] = (
            *fused._chunk_window(*padded[:3], obs[ci], ci * STREAM_CHUNK, STREAM_CHUNK + 1),
            STREAM_CHUNK)
    return cases


def windows_branch_cases(dev, g) -> dict:
    """{label: (rpacked, lengths, q1s, width, min_dinuc)} reaching each
    branch of B5: half the rows codes 0-4, half random words (nibbles past
    the code range), a read count that is not a multiple of the tile, and
    in every case but "one window" a window past the packed width."""
    import torch

    from muscato_tpu_torch.ops.packed import pack_rows

    nreads = BRANCH_READS
    wide = (0, 3, 8, 30, 77, 90, 100, 104)

    def reads(nw):
        codes = torch.randint(0, 5, (nreads // 2, nw * 8), dtype=torch.uint8,
                              device=dev, generator=g)
        junk = torch.randint(0, 2**32, (nreads - nreads // 2, nw), dtype=torch.int64,
                             device=dev, generator=g).to(torch.int32)
        lengths = torch.randint(0, nw * 8 + 1, (nreads,), dtype=torch.int32,
                                device=dev, generator=g)
        lengths[::2] = nw * 8
        return torch.cat([pack_rows(codes), junk]), lengths

    rp13, ln13 = reads(13)
    rp14, ln14 = reads(14)
    rp2, ln2 = reads(2)
    rp50, ln50 = reads(50)
    rp51, ln51 = reads(51)
    cases = {f"width {w}, min_dinuc {d}": (rp13, ln13, wide, w, d)
             for w in (4, 8, 13, 14, 20) for d in (0, 3)}
    cases["even row width"] = (rp14, ln14, wide + (111,), 20, 3)
    cases["even row width, one key"] = (rp14, ln14, wide + (111,), 13, 0)
    cases["one window"] = (rp13, ln13, (37,), 20, 3)
    cases["64 windows"] = (rp13, ln13, tuple(range(0, 128, 2)), 8, 3)
    cases["rows narrower than a window's slice"] = (rp2, ln2, (0, 3, 9), 13, 3)
    far = (0, 77, 200, 391, 403)
    cases["50-word rows (fewer reads a tile than threads)"] = (rp50, ln50, far, 20, 3)
    cases["51-word rows (fewer reads a tile than threads)"] = (rp51, ln51, far, 14, 3)
    cases["sliced by one row"] = (rp13[1:], ln13[1:], wide, 20, 3)
    cases["sliced by one row, even row width"] = (rp14[1:], ln14[1:], wide, 20, 3)
    return cases


def verify_stream(dev, g, nbases: int) -> dict:
    """A target stream of ``nbases`` codes 0-3 with X (4) at 2%, in genes
    of GENE_LEN bases (the last one shorter), packed on ``dev`` as the
    engine packs it, with its gene tables; ``trows(nwords)`` is its row
    view for reads of ``nwords`` words."""
    import numpy as np
    import torch

    from muscato_tpu_torch.ops import packed as pops

    codes = torch.randint(0, 4, (nbases,), dtype=torch.uint8, device=dev, generator=g)
    codes[torch.rand(nbases, device=dev, generator=g) < 0.02] = 4
    tpacked = torch.nn.functional.pad(pops.pack_rows(codes.view(1, -1)).view(-1),
                                      (0, pops.STREAM_PAD_WORDS))
    gene_start = np.append(np.arange(0, nbases, GENE_LEN), nbases)
    gb, steps = pops.build_gene_block(gene_start, nbases)
    return dict(codes=codes, smax=nbases, gsteps=steps,
                gene_start=torch.from_numpy(gene_start.astype(np.int32)).to(dev),
                gblock=torch.from_numpy(gb).to(dev),
                trows=functools.lru_cache(maxsize=None)(
                    lambda nwords: pops.build_trows(tpacked, nwords, nbases)))


def verify_inputs(dev, g, st, *, lanes, reads, nwords, q1s, width, lengths=None,
                  x_rate=0.02, subs=4, budget=None, pos0=0, last=0, rshift=None,
                  dead=0.1, tile_read=False, widen=0):
    """Arguments of verify_diagonals_swar for a chunk of ``lanes`` lanes
    over the stream ``st`` (verify_stream), as _verify_diagonals feeds it:
    sorted by diagonal, negative diagonals in front (d in [-99, -1]), a
    dead tail of ``dead`` of the lanes (r = -1, d = 0, the chunk's
    padding).  ``reads`` reads of ``nwords`` words, lengths drawn from
    ``lengths`` (default: all 8 * nwords), codes 0-3 with X at ``x_rate``;
    a third of the live lanes are planted: each gets a read row of its
    own, the target under its diagonal with 0 to ``subs`` - 1
    substitutions.  ``pos0`` live lanes start at gene starts, ``last`` at
    the last stream position; ``rshift`` fixes every live diagonal's
    in-word shift (4 * (d & 7)).  With ``tile_read`` every run of 256
    lanes (B7's widest tile, a multiple of every narrower one) reads its
    first lane's read; ``widen`` pads t_rows with that many columns (rows
    wider than B4 gives).  The budget table
    defaults to the flagship's PMatch 0.96.  Returns (args, kw)."""
    import torch

    from muscato_tpu_torch.ops import packed as pops
    from muscato_tpu_torch.ops import verify as vops

    smax, nbits = st["smax"], 8 * nwords
    lo, hi = lengths or (nbits, nbits)
    ri = lambda a, b, n: torch.randint(a, b, (n,), dtype=torch.int32, device=dev, generator=g)
    codes = torch.randint(0, 4, (reads, nbits), dtype=torch.uint8, device=dev, generator=g)
    codes[torch.rand(reads, nbits, device=dev, generator=g) < x_rate] = 4
    nlive = lanes - int(lanes * dead)
    d = ri(0, smax, nlive)
    if rshift is not None:
        d = ((d & ~7) | (rshift // 4)).clamp(max=smax - 1)
    ngenes = st["gene_start"].numel() - 1
    d[:pos0] = st["gene_start"][ri(0, ngenes, pos0).long()]
    d[pos0:pos0 + last] = smax - 1
    nneg = min(99, nlive // 8)
    d[nlive - nneg:] = -torch.arange(1, nneg + 1, dtype=torch.int32, device=dev)
    d = torch.sort(d).values
    r = ri(0, reads, nlive)
    live = torch.nonzero(d >= 0).view(-1)
    pl = live[torch.randperm(live.numel(), device=dev, generator=g)[:min(live.numel() // 3,
                                                                         reads)]]
    rows = torch.randperm(reads, device=dev, generator=g)[:pl.numel()]
    r[pl] = rows.to(torch.int32)
    pos = d[pl].long()[:, None] + torch.arange(nbits, device=dev)[None, :]
    tc = torch.where(pos < smax, st["codes"][pos.clamp(max=smax - 1)], 0)
    nsub = torch.randint(0, subs, (pl.numel(),), device=dev, generator=g)
    lane = torch.arange(pl.numel(), device=dev)
    for i in range(subs - 1):
        at = torch.randint(0, hi, (pl.numel(),), device=dev, generator=g)
        new = (tc[lane, at] + torch.randint(1, 5, (pl.numel(),), dtype=torch.uint8,
                                            device=dev, generator=g)) % 5
        tc[lane, at] = torch.where(nsub > i, new, tc[lane, at])
    codes[rows] = tc
    if tile_read:
        r = r[torch.arange(nlive, device=dev) // 256 * 256]
    ln = ri(lo, hi + 1, reads)
    codes[torch.arange(nbits, device=dev)[None, :] >= ln[:, None]] = 0
    ndead = lanes - nlive
    r = torch.cat([r, torch.full((ndead,), -1, dtype=torch.int32, device=dev)])
    d = torch.cat([d, torch.zeros(ndead, dtype=torch.int32, device=dev)])
    rpacked = pops.pack_rows(codes)
    if budget is None:
        budget = torch.from_numpy(vops.mismatch_budget_table(0.96, nbits)).to(dev)
    _, gstart, gend, t_rows = pops.diagonal_fetch(
        r, d, st["gene_start"], st["gblock"], st["gsteps"], st["trows"](nwords), smax)
    if widen:
        t_rows = torch.nn.functional.pad(t_rows, (0, widen))
    return ((r, d, t_rows, rpacked, ln, gstart, gend, budget, tuple(q1s)),
            dict(width=width, smax=smax))


def launch_verify(lib, r, d, t_rows, rpacked, lengths, gstart, gend, budget, q1s, *,
                  width, smax):
    """B7 of the kernel library ``lib`` (a variant build), launched as
    ops/packed.py launches the default one."""
    import ctypes

    import torch

    from muscato_tpu_torch.ops import _lib

    n = r.numel()
    nx, s, ok = (torch.empty(n, dtype=torch.int32, device=r.device) for _ in range(3))
    _lib.launch("verify_diagonals", r, r.data_ptr(), d.data_ptr(), n, t_rows.data_ptr(),
                t_rows.shape[1], rpacked.data_ptr(), *rpacked.shape, lengths.data_ptr(),
                gstart.data_ptr(), gend.data_ptr(), budget.data_ptr(), budget.numel(),
                (ctypes.c_int * max(len(q1s), 1))(*q1s), len(q1s), width, smax,
                nx.data_ptr(), s.data_ptr(), ok.data_ptr(), lib=lib)
    return nx, s, ok


def verify_sector_bytes(args, smax: int) -> int:
    """B7's bytes counted in the 32-byte sectors that the memory system
    moves: the distinct sectors that one call's data touches.  Each lane's
    r, d, gstart, gend and three outputs; the words [off, off + nwords] of
    its target row that it reads; each distinct read row's words, its
    length and its budget entry, once."""
    import torch

    r, d, t_rows, rpacked, lengths, _, _, budget, _ = args
    c, tcols = t_rows.shape
    nreads, nw = rpacked.shape

    off = (d.clamp(0, smax - 1).long() >> 3) & 7
    rows = torch.unique(r.clamp(0, nreads - 1)).long()
    rlen = lengths[rows].clamp(0, budget.numel() - 1).long()
    n = (7 * -(-4 * c // 32)  # r, d, gstart, gend, nx, s, okbits
         + sector_count((torch.arange(c, device=d.device) * tcols + off) * 4, 4 * (nw + 1))
         + sector_count(rows * (4 * nw), 4 * nw)
         + torch.unique(rows >> 3).numel() + torch.unique(rlen >> 3).numel())
    return 32 * n


def pairs_sector_bytes(args) -> int:
    """B10's bytes counted in the 32-byte sectors that the memory system
    moves, from one call's arguments: the lane arrays (r, p, q1 where it
    is one a lane, nx, g, s and the keep bytes) whole; the distinct
    sectors of the lanes' target windows (nwords + 1 words of a trows row
    from word (dc >> 3) & 7); each distinct read row's words and length;
    the gblock and gene_start entries of the lanes' bounds and genes
    (start and end), as call_work counts them; the budget table."""
    import torch

    from muscato_tpu_torch.ops import packed as pops

    r, p, rpacked, lengths, gene_start, budget, q1 = args[:7]
    smax, trows, gblock, gsteps = args[9:13]
    c, (nreads, nw), (ntrows, tcols) = r.numel(), rpacked.shape, trows.shape
    whole = lambda nbytes: -(-nbytes // 32)  # noqa: E731
    per_lane = torch.is_tensor(q1) and q1.numel() > 1
    pc = p.clamp(0, smax - 1)
    dc = (pc - (q1 if torch.is_tensor(q1) else int(q1))).clamp(min=0).long()
    first = ((dc >> 6).clamp(0, ntrows - 1) * tcols + ((dc >> 3) & 7)) * 4
    rows = torch.unique(r.clamp(0, nreads - 1)).long()
    g = pops.gene_of_pos_block(gene_start, gblock, pc, gsteps).long()
    b = (pc >> pops.GENE_BLOCK_BITS).long()
    sectors = lambda *xs, hi: torch.unique(torch.cat(xs).clamp(0, hi) >> 3).numel()  # noqa: E731
    n = (whole(4 * c) * (5 + int(per_lane)) + whole(c)
         + sector_count(first, 4 * (nw + 1))
         + sector_count(rows * (4 * nw), 4 * nw) + torch.unique(rows >> 3).numel()
         + sectors(b, b + 1, hi=gblock.numel() - 1)
         + sectors(g, g + 1, hi=gene_start.numel() - 1) + whole(4 * budget.numel()))
    return 32 * n


def gather_sector_bytes(table, idx) -> int:
    """B3's bytes counted in 32-byte sectors: the index and output streams
    whole, and the distinct sectors of the table entries the (clamped)
    indices touch."""
    import torch

    m = idx.numel()
    touched = torch.unique(idx.clamp(0, table.numel() - 1).long() >> 3).numel()
    return 32 * (2 * -(-4 * m // 32) + touched)


def verify_bank_wavefronts(args, smax: int) -> float:
    """Shared-memory wavefronts a warp load of the staged B7 kernel's
    target-row reads takes, from one call's addresses: the tile's rows
    staged at tcols words a lane, lane j's word w at j * tcols + off_j + w
    past a base that is the same for the warp's 32 lanes (so it moves no
    word to another bank's load); a load takes as many wavefronts as the
    most distinct words that fall in one of the 32 banks.  The mean over
    the call's warp loads (1.0 is conflict-free; the read rows' odd stride
    makes theirs 1.0 by construction)."""
    import torch

    r, d, t_rows, rpacked = args[:4]
    n, tcols = t_rows.shape[0] // 32 * 32, t_rows.shape[1]
    nw = rpacked.shape[1]
    off = (d[:n].clamp(0, smax - 1).long() >> 3) & 7
    word = torch.arange(n, device=d.device) * tcols + off
    total = 0
    for w in range(nw + 1):
        bank = ((word + w) % 32).view(-1, 32)
        cnt = torch.zeros_like(bank).scatter_add_(1, bank, torch.ones_like(bank))
        total += int(cnt.max(1).values.sum())
    return total / (n // 32 * (nw + 1))


def last_true(pred, lo: int) -> int:
    """The largest x >= lo with pred(x), for a pred that holds at lo and,
    past some x, never again."""
    hi = lo + 1
    while pred(hi):
        hi *= 2
    while hi - lo > 1:  # pred(lo) and not pred(hi)
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if pred(mid) else (lo, mid)
    return lo


def verify_phase(dev, unstaged=None) -> dict:
    """B7, the dedup verify's SWAR body, exact against its twin on every
    lane: the flagship's verify chunk (VERIFY_CHUNK d-sorted lanes of
    100-base reads in 13 words over the 100M-base stream, B4's 22-word
    rows, negative diagonals in front and a dead tail), measured
    (measure_case; no PyTorch call computes the function) beside its
    sector-aware bound (verify_sector_bytes) and the bank wavefronts of
    its target-row reads, then its branch cases, exact only (tiles of
    every width the launcher picks among them), and a shape too large for
    shared memory, which must take the direct route.  ``unstaged`` is the
    library built with -DMUSCATO_NO_STAGE, whose B7 is the first design
    (every word read from global memory): at the flagship chunk it is held
    against the twin and timed against the staged kernel in turns, each
    build also with every live lane on read 0 (no scattered
    read rows or lengths), and PyTorch's gathers of the chunk's read rows
    and lengths alone beside them, to place the time.  Returns the chunk's
    numbers."""
    import torch

    from muscato_tpu_torch.ops import packed as pops

    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    st = verify_stream(dev, g, NUM_GENE * GENE_LEN)
    nw = -(-READ_LEN // 8)
    args, kw = verify_inputs(dev, g, st, lanes=VERIFY_CHUNK, reads=BATCH, nwords=nw,
                             q1s=WINDOWS, width=WIDTH, lengths=(READ_LEN, READ_LEN))
    staged = lambda: pops.verify_diagonals_swar(*args, **kw)
    twin = lambda: pops.verify_diagonals_swar_torch(*args, **kw)
    res = measure_case(
        "verify_diagonals_swar", staged, twin, None,
        call_work("verify_diagonals_swar", args, kw),
        f"lanes ({VERIFY_CHUNK},) t_rows {tuple(args[2].shape)} rpacked "
        f"{tuple(args[3].shape)} windows {WINDOWS} width {WIDTH}")
    res["sector_bound_ms"] = verify_sector_bytes(args, kw["smax"]) / HBM_BYTES_PER_S * 1e3
    res["target_wavefronts_a_load"] = verify_bank_wavefronts(args, kw["smax"])
    r, rp, ln = args[0], args[3], args[4]
    if unstaged is not None:
        one = (torch.where(r >= 0, 0, r), *args[1:])
        _compare("unstaged verify_diagonals_swar", launch_verify(unstaged, *args, **kw), twin())
        # lib None: the default library.
        builds = {"staged": None, "unstaged": unstaged}
        ab = res["staging_ab"] = {}
        for order in (list(builds), list(builds)[::-1], list(builds)):
            for label in order:
                for mode, a in (("", args), (", every live lane on read 0", one)):
                    f = functools.partial(launch_verify, builds[label], *a, **kw)
                    t = ab.setdefault(label + mode, {"ms": [], "back_to_back_ms": []})
                    t["ms"].append(time_ms(f))
                    t["back_to_back_ms"].append(time_ms(f, inner=10))
        del one
    rows = r.clamp(0, rp.shape[0] - 1)
    res["row_gather_ms"] = time_ms(lambda: (rp.index_select(0, rows),
                                            ln.index_select(0, rows)), inner=10)
    del rows
    ok = staged()[2]
    res["lanes_with_okbits"] = int((ok != 0).sum())
    check(res["lanes_with_okbits"] > 0, "verify chunk: no lane passes")
    print(f"verify_diagonals_swar at the flagship chunk: {res['ms']:.4f} ms a call "
          f"({res['back_to_back_ms']:.4f} back to back) against a byte bound of "
          f"{res['bytes_bound_ms']:.4f} ms and a sector bound of {res['sector_bound_ms']:.4f} "
          f"ms; target-row reads {res['target_wavefronts_a_load']:.3f} wavefronts a warp "
          f"load; staged against unstaged (ms, in turns): "
          f"{json.dumps(res.get('staging_ab'))}; index_select of the lanes' read rows and "
          f"lengths: {res['row_gather_ms']:.4f} ms back to back", flush=True)
    del args, ok
    # The launcher's own answer (swar_tile) places the edges: t_rows as
    # wide, and reads as long, as a staged tile of 32 lanes still fits.
    tile = lambda nwords, tcols: pops.swar_tile(nwords, tcols)[0]
    staged = lambda nwords, tcols: pops.swar_tile(nwords, tcols)[1] > 0
    widest = last_true(lambda t: staged(nw, t), nw + pops.TROWS_GUARD)
    longest = last_true(lambda w: staged(w, w + pops.TROWS_GUARD), nw)
    n, nr = VERIFY_BRANCH_LANES, VERIFY_BRANCH_READS
    cases = {
        "19-word reads (150 bases)": dict(nwords=19, q1s=WINDOWS, width=WIDTH),
        "25-word reads (200 bases), X at 5%, lengths 20-200": dict(
            nwords=25, q1s=WINDOWS, width=WIDTH, lengths=(20, 200), x_rate=0.05),
        "4-word reads (an even word count), lengths 20-32": dict(
            nwords=4, q1s=(0, 8, 20), width=12, lengths=(20, 32)),
        "one window": dict(nwords=nw, q1s=(30,), width=WIDTH, lengths=(60, 104)),
        "31 windows, width 12": dict(nwords=nw, q1s=tuple(range(0, 62, 2)), width=12),
        "windows past the packed width": dict(nwords=nw, q1s=(0, 90, 100, 120), width=WIDTH,
                                              lengths=(90, 104)),
        "pos-0 lanes at gene starts, lengths 20-104": dict(
            nwords=nw, q1s=(0, 20), width=WIDTH, lengths=(20, 104), pos0=n // 4),
        "rshift 0": dict(nwords=nw, q1s=WINDOWS, width=WIDTH, rshift=0),
        "rshift 28": dict(nwords=nw, q1s=WINDOWS, width=WIDTH, rshift=28),
        "the last stream position": dict(nwords=nw, q1s=WINDOWS, width=WIDTH, last=n // 8),
        "budgets at nx (budget table 0-3)": dict(
            nwords=nw, q1s=WINDOWS, width=WIDTH, lengths=(60, 104),
            budget=torch.randint(0, 4, (8 * nw + 1,), dtype=torch.int32, device=dev,
                                 generator=g)),
        f"{n + 77} lanes (a ragged last tile)": dict(nwords=nw, q1s=WINDOWS, width=WIDTH,
                                                     lanes=n + 77),
        "a 90% dead tail (whole dead tiles, as a batch's last chunk)": dict(
            nwords=nw, q1s=WINDOWS, width=WIDTH, dead=0.9),
        "every tile on one read": dict(nwords=nw, q1s=WINDOWS, width=WIDTH, tile_read=True),
        f"t_rows of {nw + pops.TROWS_GUARD + 1} words (an odd row width)": dict(
            nwords=nw, q1s=WINDOWS, width=WIDTH, widen=1),
        **{f"{w}-word reads ({8 * w} bases)": dict(nwords=w, q1s=WINDOWS, width=WIDTH,
                                                   lengths=(20, 8 * w))
           for w in (110, 250, 512)},
        f"t_rows of {widest} words (the widest tile that fits)": dict(
            nwords=nw, q1s=WINDOWS, width=WIDTH, widen=widest - nw - pops.TROWS_GUARD),
        f"{longest}-word reads (the longest whose tile fits)": dict(
            nwords=longest, q1s=WINDOWS, width=WIDTH),
    }
    labels, tiles = [], set()
    for label, c in cases.items():
        c = dict(c)
        args, kw = verify_inputs(dev, g, st, lanes=c.pop("lanes", n), reads=nr, **c)
        got = pops.verify_diagonals_swar(*args, **kw)
        exp = pops.verify_diagonals_swar_torch(*args, **kw)
        _compare(f"verify_diagonals_swar {label}", got, exp)
        nx, ok = got[0], got[2]
        r, d, t_rows, rp, ln, _, _, budget, _ = args
        bud = budget[ln[r.clamp(min=0).long()].clamp(max=budget.numel() - 1).long()]
        live = (r >= 0) & (d >= 0)
        lanes = tile(rp.shape[1], t_rows.shape[1])
        tiles.add(lanes)
        labels.append(f"verify_diagonals_swar {label} (tiles of {lanes} lanes, "
                      f"{int((ok != 0).sum())} lanes pass, "
                      f"{int((live & (nx == bud)).sum())} live lanes at nx == budget)")
    del args, got, exp
    st["trows"].cache_clear()
    print("verify_diagonals_swar branch cases exact vs twin: " + "; ".join(labels), flush=True)
    check(tiles >= {256, 128, 64, 32},
          f"verify_diagonals_swar branch cases ran tiles of {sorted(tiles)} lanes only")
    # One column wider than the widest staged tile: the launcher takes the
    # direct route (no shared memory), exact, its launch counted there.
    args, kw = verify_inputs(dev, g, st, lanes=1 << 12, reads=1 << 10, nwords=nw,
                             q1s=WINDOWS, width=WIDTH, widen=widest + 1 - nw - pops.TROWS_GUARD)
    fn = pops.verify_diagonals_swar
    before = fn.launches, fn.direct_launches
    _compare(f"verify_diagonals_swar with t_rows of {widest + 1} words", fn(*args, **kw),
             pops.verify_diagonals_swar_torch(*args, **kw))
    check(not staged(nw, widest + 1)
          and (fn.launches, fn.direct_launches) == (before[0] + 1, before[1] + 1),
          f"verify_diagonals_swar: t_rows of {widest + 1} words did not take the direct route")
    optin = getattr(torch.cuda.get_device_properties(dev), "shared_memory_per_block_optin",
                    "not reported")
    print(f"verify_diagonals_swar with t_rows of {widest + 1} words (one past the widest "
          f"staged tile under the device's {optin} bytes): the direct route, exact vs twin",
          flush=True)
    return res


def graph_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Device time of one call of fn in ms: ``calls`` calls captured in one
    CUDA graph, replayed between CUDA events, over ``calls``, median of
    ``reps`` (after a warm-up on a side stream and one replay), so the host's
    launch work, which sets a short kernel's back-to-back time, is left
    out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    del graph
    return statistics.median(times)


def arms_in_turns(name, arms, exp) -> dict:
    """Each arm (a label and a function of no arguments) exact against the
    twin's result ``exp``, then all timed in turns, one call, back to back
    and in a CUDA graph (graph_ms), three turns, the second in reverse
    order.  Returns {arm: {"ms": [...], "back_to_back_ms": [...],
    "graph_ms": [...]}}."""
    for label, fn in arms.items():
        _compare(f"{name} {label}", fn(), exp)
    turns = {}
    for order in (list(arms), list(arms)[::-1], list(arms)):
        for label in order:
            t = turns.setdefault(label, {"ms": [], "back_to_back_ms": [], "graph_ms": []})
            t["ms"].append(time_ms(arms[label]))
            t["back_to_back_ms"].append(time_ms(arms[label], inner=10))
            t["graph_ms"].append(graph_ms(arms[label]))
    return turns


# The CUDA symbols of B3's and B10's kernels in both builds, as a profile
# names them (the default build's, and the -DMUSCATO_NO_STAGE build's
# first designs).
BUILD_SYMBOLS = {"monotone_gather": r"gather(_thread)?_kernel",
                 "verify_pairs": r"verify_pairs(_thread)?_kernel"}


def replay_in_turns(kernel: str, arms, calls, turns: int = 3) -> dict:
    """Device time (torch.profiler) of a kernel's recorded engine calls
    (``calls``, their argument tuples in the engine's order) replayed
    through each arm (a function of one call's arguments), the arms in
    turns (a, b, b, a, a, b), after one warm-up call.  Returns {arm: [ms
    summed over the calls, a turn]}.  A replay whose launches, as the
    profile counts them, are not one a call in PROFILE_TRIES tries (the
    profiler drops events now and then) is timed with CUDA events around
    each call instead, and says so."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    from muscato_tpu_torch.bench import profile_match

    pat = re.compile(r"(?<![\w])" + BUILD_SYMBOLS[kernel] + r"\b")
    out = {arm: [] for arm in arms}
    for t in range(turns):
        for arm in (list(arms) if t % 2 == 0 else list(arms)[::-1]):
            arms[arm](calls[0])
            # The profiler can miss a launch now and then (kernel_profile):
            # a replay whose count disagrees runs again.
            for _ in range(PROFILE_TRIES):
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for args in calls:
                        arms[arm](args)
                    torch.cuda.synchronize()
                evs = [e for e in profile_match.device_events(prof) if pat.search(e.name)]
                if len(evs) == len(calls):
                    break
            if len(evs) == len(calls):
                out[arm].append(sum(e.time_range.end - e.time_range.start for e in evs) / 1e3)
                continue
            marks = [torch.cuda.Event(enable_timing=True) for _ in range(2 * len(calls))]
            for i, args in enumerate(calls):
                marks[2 * i].record()
                arms[arm](args)
                marks[2 * i + 1].record()
            torch.cuda.synchronize()
            out[arm].append(sum(a.elapsed_time(b) for a, b in zip(marks[::2], marks[1::2])))
            print(f"{kernel} {arm}: the profile showed {len(evs)} launches for {len(calls)} "
                  f"calls in {PROFILE_TRIES} tries; this turn timed with CUDA events around "
                  f"each call ({out[arm][-1]:.4f} ms)", flush=True)
    return out


def launch_pairs(lib, args):
    """B10 of the kernel library ``lib`` (None: the default library) on the
    wrapper's arguments, launched as the wrapper launches it, counting
    nothing."""
    import torch

    from muscato_tpu_torch.ops import _lib

    r, p, rpacked, lengths, gene_start, budget, q1, width, max_rl, smax, trows, gblock, \
        gsteps = args
    n = r.numel()
    keep = torch.empty(n, dtype=torch.bool, device=r.device)
    nx, g, s = (torch.empty(n, dtype=torch.int32, device=r.device) for _ in range(3))
    per_lane = torch.is_tensor(q1)
    _lib.launch("verify_pairs", r, r.data_ptr(), p.data_ptr(), n,
                q1.data_ptr() if per_lane else None, 0 if per_lane else int(q1),
                trows.data_ptr(), *trows.shape, rpacked.data_ptr(), *rpacked.shape,
                lengths.data_ptr(), gene_start.data_ptr(), gene_start.numel(), gblock.data_ptr(),
                gblock.numel(), gsteps, budget.data_ptr(), budget.numel(), width, max_rl, smax,
                keep.data_ptr(), nx.data_ptr(), g.data_ptr(), s.data_ptr(), lib=lib)
    return keep, nx, g, s


def verify_pairs_phase(calls, unstaged=None) -> dict:
    """B10, the streaming expand's per-pair verify, exact against its twin
    on every lane of the streaming flagship's first chunk: its STREAM_CHUNK
    pair lanes in the probe's lo order over the 100M-base stream's rows,
    with the arguments the engine gave B10 in a profiled run (``calls``,
    that run's B10 calls in order), measured beside its bound and its
    sector bound (pairs_sector_bytes; measure_case; no PyTorch call
    computes the function); then the staged kernel and, given
    ``unstaged`` (the -DMUSCATO_NO_STAGE library), the first design's
    one-thread kernel, each exact, timed in turns (arms_in_turns), and the run's calls
    replayed through both in turns (replay_in_turns: B10's device time a
    streaming batch); then each exact on the run's last chunk
    (short: dead lanes past the pair total).  Returns the first chunk's
    numbers."""
    from muscato_tpu_torch.ops import packed as pops

    first, last = calls[0]["args"], calls[-1]["args"]
    r, p, rpacked = first[:3]
    res = measure_case(
        "verify_pairs", lambda: pops.verify_pairs_packed(*first),
        lambda: pops.verify_pairs_packed_torch(*first), None,
        call_work("verify_pairs", first, {}),
        f"the streaming flagship's first chunk: lanes ({r.numel()},) trows "
        f"{tuple(first[10].shape)} rpacked {tuple(rpacked.shape)} width {first[7]}, "
        f"one window offset a lane")
    res["sector_bound_ms"] = pairs_sector_bytes(first) / HBM_BYTES_PER_S * 1e3
    keep = pops.verify_pairs_packed(*first)[0]
    res.update(live_lanes=int(((r >= 0) & (p >= 0)).sum()), kept=int(keep.sum()))
    check(res["kept"] > 0, "verify_pairs: no pair of the first chunk passes")
    builds = {"staged, a warp a tile": None}
    if unstaged is not None:
        builds["one thread a lane (-DMUSCATO_NO_STAGE)"] = unstaged
    res["builds_in_turns"] = arms_in_turns(
        "verify_pairs", {label: functools.partial(launch_pairs, lib, first)
                         for label, lib in builds.items()},
        pops.verify_pairs_packed_torch(*first))
    res["batch_replay_ms"] = replay_in_turns(
        "verify_pairs", {label: functools.partial(launch_pairs, lib)
                         for label, lib in builds.items()}, [c["args"] for c in calls])
    lr = last[0]
    exp_last = pops.verify_pairs_packed_torch(*last)
    _compare("verify_pairs, the last chunk", pops.verify_pairs_packed(*last), exp_last)
    for label, lib in builds.items():
        _compare(f"verify_pairs {label}, the last chunk", launch_pairs(lib, last), exp_last)
    print(f"verify_pairs (B10) at the streaming flagship's first chunk: exact vs twin, "
          f"{res['live_lanes']} live lanes, {res['kept']} kept; {res['ms']:.4f} ms a call "
          f"({res['back_to_back_ms']:.4f} back to back; host {res['host_ms']:.4f} ms a call "
          f"over 100 unsynchronised calls; plain twin {res['plain_ms']:.3f} ms) against a "
          f"bound of {res['bound_ms']:.4f} ms by {res['bound_by']} "
          f"({res['sector_bound_ms']:.4f} by its 32-byte sectors); both builds, each "
          f"exact vs twin, in turns (ms): {json.dumps(res['builds_in_turns'])}; the run's "
          f"{len(calls)} calls replayed, device ms summed, in turns: "
          f"{json.dumps(res['batch_replay_ms'])}; the last "
          f"chunk of {len(calls)} exact vs twin on each ({int((lr >= 0).sum())} live lanes of "
          f"{lr.numel()})", flush=True)
    return res


def launch_gather(lib, table, idx, out=None, out_off: int = 0):
    """B3 of the kernel library ``lib`` (None: the default library) into
    ``out`` from word ``out_off`` on (default: a new tensor), counting
    nothing."""
    import torch

    from muscato_tpu_torch.ops import _lib

    if out is None:
        out = torch.empty(idx.numel(), dtype=torch.int32, device=idx.device)
    _lib.launch("monotone_gather", idx, table.data_ptr(), table.numel(), idx.data_ptr(),
                idx.numel(), out.data_ptr() + 4 * out_off, lib=lib)
    return (out,)


def gather_phase(dev, unstaged, spos, sidx, g) -> dict:
    """B3's design against its first (``unstaged``, the -DMUSCATO_NO_STAGE
    build) in turns (arms_in_turns), each exact against the twin, at the postings
    fetch (``spos[sidx]``) and at a gene lookup of the dedup verify (the
    genes, in gene_start, of VERIFY_CHUNK sorted stream positions), each
    beside its bounds and its sector bound (gather_sector_bytes); then B3
    exact on the postings stream with its indices and its outputs 0-3
    words off 16-byte alignment and m off a multiple of the run.  Returns
    {sector_bound_ms (the postings), builds_in_turns}."""
    import torch

    from muscato_tpu_torch.ops import gather

    gene_start = torch.arange(NUM_GENE + 1, dtype=torch.int32, device=dev) * GENE_LEN
    gpos = torch.sort(torch.randint(0, NUM_GENE * GENE_LEN, (VERIFY_CHUNK,), dtype=torch.int32,
                                    device=dev, generator=g)).values
    turns = {}
    for label, (tab, ix) in {"postings": (spos, sidx),
                             "gene lookup": (gene_start, gpos // GENE_LEN)}.items():
        turns[label] = dict(
            shapes=f"table ({tab.numel()},) idx ({ix.numel()},), "
                   f"{json.dumps(stream_shape(ix))}",
            **bounds(call_work("monotone_gather", (tab, ix), {})),
            sector_bound_ms=gather_sector_bytes(tab, ix) / HBM_BYTES_PER_S * 1e3,
            turns=arms_in_turns(f"monotone_gather {label}", {
                "runs of 4 a thread": lambda: gather.monotone_gather(tab, ix)[:1],
                "a thread an output (-DMUSCATO_NO_STAGE)":
                    lambda: launch_gather(unstaged, tab, ix),
            }, gather.monotone_gather_torch(tab, ix)[:1]))
    print("B3 builds in turns (ms; each exact vs twin): " + json.dumps(turns), flush=True)
    for i0, o0, cut in ((1, 0, 5), (2, 3, 0), (3, 1, 3), (0, 2, 1)):
        ix = sidx[i0: sidx.numel() - cut]
        res = torch.full((ix.numel() + 4,), -1, dtype=torch.int32, device=dev)
        exp = res.clone()
        exp[o0: o0 + ix.numel()] = gather.monotone_gather_torch(spos, ix)[0]
        _compare(f"monotone_gather idx {i0} and out {o0} words off 16 bytes, m {ix.numel()}",
                 launch_gather(None, spos, ix, res, o0), (exp,))
    return dict(sector_bound_ms=turns["postings"]["sector_bound_ms"], builds_in_turns=turns)


def kernel_phase(dev, unstaged, variants, sub_variants) -> dict:
    """Each kernel against its twin at main-path shapes; returns
    {name: {max_abs_err, ms, back_to_back_ms, host_ms, plain_ms,
    library_ms, library_back_to_back_ms, bound_ms, bound_by,
    bytes_bound_ms, ops_bound_ms, shapes}}.  ``unstaged`` is the kernel
    library built with -DMUSCATO_NO_STAGE: B1, B3, B4 and B5 from it are
    held against their twins too and timed against the real ones (B3 in
    gather_phase).
    ``variants`` and ``sub_variants`` map a label to a library of
    csrc/expand.cu whose B2 (B2_VARIANTS), or B6 (B6_VARIANTS), was built
    with other constants."""
    import torch

    from muscato_tpu_torch.engine.pipeline import _bucket_ceil
    from muscato_tpu_torch.ops import _lib, expand, fused, gather, join, window_queries
    from muscato_tpu_torch.ops.packed import pack_rows

    g = torch.Generator(device=dev).manual_seed(SEED)

    def rand_u32(n):
        return torch.randint(0, 2**32, (n,), dtype=torch.int64, device=dev,
                             generator=g).to(torch.int32)

    def case(name, fn, twin, library, work, shapes):
        out[name] = measure_case(name, fn, twin, library, work, shapes)

    def exact(label, fn, twin):
        _compare(label, fn(), twin())
        edge.append(label)

    def unstaged_join(skeys, qkeys):
        lo, cnt = torch.empty_like(qkeys), torch.empty_like(qkeys)
        _lib.launch("sorted_join", qkeys, skeys.data_ptr(), skeys.numel(),
                    qkeys.data_ptr(), qkeys.numel(), lo.data_ptr(), cnt.data_ptr(),
                    lib=unstaged)
        return lo, cnt

    def unstaged_rows(table, ridx):
        res = torch.empty((ridx.numel(), table.shape[1]), dtype=torch.int32, device=dev)
        _lib.launch("monotone_gather_rows", ridx, table.data_ptr(), table.shape[0],
                    table.shape[1], ridx.data_ptr(), ridx.numel(), res.data_ptr(),
                    lib=unstaged)
        return (res,)

    def in_turns(label, arms, twin, into):
        """Every arm but the first (the default build) exact against the
        twin, then all timed back to back, in turns (a, b, b, a, a, b)."""
        names = list(arms)
        for arm in names[1:]:
            _compare(f"{arm} {label}", arms[arm](), twin())
        times = {arm: [] for arm in names}
        for order in (names, names[::-1], names):
            for arm in order:
                times[arm].append(time_ms(arms[arm], reps=3, inner=10))
        into[label] = times

    def stage_ab(label, staged, plain, twin):
        in_turns(label, {"staged": staged, "unstaged": plain}, twin, ab)

    out, extra, edge, ab, exp_ab = {}, {}, [], {}, {}
    # B1: the sorted index (V = genes x valid windows per gene) with
    # duplicate runs and 0xFFFFFFFF keys, against K x batch sorted queries.
    v = NUM_GENE * (GENE_LEN - WIDTH + 1)
    q = len(WINDOWS) * BATCH
    base = rand_u32(v // 2)
    ntop = 5000
    keys = torch.cat([base, base[: v // 4], base[: v - v // 2 - v // 4 - ntop],
                      torch.full((ntop,), -1, dtype=torch.int32, device=dev)])
    keys = join.flip(torch.sort(join.flip(keys)).values)
    hits = keys[torch.randint(0, v, (q // 2,), device=dev, generator=g)]
    qs = torch.cat([hits, rand_u32(q - q // 2 - 2),
                    torch.tensor([0, -1], dtype=torch.int32, device=dev)])
    qs = join.flip(torch.sort(join.flip(qs)).values)
    kf, qf = join.flip(keys), join.flip(qs)
    case("sorted_join", lambda: join.sorted_join(keys, qs)[:2],
         lambda: join.sorted_join_torch(keys, qs)[:2],
         lambda: (torch.searchsorted(kf, qf, side="left"),
                  torch.searchsorted(kf, qf, side="right")),
         call_work("sorted_join", (keys, qs), {}), f"skeys ({v},) qkeys ({q},)")
    del hits, kf, qf
    stage_ab("sorted_join", lambda: join.sorted_join(keys, qs)[:2],
             lambda: unstaged_join(keys, qs), lambda: join.sorted_join_torch(keys, qs)[:2])
    # B1's other branches, exact only: unsorted queries (tiles whose span
    # exceeds the staged cap search global memory), an index slice that is
    # not 16-byte aligned (staged with plain loads), and an index with an
    # equal-key run longer than the staged cap that queries hit, whose
    # length is not a multiple of 4 (the staged tail past the last whole
    # 16 bytes is loaded plainly) and whose top key the last, ragged tile
    # queries.
    uq = qs[torch.randperm(q, device=dev, generator=g)[: 1 << 20]]
    exact("sorted_join unsorted queries", lambda: join.sorted_join(keys, uq)[:2],
          lambda: join.sorted_join_torch(keys, uq)[:2])
    exact("sorted_join unaligned index", lambda: join.sorted_join(keys[1:], qs)[:2],
          lambda: join.sorted_join_torch(keys[1:], qs)[:2])
    del uq
    run_key = int(keys[v // 2])
    keys2 = join.flip(torch.sort(join.flip(torch.cat([
        rand_u32((1 << 22) + 3),
        torch.full((JOIN_LONG_RUN,), run_key, dtype=torch.int32, device=dev)]))).values)
    qs2 = torch.cat([keys2[torch.randint(0, keys2.numel(), ((1 << 19) - 333,), device=dev,
                                         generator=g)],
                     torch.full((1 << 18,), run_key, dtype=torch.int32, device=dev),
                     rand_u32(1 << 18), keys2[-1:]])
    qs2 = join.flip(torch.sort(join.flip(qs2)).values)
    exact(f"sorted_join {JOIN_LONG_RUN}-key run, ragged tile",
          lambda: join.sorted_join(keys2, qs2)[:2],
          lambda: join.sorted_join_torch(keys2, qs2)[:2])
    del keys2, qs2

    # B2 and B6: probe slots in lo order — a live prefix, then a dead
    # tail — owning ~10M pair lanes at 2.5 lanes a live slot, and 11.0M at
    # the flagship batch's one lane a live slot; the buffer has lanes
    # past the total.  The slots that own lanes are read (three words
    # each): the live ones and the last slot, which owns the dead tail.
    m = q
    lo = torch.sort(torch.randint(0, v - 8, (m,), dtype=torch.int32, device=dev,
                                  generator=g)).values
    qid_all = torch.randperm(m, device=dev, generator=g).to(torch.int32)
    sidx = None
    for density, nlive, hi in (("", q // 4, 5), (", one lane a slot", m * 21 // 32, 2)):
        counts = torch.zeros(m, dtype=torch.int32, device=dev)
        counts[:nlive] = torch.randint(1, hi, (nlive,), dtype=torch.int32, device=dev,
                                       generator=g)
        oexcl = (torch.cumsum(counts, 0) - counts).to(torch.int32)
        qid = qid_all.clone()
        qid[nlive:] = -1
        total = int(counts.sum())
        pair_cap = _bucket_ceil(total)
        check(pair_cap > total, "B2 case needs lanes past the pair total")
        kw = dict(pair_cap=pair_cap)
        shapes = f"slots ({m},) pair_cap {pair_cap} (total {total})"
        twin = lambda: expand.expand_owners_torch(oexcl, lo, qid, **kw)
        # The library call: the owner search alone, one searchsorted of
        # every pair lane into the owners' exclusive offsets.
        pid = torch.arange(pair_cap, dtype=oexcl.dtype, device=dev)
        owners = lambda: torch.searchsorted(oexcl, pid, side="right", out_int32=True)
        for name, sub in (("expand_owners", False), ("expand_owners_sub", True)):
            case(name + density,
                 lambda: expand.expand_owners(oexcl, lo, qid, subchunk=sub, **kw),
                 twin, owners, call_work(name, (oexcl, lo, qid), kw), shapes)
        b2 = lambda: expand.expand_owners(oexcl, lo, qid, **kw)
        arms = {"B2": b2, "B6": lambda: expand.expand_owners_sub(oexcl, lo, qid, **kw)}
        for launcher, key, libs in ((launch_expand, "B2", variants),
                                    (launch_expand_sub, "B6", sub_variants)):
            arms.update({f"{key} {label}": (lambda f, lib: lambda: f(
                lib, oexcl, lo, qid, pair_cap))(launcher, lib) for label, lib in libs.items()})
        in_turns("expand_owners" + density, arms, twin, exp_ab)
        if sidx is None:
            sidx = b2()[1]
        if density:
            # The streaming expand's launch: STREAM_CHUNK lanes over the
            # STREAM_CHUNK + 1 slots of a middle chunk of this buffer.
            padded = fused._stream_slots(counts, lo, qid, pair_chunk=STREAM_CHUNK,
                                         total=total)
            ci = len(padded[3]) // 2
            win = fused._chunk_window(*padded[:3], padded[3][ci], ci * STREAM_CHUNK,
                                      STREAM_CHUNK + 1)
            ckw = dict(pair_cap=STREAM_CHUNK)
            cpid = torch.arange(STREAM_CHUNK, dtype=win[0].dtype, device=dev)
            for name, sub in (("expand_owners", False), ("expand_owners_sub", True)):
                case(f"{name} chunk window",
                     lambda: expand.expand_owners(*win, subchunk=sub, **ckw),
                     lambda: expand.expand_owners_torch(*win, **ckw),
                     lambda: torch.searchsorted(win[0], cpid, side="right", out_int32=True),
                     call_work(name, win, ckw),
                     f"chunk {ci} of {len(padded[3])}: {STREAM_CHUNK + 1} slots, "
                     f"pair_cap {STREAM_CHUNK}")
            del padded, win, cpid
        del pid
    print("B2 against B6, same run (ms a call / back to back): " + "; ".join(
        f"{label}: " + " vs ".join(
            f"{n} {out[n + d]['ms']:.3f} / {out[n + d]['back_to_back_ms']:.3f}"
            for n in ("expand_owners", "expand_owners_sub"))
        + f" (bound {out['expand_owners' + d]['bound_ms']:.3f})"
        for d, label in (("", "2.5 lanes a slot"), (", one lane a slot", "one lane a slot"))),
        flush=True)
    # What the card reaches moving the same bytes with no work: one copy
    # that reads half of B6's bytes at one lane a slot and writes the
    # other half, back to back.
    nbytes = call_work("expand_owners_sub", (oexcl, lo, qid), kw)[0] // 8 * 8
    src = torch.empty(nbytes // 8, dtype=torch.int32, device=dev)
    dst = torch.empty_like(src)
    copy_ms = time_ms(lambda: dst.copy_(src), inner=10)
    print(f"copy yardstick: {nbytes} bytes (half read, half written) in {copy_ms:.4f} ms "
          f"back to back, {nbytes / copy_ms / 1e9:.3f} TB/s (the bounds use "
          f"{HBM_BYTES_PER_S / 1e12:.2f})", flush=True)
    del src, dst
    # The wrappers' launch path (the launcher cached per library, the
    # device entered only when it is not current) against one that looks
    # the launcher up and enters the device on every call: B2's host time
    # a call, in turns.
    def launch_uncached(name, like, *args, lib=None):
        fn = getattr(lib or _lib.kernels().lib, "muscato_" + name)
        with torch.cuda.device(like.device):
            rc = fn(*args, torch.cuda.current_stream(like.device).cuda_stream)
        check(rc == 0, f"{name}: CUDA kernel launch failed (cudaError {rc})")

    cached, launch_ab = _lib.launch, {"cached": [], "uncached": []}
    for arm in ("cached", "uncached", "uncached", "cached", "cached", "uncached"):
        _lib.launch = cached if arm == "cached" else launch_uncached
        try:
            launch_ab[arm].append(host_ms(lambda: expand.expand_owners(oexcl, lo, qid, **kw)))
        finally:
            _lib.launch = cached
    print("launch path A/B (B2's wrapper, host ms a call over 100 unsynchronised "
          "calls, in turns): " + json.dumps(launch_ab), flush=True)
    # B2's and B6's branches, exact only, B6 also from its variant builds.
    for label, (o_, l_, q_, cap) in expand_branch_cases(dev, g).items():
        twin = lambda: expand.expand_owners_torch(o_, l_, q_, pair_cap=cap)
        for sub in (False, True):
            exact(f"expand_owners{'_sub' if sub else ''} {label}",
                  lambda: expand.expand_owners(o_, l_, q_, pair_cap=cap, subchunk=sub),
                  twin)
        for vlabel, lib in sub_variants.items():
            _compare(f"expand_owners_sub ({vlabel}) {label}",
                     launch_expand_sub(lib, o_, l_, q_, cap), twin())
    del o_, l_, q_

    # B3: the postings fetch spos[sidx] — piecewise nondecreasing (runs
    # re-expanded for same-key slots step back), clamped dead tail.
    spos = torch.randint(0, NUM_GENE * GENE_LEN, (v,), dtype=torch.int32,
                         device=dev, generator=g)
    sidx = sidx.clamp(0, v - 1)
    del counts, oexcl, lo, qid, qid_all
    sidx_l = sidx.long()
    case("monotone_gather", lambda: gather.monotone_gather(spos, sidx)[:1],
         lambda: gather.monotone_gather_torch(spos, sidx)[:1],
         lambda: spos[sidx_l], call_work("monotone_gather", (spos, sidx), {}),
         f"table ({v},) idx ({sidx.numel()},), {json.dumps(stream_shape(sidx))}")
    out["monotone_gather"].update(gather_phase(dev, unstaged, spos, sidx, g))
    del spos, sidx, sidx_l

    # B4: the target-row fetch of one verify chunk: (T, 22) trows, a
    # nondecreasing row stream whose dead tail maps to the last row.
    nrows = (NUM_GENE * GENE_LEN - 1) // 64 + 1
    ncols = 22
    trows = torch.randint(0, 2**32, (nrows, ncols), dtype=torch.int64, device=dev,
                          generator=g).to(torch.int32)
    vchunk = 1 << 20
    ridx = torch.sort(torch.randint(0, nrows, (vchunk,), dtype=torch.int32,
                                    device=dev, generator=g)).values
    ridx[-vchunk // 10:] = nrows - 1
    ridx_l = ridx.long()
    case("monotone_gather_rows", lambda: gather.monotone_gather_rows(trows, ridx)[:1],
         lambda: gather.monotone_gather_rows_torch(trows, ridx)[:1],
         lambda: trows.index_select(0, ridx_l),
         call_work("monotone_gather_rows", (trows, ridx), {}),
         f"table ({nrows}, {ncols}) ridx ({vchunk},)")
    stage_ab("monotone_gather_rows", lambda: gather.monotone_gather_rows(trows, ridx)[:1],
             lambda: unstaged_rows(trows, ridx),
             lambda: gather.monotone_gather_rows_torch(trows, ridx)[:1])
    # The flagship's verify chunk: 2**20 sorted rows over a contiguous
    # quarter of the table (every tile dense), timed beside index_select;
    # the same with 28-word rows, the trows width of 150-base reads.
    quarter = nrows // 4
    ridx_d = torch.sort(torch.randint(quarter, 2 * quarter, (vchunk,), dtype=torch.int32,
                                      device=dev, generator=g)).values
    ridx_dl = ridx_d.long()
    trows28 = torch.randint(0, 2**32, (nrows, 28), dtype=torch.int64, device=dev,
                            generator=g).to(torch.int32)
    for tab in (trows, trows28):
        label = f"monotone_gather_rows dense chunk, {tab.shape[1]}-word rows"
        fn = lambda: gather.monotone_gather_rows(tab, ridx_d)[:1]
        twin = lambda: gather.monotone_gather_rows_torch(tab, ridx_d)[:1]
        lib = lambda: tab.index_select(0, ridx_dl)
        extra[label] = dict(
            max_abs_err=_compare(label, fn(), twin()), ms=time_ms(fn),
            back_to_back_ms=time_ms(fn, inner=10), library_ms=time_ms(lib),
            library_back_to_back_ms=time_ms(lib, inner=10),
            **bounds(call_work("monotone_gather_rows", (tab, ridx_d), {})),
            shapes=f"table {tuple(tab.shape)} ridx ({vchunk},) over rows "
                   f"[{quarter}, {2 * quarter})")
        stage_ab(label, fn, lambda: unstaged_rows(tab, ridx_d), twin)
    del ridx_dl
    # B4's other branches, exact only (the main case above spreads each
    # tile's rows wider than the tile, so its tiles are sparse; the cases
    # over a quarter of the table or less are dense): step-backs inside a
    # tile (64-row runs each fetched twice) and a ragged last tile;
    # scattered rows; a table slice 8- but not 16-byte aligned (the piece
    # path, staged by plain loads); 21-word rows, whole and sliced to
    # 4-byte alignment (the word path, staged by the bulk copy and by
    # plain loads); a table whose word count is not a multiple of 4, with
    # its last row fetched (the staged tail loaded plainly).
    trows21 = trows[:, :21].contiguous()
    rows_cases = {
        "step-backs, ragged tile": (
            trows, ridx_d.view(-1, 64).repeat_interleave(2, dim=0).view(-1)[: vchunk - 77]),
        "scattered rows": (trows, torch.randint(0, nrows, (1 << 18,), dtype=torch.int32,
                                                device=dev, generator=g)),
        "8-byte-aligned table": (trows[1:], ridx_d),
        "21-word rows": (trows21, ridx_d),
        "21-word rows, 4-byte-aligned table": (trows21[1:], ridx_d),
        "odd word count, last row": (trows[:-1], torch.sort(torch.cat([
            torch.randint(nrows - 1 - (1 << 16), nrows - 1, (1 << 18,), dtype=torch.int32,
                          device=dev, generator=g),
            torch.tensor([nrows - 2], dtype=torch.int32, device=dev)])).values),
    }
    for label, (tab, rix) in rows_cases.items():
        check(tab.is_contiguous(), label)
        exact(f"monotone_gather_rows {label}",
              lambda: gather.monotone_gather_rows(tab, rix)[:1],
              lambda: gather.monotone_gather_rows_torch(tab, rix)[:1])
    del trows, trows21, trows28, ridx, ridx_l, ridx_d, rows_cases

    # B7: the dedup verify's SWAR body.
    out["verify_diagonals_swar"] = verify_phase(dev, unstaged)
    torch.cuda.empty_cache()

    # B5: one packed read batch (4 x 2**22 queries).  Half the rows hold
    # codes 0-4 (realistic), half random words (nibbles past the code
    # range: dinucleotide indices past bit 31); a tenth are short reads.
    # Exact on the main path's windows and, in a second check, with a
    # window past the packed width and an exact-key width.
    nw = -(-READ_LEN // 8)
    codes = torch.randint(0, 5, (BATCH // 2, nw * 8), dtype=torch.uint8,
                          device=dev, generator=g)
    rpacked = torch.cat([pack_rows(codes), rand_u32(BATCH // 2 * nw).view(-1, nw)])
    lengths = torch.full((BATCH,), READ_LEN, dtype=torch.int32, device=dev)
    short = torch.randint(0, BATCH, (BATCH // 10,), device=dev, generator=g)
    lengths[short] = torch.randint(0, READ_LEN, (short.numel(),), dtype=torch.int32,
                                   device=dev, generator=g)
    del codes, short
    for q1s, width, md in (((10, 30, 50, 70, 90), WIDTH, 3), ((0, 3, 90), 13, 0)):
        kw = dict(width=width, min_dinuc=md)
        _compare(f"window_queries {q1s} width {width}",
                 window_queries.window_queries(rpacked, lengths, q1s, **kw),
                 window_queries.window_queries_torch(rpacked, lengths, q1s, **kw))
    kw = dict(width=WIDTH, min_dinuc=3)
    case("window_queries",
         lambda: window_queries.window_queries(rpacked, lengths, WINDOWS, **kw),
         lambda: window_queries.window_queries_torch(rpacked, lengths, WINDOWS, **kw),
         None, call_work("window_queries", (rpacked, lengths, WINDOWS), kw),
         f"rpacked ({BATCH}, {nw}) windows {WINDOWS} width {WIDTH}")
    stage_ab("window_queries",
             lambda: window_queries.window_queries(rpacked, lengths, WINDOWS, **kw),
             lambda: launch_windows(unstaged, rpacked, lengths, WINDOWS, **kw),
             lambda: window_queries.window_queries_torch(rpacked, lengths, WINDOWS, **kw))
    del rpacked, lengths
    # B5's branches, exact only, from the default and the unstaged build
    # (bulk-copied and loop-copied rows at the odd widths).
    for label, (rp, ln, q1s, width, md) in windows_branch_cases(dev, g).items():
        kw = dict(width=width, min_dinuc=md)
        twin = lambda: window_queries.window_queries_torch(rp, ln, q1s, **kw)
        exact(f"window_queries {label}",
              lambda: window_queries.window_queries(rp, ln, q1s, **kw), twin)
        _compare(f"unstaged window_queries {label}",
                 launch_windows(unstaged, rp, ln, q1s, **kw), twin())
    del rp, ln

    for name, r in out.items():
        lib = ("" if r["library_ms"] is None else f", one library call "
               f"{r['library_ms']:.3f} ms ({r['library_back_to_back_ms']:.3f} back to back)")
        print(f"kernel {name}: exact vs twin; {r['ms']:.3f} ms a call "
              f"({r['back_to_back_ms']:.3f} back to back; host {r['host_ms']:.4f} ms "
              f"a call over 100 unsynchronised calls; plain twin "
              f"{r['plain_ms']:.3f} ms{lib}; bound {r['bound_ms']:.3f} ms by "
              f"{r['bound_by']}: bytes {r['bytes_bound_ms']:.4f}, operations "
              f"{r['ops_bound_ms']:.4f}) at {r['shapes']}", flush=True)
    for name, r in extra.items():
        print(f"kernel {name}: exact vs twin; {r['ms']:.3f} ms a call "
              f"({r['back_to_back_ms']:.3f} back to back; index_select "
              f"{r['library_ms']:.3f} ms ({r['library_back_to_back_ms']:.3f} back to back); "
              f"bound {r['bound_ms']:.3f} ms) at {r['shapes']}", flush=True)
    print("kernel edge cases exact vs twin: " + "; ".join(edge), flush=True)
    print("staging A/B (ms a call, 10 back-to-back calls, median of 3, in turns; the "
          "unstaged variant exact vs twin): " + json.dumps(ab), flush=True)
    print("B2 and B6 with their variant builds (ms a call, 10 back-to-back calls, "
          "median of 3, in turns; every arm exact vs twin, the B6 variants on the "
          "branch cases too): " + json.dumps(exp_ab), flush=True)
    return out


def same_result(a, b) -> bool:
    import numpy as np

    return all(
        np.array_equal(getattr(a, f), getattr(b, f))
        for f in ("read_row", "gene", "start", "nmiss")
    )


def check_result(mr, rs, ts, cfg) -> None:
    """Retained rows are in range, in canonical order, and within budget."""
    import numpy as np

    from muscato_tpu_torch.ops.verify import mismatch_budget_table

    n = len(mr.read_row)
    check(n > 0, "no matches")
    check(mr.read_row.min() >= 0 and mr.read_row.max() < rs.num_unique, "read rows")
    check(mr.gene.min() >= 0 and mr.gene.max() < ts.num_genes, "genes")
    glen = np.diff(np.asarray(ts.gene_start))[mr.gene]
    rlen = rs.lengths[mr.read_row]
    check((mr.start >= 0).all() and (mr.start + rlen <= glen).all(), "starts")
    budget = mismatch_budget_table(cfg.PMatch, cfg.MaxReadLength)
    check((mr.nmiss >= 0).all() and (mr.nmiss <= budget[rlen]).all(), "nmiss budget")
    key = mr.read_row.astype(np.int64) * ts.num_genes + mr.gene
    order_ok = (np.diff(key) > 0) | ((np.diff(key) == 0) & (np.diff(mr.start) > 0))
    check(order_ok.all(), "canonical (read, gene, start) order")


def cpu_copy(index):
    """The same TargetIndex with its tensors on the CPU."""
    import dataclasses

    return dataclasses.replace(
        index, tpacked=index.tpacked.cpu(), gene_start=index.gene_start.cpu(),
        skeys=index.skeys.cpu(), spos=index.spos.cpu(), _aux=None, _trows=None,
        _gblock=None,
    )


def flagship_run(dev, cfg, rs, ts, index, path) -> tuple:
    """One counted, timed run of the flagship through run_matching_indexed:
    every launch counter is set to 0 just before it and read just after;
    fails unless each kernel of ``path`` launched.  The reads' device copy
    that an earlier single-batch run left on the ReadSet is dropped first,
    so that the run uploads them.  Returns (MatchResult, numbers)."""
    import torch

    from muscato_tpu_torch.engine import pipeline

    rs._dev_cache = None
    wr = wrappers()
    for fn in wr.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    timings = {}
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    mr = pipeline.run_matching_indexed(cfg, rs, index, timings=timings)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wr.items()}
    check(all(launches[k] > 0 for k in path), f"a kernel never launched: {launches}")
    check_result(mr, rs, ts, cfg)
    stages = timings["stages"]
    return mr, dict(
        reads=NUM_READ, unique_reads=rs.num_unique, matches=len(mr.read_row),
        pairs=timings["pairs"], wall_s=wall, reads_per_s=NUM_READ / wall,
        stage_s=stages, stages_sum_s=sum(stages.values()),
        host_read_prep_s=timings["read_prep_s"], host_fetch_s=timings["fetch_s"],
        loop_s=timings["device_s"],
        after_fetch_s=wall - timings["device_s"] - timings["fetch_s"],
        batches=timings["batches"],
        probe_kind=timings["probe_kind"],
        peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
        launches=launches, streaming_chunks=timings["chunks"],
    )


@contextlib.contextmanager
def recorded_calls():
    """Wrap the engine's kernel calls (CALL_POINTS) for a block.  Each call
    that launches a kernel appends {kernel, site, args, kw} to the yielded
    list: the launching wrapper (read off the launch counters), the
    caller's file:line and the arguments.  The hook calls the wrappers
    themselves, so their launch counts move as without it."""
    from muscato_tpu_torch.ops import fused, packed

    mods = {"fused": fused, "packed": packed}
    counters = wrappers()
    calls, saved = [], []

    class hook:
        """Calls ``orig`` and records the call.  Its ``launches`` is the
        wrapper's own: a wrapper hooked in its own module (B7) counts
        through that module's name, which then names the hook."""

        def __init__(self, orig):
            self.orig = orig

        launches = property(lambda self: self.orig.launches,
                            lambda self, n: setattr(self.orig, "launches", n))

        def __call__(self, *args, **kw):
            f = sys._getframe(1)
            before = {k: fn.launches for k, fn in counters.items()}
            res = self.orig(*args, **kw)
            site = f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}"
            calls.extend(dict(kernel=k, site=site, args=args, kw=kw)
                         for k, fn in counters.items() if fn.launches != before[k])
            return res

    for modname, attr in CALL_POINTS:
        mod = mods[modname]
        ref, _, name = attr.rpartition(".")
        if ref:
            # A stand-in for the referenced module, so that the wrapper's
            # own module (where it counts its launches) stays as it is.
            inner = getattr(mod, ref)
            saved.append((mod, ref, inner))
            setattr(mod, ref, types.SimpleNamespace(
                **{**vars(inner), name: hook(getattr(inner, name))}))
        else:
            saved.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, hook(getattr(mod, attr)))
    try:
        yield calls
    finally:
        # Last first: two call points that share a module reference (B8
        # and B9 through fused.sops) stand in for it in turn.
        for mod, attr, orig in reversed(saved):
            setattr(mod, attr, orig)


def stream_shape(idx) -> dict:
    """How an index stream walks its table of 4-byte entries: its lanes,
    those that step back from the lane before, and the distinct 128-byte
    lines (32 entries) and 32-byte sectors (8 entries) the stream
    touches."""
    import torch

    return dict(lanes=idx.numel(), step_backs=int((idx[1:] < idx[:-1]).sum()),
                lines_128b=int(torch.unique(idx >> 5).numel()),
                sectors_32b=int(torch.unique(idx >> 3).numel()))


def kernel_profile(dev, cfg, rs, index, unstaged=None, keep=None) -> dict:
    """One more flagship run on the path the switches select, after its
    warm-up, under torch.profiler: every device kernel's total time and
    launches by name,
    the device's busy share of the stage window (from the start of the
    first B5 launch, which opens the probe, to the start of the last
    device-to-host copy, the row fetch) and the device events (kernels and
    copies) that start in it, and, per call site of each of the
    port's kernels, launches, device time and the summed bound (bounds)
    of the launches' own inputs; for the postings fetch (the B3 launches
    that read the index's spos) also the shape of their index streams
    (stream_shape), summed over the launches; for B7 also the summed
    sector-aware bound (verify_sector_bytes) and, given ``unstaged`` (the
    -DMUSCATO_NO_STAGE library), the batch's B7 calls replayed on their
    own inputs through the staged kernel and the unstaged one in turns (ms
    a batch, each call timed alone).  Fails if the profile holds no device time,
    or if it counts other launches of a port kernel than the calls the
    hook recorded (a call site missing from CALL_POINTS).  The profiler
    can miss a launch now and then (on an H100 it once listed 3 of the 4
    B5 launches that the hook saw in a 4-batch run), so a run whose counts
    disagree is profiled again, up to PROFILE_TRIES runs in all; a missing
    call site disagrees in every one.  ``keep``, a dict, gets for each
    kernel it names the list of that kernel's recorded calls (their
    arguments), in order."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    from muscato_tpu_torch.bench import profile_match
    from muscato_tpu_torch.engine import pipeline

    pats = {k: re.compile(r"(?<![\w])" + sym + r"\b") for k, sym in SYMBOLS.items()}
    for attempt in range(1, PROFILE_TRIES + 1):
        torch.cuda.synchronize(dev)
        with recorded_calls() as calls, profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            pipeline.run_matching_indexed(cfg, rs, index)
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
        evs = profile_match.device_events(prof)
        check(evs, "the profiler recorded no device time")
        per_launch = {k: [(e.time_range.end - e.time_range.start) / 1e3
                          for e in evs if p.search(e.name)] for k, p in pats.items()}
        lost = {k: (len(v), sum(c["kernel"] == k for c in calls))
                for k, v in per_launch.items()}
        lost = {k: n for k, n in lost.items() if n[0] != n[1]}
        if not lost or attempt == PROFILE_TRIES:
            break
        print(f"kernel profile, run {attempt}: the profile's launches disagree with the "
              f"hook's calls (kernel: [profile, hook]) {json.dumps(lost)}; profiled again",
              flush=True)
    out = dict(source="torch.profiler", wall_s=wall, profile_runs=attempt)
    by_name = profile_match.kernel_table(evs, lambda n: next(
        (k for k, p in pats.items() if p.search(n)), profile_match.short_name(n)))
    starts = [e.time_range.start for e in evs if pats["window_queries"].search(e.name)]
    fetch = [e.time_range.start for e in evs if "DtoH" in e.name]
    w0 = starts[0] if starts else evs[0].time_range.start
    w1 = fetch[-1] if fetch and fetch[-1] > w0 else max(e.time_range.end for e in evs)
    busy, edge = 0.0, w0
    for e in evs:
        a, b = max(e.time_range.start, edge), min(e.time_range.end, w1)
        if b > a:
            busy += b - a
            edge = b
    out.update(window_ms=(w1 - w0) / 1e3, busy_ms=busy / 1e3,
               busy_share=busy / max(w1 - w0, 1e-9),
               window_events=sum(w0 <= e.time_range.start <= w1 for e in evs))
    out["kernels"] = {n: {"launches": c, "ms": ms} for i, (n, (c, ms))
                      in enumerate(by_name.items()) if n in SYMBOLS or i < 25}
    # PyTorch's elementwise kernels, all of them (the verify's body ran as
    # such passes before B7).
    elem = [c for n, c in by_name.items() if "elementwise" in n]
    out["elementwise"] = dict(launches=sum(c for c, _ in elem), ms=sum(ms for _, ms in elem))
    sites = {}
    for k in SYMBOLS:
        mine = [c for c in calls if c["kernel"] == k]
        check(len(per_launch[k]) == len(mine),
              f"{k}: the profile shows {len(per_launch[k])} launches, the hook "
              f"recorded {len(mine)} calls (a call site missing from CALL_POINTS?)")
        for c, ms in zip(mine, per_launch[k]):
            s = sites.setdefault((k, c["site"]), dict(
                kernel=k, site=c["site"], launches=0, shapes=set(), ms=0.0, bound_ms=0.0,
                bound_by=set()))
            s["launches"] += 1
            s["shapes"].add((int(c["args"][0].shape[0]), int(c["args"][1].shape[0])))
            s["ms"] += ms
            bound = bounds(call_work(k, c["args"], c["kw"]))
            s["bound_ms"] += bound["bound_ms"]
            s["bound_by"].add(bound["bound_by"])
            if k == "verify_diagonals_swar":
                s["sector_bound_ms"] = s.get("sector_bound_ms", 0.0) + verify_sector_bytes(
                    c["args"], c["kw"]["smax"]) / HBM_BYTES_PER_S * 1e3
            if k in ("verify_pairs", "monotone_gather"):
                nbytes = (pairs_sector_bytes(c["args"]) if k == "verify_pairs"
                          else gather_sector_bytes(*c["args"]))
                s["sector_bound_ms"] = (s.get("sector_bound_ms", 0.0)
                                        + nbytes / HBM_BYTES_PER_S * 1e3)
            if k == "monotone_gather" and c["args"][0].data_ptr() == index.spos.data_ptr():
                # Summed over the launches (one a chunk on the streaming path).
                shape = stream_shape(c["args"][1].clamp(0, index.spos.numel() - 1))
                post = out.setdefault("postings", dict(
                    site=c["site"], launches=0, ms=0.0, bound_ms=0.0, bytes_bound_ms=0.0,
                    ops_bound_ms=0.0, **{key: 0 for key in shape}))
                post["launches"] += 1
                post["ms"] += ms
                for key in ("bound_ms", "bytes_bound_ms", "ops_bound_ms"):
                    post[key] += bound[key]
                for key, val in shape.items():
                    post[key] += val
                post["sector_bound_ms"] = (post.get("sector_bound_ms", 0.0)
                                           + gather_sector_bytes(*c["args"])
                                           / HBM_BYTES_PER_S * 1e3)
    for k in keep or ():
        keep[k] = [c for c in calls if c["kernel"] == k]
    b7 = [c for c in calls if c["kernel"] == "verify_diagonals_swar"]
    if unstaged is not None and b7:
        ab = out["b7_staging_ab"] = {"staged": [], "unstaged": []}
        for order in ((None, unstaged), (unstaged, None), (None, unstaged)):
            for lib in order:
                ab["staged" if lib is None else "unstaged"].append(sum(
                    time_ms(lambda: launch_verify(lib, *c["args"], **c["kw"])) for c in b7))
    del calls, b7
    for s in sites.values():
        s["shapes"] = sorted(s["shapes"])  # (len of the first two arguments)
        s["bound_by"] = sorted(s["bound_by"])
        s["loss_ms"] = s["ms"] - s["bound_ms"]
    out["sites"] = sorted(sites.values(), key=lambda s: -s["loss_ms"])
    for k, key in (("monotone_gather", "b3"), ("monotone_gather_rows", "b4"),
                   ("verify_pairs", "b10")):
        mine = [s for s in out["sites"] if s["kernel"] == k]
        out[f"{key}_bound_ms"] = sum(s["bound_ms"] for s in mine)
        out[f"{key}_ms"] = sum(s["ms"] for s in mine)
        if k != "monotone_gather_rows":
            out[f"{key}_sector_bound_ms"] = sum(s.get("sector_bound_ms", 0.0) for s in mine)
    return out


def probe_ab(dev, cfg, rs, index) -> dict:
    """Probe stage of the flagship batch with B5 and with its plain twin in
    its place, in turns (B5, twin, twin, B5, ...): CUDA-event ms each."""
    import torch

    from muscato_tpu_torch.engine import pipeline
    from muscato_tpu_torch.ops import fused, window_queries

    l_eff = int(rs.lengths.max())
    rpacked, lengths = pipeline._device_read_batch(rs, 0, BATCH, l_eff, dev)
    q1s = tuple(cfg.Windows)
    out = {"b5": [], "twin": []}
    for arm in ("b5", "twin", "twin", "b5", "b5", "twin"):
        fused.window_queries = (window_queries.window_queries if arm == "b5"
                                else window_queries.window_queries_torch)
        try:
            out[arm].append(time_ms(lambda: fused._probe_windows_pjoin_impl(
                rpacked, lengths, q1s, index.skeys, width=cfg.WindowWidth,
                min_dinuc=cfg.MinDinuc), reps=3))
        finally:
            fused.window_queries = window_queries.window_queries
    return out


def lo_key_ab(dev, cfg, rs, index) -> dict:
    """Both probes' stage on the flagship batch, the sorted join and the
    sort-merge probe (MUSCATO_PJOIN=0), with the int32 (inactive, lo)
    compaction key that they sort below fused.PACKED_LO_LIMIT index
    windows and with the int64 key that they sort from there on (the limit
    set to 0 here), in turns (int32, int64, int64, int32, int32, int64):
    CUDA-event ms each, once the two keys' Probes are found equal."""
    import torch

    from muscato_tpu_torch.engine import pipeline
    from muscato_tpu_torch.ops import fused

    l_eff = int(rs.lengths.max())
    rpacked, lengths = pipeline._device_read_batch(rs, 0, BATCH, l_eff, dev)
    limits = {"int32": fused.PACKED_LO_LIMIT, "int64": 0}
    out = {}
    for probe, impl in (("sorted_join", fused._probe_windows_pjoin_impl),
                        ("sort_merge", fused._probe_windows_impl)):
        run = lambda: impl(rpacked, lengths, tuple(cfg.Windows), index.skeys,  # noqa: E731
                           width=cfg.WindowWidth, min_dinuc=cfg.MinDinuc)
        times, first = {arm: [] for arm in limits}, {}
        try:
            for arm in ("int32", "int64", "int64", "int32", "int32", "int64"):
                fused.PACKED_LO_LIMIT = limits[arm]
                if arm not in first:
                    first[arm] = run()
                times[arm].append(time_ms(run, reps=3))
        finally:
            fused.PACKED_LO_LIMIT = limits["int32"]
        check(all(torch.equal(a, b) for a, b in zip(first["int32"], first["int64"])),
              f"{probe} probe: the int64 key's Probe differs from the int32 key's")
        out[probe] = times
    return out


def probe_small_index(dev, cfg, rs, index) -> dict:
    """Probe stage of the flagship batch against a sorted prefix of the
    index far smaller than the K x R queries, where the sort-merge probe
    sorts few rows beyond the queries: CUDA-event ms of each probe, in
    turns (sorted join, sort-merge, sort-merge, sorted join)."""
    from muscato_tpu_torch.engine import pipeline
    from muscato_tpu_torch.ops import fused

    l_eff = int(rs.lengths.max())
    rpacked, lengths = pipeline._device_read_batch(rs, 0, BATCH, l_eff, dev)
    out = {}
    for v in (1 << 16, 1 << 20):
        skeys = index.skeys[:v]
        times = {"pjoin": [], "sort_merge": []}
        for arm in ("pjoin", "sort_merge", "sort_merge", "pjoin"):
            probe = (fused._probe_windows_pjoin_impl if arm == "pjoin"
                     else fused._probe_windows_impl)
            times[arm].append(time_ms(lambda: probe(
                rpacked, lengths, tuple(cfg.Windows), skeys,
                width=cfg.WindowWidth, min_dinuc=cfg.MinDinuc), reps=3))
        out[f"V={v}"] = times
    return out


# The search parity's runs, each with the one probe kernel it must launch.
SEARCH_PARITY_KERNEL = {"search_direct": "direct_probe", "search_binary": "binary_probe"}


def search_parity(cfg, sub, index, cpu_index, engine) -> tuple:
    """The PARITY_READS reads through probe="search" against the full
    index, in direct mode and in binary mode (forced while the aux is
    built), by engine_device_check: each cuda MatchResult must equal the
    sorted join's cpu run.  check_paths sets every launch counter to 0
    just before each run and reads it just after: the direct run must
    launch B8 and not B9, the binary run B9 and not B8, neither the sorted
    join.  Adds the two paths' verdicts to ``engine`` ({path: ok}) and
    prints all of them as ENGINE_RESULTS, and each aux's build seconds on
    the card, peak device memory and device bytes; returns ({mode: the
    cuda aux}, {path: its run's launches}), the index keeping the direct
    one."""
    import torch

    from muscato_tpu_torch.bench import engine_device_check

    out = engine_device_check.check_paths(cfg, sub, index, cpu_index,
                                          paths=tuple(SEARCH_PARITY_KERNEL))
    auxes, launches = {}, {}
    for path, run in out["runs"].items():
        engine[path] = run["ok"]
        check(run["ok"], f"engine_device_check {path}: {run['error'] or 'MatchResult differs'}")
        own = SEARCH_PARITY_KERNEL[path]
        other = ({*SEARCH_PARITY_KERNEL.values()} - {own}).pop()
        got = launches[path] = run["launches"]
        check(got[own] > 0 and got[other] == 0 and got["sorted_join"] == 0,
              f"search parity, {path}: launches {got}")
        aux = auxes[run["timings"]["probe_kind"]] = run["aux"]
        print(f"parity, search probe, {aux.mode} mode ({aux.bucket_bits} bucket bits"
              + (f", {aux.probe_steps} steps" if aux.mode == "binary" else "")
              + f"): aux built in {aux.build_s:.2f}s, {aux.nbytes} device bytes; "
              f"{len(run['result'].read_row)} matches identical to the sorted join's cpu run "
              f"({run['seconds']:.2f}s with the aux build); launches " + json.dumps(got),
              flush=True)
    print("ENGINE_RESULTS " + json.dumps(engine), flush=True)
    # Each aux built once more on its own, for its build's peak memory.
    for mode in ("direct", "binary"):
        index._aux = None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        aux = engine_device_check._build_aux(index, mode)
        peak = torch.cuda.max_memory_allocated() - base
        print(f"search aux, {mode} mode, built on the card: {aux.build_s:.4f}s, peak "
              f"{peak / 2**30:.3f} GiB above the {base / 2**30:.3f} GiB held before, "
              f"{aux.nbytes} bytes kept", flush=True)
        del aux
    index._aux = auxes["direct"]
    return auxes, launches


def probe_crossover(dev, cfg, rs, index, auxes) -> dict:
    """The probe stage (probe_windows) on each probe, the direct and the
    binary search probe and the sorted join, on the first CROSSOVER_DEPTH
    batches of each size in CROSSOVER_BATCHES against the full index:
    CUDA-event ms a batch (time_ms, reps 3), the arms in turns (reversed
    on every other batch)."""
    from muscato_tpu_torch.engine import pipeline
    from muscato_tpu_torch.ops import fused

    l_eff = int(rs.lengths.max())
    arms = {"direct": auxes["direct"], "binary": auxes["binary"], "sort": None}
    out = {}
    for size in CROSSOVER_BATCHES:
        times = {arm: [] for arm in arms}
        for i, b0 in enumerate(range(0, CROSSOVER_DEPTH * size, size)):
            rpacked, lengths = pipeline._device_read_batch(rs, b0, b0 + size, l_eff, dev)
            for arm in (list(arms) if i % 2 == 0 else list(arms)[::-1]):
                times[arm].append(time_ms(lambda: fused.probe_windows(
                    rpacked, lengths, tuple(cfg.Windows), index.skeys,
                    width=cfg.WindowWidth, min_dinuc=cfg.MinDinuc,
                    index_aux=arms[arm]), reps=3))
        out[f"ReadBatch={size}"] = dict(
            queries=len(WINDOWS) * size,
            auto="search" if index.skeys.shape[0] > 64 * len(WINDOWS) * size else "sort",
            **{arm: dict(median_ms=statistics.median(t), ms=t) for arm, t in times.items()})
    return out


def probe_stage_split(dev, cfg, rs, index, auxes, size) -> dict:
    """The probe stage of the flagship's first ``size`` reads cut into its
    parts, each timed alone on the inputs the part before it made
    (time_ms, back to back): for the direct and the binary search probe
    B5, the (key1, key2) int64 key and its stable sort, the three query
    gathers into sorted order, the kernel (B8 or B9), and the (inactive,
    loc) int64 sort with its gathers (fused._compact_lo_order); for the
    sorted join B5, the key1 int32 sort, the qid gather, B1 and the
    (inactive, lo) int32 sort with its gathers; each beside the whole
    stage (fused.probe_windows)."""
    import torch

    from muscato_tpu_torch.engine import pipeline
    from muscato_tpu_torch.engine.index import DIRECT_BUCKET_WIDTH
    from muscato_tpu_torch.ops import fused, search as sops, windows as winops
    from muscato_tpu_torch.ops import join as tjoin
    from muscato_tpu_torch.ops.packed import u64

    l_eff = int(rs.lengths.max())
    rpacked, lengths = pipeline._device_read_batch(rs, 0, size, l_eff, dev)
    q1s, width = tuple(cfg.Windows), cfg.WindowWidth
    wq = dict(width=width, min_dinuc=cfg.MinDinuc)
    use_k2 = winops.uses_second_key(width)
    b2b = lambda f: time_ms(f, inner=10)  # noqa: E731
    keyf0, key2f0, validf0 = fused.window_queries(rpacked, lengths, q1s, **wq)
    out = {}
    _, order = torch.sort(fused._key_u(u64(keyf0), u64(key2f0)), stable=True)
    keyf, key2f, validf = keyf0[order], key2f0[order], validf0[order]
    qid = order.to(torch.int32)
    for mode in ("direct", "binary"):
        aux = auxes[mode]
        if mode == "direct":
            args = (keyf, key2f, validf, aux.urec, aux.sbucket)
            kw = dict(upshift=aux.upshift, bucket_bits=aux.bucket_bits,
                      bucket_width=DIRECT_BUCKET_WIDTH, use_k2=use_k2)
        else:
            args = (keyf, key2f, validf, aux.ukeys, aux.ukeys2, aux.ukk, aux.ustart,
                    aux.ucount, aux.sbucket)
            kw = dict(upshift=aux.upshift, bucket_bits=aux.bucket_bits,
                      probe_steps=aux.probe_steps, use_k2=use_k2)
        kernel = f"{mode}_probe"
        counts, loc = launch_probe(kernel, None, args, kw)
        parts = {
            "window_queries (B5)": b2b(lambda: fused.window_queries(rpacked, lengths, q1s, **wq)),
            "(key1, key2) int64 key and stable sort": b2b(lambda: torch.sort(
                fused._key_u(u64(keyf0), u64(key2f0)), stable=True)),
            "three query gathers": b2b(lambda: (keyf0[order], key2f0[order],
                                                validf0[order], order.to(torch.int32))),
            f"{kernel} ({'B8' if mode == 'direct' else 'B9'})": b2b(
                lambda: launch_probe(kernel, None, args, kw)),
            "(inactive, loc) int64 sort and its gathers": b2b(
                lambda: fused._compact_lo_order(loc, counts, qid, keyf0, key2f0)),
        }
        out[mode] = dict(parts=parts, parts_sum=sum(parts.values()), stage=b2b(
            lambda: fused.probe_windows(rpacked, lengths, q1s, index.skeys, **wq,
                                        index_aux=aux)))
    del keyf, key2f, validf, qid, counts, loc, order
    ks_flip, order = torch.sort(tjoin.flip(keyf0))
    keys = tjoin.flip(ks_flip)
    lo_m, counts_m, _ = tjoin.sorted_join(index.skeys, keys)
    qid_pay = torch.where(validf0, torch.arange(keyf0.numel(), dtype=torch.int32,
                                                device=dev), -1)
    packed_key = ((counts_m == 0).to(torch.int32) << 30) | lo_m.clamp(0, (1 << 30) - 1)
    parts = {
        "window_queries (B5)": b2b(lambda: fused.window_queries(rpacked, lengths, q1s, **wq)),
        "key1 int32 sort": b2b(lambda: torch.sort(tjoin.flip(keyf0))),
        "qid gather": b2b(lambda: qid_pay[order]),
        "sorted_join (B1)": b2b(lambda: tjoin.sorted_join(index.skeys, keys)),
        "(inactive, lo) int32 sort and its gathers": b2b(lambda: (
            lambda o: (counts_m[o[1]], qid_pay[o[1]]))(torch.sort(packed_key))),
    }
    out["sorted_join"] = dict(parts=parts, parts_sum=sum(parts.values()), stage=b2b(
        lambda: fused.probe_windows(rpacked, lengths, q1s, index.skeys, **wq)))
    return out


def binary_batch_profile(dev, cfg, rs, index, aux) -> list:
    """kernel_profile of one binary-mode batch: the flagship's first
    SMALL_BATCH reads as one batch with the binary aux in the index's
    place (the engine picks the search probe, as the 16-batch flagship
    does, and the aux's mode selects B9).  Returns B9's sites."""
    import dataclasses

    from muscato_tpu_torch.engine import pipeline
    from muscato_tpu_torch.io.reads import ReadSet

    sub = ReadSet(codes=rs.codes[:SMALL_BATCH], lengths=rs.lengths[:SMALL_BATCH],
                  counts=rs.counts[:SMALL_BATCH], num_total=SMALL_BATCH)
    cfg_b = dataclasses.replace(cfg, ReadBatch=SMALL_BATCH)
    saved, index._aux = index._aux, aux
    try:
        timings = {}
        pipeline.run_matching_indexed(cfg_b, sub, index, timings=timings)
        check(timings["probe_kind"] == "binary", f"binary batch: {timings['probe_kind']}")
        sub._dev_cache = None  # the profiled run uploads its reads, as a user's run does
        prof = kernel_profile(dev, cfg_b, sub, index)
    finally:
        index._aux = saved
    sites = [s for s in prof["sites"] if s["kernel"] == "binary_probe"]
    check(sum(s["launches"] for s in sites) == 1, f"binary batch: B9's sites {sites}")
    return sites


def probe_floor(kernel: str, args, kw) -> tuple:
    """A plain gather of the table sectors that any exact B8 or B9 must
    read, one int32 word from each distinct 32-byte sector, by index_select
    with int32 indices computed ahead into outputs allocated ahead, so that
    no load waits on another and nothing else runs: the sectors of the
    queries' bucket bounds; B8's of each query's bucket records (at most
    bucket_width); B9's of the key pairs on either side of each valid
    query's insertion point inside its bucket (which prove it) and of the
    hits' (start, count) pairs.  The query arrays and the outputs, which
    the kernels stream, are left out.  Returns (the function to time, the
    sectors it reads, the bytes it moves: 32 a sector, its 4-byte output
    word and its index, 4 bytes, 8 for a table past 2^31 words)."""
    import torch

    from muscato_tpu_torch.ops import search as sops

    keyf, key2f, validf, *tables = args
    sbucket = tables[-1]
    b = sops.bucket_of(keyf, kw["upshift"], kw["bucket_bits"])
    lo, hi = sbucket[b].long(), sbucket[b + 1].long()
    spans = [(sbucket, sector_ids(b * 4, 8))]
    if kernel == "direct_probe":
        nb = (hi - lo).clamp(0, kw["bucket_width"])
        spans.append((tables[0], sector_ids(lo * 16, nb * 16)))
    else:
        ukeys, ukeys2, ukk, ustart = tables[:4]
        p = sops.searchsorted2_bucketed(  # the insertion point, inside [lo, hi]
            ukeys, ukeys2, keyf, key2f, sbucket, upshift=kw["upshift"],
            steps=kw["probe_steps"], use_k2=kw["use_k2"], bucket_bits=kw["bucket_bits"])
        below = validf & (p > lo)
        above = validf & (p < hi)
        at = torch.cat([p[below] - 1, p[above]])
        q = packed_keys(keyf[above], key2f[above], kw["use_k2"])
        hits = p[above][packed_keys(ukeys[p[above]], ukeys2[p[above]], kw["use_k2"]) == q]
        pairs = ustart.as_strided((2 * ukeys.numel(),), (1,))
        spans += [(ukk, sector_ids(at * 8, 8)), (pairs, sector_ids(hits * 8, 8))]
    gathers = []
    for table, sec in spans:
        # The sector's first int32 word; int64 only past 2^31 words.
        idx = (sec * 8).to(torch.int32 if table.numel() < 2**31 else torch.int64)
        gathers.append((table.view(-1), idx, table.new_empty(idx.numel())))
    sectors = sum(idx.numel() for _, idx, _ in gathers)

    def run():
        for table, idx, out in gathers:
            torch.index_select(table, 0, idx, out=out)

    return run, sectors, sum((36 + idx.element_size()) * idx.numel() for _, idx, _ in gathers)


def launch_probe(kernel: str, lib, args, kw):
    """B8 or B9 of the kernel library ``lib`` (the -DMUSCATO_NO_STAGE build;
    None the default library) on a wrapper's arguments, launched as the
    wrapper launches it, counting nothing."""
    from muscato_tpu_torch.ops import search as sops

    if kernel == "direct_probe":
        return sops._launch_direct(*args, **kw, lib=lib)
    keyf, key2f, validf, ukeys, _, ukk, ustart, _, sbucket = args
    return sops._launch_binary(keyf, key2f, validf, ukk, ustart, ukeys.numel(), sbucket,
                               **kw, lib=lib)


def probe_builds(unstaged) -> dict:
    """{label: kernel library} of the builds of csrc/probe.cu: the default
    one (None) and, given, the -DMUSCATO_NO_STAGE one."""
    return {"default build": None,
            **({"one thread a query (-DMUSCATO_NO_STAGE)": unstaged} if unstaged else {})}


def probe_builds_in_turns(kernel: str, args, kw, unstaged) -> dict:
    """The default build's B8 or B9 and, given ``unstaged``, the
    -DMUSCATO_NO_STAGE build's (the first design), each exact against the
    twin on ``args``, then timed in turns (one call and back to back, three
    turns, the second in reverse order).  Returns {build: {"ms": [...],
    "back_to_back_ms": [...]}}."""
    from muscato_tpu_torch.ops import search as sops

    twin = {"direct_probe": sops.direct_probe_torch,
            "binary_probe": sops.binary_probe_torch}[kernel]
    builds = probe_builds(unstaged)
    exp = twin(*args, **kw)
    for label, lib in builds.items():
        _compare(f"{kernel} {label}", launch_probe(kernel, lib, args, kw), exp)
    del exp
    turns = {}
    for order in (list(builds), list(builds)[::-1], list(builds)):
        for label in order:
            f = functools.partial(launch_probe, kernel, builds[label], args, kw)
            t = turns.setdefault(label, {"ms": [], "back_to_back_ms": []})
            t["ms"].append(time_ms(f))
            t["back_to_back_ms"].append(time_ms(f, inner=10))
    return turns


def binary_args(aux, keyf, key2f, validf, use_k2) -> tuple:
    """B9's wrapper arguments for the sorted queries against a binary aux."""
    return ((keyf, key2f, validf, aux.ukeys, aux.ukeys2, aux.ukk, aux.ustart, aux.ucount,
             aux.sbucket),
            dict(upshift=aux.upshift, bucket_bits=aux.bucket_bits,
                 probe_steps=aux.probe_steps, use_k2=use_k2))


def sorted_query_arrays(k1, k2, use_k2) -> tuple:
    """(keyf, key2f, validf) of the int32 key words k1, k2 sorted by (key1,
    key2) as uint32, every query valid, as the main path gives B9 its
    queries."""
    import torch

    order = torch.argsort(packed_keys(k1, k2, use_k2))
    keyf, key2f = k1[order].contiguous(), k2[order].contiguous()
    return keyf, key2f, torch.ones_like(keyf, dtype=torch.bool)


def native_binary_b9(label: str, aux, keyf, key2f, validf, use_k2, unstaged) -> dict:
    """B9 on a binary aux that took that mode on its own: both builds exact
    and in turns (probe_builds_in_turns), beside PR 13's sector bound and
    the floor; printed and returned."""
    args, kw = binary_args(aux, keyf, key2f, validf, use_k2)
    floor, sectors, nbytes = probe_floor("binary_probe", args, kw)
    out = dict(queries=keyf.numel(), unique_keys=aux.ukeys.numel(),
               bucket_bits=aux.bucket_bits, probe_steps=aux.probe_steps,
               sector_bound_ms=probe_sector_bytes("binary_probe", args, kw)
               / HBM_BYTES_PER_S * 1e3,
               floor_ms=time_ms(floor, inner=10), floor_sectors=sectors, floor_bytes=nbytes,
               builds_in_turns=probe_builds_in_turns("binary_probe", args, kw, unstaged))
    print(f"B9 on {label} (binary on its own), each build exact vs twin: " + json.dumps(out),
          flush=True)
    return out


def probe_kernel_phase(dev, cfg, rs, auxes, unstaged=None) -> dict:
    """B8 and B9 (csrc/probe.cu) at the main path's shape: the sorted
    queries of the flagship's first SMALL_BATCH reads (4 windows x 262,144
    = 1,048,576, as the 16-batch flagship's first batch gives them to B8)
    against the full index's direct aux (B8) and its binary aux (B9, forced
    as search_parity forces it), each exact against its twin on every
    query and measured (measure_case; the library call: torch.searchsorted
    of the packed queries into the aux's unique keys packed into int64,
    packed outside the timed window, which finds the same insertion
    points), beside its sector bound and its floor (probe_floor, back to
    back); then the default and, given ``unstaged``, the
    -DMUSCATO_NO_STAGE build (the first design's one-thread kernels) in
    turns (probe_builds_in_turns); then both builds exact against the twins
    on the branch cases of tests/probe_cases.py.  Returns {name:
    measure_case numbers, with floor_ms, floor_sectors, floor_bytes and
    builds_in_turns}."""
    import torch

    from muscato_tpu_torch.engine import pipeline
    from muscato_tpu_torch.engine.index import DIRECT_BUCKET_WIDTH
    from muscato_tpu_torch.ops import fused, search as sops, windows as winops

    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "probe_cases", os.path.join(ROOT, "tests", "probe_cases.py"))
    probe_cases = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe_cases)

    l_eff = int(rs.lengths.max())
    rpacked, lengths = pipeline._device_read_batch(rs, 0, SMALL_BATCH, l_eff, dev)
    _, (keyf, key2f, validf, _) = fused._sorted_queries(
        rpacked, lengths, tuple(cfg.Windows), width=cfg.WindowWidth, min_dinuc=cfg.MinDinuc)
    del rpacked, lengths
    use_k2 = winops.uses_second_key(cfg.WindowWidth)
    query = packed_keys(keyf, key2f, use_k2)
    kernels = {"direct": (sops.direct_probe, sops.direct_probe_torch),
               "binary": (sops.binary_probe, sops.binary_probe_torch)}
    out = {}
    for mode, (fn, twin) in kernels.items():
        aux = auxes[mode]
        name = fn.__name__
        if mode == "direct":
            args = (keyf, key2f, validf, aux.urec, aux.sbucket)
            kw = dict(upshift=aux.upshift, bucket_bits=aux.bucket_bits,
                      bucket_width=DIRECT_BUCKET_WIDTH, use_k2=use_k2)
            rec = aux.urec.view(-1, 4)[:-DIRECT_BUCKET_WIDTH]
            ent = packed_keys(rec[:, 0], rec[:, 1], use_k2)
            shape = f"{aux.bucket_bits} bucket bits, {rec.shape[0]} unique keys"
        else:
            args, kw = binary_args(aux, keyf, key2f, validf, use_k2)
            ent = packed_keys(aux.ukeys, aux.ukeys2, use_k2)
            shape = (f"{aux.bucket_bits} bucket bits, {aux.probe_steps} steps, "
                     f"{ent.numel()} unique keys")
        res = out[name] = measure_case(
            name, lambda: fn(*args, **kw), lambda: twin(*args, **kw),
            lambda: torch.searchsorted(ent, query), call_work(name, args, kw),
            f"{keyf.numel()} sorted queries ({int(validf.sum())} valid) against the "
            f"flagship's {mode} aux: {shape}")
        del ent
        res["sector_bound_ms"] = probe_sector_bytes(name, args, kw) / HBM_BYTES_PER_S * 1e3
        floor, res["floor_sectors"], res["floor_bytes"] = probe_floor(name, args, kw)
        res["floor_ms"] = time_ms(floor, inner=10)
        del floor
        res["builds_in_turns"] = probe_builds_in_turns(name, args, kw, unstaged)
        r = res
        print(f"kernel {name}: exact vs twin; {r['ms']:.4f} ms a call ({r['back_to_back_ms']:.4f} "
              f"back to back; host {r['host_ms']:.4f} ms a call over 100 unsynchronised "
              f"calls; plain twin {r['plain_ms']:.3f} ms; torch.searchsorted "
              f"{r['library_ms']:.4f} ms ({r['library_back_to_back_ms']:.4f} back to back); "
              f"bound {r['bound_ms']:.4f} ms by {r['bound_by']}: bytes "
              f"{r['bytes_bound_ms']:.4f}, operations {r['ops_bound_ms']:.4f}; by its 32-byte "
              f"sectors {r['sector_bound_ms']:.4f}; floor, index_select of a word of each of "
              f"the {r['floor_sectors']} table sectors any exact probe reads "
              f"({r['floor_bytes']} bytes), {r['floor_ms']:.4f} back to back) at {r['shapes']}; "
              f"builds, each exact vs twin, in turns (ms): {json.dumps(r['builds_in_turns'])}",
              flush=True)
    edge = []
    libs = probe_builds(unstaged)
    for label, (mode, aux, width, q) in probe_cases.cases(SEED, 4).items():
        args, kw = probe_cases.probe_args(mode, aux, width, q)
        fn, twin = kernels[mode]
        exp = twin(*args, **kw)
        dargs = probe_cases.to_device(mode, args, dev)
        _compare(f"{fn.__name__} {label}", tuple(t.cpu() for t in fn(*dargs, **kw)), exp)
        for build, lib in libs.items():
            _compare(f"{fn.__name__} {label}, {build}", tuple(
                t.cpu() for t in launch_probe(fn.__name__, lib, dargs, kw)), exp)
        edge.append(f"{fn.__name__} {label} ({q[0].numel()} queries)")
    print(f"probe kernel branch cases exact vs twin, every build ({', '.join(libs)}): "
          + "; ".join(edge), flush=True)
    return out


def batched_flagships(dev, cfg, rs, ts, index, mr) -> tuple:
    """The flagship in SMALL_BATCH batches (16; the engine must pick the
    direct probe) and in MULTI_BATCH batches (4, sorted join) with the next
    batch's probe queued ahead and without (MUSCATO_PREFETCH_PROBE=0; the
    upload goes ahead in both), in turns: each a warm-up, then counted and timed runs whose
    MatchResult must equal the one-batch flagship's ``mr`` (each read lies
    in one batch, and MaxMatches does not bind).  One profile of each
    multi-batch arm gives the device's busy share of the loop window.
    Returns the counted small-batch and prefetching multi-batch runs'
    numbers."""
    import dataclasses

    from muscato_tpu_torch.engine import pipeline

    cfg_sb = dataclasses.replace(cfg, ReadBatch=SMALL_BATCH)
    pipeline.run_matching_indexed(cfg_sb, rs, index)
    mr_sb, flag_sb = flagship_run(dev, cfg_sb, rs, ts, index, SEARCH_PATH)
    check(same_result(mr_sb, mr), "small-batch flagship MatchResult differs")
    check(flag_sb["probe_kind"] == "direct" and flag_sb["launches"]["sorted_join"] == 0,
          f"small-batch flagship took the {flag_sb['probe_kind']} probe")
    check(flag_sb["launches"]["direct_probe"] == flag_sb["batches"] == -(-NUM_READ // SMALL_BATCH),
          f"small-batch flagship: B8 launched {flag_sb['launches']['direct_probe']} times "
          f"over {flag_sb['batches']} batches")
    prof = kernel_profile(dev, cfg_sb, rs, index)
    print(f"flagship in batches of {SMALL_BATCH} reads (auto-selected probe): "
          + json.dumps(flag_sb) + "; profile " + json.dumps({k: prof[k] for k in (
              "wall_s", "window_ms", "busy_ms", "busy_share")}) + "; B8's sites "
          + json.dumps([s for s in prof["sites"] if s["kernel"] == "direct_probe"]),
          flush=True)

    cfg_mb = dataclasses.replace(cfg, ReadBatch=MULTI_BATCH)
    arms = {"prefetch": "1", "no_prefetch": "0"}
    for value in arms.values():
        with switched(MUSCATO_PREFETCH_PROBE=value):
            pipeline.run_matching_indexed(cfg_mb, rs, index)
    runs = {arm: [] for arm in arms}
    for arm in ("prefetch", "no_prefetch", "no_prefetch", "prefetch"):
        with switched(MUSCATO_PREFETCH_PROBE=arms[arm]):
            mr_mb, flag_mb = flagship_run(dev, cfg_mb, rs, ts, index, DEFAULT_PATH)
        check(same_result(mr_mb, mr), f"multi-batch flagship ({arm}) MatchResult differs")
        check(flag_mb["batches"] == -(-NUM_READ // MULTI_BATCH)
              and flag_mb["probe_kind"] == "sorted_join", "multi-batch flagship shape")
        runs[arm].append(flag_mb)
    for arm, value in arms.items():
        with switched(MUSCATO_PREFETCH_PROBE=value):
            prof = kernel_profile(dev, cfg_mb, rs, index)
        keep = ("wall_s", "reads_per_s", "host_read_prep_s", "host_fetch_s", "loop_s",
                "after_fetch_s", "stage_s", "stages_sum_s")
        print(f"flagship in batches of {MULTI_BATCH} reads, {arm} (MUSCATO_PREFETCH_PROBE="
              f"{value}): runs " + json.dumps([{k: r[k] for k in keep} for r in runs[arm]])
              + "; profile " + json.dumps({k: prof[k] for k in (
                  "wall_s", "window_ms", "busy_ms", "busy_share")}), flush=True)
    print(f"flagship in batches of {MULTI_BATCH} reads, prefetch, launches and the rest: "
          + json.dumps(runs["prefetch"][-1]), flush=True)
    # The host's share after the fetch: the cross-batch cap and rank over
    # the union of the batches' rows, each timed on its own.
    rows, _ = pipeline.run_matching_indexed(cfg_mb, rs, index, _defer_rank=True)
    t0 = time.perf_counter()
    capped = pipeline._apply_max_matches(cfg_mb, *(rows[:, i] for i in range(rows.shape[1])))
    t1 = time.perf_counter()
    ranked = pipeline._dedup_and_rank(cfg_mb, *capped)
    t2 = time.perf_counter()
    check(same_result(ranked, mr), "multi-batch union rank differs")
    print(f"flagship in batches of {MULTI_BATCH} reads, the host's union of {len(rows)} rows: "
          f"cap {t1 - t0:.3f}s, dedup and rank {t2 - t1:.3f}s", flush=True)
    return flag_sb, runs["prefetch"][-1]


def runner_phase(dev, cfg, rs, ts, mr) -> None:
    """The benchmark runner's twin: _bench_one on the flagship arrays
    (its own index build, RUNNER_REPEATS timed repetitions), whose detail
    is printed; then its entry point, main(RUNNER_SMALL), on the card,
    whose one JSON line must name reads_per_sec_chip."""
    import contextlib
    import io

    from muscato_tpu_torch.bench import runner

    t0 = time.perf_counter()
    res = runner._bench_one(cfg, rs, ts, NUM_READ, RUNNER_REPEATS, dev)
    detail = runner._detail(res)
    check(res.probe_kind == "sorted_join" and res.matches > 0, "runner twin on the flagship")
    print(f"runner twin, _bench_one on the flagship ({time.perf_counter() - t0:.1f}s): "
          + json.dumps(detail), flush=True)
    out = io.StringIO()
    t0 = time.perf_counter()
    with switched(MUSCATO_BENCH_LOG="0"), contextlib.redirect_stdout(out):
        rc = runner.main(RUNNER_SMALL)
    lines = out.getvalue().strip().splitlines()
    check(rc == 0 and len(lines) == 1, f"runner main printed {len(lines)} lines")
    line = json.loads(lines[0])
    check(line["metric"] == "reads_per_sec_chip" and line["value"] > 0,
          f"runner main: {line['metric']} {line['value']}")
    print(f"runner twin, main({' '.join(RUNNER_SMALL)}) ({time.perf_counter() - t0:.1f}s): "
          + lines[0], flush=True)


def mesh_run(dev, cfg, rs, ts, shard, mesh, path) -> tuple:
    """One counted, timed run_matching_sharded on this rank: every launch
    counter is set to 0 just before it and read just after; fails unless
    each kernel of ``path`` launched here, and on rank 0 unless the
    MatchResult passes check_result.  The ranks meet at a barrier first,
    so that no rank's time holds its wait for rank 0's host rank of the
    run before.  Returns (MatchResult, numbers)."""
    import torch
    import torch.distributed as tdist

    from muscato_tpu_torch.parallel import mesh as pmesh

    wr = wrappers()
    for fn in wr.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    timings = {}
    torch.cuda.synchronize(dev)
    tdist.barrier(group=mesh.host_group)
    t0 = time.perf_counter()
    mr = pmesh.run_matching_sharded(cfg, rs, shard, mesh, timings=timings)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wr.items()}
    check(all(launches[k] > 0 for k in path),
          f"rank {mesh.rank}: a kernel never launched: {launches}")
    if mesh.rank == 0:
        check_result(mr, rs, ts, cfg)
    return mr, dict(
        wall_s=wall, matches=len(mr.read_row), stage_s=timings["stages"],
        **{k: timings[k] for k in ("pack_s", "upload_s", "device_s", "fetch_s",
                                   "allgather_s", "allgather_bytes", "gather_s",
                                   "gather_bytes", "batches")},
        peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2**30, launches=launches,
    )


def mesh_one_phase(dev, cfg, rs, ts, index, mr) -> None:
    """run_matching_sharded over a 1x1 mesh of this process on NCCL (a
    world of one: the all-gather runs on NCCL over a group of one), its
    one shard built by shard_targets; a warm-up, then the mesh and the
    plain run_matching_indexed on the flagship in turns (mesh, plain,
    plain, mesh), each counted, timed and equal to the flagship's ``mr``;
    then bench/scaling.py's ``measure`` on the flagship in the same
    world (its 1x1 reads/s)."""
    import torch.distributed as tdist

    from muscato_tpu_torch.bench import scaling
    from muscato_tpu_torch.bench.scaling import free_port
    from muscato_tpu_torch.parallel import dist as pdist
    from muscato_tpu_torch.parallel import mesh as pmesh

    pdist.initialize(f"localhost:{free_port()}", 1, 0, device=dev)
    try:
        check(tdist.get_backend() == "nccl", f"1x1 mesh backend {tdist.get_backend()}")
        mesh = pmesh.make_mesh(1, 1, dev)
        t0 = time.perf_counter()
        shard = pmesh.shard_targets(ts, WIDTH, 1, 0, dev)
        build_s = time.perf_counter() - t0
        pmesh.run_matching_sharded(cfg, rs, shard, mesh)
        runs = {"mesh": [], "plain": []}
        for arm in ("mesh", "plain", "plain", "mesh"):
            if arm == "mesh":
                got, num = mesh_run(dev, cfg, rs, ts, shard, mesh, DEFAULT_PATH)
            else:
                got, num = flagship_run(dev, cfg, rs, ts, index, DEFAULT_PATH)
            check(same_result(got, mr), f"1x1 mesh phase: the {arm} MatchResult differs")
            runs[arm].append(num)
        print(f"1x1 mesh on NCCL: {len(mr.read_row)} matches, identical to the flagship; "
              f"shard index built on the card in {build_s:.2f}s "
              f"{json.dumps(shard.index.build_timings)}; wall s in turns: mesh "
              + json.dumps([r["wall_s"] for r in runs["mesh"]]) + ", plain "
              + json.dumps([r["wall_s"] for r in runs["plain"]]) + "; the last mesh run: "
              + json.dumps(runs["mesh"][-1]), flush=True)
        del shard
        t0 = time.perf_counter()
        rows = scaling.measure(cfg, rs, ts, dev, 2, log=lambda *a, **k: None)
        check([r["mesh"] for r in rows] == ["1x1"] and rows[0]["reads_per_sec"] > 0,
              f"scaling: {rows}")
        print(f"scaling.measure on the flagship in this world of one on NCCL "
              f"({time.perf_counter() - t0:.1f}s, its shard built, a warm-up, the best of 2): "
              + json.dumps(rows[0]), flush=True)
    finally:
        tdist.destroy_process_group()


def mesh_rank(rank: int, port: int, work: str, device: str) -> None:
    """One rank of the 2x2 mesh on the shared card (``--mesh-rank``):
    gloo, half the gene set, half of each batch.  It memory-maps the
    flagship arrays the parent wrote, builds its shard, and runs a
    warm-up, then counted runs of the flagship, of the PARITY_READS reads
    under both switches, and of them with NoDedup; it writes rank 0's
    MatchResults and its own numbers into ``work``."""
    import dataclasses

    import numpy as np
    import torch

    from muscato_tpu_torch.io.reads import ReadSet
    from muscato_tpu_torch.io.targets import TargetSet
    from muscato_tpu_torch.parallel import dist as pdist
    from muscato_tpu_torch.parallel import mesh as pmesh

    torch.set_num_threads(2)  # the ranks share the host's cores
    pdist.initialize(f"localhost:{port}", MESH_RANKS, rank, backend="gloo", device=device)
    import torch.distributed as tdist

    try:
        mesh = pmesh.make_mesh(MESH_DP, MESH_MP, device)
        dev = mesh.device
        a = {k: np.load(os.path.join(work, f"{k}.npy"), mmap_mode="r")
             for k in ("codes", "lengths", "counts", "tcat", "gene_start")}
        rs = ReadSet(codes=a["codes"], lengths=a["lengths"], counts=a["counts"],
                     num_total=NUM_READ)
        ngenes = len(a["gene_start"]) - 1
        ts = TargetSet(tcat=a["tcat"], gene_start=a["gene_start"],
                       names=[b""] * ngenes, lengths=np.diff(a["gene_start"]))
        t0 = time.perf_counter()
        shard = pmesh.shard_targets(ts, WIDTH, MESH_MP, mesh.m, dev)
        stats = dict(rank=rank, d=mesh.d, m=mesh.m, genes=list(shard.genes),
                     index_build_s=time.perf_counter() - t0,
                     index_build_detail=shard.index.build_timings)
        cfg = config()
        pmesh.run_matching_sharded(cfg, rs, shard, mesh)
        n = PARITY_READS
        sub = ReadSet(codes=a["codes"][:n], lengths=a["lengths"][:n], counts=a["counts"][:n],
                      num_total=n)
        results = {}
        results["flagship"], stats["flagship"] = mesh_run(dev, cfg, rs, ts, shard, mesh,
                                                         DEFAULT_PATH)
        with switched(**SWITCHES):
            results["switched"], stats["switched"] = mesh_run(dev, cfg, sub, ts, shard, mesh,
                                                             SWITCHED_PATH)
        results["NoDedup"], stats["NoDedup"] = mesh_run(
            dev, dataclasses.replace(cfg, NoDedup=True), sub, ts, shard, mesh, STREAM_PATH)
        if rank == 0:
            for k, mr in results.items():
                np.savez(os.path.join(work, f"result_{k}.npz"), read_row=mr.read_row,
                         gene=mr.gene, start=mr.start, nmiss=mr.nmiss)
        with open(os.path.join(work, f"stats_{rank}.json"), "w") as f:
            json.dump(stats, f)
    finally:
        tdist.destroy_process_group()


def wait_ranks(procs, logs, timeout: float) -> None:
    """Wait for every rank; when one fails or the time is up, kill the
    others and fail with the failing rank's log."""
    deadline = time.monotonic() + timeout
    while True:
        codes = [p.poll() for p in procs]
        bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
        late = time.monotonic() > deadline
        if bad or late:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            r = bad[0] if bad else 0
            with open(logs[r]) as f:
                tail = f.read()[-4000:]
            raise RuntimeError(
                f"chip_smoke check failed: mesh rank {r} "
                f"{'exited ' + str(codes[r]) if bad else 'passed the time limit'}:\n{tail}")
        if all(c == 0 for c in codes):
            return
        time.sleep(0.5)


def mesh_ranks_phase(dev, rs, ts, mr, got, got_nd) -> dict:
    """The 2x2 mesh on the one card: MESH_RANKS processes of this script
    (``--mesh-rank``), gloo by choice, each holding half the gene set and
    half of each batch.  This process writes the flagship arrays once for
    them to memory-map.  Rank 0's flagship MatchResult must equal ``mr``,
    and its results on the PARITY_READS reads under both switches and
    with NoDedup must equal the single-device runs of the same reads
    (``got``, ``got_nd``); every kernel of each path must have launched on
    every rank.  Prints each rank's numbers; returns rank 0's launches on
    the flagship (B6's from its switched run)."""
    import numpy as np
    import subprocess as sp
    import torch

    from muscato_tpu_torch.bench.scaling import free_port
    from muscato_tpu_torch.engine.pipeline import MatchResult

    torch.cuda.empty_cache()  # the ranks share this card's memory
    work = tempfile.mkdtemp(prefix="muscato_chip_smoke_mesh_")
    procs = []
    try:
        t0 = time.perf_counter()
        for k, v in (("codes", rs.codes), ("lengths", rs.lengths), ("counts", rs.counts),
                     ("tcat", ts.tcat), ("gene_start", ts.gene_start)):
            np.save(os.path.join(work, f"{k}.npy"), np.asarray(v))
        t_write = time.perf_counter() - t0
        port = free_port()
        env = {k: v for k, v in os.environ.items() if k != "LOCAL_RANK"}
        logs = [os.path.join(work, f"rank{r}.log") for r in range(MESH_RANKS)]
        t0 = time.perf_counter()
        for r in range(MESH_RANKS):
            with open(logs[r], "w") as log:
                procs.append(sp.Popen(
                    [sys.executable, os.path.abspath(__file__), "--mesh-rank", str(r),
                     str(port), work, dev.type], stdout=log, stderr=sp.STDOUT, env=env))
        wait_ranks(procs, logs, MESH_TIMEOUT)
        wall = time.perf_counter() - t0
        stats = []
        for r in range(MESH_RANKS):
            with open(os.path.join(work, f"stats_{r}.json")) as f:
                stats.append(json.load(f))
        res = {}
        for k in ("flagship", "switched", "NoDedup"):
            z = np.load(os.path.join(work, f"result_{k}.npz"))
            res[k] = MatchResult(z["read_row"], z["gene"], z["start"], z["nmiss"])
        check(same_result(res["flagship"], mr), "2x2 mesh flagship MatchResult differs")
        check(same_result(res["switched"], got),
              "2x2 mesh, switched: MatchResult differs from the single-device run")
        check(same_result(res["NoDedup"], got_nd),
              "2x2 mesh, NoDedup: MatchResult differs from the single-device run")
        print(f"2x2 mesh, {MESH_RANKS} gloo ranks on one card: flagship {len(mr.read_row)} "
              f"matches, {PARITY_READS} reads under {' '.join(f'{k}={v}' for k, v in SWITCHES.items())} "
              f"and with NoDedup: each identical to its single-device run; arrays written in "
              f"{t_write:.1f}s, ranks started to end {wall:.1f}s", flush=True)
        for st in stats:
            print(f"2x2 mesh rank {st['rank']}: " + json.dumps(st), flush=True)
        launches = dict(stats[0]["flagship"]["launches"])
        launches["expand_owners_sub"] = stats[0]["switched"]["launches"]["expand_owners_sub"]
        return launches
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(work, ignore_errors=True)


def index_build_phase(dev, ts, index, host_s: float) -> None:
    """The flagship index built on the card (device_build=True), twice:
    each must equal the host build ``index`` (built in ``host_s``) array
    for array (skeys, the second key word, spos, num_valid, and tpacked,
    the stream packed on the card); prints both
    builds' seconds and the device build's peak memory above what was
    allocated before it."""
    import numpy as np
    import torch

    from muscato_tpu_torch.engine import pipeline

    runs = []
    for _ in range(2):
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        dindex = pipeline.build_target_index(ts, WIDTH, dev, device_build=True)
        torch.cuda.synchronize(dev)
        runs.append(dict(wall_s=time.perf_counter() - t0, timings=dindex.build_timings,
                         peak_gib=(torch.cuda.max_memory_allocated(dev) - base) / 2**30))
        check(dindex.num_valid == index.num_valid and torch.equal(dindex.skeys, index.skeys)
              and torch.equal(dindex.spos, index.spos)
              and torch.equal(dindex.tpacked, index.tpacked)
              and np.array_equal(dindex.skeys2.cpu().numpy().view(np.uint32),
                                 index.host_arrays[1]),
              "the device-built index differs from the host build")
        del dindex
    torch.cuda.empty_cache()
    print(f"index built on the card: {index.num_valid} window keys, skeys, key2, spos and "
          f"tpacked identical to the host build (host build {host_s:.2f}s "
          f"{json.dumps(index.build_timings)}); device builds " + json.dumps(runs),
          flush=True)


def random_targets(nbases: int, seed: int, dev, exact: bool = False):
    """A TargetSet of random genes of 1,000-19,999 bases, about ``nbases``
    in all (with ``exact``, exactly: the last gene takes the rest, or the
    gene before it when the rest is under 1,000 bases), the codes drawn on
    ``dev`` in pieces of 2**30 and copied to the host."""
    import numpy as np
    import torch

    from muscato_tpu_torch.io.targets import TargetSet

    rng = np.random.default_rng(seed)
    lengths = rng.integers(1_000, 20_000, nbases // 1_000)
    lengths = lengths[: int(np.searchsorted(np.cumsum(lengths), nbases, 'right'))]
    rest = nbases - int(lengths.sum())
    if exact and rest >= 1_000:
        lengths = np.append(lengths, rest)
    elif exact and rest:
        lengths[-1] += rest
    gs = np.concatenate([[0], np.cumsum(lengths)])
    tcat = np.empty(int(gs[-1]), np.uint8)
    g = torch.Generator(device=dev).manual_seed(seed)
    for c0 in range(0, tcat.size, 1 << 30):
        n = min(1 << 30, tcat.size - c0)
        torch.from_numpy(tcat[c0:c0 + n]).copy_(
            torch.randint(0, 4, (n,), dtype=torch.uint8, device=dev, generator=g))
    return TargetSet(tcat=tcat, gene_start=gs, names=[b""] * len(lengths), lengths=lengths)


def plant_big(ts, must, seed: int, bound=None):
    """gene_subset.plant_reads of BIG_READS reads over ``ts``: GROUPS
    groups of genes anywhere and, given a shard ``bound`` (the first gene
    of shard 1), CROSS_PAIRS pairs and CROSS_FOURS groups of four across
    it, no gene in two groups and none in ``must``; the other reads from
    ``must`` and random genes, PLANTED_GENES planted genes in all."""
    import numpy as np

    from muscato_tpu_torch.bench import gene_subset

    rng = np.random.default_rng(seed)
    used = set(int(g) for g in must)

    def take(pool, n):
        """The next n genes of the iterator ``pool`` that no one took."""
        out = []
        while len(out) < n:
            g = int(next(pool))
            if g not in used:
                out.append(g)
                used.add(g)
        return out

    anywhere = iter(rng.permutation(ts.num_genes))
    groups = [tuple(take(anywhere, n)) for n in GROUPS]
    if bound is not None:
        lo = iter(rng.permutation(bound))
        hi = iter(bound + rng.permutation(ts.num_genes - bound))
        groups += [(take(lo, 1)[0], take(hi, 1)[0]) for _ in range(CROSS_PAIRS)]
        groups += [tuple(x for pair in zip(take(lo, 2), take(hi, 2)) for x in pair)
                   for _ in range(CROSS_FOURS)]
    ngroup = sum(len(grp) for grp in groups)
    genes = np.concatenate([np.asarray(sorted(set(int(g) for g in must)), np.int64),
                            take(anywhere, PLANTED_GENES - ngroup - len(set(must)))])
    return gene_subset.plant_reads(ts, genes, BIG_READS, groups, seed=seed)


def big_shard_phase(dev, unstaged=None) -> dict:
    """A shard of BIG_SHARD_BASES random bases built on the card by
    ``mesh.shard_targets``, as a mesh rank builds its shard: prints its
    seconds and its peak memory above what was allocated before it.  The
    result must have the valid window count of its genes, keys ascending
    as uint32, the valid positions' sum, and, at 4,096 random entries, the
    key of the window at the entry's position computed on the host.  Then
    the same targets as one card's index with its second key word, and its
    search aux built on the card: its seconds and peak memory above the
    index, its counts summing to the window count; then B9 on that aux,
    which takes the binary mode on its own (native_binary_b9).  The reads
    of big_index_run_phase are planted in the genes first (plant_big: the
    first and the last gene, the gene holding position 2**30 and more past
    it, the longest genes).  Returns {index, ts, rs, plants} for that
    phase."""
    import numpy as np
    import torch

    from muscato_tpu_torch.engine.index import DIRECT_BUCKET_WIDTH, build_target_index
    from muscato_tpu_torch.parallel import mesh as pmesh

    t0 = time.perf_counter()
    ts = random_targets(BIG_SHARD_BASES, SEED, dev)
    rng = np.random.default_rng(SEED)
    gs, lengths = ts.gene_start, ts.lengths
    at30 = int(np.searchsorted(gs, BIG_PAST, "right")) - 1
    must = [0, ts.num_genes - 1, at30,
            *(at30 + 1 + rng.choice(ts.num_genes - at30 - 2, PAST_GENES - 1, replace=False)),
            *np.argsort(lengths, kind="stable")[-LONGEST_GENES:]]
    rs, plants = plant_big(ts, must, SEED)
    make_s = time.perf_counter() - t0
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    index = pmesh.shard_targets(ts, WIDTH, 1, 0, dev).index
    torch.cuda.synchronize(dev)
    build_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) - base
    nwin = np.maximum(lengths - WIDTH + 1, 0)
    first, last = gs[:-1], gs[:-1] + nwin - 1
    check(index.num_valid == int(nwin.sum()), "big shard: num_valid")
    u = index.skeys ^ -(1 << 31)  # signed order of these is the uint32 order of skeys
    check(bool((u[1:] >= u[:-1]).all()), "big shard: skeys do not ascend")
    del u
    check(int(index.spos.sum(dtype=torch.int64)) == int(((first + last) * nwin // 2).sum()),
          "big shard: spos is not the valid positions")
    at = rng.integers(0, index.num_valid, 4096)
    sel = torch.from_numpy(at).to(dev)
    pos, keys = index.spos[sel].cpu().numpy(), index.skeys[sel].cpu().numpy().view(np.uint32)
    win = ts.tcat[pos[:, None] + np.arange(WIDTH)].astype(np.uint64)
    exp = np.zeros(len(at), np.uint64)
    for i in range(WIDTH):
        exp = (exp * np.uint64(0x9E3779B1) + win[:, i]) & np.uint64(0xFFFFFFFF)
    check(np.array_equal(keys, exp.astype(np.uint32)), "big shard: keys at sampled entries")
    print(f"big shard: {int(gs[-1])} bases in {len(lengths)} genes, {rs.num_unique} reads "
          f"planted in {len(plants.genes)} of them (made in {make_s:.1f}s), "
          f"{index.num_valid} windows, built on the card by shard_targets in {build_s:.2f}s "
          f"{json.dumps(index.build_timings)}; peak {peak / 2**30:.2f} GiB above the "
          f"{base / 2**30:.2f} GiB allocated before, {peak / index.num_valid:.1f} bytes a "
          f"window; count, order, positions and sampled keys checked", flush=True)
    del index, sel, pos, keys
    torch.cuda.empty_cache()
    # The same targets as one card's index with its second key word (a
    # single-device run's), and its search aux built on the card.
    t0 = time.perf_counter()
    index = build_target_index(ts, WIDTH, dev, device_build=True)
    torch.cuda.synchronize(dev)
    build_s = time.perf_counter() - t0
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    aux = index.search_aux()
    peak = torch.cuda.max_memory_allocated(dev) - base
    nuniq = (aux.urec.numel() // 4 - DIRECT_BUCKET_WIDTH if aux.mode == "direct"
             else aux.ukeys.numel())
    total = int((aux.urec.view(-1, 4)[:nuniq, 3] if aux.mode == "direct"
                 else aux.ucount).sum(dtype=torch.int64))
    check(total == index.num_valid and int(aux.sbucket[-1]) == nuniq
          and bool((aux.sbucket[1:] >= aux.sbucket[:-1]).all()),
          "big index: search aux counts or bucket table")
    # At most what separate key, start and count arrays took (24 bytes a key).
    check(peak <= 33.46 * 2**30, f"big index: the aux's peak {peak / 2**30:.2f} GiB")
    print(f"big index, built on the card in {build_s:.2f}s {json.dumps(index.build_timings)}; "
          f"search aux built on the card: {aux.mode} mode ({aux.bucket_bits} "
          f"bucket bits), {nuniq} unique keys of {index.num_valid} windows in "
          f"{aux.build_s:.2f}s; peak {peak / 2**30:.2f} GiB above the index's "
          f"{base / 2**30:.2f} GiB, {peak / max(nuniq, 1):.1f} bytes a unique key; "
          f"{aux.nbytes} bytes kept; counts and bucket table checked", flush=True)
    # B9 on it: half the queries keys of the index, half random pairs.
    check(aux.mode == "binary", f"big index: a {aux.mode} aux")
    g = torch.Generator(device=dev).manual_seed(SEED)
    pick = torch.randint(nuniq, (PROBE_QUERIES // 2,), device=dev, generator=g)
    rand = torch.randint(-2**31, 2**31, (2, PROBE_QUERIES // 2), dtype=torch.int32,
                         device=dev, generator=g)
    queries = sorted_query_arrays(torch.cat([aux.ukeys[pick], rand[0]]),
                                  torch.cat([aux.ukeys2[pick], rand[1]]), True)
    del pick, rand
    native_binary_b9(f"the {int(gs[-1])}-base index, half its keys, half random pairs", aux,
                     *queries, True, unstaged)
    del aux, queries
    return dict(index=index, ts=ts, rs=rs, plants=plants)


def counted_run(dev, fn) -> tuple:
    """fn() with every launch counter set to 0 just before it and read
    just after: (its result, {wall_s, launches, peak_gib: the card's peak
    memory above what was allocated before})."""
    import torch

    for f in wrappers().values():
        f.launches = 0
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    return out, dict(wall_s=wall, launches={k: f.launches for k, f in wrappers().items()},
                     peak_gib=(torch.cuda.max_memory_allocated(dev) - base) / 2**30,
                     base_gib=base / 2**30)


def check_plants(label, mr, ts, plants, cfg, bound=None) -> dict:
    """Each group's read reports the genes plants.best_genes gives (in
    best mode); with a shard ``bound``, some group's genes kept span both
    shards and some group's copy within the budget fell to best+MMTol
    in the other shard from its best.  Returns the counts."""
    from muscato_tpu_torch.ops.verify import mismatch_budget_table

    budget = int(mismatch_budget_table(cfg.PMatch, cfg.MaxReadLength)[READ_LEN])
    expect = plants.best_genes(budget, cfg.MMTol)
    for row, genes in expect.items():
        got = set(mr.gene[mr.read_row == row].tolist())
        check(got == genes, f"{label}: read {row} reported genes {sorted(got)}, "
              f"planted {sorted(genes)}")
    out = dict(groups=len(expect), genes_kept=sum(len(g) for g in expect.values()))
    if bound is not None:
        both = dropped = 0
        for genes, subs, row in plants.groups:
            side = genes >= bound
            if side.all() or not side.any():
                continue
            both += len({bool(g >= bound) for g in expect[row]}) == 2
            best = side[subs.argmin()]
            dropped += any(s <= budget and int(g) not in expect[row] and side[i] != best
                           for i, (g, s) in enumerate(zip(genes, subs)))
        check(both and dropped, f"{label}: cross-shard groups kept in both shards {both}, "
              f"a copy dropped by best+MMTol across the shards {dropped}")
        out.update(kept_in_both_shards=both, dropped_across_shards=dropped)
    return out


def big_index_run_phase(dev, big: dict) -> dict:
    """Run A: BIG_READS reads planted in big_shard_phase's targets through
    run_matching_indexed against its 1.5e9-base index (binary aux), in
    batches of BIG_BATCH, in best mode and in first mode with MaxMatches 2
    (a binding cap), each counted (counted_run): the probe must be the
    binary search probe, B9 launched once a batch and every kernel of the
    path at least once, and the MatchResult must equal gene_subset.oracle
    (the port's CPU run over the genes reported and planted), have matches
    in the last gene and in genes past position 2**30, and in best mode
    report each group's genes as planted.  The capped run must differ from
    an uncapped first-mode run on the card, which it equals unless the cap
    cut some group's rows.  Prints each run's wall, stages, probe kind,
    launches, matches, peak memory and the oracle's seconds (and the rows
    the cap cut); frees the index.  Returns each kernel's launches summed
    over the two counted runs."""
    import dataclasses

    import numpy as np
    import torch

    from muscato_tpu_torch.bench import gene_subset
    from muscato_tpu_torch.engine import pipeline

    index, ts, rs, plants = (big.pop(k) for k in ("index", "ts", "rs", "plants"))
    base = dataclasses.replace(config(), ReadBatch=BIG_BATCH)
    gs = np.asarray(ts.gene_start)
    total = dict.fromkeys(KERNELS, 0)
    nbatch = -(-rs.num_unique // BIG_BATCH)
    for label, cfg in (("best", base),
                       ("first, MaxMatches 2", dataclasses.replace(
                           base, MatchMode="first", MaxMatches=2))):
        tm = {}
        mr, run = counted_run(dev, lambda: pipeline.run_matching_indexed(cfg, rs, index,
                                                                        timings=tm))
        name = f"big index, {label}"
        launches = run["launches"]
        check(tm["probe_kind"] == "binary", f"{name}: probe {tm['probe_kind']}")
        check(launches["binary_probe"] == tm["batches"] == nbatch,
              f"{name}: B9 launched {launches['binary_probe']} times in {tm['batches']} batches")
        check(all(launches[k] for k in BIG_PATH), f"{name}: launches {launches}")
        check_result(mr, rs, ts, cfg)
        t0 = time.perf_counter()
        exp = gene_subset.oracle(cfg, rs, ts, mr.gene, plants.genes)
        oracle_s = time.perf_counter() - t0
        check(same_result(mr, exp), f"{name}: the MatchResult differs from the gene-subset "
              f"oracle's ({len(mr.read_row)} against {len(exp.read_row)} matches)")
        check(bool((mr.gene == ts.num_genes - 1).any()), f"{name}: no match in the last gene")
        past = int((gs[mr.gene] >= BIG_PAST).sum())
        check(past > 0, f"{name}: no match past position 2**30")
        groups = check_plants(name, mr, ts, plants, cfg) if cfg.MatchMode == "best" else {}
        cap = {}
        if cfg.MaxMatches < base.MaxMatches:
            free = pipeline.run_matching_indexed(
                dataclasses.replace(cfg, MaxMatches=base.MaxMatches), rs, index)
            free_rows, rows = (set(zip(*(getattr(m, f).tolist() for f in (
                "read_row", "gene", "start", "nmiss")))) for m in (free, mr))
            cap = dict(uncapped_matches=len(free.read_row), cap_cut_rows=len(free_rows - rows))
            check(not same_result(mr, free), f"{name}: the cap bound no group (equal to the "
                  f"uncapped first run's {len(free.read_row)} matches)")
        for k in total:
            total[k] += launches[k]
        print(f"{name}: {len(mr.read_row)} matches of {rs.num_unique} reads against "
              f"{int(gs[-1])} bases in {ts.num_genes} genes ({index.num_valid} windows), "
              f"identical to the gene-subset oracle (the CPU run over "
              f"{len(np.union1d(mr.gene, plants.genes))} genes, {oracle_s:.1f}s); "
              f"{past} past position 2**30, in the last gene too; " + json.dumps(dict(
                  wall_s=run["wall_s"], stages=tm["stages"], probe_kind=tm["probe_kind"],
                  batches=tm["batches"], pairs=tm["pairs"], read_prep_s=tm["read_prep_s"],
                  fetch_s=tm["fetch_s"], launches=launches, peak_gib=run["peak_gib"],
                  base_gib=run["base_gib"], planted_groups=groups, **cap)), flush=True)
    del index, ts, rs, plants
    torch.cuda.empty_cache()
    return total


SHARD_LINE = re.compile(r"gene shard (\d+)/(\d+) \(genes \[(\d+),(\d+)\)\): (\d+) survivors; "
                        r"(\w+) build ([\d.]+)s, match ([\d.]+)s, probe (\w+)")


def gene_sharded_run_phase(dev) -> dict:
    """Run B: BIG_READS reads through pipeline.run_matching, the public
    entry point, against SHARDED_BASES random bases (past 2**31-1, so
    gene-range shards, 2 of them), planted (plant_big) in the first and
    the last gene, the gene holding global position 2**31 and more past
    it, the last gene of shard 0 and the first of shard 1, the longest
    genes, and in groups across the shard bound.  Each shard must take the
    device build (seen by wrapping pipeline.build_target_index, which also
    reads each build's peak memory); each shard's build and match seconds
    and probe kind come from its ``gene shard i/n`` log line.  The
    MatchResult must equal gene_subset.oracle, have matches in both shards
    and past global position 2**31, report each group's genes as planted,
    and show groups across the bound kept in both shards and decided
    between them by best+MMTol.  Prints those, the union's seconds (the
    wall less the shards'), the launches (B9 once a binary shard) and the
    run's peak memory.  Returns the launches."""
    import logging

    import numpy as np
    import torch

    from muscato_tpu_torch.bench import gene_subset
    from muscato_tpu_torch.engine import pipeline

    t0 = time.perf_counter()
    ts = random_targets(SHARDED_BASES, SEED + 2, dev, exact=True)
    gs = np.asarray(ts.gene_start)
    nsh = -(-int(gs[-1]) // SHARD_BASES)
    bounds = np.searchsorted(gs, np.linspace(0, int(gs[-1]), nsh + 1)).astype(np.int64)
    bounds[0], bounds[-1] = 0, ts.num_genes
    check(int(gs[-1]) == SHARDED_BASES and nsh == 2, f"sharded targets: {int(gs[-1])} bases, "
          f"{nsh} shards")
    b1 = int(bounds[1])
    at31 = int(np.searchsorted(gs, SHARDED_PAST, "right")) - 1
    rng = np.random.default_rng(SEED + 2)
    must = [0, ts.num_genes - 1, at31, b1 - 1, b1,
            *(at31 + 1 + rng.choice(ts.num_genes - at31 - 2, PAST_GENES - 1, replace=False)),
            *np.argsort(ts.lengths, kind="stable")[-LONGEST_GENES:]]
    rs, plants = plant_big(ts, must, SEED + 2, bound=b1)
    make_s = time.perf_counter() - t0
    cfg = config()

    builds, peaks = [], []
    real = pipeline.build_target_index

    def build(sub, width, device, **kw):
        torch.cuda.synchronize(dev)
        peaks.append(torch.cuda.max_memory_allocated(dev))
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        index = real(sub, width, device, **kw)
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        peaks.append(peak)
        builds.append(dict(kw, bases=int(sub.gene_start[-1]), windows=index.num_valid,
                           peak_gib=(peak - base) / 2**30, base_gib=base / 2**30,
                           timings=index.build_timings))
        return index

    lines = []
    handler = logging.Handler()
    handler.emit = lambda rec: lines.append(rec.getMessage())
    logger = logging.getLogger("muscato.pipeline")
    level = logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    pipeline.build_target_index = build
    try:
        mr, run = counted_run(dev, lambda: pipeline.run_matching(cfg, rs, ts, device=dev))
    finally:
        pipeline.build_target_index = real
        logger.removeHandler(handler)
        logger.setLevel(level)
    peak = (max([torch.cuda.max_memory_allocated(dev), *peaks]) / 2**30
            - run["base_gib"])
    shards = [dict(shard=int(m[1]), of=int(m[2]), genes=[int(m[3]), int(m[4])],
                   survivors=int(m[5]), build=m[6], build_s=float(m[7]),
                   match_s=float(m[8]), probe_kind=m[9])
              for m in (SHARD_LINE.match(x) for x in lines) if m]
    check(len(shards) == nsh == len(builds)
          and [s["genes"] for s in shards] == [[int(a), int(b)] for a, b in
                                               zip(bounds[:-1], bounds[1:])],
          f"sharded run: shards {shards}, builds {len(builds)}")
    check(all(b.get("device_build") for b in builds) and all(s["build"] == "device"
                                                             for s in shards),
          f"sharded run: a shard took the host build {builds}")
    launches = run["launches"]
    kinds = [s["probe_kind"] for s in shards]
    check(launches["binary_probe"] == kinds.count("binary")
          and launches["direct_probe"] == kinds.count("direct") and set(kinds) <= {
              "binary", "direct"}, f"sharded run: probes {kinds}, launches {launches}")
    check_result(mr, rs, ts, cfg)
    t0 = time.perf_counter()
    exp = gene_subset.oracle(cfg, rs, ts, mr.gene, plants.genes)
    oracle_s = time.perf_counter() - t0
    check(same_result(mr, exp), f"sharded run: the MatchResult differs from the gene-subset "
          f"oracle's ({len(mr.read_row)} against {len(exp.read_row)} matches)")
    in_shard = [int((mr.gene < b1).sum()), int((mr.gene >= b1).sum())]
    past = int((gs[mr.gene] >= SHARDED_PAST).sum())
    check(all(in_shard) and past > 0, f"sharded run: matches a shard {in_shard}, past 2**31 "
          f"{past}")
    groups = check_plants("sharded run", mr, ts, plants, cfg, bound=b1)
    union_s = run["wall_s"] - sum(s["build_s"] + s["match_s"] for s in shards)
    print(f"gene-sharded run (pipeline.run_matching): {len(mr.read_row)} matches of "
          f"{rs.num_unique} reads against {int(gs[-1])} bases in {ts.num_genes} genes "
          f"(made and planted in {make_s:.1f}s), identical to the gene-subset oracle (the CPU "
          f"run over {len(np.union1d(mr.gene, plants.genes))} genes, {oracle_s:.1f}s); "
          + json.dumps(dict(wall_s=run["wall_s"], shards=shards, builds=builds,
                            union_s=union_s, matches_a_shard=in_shard, past_2_31=past,
                            launches=launches, peak_gib=peak, base_gib=run["base_gib"],
                            planted_groups=groups)), flush=True)
    del ts, rs, plants
    return launches


def skewed_index_phase(dev, unstaged) -> None:
    """B9 where the binary mode is the fallback for skewed keys: an index
    of SKEW_BASES bases of an AT-rich genome (SKEW_CODES) at SKEW_WIDTH, in
    genes of 1,000-19,999 bases, built on the card; its search aux must
    take the binary mode on its own.  The queries: the windows at
    PROBE_QUERIES positions of another draw of that genome, sorted as the
    main path sorts them.  native_binary_b9 on them."""
    import numpy as np
    import torch

    from muscato_tpu_torch.engine.index import build_target_index
    from muscato_tpu_torch.io.targets import TargetSet
    from muscato_tpu_torch.ops import windows as winops

    rng = np.random.default_rng(SEED + 1)
    codes = np.array(SKEW_CODES, np.uint8)
    lengths = rng.integers(1_000, 20_000, SKEW_BASES // 1_000)
    lengths = lengths[: int(np.searchsorted(np.cumsum(lengths), SKEW_BASES, 'right'))]
    gs = np.concatenate([[0], np.cumsum(lengths)])
    ts = TargetSet(tcat=codes[rng.integers(0, codes.size, int(gs[-1]), dtype=np.uint8)],
                   gene_start=gs, names=[b""] * len(lengths), lengths=lengths)
    index = build_target_index(ts, SKEW_WIDTH, dev, device_build=True)
    aux = index.search_aux()
    check(aux.mode == "binary", f"skewed index: a {aux.mode} aux")
    draw = torch.from_numpy(codes[rng.integers(0, codes.size, PROBE_QUERIES + SKEW_WIDTH - 1,
                                               dtype=np.uint8)]).to(dev)
    k1 = winops.sliding_window_keys(draw, SKEW_WIDTH)[:PROBE_QUERIES].to(torch.int32)
    queries = sorted_query_arrays(k1, torch.zeros_like(k1), False)
    run = torch.diff(aux.sbucket)
    native_binary_b9(f"a {int(gs[-1])}-base AT-rich genome at width {SKEW_WIDTH} (buckets "
                     f"of up to {int(run.max())} keys, {float(run[run > 0].float().mean()):.1f}"
                     f" a nonempty one)", aux, *queries, False, unstaged)
    del aux, index, ts, queries, draw, k1, run
    torch.cuda.empty_cache()


def streaming_flagship(dev, cfg, rs, ts, index, path=STREAM_PATH, keep=None) -> tuple:
    """The flagship through the streaming expand (NoDedup): a warm-up from
    the first survivor capacity (earlier runs grow the process-wide hint),
    then the counted and timed run (flagship_run, which fails unless each
    kernel of ``path`` launched), starting from the capacity its warm-up
    grew, then one profile (kernel_profile, given ``keep``).  Prints their
    numbers and a summary: wall, expand_verify, chunks, each port kernel's
    launches a chunk, the device events that start in the profile's stage
    window and its busy share.  Returns (MatchResult, the counted run's
    numbers, the profile)."""
    import dataclasses

    from muscato_tpu_torch.engine import pipeline

    cfg_nd = dataclasses.replace(cfg, NoDedup=True)
    pipeline._CAP_HINT[0] = pipeline._SURV_CAP0
    cold = {}
    pipeline.run_matching_indexed(cfg_nd, rs, index, timings=cold)
    mr_nd, flag_nd = flagship_run(dev, cfg_nd, rs, ts, index, path)
    flag_nd["chunks_a_pass"] = -(-flag_nd["pairs"] // STREAM_CHUNK)
    flag_nd["warm_up_chunks"] = cold["chunks"]
    print("flagship streaming (NoDedup): " + json.dumps(flag_nd), flush=True)
    prof_nd = kernel_profile(dev, cfg_nd, rs, index, keep=keep)
    print("profile (flagship batch, streaming path, NoDedup): " + json.dumps(prof_nd),
          flush=True)
    chunks = flag_nd["streaming_chunks"]
    print("streaming (NoDedup): " + json.dumps(dict(
        wall_s=flag_nd["wall_s"], expand_verify_s=flag_nd["stage_s"]["expand_verify"],
        chunks=chunks, launches_a_chunk={k: n / chunks for k, n in flag_nd["launches"].items()},
        profile_window_events=prof_nd["window_events"],
        profile_window_events_a_chunk=prof_nd["window_events"] / chunks,
        busy_ms=prof_nd["busy_ms"], window_ms=prof_nd["window_ms"],
        busy_share=prof_nd["busy_share"], elementwise=prof_nd["elementwise"],
        verify_pairs_sites=[{k: v for k, v in site.items() if k != "shapes"}
                            for site in prof_nd["sites"] if site["kernel"] == "verify_pairs"])),
        flush=True)
    return mr_nd, flag_nd, prof_nd


def stream_cell(path: str) -> None:
    """``python3 chip_smoke.py --stream-cell K1,K2,...``: the flagship's
    workload and index, then streaming_flagship alone (``path``: the
    kernels that must launch).  The port it times is the one first on
    sys.path, so the same function times a checkout of another commit of
    the port when this file is loaded by its path from that checkout's
    root: two trees in turns on one card."""
    import torch

    import muscato_tpu_torch
    from muscato_tpu_torch.bench import gendat
    from muscato_tpu_torch.engine import pipeline

    dev = torch.device("cuda")
    print(f"stream cell: the port at {os.path.dirname(muscato_tpu_torch.__file__)}", flush=True)
    rs, ts = gendat.generate_arrays_realistic(NUM_READ, READ_LEN, NUM_GENE, GENE_LEN, SEED)
    index = pipeline.build_target_index(ts, WIDTH, dev)
    streaming_flagship(dev, config(), rs, ts, index, tuple(path.split(",")))


def match_phases(dev, unstaged=None) -> tuple:
    import dataclasses

    import torch

    from muscato_tpu_torch.bench import engine_device_check, gendat, profile_match
    from muscato_tpu_torch.engine import pipeline
    from muscato_tpu_torch.io.reads import ReadSet

    cfg = config()
    t0 = time.perf_counter()
    rs, ts = gendat.generate_arrays_realistic(
        NUM_READ, READ_LEN, NUM_GENE, GENE_LEN, SEED
    )
    print(f"workload: {rs.num_unique} unique of {NUM_READ} reads, "
          f"{ts.num_genes} genes, {int(ts.gene_start[-1])} bases "
          f"({time.perf_counter() - t0:.1f}s)", flush=True)
    t0 = time.perf_counter()
    index = pipeline.build_target_index(ts, WIDTH, dev)
    host_s = time.perf_counter() - t0
    print(f"index: {index.num_valid} window keys in "
          f"{host_s:.1f}s {index.build_timings}", flush=True)
    index_build_phase(dev, ts, index, host_s)
    skewed_index_phase(dev, unstaged)

    # Parity against the full index: cuda kernels vs cpu plain twins, then
    # each switched path on cuda against the default cuda run, then the
    # streaming expand's three triggers, each cuda against cpu.
    n = PARITY_READS
    sub = ReadSet(codes=rs.codes[:n], lengths=rs.lengths[:n],
                  counts=rs.counts[:n], num_total=n)
    cpu_index = cpu_copy(index)
    out = engine_device_check.check_paths(cfg, sub, index, cpu_index, paths=ENGINE_PATHS)
    runs = out["runs"]
    engine = {path: run["ok"] for path, run in runs.items()}
    for path, run in runs.items():
        check(run["ok"], f"engine_device_check {path}: {run['error'] or 'MatchResult differs'}")
    got, parity_t = runs["default"]["result"], runs["default"]["timings"]
    got_nd = runs["NoDedup"]["result"]
    check_result(got, sub, ts, cfg)
    check(runs["NoDedup"]["timings"]["chunks"] > 0, "NoDedup: the streaming expand did not run")
    check(runs["NoDedup"]["launches"]["verify_pairs"] == runs["NoDedup"]["timings"]["chunks"],
          "NoDedup parity: B10 did not launch once a chunk")
    check(parity_t["probe_kind"] == "sorted_join"
          and runs["MUSCATO_PJOIN=0"]["timings"]["probe_kind"] == "sort_merge", "parity probes")
    print(f"parity (engine_device_check): {n} reads vs the full index, {len(got.read_row)} "
          f"matches; each path on cuda identical to the cpu run: " + json.dumps(
              {path: round(run["seconds"], 2) for path, run in runs.items()}), flush=True)
    pair_cap = parity_t["pairs"] // 2
    streaming = {
        f"{len(STREAM_WINDOWS)} windows (0, 2, ..., {STREAM_WINDOWS[-1]})":
            (dataclasses.replace(cfg, Windows=list(STREAM_WINDOWS)), None),
        f"_MAX_PAIR_CAP {pair_cap}, below the batch's {parity_t['pairs']} pairs":
            (cfg, pair_cap),
    }
    pairs_wrapper = wrappers()["verify_pairs"]
    for label, (c, cap) in streaming.items():
        saved_cap = pipeline._MAX_PAIR_CAP
        pipeline._MAX_PAIR_CAP = cap or saved_cap
        try:
            t0 = time.perf_counter()
            tg, tc = {}, {}
            pairs_wrapper.launches = 0
            alt = pipeline.run_matching_indexed(c, sub, index, probe="sort", timings=tg)
            b10_launches = pairs_wrapper.launches
            t1 = time.perf_counter()
            alt_cpu = pipeline.run_matching_indexed(c, sub, cpu_index, probe="sort",
                                                    timings=tc)
            t2 = time.perf_counter()
        finally:
            pipeline._MAX_PAIR_CAP = saved_cap
        check(tg["chunks"] > 0 and tc["chunks"] > 0, f"{label}: the streaming expand did not run")
        check(b10_launches == tg["chunks"], f"{label}: B10 launched {b10_launches} times in "
              f"{tg['chunks']} chunks")
        check(same_result(alt, alt_cpu), f"{label}: cuda and cpu MatchResults differ")
        check_result(alt, sub, ts, c)
        if c.Windows == cfg.Windows:
            check(same_result(alt, got), f"{label}: MatchResult differs from the default run")
        print(f"parity, streaming expand, {label}: {len(alt.read_row)} matches identical on "
              f"cuda ({t1 - t0:.2f}s, {tg['chunks']} chunks, B10 once a chunk) and cpu "
              f"({t2 - t1:.2f}s)"
              + (", and to the default run" if c.Windows == cfg.Windows else ""), flush=True)

    # The flagship through the main path: one warm-up run, then the
    # counted and timed run; then the same through the switched path.
    pipeline.run_matching_indexed(cfg, rs, index)
    mr, flag = flagship_run(dev, cfg, rs, ts, index, DEFAULT_PATH)
    print("flagship: " + json.dumps(flag), flush=True)
    b3_calls = {"monotone_gather": None}
    prof = kernel_profile(dev, cfg, rs, index, unstaged, keep=b3_calls)
    print("profile (flagship batch, default path): " + json.dumps(prof), flush=True)
    # B7 launches once a verify chunk, as B4 does (its one engine call).
    pk = prof["kernels"]
    check(pk.get("verify_diagonals_swar", {}).get("launches")
          == pk.get("monotone_gather_rows", {}).get("launches"),
          "the default profile: B7 did not launch once a verify chunk")
    print(f"verify in the default profile: B7 {pk['verify_diagonals_swar']['launches']} "
          f"launches, {pk['verify_diagonals_swar']['ms']:.4f} ms; expand_verify "
          f"{flag['stage_s']['expand_verify'] * 1e3:.2f} ms in the counted run; "
          f"elementwise kernels {json.dumps(prof['elementwise'])}; B7's sites "
          + json.dumps([{k: v for k, v in site.items() if k != "shapes"}
                        for site in prof["sites"] if site["kernel"] == "verify_diagonals_swar"])
          + f"; B7 replayed staged and unstaged, ms a batch in turns: "
          f"{json.dumps(prof.get('b7_staging_ab'))}", flush=True)
    switches = " ".join(f"{k}={v}" for k, v in SWITCHES.items())
    with switched(**SWITCHES):
        pipeline.run_matching_indexed(cfg, rs, index)
        mr_sw, flag_sw = flagship_run(dev, cfg, rs, ts, index, SWITCHED_PATH)
        check(same_result(mr_sw, mr), "switched flagship MatchResult differs")
        check(flag_sw["launches"]["sorted_join"] == 0, "the sort-merge probe ran B1")
        print(f"flagship switched ({switches}): " + json.dumps(flag_sw), flush=True)
        prof_sw = kernel_profile(dev, cfg, rs, index)
    check(prof_sw["kernels"].get("expand_owners_sub", {}).get("launches") == 1,
          "the switched profile shows no B6 launch")
    print(f"profile (flagship batch, switched path, {switches}): " + json.dumps(prof_sw),
          flush=True)

    b10_calls = {"verify_pairs": None, "monotone_gather": None}
    mr_nd, flag_nd, prof_nd = streaming_flagship(dev, cfg, rs, ts, index, keep=b10_calls)
    check(same_result(mr_nd, mr), "streaming (NoDedup) flagship MatchResult differs")
    check(flag_nd["launches"]["verify_pairs"] == flag_nd["streaming_chunks"],
          f"streaming flagship: B10 launched {flag_nd['launches']['verify_pairs']} times in "
          f"{flag_nd['streaming_chunks']} chunks")
    check(sum(site["launches"] for site in prof_nd["sites"] if site["kernel"] == "verify_pairs")
          == prof_nd["kernels"]["expand_owners"]["launches"],
          "the streaming profile: B10 did not launch once a chunk, as B2 does")
    b10 = verify_pairs_phase(b10_calls["verify_pairs"], unstaged)
    # B3's calls of the two profiles replayed through both builds.
    b3_arms = {"runs of 4 a thread": lambda a: launch_gather(None, *a)}
    if unstaged is not None:
        b3_arms["a thread an output (-DMUSCATO_NO_STAGE)"] = lambda a: launch_gather(unstaged, *a)
    b3_replay = {label: replay_in_turns("monotone_gather", b3_arms,
                                        [c["args"] for c in kept["monotone_gather"]])
                 for label, kept in (("default", b3_calls), ("streaming", b10_calls))}
    print("B3's calls of the default and the streaming profile replayed through both builds, "
          "device ms summed, in turns: " + json.dumps(b3_replay), flush=True)
    del b10_calls, b3_calls

    ab = probe_ab(dev, cfg, rs, index)
    print("probe stage A/B (ms, flagship batch): " + json.dumps(ab), flush=True)
    lo_ab = lo_key_ab(dev, cfg, rs, index)
    print("probe stage, (inactive, lo) key A/B (ms, flagship batch): " + json.dumps(lo_ab),
          flush=True)
    small = probe_small_index(dev, cfg, rs, index)
    print(f"probe stage against a small index (ms, flagship batch, "
          f"K x R = {len(WINDOWS) * BATCH} queries): " + json.dumps(small), flush=True)
    # The search probe's parity comes after the flagship cells, so that
    # their peak memory does not hold its two auxes (4.1 GB together).
    auxes, launches_search = search_parity(cfg, sub, index, cpu_index, engine)
    del cpu_index
    probe_kres = probe_kernel_phase(dev, cfg, rs, auxes, unstaged)
    cross = probe_crossover(dev, cfg, rs, index, auxes)
    print(f"probe stage by batch size (ms a batch over the first {CROSSOVER_DEPTH} "
          f"batches; {index.num_valid} index keys): " + json.dumps(cross), flush=True)
    for size in SPLIT_BATCHES:
        split = probe_stage_split(dev, cfg, rs, index, auxes, size)
        print(f"probe stage split at {size} reads a batch (ms, each part alone, "
              f"back to back): " + json.dumps(split), flush=True)
    b9_site = binary_batch_profile(dev, cfg, rs, index, auxes["binary"])
    print(f"B9 on the profile of one binary-mode batch of {SMALL_BATCH} reads: "
          + json.dumps(b9_site), flush=True)
    del auxes
    flag_sb, flag_mb = batched_flagships(dev, cfg, rs, ts, index, mr)
    pm = profile_match.profile(cfg, rs, index, dev)
    check(pm["matches"] > 0 and pm["kernels"], "profile_match")
    print("profile_match on the flagship index (the reads shifted by one): "
          + json.dumps(pm), flush=True)
    mesh_one_phase(dev, cfg, rs, ts, index, mr)
    del index

    # The flagship as SHARDS gene-range shards, each built and matched in
    # turn on the card, ranked over the union.
    shard_t = {}
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    mr_sh = pipeline.run_matching_gene_sharded(cfg, rs, ts, SHARDS, device=dev,
                                               timings=shard_t)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    check(same_result(mr_sh, mr), "gene-sharded flagship MatchResult differs")
    print(f"flagship as {SHARDS} gene-range shards: {len(mr_sh.read_row)} matches, identical "
          f"to the default run; {wall:.2f}s, shards " + json.dumps(shard_t["shards"]),
          flush=True)
    runner_phase(dev, cfg, rs, ts, mr)
    launches_mesh = mesh_ranks_phase(dev, rs, ts, mr, got, got_nd)
    del rs, ts
    return (flag, flag_sw, flag_nd, flag_sb, flag_mb, launches_mesh, launches_search,
            {**probe_kres, "verify_pairs": b10}, b3_replay)


def report_files(results: str) -> dict:
    """{name: path} of the four report files of a run."""
    from muscato_tpu_torch.engine import report

    return {"results": results, "nonmatch": report.nonmatch_path(results),
            "readstats": report._stats_path(results, "readstats"),
            "genestats": report._stats_path(results, "genestats")}


def driver_phase(dev) -> dict:
    """The muscato_torch entry point on gendat files (full index size,
    DRIVER_READS reads) prepared by prep_targets; then a run that saves an
    IndexFile and keeps its TempDir, a run that loads that file, and a run
    that resumes from the kept TempDir, whose report files must each be
    byte-identical to the first run's.  Returns {work, reads, seq, ids,
    plain, wall_s}: the directory of the files (the caller removes it),
    their paths, and the first run's report bytes and seconds."""
    from muscato_tpu_torch.bench import gendat
    from muscato_tpu_torch.io import targets
    from muscato_tpu_torch import cli

    work = tempfile.mkdtemp(prefix="muscato_chip_smoke_")
    try:
        t0 = time.perf_counter()
        reads, genes = gendat.generate_big(
            DRIVER_READS, READ_LEN, NUM_GENE, GENE_LEN, out_dir=work, seed=SEED,
            hit_frac=0.9,
        )
        seq, ids = targets.prep_targets(genes, rev=False)
        t1 = time.perf_counter()

        def run(tag, **fields):
            cfg = config()
            cfg.ReadFileName, cfg.GeneFileName, cfg.GeneIdFileName = reads, seq, ids
            cfg.ResultsFileName = os.path.join(work, f"{tag}.txt")
            cfg.TempDir = os.path.join(work, f"tmp_{tag}")
            cfg.LogDir = os.path.join(work, f"logs_{tag}")
            for k, v in fields.items():
                setattr(cfg, k, v)
            cfg_path = os.path.join(work, f"{tag}.json")
            cfg.save(cfg_path)
            t = time.perf_counter()
            rc = cli.main_muscato([f"-ConfigFileName={cfg_path}", f"-device={dev}"])
            check(rc == 0, f"muscato_torch ({tag}) exited {rc}")
            wall = time.perf_counter() - t
            files = report_files(cfg.ResultsFileName)
            out = {}
            for k, p in files.items():
                with open(p, "rb") as f:
                    out[k] = f.read()
            return out, wall

        plain, t_plain = run("results")
        # The run's probe line (muscato_screen.log): the probe it took and,
        # for the search probe, the aux's bytes and its build's seconds on
        # the card.
        (run_id,) = os.listdir(os.path.join(work, "logs_results"))
        probe_line = [m for _, m in _log_entries(os.path.join(
            work, "logs_results", run_id, "muscato_screen.log")) if m.startswith("probe: ")]
        check(len(probe_line) == 1 and probe_line[0].startswith("probe: direct"),
              f"driver: the {DRIVER_READS}-read run's probe: {probe_line}")
        sizes = {k: len(v) for k, v in plain.items()}
        check(all(s > 0 for s in sizes.values()), f"empty output: {sizes}")
        nres = plain["results"].count(b"\n")
        check(nres > DRIVER_READS // 4, f"only {nres} result rows")
        print(f"driver: muscato_torch on {DRIVER_READS} reads (read count cut "
              f"from {NUM_READ}; index size, read length and windows uncut) x "
              f"{NUM_GENE} genes: {nres} result rows, files {sizes}; "
              f"data+prep {t1 - t0:.1f}s, run {t_plain:.1f}s; its {probe_line[0]}",
              flush=True)
        index_file = os.path.join(work, "index.npz")
        saved, t_save = run("index_saved", IndexFile=index_file, NoCleanTemp=True)
        check(os.path.exists(index_file), "the IndexFile run saved no index file")
        loaded, t_load = run("index_loaded", IndexFile=index_file)
        (kept,) = os.listdir(os.path.join(work, "tmp_index_saved"))
        resumed, t_resume = run(
            "resumed", ResumeDir=os.path.join(work, "tmp_index_saved", kept))
        for tag, out in (("IndexFile saved", saved), ("IndexFile loaded", loaded),
                         ("ResumeDir", resumed)):
            check(out == plain, f"driver, {tag}: report files differ from the plain run's")
        print(f"driver: IndexFile saving run {t_save:.1f}s "
              f"({os.path.getsize(index_file)} bytes), loading run {t_load:.1f}s, "
              f"ResumeDir run {t_resume:.1f}s; all four report files of each "
              f"byte-identical to the plain run's", flush=True)
        return dict(work=work, reads=reads, seq=seq, ids=ids, plain=plain, wall_s=t_plain)
    except BaseException:
        shutil.rmtree(work, ignore_errors=True)
        raise


def run_world(work: str, tag: str, cfg, want: str) -> dict:
    """One world of WORLD_RANKS processes of the muscato_torch entry point
    on the card, each started as a user starts a rank: ``cfg`` (saved as
    its config file, with the rank's own ResultsFileName and LogDir) and
    -Coordinator=localhost:<port> -ProcessCount -ProcessIndex -device=cuda,
    with MUSCATO_DIST_BACKEND=gloo and MUSCATO_STAGE_TIMES=1, LOCAL_RANK
    unset (both ranks take cuda:0).  A rank that exits non-zero or passes
    WORLD_TIMEOUT fails the phase (wait_ranks); nothing falls back to one
    process or to the CPU.  Every rank must log its place in the gloo
    world, the mesh ``want`` ("dp=D mp=M"), the range-sharded read prep of
    its own byte range of the read file and its kernel launches, which
    must include every kernel of the default path; rank 0 alone writes the
    report files.  Returns {wall_s, ranks: each rank's {rank, prep (its
    range, reads and uniques), host_s (HOST_STAGES' seconds from its log),
    launches, timings (the mesh's), shard (its build line's numbers),
    done_s (rank 0)}, results: rank 0's report file paths}."""
    import dataclasses
    import subprocess as sp

    from muscato_tpu_torch.bench.scaling import free_port

    port = free_port()
    env = {k: v for k, v in os.environ.items() if k != "LOCAL_RANK"}
    env.update(MUSCATO_DIST_BACKEND="gloo", MUSCATO_STAGE_TIMES="1")
    procs, logs, cfgs = [], [], []
    try:
        t0 = time.perf_counter()
        for r in range(WORLD_RANKS):
            rc = dataclasses.replace(
                cfg, ResultsFileName=os.path.join(work, f"{tag}_rank{r}.txt"),
                LogDir=os.path.join(work, f"logs_{tag}_rank{r}"),
                TempDir=os.path.join(work, f"tmp_{tag}"))
            path = os.path.join(work, f"{tag}_rank{r}.json")
            rc.save(path)
            cfgs.append(rc)
            logs.append(os.path.join(work, f"{tag}_rank{r}.log"))
            with open(logs[r], "w") as log:
                procs.append(sp.Popen(
                    [sys.executable, "-c", WORLD_CHILD, f"-ConfigFileName={path}",
                     f"-Coordinator=localhost:{port}", f"-ProcessCount={WORLD_RANKS}",
                     f"-ProcessIndex={r}", "-device=cuda"],
                    stdout=log, stderr=sp.STDOUT, env=env, cwd=ROOT))
        wait_ranks(procs, logs, WORLD_TIMEOUT)
        wall = time.perf_counter() - t0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    size = os.path.getsize(cfg.ReadFileName)
    ranks = []
    for r, rc in enumerate(cfgs):
        (run_id,) = os.listdir(rc.LogDir)
        main_log = [m for _, m in _log_entries(os.path.join(rc.LogDir, run_id, "muscato.log"))]
        screen = [m for _, m in _log_entries(os.path.join(rc.LogDir, run_id,
                                                          "muscato_screen.log"))]
        label = f"world {tag}, rank {r}"
        check(f"process group: rank {r} of {WORLD_RANKS} (gloo)" in main_log,
              f"{label}: no gloo process group in its log")
        check(f"mesh run: {want}, rank {r}" in main_log, f"{label}: not a {want} mesh run: "
              f"{[m for m in main_log if m.startswith('mesh run')]}")
        (prep,) = [PREP_RANGE.match(m) for m in main_log if PREP_RANGE.match(m)]
        lo, hi = r * size // WORLD_RANKS, (r + 1) * size // WORLD_RANKS
        check([int(x) for x in prep.groups()[:5]] == [r, WORLD_RANKS, lo, hi, size],
              f"{label}: read prep {prep.group(0)}, not bytes [{lo},{hi}) of {size}")
        (shard,) = [SHARD_BUILT.match(m) for m in main_log if SHARD_BUILT.match(m)]
        (launch,) = [LAUNCH_LINE.match(m) for m in screen if LAUNCH_LINE.match(m)]
        launches = {k: int(v) for k, v in (kv.split("=") for kv in launch.group(2).split())}
        check(all(launches[k] > 0 for k in DEFAULT_PATH),
              f"{label}: a kernel of the default path never launched: {launches}")
        (timings,) = [json.loads(m.split(": ", 1)[1]) for m in screen
                      if m.startswith("mesh timings over ")]
        wrote = os.path.exists(rc.ResultsFileName)
        check(wrote == (r == 0), f"{label}: wrote report files: {wrote}")
        done = [float(m.split()[2][:-1]) for m in main_log if m.startswith("done in ")]
        host = {k: float(m.rsplit(" in ", 1)[1][:-1]) for k, head in HOST_STAGES.items()
                for m in main_log if m.startswith(head)}
        check(bool(done) == (r == 0) and (r == 0 or "non-primary process: rank and report "
                                         "ran on rank 0" in main_log),
              f"{label}: its log's end {main_log[-2:]}")
        ranks.append(dict(
            rank=r, prep=dict(bytes=[lo, hi], reads=int(prep.group(6)),
                              unique=int(prep.group(7))),
            shard=dict(m=int(shard.group(1)), genes=[int(shard.group(3)), int(shard.group(4))],
                       bases=int(shard.group(5)), windows=int(shard.group(6)),
                       build_s=float(shard.group(8)), peak_reserved_gib=float(shard.group(9)),
                       card_used_gib=float(shard.group(10))),
            host_s=host, launches=launches, timings=timings, done_s=done[0] if done else None))
    return dict(wall_s=wall, ranks=ranks, results=report_files(cfgs[0].ResultsFileName))


def world_w1_phase(dev, drv: dict) -> dict:
    """W1: driver_phase's files (the flagship's genes, DRIVER_READS reads)
    through two worlds of WORLD_RANKS muscato_torch processes on the card
    (run_world): Mesh auto, which must take read parallelism (dp=2 mp=1,
    each rank building the whole index on the card), and Mesh=1x2 (two
    gene-range shards and the mp all-gather).  In each, rank 0's four
    report files must be byte-identical to driver_phase's single-process
    run's.  Prints each world's wall beside that run's and each rank's
    figures; returns each kernel's launches summed over both worlds'
    ranks."""
    total = dict.fromkeys(KERNELS, 0)
    for mesh, want in (("auto", "dp=2 mp=1"), ("1x2", "dp=1 mp=2")):
        cfg = config()
        cfg.ReadFileName, cfg.GeneFileName, cfg.GeneIdFileName = drv["reads"], drv["seq"], drv["ids"]
        cfg.Mesh = mesh
        world = run_world(drv["work"], f"w1_{mesh}", cfg, want)
        for k, p in world["results"].items():
            with open(p, "rb") as f:
                check(f.read() == drv["plain"][k], f"W1, Mesh={mesh}: rank 0's {k} file "
                      "differs from the single-process run's")
        for rk in world["ranks"]:
            for k in total:
                total[k] += rk["launches"][k]
        print(f"W1, Mesh={mesh} ({want}), {WORLD_RANKS} muscato_torch processes on the card "
              f"(gloo): rank 0's four report files byte-identical to the single-process "
              f"run's; world wall {world['wall_s']:.1f}s beside the single-process run's "
              f"{drv['wall_s']:.1f}s ({world['wall_s'] / drv['wall_s']:.2f}x); ranks "
              + json.dumps(world["ranks"]), flush=True)
    return total


def write_prepared_targets(ts, work: str, tag: str) -> tuple:
    """``ts`` as a prepared gene file and id file (the format prep_targets
    writes: one sequence a line; "%011d<TAB>name<TAB>length" a line),
    uncompressed, which the driver reads as it reads the .sz files (a
    snappy stream of 2.4e9 bases would add about 30 s of codec time on
    the host); returns their paths."""
    import numpy as np

    from muscato_tpu_torch.io import seqcodec

    seq = os.path.join(work, f"musc_{tag}.txt")
    ids = os.path.join(work, f"musc_ids_{tag}.txt")
    gs = np.asarray(ts.gene_start)
    with open(seq, "wb") as f:
        for c0 in range(0, ts.num_genes, 4096):
            c1 = min(c0 + 4096, ts.num_genes)
            letters = seqcodec.decode(ts.tcat[gs[c0]:gs[c1]])
            f.write(b"\n".join(letters[a:b] for a, b in zip(gs[c0:c1] - gs[c0],
                                                             gs[c0 + 1:c1 + 1] - gs[c0])))
            f.write(b"\n")
    with open(ids, "wb") as f:
        f.write(b"".join(b"%011d\t%s\t%d\n" % (i, n, ln)
                         for i, (n, ln) in enumerate(zip(ts.names, ts.lengths))))
    return seq, ids


def world_w2_phase(dev) -> dict:
    """W2: SHARDED_BASES random bases (random_targets, seed SEED + 2, run
    B's gene set) with gene names, written as prepared gene and id files,
    and BIG_READS reads planted by plant_big (in the first and the last
    gene, the gene holding position 2**31 and more past it, the genes on
    both sides of the mesh's shard bound, shard_bounds(ts, 2), the longest
    genes, and groups across that bound), written as fastq, through a world
    of WORLD_RANKS muscato_torch processes on the card (run_world) under
    Mesh auto, best mode, MaxMatches 1,000,000: the driver must take two
    index shards (dp=1 mp=2), each rank building its own, past 2**30
    bases, on the card and running B5 and B1 against it.  Rank 0's
    results.txt must equal, row for row in its first six columns, the
    report rows of gene_subset.oracle (the port's CPU run over the genes
    reported and planted) over the driver's ReadSet of the fastq, with
    matches in both shards and past position 2**31, and some group across
    the bound reported on both sides.  Prints each rank's build seconds,
    peak reserved memory and the card's used memory after the builds, its
    mesh timings and the world's wall; then B1 at rank 0's shape
    (shard_join_case).  Returns {launches: each kernel's launches summed
    over the ranks, sorted_join: that case's numbers}."""
    import dataclasses

    import numpy as np
    import torch

    from muscato_tpu_torch.bench import gene_subset
    from muscato_tpu_torch.bench.gendat import _fastq_blob
    from muscato_tpu_torch.engine import report
    from muscato_tpu_torch.io import reads as reads_io
    from muscato_tpu_torch.io import seqcodec
    from muscato_tpu_torch.io.seqcodec import _C2B
    from muscato_tpu_torch.parallel import mesh as pmesh

    work = tempfile.mkdtemp(prefix="muscato_chip_smoke_w2_")
    try:
        t0 = time.perf_counter()
        ts = random_targets(SHARDED_BASES, SEED + 2, dev, exact=True)
        torch.cuda.empty_cache()  # the ranks share this card's memory
        gs = np.asarray(ts.gene_start)
        ts.names = [b"w2_%07d" % i for i in range(ts.num_genes)]
        bound = pmesh.shard_bounds(ts, WORLD_RANKS)[1]
        at31 = int(np.searchsorted(gs, SHARDED_PAST, "right")) - 1
        rng = np.random.default_rng(SEED + 2)
        must = [0, ts.num_genes - 1, at31, bound - 1, bound,
                *(at31 + 1 + rng.choice(ts.num_genes - at31 - 2, PAST_GENES - 1,
                                        replace=False)),
                *np.argsort(ts.lengths, kind="stable")[-LONGEST_GENES:]]
        rs, plants = plant_big(ts, must, SEED + 2, bound=bound)
        seq, ids = write_prepared_targets(ts, work, "w2genes")
        fastq = os.path.join(work, "w2_reads.fastq")
        check(set(rs.lengths.tolist()) == {READ_LEN}, "W2: reads of other lengths")
        with open(fastq, "wb") as f:
            f.write(_fastq_blob(_C2B[rs.codes[:, :READ_LEN]], 0).tobytes())
        make_s = time.perf_counter() - t0
        cfg = dataclasses.replace(config(), ReadFileName=fastq, GeneFileName=seq,
                                  GeneIdFileName=ids, Mesh="auto")
        world = run_world(work, "w2", cfg, f"dp=1 mp={WORLD_RANKS}")
        for rk in world["ranks"]:
            check(rk["shard"]["bases"] > 1 << 30, f"W2, rank {rk['rank']}: a shard of "
                  f"{rk['shard']['bases']} bases")
        genes_of = {n: i for i, n in enumerate(ts.names)}
        results = world["results"]["results"]
        got = result_prefixes(results)
        named = np.unique([genes_of[row.split(b"\t")[4]] for row in got])
        t0 = time.perf_counter()
        rs_drv = reads_io.build_readset(fastq, cfg.MinReadLength, cfg.MaxReadLength)
        exp = gene_subset.oracle(cfg, rs_drv, ts, named, plants.genes)
        oracle_s = time.perf_counter() - t0
        exp_path = os.path.join(work, "w2_oracle.txt")
        report.write_results(exp_path, exp, rs_drv, ts)
        check(got == result_prefixes(exp_path), f"W2: rank 0's results.txt ({len(got)} rows) "
              f"differs from the gene-subset oracle's ({len(exp.read_row)} matches)")
        gene = np.asarray([genes_of[row.split(b"\t")[4]] for row in got])
        in_shard = [int((gene < bound).sum()), int((gene >= bound).sum())]
        past = int((gs[gene] >= SHARDED_PAST).sum())
        check(all(in_shard) and past > 0, f"W2: matches a shard {in_shard}, past 2**31 {past}")
        by_seq = {}
        for row, g in zip(got, gene):
            by_seq.setdefault(row.split(b"\t", 1)[0], set()).add(bool(g >= bound))
        both = sum(len(by_seq.get(seqcodec.decode(rs.codes[row, :rs.lengths[row]]), ())) == 2
                   for genes, _, row in plants.groups
                   if (genes >= bound).any() and not (genes >= bound).all())
        check(both > 0, "W2: no group across the shard bound reported on both sides")
        launches = dict.fromkeys(KERNELS, 0)
        for rk in world["ranks"]:
            for k in launches:
                launches[k] += rk["launches"][k]
        b1 = shard_join_case(dev, ts, rs_drv, cfg)
        print(f"W2, Mesh=auto (dp=1 mp={WORLD_RANKS}), {WORLD_RANKS} muscato_torch processes "
              f"on the card (gloo): {len(got)} result rows of {rs_drv.num_unique} reads against "
              f"{int(gs[-1])} bases in {ts.num_genes} genes (made, planted and written in "
              f"{make_s:.1f}s), equal row for row to the gene-subset oracle's (the CPU run over "
              f"{len(np.union1d(named, plants.genes))} genes, {oracle_s:.1f}s with the read "
              f"prep); {in_shard} a shard, {past} past position 2**31, {both} groups across the "
              f"bound reported on both sides; world wall {world['wall_s']:.1f}s; ranks "
              + json.dumps(world["ranks"]), flush=True)
        print("W2, B1 on shard 0 (rank 0's, built again here) at the run's queries: "
              + json.dumps(b1), flush=True)
        return dict(launches=launches, sorted_join=b1)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def shard_join_case(dev, ts, rs, cfg) -> dict:
    """B1 as W2's rank 0 ran it: shard 0 of ``ts`` built again on the card
    (mesh.shard_targets, as the rank built it) and the queries of the
    whole ReadSet ``rs`` (B5's keys of every window, sorted, as the
    sorted-join probe gives them), exact against its twin and timed
    (measure_case) beside torch.searchsorted's left and right bounds and
    its bound.  Frees the shard."""
    import torch

    from muscato_tpu_torch.engine import pipeline
    from muscato_tpu_torch.ops import join, window_queries
    from muscato_tpu_torch.parallel import mesh as pmesh

    keys = pmesh.shard_targets(ts, cfg.WindowWidth, WORLD_RANKS, 0, dev).index.skeys
    l_eff = pipeline._read_width(rs.lengths, rs.codes.shape[1], cfg.WindowWidth)
    rpacked, lens = pipeline._upload_rows(rs.codes[:, :l_eff], rs.lengths, rs.num_unique, dev)
    keyf = window_queries.window_queries(rpacked, lens, tuple(cfg.Windows),
                                         width=cfg.WindowWidth, min_dinuc=cfg.MinDinuc)[0]
    qs = join.flip(torch.sort(join.flip(keyf)).values)
    kf, qf = join.flip(keys), join.flip(qs)
    out = measure_case("sorted_join", lambda: join.sorted_join(keys, qs)[:2],
                       lambda: join.sorted_join_torch(keys, qs)[:2],
                       lambda: (torch.searchsorted(kf, qf, side="left"),
                                torch.searchsorted(kf, qf, side="right")),
                       call_work("sorted_join", (keys, qs), {}),
                       f"skeys ({keys.numel()},) qkeys ({qs.numel()},)")
    del keys, rpacked, lens, keyf, qs, kf, qf
    torch.cuda.empty_cache()
    return out


# The config matrix (muscato_tpu_torch/bench/config_matrix.py): the kernels
# that its runs together must launch, and those whose direct route
# (one thread a lane, no shared memory) reads past the staged tile take.
MATRIX_PATH = ("sorted_join", "expand_owners", "monotone_gather", "monotone_gather_rows",
               "window_queries", "verify_diagonals_swar", "direct_probe", "verify_pairs")
DIRECT_ROUTES = ("verify_diagonals_swar", "verify_pairs")


def matrix_cli_case(dev, cfg, rs, ts) -> dict:
    """A case through the muscato_torch entry point: its arrays written as
    gendat's files (every second read reverse-complemented), the targets
    prepared with -rev, then a run on the card and one on the CPU, whose
    four report files must be byte-identical.  Returns the card run's
    numbers as check_paths gives a path's."""
    import dataclasses

    from muscato_tpu_torch import cli
    from muscato_tpu_torch.bench import config_matrix
    from muscato_tpu_torch.engine import pipeline
    from muscato_tpu_torch.io import targets

    work = tempfile.mkdtemp(prefix="muscato_chip_smoke_matrix_")
    try:
        reads, genes = config_matrix.write_files(rs, ts, work)
        seq, ids = targets.prep_targets(genes, rev=True)
        outs, walls = {}, {}
        for run, d in (("card", dev), ("cpu", "cpu")):
            c = dataclasses.replace(
                cfg, ReadFileName=reads, GeneFileName=seq, GeneIdFileName=ids,
                ResultsFileName=os.path.join(work, f"{run}.txt"),
                TempDir=os.path.join(work, f"tmp_{run}"), LogDir=os.path.join(work, f"logs_{run}"))
            cfg_path = os.path.join(work, f"{run}.json")
            c.save(cfg_path)
            for fn in pipeline.KERNELS.values():
                fn.launches = 0
            for k in DIRECT_ROUTES:
                pipeline.KERNELS[k].direct_launches = 0
            t0 = time.perf_counter()
            rc = cli.main_muscato([f"-ConfigFileName={cfg_path}", f"-device={d}"])
            walls[run] = time.perf_counter() - t0
            check(rc == 0, f"muscato_torch -device={d} exited {rc}")
            if run == "card":
                launches = {k: fn.launches for k, fn in pipeline.KERNELS.items()}
                direct = {k: pipeline.KERNELS[k].direct_launches for k in DIRECT_ROUTES}
            outs[run] = {}
            for k, path in report_files(c.ResultsFileName).items():
                with open(path, "rb") as f:
                    outs[run][k] = f.read()
        (run_id,) = os.listdir(os.path.join(work, "logs_card"))
        probe = [m for _, m in _log_entries(os.path.join(
            work, "logs_card", run_id, "muscato_screen.log")) if m.startswith("probe: ")]
        rows = outs["card"]["results"].splitlines()
        return dict(equal=outs["card"] == outs["cpu"], error=None, matches=len(rows),
                    rev_matches=sum(b"_r\t" in ln for ln in rows),
                    probe=probe[0].split()[1] if probe else None, batches=None,
                    launches=launches, direct=direct, card_s=walls["card"],
                    cpu_s=walls["cpu"])
    finally:
        shutil.rmtree(work, ignore_errors=True)


def config_matrix_phase(dev) -> dict:
    """Whole runs on the card beyond the flagship's setting: each case of
    muscato_tpu_torch/bench/config_matrix.py (the flagship's config() with
    the case's fields; the reference's test setting at width 4, also
    through the muscato_torch CLI on -rev targets, its documented flags at
    width 15, first mode with a MaxMatches cap binding within and across
    batches, widths 13, 32 and 40, 66 windows, reads of 2,000 and 8,000
    bases) on gendat.generate_arrays_realistic(*case.data, seed=SEED),
    its index built on the CPU and on the card (device_build), its paths
    run by engine_device_check.check_paths on the card, each MatchResult
    held to the CPU run of the same inputs (the case's cpu_fields: a
    verify chunk for long reads).  Prints each run's matches, probe,
    launches (and B7's and B10's on the direct route), card and CPU
    seconds and equality; fails on any inequality, a run with no match or
    a fault, unless B1, B2, B3, B4, B5, B7, B8 and B10 each launched, unless
    long-8k took B7's and B10's direct route only and long-2k B7's staged
    tile, unless windows-66 launched B5 in two groups a batch, and unless
    first-w10-capped took the search probe in 4 batches.  Returns each
    kernel's launches summed over the matrix's runs."""
    import torch

    from muscato_tpu_torch.bench import config_matrix, engine_device_check, gendat
    from muscato_tpu_torch.engine import pipeline
    from muscato_tpu_torch.ops import packed as pops

    t_phase = time.perf_counter()
    total = dict.fromkeys(KERNELS, 0)
    runs = {}
    for name, case in config_matrix.CASES.items():
        t0 = time.perf_counter()
        cfg = config_matrix.config(name, config())
        rs, ts = gendat.generate_arrays_realistic(*case.data, seed=SEED)
        data_s = time.perf_counter() - t0
        if case.rev:
            runs[name, "cli"] = matrix_cli_case(dev, cfg, rs, ts)
        else:
            t0 = time.perf_counter()
            cpu_index = pipeline.build_target_index(ts, cfg.WindowWidth, "cpu")
            index = pipeline.build_target_index(ts, cfg.WindowWidth, dev, device_build=True)
            index_s = time.perf_counter() - t0
            out = engine_device_check.check_paths(
                cfg, rs, index, cpu_index, paths=case.paths,
                ref_cfg=config_matrix.config(name, config(), cpu=True))
            for path, run in out["runs"].items():
                mr, tm = run["result"], run["timings"] or {}
                runs[name, path] = dict(
                    equal=run["ok"], error=run["error"],
                    matches=0 if mr is None else len(mr.read_row),
                    probe=tm.get("probe_kind"), batches=tm.get("batches"),
                    launches=run["launches"], direct=run["direct"], card_s=run["seconds"],
                    cpu_s=out["reference_s"])
            print(f"config matrix {name}: data {data_s:.1f}s, both indexes {index_s:.1f}s",
                  flush=True)
            del index, cpu_index, out
            torch.cuda.empty_cache()
        for (n, path), r in runs.items():
            if n != name:
                continue
            for k, v in (r["launches"] or {}).items():
                total[k] += v
            print(f"config matrix {name} [{path}]: " + json.dumps(dict(
                {k: v for k, v in r.items() if k != "launches"},
                launches={k: v for k, v in (r["launches"] or {}).items() if v})), flush=True)
    for (name, path), r in runs.items():
        check(r["equal"] and r["matches"] > 0,
              f"config matrix {name} [{path}]: {r['error'] or 'not equal, or no match'} "
              f"({r['matches']} matches)")
    check(all(total[k] > 0 for k in MATRIX_PATH),
          f"config matrix: a kernel never launched: {total}")
    b7, b10 = DIRECT_ROUTES
    auto8, nd8 = runs["long-8k", "auto"], runs["long-8k", "NoDedup"]
    check(auto8["launches"][b7] > 0 and auto8["direct"][b7] == auto8["launches"][b7],
          f"long-8k: B7 off its direct route: {auto8['launches'][b7]} launches, "
          f"{auto8['direct'][b7]} direct")
    check(nd8["launches"][b10] > 0 and nd8["direct"][b10] == nd8["launches"][b10],
          f"long-8k NoDedup: B10 off its direct route: {nd8['launches'][b10]} launches, "
          f"{nd8['direct'][b10]} direct")
    l2 = runs["long-2k", "auto"]
    nw2 = -(-config_matrix.CASES["long-2k"].data[1] // 8)
    tile2 = pops.swar_tile(nw2, nw2 + pops.TROWS_GUARD)
    check(l2["launches"][b7] > 0 and l2["direct"][b7] == 0 and tile2[1] > 0,
          f"long-2k: B7 not on its staged tile: {l2}, tile {tile2}")
    w66 = runs["windows-66", "auto"]
    check(w66["launches"]["window_queries"] == 2 * w66["batches"]
          and w66["launches"][b10] > 0,
          f"windows-66: B5 not in two groups a batch, or no B10: {w66}")
    first = runs["first-w10-capped", "auto"]
    check(first["probe"] in ("direct", "binary") and first["batches"] == 4,
          f"first-w10-capped: probe {first['probe']} in {first['batches']} batches")
    print(f"config matrix: long-2k's B7 tile {tile2[0]} lanes ({tile2[1]} bytes); "
          f"launches summed over the matrix: " + json.dumps(total), flush=True)
    print(f"config matrix phase: {time.perf_counter() - t_phase:.1f}s", flush=True)
    return total


def long_read_routes(dev, unstaged) -> dict:
    """B7 and B10 on long reads, on both routes: the staged kernels of the
    default library and the direct ones (one thread a lane, no shared
    memory) of ``unstaged``, the -DMUSCATO_NO_STAGE library, each exact
    against its twin and timed in turns (arms_in_turns), at 2,000 bases
    (long-2k's reads: B7's 64-lane tile) and 7,000 bases (875 words: both
    staged tiles of 32 lanes); at 8,000 bases (1,000 words) the default
    library takes the direct route itself.  Then each wrapper once at each
    length, counted on its route.  B7 on VERIFY_BRANCH_LANES d-sorted
    lanes of 2,048 reads over a 20M-base stream, B10 on the same lanes in
    random order (as the probe's lo order leaves them), one window offset
    a lane.  Returns {kernel: {bases: {route: [ms a call, a turn]}}}."""
    import torch

    from muscato_tpu_torch.ops import packed as pops

    g = torch.Generator(device=dev).manual_seed(SEED + 17)
    st = verify_stream(dev, g, 20_000_000)
    out = {"verify_diagonals_swar": {}, "verify_pairs": {}}
    for bases, wins in ((2000, (0, 500, 1000, 1500)), (7000, (0, 2000, 4000, 6000)),
                        (8000, (0, 2000, 4000, 6000))):
        nw = bases // 8
        args, kw = verify_inputs(dev, g, st, lanes=VERIFY_BRANCH_LANES, reads=1 << 11,
                                 nwords=nw, q1s=wins, width=WIDTH, lengths=(bases, bases))
        r, d, t_rows, rp, ln, _, _, budget, _ = args
        lanes, smem = pops.swar_tile(nw, t_rows.shape[1])
        staged, pstaged = smem > 0, pops.pairs_tile(nw)[1] > 0
        check(staged == pstaged == (bases < 8000),
              f"at {bases} bases B7 staged {staged}, B10 staged {pstaged}")
        # B10 on the same lanes in the probe's order: shuffled, each with
        # one of the windows and its position d + q1.
        perm = torch.randperm(r.numel(), device=dev, generator=g)
        q1 = torch.tensor(wins, dtype=torch.int32, device=dev)[
            torch.randint(0, len(wins), (r.numel(),), device=dev, generator=g)]
        rr, dd = r[perm], d[perm]
        pp = torch.where((rr >= 0) & (dd >= 0), dd + q1, -1).to(torch.int32)
        pargs = (rr, pp, rp, ln, st["gene_start"], budget, q1, WIDTH, 8 * nw, st["smax"],
                 st["trows"](nw), st["gblock"], st["gsteps"])
        libs = {"staged": None, "direct": unstaged} if staged else {"direct": None}
        exp = pops.verify_diagonals_swar_torch(*args, **kw)
        pexp = pops.verify_pairs_packed_torch(*pargs)
        for kernel, arms, want in (
                ("verify_diagonals_swar",
                 {k: functools.partial(launch_verify, lib, *args, **kw) for k, lib in libs.items()},
                 exp),
                ("verify_pairs",
                 {k: functools.partial(launch_pairs, lib, pargs) for k, lib in libs.items()},
                 pexp)):
            turns = arms_in_turns(f"{kernel} at {bases} bases", arms, want)
            out[kernel][bases] = {k: t["ms"] for k, t in turns.items()}
        # Through the wrappers: one launch each, counted on its route.
        for kernel, fn, call, want in (
                ("verify_diagonals_swar", pops.verify_diagonals_swar,
                 lambda: pops.verify_diagonals_swar(*args, **kw), exp),
                ("verify_pairs", pops.verify_pairs_packed,
                 lambda: pops.verify_pairs_packed(*pargs), pexp)):
            before = fn.launches, fn.direct_launches
            _compare(f"{kernel} wrapper at {bases} bases", call(), want)
            check((fn.launches, fn.direct_launches) == (before[0] + 1, before[1] + (not staged)),
                  f"{kernel} at {bases} bases: its launch was not counted on its route")
        live = int(((r >= 0) & (d >= 0)).sum())
        print(f"long reads, {bases} bases ({nw} words), {r.numel()} lanes ({live} live), "
              f"windows {wins}: the wrappers take "
              f"{f'staged tiles (B7 {lanes} lanes, B10 32)' if staged else 'the direct route'}; "
              f"exact vs twin on each route; ms a call in turns: B7 "
              f"{json.dumps(out['verify_diagonals_swar'][bases])}, B10 "
              f"{json.dumps(out['verify_pairs'][bases])}", flush=True)
        del args, pargs, exp, pexp, t_rows
        st["trows"].cache_clear()
    return out


def run_child(argv, label: str, env=None) -> str:
    """Run ``python argv`` in a session of its own and return its output
    (stdout and stderr); fails when it exits non-zero or outlasts
    SCALE_TIMEOUT, and then kills every process of its session."""
    import signal

    p = subprocess.Popen([sys.executable, *argv], env=env, cwd=ROOT,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                         start_new_session=True)
    try:
        out, _ = p.communicate(timeout=SCALE_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        out, _ = p.communicate()
        raise RuntimeError(f"chip_smoke check failed: {label} passed {SCALE_TIMEOUT}s:\n"
                           f"{out[-4000:]}")
    check(p.returncode == 0, f"{label} exited {p.returncode}:\n{out[-4000:]}")
    return out


def _log_entries(path: str) -> list:
    """(seconds since the epoch, logger message) of each line of a driver
    log file ("%(asctime)s %(name)s: %(message)s")."""
    import datetime

    out = []
    with open(path) as f:
        for ln in f:
            when = datetime.datetime.strptime(ln[:23], "%Y-%m-%d %H:%M:%S,%f").timestamp()
            out.append((when, ln[24:].split(": ", 1)[1].rstrip("\n")))
    return out


def scale_run(work: str, dev, tag: str) -> dict:
    """One run of the reference-scale script (run_100m run) on ``work``:
    checks its exit, the batch count, one stage-times line a batch and
    the kernels of the default path launched; returns its run100m.json
    with the driver log's own stage times and the seconds after the row
    fetch."""
    logs = os.path.join(work, "logs")
    before = set(os.listdir(logs)) if os.path.isdir(logs) else set()
    t0 = time.perf_counter()
    run_child(["-m", "muscato_tpu_torch.scripts.run_100m", "run", work, "--device", dev.type],
              f"run_100m ({tag})", env=dict(os.environ, N_READS=str(SCALE_READS)))
    wall = time.perf_counter() - t0
    with open(os.path.join(work, "run100m.json")) as f:
        rec = json.load(f)
    check(rec["driver_exit"] == 0, f"run_100m ({tag}): driver exited {rec['driver_exit']}")
    check(rec["peak_anon_rss_mb"] > 0, f"run_100m ({tag}): no anonymous RSS read")
    (run_id,) = set(os.listdir(logs)) - before
    main = _log_entries(os.path.join(logs, run_id, "muscato.log"))
    screen = _log_entries(os.path.join(logs, run_id, "muscato_screen.log"))
    said = lambda entries, head: [(t, m) for t, m in entries if m.startswith(head)]  # noqa: E731
    batches, stage_lines = said(screen, "batch reads ["), said(screen, "stage times [")
    check(len(batches) == SCALE_BATCHES and len(stage_lines) == SCALE_BATCHES
          and len(said(screen, "stage sums over ")) == 1,
          f"run_100m ({tag}): {len(batches)} batches, {len(stage_lines)} stage-times lines")
    (launch_line,) = said(screen, "kernel launches over ")
    launches = {k: int(v) for k, v in (
        kv.split("=") for kv in launch_line[1].split(": ", 1)[1].split())}
    check(all(launches[k] > 0 for k in DEFAULT_PATH),
          f"run_100m ({tag}): a kernel never launched: {launches}")
    # What follows the row fetch (the MatchResult's assembly; the union of
    # the batches runs on the card before it): from the pipeline's last
    # line (logged after the fetch) to the driver's "retained" line.
    (fetched,) = said(screen, "windows ")
    (retained,) = said(main, "retained ")
    t_first = main[0][0]
    return dict(rec, tag=tag, command_s=wall, after_fetch_s=retained[0] - fetched[0],
                launches=launches,
                driver_log=[(round(t - t_first, 3), m) for t, m in main],
                screen_log=[m for _, m in screen])


def result_prefixes(path: str, seqs=None) -> list:
    """The first six columns (readseq, target, pos, nmiss, gene, genelen) of
    each results row, of every row or of the rows whose read sequence is
    in ``seqs``, sorted: the columns that depend on the read's sequence
    alone."""
    rows = []
    with open(path, "rb") as f:
        for ln in f:
            cols = ln.split(b"\t", 6)
            if seqs is None or cols[0] in seqs:
                rows.append(b"\t".join(cols[:6]))
    rows.sort()
    return rows


def scale_run_phase(dev) -> dict:
    """The reference-scale job on the card: gen_parallel writes SCALE_READS
    reads against the 100,000 x 1,000-base gene set, then run_100m runs the
    muscato_torch driver twice (the first builds and saves the IndexFile,
    the second loads it): each exits 0, runs SCALE_BATCHES batches with
    one stage-times line each and launches every kernel of the default
    path, and both write the same results.txt.  Then the gate: the first
    SCALE_GATE_READS reads through the driver on the CPU (the plain twins)
    with the same config and IndexFile, whose rows' first six columns
    must equal those of the card's rows with the same read sequences (a
    row depends on its read's sequence alone: MaxMatches 1,000,000 does
    not bind here, and best+MMTol ranks each read alone).  Returns the
    second run's kernel launches."""
    import filecmp

    work = tempfile.mkdtemp(prefix="muscato_chip_smoke_scale_")
    try:
        t_phase = time.perf_counter()
        workers = min(16, os.cpu_count() or 1)
        t0 = time.perf_counter()
        run_child(["-m", "muscato_tpu_torch.scripts.gen_parallel", work, str(SCALE_READS),
                   str(workers)], "gen_parallel",
                  env=dict(os.environ, GEN_CHUNK=str(SCALE_GEN_CHUNK)))
        gen_s = time.perf_counter() - t0
        disk = shutil.disk_usage(work)
        print(f"scale run: gen_parallel {SCALE_READS} reads, {workers} workers, "
              f"chunks of {SCALE_GEN_CHUNK}: {gen_s:.1f}s, fastq "
              f"{os.path.getsize(os.path.join(work, 'reads.fastq'))} bytes; disk free "
              f"{disk.free / 2**30:.1f} GiB of {disk.total / 2**30:.1f}", flush=True)
        runs = []
        for tag in ("IndexFile built", "IndexFile loaded"):
            rec = scale_run(work, dev, tag)
            keep = ("n_reads", "prep_targets_s", "driver_s", "driver_exit",
                    "reads_per_sec_end_to_end", "peak_anon_rss_mb", "result_rows",
                    "command_s", "after_fetch_s", "launches")
            print(f"scale run ({tag}): " + json.dumps(dict(
                {k: rec[k] for k in keep}, gen_s=gen_s,
                index_file_bytes=os.path.getsize(os.path.join(work, "index_w20.npz")))),
                flush=True)
            print(f"scale run ({tag}), driver log (seconds from its first line): "
                  + json.dumps(rec["driver_log"]), flush=True)
            print(f"scale run ({tag}), screen log: " + json.dumps(rec["screen_log"]),
                  flush=True)
            os.replace(os.path.join(work, "results.txt"),
                       os.path.join(work, f"results_{len(runs)}.txt"))
            runs.append(rec)
        check(runs[0]["prep_targets_s"] != "cached" and runs[1]["prep_targets_s"] == "cached",
              "scale run: target prep was not run once and reused once")
        check(any(m.startswith("saved index to") for _, m in runs[0]["driver_log"])
              and any(m.startswith("loaded index") for _, m in runs[1]["driver_log"]),
              "scale run: the IndexFile was not built and saved, then loaded")
        check(filecmp.cmp(os.path.join(work, "results_0.txt"),
                          os.path.join(work, "results_1.txt"), shallow=False),
              "scale run: results.txt differs between the two runs")

        # The gate: the first reads on the CPU, same config and IndexFile.
        t0 = time.perf_counter()
        gate = os.path.join(work, "gate")
        os.makedirs(gate)
        seqs = set()
        with open(os.path.join(work, "reads.fastq"), "rb") as f, \
                open(os.path.join(gate, "reads.fastq"), "wb") as g:
            for i in range(4 * SCALE_GATE_READS):
                ln = f.readline()
                g.write(ln)
                if i % 4 == 1:
                    seqs.add(ln.rstrip(b"\n"))
        with open(os.path.join(work, "config.json")) as f:
            cfg = json.load(f)
        cfg.update(ReadFileName=os.path.join(gate, "reads.fastq"),
                   ResultsFileName=os.path.join(gate, "results.txt"),
                   TempDir=os.path.join(gate, "tmp"), LogDir=os.path.join(gate, "logs"))
        cfg_path = os.path.join(gate, "config.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        run_child(["-c", "from muscato_tpu_torch import cli; "
                   f"cli.main_muscato(['-ConfigFileName={cfg_path}', '-device=cpu'])"],
                  "the CPU gate run")
        cpu_rows = result_prefixes(os.path.join(gate, "results.txt"))
        card_rows = result_prefixes(os.path.join(work, "results_1.txt"), seqs)
        check(len(cpu_rows) > SCALE_GATE_READS // 4 and cpu_rows == card_rows,
              f"scale run gate: {len(cpu_rows)} CPU rows against {len(card_rows)} card rows")
        print(f"scale run gate: the first {SCALE_GATE_READS} reads through the driver on the "
              f"CPU ({time.perf_counter() - t0:.1f}s): {len(cpu_rows)} rows, their first six "
              f"columns equal to the card run's rows of the same {len(seqs)} read sequences",
              flush=True)
        print(f"scale run phase: {time.perf_counter() - t_phase:.1f}s", flush=True)
        return runs[1]["launches"]
    finally:
        shutil.rmtree(work, ignore_errors=True)


def bench_tool_phases(dev) -> None:
    """The bench tools that stand on their own: pallas_device_check at its
    small shapes (every kernel exact against its twin; kernel_phase holds
    them at the main path's shapes), then micro_verify's modes at
    MICRO_VERIFY_LANES lanes on its 100M-base, 4M-read tables."""
    import torch

    from muscato_tpu_torch.bench import micro_verify, pallas_device_check

    t0 = time.perf_counter()
    res = pallas_device_check.run(dev, ("small",))
    check(all(res.values()), f"pallas_device_check: {res}")
    print(f"pallas_device_check ({time.perf_counter() - t0:.1f}s): PALLAS_RESULTS "
          + json.dumps(res), flush=True)
    t0 = time.perf_counter()
    tb = micro_verify.tables(dev, 100_000_000, 4_000_000)
    out = micro_verify.measure(dev, MICRO_VERIFY_LANES, tb)
    del tb
    torch.cuda.empty_cache()
    print(f"micro_verify at {MICRO_VERIFY_LANES} lanes ({time.perf_counter() - t0:.1f}s): "
          + json.dumps(out), flush=True)


def tool_run_phases(dev) -> None:
    """bigtest run through its entry point on the card at its defaults
    (100k reads x 100k genes through the muscato_torch driver) in a
    temporary directory."""
    import contextlib
    import io

    from muscato_tpu_torch.bench import bigtest

    work = tempfile.mkdtemp(prefix="muscato_chip_smoke_bigtest_")
    try:
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = bigtest.main(["--Dir", work])
        text = out.getvalue()
        full = [ln for ln in text.splitlines() if ln.startswith("full run: ")]
        check(rc == 0 and full and int(full[0].split(", ")[-1].split()[0]) > 0,
              f"bigtest: {text[-2000:]}")
        print(f"bigtest at its defaults ({time.perf_counter() - t0:.1f}s):\n" + text.strip(),
              flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main() -> int:
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    print(smi.stdout.strip(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)

    from muscato_tpu_torch.io import native
    from muscato_tpu_torch.ops import _lib

    t0 = time.perf_counter()
    kern = _lib.kernels()
    print(f"kernels: built {kern.path} in {kern.build_s:.2f}s "
          f"(load {time.perf_counter() - t0:.2f}s)", flush=True)
    print(kern.log.strip(), flush=True)
    # The variant builds, all at once: every source without staging, and
    # csrc/expand.cu alone with each B2 and B6 variant's constants.
    t0 = time.perf_counter()
    expand_src = [os.path.join(_lib.CSRC, "expand.cu")]
    wanted = [("-DMUSCATO_NO_STAGE", None),
              *((f, expand_src) for f in (*B2_VARIANTS.values(), *B6_VARIANTS.values()))]
    with concurrent.futures.ThreadPoolExecutor(max_workers=len(wanted)) as pool:
        builds = list(pool.map(
            lambda w: _lib._build(_lib.NVCC_FLAGS + (w[0],), w[1]), wanted))
    libs = [_lib.load(path) for path, _, _ in builds]
    unstaged = libs[0]
    variants = dict(zip(B2_VARIANTS, libs[1:]))
    sub_variants = dict(zip(B6_VARIANTS, libs[1 + len(B2_VARIANTS):]))
    print(f"kernels without staging (-DMUSCATO_NO_STAGE), and expand.cu with B2 variants "
          f"({', '.join(B2_VARIANTS.values())}) and B6 variants "
          f"({', '.join(B6_VARIANTS.values())}): built and loaded in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    print(f"B6, -Xptxas -v: {ptxas_of(kern.log, SYMBOLS['expand_owners_sub'])}", flush=True)
    for label, (_, _, log) in zip(B6_VARIANTS, builds[1 + len(B2_VARIANTS):]):
        print(f"B6 variant {label}, -Xptxas -v: {ptxas_of(log, SYMBOLS['expand_owners_sub'])}",
              flush=True)
    print(f"B7, -Xptxas -v: {ptxas_of(kern.log, SYMBOLS['verify_diagonals_swar'])}; "
          f"without staging: {ptxas_of(builds[0][2], 'verify_diagonals_direct_kernel')}",
          flush=True)
    print(f"B10, -Xptxas -v: {ptxas_of(kern.log, SYMBOLS['verify_pairs'])}; one thread a "
          f"lane (-DMUSCATO_NO_STAGE): {ptxas_of(builds[0][2], 'verify_pairs_thread_kernel')}",
          flush=True)
    print(f"B3, -Xptxas -v: {ptxas_of(kern.log, SYMBOLS['monotone_gather'])}; a thread an "
          f"output (-DMUSCATO_NO_STAGE): {ptxas_of(builds[0][2], 'gather_thread_kernel')}",
          flush=True)
    print(f"B8, -Xptxas -v: {ptxas_of(kern.log, SYMBOLS['direct_probe'])}; B9: "
          f"{ptxas_of(kern.log, SYMBOLS['binary_probe'])}; one thread a query "
          f"(-DMUSCATO_NO_STAGE): B8 {ptxas_of(builds[0][2], 'direct_probe_thread_kernel')}, "
          f"B9 {ptxas_of(builds[0][2], 'binary_probe_thread_kernel')}", flush=True)
    t0 = time.perf_counter()
    print(f"native host library: {native.ensure_built() is not None} "
          f"({time.perf_counter() - t0:.1f}s)", flush=True)
    print(f"integer rate: {int_pipe_rate():.4g} operations/s a pipe "
          f"({torch.cuda.get_device_properties(0).multi_processor_count} SMs x "
          f"{INT_LANES_PER_SM} lanes x the max SM clock); measured on chains of "
          f"dependent instructions: {json.dumps(measured_int_rates(dev))}", flush=True)

    phase_s = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = round(time.perf_counter() - t0, 1)
        print(f"phase {name}: {phase_s[name]}s", flush=True)
        return out

    kres = timed("kernel_phase", kernel_phase, dev, unstaged, variants, sub_variants)
    timed("bench_tool_phases", bench_tool_phases, dev)
    big = timed("big_shard_phase", big_shard_phase, dev, unstaged)
    launches_big = timed("big_index_run_phase", big_index_run_phase, dev, big)
    del big
    launches_sharded = timed("gene_sharded_run_phase", gene_sharded_run_phase, dev)
    w2 = timed("world_w2_phase", world_w2_phase, dev)
    (flag, flag_sw, flag_nd, flag_sb, flag_mb, launches_mesh, launches_search,
     match_kres, b3_replay) = timed("match_phases", match_phases, dev, unstaged)
    kres.update(match_kres)
    kres["monotone_gather"]["batch_replay_ms"] = b3_replay
    drv = timed("driver_phase", driver_phase, dev)
    try:
        launches_w1 = timed("world_w1_phase", world_w1_phase, dev, drv)
    finally:
        shutil.rmtree(drv["work"], ignore_errors=True)
    launches_matrix = timed("config_matrix_phase", config_matrix_phase, dev)
    routes = timed("long_read_routes", long_read_routes, dev, unstaged)
    launches_scale = timed("scale_run_phase", scale_run_phase, dev)
    timed("tool_run_phases", tool_run_phases, dev)
    print(f"phase seconds: {json.dumps(phase_s)}; whole run {time.perf_counter() - t_start:.1f}s",
          flush=True)

    # Each kernel's "launches": the counted run of the path it is on (the
    # default flagship; B6 the switched one; B8 the 16-batch flagship, whose
    # batches take the direct probe; B9 the binary search-parity run; B10
    # the streaming flagship).
    main_run = {"expand_owners_sub": flag_sw["launches"],
                "direct_probe": flag_sb["launches"],
                "binary_probe": launches_search["search_binary"],
                "verify_pairs": flag_nd["launches"]}
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1],
         "launches": main_run.get(name, flag["launches"])[name],
         "launches_switched": flag_sw["launches"][name],
         "launches_streaming": flag_nd["launches"][name],
         "launches_small_batch": flag_sb["launches"][name],
         "launches_multi_batch": flag_mb["launches"][name],
         "launches_mesh": launches_mesh[name],
         "launches_scale_run": launches_scale[name],
         "launches_search_direct": launches_search["search_direct"][name],
         "launches_search_binary": launches_search["search_binary"][name],
         "launches_config_matrix": launches_matrix[name],
         "launches_big_index": launches_big[name],
         "launches_gene_sharded": launches_sharded[name],
         "launches_world": launches_w1[name] + w2["launches"][name],
         **({"w2_shard": w2[name]} if name in w2 else {}),
         "max_abs_err": kres[name]["max_abs_err"], "ms": kres[name]["ms"],
         "plain_ms": kres[name]["plain_ms"], "bound_ms": kres[name]["bound_ms"],
         "bound_by": kres[name]["bound_by"], "library_ms": kres[name]["library_ms"],
         "bytes_bound_ms": kres[name]["bytes_bound_ms"],
         "ops_bound_ms": kres[name]["ops_bound_ms"],
         "back_to_back_ms": kres[name]["back_to_back_ms"],
         "library_back_to_back_ms": kres[name]["library_back_to_back_ms"],
         **{k: kres[name][k] for k in ("sector_bound_ms", "floor_ms", "floor_sectors",
                                        "floor_bytes", "builds_in_turns", "batch_replay_ms")
            if k in kres[name]},
         **({"long_read_routes_ms": routes[name]} if name in routes else {})}
        for name in KERNELS
    ]}
    print(smi.stdout.strip(), flush=True)  # again, beside the numbers it qualifies
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        mesh_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
        sys.exit(0)
    if sys.argv[1:2] == ["--stream-cell"]:
        stream_cell(sys.argv[2] if len(sys.argv) > 2 else ",".join(STREAM_PATH))
        sys.exit(0)
    sys.exit(main())
