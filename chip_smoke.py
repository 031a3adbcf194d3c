#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (mhm2_proxy_tpu_torch).

    python3 chip_smoke.py                          # every phase, one GPU
    python3 chip_smoke.py --only callers [DIR]     # phase 2's whole-call rows
    python3 chip_smoke.py --only ladder [DIR]      # phase 5, kernels metered
    python3 chip_smoke.py --only stitch [DIR]      # phase 5b on the k = 21 round alone
    python3 chip_smoke.py --only kernels [DIR]     # phase 2's extract, range cuts,
                                                   # finalize, join, scan (+ collapse
                                                   # compact), ssw and minimizer rows
    python3 chip_smoke.py --only sharded [DIR]     # phase 8 alone, the minimizer metered
    python3 chip_smoke.py --only hosts [DIR]       # phase 9 alone, the supermer stage metered
    python3 chip_smoke.py --only multiproc [DIR]   # phase 10 alone (CLI ranks, one card)
    python3 chip_smoke.py --only lookup [DIR]      # phase 2's lookup rows
    python3 chip_smoke.py --only merge [DIR]       # phase 5m alone (the pair merge)

(DIR: the checkout whose mhm2_proxy_tpu_torch to run, default this one, so
that another tree, e.g. a parent commit unpacked beside it, is timed on the
same inputs.)

Phases (any failure raises, and the script exits non-zero):
  1. the card (nvidia-smi name and power limit), torch/CUDA versions, and the
     build of the CUDA kernels from csrc/ (one nvcc per source, in
     parallel);
  2. each kernel against its plain PyTorch version on CUDA tensors at the
     main path's shapes, bit-exact (integers, tolerance 0), with times, the
     bound of each measurement (the larger of its bytes over the HBM rate
     and its integer operations over the card's int32 rate) and, where one
     PyTorch call computes the same function, that call's time; the
     extract kernel on read blocks at k = 21-77 (also 150 bp rows),
     contig windows and the supermer receiver's (524,288, nb) windows at
     k = 21, 33, 55, 77, 99; the ssw kernel on 65,536 read/window pairs under four
     scoring profiles, one past a signed byte, and at 2 x 150 bp reads
     (Lq 150, Lr 214); the range cuts of a ranged fold on 12 sorted runs
     of 100M rows, Q = 17, with the host path they replace timed beside
     them; the minimizer kernel on 131,072-read blocks at
     k = 21, 33, 55, 77, 99 with 4 shards, a (2048, 2048) contig-window
     block and 4096 shards; the finalize kernel (group sums, calls, purge
     and compaction in one launch) on two merged read blocks at k = 21 and
     at k = 77 (separate payload), purge on and off; the join kernel at
     the k = 21 edge join's shapes (fused lanes, separate lanes, and the
     ladder's all-ones mix) and at
     the k = 77 and 99 joins' (6 and 8 key lanes, 75,497,472 merged rows);
     table_lookup and table_join (the sort and join kernels) on CUDA
     against the CPU at a 30M-row index and 327,680 queries, and rank_rows
     (lower and upper) on a 30M-row table whose keys each appear twice; the count
     store + traversal on CUDA against the same on the CPU at
     k = 21, 33, 55, 63, 77, 99 (every instantiation of the kernels' templates),
     and at each k the split LSM on CUDA (every push collapsed, the cascade
     merging or deferring, ranged folds) against the CPU's raw-path table;
     and the sharded store (4 shards, a small bucket cap: spill rounds, a
     contig pass) on CUDA against the CPU at k = 21 and 77: per-shard
     tables, exchange statistics, sharded_lookup's answers, contigs and
     stitch rounds, and the same for HierarchicalCounter over 2 hosts x 2
     devices with supermers and for the flat counter with supermers; the
     analog of __graft_entry__.dryrun_multichip(8) on CUDA (2 x 4 with
     supermers, skewed reads, spill rounds, a contig pass, lookups, the
     sharded traversal against the single-device assembly, and the 1.1M
     k-mer poly-A volume phase) against MULTICHIP_r05.json's counts; and
     the compact, sort and finalize kernels' main
     callers as whole calls (_merge_sorted_sets, _compact_keep, _split_emit
     at real widths, final_from_sorted_packed and final_from_sorted_sep on
     the finalize rows' runs), kernel and torch around it, against the
     same calls through the plain versions on the card;
  3. the CI sample (ci/make_sample.py's default community, regenerated with
     the port's synth) end to end through the CLI entry point with
     --post-asm-align --post-asm-abundance, then --post-asm-only on the same
     directory (as ci/ci_post_asm_test.sh runs them): the FASTA, SAM (without
     @PG) and depth digests of the JAX package, ci/good-synth-sample-k2133.txt,
     ci/good-synth-postasm.txt and ci/good-synth-postasm-only.txt, and
     ci/check_post_asm.py's structural SAM check; then the CI sample with
     --shards 4: the JAX package's --shards 4 FASTA digest and the sharded
     path's five kernels launched; then with --hosts 2 --shards 4: the JAX
     package's digest for those flags and the five kernels launched;
  4. the --arctic-scale community cut to 3 genomes (6.75 Mbp, 8x, 100 bp
     pairs, k = 21 33), checked against the JAX package's FASTA digest,
     the launch counts of its five kernels > 0, and >= 95% of the assembled
     bases in exact substrings of the genomes; then the same reads at
     --hosts 2 --shards 4 -k 21 in blocks of 4096 reads: the exchange's
     records, k-mers, presummed and re-sent rows and spill rounds equal the
     JAX package's (ARCTIC3_HOSTS2_K21_EXCHANGE);
  5. the full --arctic-scale community (12 genomes, 27 Mbp, 2.16M reads)
     through the CLI with the default k ladder 21 33 55 77 99: per-k
     counting log (blocks, raw rows, split-LSM collapses, cascade merges and
     deferrals, ranged pieces, table rows, peak device memory), all six
     contigging launch counts > 0, each kernel's device ms over the ladder
     (a CUDA event pair around every call of its C entry; each join call
     with its shape), at least one collapse, one ranged read fold and one
     ranged ctg-rule fold, >= 95% exact-substring bases, and the k = 21
     edge join's shape (trimmed table rows, valid and UU rows, all-ones
     table rows and queries, the longest equal-key run), and every round's
     traversal and stitch lines (each stitch stage's seconds: the run
     records its spans, utils/trace.py, and logs their table);
  5b. the stitch on CUDA on phase 5's k = 21 table against the native
     sequential walker on the same states after the same repair (equal
     sorted contig lists): states, paths emitted and kept, each stage's
     seconds, the bytes fetched, the stitch's peak device memory, the
     walker's seconds;
  5m. the pair merge on the card (io/merge.py, the shortlist scan and the
     dense rerun of overflowing rows) against the native merge on every pair
     of phase 5's community in the CLI's blocks (every key equal, the
     ambiguity counts summed): both merges' seconds (the card's by CUDA
     events, copies included, and the copies alone), blocks and rows rerun
     densely, the device peak; then an adversarial block (poly-A,
     dinucleotide, triplet and N-rich repeats) that must overflow, where the
     dense scan, the wrapper and the native merge agree; then the CI sample
     through the CLI in a child process with MHM2_NO_NATIVE_MERGE=1: the
     JAX package's FASTA digest and ci/good-synth-sample-k2133.txt;
  6. store-level equality on that community's reads plus contig windows cut
     from its genomes, at k = 33 (k = 77's separate payload runs the forced
     split LSM in phase 2):
     the count store with the collapse, deferred cascades and ranged folds
     forced gives the table of the raw-only path (digest of words, count,
     left, right);
  7. --post-asm-only --post-asm-align --post-asm-abundance on phase 5's
     output: every read aligned to the 27 Mbp assembly; reads aligned,
     identity, the stage's times, the ssw launches, cells and GCUPS;
     ci/check_post_asm.py's structural check; and the first 16,384 reads
     aligned on CUDA and on the CPU against the same index give equal
     results (contig, score, begins, ends, CIGARs, NM);
  8. the full community again with --shards 4 (4 shards on the card) on the
     default ladder: per round the exchange (records, MiB, k-mers a record,
     presummed and re-sent rows, spill rounds), the stitch rounds and their
     all_to_all bytes, counting and traversal walls and peak device memory;
     the minimizer, extract, sort, scan and compact launch counts > 0; the
     union of the k = 21 shard tables equals phase 5's single-device table;
     >= 95% exact-substring bases; and how many printed contigs differ from
     phase 5's (only cycle break points may);
  9. the full community again with --hosts 2 --shards 4 (2 hosts x 2
     devices, supermers through the hierarchical two-stage exchange, on the
     card) on the default ladder: per round the exchange beside phase 8's
     (records, MiB, k-mers a record), presummed and re-sent rows, spill
     rounds, counting and traversal walls, the supermer stage's device ms
     and peaks (build_supermers, expand_supermers) and peak device memory;
     the sharded path's five launch counts > 0; each k = 21 shard table
     equals phase 8's shard for shard; final_assembly.fasta is
     byte-identical to phase 8's; >= 95% exact-substring bases;
 10. CLI ranks over torch.distributed on the one card (main.main joined by
     MHM2_TPU_NUM_PROCS / MHM2_TPU_PROC_ID / MHM2_TPU_COORDINATOR), the
     community at k = 21 with --hosts 2 --shards 4: two ranks that share
     the card (gloo), then one rank (NCCL), each against the single-process
     CLI at the same layout: final_assembly.fasta and contigs-21.fasta
     byte for byte, the backend in the log; each gloo rank's per-rank log
     and its sharded-path launch counts > 0.
Prints the kernels' JSON summary (launch counts of phase 5, ssw's of phase
7, minimizer's of phase 8, hosts_launches: phase 9's, multiproc_launches:
phase 10's two gloo ranks' together; ladder_ms: phase 5's
device ms, minimizer's of phase 8, metered the same way), then the card
line, then as the last line
{"ok": true, "device": {...}}. Without CUDA it exits 2, and without the
mhm2_proxy_tpu_torch package beside it 3, printing no result. Work files go
to chip_smoke_work/ next to this script (removed at the end).
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# sha256 digests, from the JAX package on the CPU (see CHANGES.md)
CI_FASTQ_SHA256 = "d0409d7f481511021635839eb02cc4c264371be2afda1f68b8e5f4e85a817c98"
CI_FASTA_SHA256 = "a17c6e42edf61813c7d47128a0efa75f6461930485cc80dfbe31152ce664b2f3"
# the JAX package's `-k 21 33 --shards 4` on the CI sample (4 virtual CPU
# devices): not CI_FASTA_SHA256, since the sharded branch keeps every path
# (no min_ctg_len) and breaks cycles at the least (shard, row) node
CI_SHARDS4_FASTA_SHA256 = "836b8d88f13b4741e9b8adf5c90457ba10020459711a8fa0707bb4beaba8393f"
# the JAX package's `-k 21 33 --shards 4 --hosts 2` on the CI sample (the 8
# virtual CPU devices as a 2 x 4 mesh, 4 of them used as 2 x 2;
# `python -m mhm2_proxy_tpu -r synth_sample.fastq -k 21 33 --shards 4
# --hosts 2`): the --shards 4 digest, since the host-major shards are the
# flat layout's shards and hold the same tables
CI_HOSTS2_FASTA_SHA256 = "836b8d88f13b4741e9b8adf5c90457ba10020459711a8fa0707bb4beaba8393f"
ARCTIC3_FASTQ_SHA256 = "491bd9fb910e892ec85dc9dd8d8358aaaddc598794d4b6f1aaa78b08cf43be15"
ARCTIC3_FASTA_SHA256 = "b9863311bb0099aea359a6dbeb623bce8910e665ca86a2f609f1a4242219a2bb"
# the JAX package's exchange line for that cut at `-k 21 --hosts 2 --shards
# 4` on the CPU (8 virtual devices, its CPU block of 4096 reads: `python -m
# mhm2_proxy_tpu -r arctic-scale.fastq -k 21 --hosts 2 --shards 4`): "8701453
# records (199 MiB all_to_all) for 42063880 kmers (4.8 kmers/record), 34522
# presummed, 0 re-sent in 0 spill rounds"; as (records, k-mers, presummed,
# re-sent, spill rounds)
ARCTIC3_HOSTS2_K21_EXCHANGE = (8701453, 42063880, 34522, 0, 0)
# the full community's FASTQ, computed with the same generator on the CPU
ARCTIC12_FASTQ_SHA256 = "d6a96821ddd735107a23b4cb83ee64ebd619551136cc657648ecc07d3334aa3c"
# the JAX package's post-assembly files for the CI sample on the CPU
# (`python -m mhm2_proxy_tpu -r synth_sample.fastq -k 21 33 --post-asm-align
# --post-asm-abundance --block-reads 131072`, then `--post-asm-only`): the
# SAM without its @PG line. Both packages list the reads in their packed
# order, which follows the ingest block (merged reads, then unmerged mates,
# block by block), so the reference runs with the port's CUDA default block
# of 131072 reads (its own TPU default); its CPU default of 4096 orders the
# same records differently.
CI_SAM_SHA256 = "d142134bd49b9eeb3dc767d2ed26e9fb0f7dc1b8a176edaf190d8c0843907dd2"
CI_DEPTHS_SHA256 = "133639f26e2311d5fc7000d19cdeeff27cbb44cf1abf39313780af6e9c970fe3"
CI_ONLY_SAM_SHA256 = "833d592c07369643a09e1ebb2fe4b41707885a11e2b91a4b2bb1c897e63d2d39"
CI_ONLY_DEPTHS_SHA256 = "19af43f8d7a74acc228a59a2b4ccd79eb6dc6ab72c5538cabbddcaeee0b48560"
# ci/good-synth-postasm.txt predates the JAX package's drop of contigs
# shorter than k + 2 (a07afb1): the package itself now writes 81 depth rows
# (mean depth 1.398), not the file's 85 (1.332). Those two metrics are held
# to the package's values; the others to the file.
CI_POSTASM_STALE = {"abundance_contigs": 81, "mean_depth": 1.398}

# bounds: HBM3 bytes a second and int32 lanes per SM of an H100 SXM (NVIDIA's
# data sheet); the SM count and clock are read from the card
HBM_BYTES_PER_S = 3.35e12
INT32_LANES_PER_SM = 64
# each function's own integer operations per row (per k-mer position for
# extract, per output row for sort, per DP cell for ssw), not a kernel's
# search, scan, index or loop overhead
OPS_PER_ROW = dict(
    # 9 one-hot decodes and sums, the ext calls, the purge test (32), and the
    # kept row's class test, count and destination (3)
    finalize=35,
    compact=3,  # class test, count, destination
    scan_packed=28,  # 9 one-hot decodes and sums, the key compare, 5 packs
    # the least the recurrence of csrc/ssw.cu's note needs, with sm_90's DPX
    # forms and a byte permute as one instruction each: substitution 1 (a
    # permute of the row's score bytes); E 2 (ep - ge, add-max); Hn 1
    # (add-max with the 0 floor); H 1 and F 1 (add-max each, with f carried
    # as f + i ge); best 1.5 (the packed key, and half of a 3-way max)
    ssw=7.5,
)


# the kernels that the k = 21 33 runs of phases 3 and 4 go through (their
# raw runs stay under the byte budget: no scan)
K21_33_KERNELS = ("extract", "sort", "finalize", "compact", "join")
# the kernels of the sharded path (--shards S > 1): records and their
# target shards, the receivers' aggregation (lexsort, scan, compact) and the
# LSM's merges
SHARDED_KERNELS = ("minimizer", "extract", "sort", "scan", "compact")


# each hand kernel's C entry points (csrc/, called through kernels.lib())
C_ENTRIES = {
    "mhm2_extract": "extract", "mhm2_merge": "sort", "mhm2_finalize": "finalize",
    "mhm2_compact": "compact", "mhm2_join": "join", "mhm2_join_sep": "join",
    "mhm2_scan_lanes": "scan", "mhm2_scan_packed": "scan", "mhm2_ssw": "ssw",
    "mhm2_minimizer": "minimizer", "mhm2_range_cuts": "range_cuts",
}
# the kernels that phase 5's ladder launches
LADDER_KERNELS = ("extract", "sort", "finalize", "compact", "join", "scan", "range_cuts")


def log(*a):
    print(*a, flush=True)


def check(ok, what):
    """A failed check ends the run (explicit, so `python -O` keeps it)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def make_community(out_dir, name, genomes, genome_len, step, coverage, read_len, seed, arctic):
    """ci/make_sample.py's generator (same rng call order) on the port's
    synth: genome FASTAs + one interleaved paired FASTQ."""
    import numpy as np

    from mhm2_proxy_tpu_torch.io.fasta import write_fasta
    from mhm2_proxy_tpu_torch.io.fastq import write_fastq
    from mhm2_proxy_tpu_torch.utils.synth import random_genome, simulate_reads

    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    all_ids, all_seqs, all_quals, gens = [], [], [], []
    for g in range(genomes):
        cov = coverage if arctic else coverage * (1.0 + 0.5 * (g % 4))
        genome = random_genome(rng, genome_len + step * g)
        gens.append(genome)
        write_fasta(os.path.join(out_dir, f"{name}-genome{g}.fasta"), [(g, genome, 1.0)])
        ids, seqs, quals = simulate_reads(
            rng, genome, coverage=cov, read_len=read_len, insert_mean=260, insert_sd=40,
            err_rate=0.002 if arctic else 0.004,
        )
        all_ids.extend(f"g{g}.{i.decode()}".encode() for i in ids)
        all_seqs.extend(seqs)
        all_quals.extend(quals)
    order = rng.permutation(len(all_seqs) // 2)
    ids, seqs, quals = [], [], []
    for p in order:
        for j in (0, 1):
            ids.append(all_ids[2 * p + j])
            seqs.append(all_seqs[2 * p + j])
            quals.append(all_quals[2 * p + j])
    fq = os.path.join(out_dir, f"{name}.fastq")
    write_fastq(fq, ids, seqs, quals)
    return fq, gens, len(order)


def read_fasta_seqs(path):
    from mhm2_proxy_tpu_torch.io.fasta import read_fasta

    return [s for _, s in read_fasta(path)]


def asm_metrics(seqs):
    lens = sorted((len(s) for s in seqs), reverse=True)
    tot = sum(lens)
    acc, n50 = 0, 0
    for ln in lens:
        acc += ln
        if acc >= tot / 2:
            n50 = ln
            break
    return dict(num_contigs=len(lens), total_length=tot,
                largest_contig=lens[0] if lens else 0, n50=n50)


def exact_substring_bases(seqs, gens, K: int = 24):
    """Bases of the contigs that are exact substrings of a genome or its
    reverse complement: each contig's first K-mer is looked up in a sorted
    index of every K-mer of the genomes (numpy, built once for a set of
    genomes), and the candidates are compared in full."""
    import numpy as np

    text, lut, skey, spos = _substring_index(tuple(gens), K)
    match = 0
    for sq in seqs:
        b = sq.encode()
        if len(b) < K:
            match += len(b) if b in text else 0
            continue
        c = np.uint64(0)
        for ch in lut[np.frombuffer(b[:K], np.uint8)]:
            c = (c << np.uint64(2)) | np.uint64(ch & 3)
        lo, hi = np.searchsorted(skey, c, "left"), np.searchsorted(skey, c, "right")
        if any(text[p : p + len(b)] == b for p in spos[lo:hi]):
            match += len(b)
    return match


@functools.lru_cache(maxsize=1)
def _substring_index(gens: tuple, K: int):
    """The genomes and their reverse complements as one text, the base
    lookup table, and every K-mer's key and position sorted by key."""
    import numpy as np

    from mhm2_proxy_tpu_torch.io.gfa import revcomp_str

    text = "$".join(list(gens) + [revcomp_str(g) for g in gens]).encode()
    arr = np.frombuffer(text, np.uint8)
    lut = np.full(256, 4, np.uint8)
    for i, c in enumerate(b"ACGT"):
        lut[c] = i
    codes = lut[arr].astype(np.uint64)
    n = codes.size - K + 1
    key = np.zeros(n, np.uint64)
    bad = np.zeros(n, bool)
    for j in range(K):
        key = (key << np.uint64(2)) | (codes[j : j + n] & np.uint64(3))
        bad |= codes[j : j + n] == 4
    pos = np.nonzero(~bad)[0]
    order = np.argsort(key[pos], kind="stable")
    return text, lut, key[pos][order], pos[order]


def parse_run_log(path):
    """Per-k counting lines and [module] wall times from mhm2_torch.log."""
    rounds, modules = {}, {}
    pat = re.compile(r"k=(\d+): counted (\d+) kmers from (\d+) blocks in [\d.]+s "
                     r"\(raw rows (\d+), raw bytes (\d+), ctg-rule rows (\d+)\)")
    lsm = re.compile(r"k=(\d+): split LSM collapses (\d+), cascade merges (\d+), deferrals "
                     r"(\d+); ranged pieces read (\d+), ctg-rule (\d+); peak device memory "
                     r"(\d+) bytes")
    for line in open(path):
        m = pat.search(line)
        if m:
            k, kmers, blocks, rows, nbytes, ctg = map(int, m.groups())
            rounds[k] = dict(kmers=kmers, blocks=blocks, raw_rows=rows, raw_bytes=nbytes,
                             ctg_rule_rows=ctg)
        m = lsm.search(line)
        if m:
            k, *vals = map(int, m.groups())
            rounds[k].update(zip(("collapses", "cascade_merges", "deferrals", "read_pieces",
                                  "ctg_pieces", "peak_bytes"), vals))
        m = re.search(r"\[module\] (.+) ([\d.]+)s$", line.strip())
        if m:
            modules[m.group(1)] = float(m.group(2))
    return rounds, modules


# ---------------------------------------------------------------------------
# phase 2: kernel vs plain version
# ---------------------------------------------------------------------------


# cuda_ms times at least this many ms of back-to-back calls: a mean over
# three calls of a sub-0.1 ms kernel also spans the host's launch of the
# first call
TIMED_MIN_MS = 20.0


def cuda_ms(fn, reps: int = 3) -> float:
    """Mean device ms of fn over back-to-back calls after a warm-up: `reps`
    calls, or, when those take less than TIMED_MIN_MS in all, as many as
    fill it (at most 200)."""
    import torch

    def timed(n):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(n):
            fn()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / n

    fn()
    torch.cuda.synchronize()
    ms = timed(reps)
    if ms * reps < TIMED_MIN_MS:
        ms = timed(min(200, max(reps, int(TIMED_MIN_MS / max(ms, 1e-3)) + 1)))
    return ms


def nbytes(*tensors) -> int:
    """Bytes of the given tensors (nested tuples flattened)."""
    n = 0
    for t in tensors:
        if isinstance(t, (tuple, list)):
            n += nbytes(*t)
        elif t is not None:
            n += t.numel() * t.element_size()
    return n


def int32_ops_per_s() -> float:
    """The card's int32 rate: SMs x 64 int32 lanes x the SM clock that
    nvidia-smi reports as its maximum. A DPX instruction (a fused add-max
    or 3-way max, optionally floored at 0) counts as one operation at this
    rate."""
    import torch

    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INT32_LANES_PER_SM * mhz * 1e6


def bound(io_bytes: int, ops: int, int_rate: float):
    """(bound ms, what binds): the larger of the bytes over the HBM rate and
    the operations over the int32 rate."""
    b = io_bytes / HBM_BYTES_PER_S * 1e3
    o = ops / int_rate * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


def max_abs_err(a, b) -> int:
    """Max |a - b| over int32 lane tuples read as u32 (shapes must match)."""
    from mhm2_proxy_tpu_torch.ops.u32 import widen

    a, b = tuple(a), tuple(b)
    check(len(a) == len(b), (len(a), len(b)))
    err = 0
    for x, y in zip(a, b):
        check(x.shape == y.shape, (x.shape, y.shape))
        if x.numel():
            err = max(err, int((widen(x) - widen(y)).abs().max()))
    return err


def pair_key(lanes):
    """One int64 per row whose signed order is the unsigned order of the
    row's (at most two) u32 key lanes."""
    from mhm2_proxy_tpu_torch.ops.u32 import widen

    if len(lanes) == 1:
        return widen(lanes[0])
    return (widen(lanes[0]) - (1 << 31)) * (1 << 32) + widen(lanes[1])


def random_sorted_run(n, n_lanes, kw, gen, dup_from=None, sent_frac=0.02):
    """A lexsorted run: random u32 keys (bit 31 set on about half), a tail of
    all-ones sentinels, optional keys copied from `dup_from` (equal keys
    across the two runs), random non-key lanes."""
    import torch

    from mhm2_proxy_tpu_torch.ops.u32 import lexsort_lanes

    dev = "cuda"
    lanes = [torch.randint(-2**31, 2**31, (n,), dtype=torch.int32, device=dev, generator=gen)
             for _ in range(n_lanes)]
    if dup_from is not None and n:
        m = dup_from[0].shape[0]
        pick = torch.randint(0, max(m, 1), (n // 2,), device=dev, generator=gen)
        for i in range(kw):
            lanes[i][: n // 2] = dup_from[i][pick]
    n_sent = int(n * sent_frac)
    for i in range(kw):
        lanes[i][n - n_sent:] = -1
    return lexsort_lanes(tuple(lanes), kw)


def sim_read_block(genome_codes, B, L, read_len, gen):
    """B reads of read_len bases at random genome positions with 0.2% base
    errors and 5% low-quality bases, padded to L (device tensors)."""
    import torch

    dev = "cuda"
    G = genome_codes.shape[0]
    start = torch.randint(0, G - read_len, (B,), device=dev, generator=gen)
    idx = start[:, None] + torch.arange(read_len, device=dev)[None, :]
    reads = genome_codes[idx]
    err = torch.rand((B, read_len), device=dev, generator=gen) < 0.002
    shift = torch.randint(1, 4, (B, read_len), device=dev, generator=gen, dtype=torch.uint8)
    reads = torch.where(err, (reads + shift) % 4, reads)
    codes = torch.full((B, L), 4, dtype=torch.uint8, device=dev)
    codes[:, :read_len] = reads
    qual = torch.rand((B, L), device=dev, generator=gen) > 0.05
    lens = torch.full((B,), read_len, dtype=torch.int32, device=dev)
    return codes, qual, lens


def make_recorder(results):
    """record(name, err, ms, plain_ms, what, io_bytes, ops, library_ms=None):
    logs one phase-2 measurement with its bound, fails on any disagreement,
    and keeps each kernel's first (main-path shape) row in `results`."""
    int_rate = int32_ops_per_s()
    log(f"[bound] HBM {HBM_BYTES_PER_S / 1e12:.2f} TB/s, int32 {int_rate / 1e12:.3f} Tops/s")

    def record(name, err, ms, plain_ms, what, io_bytes, ops, library_ms=None):
        bound_ms, bound_by = bound(io_bytes, ops, int_rate)
        lib = "none" if library_ms is None else f"{library_ms:.3f} ms"
        log(f"[kernel] {name:8s} {what}: max_abs_err={err} kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}: {io_bytes} bytes, "
            f"{ops} ops), library {lib}")
        check(err == 0, f"{name} disagrees with its plain version ({what}): max_abs_err={err}")
        r = results.setdefault(name, dict(max_abs_err=0, ms=None))
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if r["ms"] is None:  # the first, main-path-shape measurement is reported
            r.update(ms=ms, plain_ms=plain_ms, shape=what, bound_ms=bound_ms,
                     bound_by=bound_by, library_ms=library_ms)

    return record


def phase_extract(record, gen):
    """The extract kernel against its plain version: read blocks (131072,
    128), packed, k = 21 and 33; contig windows (2048, 2048) in the record
    layout; (131072, 128) at k = 63 and 77 (record); 150 bp reads
    unpadded, (131072, 150) k = 21 packed (rows not 16-byte multiples);
    and the supermer receiver's windows, (524288, nb) in the record layout
    at k = 21, 33, 55, 77, 99 (nb = k + 25: 46, 58, 80, 102, 124 bases;
    lens n + k + 1 with n = 1..24 k-mers, as expand_supermers gives)."""
    import torch

    from mhm2_proxy_tpu_torch.ops import extract

    dev = "cuda"
    windows = tuple((k, (1 << 19, k + 25), False) for k in (21, 33, 55, 77, 99))
    for k, (B, L), packed in ((21, (131072, 128), True), (33, (131072, 128), True),
                              (33, (2048, 2048), False), (63, (131072, 128), False),
                              (77, (131072, 128), False), (21, (131072, 150), True)) + windows:
        window = (k, (B, L), packed) in windows
        codes = torch.randint(0, 4 if window else 5, (B, L), dtype=torch.uint8, device=dev,
                              generator=gen)
        qual = torch.rand((B, L), device=dev, generator=gen) > 0.05
        lo = k + 2 if window else k - 2
        lens = torch.randint(lo, L + 1, (B,), dtype=torch.int32, device=dev, generator=gen)
        kern = lambda: extract._extract(codes, qual, lens, k, packed)  # noqa: E731
        plain = lambda: extract._extract_plain(codes, qual, lens, k, packed)  # noqa: E731
        out = kern()
        err = max_abs_err(out, plain())
        # per k-mer position: a shift, an or and a complement per word for the
        # k-mer and its reverse complement, the canonical compare, the exts
        ops = B * (L - k + 1) * (8 * len(out) + 12)
        record("extract", err, cuda_ms(kern), cuda_ms(plain),
               f"({B}, {L}) k={k} {'packed' if packed else 'record'}"
               f"{' supermer windows' if window else ''}",
               nbytes(codes, qual, lens, out), ops)
        del out


def phase_kernels(results):
    import torch

    from mhm2_proxy_tpu_torch.ops import compact, sort

    gen = torch.Generator(device="cuda")
    gen.manual_seed(20260817)
    dev = "cuda"
    record = make_recorder(results)
    phase_extract(record, gen)

    # sort: the 1120-tile merge (7,340,032 + 29,360,128 rows = 36,700,160),
    # two odd-length merges, and a kw = 4 + payload merge at a join shape
    cases = [
        ("1120-tile merge 7340032+29360128 kw=2", 7_340_032, 29_360_128, 2, 2),
        ("odd merge 1000003+2999999 kw=3", 1_000_003, 2_999_999, 3, 3),
        ("odd merge 12345+1 kw=2 +1 payload", 12_345, 1, 2, 3),
        ("merge 7000001+14000002 kw=4 +1 payload", 7_000_001, 14_000_002, 4, 5),
    ]
    for what, na, nb, kw, n_lanes in cases:
        a = random_sorted_run(na, n_lanes, kw, gen)
        b = random_sorted_run(nb, n_lanes, kw, gen, dup_from=a)
        kern = lambda: sort._merge_cuda(a, b, kw, False)  # noqa: E731
        plain = lambda: sort._merge_plain(a, b, kw, False)  # noqa: E731
        out = kern()
        err = max_abs_err(out, plain())
        library_ms = None
        if n_lanes == kw <= 2:
            # torch.sort of the concatenated keys, packed into one order-preserving int64
            key = torch.cat([pair_key(a), pair_key(b)])
            library_ms = cuda_ms(lambda: torch.sort(key, stable=True))
            del key
        # per output row: the key compare (kw words) and the select
        record("sort", err, cuda_ms(kern), cuda_ms(plain), what, nbytes(a, b, out),
               (na + nb) * (2 * kw + 2), library_ms)
        del a, b, out

    phase_range_cuts(record, gen)
    genome = phase_finalize(record, gen)
    # compact: 2-class at 36,700,160 rows, 3 lanes, emit class 0 (a fifth of
    # the rows), rows past the count unwritten, as the library call; int32
    # class flags, then the same rows as a bool keep mask
    N = 36_700_160
    lanes = tuple(torch.randint(-2**31, 2**31, (N,), dtype=torch.int32, device=dev, generator=gen)
                  for _ in range(3))
    flags = (torch.rand((N,), device=dev, generator=gen) > 0.2).to(torch.int32)
    layout = (((0,), (1,), (2,)),)
    stacked, keep = torch.stack(lanes, 1), flags == 0
    # one class emitted: boolean-mask indexing of the stacked lanes
    library_ms = cuda_ms(lambda: stacked[keep])
    del stacked
    for what, fl in ((f"{N} rows 2-class", flags), (f"{N} rows bool keep mask", keep)):
        kern = lambda: compact._compact_cuda(lanes, fl, 2, (0,), layout, None)  # noqa: E731
        plain = lambda: compact._compact_plain(lanes, fl, (0,), layout, None)  # noqa: E731
        ((ko,), kn), ((po,), pn) = kern(), plain()
        n = int(pn[0])
        err = abs(int(kn[0]) - n) + max_abs_err(tuple(x[:n] for x in ko), tuple(x[:n] for x in po))
        # bytes: the flags, and the emitted rows' lanes read and written (the
        # kernel gathers only those rows)
        record("compact", err, cuda_ms(kern), cuda_ms(plain), what,
               nbytes(fl) + 2 * 12 * n, N * OPS_PER_ROW["compact"], library_ms)
    del lanes, flags, keep

    phase_join(record, gen)
    phase_collapse_kernels(record, genome, gen)
    phase_ssw(record, gen)
    phase_minimizer(record, gen)
    phase_lookup(gen)
    torch.cuda.empty_cache()


def phase_range_cuts(record, gen):
    """The range cuts of a ranged fold against their plain version (both on
    the card): 12 runs of word 0 of (n, 2) words, 100,000,000 live rows,
    Q = 17 (6M rows a range), a third of the runs 2^20 distinct keys; and,
    for the record, the host path it replaces on the same runs (each word 0
    copied out, np.quantile over their concatenation, np.searchsorted)."""
    import numpy as np
    import torch

    from mhm2_proxy_tpu_torch.ops import sort

    runs, counts = [], []
    for j in range(12):
        n = 100_000_000 // 12 + j
        w = torch.randint(-2**31, 2**31, (n + 5, 2), dtype=torch.int32, device="cuda",
                          generator=gen)
        if j % 3 == 0:
            w[:, 0] &= (1 << 20) - 1
        w[:n, 0] = torch.sort(w[:n, 0].to(torch.int64) & 0xFFFFFFFF).values.to(torch.int32)
        w[n:] = -1
        runs.append(w[:, 0])
        counts.append(n)
    Q = 17
    kern = lambda: sort._range_select_cuda(runs, counts, Q)  # noqa: E731
    plain = lambda: sort._range_select_plain(runs, counts, Q)  # noqa: E731
    (kc, ke), (pc, pe) = kern(), plain()
    err = max(int((kc - pc).abs().max()), int((ke - pe).abs().max()))
    t0 = time.perf_counter()
    w0 = [x[:n].cpu().numpy().view(np.uint32) for x, n in zip(runs, counts)]
    edges = np.quantile(np.concatenate(w0), np.arange(1, Q) / Q).astype(np.uint32)
    host_cuts = [np.searchsorted(x, edges, "left") for x in w0]
    host_s = time.perf_counter() - t0
    del w0, host_cuts
    # the dependent loads: one binary search a run at each of the 33 steps
    # of an edge (32 bisection steps and the cut), 4 bytes each; the cuts
    # written
    loads = (Q - 1) * 33 * sum(max(1, n).bit_length() for n in counts)
    io_bytes = 4 * loads + 8 * (len(runs) * (Q + 1) + Q - 1)
    what = f"12 runs, {sum(counts)} rows of (n, 2) word 0, Q={Q}"
    record("range_cuts", err, cuda_ms(kern), cuda_ms(plain), what, io_bytes, 3 * loads)
    log(f"[kernel] range_cuts host path it replaces ({what}): copy, np.quantile and "
        f"searchsorted {host_s:.3f} s")
    del runs
    torch.cuda.empty_cache()


def finalize_runs(gen):
    """The finalize inputs of the main path: a 2.25 Mbp genome, and two
    extracted read blocks of it (131072 x 100 bp reads) merged, packed at
    k = 21 (28,311,552 rows) and key-sorted with a separate payload at
    k = 77 (13,631,488 rows; its 5 key lanes, then the payload lane)."""
    import torch

    from mhm2_proxy_tpu_torch.ops import count, extract, sort
    from mhm2_proxy_tpu_torch.ops.u32 import lexsort_lanes

    genome = torch.randint(0, 4, (2_250_000,), dtype=torch.uint8, device="cuda", generator=gen)
    packed, sep = [], []
    for _ in range(2):
        codes, qual, lens = sim_read_block(genome, 131072, 128, 100, gen)
        packed.append(lexsort_lanes(extract._extract(codes, qual, lens, 21, True)))
    for _ in range(2):
        codes, qual, lens = sim_read_block(genome, 131072, 128, 100, gen)
        sep.append(count.block_to_raw_run_sep(codes, qual, lens, 77))
    return (genome, sort.merge_sorted_lanes(packed[0], packed[1], 2),
            sort.merge_sorted_lanes(sep[0], sep[1], 5))


def phase_finalize(record, gen):
    """The finalize kernel (scan_purge_compact: group sums, calls, purge and
    compaction in one launch) against its plain version on finalize_runs'
    merged runs, purge on and off. Returns the genome (the collapse rows
    read from it too). A tree from before the fused kernel has no
    scan_purge_compact: its finalize and compact pair is timed by
    `--only callers` as whole final_from_sorted_* calls."""
    from mhm2_proxy_tpu_torch.ops import finalize

    genome, merged, merged_sep = finalize_runs(gen)
    if not hasattr(finalize, "scan_purge_compact"):
        log("[kernel] finalize: no scan_purge_compact in this tree (see --only callers)")
        return genome
    for what, keys, pay, k, W in (("k=21", merged, None, 21, 2),
                                  ("k=77 separate payload", merged_sep[:5], merged_sep[5], 77, 6)):
        keymask = finalize._keymask(k, len(keys)) if pay is None else 0xFFFFFFFF
        for purge in (True, False):
            args = (keys, pay, keymask, W, 2, purge)
            kern = lambda: finalize._scan_purge_compact_cuda(*args)  # noqa: E731
            plain = lambda: finalize._scan_purge_compact_plain(*args)  # noqa: E731
            ko, po = kern(), plain()
            err = max_abs_err(ko[1:-1] + (ko[-1][None],), po[1:-1] + (po[-1][None],))
            err = max(err, max_abs_err(tuple(ko[0].T), tuple(po[0].T)))
            N = keys[0].shape[0]
            # bytes: every input lane read once; every output row written once
            # (the kept rows and the fill behind them): W words and the payload
            record("finalize", err, cuda_ms(kern), cuda_ms(plain),
                   f"{N} rows {what} purge={purge}, {int(po[-1])} kept",
                   nbytes(keys, pay, ko), N * OPS_PER_ROW["finalize"])
            del ko, po
    del merged, merged_sep
    return genome


def phase_join(record, gen):
    """The join kernel against its plain version at the k = 21 edge join's
    shapes: fused lanes (below 2^25 rows), then phase_join_separate's rows."""
    import torch

    from mhm2_proxy_tpu_torch.ops import join, lookup
    from mhm2_proxy_tpu_torch.ops.u32 import narrow

    dev = "cuda"
    # join: the k=21 edge join at the real-size community's shape: a table
    # of 7,340,032 rows (6,636,069 valid), two queries per row (70% hits,
    # 10% all-ones), a 6-bit payload
    T, n_valid = 7_340_032, 6_636_069
    Q = 2 * T
    keys = torch.unique(torch.randint(0, 1 << 42, (T + T // 8,), device=dev, generator=gen))[:T]
    check(keys.shape[0] == T, "join: too few distinct table keys")

    def key_words(kk):
        return torch.stack([narrow(kk >> 10), narrow((kk & 0x3FF) << 22)], 1)

    words = key_words(keys)
    words[n_valid:] = -1
    n_hit, n_sent = Q * 7 // 10, Q // 10
    qk = torch.cat([keys[torch.randint(0, n_valid, (n_hit,), device=dev, generator=gen)],
                    torch.randint(0, 1 << 42, (Q - n_hit - n_sent,), device=dev, generator=gen)])
    qw = torch.cat([key_words(qk), torch.full((n_sent, 2), -1, dtype=torch.int32, device=dev)])
    qw = qw[torch.randperm(Q, device=dev, generator=gen)]
    payload = torch.randint(0, 64, (T,), device=dev, generator=gen)
    merged = lookup.merged_join_rows(words, qw, payload)
    nv = torch.tensor(n_valid, dtype=torch.int32, device=dev)
    kern = lambda: join._propagate_cuda(merged, nv, 2, 6, Q, 32)  # noqa: E731
    plain = lambda: join._propagate_plain(merged, nv, 2, 6, Q, 32)  # noqa: E731
    ka, pa = kern(), plain()
    hits = int((pa != 0).sum())
    check(n_hit <= hits < Q - n_sent, f"join: {hits} answers for {n_hit} hit queries")
    M = merged[0].shape[0]
    # per merged row: the key compares with its neighbours and the answer select
    record("join", max_abs_err((ka,), (pa,)), cuda_ms(kern), cuda_ms(plain),
           f"{M} merged rows ({T} table, {Q} queries) kw=2", nbytes(merged, ka), M * 8)
    del merged, ka, pa, words, qw, keys
    phase_join_separate(record, gen)
    phase_join_past_2_28(record, gen)


def phase_join_past_2_28(record, gen):
    """The separate-lane join past 2^28 queries, where its staging runs in
    passes of 512 query-id windows of 2^19 answers: 90,000,000 runs of 4
    equal keys (kw = 1), each a table row (80% valid) and 3 queries,
    270,000,000 queries in all (two passes, the second of 3 windows)."""
    import torch

    from mhm2_proxy_tpu_torch.ops import join
    from mhm2_proxy_tpu_torch.ops.u32 import narrow

    n_runs = 90_000_000
    M, Q = 4 * n_runs, 3 * n_runs
    row = torch.arange(M, device="cuda")
    is_t = row % 4 == 0
    src = torch.where(is_t, row // 4, 0)
    src[~is_t] = torch.randperm(Q, device="cuda", generator=gen) | join.SEP_QUERY_BIT
    pay = torch.randint(-(1 << 31), 1 << 31, (M,), dtype=torch.int32, device="cuda",
                        generator=gen)
    merged = ((row // 4).to(torch.int32), narrow(src), pay)
    del row, is_t, src
    nv = torch.tensor(int(0.8 * n_runs), dtype=torch.int32, device="cuda")
    kern = lambda: join._propagate_sep_cuda(merged, nv, 1, Q, 32)  # noqa: E731
    plain = lambda: join._propagate_sep_plain(merged, nv, 1, Q, 32)  # noqa: E731
    ka, pa = kern(), plain()
    err = max_abs_err((narrow(ka), narrow(ka >> 32)), (narrow(pa), narrow(pa >> 32)))
    hits = int((pa != 0).sum())
    check(0 < hits < Q, f"join past 2^28 queries: {hits} answers")
    del pa
    record("join", err, cuda_ms(kern), cuda_ms(plain),
           f"{M} merged rows ({n_runs} table, {Q} queries) kw=1 separate lanes, past 2^28 "
           "queries", nbytes(merged, ka), M * 8)
    del merged, ka


# The least int32 operations the minimizer needs a position, at any k (u64
# operations count two, a u64 multiply four): a rolling forward m-mer pack
# (shift, or, mask: 6), a rolling reverse complement (shift, or, mask: 6), the
# least of the two with its select (4), a sliding window max at constant
# cost a position (van Herk/Gil-Werman, about 3 compare-selects: 12),
# quick_hash (two multiplies, an add, six shift-xors: 34) and the remainder (8)
MINIMIZER_OPS = 6 + 6 + 4 + 12 + 34 + 8


def phase_minimizer(record, gen):
    """The minimizer kernel against its plain version at the sharded path's
    shapes: read blocks of 131,072 reads (L = max(128, k + 32), the
    community's 100 bp reads padded) at k = 21, 33, 55, 77, 99 with 4
    shards, a (2048, 2048) contig-window block at k = 33, and 4096
    shards."""
    import torch

    from mhm2_proxy_tpu_torch.constants import minimizer_len_for_k
    from mhm2_proxy_tpu_torch.ops import minimizer

    cases = [(21, 131072, 128, 4), (33, 131072, 128, 4), (55, 131072, 128, 4),
             (77, 131072, 128, 4), (99, 131072, 131, 4), (33, 2048, 2048, 4),
             (21, 131072, 128, 4096)]
    for k, B, L, S in cases:
        m = minimizer_len_for_k(k)
        codes = torch.randint(0, 5, (B, L), dtype=torch.uint8, device="cuda", generator=gen)
        kern = lambda: minimizer._targets_cuda(codes, k, m, S)  # noqa: E731
        plain = lambda: minimizer._targets_plain(codes, k, m, S)  # noqa: E731
        out = kern()
        err = max_abs_err((out,), (plain(),))
        check(int(out.min()) >= 0 and int(out.max()) < S, f"minimizer targets out of [0, {S})")
        P = L - k + 1
        record("minimizer", err, cuda_ms(kern), cuda_ms(plain),
               f"({B}, {L}) k={k} m={m} S={S}", nbytes(codes, out), B * P * MINIMIZER_OPS)
        del out, codes


def phase_sharded_devices():
    """The sharded stores (reads with spill rounds, a contig pass) on CUDA
    equal the same on the CPU at k = 21 and 77: the flat ShardedCounter
    (raw records, 4 shards), HierarchicalCounter over 2 hosts x 2 devices
    with supermers, and the flat ShardedCounter with supermers: per-shard
    tables, every exchange statistic, sharded_lookup's answers and the
    traversal's contigs and stitch rounds; then the analog of
    dryrun_multichip(8) on CUDA against MULTICHIP_r05.json's counts."""
    import numpy as np
    import torch

    from mhm2_proxy_tpu_torch.dbjg import traverse_debruijn_graph_sharded
    from mhm2_proxy_tpu_torch.parallel import HierarchicalCounter, ShardedCounter, sharded_lookup

    rng = np.random.default_rng(21)
    genome = rng.integers(0, 4, 200_000).astype(np.uint8)
    S, cap = 4, 4000  # below a bucket's share of a block: spill rounds
    # the supermer stores' caps (in k-mers, an eighth of them in records)
    # give 2-5 spill rounds: ~5 k-mers a record at k = 21, ~14 at k = 77
    sup_cap = {21: 16000, 77: 2000}
    stores = {
        "flat raw": lambda k, dev: ShardedCounter(k, S, bucket_cap=cap, device=dev),
        "2x2 supermers": lambda k, dev: HierarchicalCounter(k, (2, 2), bucket_cap=sup_cap[k],
                                                            device=dev),
        "flat supermers": lambda k, dev: ShardedCounter(k, S, bucket_cap=sup_cap[k], device=dev,
                                                        use_supermers=True),
    }
    for k in (21, 77):
        blocks = []
        for _ in range(2):
            B, L = 4096, 128
            start = rng.integers(0, genome.size - 100, B)
            codes = genome[start[:, None] + np.arange(100)[None, :]]
            err = rng.random(codes.shape) < 0.003
            codes = np.where(err, rng.integers(0, 5, codes.shape), codes).astype(np.uint8)
            codes = np.concatenate([codes, np.full((B, L - 100), 4, np.uint8)], 1)
            blocks.append((codes, rng.random(codes.shape) > 0.05, np.full(B, 100, np.int32)))
        n_ctg, seg = 64, 2048
        c_start = rng.integers(0, genome.size - seg, n_ctg)
        c_codes = genome[c_start[:, None] + np.arange(seg)[None, :]].astype(np.uint8)
        c_lens = rng.integers(k + 2, seg + 1, n_ctg).astype(np.int32)
        c_codes[np.arange(seg)[None, :] >= c_lens[:, None]] = 4
        c_deps = rng.integers(1, 50, n_ctg).astype(np.int32)
        for name, make in stores.items():
            t0 = time.perf_counter()
            got = {}
            for dev in ("cpu", "cuda"):
                st = make(k, dev)
                for blk in blocks:
                    st.add_reads_block(*blk)
                st.add_ctgs_block(c_codes, c_lens, c_deps)
                table = st.finalize()
                rows = [tuple(x.cpu().numpy().copy() for x in (
                    table.words[s, :n], table.count[s, :n], table.left[s, :n],
                    table.right[s, :n])) for s, n in enumerate(table.n.tolist())]
                Q = int(table.n.max())
                qv = torch.roll(torch.arange(Q, device=dev)[None, :] < table.n[:, None], 1, 0)
                look = sharded_lookup(table, torch.roll(table.words[:, :Q], 1, 0), qv)
                tstats = {}
                contigs = sorted(traverse_debruijn_graph_sharded(table, k, stats=tstats))
                got[dev] = (rows, (st.stat_kmers, st.stat_records, st.stat_collapsed, st.spilled,
                                   st.spill_rounds, st.stat_bytes, table.bound_rows),
                            [x.cpu() for x in look], contigs, tstats["stitch_rounds"])
            (rc, sc, lc, cc, tc), (rg, sg, lg, cg, tg) = got["cpu"], got["cuda"]
            same_rows = all(all(np.array_equal(a, b) for a, b in zip(x, y))
                            for x, y in zip(rc, rg))
            same = (same_rows and sc == sg and all(torch.equal(a, b) for a, b in zip(lc, lg))
                    and cc == cg and tc == tg)
            log(f"[sharded-devices] k={k} {name}: {sum(len(r[0]) for r in rc)} table rows over "
                f"{S} shards, stats (kmers, records, presummed, re-sent, spill rounds, bytes, "
                f"bound rows) {sc}, {len(cc)} contigs, stitch rounds {tc}, CUDA == CPU: {same} "
                f"({time.perf_counter() - t0:.1f} s)")
            check(same and sc[4] > 0 and len(cc) > 0 and bool(lc[0].any()),
                  f"k={k} {name}: the sharded store on CUDA differs from the CPU (or no spill "
                  f"round)")
    t0 = time.perf_counter()
    got = dryrun_multichip("cuda")
    log(f"[sharded-devices] dryrun_multichip analog on CUDA: {got} "
        f"({time.perf_counter() - t0:.1f} s)")
    check(got == MULTICHIP_R05, f"dryrun_multichip analog: {got} != MULTICHIP_r05.json's "
          f"{MULTICHIP_R05}")


# The counts of MULTICHIP_r05.json: __graft_entry__.dryrun_multichip(8), the
# JAX package's hierarchical exchange over a 2 x 4 mesh of virtual CPU
# devices (the JAX package on the CPU still prints them); exchange tuples
# are (records, k-mers, presummed, re-sent, spill rounds)
MULTICHIP_R05 = dict(kmers=2555, contigs=15, exchange=(4579, 22560, 1636, 1904, 2),
                     volume_exchange=(42166, 1100704, 166734, 35372, 2),
                     shard_rows=[323, 383, 380, 348, 371, 387, 417, 368])


def dryrun_multichip(device="cuda"):
    """The analog of __graft_entry__.dryrun_multichip(8) on the port, on one
    device: HierarchicalCounter over 2 hosts x 4 devices with supermers,
    skewed reads (half on one 600 bp hotspot) through a 640-k-mer bucket
    cap (>= 2 spill rounds), a contig pass, lookups of every shard's own
    k-mers, and the sharded traversal against the single-device assembly;
    then the volume phase: 1.1M k-mers, 30% poly-A reads, cap 4096. Returns
    the counts that MULTICHIP_R05 pins."""
    import numpy as np
    import torch

    from mhm2_proxy_tpu_torch.dbjg import traverse_debruijn_graph, traverse_debruijn_graph_sharded
    from mhm2_proxy_tpu_torch.kcount import KmerCountStore
    from mhm2_proxy_tpu_torch.ops.bitkmer import ascii_to_codes
    from mhm2_proxy_tpu_torch.parallel import HierarchicalCounter, sharded_lookup

    n_dev, layout, k, L = 8, (2, 4), 21, 64
    n_reads = max(512, 64 * n_dev)
    rng = np.random.default_rng(1)
    genome = rng.integers(0, 4, 3000, dtype=np.uint8)
    n_hot = n_reads // 4
    starts = np.concatenate([rng.integers(0, 3000 - L, n_reads // 2 - n_hot),
                             rng.integers(1000, 1600 - L, n_hot)])
    half = np.stack([genome[s : s + L] for s in starts])
    codes = np.concatenate([half, half])
    qual_ok = np.ones_like(codes, bool)
    lens = np.full((n_reads,), L, np.int32)
    counter = HierarchicalCounter(k, layout, bucket_cap=640, device=device, use_supermers=True)
    counter.add_reads_block(codes, qual_ok, lens)
    gstr = "".join("ACGT"[c] for c in genome)
    ctgs = [(gstr[900:1700], 7), (gstr[200:500], 3)]
    ccodes = np.full((n_dev, 1024), 4, np.uint8)
    clens = np.zeros((n_dev,), np.int32)
    cdeps = np.zeros((n_dev,), np.int32)
    for i, (cs, d) in enumerate(ctgs):
        ccodes[i, : len(cs)] = ascii_to_codes(cs.encode())
        clens[i], cdeps[i] = len(cs), d
    counter.add_ctgs_block(ccodes, clens, cdeps)
    table = counter.finalize()
    Q = 32
    qw = table.words[:, :Q, :]
    qv = (torch.arange(Q, device=qw.device)[None, :] < table.n[:, None]) & ~(qw == -1).all(-1)
    found = sharded_lookup(table, qw, qv)[0]
    check(bool(found[qv].all()), "own k-mers not found through the sharded lookup")
    got = traverse_debruijn_graph_sharded(table, k)
    store = KmerCountStore(k, device=device)
    store.add_reads_block(codes, qual_ok, lens)
    store.add_ctgs_block(ccodes, clens, cdeps)
    exp = traverse_debruijn_graph(store.finalize(), k)
    norm = lambda cs: sorted((sq, round(d, 9)) for sq, d in cs)  # noqa: E731
    check(norm(got) == norm(exp), f"sharded contigs != single-device ({len(got)} vs {len(exp)})")
    check(counter.spill_rounds >= 2 and counter.dropped == 0, counter.describe_exchange())
    # the volume phase: the poly-A reads all route to one shard
    Lv = 128
    Bv = -(-(1_100_000 // (Lv - k - 1)) // n_dev) * n_dev
    starts_v = rng.integers(0, 3000 - Lv, Bv)
    codes_v = np.stack([genome[s : s + Lv] for s in starts_v])
    n_polya = (3 * Bv // 10 // n_dev) * n_dev
    codes_v[:n_polya] = 0
    codes_v = codes_v.reshape(n_dev, -1, Lv).transpose(1, 0, 2).reshape(-1, Lv)
    counter_v = HierarchicalCounter(k, layout, bucket_cap=4096, device=device, use_supermers=True)
    counter_v.add_reads_block(codes_v, np.ones_like(codes_v, bool), np.full((Bv,), Lv, np.int32))
    shard_n = counter_v.finalize().n.tolist()
    check(counter_v.spill_rounds >= 2 and counter_v.dropped == 0, counter_v.describe_exchange())
    check(counter_v.stat_collapsed >= n_polya * (Lv - k - 1) // 2, counter_v.stat_collapsed)
    check(0 < sum(shard_n) <= 3001, shard_n)
    ex = lambda c: (c.stat_records, c.stat_kmers, c.stat_collapsed, c.spilled,  # noqa: E731
                    c.spill_rounds)
    return dict(kmers=int(table.n.sum()), contigs=len(got), exchange=ex(counter),
                volume_exchange=ex(counter_v), shard_rows=shard_n)


def phase_join_separate(record, gen):
    """The join's separate-lane variant at the full community's k = 21
    edge-join shape (every round of it: tables trim to 2^25 rows): 2^25
    table rows (1M of them sentinels), 2^26 queries (70% hits), a 6-bit
    payload; and the whole table_join_payload around it."""
    import torch

    from mhm2_proxy_tpu_torch.ops import join, lookup
    from mhm2_proxy_tpu_torch.ops.u32 import narrow

    dev = "cuda"
    T = 1 << 25
    n_valid = T - 1_000_000
    Q = 2 * T
    keys = torch.unique(torch.randint(0, 1 << 42, (T + T // 8,), device=dev, generator=gen))[:T]
    check(keys.shape[0] == T, "join: too few distinct table keys")
    words = torch.stack([narrow(keys >> 10), narrow((keys & 0x3FF) << 22)], 1)
    words[n_valid:] = -1
    n_hit = Q * 7 // 10
    qk = torch.cat([keys[torch.randint(0, n_valid, (n_hit,), device=dev, generator=gen)],
                    torch.randint(0, 1 << 42, (Q - n_hit,), device=dev, generator=gen)])
    qw = torch.stack([narrow(qk >> 10), narrow((qk & 0x3FF) << 22)], 1)
    del keys, qk
    payload = torch.randint(0, 64, (T,), device=dev, generator=gen)
    nv = torch.tensor(n_valid, dtype=torch.int32, device=dev)
    merged = lookup.merged_join_rows_sep(words, qw, payload)
    kern = lambda: join._propagate_sep_cuda(merged, nv, 2, Q, 32)  # noqa: E731
    plain = lambda: join._propagate_sep_plain(merged, nv, 2, Q, 32)  # noqa: E731
    ka = kern()
    err = max_abs_err((narrow(ka), narrow(ka >> 32)), (narrow(plain()), narrow(plain() >> 32)))
    M = merged[0].shape[0]
    record("join", err, cuda_ms(kern), cuda_ms(plain),
           f"{M} merged rows ({T} table, {Q} queries) kw=2 separate lanes", nbytes(merged, ka),
           M * 8)
    del merged, ka
    run = lambda: lookup.table_join_payload(words, nv, qw, payload, payload_bits=6)  # noqa: E731
    idx, found, pay = run()
    hits = int(found.sum())
    ok = bool((payload[idx[found].long()] == pay[found]).all()) and bool(
        (words[idx[found].long()] == qw[found]).all())
    check(n_hit <= hits < Q and ok, f"separate-lane join: {hits} answers for {n_hit} hits")
    log(f"[join-sep] table_join_payload, {T} table rows, {Q} queries: {hits} found, "
        f"{cuda_ms(run):.3f} ms (query lexsort + sort kernel merge + join kernel)")
    del words, qw, payload, idx, found, pay
    phase_join_ladder_mix(record, gen)


# The k = 21 edge join of phase 5's ladder (its `[arctic] k=21 edge join`
# line on an H100: 33,554,432 trimmed table rows, 7,014,948 of them
# all-ones; 67,108,864 queries, 14,049,878 of them all-ones, those of non-UU
# rows; the longest equal-key run 21,064,826 rows): the all-ones shares
LADDER_JOIN_ONES_TABLE = 7_014_948 / 33_554_432
LADDER_JOIN_ONES_QUERIES = 14_049_878 / 67_108_864


# The ladder's k = 77 and 99 edge joins (phase 5's `mhm2_join_sep` lines):
# 6 and 8 key lanes, 75,497,472 merged rows, 50,331,648 queries
LADDER_WIDE_JOINS = ((6, 25_165_824), (8, 25_165_824))


def phase_join_ladder_mix(record, gen):
    """The separate-lane join with the ladder's all-ones shares
    (LADDER_JOIN_ONES_*): at the k = 21 edge join's 2^25 table rows and 2
    key lanes, then at the k = 77 and 99 joins' shapes (LADDER_WIDE_JOINS).
    The all-ones table rows and queries make one run of millions of rows,
    as build_edges' does; of the other queries 70% hit."""
    import torch

    from mhm2_proxy_tpu_torch.ops import join, lookup
    from mhm2_proxy_tpu_torch.ops.u32 import narrow

    dev = "cuda"
    for kw, T in ((2, 1 << 25),) + LADDER_WIDE_JOINS:
        Q = 2 * T
        n_valid = T - int(T * LADDER_JOIN_ONES_TABLE)
        n_ones = int(Q * LADDER_JOIN_ONES_QUERIES)
        keys = torch.unique(torch.randint(0, 1 << 42, (T + T // 8,), device=dev,
                                          generator=gen))[:T]
        check(keys.shape[0] == T, "join: too few distinct table keys")

        def key_words(kk):
            # the 42-bit key in lanes 0-1 (distinct keys differ there, as
            # sorted neighbours of a real table mostly do), lanes 2.. a hash
            return torch.stack([narrow(kk >> 10), narrow((kk & 0x3FF) << 22)] + [
                narrow((kk * (2654435761 + 2 * w)) & 0xFFFFFFFF) for w in range(2, kw)], 1)

        words = key_words(keys)
        words[n_valid:] = -1
        n_hit = (Q - n_ones) * 7 // 10
        qk = torch.cat([keys[torch.randint(0, n_valid, (n_hit,), device=dev, generator=gen)],
                        torch.randint(0, 1 << 42, (Q - n_ones - n_hit,), device=dev,
                                      generator=gen)])
        qw = torch.cat([key_words(qk), torch.full((n_ones, kw), -1, dtype=torch.int32,
                                                  device=dev)])
        qw = qw[torch.randperm(Q, device=dev, generator=gen)]
        del keys, qk
        payload = torch.randint(0, 64, (T,), device=dev, generator=gen)
        nv = torch.tensor(n_valid, dtype=torch.int32, device=dev)
        merged = lookup.merged_join_rows_sep(words, qw, payload)
        del words, qw
        kern = lambda: join._propagate_sep_cuda(merged, nv, kw, Q, 32)  # noqa: E731
        plain = lambda: join._propagate_sep_plain(merged, nv, kw, Q, 32)  # noqa: E731
        ka, pa = kern(), plain()
        err = max_abs_err((narrow(ka), narrow(ka >> 32)), (narrow(pa), narrow(pa >> 32)))
        hits = int((pa != 0).sum())
        check(n_hit <= hits < Q - n_ones, f"ladder-mix join: {hits} answers for {n_hit} hits")
        M = merged[0].shape[0]
        record("join", err, cuda_ms(kern), cuda_ms(plain),
               f"{M} merged rows ({T} table, {Q} queries) kw={kw} separate lanes, ladder mix: "
               f"{T - n_valid + n_ones} all-ones rows", nbytes(merged, ka), M * 8)
        del merged, ka, pa, payload
        torch.cuda.empty_cache()


def phase_collapse_kernels(record, genome, gen):
    """scan and the split's 3-class compaction at the k = 21 collapse shape
    (16 extracted read blocks merged: ~163M packed rows, the raw budget of
    an 80 GB card), and the lanes scan at the final fold's shape
    (RANGED_FOLD_MIN_ROWS rows, nine lanes)."""
    import torch

    from mhm2_proxy_tpu_torch.constants import MAX_KMER_COUNT
    from mhm2_proxy_tpu_torch.kcount import KmerCountStore
    from mhm2_proxy_tpu_torch.ops import compact, count, finalize, scan
    from mhm2_proxy_tpu_torch.ops.u32 import ONES, rows_equal_next, u32

    runs = []
    for _ in range(16):
        codes, qual, lens = sim_read_block(genome, 131072, 128, 100, gen)
        run = count.block_to_raw_run(codes, qual, lens, 21)
        n_valid = int((run[1] != -1).sum())
        runs.append(tuple(x[:n_valid].clone() for x in run))
        del run
    merged = count.merge_raw_runs(runs)
    N = merged[0].shape[0]
    keymask = finalize._keymask(21, 2)
    kern = lambda: scan._scan_packed_cuda(merged, keymask, MAX_KMER_COUNT)  # noqa: E731
    plain = lambda: scan._scan_packed_plain(merged, keymask, MAX_KMER_COUNT)  # noqa: E731
    p = kern()
    record("scan", max_abs_err(p, plain()), cuda_ms(kern), cuda_ms(plain),
           f"{N} rows k=21 packed (collapse)", nbytes(merged, p), N * OPS_PER_ROW["scan_packed"])

    # the split's flags and lanes (count.split_from_sorted_packed)
    skey = merged[1] & u32(keymask)
    sent = (skey == u32(keymask)) & (merged[0] == ONES)
    w = (merged[0], torch.where(sent, ONES, skey))
    one = torch.ones((1,), dtype=torch.bool, device="cuda")
    last = torch.cat([~rows_equal_next(w), one]) & ~sent
    cnt = p[0] & 0xFFFF
    flags = torch.where(last & (cnt >= 2), 0, torch.where(last & (cnt == 1), 1, 2)).to(torch.int32)
    lanes = w + tuple(p)
    layouts = (tuple((i,) for i in range(7)), tuple((i,) for i in range(3)))
    kern = lambda: compact._compact_cuda(lanes, flags, 3, (0, 1), layouts, None)  # noqa: E731
    plain = lambda: compact._compact_plain(lanes, flags, (0, 1), layouts, None)  # noqa: E731
    err = 0
    emitted = 0
    (kouts, kn), (pouts, pn) = kern(), plain()
    for ko, po, kc, pc, sl in zip(kouts, pouts, kn.tolist(), pn.tolist(), layouts):
        emitted += 4 * pc * len(sl)
        err = max(err, abs(kc - pc) + max_abs_err(tuple(x[:pc] for x in ko),
                                                  tuple(x[:pc] for x in po)))
    del kouts, pouts
    record("compact", err, cuda_ms(kern), cuda_ms(plain),
           f"{N} rows 3-class split, emit_lanes 7/3 (k=21 collapse)",
           nbytes(flags) + 2 * emitted, N * OPS_PER_ROW["compact"])
    del lanes, flags, w, skey, sent, last, cnt, p

    # lanes scan at the final fold's shape: counts 1-300 on one-hot exts
    M = KmerCountStore.RANGED_FOLD_MIN_ROWS
    _keys, _sent, is_start, rows = scan.packed_rows(tuple(x[:M] for x in merged), keymask)
    c = torch.randint(1, 301, (M,), device="cuda", generator=gen)
    pays = tuple((x * c).to(torch.int32) for x in rows)
    del rows, merged, _keys, _sent
    kern = lambda: scan._scan_lanes_cuda(pays, is_start, MAX_KMER_COUNT)  # noqa: E731
    plain = lambda: scan._scan_lanes_plain(pays, is_start, MAX_KMER_COUNT)  # noqa: E731
    out = kern()
    # per row and lane: the add and the start select; one start flag
    record("scan", max_abs_err(out, plain()), cuda_ms(kern), cuda_ms(plain),
           f"{M} rows x 9 lanes (final fold)", nbytes(pays, is_start, out), M * (2 * 9 + 1))
    del out
    del pays, is_start, c
    torch.cuda.empty_cache()


def ssw_pairs(B, Lq, Lr, gen):
    """B reads of Lq bases cut at offset 32 from random Lr-base windows (the
    post-asm window shape), with 2% substitutions, a one-base deletion in
    10% of them and an insertion in another 10%, ragged lengths (q_len
    60-Lq, r_len Lr-34..Lr, 64 pairs with q_len 0)."""
    import torch

    dev = "cuda"
    ref = torch.randint(0, 4, (B, Lr), dtype=torch.uint8, device=dev, generator=gen)
    i = torch.arange(Lq, device=dev)[None, :]
    p = torch.randint(0, Lq, (B, 1), device=dev, generator=gen)
    kind = torch.randint(0, 10, (B, 1), device=dev, generator=gen)
    src = 32 + i + ((kind == 0) & (i >= p)).long() - ((kind == 1) & (i > p)).long()
    q = torch.gather(ref, 1, src)
    q = torch.where((kind == 1) & (i == p), (q + 1) % 4, q)
    sub = torch.rand((B, Lq), device=dev, generator=gen) < 0.02
    shift = torch.randint(1, 4, (B, Lq), dtype=torch.uint8, device=dev, generator=gen)
    q = torch.where(sub, (q + shift) % 4, q).to(torch.uint8)
    ql = torch.randint(60, Lq + 1, (B,), dtype=torch.int32, device=dev, generator=gen)
    rl = torch.randint(Lr - 34, Lr + 1, (B,), dtype=torch.int32, device=dev, generator=gen)
    ql[:64] = 0
    return q, ql, ref, rl


def phase_ssw(record, gen):
    """The ssw kernel against its plain version at the post-asm shape of the
    community's 100 bp reads: 65,536 pairs, Lq = 100, Lr = 164, under the
    reference's three scoring profiles and one with gap_open < gap_extend
    (tests/torch_common.py), and one whose mismatch score does not fit a
    signed byte (the kernel's compare-and-select substitution); then 2 x
    150 bp reads, Lq = 150, Lr = 214, whose ragged r_len ends strips at
    every offset."""
    from mhm2_proxy_tpu_torch.ops import ssw

    common = repo_module("tests", "torch_common")
    scorings, wide = common.SCORINGS_ALL, common.SCORING_WIDE
    for Lq, Lr, profiles in ((100, 164, scorings + [wide]), (150, 214, scorings[:1])):
        q, ql, r, rl = ssw_pairs(65536, Lq, Lr, gen)
        cells = int((ql.clamp(0, Lq).long() * rl.clamp(0, Lr).long()).sum())
        for sc in profiles:
            kern = lambda: ssw._sw_ends_cuda(q, ql, r, rl, **sc)  # noqa: E731
            plain = lambda: ssw._sw_ends_plain(q, ql, r, rl, **sc)  # noqa: E731
            out = kern()
            err = max_abs_err(out, plain())
            ms = cuda_ms(kern)
            what = (f"65536 pairs, Lq={Lq} Lr={Lr}, go={sc['gap_open']} ge={sc['gap_extend']}"
                    f"{' mismatch=200' if sc is wide else ''}: {cells} cells, "
                    f"{cells / ms / 1e6:.1f} GCUPS")
            check(int((out[0] > 0).sum()) > 60000, f"ssw: too few alignments ({what})")
            record("ssw", err, ms, cuda_ms(plain), what, nbytes(q, ql, r, rl, out),
                   int(cells * OPS_PER_ROW["ssw"]))


def phase_lookup(gen):
    """table_lookup (plain torch, no kernel) on CUDA against the CPU at a
    30M-row index with 327,680 queries (five seeds of a 65,536-read block),
    half of them present; table_join (the sort and join kernels) on the
    same; and rank_rows, lower and upper, on a 30M-row table whose keys
    each appear twice."""
    import torch

    from mhm2_proxy_tpu_torch.ops import kernels, lookup
    from mhm2_proxy_tpu_torch.ops.u32 import lexsort_lanes

    T, Q = 30_000_000, 327_680
    raw = torch.randint(-2**31, 2**31, (T, 2), dtype=torch.int32, device="cuda", generator=gen)
    words = torch.stack(lexsort_lanes((raw[:, 0], raw[:, 1])), 1)
    del raw
    qw = torch.cat([words[torch.randint(0, T, (Q // 2,), device="cuda", generator=gen)],
                    torch.randint(-2**31, 2**31, (Q - Q // 2, 2), dtype=torch.int32,
                                  device="cuda", generator=gen)])
    run = lambda: lookup.table_lookup(words, T, qw)  # noqa: E731
    idx, found = run()
    ms = cuda_ms(run)
    t0 = time.perf_counter()
    idx_h, found_h = lookup.table_lookup(words.cpu(), T, qw.cpu())
    cpu_s = time.perf_counter() - t0
    same = torch.equal(found.cpu(), found_h) and torch.equal(idx.cpu(), idx_h)
    log(f"[lookup] table_lookup {T} rows, {Q} queries: {int(found_h.sum())} found, CUDA "
        f"{ms:.3f} ms, CPU {cpu_s:.2f} s, CUDA == CPU: {same}")
    check(same and int(found_h.sum()) >= Q // 2, "table_lookup on CUDA differs from the CPU")
    top = float((words[:, 0] < 0).float().mean())
    # table_join: the sort kernel's merge of the sorted queries into the
    # table, then the join kernel (fused lane: T < 2^25)
    kernels.reset_launches()
    run = lambda: lookup.table_join(words, T, qw)  # noqa: E731
    idx, found = run()
    launched = {k: v for k, v in kernels.launches().items() if v}
    ms = cuda_ms(run)
    t0 = time.perf_counter()
    idx_h, found_h = lookup.table_join(words.cpu(), T, qw.cpu())
    cpu_s = time.perf_counter() - t0
    same = torch.equal(found.cpu(), found_h) and torch.equal(idx.cpu()[found_h], idx_h[found_h])
    log(f"[lookup] table_join {T} rows ({top:.3f} with the top bit set), {Q} queries: "
        f"{int(found_h.sum())} found, CUDA {ms:.3f} ms (launches {launched}), CPU "
        f"{cpu_s:.2f} s, CUDA == CPU: {same}")
    check(same and int(found_h.sum()) >= Q // 2 and set(launched) == {"sort", "join"},
          "table_join on CUDA differs from the CPU or did not run the sort and join kernels")
    # rank_rows on a table whose every key appears twice, queries drawn
    # from it, random and all-ones
    dup = words[: T // 2].repeat_interleave(2, 0)
    del words
    qd = torch.cat([dup[torch.randint(0, T, (Q // 2,), device="cuda", generator=gen)],
                    torch.randint(-2**31, 2**31, (Q - Q // 2 - 64, 2), dtype=torch.int32,
                                  device="cuda", generator=gen),
                    torch.full((64, 2), -1, dtype=torch.int32, device="cuda")])
    ranks = {}
    for upper in (False, True):
        run = lambda: lookup.rank_rows(dup, T, qd, upper=upper)  # noqa: E731
        ranks[upper] = run()
        ms = cuda_ms(run)
        t0 = time.perf_counter()
        host = lookup.rank_rows(dup.cpu(), T, qd.cpu(), upper=upper)
        cpu_s = time.perf_counter() - t0
        same = torch.equal(ranks[upper].cpu(), host)
        log(f"[lookup] rank_rows upper={upper} {T} rows (each key twice), {Q} queries: CUDA "
            f"{ms:.3f} ms, CPU {cpu_s:.2f} s, CUDA == CPU: {same}")
        check(same, f"rank_rows(upper={upper}) on CUDA differs from the CPU")
    span = (ranks[True] - ranks[False]).cpu()
    check(bool((span[: Q // 2] == 2).all()) and bool((ranks[False][-64:] == T).all()),
          "rank_rows: a duplicated key does not span 2 rows, or all-ones ranks below T")


def phase_callers(seed: int = 20261016):
    """The compact, sort and finalize kernels' main callers as whole calls,
    timed as the caller sees them (the kernels and the torch around them),
    each against the same call through the plain versions on the card
    (kernels.use_kernel answering False), bit-equal: _merge_sorted_sets (the
    split LSM's merge at k = 21: two deduped sets of 18,350,080 rows, W = 2
    key lanes + 5 packed sum lanes), _compact_keep (36,700,160 rows, W = 2 +
    one payload lane, a fifth kept), _split_emit (the k = 21 collapse shape,
    163,577,856 rows, W = 2 + 5 lanes, a quarter multis, a sixth singles),
    and final_from_sorted_packed (finalize_runs' k = 21 run, purge on and
    off) and final_from_sorted_sep (its k = 77 run, purge).
    It runs whichever mhm2_proxy_tpu_torch comes first on sys.path, so that
    `--callers DIR` times another tree's callers on the same inputs."""
    import torch

    from mhm2_proxy_tpu_torch.ops import count, kernels
    from mhm2_proxy_tpu_torch.ops.u32 import lexsort_perm

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def rand(shape, lo=-2**31, hi=2**31):
        return torch.randint(lo, hi, shape, dtype=torch.int32, device="cuda", generator=gen)

    def sorted_set(n):
        w = rand((n, 2))
        w = w[lexsort_perm((w[:, 0], w[:, 1]))].contiguous()
        return w, rand((n,), 1, 301), rand((n, 4), 0, 1 << 16), rand((n, 4), 0, 1 << 16)

    def flat(x):
        return [t for y in x for t in flat(y)] if isinstance(x, (tuple, list)) else [x]

    def run(name, what, fn):
        out_k = fn()
        ms = cuda_ms(fn)
        orig = kernels.use_kernel
        kernels.use_kernel = lambda *t: False
        try:
            out_p = fn()
            plain_ms = cuda_ms(fn)
        finally:
            kernels.use_kernel = orig
        same = all(torch.equal(a, b) for a, b in zip(flat(out_k), flat(out_p)))
        log(f"[caller] {name} {what}: kernel path {ms:.3f} ms, plain path {plain_ms:.3f} ms, "
            f"equal to the plain path: {same}")
        check(same and len(flat(out_k)) == len(flat(out_p)), f"{name}: kernel and plain paths "
              "differ")
        return ms

    times = {}
    a, b = sorted_set(18_350_080), sorted_set(18_350_080)
    times["_merge_sorted_sets"] = run("_merge_sorted_sets", "18350080+18350080 rows, W=2 + 5 "
                                      "sum lanes", lambda: count._merge_sorted_sets(a, b))
    del a, b
    N = 36_700_160
    words, pay = rand((N, 2)), rand((N,))
    keep = torch.rand((N,), device="cuda", generator=gen) < 0.2
    times["_compact_keep"] = run("_compact_keep", f"{N} rows, W=2 + 1 payload lane",
                                 lambda: count._compact_keep(words, keep, (pay,)))
    del words, pay, keep
    N = 163_577_856
    words, p = rand((N, 2)), tuple(rand((N,)) for _ in range(5))
    u = torch.rand((N,), device="cuda", generator=gen)
    keep_m, keep_s = u < 0.25, (u >= 0.25) & (u < 0.25 + 1 / 6)
    del u
    times["_split_emit"] = run("_split_emit", f"{N} rows, W=2 + 5 lanes (k=21 collapse)",
                               lambda: count._split_emit(words, p, keep_m, keep_s))
    del words, p, keep_m, keep_s
    # finalize: the kernel (and, in a tree from before the fused kernel, the
    # compact launch after it) and the table's unpacking, as a round runs it
    _genome, merged, merged_sep = finalize_runs(gen)
    N = merged[0].shape[0]
    for purge in (True, False):
        times[f"final_from_sorted_packed purge={purge}"] = run(
            "final_from_sorted_packed", f"{N} rows k=21 purge={purge}",
            lambda: count.final_from_sorted_packed(merged, 21, 2, purge=purge))
    N = merged_sep[0].shape[0]
    times["final_from_sorted_sep"] = run(
        "final_from_sorted_sep", f"{N} rows k=77 separate payload purge=True",
        lambda: count.final_from_sorted_sep(merged_sep, 77, 6))
    del merged, merged_sep
    torch.cuda.empty_cache()
    return times


class launch_meter:
    """Within the block, a CUDA event pair right around every call of a hand
    kernel's C entry point (C_ENTRIES, reached through kernels.lib()). A
    pair spans what the stream ran between its records: the entry's
    launches, and, when the stream had run dry, the host's time to launch
    them (microseconds), but none of the wrapper's own host work
    (allocations, checks). totals() synchronizes and gives, per kernel,
    (entry calls, device ms); join_calls() each join call's (entry, key
    lanes, merged rows, queries, device ms)."""

    def __enter__(self):
        import torch

        from mhm2_proxy_tpu_torch.ops import kernels

        lib, events, joins = kernels.lib(), {}, []
        self.kernels, self.orig, self.events, self.joins = kernels, kernels.lib, events, joins

        class MeteredLib:
            def __getattr__(self, entry):
                fn = getattr(lib, entry)
                if entry not in C_ENTRIES:
                    return fn

                def call(*args):
                    ev = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                    ev[0].record()
                    rc = fn(*args)
                    ev[1].record()
                    events.setdefault(C_ENTRIES[entry], []).append(ev)
                    if entry in ("mhm2_join", "mhm2_join_sep"):  # (keys, kw, src, [pay,] M, ..., Q
                        joins.append((entry, args[1], args[3 if entry == "mhm2_join" else 4],
                                      args[8], ev))
                    return rc

                return call

        metered = MeteredLib()
        kernels.lib = lambda: metered
        return self

    def __exit__(self, *exc):
        self.kernels.lib = self.orig

    def join_calls(self):
        import torch

        torch.cuda.synchronize()
        return [(entry, kw, M, Q, e0.elapsed_time(e1))
                for entry, kw, M, Q, (e0, e1) in self.joins]

    def totals(self):
        import torch

        torch.cuda.synchronize()
        return {name: (len(self.events.get(name, ())),
                       sum(e0.elapsed_time(e1) for e0, e1 in self.events.get(name, ())))
                for name in set(C_ENTRIES.values())}


def phase_devices():
    """KmerCountStore (reads + a contig pass) and the traversal on CUDA equal
    the same on the CPU (plain versions), table and contigs, at every k the
    slice supports."""
    import numpy as np

    from mhm2_proxy_tpu_torch.dbjg import traverse_debruijn_graph
    from mhm2_proxy_tpu_torch.kcount import KmerCountStore

    rng = np.random.default_rng(7)
    genome = rng.integers(0, 4, 20000).astype(np.uint8)
    for k in (21, 33, 55, 63, 77, 99):
        t0 = time.perf_counter()
        blocks = []
        for _ in range(2):
            B, L = 3000, 160
            start = rng.integers(0, genome.size - L, B)
            codes = genome[start[:, None] + np.arange(L)[None, :]]
            err = rng.random(codes.shape) < 0.003
            codes = np.where(err, rng.integers(0, 5, codes.shape), codes).astype(np.uint8)
            lens = rng.integers(k - 2, L + 1, B).astype(np.int32)
            codes[np.arange(L)[None, :] >= lens[:, None]] = 4
            blocks.append((codes, rng.random(codes.shape) > 0.05, lens))
        n_ctg, seg = 24, 2048
        c_start = rng.integers(0, genome.size - seg, n_ctg)
        c_codes = genome[c_start[:, None] + np.arange(seg)[None, :]].astype(np.uint8)
        c_lens = rng.integers(k + 2, seg + 1, n_ctg).astype(np.int32)
        c_codes[np.arange(seg)[None, :] >= c_lens[:, None]] = 4
        c_deps = rng.integers(1, 50, n_ctg).astype(np.int32)
        got = {}
        for dev in ("cpu", "cuda"):
            st = KmerCountStore(k, device=dev)
            for blk in blocks:
                st.add_reads_block(*blk)
            st.add_ctgs_block(c_codes, c_lens, c_deps)
            table = st.finalize()
            w, c, l, r, n = table.to_numpy()
            got[dev] = ((w[:n], c[:n], l[:n], r[:n]), sorted(traverse_debruijn_graph(table, k)))
        (tc, cc), (tg, cg) = got["cpu"], got["cuda"]
        same = all(np.array_equal(x, y) for x, y in zip(tc, tg)) and cc == cg
        log(f"[devices] k={k}: {len(tc[0])} table rows, {len(cc)} contigs, "
            f"CUDA == CPU: {same} ({time.perf_counter() - t0:.1f} s)")
        check(same and len(tc[0]) > 0 and len(cc) > 0, f"k={k}: CUDA and CPU results differ")
        for case in ("merge", "defer"):
            table, stats = forced_split_store(k, "cuda", blocks, (c_codes, c_lens, c_deps), case)
            w, c, l, r, n = table.to_numpy()
            same = all(np.array_equal(x, y) for x, y in zip(tc, (w[:n], c[:n], l[:n], r[:n])))
            log(f"[devices] k={k}: split LSM on CUDA, cascade {case}: {stats}, equals the "
                f"CPU raw path: {same}")
            check(same, f"k={k}: the split LSM ({case}) on CUDA differs from the raw path")


def forced_split_store(k, device, blocks, ctg, case):
    """A count store with every push collapsed into the split LSM, the
    cascade merging (case "merge") or deferring ("defer") every push after
    the first, and both folds run by key range over several pieces; returns
    its final table and stats."""
    from mhm2_proxy_tpu_torch.kcount import KmerCountStore

    st = KmerCountStore(k, device=device, raw_budget_bytes=1)
    st.cascade_max_rows = 1 << 62 if case == "merge" else 1
    st.RANGED_FOLD_MIN_ROWS = 0
    st.RANGED_FOLD_TARGET_ROWS = 4096
    for blk in blocks:
        st.add_reads_block(*blk)
    st.add_ctgs_block(*ctg)
    table = st.finalize()
    s = st.stats
    pushes = len(blocks) - 1
    check(s["collapses"] == len(blocks) and s["read_pieces"] > 2 and s["ctg_pieces"] > 2
          and s["cascade_merges" if case == "merge" else "cascade_deferrals"] == pushes,
          f"k={k}: the forced split LSM ({case}) did not collapse, {case} and range: {s}")
    return table, s


# ---------------------------------------------------------------------------
# phases 3 and 4: the CLI end to end
# ---------------------------------------------------------------------------


POST_ASM = ["--post-asm-align", "--post-asm-abundance"]


def run_cli(fq, out_dir, ks=None, extra=(), fresh=True):
    """The CLI on one FASTQ (`-k ks`, or the default ladder when ks is None,
    then the flags in `extra`; in a new output directory unless fresh is
    False); returns its wall time, the launch counts of that run alone and
    the run's assembler (what `python -m mhm2_proxy_tpu_torch` runs:
    run_pipeline(parse_args(argv)))."""
    import torch

    from mhm2_proxy_tpu_torch.main import run_pipeline
    from mhm2_proxy_tpu_torch.ops import kernels
    from mhm2_proxy_tpu_torch.options import parse_args

    if fresh:
        shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    kernels.reset_launches()
    t0 = time.perf_counter()
    argv = ["-r", fq, "-o", out_dir] + (["-k", *map(str, ks)] if ks else []) + list(extra)
    asm = run_pipeline(parse_args(argv))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launches()
    return wall, counts, asm


def repo_module(folder, name):
    """A script of the repo's `folder` as a module, loaded from its file:
    ci/check_post_asm.py and ci/check_asm_quality.py (only the standard
    library at module level), tests/torch_common.py (torch and pytest). A
    `tests` package installed elsewhere can shadow the folder's name."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, folder, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sam_digest(path):
    """sha256 of a SAM file without its @PG line (the program's own name)."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for line in f:
            if not line.startswith(b"@PG"):
                h.update(line)
    return h.hexdigest()


def post_asm_gate(out_dir, golden=None, stale=None):
    """ci/check_post_asm.py's checks on a run's final_assembly.sam and
    final_assembly_depths.tsv: every assembly contig in the @SQ header with
    its length, the structural SAM check (RNAME, POS, CIGAR lengths, and NM
    recomputed against the contig), one depth row per @SQ line, and, with a
    golden file, its metrics within 2% (the `stale` metrics held to the
    given values instead). Returns the metrics."""
    from mhm2_proxy_tpu_torch.io.fasta import read_fasta

    cpa, caq = repo_module("ci", "check_post_asm"), repo_module("ci", "check_asm_quality")
    contigs = {hdr.split()[0]: seq for hdr, seq in
               read_fasta(os.path.join(out_dir, "final_assembly.fasta"))}
    header_len, records = cpa.parse_sam(os.path.join(out_dir, "final_assembly.sam"))
    check(not set(contigs) - set(header_len), "assembly contigs absent from @SQ")
    check(all(header_len[n] == len(sq) for n, sq in contigs.items()), "@SQ LN differs")
    n_mapped, nm_sum, bases = cpa.structural_check(header_len, records, contigs)
    rows = []
    with open(os.path.join(out_dir, "final_assembly_depths.tsv")) as f:
        check(f.readline().strip().split("\t") == ["contigName", "contigLen", "totalAvgDepth"],
              "depths header")
        for line in f:
            name, ln, d = line.split("\t")
            rows.append((name, int(ln), float(d)))
    check(len(rows) == len(header_len), "depths rows != SAM @SQ count")
    m = {
        "sam_records": len(records),
        "mapped_frac": round(n_mapped / max(len(records), 1), 4),
        "nm_per_100bp": round(100.0 * nm_sum / max(bases, 1), 3),
        "abundance_contigs": len(rows),
        "mean_depth": round(sum(d for _, _, d in rows) / max(len(rows), 1), 3),
        "depth_weighted_bases_ratio": round(sum(ln * d for _, ln, d in rows) / max(bases, 1), 4),
    }
    if golden:
        stale = stale or {}
        want = {k: v for k, v in caq.load_metrics_file(os.path.join(ROOT, "ci", golden)).items()
                if k not in stale}
        errs = caq.compare(m, want, 0.02)
        check(not errs and all(m[k] == v for k, v in stale.items()), f"{golden}: {errs} {m}")
    return m


def ci_sample(work):
    """The CI sample's FASTQ (made once a run, checked against its digest)."""
    d = os.path.join(work, "ci_data")
    fq = os.path.join(d, "synth_sample.fastq")
    if not os.path.exists(fq):
        fq, _gens, n_pairs = make_community(d, "synth_sample", 3, 20000, 5000, 18.0, 150,
                                            20260817, False)
        digest = sha256(fq)
        log(f"[ci] {n_pairs} pairs, fastq sha256 {digest}")
        check(digest == CI_FASTQ_SHA256,
              "CI sample FASTQ differs from ci/make_sample.py's (numpy drift)")
    return fq


def ci_metrics_gate(fa):
    """The CI sample's assembly metrics equal ci/good-synth-sample-k2133.txt."""
    golden = {}
    for line in open(os.path.join(ROOT, "ci", "good-synth-sample-k2133.txt")):
        m = re.match(r"(\w+) = ([\d.]+)", line.strip())
        if m:
            golden[m.group(1)] = float(m.group(2))
    got = asm_metrics(read_fasta_seqs(fa))
    for key, v in got.items():
        check(v == golden[key], f"{key}: {v} vs golden {golden[key]}")
    log(f"[ci] metrics {got} match ci/good-synth-sample-k2133.txt")


def phase_ci(work):
    fq = ci_sample(work)
    out = os.path.join(work, "ci_run")
    wall, counts, _ = run_cli(fq, out, (21, 33), POST_ASM)
    fa = os.path.join(out, "final_assembly.fasta")
    fdig = sha256(fa)
    log(f"[ci] wall {wall:.2f} s, launches {counts}, final_assembly.fasta sha256 {fdig}")
    check(fdig == CI_FASTA_SHA256, "final_assembly.fasta differs from the JAX package's")
    ci_metrics_gate(fa)
    check(all(counts[k] > 0 for k in K21_33_KERNELS + ("ssw",)), counts)
    sam = os.path.join(out, "final_assembly.sam")
    dep = os.path.join(out, "final_assembly_depths.tsv")
    for what, extra, sam_sha, dep_sha, golden in (
        ("--post-asm-align --post-asm-abundance", (), CI_SAM_SHA256, CI_DEPTHS_SHA256,
         "good-synth-postasm.txt"),
        ("--post-asm-only", ("--post-asm-only",), CI_ONLY_SAM_SHA256, CI_ONLY_DEPTHS_SHA256,
         "good-synth-postasm-only.txt"),
    ):
        if extra:  # as ci/ci_post_asm_test.sh: drop the files, rerun on the directory
            os.remove(sam)
            os.remove(dep)
            wall, counts, _ = run_cli(fq, out, None, list(extra) + POST_ASM, fresh=False)
        m = post_asm_gate(out, golden, CI_POSTASM_STALE if not extra else None)
        digests = (sam_digest(sam), sha256(dep))
        log(f"[ci] {what}: wall {wall:.2f} s, ssw launches {counts['ssw']}, SAM (no @PG) sha256 "
            f"{digests[0]}, depths sha256 {digests[1]}, metrics {m} pass ci/{golden} and the "
            f"structural check")
        check(digests == (sam_sha, dep_sha), f"{what}: SAM or depths differ from the JAX package's")
    # the sharded path: 4 shards on the card
    out4 = os.path.join(work, "ci_run_shards4")
    wall, counts, _ = run_cli(fq, out4, (21, 33), ("--shards", "4"))
    fdig = sha256(os.path.join(out4, "final_assembly.fasta"))
    log(f"[ci] --shards 4: wall {wall:.2f} s, launches {counts}, final_assembly.fasta sha256 "
        f"{fdig} (the JAX package's --shards 4: {fdig == CI_SHARDS4_FASTA_SHA256}; the "
        f"single-device digest: {fdig == CI_FASTA_SHA256})")
    check(fdig == CI_SHARDS4_FASTA_SHA256, "--shards 4 FASTA differs from the JAX package's")
    check(all(counts[k] > 0 for k in SHARDED_KERNELS), f"a sharded-path kernel never ran: {counts}")
    # the hierarchical exchange with supermers: 2 hosts x 2 devices
    outh = os.path.join(work, "ci_run_hosts2")
    wall, counts, asm = run_cli(fq, outh, (21, 33), ("--hosts", "2", "--shards", "4"))
    fdig = sha256(os.path.join(outh, "final_assembly.fasta"))
    ex = {k: asm.round_stats[k]["records"] for k in (21, 33)}
    log(f"[ci] --hosts 2 --shards 4: wall {wall:.2f} s, launches {counts}, records {ex}, "
        f"final_assembly.fasta sha256 {fdig} (the JAX package's --hosts 2 --shards 4: "
        f"{fdig == CI_HOSTS2_FASTA_SHA256})")
    check(fdig == CI_HOSTS2_FASTA_SHA256, "--hosts 2 --shards 4 FASTA differs from the JAX "
          "package's")
    check(all(counts[k] > 0 for k in SHARDED_KERNELS), f"a sharded-path kernel never ran: {counts}")


def phase_real(work):
    d = os.path.join(work, "arctic3")
    t0 = time.perf_counter()
    fq, gens, n_pairs = make_community(d, "arctic-scale", 3, 2_250_000, 0, 8.0, 100, 12, True)
    digest = sha256(fq)
    log(f"[real] {sum(map(len, gens))} bp in 3 genomes, {n_pairs} pairs "
        f"({2 * n_pairs} reads), fastq sha256 {digest}, generated in "
        f"{time.perf_counter() - t0:.1f} s")
    check(digest == ARCTIC3_FASTQ_SHA256, "arctic-scale FASTQ differs (numpy drift)")
    out = os.path.join(work, "arctic3_run")
    wall, counts, _ = run_cli(fq, out, (21, 33))
    rounds, modules = parse_run_log(os.path.join(out, "mhm2_torch.log"))
    for k, r in sorted(rounds.items()):
        log(f"[real] k={k}: {r['blocks']} blocks, raw rows {r['raw_rows']} "
            f"({r['raw_bytes'] / 1e9:.3f} GB merged), ctg-rule rows {r['ctg_rule_rows']}, "
            f"table rows {r['kmers']}")
    for name, secs in modules.items():
        log(f"[real] stage {name}: {secs:.2f} s")
    log(f"[real] wall {wall:.2f} s, launches {counts}")
    check(all(counts[k] > 0 for k in K21_33_KERNELS),
          f"a kernel of the path never launched: {counts}")
    fa = os.path.join(out, "final_assembly.fasta")
    seqs = read_fasta_seqs(fa)
    tot = sum(map(len, seqs))
    match = exact_substring_bases(seqs, gens)
    frac = match / max(tot, 1)
    fdig = sha256(fa)
    log(f"[real] {asm_metrics(seqs)}; exact-substring bases {match}/{tot} = {frac:.4f}; "
        f"final_assembly.fasta sha256 {fdig}")
    check(tot > 0 and frac >= 0.95, frac)
    check(fdig == ARCTIC3_FASTA_SHA256, "final_assembly.fasta differs from the JAX package's")
    # supermer density on 100 bp reads: the exchange at --hosts 2 --shards 4,
    # k = 21, in the reference's blocks of 4096 reads
    wall, _, asm = run_cli(fq, os.path.join(work, "arctic3_hosts2"), (21,),
                           ("--hosts", "2", "--shards", "4", "--block-reads", "4096"))
    r = asm.round_stats[21]
    got = (r["records"], r["exchanged_kmers"], r["presummed"], r["resent"], r["spill_rounds"])
    log(f"[real] --hosts 2 --shards 4 -k 21 --block-reads 4096: (records, k-mers, presummed, "
        f"re-sent, spill rounds) {got}, {got[1] / got[0]:.3f} k-mers a record; the JAX "
        f"package's {ARCTIC3_HOSTS2_K21_EXCHANGE}; wall {wall:.2f} s")
    check(got == ARCTIC3_HOSTS2_K21_EXCHANGE, "the supermer exchange differs from the JAX "
          "package's on the 6.75 Mbp cut")


def arctic_community(work):
    """The full --arctic-scale community's FASTQ (checked against its
    digest) and genomes."""
    d = os.path.join(work, "arctic12")
    t0 = time.perf_counter()
    fq, gens, n_pairs = make_community(d, "arctic-scale", 12, 2_250_000, 0, 8.0, 100, 12, True)
    digest = sha256(fq)
    log(f"[arctic] {sum(map(len, gens))} bp in 12 genomes, {n_pairs} pairs ({2 * n_pairs} "
        f"reads), fastq sha256 {digest}, generated in {time.perf_counter() - t0:.1f} s")
    check(digest == ARCTIC12_FASTQ_SHA256, "arctic-scale FASTQ differs (numpy drift)")
    return fq, gens


def span_recording():
    """The package's span recording (utils/trace.py), whose stitch stages
    end at a device sync each; nothing in a tree from before it."""
    try:
        from mhm2_proxy_tpu_torch.utils import trace
    except ImportError:
        return contextlib.nullcontext()
    return trace.recording(syncs=False)


def phase_arctic(work):
    """The full --arctic-scale community through the CLI, default k ladder."""
    fq, gens = arctic_community(work)
    out = os.path.join(work, "arctic12_run")
    from mhm2_proxy_tpu_torch.kcount import KmerCountStore

    k21 = k21_table_copy(KmerCountStore, lambda table: table.to_numpy())
    with k21, launch_meter() as meter, span_recording() as spans:
        wall, counts, _ = run_cli(fq, out)
    totals = meter.totals()
    ladder = {name: totals[name] for name in LADDER_KERNELS}
    rounds, modules = parse_run_log(os.path.join(out, "mhm2_torch.log"))
    for k, r in sorted(rounds.items()):
        log(f"[arctic] k={k}: {r['blocks']} blocks, raw rows {r['raw_rows']} (largest merged "
            f"{r['raw_bytes'] / 1e9:.3f} GB), collapses {r['collapses']}, cascade merges "
            f"{r['cascade_merges']}, deferrals {r['deferrals']}, ranged pieces read "
            f"{r['read_pieces']} ctg-rule {r['ctg_pieces']}, ctg-rule rows "
            f"{r['ctg_rule_rows']}, table rows {r['kmers']}, peak device memory "
            f"{r['peak_bytes'] / 1e9:.2f} GB")
    for line in open(os.path.join(out, "mhm2_torch.log")):
        if re.search(r"k=\d+: (traversal ->|stitch \{)", line):
            log(f"[arctic] {line.strip().split(' ', 2)[-1]}")
    for name, secs in modules.items():
        log(f"[arctic] stage {name}: {secs:.2f} s")
    if spans is not None:
        from mhm2_proxy_tpu_torch.utils import trace

        for line in trace.table(spans):
            log(f"[arctic] {line}")
    log(f"[arctic] wall {wall:.2f} s ({k21.seconds:.2f} s of it copying the k=21 table to the "
        f"host for phases 5b and 8), launches {counts}")
    for name, (calls, ms) in ladder.items():
        log(f"[arctic] kernel {name}: {counts[name]} launches, {calls} C entry calls, "
            f"{ms:.2f} device ms over the ladder (CUDA event pairs around the C entry)")
    for entry, kw, M, Q, ms in meter.join_calls():
        log(f"[arctic] {entry}: {kw} key lanes, {M} merged rows, {Q} queries, {ms:.3f} device ms")
    check(sorted(rounds) == [21, 33, 55, 77, 99], f"rounds run: {sorted(rounds)}")
    check(all(counts[k] > 0 for k in counts if k not in ("ssw", "minimizer")),
          f"a kernel of the path never launched: {counts}")
    check(sum(r["collapses"] for r in rounds.values()) > 0, "no collapse into the split LSM")
    check(sum(r["read_pieces"] for r in rounds.values()) > 0, "no ranged read fold")
    check(sum(r["ctg_pieces"] for r in rounds.values()) > 0, "no ranged ctg-rule fold")
    seqs = read_fasta_seqs(os.path.join(out, "final_assembly.fasta"))
    tot = sum(map(len, seqs))
    match = exact_substring_bases(seqs, gens)
    frac = match / max(tot, 1)
    k21_dig = table_digest(*k21.tables[0])
    log(f"[arctic] {asm_metrics(seqs)}; exact-substring bases {match}/{tot} = {frac:.4f}; "
        f"k=21 table {k21_dig[0]} rows, digest {k21_dig[1][:16]}")
    check(tot > 0 and frac >= 0.95, frac)
    log("[arctic] k=21 edge join: " + ", ".join(
        f"{key} {val}" for key, val in edge_join_shape(k21.tables[0], 21).items()))
    return (fq, gens, counts, out, k21_dig, {name: ms for name, (_c, ms) in ladder.items()},
            k21.tables[0])


def phase_stitch(table, k: int = 21, min_states: int = 3):
    """Phase 5b: the port's stitch on CUDA on a k = 21 table (a host copy
    of a FinalTable; the edges built on the card), at the assembler's
    min_states (its k + 2 contig bound), against the native sequential
    walker (io/native.py) on the same states after the same repair: equal
    sorted (seq, depth) lists, the walker's paths rendered by the same
    canonical_contigs. Logs the states and paths, every stage's seconds,
    the bytes fetched, the stitch's peak device memory, and the walker's
    time with the copy of the states it needs."""
    import numpy as np
    import torch

    from mhm2_proxy_tpu_torch.dbjg import stitch as ST
    from mhm2_proxy_tpu_torch.dbjg.traverse import build_edges, fit_table_rows
    from mhm2_proxy_tpu_torch.io.native import get_stitch_walk
    from mhm2_proxy_tpu_torch.kcount import FinalTable

    ft = fit_table_rows(FinalTable.from_reference(k, *table, device="cuda"))
    edges = build_edges(ft.words, ft.count, ft.left, ft.right, ft.n, k)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    timings: dict = {}
    t0 = time.perf_counter()
    got = ST.stitch_paths(edges, ft.words, ft.count, k, timings=timings, min_states=min_states)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    log(f"[stitch] k={k}: {timings['states']} states, {timings['paths']} paths emitted, "
        f"{timings['paths_kept']} kept (min_states {min_states}); device stitch {wall:.4f} s, "
        f"stages {timings}; fetched {timings['fetched_bytes']} bytes; peak device memory "
        f"{peak} bytes ({resident} bytes of table and edges before it); {card_line()}")

    # the walker: the same pack and repair on the card, the states copied out
    succ, base, cnt = ST._pack_states_device(
        edges["uu"], edges["r_idx"], edges["r_port"], edges["r_ok"],
        edges["l_idx"], edges["l_port"], edges["l_ok"], ft.words, ft.count, k)
    succ, _dropped = ST._repair(succ)
    t0 = time.perf_counter()
    succ, base, cnt = succ.cpu().numpy().astype(np.int64), base.cpu().numpy(), cnt.cpu().numpy()
    fetch_s = time.perf_counter() - t0
    walk = get_stitch_walk()
    check(walk is not None, "the native stitch walker (io/native.py's host library) did not load")
    S = succ.size
    buf = np.empty(S + (k - 1) * (S + 1), np.uint8)
    starts, nst, dep = (np.empty(S + 1, np.int64) for _ in range(3))
    t0 = time.perf_counter()
    n_paths = walk(succ, base, cnt, k, buf, starts, nst, dep)
    walk_s = time.perf_counter() - t0
    check(n_paths >= 0, "the native walker overflowed its buffers")
    starts, nst, dep = starts[:n_paths], nst[:n_paths], dep[:n_paths]
    src = np.zeros(n_paths, np.int64)
    np.cumsum(((k - 1) + nst)[:-1], out=src[1:])
    keep = nst >= min_states
    starts, nst, dep, src = starts[keep], nst[keep], dep[keep], src[keep]
    log(f"[stitch] k={k}: native walker {walk_s:.4f} s ({n_paths} paths, {keep.sum()} kept), "
        f"after copying the repaired states to the host in {fetch_s:.4f} s "
        f"({S * 4 + S + cnt.nbytes} bytes as int32 successors, bases and counts); "
        f"{card_line()}")
    # the walker's kept paths as canonical_contigs takes them
    path = np.repeat(np.arange(nst.size), nst)
    pos = np.arange(path.size) - np.repeat(np.cumsum(nst) - nst, nst)
    on_card = lambda x: torch.from_numpy(np.ascontiguousarray(x)).cuda()  # noqa: E731
    want = ST.canonical_contigs(
        on_card(nst), on_card(path), on_card(pos), on_card(buf[src[path] + (k - 1) + pos]),
        on_card(np.where(pos == 0, dep[path], 0)), ft.words[on_card(starts >> 1)],
        on_card((starts & 1) == 1), k)
    del buf, path, pos, succ, base, cnt
    check(n_paths == timings["paths"] and len(want) == len(got) == timings["paths_kept"],
          "the walker and the device stitch emit different path counts")
    check(sorted(got) == sorted(want), f"k={k}: the device stitch differs from the native walker")
    log(f"[stitch] k={k}: the device stitch equals the native walker ({len(got)} contigs)")
    del ft, edges
    torch.cuda.empty_cache()


def edge_join_shape(table, k: int) -> dict:
    """The shape of build_edges' join on a host copy of a final table
    (words, count, left, right, n), computed on the card as
    dbjg/traverse.py does it: the table trimmed to trim_rows(n) rows, two
    queries a row, all-ones where the row is not UU. Returns the trimmed
    table rows, valid rows, UU rows, all-ones table rows and queries, and
    the longest equal-key run of table rows and queries together."""
    import numpy as np
    import torch

    from mhm2_proxy_tpu_torch.ops import bitkmer as bk
    from mhm2_proxy_tpu_torch.ops.count import trim_rows
    from mhm2_proxy_tpu_torch.ops.u32 import ONES

    words, _count, left, right, n = table
    T = max(256, trim_rows(n))
    m = min(T, words.shape[0])
    w = torch.full((T, words.shape[1]), ONES, dtype=torch.int32, device="cuda")
    w[:m] = torch.from_numpy(np.ascontiguousarray(words[:m]).view(np.int32)).cuda()
    lt = torch.full((T,), 5, dtype=torch.uint8, device="cuda")
    rt = lt.clone()
    lt[:m] = torch.from_numpy(left[:m]).cuda()
    rt[:m] = torch.from_numpy(right[:m]).cuda()
    uu = (torch.arange(T, device="cuda") < n) & (lt < 4) & (rt < 4)
    b_can, _ = bk.canonicalize_words(bk.forward_base_words(w, rt, k), k)
    p_can, _ = bk.canonicalize_words(bk.backward_base_words(w, lt, k), k)
    q = torch.where(torch.cat([uu, uu])[:, None], torch.cat([b_can, p_can]), ONES)
    del b_can, p_can
    runs = torch.unique(torch.cat([w, q]), dim=0, return_counts=True)[1]
    return {"table rows": T, "valid": n, "UU": int(uu.sum()),
            "all-ones table rows": int((w == ONES).all(1).sum()), "queries": 2 * T,
            "all-ones queries": int((q == ONES).all(1).sum()),
            "longest equal-key run": int(runs.max())}


class k21_table_copy:
    """Within the block, every k = 21 table that `store_cls.finalize` returns
    is copied to the host (copy_fn(table)) into `tables`; `seconds` sums the
    copies' time, which lies inside the CLI's wall and the round's counting
    time. The digests are taken after the run."""

    def __init__(self, store_cls, copy_fn):
        self.cls, self.fn, self.tables, self.seconds = store_cls, copy_fn, [], 0.0

    def __enter__(self):
        self.orig = orig = self.cls.finalize

        def finalize(store):
            table = orig(store)
            if store.k == 21:
                t0 = time.perf_counter()
                self.tables.append(self.fn(table))
                self.seconds += time.perf_counter() - t0
            return table

        self.cls.finalize = finalize
        return self

    def __exit__(self, *exc):
        self.cls.finalize = self.orig


def sharded_to_host(table):
    """Each shard's live rows on the host: a list of (words uint32, count,
    left, right, n) as FinalTable.to_numpy gives them."""
    import numpy as np

    return [(table.words[s, :n].cpu().numpy().view(np.uint32), table.count[s, :n].cpu().numpy(),
             table.left[s, :n].cpu().numpy(), table.right[s, :n].cpu().numpy(), n)
            for s, n in enumerate(table.n.tolist())]


def sharded_union_digest(shards):
    """table_digest of the union of a sharded table's shards: the rows in one
    key order (a k-mer lives on one shard only)."""
    import numpy as np

    words, count, left, right = (np.concatenate([sh[i] for sh in shards]) for i in range(4))
    perm = np.lexsort(tuple(words[:, i] for i in range(words.shape[1] - 1, -1, -1)))
    return table_digest(words[perm], count[perm], left[perm], right[perm], words.shape[0])


def phase_sharded_arctic(work, fq, gens, single_out=None, single_k21=None):
    """Phase 8: the full community through the CLI with --shards 4 on the
    default ladder (4 shards on the card): each round's exchange, stitch
    rounds and volume, walls and peak memory; the sharded path's launch
    counts and the minimizer's device ms; >= 95% exact-substring bases;
    and, given phase 5's output (single_out, single_k21), at k = 21 the
    union of the shard tables equals phase 5's single-device table, and the
    contigs that differ from phase 5's FASTA (only cycle break points
    may)."""
    from mhm2_proxy_tpu_torch.parallel import ShardedCounter

    out = os.path.join(work, "arctic12_shards4")
    k21 = k21_table_copy(ShardedCounter, sharded_to_host)
    with k21, launch_meter() as meter:
        wall, counts, asm = run_cli(fq, out, None, ("--shards", "4"))
    m_calls, m_ms = meter.totals()["minimizer"]
    pat = re.compile(r"k=\d+: (counted|exchange|traversal ->|stitch \{|sharded stitch"
                     r"|sharded count)")
    for line in open(os.path.join(out, "mhm2_torch.log")):
        if pat.search(line):
            log(f"[sharded] {line.strip().split(' ', 2)[-1]}")
    rs = asm.round_stats
    for k in sorted(rs):
        r = rs[k]
        sr = r["stitch_rounds"]
        log(f"[sharded] k={k}: {r['records']} records, {r['exchange_bytes'] / 2**20:.1f} MiB, "
            f"{r['exchanged_kmers'] / max(r['records'], 1):.2f} kmers a record, presummed "
            f"{r['presummed']}, re-sent {r['resent']}, spill rounds {r['spill_rounds']}; "
            f"stitch rounds {sr['doubling']}+{sr['cycle_min']}+{sr['post_cut']} (bound "
            f"{sr['static_bound']}), all_to_all {r['stitch_bytes'] / 2**20:.1f} MiB (the "
            f"reference's count; buckets moved {r['stitch_bucket_bytes'] / 2**20:.1f} MiB); "
            f"counting "
            f"{r['count_s']:.2f} s, traversal {r['traverse_s']:.2f} s, table rows {r['kmers']}, "
            f"contigs {r['contigs']}, peak device memory {r['peak_bytes'] / 1e9:.2f} GB")
    for name, secs in parse_run_log(os.path.join(out, "mhm2_torch.log"))[1].items():
        log(f"[sharded] stage {name}: {secs:.2f} s")
    log(f"[sharded] wall {wall:.2f} s ({k21.seconds:.2f} s of it copying the k=21 table to the "
        f"host for the check below), launches {counts}")
    log(f"[sharded] kernel minimizer: {counts['minimizer']} launches, {m_calls} C entry calls, "
        f"{m_ms:.2f} device ms over the ladder (CUDA event pairs around the C entry)")
    check(sorted(rs) == [21, 33, 55, 77, 99], f"rounds run: {sorted(rs)}")
    check(all(counts[k] > 0 for k in SHARDED_KERNELS), f"a sharded-path kernel never ran: {counts}")
    t0 = time.perf_counter()
    union = [sharded_union_digest(t) for t in k21.tables]
    shards = [table_digest(*sh) for sh in k21.tables[0]]
    log(f"[sharded] k=21: union of the shard tables {union[0][0]} rows, digest "
        f"{union[0][1][:16]}; shards {[(n, d[:16]) for n, d in shards]} (hashed in "
        f"{time.perf_counter() - t0:.1f} s after the run)")
    if single_k21 is not None:
        log(f"[sharded] k=21: single-device {single_k21[0]} rows, digest {single_k21[1][:16]}")
        check(union == [single_k21], "k=21: the union of the shard tables differs from the "
              "single-device table")
    seqs = read_fasta_seqs(os.path.join(out, "final_assembly.fasta"))
    tot = sum(map(len, seqs))
    match = exact_substring_bases(seqs, gens)
    frac = match / max(tot, 1)
    log(f"[sharded] {asm_metrics(seqs)}; exact-substring bases {match}/{tot} = {frac:.4f}")
    if single_out is not None:
        single = set(read_fasta_seqs(os.path.join(single_out, "final_assembly.fasta")))
        differ = sum(1 for sq in seqs if sq not in single)
        log(f"[sharded] {differ} of {len(seqs)} printed contigs are not in phase 5's FASTA "
            f"({len(single)} contigs)")
    check(tot > 0 and frac >= 0.95, frac)
    return counts, m_ms, dict(out=out, rounds=rs, k21_shards=shards, wall=wall)


class supermer_meter:
    """Within the block, every build_supermers (the sender's records) and
    expand_supermers (the receiver's windows) call of parallel/sharded.py
    runs between a CUDA event pair, with the device's peak memory reset
    before it and read after it. Those resets make the CLI's own peak for
    the round (round_stats' peak_bytes, the log's "peak device memory")
    the peak since the last stage only. The peak read before each reset is
    kept, so the round's peak is the largest of those, the stages' peaks
    and that end-of-round read; this holds because the assembler resets
    the peak at the start of every round, so no read spans two rounds.
    totals() synchronizes and gives, per k and stage, (calls, device ms,
    peak bytes)."""

    STAGES = ("build_supermers", "expand_supermers")

    def __enter__(self):
        import torch

        from mhm2_proxy_tpu_torch.parallel import sharded

        self.mod, self.orig, self.calls, self.before = sharded, {}, {}, {}
        for name in self.STAGES:
            fn = self.orig[name] = getattr(sharded, name)

            def call(*args, _fn=fn, _name=name, **kw):
                k = args[3] if _name == "build_supermers" else args[1]
                self.before[k] = max(self.before.get(k, 0), torch.cuda.max_memory_allocated())
                torch.cuda.reset_peak_memory_stats()
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
                out = _fn(*args, **kw)
                ev[1].record()
                self.calls.setdefault((k, _name), []).append(
                    (ev, torch.cuda.max_memory_allocated()))
                return out

            setattr(sharded, name, call)
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.mod, name, fn)

    def totals(self):
        import torch

        torch.cuda.synchronize()
        return {key: (len(c), sum(a.elapsed_time(b) for (a, b), _ in c), max(p for _, p in c))
                for key, c in self.calls.items()}


def phase_hosts_arctic(work, fq, gens, sharded=None):
    """Phase 9: the full community through the CLI with --hosts 2 --shards 4
    on the default ladder (2 hosts x 2 devices, supermers through the
    two-stage exchange, on the card): each round's exchange beside phase
    8's at the same k (records, MiB, k-mers a record), presummed and
    re-sent rows, spill rounds, counting and traversal walls, the supermer
    stage's device ms and peaks, and the round's peak memory; the sharded
    path's launch counts; >= 95% exact-substring bases; and, given phase
    8's run (sharded), each k = 21 shard table equals phase 8's shard for
    shard and final_assembly.fasta is byte-identical to phase 8's."""
    from mhm2_proxy_tpu_torch.parallel import ShardedCounter

    out = os.path.join(work, "arctic12_hosts2")
    k21 = k21_table_copy(ShardedCounter, sharded_to_host)
    with k21, supermer_meter() as meter:
        wall, counts, asm = run_cli(fq, out, None, ("--hosts", "2", "--shards", "4"))
    stages = meter.totals()
    pat = re.compile(r"k=\d+: (counted|exchange|traversal ->|sharded stitch|sharded count)")
    for line in open(os.path.join(out, "mhm2_torch.log")):
        if pat.search(line):
            log(f"[hosts] {line.strip().split(' ', 2)[-1]}")
    rs = asm.round_stats
    flat = sharded["rounds"] if sharded else {}
    mib = lambda r: r["exchange_bytes"] / 2**20  # noqa: E731
    kpr = lambda r: r["exchanged_kmers"] / max(r["records"], 1)  # noqa: E731
    for k in sorted(rs):
        r, f = rs[k], flat.get(k)
        sr = r["stitch_rounds"]
        st = {name: stages.get((k, name), (0, 0.0, 0)) for name in supermer_meter.STAGES}
        peak = max([r["peak_bytes"], meter.before.get(k, 0)] + [p for _c, _ms, p in st.values()])
        beside = (f" (phase 8: {f['records']} records, {mib(f):.1f} MiB, {kpr(f):.2f} k-mers a "
                  f"record, counting {f['count_s']:.2f} s, traversal {f['traverse_s']:.2f} s, "
                  f"peak {f['peak_bytes'] / 1e9:.2f} GB)") if f else ""
        log(f"[hosts] k={k}: {r['records']} records, {mib(r):.1f} MiB, {kpr(r):.2f} k-mers a "
            f"record, presummed {r['presummed']}, re-sent {r['resent']}, spill rounds "
            f"{r['spill_rounds']}; counting {r['count_s']:.2f} s, traversal "
            f"{r['traverse_s']:.2f} s, stitch rounds {sr['doubling']}+{sr['cycle_min']}+"
            f"{sr['post_cut']} (bound {sr['static_bound']}); supermer stage: "
            + ", ".join(f"{name} {c} calls {ms:.2f} device ms peak {p / 1e9:.2f} GB"
                        for name, (c, ms, p) in st.items())
            + f"; table rows {r['kmers']}, contigs {r['contigs']}, peak device memory "
            f"{peak / 1e9:.2f} GB{beside}")
    w8 = f" (phase 8: {sharded['wall']:.2f} s)" if sharded else ""
    log(f"[hosts] wall {wall:.2f} s{w8} ({k21.seconds:.2f} s of it copying the k=21 table to "
        f"the host), launches {counts}")
    check(sorted(rs) == [21, 33, 55, 77, 99], f"rounds run: {sorted(rs)}")
    check(all(counts[k] > 0 for k in SHARDED_KERNELS), f"a sharded-path kernel never ran: {counts}")
    check(all(rs[k]["records"] < rs[k]["exchanged_kmers"] for k in rs), "no supermer packing")
    shards = [table_digest(*sh) for sh in k21.tables[0]]
    log(f"[hosts] k=21: shards {[(n, d[:16]) for n, d in shards]}")
    if sharded:
        check(shards == sharded["k21_shards"], "k=21: a shard table differs from phase 8's")
        same = sha256(os.path.join(out, "final_assembly.fasta")) == sha256(
            os.path.join(sharded["out"], "final_assembly.fasta"))
        log(f"[hosts] k=21 shard tables == phase 8's: True; final_assembly.fasta == phase 8's: "
            f"{same}")
        check(same, "final_assembly.fasta differs from phase 8's")
    seqs = read_fasta_seqs(os.path.join(out, "final_assembly.fasta"))
    tot = sum(map(len, seqs))
    match = exact_substring_bases(seqs, gens)
    frac = match / max(tot, 1)
    log(f"[hosts] {asm_metrics(seqs)}; exact-substring bases {match}/{tot} = {frac:.4f}")
    check(tot > 0 and frac >= 0.95, frac)
    return counts


# ---------------------------------------------------------------------------
# phase 10: CLI ranks over torch.distributed
# ---------------------------------------------------------------------------

# one CLI rank (main.main, which the rendezvous variables join to its group)
# that then writes its kernels' launch counts to the file of its first argument
RANK = ("import json, sys\n"
        "from mhm2_proxy_tpu_torch.main import main\n"
        "from mhm2_proxy_tpu_torch.ops import kernels\n"
        "main(sys.argv[2:])\n"
        "json.dump(kernels.launches(), open(sys.argv[1], 'w'))\n")


def free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_ranks(argv, out_dir, n, timeout=900):
    """n CLI ranks on the card (they share it), joined by MHM2_TPU_NUM_PROCS /
    MHM2_TPU_PROC_ID / MHM2_TPU_COORDINATOR, on argv + `-o out_dir`; each
    one's output in out_dir.<pid>.out. Fails unless every one exits 0, and
    kills the rest as soon as one fails. Returns (wall, each rank's launch
    counts)."""
    import mhm2_proxy_tpu_torch

    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(mhm2_proxy_tpu_torch.__file__)))
    shutil.rmtree(out_dir, ignore_errors=True)
    port = free_port()
    t0 = time.perf_counter()
    procs = []
    try:
        for pid in range(n):
            out = open(f"{out_dir}.{pid}.out", "w")
            env = dict(os.environ, PYTHONPATH=pkg_root, MHM2_TPU_NUM_PROCS=str(n),
                       MHM2_TPU_PROC_ID=str(pid), MHM2_TPU_COORDINATOR=f"localhost:{port}")
            procs.append((subprocess.Popen(
                [sys.executable, "-c", RANK, f"{out_dir}.{pid}.json", *argv, "-o", out_dir],
                env=env, cwd=pkg_root, stdout=out, stderr=subprocess.STDOUT), out))
        while any(p.poll() is None for p, _ in procs):
            failed = any(p.poll() not in (None, 0) for p, _ in procs)
            check(not failed and time.perf_counter() - t0 < timeout,
                  f"a rank of {n} failed or the run passed {timeout} s")
            time.sleep(0.5)
    finally:
        for p, f in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            f.close()
            if p.returncode:
                log(open(f.name).read()[-4000:])
    check(all(p.returncode == 0 for p, _ in procs),
          f"ranks exited {[p.returncode for p, _ in procs]}")
    return time.perf_counter() - t0, [json.load(open(f"{out_dir}.{pid}.json"))
                                      for pid in range(n)]


def phase_multiproc(work, fq):
    """Phase 10: CLI ranks over torch.distributed on the one card, the
    community at k = 21 with --hosts 2 --shards 4, against the
    single-process CLI at the same layout: two ranks that share the card
    (gloo), then one rank (NCCL). Each run's final_assembly.fasta and
    contigs-21.fasta equal the control's byte for byte, its log names its
    backend, and each gloo rank has its per-rank log and launched every
    kernel of the sharded path. Returns the two gloo ranks' launches summed."""
    layout = ["-k", "21", "--hosts", "2", "--shards", "4"]
    ctrl = os.path.join(work, "mp_one")
    wall = run_cli(fq, ctrl, None, layout)[0]
    log(f"[multiproc] control: one process, {' '.join(layout)}: {wall:.2f} s")
    files = ("final_assembly.fasta", "contigs-21.fasta")
    digests = [sha256(os.path.join(ctrl, f)) for f in files]
    summed = {}
    for n, backend in ((2, "gloo"), (1, "nccl")):
        out = os.path.join(work, f"mp_{backend}")
        wall, launches = run_ranks(["-r", fq, *layout], out, n)
        said = f"process 0 of {n}, backend {backend}" in open(
            os.path.join(out, "mhm2_torch.log")).read()
        same = [sha256(os.path.join(out, f)) for f in files] == digests
        log(f"[multiproc] {n} rank(s) over {backend}: wall {wall:.2f} s (process start and the "
            f"libraries' load included), launches {launches}; the log names {backend}: {said}; "
            f"{' and '.join(files)} == the control's: {same}")
        check(said, f"the {n}-rank run did not take the {backend} backend")
        check(same, f"the {n}-rank run's FASTA files differ from the control's")
        if n > 1:
            for pid, counts in enumerate(launches):
                check(all(counts[k] > 0 for k in SHARDED_KERNELS),
                      f"rank {pid}: a sharded-path kernel never ran: {counts}")
                check(os.path.exists(os.path.join(out, "per_rank", "00000000", f"{pid:08d}",
                                                  "mhm2_torch.log")), f"rank {pid}: no log")
            summed = {k: sum(c[k] for c in launches) for k in launches[0]}
    return summed


MERGE_KEYS = ("merged", "m_len", "overlap", "m_codes", "m_quals", "quals1_z", "quals2_z")


def merge_blocks(fq):
    """The pair blocks that the CLI's interleaved ingest merges
    (Assembler.load_reads on CUDA): (c1, q1, l1, c2, q2, l2) of every block
    of 2 x 131,072 reads."""
    import numpy as np

    from mhm2_proxy_tpu_torch.io.stream import stream_fastq_blocks
    from mhm2_proxy_tpu_torch.models.assembler import AssemblerConfig, resolve_block_reads

    cfg = AssemblerConfig()
    B = resolve_block_reads(cfg.block_reads, "cuda")
    for c, q, l, _n in stream_fastq_blocks(fq, 2 * B, pad_quantum=cfg.pad_len_quantum,
                                           qual_offset=cfg.qual_offset,
                                           chunk_bytes=cfg.chunk_bytes):
        yield tuple(np.ascontiguousarray(x) for x in (c[0::2], q[0::2], l[0::2],
                                                      c[1::2], q[1::2], l[1::2]))


def same_merge(a, b) -> bool:
    """Every per-pair key and the ambiguity count equal (tolerance 0)."""
    import numpy as np

    return (all(np.array_equal(a[k], b[k]) for k in MERGE_KEYS)
            and int(a["n_ambiguous"]) == int(b["n_ambiguous"]))


def adversarial_block(blk, rows: int = 8192, every: int = 16):
    """The first `rows` pairs of a block with every `every`-th replaced by a
    low-complexity pair that passes the merge's prefilter at many shifts
    (tests/test_merge.py's poly-A and dinucleotide repeats, a triplet
    repeat, an N-rich repeat and an all-N pair), 100 bp, quality 'F'."""
    import numpy as np

    c1, q1, l1, c2, q2, l2 = (np.array(x[:rows]) for x in blk)
    kinds = [([0], [3]), ([0, 1], [2, 3]), ([0, 3], [0, 3]), ([1, 0, 2], [1, 3, 2]),
             ([0, 1, 4, 2, 3], [0, 1, 4, 2, 3]), ([4], [4])]
    for t, r in enumerate(range(0, rows, every)):
        u1, u2 = kinds[t % len(kinds)]
        n = 100 - 100 % len(u1)
        for c, q, ln, unit in ((c1, q1, l1, u1), (c2, q2, l2, u2)):
            c[r] = 4
            c[r, :n] = np.resize(np.array(unit, np.uint8), n)
            q[r] = 33
            q[r, :n] = 70
            ln[r] = n
    return c1, q1, l1, c2, q2, l2


def phase_merge(fq):
    """The pair merge on the card against the native merge on every pair of
    the 27 Mbp community (the CLI's blocks), then the adversarial block."""
    import numpy as np
    import torch

    from mhm2_proxy_tpu_torch.io import merge, native

    check(native.merge_available(), "the native merge library is not available")
    ev = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731
    tot = dict(pairs=0, merged=0, ambig=0, blocks=0, dense_blocks=0, dense_rows=0,
               native_s=0.0, device_ms=0.0, device_wall_s=0.0, h2d_ms=0.0, d2h_ms=0.0, peak=0)
    first = None
    t_phase = time.perf_counter()
    for blk in merge_blocks(fq):
        first = first or blk
        t0 = time.perf_counter()
        nat = merge.merge_reads_arrays(*blk, use_native=True)
        tot["native_s"] += time.perf_counter() - t0
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        st = {}
        e0, e1 = ev(), ev()
        t0 = time.perf_counter()
        e0.record()
        dev = merge.merge_reads_arrays(*blk, use_native=False, device="cuda", stats=st)
        e1.record()
        torch.cuda.synchronize()
        tot["device_wall_s"] += time.perf_counter() - t0
        tot["device_ms"] += e0.elapsed_time(e1)
        tot["peak"] = max(tot["peak"], torch.cuda.max_memory_allocated() - base)
        # the copies alone: the block in, the results out
        e2, e3 = ev(), ev()
        e0.record()
        ins = [torch.from_numpy(x).to("cuda") for x in blk]
        e1.record()
        outs = [torch.from_numpy(np.asarray(dev[k])).to("cuda") for k in MERGE_KEYS]
        e2.record()
        host = [o.cpu() for o in outs]
        e3.record()
        torch.cuda.synchronize()
        tot["h2d_ms"] += e0.elapsed_time(e1)
        tot["d2h_ms"] += e2.elapsed_time(e3)
        del ins, outs, host
        check(same_merge(dev, nat), f"block {tot['blocks']}: the device merge differs from "
              "the native merge")
        tot["pairs"] += int(((blk[2] > 0) & (blk[5] > 0)).sum())
        tot["merged"] += int(nat["merged"].sum())
        tot["ambig"] += int(nat["n_ambiguous"])
        tot["blocks"] += 1
        tot["dense_blocks"] += st["dense_rows"] > 0
        tot["dense_rows"] += st["dense_rows"]
    L = first[0].shape[1]
    log(f"[merge] {tot['pairs']} pairs in {tot['blocks']} blocks of {first[0].shape[0]} (L = "
        f"{L}, {merge.chunk_rows(L)} rows a chunk): {tot['merged']} merged, "
        f"{tot['ambig']} ambiguous; device == native on every key of every pair")
    log(f"[merge] native {tot['native_s']:.3f} s (wall, {os.cpu_count()} threads); device "
        f"{tot['device_ms'] / 1e3:.3f} s (CUDA events around merge_reads_arrays, copies "
        f"included; wall {tot['device_wall_s']:.3f} s), of which the copies alone take "
        f"{tot['h2d_ms'] / 1e3:.3f} s in and {tot['d2h_ms'] / 1e3:.3f} s out; "
        f"{tot['dense_blocks']} blocks overflowed to the dense scan ({tot['dense_rows']} "
        f"rows); device peak {tot['peak'] / 1e9:.3f} GB above the inputs")
    check(tot["pairs"] > 1_000_000 and tot["merged"] > 0, tot)
    # the adversarial block: the shortlist overflows, and the dense scan,
    # the wrapper (shortlist + dense rerun) and the native merge agree
    adv = adversarial_block(first)
    args = [torch.from_numpy(x).to("cuda") for x in adv]
    short = merge.merge_pairs_block(*args, scan="shortlist")
    dense = {k: v.cpu().numpy() for k, v in merge.merge_pairs_block(*args, scan="dense").items()}
    st = {}
    wrapper = merge.merge_reads_arrays(*adv, use_native=False, device="cuda", stats=st)
    nat = merge.merge_reads_arrays(*adv, use_native=True)
    log(f"[merge] adversarial block of {adv[0].shape[0]} pairs: shortlist overflow "
        f"{bool(short['overflow'])}, {st['dense_rows']} rows rerun densely, "
        f"{int(nat['merged'].sum())} merged, {int(nat['n_ambiguous'])} ambiguous; dense == "
        f"wrapper == native: {same_merge(dense, wrapper) and same_merge(wrapper, nat)}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    check(bool(short["overflow"]) and st["dense_rows"] >= adv[0].shape[0] // 16 // 2,
          "the adversarial block did not overflow the shortlist")
    check(same_merge(dense, wrapper) and same_merge(wrapper, nat),
          "adversarial block: dense, wrapper and native merges differ")
    return tot


def phase_ci_device_merge(work, root):
    """The CI sample through the CLI in a child process with
    MHM2_NO_NATIVE_MERGE=1 (the merge on the card): the JAX package's FASTA
    digest and ci/good-synth-sample-k2133.txt's metrics."""
    fq = ci_sample(work)
    out = os.path.join(work, "ci_run_device_merge")
    shutil.rmtree(out, ignore_errors=True)
    env = dict(os.environ, MHM2_NO_NATIVE_MERGE="1",
               PYTHONPATH=os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "mhm2_proxy_tpu_torch", "-r", fq, "-o", out,
                          "-k", "21", "33"], cwd=root, env=env, capture_output=True, text=True,
                         timeout=600)
    wall = time.perf_counter() - t0
    check(res.returncode == 0, f"the CLI with MHM2_NO_NATIVE_MERGE=1 failed: "
          f"{res.stdout[-2000:]} {res.stderr[-2000:]}")
    with open(os.path.join(out, "mhm2_torch.log")) as f:
        said = [line.strip() for line in f if "pair merge:" in line or "Merged " in line]
    fdig = sha256(os.path.join(out, "final_assembly.fasta"))
    log(f"[ci] MHM2_NO_NATIVE_MERGE=1: wall {wall:.2f} s (a child process), {said}, "
        f"final_assembly.fasta sha256 {fdig}")
    check(any("block-vectorized merge on cuda" in line for line in said),
          "the CLI did not run the device merge")
    check(fdig == CI_FASTA_SHA256, "final_assembly.fasta with the device merge differs from "
          "the JAX package's")
    ci_metrics_gate(os.path.join(out, "final_assembly.fasta"))


def phase_post_asm(fq, out):
    """--post-asm-only --post-asm-align --post-asm-abundance on the full
    community's output directory: every read aligned to the 27 Mbp
    assembly, the structural SAM check, and the first 16,384 reads aligned
    on CUDA and on the CPU against the same index."""
    import numpy as np
    import torch

    from mhm2_proxy_tpu_torch.models.post_asm import align_reads_to_contigs, build_contig_index
    from mhm2_proxy_tpu_torch.ops import ssw

    # each launch's DP cells (q_len x r_len a pair), for GCUPS, and the
    # kernel's device time
    metered, launch = [], ssw._sw_ends_cuda

    def sw_ends_counted(query, q_len, ref, r_len, **scoring):
        Lq, Lr = query.shape[1], ref.shape[1]
        metered.append((q_len.clamp(0, Lq).long() * r_len.clamp(0, Lr).long()).sum())
        return launch(query, q_len, ref, r_len, **scoring)

    ssw._sw_ends_cuda = sw_ends_counted
    try:
        with launch_meter() as meter:
            wall, counts, asm = run_cli(fq, out, None, ["--post-asm-only"] + POST_ASM, fresh=False)
    finally:
        ssw._sw_ends_cuda = launch
    cells = sum(int(c) for c in metered)
    _calls, kernel_ms = meter.totals()["ssw"]
    stats = timings = ""
    for line in open(os.path.join(out, "mhm2_torch.log")):
        if "post-asm-align: {" in line:
            stats = line.split("post-asm-align: ", 1)[1].strip()
        if "post-asm-align timings:" in line:
            timings = line.split("timings: ", 1)[1].strip()
    log(f"[post-asm] {len(asm.contigs)} contigs, {len(asm.packed_reads)} reads: {stats}")
    log(f"[post-asm] wall {wall:.2f} s ({timings}); ssw launches {counts['ssw']}, {cells} "
        f"cells in {kernel_ms:.2f} kernel ms (CUDA event pairs around the C entry): "
        f"{cells / kernel_ms / 1e6:.1f} GCUPS")
    check(counts["ssw"] > 0 and cells > 0, f"ssw never launched: {counts}")
    m = post_asm_gate(out)
    log(f"[post-asm] structural check passed: {m}")
    check(m["mapped_frac"] > 0.8, m)

    contigs = [c.seq for c in asm.contigs]
    codes, _q, lens, _ids = next(asm.packed_reads.blocks(16384, min_len=31, with_ids=True))
    del asm
    t0 = time.perf_counter()
    index = build_contig_index(contigs, 31, device="cuda")
    got = {"cuda": align_reads_to_contigs(codes, lens, contigs, index=index, k=31, cigars=True)}
    cuda_s = time.perf_counter() - t0
    index = {k: v.cpu() if torch.is_tensor(v) else v for k, v in index.items()}
    t0 = time.perf_counter()
    got["cpu"] = align_reads_to_contigs(codes, lens, contigs, index=index, k=31, cigars=True)
    cpu_s = time.perf_counter() - t0
    a, b = got["cuda"], got["cpu"]
    same = a["cigar"] == b["cigar"] and all(
        np.array_equal(a[n], b[n]) for n in a if n != "cigar")
    log(f"[post-asm] first 16384 reads: {int((a['cid'] >= 0).sum())} anchored, CUDA "
        f"{cuda_s:.1f} s (index included), CPU {cpu_s:.1f} s, CUDA == CPU (cid, score, begins, "
        f"ends, CIGARs, NM, windows, codes): {same}")
    check(same, "post-asm alignment on CUDA differs from the CPU")
    return counts


def table_digest(words, cnt, left, right, n):
    """(rows, sha256 of the first n rows of words, count, left and right)."""
    h = hashlib.sha256()
    for x in (words[:n], cnt[:n], left[:n], right[:n]):
        h.update(x.tobytes())
    return n, h.hexdigest()


# the forced store of phase 6: the raw budget collapses every few blocks,
# cascade merges of collapsed runs are deferred, and both folds run by range
FORCED = dict(raw_budget_bytes=256 << 20, cascade_max_rows=20_000_000,
              RANGED_FOLD_TARGET_ROWS=8_000_000)


def phase_store_equality(fq, gens, device="cuda", forced=FORCED, block_reads=131072):
    """k = 33 on the community's reads + contig windows of its genomes:
    the store with the collapse, deferral and ranged folds forced equals the
    raw-only path."""
    import numpy as np
    import torch

    from mhm2_proxy_tpu_torch.constants import QUAL_CUTOFF
    from mhm2_proxy_tpu_torch.kcount import KmerCountStore
    from mhm2_proxy_tpu_torch.models.assembler import Assembler, AssemblerConfig
    from mhm2_proxy_tpu_torch.ops.bitkmer import ascii_to_codes

    t0 = time.perf_counter()
    asm = Assembler(AssemblerConfig(device=device))
    asm.load_reads([fq])
    log(f"[store] loaded {len(asm.packed_reads)} reads in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(33)
    seg = asm.CTG_MAX_SEG
    # k = 33 only, for the script's time limit (phase 8 takes ~110 s); k =
    # 77's separate payload through the forced split LSM stays in phase 2
    for k in (33,):
        # contig windows tiling every genome (k + 1 overlap), depths 1-60,
        # one base changed in every 16th window (ext conflicts)
        wins = [g[st : st + seg] for g in gens for st in range(0, len(g) - (k + 1), seg - (k + 1))]
        codes = np.full((len(wins), seg), 4, np.uint8)
        lens = np.array([len(w) for w in wins], np.int32)
        for i, w in enumerate(wins):
            codes[i, : len(w)] = ascii_to_codes(w.encode())
        codes[::16, seg // 2] = (codes[::16, seg // 2] + 1) % 4
        deps = rng.integers(1, 61, len(wins)).astype(np.int32)
        got = {}
        for name in ("forced", "raw-only"):
            if device == "cuda":
                torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            if name == "forced":
                st = KmerCountStore(k, device=device, raw_budget_bytes=forced["raw_budget_bytes"])
                st.cascade_max_rows = forced["cascade_max_rows"]
                st.RANGED_FOLD_MIN_ROWS = 0
                st.RANGED_FOLD_TARGET_ROWS = forced["RANGED_FOLD_TARGET_ROWS"]
            else:
                st = KmerCountStore(k, device=device, raw_budget_bytes=1 << 62)
                st.RANGED_FOLD_MIN_ROWS = 1 << 62
            q = asm.cfg.pad_len_quantum
            L = max(((asm.packed_reads.max_read_len + q - 1) // q) * q, k + q)
            for rc, rq, rl in asm.packed_reads.blocks(block_reads, pad_len=L, min_len=k):
                st.add_reads_block(rc, rq >= asm.cfg.qual_offset + QUAL_CUTOFF, rl)
            for s0 in range(0, len(wins), 2048):
                st.add_ctgs_block(codes[s0 : s0 + 2048], lens[s0 : s0 + 2048],
                                  deps[s0 : s0 + 2048])
            resident = st.resident_run_bytes()
            got[name] = table_digest(*st.finalize().to_numpy())
            stats = dict(st.stats)
            peak = torch.cuda.max_memory_allocated() / 1e9 if device == "cuda" else 0.0
            log(f"[store] k={k} {name}: {got[name][0]} rows, digest {got[name][1][:16]}, "
                f"{time.perf_counter() - t1:.1f} s, read runs resident before finalize "
                f"{resident / 1e9:.2f} GB, peak device memory {peak:.2f} GB, stats {stats}")
            if name == "forced":
                check(stats["collapses"] > 1 and stats["cascade_deferrals"] > 0
                      and stats["read_pieces"] > 2 and stats["ctg_pieces"] > 2,
                      f"k={k}: the forced store did not collapse, defer and range: {stats}")
            del st
        check(got["forced"] == got["raw-only"] and got["forced"][0] > 0,
              f"k={k}: forced split-LSM table differs from the raw-only table")
        log(f"[store] k={k}: forced == raw-only")


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: no CUDA device", file=sys.stderr)
        return 2
    # `--only callers|ladder|stitch|kernels|sharded [DIR]`: only
    # phase_callers, only phase 5 (the 27 Mbp ladder, its kernels metered),
    # only phase 5b (the community's k = 21 round, then the stitch against
    # the walker on its table), only phase 2's
    # extract, finalize, join, collapse (scan, compact), ssw and minimizer
    # rows, only phase 8 (the 27 Mbp community with --shards 4, the
    # minimizer metered), or only phase 9 (the same with --hosts 2 --shards
    # 4, the supermer stage metered), or only phase 10 (CLI ranks over
    # torch.distributed on the one card), or only phase 2's lookup rows, or
    # only the pair-merge phase and the CI sample with the device merge, on
    # the package of DIR (default this checkout), e.g. a parent tree
    # unpacked beside it
    only = argv[1] if argv[:1] == ["--only"] and len(argv) > 1 else None
    if argv and only not in ("callers", "ladder", "stitch", "kernels", "sharded", "hosts",
                             "multiproc", "lookup", "merge"):
        print("usage: chip_smoke.py [--only callers|ladder|stitch|kernels|sharded|hosts|"
              "multiproc|lookup|merge [PACKAGE_DIR]]", file=sys.stderr)
        return 2
    root = os.path.abspath(argv[2]) if len(argv) > 2 else ROOT
    if not os.path.isdir(os.path.join(root, "mhm2_proxy_tpu_torch")):
        # the script alone: there is nothing to build or drive
        print(f"chip_smoke: no mhm2_proxy_tpu_torch/ in {root}; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 3
    sys.path.insert(0, root)
    if only:
        log(f"[card] {card_line()}; package {root}")
        # the kernels' build first, so that no metered call spans it
        from mhm2_proxy_tpu_torch.ops import _build

        _build.load()
        if only == "callers":
            phase_callers()
            return 0
        if only == "lookup":
            gen = torch.Generator(device="cuda")
            gen.manual_seed(20260817)
            phase_lookup(gen)
            return 0
        if only == "kernels":
            gen = torch.Generator(device="cuda")
            gen.manual_seed(20260817)
            record = make_recorder({})
            phase_extract(record, gen)
            phase_range_cuts(record, gen)
            genome = phase_finalize(record, gen)
            phase_join(record, gen)
            phase_collapse_kernels(record, genome, gen)
            phase_ssw(record, gen)
            phase_minimizer(record, gen)
            return 0
        work = os.path.join(ROOT, "chip_smoke_work")
        try:
            if only == "ladder":
                phase_arctic(work)
            elif only == "stitch":
                from mhm2_proxy_tpu_torch.kcount import KmerCountStore

                fq, _gens = arctic_community(work)
                k21 = k21_table_copy(KmerCountStore, lambda table: table.to_numpy())
                with k21:
                    wall = run_cli(fq, os.path.join(work, "arctic12_k21"), (21,))[0]
                log(f"[stitch] the community's k = 21 round through the CLI in {wall:.2f} s")
                phase_stitch(k21.tables[0])
            elif only == "sharded":
                phase_sharded_arctic(work, *arctic_community(work))
            elif only == "hosts":
                phase_hosts_arctic(work, *arctic_community(work))
            elif only == "merge":
                phase_merge(arctic_community(work)[0])
                phase_ci_device_merge(work, root)
            else:
                log(f"[multiproc] launches {phase_multiproc(work, arctic_community(work)[0])}")
        finally:
            shutil.rmtree(work, ignore_errors=True)
        return 0
    from mhm2_proxy_tpu_torch.ops import _build, kernels

    t_start = time.perf_counter()
    card = card_line()
    log(f"[card] {card}")
    log(f"[versions] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.load()
    log(f"[build] kernels ready in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 'cached'}), "
        f"{_build.library_path}")
    work = os.path.join(ROOT, "chip_smoke_work")
    results: dict = {}
    try:
        phase_kernels(results)
        phase_callers()
        phase_devices()
        phase_sharded_devices()
        phase_ci(work)
        phase_real(work)
        fq, gens, counts, out, k21, ladder_ms, k21_table = phase_arctic(work)
        phase_stitch(k21_table)
        del k21_table
        phase_merge(fq)
        phase_ci_device_merge(work, root)
        phase_store_equality(fq, gens)
        counts["ssw"] = phase_post_asm(fq, out)["ssw"]
        sharded_counts, ladder_ms["minimizer"], sharded = phase_sharded_arctic(
            work, fq, gens, out, k21)
        counts["minimizer"] = sharded_counts["minimizer"]
        hosts_counts = phase_hosts_arctic(work, fq, gens, sharded)
        multiproc_counts = phase_multiproc(work, fq)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    summary = []
    for name, (src, replaces) in kernels.KERNELS.items():
        r = results[name]
        summary.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                            launches=counts[name], max_abs_err=r["max_abs_err"],
                            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"], library_ms=r["library_ms"],
                            shape=r["shape"], ladder_ms=ladder_ms.get(name),
                            hosts_launches=hosts_counts[name],
                            multiproc_launches=multiproc_counts[name]))
    log(f"[done] every phase passed in {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": summary}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
