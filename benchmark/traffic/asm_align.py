"""Traffic kind `asm_align`: a closed loop of whole assemblies, each aligning
every read back to its own contigs.

Each job is what `python -m mhm2_proxy_tpu_torch -r <fastq> -o <dir>
--post-asm-align --post-asm-abundance` runs: `main.run_pipeline` with the
ladder traffic's options and both post-assembly flags, from the interleaved
FASTQ to `final_assembly.fasta`, `final_assembly.sam` (every packed read of
at least 31 bases against the final contigs) and
`final_assembly_depths.tsv`. Set-up makes the community from the seed and
writes its FASTQ as the ladder traffic does, then runs a slice of the same
reads through the same pipeline once, alignment included, so that every
round, block and alignment shape has run. The configuration's
`post_asm_align` and `post_asm_abundance` give the two flags.

The check, once the window has closed: the ladder traffic's check of every
job's merged reads, round contigs and final contigs against the plain
reference; then the post_asm traffic's judges of every job's SAM and depth
table against that job's own contigs: a sample of reads drawn from the
seed, with the longest reads in it, is anchored again by the plain
reference (benchmark/reference/align.py), which judges each record by what
it says; each read has exactly one record; every depth row equals the sum
of the reference bases that the SAM's records cover on its contig, over
its length. Jobs whose contigs, SAM and depth table hash equal take the
first one's verdict.
"""

from __future__ import annotations

import hashlib
import os
import re
import sys
import time
import types

import numpy as np
import torch

from ..gen.community import make_community, write_fastq
from ..reference import align
from . import ladder, post_asm

def _options(ctx, fastq: str, out_dir: str):
    opts = ladder._options(ctx, fastq, out_dir)
    opts.post_asm_align = bool(ctx.config["post_asm_align"])
    opts.post_asm_abundance = bool(ctx.config["post_asm_abundance"])
    return opts


def setup(ctx) -> None:
    from mhm2_proxy_tpu_torch.main import run_pipeline

    p, cfg = ctx.workload["params"], ctx.config
    parts = ctx.state["setup_parts"] = {}
    t0 = time.perf_counter()
    com = ctx.state["community"] = make_community(cfg, ctx.seed)
    t1 = time.perf_counter()
    fq = ctx.state["fastq"] = os.path.join(ctx.tmp, "reads.fastq")
    write_fastq(com, fq, cfg["qual_offset"])
    n = min(com.n_pairs, int(p["warmup_pairs"]))
    warm = os.path.join(ctx.tmp, "warmup.fastq")
    write_fastq(com, warm, cfg["qual_offset"], rows=np.arange(n))
    t2 = time.perf_counter()
    run_pipeline(_options(ctx, warm, os.path.join(ctx.tmp, "warmup")))
    os.remove(warm)
    parts.update(community=t1 - t0, fastq=t2 - t1, warmup=time.perf_counter() - t2)


def span_targets():
    return ladder.span_targets() + post_asm.span_targets()


_TIMING = re.compile(r"(\w+_s) ([0-9.]+)s")


def post_asm_timings(log: list[str]) -> dict:
    """post_asm_align's timings as the job's log line gives them."""
    for line in log:
        if "post-asm-align timings: " in line:
            return {k: float(v) for k, v in _TIMING.findall(line.split("timings: ", 1)[1])}
    return {}


def job(ctx, i: int) -> dict:
    from mhm2_proxy_tpu_torch.main import run_pipeline

    out = os.path.join(ctx.tmp, f"job{i}")
    asm = run_pipeline(_options(ctx, ctx.state["fastq"], out))
    with open(os.path.join(out, "mhm2_torch.log")) as f:
        log = f.read().splitlines()
    return dict(out_dir=out, log=log, round_stats=dict(asm.round_stats),
                packed_reads=asm.packed_reads, timings=post_asm_timings(log),
                contigs=[(c.id, c.seq) for c in asm.contigs])


def end_to_end(ctx, jobs, wall_s: float) -> dict:
    return {"assembly_s": wall_s / len(jobs)}


# -- the check -------------------------------------------------------------


def _alignment_verdict(ctx, jb, score_bits):
    """(sampled records wrong, reads without exactly one record, depth rows
    wrong) of one job's SAM and depth table, against its own contigs and
    reads."""
    p, dev = ctx.workload["params"], ctx.device
    contigs = [s for _, s in jb["contigs"]]
    cnames = [f"Contig{i}" for i, _ in jb["contigs"]]
    t0 = time.perf_counter()
    codes, lens, names, L = post_asm._reads(types.SimpleNamespace(
        packed_reads=jb["packed_reads"]), align.K)
    rows = post_asm.sample_rows(len(names), lens, ctx.seed, int(p["check_reads"]),
                                int(p["check_longest"]))
    index = align.contig_index(contigs, dev)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa: E731
    an = align.anchor(index, t(codes[rows]), t(lens[rows]), L)
    win = align.windows(index, an, L)
    best = align.best_scores(an["oriented"], t(lens[rows]), win, an["r_len"])
    claimed = None
    if score_bits:
        claimed = align.to_numpy(align.best_scores(an["oriented"], t(lens[rows]), win,
                                                   an["r_len"], bits=score_bits))
    an = {n: align.to_numpy(v) for n, v in an.items()}
    best = align.to_numpy(best)
    del index, win
    print(f"reference: {len(rows)} of {len(names)} reads anchored and scored in "
          f"{time.perf_counter() - t0:.2f}s", file=sys.stderr, flush=True)
    return post_asm._judge(os.path.join(jb["out_dir"], "final_assembly.sam"),
                           os.path.join(jb["out_dir"], "final_assembly_depths.tsv"),
                           names, rows, lens, an, best, claimed, contigs, cnames)


def check(ctx, jobs, score_bits=None):
    """({name: (value, limit)}, jobs with any difference). score_bits=8 is
    the control: the reference's best scores saturated at 127 in place of
    the program's AS. The jobs whose alignment is wrong, plus those the
    assembly check fails, up to the number of jobs (that check gives a
    count, not which jobs)."""
    checks, asm_failed = ladder.check(ctx, jobs)
    wrong = missing = depth_bad = failed = 0
    verdicts: dict[str, tuple[int, int, int]] = {}
    for jb in jobs:
        h = hashlib.sha256()
        for cid, seq in jb["contigs"]:
            h.update(f">{cid}\n{seq}\n".encode())
        key = h.hexdigest() + "".join(
            post_asm._digest(os.path.join(jb["out_dir"], f))
            for f in ("final_assembly.sam", "final_assembly_depths.tsv"))
        if key not in verdicts:
            verdicts[key] = _alignment_verdict(ctx, jb, score_bits)
        bad, miss, d = verdicts[key]
        wrong, missing, depth_bad = wrong + bad, missing + miss, depth_bad + d
        failed += bool(bad or miss or d)
    checks |= {
        "sam_records_wrong": (wrong, 0),
        "sam_reads_missing": (missing, 0),
        "depth_rows_wrong": (depth_bad, 0),
    }
    return checks, min(len(jobs), failed + asm_failed)
