"""Traffic kind `post_asm`: a closed loop of whole post-assembly passes.

Each job is what `--post-asm-align --post-asm-abundance` runs after the
ladder: `models.post_asm.post_asm_align` over every read of the set-up's
assembler against its final contigs, writing the SAM file and the depth
table. Set-up makes the community, assembles it once with the CLI's own
options (the contigs the reads align to), and aligns one block of reads.

The check, once the window has closed: the set-up's assembly, which every
pass aligns to, is held to the plain reference as a ladder job is (its
merged reads, each round's contigs and the final contigs); in every job's
SAM, each read has exactly one record; a sample of reads drawn from the seed, with the longest
reads in it, is anchored again by the plain reference, which computes the
best local alignment score there and judges each record by what it says
(benchmark/reference/align.py); and every depth row equals the sum of the
reference bases that the SAM's records cover on its contig, over its
length.
"""

from __future__ import annotations

import hashlib
import os
import sys
import time

import numpy as np
import torch

from ..gen.community import make_community, write_fastq
from ..reference import align
from . import ladder


def setup(ctx) -> None:
    from mhm2_proxy_tpu_torch.main import run_pipeline
    from mhm2_proxy_tpu_torch.models.post_asm import post_asm_align

    cfg, p = ctx.config, ctx.workload["params"]
    parts = ctx.state["setup_parts"] = {}
    t0 = time.perf_counter()
    com = ctx.state["community"] = make_community(cfg, ctx.seed)
    t1 = time.perf_counter()
    fq = os.path.join(ctx.tmp, "reads.fastq")
    write_fastq(com, fq, cfg["qual_offset"])
    t2 = time.perf_counter()
    asm_dir = ctx.state["asm_dir"] = os.path.join(ctx.tmp, "asm")
    asm = ctx.state["asm"] = run_pipeline(ladder._options(ctx, fq, asm_dir))
    os.remove(fq)
    t3 = time.perf_counter()
    warm = os.path.join(ctx.tmp, "warmup")
    os.makedirs(warm)
    post_asm_align(asm, sample_reads=int(p["warmup_reads"]),
                   sam_fname=os.path.join(warm, "w.sam"),
                   abundance_fname=os.path.join(warm, "w.tsv"))
    parts.update(community=t1 - t0, fastq=t2 - t1, assembly=t3 - t2,
                 warmup=time.perf_counter() - t3)


def span_targets():
    from mhm2_proxy_tpu_torch.models import post_asm

    return [
        (post_asm, "build_contig_index", "index"),
        (post_asm, "align_reads_to_contigs", "align"),
        (post_asm, "sw_align", "ssw"),
        (post_asm, "sw_cigar_batch", "cigars"),
        (post_asm, "sam_block", "sam_block"),
    ]


def job(ctx, i: int) -> dict:
    from mhm2_proxy_tpu_torch.models.post_asm import post_asm_align

    out = os.path.join(ctx.tmp, f"job{i}")
    os.makedirs(out)
    tm: dict = {}
    post_asm_align(ctx.state["asm"], sam_fname=os.path.join(out, "final_assembly.sam"),
                   abundance_fname=os.path.join(out, "final_assembly_depths.tsv"), timings=tm)
    return dict(out_dir=out, timings=tm)


def end_to_end(ctx, jobs, wall_s: float) -> dict:
    return {"post_asm_s": wall_s / len(jobs)}


# -- the check -------------------------------------------------------------


def _reads(asm, k: int):
    """The program's aligned reads as the alignment pass sees them: codes,
    lengths (0 below k) and SAM names, and the pass's block width."""
    codes, lens, ids = [], [], []
    for c, _q, ln, i in asm.packed_reads.blocks(1 << 17, min_len=k, with_ids=True):
        live = ln > 0
        codes.append(c[live])
        lens.append(ln[live])
        ids.append(i[live])
    L = codes[0].shape[1]
    ids = np.concatenate(ids)
    names = [f"r{abs(r)}/{2 if r > 0 else 1}" for r in ids.tolist()]
    return np.concatenate(codes), np.concatenate(lens), names, L


def sample_rows(n: int, lens: np.ndarray, seed: int, size: int, longest: int) -> np.ndarray:
    rng = np.random.default_rng([int(seed) & ((1 << 64) - 1), 0x73616D])
    pick = rng.choice(n, min(size, n), replace=False)
    top = np.argsort(-lens, kind="stable")[:longest]
    return np.unique(np.concatenate([pick, top]))


def _read_sam(path: str):
    """{read name: fields}, records of mapped reads, and names seen twice."""
    recs, dup = {}, 0
    with open(path) as f:
        for line in f:
            if line.startswith("@"):
                continue
            fields = line.rstrip("\n").split("\t")
            dup += fields[0] in recs
            recs[fields[0]] = fields
    return recs, dup


def _depth_rows_wrong(path: str, recs: dict, cnames: list[str], contigs: list[str]) -> int:
    span_of: dict[str, int] = {}
    bases = dict.fromkeys(cnames, 0)
    for fields in recs.values():
        if fields[1] == "4":
            continue
        cig = fields[5]
        s = span_of.get(cig)
        if s is None:
            s = span_of[cig] = align.cigar_ref_span(cig)
        bases[fields[2]] = bases.get(fields[2], 0) + s
    want = ["contigName\tcontigLen\ttotalAvgDepth"] + [
        f"{n}\t{len(c)}\t{bases[n] / max(len(c), 1):.4f}" for n, c in zip(cnames, contigs)]
    with open(path) as f:
        got = f.read().splitlines()
    return sum(a != b for a, b in zip(got, want)) + abs(len(got) - len(want))


def _digest(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 24), b""):
            h.update(chunk)
    return h.hexdigest()


def _judge(sam, tsv, names, rows, lens, an, best, claimed, contigs, cnames):
    """(sampled records wrong, reads without exactly one record, depth rows
    wrong) of one pass's SAM and depth table."""
    acgt = np.frombuffer(b"ACGTN", np.uint8)
    recs, dup = _read_sam(sam)
    miss = dup + abs(len(recs) - len(names)) + sum(n not in recs for n in names)
    bad = 0
    for t_i, r in enumerate(rows.tolist()):
        fields = recs.get(names[r])
        if fields is None:
            continue
        if an["cid"][t_i] < 0:
            bad += fields[1] != "4"
            continue
        if claimed is not None:
            fields = fields[:-1] + [f"AS:i:{int(claimed[t_i])}"]
        n = int(lens[r])
        seq = acgt[an["oriented"][t_i, :n]].tobytes().decode()
        c = int(an["cid"][t_i])
        why = align.judge_record(fields, seq, contigs[c], cnames[c], bool(an["rev"][t_i]),
                                 int(an["lo"][t_i]), int(an["r_len"][t_i]), int(best[t_i]))
        bad += why is not None
    return bad, miss, _depth_rows_wrong(tsv, recs, cnames, contigs)


def check(ctx, jobs, score_bits=None):
    """({name: (value, limit)}, jobs with any difference). score_bits=8 is
    the control: the reference's best scores saturated at 127 in place of
    the program's AS. The set-up's assembly is checked first: the contigs
    and reads that the passes align are the program's, and the reference
    anchors to them only once they equal its own."""
    asm, p, dev = ctx.state["asm"], ctx.workload["params"], ctx.device
    setup_checks, setup_bad = ladder.check(
        ctx, [dict(out_dir=ctx.state["asm_dir"], packed_reads=asm.packed_reads)])
    t0 = time.perf_counter()
    contigs = [c.seq for c in asm.contigs]
    cnames = [f"Contig{c.id}" for c in asm.contigs]
    codes, lens, names, L = _reads(asm, align.K)
    rows = sample_rows(len(names), lens, ctx.seed, int(p["check_reads"]),
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
    print(f"reference: {len(rows)} sampled reads anchored and scored in "
          f"{time.perf_counter() - t0:.2f}s", file=sys.stderr, flush=True)
    wrong = missing = depth_bad = failed = 0
    verdicts: dict[str, tuple[int, int, int]] = {}
    for jb in jobs:
        sam = os.path.join(jb["out_dir"], "final_assembly.sam")
        tsv = os.path.join(jb["out_dir"], "final_assembly_depths.tsv")
        # byte-identical outputs have the verdict of the first of them
        key = _digest(sam) + _digest(tsv)
        if key not in verdicts:
            verdicts[key] = _judge(sam, tsv, names, rows, lens, an, best, claimed, contigs,
                                   cnames)
        bad, miss, d = verdicts[key]
        wrong, missing, depth_bad = wrong + bad, missing + miss, depth_bad + d
        # a pass over a wrong assembly is wrong whatever its own records say
        failed += bool(bad or miss or d or setup_bad)
    checks = {f"setup_{n}": v for n, v in setup_checks.items()}
    checks |= {
        "sam_records_wrong": (wrong, 0),
        "sam_reads_missing": (missing, 0),
        "depth_rows_wrong": (depth_bad, 0),
    }
    return checks, failed
