"""Traffic kind `ladder`: a closed loop of whole assemblies.

Each job is what `python -m mhm2_proxy_tpu_torch -r <fastq> -o <dir>` runs:
`main.run_pipeline` with the CLI's own options, from the interleaved FASTQ
to `final_assembly.fasta`, over the configuration's k ladder. Set-up makes
the community from the seed, writes its FASTQ, and assembles a slice of the
same reads once, so that every round and block shape has run.

The check, once the window has closed: the plain reference merges every
pair and assembles the ladder from its own merged reads; every job's merged
reads, each round's `contigs-<k>.fasta` and the `final_assembly.fasta` are
compared with it record by record.
"""

from __future__ import annotations

import collections
import os
import sys
import time

import numpy as np
import torch

from ..gen.community import make_community, write_fastq
from ..reference.assemble import assemble
from ..reference.merge import merge_pairs


def _options(ctx, fastq: str, out_dir: str):
    from mhm2_proxy_tpu_torch.options import parse_args

    cfg = ctx.config
    return parse_args([
        "-r", fastq, "-o", out_dir, "-k", *map(str, cfg["kmer_lens"]),
        "--min-depth-thres", str(cfg["min_depth_thres"]),
        "--min-ctg-print-len", str(cfg["min_ctg_print_len"]),
        "-Q", str(cfg["qual_offset"]), "--device", ctx.device.type,
    ])


def setup(ctx) -> None:
    from mhm2_proxy_tpu_torch.main import run_pipeline

    cfg = ctx.config
    parts = ctx.state["setup_parts"] = {}
    t0 = time.perf_counter()
    com = ctx.state["community"] = make_community(cfg, ctx.seed)
    t1 = time.perf_counter()
    fq = ctx.state["fastq"] = os.path.join(ctx.tmp, "reads.fastq")
    write_fastq(com, fq, cfg["qual_offset"])
    n = min(com.n_pairs, int(ctx.workload["params"]["warmup_pairs"]))
    warm = os.path.join(ctx.tmp, "warmup.fastq")
    write_fastq(com, warm, cfg["qual_offset"], rows=np.arange(n))
    t2 = time.perf_counter()
    run_pipeline(_options(ctx, warm, os.path.join(ctx.tmp, "warmup")))
    os.remove(warm)
    parts.update(community=t1 - t0, fastq=t2 - t1, warmup=time.perf_counter() - t2)


def span_targets():
    """(owner, attribute, span name) of the layers a traced job is cut into."""
    from mhm2_proxy_tpu_torch.kcount import kmer_store
    from mhm2_proxy_tpu_torch.models import assembler

    return [
        (assembler.Assembler, "load_reads", "ingest"),
        (assembler.Assembler, "run_round", "round"),
        (kmer_store.KmerCountStore, "add_reads_block", "count.reads"),
        (assembler.Assembler, "_add_ctg_kmers", "count.contigs"),
        (kmer_store.KmerCountStore, "finalize", "count.finalize"),
        (assembler, "traverse_debruijn_graph", "traverse"),
        (assembler, "write_fasta", "write_fasta"),
    ]


def job(ctx, i: int) -> dict:
    from mhm2_proxy_tpu_torch.main import run_pipeline

    out = os.path.join(ctx.tmp, f"job{i}")
    asm = run_pipeline(_options(ctx, ctx.state["fastq"], out))
    with open(os.path.join(out, "mhm2_torch.log")) as f:
        log = f.read().splitlines()
    return dict(out_dir=out, log=log, round_stats=dict(asm.round_stats),
                packed_reads=asm.packed_reads)


def end_to_end(ctx, jobs, wall_s: float) -> dict:
    return {"assembly_s": wall_s / len(jobs)}


# -- the check -------------------------------------------------------------


def _program_pairs(packed, n_pairs: int, L: int, qual_offset: int):
    """The program's reads per pair: (merged (P,), merged codes and raw
    quals (P, 2L), merged length, and each mate's codes, quals, length)."""
    P = n_pairs
    m_codes = np.full((P, 2 * L), 4, np.uint8)
    m_quals = np.zeros((P, 2 * L), np.uint8)
    m_len = np.zeros(P, np.int32)
    mates = [(np.full((P, L), 4, np.uint8), np.zeros((P, L), np.uint8), np.zeros(P, np.int32))
             for _ in range(2)]
    seen = np.zeros((P, 2), np.int32)
    for codes, quals, lens, ids in packed.blocks(1 << 17, with_ids=True):
        live = (lens > 0) & (ids != 0)
        codes, quals, lens, ids = codes[live], quals[live], lens[live], ids[live]
        pair = (np.abs(ids) - 1) // 2
        mate = (ids > 0).astype(np.int64)
        np.add.at(seen, (pair, mate), 1)
        W = min(codes.shape[1], 2 * L)
        for m in (0, 1):
            r = mate == m
            c, q, ln = mates[m]
            w = min(W, L)
            c[pair[r], :w] = codes[r, :w]
            q[pair[r], :w] = quals[r, :w] - np.where(codes[r, :w] < 4, qual_offset, 0)
            ln[pair[r]] = lens[r]
        r = mate == 0
        m_codes[pair[r], :W] = codes[r, :W]
        m_quals[pair[r], :W] = quals[r, :W] - qual_offset
        m_len[pair[r]] = lens[r]
    merged = (seen[:, 0] == 1) & (seen[:, 1] == 0)
    return merged, m_codes, m_quals, m_len, mates, seen


def _merge_diff(prog, ref, com) -> int:
    """Pairs whose merge differs from the reference's: the outcome, or the
    merged read's bases, qualities or length, or a mate kept unmerged."""
    merged, m_codes, m_quals, m_len, mates, seen = prog
    r_merged, r_codes, r_quals, r_len = ref
    bad = merged != r_merged
    bad |= ~merged & ~((seen[:, 0] == 1) & (seen[:, 1] == 1))
    L = com.codes1.shape[1]
    j = np.arange(2 * L)
    inside = j[None, :] < r_len[:, None]
    both = merged & r_merged
    bad |= both & (m_len != r_len)
    bad |= both & ((m_codes != r_codes) & inside).any(1)
    bad |= both & ((m_quals != r_quals) & inside).any(1)
    un = ~merged & ~r_merged
    for m, (c, q) in enumerate(((com.codes1, com.quals1), (com.codes2, com.quals2))):
        pc, pq, pl = mates[m]
        bad |= un & ((pl != L) | (pc != c).any(1) | (pq != q).any(1))
    return int(bad.sum())


def fasta_records(path: str) -> list[str]:
    with open(path) as f:
        text = f.read()
    return [">" + r for r in text.split(">")[1:]]


def expected_records(contigs, min_len: int = 0) -> list[str]:
    return [f">Contig{i} {d}\n{s}\n" for i, (s, d) in enumerate(contigs) if len(s) >= min_len]


def records_diff(got: list[str], want: list[str]) -> int:
    """Records in one list and not the other (as multisets), counted on
    both sides."""
    a, b = collections.Counter(got), collections.Counter(want)
    return sum(((a - b) + (b - a)).values())


def reference_reads(ctx, device):
    """The reference's merge of every pair, and its reads laid end to end
    for counting: merged reads, then both mates of the unmerged pairs."""
    com = ctx.state["community"]
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)  # noqa: E731
    L = com.codes1.shape[1]
    lens = torch.full((com.n_pairs,), L, dtype=torch.int32, device=device)
    merged, mc, mq, ml = merge_pairs(t(com.codes1), t(com.quals1), lens,
                                     t(com.codes2), t(com.quals2), lens)
    um = ~merged
    pieces = [(mc[merged], mq[merged], ml[merged]),
              (t(com.codes1)[um], t(com.quals1)[um], lens[um]),
              (t(com.codes2)[um], t(com.quals2)[um], lens[um])]
    flat, ok, all_lens = [], [], []
    for c, q, ln in pieces:
        inside = torch.arange(c.shape[1], device=device)[None, :] < ln[:, None].to(torch.int64)
        flat.append(c[inside])
        ok.append(q[inside] >= 20)
        all_lens.append(ln.to(torch.int64))
    lens_all = torch.cat(all_lens)
    starts = torch.cumsum(lens_all, 0) - lens_all
    reads = (torch.cat(flat), torch.cat(ok), starts, lens_all)
    ref_merge = tuple(x.cpu().numpy() for x in (merged, mc, mq, ml))
    return ref_merge, reads


def check(ctx, jobs, depth_dtype=None):
    """({name: (value, limit)} of every compared number, the jobs with any
    difference). depth_dtype "float32" is the control: the reference's
    depths divided in float32."""
    com, cfg = ctx.state["community"], ctx.config
    t0 = time.perf_counter()
    ref_merge, reads = reference_reads(ctx, ctx.device)
    log = lambda m: print(m, file=sys.stderr, flush=True)  # noqa: E731
    log(f"reference merge: {int(ref_merge[0].sum())} of {com.n_pairs} pairs merged in "
        f"{time.perf_counter() - t0:.2f}s")
    rounds = assemble(reads, cfg["kmer_lens"], cfg["min_depth_thres"], depth_dtype=depth_dtype,
                      log=log)
    del reads
    kmax = cfg["kmer_lens"][-1]
    want = {k: expected_records(rounds[k]) for k in cfg["kmer_lens"]}
    want_final = expected_records(rounds[kmax], cfg["min_ctg_print_len"])
    merge_bad = contig_bad = final_bad = failed = 0
    for jb in jobs:
        prog = _program_pairs(jb["packed_reads"], com.n_pairs, com.codes1.shape[1],
                              cfg["qual_offset"])
        m = _merge_diff(prog, ref_merge, com)
        c = sum(records_diff(fasta_records(os.path.join(jb["out_dir"], f"contigs-{k}.fasta")),
                             want[k]) for k in cfg["kmer_lens"])
        f = records_diff(fasta_records(os.path.join(jb["out_dir"], "final_assembly.fasta")),
                         want_final)
        merge_bad, contig_bad, final_bad = merge_bad + m, contig_bad + c, final_bad + f
        failed += bool(m or c or f)
    checks = {
        "merge_pairs_differing": (merge_bad, 0),
        "round_contigs_differing": (contig_bad, 0),
        "final_contigs_differing": (final_bad, 0),
    }
    return checks, failed
