"""Post-assembly read-to-contig alignment (port of
mhm2_proxy_tpu/models/post_asm.py; full-MHM2 --post-asm-align parity).

Reads are anchored to contigs by multi-seed k-mer lookup in a sorted index
of the contig k-mers, aligned with the batched Smith-Waterman kernel
(ops/ssw.py), given CIGARs by the batched traceback DP, and summed into
per-contig depths (the jgi_summarize-style table of docs/mhm_guide.md:
211-233). The index build, seed lookup, vote, window gather, alignment and
traceback run as tensors on the assembler's device; the SAM text and the
depth sums are rendered on the host, with the reference's exact bytes.
Ranks that hold their own reads (Assembler.read_split) align them on their
own devices; rank 0 writes the SAM records in rank order and the depths
summed over the ranks.

The reference builds the index with a Python loop per contig; here it is
one batch over the concatenated contig codes, with every window that
crosses a contig boundary dropped, then one stable lexsort (a k-mer that
occurs several times keeps its (contig, offset) order, so a lookup returns
the reference's first row).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops import bitkmer as bk
from ..ops.lookup import table_lookup
from ..ops.ssw import sw_align, sw_cigar_batch
from ..ops.u32 import lexsort_perm
from ..parallel import comm
from ..utils import trace

_ACGT = np.frombuffer(b"ACGTN", np.uint8)
_SEED_FRACS = (0.5, 0.25, 0.75, 0.0, 1.0)  # by centrality: ties go to the middle


def default_block_reads(device) -> int:
    """Reads per alignment block: 2048 on the CPU (the reference's), 65536 on
    CUDA, where the traceback codes (B x (Nr+1) x (Nq+1) bytes, the
    `tb_bytes` counter) take 5.47-5.49 GB a block of merged 2x150 bp reads
    (up to 290 bp; 5,473,632,256 to 5,492,572,160 bytes on an H100 at the
    cami_low12 community), under 2.4 GB at 100-190 bp. The outputs are per
    read: no block size changes them."""
    return 65536 if torch.device(device).type == "cuda" else 2048


def build_contig_index(contigs: list[str], k: int = 31, device="cuda"):
    """Sorted (canonical k-mer -> contig id, offset, orientation) rows over
    every contig k-mer, plus the concatenated contig codes and their
    starts and lengths for the window gather. Tensors on `device`; None
    when no contig has k bases."""
    dev = torch.device(device)
    clen_h = np.array([len(s) for s in contigs], np.int64)
    cstart_h = np.zeros(len(contigs) + 1, np.int64)
    np.cumsum(clen_h, out=cstart_h[1:])
    if not (clen_h >= k).any():
        return None
    concat = torch.from_numpy(bk.ascii_to_codes("".join(contigs).encode())).to(dev)
    clen = torch.from_numpy(clen_h).to(dev)
    cstart = torch.from_numpy(cstart_h).to(dev)
    words = bk.kmer_words_from_codes(concat[None, :], k)[0]  # (N - k + 1, W)
    P = words.shape[0]
    cid = torch.repeat_interleave(torch.arange(len(contigs), device=dev), clen)[:P]
    off = torch.arange(P, device=dev) - cstart[cid]
    keep = off + k <= clen[cid]
    cw, was_rc = bk.canonicalize_words(words[keep], k)
    cid = cid[keep].to(torch.int32)
    off = off[keep].to(torch.int32)
    order = lexsort_perm(tuple(cw[:, w] for w in range(cw.shape[1])))
    del words, keep
    return dict(words=cw[order].contiguous(), cid=cid[order], off=off[order],
                rc=was_rc[order], k=k, concat=concat, cstart=cstart, clen=clen)


def _first_argmax(x: torch.Tensor) -> torch.Tensor:
    """Index of the first maximum along dim 1 (np.argmax's tie rule)."""
    n = x.shape[1]
    iota = torch.arange(n, device=x.device)[None, :]
    return torch.where(x == x.max(dim=1, keepdim=True).values, iota, n).min(dim=1).values


def align_reads_to_contigs(
    codes: np.ndarray, lens: np.ndarray, contigs: list[str],
    index=None, k: int = 31,
    match=1, mismatch=1, gap_open=1, gap_extend=1,
    cigars: bool = False, n_seeds: int = 5, timings: dict | None = None, device="cuda",
):
    """Anchor and align a block of reads against contigs (the reference's
    multi-seed vote: n_seeds k-mer positions per read looked up in one
    batch, voting on (contig, orientation, diagonal +- 16); the winning seed
    anchors a window of L + 64 contig bases).

    Returns numpy arrays per read: cid (-1 unanchored), score, identity,
    begin/end spans, rev, win_lo (contig position = win_lo + r_begin), the
    oriented codes, and with cigars=True the CIGARs and NM counts. The
    index's device runs the work; an index built here is built on
    `device`.
    The seeding, vote, windows and both alignment passes, to the results'
    copy to the host, are the span `post_asm.align`, with the counters
    `reads` (rows of length >= k) and `anchored`; the CIGAR path is
    sw_cigar_batch's spans. timings, when given, accumulates the align
    span's seconds ("align_s") and those of the CIGAR path
    (sw_cigar_batch's "tb_dp_s", "tb_walk_s", "cigar_render_s")."""
    if index is None:
        index = build_contig_index(contigs, k, device=device)
    if index is None:
        B = codes.shape[0]
        return dict(cid=np.full(B, -1, np.int32), score=np.zeros(B, np.int32),
                    identity=np.zeros(B, np.float32))
    with trace.span("post_asm.align") as sp:
        dev = index["words"].device
        B, L = codes.shape
        kk = index["k"]
        codes_t = torch.from_numpy(np.ascontiguousarray(codes)).to(dev)
        lens_t = torch.from_numpy(np.asarray(lens, np.int64)).to(dev)
        words = bk.kmer_words_from_codes(codes_t, kk)
        P = words.shape[1]
        span = torch.clamp(lens_t - kk, min=0)
        fracs = torch.tensor(_SEED_FRACS[:n_seeds], dtype=torch.float64, device=dev)
        NS = fracs.shape[0]
        posS = torch.clamp((span[:, None].to(torch.float64) * fracs[None, :]).to(torch.int64),
                           0, P - 1)
        rb = torch.arange(B, device=dev)
        anchors = words[rb[:, None], posS]  # (B, NS, W)
        del words
        cwS, q_rcS = bk.canonicalize_words(anchors.reshape(B * NS, -1), kk)
        q_rcS = q_rcS.reshape(B, NS)
        idxS, foundS = table_lookup(index["words"], index["words"].shape[0], cwS)
        idxS = idxS.reshape(B, NS).to(torch.int64)
        foundS = foundS.reshape(B, NS)
        cidS = torch.where(foundS & (lens_t >= kk)[:, None], index["cid"][idxS].to(torch.int64),
                           -1)
        rel_rcS = (q_rcS ^ index["rc"][idxS]) & (cidS >= 0)
        # oriented read position of each anchor and the implied contig diagonal
        midS = torch.where(rel_rcS, span[:, None] - posS, posS)
        diagS = index["off"][idxS].to(torch.int64) - midS
        same = (
            (cidS[:, :, None] == cidS[:, None, :])
            & (rel_rcS[:, :, None] == rel_rcS[:, None, :])
            & ((diagS[:, :, None] - diagS[:, None, :]).abs() <= 16)
            & (cidS >= 0)[:, None, :]
        )
        votes = torch.where(cidS >= 0, same.sum(dim=-1), -1)
        s_star = _first_argmax(votes)
        cid = cidS[rb, s_star]
        idx = idxS[rb, s_star]
        rel_rc = rel_rcS[rb, s_star]
        mid = midS[rb, s_star]
        # reverse-complement the reads that anchor in reverse orientation
        j = torch.arange(L, device=dev)[None, :]
        codes_rc = torch.gather(codes_t, 1, torch.clamp(lens_t[:, None] - 1 - j, 0, L - 1))
        codes_rc = torch.where(codes_rc < 4, 3 - codes_rc, codes_rc)
        codes_rc = torch.where(j < lens_t[:, None], codes_rc, 4).to(torch.uint8)
        codes_t = torch.where(rel_rc[:, None], codes_rc, codes_t).contiguous()
        # the contig window around the anchor: one gather over the concatenation
        Lr = L + 64
        hit = cid >= 0
        cid0 = torch.clamp(cid, min=0)
        c_len = torch.where(hit, index["clen"][cid0], 0)
        lo = torch.where(hit, torch.clamp(index["off"][idx].to(torch.int64) - mid - 32, min=0), 0)
        gidx = (index["cstart"][cid0] + lo)[:, None] + torch.arange(Lr, device=dev)[None, :]
        concat = index["concat"]
        in_contig = (torch.arange(Lr, device=dev)[None, :] < (c_len - lo)[:, None]) & hit[:, None]
        refs = torch.where(in_contig, concat[torch.clamp(gidx, 0, concat.shape[0] - 1)],
                           255).to(torch.uint8)
        r_len = torch.where(hit, torch.clamp(c_len - lo, max=Lr), 0).to(torch.int32)
        q_len = lens_t.to(torch.int32)
        aln = sw_align(codes_t, q_len, refs, r_len, match=match, mismatch=mismatch,
                       gap_open=gap_open, gap_extend=gap_extend)
        aln_h = {n: v.cpu().numpy() for n, v in aln.items()}
        cid_h = cid.to(torch.int32).cpu().numpy()
        score = aln_h["score"]
        # identity proxy: score / (match * aligned query length)
        qspan = np.maximum(aln_h["q_end"] - aln_h["q_begin"] + 1, 1)
        identity = np.where(cid_h >= 0, score / (match * qspan), 0.0)
        out = dict(cid=cid_h, score=score, identity=identity.astype(np.float32),
                   q_begin=aln_h["q_begin"], q_end=aln_h["q_end"],
                   r_begin=aln_h["r_begin"], r_end=aln_h["r_end"],
                   rev=rel_rc.cpu().numpy(), win_lo=lo.cpu().numpy(),
                   codes=codes_t.cpu().numpy())
        trace.count("reads", int(np.count_nonzero(np.asarray(lens) >= kk)))
        trace.count("anchored", int(np.count_nonzero(cid_h >= 0)))
    if timings is not None:
        timings["align_s"] = timings.get("align_s", 0.0) + sp.seconds
    if cigars:
        aln_c = dict(aln, q_begin=torch.where(hit, aln["q_begin"], -1),
                     q_end=torch.where(hit, aln["q_end"], -1))
        out["cigar"], out["nm"] = sw_cigar_batch(
            codes_t, q_len, refs, r_len, aln_c, match=match, mismatch=mismatch,
            gap_open=gap_open, gap_extend=gap_extend, timings=timings,
        )
    return out


def sam_record(name: str, out: dict, i: int, lens: np.ndarray,
               cnames: list[str] | None = None) -> str:
    """One SAM line (v1.6 mandatory fields + NM and AS tags) for read i of
    a block, the reference's sam_record (post_asm.py:177): CIGAR "*" and NM
    0 where `out` has none, and Contig<index> names where cnames is None."""
    n = int(lens[i])
    if out["cid"][i] < 0 or n == 0:
        return f"{name}\t4\t*\t0\t0\t*\t*\t0\t0\t*\t*"
    seq = _ACGT[np.minimum(out["codes"][i, :n], 4)].tobytes().decode()
    flag = 16 if out["rev"][i] else 0
    pos = int(out["win_lo"][i] + out["r_begin"][i]) + 1  # SAM is 1-based
    cig = out["cigar"][i] if out.get("cigar") else "*"
    nm = int(out["nm"][i]) if "nm" in out else 0
    ci = int(out["cid"][i])
    rname = cnames[ci] if cnames is not None else f"Contig{ci}"
    return (
        f"{name}\t{flag}\t{rname}\t{pos}\t60\t{cig}"
        f"\t*\t0\t0\t{seq}\t*\tNM:i:{nm}\tAS:i:{int(out['score'][i])}"
    )


def sam_block(names: list[str], out: dict, rows: np.ndarray, lens: np.ndarray,
              cnames: list[str]) -> str:
    """The SAM lines (v1.6 mandatory fields + NM and AS tags) of a block's
    rows: the reference's sam_record (post_asm.py:177) for each row,
    with the per-read numpy work done once per block. cnames maps the
    aligner's dense contig index to the contig's name in the FASTA
    (Contig<id>): a --post-asm-only run reloads only the printed contigs,
    so the index is not the id there."""
    n_l = lens[rows].tolist()
    cid = out["cid"][rows].tolist()
    if not rows.size:
        return ""
    L = out["codes"].shape[1]
    seqs = _ACGT[np.minimum(out["codes"][rows], 4)].tobytes().decode()
    flag = np.where(out["rev"][rows], 16, 0).tolist()
    pos = (out["win_lo"][rows] + out["r_begin"][rows] + 1).tolist()
    nm = out["nm"][rows].tolist()
    score = out["score"][rows].tolist()
    cig = out["cigar"]
    lines = []
    for t, i in enumerate(rows.tolist()):
        n = n_l[t]
        if cid[t] < 0 or n == 0:
            lines.append(f"{names[t]}\t4\t*\t0\t0\t*\t*\t0\t0\t*\t*\n")
            continue
        lines.append(
            f"{names[t]}\t{flag[t]}\t{cnames[cid[t]]}\t{pos[t]}\t60\t{cig[i]}"
            f"\t*\t0\t0\t{seqs[t * L : t * L + n]}\t*\tNM:i:{nm[t]}\tAS:i:{score[t]}\n"
        )
    return "".join(lines)


def post_asm_align(
    asm, sample_reads: int | None = None, k: int = 31, block_reads: int | None = None,
    sam_fname: str | None = None, abundance_fname: str | None = None,
    timings: dict | None = None,
):
    """Align the packed reads back to the final contigs; optional SAM and
    depths files (the reference's post_asm_align, post_asm.py:200-272).

    sample_reads=None aligns every read. block_reads None takes
    default_block_reads(asm.device). Returns the reference's summary stats.

    Spans: `post_asm.index` (the contig index), per block
    `post_asm.reads` (the block's rows), `post_asm.align` and the CIGAR
    path's `post_asm.tb_dp`, `post_asm.tb_walk` and `post_asm.cigar_render`
    (align_reads_to_contigs), and `post_asm.sam` (the block's sums, SAM
    lines and their write, counting `sam_bytes`; also the header, and at
    the end the depth table). timings, when given, receives their seconds:
    "index_s", "align_s", "tb_dp_s", "tb_walk_s", "cigar_render_s" and
    "host_s" (the `post_asm.sam` spans), and "reads_aligned"."""
    contigs = [c.seq for c in asm.contigs]
    cnames = [f"Contig{c.id}" for c in asm.contigs]
    if not contigs:
        return dict(aligned_frac=0.0, mean_identity=0.0)
    dev = asm.device
    block_reads = block_reads or default_block_reads(dev)
    tm = timings if timings is not None else {}
    with trace.span("post_asm.index") as sp:
        index = build_contig_index(contigs, k, device=dev)
    tm["index_s"] = sp.seconds
    tot = 0
    anchored = 0
    ident_sum = 0.0
    aligned_bases = np.zeros(len(contigs), np.int64)
    # ranks that hold their own reads write their SAM records to a part file
    ranks = comm.world() if getattr(asm, "own_reads", False) else 1
    rank = comm.rank() if ranks > 1 else 0
    part = f"{sam_fname}.rank{rank}" if sam_fname and rank else sam_fname
    with trace.span("post_asm.sam") as sp:
        sam = open(part, "w") if part else None
        if sam and not rank:
            head = "".join(["@HD\tVN:1.6\tSO:unknown\n"]
                           + [f"@SQ\tSN:{cname}\tLN:{len(c)}\n"
                              for cname, c in zip(cnames, contigs)]
                           + ["@PG\tID:mhm2_proxy_tpu_torch\tPN:mhm2_proxy_tpu_torch\n"])
            sam.write(head)
            trace.count("sam_bytes", len(head))
    tm["host_s"] = sp.seconds
    rid = 0
    blocks = asm.packed_reads.blocks(block_reads, min_len=k, with_ids=True)
    for codes, _quals, lens, ids in trace.iterate("post_asm.reads", blocks):
        out = align_reads_to_contigs(codes, lens, contigs, index=index, k=k,
                                     cigars=sam is not None, timings=tm)
        with trace.span("post_asm.sam") as sp:
            mask = lens > 0
            tot += int(mask.sum())
            hit = (out["cid"] >= 0) & mask
            anchored += int(hit.sum())
            ident_sum += float(out["identity"][hit].sum())
            span = np.where(hit, out["r_end"] - out["r_begin"] + 1, 0)
            np.add.at(aligned_bases, np.clip(out["cid"], 0, None), span)
            if sam:
                rows = np.nonzero(mask)[0]
                # the real read identity (packed_reads.cpp:74-75 convention);
                # anonymous rows keep a positional name
                rids = ids[rows].tolist()
                names = [f"r{abs(r)}/{2 if r > 0 else 1}" if r else f"read_{rid + i}"
                         for r, i in zip(rids, rows.tolist())]
                text = sam_block(names, out, rows, lens, cnames)
                sam.write(text)
                trace.count("sam_bytes", len(text))
            rid += int(codes.shape[0])
        tm["host_s"] += sp.seconds
        if sample_reads is not None and tot >= sample_reads:
            break
    with trace.span("post_asm.sam") as sp:
        if sam:
            sam.close()
        if ranks > 1:
            tot, anchored = comm.all_sum(tot, anchored)
            ident_sum = float(comm.all_sum_tensor(torch.tensor([ident_sum],
                                                               dtype=torch.float64)))
            aligned_bases = comm.all_sum_tensor(torch.from_numpy(aligned_bases)).numpy()
            if sam_fname:
                _gather_parts(sam_fname, rank, ranks)
        stats = dict(
            aligned_frac=anchored / max(tot, 1),
            mean_identity=ident_sum / max(anchored, 1),
            sampled_reads=tot,
        )
        if abundance_fname and not rank:
            with open(abundance_fname, "w") as f:
                f.write("contigName\tcontigLen\ttotalAvgDepth\n")
                for cidx, (cname, c) in enumerate(zip(cnames, contigs)):
                    depth = aligned_bases[cidx] / max(len(c), 1)
                    f.write(f"{cname}\t{len(c)}\t{depth:.4f}\n")
            stats["abundance_file"] = abundance_fname
    tm["host_s"] += sp.seconds
    tm["reads_aligned"] = anchored
    asm.log.info(f"post-asm-align: {stats}")
    return stats


def _gather_parts(sam_fname: str, rank: int, ranks: int):
    """Rank 0 appends the other ranks' part files to sam_fname, in rank
    order, and removes them."""
    comm.barrier()
    if not rank:
        with open(sam_fname, "ab") as out:
            for r in range(1, ranks):
                with open(f"{sam_fname}.rank{r}", "rb") as f:
                    while chunk := f.read(1 << 24):
                        out.write(chunk)
                os.remove(f"{sam_fname}.rank{r}")
    comm.barrier()


def post_asm_align_stats(asm, sample_reads: int = 2048, k: int = 31):
    """Align a sample of the packed reads back to the final contigs."""
    return post_asm_align(asm, sample_reads=sample_reads, k=k, block_reads=512)
