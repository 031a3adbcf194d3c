"""Plain-torch checks of post-assembly alignment: where each read anchors,
the best local alignment score there, and what a SAM record claims.

The anchoring rule of MHM2's post-assembly alignment, as the repository's
reference package states it (post_asm.py:200-272): every canonical 31-mer
of the contigs in one stable key order, so that a k-mer found more than
once answers with its first (contig, offset). A read of length n in a block
padded to width L takes seeds at positions int((n - 31) * f), f = 0.5,
0.25, 0.75, 0, 1 (clamped to the block's last position); each found seed
votes for the seeds with its contig, its orientation and a diagonal within
16; the first seed with the most votes anchors the read, reverse-
complemented when the seed and the contig k-mer differ in orientation, to a
window of L + 64 contig bases from 32 before the seed's diagonal.

The score is the best local alignment (Smith-Waterman with affine gaps: a
match +1, a mismatch or an N -1, a gap of g bases open + (g - 1) extend) of
the oriented read against the window. A record is judged by what it says:
its contig, strand and sequence are the anchor's, its CIGAR walks the read
over the contig from POS inside the window with `=` on equal bases and `X`
on others, its score is AS and the best score, and NM counts its X, I and
D bases. This module imports nothing of the program.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from .assemble import _pack_windows, _seq_tensors, canonical, lex_order, lookup, pack_rows

K = 31
SEED_FRACS = (0.5, 0.25, 0.75, 0.0, 1.0)
NEG = -(1 << 20)
_OPS = re.compile(r"(\d+)([SIDX=M])")


def contig_index(contigs: list[str], device, k: int = K) -> dict:
    """Canonical k-mers of every window inside a contig, in stable key
    order, with their contig, offset and orientation."""
    flat, starts, lens = _seq_tensors(contigs, device)
    P = flat.shape[0] - k + 1
    cid = torch.repeat_interleave(torch.arange(len(contigs), device=device), lens,
                                  output_size=flat.shape[0])[:P]
    off = torch.arange(P, device=device) - starts[cid]
    keep = off + k <= lens[cid]
    key, rc = canonical(_pack_windows(flat, k, P, False)[keep],
                        _pack_windows(flat, k, P, True)[keep])
    order = lex_order(key)
    key = key[order]
    new = torch.ones(key.shape[0], dtype=torch.bool, device=device)
    new[1:] = (key[1:] != key[:-1]).any(1)
    idx = torch.arange(key.shape[0], device=device)
    run_start = torch.cummax(torch.where(new, idx, 0), 0).values
    return dict(key=key, cid=cid[keep][order], off=off[keep][order], rc=rc[order],
                run_start=run_start, flat=flat, starts=starts, lens=lens)


def anchor(index: dict, codes: torch.Tensor, lens: torch.Tensor, L: int, k: int = K) -> dict:
    """Each read's anchor: contig (-1 none), reverse strand, window start
    and length, and the oriented read. codes (B, L0) uint8 ACGT = 0..3,
    N = 4; L the block width of the program's alignment pass."""
    dev = codes.device
    B = codes.shape[0]
    lens = lens.to(torch.int64)
    c = torch.full((B, L), 4, dtype=torch.uint8, device=dev)
    c[:, : codes.shape[1]] = codes[:, :L]
    P = L - k + 1
    span = torch.clamp(lens - k, min=0)
    fr = torch.tensor(SEED_FRACS, dtype=torch.float64, device=dev)
    pos = torch.clamp((span[:, None].to(torch.float64) * fr[None, :]).to(torch.int64), 0, P - 1)
    S = len(SEED_FRACS)
    flat_pos = (torch.arange(B, device=dev)[:, None] * L + pos).reshape(-1)
    rows = c.reshape(-1)
    key, q_rc = canonical(_windows_at(rows, flat_pos, k, False),
                          _windows_at(rows, flat_pos, k, True))
    last = lookup(index["key"], key)  # the last of equal keys; answer with the first
    idx = torch.where(last >= 0, index["run_start"][last.clamp(min=0)], -1).reshape(B, S)
    q_rc = q_rc.reshape(B, S)
    found = idx >= 0
    ii = idx.clamp(min=0)
    cid = torch.where(found & (lens >= k)[:, None], index["cid"][ii], -1)
    rel_rc = (q_rc ^ index["rc"][ii]) & (cid >= 0)
    mid = torch.where(rel_rc, span[:, None] - pos, pos)
    diag = index["off"][ii] - mid
    same = ((cid[:, :, None] == cid[:, None, :]) & (rel_rc[:, :, None] == rel_rc[:, None, :])
            & ((diag[:, :, None] - diag[:, None, :]).abs() <= 16) & (cid >= 0)[:, None, :])
    votes = torch.where(cid >= 0, same.sum(-1), -1)
    best = votes.max(1, keepdim=True).values
    s_star = torch.where(votes == best, torch.arange(S, device=dev), S).min(1).values
    r = torch.arange(B, device=dev)
    cid, ii, rel_rc, mid = cid[r, s_star], ii[r, s_star], rel_rc[r, s_star], mid[r, s_star]
    hit = cid >= 0
    j = torch.arange(L, device=dev)[None, :]
    src = torch.clamp(lens[:, None] - 1 - j, 0, L - 1)
    back = torch.gather(c, 1, src)
    back = torch.where(back < 4, 3 - back, back)
    back = torch.where(j < lens[:, None], back, 4).to(torch.uint8)
    oriented = torch.where(rel_rc[:, None], back, c)
    c0 = cid.clamp(min=0)
    clen = index["lens"][c0]
    lo = torch.where(hit, torch.clamp(index["off"][ii] - mid - 32, min=0), 0)
    r_len = torch.where(hit, torch.clamp(clen - lo, max=L + 64), 0)
    return dict(cid=cid, rev=rel_rc & hit, lo=lo, r_len=r_len, oriented=oriented)


def _windows_at(rows: torch.Tensor, at: torch.Tensor, k: int, reverse: bool) -> torch.Tensor:
    """Words of the k-mers starting at positions `at` of a flat code row (N
    packed as G), or of their reverse complements."""
    g = rows[(at[:, None] + torch.arange(k, device=rows.device)[None, :]).clamp(
        max=rows.shape[0] - 1)]
    g = torch.where(g == 4, 2, g)
    return pack_rows(3 - g.flip(1) if reverse else g)


def windows(index: dict, an: dict, L: int) -> torch.Tensor:
    """(B, L + 64) contig bases of each anchor's window (4 past its end)."""
    Lr = L + 64
    jr = torch.arange(Lr, device=an["lo"].device)[None, :]
    base = index["starts"][an["cid"].clamp(min=0)] + an["lo"]
    g = index["flat"][(base[:, None] + jr).clamp(max=index["flat"].shape[0] - 1)]
    return torch.where(jr < an["r_len"][:, None], g, 4).to(torch.uint8)


def best_scores(q: torch.Tensor, q_len: torch.Tensor, r: torch.Tensor, r_len: torch.Tensor,
                go: int = 1, ge: int = 1, bits: int | None = None) -> torch.Tensor:
    """Best local alignment score of each (query, window) pair, query rows
    outer, window positions in one vector with the gaps along it by a
    running maximum. bits=8 saturates every cell at 127 (the control)."""
    B, Lq = q.shape
    Lr = r.shape[1]
    dev = q.device
    jr = torch.arange(Lr, device=dev)[None, :]
    rv = jr < r_len[:, None]
    rb = r.to(torch.int64)
    H = torch.zeros((B, Lr), dtype=torch.int64, device=dev)
    E = torch.full((B, Lr), NEG, dtype=torch.int64, device=dev)
    best = torch.zeros(B, dtype=torch.int64, device=dev)
    ramp = jr * ge
    for i in range(Lq):
        qb = q[:, i].to(torch.int64)[:, None]
        valid = rv & (i < q_len)[:, None]
        s = torch.where((qb < 4) & (rb < 4) & (qb == rb), 1, -1)
        diag = torch.cat([torch.zeros((B, 1), dtype=torch.int64, device=dev), H[:, :-1]], 1)
        E = torch.maximum(H - go, E - ge)
        h0 = torch.clamp(torch.maximum(diag + s, E), min=0)
        # F[j] = max over t < j of h0[t] - go - (j - 1 - t) ge
        run = torch.cummax(h0 + ramp, 1).values
        F = torch.cat([torch.full((B, 1), NEG, dtype=torch.int64, device=dev),
                       run[:, :-1] - go - (ramp[:, 1:] - ge)], 1)
        H = torch.where(valid, torch.maximum(h0, F), 0)
        E = torch.where(valid, E, NEG)
        if bits == 8:
            H = H.clamp(max=127)
            E = E.clamp(max=127)
        best = torch.maximum(best, H.max(1).values)
    return best


def parse_cigar(cigar: str):
    ops = [(int(n), op) for n, op in _OPS.findall(cigar)]
    if "".join(f"{n}{op}" for n, op in ops) != cigar:
        return None
    return ops


def judge_record(fields: list[str], seq: str, contig: str, cname: str, rev: bool, lo: int,
                 r_len: int, best: int, go: int = 1, ge: int = 1) -> str | None:
    """None if a mapped SAM record's claims hold, else what is wrong."""
    if fields[2] != cname:
        return "contig"
    if int(fields[1]) != (16 if rev else 0):
        return "flag"
    if fields[9] != seq:
        return "sequence"
    ops = parse_cigar(fields[5])
    if not ops:
        return "cigar syntax"
    qi, rj = 0, int(fields[3]) - 1
    score = nm = 0
    if ops[0][1] == "S":
        qi = ops[0][0]
        ops = ops[1:]
    tail = ops[-1][0] if ops and ops[-1][1] == "S" else 0
    ops = ops[:-1] if tail else ops
    if rj < lo:
        return "position"
    for n, op in ops:
        if op in "=X":
            a, b = seq[qi : qi + n], contig[rj : rj + n]
            if len(a) != n or len(b) != n:
                return "past the end"
            same = [x == y and x in "ACGT" for x, y in zip(a, b)]
            if (op == "=" and not all(same)) or (op == "X" and any(same)):
                return "op against bases"
            score += n if op == "=" else -n
            nm += 0 if op == "=" else n
            qi += n
            rj += n
        elif op in "ID":
            score -= go + (n - 1) * ge
            nm += n
            qi += n if op == "I" else 0
            rj += n if op == "D" else 0
        else:
            return "op"
    if qi + tail != len(seq):
        return "query length"
    if rj > lo + r_len:
        return "outside the window"
    if fields[-1] != f"AS:i:{score}":
        return "score of the cigar"
    if score != best:
        return "not the best score"
    if fields[-2] != f"NM:i:{nm}":
        return "NM"
    return None


def cigar_ref_span(cigar: str) -> int:
    return sum(int(n) for n, op in _OPS.findall(cigar) if op in "=XDM")


def to_numpy(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
