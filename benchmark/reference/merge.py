"""Plain-torch pair merge: MHM2's merge_reads rules, every pair at once.

The rules (src/merge_reads.cpp:307-495 of MetaHipMer2), stated per pair:
read 2 is reverse-complemented; for each shift i in
[0, ln - MIN_OVERLAP + EXTRA_TEST_OVERLAP), ln = min(len1, len2), the
overlap of ln - i bases is scored position by position, stopping early on
too many N bases (the whole merge aborts) or too many mismatches (the shift
fails). A shift is *good* when it passes the strict test and *found* when it
passes only the loose one. Scanning the shifts in order, a pair merges
exactly when no shift aborts, exactly one shift is good and none is found:
any other sequence of events ends the sequential scan without a merge. So
every shift is scored for every pair independently, and only counts decide.

Qualities are raw phred values (ASCII minus the offset); an N base's
quality counts as 0. perror sums float64 terms and is rounded once to
float32 before its division by the overlap, as the reference's C code does.
This module imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

MIN_OVERLAP = 12
EXTRA_TEST_OVERLAP = 2
MAX_MISMATCHES = 3
MAX_PERROR = 0.025
EXTRA_MISMATCHES_PER_1000 = 150
N_CODE = 4

# 10^(-q/10) to four significant digits, as merge_reads.cpp:73-81 lists it
Q2PERROR = [
    1.0, 0.7943, 0.6309, 0.5012, 0.3981, 0.3162, 0.2512, 0.1995, 0.1585, 0.1259,
    0.1, 0.07943, 0.06310, 0.05012, 0.03981, 0.03162, 0.02512, 0.01995, 0.01585, 0.01259,
    0.01, 0.007943, 0.006310, 0.005012, 0.003981, 0.003162, 0.002512, 0.001995, 0.001585,
    0.001259,
    0.001, 0.0007943, 0.0006310, 0.0005012, 0.0003981, 0.0003162, 0.0002512, 0.0001995,
    0.0001585, 0.0001259,
    0.0001, 7.943e-05, 6.310e-05, 5.012e-05, 3.981e-05, 3.162e-05, 2.512e-05, 1.995e-05,
    1.585e-05, 1.259e-05,
    1e-05, 7.943e-06, 6.310e-06, 5.012e-06, 3.981e-06, 3.162e-06, 2.512e-06, 1.995e-06,
    1.585e-06, 1.259e-06,
    1e-06, 7.943e-07, 6.310e-07, 5.012e-07, 3.981e-07, 3.1622e-07, 2.512e-07, 1.995e-07,
    1.585e-07, 1.259e-07,
    1e-07, 7.943e-08, 6.310e-08, 5.012e-08, 3.981e-08, 3.1622e-08, 2.512e-08, 1.995e-08,
    1.585e-08, 1.259e-08,
]


def _first_true(mask: torch.Tensor, default: int) -> torch.Tensor:
    """Index of the first True along dim 1, `default` where there is none."""
    n = mask.shape[1]
    idx = torch.arange(n, device=mask.device).expand_as(mask)
    return torch.where(mask, idx, default).amin(1)


def merge_pairs(codes1, quals1, len1, codes2, quals2, len2, chunk: int = 1 << 18):
    """Merge pairs: codes (P, L) uint8 (A C G T = 0..3, N = 4), raw phred
    quals (P, L) uint8, lengths (P,). Returns (merged (P,) bool, m_codes
    (P, 2L) uint8, m_quals (P, 2L) uint8 raw phred, m_len (P,) int32), on
    the inputs' device, in row chunks of `chunk` pairs."""
    outs = [_merge_chunk(*(x[s : s + chunk] for x in (codes1, quals1, len1, codes2, quals2, len2)))
            for s in range(0, codes1.shape[0], chunk)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def _merge_chunk(c1, q1, l1, c2, q2, l2):
    dev = c1.device
    P, L = c1.shape
    c1 = c1.to(torch.int16)
    c2 = c2.to(torch.int16)
    l1 = l1.to(torch.int64)
    l2 = l2.to(torch.int64)
    j = torch.arange(L, device=dev)
    # read 2 reverse-complemented, left-aligned: rc2[jj] = comp(c2[l2-1-jj])
    src = (l2[:, None] - 1 - j).clamp(min=0)
    in2 = j < l2[:, None]
    b2 = torch.gather(c2, 1, src)
    rc2 = torch.where(in2, torch.where(b2 == N_CODE, N_CODE, 3 - b2), N_CODE)
    rq2 = torch.where(in2, torch.gather(q2.to(torch.int16), 1, src), 0)
    rq2 = torch.where(rc2 == N_CODE, 0, rq2)
    q1z = torch.where(c1 == N_CODE, 0, q1.to(torch.int16))
    q1z = torch.where(j < l1[:, None], q1z, 0)
    ln = torch.minimum(l1, l2)
    start_i = l1 - ln
    q2p = torch.tensor(Q2PERROR, dtype=torch.float64, device=dev)
    n_good = torch.zeros(P, dtype=torch.int32, device=dev)
    n_found = torch.zeros(P, dtype=torch.int32, device=dev)
    n_abort = torch.zeros(P, dtype=torch.int32, device=dev)
    best = torch.full((P,), -1, dtype=torch.int64, device=dev)
    n_shifts = int((ln - MIN_OVERLAP + EXTRA_TEST_OVERLAP).max().item()) if P else 0
    for i in range(max(n_shifts, 0)):
        live = i < ln - MIN_OVERLAP + EXTRA_TEST_OVERLAP
        overlap = ln - i
        inside = j < overlap[:, None]
        p1 = (start_i[:, None] + i + j).clamp(max=L - 1)
        ps = torch.gather(c1, 1, p1)
        pq = torch.gather(q1z, 1, p1)
        rs, rq = rc2, rq2
        this_max = MAX_MISMATCHES + (EXTRA_MISMATCHES_PER_1000 * overlap) // 1000
        error_max = (this_max * 4) // 3 + 1
        differ = (ps != rs) & inside
        byte_mm = differ.sum(1)
        scored = live & (byte_mm <= error_max)
        both_n = (ps == rs) & (ps == N_CODE) & inside
        one_n = differ & ((ps == N_CODE) | (rs == N_CODE))
        ncount = torch.cumsum(2 * both_n.to(torch.int32) + one_n.to(torch.int32), 1)
        mism = torch.cumsum(differ.to(torch.int32) + one_n.to(torch.int32), 1)
        # the scan stops at the first position that aborts (a second N-N
        # match, or more than 3 N) or that passes error_max mismatches; the
        # abort is tested first within a position
        abort_pos = _first_true(
            inside & ((torch.cumsum(both_n.to(torch.int32), 1) >= 2) | (ncount > 3)), L)
        mm_pos = _first_true(inside & (mism > error_max[:, None]), L)
        aborted = scored & (abort_pos <= mm_pos) & (abort_pos < overlap)
        complete = scored & (abort_pos >= overlap) & (mm_pos >= overlap)
        matches = ((ps == rs) & inside).sum(1)
        mismatches = (mism * (j == (overlap - 1).clamp(min=0)[:, None])).sum(1)
        diffq = (pq - rq).abs()
        term = torch.where(diffq <= 2, torch.full_like(diffq, 0, dtype=torch.float64) + 0.5,
                           q2p[diffq.clamp(max=len(Q2PERROR) - 1).to(torch.int64)])
        term = term + torch.where(ps == N_CODE, q2p[rq.to(torch.int64)], 0.0) * one_n
        term = term + torch.where((ps != N_CODE) & (rs == N_CODE), q2p[pq.to(torch.int64)],
                                  0.0) * one_n
        perror = torch.where(differ, term, 0.0).sum(1)
        ratio = perror.to(torch.float32) / overlap.to(torch.float32)
        match_thres = torch.clamp(overlap - this_max, min=MIN_OVERLAP)
        good = (complete & (matches >= match_thres) & (mismatches <= this_max)
                & (ratio <= np.float32(MAX_PERROR)))
        found = (complete & ~good & (mismatches <= error_max)
                 & (ratio <= np.float32(MAX_PERROR * 4 / 3)))
        n_good += good.to(torch.int32)
        n_found += found.to(torch.int32)
        n_abort += aborted.to(torch.int32)
        best = torch.where(good & (best < 0), i, best)
    merged = (n_good == 1) & (n_found == 0) & (n_abort == 0) & (l1 > 0) & (l2 > 0)
    # the merged read: read 1 with the overlap resolved, then rc2's tail
    i = best.clamp(min=0)
    overlap = ln - i
    W = 2 * L
    jw = torch.arange(W, device=dev)
    in_ov = (jw[None, :] >= (start_i + i)[:, None]) & (jw[None, :] < l1[:, None])
    jj = (jw[None, :] - (start_i + i)[:, None]).clamp(0, L - 1)
    r_s = torch.gather(rc2, 1, jj)
    r_q = torch.gather(rq2, 1, jj)
    pad = lambda t, v: torch.cat([t, torch.full((P, W - L), v, dtype=t.dtype, device=dev)], 1)
    s1 = pad(c1, N_CODE)
    sq = pad(q1z, 0)
    same = s1 == r_s
    take2 = in_ov & ~same & (sq < r_q)
    m_codes = torch.where(take2, r_s, s1)
    m_quals = torch.where(in_ov & same, torch.clamp(sq + r_q, max=41),
                          torch.where(in_ov, torch.clamp((sq - r_q).abs(), min=2), sq))
    # rc2[overlap:] goes after read 1
    tail = jw[None, :] >= l1[:, None]
    tj = (jw[None, :] - l1[:, None] + overlap[:, None]).clamp(0, L - 1)
    m_codes = torch.where(tail, torch.gather(rc2, 1, tj), m_codes)
    m_quals = torch.where(tail, torch.gather(rq2, 1, tj), m_quals)
    m_len = l1 + l2 - overlap
    valid = jw[None, :] < m_len[:, None]
    m_codes = torch.where(valid & merged[:, None], m_codes, N_CODE).to(torch.uint8)
    m_quals = torch.where(valid & merged[:, None], m_quals, 0).to(torch.uint8)
    return merged, m_codes, m_quals, torch.where(merged, m_len, 0).to(torch.int32)
