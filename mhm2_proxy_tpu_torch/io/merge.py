"""Paired-read merging (reference src/merge_reads.cpp:237-495; port of
mhm2_proxy_tpu/io/merge.py).

Two engines give one result contract:
- the shared native C++ scan (native/merge_native.cpp), a sequential
  early-exit scan per pair on the host: the production merge whenever the
  library is present and MHM2_NO_NATIVE_MERGE is not "1";
- merge_pairs_block, the reference's block-vectorized formulation, as plain
  torch on the tensors' device. Every pair of a block is scored at a shift
  with masked vector ops, and the reference's per-pair early-exit state
  machine (best/found/ambiguous/abort) becomes a carried state fold.
  scan="dense" folds over every shift; scan="shortlist" scores only the
  first K_CAND shifts of each pair that pass the byte-mismatch prefilter,
  which is exact unless the pair's `overflow` is set (more passing shifts),
  where merge_reads_arrays reruns the dense scan.

perror follows the native merge (merge_native.cpp:62-93) and the
reference's oracle: float64 contributions summed in float64 and rounded
once to float32 before the division by the overlap. A float32 sum depends
on the reduction order, which differs between devices, and the 0.025 test
can flip on a pair at the threshold.

Constants mirror merge_reads.cpp:285-295: MIN_OVERLAP=12,
EXTRA_TEST_OVERLAP=2, MAX_MISMATCHES=3 (+150/1000 per overlap base),
MAX_PERROR=0.025, and the Q2Perror table (merge_reads.cpp:73-81).

Known deliberate divergence (both packages): the reference zeroes the
quality of 'N' bases lazily as overlap scans touch them
(merge_reads.cpp:375,382); here all N-base qualities are pre-zeroed. This
changes nothing inside the accepted overlap (the winning scan touches every
position there) and only the output qualities of never-tested N bases,
which cannot influence assembly.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..utils.logger import get_logger

MIN_OVERLAP = 12
EXTRA_TEST_OVERLAP = 2
MAX_MISMATCHES = 3
MAX_PERROR = 0.025
EXTRA_MISMATCHES_PER_1000 = 150

# Q2Perror[q] = 10^(-q/10) table (merge_reads.cpp:73-81), 80 entries
_Q2PERROR = np.array(
    [1.0, 0.7943, 0.6309, 0.5012, 0.3981, 0.3162, 0.2512, 0.1995, 0.1585, 0.1259,
     0.1, 0.07943, 0.06310, 0.05012, 0.03981, 0.03162, 0.02512, 0.01995, 0.01585, 0.01259,
     0.01, 0.007943, 0.006310, 0.005012, 0.003981, 0.003162, 0.002512, 0.001995, 0.001585, 0.001259,
     0.001, 0.0007943, 0.0006310, 0.0005012, 0.0003981, 0.0003162, 0.0002512, 0.0001995, 0.0001585, 0.0001259,
     0.0001, 7.943e-05, 6.310e-05, 5.012e-05, 3.981e-05, 3.162e-05, 2.512e-05, 1.995e-05, 1.585e-05, 1.259e-05,
     1e-05, 7.943e-06, 6.310e-06, 5.012e-06, 3.981e-06, 3.162e-06, 2.512e-06, 1.995e-06, 1.585e-06, 1.259e-06,
     1e-06, 7.943e-07, 6.310e-07, 5.012e-07, 3.981e-07, 3.1622e-07, 2.512e-07, 1.995e-07, 1.585e-07, 1.259e-07,
     1e-07, 7.943e-08, 6.310e-08, 5.012e-08, 3.981e-08, 3.1622e-08, 2.512e-08, 1.995e-08, 1.585e-08, 1.259e-08],
    np.float64,
)

K_CAND = 12  # shortlist width: prefilter-passing shifts evaluated in detail

# the perror ratio's float32 limits (the native merge compares in float)
_MAX_PE = float(np.float32(MAX_PERROR))
_MAX_PE_WEAK = float(np.float32(MAX_PERROR * 4 / 3))

# device bytes a chunk of rows may take: the block is merged in row chunks
# (pairs are independent), each costing at most L * (3 n_i + 100 K_CAND)
# bytes a row at its peak (the prefilter's (rows, n_i, L) masks and the
# shortlist's (rows, K_CAND, L) temporaries). At L = 128 a 2 GiB budget is
# 10,796 rows a chunk and a 1.83 GB peak on an H100; larger chunks save
# little time (PERF.md §5, "The pair merge")
_CHUNK_BYTES = 2 << 30

_I16, _I32, _I64, _U8 = torch.int16, torch.int32, torch.int64, torch.uint8


def _eval_shift(a, q1, rc2, q2f, overlap, q2p):
    """Detailed overlap scoring at one shift (merge_reads.cpp:346-443).

    a, q1: (..., L) aligned seq1 window (int16 codes / int32 phred); rc2,
    q2f: broadcast-compatible (..., L) rc(read2); overlap: (...,) int64;
    q2p: the (80,) float64 Q2Perror table. Returns (good, weak, abort_here)
    ungated by scan state: callers apply the done / shift-validity gating.
    """
    L = a.shape[-1]
    in_ov = torch.arange(L, device=a.device) < overlap[..., None]

    this_max = MAX_MISMATCHES + (EXTRA_MISMATCHES_PER_1000 * overlap) // 1000
    error_max = (this_max * 4) // 3 + 1

    is_mm = (a != rc2) & in_ov
    prefilter_ok = is_mm.sum(-1) <= error_max

    a_n, rc_n = a == 4, rc2 == 4
    mm_n = is_mm & (a_n | rc_n)  # N mismatches count double
    det_mm = is_mm.to(_I32) + mm_n.to(_I32)
    cum_mm = torch.cumsum(det_mm, -1, dtype=_I32)
    # j is processed iff cumulative mismatches before j never exceeded max
    first = torch.ones(cum_mm.shape[:-1] + (1,), dtype=torch.bool, device=a.device)
    proc = torch.cat([first, cum_mm[..., :-1] <= error_max[..., None]], -1) & in_ov
    complete = (proc | ~in_ov).all(-1)

    match_n = a_n & rc_n & in_ov
    cum_match_n = torch.cumsum(match_n, -1, dtype=_I32)
    ncount = torch.cumsum(match_n.to(_I32) * 2 + mm_n.to(_I32), -1, dtype=_I32)
    abort_j = ((cum_match_n >= 2) & match_n) | (ncount > 3)
    abort_here = (abort_j & proc).any(-1) & prefilter_ok

    matches = ((a == rc2) & in_ov).sum(-1)

    # perror contributions at mismatches (merge_reads.cpp:370-406)
    qq1 = torch.where(a_n, 0, q1).clamp(0, 79)
    qq2 = torch.where(rc_n, 0, q2f).clamp(0, 79)
    diffq = (qq1 - qq2).abs()
    base_pe = torch.where(diffq <= 2, 0.5, q2p[diffq])
    n_pe = torch.where(a_n, q2p[qq2], torch.where(rc_n, q2p[qq1], 0.0))
    perror = torch.where(is_mm, base_pe + n_pe, 0.0).sum(-1).to(torch.float32)

    mm_total = det_mm.sum(-1)
    ratio = perror / overlap.clamp(min=1).to(torch.float32)
    match_thres = (overlap - this_max).clamp(min=MIN_OVERLAP)
    ok = prefilter_ok & complete & ~abort_here
    good = ok & (matches >= match_thres) & (mm_total <= this_max) & (ratio <= _MAX_PE)
    weak = ok & ~good & (mm_total <= error_max) & (ratio <= _MAX_PE_WEAK)
    return good, weak, abort_here


def _step(state, i_k, good, weak, abort_here):
    """One state-machine transition (merge_reads.cpp:419-442)."""
    best_i, found_i, done, aborted, n_ambig = state
    good = good & ~done
    weak = weak & ~done
    abort_here = abort_here & ~done
    fresh = (best_i < 0) & (found_i < 0)
    new_best = torch.where(good & fresh, i_k, best_i)
    good_ambig = good & ~fresh
    weak_ambig = weak & (best_i >= 0)
    new_best = torch.where(good_ambig | weak_ambig, -1, new_best)
    new_found = torch.where(weak, i_k, found_i)
    ambig = abort_here | good_ambig | weak_ambig
    return new_best, new_found, done | ambig, aborted | abort_here, n_ambig + ambig.to(_I64)


def _merge_rows(codes1, quals1, len1, codes2, quals2, len2, qual_offset: int, scan: str, q2p):
    """merge_pairs_block on one chunk of rows, with per-row n_ambig and
    overflow; q2p is _Q2PERROR on the rows' device."""
    B, L = codes1.shape
    dev = codes1.device

    # pre-zero N-base qualities (see module docstring)
    quals1 = torch.where(codes1 == 4, qual_offset, quals1)
    quals2 = torch.where(codes2 == 4, qual_offset, quals2)
    c1, c2 = codes1.to(_I16), codes2.to(_I16)  # room for 3 - c and the sentinels
    len1, len2 = len1.to(_I64), len2.to(_I64)

    # rc of read2 with reversed quals, left-aligned to its length
    j = torch.arange(L, device=dev)[None, :]
    in2 = j < len2[:, None]
    rev_idx = (len2[:, None] - 1 - j).clamp(0, L - 1)
    c2r = torch.gather(c2, 1, rev_idx)
    rc2 = torch.where(in2, torch.where(c2r < 4, 3 - c2r, c2r), 255)
    rq2 = torch.where(in2, torch.gather(quals2, 1, rev_idx), qual_offset)

    ov_len = torch.minimum(len1, len2)  # 'len' in the reference
    start_i = len1 - ov_len

    # seq1 aligned at start_i, padded right so offset slices stay in bounds
    a_pos = start_i[:, None] + j
    a_idx = a_pos.clamp(0, L - 1)
    a_al = torch.where(a_pos < len1[:, None], torch.gather(c1, 1, a_idx), 254)
    a_pad = torch.cat([a_al, torch.full((B, L), 254, dtype=_I16, device=dev)], 1)
    q1f = torch.cat([torch.gather(quals1, 1, a_idx).to(_I32) - qual_offset,
                     torch.zeros((B, L), dtype=_I32, device=dev)], 1)
    q2f = rq2.to(_I32) - qual_offset

    n_i = max(L - MIN_OVERLAP + EXTRA_TEST_OVERLAP, 1)
    shift_lim = ov_len - MIN_OVERLAP + EXTRA_TEST_OVERLAP  # shift i runs iff i < this
    st = (torch.full((B,), -1, dtype=_I64, device=dev),
          torch.full((B,), -1, dtype=_I64, device=dev),
          torch.zeros((B,), dtype=torch.bool, device=dev),
          torch.zeros((B,), dtype=torch.bool, device=dev),
          torch.zeros((B,), dtype=_I64, device=dev))

    if scan == "dense":
        # no pair's state changes past its last shift: stop at the block's
        n_run = min(n_i, max(int(shift_lim.max()), 0)) if B else 0
        for i in range(n_run):
            ok = i < shift_lim
            good, weak, abort_here = _eval_shift(a_pad[:, i:i + L], q1f[:, i:i + L], rc2, q2f,
                                                 ov_len - i, q2p)
            st = _step(st, i, good & ok, weak & ok, abort_here & ok)
        overflow = torch.zeros((B,), dtype=torch.bool, device=dev)
    elif scan == "shortlist":
        # full scoring runs only on the <= K_CAND shifts per pair that pass
        # the cheap mismatch-count prefilter (the reference's SSE popcnt
        # prefilter, merge_reads.cpp:346-357). Exact: state transitions fire
        # only at prefilter-passing shifts, so evaluating exactly those in
        # order reproduces the sequential scan; a pair with more passing
        # shifts sets `overflow`, and its caller reruns the dense scan
        shift = torch.arange(n_i, device=dev)[None, :]
        overlap_all = ov_len[:, None] - shift  # (B, n_i)
        error_max_all = ((MAX_MISMATCHES + (EXTRA_MISMATCHES_PER_1000 * overlap_all) // 1000)
                         * 4) // 3 + 1
        win = a_pad.unfold(1, L, 1)[:, :n_i]  # (B, n_i, L) view: a_pad[b, s:s+L]
        in_ov_all = j[:, None, :] < overlap_all[..., None]
        byte_mm_all = ((win != rc2[:, None, :]) & in_ov_all).sum(-1)
        passing = (byte_mm_all <= error_max_all) & (shift < shift_lim[:, None])
        overflow = passing.sum(1) > K_CAND

        cand = torch.sort(torch.where(passing, shift, n_i), dim=1).values[:, :K_CAND]
        kc = cand.shape[1]
        idx3 = cand[:, :, None] + j[:, None, :]  # (B, kc, L)
        gat = lambda x: torch.gather(x[:, None, :].expand(B, kc, 2 * L), 2, idx3)  # noqa: E731
        good_c, weak_c, abort_c = _eval_shift(gat(a_pad), gat(q1f), rc2[:, None, :],
                                              q2f[:, None, :], ov_len[:, None] - cand, q2p)
        valid = cand < n_i
        good_c, weak_c, abort_c = good_c & valid, weak_c & valid, abort_c & valid
        for kk in range(kc):
            st = _step(st, cand[:, kk], good_c[:, kk], weak_c[:, kk], abort_c[:, kk])
    else:
        raise ValueError(f"merge_pairs_block: scan {scan!r} is neither 'dense' nor 'shortlist'")
    best_i, _found_i, _done, aborted, n_ambig = st

    merged = (best_i >= 0) & ~aborted & (len1 > 0) & (len2 > 0)

    # --- resolution of the merged overlap (merge_reads.cpp:445-475) ---
    bi = best_i.clamp(min=0)
    overlap = ov_len - bi
    a = torch.gather(a_pad, 1, bi[:, None] + j)
    q1 = torch.gather(q1f, 1, bi[:, None] + j)
    in_ov = j < overlap[:, None]
    is_match = (a == rc2) & in_ov
    res_base = torch.where(in_ov & ~is_match & (q1 >= q2f), a, rc2)
    res_q = torch.where(in_ov, torch.where(is_match, (q1 + q2f).clamp(max=41),
                                           (q1 - q2f).abs().clamp(min=2)), q2f)
    res_q = res_q.clamp(0, 255 - qual_offset) + qual_offset

    # merged[t] = seq1[t] for t < start_i+bi else res[t - start_i - bi]
    # (start_i + bi <= len1 <= L, so seq1 is read at t < L only)
    t = torch.arange(2 * L, device=dev)[None, :]
    cut = (start_i + bi)[:, None]
    m_len = len1 + len2 - overlap
    src2 = (t - cut).clamp(0, L - 1)
    fill = lambda x, v: torch.cat([x, torch.full_like(x, v)], 1)  # noqa: E731
    m_codes = torch.where(t < cut, fill(c1, 4), torch.gather(res_base, 1, src2))
    m_quals = torch.where(t < cut, fill(quals1.to(_I32), qual_offset),
                          torch.gather(res_q, 1, src2))
    keep = (t < m_len[:, None]) & merged[:, None]
    return dict(
        merged=merged,
        m_codes=torch.where(keep, m_codes, 4).to(_U8),
        m_quals=torch.where(keep, m_quals, qual_offset).to(_U8),
        m_len=torch.where(merged, m_len, 0).to(_I32),
        n_ambig=n_ambig,
        overlap=torch.where(merged, overlap, 0).to(_I32),
        quals1_z=quals1,
        quals2_z=quals2,
        overflow=overflow,
    )


def chunk_rows(L: int) -> int:
    """Rows of a (B, L) block that _merge_rows takes at once."""
    n_i = max(L - MIN_OVERLAP + EXTRA_TEST_OVERLAP, 1)
    return max(1, _CHUNK_BYTES // (L * (3 * n_i + 100 * K_CAND)))


def _merge_chunked(args, qual_offset: int, scan: str) -> dict:
    """_merge_rows over row chunks of the block, concatenated."""
    B, L = args[0].shape
    step = chunk_rows(L)
    q2p = torch.as_tensor(_Q2PERROR, device=args[0].device)  # one copy, not one a chunk
    parts = [_merge_rows(*(x[r0:r0 + step] for x in args), qual_offset, scan, q2p)
             for r0 in range(0, max(B, 1), step)]
    if len(parts) == 1:
        return parts[0]
    return {key: torch.cat([p[key] for p in parts]) for key in parts[0]}


def merge_pairs_block(codes1, quals1, len1, codes2, quals2, len2, qual_offset: int = 33,
                      scan: str = "dense"):
    """Merge a block of read pairs on the tensors' device.

    codes*: (B, L) uint8 base codes (0-3, 4=N); quals*: (B, L) uint8 raw
    (phred+offset); len*: (B,) int32. scan="dense" evaluates every shift
    (the reference's sequential scan as a fold); scan="shortlist" evaluates
    only prefilter-passing shifts (exact unless `overflow` is True).

    Returns a dict of tensors: merged (B,) bool, m_codes / m_quals (B, 2L)
    uint8, m_len and overlap (B,) int32 (0 where not merged), n_ambiguous
    (0-dim int64, the block's sum), quals1_z / quals2_z (B, L) uint8 with N
    qualities zeroed, and overflow (0-dim bool; always False for dense).
    The block is processed in row chunks of chunk_rows(L), which bounds its
    device memory and changes no output."""
    out = _merge_chunked((codes1, quals1, len1, codes2, quals2, len2), qual_offset, scan)
    out["n_ambiguous"] = out.pop("n_ambig").sum()
    out["overflow"] = out["overflow"].any()
    return out


_LOGGED_REASONS: set = set()


def _log_device_merge(reason: str, device) -> None:
    """Say once a process, for each reason, that the device merge runs."""
    if reason not in _LOGGED_REASONS:
        _LOGGED_REASONS.add(reason)
        get_logger().info(f"pair merge: the block-vectorized merge on {device} ({reason})")


def merge_reads_arrays(codes1, quals1, len1, codes2, quals2, len2, qual_offset=33,
                       use_native: bool | None = None, device="cuda", stats: dict | None = None):
    """Merge a block of read pairs; returns the per-pair result dict as
    numpy arrays (merge_pairs_block's keys without `overflow`).

    use_native=None reads MHM2_NO_NATIVE_MERGE ("1" turns the native merge
    off). The native merge runs when asked for and present; otherwise the
    shortlist scan runs on `device`, and the rows whose shortlist
    overflowed are merged again by the dense scan. stats, when given and
    the device merge runs, receives those rows' count ("dense_rows")."""
    if use_native is None:
        use_native = os.environ.get("MHM2_NO_NATIVE_MERGE", "") != "1"
    from . import native

    if use_native and native.merge_available():
        return native.merge_pairs(
            np.asarray(codes1), np.asarray(quals1), np.asarray(len1),
            np.asarray(codes2), np.asarray(quals2), np.asarray(len2),
            qual_offset=qual_offset,
        )
    dev = torch.device(device)
    if not use_native:
        reason = "the native merge is turned off"
    else:
        reason = "the host library libmhm2_host.so, with the native merge, is not available"
    _log_device_merge(reason, dev)
    args = tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                 for x in (codes1, quals1, len1, codes2, quals2, len2))
    out = _merge_chunked(args, qual_offset, "shortlist")
    rows = torch.nonzero(out.pop("overflow")).flatten()
    if stats is not None:
        stats["dense_rows"] = int(rows.numel())
    if rows.numel():
        # > K_CAND prefilter-passing shifts (low-complexity reads): these
        # rows take the exact dense scan; rows are independent, so this
        # equals the reference's dense rerun of the whole block
        dense = _merge_chunked(tuple(x[rows] for x in args), qual_offset, "dense")
        for key, v in out.items():
            v[rows] = dense[key]
    n_ambig = out.pop("n_ambig").sum()
    res = {key: v.cpu().numpy() for key, v in out.items()}
    res["n_ambiguous"] = n_ambig.cpu().numpy()
    return res
