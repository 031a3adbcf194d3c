"""Batched Smith-Waterman local alignment (port of mhm2_proxy_tpu/ops/ssw.py
and ops/pallas_ssw.py).

Semantics (Farrar/SSW conventions, affine gaps):
  H[i,j] = max(0, H[i-1,j-1] + subst, E[i,j], F[i,j])
  E[i,j] = max(H[i,j-1] - gap_open, E[i,j-1] - gap_extend)   (gap in query)
  F[i,j] = max(H[i-1,j] - gap_open, F[i-1,j] - gap_extend)   (gap in ref)
with the reference's lazy F: F is taken over the column's H before F
(H_noF), f_i = max(H_noF[i-1] - gap_open, f_{i-1} - gap_extend), f_0 = NEG.
The best cell ties toward the smaller ref position, then the smaller query
position. Begin positions come from a second pass over the reversed
prefixes that end at the best cell.

sw_align_ends is the kernel wrapper: for CUDA tensors it launches
csrc/ssw.cu (one pair per thread, the DP in strips of ref columns held
in registers, any Lq and Lr); for CPU tensors it runs
the plain version, the reference's XLA column loop
(`_sw_align_ends_xla`, ssw.py:84-132) with the in-column F as the log-step
max-decay doubling of the Pallas kernel (pallas_ssw.py:76-81).

The CIGAR path is the reference's: a global DP over the clipped segments
that stores traceback codes (`_global_tb_pointers`, plain torch on the
device, as the reference leaves it to XLA), a vectorised traceback walk
over the whole batch, and run-length CIGARs. sw_cigar_host is the
pure-Python oracle.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import trace
from . import kernels

NEG = -(10 ** 6)


def decay_max_scan(c: torch.Tensor, ge: int) -> torch.Tensor:
    """y[..., i] = max over k <= i of c[..., k] - (i - k) * ge, along the last
    axis, by log-step doubling (the reference's associative scan): step s
    takes y[i - s] - s * ge into y[i] for i >= s. Updated in place on a copy
    of c (the shifted operand is materialised before each write)."""
    L = c.shape[-1]
    y = c.clone()
    s = 1
    while s < L:
        torch.maximum(y[..., s:], y[..., : L - s] - s * ge, out=y[..., s:])
        s *= 2
    return y


def sw_align_ends(query, q_len, ref, r_len, match: int = 1, mismatch: int = 1,
                  gap_open: int = 1, gap_extend: int = 1, ambiguity: int = 1):
    """Forward pass: best score and its end cell for a batch of pairs.

    query (B, Lq) uint8 codes (0-3, >= 4 ambiguous, 255 pad), q_len (B,)
    int32, ref (B, Lr) uint8, r_len (B,) int32. Returns (score, q_end,
    r_end), (B,) int32, 0-based inclusive ends; (0, -1, -1) where no cell
    scores above 0."""
    B, Lq = query.shape
    if ref.shape[0] != B or q_len.shape != (B,) or r_len.shape != (B,):
        raise ValueError(f"ssw: query {tuple(query.shape)}, ref {tuple(ref.shape)}, "
                         f"q_len {tuple(q_len.shape)}, r_len {tuple(r_len.shape)}")
    kw = dict(match=match, mismatch=mismatch, gap_open=gap_open, gap_extend=gap_extend,
              ambiguity=ambiguity)
    if kernels.use_kernel(query, q_len, ref, r_len):
        return _sw_ends_cuda(query, q_len, ref, r_len, **kw)
    return _sw_ends_plain(query, q_len, ref, r_len, **kw)


def _sw_ends_plain(query, q_len, ref, r_len, match, mismatch, gap_open, gap_extend, ambiguity):
    B, Lq = query.shape
    Lr = ref.shape[1]
    dev = query.device
    i32 = torch.int32
    if Lq == 0:
        unset = torch.full((B,), -1, dtype=i32, device=dev)
        return torch.zeros_like(unset), unset, unset.clone()
    q = query.to(i32)
    iota = torch.arange(Lq, dtype=i32, device=dev)[None, :]
    q_valid = iota < q_len.to(i32)[:, None]
    q_amb = q >= 4
    H = torch.zeros((B, Lq), dtype=i32, device=dev)
    E = torch.full((B, Lq), NEG, dtype=i32, device=dev)
    best = torch.zeros((B,), dtype=i32, device=dev)
    bi = torch.full((B,), -1, dtype=i32, device=dev)
    bj = torch.full((B,), -1, dtype=i32, device=dev)
    neg_col = torch.full((B, 1), NEG, dtype=i32, device=dev)
    zero_col = torch.zeros((B, 1), dtype=i32, device=dev)
    for j in range(Lr):
        r_b = ref[:, j].to(i32)[:, None]
        valid = q_valid & (j < r_len)[:, None]
        sub = torch.where(q_amb | (r_b >= 4), -ambiguity,
                          torch.where(q == r_b, match, -mismatch)).to(i32)
        sub = torch.where(valid, sub, NEG)
        diag = torch.cat([zero_col, H[:, :-1]], dim=1)
        E = torch.maximum(H - gap_open, E - gap_extend)
        H_noF = torch.clamp_min(torch.maximum(diag + sub, E), 0)
        F = decay_max_scan(torch.cat([neg_col, H_noF[:, :-1] - gap_open], dim=1), gap_extend)
        H = torch.where(valid, torch.maximum(H_noF, F), 0)
        col_best = H.max(dim=1).values
        col_i = torch.where(H == col_best[:, None], iota, Lq).min(dim=1).values
        upd = col_best > best
        best = torch.where(upd, col_best, best)
        bi = torch.where(upd, col_i, bi)
        bj = torch.where(upd, j, bj)
    none = best <= 0
    return (torch.where(none, 0, best), torch.where(none, -1, bi), torch.where(none, -1, bj))


def _sw_ends_cuda(query, q_len, ref, r_len, match, mismatch, gap_open, gap_extend, ambiguity):
    """The kernel on CUDA tensors. It keeps a row's best as score x R +
    column tie-break in an int32 (R: csrc/ssw.cu's strip width), so it
    refuses, as a failed launch, a scoring whose best possible score, match
    x min(Lq, Lr), reaches 2^31 / R."""
    kernels.require(query, torch.uint8, "ssw query")
    kernels.require(ref, torch.uint8, "ssw ref")
    kernels.require(q_len, torch.int32, "ssw q_len")
    kernels.require(r_len, torch.int32, "ssw r_len")
    B, Lq = query.shape
    Lr = ref.shape[1]
    dev = query.device
    out = torch.empty((3, B), dtype=torch.int32, device=dev)
    if B == 0:
        return out[0], out[1], out[2]
    # each row's H and E at a strip's last column, for the next strip
    edge = torch.empty((Lq, B, 2), dtype=torch.int32, device=dev)
    rc = kernels.lib().mhm2_ssw(
        query.data_ptr(), q_len.data_ptr(), ref.data_ptr(), r_len.data_ptr(), B, Lq, Lr,
        match, mismatch, gap_open, gap_extend, ambiguity, edge.data_ptr(), out.data_ptr(),
        kernels.stream(dev),
    )
    kernels.check(rc, "ssw")
    kernels.count_launch("ssw")
    return out[0], out[1], out[2]


def reverse_prefix(arr: torch.Tensor, lens: torch.Tensor, L: int) -> torch.Tensor:
    """arr[:, :lens] reversed and left-aligned; the tail padded with 255."""
    j = torch.arange(L, dtype=torch.int64, device=arr.device)[None, :]
    lens = lens.to(torch.int64)[:, None]
    idx = torch.clamp(lens - 1 - j, 0, L - 1)
    out = torch.gather(arr, 1, idx)
    return torch.where(j < lens, out, torch.full_like(out, 255))


def sw_align(query, q_len, ref, r_len, match: int = 1, mismatch: int = 1, gap_open: int = 1,
             gap_extend: int = 1, ambiguity: int = 1) -> dict:
    """Full batched local alignment: dict(score, q_begin, q_end, r_begin,
    r_end), (B,) int32, 0-based inclusive; begins and ends are -1 for pairs
    with no alignment."""
    kw = dict(match=match, mismatch=mismatch, gap_open=gap_open, gap_extend=gap_extend,
              ambiguity=ambiguity)
    score, q_end, r_end = sw_align_ends(query, q_len, ref, r_len, **kw)
    Lq, Lr = query.shape[1], ref.shape[1]
    q_rev = reverse_prefix(query, q_end + 1, Lq)
    r_rev = reverse_prefix(ref, r_end + 1, Lr)
    _s2, qe2, re2 = sw_align_ends(q_rev, q_end + 1, r_rev, r_end + 1, **kw)
    q_begin = torch.where(q_end >= 0, q_end - qe2, -1)
    r_begin = torch.where(r_end >= 0, r_end - re2, -1)
    return dict(score=score, q_begin=q_begin, q_end=q_end, r_begin=r_begin, r_end=r_end)


# ---------------------------------------------------------------------------
# batched CIGARs: the traceback DP on the device, a vectorised walk
# ---------------------------------------------------------------------------


def global_tb_pointers(q, r, match: int = 1, mismatch: int = 1, gap_open: int = 1,
                       gap_extend: int = 1, ambiguity: int = 1) -> torch.Tensor:
    """Global-alignment DP over clipped segments, returning traceback codes.

    q (B, Nq) uint8 codes (255 pad), r (B, Nr). Returns (B, Nr+1, Nq+1)
    uint8: 0 = diag, 1 = E (gap in query, 'D'), 2 = F (gap in ref, 'I'), in
    the host oracle's priority (diag, then E, else F); the reference's
    `_global_tb_pointers` (ssw.py:174-231), column by column."""
    B, Nq = q.shape
    Nr = r.shape[1]
    dev = q.device
    i32 = torch.int32
    i_ax = torch.arange(Nq + 1, dtype=i32, device=dev)[None, :]
    H = torch.where(i_ax == 0, 0, -gap_open - (i_ax - 1) * gap_extend).to(i32).expand(B, Nq + 1)
    E = torch.full((B, Nq + 1), NEG, dtype=i32, device=dev)
    tb = torch.empty((B, Nr + 1, Nq + 1), dtype=torch.uint8, device=dev)
    tb[:, 0, :] = 2
    qi = q.to(i32)
    q_amb = qi >= 4
    neg_col = torch.full((B, 1), NEG, dtype=i32, device=dev)
    for j in range(1, Nr + 1):
        r_b = r[:, j - 1].to(i32)[:, None]
        sub = torch.where(q_amb | (r_b >= 4), -ambiguity,
                          torch.where(qi == r_b, match, -mismatch)).to(i32)
        h_bound = -gap_open - (j - 1) * gap_extend
        E = torch.maximum(H - gap_open, E - gap_extend)
        E[:, 0] = h_bound
        dps = torch.cat([neg_col, H[:, :-1] + sub], dim=1)
        H_noF = torch.maximum(dps, E)
        H_noF[:, 0] = h_bound
        F = decay_max_scan(torch.cat([neg_col, H_noF[:, :-1] - gap_open], dim=1), gap_extend)
        H = torch.maximum(H_noF, F)
        H[:, 0] = h_bound
        src = torch.where(H == dps, 0, torch.where(H == E, 1, 2)).to(torch.uint8)
        src[:, 0] = 1
        tb[:, j, :] = src
    return tb


_OP_CHARS = np.frombuffer(b".=XID", np.uint8)  # op code -> CIGAR char
_DIGITS = 6  # longest decimal count a CIGAR token carries (positions < 10^6)


def _traceback_walk(tb, q_clip, r_clip, nq, nr):
    """The reference's vectorised walk from (nq, nr) on the device: (B, S)
    uint8 ops end-to-start (1 '=', 2 'X', 3 'I', 4 'D', 0 none) and the ops
    per row. S = max(nq + nr): every step consumes a row or a column, so no
    row is active past it."""
    B, Nr1, Nq1 = tb.shape
    dev = tb.device
    S = int((nq + nr).max()) if B else 0
    i, j = nq.clone(), nr.clone()
    flat = tb.reshape(-1)
    base = torch.arange(B, dtype=torch.int64, device=dev) * (Nr1 * Nq1)
    rows = torch.arange(B, dtype=torch.int64, device=dev)
    Nq, Nr = Nq1 - 1, Nr1 - 1
    ops_rev = torch.zeros((B, max(S, 1)), dtype=torch.uint8, device=dev)
    for step in range(S):
        active = (i > 0) | (j > 0)
        h = flat[base + j * Nq1 + i]
        d = active & (h == 0) & (i > 0) & (j > 0)
        dd = active & ~d & (h == 1) & (j > 0)
        ii = active & ~d & ~dd
        qv = q_clip[rows, torch.clamp(i - 1, 0, Nq - 1)]
        rv = r_clip[rows, torch.clamp(j - 1, 0, Nr - 1)]
        eq = (qv == rv) & (qv < 4)
        ops_rev[:, step] = torch.where(d, torch.where(eq, 1, 2),
                                       torch.where(dd, 4, torch.where(ii, 3, 0))).to(torch.uint8)
        i = i - (d | ii).to(torch.int64)
        j = j - (d | dd).to(torch.int64)
    n_ops = (ops_rev > 0).sum(dim=1)
    return ops_rev, n_ops


def _op_runs(ops_rev: torch.Tensor, n_ops: torch.Tensor):
    """The runs of equal ops of each row, start to end, on the ops' device:
    (row, start, length, op code) per run, rows ascending, then starts."""
    B, S = ops_rev.shape
    t = torch.arange(S, device=ops_rev.device)[None, :]
    live = t < n_ops[:, None]
    ops = torch.where(live, torch.gather(ops_rev, 1, torch.clamp(n_ops[:, None] - 1 - t, 0, S - 1)),
                      0)
    prev = torch.cat([torch.zeros_like(ops[:, :1]), ops[:, :-1]], dim=1)
    rr, st = torch.nonzero(live & ((t == 0) | (ops != prev)), as_tuple=True)
    nxt = torch.cat([st[1:], torch.zeros_like(st[:1])])
    same_row = torch.cat([rr[1:] == rr[:-1], torch.zeros_like(rr[:1], dtype=torch.bool)])
    run_len = torch.where(same_row, nxt, n_ops[rr]) - st
    return rr, st, run_len, ops[rr, st]


def _render_cigars(rr: np.ndarray, st: np.ndarray, run_len: np.ndarray, run_op: np.ndarray,
                   qb: np.ndarray, tail: np.ndarray, ok: np.ndarray) -> list[str]:
    """Run-length CIGARs of a whole batch without a loop per read: the
    tokens (head clip, the runs of _op_runs, tail clip) become one
    fixed-width digit matrix, whose used bytes are cut per read. Equal to
    the reference's per-read f-strings."""
    B = ok.shape[0]
    S = int(st.max(initial=0)) + 1
    run_chr = _OP_CHARS[run_op]
    head = np.nonzero(ok & (qb > 0))[0]
    tl = np.nonzero(ok & (tail > 0))[0]
    S_ch = np.uint8(ord("S"))
    tok_row = np.concatenate([head, rr, tl])
    tok_ord = np.concatenate([np.full(head.size, -1), st, np.full(tl.size, S + 1)])
    tok_len = np.concatenate([qb[head], run_len, tail[tl]]).astype(np.int64)
    tok_chr = np.concatenate([np.full(head.size, S_ch), run_chr, np.full(tl.size, S_ch)])
    order = np.lexsort((tok_ord, tok_row))
    tok_row, tok_len, tok_chr = tok_row[order], tok_len[order], tok_chr[order]
    if tok_len.size and int(tok_len.max()) >= 10 ** _DIGITS:
        raise ValueError("CIGAR run longer than the renderer's digit field")
    pw = 10 ** np.arange(_DIGITS - 1, -1, -1)
    digits = (tok_len[:, None] // pw[None, :]) % 10
    n_dig = 1 + sum((tok_len >= 10 ** d).astype(np.int64) for d in range(1, _DIGITS))
    mat = np.zeros((tok_len.size, _DIGITS + 1), np.uint8)
    mat[:, :_DIGITS] = (digits + ord("0")).astype(np.uint8)
    mat[:, _DIGITS] = tok_chr
    used = np.arange(_DIGITS + 1)[None, :] >= (_DIGITS - n_dig)[:, None]
    text = mat[used].tobytes().decode()
    row_bytes = np.bincount(tok_row, weights=n_dig + 1, minlength=B).astype(np.int64)
    ends = np.cumsum(row_bytes)
    begins = ends - row_bytes
    return [text[a:b] for a, b in zip(begins.tolist(), ends.tolist())]


def sw_cigar_batch(query, q_len, ref, r_len, aln: dict, match=1, mismatch=1, gap_open=1,
                   gap_extend=1, ambiguity=1, timings: dict | None = None):
    """CIGARs and mismatch counts for a whole aligned batch (the reference's
    sw_cigar_batch, ssw.py:237-327).

    query/ref: (B, Lq)/(B, Lr) uint8 codes (torch tensors on the device
    that runs the DP, or numpy arrays, which run on the CPU); aln from
    sw_align on the same batch (tensors or arrays). The clipped segments'
    global DP and the traceback walk run on the tensors' device; the CIGAR
    text is rendered on the host. Returns (cigars: list[str], mismatches:
    (B,) int32 numpy); unaligned pairs get "". Equal to sw_cigar_host.
    timings, when given, accumulates the seconds of the DP ("tb_dp_s"), the
    walk ("tb_walk_s") and the rendering ("cigar_render_s"), each ending at
    a sync of the device's queued work; while a trace records, each is a
    span "post_asm." + its key without "_s", the DP's counting `tb_bytes`
    (its traceback codes, B x (Nr+1) x (Nq+1) bytes)."""
    t0 = trace.now()
    query = torch.as_tensor(query)
    ref = torch.as_tensor(ref, device=query.device)
    dev = query.device
    B, Lq = query.shape
    Lr = ref.shape[1]

    def lane(x):
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                               device=dev).to(torch.int64)

    qb, qe, rb, re_ = (lane(aln[n]) for n in ("q_begin", "q_end", "r_begin", "r_end"))
    ok = qe >= 0
    nq = torch.where(ok, qe - qb + 1, 0)
    nr = torch.where(ok, re_ - rb + 1, 0)
    Nq = max(int(nq.max()) if B else 0, 1)
    Nr = max(int(nr.max()) if B else 0, 1)
    jq = torch.arange(Nq, device=dev)[None, :]
    q_clip = torch.where(jq < nq[:, None],
                         torch.gather(query, 1, torch.clamp(qb[:, None] + jq, 0, Lq - 1)),
                         255).to(torch.uint8)
    jr = torch.arange(Nr, device=dev)[None, :]
    r_clip = torch.where(jr < nr[:, None],
                         torch.gather(ref, 1, torch.clamp(rb[:, None] + jr, 0, Lr - 1)),
                         255).to(torch.uint8)
    tb = global_tb_pointers(q_clip, r_clip, match=match, mismatch=mismatch, gap_open=gap_open,
                            gap_extend=gap_extend, ambiguity=ambiguity)
    t0 = trace.lap(timings, "tb_dp_s", t0, dev, "post_asm.", tb_bytes=tb.numel())
    ops_rev, n_ops = _traceback_walk(tb, q_clip, r_clip, nq, nr)
    del tb
    t0 = trace.lap(timings, "tb_walk_s", t0, dev, "post_asm.")
    mismatches = torch.where(ok, (ops_rev >= 2).sum(dim=1), 0).to(torch.int32).cpu().numpy()
    ok_h = ok.cpu().numpy()
    qb_h = qb.cpu().numpy()
    tail = lane(q_len).cpu().numpy() - 1 - qe.cpu().numpy()
    runs = [x.cpu().numpy() for x in _op_runs(ops_rev, n_ops)]
    cigars = _render_cigars(*runs, qb_h, tail, ok_h)
    trace.lap(timings, "cigar_render_s", t0, dev, "post_asm.")
    return cigars, mismatches


# ---------------------------------------------------------------------------
# host traceback for CIGARs (reference SSW report_cigar path)
# ---------------------------------------------------------------------------


def sw_cigar_host(query: str, ref: str, aln: dict, idx: int,
                  match=1, mismatch=1, gap_open=1, gap_extend=1, ambiguity=1):
    """CIGAR + mismatch count for one aligned pair by host DP traceback.

    Produces SSW-style CIGARs with '=' / 'X' / 'I' / 'D' and soft clips 'S'
    at the query ends (cf. test/ssw-test.cpp expectations like '1S4=2S').
    """
    qb, qe = int(aln["q_begin"][idx]), int(aln["q_end"][idx])
    rb, re_ = int(aln["r_begin"][idx]), int(aln["r_end"][idx])
    if qe < 0:
        return "", 0
    q = query[qb : qe + 1]
    r = ref[rb : re_ + 1]
    n, m = len(q), len(r)
    H = np.zeros((n + 1, m + 1), np.int32)
    E = np.full((n + 1, m + 1), NEG, np.int32)
    F = np.full((n + 1, m + 1), NEG, np.int32)
    # global alignment of the clipped segment (it is known to align end-to-end)
    for i in range(1, n + 1):
        H[i, 0] = -gap_open - (i - 1) * gap_extend
        F[i, 0] = H[i, 0]
    for j in range(1, m + 1):
        H[0, j] = -gap_open - (j - 1) * gap_extend
        E[0, j] = H[0, j]
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            s = match if q[i - 1] == r[j - 1] else -mismatch
            if q[i - 1] not in "ACGT" or r[j - 1] not in "ACGT":
                s = -ambiguity
            E[i, j] = max(H[i, j - 1] - gap_open, E[i, j - 1] - gap_extend)
            F[i, j] = max(H[i - 1, j] - gap_open, F[i - 1, j] - gap_extend)
            H[i, j] = max(H[i - 1, j - 1] + s, E[i, j], F[i, j])
    # traceback
    ops = []
    i, j = n, m
    mismatches = 0
    while i > 0 or j > 0:
        if i > 0 and j > 0 and H[i, j] == H[i - 1, j - 1] + (
            (match if q[i - 1] == r[j - 1] else -mismatch)
            if q[i - 1] in "ACGT" and r[j - 1] in "ACGT"
            else -ambiguity
        ):
            ops.append("=" if q[i - 1] == r[j - 1] else "X")
            if q[i - 1] != r[j - 1]:
                mismatches += 1
            i, j = i - 1, j - 1
        elif j > 0 and H[i, j] == E[i, j]:
            ops.append("D")
            mismatches += 1
            j -= 1
        else:
            ops.append("I")
            mismatches += 1
            i -= 1
    ops.reverse()
    # run-length encode with soft clips
    cigar = []
    if qb > 0:
        cigar.append(f"{qb}S")
    k = 0
    while k < len(ops):
        k2 = k
        while k2 < len(ops) and ops[k2] == ops[k]:
            k2 += 1
        cigar.append(f"{k2 - k}{ops[k]}")
        k = k2
    tail = len(query) - 1 - qe
    if tail > 0:
        cigar.append(f"{tail}S")
    return "".join(cigar), mismatches
