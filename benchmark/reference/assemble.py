"""Plain-torch contigging: k-mer counting and de Bruijn traversal of MHM2.

One round at k (MetaHipMer2 contigging.cpp:93-158, as the oracle of the
repository's reference package states it):

- Counting. Every k-mer at positions 1 .. len - k - 1 of every read is
  counted in canonical form (the lesser of it and its reverse complement by
  2-bit codes; N counts as G), with a vote for its left and right
  neighbouring base when that base has phred >= 20 and is not N. Counts and
  votes saturate at 65535.
- Contig k-mers (from the round before; contigs of >= k + 2 bases, at the
  same positions, with their integer depth). A k-mer whose read entry is not
  UU with count >= 2 takes the contig entry instead: count = the least depth
  of its contig occurrences, and one vote of that weight on each side, or
  count 0 when its occurrences disagree on their neighbouring bases.
- Extension calls (kcount_cpu.cpp:173-182): a side with top vote count
  below max(int((1.0 - 0.9) * count), 2) is X, one whose runner-up reaches
  it is F, otherwise the top base. Entries with count < 2, or X on both
  sides, are dropped.
- Traversal. UU k-mers link A -> B when B = A[1:] + A's right call exists,
  is UU, is not A, and B's left call (in A's orientation) is A's first
  base; and likewise to the left. States that two edges enter lose all
  their in-edges and the edges' mirrors. Every maximal path is a contig;
  every cycle is cut before its least k-mer (walking the least k-mer
  forward). Contigs of >= k + 2 bases are kept, in canonical orientation,
  with depth = the sum of their k-mers' counts / (len - k + 2) in float64,
  sorted by (sequence, depth).

Everything runs on the inputs' device with plain torch operations. This
module imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

BASES_PER_WORD = 31
N_CODE = 4
F_CALL, X_CALL = 4, 5
MAX_COUNT = 0xFFFF
QUAL_CUTOFF = 20
CHUNK_POSITIONS = 1 << 25
ROW_CHUNK = 1 << 23


def n_words(k: int) -> int:
    return -(-k // BASES_PER_WORD)


# -- packing ---------------------------------------------------------------


def _pack_windows(codes: torch.Tensor, k: int, P: int, reverse: bool) -> torch.Tensor:
    """(P, W) int64 words of the k-mers at positions 0 .. P-1 of a flat code
    array (N packed as G); reverse packs each k-mer's reverse complement."""
    c = torch.where(codes == N_CODE, 2, codes.to(torch.int64))
    W = n_words(k)
    out = torch.zeros((P, W), dtype=torch.int64, device=codes.device)
    for w in range(W):
        nb = min(BASES_PER_WORD, k - BASES_PER_WORD * w)
        acc = torch.zeros(P, dtype=torch.int64, device=codes.device)
        for t in range(BASES_PER_WORD * w, BASES_PER_WORD * w + nb):
            src = (k - 1 - t) if reverse else t
            base = c[src : src + P]
            acc = acc * 4 + ((3 - base) if reverse else base)
        out[:, w] = acc << (2 * (BASES_PER_WORD - nb))
    return out


def pack_rows(codes: torch.Tensor) -> torch.Tensor:
    """(n, k) codes 0..3 -> (n, W) words."""
    n, k = codes.shape
    W = n_words(k)
    out = torch.zeros((n, W), dtype=torch.int64, device=codes.device)
    c = codes.to(torch.int64)
    for w in range(W):
        nb = min(BASES_PER_WORD, k - BASES_PER_WORD * w)
        acc = torch.zeros(n, dtype=torch.int64, device=codes.device)
        for t in range(BASES_PER_WORD * w, BASES_PER_WORD * w + nb):
            acc = acc * 4 + c[:, t]
        out[:, w] = acc << (2 * (BASES_PER_WORD - nb))
    return out


def unpack_rows(words: torch.Tensor, k: int) -> torch.Tensor:
    """(n, W) words -> (n, k) codes 0..3 (uint8)."""
    t = torch.arange(k, device=words.device)
    shift = 2 * (BASES_PER_WORD - 1 - t % BASES_PER_WORD)
    return ((words[:, t // BASES_PER_WORD] >> shift) & 3).to(torch.uint8)


def base_at(words: torch.Tensor, t: int) -> torch.Tensor:
    """(n,) int64 code of base t of each k-mer."""
    w, i = divmod(t, BASES_PER_WORD)
    return (words[:, w] >> (2 * (BASES_PER_WORD - 1 - i))) & 3


def lex_less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise a < b of (n, W) words, most significant word first."""
    less = torch.zeros(a.shape[0], dtype=torch.bool, device=a.device)
    for w in range(a.shape[1] - 1, -1, -1):
        less = torch.where(a[:, w] != b[:, w], a[:, w] < b[:, w], less)
    return less


def canonical(fwd: torch.Tensor, rc: torch.Tensor):
    """(canonical words, was the reverse complement)."""
    use_rc = lex_less(rc, fwd)
    return torch.where(use_rc[:, None], rc, fwd), use_rc


def lex_order(keys: torch.Tensor, tail: torch.Tensor | None = None) -> torch.Tensor:
    """Permutation that sorts (n, W) keys lexicographically (stable), with
    `tail` as a last, least significant key when given."""
    perm = torch.arange(keys.shape[0], device=keys.device)
    if tail is not None:
        perm = torch.sort(tail, stable=True).indices
    for w in range(keys.shape[1] - 1, -1, -1):
        perm = perm[torch.sort(keys[perm, w], stable=True).indices]
    return perm


# -- counting ----------------------------------------------------------------


def occurrences(flat: torch.Tensor, ok: torch.Tensor, starts: torch.Tensor,
                lens: torch.Tensor, k: int):
    """Canonical k-mer occurrences of sequences laid end to end in `flat`
    (codes uint8, `ok` the bases allowed to vote, each sequence at
    starts[i] with lens[i] bases): (words (n, W), left, right (n,) uint8,
    4 = no vote, sequence index (n,))."""
    dev = flat.device
    T = flat.shape[0]
    P_all = T - k + 1
    seq_of = torch.repeat_interleave(torch.arange(lens.shape[0], device=dev), lens.to(torch.int64),
                                     output_size=T)
    parts = []
    for a in range(0, max(P_all, 0), CHUNK_POSITIONS):
        P = min(CHUNK_POSITIONS, P_all - a)
        p = torch.arange(a, a + P, device=dev)
        s = seq_of[p]
        rel = p - starts[s]
        valid = (rel >= 1) & (rel + k + 1 <= lens[s])
        pv = torch.nonzero(valid).squeeze(1)
        if pv.numel() == 0:
            continue
        seg = flat[a : a + P + k - 1]
        fwd = _pack_windows(seg, k, P, False)[pv]
        rc = _pack_windows(seg, k, P, True)[pv]
        key, was_rc = canonical(fwd, rc)
        del fwd, rc
        gp = pv + a

        def vote(q):
            b = flat[q]
            return torch.where(ok[q] & (b != N_CODE), b, N_CODE).to(torch.uint8)

        left, right = vote(gp - 1), vote(gp + k)
        comp = lambda x: torch.where(x == N_CODE, x, 3 - x).to(torch.uint8)  # noqa: E731
        left, right = (torch.where(was_rc, comp(right), left),
                       torch.where(was_rc, comp(left), right))
        parts.append((key, left, right, s[pv]))
    if not parts:
        W = n_words(k)
        z = torch.zeros(0, dtype=torch.uint8, device=dev)
        return (torch.zeros((0, W), dtype=torch.int64, device=dev), z, z,
                torch.zeros(0, dtype=torch.int64, device=dev))
    return tuple(torch.cat(x) for x in zip(*parts))


def ext_calls(votes: torch.Tensor, count: torch.Tensor, dmin_thres: int) -> torch.Tensor:
    """(n, 4) vote counts -> call per row: 0..3 a base, 4 F, 5 X."""
    dmin = torch.clamp(torch.floor((1.0 - 0.9) * count.to(torch.float64)).to(torch.int64),
                       min=dmin_thres)
    top2 = torch.topk(votes.to(torch.int64), 2, dim=1).values
    call = torch.argmax(votes.to(torch.int64), dim=1)
    call = torch.where(top2[:, 1] >= dmin, F_CALL, call)
    return torch.where(top2[:, 0] < dmin, X_CALL, call).to(torch.uint8)


def _seq_tensors(seqs, device):
    """Python strings or bytes -> flat codes, starts, lens."""
    lut = np.full(256, N_CODE, np.uint8)
    for i, ch in enumerate(b"ACGT"):
        lut[ch] = i
    blob = b"".join(s.encode() if isinstance(s, str) else s for s in seqs)
    lens = np.fromiter((len(s) for s in seqs), np.int64, len(seqs))
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]) if len(seqs) else lens
    flat = lut[np.frombuffer(blob, np.uint8)]
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)  # noqa: E731
    return t(flat), t(starts), t(lens)


def count_round(reads, contigs, k: int, dmin_thres: int = 2):
    """The purged table of one round. reads: (flat codes, flat quality ok,
    starts, lens); contigs: list of (seq, depth) from the round before.
    Returns (keys (T, W) in lexicographic order, count, left call, right
    call)."""
    flat, ok, starts, lens = reads
    dev = flat.device
    key, left, right, _ = occurrences(flat, ok, starts, lens, k)
    n_read = key.shape[0]
    ctgs = [(s, d) for s, d in contigs if len(s) >= k + 2]
    if ctgs:
        cflat, cst, cl = _seq_tensors([s for s, _ in ctgs], dev)
        ck, cleft, cright, cseq = occurrences(cflat, torch.ones_like(cflat, dtype=torch.bool),
                                              cst, cl, k)
        depth = torch.tensor([min(max(int(d), 0), MAX_COUNT) for _, d in ctgs],
                             dtype=torch.int64, device=dev)[cseq]
        key = torch.cat([key, ck])
        left = torch.cat([left, cleft])
        right = torch.cat([right, cright])
        del cflat, ck
    else:
        depth = torch.zeros(0, dtype=torch.int64, device=dev)
    n = key.shape[0]
    order = lex_order(key)
    key = key[order]
    left, right = left[order], right[order]
    is_read = order < n_read
    cdepth = torch.zeros(n, dtype=torch.int64, device=dev)
    cdepth[~is_read] = depth[order[~is_read] - n_read]
    del order
    new = torch.ones(n, dtype=torch.bool, device=dev)
    if n > 1:
        new[1:] = (key[1:] != key[:-1]).any(1)
    seg = torch.cumsum(new.to(torch.int64), 0) - 1
    U = int(seg[-1].item()) + 1 if n else 0
    ukeys = key[new]
    del key
    sr = seg[is_read]
    rcount = torch.bincount(sr, minlength=U)

    def votes(ext, rows):
        v = ext[rows].to(torch.int64)
        s = seg[rows]
        m = v < 4
        return torch.bincount(s[m] * 4 + v[m], minlength=4 * U).view(U, 4)

    rl = votes(left, is_read).clamp(max=MAX_COUNT)
    rr = votes(right, is_read).clamp(max=MAX_COUNT)
    rcount = rcount.clamp(max=MAX_COUNT)
    read_uu = ((rcount >= 2) & (ext_calls(rl, rcount, dmin_thres) < 4)
               & (ext_calls(rr, rcount, dmin_thres) < 4))
    is_ctg = ~is_read
    sc = seg[is_ctg]
    has_ctg = torch.zeros(U, dtype=torch.bool, device=dev)
    has_ctg[sc] = True
    lr = (left[is_ctg].to(torch.int64) * 8 + right[is_ctg].to(torch.int64))
    big = torch.iinfo(torch.int64).max
    lr_min = torch.full((U,), big, dtype=torch.int64, device=dev).scatter_reduce(
        0, sc, lr, "amin")
    lr_max = torch.full((U,), -1, dtype=torch.int64, device=dev).scatter_reduce(0, sc, lr, "amax")
    dmin_ctg = torch.full((U,), big, dtype=torch.int64, device=dev).scatter_reduce(
        0, sc, cdepth[is_ctg], "amin")
    use_ctg = has_ctg & ~read_uu
    ccount = torch.where(lr_min == lr_max, dmin_ctg, 0)
    cl = torch.zeros((U, 4), dtype=torch.int64, device=dev)
    cr = torch.zeros((U, 4), dtype=torch.int64, device=dev)
    rows = torch.nonzero(use_ctg & (lr_min == lr_max)).squeeze(1)
    lb, rb = lr_min[rows] // 8, lr_min[rows] % 8
    cl[rows[lb < 4], lb[lb < 4]] = ccount[rows[lb < 4]]
    cr[rows[rb < 4], rb[rb < 4]] = ccount[rows[rb < 4]]
    count = torch.where(use_ctg, ccount, rcount)
    lv = torch.where(use_ctg[:, None], cl, rl)
    rv = torch.where(use_ctg[:, None], cr, rr)
    lcall = ext_calls(lv, count, dmin_thres)
    rcall = ext_calls(rv, count, dmin_thres)
    keep = (count >= 2) & ~((lcall == X_CALL) & (rcall == X_CALL))
    return ukeys[keep], count[keep], lcall[keep], rcall[keep]


# -- traversal -----------------------------------------------------------------


def lookup(table: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Row of each query in the lexicographically sorted `table` (the last
    of equal rows), -1 where absent."""
    T, Q = table.shape[0], queries.shape[0]
    dev = table.device
    allk = torch.cat([table, queries])
    tag = torch.cat([torch.zeros(T, dtype=torch.int8, device=dev),
                     torch.ones(Q, dtype=torch.int8, device=dev)])
    order = lex_order(allk, tag)
    last_tab = torch.where(order < T, order, -1)
    last_tab = torch.cummax(last_tab, 0).values
    q_at = order >= T
    cand = last_tab[q_at]
    qi = order[q_at] - T
    hit = cand >= 0
    hit[hit.clone()] = (table[cand[hit]] == queries[qi[hit]]).all(1)
    out = torch.full((Q,), -1, dtype=torch.int64, device=dev)
    out[qi] = torch.where(hit, cand, -1)
    return out


def traverse(keys, count, lcall, rcall, k: int, depth_dtype=None):
    """Contigs (list of (seq, depth), sorted) of a purged table. depth_dtype
    "float32" divides in float32 instead (the check's control)."""
    dev = keys.device
    uu = (lcall < 4) & (rcall < 4)
    K = keys[uu]
    cnt = count[uu].clamp(max=MAX_COUNT)
    lc, rc_ = lcall[uu].to(torch.int64), rcall[uu].to(torch.int64)
    n = K.shape[0]
    if n == 0:
        return []
    first, last = base_at(K, 0), base_at(K, k - 1)
    b_key, b_rc, p_key, p_rc = [], [], [], []
    for r0 in range(0, n, ROW_CHUNK):
        codes = unpack_rows(K[r0 : r0 + ROW_CHUNK], k)
        for oriented, keys, rcs in (
                (torch.cat([codes[:, 1:], rc_[r0 : r0 + ROW_CHUNK, None].to(torch.uint8)], 1),
                 b_key, b_rc),
                (torch.cat([lc[r0 : r0 + ROW_CHUNK, None].to(torch.uint8), codes[:, :-1]], 1),
                 p_key, p_rc)):
            key, was_rc = canonical(pack_rows(oriented), pack_rows(3 - oriented.flip(1)))
            keys.append(key)
            rcs.append(was_rc)
        del codes
    b_key, b_rc, p_key, p_rc = (torch.cat(x) for x in (b_key, b_rc, p_key, p_rc))
    idx = lookup(K, torch.cat([b_key, p_key]))
    del b_key, p_key
    b_idx, p_idx = idx[:n], idx[n:]
    own = torch.arange(n, device=dev)
    bi = b_idx.clamp(min=0)
    b_left_or = torch.where(b_rc, 3 - rc_[bi], lc[bi])
    r_ok = (b_idx >= 0) & (b_left_or == first) & (b_idx != own)
    pi = p_idx.clamp(min=0)
    p_right_or = torch.where(p_rc, 3 - lc[pi], rc_[pi])
    l_ok = (p_idx >= 0) & (p_right_or == last) & (p_idx != own)
    # state 2i + 1 walks node i forward (leaves by its right side), 2i backward
    S = 2 * n
    succ = torch.full((S,), -1, dtype=torch.int64, device=dev)
    succ[1::2] = torch.where(r_ok, 2 * bi + (~b_rc).to(torch.int64), -1)
    succ[0::2] = torch.where(l_ok, 2 * pi + p_rc.to(torch.int64), -1)
    sid = torch.arange(S, device=dev)
    # states entered twice lose every in-edge, and each lost edge's mirror
    has = succ >= 0
    indeg = torch.bincount(succ[has], minlength=S)
    drop = has & (indeg[succ.clamp(min=0)] >= 2)
    dropped_src = sid[drop]
    mirror_src = succ[dropped_src] ^ 1
    succ[dropped_src] = -1
    hit = succ[mirror_src] == (dropped_src ^ 1)
    succ[mirror_src[hit]] = -1
    rounds = max(1, S.bit_length()) + 1
    # each state's terminal (path) or its cycle's least node (cycle)
    term = succ < 0
    nxt = torch.where(term, sid, succ)
    low = sid >> 1
    for _ in range(rounds):
        low = torch.minimum(low, low[nxt])
        nxt = nxt[nxt]
    on_cycle = ~term[nxt]
    # cut each cycle before its least node walked forward: that direction
    # becomes a path from the least node, the other stays a cycle
    succ = torch.where(on_cycle & (succ == 2 * low + 1), -1, succ)
    # distance to the terminal, and the terminal
    term = succ < 0
    nxt = torch.where(term, sid, succ)
    dist = (~term).to(torch.int64)
    for _ in range(rounds):
        dist = dist + dist[nxt]
        nxt = nxt[nxt]
    off_cycle = term[nxt]
    has_pred = torch.zeros(S, dtype=torch.bool, device=dev)
    has_pred[succ[succ >= 0]] = True
    # of a path's two directions, the one whose start is below the mirror of
    # its terminal; a cut cycle has one direction
    emit = off_cycle & ~has_pred & (on_cycle | (sid < (nxt ^ 1))) & (dist >= 2)
    starts = sid[emit]
    n_paths = starts.shape[0]
    if n_paths == 0:
        return []
    # every state's path: the registry at its terminal
    reg = torch.full((S,), -1, dtype=torch.int64, device=dev)
    reg[nxt[starts]] = torch.arange(n_paths, device=dev)
    path = torch.where(off_cycle, reg[nxt], -1)
    on = torch.nonzero(path >= 0).squeeze(1)
    path = path[on]
    pos = dist[starts][path] - dist[on]
    nodes = on >> 1
    fwd = (on & 1) == 1
    base = torch.where(fwd, last[nodes], 3 - first[nodes])
    plen = dist[starts] + 1
    clen = plen + (k - 1)
    off = torch.zeros(n_paths + 1, dtype=torch.int64, device=dev)
    off[1:] = torch.cumsum(clen, 0)
    total = int(off[-1].item())
    buf = torch.zeros(total, dtype=torch.int64, device=dev)
    buf[off[path] + (k - 1) + pos] = base
    head = unpack_rows(K[starts >> 1], k).to(torch.int64)
    head = torch.where(((starts & 1) == 1)[:, None], head, 3 - head.flip(1))
    buf[(off[:-1, None] + torch.arange(k, device=dev)).view(-1)] = head.view(-1)
    dsum = torch.zeros(n_paths, dtype=torch.int64, device=dev).index_add_(0, path, cnt[nodes])
    # canonical orientation: the lesser of the path and its reverse complement
    pid = torch.repeat_interleave(torch.arange(n_paths, device=dev), clen, output_size=total)
    j = torch.arange(total, device=dev)
    rc = 3 - buf[off[pid] + off[pid + 1] - 1 - j]
    firstdiff = torch.full((n_paths,), total, dtype=torch.int64, device=dev).scatter_reduce(
        0, pid, torch.where(buf != rc, j, total), "amin")
    at = firstdiff.clamp(max=total - 1)
    rc_less = (firstdiff < total) & (rc[at] < buf[at])
    text = torch.where(rc_less[pid], rc, buf)
    lut = torch.tensor(list(b"ACGT"), dtype=torch.uint8, device=dev)
    blob = lut[text].cpu().numpy().tobytes()
    offs = off.cpu().tolist()
    ds = dsum.cpu().tolist()
    den = [offs[p + 1] - offs[p] - k + 2 for p in range(n_paths)]
    if depth_dtype == "float32":
        dep = (np.array(ds, np.float32) / np.array(den, np.float32)).tolist()
    else:
        dep = [d / n for d, n in zip(ds, den)]
    out = [(blob[offs[p] : offs[p + 1]].decode(), dep[p]) for p in range(n_paths)]
    out.sort()
    return out


def assemble(reads, kmer_lens, dmin_thres: int = 2, depth_dtype=None, log=None):
    """Contigs of every round: {k: sorted list of (seq, depth)}. log, when
    given, receives a line a round."""
    import time

    contigs, rounds = [], {}
    for k in kmer_lens:
        t0 = time.perf_counter()
        table = count_round(reads, contigs, k, dmin_thres)
        n = table[0].shape[0]
        contigs = traverse(*table, k, depth_dtype=depth_dtype)
        del table
        rounds[k] = contigs
        if log:
            log(f"reference k={k}: {n} k-mers, {len(contigs)} contigs in "
                f"{time.perf_counter() - t0:.2f}s")
    return rounds
