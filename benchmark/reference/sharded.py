"""Plain-torch contigging under the rules of the sharded multi-rank branch.

What the program's `--hosts H --shards S` path writes, worked out again from
the reads. It counts and traverses as `reference/assemble.py` states it
(MetaHipMer2 contigging.cpp:93-158), whose functions it uses, and departs
from that module in these points only:

- Every path is rendered into a round's `contigs-<k>.fasta`, down to a path
  of one k-mer (k bases); assemble.py keeps contigs of >= k + 2 bases. The
  next round's counting takes contigs of >= k' + 2 bases, k' > k, so the
  paths that assemble.py drops never reach a later round or the final file.
- Contig ids number every path, in (sequence, depth) order over all of them.
- A cycle is cut at a node that the rank layout picks (the least (owner
  shard, row)), where assemble.py cuts it before its least k-mer: both
  render every node of the cycle once, so the two contigs are rotations of
  one circular sequence, on one strand or the other, with one depth. The
  comparison therefore gives every cyclic contig one canonical rotation
  over both strands (`canonical_cycle`), on both sides, and compares ids
  apart from the records (`id_faults`).
- Counting runs over `n_parts` key blocks, each block all k-mers whose
  canonical words hash to it, so that a card holds one block's
  occurrences, not all of them; each k-mer's count, votes and contig rule
  see only its own occurrences, so the table is the one assemble.py
  makes. The k-mer words are packed by doubling (log k steps a word), not
  base by base.

This module imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from .assemble import (BASES_PER_WORD, CHUNK_POSITIONS, MAX_COUNT, N_CODE, ROW_CHUNK, X_CALL,
                       _seq_tensors, base_at, canonical, ext_calls, lex_order, lookup, n_words,
                       pack_rows, unpack_rows)

HASH_MULT = -7046029254386353131  # 0x9E3779B97F4A7C15 as a signed int64


# -- packing -----------------------------------------------------------------


def _windows(x: torch.Tensor, n: int, little: bool, memo: dict) -> torch.Tensor:
    """(len(x) - n + 1,) int64: each window of n codes of x packed two bits
    a code, the first code in the highest bits (little: in the lowest);
    memo keeps the halves already made."""
    if n == 1:
        return x
    if n not in memo:
        a = n // 2
        lo, hi = _windows(x, a, little, memo), _windows(x, n - a, little, memo)
        m = x.shape[0] - n + 1
        memo[n] = (lo[:m] | (hi[a : a + m] << (2 * a)) if little
                   else (lo[:m] << (2 * (n - a))) | hi[a : a + m])
    return memo[n]


def pack_windows(codes: torch.Tensor, k: int, P: int):
    """(fwd, rc): (P, W) int64 words of the k-mers at positions 0 .. P-1 of
    a flat code array and of their reverse complements (N packed as G), as
    assemble.py's _pack_windows packs them."""
    c = torch.where(codes == N_CODE, 2, codes.to(torch.int64))[: P + k - 1]
    d = 3 - c
    W = n_words(k)
    fwd = torch.empty((P, W), dtype=torch.int64, device=codes.device)
    rc = torch.empty_like(fwd)
    big, little = {}, {}
    for w in range(W):
        nb = min(BASES_PER_WORD, k - BASES_PER_WORD * w)
        shift = 2 * (BASES_PER_WORD - nb)
        f0 = BASES_PER_WORD * w
        fwd[:, w] = _windows(c, nb, False, big)[f0 : f0 + P] << shift
        r0 = k - BASES_PER_WORD * w - nb
        rc[:, w] = _windows(d, nb, True, little)[r0 : r0 + P] << shift
    return fwd, rc


def key_part(words: torch.Tensor, n_parts: int) -> torch.Tensor:
    """The key block of each (n, W) k-mer: a hash of its words mod n_parts."""
    h = torch.zeros(words.shape[0], dtype=torch.int64, device=words.device)
    for w in range(words.shape[1]):
        h = (h ^ words[:, w]) * HASH_MULT
    return ((h >> 33) & 0x7FFFFFFF) % n_parts


def occurrences(flat, ok, starts, lens, k: int, part: int = 0, n_parts: int = 1):
    """assemble.py's occurrences of the k-mers in key block `part`:
    (words (n, W), left, right (n,) uint8, 4 = no vote, sequence index)."""
    dev = flat.device
    T = flat.shape[0]
    P_all = T - k + 1
    parts = []
    for a in range(0, max(P_all, 0), CHUNK_POSITIONS):
        P = min(CHUNK_POSITIONS, P_all - a)
        p = torch.arange(a, a + P, device=dev)
        s = torch.searchsorted(starts, p, right=True) - 1
        rel = p - starts[s]
        valid = (rel >= 1) & (rel + k + 1 <= lens[s])
        fwd, rc = pack_windows(flat[a : a + P + k - 1], k, P)
        key, was_rc = canonical(fwd, rc)
        del fwd, rc
        if n_parts > 1:
            valid &= key_part(key, n_parts) == part
        pv = torch.nonzero(valid).squeeze(1)
        if pv.numel() == 0:
            continue
        key, was_rc = key[pv], was_rc[pv]
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
        z = torch.zeros(0, dtype=torch.uint8, device=dev)
        return (torch.zeros((0, n_words(k)), dtype=torch.int64, device=dev), z, z,
                torch.zeros(0, dtype=torch.int64, device=dev))
    return tuple(torch.cat(x) for x in zip(*parts))


# -- counting -------------------------------------------------------------------


def count_part(reads, ctg_seqs, k: int, dmin_thres: int, part: int, n_parts: int):
    """assemble.py's count_round over the k-mers of key block `part`:
    (keys (T, W), count, left call, right call) of the block, unsorted
    across blocks. ctg_seqs: (flat codes, starts, lens, depths) of the
    contigs of >= k + 2 bases from the round before, or None."""
    flat, ok, starts, lens = reads
    dev = flat.device
    key, left, right, _ = occurrences(flat, ok, starts, lens, k, part, n_parts)
    n_read = key.shape[0]
    if ctg_seqs is not None:
        cflat, cst, cl, cdep = ctg_seqs
        ck, cleft, cright, cseq = occurrences(cflat, torch.ones_like(cflat, dtype=torch.bool),
                                              cst, cl, k, part, n_parts)
        depth = cdep[cseq]
        key = torch.cat([key, ck])
        left = torch.cat([left, cleft])
        right = torch.cat([right, cright])
        del ck
    else:
        depth = torch.zeros(0, dtype=torch.int64, device=dev)
    n = key.shape[0]
    if n == 0:
        z = torch.zeros(0, dtype=torch.int64, device=dev)
        return key, z, z.to(torch.uint8), z.to(torch.uint8)
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
    U = int(seg[-1].item()) + 1
    ukeys = key[new]
    del key

    def votes(ext, rows):
        v = ext[rows].to(torch.int64)
        s = seg[rows]
        m = v < 4
        return torch.bincount(s[m] * 4 + v[m], minlength=4 * U).view(U, 4)

    rcount = torch.bincount(seg[is_read], minlength=U).clamp(max=MAX_COUNT)
    rl = votes(left, is_read).clamp(max=MAX_COUNT)
    rr = votes(right, is_read).clamp(max=MAX_COUNT)
    read_uu = ((rcount >= 2) & (ext_calls(rl, rcount, dmin_thres) < 4)
               & (ext_calls(rr, rcount, dmin_thres) < 4))
    is_ctg = ~is_read
    sc = seg[is_ctg]
    has_ctg = torch.zeros(U, dtype=torch.bool, device=dev)
    has_ctg[sc] = True
    lr = left[is_ctg].to(torch.int64) * 8 + right[is_ctg].to(torch.int64)
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


def count_round(reads, contigs, k: int, dmin_thres: int = 2, n_parts: int = 1):
    """The purged table of one round, in lexicographic key order, counted
    over n_parts key blocks (the table of assemble.py's count_round)."""
    dev = reads[0].device
    ctgs = [(s, d) for s, d in contigs if len(s) >= k + 2]
    ctg_seqs = None
    if ctgs:
        cflat, cst, cl = _seq_tensors([s for s, _ in ctgs], dev)
        cdep = torch.tensor([min(max(int(d), 0), MAX_COUNT) for _, d in ctgs],
                            dtype=torch.int64, device=dev)
        ctg_seqs = (cflat, cst, cl, cdep)
    blocks = [count_part(reads, ctg_seqs, k, dmin_thres, p, n_parts) for p in range(n_parts)]
    keys, count, lcall, rcall = (torch.cat(x) for x in zip(*blocks))
    del blocks
    order = lex_order(keys)
    return keys[order], count[order], lcall[order], rcall[order]


# -- traversal -------------------------------------------------------------------


def traverse(keys, count, lcall, rcall, k: int, depth_dtype=None):
    """Every path and cycle of a purged table: list of (seq, depth), sorted.
    assemble.py's traverse without its >= k + 2 bases bound; depth_dtype
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
    S = 2 * n
    succ = torch.full((S,), -1, dtype=torch.int64, device=dev)
    succ[1::2] = torch.where(r_ok, 2 * bi + (~b_rc).to(torch.int64), -1)
    succ[0::2] = torch.where(l_ok, 2 * pi + p_rc.to(torch.int64), -1)
    sid = torch.arange(S, device=dev)
    has = succ >= 0
    indeg = torch.bincount(succ[has], minlength=S)
    drop = has & (indeg[succ.clamp(min=0)] >= 2)
    dropped_src = sid[drop]
    mirror_src = succ[dropped_src] ^ 1
    succ[dropped_src] = -1
    hit = succ[mirror_src] == (dropped_src ^ 1)
    succ[mirror_src[hit]] = -1
    rounds = max(1, S.bit_length()) + 1
    term = succ < 0
    nxt = torch.where(term, sid, succ)
    low = sid >> 1
    for _ in range(rounds):
        low = torch.minimum(low, low[nxt])
        nxt = nxt[nxt]
    on_cycle = ~term[nxt]
    succ = torch.where(on_cycle & (succ == 2 * low + 1), -1, succ)
    term = succ < 0
    nxt = torch.where(term, sid, succ)
    dist = (~term).to(torch.int64)
    for _ in range(rounds):
        dist = dist + dist[nxt]
        nxt = nxt[nxt]
    off_cycle = term[nxt]
    has_pred = torch.zeros(S, dtype=torch.bool, device=dev)
    has_pred[succ[succ >= 0]] = True
    # every path: one of its two directions; a cut cycle has one
    emit = off_cycle & ~has_pred & (on_cycle | (sid < (nxt ^ 1)))
    starts = sid[emit]
    n_paths = starts.shape[0]
    if n_paths == 0:
        return []
    reg = torch.full((S,), -1, dtype=torch.int64, device=dev)
    reg[nxt[starts]] = torch.arange(n_paths, device=dev)
    path = torch.where(off_cycle, reg[nxt], -1)
    on = torch.nonzero(path >= 0).squeeze(1)
    path = path[on]
    pos = dist[starts][path] - dist[on]
    nodes = on >> 1
    fwd = (on & 1) == 1
    base = torch.where(fwd, last[nodes], 3 - first[nodes])
    clen = dist[starts] + k
    off = torch.zeros(n_paths + 1, dtype=torch.int64, device=dev)
    off[1:] = torch.cumsum(clen, 0)
    total = int(off[-1].item())
    buf = torch.zeros(total, dtype=torch.int64, device=dev)
    buf[off[path] + (k - 1) + pos] = base
    head = unpack_rows(K[starts >> 1], k).to(torch.int64)
    head = torch.where(((starts & 1) == 1)[:, None], head, 3 - head.flip(1))
    buf[(off[:-1, None] + torch.arange(k, device=dev)).view(-1)] = head.view(-1)
    dsum = torch.zeros(n_paths, dtype=torch.int64, device=dev).index_add_(0, path, cnt[nodes])
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


def assemble(reads, kmer_lens, dmin_thres: int = 2, n_parts=1, depth_dtype=None, log=None):
    """Every round's contigs under the sharded rules: {k: sorted list of
    (seq, depth)}, every path of each round. n_parts: the key blocks of
    every round, or a function of k that gives them."""
    import time

    contigs, rounds = [], {}
    for k in kmer_lens:
        t0 = time.perf_counter()
        parts = n_parts(k) if callable(n_parts) else n_parts
        table = count_round(reads, contigs, k, dmin_thres, parts)
        n = table[0].shape[0]
        contigs = traverse(*table, k, depth_dtype=depth_dtype)
        del table
        rounds[k] = contigs
        if log:
            log(f"reference (sharded rules) k={k}: {n} k-mers, {len(contigs)} paths in "
                f"{time.perf_counter() - t0:.2f}s ({parts} key blocks)")
    return rounds


# -- the comparison's rules --------------------------------------------------------

_COMP = str.maketrans("ACGT", "TGCA")


def _least_rotation(s: str) -> int:
    """The start of s's lexicographically least rotation (Booth, O(len s))."""
    t = s + s
    f = [-1] * len(t)
    k = 0
    for j in range(1, len(t)):
        c = t[j]
        i = f[j - k - 1]
        while i != -1 and c != t[k + i + 1]:
            if c < t[k + i + 1]:
                k = j - i - 1
            i = f[i]
        if c != t[k + i + 1]:
            if c < t[k]:
                k = j
            f[j - k] = -1
        else:
            f[j - k] = i + 1
    return k


def is_cycle(seq: str, k: int) -> bool:
    """A contig of n >= 2 k-mers whose last k-mer leads back to its first:
    its last k - 1 bases are its first k - 1."""
    n = len(seq) - (k - 1)
    return n >= 2 and seq[n:] == seq[: k - 1]


def canonical_cycle(seq: str, k: int) -> str:
    """A cyclic contig as the least rotation of its circular sequence over
    both strands, written out as a contig (the circle, then its first
    k - 1 bases again); any other contig unchanged."""
    if not is_cycle(seq, k):
        return seq
    n = len(seq) - (k - 1)
    best = None
    for circ in (seq[:n], seq[:n].translate(_COMP)[::-1]):
        r = _least_rotation(circ)
        rot = circ[r:] + circ[:r]
        best = rot if best is None or rot < best else best
    reps = -(-(n + k - 1) // n)
    return (best * reps)[: n + k - 1]


def parse_records(records: list[str]) -> list[tuple[int, str, str]]:
    """FASTA records `>Contig<id> <depth>\\n<seq>\\n` -> (id, depth text, seq)."""
    out = []
    for r in records:
        head, _, seq = r[1:].partition("\n")
        name, _, depth = head.partition(" ")
        out.append((int(name[len("Contig"):]), depth, seq.strip()))
    return out


def rotated(records, k: int) -> list[str]:
    """Each (id, depth, seq) record as `depth seq`, a cycle by its canonical
    rotation: what both sides are compared by."""
    return [f"{d} {canonical_cycle(s, k)}" for _, d, s in records]


def id_faults(records) -> int:
    """Records of a round's file out of place: ids are 0, 1, ... in the
    file's order, and the records sorted by (sequence, depth)."""
    bad = sum(i != r[0] for i, r in enumerate(records))
    keys = [(s, float(d)) for _, d, s in records]
    return bad + sum(b < a for a, b in zip(keys, keys[1:]))


def expected_records(contigs) -> list[tuple[int, str, str]]:
    """The reference's contigs as (id, depth text, seq), ids over every path."""
    return [(i, f"{d}", s) for i, (s, d) in enumerate(contigs)]
