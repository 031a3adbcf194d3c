"""Sort + segmented-reduce k-mer counting (port of mhm2_proxy_tpu/ops/count.py:
the raw runs and the split runs they collapse into).

Each read block becomes ONE sorted raw run (extract kernel + lexsort): the
packed layout folds the 7-bit payload into the last key lane's free bits
(k = 21, 33, 55, 99); k = 63, 77 carry it in a separate lane. The runs merge
in a balanced tree (sort kernel), and one finalize pass (the finalize
kernel, which also compacts) turns the merged run into the final table or,
for rounds with contigs, the unique aggregate. Past the store's byte budget
a merged raw run instead collapses into a deduped split run (scan kernel +
3-class compaction): a multi part (count >= 2, full sums) and a singleton part
(count == 1, its two ext codes in one byte), the reference's GQF analog
(kcount-gpu/gqf.hpp:358-378). Split runs merge four parts at a time
(merge_split4) and fold into the final table in one pass (final_fold_runs).
Counts and extension sums clamp at the u16 ceiling at every merge and fold,
which equals the reference's saturating accumulation (kcount_cpu.cpp:152-155).
The sharded counter (parallel/sharded.py) takes each record's target shard
from the minimizer kernel (read_kmer_records' `target`); its receivers
aggregate raw records (aggregate_records: lexsort, scan, compact), split
them (split_run) and merge split runs (merge_split4) and deduped runs
(merge_aggregates: the sort kernel and a bounded dedup).

u32 lanes are int32 tensors (ops/u32.py). Table words are (N, W) int32;
group sums are tuples of nine (N,) int32 lanes (count, left one-hots 0-3,
right one-hots 0-3).
"""

from __future__ import annotations

import torch

from ..constants import EXT_NONE, EXT_X, MAX_KMER_COUNT, minimizer_len_for_k, words32_for_k
from .compact import compact_lanes, words_layout
from .extract import extract_packed_lanes, extract_record_lanes
from .finalize import get_ext_calls as _get_ext_calls
from .finalize import scan_purge_compact
from .minimizer import minimizer_targets
from .scan import group_sums_scan_lanes, group_sums_scan_packed
from .sort import merge_sorted_lanes
from .u32 import ONES, lexsort_lanes, narrow, rows_equal_next, u32, widen


def minimizer_shard_targets(codes, k: int, m: int, n_shards: int):
    """(B, L) codes -> (B, P) int32 target shards, quick_hash(minimizer) %
    n_shards (minimizer kernel); all zeros with no launch for one shard."""
    if n_shards == 1:
        B, L = codes.shape
        return torch.zeros((B, L - k + 1), dtype=torch.int32, device=codes.device)
    return minimizer_targets(codes, k, m, n_shards)


def read_kmer_records(codes, qual_ok, lens, k: int, depth=None, n_shards: int = 1):
    """Count records of a block of sequences (reference process_seq +
    get_kmers_and_exts, kcount_cpu.cpp:84-101, 307-335), through the extract
    kernel's record layout.

    codes (B, L) uint8, qual_ok (B, L) bool, lens (B,) int32, depth optional
    (B,) int32 per-sequence count (contig pass). Returns a dict of (B*P,)
    arrays: words (B*P, W) int32 (all-ones on invalid rows), left / right
    uint8 ext codes (0 on invalid rows), count int32, valid bool, target
    int32 (the owner shard of each k-mer among n_shards, kmer_dht.cpp:193-196)."""
    lanes, pay = extract_record_lanes(codes, qual_ok, lens, k)
    B, L = codes.shape
    P = L - k + 1
    words = torch.stack(lanes, dim=-1)
    valid = pay != 0
    cnt, left, right = _unpack_cnt_ext(pay)
    if depth is not None:
        d = torch.clamp(depth.to(torch.int32), 0, MAX_KMER_COUNT)
        cnt = cnt * d[:, None].expand(B, P).reshape(-1)
    target = minimizer_shard_targets(codes, k, minimizer_len_for_k(k), n_shards).reshape(-1)
    return dict(words=words, left=left, right=right, count=cnt, valid=valid, target=target)


def _sentinelize(words, valid):
    """Overwrite invalid rows with the all-ones empty-key sentinel
    (reference KEY_EMPTY, kcount_cpu.cpp:217,227)."""
    return torch.where(valid[..., None], words, ONES)


def _pack_cnt_ext(count, left, right):
    """count (<= 0xFFFF) | left << 16 | right << 24 in one u32 lane."""
    c = torch.clamp(count.to(torch.int64), 0, MAX_KMER_COUNT)
    return narrow(c | (left.to(torch.int64) << 16) | (right.to(torch.int64) << 24))


def _unpack_cnt_ext(p):
    p = widen(p)
    return (
        (p & 0xFFFF).to(torch.int32),
        ((p >> 16) & 0xFF).to(torch.uint8),
        (p >> 24).to(torch.uint8),
    )


def _pack_sums(count, l4, r4):
    """(count, (N,4) l4, (N,4) r4), each value <= 0xFFFF -> 5 u32 lanes."""
    l = l4.to(torch.int64)
    r = r4.to(torch.int64)
    return (
        narrow(torch.clamp(count.to(torch.int64), 0, MAX_KMER_COUNT)),
        narrow(l[:, 0] | (l[:, 1] << 16)),
        narrow(l[:, 2] | (l[:, 3] << 16)),
        narrow(r[:, 0] | (r[:, 1] << 16)),
        narrow(r[:, 2] | (r[:, 3] << 16)),
    )


def _unpack_sums(c, l01, l23, r01, r23):
    lo = lambda x: (widen(x) & 0xFFFF).to(torch.int32)  # noqa: E731
    hi = lambda x: (widen(x) >> 16).to(torch.int32)  # noqa: E731
    l4 = torch.stack([lo(l01), hi(l01), lo(l23), hi(l23)], dim=-1)
    r4 = torch.stack([lo(r01), hi(r01), lo(r23), hi(r23)], dim=-1)
    return c.to(torch.int32), l4, r4


def _compact_keep(words, keep, payload):
    """Stable compaction of keep-flagged rows to a dense prefix (compact
    kernel; words read and written as (N, W)). Returns (words (N, W) with
    all-ones tail, *payload lanes with zero tails, n_keep 0-dim int32)."""
    W = words.shape[1]
    layout, fills = words_layout(W, len(payload))
    (out,), counts = compact_lanes(_lanes(words) + tuple(payload), keep, 2, (0,), (layout,),
                                   (fills,))
    return out + (counts[0],)


def trim_rows(n: int, floor: int = 256) -> int:
    """Half-octave row count: smallest 2^k or 3*2^(k-1) >= n."""
    n = max(int(n), 1)
    p = 1 << (n - 1).bit_length()
    half_octave = 3 * (p // 4)
    if p >= 4 and n <= half_octave:
        return max(floor, half_octave)
    return max(floor, p)


def payload_fits_in_keys(k: int, W: int) -> bool:
    """True when the 7-bit read payload (valid + two 3-bit ext codes) fits
    the free low bits of the last non-zero key lane: k=21/33/55/99 qualify;
    k=63/77 need the separate payload lane."""
    weff = -(-2 * k // 32)
    return weff <= W and 32 * weff - 2 * k >= 7


def block_to_raw_run(codes, qual_ok, lens, k: int):
    """Read block -> ONE sorted packed run: ceil(2k/32) int32 lanes, the
    7-bit payload in the last lane's free bits, all-ones sentinel rows at
    the tail. Requires payload_fits_in_keys(k, words32_for_k(k))."""
    return lexsort_lanes(extract_packed_lanes(codes, qual_ok, lens, k))


def block_to_raw_run_sep(codes, qual_ok, lens, k: int):
    """block_to_raw_run for k whose payload does not fit the key bits
    (k = 63, 77): ceil(2k/32) key lanes + one _pack_cnt_ext payload lane
    (count 1 | left << 16 | right << 24; 0 on sentinel rows), sorted by the
    key lanes only (the extract kernel's record layout + a key lexsort)."""
    weff = -(-2 * k // 32)
    lanes, pay = extract_record_lanes(codes, qual_ok, lens, k)
    return lexsort_lanes(tuple(lanes[:weff]) + (pay,), weff)


def _merge_tree(level: list, merge):
    """Balanced pairwise merge tree: an odd run out waits for the next level.
    Each pair is released once merged, so the caching allocator reuses it."""
    while len(level) > 1:
        nxt = []
        for i in range(0, len(level) - 1, 2):
            nxt.append(merge(level[i], level[i + 1]))
            level[i] = level[i + 1] = None
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
    return level[0]


def merge_raw_runs(runs: list, kw: int | None = None):
    """Merge sorted raw runs -> one sorted tuple of lanes (sort kernel, in a
    balanced tree). kw = leading key lanes (default all: the packed layout;
    the separate-payload layout passes len - 1). Consumes `runs`: the list
    is emptied."""
    level = [tuple(r) for r in runs]
    runs.clear()
    kw = len(level[0]) if kw is None else kw
    return _merge_tree(level, lambda a, b: merge_sorted_lanes(a, b, kw))


def _final_table(out, purge: bool):
    """scan_purge_compact's (words, payload lanes, n) -> the final table
    (purge: words, count, left, right, n_kept) or the unique aggregate (no
    purge: words, count, l4, r4, n_unique)."""
    words, *pays, n = out
    if purge:
        return (words,) + _unpack_cnt_ext(pays[0]) + (n,)
    return (words,) + _unpack_sums(*pays) + (n,)


def final_from_sorted_packed(sorted_lanes, k: int, W: int, dmin_thres: int = 2,
                             purge: bool = True):
    """ONE finalize pass (the finalize kernel: group sums, purge and
    compaction) from a merged sorted packed run to the final table
    (purge=True: (words, count, left, right, n_kept) applying the reference
    purge rules kcount_cpu.cpp:497-517) or the unique aggregate
    (purge=False: (words, count, l4, r4, n_unique) for the ctg rules)."""
    return _final_table(scan_purge_compact(sorted_lanes, k, W, dmin_thres, purge), purge)


def final_from_sorted_sep(sorted_lanes, k: int, W: int, dmin_thres: int = 2,
                          purge: bool = True):
    """final_from_sorted_packed for the separate-payload layout
    (block_to_raw_run_sep): weff key lanes + the payload lane."""
    keys, pay = tuple(sorted_lanes[:-1]), sorted_lanes[-1]
    return _final_table(scan_purge_compact(keys, k, W, dmin_thres, purge, pay=pay), purge)


def finalize_table(u_words, u_count, u_l4, u_r4, n_unique, dmin_thres: int = 2):
    """Clamp counts, call extensions, purge (count < 2, or both calls X;
    reference kcount_cpu.cpp:497-517) and compact the final table.
    Returns (words, count int32, left uint8, right uint8, n_kept)."""
    N = u_words.shape[0]
    count = torch.clamp(u_count.to(torch.int64), max=MAX_KMER_COUNT)
    l4 = torch.clamp(u_l4.to(torch.int64), max=MAX_KMER_COUNT)
    r4 = torch.clamp(u_r4.to(torch.int64), max=MAX_KMER_COUNT)
    left = _get_ext_calls(l4, count, dmin_thres)
    right = _get_ext_calls(r4, count, dmin_thres)
    row_valid = torch.arange(N, device=u_words.device) < n_unique
    keep = row_valid & (count >= 2) & ~((left == EXT_X) & (right == EXT_X))
    w_s, pay, n_kept = _compact_keep(u_words, keep, (_pack_cnt_ext(count, left, right),))
    cnt_s, left_s, right_s = _unpack_cnt_ext(pay)
    return w_s, cnt_s, left_s, right_s, n_kept


# ---------------------------------------------------------------------------
# group sums over sorted (words, count, l4, r4) rows
# ---------------------------------------------------------------------------


def _lanes(words):
    """(N, W) words -> its W columns as (N,) views (the sort and compact
    kernels read them in place)."""
    return tuple(words[:, i] for i in range(words.shape[1]))


def _ends(words):
    """(is_start, is_last, is_sent) of lexsorted (N, W) rows."""
    N = words.shape[0]
    neq = ~rows_equal_next(tuple(words[:, i] for i in range(words.shape[1])))
    one = torch.ones((1,), dtype=torch.bool, device=words.device)
    is_sent = (words == ONES).all(dim=-1)
    return torch.cat([one, neq])[:N], torch.cat([neq, one])[:N], is_sent


def _sum_lanes(count, l4, r4):
    """(9, N) int32: count, l4 and r4 as contiguous lanes."""
    return torch.cat([count[None].to(torch.int32), l4.T.to(torch.int32), r4.T.to(torch.int32)])


def _ext_onehot(ext, count):
    """(N,) ext codes + counts -> (N, 4) int32 one-hot counts; codes >= 4 ignored."""
    hot = ext.to(torch.int64)[:, None] == torch.arange(4, device=ext.device)[None, :]
    return hot.to(torch.int32) * count.to(torch.int32)[:, None]


def _group_sums_scan(words, count, l4, r4):
    """Per-group payload sums of lexsorted rows (scan kernel), valid at
    group-last rows. Returns (sums: 9 (N,) int32 lanes clamped to the u16
    ceiling, is_last, is_sent)."""
    is_start, is_last, is_sent = _ends(words)
    pay = _sum_lanes(count, l4, r4)
    sums = group_sums_scan_lanes(tuple(pay[i] for i in range(9)), is_start, MAX_KMER_COUNT)
    return sums, is_last, is_sent


def _group_sums_bounded(words, count, l4, r4, mult: int):
    """_group_sums_scan for rows whose key multiplicity is bounded by `mult`
    (merges of deduped runs): ceil(log2(mult)) masked shift-adds. Sums are
    exact in int32 (<= mult * 0xFFFF) before the clamp."""
    pay = _sum_lanes(count, l4, r4)
    d = 1
    while d < mult and d < pay.shape[1]:
        same = (words[d:] == words[:-d]).all(dim=-1)
        pay[:, d:] += torch.where(same, pay[:, :-d], 0)
        d *= 2
    _is_start, is_last, is_sent = _ends(words)
    pay = torch.clamp(pay, max=MAX_KMER_COUNT)
    return tuple(pay[i] for i in range(9)), is_last, is_sent


# ---------------------------------------------------------------------------
# split runs: (m_words, m_count, m_l4, m_r4, n_multi, s_words, s_ext, n_single)
# both parts lexsorted dense prefixes with all-ones tails; s_ext packs
# left | right << 4 in one uint8
# ---------------------------------------------------------------------------


def _ext_code_of(c4, valid):
    """(N, 4) one-hot ext counts of count-1 rows -> uint8 code (0-3 or EXT_NONE)."""
    has = c4.sum(dim=-1) == 1
    code = torch.argmax(c4, dim=-1)
    return torch.where(valid & has, code, EXT_NONE).to(torch.uint8)


def expand_singles(s_words, s_ext, n_single):
    """Compact singleton rows -> full (words, count, l4, r4) format."""
    N = s_words.shape[0]
    valid = torch.arange(N, device=s_words.device) < n_single
    e = s_ext.to(torch.int64)
    cnt = valid.to(torch.int32)
    return s_words, cnt, _ext_onehot(e & 0xF, cnt), _ext_onehot(e >> 4, cnt)


def _split_emit(words, p, keep_m, keep_s):
    """3-class split compaction (compact kernel): (words, the 5 packed sum
    lanes, class flags) -> split run. p[0] already carries the singleton ext
    code in its upper 16 bits on keep_s rows. Multis write W + 5 lanes,
    singles only the words and the (count | ext) lane."""
    W = words.shape[1]
    flags = torch.where(keep_m, 0, torch.where(keep_s, 1, 2)).to(torch.int32)
    (m_lay, m_fill), (s_lay, s_fill) = words_layout(W, 5), words_layout(W, 1)
    (m_out, s_out), counts = compact_lanes(_lanes(words) + tuple(p), flags, 3, (0, 1),
                                           (m_lay, s_lay), (m_fill, s_fill))
    m_words, m_p0, *m_p = m_out
    m_count, m_l4, m_r4 = _unpack_sums(m_p0 & 0xFFFF, *m_p)
    s_words, s_p0 = s_out
    s_ext = ((s_p0 >> 16) & 0xFF).to(torch.uint8)
    return m_words, m_count, m_l4, m_r4, counts[0], s_words, s_ext, counts[1]


def _split_from_packed_sums(words, p, is_last, is_sent):
    """_split_from_scanned taking the 5 packed group-sum lanes of the packed
    scan (no nine-lane sums)."""
    p0, p1, p2, p3, p4 = p
    cnt = p0 & 0xFFFF
    keep_m = is_last & ~is_sent & (cnt >= 2)
    keep_s = is_last & ~is_sent & (cnt == 1)
    lo = lambda x: x & 0xFFFF  # noqa: E731
    hi = lambda x: (x >> 16) & 0xFFFF  # noqa: E731

    def _code(a, b):
        # singleton rows have 0/1 ext fields; exactly one set -> its code
        f0, f1, f2, f3 = lo(a), hi(a), lo(b), hi(b)
        has = (f0 + f1 + f2 + f3) == 1
        return torch.where(keep_s & has, f1 + 2 * f2 + 3 * f3, EXT_NONE)

    ext = _code(p1, p2) | (_code(p3, p4) << 4)
    p0 = p0 | torch.where(keep_s, ext << 16, 0).to(torch.int32)
    return _split_emit(words, (p0, p1, p2, p3, p4), keep_m, keep_s)


def _split_live(words, cnt, l4, r4, live):
    """Split the live rows by count: ONE 3-class compaction (multi, single,
    dead). The singleton ext code rides the free upper 16 bits of the count
    lane (singles have count 1)."""
    keep_m = live & (cnt >= 2)
    keep_s = live & (cnt == 1)
    ext = _ext_code_of(l4, keep_s).to(torch.int64) | (_ext_code_of(r4, keep_s).to(torch.int64) << 4)
    p0, p1, p2, p3, p4 = _pack_sums(cnt, l4, r4)
    p0 = p0 | torch.where(keep_s, ext << 16, 0).to(torch.int32)
    return _split_emit(words, (p0, p1, p2, p3, p4), keep_m, keep_s)


def _split_from_scanned(words, sums, is_last, is_sent):
    """Compact scanned lexsorted rows (group sums at group-last rows)
    straight into a split run."""
    return _split_live(words, sums[0], torch.stack(sums[1:5], dim=1),
                       torch.stack(sums[5:9], dim=1), is_last & ~is_sent)


def split_run(words, count, l4, r4, n_unique):
    """Split a deduped run (its n_unique rows a lexsorted dense prefix) into
    (multi, compact-singleton) parts."""
    live = torch.arange(words.shape[0], device=words.device) < n_unique
    return _split_live(words, count, l4, r4, live)


def pow2_rows(n: int, floor: int = 256) -> int:
    """Power-of-two row count to slice a run to (the sharded LSM's trim)."""
    return max(floor, 1 << (max(int(n), 1) - 1).bit_length())


def _raw_words(key_lanes, sent, W: int):
    """(N, W) words of a raw run's key lanes: the zero lanes past weff,
    all-ones on sentinel rows."""
    zero_lane = torch.where(sent, ONES, 0).to(torch.int32)
    return torch.stack(tuple(key_lanes) + (zero_lane,) * (W - len(key_lanes)), dim=-1)


def split_from_sorted_packed(sorted_lanes, k: int, W: int):
    """A merged sorted packed raw run -> one split run (the collapse past the
    raw byte budget): the packed scan kernel, then the 3-class split."""
    weff = len(sorted_lanes)
    free = 32 * weff - 2 * k
    keymask = 0xFFFFFFFF ^ ((1 << free) - 1)
    skey = sorted_lanes[-1] & u32(keymask)
    sent = skey == u32(keymask)
    for x in sorted_lanes[:-1]:
        sent = sent & (x == ONES)
    clean_last = torch.where(sent, ONES, skey)
    w = _raw_words(tuple(sorted_lanes[:-1]) + (clean_last,), sent, W)
    p = group_sums_scan_packed(sorted_lanes, keymask, MAX_KMER_COUNT)
    _is_start, is_last, _is_sent = _ends(w)
    return _split_from_packed_sums(w, p, is_last, sent)


def split_from_sorted_sep(sorted_lanes, k: int, W: int):
    """split_from_sorted_packed for a key-sorted separate-payload raw run
    (k = 63, 77): unpacked one-hots through the lanes scan kernel."""
    keys, pay = tuple(sorted_lanes[:-1]), sorted_lanes[-1]
    cnt, left, right = _unpack_cnt_ext(pay)
    w = _raw_words(keys, cnt == 0, W)
    sums, is_last, is_sent = _group_sums_scan(w, cnt, _ext_onehot(left, cnt),
                                              _ext_onehot(right, cnt))
    return _split_from_scanned(w, sums, is_last, is_sent)


def _merge_sorted_sets(a, b):
    """Merge two sorted (words, count, l4, r4) sets (sort kernel over the W
    key lanes + the 5 packed sum lanes) -> sorted (words, count, l4, r4)."""
    W = a[0].shape[1]
    lanes = lambda x: _lanes(x[0]) + _pack_sums(*x[1:4])  # noqa: E731
    words, *sums = merge_sorted_lanes(lanes(a), lanes(b), W, as_words=True)
    return (words,) + _unpack_sums(*sums)


def _dedup_keep(words, sums, is_last, is_sent):
    """Compact the group-last rows' sums of lexsorted rows to a dense prefix:
    (words, count, l4, r4, n_unique)."""
    packed = _pack_sums(sums[0], torch.stack(sums[1:5], dim=1), torch.stack(sums[5:9], dim=1))
    u_words, *pays, n_unique = _compact_keep(words, is_last & ~is_sent, packed)
    return (u_words,) + _unpack_sums(*pays) + (n_unique,)


def _dedup_sorted(words, count, l4, r4):
    """Segment-reduce equal adjacent keys of lexsorted rows (scan kernel, then
    compact kernel): unique rows in a dense prefix, sums clamped at the u16
    ceiling (reference kcount_cpu.cpp:152-155). Returns (words, count, l4,
    r4, n_unique) of the input's row count."""
    return _dedup_keep(words, *_group_sums_scan(words, count, l4, r4))


def _dedup_sorted_bounded(words, count, l4, r4, mult: int):
    """_dedup_sorted for rows whose key multiplicity is at most `mult`
    (merges of deduped runs): masked shift-adds instead of the scan."""
    return _dedup_keep(words, *_group_sums_bounded(words, count, l4, r4, mult))


def aggregate_records(words, left, right, count, valid):
    """Raw count records -> a deduped sorted partial table (words, count,
    l4, r4, n_unique): one stable lexsort of the words carrying the packed
    count | left << 16 | right << 24 lane, the one-hots expanded after it,
    then _dedup_sorted."""
    w = _sentinelize(words, valid)
    cnt = torch.where(valid, count, 0).to(torch.int32)
    W = w.shape[1]
    out = lexsort_lanes(_lanes(w) + (_pack_cnt_ext(cnt, left, right),), W)
    cnt, left_s, right_s = _unpack_cnt_ext(out[W])
    return _dedup_sorted(torch.stack(out[:W], dim=-1), cnt, _ext_onehot(left_s, cnt),
                         _ext_onehot(right_s, cnt))


def merge_aggregates(a_words, a_count, a_l4, a_r4, b_words, b_count, b_l4, b_r4):
    """Merge two deduped partial tables (sort kernel + bounded dedup)."""
    w, cnt, l4, r4 = _merge_sorted_sets((a_words, a_count, a_l4, a_r4),
                                        (b_words, b_count, b_l4, b_r4))
    return _dedup_sorted_bounded(w, cnt, l4, r4, mult=2)


def merge_split4(a, b, c, d):
    """Merge four sorted deduped (words, count, l4, r4) sets straight into a
    split run (key multiplicity <= 4: bounded group sums)."""
    ab = _merge_sorted_sets(a[:4], b[:4])
    cd = _merge_sorted_sets(c[:4], d[:4])
    w, cnt, l4, r4 = _merge_sorted_sets(ab, cd)
    del ab, cd
    sums, is_last, is_sent = _group_sums_bounded(w, cnt, l4, r4, mult=4)
    return _split_from_scanned(w, sums, is_last, is_sent)


def final_fold_runs(runs, dmin_thres: int = 2, purge: bool = True):
    """Fold split runs straight into the final table (purge: (words, count,
    left, right, n_kept), reference purge rules kcount_cpu.cpp:497-517) or
    the unique aggregate (no purge: (words, count, l4, r4, n_unique)): each
    run's parts (singles expanded) merge in a balanced tree without
    intermediate dedups, then ONE group-sums scan and ONE compaction."""
    leaves = []
    for r in runs:
        leaves.append(tuple(r[:4]))
        leaves.append(expand_singles(r[5], r[6], r[7]))
    w, cnt, l4, r4 = _merge_tree(leaves, _merge_sorted_sets)
    sums, is_last, is_sent = _group_sums_scan(w, cnt, l4, r4)
    if not purge:
        return _dedup_keep(w, sums, is_last, is_sent)
    count = sums[0]
    l4, r4 = torch.stack(sums[1:5], dim=1), torch.stack(sums[5:9], dim=1)
    left = _get_ext_calls(l4, count, dmin_thres)
    right = _get_ext_calls(r4, count, dmin_thres)
    keep = is_last & ~is_sent & (count >= 2) & ~((left == EXT_X) & (right == EXT_X))
    w_s, pay, n_kept = _compact_keep(w, keep, (_pack_cnt_ext(count, left, right),))
    return (w_s,) + _unpack_cnt_ext(pay) + (n_kept,)
