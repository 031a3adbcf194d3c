"""Sort + segmented-reduce k-mer counting (port of mhm2_proxy_tpu/ops/count.py,
the raw-LSM slice).

Each read block becomes ONE sorted packed run (extract kernel + lexsort),
the runs merge in a balanced tree (sort kernel), and one finalize pass
(finalize kernel + compact kernel) turns the merged run into the final table
or, for rounds with contigs, the unique aggregate. Counts and extension sums
are exact int32 sums clamped at the u16 ceiling, which equals the
reference's saturating accumulation (kcount_cpu.cpp:152-155).

u32 lanes are int32 tensors (ops/u32.py). Table words are (N, W) int32.
"""

from __future__ import annotations

import torch

from ..constants import EXT_X, MAX_KMER_COUNT, words32_for_k
from .compact import compact_classes
from .extract import extract_packed_lanes, extract_record_lanes
from .finalize import get_ext_calls as _get_ext_calls
from .finalize import scan_purge
from .sort import merge_sorted_lanes
from .u32 import ONES, lexsort_lanes, narrow, widen


def read_kmer_records(codes, qual_ok, lens, k: int, depth=None):
    """Count records of a block of sequences (reference process_seq +
    get_kmers_and_exts, kcount_cpu.cpp:84-101, 307-335), through the extract
    kernel's record layout.

    codes (B, L) uint8, qual_ok (B, L) bool, lens (B,) int32, depth optional
    (B,) int32 per-sequence count (contig pass). Returns a dict of (B*P,)
    arrays: words (B*P, W) int32 (all-ones on invalid rows), left / right
    uint8 ext codes (0 on invalid rows), count int32, valid bool."""
    lanes, pay = extract_record_lanes(codes, qual_ok, lens, k)
    B, L = codes.shape
    P = L - k + 1
    words = torch.stack(lanes, dim=-1)
    valid = pay != 0
    cnt, left, right = _unpack_cnt_ext(pay)
    if depth is not None:
        d = torch.clamp(depth.to(torch.int32), 0, MAX_KMER_COUNT)
        cnt = cnt * d[:, None].expand(B, P).reshape(-1)
    return dict(words=words, left=left, right=right, count=cnt, valid=valid)


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
    kernel). Returns (words (N, W) with all-ones tail, *payload lanes with
    zero tails, n_keep 0-dim int32)."""
    N, W = words.shape
    flags = torch.where(keep, 0, 1).to(torch.int32)
    lanes = tuple(words[:, i].contiguous() for i in range(W)) + tuple(
        p.contiguous() for p in payload
    )
    ((out, n),) = compact_classes(lanes, flags, 2, emit=(0,))
    live = torch.arange(N, device=words.device) < n
    u_words = torch.where(live[:, None], torch.stack(out[:W], dim=-1), ONES)
    pays = tuple(torch.where(live, x, 0) for x in out[W:])
    return (u_words,) + pays + (n,)


def pow2_rows(n: int, floor: int = 256) -> int:
    """Row count to slice a run to: the next power of two >= n."""
    return max(floor, 1 << (max(int(n), 1) - 1).bit_length())


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


def pack_payload_into_lanes(word_lanes, payload, k: int):
    """Fold the 7-bit record payload (_pack_cnt_ext layout, count in {0, 1})
    into the last non-zero key lane's free low bits; payload == 0 rows
    become full all-ones sentinels. Returns the ceil(2k/32) packed lanes."""
    W = len(word_lanes)
    weff = -(-2 * k // 32)
    free = 32 * weff - 2 * k
    assert weff <= W and free >= 7, (k, W)
    p = widen(payload)
    pay7 = (p & 1) | (((p >> 16) & 7) << 1) | (((p >> 24) & 7) << 4)
    last = widen(word_lanes[weff - 1])
    packed = torch.where(p == 0, ONES, narrow((last & ~((1 << free) - 1)) | pay7))
    return tuple(word_lanes[: weff - 1]) + (packed,)


def block_to_raw_run(codes, qual_ok, lens, k: int):
    """Read block -> ONE sorted packed run: ceil(2k/32) int32 lanes, the
    7-bit payload in the last lane's free bits, all-ones sentinel rows at
    the tail. Requires payload_fits_in_keys(k, words32_for_k(k))."""
    W = words32_for_k(k)
    if not payload_fits_in_keys(k, W):
        raise NotImplementedError(
            f"k={k}: the separate-payload raw layout (k=63/77) is not ported "
            "yet: ROADMAP queue 1 item 3"
        )
    return lexsort_lanes(extract_packed_lanes(codes, qual_ok, lens, k))


def merge_raw_runs(runs):
    """Balanced pairwise merge tree over sorted packed raw runs (every lane
    is key) -> one sorted tuple of lanes (sort kernel). An odd run out waits
    for the next level."""
    runs = [tuple(r) for r in runs]
    while len(runs) > 1:
        nxt = [
            merge_sorted_lanes(runs[i], runs[i + 1], len(runs[i]))
            for i in range(0, len(runs) - 1, 2)
        ]
        if len(runs) % 2:
            nxt.append(runs[-1])
        runs = nxt
    return runs[0]


def final_from_sorted_packed(sorted_lanes, k: int, W: int, dmin_thres: int = 2,
                             purge: bool = True):
    """ONE finalize pass + compaction from a merged sorted packed run to the
    final table (purge=True: (words, count, left, right, n_kept) applying the
    reference purge rules kcount_cpu.cpp:497-517) or the unique aggregate
    (purge=False: (words, count, l4, r4, n_unique) for the ctg rules)."""
    weff = len(sorted_lanes)
    data, flags = scan_purge(sorted_lanes, k, dmin_thres=dmin_thres, purge=purge)
    ((out, n),) = compact_classes(data, flags, 2, emit=(0,))
    N = flags.shape[0]
    dev = flags.device
    live = torch.arange(N, device=dev) < n
    zero_lane = torch.where(live, 0, ONES).to(torch.int32)
    u_words = torch.stack(
        tuple(torch.where(live, x, ONES) for x in out[:weff]) + (zero_lane,) * (W - weff),
        dim=-1,
    )
    if purge:
        cnt, left, right = _unpack_cnt_ext(torch.where(live, out[weff], 0))
        return u_words, cnt, left, right, n
    u_count, u_l4, u_r4 = _unpack_sums(*(torch.where(live, x, 0) for x in out[weff : weff + 5]))
    return u_words, u_count, u_l4, u_r4, n


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
