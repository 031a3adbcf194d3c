"""Sort-join lookups over sorted k-mer tables (port of
mhm2_proxy_tpu/ops/lookup.py, merge-join form).

The table is always lexsorted (dense sorted prefix + sentinel tail), so only
the queries are sorted; the two runs meet in the sort kernel's merge, and
every query gets the table row with its key, in query order.

- Fused (max(T, Q) < 2^25 rows and payloads of <= 6 bits, the reference's
  merge-join path, mhm2_proxy_tpu/ops/lookup.py:85-143): row id, query flag
  and payload share one u32 lane, and the join kernel (ops/join.py) stores
  each query's (idx+1) << payload_bits | payload answer at its index.
- Separate lanes (larger tables or query sets, wider payloads; the
  reference's XLA branch, lookup.py:144-247, which no Pallas kernel runs):
  the merge carries a source lane (row id, bit 31 for queries) and a
  payload lane, and the join kernel's separate-lane variant stores each
  query's (idx+1) << 32 | payload answer at its index.

table_join is table_join_payload without a payload (payload_bits 0, so the
fused lane below 2^25 rows). table_lookup and rank_rows are the reference's
batched bisections (lookup.py:287-342), which XLA runs there: plain torch
on the table's device.
"""

from __future__ import annotations

import torch

from .join import (MAX_PAYLOAD_BITS, QUERY_BIT, SEP_QUERY_BIT, propagate_answers,
                   propagate_answers_sep)
from .sort import merge_sorted_lanes
from .u32 import lexsort_lanes, narrow, widen

# (row | query flag | payload) must fit one u32: row ids need 25 bits
_FUSED_MAX_ROWS = QUERY_BIT


def merged_join_rows(table_words, query_words, payload):
    """The table rows (key lanes + idx | payload << 26) merged with the
    sorted query rows (key lanes + idx | QUERY_BIT): W + 1 lanes of T + Q
    rows (the table's key lanes read in place)."""
    T, W = table_words.shape
    Q = query_words.shape[0]
    dev = table_words.device
    qsrc = narrow(torch.arange(Q, device=dev) | QUERY_BIT)
    qs = lexsort_lanes(tuple(query_words[:, w] for w in range(W)) + (qsrc,), W)
    tsrc = narrow(torch.arange(T, device=dev) | (payload.to(torch.int64) << 26))
    return merge_sorted_lanes(tuple(table_words[:, w] for w in range(W)) + (tsrc,), qs, W)


def table_join_payload(table_words, n_valid, query_words, payload,
                       max_dup: int = 32, payload_bits: int = 32):
    """For each query row the unique table row (within the valid prefix
    n_valid) with the same key: returns (idx int32, found bool, pay int32 =
    payload[idx] where found, else 0). Precondition: fewer than max_dup
    rows (table + queries) share a key, and invalid queries are all-ones
    (they never match: table sentinels lie past n_valid). The reference's
    `_sort_join` in its merge-join form."""
    T, W = table_words.shape
    Q = query_words.shape[0]
    if payload_bits <= MAX_PAYLOAD_BITS and max(T, Q) < _FUSED_MAX_ROWS:
        out = merged_join_rows(table_words, query_words, payload)
        ans = widen(propagate_answers(out, n_valid, W, payload_bits, Q, max_dup))
        shift = payload_bits
    else:
        ans = _join_separate_lanes(table_words, n_valid, query_words, payload, max_dup)
        shift = 32
    found = ans > 0
    idx = torch.clamp((ans >> shift) - 1, 0, max(T - 1, 0)).to(torch.int32)
    pay = narrow(ans & ((1 << payload_bits) - 1))
    return idx, found, pay


def table_join(table_words, n_valid, query_words, max_dup: int = 32):
    """For each query row the table row (within the valid prefix n_valid)
    with the same key: returns (idx int32, found bool); idx has meaning
    only where found. The preconditions of table_join_payload hold."""
    T = table_words.shape[0]
    payload = torch.zeros((T,), dtype=torch.int64, device=table_words.device)
    idx, found, _ = table_join_payload(table_words, n_valid, query_words, payload, max_dup,
                                       payload_bits=0)
    return idx, found


def merged_join_rows_sep(table_words, query_words, payload):
    """The separate-lane merge: the table rows (key lanes + row idx + payload)
    merged with the sorted query rows (key lanes + idx | bit 31 + 0): W + 2
    lanes."""
    T, W = table_words.shape
    Q = query_words.shape[0]
    dev = table_words.device
    qsrc = narrow(torch.arange(Q, device=dev) | SEP_QUERY_BIT)
    zeros = torch.zeros((Q,), dtype=torch.int32, device=dev)
    qs = lexsort_lanes(tuple(query_words[:, w] for w in range(W)) + (qsrc, zeros), W)
    a_lanes = tuple(table_words[:, w] for w in range(W)) + (
        torch.arange(T, dtype=torch.int32, device=dev), narrow(payload.to(torch.int64)),
    )
    return merge_sorted_lanes(a_lanes, qs, W)


def _join_separate_lanes(table_words, n_valid, query_words, payload, max_dup: int):
    """(Q,) int64 answers (idx + 1) << 32 | payload, 0 where no valid table
    row has the query's key."""
    out = merged_join_rows_sep(table_words, query_words, payload)
    return propagate_answers_sep(out, n_valid, table_words.shape[1], query_words.shape[0],
                                 max_dup)


def _lex_less_u32(a, b):
    """(N,) bool: row a < row b over (N, W) int32 words read as u32."""
    W = a.shape[1]
    lt = widen(a[:, W - 1]) < widen(b[:, W - 1])
    for w in range(W - 2, -1, -1):
        aw, bw = widen(a[:, w]), widen(b[:, w])
        lt = (aw < bw) | ((aw == bw) & lt)
    return lt


def _lex_leq_u32(a, b):
    """(N,) bool: row a <= row b over (N, W) int32 words read as u32."""
    W = a.shape[1]
    le = widen(a[:, W - 1]) <= widen(b[:, W - 1])
    for w in range(W - 2, -1, -1):
        aw, bw = widen(a[:, w]), widen(b[:, w])
        le = (aw < bw) | ((aw == bw) & le)
    return le


def _bisect(table_words, n_valid, query_words, go_right):
    """(Q,) int64 lower bound: the first row in [0, n_valid) at which
    go_right(row, query) is false, in the reference's bit_length(T - 1) + 1
    steps (T >= 1)."""
    T = table_words.shape[0]
    Q = query_words.shape[0]
    dev = query_words.device
    steps = max(1, (T - 1).bit_length() + 1) if T > 1 else 1
    lo = torch.zeros((Q,), dtype=torch.int64, device=dev)
    hi = torch.full((Q,), int(n_valid), dtype=torch.int64, device=dev)
    for _ in range(steps):
        mid = (lo + hi) >> 1
        right = go_right(table_words[torch.clamp(mid, 0, T - 1)], query_words)
        active = lo < hi
        lo = torch.where(active & right, mid + 1, lo)
        hi = torch.where(active & ~right, mid, hi)
    return lo


def rank_rows(table_words, n_valid, query_words, upper: bool = False):
    """Rank of each query row in a lexsorted table prefix: (Q,) int32, the
    number of the first n_valid table rows < the query (lower, default) or
    <= it (upper=True), in u32 order. Two sorted runs interleave at
    positions i + rank(other, row) without a re-sort."""
    if table_words.shape[0] == 0:
        return torch.zeros((query_words.shape[0],), dtype=torch.int32,
                           device=query_words.device)
    cmp = _lex_leq_u32 if upper else _lex_less_u32
    return _bisect(table_words, n_valid, query_words, cmp).to(torch.int32)


def table_lookup(table_words, n_valid, query_words):
    """Lower-bound binary search of query rows in a lexsorted table prefix.

    table_words (T, W) int32 (u32 bits) sorted rows, valid prefix length
    n_valid; query_words (Q, W). Returns (idx (Q,) int32, found (Q,) bool):
    idx is the first row of the query's key where found. The reference's
    bit_length(T - 1) + 1 steps."""
    T = table_words.shape[0]
    Q = query_words.shape[0]
    dev = query_words.device
    if T == 0:
        return (torch.zeros((Q,), dtype=torch.int32, device=dev),
                torch.zeros((Q,), dtype=torch.bool, device=dev))
    lo = _bisect(table_words, n_valid, query_words, _lex_less_u32)
    idx = torch.clamp(lo, 0, T - 1)
    found = (lo < int(n_valid)) & (table_words[idx] == query_words).all(dim=1)
    return idx.to(torch.int32), found
