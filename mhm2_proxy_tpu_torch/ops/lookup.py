"""Sort-join lookups over sorted k-mer tables (port of
mhm2_proxy_tpu/ops/lookup.py, merge-join form).

The table is always lexsorted (dense sorted prefix + sentinel tail), so only
the queries are sorted; the two runs meet in the sort kernel's merge, and
the join kernel (ops/join.py) gives every query the (idx+1) << payload_bits
| payload answer of the table row with its key, in query order. This is the
reference's fused merge-join path (mhm2_proxy_tpu/ops/lookup.py:85-143).
"""

from __future__ import annotations

import torch

from .join import IDX_MASK, MAX_PAYLOAD_BITS, QUERY_BIT, propagate_answers
from .sort import merge_sorted_lanes_tiled
from .u32 import lexsort_lanes, narrow, widen

# (row | query flag | payload) must fit one u32: row ids need 25 bits
_FUSED_MAX_ROWS = QUERY_BIT


def merged_join_rows(table_words, query_words, payload):
    """The table rows (key lanes + idx | payload << 26) merged with the
    sorted query rows (key lanes + idx | QUERY_BIT): W + 1 lanes, padded to
    the sort's TILE. Pad rows carry source 0x01FFFFFF: query flag clear, idx
    past any valid row, so a pad is never an answer nor a query."""
    T, W = table_words.shape
    Q = query_words.shape[0]
    dev = table_words.device
    qsrc = narrow(torch.arange(Q, device=dev) | QUERY_BIT)
    qs = lexsort_lanes(tuple(query_words[:, w] for w in range(W)) + (qsrc,), W)
    tsrc = narrow(torch.arange(T, device=dev) | (payload.to(torch.int64) << 26))
    a_lanes = tuple(table_words[:, w].contiguous() for w in range(W)) + (tsrc,)
    return merge_sorted_lanes_tiled(a_lanes, qs, W, pad_fill=(IDX_MASK,))


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
    fused = payload_bits <= MAX_PAYLOAD_BITS and max(T, Q) < _FUSED_MAX_ROWS
    narrow_ok = (T + 1) * (1 << payload_bits) <= (1 << 32)
    if not (fused and narrow_ok):
        raise NotImplementedError(
            f"sort-join with {T} table rows, {Q} queries and payload_bits="
            f"{payload_bits} needs the separate-lane join, not ported yet: ROADMAP "
            "queue 1 item 5"
        )
    out = merged_join_rows(table_words, query_words, payload)
    ans = widen(propagate_answers(out, n_valid, W, payload_bits, Q, max_dup))
    found = ans > 0
    idx = torch.clamp((ans >> payload_bits) - 1, 0, T - 1).to(torch.int32)
    pay = narrow(ans & ((1 << payload_bits) - 1))
    return idx, found, pay
