"""De Bruijn graph traversal as bulk path decomposition (port of
mhm2_proxy_tpu/dbjg/traverse.py).

1. build_edges (device): one sort-join answers both neighbours of every UU
   k-mer: index, entry port, and edge validity (reference
   dbjg_traversal.cpp:165-335 walks these one RPC hop at a time).
2. stitch_paths (host): the native walker decomposes the reciprocal UU
   edge graph into maximal paths and cycles (dbjg/stitch.py).

Contigs come out in canonical orientation with depth = sum of member k-mer
counts / (len - k + 2) (dbjg_traversal.cpp:542).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import bitkmer as bk
from ..ops.count import trim_rows
from ..ops.lookup import table_join_payload
from ..ops.u32 import ONES, widen


def build_edges(words, count, left, right, n, k: int):
    """Reciprocal-edge inputs for every table row.

    words/count/left/right/n: a FinalTable's tensors (lexsorted dense prefix).
    Returns per row: uu (bool), and for each side nbr_idx (int32), entry port
    (0=L, 1=R), ok (bool), plus the walk-termination counts term_stats (2, 4).

    Walking right from canonical A with ext r reaches B_oriented = A[1:] + r;
    the edge is valid iff B exists, B is UU, B's oriented left ext == A[0]
    (CONFLICT check, dbjg_traversal.cpp:192-197) and B is not A (REPEAT,
    :204-207). Symmetric for the left side.
    """
    T = words.shape[0]
    dev = words.device
    row_valid = torch.arange(T, device=dev) < n
    uu = row_valid & (left < 4) & (right < 4)
    a_first = bk.first_base(words)
    a_last = bk.last_base(words, k)

    b_can, b_rc = bk.canonicalize_words(bk.forward_base_words(words, right, k), k)
    p_can, p_rc = bk.canonicalize_words(bk.backward_base_words(words, left, k), k)
    # one join answers both directions; queries of non-UU rows are all-ones
    q = torch.cat([b_can, p_can])
    q = torch.where(torch.cat([uu, uu])[:, None], q, ONES)
    # neighbour ext codes ride the join as a 6-bit payload
    ext_pay = left.to(torch.int64) | (right.to(torch.int64) << 3)
    idx2, found2, pay2 = table_join_payload(words, n, q, ext_pay, payload_bits=6)
    pay2 = widen(pay2)
    b_idx, b_found = idx2[:T], found2[:T]
    p_idx, p_found = idx2[T:], found2[T:]
    b_left = pay2[:T] & 7
    b_right = (pay2[:T] >> 3) & 7
    b_uu = (b_left < 4) & (b_right < 4)
    # oriented left ext of B: comp(right) if B's canonical form is its rc
    b_left_or = torch.where(b_rc, 3 - b_right, b_left)
    self_idx = torch.arange(T, dtype=torch.int32, device=dev)
    r_ok = uu & b_found & b_uu & (b_left_or == a_first) & (b_idx != self_idx)
    # entry port on B: via L (canonical-aligned) exits R; via R (rc) exits L
    r_port = b_rc.to(torch.int32)

    p_left = pay2[T:] & 7
    p_right = (pay2[T:] >> 3) & 7
    p_uu = (p_left < 4) & (p_right < 4)
    p_right_or = torch.where(p_rc, 3 - p_left, p_right)
    l_ok = uu & p_found & p_uu & (p_right_or == a_last) & (p_idx != self_idx)
    l_port = (~p_rc).to(torch.int32)

    # walk-termination classification per side (reference WalkTermStats,
    # dbjg_traversal.cpp:114-141)
    def _term(found, n_uu, n_left, n_right, ok, self_hit):
        missing = uu & ~found
        deadend = uu & found & ((n_left == 5) | (n_right == 5))
        fork = uu & found & ~deadend & ((n_left == 4) | (n_right == 4))
        conflict = uu & found & n_uu & ~ok & ~self_hit
        repeat = uu & found & self_hit
        return torch.stack([(missing | deadend).sum(), fork.sum(), conflict.sum(), repeat.sum()])

    r_stats = _term(b_found, b_uu, b_left, b_right, r_ok, b_idx == self_idx)
    l_stats = _term(p_found, p_uu, p_left, p_right, l_ok, p_idx == self_idx)
    return dict(
        uu=uu,
        r_idx=b_idx, r_port=r_port, r_ok=r_ok,
        l_idx=p_idx, l_port=l_port, l_ok=l_ok,
        term_stats=torch.stack([r_stats, l_stats]),
    )


def _resize_rows(table, target: int):
    T = table.words.shape[0]
    if target == T:
        return table
    if target < T:
        return dataclasses.replace(
            table, words=table.words[:target], count=table.count[:target],
            left=table.left[:target], right=table.right[:target],
        )
    padn = target - T
    dev = table.words.device
    return dataclasses.replace(
        table,
        words=torch.cat([table.words, torch.full((padn, table.words.shape[1]), ONES,
                                                 dtype=torch.int32, device=dev)]),
        count=torch.cat([table.count, torch.zeros((padn,), dtype=table.count.dtype, device=dev)]),
        left=torch.cat([table.left, torch.full((padn,), 5, dtype=torch.uint8, device=dev)]),
        right=torch.cat([table.right, torch.full((padn,), 5, dtype=torch.uint8, device=dev)]),
    )


def fit_table_rows(table):
    """Slice (or pad) the table arrays to trim_rows(n) of the live row count:
    every sentinel pad row would ride the join as 3 rows."""
    return _resize_rows(table, max(256, trim_rows(int(table.n))))


def term_stats_to_dict(term_stats) -> dict:
    """(2, 4) [right/left walk][deadend, fork, conflict, repeat] -> dict
    (reference WalkTermStats::print_stats, dbjg_traversal.cpp:128-141)."""
    ts = np.asarray(term_stats.cpu()).sum(axis=0)
    return dict(deadend=int(ts[0]), fork=int(ts[1]), conflict=int(ts[2]), repeat=int(ts[3]))


def traverse_debruijn_graph(table, k: int, stats: dict | None = None, min_ctg_len: int = 0):
    """Full traversal of a FinalTable -> list of (seq, depth).

    `stats`, if a dict, receives the walk-termination counts. min_ctg_len > 0
    drops contigs shorter than it before host materialization (the assembler
    passes k+2)."""
    from .stitch import stitch_paths

    table = fit_table_rows(table)
    edges = build_edges(table.words, table.count, table.left, table.right, table.n, k)
    if stats is not None:
        stats["terminations"] = term_stats_to_dict(edges["term_stats"])
    timings = {} if stats is not None else None
    out = stitch_paths(edges, table.words, table.count, k, timings=timings,
                       min_states=max(1, min_ctg_len - (k - 1)))
    if stats is not None:
        stats["stitch_timings"] = timings
    return out

