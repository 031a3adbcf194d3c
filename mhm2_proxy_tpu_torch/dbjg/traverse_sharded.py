"""Sharded de Bruijn traversal: cross-shard edge building + the on-device
stitch (port of mhm2_proxy_tpu/dbjg/traverse_sharded.py).

The reference's rank-hopping walks (dbjg_traversal.cpp:245-289, one RPC per
remote hop) become two batched cross-shard lookups, one per walk direction,
then distributed pointer doubling (stitch_sharded.py). Edge, conflict and
self-loop rules are those of dbjg/traverse.py::build_edges. Edge arrays stay
(D, T) on the device, over the rank's D shards (global node id = shard * T +
row, the rank's shards from shard0 on); the lookups cross ranks, and the
walk-termination counts are summed over them. The stitch brings only
rendered contigs to the host.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from ..ops import bitkmer as bk
from ..ops.count import pow2_rows
from ..parallel import comm
from ..parallel.comm import TRAVERSE_EXCHANGE
from ..parallel.sharded import ShardedTable, owner_shards, sharded_lookup
from .stitch_sharded import stitch_paths_sharded
from .traverse import term_stats_to_dict


def _neighbor_queries(words, left, right, n, k: int):
    """Each shard's neighbour queries for both directions: (uu, b_can, b_rc,
    p_can, p_rc, first base, last base), each (S, T, ...); built shard by
    shard, which bounds the int64 temporaries to one shard's rows."""
    S, T, _W = words.shape
    outs = []
    for s in range(S):
        w = words[s]
        uu = (torch.arange(T, device=w.device) < n[s]) & (left[s] < 4) & (right[s] < 4)
        b_can, b_rc = bk.canonicalize_words(bk.forward_base_words(w, right[s], k), k)
        p_can, p_rc = bk.canonicalize_words(bk.backward_base_words(w, left[s], k), k)
        outs.append((uu, b_can, b_rc, p_can, p_rc, bk.first_base(w), bk.last_base(w, k)))
    return tuple(torch.stack([o[i] for o in outs]) for i in range(7))


def _edge_conditions(uu, b_rc, p_rc, a_first, a_last, r_found, b_left, b_right, b_idx,
                     l_found, p_left, p_right, p_idx, b_shard, p_shard, shard0: int = 0):
    """Elementwise edge and walk-termination rules on the (D, T) arrays of
    global shards shard0 ...; global node ids are shard * T + row."""
    D, T = uu.shape
    dev = uu.device
    self_gid = ((shard0 + torch.arange(D, device=dev))[:, None] * T
                + torch.arange(T, device=dev)[None, :])
    b_gid = b_shard.to(torch.int64) * T + b_idx
    p_gid = p_shard.to(torch.int64) * T + p_idx
    b_uu = (b_left < 4) & (b_right < 4)
    p_uu = (p_left < 4) & (p_right < 4)
    b_left_or = torch.where(b_rc, 3 - b_right.to(torch.int64), b_left.to(torch.int64))
    p_right_or = torch.where(p_rc, 3 - p_left.to(torch.int64), p_right.to(torch.int64))
    r_ok = uu & r_found & b_uu & (b_left_or == a_first) & (b_gid != self_gid)
    l_ok = uu & l_found & p_uu & (p_right_or == a_last) & (p_gid != self_gid)

    # walk terminations, as traverse.build_edges (reference WalkTermStats,
    # dbjg_traversal.cpp:114-141)
    def _term(found, n_left, n_right, ok, self_hit):
        n_uu = (n_left < 4) & (n_right < 4)
        x = (n_left == 5) | (n_right == 5)
        deadend = uu & (~found | (found & x))
        fork = uu & found & ~x & ((n_left == 4) | (n_right == 4))
        conflict = uu & found & n_uu & ~ok & ~self_hit
        repeat = uu & found & self_hit
        return torch.stack([deadend.sum(), fork.sum(), conflict.sum(), repeat.sum()])

    terms = torch.stack([
        _term(r_found, b_left, b_right, r_ok, b_gid == self_gid),
        _term(l_found, p_left, p_right, l_ok, p_gid == self_gid),
    ])
    with comm.stage(TRAVERSE_EXCHANGE):
        term_stats = comm.all_sum_tensor(terms)
    edges = dict(
        uu=uu, r_gid=b_gid.to(torch.int32), r_port=b_rc.to(torch.int32), r_ok=r_ok,
        l_gid=p_gid.to(torch.int32), l_port=(~p_rc).to(torch.int32), l_ok=l_ok,
    )
    return edges, term_stats


def build_edges_sharded(table: ShardedTable, k: int):
    """Reciprocal UU edges across shards, kept (D, T) on the device. Returns
    (edges, term_stats): edges holds the uu mask and, per direction, the
    neighbour's global node id, entry port and validity; term_stats (2, 4)
    the walk terminations (deadend, fork, conflict, repeat) per direction,
    over every rank."""
    S = table.S
    uu, b_can, b_rc, p_can, p_rc, a_first, a_last = _neighbor_queries(
        table.words, table.left, table.right, table.n, k)
    r_found, _, b_left, b_right, b_idx = sharded_lookup(table, b_can, uu)
    l_found, _, p_left, p_right, p_idx = sharded_lookup(table, p_can, uu)
    # each query's owner shard, computed on the source side with the router's hash
    b_shard = torch.stack([owner_shards(b_can[s], k, S) for s in range(table.n_local)])
    p_shard = torch.stack([owner_shards(p_can[s], k, S) for s in range(table.n_local)])
    del b_can, p_can
    return _edge_conditions(uu, b_rc, p_rc, a_first, a_last, r_found, b_left, b_right, b_idx,
                            l_found, p_left, p_right, p_idx, b_shard, p_shard, table.shard0)


def live_rows(table: ShardedTable) -> ShardedTable:
    """The table cut to the power of two of the fullest shard's live rows
    over every rank. A shard's rows past its n hold nothing, yet the
    counter's table keeps the rows of every k-mer it saw before the purge
    (16 times the live ones at k = 21 on the CAMI high-complexity cut), and
    the edges' lookups and the stitch's states and buckets scale with the
    rows. Node ids (shard * T + row) keep their order for any T that holds
    the live rows, so the contigs, their ids and the cycles' cut points are
    the whole table's; the stitch's round bound keeps bound_rows."""
    n_loc = int(table.n.max())
    with comm.stage(TRAVERSE_EXCHANGE):
        n_max = comm.all_max(n_loc)
    T = min(table.words.shape[1], pow2_rows(n_max))
    if T == table.words.shape[1]:
        return table
    cut = lambda x: x[:, :T].contiguous()  # noqa: E731
    return dataclasses.replace(table, words=cut(table.words), count=cut(table.count),
                               left=cut(table.left), right=cut(table.right))


def traverse_debruijn_graph_sharded(table: ShardedTable, k: int, stats: dict | None = None):
    """Full sharded traversal -> list of (seq, depth).

    Contigs may differ from the single-shard path only at cycle break points:
    a cycle breaks at its minimum global node id, which orders k-mers by
    (owner shard, row) instead of by k-mer; revcomp-palindromic cycles emit
    the segment up to re-entering the leader node (reference
    traverse_sharded.py:133-141). No min_ctg_len: the reference's sharded
    branch renders every path."""
    t0 = time.perf_counter()
    table = live_rows(table)
    edges, term_stats = build_edges_sharded(table, k)
    terms = term_stats_to_dict(term_stats)  # waits for the device
    edges_s = time.perf_counter() - t0
    out = stitch_paths_sharded(table, edges, k, stats=stats)
    if stats is not None:
        stats["terminations"] = terms
        stats["stitch_timings"] = dict(edges_s=round(edges_s, 2), **stats["stitch_timings"])
    return out
