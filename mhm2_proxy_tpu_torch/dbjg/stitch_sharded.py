"""Sharded path stitching by pointer doubling on the device (port of
mhm2_proxy_tpu/dbjg/stitch_sharded.py).

Every shard owns the 2T walk states of its table rows (state 2*row + exit
port, global id shard * 2T + state); a rank holds D of the S shards, and
every per-state array is (D, 2T). Each doubling round gathers (successor,
distance) at every state's current successor through the exchange
(gather_pair: a bucketize, an all_to_all there and one back, across ranks);
chains first
jump through successors on their own shard (local_advance, no exchange),
since minimizer sharding keeps consecutive k-mers together
(dbjg_traversal.cpp:232-236). The loops stop when nothing moves, capped at
ceil(log2(S*2T + 1)) + 1 rounds, with T the reference table's row count
(ShardedTable.bound_rows), so a cycle's doubling runs the reference's
rounds; a loop goes on while anything moved on any rank. Then cycles are
cut at their minimum node (both directions), predecessors are marked, one
direction of each path is emitted, path ids come from a global exclusive
scan of per-shard emit counts (the reference's reduce_prefix,
dbjg_traversal.cpp:583-587), and every on-path state reads its path and
position from a start-of-terminal registry. The contigs are rendered on the
device by dbjg/stitch.py, and the host receives only their bases, depth
sums and offsets: each rank renders the paths that start on its shards
(their states sent to it across ranks), and an all_gather of the rendered
bytes (in a world of one, its own) gives every rank the global contig
list in path order.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..parallel import comm
from ..parallel.comm import TRAVERSE_EXCHANGE, all_to_all
from ..parallel.sharded import _bucketize
from .stitch import contigs_from_blob, render_contigs_blob

LOCAL_ROUNDS = 4


def static_rounds(S: int, T: int) -> int:
    return max(1, int(np.ceil(np.log2(S * 2 * T + 1))) + 1)


class _Exchange:
    """The stitch's collectives over (D, 2T) per-shard state arrays of the
    rank's D shards, from global shard shard0 on, of S."""

    def __init__(self, S: int, D: int, shard0: int, T2: int, device):
        self.S, self.D, self.shard0, self.T2, self.dev = S, D, shard0, T2, device
        self.bytes_moved = 0  # what the buckets carried through all_to_all

    def all_to_all(self, buckets, fill):
        self.bytes_moved += buckets.numel() * buckets.element_size()
        with comm.stage(TRAVERSE_EXCHANGE):
            return all_to_all(buckets, fill)

    def route(self, payload, tgt, valid):
        """Send each valid state's payload row to shard tgt: (D, S*T2, R)
        received rows (zero rows in empty slots), and their fill (D, S)."""
        S, D, T2 = self.S, self.D, self.T2
        buckets, _n_over, _left, fill = _bucketize(payload, tgt, valid, S, T2)
        recv, fill = self.all_to_all(buckets, fill)
        return recv.view(D, S * T2, payload.shape[2]), fill

    def scatter_rows(self, recv_rows, recv_valid, values, fill: int):
        """(D, T2) array holding each received value at its row (fill elsewhere)."""
        D, T2 = self.D, self.T2
        dest = torch.where(recv_valid, recv_rows.long(), T2)
        out = torch.full((D, T2 + 1), fill, dtype=torch.int32, device=self.dev)
        return out.scatter_(1, dest, values.to(torch.int32))[:, :T2]

    def gather_pair(self, va, vb, gids):
        """(va[g], vb[g]) at global state ids g, through two all_to_alls."""
        S, D, T2 = self.S, self.D, self.T2
        qid = torch.arange(T2, dtype=torch.int32, device=self.dev).expand(D, T2)
        payload = torch.stack([gids % T2, qid, torch.ones_like(qid)], dim=2)
        recv, fill = self.route(payload, gids // T2, torch.ones((D, T2), dtype=torch.bool,
                                                                   device=self.dev))
        r_row = recv[..., 0].clamp(0, T2 - 1).long()
        back = torch.stack([torch.gather(va, 1, r_row), torch.gather(vb, 1, r_row),
                            recv[..., 1], recv[..., 2]], dim=2)
        del recv, r_row
        ret = self.all_to_all(back.view(D, S, T2, 4), fill)[0].view(D, S * T2, 4)
        ok = ret[..., 3] > 0
        return (self.scatter_rows(ret[..., 2], ok, ret[..., 0], 0),
                self.scatter_rows(ret[..., 2], ok, ret[..., 1], 0))


def _any_rank(flag: bool) -> bool:
    with comm.stage(TRAVERSE_EXCHANGE):
        return comm.any_true(flag)


def _stitch_states(x: _Exchange, uu, r_gid, r_port, r_ok, l_gid, l_port, l_ok,
                   first_b, last_b, count, rounds: int):
    """Per-state path assignment (reference stitch_sharded.py:40-244).
    Returns (out (D, 2T, 4) [path, pos, base, count], on_path, srt (D, 2T,
    4) [rank, plen, port, row], emit, rounds used (doubling, cycle min,
    post-cut), every shard's emit count (S,))."""
    S, D, T2, dev = x.S, x.D, x.T2, x.dev
    own = ((x.shard0 + torch.arange(D, dtype=torch.int32, device=dev))[:, None] * T2
           + torch.arange(T2, dtype=torch.int32, device=dev)[None, :])
    lo = own[:, :1]

    def local_advance(val, nxt, combine):
        """In-shard jump composition through successors on the same shard."""
        for _ in range(LOCAL_ROUNDS):
            on = (nxt >= lo) & (nxt < lo + T2)
            row = (nxt - lo).clamp(0, T2 - 1).long()
            val, nxt = (torch.where(on, combine(val, torch.gather(val, 1, row)), val),
                        torch.where(on, torch.gather(nxt, 1, row), nxt))
        return val, nxt

    def doubling(succ):
        term = succ < 0
        nxt = torch.where(term, own, succ)
        d = torch.where(term, 0, 1).to(torch.int32)
        d, nxt = local_advance(d, nxt, torch.add)
        i, changed = 0, True
        while changed and i < rounds:
            rn, rd = x.gather_pair(nxt, d, nxt)
            changed = _any_rank(bool((rd > 0).any()))
            nxt, d, i = rn, d + rd, i + 1
        return nxt, d, term, i

    # per-state successor: s = 2*node + port (0 = exit left, 1 = exit right)
    succ_l = torch.where(l_ok & uu, 2 * l_gid + (1 - l_port), -1).to(torch.int32)
    succ_r = torch.where(r_ok & uu, 2 * r_gid + (1 - r_port), -1).to(torch.int32)
    succ = torch.stack([succ_l, succ_r], dim=2).view(D, T2)
    state_valid = torch.stack([uu, uu], dim=2).view(D, T2)

    nxt, _d, term, i1 = doubling(succ)
    t_at, _ = x.gather_pair(term.to(torch.int32), term.to(torch.int32), nxt)
    in_cycle = state_valid & (t_at == 0)

    # cycle leaders: the minimum global node id over the cycle
    mini, nx2 = local_advance(own >> 1, torch.where(term, own, succ), torch.minimum)
    i_min, changed = 0, True
    while changed and i_min < rounds:
        rm, rn2 = x.gather_pair(mini, nx2, nx2)
        new_mini = torch.minimum(mini, rm)
        changed = _any_rank(bool((new_mini != mini).any()))
        mini, nx2, i_min = new_mini, rn2, i_min + 1
    # cut both direction-cycles at the leader node; emission takes the
    # port-1 start only, so each cycle yields one contig
    cut = in_cycle & (succ >= 0) & ((succ == 2 * mini + 1) | (succ == 2 * mini))
    succ2 = torch.where(cut, -1, succ)
    del mini, nx2, cut, t_at

    nxt2, d2, term2, i2 = doubling(succ2)
    t2_at, _ = x.gather_pair(term2.to(torch.int32), term2.to(torch.int32), nxt2)
    still_cyc = state_valid & (t2_at == 0)

    # predecessor marking: each state notifies its successor's owner
    v = succ2 >= 0
    recv = x.route(torch.stack([torch.where(v, succ2 % T2, 0), v.to(torch.int32)], dim=2),
                   torch.where(v, succ2 // T2, S), v)[0]
    has_pred = x.scatter_rows(recv[..., 0], recv[..., 1] > 0, recv[..., 1], 0) > 0
    del recv

    is_start = state_valid & ~still_cyc & ~has_pred
    was_cycle_start = in_cycle & is_start
    emit = is_start & ((was_cycle_start & ((own & 1) == 1))
                       | (~was_cycle_start & (own < (nxt2 ^ 1))))
    plen = d2 + 1

    # global path ids: exclusive scan of the per-shard emit counts
    with comm.stage(TRAVERSE_EXCHANGE):
        offset, n_emit = comm.exclusive_scan(emit.sum(1))
    rank = torch.where(emit, offset[:, None] + torch.cumsum(emit.to(torch.int64), 1) - 1,
                       -1).to(torch.int32)

    # start-of-terminal registry: emitted starts notify their terminal's
    # owner; every state then reads (path id, start distance) at its terminal
    recv = x.route(torch.stack([torch.where(emit, nxt2 % T2, 0), rank, d2,
                                emit.to(torch.int32)], dim=2),
                   torch.where(emit, nxt2 // T2, S), emit)[0]
    ok = recv[..., 3] > 0
    sot = x.scatter_rows(recv[..., 0], ok, recv[..., 1], -1)
    dstart = x.scatter_rows(recv[..., 0], ok, recv[..., 2], 0)
    del recv, ok
    path_of_state, d_start = x.gather_pair(sot, dstart, nxt2)
    on_path = state_valid & ~still_cyc & (path_of_state >= 0)
    path_of_state = torch.where(on_path, path_of_state, -1)
    pos = torch.where(on_path, d_start - d2, 0)

    # emitted base per state: exit right -> last base, exit left -> comp(first)
    port = torch.arange(T2, device=dev) & 1
    row = torch.arange(T2, device=dev) >> 1
    base = torch.where(port == 1, last_b[:, row], 3 - first_b[:, row]).to(torch.int32)
    cnt = count[:, row].to(torch.int32)
    out = torch.stack([path_of_state, pos, base, cnt], dim=2)
    srt = torch.stack([rank, plen, port.to(torch.int32).expand(D, T2),
                       row.to(torch.int32).expand(D, T2)], dim=2)
    return out, on_path, srt, emit, (i1, i_min, i2), n_emit


def stitch_paths_sharded(table, edges: dict, k: int, stats: dict | None = None):
    """Distributed path decomposition -> list of (canonical seq, depth), the
    same global list on every rank. stats, if a dict, receives the executed
    collective rounds, the reference's count of their all_to_all bytes (7
    int32 lanes a state a gather round) and the bytes the port's buckets
    moved (each (src, dst) bucket holds 2T states)."""
    S, (D, T) = table.S, table.words.shape[:2]
    if S * T * 2 >= 2 ** 31:
        raise ValueError("state ids exceed int32; shard the table wider")
    words = table.words
    dev = words.device
    w_last = (k - 1) // 16
    sh_last = 2 * (15 - ((k - 1) % 16))
    first_b = (words[:, :, 0].to(torch.int64) >> 30) & 3
    last_b = (words[:, :, w_last].to(torch.int64) >> sh_last) & 3
    T_ref = table.bound_rows  # global: it follows from global shapes
    rounds = static_rounds(S, T_ref)
    t0 = time.perf_counter()
    x = _Exchange(S, D, table.shard0, 2 * T, dev)
    out, on_path, srt, emit, used, n_emit = _stitch_states(
        x, edges["uu"], edges["r_gid"], edges["r_port"], edges["r_ok"],
        edges["l_gid"], edges["l_port"], edges["l_ok"], first_b, last_b, table.count, rounds)
    if stats is not None:
        stats["stitch_rounds"] = dict(doubling=used[0], cycle_min=used[1], post_cut=used[2],
                                      static_bound=rounds)
        # the reference's count: each gather_pair round moves (3 + 4) int32
        # lanes a state
        stats["stitch_all_to_all_bytes"] = (sum(used) + 3) * S * 2 * T_ref * 7 * 4
    n_paths = int(n_emit.sum())
    t1 = time.perf_counter()
    if stats is not None:
        stats["stitch_timings"] = dict(states_s=round(t1 - t0, 2))
    if n_paths == 0:
        if stats is not None:
            stats["stitch_bucket_bytes"] = x.bytes_moved
        return []
    # this rank's paths: those whose starts lie on its shards
    lo = int(n_emit[: table.shard0].sum())
    n_mine = int(n_emit[table.shard0 : table.shard0 + D].sum())
    if comm.world() > 1:
        # each on-path state goes to the shard that emitted its path
        ends = torch.from_numpy(np.cumsum(n_emit)).to(dev)
        owner = torch.searchsorted(ends, out[..., 0].to(torch.int64), right=True)
        recv = x.route(torch.cat([out, on_path.to(torch.int32)[..., None]], dim=2),
                       torch.where(on_path, owner, S), on_path)[0].view(-1, 5)
        rows = recv[recv[:, 4] > 0, :4]
        del recv, owner
    else:
        rows = out[on_path]
    if stats is not None:
        stats["stitch_bucket_bytes"] = x.bytes_moved
    path, pos, base, cnt = rows.to(torch.int64).unbind(1)
    path = path - lo
    st = srt[emit]
    rank = st[:, 0].to(torch.int64) - lo
    local_of = torch.arange(D, device=dev)[:, None].expand(D, 2 * T)
    heads = torch.empty((n_mine, words.shape[2]), dtype=words.dtype, device=dev)
    heads[rank] = words[local_of[emit], st[:, 3].to(torch.int64)]
    plen = torch.empty(n_mine, dtype=torch.int64, device=dev)
    plen[rank] = st[:, 1].to(torch.int64)
    fwd = torch.empty(n_mine, dtype=torch.bool, device=dev)
    fwd[rank] = st[:, 2] == 1
    del out, on_path, srt, emit, st, rows
    # every rank renders its own paths; the gather gives each the global list
    blob = render_contigs_blob(plen, path, pos, base.to(torch.uint8), cnt, heads, fwd, k)
    head = np.array([n_mine], np.int64).tobytes()
    result = []
    payload = head + blob.tobytes()
    with comm.stage(TRAVERSE_EXCHANGE):
        gathered = comm.all_gather_bytes(payload)
    for got in gathered:
        n = int(np.frombuffer(got[:8], np.int64)[0])
        result += contigs_from_blob(np.frombuffer(got[8:], np.uint8), n, k)
    if stats is not None:
        stats["stitch_timings"]["render_s"] = round(time.perf_counter() - t1, 2)
    return result
