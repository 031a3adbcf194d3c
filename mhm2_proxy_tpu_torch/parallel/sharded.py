"""Sharded k-mer counting and cross-shard lookup (port of
mhm2_proxy_tpu/parallel/sharded.py).

The reference's routed all-to-all (ThreeTierAggrStore, routed by minimizer
hash, kmer_dht.cpp:193-196) is a bulk-synchronous exchange here:

  each source shard's reads -> records with their target shard (raw k-mer
  records: extract + minimizer kernels; or supermers, ops/supermer.py) ->
  sender presum of duplicate records -> fixed-capacity buckets per
  destination (leftovers kept for spill rounds) -> all_to_all -> each
  destination expands (supermers), sorts and reduces what it received into
  a split run of its LSM.

Every per-shard tensor has a leading axis over the rank's D = S / W shards
(W ranks, parallel/comm.py; all S shards on the one device of a world of
one), and comm.all_to_all is the one place where shards exchange data.
Every host value that sets a shape or a loop (bucket caps, trims, spill
rounds, retries) is global, so the ranks' buckets line up. A shard's local
work runs shard by shard through the single-device functions of
ops/count.py and kcount/kmer_store.py. Lookups route the same way there and
back (sharded_lookup). parallel/multihost.py stages the same exchange in two
hops over an (H, D) layout of the shards.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..constants import MAX_KMER_COUNT, minimizer_len_for_k, words32_for_k
from ..kcount.kmer_store import (FinalTable, _aggregate_ctg_records, _apply_ctg_rules,
                                 _merge_ctg_aggregates, to_device)
from ..ops import bitkmer as bk
from ..ops import count as C
from ..ops.lookup import table_lookup
from ..ops.scan import group_sums_scan_lanes
from ..ops.supermer import SMAX, build_supermers, expand_supermers, record_kmers, supermer_layout
from ..ops.u32 import ONES, lexsort_perm, narrow, u32, widen
from ..ops.u64 import umod
from ..utils import trace
from . import comm
from .comm import COUNT_EXCHANGE, TRAVERSE_EXCHANGE, all_to_all


def owner_shards(words, k: int, n_shards: int):
    """(..., W) canonical k-mer words -> (...) int32 owner shard,
    quick_hash(minimizer) % n_shards (plain torch: the router's hash)."""
    minz = bk.minimizers_from_words(words, k, minimizer_len_for_k(k))
    return umod(bk.quick_hash_u64(minz), n_shards).to(torch.int32)


def _per_shard(fn, *args):
    """fn applied to shard s of every (S, ...) argument, for each s; the
    outputs' tuple elements stacked along a new leading shard axis."""
    outs = [fn(*(a[s] for a in args)) for s in range(args[0].shape[0])]
    return tuple(torch.stack([o[i] for o in outs]) for i in range(len(outs[0])))


def _bucketize(payload, target, valid, n_shards: int, cap: int):
    """Route each source's rows into fixed-capacity buckets (reference
    sharded.py:77-106). payload (S_src, N, R) int32, target (S_src, N) in
    [0, n_shards), valid (S_src, N) bool.

    Rows past a bucket's capacity are not lost: they come back as leftovers
    (the payload sorted by target, the target, the leftover mask) for a spill
    round, as the reference's aggregating stores backpressure rather than
    drop (flat_aggr_store.hpp:41-72). Returns (buckets (S_src, n_shards,
    cap, R), n_overflow (S_src,), leftovers, fill (S_src, n_shards): the
    rows each bucket holds, in a prefix of its slots)."""
    S_src, N, R = payload.shape
    dev = payload.device
    key = torch.where(valid, target.to(torch.int64), n_shards)
    t_s, order = torch.sort(key, dim=1, stable=True)
    p_s = torch.gather(payload, 1, order[..., None].expand(S_src, N, R))
    del order
    edges = torch.arange(n_shards + 1, device=dev).expand(S_src, n_shards + 1).contiguous()
    start = torch.searchsorted(t_s, edges)
    pos = torch.arange(N, device=dev) - torch.gather(start, 1, t_s.clamp(0, n_shards - 1))
    ok = (t_s < n_shards) & (pos < cap)
    dest = (torch.arange(S_src, device=dev)[:, None] * n_shards + t_s) * cap + pos
    out = torch.zeros((S_src * n_shards * cap, R), dtype=payload.dtype, device=dev)
    out[dest[ok]] = p_s[ok]
    del dest, ok
    left_mask = (t_s < n_shards) & (pos >= cap)
    left_target = torch.where(left_mask, t_s, n_shards).to(torch.int32)
    fill = (start[:, 1:] - start[:, :-1]).clamp(max=cap)
    return (out.view(S_src, n_shards, cap, R), left_mask.sum(1), (p_s, left_target, left_mask),
            fill)


def _presum_duplicates(payload, target, valid, count_of, with_count, mode: str):
    """Sender-side pre-aggregation of duplicate records (reference
    sharded.py:109-162, the HeavyHitterStreamingStore analog,
    heavy_hitter_streaming_store.hpp:243-265): within each source shard,
    rows equal in every bit but the count collapse into the group's last
    row, whose count becomes the group's sum saturated at the u16 ceiling
    ('sum', read pass: the scan kernel) or its min ('min', contig pass,
    kcount_cpu.cpp:381-396). A poly-A storm thus leaves about one row per
    sender. Rows sort by (valid first, the payload with its count zeroed)
    in unsigned order.

    count_of(rows (N, R)) -> (N,) int32; with_count(rows, c) sets the count
    field of rows in place (clamped) and returns them, keeping every other
    bit (the two-stage exchange keeps the target host in spare meta bits).
    Returns (payload, target, valid, n_collapsed) in that sorted order."""
    S_src, N, R = payload.shape
    dev = payload.device
    flat = payload.reshape(-1, R)
    cnt = count_of(flat)
    key_rows = with_count(flat.clone(), torch.zeros_like(cnt))
    src = torch.arange(S_src, dtype=torch.int32, device=dev).repeat_interleave(N)
    vkey = torch.where(valid.reshape(-1), 0, 1).to(torch.int32)
    perm = lexsort_perm((src, vkey) + tuple(key_rows[:, i] for i in range(R)))
    kp = key_rows[perm]
    del key_rows
    c = cnt[perm].contiguous()
    t = target.reshape(-1)[perm]
    sv = vkey[perm] == 0
    src = src[perm]
    del perm
    neq = (kp[1:] != kp[:-1]).any(dim=1) | (sv[1:] != sv[:-1]) | (src[1:] != src[:-1])
    one = torch.ones((1,), dtype=torch.bool, device=dev)
    is_start, is_last = torch.cat([one, neq]), torch.cat([neq, one])
    if mode == "sum":
        red = group_sums_scan_lanes((c,), is_start, MAX_KMER_COUNT)[0]
    else:
        gid = torch.cumsum(is_start.to(torch.int64), 0) - 1
        init = torch.zeros((int(gid[-1]) + 1,), dtype=torch.int32, device=dev)
        red = init.scatter_reduce(0, gid, c, "amin", include_self=False)[gid]
    v2 = sv & is_last
    kp = with_count(kp, red)
    n_collapsed = int(valid.sum()) - int(v2.sum())
    return kp.view(S_src, N, R), t.view(S_src, N), v2.view(S_src, N), n_collapsed


class RecordFns(NamedTuple):
    """The record format of one exchange (reference _record_fns,
    sharded.py:165-227): make_records(codes, qual_ok, lens, depth, n_src)
    -> (payload (n_src, N, R), target, valid, n_kmers); receive(recv (S, M,
    R)) -> each shard's aggregate of what it received (S, ...), a split
    run on the read pass; count_of / with_count for _presum_duplicates;
    is_valid(rows); meta_col, the word whose spare bits from host_shift
    up carry a target host; R, words a record; rows_per_record, the k-mer
    rows the reference's receiver makes of one received record; and mode,
    the presum's reduction ('sum' on the read pass, 'min' on the contig
    pass)."""

    make_records: Callable
    receive: Callable
    count_of: Callable
    with_count: Callable
    is_valid: Callable
    meta_col: int
    host_shift: int
    R: int
    rows_per_record: int
    mode: str


def _record_fns(k: int, n_route: int, use_supermers: bool, ctg_mode: bool):
    """The raw k-mer records (words, meta: left | right << 8 | valid << 16,
    count) or supermers (ops/supermer.py: code words, mask words, meta:
    n | count << 8), routed over n_route targets."""
    mode = "min" if ctg_mode else "sum"

    def aggregate(words, left, right, count, valid):
        if ctg_mode:
            return _aggregate_ctg_records(words, left, right, count, valid)
        return C.split_run(*C.aggregate_records(words, left, right, count, valid))

    if use_supermers:
        nb, cw, mw, R = supermer_layout(k, SMAX)
        mc = cw + mw
        per_record = nb - k + 1

        def count_of(rows):
            return (rows[:, mc] >> 8) & 0xFFFF

        def with_count(rows, c):
            rows[:, mc] = (rows[:, mc] & u32(~(0xFFFF << 8))) | (
                torch.clamp(c, 0, MAX_KMER_COUNT).to(torch.int32) << 8)
            return rows

        def is_valid(rows):
            return (rows[:, mc] & 0xFF) > 0

        def make_records(codes, qual_ok, lens, depth, n_src):
            sup = build_supermers(codes, qual_ok, lens, k, SMAX, n_route, depth=depth,
                                  n_src=n_src)
            return sup["records"], sup["target"], sup["valid"], sup["n_kmers"]

        def receive(recv):
            """Expand only the records that carry k-mers: every shard takes
            the same count M_e of records (its live ones first, then empty
            ones), enough that a trim to the reference's row count (the
            pow2 of the occupancy, at most M * per_record) keeps whole rows."""
            S, M, _R = recv.shape
            n = record_kmers(recv.reshape(-1, R), k, SMAX).view(S, M)
            live = n > 0
            n_sum, n_live = int(n.sum(1).max()), int(live.sum(1).max())
            with comm.stage(COUNT_EXCHANGE):
                n_max, live_max = comm.all_max(n_sum, n_live)
            need = C.pow2_rows(n_max)
            M_e = min(M, max(live_max, -(-need // per_record), 1))

            def one(rows, keep):
                sel = torch.zeros((M_e, R), dtype=rows.dtype, device=rows.device)
                idx = keep.nonzero().squeeze(1)
                sel[: idx.shape[0]] = rows[idx]
                s_codes, s_qok, s_lens, s_depth = expand_supermers(sel, k, SMAX)
                rec = C.read_kmer_records(s_codes, s_qok, s_lens, k, depth=s_depth)
                return aggregate(rec["words"], rec["left"], rec["right"], rec["count"],
                                 rec["valid"])

            return _per_shard(one, recv, live)

        return RecordFns(make_records, receive, count_of, with_count, is_valid, mc, 24, R,
                         per_record, mode)

    W = words32_for_k(k)

    def count_of(rows):
        return rows[:, W + 1]

    def with_count(rows, c):
        rows[:, W + 1] = torch.clamp(c, 0, MAX_KMER_COUNT).to(torch.int32)
        return rows

    def is_valid(rows):
        return ((rows[:, W] >> 16) & 1).bool()

    def make_records(codes, qual_ok, lens, depth, n_src):
        rec = C.read_kmer_records(codes, qual_ok, lens, k, depth=depth, n_shards=n_route)
        n = rec["valid"].shape[0] // n_src
        return (_pack_records(rec).view(n_src, n, W + 2), rec["target"].view(n_src, n),
                rec["valid"].view(n_src, n), int(rec["valid"].sum()))

    def receive(recv):
        return _per_shard(lambda pl: aggregate(*_unpack_records(pl, W)), recv)

    return RecordFns(make_records, receive, count_of, with_count, is_valid, W, 17, W + 2, 1, mode)


def _pack_records(rec):
    """Count records -> one (N, W + 2) int32 payload: the words, meta (left |
    right << 8 | valid << 16), count."""
    meta = (rec["left"].to(torch.int64) | (rec["right"].to(torch.int64) << 8)
            | (rec["valid"].to(torch.int64) << 16))
    return torch.cat([rec["words"], narrow(meta)[:, None], rec["count"].to(torch.int32)[:, None]],
                     dim=1)


def _unpack_records(payload, W: int):
    """(N, W + 2) payload -> (words, left, right, count, valid). The zero rows
    of empty bucket slots carry valid 0."""
    meta = widen(payload[:, W])
    return (payload[:, :W], (meta & 0xFF).to(torch.uint8), ((meta >> 8) & 0xFF).to(torch.uint8),
            payload[:, W + 1], ((meta >> 16) & 1).bool())


class ShardedCounter:
    """k-mer counting over S shards: one count store per shard, raw k-mer
    records or supermers routed by minimizer hash (reference ShardedCounter,
    sharded.py:252-575). A rank holds D = S / W of them (n_local, from
    shard0 on). Read-pass runs are split into a multi part and a compact
    singleton part (the GQF analog, kcount-gpu/gqf.hpp:358-378) and merge
    LSM-style; every shard's run has the same row count, the pow2 of the
    fullest shard's occupancy over all ranks."""

    def __init__(self, k: int, n_shards: int, dmin_thres: int = 2,
                 bucket_cap: int | None = None, device="cuda", use_supermers: bool = False):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        if n_shards % comm.world():
            raise ValueError(f"{n_shards} shards do not divide over {comm.world()} ranks")
        self.k = k
        self.S = n_shards
        self.n_local = n_shards // comm.world()
        self.shard0 = comm.rank() * self.n_local
        self.W = words32_for_k(k)
        self.dmin_thres = dmin_thres
        self.bucket_cap = bucket_cap
        self.device = torch.device(device)
        # supermers trade compute (window packing at the sender, expansion
        # at the receiver) for the reference's ~k / SMAX cut of the exchanged
        # records (kcount_cpu.cpp:84-103); off by default for the flat layout
        # (the reference's choice), on in HierarchicalCounter
        self.use_supermers = use_supermers
        self._row_words = (supermer_layout(k, SMAX)[3] if use_supermers else self.W + 2)
        self.runs: list[tuple] = []
        self.ctg_runs: list[tuple] = []
        # k-mer rows a shard received in the contig pass: the reference keeps
        # them all, which sets its table's row count (ShardedTable.bound_rows)
        self.ctg_recv_rows = 0
        # exchange observability (reference kcount_cpu.cpp:107-110, the
        # aggregating stores' per-target volume counters)
        self.dropped = 0  # rows lost for good: none, the spill loop re-sends
        self.spilled = 0  # rows deferred to spill rounds
        self.spill_rounds = 0
        self.stat_kmers = 0
        self.stat_records = 0
        self.stat_bytes = 0
        self.stat_collapsed = 0

    def add_reads_block(self, codes, qual_ok, lens):
        """codes (D*B, L) uint8 and qual_ok (D*B, L) bool, numpy or CPU
        tensors, numpy lens (D*B,): rows [s*B, (s+1)*B) are the reads of the
        rank's source shard s; every rank passes a block of the same shape."""
        self._add_block(codes, qual_ok, lens, None)

    def add_ctgs_block(self, codes, lens, depths):
        """Contig k-mers with per-contig depth (reference kcount.cpp:100-138)."""
        self._add_block(codes, np.ones(np.asarray(codes).shape, bool), lens,
                        np.asarray(depths, np.int32))

    def _add_block(self, codes, qual_ok, lens, depths):
        ctg_mode = depths is not None
        S, D, k = self.S, self.n_local, self.k
        SB, L = np.shape(codes)
        if SB % D:
            raise ValueError(f"a block's {SB} rows do not divide over {D} shards")
        with comm.stage(COUNT_EXCHANGE):
            agreed = comm.all_max(SB, L, -SB, -L) == [SB, L, -SB, -L]
        if not agreed:
            raise ValueError(f"the ranks' blocks differ in shape (this rank's: {SB} x {L})")
        B, P = SB // D, L - k + 1
        # the cap is in k-mers; supermers convert it to records (reference
        # sharded.py:421-430). An undersized cap costs spill rounds, never
        # correctness
        if self.bucket_cap:
            kmer_cap, floor = self.bucket_cap, 8
        else:
            kmer_cap, floor = max(256, int(B * P // S * 2)), 64
        cap = max(floor, kmer_cap // SMAX * 3) if self.use_supermers else kmer_cap
        fns = _record_fns(k, S, self.use_supermers, ctg_mode)
        dev = self.device
        payload, target, valid, n_kmers = fns.make_records(
            to_device(codes, dev), to_device(qual_ok, dev, bool), to_device(lens, dev, np.int32),
            to_device(depths, dev) if ctg_mode else None, D)
        payload, target, valid, n_pre = _presum_duplicates(
            payload, target, valid, fns.count_of, fns.with_count, fns.mode)
        n_sent, n_over, n_comb, left = self._exchange(payload, target, valid, cap, fns)
        self._account(n_kmers, n_sent, n_over, n_pre + n_comb)
        del payload, target, valid
        # spill rounds: re-exchange the overflowed rows until all are placed
        # (lossless under any skew: every round ships cap rows per over-full
        # destination), every rank while any rank has some
        while self._spill_pending(n_over):
            self.spill_rounds += 1
            n_sent, n_over, n_comb, left = self._exchange(*left, cap, fns)
            self._account(0, n_sent, n_over, n_comb)

    @staticmethod
    def _spill_pending(n_over: int) -> bool:
        """Whether any rank has rows left over; a spill round counts on the
        exchange's span."""
        with comm.stage(COUNT_EXCHANGE):
            more = comm.all_sum(n_over) > 0
            if more:
                trace.count("spill_rounds")
        return more

    def _route(self, payload, target, valid, cap: int, fns: RecordFns):
        """Bucketize + all_to_all: returns (what each local shard received
        (D, S * cap, R), rows sent, rows left over, rows collapsed on the
        way, the leftovers)."""
        buckets, n_over, left, fill = _bucketize(payload, target, valid, self.S, cap)
        n_over = int(n_over.sum())
        n_sent = int(valid.sum()) - n_over
        with comm.stage(COUNT_EXCHANGE, records=n_sent):
            recv = all_to_all(buckets, fill)[0].view(self.n_local, self.S * cap, fns.R)
        return recv, n_sent, n_over, 0, left

    def _exchange(self, payload, target, valid, cap: int, fns: RecordFns):
        """One routed exchange and receive; pushes the received runs and
        returns (rows sent, rows left over, rows collapsed, the leftovers)."""
        recv, n_sent, n_over, n_comb, left = self._route(payload, target, valid, cap, fns)
        rows = recv.shape[1] * fns.rows_per_record
        agg = fns.receive(recv)
        del recv
        if fns.mode == "min":  # the contig pass
            self.ctg_recv_rows += rows
            self._push_ctg_run(agg)
        else:
            self._push_split(self._trim_split(agg, rows))
        return n_sent, n_over, n_comb, left

    def _account(self, n_kmers: int, n_sent: int, n_over: int, n_collapsed: int):
        self.stat_kmers += n_kmers
        self.stat_records += n_sent
        self.stat_bytes += n_sent * self._row_words * 4
        self.stat_collapsed += n_collapsed
        self.spilled += n_over

    def describe_exchange(self) -> str:
        """Exchange-volume summary (reference kcount_cpu.cpp:107-110 and the
        aggregating stores' volume counters)."""
        ratio = self.stat_kmers / max(self.stat_records, 1)
        return (
            f"{self.stat_records} records ({self.stat_bytes >> 20} MiB all_to_all) "
            f"for {self.stat_kmers} kmers ({ratio:.1f} kmers/record), "
            f"{self.stat_collapsed} presummed, {self.spilled} re-sent in "
            f"{self.spill_rounds} spill rounds, {self.dropped} dropped"
        )

    # -- read-pass LSM of split runs (S, T, ...) ----------------------------

    @staticmethod
    def _trim_split(run, rows: int | None = None):
        """Trim a split run to the pow2 of its fullest shard's occupancy, at
        most `rows` (default: the run's own rows; a supermer receive passes
        the reference's, which expands every received record)."""
        m_w, m_c, m_l4, m_r4, nm, s_w, s_e, ns = run
        nm_loc, ns_loc = int(nm.max()), int(ns.max())
        with comm.stage(COUNT_EXCHANGE):
            nm_max, ns_max = comm.all_max(nm_loc, ns_loc)
        pm = min(C.pow2_rows(nm_max), rows or m_w.shape[1])
        ps = min(C.pow2_rows(ns_max), rows or s_w.shape[1])
        if pm > m_w.shape[1] or ps > s_w.shape[1]:
            raise RuntimeError(f"a split run of {m_w.shape[1]} / {s_w.shape[1]} rows cut "
                               f"to {pm} / {ps}")
        cut = lambda x, p: x[:, :p].contiguous()  # noqa: E731
        return (cut(m_w, pm), cut(m_c, pm), cut(m_l4, pm), cut(m_r4, pm), nm,
                cut(s_w, ps), cut(s_e, ps), ns)

    def _merge_split(self, a, b):
        run = _per_shard(
            lambda *x: C.merge_split4(x[0:4], C.expand_singles(*x[4:7]), x[7:11],
                                      C.expand_singles(*x[11:14])),
            *a[:4], *a[5:8], *b[:4], *b[5:8])
        return self._trim_split(run)

    @staticmethod
    def _split_rows(run) -> int:
        return run[0].shape[1] + run[5].shape[1]

    def _push_split(self, run):
        self.runs.append(run)
        while (len(self.runs) >= 2
               and self._split_rows(self.runs[-1]) >= self._split_rows(self.runs[-2]) // 2):
            b = self.runs.pop()
            a = self.runs.pop()
            self.runs.append(self._merge_split(a, b))

    @staticmethod
    def _trim_ctg(agg):
        """Trim a contig run to the pow2 of its fullest shard's occupancy.
        The reference keeps every received row (S * cap a push, mostly dead
        rows of short contigs' windows): at the 27 Mbp community's ~150
        contig blocks a round that is ~3e8 rows a shard, past int32 state
        ids in the stitch. Tables are the same either way, and the table's
        bound_rows keeps the reference's row count for the stitch's round
        bound."""
        n_loc = int(agg[4].max())
        with comm.stage(COUNT_EXCHANGE):
            n_max = comm.all_max(n_loc)
        P = min(C.pow2_rows(n_max), agg[0].shape[1])
        return tuple(x[:, :P].contiguous() for x in agg[:4]) + (agg[4],)

    def _merge_ctg(self, a, b):
        return self._trim_ctg(_per_shard(_merge_ctg_aggregates, *a[:4], *b[:4]))

    def _push_ctg_run(self, agg):
        self.ctg_runs.append(self._trim_ctg(agg))
        while (len(self.ctg_runs) >= 2
               and self.ctg_runs[-1][0].shape[1] >= self.ctg_runs[-2][0].shape[1] // 2):
            b = self.ctg_runs.pop()
            a = self.ctg_runs.pop()
            self.ctg_runs.append(self._merge_ctg(a, b))

    def finalize(self) -> "ShardedTable":
        while len(self.runs) > 1:
            b = self.runs.pop()
            a = self.runs.pop()
            self.runs.append(self._merge_split(a, b))
        if self.runs:
            # fold the singleton part back into the full format
            a = self.runs.pop()
            merged = _per_shard(lambda *x: C.merge_aggregates(*x[:4], *C.expand_singles(*x[4:])),
                                *a[:4], *a[5:8])
            del a
        else:
            S, W, dev = self.n_local, self.W, self.device
            merged = (torch.full((S, 1, W), ONES, dtype=torch.int32, device=dev),
                      torch.zeros((S, 1), dtype=torch.int32, device=dev),
                      torch.zeros((S, 1, 4), dtype=torch.int32, device=dev),
                      torch.zeros((S, 1, 4), dtype=torch.int32, device=dev),
                      torch.zeros((S,), dtype=torch.int32, device=dev))
        while len(self.ctg_runs) > 1:
            b = self.ctg_runs.pop()
            a = self.ctg_runs.pop()
            self.ctg_runs.append(self._merge_ctg(a, b))
        # global: the row counts follow from global trims and bucket shapes
        bound_rows = merged[0].shape[1] + self.ctg_recv_rows
        if self.ctg_runs:
            c = self.ctg_runs.pop()
            merged = _per_shard(lambda *x: _apply_ctg_rules(*x, self.dmin_thres), *merged, *c)
            del c
        out = _per_shard(lambda *x: C.finalize_table(*x, dmin_thres=self.dmin_thres), *merged)
        return ShardedTable(self.k, *out, bound_rows=bound_rows, n_shards=self.S,
                            shard0=self.shard0)


@dataclasses.dataclass
class ShardedTable:
    """Per-shard finalized tables of the rank's D shards, (D, T, ...) with
    one row count T on every rank: global shard shard0 + s holds the k-mers
    whose minimizer hashes to it, lexsorted in a dense prefix of n[s] rows."""

    k: int
    words: torch.Tensor  # (D, T, W) int32 (u32 bits)
    count: torch.Tensor  # (D, T) int32
    left: torch.Tensor  # (D, T) uint8 ext call codes
    right: torch.Tensor  # (D, T) uint8
    n: torch.Tensor  # (D,) int32
    # the row count of the reference's table for the same input (its contig
    # runs keep every received row); the stitch's round bound comes from it
    bound_rows: int | None = None
    n_shards: int | None = None  # S over all ranks (default: D)
    shard0: int = 0  # the global id of local shard 0

    def __post_init__(self):
        if self.bound_rows is None:
            self.bound_rows = self.words.shape[1]
        if self.n_shards is None:
            self.n_shards = self.words.shape[0]

    @property
    def S(self) -> int:
        return self.n_shards

    @property
    def n_local(self) -> int:
        return self.words.shape[0]

    @classmethod
    def from_reference(cls, k: int, words, count, left, right, n, device="cuda") -> "ShardedTable":
        """Build from the numpy arrays of a mhm2_proxy_tpu ShardedTable
        (uint32 words taken bit for bit as int32)."""
        dev = torch.device(device)
        w = np.ascontiguousarray(np.asarray(words)).view(np.int32)
        as_t = lambda a, dt: torch.from_numpy(np.array(a, dt)).to(dev)  # noqa: E731
        return cls(k, torch.from_numpy(w.copy()).to(dev), as_t(count, np.int32),
                   as_t(left, np.uint8), as_t(right, np.uint8), as_t(n, np.int32))

    def shard_tables(self) -> list[FinalTable]:
        return [FinalTable(self.k, self.words[s], self.count[s], self.left[s], self.right[s],
                           self.n[s]) for s in range(self.n_local)]


def sharded_lookup(table: ShardedTable, query_words, query_valid, cap: int | None = None):
    """Cross-shard batched point lookup (reference sharded.py:602-705).

    query_words (D, Q, W): each local source shard's canonical k-mer
    queries, query_valid (D, Q) bool. Returns (found bool, count int32, left
    uint8, right uint8, owner row int32), each (D, Q), aligned with the
    queries. A bucket overflow on any rank retries at doubled capacity on
    every rank until every query is answered (the reference's aggregating
    stores never drop either)."""
    S = table.S
    with comm.stage(TRAVERSE_EXCHANGE):
        Q = comm.all_max(query_words.shape[1])
    max_cap = S * Q  # every query routed to one shard
    cap = cap or max(64, 2 * Q // max(S, 1) + 64)
    while True:
        out = _sharded_lookup_once(table, query_words, query_valid, cap)
        if out is not None:
            return out
        if cap >= max_cap:
            raise RuntimeError("sharded_lookup: overflow at max capacity")
        cap = min(2 * cap, max_cap)


def _sharded_lookup_once(table: ShardedTable, query_words, query_valid, cap: int):
    """One routed lookup at bucket capacity cap; None if a bucket overflowed
    (a dropped query would read as not found and split a contig)."""
    D, Q, W = query_words.shape
    S = table.S
    dev = query_words.device
    target = owner_shards(query_words, table.k, S)
    qid = torch.arange(Q, dtype=torch.int32, device=dev).expand(D, Q)
    payload = torch.cat([query_words, qid[..., None], query_valid.to(torch.int32)[..., None]],
                        dim=2)
    buckets, n_over, _left, fill = _bucketize(payload, target, query_valid, S, cap)
    del payload, target
    n_over = int(n_over.sum())
    with comm.stage(TRAVERSE_EXCHANGE):
        overflow = comm.all_sum(n_over)
    if overflow:
        return None
    with comm.stage(TRAVERSE_EXCHANGE):
        rq, fill = all_to_all(buckets, fill)
    rq = rq.view(D, S * cap, W + 2)
    del buckets
    back = []
    for s in range(D):
        r_words, r_qid, r_valid = rq[s, :, :W], rq[s, :, W], rq[s, :, W + 1] != 0
        idx, found = table_lookup(table.words[s], table.n[s], r_words)
        found = found & r_valid
        il = idx.long()
        # answer: found (1) | left call (3) | right call (3) | count (16)
        ans = (found.to(torch.int64) | (table.left[s][il].to(torch.int64) << 1)
               | (table.right[s][il].to(torch.int64) << 4)
               | (torch.clamp(table.count[s][il].to(torch.int64), 0, MAX_KMER_COUNT) << 7))
        ans = torch.where(r_valid, ans, 0).to(torch.int32)
        back.append(torch.stack([ans, idx, r_qid, r_valid.to(torch.int32)], dim=-1))
    # slot (s, c) of each destination returns to source shard s
    back = torch.stack(back).view(D, S, cap, 4)
    with comm.stage(TRAVERSE_EXCHANGE):
        ret = all_to_all(back, fill)[0].view(D, S * cap, 4)
    del back, rq
    dest = torch.where(ret[..., 3] > 0, ret[..., 2].long(), Q)
    at_query = lambda v: torch.zeros((D, Q + 1), dtype=torch.int32, device=dev).scatter_(  # noqa: E731
        1, dest, v)[:, :Q]
    ans, oidx = at_query(ret[..., 0]), at_query(ret[..., 1])
    a = ans.to(torch.int64)
    return ((a & 1).bool(), ((a >> 7) & 0xFFFF).to(torch.int32), ((a >> 1) & 7).to(torch.uint8),
            ((a >> 4) & 7).to(torch.uint8), oidx)
