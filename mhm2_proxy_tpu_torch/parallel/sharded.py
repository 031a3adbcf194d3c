"""Sharded k-mer counting and cross-shard lookup (port of
mhm2_proxy_tpu/parallel/sharded.py, the raw-record exchange on one process).

The reference's routed all-to-all (ThreeTierAggrStore, routed by minimizer
hash, kmer_dht.cpp:193-196) is a bulk-synchronous exchange here:

  each source shard's reads -> k-mer records with their target shard
  (extract + minimizer kernels) -> sender presum of duplicate records ->
  fixed-capacity buckets per destination (leftovers kept for spill rounds)
  -> all_to_all -> each destination sorts and reduces what it received
  into a split run of its LSM.

Every global tensor has a leading shard axis (S, ...), with all S shards on
the run's one device, and all_to_all is the one place where shards exchange
data. A shard's local work runs shard by shard through the single-device
functions of ops/count.py and kcount/kmer_store.py. Lookups route the same
way there and back (sharded_lookup).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..constants import MAX_KMER_COUNT, minimizer_len_for_k, words32_for_k
from ..kcount.kmer_store import (FinalTable, _aggregate_ctg_records, _apply_ctg_rules,
                                 _merge_ctg_aggregates)
from ..ops import bitkmer as bk
from ..ops import count as C
from ..ops.lookup import table_lookup
from ..ops.scan import group_sums_scan_lanes
from ..ops.u32 import ONES, lexsort_perm, narrow, widen
from ..ops.u64 import umod


def all_to_all(buckets):
    """(S_src, S_dst, cap, R) -> (S_dst, S_src, cap, R): slot (src, dst) of
    every source reaches destination dst. All shards share one device, so
    it is a transpose."""
    return buckets.transpose(0, 1).contiguous()


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
    cap, R), n_overflow (S_src,), leftovers)."""
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
    return out.view(S_src, n_shards, cap, R), left_mask.sum(1), (p_s, left_target, left_mask)


def _presum_duplicates(payload, target, valid, mode: str):
    """Sender-side pre-aggregation of duplicate records (reference
    sharded.py:109-162, the HeavyHitterStreamingStore analog,
    heavy_hitter_streaming_store.hpp:243-265): within each source shard,
    rows equal in every lane but the count (the last lane) collapse into the
    group's last row, whose count becomes the group's sum saturated at the
    u16 ceiling ('sum', read pass: the scan kernel) or its min ('min',
    contig pass, kcount_cpu.cpp:381-396). A poly-A storm thus leaves about
    one row per sender. Rows sort by (valid first, the payload with its
    count zeroed) in unsigned order.

    Returns (payload, target, valid, n_collapsed) in that sorted order."""
    S_src, N, R = payload.shape
    dev = payload.device
    cnt = payload[..., R - 1].reshape(-1)
    key_rows = payload.reshape(-1, R).clone()
    key_rows[:, R - 1] = 0
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
    kp[:, R - 1] = torch.clamp(red, 0, MAX_KMER_COUNT)
    n_collapsed = int(valid.sum()) - int(v2.sum())
    return kp.view(S_src, N, R), t.view(S_src, N), v2.view(S_src, N), n_collapsed


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
    """k-mer counting over S shards on one device: one count store per shard,
    records routed by minimizer hash (reference ShardedCounter with the
    raw-record exchange, sharded.py:252-575). Read-pass runs are split into
    a multi part and a compact singleton part (the GQF analog,
    kcount-gpu/gqf.hpp:358-378) and merge LSM-style; every shard's run has
    the same row count, the pow2 of the fullest shard's occupancy."""

    def __init__(self, k: int, n_shards: int, dmin_thres: int = 2,
                 bucket_cap: int | None = None, device="cuda"):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.k = k
        self.S = n_shards
        self.W = words32_for_k(k)
        self.R = self.W + 2
        self.dmin_thres = dmin_thres
        self.bucket_cap = bucket_cap
        self.device = torch.device(device)
        self.runs: list[tuple] = []
        self.ctg_runs: list[tuple] = []
        # rows a shard received in the contig pass: the reference keeps them
        # all, which sets its table's row count (ShardedTable.bound_rows)
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
        """codes (S*B, L) uint8, qual_ok (S*B, L) bool, lens (S*B,) numpy
        arrays: rows [s*B, (s+1)*B) are source shard s's reads."""
        self._add_block(codes, qual_ok, lens, None)

    def add_ctgs_block(self, codes, lens, depths):
        """Contig k-mers with per-contig depth (reference kcount.cpp:100-138)."""
        self._add_block(codes, np.ones(np.asarray(codes).shape, bool), lens,
                        np.asarray(depths, np.int32))

    def _add_block(self, codes, qual_ok, lens, depths):
        ctg_mode = depths is not None
        S, k, R = self.S, self.k, self.R
        SB, L = np.asarray(codes).shape
        if SB % S:
            raise ValueError(f"a block's {SB} rows do not divide over {S} shards")
        B, P = SB // S, L - k + 1
        # the cap is in k-mer records; an undersized cap costs spill rounds,
        # never correctness
        cap = self.bucket_cap or max(256, int(B * P // S * 2))
        dev = self.device
        to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
        rec = C.read_kmer_records(
            to_dev(codes), to_dev(np.asarray(qual_ok, bool)), to_dev(np.asarray(lens, np.int32)),
            k, depth=to_dev(depths) if ctg_mode else None, n_shards=S)
        payload = _pack_records(rec).view(S, B * P, R)
        target, valid = rec["target"].view(S, B * P), rec["valid"].view(S, B * P)
        del rec
        n_kmers = int(valid.sum())
        payload, target, valid, n_collapsed = _presum_duplicates(
            payload, target, valid, "min" if ctg_mode else "sum")
        n_over, left = self._exchange(payload, target, valid, cap, ctg_mode)
        self._account(n_kmers, int(valid.sum()) - n_over, n_over, n_collapsed)
        del payload, target, valid
        # spill rounds: re-exchange the overflowed rows until all are placed
        # (lossless under any skew: every round ships cap rows per over-full
        # destination)
        while n_over > 0:
            self.spill_rounds += 1
            lp, lt, lv = left
            n_over, left = self._exchange(lp, lt, lv, cap, ctg_mode)
            self._account(0, int(lv.sum()) - n_over, n_over, 0)

    def _exchange(self, payload, target, valid, cap: int, ctg_mode: bool):
        """One bucketize + all_to_all + receive; pushes the received runs and
        returns (rows left over, the leftovers)."""
        buckets, n_over, left = _bucketize(payload, target, valid, self.S, cap)
        recv = all_to_all(buckets).view(self.S, self.S * cap, self.R)
        del buckets
        W = self.W
        if ctg_mode:
            self.ctg_recv_rows += recv.shape[1]
            agg = _per_shard(lambda pl: _aggregate_ctg_records(*_unpack_records(pl, W)), recv)
            del recv
            self._push_ctg_run(agg)
        else:
            run = _per_shard(lambda pl: C.split_run(*C.aggregate_records(*_unpack_records(pl, W))),
                             recv)
            del recv
            self._push_split(self._trim_split(run))
        return int(n_over.sum()), left

    def _account(self, n_kmers: int, n_sent: int, n_over: int, n_collapsed: int):
        self.stat_kmers += n_kmers
        self.stat_records += n_sent
        self.stat_bytes += n_sent * self.R * 4
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
    def _trim_split(run):
        """Trim a split run to the pow2 of its fullest shard's occupancy."""
        m_w, m_c, m_l4, m_r4, nm, s_w, s_e, ns = run
        pm = min(C.pow2_rows(int(nm.max())), m_w.shape[1])
        ps = min(C.pow2_rows(int(ns.max())), s_w.shape[1])
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
        P = min(C.pow2_rows(int(agg[4].max())), agg[0].shape[1])
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
            S, W, dev = self.S, self.W, self.device
            merged = (torch.full((S, 1, W), ONES, dtype=torch.int32, device=dev),
                      torch.zeros((S, 1), dtype=torch.int32, device=dev),
                      torch.zeros((S, 1, 4), dtype=torch.int32, device=dev),
                      torch.zeros((S, 1, 4), dtype=torch.int32, device=dev),
                      torch.zeros((S,), dtype=torch.int32, device=dev))
        while len(self.ctg_runs) > 1:
            b = self.ctg_runs.pop()
            a = self.ctg_runs.pop()
            self.ctg_runs.append(self._merge_ctg(a, b))
        bound_rows = merged[0].shape[1] + self.ctg_recv_rows
        if self.ctg_runs:
            c = self.ctg_runs.pop()
            merged = _per_shard(lambda *x: _apply_ctg_rules(*x, self.dmin_thres), *merged, *c)
            del c
        out = _per_shard(lambda *x: C.finalize_table(*x, dmin_thres=self.dmin_thres), *merged)
        return ShardedTable(self.k, *out, bound_rows=bound_rows)


@dataclasses.dataclass
class ShardedTable:
    """Per-shard finalized tables, (S, T, ...) with one row count T: shard s
    holds the k-mers whose minimizer hashes to s, lexsorted in a dense
    prefix of n[s] rows."""

    k: int
    words: torch.Tensor  # (S, T, W) int32 (u32 bits)
    count: torch.Tensor  # (S, T) int32
    left: torch.Tensor  # (S, T) uint8 ext call codes
    right: torch.Tensor  # (S, T) uint8
    n: torch.Tensor  # (S,) int32
    # the row count of the reference's table for the same input (its contig
    # runs keep every received row); the stitch's round bound comes from it
    bound_rows: int | None = None

    def __post_init__(self):
        if self.bound_rows is None:
            self.bound_rows = self.words.shape[1]

    @property
    def S(self) -> int:
        return self.words.shape[0]

    @classmethod
    def from_reference(cls, k: int, words, count, left, right, n, device="cpu") -> "ShardedTable":
        """Build from the numpy arrays of a mhm2_proxy_tpu ShardedTable
        (uint32 words taken bit for bit as int32)."""
        dev = torch.device(device)
        w = np.ascontiguousarray(np.asarray(words)).view(np.int32)
        as_t = lambda a, dt: torch.from_numpy(np.array(a, dt)).to(dev)  # noqa: E731
        return cls(k, torch.from_numpy(w.copy()).to(dev), as_t(count, np.int32),
                   as_t(left, np.uint8), as_t(right, np.uint8), as_t(n, np.int32))

    def shard_tables(self) -> list[FinalTable]:
        return [FinalTable(self.k, self.words[s], self.count[s], self.left[s], self.right[s],
                           self.n[s]) for s in range(self.S)]


def sharded_lookup(table: ShardedTable, query_words, query_valid, cap: int | None = None):
    """Cross-shard batched point lookup (reference sharded.py:602-705).

    query_words (S, Q, W): each source shard's canonical k-mer queries,
    query_valid (S, Q) bool. Returns (found bool, count int32, left uint8,
    right uint8, owner row int32), each (S, Q), aligned with the queries.
    A bucket overflow retries at doubled capacity until every query is
    answered (the reference's aggregating stores never drop either)."""
    S, Q, _W = query_words.shape
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
    S, Q, W = query_words.shape
    dev = query_words.device
    target = owner_shards(query_words, table.k, S)
    qid = torch.arange(Q, dtype=torch.int32, device=dev).expand(S, Q)
    payload = torch.cat([query_words, qid[..., None], query_valid.to(torch.int32)[..., None]],
                        dim=2)
    buckets, n_over, _left = _bucketize(payload, target, query_valid, S, cap)
    del payload, target
    if int(n_over.sum()):
        return None
    rq = all_to_all(buckets).view(S, S * cap, W + 2)
    del buckets
    back = []
    for s in range(S):
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
    ret = all_to_all(torch.stack(back).view(S, S, cap, 4)).view(S, S * cap, 4)
    del back, rq
    dest = torch.where(ret[..., 3] > 0, ret[..., 2].long(), Q)
    at_query = lambda v: torch.zeros((S, Q + 1), dtype=torch.int32, device=dev).scatter_(  # noqa: E731
        1, dest, v)[:, :Q]
    ans, oidx = at_query(ret[..., 0]), at_query(ret[..., 1])
    a = ans.to(torch.int64)
    return ((a & 1).bool(), ((a >> 7) & 0xFFFF).to(torch.int32), ((a >> 1) & 7).to(torch.uint8),
            ((a >> 4) & 7).to(torch.uint8), oidx)
