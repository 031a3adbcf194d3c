"""Single-device k-mer count store: the raw LSM (port of
mhm2_proxy_tpu/kcount/kmer_store.py).

Read blocks stream in as ONE sorted packed run each (no per-block dedup);
finalize merges the runs in a balanced tree and runs one finalize pass over
the merged run (ops/count.py). Rounds after the first add contig k-mers:
per k-mer over all its contig occurrences a conflict (distinct (left,right)
ext pairs) zeroes the count, otherwise count = min depth; a read-table entry
survives only as a UU k-mer with count >= 2 (reference
kcount_cpu.cpp:357-406, see mhm2_proxy_tpu/oracle/pyref.py).

The port runs the raw LSM on every device; the reference picks it on the
TPU only, and both of its LSMs produce the same table. Raw runs are stored
trimmed to their valid rows: a block's sentinel rows (invalid positions)
carry nothing, and dropping them keeps the merge tree and the byte budget
to the k-mers themselves.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..constants import EXT_X, MAX_KMER_COUNT, words32_for_k
from ..ops import bitkmer as bk
from ..ops import count as C
from ..ops.sort import merge_sorted_lanes
from ..ops.u32 import ONES, lexsort_lanes, narrow, rows_equal_next, widen


@dataclasses.dataclass
class FinalTable:
    """A finalized, lexsorted k-mer table (single device)."""

    k: int
    words: torch.Tensor  # (T, W) int32 (u32 bits), kept rows in a dense sorted prefix
    count: torch.Tensor  # (T,) int32
    left: torch.Tensor  # (T,) uint8 ext call codes (0-3 base, 4 F, 5 X)
    right: torch.Tensor  # (T,) uint8
    n: torch.Tensor  # 0-dim int32 number of valid rows

    @classmethod
    def from_reference(cls, k: int, words, count, left, right, n, device="cpu") -> "FinalTable":
        """Build from the numpy arrays of a mhm2_proxy_tpu FinalTable (uint32
        words are taken bit for bit as int32)."""
        w = np.ascontiguousarray(np.asarray(words)).view(np.int32)
        dev = torch.device(device)
        return cls(
            k,
            torch.from_numpy(w.copy()).to(dev),
            torch.from_numpy(np.asarray(count, np.int32).copy()).to(dev),
            torch.from_numpy(np.asarray(left, np.uint8).copy()).to(dev),
            torch.from_numpy(np.asarray(right, np.uint8).copy()).to(dev),
            torch.tensor(int(np.asarray(n)), dtype=torch.int32, device=dev),
        )

    def to_numpy(self):
        """(words uint32, count int32, left uint8, right uint8, n int) on the host."""
        return (
            self.words.cpu().numpy().view(np.uint32), self.count.cpu().numpy(),
            self.left.cpu().numpy(), self.right.cpu().numpy(), int(self.n),
        )

    def dump_kmers(self, fname: str):
        """Write 'KMER count L R' lines gzipped (reference kmer_dht.cpp:238-266)."""
        import gzip

        words, cnt, left, right, n = self.to_numpy()
        with gzip.open(fname, "wb") as f:
            f.write(render_kmer_dump(words[:n], cnt[:n], left[:n], right[:n], self.k))

    def to_host_dict(self) -> dict[str, tuple[int, str, str]]:
        """Materialize as {kmer_str: (count, left_char, right_char)}."""
        from ..constants import EXT_CALL_CHARS

        words, cnt, left, right, n = self.to_numpy()
        kmers = bk.words_to_strings(words[:n], self.k)
        return {
            km: (int(c), EXT_CALL_CHARS[l], EXT_CALL_CHARS[r])
            for km, c, l, r in zip(kmers, cnt[:n], left[:n], right[:n])
        }


def render_kmer_dump(words, count, left, right, k: int) -> bytes:
    """Vectorized 'KMER count L R\\n' rendering (kmer_dht.cpp:243-266 format)."""
    from ..constants import EXT_CALL_CHARS

    n = len(count)
    if n == 0:
        return b""
    chars = bk.decode_words_ascii(words, k)  # (n, k) ascii
    cnt = np.asarray(count, np.int64)
    ext_lut = np.frombuffer(EXT_CALL_CHARS.encode()[:8].ljust(8, b"?"), np.uint8)
    thresholds = 10 ** np.arange(1, 10, dtype=np.int64)
    ndig = 1 + (cnt[:, None] >= thresholds[None, :]).sum(1)
    D = int(ndig.max())
    pow10 = (10 ** np.arange(D - 1, -1, -1)).astype(np.int64)
    digits = ((cnt[:, None] // pow10) % 10 + ord("0")).astype(np.uint8)

    seg = k + 1 + ndig + 5  # KMER ' ' digits ' ' L ' ' R '\n'
    starts = np.zeros(n + 1, np.int64)
    np.cumsum(seg, out=starts[1:])
    out = np.empty(int(starts[-1]), np.uint8)
    rs = starts[:-1]
    out[rs[:, None] + np.arange(k)] = chars
    out[rs + k] = ord(" ")
    total_d = int(ndig.sum())
    dt = np.repeat(rs + k + 1, ndig) + (
        np.arange(total_d) - np.repeat(np.concatenate([[0], np.cumsum(ndig)[:-1]]), ndig)
    )
    out[dt] = digits[np.arange(D) >= (D - ndig)[:, None]]
    base = rs + k + 1 + ndig
    out[base] = ord(" ")
    out[base + 1] = ext_lut[np.minimum(np.asarray(left), 7)]
    out[base + 2] = ord(" ")
    out[base + 3] = ext_lut[np.minimum(np.asarray(right), 7)]
    out[base + 4] = ord("\n")
    return out.tobytes()


class KmerCountStore:
    """Accumulates k-mer count records for one k round on one device."""

    # the monolithic ctg-rule application handles up to this many rows;
    # above it the reference folds by key range (not ported yet)
    RANGED_FOLD_MIN_ROWS = 24_000_000

    def __init__(self, k: int, dmin_thres: int = 2, device="cuda",
                 raw_budget_bytes: int | None = None):
        self.k = k
        self.dmin_thres = dmin_thres
        self.device = torch.device(device)
        self.W = words32_for_k(k)
        if not C.payload_fits_in_keys(k, self.W):
            raise NotImplementedError(
                f"k={k}: the separate-payload raw layout (k=63/77) is not ported "
                "yet: ROADMAP queue 1 item 3"
            )
        if raw_budget_bytes is None:
            # the reference's sizing (kmer_store.py:216-227): a small fraction
            # of free device memory, since past it the runs collapse
            from ..utils.memlog import get_free_device_mem_bytes

            dev_free = get_free_device_mem_bytes(self.device)
            raw_budget_bytes = (
                min(2 << 30, max(128 << 20, dev_free // 64)) if dev_free else 2 << 30
            )
        self.raw_budget_bytes = raw_budget_bytes
        self.raw_runs: list[tuple] = []  # sorted packed lanes per block
        self.ctg_runs: list[tuple] = []
        self.stats = dict(raw_rows=0, raw_bytes=0, blocks=0, ctg_rule_rows=0)

    # -- read pass ---------------------------------------------------------

    def add_reads_block(self, codes, qual_ok, lens):
        """Count one block of reads (numpy codes (B,L) u8, qual_ok (B,L) bool,
        lens (B,) int32): ONE sorted packed run, trimmed to its valid rows
        (max(0, len-k-1) per read, known on the host)."""
        lens_np = np.asarray(lens, np.int32)
        n_valid = int(np.maximum(lens_np.astype(np.int64) - self.k - 1, 0).sum())
        dev = self.device
        run = C.block_to_raw_run(
            torch.from_numpy(np.ascontiguousarray(codes)).to(dev),
            torch.from_numpy(np.ascontiguousarray(qual_ok)).to(dev),
            torch.from_numpy(lens_np).to(dev), self.k,
        )
        self.raw_runs.append(tuple(x[:n_valid].clone() for x in run))
        self.stats["blocks"] += 1
        self.stats["raw_rows"] += n_valid
        if self._raw_bytes() > self.raw_budget_bytes:
            raise NotImplementedError(
                f"k={self.k}: raw runs of {self._raw_bytes()} bytes exceed the raw "
                f"budget of {self.raw_budget_bytes} bytes; the collapse into the "
                "split LSM is not ported yet: ROADMAP queue 1 item 9"
            )

    def _raw_bytes(self) -> int:
        return sum(x.numel() * x.element_size() for run in self.raw_runs for x in run)

    # -- contig pass (rounds >= 2) ----------------------------------------

    def add_ctgs_block(self, codes, lens, depths):
        """Add contig k-mers with per-contig depth (reference kcount.cpp:100-138).

        Runs are trimmed to occupancy, then padded to pow2 rows with sentinel
        tails, and merged LSM-style."""
        dev = self.device
        codes_t = torch.from_numpy(np.ascontiguousarray(codes)).to(dev)
        rec = C.read_kmer_records(
            codes_t, torch.ones_like(codes_t, dtype=torch.bool),
            torch.from_numpy(np.asarray(lens, np.int32)).to(dev), self.k,
            depth=torch.from_numpy(np.asarray(depths, np.int32)).to(dev),
        )
        agg = _aggregate_ctg_records(rec["words"], rec["left"], rec["right"], rec["count"],
                                     rec["valid"])
        P = min(C.trim_rows(int(agg[4])), agg[0].shape[0])
        agg = tuple(x[:P] for x in agg[:4]) + (agg[4],)
        _push_run(self.ctg_runs, _pad_ctg_pow2(agg), _merge_ctg_padded)

    def _merged_ctgs(self):
        while len(self.ctg_runs) > 1:
            b = self.ctg_runs.pop()
            a = self.ctg_runs.pop()
            self.ctg_runs.append(_merge_ctg_padded(*a[:4], *b[:4]))
        return self.ctg_runs[0] if self.ctg_runs else None

    # -- finalize ----------------------------------------------------------

    def _apply_ctg_rules_ranged(self, r, c):
        """ctg-rule application + finalize; the reference's key-range
        partitioned form above RANGED_FOLD_MIN_ROWS is not ported yet."""
        total = int(r[4]) + int(c[4])
        self.stats["ctg_rule_rows"] = total
        if total > self.RANGED_FOLD_MIN_ROWS:
            raise NotImplementedError(
                f"k={self.k}: {total} ctg-rule rows exceed RANGED_FOLD_MIN_ROWS; the "
                "ranged ctg-rule fold is not ported yet: ROADMAP queue 1 item 9"
            )
        merged = _apply_ctg_rules(*r, *c, self.dmin_thres)
        return C.finalize_table(*merged, dmin_thres=self.dmin_thres)

    def finalize(self) -> FinalTable:
        has_ctg = bool(self.ctg_runs)
        weff = -(-2 * self.k // 32)
        if self.raw_runs:
            merged = C.merge_raw_runs(self.raw_runs)
        else:
            merged = tuple(torch.empty((0,), dtype=torch.int32, device=self.device)
                           for _ in range(weff))
        self.raw_runs = []
        self.stats["raw_bytes"] = sum(x.numel() * 4 for x in merged)
        if not has_ctg:
            out = C.final_from_sorted_packed(merged, self.k, self.W,
                                             dmin_thres=self.dmin_thres, purge=True)
            return FinalTable(self.k, *out)
        agg = C.final_from_sorted_packed(merged, self.k, self.W,
                                         dmin_thres=self.dmin_thres, purge=False)
        del merged
        return FinalTable(self.k, *self._apply_ctg_rules_ranged(agg, self._merged_ctgs()))


def _push_run(runs, agg, merge_fn):
    """LSM merge: keep runs geometrically sized to bound total merges."""
    runs.append(agg)
    while len(runs) >= 2 and runs[-1][0].shape[0] >= runs[-2][0].shape[0] // 2:
        b = runs.pop()
        a = runs.pop()
        runs.append(merge_fn(*a[:4], *b[:4]))


# ---------------------------------------------------------------------------
# contig-kmer aggregation: track (min pair, max pair, min depth) per kmer
# ---------------------------------------------------------------------------


def _pad_ctg_pow2(agg):
    """Pad a deduped ctg run to pow2 rows (>= 256) with sentinel tails."""
    w, pmin, pmax, dmin, n = agg
    N = w.shape[0]
    P = 1 << max(8, (N - 1).bit_length())
    if P == N:
        return agg
    pad = P - N
    w = torch.cat([w, torch.full((pad, w.shape[1]), ONES, dtype=torch.int32, device=w.device)])
    z = torch.zeros((pad,), dtype=pmin.dtype, device=w.device)
    return (w, torch.cat([pmin, z]), torch.cat([pmax, z]), torch.cat([dmin, z]), n)


def _merge_ctg_padded(*args):
    return _pad_ctg_pow2(_merge_ctg_aggregates(*args))


def _pack_ctg(pmin, pmax, dmin):
    """pmin | pmax << 6 | dmin << 16 in one u32 lane (pairs are 0..45)."""
    return narrow(
        pmin.to(torch.int64) | (pmax.to(torch.int64) << 6)
        | (torch.clamp(dmin.to(torch.int64), 0, MAX_KMER_COUNT) << 16)
    )


def _unpack_ctg(p):
    p = widen(p)
    return (p & 0x3F).to(torch.int32), ((p >> 6) & 0x3F).to(torch.int32), (p >> 16).to(torch.int32)


def _ctg_compact(w, keep, packed):
    """Stable compaction of kept ctg rows (compact kernel)."""
    u_words, packed, n = C._compact_keep(w, keep, (packed,))
    pmin, pmax, dmin = _unpack_ctg(packed)
    return u_words, pmin, pmax, dmin, n


def _is_sentinel_row(w):
    return (w == ONES).all(dim=-1)


def _aggregate_ctg_records(words, left, right, count, valid):
    """Dedup ctg records into (words, pair_min, pair_max, depth_min, n):
    one stable lexsort carrying a packed (pair | depth << 8) lane, then
    per-group min/max (scatter_reduce over group ids) read at group-last
    rows, then one stable compaction."""
    w = C._sentinelize(words, valid)
    pair = left.to(torch.int64) * 8 + right.to(torch.int64)
    depth = torch.clamp(count.to(torch.int64), 0, MAX_KMER_COUNT)
    W = w.shape[-1]
    out = lexsort_lanes(tuple(w[:, i] for i in range(W)) + (narrow(pair | (depth << 8)),), W)
    w = torch.stack(out[:W], dim=-1)
    pv = widen(out[W])
    pair_v, depth_v = pv & 0xFF, pv >> 8
    N = w.shape[0]
    neq = ~rows_equal_next(out[:W])
    one = torch.ones((1,), dtype=torch.bool, device=w.device)
    is_start = torch.cat([one, neq])
    is_last = torch.cat([neq, one])
    gid = torch.cumsum(is_start.to(torch.int64), 0) - 1
    G = int(gid[-1]) + 1 if N else 0

    def seg(x, how):
        init = torch.zeros((G,), dtype=torch.int64, device=w.device)
        return init.scatter_reduce(0, gid, x, how, include_self=False)[gid]

    keep = is_last & ~_is_sentinel_row(w)
    return _ctg_compact(w, keep, _pack_ctg(seg(pair_v, "amin"), seg(pair_v, "amax"),
                                           seg(depth_v, "amin")))


def _merge_ctg_aggregates(a_w, a_pmin, a_pmax, a_dmin, b_w, b_pmin, b_pmax, b_dmin):
    """Merge two deduped ctg runs (sort kernel): key multiplicity <= 2, so
    the combine needs only the previous row."""
    W = a_w.shape[-1]
    lanes = lambda w, pmn, pmx, dmn: tuple(w[:, i].contiguous() for i in range(W)) + (  # noqa: E731
        _pack_ctg(pmn, pmx, dmn),
    )
    out = merge_sorted_lanes(lanes(a_w, a_pmin, a_pmax, a_dmin),
                             lanes(b_w, b_pmin, b_pmax, b_dmin), W)
    w = torch.stack(out[:W], dim=-1)
    pmin, pmax, dmin = _unpack_ctg(out[W])
    neq = ~rows_equal_next(out[:W])
    zero = torch.zeros((1,), dtype=torch.bool, device=w.device)
    same = torch.cat([zero, ~neq])
    is_last = torch.cat([neq, ~zero])
    sh = lambda x: torch.cat([x[:1], x[:-1]])  # noqa: E731
    pmin = torch.where(same, torch.minimum(pmin, sh(pmin)), pmin)
    pmax = torch.where(same, torch.maximum(pmax, sh(pmax)), pmax)
    dmin = torch.where(same, torch.minimum(dmin, sh(dmin)), dmin)
    keep = is_last & ~_is_sentinel_row(w)
    return _ctg_compact(w, keep, _pack_ctg(pmin, pmax, dmin))


def _apply_ctg_rules(r_words, r_count, r_l4, r_r4, r_n,
                     c_words, c_pmin, c_pmax, c_dmin, c_n, dmin_thres: int):
    """Merge the read table with the deterministic ctg-kmer resolution
    (reference kcount_cpu.cpp:357-406): a read-table UU k-mer with count >= 2
    wins; otherwise the ctg entry replaces it with count = min depth over
    agreeing occurrences, or 0 on ext disagreement."""
    dev = r_words.device
    conflict = c_pmin != c_pmax
    c_count = torch.where(conflict, 0, torch.clamp(c_dmin, 0, MAX_KMER_COUNT)).to(torch.int32)
    c_left = torch.where(conflict, EXT_X, c_pmin // 8).to(torch.int64)
    c_right = torch.where(conflict, EXT_X, c_pmin % 8).to(torch.int64)
    c_valid = torch.arange(c_words.shape[0], device=dev) < c_n
    ar4 = torch.arange(4, device=dev)[None, :]
    c_l4 = (c_left[:, None] == ar4).to(torch.int32) * c_count[:, None]
    c_r4 = (c_right[:, None] == ar4).to(torch.int32) * c_count[:, None]

    # read-entry survival: UU with clamped count >= 2
    rc = torch.clamp(r_count.to(torch.int64), max=MAX_KMER_COUNT)
    r_lcall = C._get_ext_calls(torch.clamp(r_l4.to(torch.int64), max=MAX_KMER_COUNT), rc, dmin_thres)
    r_rcall = C._get_ext_calls(torch.clamp(r_r4.to(torch.int64), max=MAX_KMER_COUNT), rc, dmin_thres)
    r_valid = torch.arange(r_words.shape[0], device=dev) < r_n
    r_keep = r_valid & (rc >= 2) & (r_lcall < 4) & (r_rcall < 4)

    # both sides are sorted: ONE stable merge (reads first on equal keys)
    # carrying the source flags and packed sums; a key occurs at most once
    # per side, so each group is at most (read, ctg)
    W = r_words.shape[-1]

    def side(words, valid, count, l4, r4, flags):
        w = C._sentinelize(words, valid)
        return tuple(w[:, i].contiguous() for i in range(W)) + (flags,) + C._pack_sums(count, l4, r4)

    r_flags = (r_valid.to(torch.int32) | (r_keep.to(torch.int32) << 1))
    c_flags = c_valid.to(torch.int32) << 2
    out = merge_sorted_lanes(side(r_words, r_valid, r_count, r_l4, r_r4, r_flags),
                             side(c_words, c_valid, c_count, c_l4, c_r4, c_flags), W)
    words = torch.stack(out[:W], dim=-1)
    flags = out[W]
    count, l4, r4 = C._unpack_sums(*out[W + 1 :])
    is_read = (flags & 1).bool()
    keep_read = ((flags >> 1) & 1).bool()
    is_ctg = ((flags >> 2) & 1).bool()

    neq = ~rows_equal_next(out[:W])
    zero = torch.zeros((1,), dtype=torch.bool, device=dev)
    same_prev = torch.cat([zero, ~neq])
    is_last = torch.cat([neq, ~zero])
    sh = lambda x: torch.cat([x[:1], x[:-1]])  # noqa: E731
    nb = lambda m: same_prev & sh(m)  # noqa: E731
    # group flags as seen from the group's LAST row (group size <= 2)
    g_has_read = is_read | nb(is_read)
    g_keep_read = keep_read | nb(keep_read)
    g_has_ctg = is_ctg | nb(is_ctg)
    use_read = g_has_read & (g_keep_read | ~g_has_ctg)
    own_sel = (is_read & use_read) | (is_ctg & ~use_read)
    prev_sel = (nb(is_read) & use_read) | (nb(is_ctg) & ~use_read)
    add = lambda x, so, sp: torch.where(so, x, 0) + torch.where(sp, sh(x), 0)  # noqa: E731
    g_count = torch.clamp(add(count, own_sel, prev_sel), max=MAX_KMER_COUNT)
    g_l4 = torch.clamp(add(l4, own_sel[:, None], prev_sel[:, None]), max=MAX_KMER_COUNT)
    g_r4 = torch.clamp(add(r4, own_sel[:, None], prev_sel[:, None]), max=MAX_KMER_COUNT)

    keep = is_last & ~_is_sentinel_row(words)
    u_words, *pays, n_unique = C._compact_keep(words, keep, C._pack_sums(g_count, g_l4, g_r4))
    u_count, u_l4, u_r4 = C._unpack_sums(*pays)
    return u_words, u_count, u_l4, u_r4, n_unique
