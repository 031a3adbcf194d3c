"""End-to-end contigging pipeline (port of mhm2_proxy_tpu/models/assembler.py;
reference src/main.cpp + src/contigging.cpp).

FASTQ ingest -> paired merge -> per-k rounds of (k-mer counting [+ contig
k-mers from the previous round] -> de Bruijn traversal) -> final contigs.
The per-round flow mirrors contigging<MAX_K> (contigging.cpp:93-158) and
analyze_kmers (kcount.cpp:140-157). n_shards > 0 counts and traverses over
that many shards (parallel/sharded.py), all on the run's one device, or in
a multi-process run (parallel/multihost.py::init_multihost) over the
processes, each counting the reads of its own byte range of the input
(fastq.cpp:399-455) in blocks of a shape and a number that every rank
agrees on; with n_hosts > 1 the shards form (n_hosts, n_shards / n_hosts)
and count through the hierarchical exchange (parallel/multihost.py). Rank 0
alone writes the FASTA files, whose contigs every rank holds.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..constants import (
    DEFAULT_KMER_LENS,
    DEFAULT_MIN_CTG_PRINT_LEN,
    DEFAULT_QUAL_OFFSET,
    DEFAULT_DMIN_THRES,
    QUAL_CUTOFF,
)
from ..io.fastq import split_paired_fname
from ..io.fasta import write_fasta
from ..io.merge import merge_reads_arrays
from ..io.reads import PackedReads
from ..io.stream import stream_fastq_blocks
from ..kcount import KmerCountStore
from ..kcount.kmer_store import render_kmer_dump
from ..dbjg import traverse_debruijn_graph, traverse_debruijn_graph_sharded
from ..ops.bitkmer import ascii_to_codes
from ..parallel import comm
from ..utils import trace
from ..utils.logger import get_logger


def resolve_block_reads(block_reads: int, device) -> int:
    """0 = auto: 131072 reads per block on CUDA (fewer, larger runs to merge),
    4096 on the CPU (small test runs)."""
    if block_reads:
        return block_reads
    return 131072 if torch.device(device).type == "cuda" else 4096


@dataclasses.dataclass
class AssemblerConfig:
    kmer_lens: tuple = DEFAULT_KMER_LENS
    qual_offset: int = DEFAULT_QUAL_OFFSET
    dmin_thres: int = DEFAULT_DMIN_THRES
    min_ctg_print_len: int = DEFAULT_MIN_CTG_PRINT_LEN
    # reads per device block; 0 = auto (131072 on CUDA, 4096 on CPU)
    block_reads: int = 0
    pad_len_quantum: int = 32  # pad read length up to a multiple -> few shapes
    chunk_bytes: int = 8 << 20  # streaming-ingest chunk size (bounded memory)
    checkpoint: bool = False
    output_dir: str = "."
    verbose: bool = False
    dump_kmers: bool = False
    device: str = "cuda"
    # >0: count and traverse over this many shards, all on `device` (the
    # analog of the reference's backend seam, kcount.hpp:57-69)
    n_shards: int = 0
    # per-destination exchange bucket rows of the sharded counter (None: auto)
    bucket_cap: int | None = None
    # >1 lays the n_shards shards out as (n_hosts, n_shards / n_hosts) and
    # counts through the hierarchical two-stage exchange with supermers
    # (parallel/multihost.py)
    n_hosts: int = 0


@dataclasses.dataclass
class Contig:
    id: int
    seq: str
    depth: float


class Assembler:
    def __init__(self, config: AssemblerConfig | None = None):
        self.cfg = config or AssemblerConfig()
        self.log = get_logger(verbose=self.cfg.verbose)
        self.packed_reads = PackedReads(self.cfg.qual_offset)
        self.contigs: list[Contig] = []
        self._next_read_id: int | None = None
        # this rank holds only its own share of the reads (read_split()); the
        # others hold the rest
        self.own_reads = False
        self.device = torch.device(self.cfg.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device cuda requested but torch.cuda.is_available() is False")
        self.round_stats: dict[int, dict] = {}

    # -- ingest + merge ----------------------------------------------------

    # per-process read-id block stride (reference allocates
    # rank*(max_est+10000)*3 estimated blocks, merge_reads.cpp:258-260;
    # a fixed 2^44 stride guarantees disjointness with no communication)
    READ_ID_STRIDE = 1 << 44

    def read_split(self) -> tuple[int, int]:
        """(rank, ranks) of the input's split: each rank of a sharded
        multi-process run reads its own share (fastq.cpp:399-455); any
        other run reads all of it, (0, 1)."""
        if comm.world() > 1 and self.cfg.n_shards > 0:
            return comm.rank(), comm.world()
        return 0, 1

    def load_reads(self, reads_fnames: list[str], byte_range=None,
                   rank: int = 0, n_ranks: int = 1, validate_pairs: bool = True):
        """Stream FASTQ files (paired 'f1:f2' or interleaved) and merge pairs.

        Inputs are streamed in bounded-memory chunks (io/stream.py; the
        reference streams rank byte ranges, fastq.cpp:457-475) through the
        native C++ parser when available. rank/n_ranks split each input by
        bytes for multi-process ingest: interleaved files are cut between
        pairs (parallel/multihost.py::interleaved_pair_range; fastq.cpp:399-455);
        two-file pairs are aligned to a
        common PAIR boundary per file (set_matching_pair, fastq.cpp:310-396)
        so same-ordinal records are guaranteed mates even when the files
        have different record byte sizes. byte_range overrides the split for
        single-file inputs only. With validate_pairs, mate headers are
        normalized and checked block-vectorized (get_fq_name,
        fastq.cpp:73-122) and a mis-paired input dies loudly.
        """
        from ..io.fastq import check_pair_block
        from ..io.stream import matching_pair_ranges

        if self._next_read_id is None:
            self._next_read_id = rank * self.READ_ID_STRIDE
        self.own_reads |= n_ranks > 1
        cfg = self.cfg
        B = resolve_block_reads(cfg.block_reads, self.device)
        kw = dict(
            pad_quantum=cfg.pad_len_quantum, qual_offset=cfg.qual_offset,
            chunk_bytes=cfg.chunk_bytes,
        )

        def die_mispaired(fname, hdrs1, hdrs2, bad):
            h1 = bytes(hdrs1[0][bad][: hdrs1[1][bad]]) if bad < len(hdrs1[1]) else b"<eof>"
            h2 = bytes(hdrs2[0][bad][: hdrs2[1][bad]]) if bad < len(hdrs2[1]) else b"<eof>"
            raise ValueError(
                f"mis-paired input {fname}: record {bad}: {h1!r} vs {h2!r} "
                "are not mates (reference merge_reads.cpp:346-348 dies here too)"
            )

        for fname in reads_fnames:
            f1, f2 = split_paired_fname(fname)
            if f2 is not None:
                if n_ranks > 1:
                    br1, br2 = matching_pair_ranges(f1, f2, rank, n_ranks)
                else:
                    br1 = br2 = byte_range
                it2 = _parsed_blocks(f2, B, br2, validate_pairs, kw)
                for blk1 in _parsed_blocks(f1, B, br1, validate_pairs, kw):
                    c1, q1, l1, n1 = blk1[:4]
                    blk2 = next(it2, None)
                    if blk2 is None:
                        raise ValueError(f"paired files record mismatch: {f2} ran out first")
                    c2, q2, l2, n2 = blk2[:4]
                    if n1 != n2:
                        raise ValueError(f"paired files record mismatch: {n1} vs {n2}")
                    if validate_pairs:
                        hdrs1, hdrs2 = blk1[4], blk2[4]
                        with trace.span("ingest.pairs"):
                            bad = check_pair_block(
                                hdrs1[0][:n1], hdrs1[1][:n1], hdrs2[0][:n2], hdrs2[1][:n2]
                            )
                        if bad >= 0:
                            die_mispaired(fname, hdrs1, hdrs2, bad)
                    self._merge_blocks(c1, q1, l1, c2, q2, l2)
                if next(it2, None) is not None:
                    raise ValueError(f"paired files record mismatch: {f1} ran out first")
            else:
                br = byte_range
                if br is None and n_ranks > 1:
                    from ..parallel.multihost import interleaved_pair_range

                    br = interleaved_pair_range(f1, rank, n_ranks)
                for blk in _parsed_blocks(f1, 2 * B, br, validate_pairs, kw):
                    c, q, l, n = blk[:4]
                    if validate_pairs:
                        hm, hl = blk[4]
                        m = 2 * (n // 2)  # a dangling trailing record is not an error
                        with trace.span("ingest.pairs"):
                            bad = check_pair_block(
                                hm[0:m:2], hl[0:m:2], hm[1:m:2], hl[1:m:2]
                            )
                        if bad >= 0:
                            die_mispaired(fname, (hm[0::2], hl[0::2]), (hm[1::2], hl[1::2]), bad)
                    self._merge_blocks(c[0::2], q[0::2], l[0::2], c[1::2], q[1::2], l[1::2])
        self.log.info(
            f"Merged {getattr(self, '_n_merged', 0)}/{getattr(self, '_n_pairs', 0)} pairs"
        )
        self.log.info(
            f"Loaded {len(self.packed_reads)} reads, {self.packed_reads.total_bases} bases"
        )

    def add_interleaved(self, seqs, quals):
        """Merge interleaved mates (seqs[0::2] with seqs[1::2]) and pack them."""
        c, q, l = _lists_to_block(seqs, quals, self.cfg.pad_len_quantum, self.cfg.qual_offset)
        self._merge_blocks(c[0::2], q[0::2], l[0::2], c[1::2], q[1::2], l[1::2])

    def add_unpaired(self, seqs, quals):
        c, q, l = _lists_to_block(seqs, quals, self.cfg.pad_len_quantum, self.cfg.qual_offset)
        # unpaired reads get a pair id block like the reference's dummy-mate
        # convention (merge_reads.cpp:306-312): 2 ids per read, mate-1 sign
        ids = -(self._take_read_ids(len(l)) + 1)
        self.packed_reads.add_block(c, q, l, ids=ids)

    def _take_read_ids(self, n_pairs: int) -> np.ndarray:
        """Allocate n_pairs read-id bases (2 ids per pair, reference
        merge_reads.cpp:306-329 read_id += 2)."""
        if self._next_read_id is None:
            self._next_read_id = 0
        base = self._next_read_id
        self._next_read_id += 2 * n_pairs
        return base + 2 * np.arange(n_pairs, dtype=np.int64)

    def _merge_blocks(self, c1, q1, l1, c2, q2, l2):
        """Merge aligned pair blocks and pack results (block-vectorized)."""
        cfg = self.cfg
        with trace.span("ingest.pack"):
            # equalize widths
            L = max(c1.shape[1], c2.shape[1])
            pad = lambda a, v: (
                a if a.shape[1] == L
                else np.pad(a, ((0, 0), (0, L - a.shape[1])), constant_values=v)
            )
            c1, c2 = pad(c1, 4), pad(c2, 4)
            q1, q2 = pad(q1, cfg.qual_offset), pad(q2, cfg.qual_offset)
        with trace.span("ingest.merge"):
            out = merge_reads_arrays(c1, q1, l1, c2, q2, l2, qual_offset=cfg.qual_offset,
                                     device=self.device)
            both = (l1 > 0) & (l2 > 0)
            merged = out["merged"] & both
            mi = np.nonzero(merged)[0]
            n_pairs = int(both.sum())
            trace.count("pairs", n_pairs)
            trace.count("merged", int(mi.size))
        with trace.span("ingest.pack"):
            ui = np.nonzero(~merged & ((l1 > 0) | (l2 > 0)))[0]
            # signed int64 identity (packed_reads.cpp:74-75): pair base id + 1,
            # negative mate 1 / positive mate 2; merged reads carry the mate-1 id
            ids = self._take_read_ids(c1.shape[0])
            if mi.size:
                self.packed_reads.add_block(
                    out["m_codes"][mi], out["m_quals"][mi], out["m_len"][mi],
                    ids=-(ids[mi] + 1),
                )
            if ui.size:
                self.packed_reads.add_block(c1[ui], out["quals1_z"][ui], l1[ui],
                                            ids=-(ids[ui] + 1))
                self.packed_reads.add_block(c2[ui], out["quals2_z"][ui], l2[ui], ids=ids[ui] + 1)
        self._n_merged = getattr(self, "_n_merged", 0) + int(mi.size)
        self._n_pairs = getattr(self, "_n_pairs", 0) + n_pairs
        self.log.debug(f"Merged {mi.size}/{(l1 > 0).sum()} pairs in block")

    def load_merged_reads(self, fname: str):
        """Reload a --checkpoint-merged FASTQ: the reads are already merged,
        so ingest skips the pair merge (the reference's --restart consumes
        *-merged.fastq the same way, docs/mhm_guide.md:197-210). Read ids
        round-trip through the r<id>/<mate> names. Under read_split() a rank
        keeps every n-th read from its rank on: a k-mer's count sums the
        ranks' reads, whichever rank holds each."""
        from ..io.fastq import parse_rid_headers

        cfg = self.cfg
        rank, n_ranks = self.read_split()
        self.own_reads |= n_ranks > 1
        B = resolve_block_reads(cfg.block_reads, self.device)
        hi_id = 0
        row0 = 0
        for c, q, l, n, (hm, hl) in stream_fastq_blocks(
            fname, B, pad_quantum=cfg.pad_len_quantum, qual_offset=cfg.qual_offset,
            chunk_bytes=cfg.chunk_bytes, with_ids=True,
        ):
            ids = parse_rid_headers(hm[:n], hl[:n])
            if ids.size:
                hi_id = max(hi_id, int(np.abs(ids).max()))
            mine = slice((rank - row0) % n_ranks, n, n_ranks)
            self.packed_reads.add_block(c[mine], q[mine], l[mine], ids=ids[mine])
            row0 += n
        self._next_read_id = hi_id  # continue past the reloaded block
        self.log.info(f"Reloaded {len(self.packed_reads)} merged reads from {fname}")

    def dump_merged_reads(self, fname: str):
        """Write the merged/packed read set as FASTQ (reference
        --checkpoint-merged, merged fname convention utils.cpp:154-161).
        Vectorized block rendering (io/fastq.py render_fastq_block) — no
        per-read Python at arctic scale. Ranks that hold their own reads
        append them in rank order, one gzip member each."""
        import gzip

        from ..io.fastq import render_fastq_block

        opener = gzip.open if fname.endswith(".gz") else open
        ranks = comm.world() if self.own_reads else 1
        for r in range(ranks):
            if r == comm.rank():
                with opener(fname, "ab" if r else "wb") as f:
                    for codes, quals, lens, ids in self.packed_reads.blocks(65536, with_ids=True):
                        f.write(render_fastq_block(ids, codes, quals, lens))
            if ranks > 1:
                comm.barrier()

    # -- contigging rounds -------------------------------------------------

    def _make_store(self, k: int):
        cfg = self.cfg
        if cfg.n_shards > 0:
            if cfg.n_hosts > 1:
                from ..parallel import HierarchicalCounter

                if cfg.n_shards % cfg.n_hosts:
                    raise ValueError(f"{cfg.n_shards} shards do not divide over "
                                     f"{cfg.n_hosts} hosts")
                return HierarchicalCounter(k, (cfg.n_hosts, cfg.n_shards // cfg.n_hosts),
                                           dmin_thres=cfg.dmin_thres, bucket_cap=cfg.bucket_cap,
                                           device=self.device)
            from ..parallel import ShardedCounter

            return ShardedCounter(k, cfg.n_shards, dmin_thres=cfg.dmin_thres,
                                  bucket_cap=cfg.bucket_cap, device=self.device)
        return KmerCountStore(k, dmin_thres=cfg.dmin_thres, device=self.device)

    def _estimate_num_kmers(self, k: int) -> int:
        """Estimated k-mer records this round (reference contigging.cpp:61-91
        samples reads; the packed store knows totals exactly)."""
        n = len(self.packed_reads)
        return max(self.packed_reads.total_bases - n * (k + 1), 0)

    def run_round(self, k: int) -> list[Contig]:
        """One contigging round (reference contigging.cpp:93-158): the
        spans `count`, `traverse` and `write_fasta` (its callers open the
        round's own, `round` with its k)."""
        cfg = self.cfg
        sharded = cfg.n_shards > 0
        with trace.span("count") as sp_count:
            store, table, n_blocks = self._count_round(k)
            n_kmers = int(table.n.sum()) if sharded else int(table.n)
        t_count = sp_count.seconds
        if sharded:
            self.log.info(
                f"k={k}: counted {n_kmers} kmers from {n_blocks} blocks in {t_count:.1f}s")
            self.log.info(f"k={k}: exchange {store.describe_exchange()}")
            if store.spilled:
                self.log.warning(
                    f"k={k}: minimizer-hash skew: {store.spilled} records re-sent over "
                    f"{store.spill_rounds} spill rounds (consider a larger --bucket-cap)")
            st = dict(records=store.stat_records, exchange_bytes=store.stat_bytes,
                      exchanged_kmers=store.stat_kmers, presummed=store.stat_collapsed,
                      resent=store.spilled, spill_rounds=store.spill_rounds)
        else:
            st = store.stats
            self.log.info(
                f"k={k}: counted {n_kmers} kmers from {n_blocks} blocks in {t_count:.1f}s "
                f"(raw rows {st['raw_rows']}, raw bytes {st['raw_bytes']}, "
                f"ctg-rule rows {st['ctg_rule_rows']})"
            )
        if cfg.dump_kmers:
            fname = f"{cfg.output_dir}/kmers-{k}.txt.gz"
            if sharded:
                self._dump_sharded_kmers(table, k, fname)
            else:
                table.dump_kmers(fname)
        tstats: dict = {}
        with trace.span("traverse") as sp_trav:
            if sharded:
                # the reference's sharded branch renders every path (no min_ctg_len)
                raw = traverse_debruijn_graph_sharded(table, k, stats=tstats)
            else:
                # k+2 usability bound: shorter contigs can never seed a later
                # (larger-k) round nor reach any output (min print len 500)
                raw = traverse_debruijn_graph(table, k, stats=tstats, min_ctg_len=k + 2)
            del table
            with trace.span("traverse.contigs"):
                self.contigs = [Contig(i, seq, depth)
                                for i, (seq, depth) in enumerate(sorted(raw))]
        t_trav = sp_trav.seconds
        self.log.info(f"k={k}: traversal -> {len(self.contigs)} contigs in {t_trav:.1f}s")
        term = tstats.get("terminations", {})
        self.log.info(
            f"k={k}: walk terminations deadend={term.get('deadend', 0)} "
            f"fork={term.get('fork', 0)} conflict={term.get('conflict', 0)} "
            f"repeat={term.get('repeat', 0)}"
        )
        if tstats.get("stitch_timings"):
            self.log.info(f"k={k}: stitch {tstats['stitch_timings']}")
        peak = (torch.cuda.max_memory_allocated(self.device)
                if self.device.type == "cuda" else 0)
        if sharded:
            sr = tstats["stitch_rounds"]
            self.log.info(
                f"k={k}: sharded stitch rounds {sr['doubling']}+{sr['cycle_min']}"
                f"+{sr['post_cut']} (static bound {sr['static_bound']} each), "
                f"all_to_all {tstats['stitch_all_to_all_bytes'] >> 20} MiB (the reference's "
                f"count), buckets moved {tstats['stitch_bucket_bytes'] >> 20} MiB"
            )
            self.log.info(f"k={k}: sharded count {t_count:.2f}s, traversal {t_trav:.2f}s; "
                          f"peak device memory {peak} bytes")
            st = dict(st, stitch_rounds=sr, stitch_bytes=tstats["stitch_all_to_all_bytes"],
                      stitch_bucket_bytes=tstats["stitch_bucket_bytes"])
        else:
            self.log.info(
                f"k={k}: split LSM collapses {st['collapses']}, cascade merges "
                f"{st['cascade_merges']}, deferrals {st['cascade_deferrals']}; ranged pieces "
                f"read {st['read_pieces']}, ctg-rule {st['ctg_pieces']}; peak device memory "
                f"{peak} bytes"
            )
        self.round_stats[k] = dict(
            st, kmers=n_kmers, contigs=len(self.contigs), count_s=t_count,
            traverse_s=t_trav, peak_bytes=peak,
        )
        if cfg.checkpoint and comm.rank() == 0:
            with trace.span("write_fasta"):
                write_fasta(
                    f"{cfg.output_dir}/contigs-{k}.fasta",
                    [(c.id, c.seq, c.depth) for c in self.contigs],
                )
        return self.contigs

    def _count_round(self, k: int):
        """The round's counting, up to its finalized table: the memory
        pre-flight, the store, every read block (`count.pack` making it,
        `count.reads` counting it), the contig pass and the finalize.
        Returns (store, table, read blocks)."""
        cfg = self.cfg
        # memory pre-flight (reference kmer_dht.cpp:119-131, main.cpp:107-130)
        est = self._estimate_num_kmers(k)
        from ..constants import words32_for_k
        from ..utils.memlog import get_free_device_mem_bytes, get_free_mem_bytes

        bytes_per_rec = 4 * words32_for_k(k) + 8 + 2 * 32  # words + count + exts
        want = est * bytes_per_rec * 2  # LSM transient factor
        free = get_free_mem_bytes()
        # on a GPU the binding constraint is device memory, not host RAM
        # (reference sizes from device memory, kcount_gpu.cpp:175-196)
        dev_free = get_free_device_mem_bytes(self.device)
        if dev_free:
            free = min(free, dev_free)
        if want > 0.8 * free:
            self.log.warning(
                f"k={k}: estimated {est} kmer records (~{want>>20} MiB) vs "
                f"{free>>20} MiB free; may run out of memory"
            )
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        store = self._make_store(k)
        q = cfg.pad_len_quantum
        L = max(((self.packed_reads.max_read_len + q - 1) // q) * q, k + q)
        # block-size backoff (reference kmer_dht.cpp:119-131): halve the block
        # until ~6 copies of its raw records fit half the free memory
        B = resolve_block_reads(cfg.block_reads, self.device)
        raw_rec_bytes = 4 * (words32_for_k(k) + 1)
        while B > 1024 and 6 * B * (L - k + 1) * raw_rec_bytes > 0.5 * free:
            B //= 2
        if comm.world() > 1:
            # the ranks' blocks have one shape: the widest reads, the smallest block
            with comm.stage(comm.COUNT_EXCHANGE):
                L, B = comm.all_max(L, -B)
            B = -B
        if B != resolve_block_reads(cfg.block_reads, self.device):
            self.log.warning(f"k={k}: block-size backoff to {B} reads/block to fit memory")
        if cfg.n_shards > 0 and B % cfg.n_shards:
            # each shard takes an equal slice of every block's rows
            raise ValueError(f"{B} reads a block do not divide over {cfg.n_shards} shards")
        n_blocks = 0
        for args in trace.iterate("count.pack", self._read_blocks(store, B, L, k)):
            with trace.span("count.reads"):
                store.add_reads_block(*args)
            n_blocks += 1
        if self.contigs:
            self._add_ctg_kmers(store, k)
        with trace.span("count.finalize"):
            table = store.finalize()
        return store, table, n_blocks

    def _read_blocks(self, store, B: int, L: int, k: int):
        """The round's read blocks as add_reads_block's arguments: codes,
        the quality mask and lengths, from the reads' counting blocks
        (PackedReads.count_blocks, built in the job's first round). A rank
        that holds its own reads (read_split()) passes them in blocks of
        B / S rows a local shard, as many blocks as the rank with most reads
        makes, the rest empty; a rank that holds every read passes its
        shards' rows of each block."""
        reads = self.packed_reads
        kw = dict(qual_cut=self.cfg.qual_offset + QUAL_CUTOFF, min_len=k,
                  pin=self.device.type == "cuda")
        if self.own_reads and hasattr(store, "n_local"):
            b = B // store.S * store.n_local
            with comm.stage(comm.COUNT_EXCHANGE):
                n_blocks = comm.all_max(reads.n_blocks(b))
            yield from reads.count_blocks(b, L, n_blocks=n_blocks, **kw)
        else:
            for blk in reads.count_blocks(B, L, **kw):
                yield _rank_rows(store, *blk)

    @staticmethod
    def _dump_sharded_kmers(table, k: int, fname: str):
        """--dump-kmers of a sharded table: every shard's rows in one key
        order (reference assembler.py:363-381)."""
        import gzip

        parts = [ft.to_numpy() for ft in table.shard_tables()]
        w = np.concatenate([p[0][: p[4]] for p in parts])
        order = np.lexsort(tuple(w[:, i] for i in range(w.shape[1] - 1, -1, -1)))
        cat = lambda j: np.concatenate([p[j][: p[4]] for p in parts])[order]  # noqa: E731
        with gzip.open(fname, "wb") as f:
            f.write(render_kmer_dump(w[order], cat(1), cat(2), cat(3), k))

    # cells (rows x padded length) per ctg-pass block
    CTG_CELL_BUDGET = 1 << 19
    # longest contig window fed to extraction (longer contigs chop with a
    # k+1 overlap)
    CTG_MAX_SEG = 2048

    def _add_ctg_kmers(self, store, k: int):
        """Second pass: contig k-mers with depth (reference kcount.cpp:100-138).

        Contigs are chopped into windows of at most CTG_MAX_SEG bases with a
        k+1 overlap, so consecutive windows' valid k-mer ranges (positions
        1..len-k-1) are exactly contiguous and every interior k-mer lands in
        exactly one window with its true extension bases; the windows are
        packed into fixed (rows, CTG_MAX_SEG) blocks.
        """
        with trace.span("count.contigs"):
            cfg = self.cfg
            ctgs = [c for c in self.contigs if len(c.seq) >= k + 2]
            if not ctgs:
                return
            seg = self.CTG_MAX_SEG
            windows = []  # (seq, depth)
            for c in ctgs:
                if len(c.seq) <= seg:
                    windows.append((c.seq, c.depth))
                else:
                    step = seg - (k + 1)
                    for st in range(0, len(c.seq) - (k + 1), step):
                        windows.append((c.seq[st : st + seg], c.depth))
            # each shard takes an equal slice of a block's rows
            row_q = 8 if cfg.n_shards == 0 else math.lcm(8, cfg.n_shards)
            cells = self.CTG_CELL_BUDGET * (8 if self.device.type == "cuda" else 1)
            B = max(row_q, cells // seg // row_q * row_q)
            for s0 in range(0, len(windows), B):
                chunk = windows[s0 : s0 + B]
                codes = np.full((B, seg), 4, np.uint8)
                lens = np.zeros(B, np.int32)
                deps = np.zeros(B, np.int32)
                for i, (seq, depth) in enumerate(chunk):
                    codes[i, : len(seq)] = ascii_to_codes(seq.encode())
                    lens[i] = len(seq)
                    deps[i] = min(max(int(depth), 0), 0xFFFF)
                store.add_ctgs_block(*_rank_rows(store, codes, lens, deps))

    def run(self, kmer_lens=None) -> list[Contig]:
        for k in kmer_lens or self.cfg.kmer_lens:
            with trace.span("round", k=k):
                self.run_round(k)
        self.packed_reads.release_count_blocks()
        return self.contigs

    # -- output ------------------------------------------------------------

    def dump_contigs(self, fname: str, min_len: int | None = None):
        """The contigs of at least min_len bases to fname (rank 0 of a
        multi-process run)."""
        if comm.rank() != 0:
            return
        min_len = self.cfg.min_ctg_print_len if min_len is None else min_len
        with trace.span("write_fasta"):
            write_fasta(fname, [(c.id, c.seq, c.depth) for c in self.contigs], min_len=min_len)

    def print_stats(self, min_len: int | None = None):
        """Assembly statistics (reference contigs.cpp:92-164)."""
        min_len = self.cfg.min_ctg_print_len if min_len is None else min_len
        lens = sorted((len(c.seq) for c in self.contigs if len(c.seq) >= min_len), reverse=True)
        tot = sum(lens)
        depths = [c.depth for c in self.contigs if len(c.seq) >= min_len]
        n50 = 0
        acc = 0
        for ln in lens:
            acc += ln
            if acc >= tot / 2:
                n50 = ln
                break
        stats = {
            "num_contigs": len(lens),
            "total_length": tot,
            "avg_depth": float(sum(depths) / len(depths)) if depths else 0.0,
            "max_length": lens[0] if lens else 0,
            "n50": n50,
        }
        for cut in (1, 5, 10, 25, 50):
            stats[f"ge_{cut}kbp"] = sum(ln for ln in lens if ln >= cut * 1000)
        self.log.info(f"Assembly stats (>= {min_len}bp): {stats}")
        return stats


def assemble(reads_fnames: list[str], config: AssemblerConfig | None = None):
    """Convenience entry point: full pipeline to final contigs."""
    asm = Assembler(config)
    asm.load_reads(reads_fnames)
    asm.run()
    asm.dump_contigs(f"{asm.cfg.output_dir}/final_assembly.fasta")
    asm.print_stats()
    return asm


def _parsed_blocks(fname: str, block_reads: int, byte_range, with_ids: bool, kw: dict):
    """stream_fastq_blocks of one file, the reading and parsing of each
    block (the consumer's next()) in an `ingest.parse` span that counts
    the FASTQ bytes read and the block's reads."""

    def counted():
        for blk in stream_fastq_blocks(fname, block_reads, byte_range=byte_range,
                                       with_ids=with_ids, **kw):
            trace.count("reads", int(blk[3]))
            yield blk

    return trace.iterate("ingest.parse", counted())


def _rank_rows(store, *arrays):
    """A replicated block's rows for this rank's shards: every rank of a
    multi-process run holds every contig (the traversal gathers them), and
    every read unless it ingested its own share, so each passes its
    shards' equal slices of a block's rows to a sharded store."""
    if comm.world() == 1 or not hasattr(store, "n_local"):
        return arrays
    if arrays[0].shape[0] % store.S:
        raise ValueError(f"{arrays[0].shape[0]} rows a block do not divide over "
                         f"{store.S} shards")
    b = arrays[0].shape[0] // store.S
    rows = slice(store.shard0 * b, (store.shard0 + store.n_local) * b)
    return tuple(a[rows] for a in arrays)


def _lists_to_block(seqs, quals, quantum: int, qual_offset: int, rows: int | None = None):
    maxlen = max((len(s) for s in seqs), default=1)
    L = ((maxlen + quantum - 1) // quantum) * quantum
    B = rows or len(seqs)
    codes = np.full((B, L), 4, np.uint8)
    q = np.full((B, L), qual_offset, np.uint8)
    lens = np.zeros((B,), np.int32)
    for i, (sq, ql) in enumerate(zip(seqs, quals)):
        sq = sq.encode() if isinstance(sq, str) else sq
        ql = ql.encode() if isinstance(ql, str) else ql
        codes[i, : len(sq)] = ascii_to_codes(sq)
        q[i, : len(ql)] = np.frombuffer(ql, np.uint8)
        lens[i] = len(sq)
    return codes, q, lens
