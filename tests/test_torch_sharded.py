"""The port's sharded path (parallel/sharded.py, dbjg/traverse_sharded.py,
dbjg/stitch_sharded.py) against the JAX package's on the 8-device virtual
CPU mesh, at tolerance 0: per-shard tables and every exchange statistic of
ShardedCounter (several blocks, the contig pass, spill rounds, the poly-A
storm that only the sender presum saves), sharded_lookup with a forced
retry, the edges and the stitch on the reference's own table, and a
two-round assembly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhm2_proxy_tpu.dbjg import traverse_debruijn_graph_sharded as ref_traverse
from mhm2_proxy_tpu.dbjg.traverse_sharded import build_edges_sharded as ref_build_edges
from mhm2_proxy_tpu.models import Assembler as RefAssembler
from mhm2_proxy_tpu.models import AssemblerConfig as RefConfig
from mhm2_proxy_tpu.oracle.pyref import count_kmers_oracle
from mhm2_proxy_tpu.parallel import ShardedCounter as RefCounter
from mhm2_proxy_tpu.parallel import make_shard_mesh
from mhm2_proxy_tpu.parallel import sharded_lookup as ref_lookup
from mhm2_proxy_tpu_torch.dbjg import traverse_debruijn_graph_sharded
from mhm2_proxy_tpu_torch.dbjg.traverse_sharded import build_edges_sharded
from mhm2_proxy_tpu_torch.io.fastq import write_fastq
from mhm2_proxy_tpu_torch.models import Assembler, AssemblerConfig
from mhm2_proxy_tpu_torch.ops.bitkmer import ascii_to_codes
from mhm2_proxy_tpu_torch.parallel import ShardedCounter, ShardedTable, sharded_lookup
from mhm2_proxy_tpu_torch.utils.synth import random_genome, simulate_reads
from tests.test_count import reads_to_block
from torch_common import one_torch_thread  # noqa: F401 (autouse fixture)

Q40 = chr(33 + 38)


def _read_set(rng, n_reads, L=64, G=400):
    genome = "".join(rng.choice(list("ACGT"), size=G))
    return [(genome[s : s + L], Q40 * L) for s in rng.integers(0, G - L, n_reads)]


def _storm(rng, n_reads=96, L=64):
    """Poly-A reads with random low-quality dips: every record routes to one
    shard, and only identical dip-free windows collapse on the sender."""
    reads = []
    for _ in range(n_reads):
        q = np.full(L, 33 + 38, np.uint8)
        q[rng.integers(0, L, 3)] = 33 + 2
        reads.append(("A" * L, "".join(chr(c) for c in q)))
    return reads


def _ctg_block(rng, reads, rows=8, L=256):
    codes = np.full((rows, L), 4, np.uint8)
    lens = np.zeros(rows, np.int32)
    deps = np.zeros(rows, np.int32)
    ctgs = [(reads[0][0] + reads[1][0], 9), ("".join(rng.choice(list("ACGT"), size=120)), 4),
            (reads[2][0] * 3, 30)]
    for i, (s, d) in enumerate(ctgs):
        codes[i, : len(s)] = ascii_to_codes(s.encode())
        lens[i], deps[i] = len(s), d
    return codes, lens, deps, ctgs


def _shard_rows(table):
    """Per shard: the live rows (words as uint32, count, left, right)."""
    out = []
    for ft in table.shard_tables():
        vals = [x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
                for x in (ft.words, ft.count, ft.left, ft.right, ft.n)]
        n = int(vals[4])
        out.append((vals[0].view(np.uint32)[:n].tolist(),)
                   + tuple(v[:n].tolist() for v in vals[1:4]))
    return out


def _stats(c):
    return (c.stat_kmers, c.stat_records, c.stat_bytes, c.stat_collapsed, c.spilled,
            c.spill_rounds, c.dropped, c.describe_exchange())


CASES = {
    # name: (S, bucket_cap, k, read blocks, contig pass, storm)
    "blocks": (8, 4096, 21, 2, False, False),
    "ctg_pass": (4, None, 33, 1, True, False),
    "tiny_cap_spills": (8, 16, 21, 2, False, False),
    "k77_spills_ctg": (2, 64, 77, 2, True, False),
    "poly_a_storm": (8, 256, 21, 1, False, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_counter_equals_reference(case):
    S, cap, k, n_blocks, ctg, storm = CASES[case]
    rng = np.random.default_rng(len(case))
    reads = _storm(rng) if storm else _read_set(rng, 96 * n_blocks)
    ref = RefCounter(k, make_shard_mesh(S), bucket_cap=cap)
    port = ShardedCounter(k, S, bucket_cap=cap, device="cpu")
    for b in range(n_blocks):
        blk = reads_to_block(reads[96 * b : 96 * (b + 1)], B=96, L=64 + (k > 64) * 32)
        ref.add_reads_block(*blk)
        port.add_reads_block(*blk)
    ctgs = None
    if ctg:
        codes, lens, deps, ctgs = _ctg_block(rng, reads)
        ref.add_ctgs_block(codes, lens, deps)
        port.add_ctgs_block(codes, lens, deps)
    want, got = ref.finalize(), port.finalize()
    assert _stats(port) == _stats(ref)
    assert _shard_rows(got) == _shard_rows(want)
    if not ctg:  # contig runs are trimmed to their occupancy in the port
        assert tuple(got.words.shape) == want.words.shape
    assert got.bound_rows == want.words.shape[1]  # the stitch's round bound
    merged = {}
    for ft in got.shard_tables():
        merged.update(ft.to_host_dict())
    assert merged == count_kmers_oracle(reads[: 96 * n_blocks], k, ctgs=ctgs)
    if "spill" in case:
        assert port.spill_rounds > 0 and port.spilled > 0
    if storm:
        assert port.stat_collapsed > 0
    assert port.dropped == 0


def _ref_table(S, rng, n_reads=96, k=21, cap=4096):
    reads = _read_set(rng, n_reads)
    counter = RefCounter(k, make_shard_mesh(S), bucket_cap=cap)
    counter.add_reads_block(*reads_to_block(reads, B=n_reads, L=64))
    want = counter.finalize()
    got = ShardedTable.from_reference(k, *(np.asarray(x) for x in (
        want.words, want.count, want.left, want.right, want.n)), device="cpu")
    return want, got


def test_sharded_lookup_with_retry_equals_reference():
    want_t, got_t = _ref_table(8, np.random.default_rng(3))
    n = np.asarray(want_t.n)
    Q = int(n.max())
    qw = np.roll(np.asarray(want_t.words[:, :Q]), 1, axis=0)
    qv = np.roll(np.arange(Q)[None, :] < n[:, None], 1, axis=0)
    qw[:, ::7, -1] ^= np.uint32(0x5A5A0000)  # some queries miss
    for cap in (None, max(Q // 4, 1)):  # the second overflows and retries
        want = ref_lookup(want_t, jnp.asarray(qw), jnp.asarray(qv), cap=cap)
        got = sharded_lookup(got_t, torch.from_numpy(qw.view(np.int32).copy()),
                             torch.from_numpy(qv.copy()), cap=cap)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        found = got[0].numpy()
        assert found[qv].mean() > 0.8 and not found[~qv].any()


@pytest.mark.parametrize("S", [2, 8])
def test_build_edges_on_reference_table(S):
    want_t, got_t = _ref_table(S, np.random.default_rng(S), n_reads=160)
    want, want_term = ref_build_edges(want_t, 21)
    got, got_term = build_edges_sharded(got_t, 21)
    for name in ("uu", "r_gid", "r_port", "r_ok", "l_gid", "l_port", "l_ok"):
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]), err_msg=name)
    np.testing.assert_array_equal(got_term.numpy(), want_term)
    assert got["r_ok"].any() and got["l_ok"].any()


@pytest.mark.parametrize("S", [4, 8])
def test_stitch_long_paths_and_cycle_on_reference_table(S):
    """Paths far longer than the local-advance window plus a cycle: the
    contigs, the executed rounds of each loop, their bound and the
    all_to_all volume equal the reference's."""
    k = 21
    rng = np.random.default_rng(42)
    genome = "".join(rng.choice(list("ACGT"), size=2400))
    circle = "".join(rng.choice(list("ACGT"), size=260))
    reads = [(genome[s : s + 64], Q40 * 64) for s in rng.integers(0, len(genome) - 64, 420)]
    ring = circle + circle[: k + 40]
    for s in range(0, len(circle), 24):
        reads += [(ring[s : s + 64], Q40 * 64)] * 2
    counter = RefCounter(k, make_shard_mesh(S), bucket_cap=65536)
    counter.add_reads_block(*reads_to_block(reads, B=1024, L=64))
    table = counter.finalize()
    want_stats, got_stats = {}, {}
    want = ref_traverse(table, k, stats=want_stats)
    got = traverse_debruijn_graph_sharded(ShardedTable.from_reference(k, *(np.asarray(x) for x in (
        table.words, table.count, table.left, table.right, table.n)), device="cpu"), k,
        stats=got_stats)
    assert sorted(got) == sorted(want) and len(got) > 2
    assert {key: got_stats[key] for key in want_stats} == want_stats
    assert set(got_stats["stitch_timings"]) == {"edges_s", "states_s", "render_s"}
    sr = got_stats["stitch_rounds"]
    assert sr["doubling"] == sr["static_bound"] and sr["post_cut"] < sr["static_bound"]


def test_two_round_assembly_s8_equals_reference(tmp_path):
    rng = np.random.default_rng(11)
    genome = random_genome(rng, 2500)
    ids, seqs, quals = simulate_reads(rng, genome, coverage=20.0, read_len=80, err_rate=0.002)
    fq = str(tmp_path / "reads.fastq")
    write_fastq(fq, ids, seqs, quals)
    kw = dict(kmer_lens=(21, 33), block_reads=256, n_shards=8, bucket_cap=16384)
    ref = RefAssembler(RefConfig(output_dir=str(tmp_path), **kw))
    ref.load_reads([fq])
    port = Assembler(AssemblerConfig(output_dir=str(tmp_path), device="cpu", **kw))
    port.load_reads([fq])
    want = [(c.seq, c.depth) for c in ref.run()]
    got = [(c.seq, c.depth) for c in port.run()]
    assert got == want and max(len(s) for s, _ in got) > 1000
    assert port.round_stats[33]["spill_rounds"] == 0 and port.round_stats[33]["records"] > 0


def test_two_round_stitch_rounds_with_cycle_equal_reference(tmp_path, monkeypatch):
    """A linear genome plus a circular one over two rounds: the k = 33 round
    has a contig pass (whose runs the port trims) and a cycle, whose doubling
    runs to the static bound. Every round's executed doubling, cycle-min and
    post-cut rounds, the bound and the reference's all_to_all count equal
    the reference's; the bytes the port's buckets move are its own."""
    import mhm2_proxy_tpu.dbjg as ref_dbjg

    rng = np.random.default_rng(5)
    genome, ring = random_genome(rng, 1500), random_genome(rng, 400)
    ids, seqs, quals = simulate_reads(rng, genome, coverage=20.0, read_len=80, err_rate=0.0)
    # the ring's reads: fragments of the ring read round its junction
    r_ids, r_seqs, r_quals = simulate_reads(rng, ring + ring[:300], coverage=30.0, read_len=80,
                                            err_rate=0.0)
    ids += [b"ring" + i for i in r_ids]
    seqs += r_seqs
    quals += r_quals
    fq = str(tmp_path / "reads.fastq")
    write_fastq(fq, ids, seqs, quals)
    want_stats = []
    ref_traverse_fn = ref_dbjg.traverse_debruijn_graph_sharded

    def capture(table, k, stats=None):
        out = ref_traverse_fn(table, k, stats=stats)
        want_stats.append((k, dict(stats)))
        return out

    monkeypatch.setattr(ref_dbjg, "traverse_debruijn_graph_sharded", capture)
    kw = dict(kmer_lens=(21, 33), block_reads=128, n_shards=4, bucket_cap=8192)
    ref = RefAssembler(RefConfig(output_dir=str(tmp_path), **kw))
    ref.load_reads([fq])
    port = Assembler(AssemblerConfig(output_dir=str(tmp_path), device="cpu", **kw))
    port.load_reads([fq])
    assert [(c.seq, c.depth) for c in port.run()] == [(c.seq, c.depth) for c in ref.run()]
    assert [k for k, _ in want_stats] == [21, 33]
    for k, want in want_stats:
        got = port.round_stats[k]
        assert got["stitch_rounds"] == want["stitch_rounds"], k
        assert got["stitch_bytes"] == want["stitch_all_to_all_bytes"], k
        assert got["stitch_bucket_bytes"] > 0
    sr = port.round_stats[33]["stitch_rounds"]
    assert sr["doubling"] == sr["static_bound"]  # the cycle ran to the bound
