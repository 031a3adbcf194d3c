"""The port's hierarchical two-stage exchange (parallel/multihost.py) and the
flat counter with supermers against the JAX package's HierarchicalCounter
and ShardedCounter on the 8-device virtual CPU mesh, at tolerance 0:
per-shard tables, their shapes and the stitch's row bound, every exchange
statistic and the describe_exchange line, on the count, spill (supermers
off and on), the contig pass and a poly-A storm; lookups and the traversal
on the 2 x 4 table; and the analog of __graft_entry__.dryrun_multichip(8)
against the counts MULTICHIP_r05.json records."""

import json
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as S
from mhm2_proxy_tpu.dbjg import traverse_debruijn_graph_sharded as ref_traverse
from mhm2_proxy_tpu.oracle.pyref import count_kmers_oracle, target_shard
from mhm2_proxy_tpu.parallel import HierarchicalCounter as RefHier
from mhm2_proxy_tpu.parallel import ShardedCounter as RefCounter
from mhm2_proxy_tpu.parallel import make_host_mesh, make_shard_mesh
from mhm2_proxy_tpu.parallel import sharded_lookup as ref_lookup
from mhm2_proxy_tpu_torch.constants import minimizer_len_for_k
from mhm2_proxy_tpu_torch.dbjg import traverse_debruijn_graph_sharded
from mhm2_proxy_tpu_torch.parallel import HierarchicalCounter, ShardedCounter, sharded_lookup
from tests.test_count import reads_to_block
from tests.test_torch_sharded import Q40, _ctg_block, _read_set, _shard_rows, _stats, _storm
from torch_common import one_torch_thread  # noqa: F401 (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = {
    # name: (hosts, devices a host, bucket_cap, k, supermers, read blocks, contig pass, storm)
    "count": (2, 4, 4096, 21, True, 1, False, False),
    "spill_raw": (2, 4, 16, 21, False, 1, False, False),
    "spill_supermers": (2, 4, 64, 21, True, 2, False, False),
    "ctg_pass": (2, 4, 4096, 21, True, 1, True, False),
    "k77_ctg_2x2": (2, 2, 256, 77, True, 1, True, False),
    "poly_a_storm_4x2": (4, 2, 512, 21, True, 1, False, True),
    "flat_supermers": (0, 8, 4096, 21, True, 1, False, False),
    "flat_supermers_spill_ctg": (0, 4, 96, 33, True, 2, True, False),
}


def _counters(H, D, cap, k, sup):
    if H == 0:
        return (RefCounter(k, make_shard_mesh(D), bucket_cap=cap, use_supermers=sup),
                ShardedCounter(k, D, bucket_cap=cap, device="cpu", use_supermers=sup))
    return (RefHier(k, make_host_mesh(H, D), bucket_cap=cap, use_supermers=sup),
            HierarchicalCounter(k, (H, D), bucket_cap=cap, device="cpu", use_supermers=sup))


@pytest.mark.parametrize("case", sorted(CASES))
def test_counter_equals_reference(case):
    H, D, cap, k, sup, n_blocks, ctg, storm = CASES[case]
    rng = np.random.default_rng(len(case) + 100)
    reads = _storm(rng) if storm else _read_set(rng, 96 * n_blocks)
    ref, port = _counters(H, D, cap, k, sup)
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
    assert port.dropped == 0
    merged = {}
    for ft in got.shard_tables():
        merged.update(ft.to_host_dict())
    assert merged == count_kmers_oracle(reads[: 96 * n_blocks], k, ctgs=ctgs)
    m = minimizer_len_for_k(k)
    for s, ft in enumerate(got.shard_tables()):  # host-major shard ids
        assert all(target_shard(km, m, got.S) == s for km in list(ft.to_host_dict())[:20])
    if "spill" in case:
        assert port.spill_rounds > 0 and port.spilled > 0
    if sup and not storm:
        assert port.stat_kmers > 2 * port.stat_records  # several k-mers a record
    if storm:
        assert port.stat_collapsed > 0


def test_hierarchical_lookup_and_traversal_equal_reference():
    """Lookups over the 2 x 4 table and the sharded traversal equal the
    reference's on its own 2 x 4 table (contigs, stitch rounds)."""
    k = 21
    rng = np.random.default_rng(42)
    genome = "".join(rng.choice(list("ACGT"), size=600))
    reads = [(genome[s : s + 64], Q40 * 64) for s in rng.integers(0, 600 - 64, 96)]
    blk = reads_to_block(reads, B=96, L=64)
    ref = RefHier(k, make_host_mesh(2, 4), bucket_cap=4096)
    port = HierarchicalCounter(k, (2, 4), bucket_cap=4096, device="cpu")
    ref.add_reads_block(*blk)
    port.add_reads_block(*blk)
    want_t, got_t = ref.finalize(), port.finalize()
    n = np.asarray(want_t.n)
    Q = int(n.max())
    qw = np.roll(np.asarray(want_t.words[:, :Q]), 1, axis=0)
    qv = np.roll(np.arange(Q)[None, :] < n[:, None], 1, axis=0)
    want = ref_lookup(want_t, jnp.asarray(qw), jnp.asarray(qv))
    got = sharded_lookup(got_t, torch.from_numpy(qw.view(np.int32).copy()),
                         torch.from_numpy(qv.copy()))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].numpy()[qv].all()
    want_stats, got_stats = {}, {}
    want_c = ref_traverse(want_t, k, stats=want_stats)
    got_c = traverse_debruijn_graph_sharded(got_t, k, stats=got_stats)
    assert sorted(got_c) == sorted(want_c) and len(got_c) > 0
    assert got_stats["stitch_rounds"] == want_stats["stitch_rounds"]


def _multichip_r05() -> dict:
    """The counts of MULTICHIP_r05.json's dryrun_multichip(8) line."""
    tail = json.load(open(os.path.join(ROOT, "MULTICHIP_r05.json")))["tail"]
    line = next(x for x in tail.splitlines() if x.startswith("dryrun_multichip ok"))
    ex = re.findall(r"exchange: (\d+) records \(\d+ MiB all_to_all\) for (\d+) kmers .*?, "
                    r"(\d+) presummed, (\d+) re-sent in (\d+) spill rounds", line)
    return dict(
        kmers=int(re.search(r", (\d+) kmers, ", line).group(1)),
        contigs=int(re.search(r"\((\d+) contigs", line).group(1)),
        exchange=tuple(int(x) for x in ex[0]),
        volume_exchange=tuple(int(x) for x in ex[1]),
        shard_rows=[int(x) for x in re.search(r"shard table rows \[([\d, ]+)\]",
                                              line).group(1).split(", ")],
    )


def test_dryrun_multichip_analog_equals_multichip_r05():
    """chip_smoke.py's dryrun_multichip on the CPU: its counts are the ones
    it pins (MULTICHIP_R05), and those are MULTICHIP_r05.json's."""
    assert S.MULTICHIP_R05 == _multichip_r05()
    got = S.dryrun_multichip("cpu")
    assert got == S.MULTICHIP_R05
