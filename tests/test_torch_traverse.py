"""Port traversal (build_edges, stitch) run on the JAX reference's own table
(FinalTable.from_reference): identical edge arrays and contig lists."""

import numpy as np
import pytest

from mhm2_proxy_tpu.dbjg import traverse as RT
from mhm2_proxy_tpu.kcount import KmerCountStore
from mhm2_proxy_tpu_torch.dbjg import traverse as PT
from mhm2_proxy_tpu_torch.kcount import FinalTable
from tests.test_count import reads_to_block
from tests.test_torch_count import _reads


@pytest.mark.parametrize("k", [21, 33])
def test_traversal_on_reference_table(k):
    rng = np.random.default_rng(50 + k)
    genome = "".join(rng.choice(list("ACGT"), size=1500))
    genome = genome + genome[200:260] + genome  # a repeat: forks and conflicts
    store = KmerCountStore(k)
    store.add_reads_block(*reads_to_block(_reads(rng, genome, 400, k + 10, k + 70, err=0.003)))
    ref = store.finalize()
    port = FinalTable.from_reference(k, np.asarray(ref.words), np.asarray(ref.count),
                                     np.asarray(ref.left), np.asarray(ref.right), ref.n, device="cpu")
    assert port.to_host_dict() == ref.to_host_dict()

    rt, pt = RT.fit_table_rows(ref), PT.fit_table_rows(port)
    want = RT.build_edges(rt.words, rt.count, rt.left, rt.right, rt.n, k)
    got = PT.build_edges(pt.words, pt.count, pt.left, pt.right, pt.n, k)
    assert set(got) == set(want)
    for key in want:
        assert np.array_equal(got[key].numpy(), np.asarray(want[key])), key

    for min_len in (0, k + 2):
        stats_r, stats_p = {}, {}
        c_ref = RT.traverse_debruijn_graph(ref, k, stats=stats_r, min_ctg_len=min_len)
        c_port = PT.traverse_debruijn_graph(port, k, stats=stats_p, min_ctg_len=min_len)
        assert sorted(c_port) == sorted(c_ref) and len(c_ref) > 0
        assert stats_p["terminations"] == stats_r["terminations"]
