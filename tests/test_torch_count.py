"""Port KmerCountStore (raw LSM, plain versions) vs the JAX reference's
raw_lsm=True and raw_lsm=False stores: identical final tables."""

import numpy as np
import pytest

from mhm2_proxy_tpu.kcount import KmerCountStore as RefStore
from mhm2_proxy_tpu.ops.bitkmer import ascii_to_codes
from mhm2_proxy_tpu_torch.kcount import KmerCountStore as PortStore
from tests.test_count import reads_to_block


def _reads(rng, genome, n, lo, hi, err=0.01, low_q_frac=0.05):
    out = []
    for _ in range(n):
        ln = int(rng.integers(lo, hi + 1))
        s = int(rng.integers(0, len(genome) - ln + 1))
        seq = list(genome[s : s + ln])
        for i in np.nonzero(rng.random(ln) < err)[0]:
            seq[i] = "ACGTN"[int(rng.integers(0, 5))]
        quals = "".join(chr(33 + (5 if rng.random() < low_q_frac else 38)) for _ in range(ln))
        out.append(("".join(seq), quals))
    return out


def _ctg_block(rng, genome, n, k, L=320):
    codes = np.full((n, L), 4, np.uint8)
    lens = np.zeros(n, np.int32)
    for i in range(n):
        ln = int(rng.integers(k + 2, L + 1))
        s = int(rng.integers(0, len(genome) - ln + 1))
        seq = bytearray(genome[s : s + ln].encode())
        if i % 4 == 0:
            seq[ln // 2] = ord("ACGT"[(seq[ln // 2] + 1) % 4])
        codes[i, :ln] = ascii_to_codes(bytes(seq))
        lens[i] = ln
    depths = rng.integers(1, 40, n).astype(np.int32)
    depths[0] = 70000
    return codes, lens, depths


def _table(t, to_np):
    w, c, l, r, n = to_np(t)
    return w[:n], c[:n], l[:n], r[:n]


@pytest.mark.parametrize("k", [21, 33, 55, 99])
@pytest.mark.parametrize("with_ctg", [False, True])
def test_store_equals_reference(k, with_ctg):
    rng = np.random.default_rng(k + 1000 * with_ctg)
    genome = "".join(rng.choice(list("ACGT"), size=700))
    # fixed (B, L) block shapes: one reference compile per k
    blocks = [reads_to_block(_reads(rng, genome, 40, k - 1, k + 60), L=k + 60) for _ in range(3)]
    ctgs = [_ctg_block(rng, genome, 6, k) for _ in range(3)] if with_ctg else []
    port = PortStore(k, device="cpu")
    refs = [RefStore(k, raw_lsm=True, raw_budget_bytes=2 << 30), RefStore(k, raw_lsm=False)]
    for store in [port] + refs:
        for blk in blocks:
            store.add_reads_block(*blk)
        for cb in ctgs:
            store.add_ctgs_block(*cb)
    got = _table(port.finalize(), lambda t: t.to_numpy())
    assert len(got[0]) > 0
    for ref in refs:
        want = _table(ref.finalize(), lambda t: (np.asarray(t.words), np.asarray(t.count),
                                                 np.asarray(t.left), np.asarray(t.right),
                                                 int(t.n)))
        for g, w in zip(got, want):
            assert g.shape == w.shape and np.array_equal(g, w)
