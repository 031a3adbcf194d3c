"""Port KmerCountStore (plain versions) vs the JAX reference's raw_lsm=True
and raw_lsm=False stores: identical final tables, on the raw path and with
the collapse into the split LSM, deferred cascades and ranged folds forced
(mirroring tests/test_raw_lsm.py)."""

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


def _ref_table(t):
    return _table(t, lambda t: (np.asarray(t.words), np.asarray(t.count), np.asarray(t.left),
                                np.asarray(t.right), int(t.n)))


@pytest.mark.parametrize("k", [21, 33, 55, 63, 77, 99])
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
        want = _ref_table(ref.finalize())
        for g, w in zip(got, want):
            assert g.shape == w.shape and np.array_equal(g, w)


# (raw budget bytes, cascade_max_rows, ranged): every push collapses; every
# cascade merge deferred; ranged read and ctg-rule folds over several ranges
# (RANGED_FOLD_TARGET_ROWS = 4096), split-only and mixed (collapse, then a
# raw remainder)
_SPLIT_CASES = {
    "collapse": (1, None, False),
    "deferred": (1, 1, False),
    "ranged": (1, None, True),
    "ranged_mixed": (60_000, None, True),
}


def _configure(store, budget, cascade, ranged):
    store.raw_budget_bytes = budget
    if cascade is not None:
        store.cascade_max_rows = cascade
    if ranged:
        store.RANGED_FOLD_MIN_ROWS = 0
        store.RANGED_FOLD_TARGET_ROWS = 4096
    return store


_PLAIN_LSM_TABLES = {}


def _split_inputs(k, with_ctg):
    rng = np.random.default_rng(k + 7 * with_ctg)
    genome = "".join(rng.choice(list("ACGT"), size=8000))
    blocks = [reads_to_block(_reads(rng, genome, 100, k + 5, k + 80), L=k + 80) for _ in range(4)]
    ctgs = [_ctg_block(rng, genome, 6, k) for _ in range(2)] if with_ctg else []
    return blocks, ctgs


def _fill(store, blocks, ctgs):
    for blk in blocks:
        store.add_reads_block(*blk)
    for cb in ctgs:
        store.add_ctgs_block(*cb)
    return store


@pytest.mark.parametrize("k", [21, 33, 63, 77])
@pytest.mark.parametrize("case", list(_SPLIT_CASES))
@pytest.mark.parametrize("with_ctg", [False, True])
def test_split_lsm_equals_reference(k, case, with_ctg):
    budget, cascade, ranged = _SPLIT_CASES[case]
    blocks, ctgs = _split_inputs(k, with_ctg)
    port = _fill(_configure(PortStore(k, device="cpu"), budget, cascade, ranged), blocks, ctgs)
    st = port.stats
    assert st["collapses"] >= (1 if case == "ranged_mixed" else 4)
    assert st["cascade_deferrals"] >= (3 if case == "deferred" else 0)
    assert st["cascade_merges"] >= (1 if case == "collapse" else 0)
    got = _table(port.finalize(), lambda t: t.to_numpy())
    if ranged:
        assert port.stats["read_pieces"] >= 3
        assert port.stats["ctg_pieces"] >= (3 if with_ctg else 0)
    assert len(got[0]) > 0
    ref = _fill(_configure(RefStore(k, raw_lsm=True), budget, cascade, ranged), blocks, ctgs)
    if (k, with_ctg) not in _PLAIN_LSM_TABLES:
        _PLAIN_LSM_TABLES[k, with_ctg] = _ref_table(
            _fill(RefStore(k, raw_lsm=False), blocks, ctgs).finalize())
    for want in (_ref_table(ref.finalize()), _PLAIN_LSM_TABLES[k, with_ctg]):
        for g, w in zip(got, want):
            assert g.shape == w.shape and np.array_equal(g, w)
