"""The port's CUDA kernels against their plain versions, on the card.

Each case runs a kernel's wrapper on CUDA tensors and the same wrapper on
CPU copies (which takes the plain version), and requires bit-equal integer
results (tolerance 0). The shapes are small but pick the edges the kernels'
block decompositions have: empty runs, lengths that are not block
multiples, equal-key runs and group sums that span many blocks, and the u16
clamp. Every test takes the `cuda` fixture, which skips it when there is
no CUDA device. The repo's conftest imports jax, which the GPU machine
lacks, so run them there without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from mhm2_proxy_tpu_torch.ops import compact, extract, finalize, join, kernels, sort
from mhm2_proxy_tpu_torch.ops.u32 import lexsort_lanes


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _i32(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.uint32)).view(np.int32))


def _launched(name, fn):
    before = kernels.launches()[name]
    out = fn()
    torch.cuda.synchronize()
    assert kernels.launches()[name] == before + 1
    return out


def _same(got, want, rows=None):
    for g, w in zip(got, want):
        g = g.cpu()
        if rows is not None:
            g, w = g[:rows], w[:rows]
        assert g.shape == w.shape and torch.equal(g, w)


@pytest.mark.parametrize("k", [21, 33, 55, 99])
@pytest.mark.parametrize("packed", [True, False])
def test_extract(cuda, k, packed):
    rng = np.random.default_rng(k + packed)
    for B, L in ((37, k + 45), (3, 2048)):
        codes = torch.from_numpy(rng.integers(0, 5, (B, L), dtype=np.uint8))
        qual = torch.from_numpy(rng.random((B, L)) > 0.1)
        lens = torch.from_numpy(rng.integers(k - 2, L + 1, B).astype(np.int32))
        want = extract._extract(codes, qual, lens, k, packed)
        got = _launched("extract", lambda: extract._extract(
            codes.to(cuda), qual.to(cuda), lens.to(cuda), k, packed))
        _same(got, want)


def _sorted_run(rng, n, n_lanes, kw, n_keys):
    """A lexsorted run over few distinct keys (long equal-key runs), keys
    with bit 31 set, and an all-ones sentinel tail."""
    keys = rng.integers(0, 1 << 32, (max(n_keys, 1), kw), dtype=np.uint64).astype(np.uint32)
    keys[: len(keys) // 2, 0] |= np.uint32(0x80000000)
    rows = np.concatenate(
        [keys[rng.integers(0, len(keys), n)],
         rng.integers(0, 1 << 32, (n, n_lanes - kw), dtype=np.uint64).astype(np.uint32)], 1)
    rows[n - n // 10 :, :kw] = 0xFFFFFFFF
    return lexsort_lanes(tuple(_i32(rows[:, i]) for i in range(n_lanes)), kw)


@pytest.mark.parametrize("na,nb,kw,n_lanes,n_keys,pad", [
    (0, 5, 2, 2, 3, 0),
    (7, 0, 1, 3, 3, 0),
    (1, 1, 2, 2, 2, 0),
    (1023, 1025, 3, 3, 5000, 0),
    (3000, 7001, 2, 3, 4, 0),        # equal-key runs across many blocks
    (2500, 4100, 4, 5, 900, 1500),   # pad rows with a pad_fill value
])
def test_merge(cuda, na, nb, kw, n_lanes, n_keys, pad):
    rng = np.random.default_rng(na + nb + kw)
    a = _sorted_run(rng, na, n_lanes, kw, n_keys)
    b = _sorted_run(rng, nb, n_lanes, kw, n_keys)
    fill = [0x01FFFFFF + i for i in range(n_lanes - kw)] if pad else None
    n_out = na + nb + pad
    want = sort.merge_sorted_lanes(a, b, kw, n_out, fill)
    got = _launched("sort", lambda: sort.merge_sorted_lanes(
        tuple(x.to(cuda) for x in a), tuple(x.to(cuda) for x in b), kw, n_out, fill))
    _same(got, want)


def _packed_run(rng, k, n, n_keys):
    """A sorted packed run: few distinct keys (groups spanning blocks), the
    7-bit payload in the last lane's free bits, a sentinel tail."""
    weff = -(-2 * k // 32)
    free = 32 * weff - 2 * k
    keys = rng.integers(0, 1 << 32, (n_keys, weff), dtype=np.uint64).astype(np.uint32)
    keys[:, -1] &= np.uint32((0xFFFFFFFF >> free) << free)
    rows = keys[rng.integers(0, n_keys, n)]
    pay = 1 | (rng.integers(0, 6, n) << 1) | (rng.integers(0, 6, n) << 4)
    rows[:, -1] |= pay.astype(np.uint32)
    rows[n - n // 20 :] = 0xFFFFFFFF
    return lexsort_lanes(tuple(_i32(rows[:, i]) for i in range(weff)))


@pytest.mark.parametrize("k", [21, 33, 55, 99])
@pytest.mark.parametrize("purge", [True, False])
def test_finalize(cuda, k, purge):
    rng = np.random.default_rng(k * 2 + purge)
    # n_keys=2 over 70001 rows: groups of ~33k rows span ~33 blocks; one
    # key of 68400 rows (72000 less the sentinel tail) passes the u16 clamp
    for n, n_keys in ((1, 1), (3001, 300), (70001, 2), (72000, 1)):
        lanes = _packed_run(rng, k, n, n_keys)
        want = finalize.scan_purge(lanes, k, purge=purge)
        got = _launched("finalize", lambda: finalize.scan_purge(
            tuple(x.to(cuda) for x in lanes), k, purge=purge))
        _same(got[0] + (got[1],), want[0] + (want[1],))


@pytest.mark.parametrize("n", [1, 1000, 1025, 5000])
@pytest.mark.parametrize("n_classes,emit", [(1, (0,)), (2, (0,)), (3, (0, 2)), (4, (3, 1, 0))])
def test_compact(cuda, n, n_classes, emit):
    rng = np.random.default_rng(n + n_classes)
    lanes = tuple(_i32(rng.integers(0, 1 << 32, n, dtype=np.uint64)) for _ in range(3))
    flags = torch.from_numpy(rng.integers(0, n_classes, n).astype(np.int32))
    want = compact.compact_classes(lanes, flags, n_classes, emit)
    got = _launched("compact", lambda: compact.compact_classes(
        tuple(x.to(cuda) for x in lanes), flags.to(cuda), n_classes, emit))
    for (gl, gn), (wl, wn) in zip(got, want):
        assert int(gn) == int(wn)
        _same(gl, wl, rows=int(wn))


@pytest.mark.parametrize("n,kw,n_keys,max_dup,q_frac", [
    (0, 2, 1, 32, 0.6),
    (1, 1, 1, 32, 0.6),
    (3001, 2, 300, 32, 0.6),
    (5000, 4, 40, 32, 0.99),  # runs of ~125 rows, few table rows: past the reach, across blocks
    (4097, 7, 2000, 129, 0.6),
    (2000, 3, 50, 1, 0.6),    # reach 0: only a query's own row
])
def test_join(cuda, n, kw, n_keys, max_dup, q_frac):
    rng = np.random.default_rng(n + kw + max_dup)
    keys = rng.integers(0, 1 << 32, (n_keys, kw), dtype=np.uint64).astype(np.uint32)
    keys[: n_keys // 2, 0] |= np.uint32(0x80000000)
    rows = keys[rng.integers(0, n_keys, n)]
    rows[n - n // 10 :] = 0xFFFFFFFF
    is_q = rng.random(n) < q_frac
    n_q = int(is_q.sum())
    qsrc = np.zeros(n, np.uint64)
    qsrc[is_q] = rng.permutation(n_q).astype(np.uint64) | join.QUERY_BIT
    tsrc = rng.integers(0, n + 1, n).astype(np.uint64) | (rng.integers(0, 64, n).astype(np.uint64) << 26)
    src = np.where(is_q, qsrc, tsrc).astype(np.uint32)
    lanes = lexsort_lanes(tuple(_i32(rows[:, i]) for i in range(kw)) + (_i32(src),), kw)
    n_valid = int(0.8 * n)
    want = join.propagate_answers(lanes, n_valid, kw, 6, n_q, max_dup)
    nv = torch.tensor(n_valid, dtype=torch.int32, device=cuda)
    if n:
        got = _launched("join", lambda: join.propagate_answers(
            tuple(x.to(cuda) for x in lanes), nv, kw, 6, n_q, max_dup))
    else:
        got = join.propagate_answers(tuple(x.to(cuda) for x in lanes), nv, kw, 6, n_q, max_dup)
    _same((got,), (want,))
    hits = int((want != 0).sum())
    assert n < 1000 or (hits == 0 if max_dup == 1 else 0 < hits < n_q)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="one CUDA device or all on the CPU"):
        sort.merge_sorted_lanes((x,), (x.cpu(),), 1)
    with pytest.raises(TypeError, match="expected torch.int32"):
        sort.merge_sorted_lanes((x.long(),), (x.long(),), 1)
    with pytest.raises(ValueError, match="contiguous"):
        compact.compact_classes((torch.zeros((8, 2), dtype=torch.int32, device=cuda)[:, 0],), x, 2,
                                (0,))
