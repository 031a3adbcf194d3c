"""Port compaction (plain version) vs the JAX reference: compact_classes in
interpret mode and count._compact_keep."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhm2_proxy_tpu.ops import count as RC
from mhm2_proxy_tpu.ops import pallas_compact as RPC
from mhm2_proxy_tpu_torch.ops import compact as PCO
from mhm2_proxy_tpu_torch.ops import count as PC


def _t(a):
    return torch.from_numpy(np.array(a).view(np.int32))


@pytest.mark.parametrize("n_classes,emit,pdead", [(2, (0,), 0.3), (3, (0, 1), 0.5), (2, (0, 1), 1.0)])
def test_compact_classes_equals_reference(n_classes, emit, pdead):
    rng = np.random.default_rng(n_classes * 10 + len(emit))
    N = RPC.TILE
    p = [(1 - pdead) / (n_classes - 1)] * (n_classes - 1) + [pdead]
    flags = rng.choice(n_classes, size=N, p=p).astype(np.int32)
    lanes = tuple(rng.integers(0, 1 << 32, N, dtype=np.uint64).astype(np.uint32) for _ in range(3))
    want = RPC.compact_classes(tuple(jnp.asarray(x) for x in lanes), jnp.asarray(flags),
                               n_classes, emit=emit, interpret=True)
    got = PCO.compact_classes(tuple(_t(x) for x in lanes), _t(flags), n_classes, emit)
    for (gl, gn), (wl, wn) in zip(got, want):
        n = int(wn)
        assert int(gn) == n
        for g, w in zip(gl, wl):
            assert np.array_equal(g.numpy().view(np.uint32)[:n], np.asarray(w)[:n])


@pytest.mark.parametrize("frac", [0.0, 0.37, 1.0])
def test_compact_keep_equals_reference(frac):
    rng = np.random.default_rng(int(frac * 100))
    N, W = 3000, 4
    words = rng.integers(0, 1 << 32, (N, W), dtype=np.uint64).astype(np.uint32)
    keep = rng.random(N) < frac
    pay = rng.integers(0, 1 << 32, N, dtype=np.uint64).astype(np.uint32)
    want = RC._compact_keep(jnp.asarray(words), jnp.asarray(keep), (jnp.asarray(pay),))
    got = PC._compact_keep(_t(words), torch.from_numpy(keep), (_t(pay),))
    assert int(got[-1]) == int(want[-1])
    assert np.array_equal(got[0].numpy().view(np.uint32), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy().view(np.uint32), np.asarray(want[1]))


@pytest.mark.parametrize("mask", ["int32", "bool", "uint8"])
def test_compact_lanes_layouts_brute_force(mask):
    """compact_lanes' plain version against a row-by-row brute force: strided
    (N, W) input columns, a (N, 4) output group with a constant-0 column,
    single lanes, per-group tail fills, int32 classes with values outside
    [0, n_classes), and bool / uint8 keep masks."""
    rng = np.random.default_rng(len(mask))
    N, W = 2500, 4
    words = rng.integers(0, 1 << 32, (N, W), dtype=np.uint64).astype(np.uint32)
    pay = rng.integers(0, 1 << 32, N, dtype=np.uint64).astype(np.uint32)
    wt = _t(words)
    lanes = tuple(wt[:, i] for i in range(W)) + (_t(pay),)
    if mask == "int32":
        cls = rng.integers(-1, 4, N).astype(np.int32)  # -1 and 3: no class of 3
        flags, n_classes, emit = torch.from_numpy(cls), 3, (2, 0)
    else:
        keep = rng.random(N) < 0.4
        cls = np.where(keep, 0, 1)
        raw = keep * rng.integers(1, 256, N) if mask == "uint8" else keep
        flags = torch.from_numpy(raw.astype(np.uint8 if mask == "uint8" else bool))
        n_classes, emit = 2, (0, 1)
    layouts = (((0, 1, 2, None), (4,)), ((3,), (4,), (0, 1)))
    fills = ((0xFFFFFFFF, 7), (0, 1, 0x12345678))
    outs, counts = PCO.compact_lanes(lanes, flags, n_classes, emit, layouts, fills)
    cols = np.concatenate([words, pay[:, None], np.zeros((N, 1), np.uint32)], 1)
    for (c, lay, fl), groups, n in zip(zip(emit, layouts, fills), outs, counts.tolist()):
        rows = np.nonzero(cls == c)[0]
        assert n == len(rows)
        for g, f, got in zip(lay, fl, groups):
            src = [W + 1 if s is None else s for s in g]
            want = np.full((N, len(g)), f, np.uint32)
            want[:n] = cols[rows][:, src]
            got = got.numpy().view(np.uint32).reshape(N, -1)
            assert np.array_equal(got, want)
