"""The port's stitch (dbjg/stitch.py: pack, repair, pointer doubling, path
map, device render) against the JAX package's stitch_paths, both its
native walker and its numpy pointer doubling, at tolerance 0: on the
reference's graph zoo built from the reference's own tables, on the
non-reciprocal repair case, on seeded synthetic state graphs, and the
render alone against the reference's _render_contigs."""

import functools

import numpy as np
import pytest
import torch

from mhm2_proxy_tpu.dbjg import stitch as RS
from mhm2_proxy_tpu.dbjg import traverse as RT
from mhm2_proxy_tpu.io.native import get_stitch_walk
from mhm2_proxy_tpu.kcount import KmerCountStore
from mhm2_proxy_tpu_torch.constants import words32_for_k
from mhm2_proxy_tpu_torch.dbjg import stitch as PS
from mhm2_proxy_tpu_torch.dbjg import traverse as PT
from mhm2_proxy_tpu_torch.kcount import FinalTable
from tests.test_count import reads_to_block
from tests.test_traverse import coverage_reads
from torch_common import one_torch_thread  # noqa: F401 (autouse fixture)

STITCHERS = ("walker", "doubling")


def _revcomp(s):
    return s.translate(str.maketrans("ACGT", "TGCA"))[::-1]


def _zoo_genomes(kind, k, rng):
    """The reference's graph zoo (tests/test_traverse.py): reads of each
    genome give a linear path, forks, a cycle, an inverted-repeat loop or
    isolated nodes."""
    rand = lambda n: "".join(rng.choice(list("ACGT"), size=n))  # noqa: E731
    if kind == "linear":
        return [rand(400)]
    if kind == "fork":
        core = rand(120)
        return [rand(150) + core + rand(150), rand(150) + core + rand(150)]
    if kind == "cycle":
        g = rand(150)
        return [g + g[: k + 30]]
    if kind == "palindrome":
        h = rand(120)
        pal = h + _revcomp(h)
        return [pal + pal[: k + 30]]
    return [rand(60) + rand(400)]


@functools.lru_cache(maxsize=None)
def _zoo(kind, k):
    """(reference table, its edges; port table, its edges), the port's table
    taken from the reference's through FinalTable.from_reference."""
    rng = np.random.default_rng([k, len(kind), ord(kind[0])])
    reads = [r for g in _zoo_genomes(kind, k, rng) for r in coverage_reads(g, k, rng, n=200)]
    store = KmerCountStore(k)
    store.add_reads_block(*reads_to_block(reads))
    ref = RT.fit_table_rows(store.finalize())
    port = PT.fit_table_rows(FinalTable.from_reference(
        k, np.asarray(ref.words), np.asarray(ref.count), np.asarray(ref.left),
        np.asarray(ref.right), ref.n, device="cpu"))
    r_edges = RT.build_edges(ref.words, ref.count, ref.left, ref.right, ref.n, k)
    p_edges = PT.build_edges(port.words, port.count, port.left, port.right, port.n, k)
    return ref, r_edges, port, p_edges


def _reference(stitcher, monkeypatch, *args, **kw):
    """The JAX package's stitch_paths through its native walker, or through
    its numpy pointer doubling (the walker patched away, as
    tests/test_traverse.py does)."""
    if stitcher == "walker":
        assert get_stitch_walk() is not None, "the native walker did not load"
    else:
        monkeypatch.setattr(RS, "_stitch_native", lambda *a: None)
    out = RS.stitch_paths(*args, **kw)
    monkeypatch.undo()
    return out


@pytest.mark.parametrize("stitcher", STITCHERS)
@pytest.mark.parametrize("min_states", [1, 3])
@pytest.mark.parametrize("k", [21, 33])
@pytest.mark.parametrize("kind", ["linear", "fork", "cycle", "palindrome", "isolated"])
def test_stitch_zoo_equals_reference(kind, k, min_states, stitcher, monkeypatch):
    ref, r_edges, port, p_edges = _zoo(kind, k)
    timings = {}
    got = PS.stitch_paths(p_edges, port.words, port.count, k, timings=timings,
                          min_states=min_states)
    want = _reference(stitcher, monkeypatch, r_edges, ref.words, ref.count, k,
                      min_states=min_states)
    assert sorted(got) == sorted(want) and len(want) > 0
    # the host receives the contigs' bases and two int64 words a path, plus
    # one offset
    assert timings["paths_kept"] == len(got)
    assert timings["fetched_bytes"] == sum(len(s) for s, _ in got) + 8 * (2 * len(got) + 1)


def _edges_to_torch(edges):
    return {key: torch.from_numpy(v.astype(np.int32) if v.dtype == np.int64 else v)
            for key, v in edges.items()}


@pytest.mark.parametrize("stitcher", STITCHERS)
def test_nonreciprocal_repair_equals_reference(stitcher, monkeypatch):
    """tests/test_traverse.py's merge state: two nodes claim node 2's left
    side; both edges are dropped, and every node is a k-length contig."""
    from mhm2_proxy_tpu.ops import bitkmer as rbk

    k, n = 5, 4
    words = np.stack([np.asarray(rbk.strings_to_words([s], k))[0]
                      for s in ["ACGTC", "GGATC", "TTACG", "CCCAG"]])
    count = np.full(n, 3, np.int32)
    z = np.zeros(n, np.int64)
    edges = dict(uu=np.ones(n, bool), r_idx=z.copy(), r_port=z.copy(), r_ok=np.zeros(n, bool),
                 l_idx=z.copy(), l_port=z.copy(), l_ok=np.zeros(n, bool))
    edges["r_ok"][[0, 1]] = True
    edges["r_idx"][[0, 1]] = 2
    t_ref, t_port = {}, {}
    want = _reference(stitcher, monkeypatch, edges, words, count, k, timings=t_ref)
    got = PS.stitch_paths(_edges_to_torch(edges), torch.from_numpy(words.view(np.int32)),
                          torch.from_numpy(count), k, timings=t_port)
    assert got == want and len(got) == n
    assert t_port["nonreciprocal_dropped"] == t_ref["nonreciprocal_dropped"] == 2


def _synth_graph(rng, k):
    """A state graph with the structures the stitch meets: disjoint paths,
    cycles (each a mirrored pair of state cycles), revcomp-palindromic
    cycles and hairpin paths (self-mirrored, through a node side linked to
    itself), isolated nodes, invalid (non-UU) nodes whose edge fields hold
    garbage, and one-way links into taken states (merge states that the
    repair must break). Returns the numpy edge dict, words and counts."""
    n = 400
    W = words32_for_k(k)
    edges = dict(uu=np.ones(n, bool),
                 r_idx=rng.integers(0, n, n), r_port=rng.integers(0, 2, n),
                 r_ok=np.zeros(n, bool),
                 l_idx=rng.integers(0, n, n), l_port=rng.integers(0, 2, n),
                 l_ok=np.zeros(n, bool))
    free = []  # node sides without an edge

    def side(a, sa, b, sb):
        p = "r" if sa == 1 else "l"
        edges[p + "_idx"][a], edges[p + "_port"][a], edges[p + "_ok"][a] = b, sb, True

    def connect(a, sa, b, sb):
        side(a, sa, b, sb)
        side(b, sb, a, sa)

    def chain(vs, ex):
        # leave v[i] by side ex[i], enter v[i + 1] by the other side of its exit
        for i in range(len(vs) - 1):
            connect(vs[i], ex[i], vs[i + 1], 1 - ex[i + 1])

    nodes = iter(rng.permutation(n).tolist())
    taken = []
    while True:
        kind = rng.choice(["path", "path", "cycle", "palindrome", "hairpin", "isolated",
                           "invalid"])
        m = int(rng.integers(1, 13))
        vs = [next(nodes, None) for _ in range(m)]
        if vs[-1] is None:
            break
        ex = rng.integers(0, 2, m).tolist()
        chain(vs, ex)
        if kind == "path":
            free += [(vs[0], 1 - ex[0]), (vs[-1], ex[-1])]
            taken += [(vs[i + 1], 1 - ex[i + 1]) for i in range(m - 1)]
        elif kind == "cycle" and m >= 2:
            connect(vs[-1], ex[-1], vs[0], 1 - ex[0])
            taken += [(vs[i], 1 - ex[i]) for i in range(m)]
        elif kind == "palindrome":
            connect(vs[-1], ex[-1], vs[-1], ex[-1])
            connect(vs[0], 1 - ex[0], vs[0], 1 - ex[0])
        elif kind == "hairpin":
            connect(vs[-1], ex[-1], vs[-1], ex[-1])
            free.append((vs[0], 1 - ex[0]))
        elif kind == "isolated":
            for v in vs:
                for p in "rl":
                    edges[p + "_ok"][v] = False
                free += [(v, 0), (v, 1)]
        else:  # invalid: not UU, edge fields left as garbage
            for v in vs:
                edges["uu"][v] = False
                edges["r_ok"][v], edges["l_ok"][v] = rng.integers(0, 2, 2).astype(bool)
    # one-way links from free sides into states that already have a predecessor
    for i in rng.choice(len(free), min(len(free), 12), replace=False):
        b, sb = taken[int(rng.integers(0, len(taken)))]
        side(*free[i], b, sb)
    words = rng.integers(0, 2**32, (n, W), dtype=np.uint64).astype(np.uint32)
    count = rng.integers(1, 60000, n).astype(np.int32)
    return edges, words, count


@pytest.mark.parametrize("stitcher", STITCHERS)
@pytest.mark.parametrize("min_states", [1, 3])
@pytest.mark.parametrize("seed", range(6))
def test_synthetic_state_graphs_equal_reference(seed, min_states, stitcher, monkeypatch):
    rng = np.random.default_rng(9000 + seed)
    k = (21, 33, 77)[seed % 3]
    edges, words, count = _synth_graph(rng, k)
    t_ref, t_port = {}, {}
    want = _reference(stitcher, monkeypatch, edges, words, count, k, timings=t_ref,
                      min_states=min_states)
    got = PS.stitch_paths(_edges_to_torch(edges), torch.from_numpy(words.view(np.int32)),
                          torch.from_numpy(count), k, timings=t_port, min_states=min_states)
    assert sorted(got) == sorted(want) and len(want) > 0
    assert t_port.get("nonreciprocal_dropped") == t_ref.get("nonreciprocal_dropped")
    assert t_ref.get("nonreciprocal_dropped", 0) > 0


def _encode(codes, W):
    """Base codes -> one row of W packed u32 words."""
    w = np.zeros(W, np.uint32)
    for i, c in enumerate(codes):
        w[i // 16] |= np.uint32(int(c) << (2 * (15 - i % 16)))
    return w


@pytest.mark.parametrize("k", [21, 33, 77])
@pytest.mark.parametrize("seed", range(3))
def test_device_render_equals_reference_render(seed, k):
    """canonical_contigs against the reference's _render_contigs on random
    path buffers, a third of them reverse-complement palindromes (no
    differing base) or palindromes with one base changed late."""
    rng = np.random.default_rng(700 + seed)
    W = words32_for_k(k)
    n_paths = 60
    n_states = rng.integers(1, 40, n_paths)
    clen = (k - 1) + n_states
    offsets = np.zeros(n_paths + 1, np.int64)
    np.cumsum(clen, out=offsets[1:])
    buf = rng.integers(0, 4, offsets[-1]).astype(np.uint8)
    nodes = rng.permutation(3 * n_paths)[:n_paths]
    fwd = rng.integers(0, 2, n_paths)
    starts = 2 * nodes + fwd
    words = rng.integers(0, 2**32, (3 * n_paths, W), dtype=np.uint64).astype(np.uint32)
    for p in range(n_paths):
        if p % 3 or clen[p] % 2:
            continue
        half = rng.integers(0, 4, clen[p] // 2).astype(np.uint8)
        c = np.concatenate([half, 3 - half[::-1]])
        if p % 6 == 0:
            c[-2] = (c[-2] + 1) % 4
        buf[offsets[p] : offsets[p + 1]] = c
        head = c[:k] if fwd[p] else (3 - c[:k][::-1])
        words[nodes[p]] = _encode(head, W)
    depth_sum = rng.integers(0, 2**40, n_paths)
    want = RS._render_contigs(starts, n_states, depth_sum, buf, offsets[:-1], words, k)

    path = np.repeat(np.arange(n_paths), n_states)
    pos = np.arange(path.size) - np.repeat(np.cumsum(n_states) - n_states, n_states)
    count = np.where(pos == 0, depth_sum[path], 0)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))  # noqa: E731
    got = PS.canonical_contigs(t(n_states), t(path), t(pos), t(buf[offsets[path] + (k - 1) + pos]),
                               t(count), t(words[nodes].view(np.int32)), t(fwd == 1), k)
    assert got == want
    assert sum(1 for s, _ in got if s == _revcomp(s)) > 0


def test_state_ids_past_int32_raise():
    big = torch.zeros(1, dtype=torch.bool).expand(2**30)
    with pytest.raises(ValueError, match="int32"):
        PS.stitch_paths(dict(uu=big), torch.zeros((1, 2), dtype=torch.int32),
                        torch.zeros(1, dtype=torch.int32), 21)
