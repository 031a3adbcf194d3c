"""Path stitching (port of mhm2_proxy_tpu/dbjg/stitch.py, native path).

The reciprocal UU edge graph is a disjoint union of simple paths and
cycles; each node yields two directed walk states s = 2*node + exit_port
(0=L, 1=R). The device packs the edge dict into the three arrays the
stitcher needs (successor, per-state base, count), the host repairs
non-reciprocal links, the native sequential walker (native/stitch_native.cpp)
decomposes the states into paths, and numpy renders canonical contigs.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops import bitkmer as bk
from ..ops.u32 import widen


def _pack_states_device(uu, r_idx, r_port, r_ok, l_idx, l_port, l_ok, words, count, k: int):
    """Per-port successors (-1 terminal, -2 invalid), per-state emitted base
    (exit L -> comp(first base), exit R -> last base) and u16 counts."""
    succ_r = torch.where(r_ok & uu, 2 * r_idx.to(torch.int64) + (1 - r_port), -1)
    succ_l = torch.where(l_ok & uu, 2 * l_idx.to(torch.int64) + (1 - l_port), -1)
    succ_r = torch.where(uu, succ_r, -2)
    succ_l = torch.where(uu, succ_l, -2)
    w_last = (k - 1) // 16
    sh_last = 2 * (15 - ((k - 1) % 16))
    first_b = (widen(words[:, 0]) >> 30) & 3
    last_b = (widen(words[:, w_last]) >> sh_last) & 3
    return (succ_l, succ_r, (3 - first_b).to(torch.uint8), last_b.to(torch.uint8),
            torch.clamp(count, 0, 0xFFFF).to(torch.int32))


def _render_contigs(starts, n_states, depth_sum, buf, src_off, words, k: int):
    """Contig text: oriented head k-mers + the walker's bases, canonicalized
    (min of seq and revcomp) with one ragged permutation; `words` may live
    on the device, only the n_paths head rows are fetched."""
    n_paths = starts.shape[0]
    if n_paths == 0:
        return []
    clen = (k - 1) + n_states
    offsets = np.zeros(n_paths + 1, np.int64)
    np.cumsum(clen, out=offsets[1:])
    total = int(offsets[-1])
    j = np.arange(total, dtype=np.int64)
    pid = np.repeat(np.arange(n_paths, dtype=np.int32), clen)
    local = j - offsets[pid]
    cbuf = buf[src_off[pid] + local]

    s_nodes = torch.from_numpy(starts >> 1).to(words.device)
    s_fwd = (starts & 1) == 1
    kmers = bk.codes_from_words(words[s_nodes].cpu().numpy(), k)
    rc = (3 - kmers[:, ::-1]).astype(np.uint8)
    oriented = np.where(s_fwd[:, None], kmers, rc)
    kpos = offsets[:-1, None] + np.arange(k)[None, :]
    cbuf[kpos.reshape(-1)] = oriented.reshape(-1)
    del kpos, oriented, kmers, rc, pid, local, j
    return canonical_contigs(cbuf, offsets, depth_sum, k)


def canonical_contigs(cbuf, offsets, depth_sum, k: int):
    """Contigs from the concatenated base codes of the paths (path p is
    cbuf[offsets[p]:offsets[p+1]]): each in canonical orientation (the lesser
    of it and its reverse complement, chosen at the first differing base by
    one ragged permutation), with depth = depth_sum / (len - k + 2)
    (dbjg_traversal.cpp:542)."""
    n_paths = offsets.shape[0] - 1
    if n_paths == 0:
        return []
    clen = np.diff(offsets)
    total = int(offsets[-1])
    j = np.arange(total, dtype=np.int64)
    pid = np.repeat(np.arange(n_paths, dtype=np.int32), clen)
    rc_src = offsets[pid] + (clen[pid] - 1 - (j - offsets[pid]))
    rc_buf = (3 - cbuf[rc_src]).astype(np.uint8)
    del rc_src
    diff = cbuf != rc_buf
    big = total + 1
    first = np.minimum.reduceat(np.where(diff, j, big), offsets[:-1])
    del diff, j
    has = first < big
    rc_less = np.zeros(n_paths, bool)
    idx = first[has]
    rc_less[has] = rc_buf[idx] < cbuf[idx]
    canon = np.where(rc_less[pid], rc_buf, cbuf)

    lut = np.frombuffer(b"ACGT", np.uint8)
    all_bytes = lut[canon].tobytes()
    off = offsets.tolist()
    dep = depth_sum.tolist()
    cl = clen.tolist()
    return [
        (all_bytes[off[p] : off[p + 1]].decode(), dep[p] / (cl[p] - k + 2))
        for p in range(n_paths)
    ]


def _stitch_native(succ_n, base, count, words, k: int, timings=None, min_states: int = 1):
    """Sequential C++ walker; paths shorter than min_states states are
    dropped before rendering."""
    from ..io.native import get_stitch_walk

    walk = get_stitch_walk()
    if walk is None:
        raise RuntimeError("the native stitch walker (native/libmhm2_native.so) is unavailable")
    S = succ_n.shape[0]
    counts = np.ascontiguousarray(count, np.int32)
    max_paths = S + 1
    cap = S + (k - 1) * max_paths
    buf = np.empty(cap, np.uint8)
    starts = np.empty(max_paths, np.int64)
    nst = np.empty(max_paths, np.int64)
    dep = np.empty(max_paths, np.int64)
    t0 = time.perf_counter()
    n_paths = walk(succ_n, base, counts, k, buf, starts, nst, dep)
    if timings is not None:
        timings["walk_s"] = round(time.perf_counter() - t0, 2)
    if n_paths < 0:
        raise RuntimeError("native stitch walker overflowed its buffers")
    starts, nst, dep = starts[:n_paths], nst[:n_paths], dep[:n_paths]
    src_off = np.zeros(n_paths, np.int64)
    np.cumsum(((k - 1) + nst)[:-1], out=src_off[1:])
    if min_states > 1:
        keep = nst >= min_states
        if timings is not None:
            timings["dropped_tiny_paths"] = int(n_paths - keep.sum())
        starts, nst, dep, src_off = starts[keep], nst[keep], dep[keep], src_off[keep]
    t0 = time.perf_counter()
    out = _render_contigs(starts, nst, dep, buf, src_off, words, k)
    if timings is not None:
        timings["render_s"] = round(time.perf_counter() - t0, 2)
    return out


def stitch_paths(edges: dict, words, count, k: int, timings: dict | None = None,
                 min_states: int = 1):
    """Path decomposition -> list of (canonical seq, depth); min_states drops
    paths below that many states before any host materialization."""
    n = int(edges["uu"].shape[0])
    if n == 0:
        return []
    t0 = time.perf_counter()
    packed = _pack_states_device(
        edges["uu"], edges["r_idx"], edges["r_port"], edges["r_ok"],
        edges["l_idx"], edges["l_port"], edges["l_ok"], words, count, k,
    )
    sl, sr, bl, br, cnt = (x.cpu().numpy() for x in packed)
    succ_n = np.empty(2 * n, np.int64)
    succ_n[0::2] = sl
    succ_n[1::2] = sr
    base = np.empty(2 * n, np.uint8)
    base[0::2] = bl
    base[1::2] = br
    if timings is not None:
        timings["pack_fetch_s"] = round(time.perf_counter() - t0, 2)
    if not (succ_n != -2).any():
        return []

    # reciprocity repair (reference clean_frag_links, dbjg_traversal.cpp:
    # 392-430): drop ALL in-edges of merge states (two predecessors) and each
    # dropped edge's mirror, so every state has in-degree <= 1 and the two
    # directions of every chain stay exact mirrors
    pos = succ_n >= 0
    bc = np.bincount(succ_n[pos], minlength=2 * n)
    viol = bc >= 2
    if viol.any():
        drop_src = np.nonzero(pos & viol[np.clip(succ_n, 0, None)])[0]
        tgt = succ_n[drop_src]
        succ_n[drop_src] = -1
        mirror_src = tgt ^ 1
        ok = succ_n[mirror_src] == (drop_src ^ 1)
        succ_n[mirror_src[ok]] = -1
        if timings is not None:
            timings["nonreciprocal_dropped"] = int(drop_src.size + ok.sum())
    return _stitch_native(succ_n, base, cnt, words, k, timings, min_states)
