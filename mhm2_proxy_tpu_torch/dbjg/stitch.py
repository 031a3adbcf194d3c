"""Path stitching by pointer doubling (port of mhm2_proxy_tpu/dbjg/stitch.py).

The reciprocal UU edge graph is a disjoint union of simple paths and
cycles; each node yields two directed walk states s = 2*node + exit_port
(0=L, 1=R), int32 ids. Every step runs on the device that holds the edge
dict (the card, or the CPU for CPU tensors): the pack into per-state
successors, bases and counts; the reciprocity repair; a pointer doubling
that finds every state's terminal and its cycle's minimum node; the cut of
each cycle at its leader; a second doubling for every state's terminal and
distance; the starts and the rule that emits one direction of each path;
the path map; the base scatter and the depth sums; and the render of
canonical contigs. The host receives one copy, the kept contigs' ASCII
bases with their depth sums and offsets, and only slices it into strings.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import bitkmer as bk
from ..utils import trace

STAGE = "traverse.stitch."  # the stages' span names: STAGE + pack, repair, ...


def _pack_states_device(uu, r_idx, r_port, r_ok, l_idx, l_port, l_ok, words, count, k: int):
    """Interleaved per-state successors (2n,) int32 (-1 terminal, -2
    invalid), per-state emitted bases (2n,) uint8 (exit L -> comp(first
    base), exit R -> last base) and the node counts clamped to u16, as int32."""
    succ_l = torch.where(l_ok & uu, 2 * l_idx.to(torch.int32) + (1 - l_port.to(torch.int32)), -1)
    succ_r = torch.where(r_ok & uu, 2 * r_idx.to(torch.int32) + (1 - r_port.to(torch.int32)), -1)
    succ = torch.stack([torch.where(uu, succ_l, -2), torch.where(uu, succ_r, -2)], 1).view(-1)
    base = torch.stack([3 - bk.first_base(words), bk.last_base(words, k)], 1).view(-1)
    return succ.to(torch.int32), base.to(torch.uint8), torch.clamp(count, 0, 0xFFFF).to(torch.int32)


def _repair(succ):
    """Reciprocity repair (reference clean_frag_links, dbjg_traversal.cpp:
    392-430): drop ALL in-edges of merge states (two predecessors) and each
    dropped edge's mirror, so every state has in-degree <= 1 and the two
    directions of every chain stay exact mirrors. Returns the repaired
    successors and the number of edges dropped."""
    S = succ.shape[0]
    pos = succ >= 0
    indeg = torch.bincount(torch.where(pos, succ, S), minlength=S + 1)[:S]
    drop = pos & (indeg >= 2).index_select(0, succ.clamp(min=0))
    cut = torch.where(drop, -1, succ)
    # the mirror of a dropped edge s -> t is t^1 -> s^1: state m is one when
    # its (remaining) successor's mirror s was dropped with target m^1
    src = (cut ^ 1).clamp(min=0)
    own = torch.arange(S, dtype=torch.int32, device=succ.device)
    mirror = (cut >= 0) & drop.index_select(0, src) & ((succ.index_select(0, src) ^ 1) == own)
    return torch.where(mirror, -1, cut), int(drop.sum() + mirror.sum())


def _doubling(nxt, val, rounds: int, combine):
    """`rounds` pointer-doubling steps: val[s] = combine(val[s], val[nxt[s]]),
    then nxt[s] = nxt[nxt[s]]. From nxt = successor (terminals pointing to
    themselves), nxt ends at every path state's terminal."""
    for _ in range(rounds):
        val = combine(val, val.index_select(0, nxt))
        nxt = nxt.index_select(0, nxt)
    return nxt, val


def canonical_contigs(plen, path, pos, base, count, heads, head_fwd, k: int, timings=None,
                      counts=None):
    """Contigs of n_paths paths from their on-path states, on the states'
    device: contigs_from_blob of render_contigs_blob. `counts`, if a dict,
    receives fetched_bytes."""
    blob = render_contigs_blob(plen, path, pos, base, count, heads, head_fwd, k, timings)
    t0 = trace.now()
    out = contigs_from_blob(blob, plen.shape[0], k)
    trace.lap(timings, "strings_s", t0, plen.device, STAGE, fetched_bytes=blob.nbytes)
    if counts is not None:
        counts["fetched_bytes"] = blob.nbytes
    return out


def render_contigs_blob(plen, path, pos, base, count, heads, head_fwd, k: int, timings=None):
    """The rendered contigs of n_paths paths in one host copy, uint8: the
    offsets (n_paths + 1 int64), the depth sums (n_paths int64), then the
    ASCII bases.

    plen (n_paths,): states a path; path, pos, base, count: each on-path
    state's path rank, position from its path's start, emitted base and
    node count; heads (n_paths, W): the words of each start's node;
    head_fwd: the start exits right. A contig is its start's k-mer in the
    start's orientation, then one base a later state; it is put in canonical
    orientation (the lesser of it and its reverse complement, decided at
    their first differing base), with its depth sum: the sum of its states'
    counts. `timings`, if a dict, receives render_s and fetch_s."""
    dev = plen.device
    n_paths = plen.shape[0]
    t0 = trace.now()
    clen = plen.to(torch.int64) + (k - 1)
    offsets = torch.zeros(n_paths + 1, dtype=torch.int64, device=dev)
    torch.cumsum(clen, 0, out=offsets[1:])
    total = int(offsets[-1])
    buf = torch.zeros(total, dtype=torch.uint8, device=dev)
    buf[offsets[path] + (k - 1) + pos] = base
    depth = torch.zeros(n_paths, dtype=torch.int64, device=dev)
    depth.index_add_(0, path, count.to(torch.int64))
    # the head k-mers, written over the start's own base at offset k-1
    codes = bk.codes_from_word_tensor(heads, k)
    codes = torch.where(head_fwd[:, None], codes, 3 - codes.flip(1))
    buf[(offsets[:-1, None] + torch.arange(k, device=dev)).view(-1)] = codes.view(-1)
    del codes
    # the reverse complement of every path and its first base that differs
    pid = torch.repeat_interleave(torch.arange(n_paths, device=dev), clen, output_size=total)
    j = torch.arange(total, device=dev)
    rc = 3 - buf[offsets[pid] + offsets[pid + 1] - 1 - j]
    first = torch.full((n_paths,), total, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, pid, torch.where(buf != rc, j, total), "amin")
    del j
    # a path with no differing base reads the same either way
    at = first.clamp(max=total - 1)
    rc_less = rc[at] < buf[at]
    lut = torch.tensor(list(b"ACGT"), dtype=torch.uint8, device=dev)
    text = lut[torch.where(rc_less[pid], rc, buf).to(torch.int64)]
    del pid, rc, buf
    t0 = trace.lap(timings, "render_s", t0, dev, STAGE)
    blob = torch.cat([offsets.view(torch.uint8), depth.view(torch.uint8), text]).cpu().numpy()
    trace.lap(timings, "fetch_s", t0, dev, STAGE)
    return blob


def contigs_from_blob(blob, n_paths: int, k: int):
    """render_contigs_blob's copy -> list of (seq, depth), depth = the depth
    sum / (len - k + 2) (dbjg_traversal.cpp:542)."""
    off = blob[: 8 * (n_paths + 1)].view(np.int64).tolist()
    dep = blob[8 * (n_paths + 1) : 8 * (2 * n_paths + 1)].view(np.int64).tolist()
    all_bytes = blob[8 * (2 * n_paths + 1) :].tobytes()
    return [
        (all_bytes[off[p] : off[p + 1]].decode(), dep[p] / (off[p + 1] - off[p] - k + 2))
        for p in range(n_paths)
    ]


def stitch_paths(edges: dict, words, count, k: int, timings: dict | None = None,
                 min_states: int = 1, counts: dict | None = None):
    """Path decomposition -> list of (canonical seq, depth), on the device
    of the edge dict.

    min_states drops paths below that many states before anything reaches
    the host (the assembler passes its k + 2 contig bound; at k = 21 the
    graph has tens of millions of 1-2 state paths). `timings`, if a dict,
    receives each stage's seconds, each stage ending at a sync of the
    device's queued work; `counts` (else `timings`), if a dict, receives
    the counts of states and paths, the repair's dropped edges and the
    bytes fetched. While a trace records, each stage is a span
    STAGE + <stage> holding those counts."""
    n = int(edges["uu"].shape[0])
    if n == 0:
        return []
    if 2 * n >= 2 ** 31:
        raise ValueError("state ids exceed int32: more than 2^30 table rows")
    S = 2 * n
    dev = words.device
    counts = timings if counts is None else counts
    t0 = trace.now()
    succ, base, cnt = _pack_states_device(
        edges["uu"], edges["r_idx"], edges["r_port"], edges["r_ok"],
        edges["l_idx"], edges["l_port"], edges["l_ok"], words, count, k,
    )
    t0 = trace.lap(timings, "pack_s", t0, dev, STAGE)
    state_valid = succ != -2
    if not bool(state_valid.any()):
        return []
    succ, n_dropped = _repair(succ)
    if counts is not None and n_dropped:
        counts["nonreciprocal_dropped"] = n_dropped
    succ = torch.where(state_valid, succ, -1)
    t0 = trace.lap(timings, "repair_s", t0, dev, STAGE, nonreciprocal_dropped=n_dropped)

    rounds = max(1, int(np.ceil(np.log2(S + 1))) + 1)
    own = torch.arange(S, dtype=torch.int32, device=dev)
    term = succ < 0
    # one doubling gives each state's terminal and its cycle's minimum node
    # (the reference's first doubling reads only the terminal, and its
    # minimum pass follows the same pointers)
    nxt, mini = _doubling(torch.where(term, own, succ), own >> 1, rounds, torch.minimum)
    in_cycle = state_valid & ~term.index_select(0, nxt)
    # cut the edge entering (min node, exit R), so each forward cycle becomes
    # a path from its leader
    succ2 = torch.where(in_cycle & (succ == 2 * mini + 1), -1, succ)
    del nxt, mini, succ
    t0 = trace.lap(timings, "cycles_s", t0, dev, STAGE)

    term2 = succ2 < 0
    # d2 of a state still on a cycle is meaningless (it may wrap); it is read
    # only for path states below
    nxt2, d2 = _doubling(torch.where(term2, own, succ2), (~term2).to(torch.int32), rounds,
                         torch.add)
    off_cycle = state_valid & term2.index_select(0, nxt2)
    has_pred = torch.bincount(torch.where(term2, S, succ2), minlength=S + 1)[:S] > 0
    del succ2, term2
    is_start = off_cycle & ~has_pred
    # the cut leaders, and of each path's two directions the one whose start
    # is below its terminal's mirror
    emit = is_start & (in_cycle | (own < (nxt2 ^ 1)))
    starts = torch.nonzero(emit & (d2 >= min_states - 1)).squeeze(1)
    n_paths = starts.shape[0]
    found = {}
    if counts is not None or trace.is_recording():
        found = dict(states=S, paths=int(emit.sum()), paths_kept=n_paths)
        if counts is not None:
            counts.update(found)
    del in_cycle, has_pred, is_start, emit
    t0 = trace.lap(timings, "paths_s", t0, dev, STAGE, **found)
    if n_paths == 0:
        return []

    # path map: the registry of each kept start at its terminal, read by
    # every state at its own terminal; position = d2[start] - d2[state]
    registry = torch.full((S,), -1, dtype=torch.int32, device=dev)
    registry[nxt2[starts].to(torch.int64)] = torch.arange(n_paths, dtype=torch.int32, device=dev)
    path = torch.where(off_cycle, registry.index_select(0, nxt2), -1)
    on = torch.nonzero(path >= 0).squeeze(1)
    path = path[on].to(torch.int64)
    d_start = d2[starts]
    pos = (d_start[path] - d2[on]).to(torch.int64)
    del registry, nxt2, d2, off_cycle
    trace.lap(timings, "path_map_s", t0, dev, STAGE)
    return canonical_contigs(d_start + 1, path, pos, base[on], cnt[on >> 1], words[starts >> 1],
                             (starts & 1) == 1, k, timings, counts)
