"""GFA2 assembly-graph output.

Full MHM2 documents GFA2 graph output of the final assembly
(reference docs/mhm_guide.md:235-239). Segments are contigs; edges connect
oriented contig ends that overlap by (k-1) bases — the boundaries at which
de Bruijn traversal stopped with a fork (F) call. Every orientation pairing
is enumerated (tail->head, tail->tail, head->head via the '-' forms), so a
fork with multiple continuations emits one edge per continuation
(multi-edges), not just the '+/+ suffix' case.
"""

from __future__ import annotations

_COMP = str.maketrans("ACGTNacgtn", "TGCANtgcan")


def revcomp_str(s: str) -> str:
    """Reverse complement of an ACGTN string (reference utils.cpp:94-119)."""
    return s.translate(_COMP)[::-1]


def write_gfa2(fname: str, contigs, k: int):
    """contigs: iterable of (id, seq, depth). Writes GFA2; returns #edges.

    Edge model: an edge exists between oriented segments X and Y whenever
    suffix(X, k-1) == prefix(Y, k-1). X ranges over both orientations of
    every contig; the edge X->Y and its mirror revcomp(Y)->revcomp(X) are the
    same edge and emitted once. GFA2 beg/end positions are in each segment's
    own (unoriented) coordinates, with $ marking the segment end.
    """
    contigs = list(contigs)
    seqs = {cid: seq for cid, seq, _ in contigs}

    # prefix index over oriented segments: prefix(B+) = head(B),
    # prefix(B-) = revcomp(tail(B))
    prefix: dict[str, list] = {}
    for cid, seq, _ in contigs:
        if len(seq) < k:
            continue
        prefix.setdefault(seq[: k - 1], []).append((cid, "+"))
        prefix.setdefault(revcomp_str(seq[-(k - 1) :]), []).append((cid, "-"))

    lines = ["H\tVN:Z:2.0"]
    for cid, seq, depth in contigs:
        lines.append(f"S\tContig{cid}\t{len(seq)}\t{seq}\tDP:f:{depth:.3f}")

    def _suffix_coords(cid, orient):
        n = len(seqs[cid])
        # suffix of A+ sits at the tail of A; suffix of A- is A's head revcomp
        return (n - (k - 1), f"{n}$") if orient == "+" else (0, k - 1)

    def _prefix_coords(cid, orient):
        n = len(seqs[cid])
        return (0, k - 1) if orient == "+" else (n - (k - 1), f"{n}$")

    flip = {"+": "-", "-": "+"}
    seen = set()
    eid = 0
    for cid, seq, _ in contigs:
        if len(seq) < k:
            continue
        for o1 in ("+", "-"):
            sfx = seq[-(k - 1) :] if o1 == "+" else revcomp_str(seq[: k - 1])
            for cid2, o2 in prefix.get(sfx, []):
                if cid2 == cid and o2 == flip[o1]:
                    # X -> revcomp(X) on the same (k-1)-palindromic end:
                    # a degenerate self-mirror, not a graph edge
                    continue
                key = (cid, o1, cid2, o2)
                mirror = (cid2, flip[o2], cid, flip[o1])
                if key in seen or mirror in seen:
                    continue
                seen.add(key)
                b1, e1 = _suffix_coords(cid, o1)
                b2, e2 = _prefix_coords(cid2, o2)
                lines.append(
                    f"E\te{eid}\tContig{cid}{o1}\tContig{cid2}{o2}\t"
                    f"{b1}\t{e1}\t{b2}\t{e2}\t{k - 1}M"
                )
                eid += 1
    with open(fname, "w") as f:
        f.write("\n".join(lines) + "\n")
    return eid
