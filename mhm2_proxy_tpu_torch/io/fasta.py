"""FASTA output/input (reference src/contigs.cpp:166-180 dump_contigs)."""

from __future__ import annotations

import gzip


def write_fasta(fname: str, contigs, min_len: int = 0):
    """contigs: iterable of (id, seq, depth). Format '>Contig<id> <depth>'."""
    opener = gzip.open if fname.endswith(".gz") else open
    with opener(fname, "wt") as f:
        for cid, seq, depth in contigs:
            if len(seq) < min_len:
                continue
            f.write(f">Contig{cid} {depth}\n{seq}\n")


def read_fasta(fname: str):
    opener = gzip.open if fname.endswith(".gz") else open
    out = []
    name, parts = None, []
    with opener(fname, "rt") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    out.append((name, "".join(parts)))
                name, parts = line[1:], []
            else:
                parts.append(line)
    if name is not None:
        out.append((name, "".join(parts)))
    return out
