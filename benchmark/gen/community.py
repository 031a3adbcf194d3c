"""Seeded metagenome communities: random genomes and Illumina-like pairs.

A vectorised copy of the parameters of the repository's community
generator (`chip_smoke.py::make_community` on `utils/synth.py`): random
genomes, fragments of a normal insert length (floored at read length + 10),
read 1 from the fragment's start and read 2 as the reverse complement of its
end, substitutions at a uniform rate, and low quality on a share of the
substituted bases. It does not reproduce that generator's bytes: it draws
the same distributions in bulk.

Everything is a function of (configuration, seed). The number of pairs of
each genome is fixed by the configuration alone, so every seed makes the
same amount of work, in another order and with other bases.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

BASES = np.frombuffer(b"ACGT", np.uint8)
# ASCII -> complement ASCII (A<->T, C<->G)
_COMP_CODE = np.array([3, 2, 1, 0], np.uint8)


@dataclasses.dataclass
class Community:
    """Pairs as code arrays (A=0 C=1 G=2 T=3), raw phred qualities, and the
    genome each pair came from; reads of one configuration share a length."""

    codes1: np.ndarray  # (P, L) uint8
    quals1: np.ndarray  # (P, L) uint8 phred
    codes2: np.ndarray
    quals2: np.ndarray
    genome_of_pair: np.ndarray  # (P,) int16
    insert_len: np.ndarray  # (P,) int32
    start: np.ndarray  # (P,) int64: the fragment's first base in its genome
    n_errors: int
    genomes: list  # (G_i,) uint8 code arrays

    @property
    def n_pairs(self) -> int:
        return self.codes1.shape[0]


def pairs_per_genome(cfg: dict) -> np.ndarray:
    """Pairs drawn from each genome: `pairs` split in proportion to the
    configuration's `abundances` by largest remainder (uniform without them)."""
    g = cfg["genomes"]
    ab = np.asarray(cfg.get("abundances") or [1.0] * g, np.float64)
    if ab.shape != (g,):
        raise ValueError(f"{cfg['name']}: {ab.shape[0]} abundances for {g} genomes")
    share = ab / ab.sum() * cfg["pairs"]
    n = np.floor(share).astype(np.int64)
    rest = cfg["pairs"] - int(n.sum())
    n[np.argsort(-(share - n), kind="stable")[:rest]] += 1
    return n


def make_community(cfg: dict, seed: int) -> Community:
    """The configuration's community for `seed` (any int up to 2**63)."""
    rng = np.random.default_rng([int(seed) & ((1 << 64) - 1), 0x6D686D32])
    L = cfg["read_len"]
    per = pairs_per_genome(cfg)
    genomes, c1, c2, gid, ins_all, starts = [], [], [], [], [], []
    for g in range(cfg["genomes"]):
        G = cfg["genome_len"]
        genome = rng.integers(0, 4, G, dtype=np.uint8)
        genomes.append(genome)
        n = int(per[g])
        ins = np.maximum(L + 10, rng.normal(cfg["insert_mean"], cfg["insert_sd"], n)
                         .astype(np.int64))
        ins = np.minimum(ins, G)
        start = (rng.random(n) * np.maximum(1, G - ins)).astype(np.int64)
        j = np.arange(L, dtype=np.int64)
        c1.append(genome[start[:, None] + j])
        c2.append(_COMP_CODE[genome[(start + ins - 1)[:, None] - j]])
        gid.append(np.full(n, g, np.int16))
        ins_all.append(ins.astype(np.int32))
        starts.append(start)
    codes = np.stack([np.concatenate(c1), np.concatenate(c2)], 1)  # (P, 2, L)
    gid = np.concatenate(gid)
    ins_all = np.concatenate(ins_all)
    starts = np.concatenate(starts)
    del c1, c2
    quals = np.full(codes.shape, cfg["qual_hi"], np.uint8)
    err = rng.random(codes.shape, dtype=np.float32) < np.float32(cfg["err_rate"])
    n_err = int(err.sum())
    shift = rng.integers(1, 4, n_err, dtype=np.uint8)
    codes[err] = (codes[err] + shift) % 4
    low = rng.random(n_err, dtype=np.float32) < np.float32(cfg["low_qual_share_of_errors"])
    qv = quals[err]
    qv[low] = cfg["qual_lo"]
    quals[err] = qv
    order = rng.permutation(codes.shape[0])
    codes, quals = codes[order], quals[order]
    return Community(
        codes1=np.ascontiguousarray(codes[:, 0]), quals1=np.ascontiguousarray(quals[:, 0]),
        codes2=np.ascontiguousarray(codes[:, 1]), quals2=np.ascontiguousarray(quals[:, 1]),
        genome_of_pair=gid[order], insert_len=ins_all[order], start=starts[order],
        n_errors=n_err, genomes=genomes,
    )


def _digits(x: np.ndarray, width: int) -> np.ndarray:
    """(n,) non-negative ints -> (n, width) ASCII decimal digits."""
    p = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
    return (48 + (x[:, None] // p) % 10).astype(np.uint8)


def fastq_bytes(com: Community, qual_offset: int = 33, rows=None) -> bytes:
    """One interleaved FASTQ: `@p<pair>/1`, then its mate `@p<pair>/2`,
    built as one fixed-width byte matrix (every record has one length)."""
    idx = np.arange(com.n_pairs, dtype=np.int64) if rows is None else np.asarray(rows)
    n, L = idx.shape[0], com.codes1.shape[1]
    width = max(7, len(str(max(com.n_pairs - 1, 0))))
    name = _digits(idx, width)
    rec = 1 + 1 + width + 2 + 1 + L + 1 + 2 + L + 1  # @p<digits>/m \n seq \n + \n qual \n
    out = np.empty((n, 2, rec), np.uint8)
    for m, (codes, quals) in enumerate(((com.codes1, com.quals1), (com.codes2, com.quals2))):
        o = out[:, m]
        o[:, 0] = ord("@")
        o[:, 1] = ord("p")
        o[:, 2 : 2 + width] = name
        c = 2 + width
        o[:, c] = ord("/")
        o[:, c + 1] = ord("1") + m
        o[:, c + 2] = 10
        c += 3
        o[:, c : c + L] = BASES[codes[idx]]
        o[:, c + L] = 10
        o[:, c + L + 1] = ord("+")
        o[:, c + L + 2] = 10
        c += L + 3
        o[:, c : c + L] = quals[idx] + qual_offset
        o[:, c + L] = 10
    return out.tobytes()


def write_fastq(com: Community, path: str, qual_offset: int = 33, rows=None) -> int:
    """Write the interleaved FASTQ (all pairs, or `rows`); returns its bytes."""
    data = fastq_bytes(com, qual_offset, rows)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
    return len(data)
