"""Paired-end Illumina reads simulated from a genome library, shaped as the
CAMI II short-read samples (Meyer et al. 2022, Nat Methods 19:429): 2 x R bp
mates from both strands of fragments of normally distributed length, uniform
substitutions, ambiguous bases (N) alone and in stretches, log-normal
genome abundances (CAMISIM's default, mu 1, sigma 2), and a share of pairs
from genomes outside the library, so that some reads stay unclassified.

The work is the same for every seed: a sample's abundances are the
log-normal's quantiles in a fixed order of its own, each genome gives a
fixed number of pairs, and a fixed number of mates carry a stretch of N.
The seed draws the rest (where fragments start, their lengths and strands,
substitutions, where N falls, the order of the pairs) from one numpy
Generator, so the same seed gives the same reads.
"""

from __future__ import annotations

from statistics import NormalDist
from typing import List, NamedTuple

import numpy as np

_LETTERS = np.frombuffer(b"ACGTN", np.uint8)


class Pairs(NamedTuple):
    """n read pairs: uint8 codes of each mate [n, R] (mate 2 as sequenced,
    reverse complemented), and each pair's source genome (an index into the
    library, -1 outside it)."""

    mate1: np.ndarray
    mate2: np.ndarray
    source: np.ndarray


def profile(n_genomes: int, mu: float, sigma: float, sample: int) -> np.ndarray:
    """Relative abundances of the genomes of sample `sample`: the
    log-normal's quantiles at (i + 0.5) / n, in a fixed order drawn from
    the sample's number, never from the run's seed."""
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n_genomes) for i in range(n_genomes)])
    a = np.exp(mu + sigma * z)[np.random.default_rng(sample).permutation(n_genomes)]
    return a / a.sum()


def apportion(weights: np.ndarray, n: int) -> np.ndarray:
    """n split in proportion to weights, by largest remainders (ties to
    the lower index): whole counts that sum to n."""
    share = n * np.asarray(weights, np.float64) / np.sum(weights)
    counts = np.floor(share).astype(np.int64)
    rest = np.argsort(-(share - counts), kind="stable")[: n - int(counts.sum())]
    counts[rest] += 1
    return counts


def _revcomp(codes: np.ndarray) -> np.ndarray:
    return (3 - codes)[..., ::-1]


def simulate(rng, genomes: List[np.ndarray], outside: List[np.ndarray], abundance: np.ndarray,
             n_pairs: int, read_len: int, frag_mean: float, frag_sd: float, sub_rate: float,
             outside_share: float, n_rate: float = 0.0, n_run_share: float = 0.0,
             n_run_len=(0, 0)) -> Pairs:
    """n_pairs pairs: a share outside_share from the `outside` genomes (as
    many from each), the rest from `genomes` in proportion to abundance x
    length (apportion: the counts never depend on rng); fragments of
    N(frag_mean, frag_sd) bp, at least read_len; either strand with even
    odds; each base substituted with probability sub_rate, then called N
    with probability n_rate; round(n_run_share x n_pairs) mates of each
    side with a stretch of N of n_run_len[0] to n_run_len[1] bases at a
    uniform place. Pairs come in a random order."""
    lengths = np.array([len(g) for g in genomes], np.float64)
    n_out = int(round(outside_share * n_pairs)) if outside else 0
    src = np.concatenate([np.repeat(np.arange(len(genomes)), apportion(abundance * lengths, n_pairs - n_out)),
                          -1 - np.repeat(np.arange(len(outside)), apportion(np.ones(len(outside)), n_out))])
    frag = np.maximum(np.rint(rng.normal(frag_mean, frag_sd, n_pairs)).astype(np.int64), read_len)
    m1 = np.empty((n_pairs, read_len), np.uint8)
    m2 = np.empty((n_pairs, read_len), np.uint8)
    pos = np.arange(read_len)
    for s in np.unique(src):
        g = genomes[s] if s >= 0 else outside[-1 - s]
        rows = np.flatnonzero(src == s)
        f = np.minimum(frag[rows], len(g))
        start = (rng.random(len(rows)) * (len(g) - f + 1)).astype(np.int64)
        m1[rows] = g[start[:, None] + pos]
        m2[rows] = _revcomp(g[(start + f - read_len)[:, None] + pos])
    flip = rng.random(n_pairs) < 0.5  # the reverse strand: the mates change places
    m1[flip], m2[flip] = m2[flip].copy(), m1[flip].copy()
    for m in (m1, m2):
        hit = rng.random(m.shape) < sub_rate
        m[hit] = (m[hit] + rng.integers(1, 4, int(hit.sum()), dtype=np.uint8)) % 4
        m[rng.random(m.shape) < n_rate] = 4
        rows = np.sort(rng.choice(n_pairs, int(round(n_run_share * n_pairs)), replace=False))
        lo, hi = int(n_run_len[0]), min(int(n_run_len[1]), read_len)
        length = rng.integers(lo, hi + 1, len(rows))
        start = (rng.random(len(rows)) * (read_len - length + 1)).astype(np.int64)
        for r, a, n in zip(rows.tolist(), start.tolist(), length.tolist()):
            m[r, a : a + n] = 4
    order = rng.permutation(n_pairs)
    return Pairs(m1[order], m2[order], np.where(src[order] >= 0, src[order], -1))


def title(prefix: str, i: int) -> str:
    """The title of read i of a sample file: prefix and a zero-padded number."""
    return f"{prefix}{i:07d}"


def titles(prefix: str, n: int) -> List[str]:
    """The read titles of a sample file."""
    return [title(prefix, i) for i in range(n)]


def fastq_bytes(prefix: str, codes: np.ndarray) -> bytes:
    """FASTQ records of equal-length reads titled titles(prefix, n), quality
    I throughout, built as one fixed-width byte array."""
    n, R = codes.shape
    t = np.frombuffer("".join(titles(prefix, n)).encode("ascii"), np.uint8).reshape(n, -1)
    col = lambda b: np.full((n, len(b)), np.frombuffer(b, np.uint8))  # noqa: E731
    rows = np.concatenate([col(b"@"), t, col(b"\n"), _LETTERS[codes], col(b"\n+\n"),
                           col(b"I" * R), col(b"\n")], axis=1)
    return rows.tobytes()
