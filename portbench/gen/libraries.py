"""The deployments' taxonomies and genome libraries, made from the run's seed.

A taxonomy has NCBI's standard ranks, the ones a Kraken 2 report names (D, P,
C, O, F, G, S under the root), with a fixed number of taxa of each rank under
each taxon of the rank above. A library holds one bacterial-size genome a
species: sizes are the quantiles of a log-normal, in a fixed order, so they
never depend on the seed; the bases do. Each taxon of the tree carries a
genome from which its children's genomes are copied with a share of their
bases substituted (its rank's divergence); a divergence of 0.75 or more
gives the child a random genome of its own, unrelated to any other.

The taxonomy is returned as plain (taxid, parent, rank) and (taxid, name)
tuples; the harness builds the program's Taxonomy from them, the reference
reads them as they are.
"""

from __future__ import annotations

from statistics import NormalDist
from typing import Dict, Iterator, List, Tuple

import numpy as np

_ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)

#: the ranks below the root, from the top down (a Kraken 2 report's D, P, C, O, F, G, S)
RANKS = ("superkingdom", "phylum", "class", "order", "family", "genus", "species")
#: a divergence from which a genome is random, not a copy
UNRELATED = 0.75

Nodes = List[Tuple[int, int, str]]


def ranked_taxonomy(tax: dict) -> Tuple[Nodes, List[Tuple[int, str]]]:
    """(nodes, names) of a tree of tax["n_species"] species with
    tax["per_parent"][rank] taxa of each rank under each taxon of the rank
    above (the last taxon of a rank may hold fewer); the superkingdoms sit
    under the root. Taxids are given from the top down, 2, 3, ..., so the
    species come last and in order, and taxon i of a rank has taxon
    i // per_parent of the rank above as its parent."""
    per = tax["per_parent"]
    counts = [int(tax["n_species"])]
    for rank in RANKS[:0:-1]:  # species up to phylum: how many of the rank above
        counts.append(-(-counts[-1] // int(per[rank])))
    counts = counts[::-1]  # superkingdom first
    first, nxt = [], 2
    for n in counts:
        first.append(nxt)
        nxt += n
    nodes = [(1, 1, "root")]
    for level, (rank, n) in enumerate(zip(RANKS, counts)):
        for i in range(n):
            parent = 1 if level == 0 else first[level - 1] + i // int(per[rank])
            nodes.append((first[level] + i, parent, rank))
    return nodes, [(t, f"taxon{t}") for t, _, _ in nodes]


TAXONOMIES = {"ranked_taxonomy": ranked_taxonomy}


def genome_sizes(lib: dict, n: int) -> np.ndarray:
    """n genome sizes: the log-normal's quantiles at (i + 0.5) / n (median
    lib["size_median_bp"], sigma lib["size_sigma"]), cut to
    [size_min_bp, size_max_bp], in a fixed shuffled order."""
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    sizes = np.rint(float(lib["size_median_bp"]) * np.exp(float(lib["size_sigma"]) * z))
    sizes = np.clip(sizes, int(lib["size_min_bp"]), int(lib["size_max_bp"])).astype(np.int64)
    return sizes[np.random.default_rng(0).permutation(n)]


def tree_library(lib: dict, nodes: Nodes, seed: int) -> Iterator[Tuple[int, str]]:
    """(species taxid, genome) of each species, in taxid order: sizes from
    genome_sizes; each taxon's genome is its parent's cut to the longest
    genome below it, with a share lib["divergence"][rank] of its bases
    substituted, or a random genome where that share is UNRELATED or more
    (and always at the top of the tree)."""
    div: Dict[str, float] = {r: float(lib["divergence"][r]) for r in RANKS}
    children: Dict[int, List[int]] = {}
    rank = {}
    for t, p, r in nodes:
        rank[t] = r
        if t != 1:
            children.setdefault(p, []).append(t)
    species = [t for t, _, r in nodes if r == "species"]
    size = dict(zip(species, genome_sizes(lib, len(species)).tolist()))

    def longest(t: int) -> int:
        if t not in size:
            size[t] = max(longest(c) for c in children[t])
        return size[t]

    rng = np.random.default_rng(seed)

    def genome(t: int, parent) -> np.ndarray:
        n, d = longest(t), div[rank[t]]
        if parent is None or d >= UNRELATED:
            return rng.integers(0, 4, n, dtype=np.uint8)
        out = parent[:n].copy()
        hit = np.flatnonzero(rng.random(n) < d)
        out[hit] = (out[hit] + rng.integers(1, 4, len(hit), dtype=np.uint8)) % 4
        return out

    def walk(t: int, parent):
        if rank[t] == "species":
            yield t, _ACGT[genome(t, parent)].tobytes().decode("ascii")
            return
        related = any(div[rank[c]] < UNRELATED for c in children[t])
        own = genome(t, parent) if related else None  # a genome only where a child copies it
        for c in sorted(children[t]):
            yield from walk(c, own)

    for top in sorted(children[1]):
        yield from walk(top, None)


LIBRARIES = {"tree_library": tree_library}

#: byte -> 2-bit code (A, C, G, T and their lower case; 4 for anything else)
CODE_LUT = np.full(256, 4, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    CODE_LUT[_c] = _i
    CODE_LUT[ord(chr(_c).lower())] = _i
CODE_LUT[ord("U")] = CODE_LUT[ord("u")] = 3


def encode(seq: str) -> np.ndarray:
    """uint8 codes of a sequence string (4 for a base that is not ACGT)."""
    return CODE_LUT[np.frombuffer(seq.encode("ascii"), np.uint8)]
