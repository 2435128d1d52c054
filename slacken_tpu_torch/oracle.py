"""Naive pure-Python oracle of the Kraken 2 / Slacken algorithms, the
port's own copy (the port imports nothing outside itself): the string-level
minimizer, span, LCA and resolveTree oracles, the naive index and per-read
classification built on them, and the random taxonomies and genome
libraries that the fuzz harness (slacken_tpu_torch/fuzz.py) draws. It is the
same strategy as the reference's LowestCommonAncestorProps.scala:66-108
oracle.

Everything here favours clarity over speed and works on Python ints and
strings. It stays independent of the code it checks: it never calls the
port's scan, probe, resolve or report; `random_taxonomy` only builds the
port's Taxonomy object, whose parents it then reads.
"""

from __future__ import annotations

import math

from .taxonomy import RANK_TITLES, Taxonomy

DEFAULT_TOGGLE_MASK = 0xE37E28C4271B5A2D

CODE = {"A": 0, "C": 1, "G": 2, "T": 3, "U": 3}
for _k, _v in list(CODE.items()):
    CODE[_k.lower()] = _v


def enc(ch: str) -> int:
    return CODE.get(ch, 4)


def encode(seq: str):
    return [enc(c) for c in seq]


def mmer_value(codes, start, m) -> int:
    v = 0
    for j in range(start, start + m):
        v = (v << 2) | (codes[j] & 3)
    return v


def revcomp_value(v: int, m: int) -> int:
    r = 0
    for _ in range(m):
        r = (r << 2) | ((v & 3) ^ 3)
        v >>= 2
    return r


def canonical_value(v: int, m: int) -> int:
    return min(v, revcomp_value(v, m))


def space_mask(m: int, s: int) -> int:
    mask = (1 << (2 * m)) - 1
    for j in range(s):
        mask &= ~(0b11 << (2 * (2 * j + 1)))
    return mask


def wide_toggle(m: int, toggle: int) -> int:
    """Toggle mask over 2m bits with the reference's multi-long replication
    (MinimizerPriorities.scala:146-160): full 32-nt longs carry the whole
    64-bit mask; a trailing partial long of r nts carries its low 2r bits."""
    if m <= 32:
        return toggle & ((1 << (2 * m)) - 1)
    r = m % 32
    val = 0
    for _ in range(m // 32):
        val = (val << 64) | (toggle & ((1 << 64) - 1))
    if r:
        val = (val << (2 * r)) | (toggle & ((1 << (2 * r)) - 1))
    return val


def priority(v: int, m: int, s: int, toggle=DEFAULT_TOGGLE_MASK, canonical=True) -> int:
    if canonical:
        v = canonical_value(v, m)
    p = v ^ wide_toggle(m, toggle)
    if s > 0:
        p &= space_mask(m, s)
    return p


def window_minimizers(codes, k, m, s, toggle=DEFAULT_TOGGLE_MASK, canonical=True):
    """For each k-window start i: (minimizer value or None if window invalid)."""
    L = len(codes)
    out = []
    prios = []
    for i in range(L):
        if i + m <= L and all(c < 4 for c in codes[i : i + m]):
            prios.append(priority(mmer_value(codes, i, m), m, s, toggle, canonical))
        else:
            prios.append(None)
    for i in range(L):
        if i + k <= L and all(c < 4 for c in codes[i : i + k]):
            vals = [prios[j] for j in range(i, i + k - m + 1)]
            out.append(min(vals))
        else:
            out.append(None)
    return out


def spans(codes, k, m, s, toggle=DEFAULT_TOGGLE_MASK, canonical=True):
    """Super-mer spans: list of (start, n_windows, minimizer, distinct).

    Follows MinSplitter.splitRead + Supermers.spans: a span is a maximal run
    of consecutive valid windows with equal minimizer value; `distinct` is
    True iff the span's minimizer differs from the previous span's (the first
    span is distinct), carried across validity gaps.
    """
    wm = window_minimizers(codes, k, m, s, toggle, canonical)
    result = []
    last_valid_value = None
    i = 0
    L = len(wm)
    while i < L:
        if wm[i] is None:
            i += 1
            continue
        j = i
        while j + 1 < L and wm[j + 1] == wm[i]:
            j += 1
        distinct = last_valid_value is None or wm[i] != last_valid_value
        result.append((i, j - i + 1, wm[i], distinct))
        last_valid_value = wm[i]
        i = j + 1
    return result


# ---------------------------------------------------------------------------
# Taxonomy / LCA / resolveTree oracles
# ---------------------------------------------------------------------------

NONE = 0
ROOT = 1


def lca(parents, a, b):
    """Kraken 1 krakenutil.cpp algorithm (LowestCommonAncestor.scala:49-78)."""
    if a == NONE or b == NONE:
        return a if b == NONE else b
    path = []
    x = a
    while x != NONE:
        path.append(x)
        x = parents[x]
    x = b
    while x != NONE:
        if x in path:
            return x
        x = parents[x]
    return ROOT


def has_ancestor(parents, tax, anc):
    x = tax
    while x != NONE:
        if x == anc:
            return True
        x = parents[x]
    return False


def resolve_tree(parents, hit_counts: dict, required_score: float) -> int:
    """Naive reimplementation of LowestCommonAncestor.resolveTree
    (LowestCommonAncestor.scala:101-146)."""
    max_taxon = 0
    max_score = 0
    for taxon in hit_counts:
        if taxon == NONE:
            continue
        node = taxon
        score = 0
        while node != NONE:
            score += hit_counts.get(node, 0)
            node = parents[node]
        if score > max_score:
            max_taxon, max_score = taxon, score
        elif score == max_score:
            max_taxon = lca(parents, max_taxon, taxon)

    max_score = hit_counts.get(max_taxon, 0)
    while max_taxon != NONE and max_score < required_score:
        max_score = 0
        for taxon, cnt in hit_counts.items():
            if taxon != NONE and has_ancestor(parents, taxon, max_taxon):
                max_score += cnt
        if max_score >= required_score:
            return max_taxon
        max_taxon = parents[max_taxon]
    return max_taxon


def classify_read(parents, window_taxa, ambig_kmers, confidence, min_hit_groups, num_distinct):
    """Full per-read classification given per-window LCA taxa.

    window_taxa: ordered taxa of all valid windows (0 = not found);
    ambig_kmers: count of pseudo-kmers from ambiguous segments >= k.
    Mirrors Classifier.classify (Classifier.scala:439-454).
    """
    counts = {}
    for t in window_taxa:
        counts[t] = counts.get(t, 0) + 1
    total = len(window_taxa) + ambig_kmers
    required = math.ceil(confidence * total)
    taxon = resolve_tree(parents, counts, required)
    classified = taxon != NONE and num_distinct >= min_hit_groups
    return (classified, taxon if classified else NONE)


# ---------------------------------------------------------------------------
# Naive index and per-read classification
# ---------------------------------------------------------------------------


def oracle_index(genomes, k, m, s, parents):
    """(minimizer -> LCA taxon) built naively from per-genome spans."""
    by_min = {}
    for taxon, seq in genomes:
        for _, _, value, _ in spans(encode(seq), k, m, s):
            if value in by_min:
                by_min[value] = lca(parents, by_min[value], taxon)
            else:
                by_min[value] = taxon
    return by_min


def oracle_classify(seq, seq2, idx_map, parents, k, m, s, conf, min_hit_groups):
    """Full per-read oracle: spans -> lookup -> ordered hits -> resolveTree.
    Returns (classified, taxon, hit_details, length_string)."""
    mates = [seq] if seq2 is None else [seq, seq2]
    all_hits = []  # ordered (taxon, count), with border markers -2
    window_taxa = []
    num_distinct = 0
    last_min = None
    ambig = 0
    for mi, mate in enumerate(mates):
        if mi > 0:
            all_hits.append((-2, 0))
        codes = encode(mate)
        # char runs
        i = 0
        n = len(codes)
        while i < n:
            j = i
            while j < n and (codes[j] < 4) == (codes[i] < 4):
                j += 1
            if j - i >= k:
                if codes[i] < 4:
                    sps = spans(codes[i:j], k, m, s)
                    for start, nwin, value, _ in sps:
                        taxon = idx_map.get(value, 0)
                        distinct = last_min is None or value != last_min
                        if distinct and taxon != 0:
                            num_distinct += 1
                        last_min = value
                        all_hits.append((taxon, nwin))
                        window_taxa += [taxon] * nwin
                else:
                    all_hits.append((-1, (j - i) - k + 1))
                    ambig += (j - i) - k + 1
            i = j

    # merge adjacent equal (TaxonCounts.fromHits)
    merged = []
    for t, c in all_hits:
        if merged and merged[-1][0] == t and t != -2:
            merged[-1][1] += c
        else:
            merged.append([t, c])

    total = len(window_taxa) + ambig
    required = math.ceil(conf * total)
    counts = {}
    for t in window_taxa:
        counts[t] = counts.get(t, 0) + 1
    taxon = resolve_tree(parents, counts, required)
    classified = taxon != 0 and num_distinct >= min_hit_groups

    pieces = []
    lengths = []
    cur = 0
    for t, c in merged:
        if t == -2:
            lengths.append(cur + k - 1)
            cur = 0
            pieces.append("|:|")
        else:
            pieces.append(("A" if t == -1 else str(t)) + f":{c}")
            cur += c
    lengths.append(cur + k - 1)
    details = " ".join(pieces)
    length_string = "|".join(str(x) for x in lengths)
    return classified, (taxon if classified else 0), details, length_string


# ---------------------------------------------------------------------------
# Random taxonomies and genome libraries
# ---------------------------------------------------------------------------


def random_taxonomy(rng, size=40) -> Taxonomy:
    """Level-structured random taxonomy, mirroring the reference generator
    (slacken/Testing.scala:62-83): 8 rank levels with fixed ID ranges, each
    node's parent drawn from lower-numbered IDs."""
    level_size = size // 8 + 1
    nodes = [(1, 1, "root")]
    names = [(1, "root")]
    for depth in range(1, 9):
        lo = (depth - 1) * level_size + 2
        hi = depth * level_size + 2
        max_parent = (depth - 1) * level_size + 1
        title = RANK_TITLES[depth]
        for taxid in range(lo, hi):
            parent = int(rng.integers(1, max_parent + 1))
            nodes.append((taxid, parent, title))
            names.append((taxid, f"Taxon {taxid}"))
    return Taxonomy.from_nodes_and_names(nodes, names)


def random_genome(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


def make_genomes(rng, t, n_genomes=6, length=600):
    leaves = [x for x in t.taxa() if t.is_leaf(x)]
    chosen = rng.choice(leaves, n_genomes, replace=False)
    return [(int(tx), random_genome(rng, length)) for tx in chosen]
