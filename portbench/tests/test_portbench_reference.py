"""The plain reference against the port's naive string oracle
(slacken_tpu_torch.oracle, written from Kraken 2's and Slacken's
definitions) and, for Bracken, against the numpy window classifier that the
port runs on the CPU: on random taxonomies, genomes and reads. The
reference itself imports neither."""

import numpy as np
import pytest
import torch

from portbench.reference import bracken as rb
from portbench.reference import classify as rc
from portbench.reference.index import ReferenceIndex
from portbench.reference.minimizers import MinimizerSpec, window_minimizers
from portbench.reference.tree import Tree
from slacken_tpu_torch import oracle

SPECS = [MinimizerSpec(35, 31, 7), MinimizerSpec(15, 10, 2), MinimizerSpec(9, 5, 0)]


def tree_of(t):
    nodes = [(x, int(t.parents[x]) if x != 1 else 1, t.rank_titles[x] or "no rank") for x in t.taxa()]
    return Tree(nodes, [(x, t.get_name(x) or "") for x in t.taxa()])


@pytest.mark.parametrize("spec", SPECS)
def test_window_minimizers_match_the_oracle(spec):
    g = np.random.default_rng(spec.k)
    codes = g.integers(0, 4, 300).astype(np.uint8)
    codes[g.random(300) < 0.02] = 4
    ours = window_minimizers(torch.from_numpy(codes), spec).tolist()
    theirs = oracle.window_minimizers(codes.tolist(), spec.k, spec.m, spec.spaces)[: len(ours)]
    assert ours == [-1 if x is None else x for x in theirs]


@pytest.mark.parametrize("seed", range(4))
def test_index_and_classification_match_the_oracle(seed):
    g = np.random.default_rng(seed)
    spec = SPECS[seed % 3]
    t = oracle.random_taxonomy(g, 40)
    tree = tree_of(t)
    genomes = oracle.make_genomes(g, t, 5, 600)
    # related genomes too: the second a mutated copy of the first
    s = list(genomes[0][1])
    for i in np.flatnonzero(g.random(len(s)) < 0.03):
        s[i] = "ACGT"[(("ACGT".index(s[i])) + 1) % 4]
    genomes[1] = (genomes[1][0], "".join(s))
    idx = ReferenceIndex.build(genomes, spec, tree, "cpu")
    want = oracle.oracle_index(genomes, spec.k, spec.m, spec.spaces, t.parents)
    assert dict(zip(idx.keys.tolist(), idx.taxa.tolist())) == want
    # pairs of 60 bp mates from the genomes, some mutated
    n, R = 40, 60
    m1 = np.empty((n, R), np.uint8)
    m2 = np.empty((n, R), np.uint8)
    enc = {c: i for i, c in enumerate("ACGT")}
    for r in range(n):
        seq = genomes[r % len(genomes)][1]
        a = int(g.integers(0, len(seq) - 2 * R))
        m1[r] = [enc[c] for c in seq[a : a + R]]
        m2[r] = [enc[c] for c in seq[a + R : a + 2 * R]]
        m2[r, g.random(R) < 0.05] = g.integers(0, 4)
    # ambiguous bases: alone, in stretches shorter and longer than k, a mate all N, two stretches apart
    for m in (m1, m2):
        m[g.random(m.shape) < 0.01] = 4
    for r in range(0, n, 4):
        a = int(g.integers(0, R - 20))
        m1[r, a : a + int(g.integers(1, R - a))] = 4
    m2[1] = 4
    m1[2, 5 : 5 + spec.k] = 4
    m1[2, 7 + spec.k : 9 + 2 * spec.k] = 4
    thresholds = [0.0, 0.3, 0.7]
    c = rc.classify_pairs(m1, m2, idx, spec, tree, thresholds, 2, "cpu")
    wt = c.window_taxa.numpy()
    for r in range(n):
        s1, s2 = ("".join("ACGTN"[x] for x in m) for m in (m1[r], m2[r]))
        for i, thr in enumerate(thresholds):
            cl, taxon, details, lengths = oracle.oracle_classify(s1, s2, want, t.parents, spec.k, spec.m,
                                                                 spec.spaces, thr, 2)
            assert c.taxa[i, r] == taxon
            line = f"{'C' if cl else 'U'}\tr{r}\t{taxon}\t{lengths}\t{details}"
            assert rc.read_line(f"r{r}", int(c.taxa[i, r]), wt[r], spec.k) == line
    assert (wt == rc.AMBIGUOUS).any() and (wt == rc.SKIPPED).any()


def test_kreport_matches_the_port():
    from slacken_tpu_torch.report import KrakenReport

    g = np.random.default_rng(7)
    t = oracle.random_taxonomy(g, 40)
    taxa = g.choice([0] + [x for x in t.taxa()], 300)
    vals, cts = np.unique(taxa, return_counts=True)
    want = KrakenReport(t, list(zip(vals.tolist(), cts.tolist()))).lines()
    assert rc.kreport_lines(tree_of(t), taxa) == want


@pytest.mark.parametrize("seed", range(3))
def test_bracken_matches_the_ports_numpy_classifier(seed):
    from slacken_tpu_torch.bracken import BrackenWeights
    from slacken_tpu_torch.index import IndexParams, KeyValueIndex

    g = np.random.default_rng(seed)
    t = oracle.random_taxonomy(g, 40)
    genomes = oracle.make_genomes(g, t, 4, 3000)
    s = genomes[0][1]
    genomes[2] = (genomes[2][0], s[:1500] + genomes[2][1][1500:])  # shared stretches spread hits over ancestors
    spec = MinimizerSpec(35, 31, 7)
    tree = tree_of(t)
    idx = ReferenceIndex.build(genomes, spec, tree, "cpu")
    R = 100
    want = rb.weights(genomes, {x for x, _ in genomes}, idx, spec, tree, R, "cpu")
    port = KeyValueIndex.build(iter(genomes), IndexParams(), t, "cpu")

    class Lib:
        def sequences(self):
            for i, (x, q) in enumerate(genomes):
                yield x, f"g{i}", q

    got = BrackenWeights(port, R, "cpu").build_weights(Lib(), {x for x, _ in genomes})
    assert got == want
