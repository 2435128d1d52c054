"""The port's copy of the oracle (slacken_tpu_torch/oracle.py) against its
originals, exactly, on seeded inputs: tests/oracle.py's functions,
oracle_index and make_genomes and random_genome (tests/test_index.py),
oracle_classify (tests/test_classify.py) and random_taxonomy
(tests/test_taxonomy.py, compared by its saved files)."""

import numpy as np
import pytest

import oracle as joracle
from slacken_tpu_torch import fuzz, oracle
from test_classify import oracle_classify as j_oracle_classify
from test_index import make_genomes as j_make_genomes
from test_index import oracle_index as j_oracle_index
from test_index import random_genome as j_random_genome
from test_taxonomy import random_taxonomy as j_random_taxonomy


def noisy(rng, n, n_share=0.1):
    """A sequence of n letters, some N and some lower case."""
    seq = np.array(list(j_random_genome(rng, n)))
    seq[rng.random(n) < n_share] = "N"
    low = rng.random(n) < 0.1
    seq[low] = np.char.lower(seq[low])
    return "".join(seq)


@pytest.mark.parametrize("k,m", fuzz.KM_CHOICES)
@pytest.mark.parametrize("s", [0, 3])
def test_scan_oracles_match(k, m, s):
    rng = np.random.default_rng(1000 * k + m + s)
    for n in (k - 1, k, 3 * k):
        codes = oracle.encode(noisy(rng, n))
        assert codes == joracle.encode("".join("ACGTN"[c] for c in codes))
        assert oracle.window_minimizers(codes, k, m, s) == joracle.window_minimizers(codes, k, m, s)
        assert oracle.spans(codes, k, m, s) == joracle.spans(codes, k, m, s)
        assert oracle.spans(codes, k, m, s, canonical=False) == joracle.spans(codes, k, m, s, canonical=False)
    for _ in range(20):
        v = int(rng.integers(0, 1 << 62)) << 60 | int(rng.integers(0, 1 << 60))
        v &= (1 << (2 * m)) - 1
        assert oracle.priority(v, m, s) == joracle.priority(v, m, s)
        assert oracle.canonical_value(v, m) == joracle.canonical_value(v, m)
    assert oracle.wide_toggle(m, joracle.DEFAULT_TOGGLE_MASK) == joracle.wide_toggle(m, joracle.DEFAULT_TOGGLE_MASK)
    assert oracle.space_mask(m, s) == joracle.space_mask(m, s)


def test_tree_oracles_match():
    rng = np.random.default_rng(7)
    for size in (12, 40, 59):
        t = oracle.random_taxonomy(rng, size)
        parents = {i: int(p) for i, p in enumerate(t.parents)}
        taxa = [0] + list(t.taxa())
        for _ in range(200):
            a, b = (int(x) for x in rng.choice(taxa, 2))
            assert oracle.lca(parents, a, b) == joracle.lca(parents, a, b)
            assert oracle.has_ancestor(parents, a, b) == joracle.has_ancestor(parents, a, b)
        for _ in range(100):
            hits = {int(x): int(rng.integers(1, 9)) for x in rng.choice(taxa, int(rng.integers(1, 6)))}
            req = float(rng.integers(0, sum(hits.values()) + 2))
            assert oracle.resolve_tree(parents, hits, req) == joracle.resolve_tree(parents, hits, req)
            wt = [int(x) for x in rng.choice(taxa, int(rng.integers(0, 30)))]
            args = (parents, wt, int(rng.integers(0, 5)), float(rng.choice([0.0, 0.3, 0.9])),
                    int(rng.integers(1, 4)), int(rng.integers(0, 4)))
            assert oracle.classify_read(*args) == joracle.classify_read(*args)
    assert (oracle.NONE, oracle.ROOT, oracle.CODE) == (joracle.NONE, joracle.ROOT, joracle.CODE)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_library_generators_match(seed, tmp_path):
    t = oracle.random_taxonomy(np.random.default_rng(seed), 20 + 15 * seed)
    jt = j_random_taxonomy(np.random.default_rng(seed), 20 + 15 * seed)
    t.save(str(tmp_path / "port"))
    jt.save(str(tmp_path / "jax"))
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir()) and names
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
    a, b = np.random.default_rng(seed + 10), np.random.default_rng(seed + 10)
    assert oracle.random_genome(a, 333) == j_random_genome(b, 333)
    assert oracle.make_genomes(a, t, n_genomes=5, length=400) == j_make_genomes(b, jt, n_genomes=5, length=400)
    assert a.random() == b.random()  # both drew the same amount


@pytest.mark.parametrize("k,m,s", [(21, 15, 0), (35, 31, 7), (45, 32, 3), (51, 45, 7)])
def test_index_and_classify_oracles_match(k, m, s):
    """oracle_index on a library with a genome repeated under another taxon
    (LCA merges), then oracle_classify of noisy, paired, short and exactly-k
    reads at three thresholds and gates."""
    rng = np.random.default_rng(k * m + s)
    t = oracle.random_taxonomy(rng, 40)
    parents = {i: int(p) for i, p in enumerate(t.parents)}
    genomes = oracle.make_genomes(rng, t, n_genomes=5, length=500)
    genomes.append((genomes[0][0], genomes[1][1]))
    idx_map = oracle.oracle_index(genomes, k, m, s, parents)
    assert idx_map == j_oracle_index(genomes, k, m, s, parents) and idx_map
    reads = []
    for i in range(12):
        g = genomes[i % len(genomes)][1]
        a = int(rng.integers(0, 300))
        seq = g[a : a + int(rng.integers(k - 1, 200))]
        if i % 3 == 0:
            seq = "".join(c if rng.random() > 0.05 else "N" for c in seq)
        reads.append((seq, g[100:190] if i % 4 == 0 else None))
    reads += [("ACGTACG", None), ("N" * 50, None), (genomes[0][1][:k], None), (genomes[0][1][: k - 1], "N" * 60)]
    for seq, seq2 in reads:
        for conf, gate in ((0.0, 1), (0.15, 2), (0.6, 3)):
            want = j_oracle_classify(seq, seq2, idx_map, parents, k, m, s, conf, gate)
            assert oracle.oracle_classify(seq, seq2, idx_map, parents, k, m, s, conf, gate) == want
