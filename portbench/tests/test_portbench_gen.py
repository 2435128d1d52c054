"""The generators: the ranked taxonomy's shape, the library's sizes and
relatedness, and the read simulator, each the seed's alone."""

import json
import os
from statistics import NormalDist

import numpy as np
import pytest

from portbench.gen import libraries, reads
from portbench.pbcore import manifest
from slacken_tpu_torch.taxonomy import Taxonomy

CONFIGS = {n: json.load(open(os.path.join(manifest.BENCH_DIR, "configs", f"{n}.json"))) for n in ("marine", "strain")}


def small(name, n_species=40):
    cfg = json.loads(json.dumps(CONFIGS[name]))
    cfg["library"].update(size_median_bp=30_000, size_min_bp=10_000, size_max_bp=100_000)
    cfg["taxonomy"]["n_species"] = n_species
    return cfg


@pytest.mark.parametrize("name", ["marine", "strain"])
def test_the_ranked_taxonomy(name):
    tax = CONFIGS[name]["taxonomy"]
    nodes, names = libraries.ranked_taxonomy(tax)
    parent = {t: p for t, p, _ in nodes}
    rank = {t: r for t, _, r in nodes}
    species = [t for t, _, r in nodes if r == "species"]
    assert len(species) == tax["n_species"] and species == sorted(species) and species[-1] == max(parent)
    for t in species:  # every species has the seven ranks above it, in order
        path = []
        while t != 1:
            path.append(rank[t])
            t = parent[t]
        assert path == list(libraries.RANKS[::-1])
    count = {r: sum(rr == r for _, _, rr in nodes) for r in libraries.RANKS}
    for above, r in zip(libraries.RANKS, libraries.RANKS[1:]):
        kids = {}
        for t, p, rr in nodes:
            if rr == r:
                kids.setdefault(p, []).append(t)
        assert max(len(v) for v in kids.values()) <= tax["per_parent"][r]
        assert count[above] == -(-count[r] // tax["per_parent"][r])
    port = Taxonomy.from_nodes_and_names(nodes, names)
    assert sorted(port.taxa()) == sorted(parent)


def test_genome_sizes_are_fixed_and_bacterial():
    lib = CONFIGS["marine"]["library"]
    a, b = libraries.genome_sizes(lib, 120), libraries.genome_sizes(lib, 120)
    assert np.array_equal(a, b)
    assert a.min() >= 1_000_000 and a.max() <= 10_000_000 and 2.9e6 < np.median(a) < 3.1e6
    assert not np.array_equal(a, np.sort(a))  # not in size order


@pytest.mark.parametrize("name", ["marine", "strain"])
@pytest.mark.parametrize("seed", [0, 2**31 + 11])
def test_libraries_are_the_seeds(name, seed):
    cfg = small(name)
    nodes = libraries.ranked_taxonomy(cfg["taxonomy"])[0]
    one = list(libraries.tree_library(cfg["library"], nodes, seed))
    assert one == list(libraries.tree_library(cfg["library"], nodes, seed))
    assert one != list(libraries.tree_library(cfg["library"], nodes, seed + 1))
    sizes = libraries.genome_sizes(cfg["library"], cfg["taxonomy"]["n_species"])
    assert [len(s) for _, s in one] == sizes.tolist()
    assert [t for t, _ in one] == [t for t, _, r in nodes if r == "species"]


def _identity(a, b):
    n = min(len(a), len(b))
    return float((libraries.encode(a[:n]) == libraries.encode(b[:n])).mean())


def test_relatedness_follows_the_divergence():
    for name, same_genus, other_order in (("marine", (0.2, 0.3), (0.2, 0.3)), ("strain", (0.97, 0.99), (0.2, 0.3))):
        cfg = small(name, 64)
        nodes = libraries.ranked_taxonomy(cfg["taxonomy"])[0]
        g = list(libraries.tree_library(cfg["library"], nodes, 5))
        per = cfg["taxonomy"]["per_parent"]
        lo, hi = same_genus
        assert lo < _identity(g[0][1], g[1][1]) < hi, name  # the first two species share a genus
        far = per["species"] * per["genus"] * per["family"]  # the first species of the next order
        lo, hi = other_order
        assert lo < _identity(g[0][1], g[far][1]) < hi, name


def test_encode():
    assert libraries.encode("ACGTNacgtu").tolist() == [0, 1, 2, 3, 4, 0, 1, 2, 3, 3]


def _pairs(seed, n_rate=0.0, n_run_share=0.0):
    g = np.random.default_rng(seed)
    genomes = [g.integers(0, 4, 5000).astype(np.uint8) for _ in range(3)]
    outside = [g.integers(0, 4, 3000).astype(np.uint8)]
    return genomes, reads.simulate(g, genomes, outside, reads.profile(3, 1.0, 2.0, 0), 500, 150, 270, 27, 0.0, 0.1,
                                   n_rate, n_run_share, (35, 75))


def test_simulator_is_seeded_and_shaped():
    genomes, a = _pairs(3)
    _, b = _pairs(3)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert a.mate1.shape == a.mate2.shape == (500, 150)
    assert (a.source == -1).sum() == 50
    assert (a.mate1 < 4).all() and (a.mate2 < 4).all()
    rc = lambda c: (3 - c)[::-1]  # noqa: E731
    for r in np.flatnonzero(a.source >= 0)[:50]:
        g = genomes[a.source[r]].tobytes()
        m1, m2 = a.mate1[r], a.mate2[r]
        # without substitutions one mate lies on the forward strand and the other's reverse complement does
        assert (m1.tobytes() in g and rc(m2).tobytes() in g) or (m2.tobytes() in g and rc(m1).tobytes() in g)


def test_simulator_work_is_the_same_for_every_seed():
    """Another seed changes the reads, not the work: as many pairs from
    each genome and outside, and as many mates with a stretch of N."""
    _, a = _pairs(5, n_run_share=0.1)
    _, b = _pairs(6, n_run_share=0.1)
    assert not np.array_equal(a.mate1, b.mate1)
    assert np.array_equal(np.bincount(a.source + 1), np.bincount(b.source + 1))
    stretch = lambda m: int((np.convolve(m.ravel() == 4, np.ones(35, int), "valid") == 35).sum())  # noqa: E731
    assert stretch(a.mate1) > 0
    assert [(x == 4).any(axis=1).sum() for x in (a.mate1, a.mate2)] == [(x == 4).any(axis=1).sum()
                                                                        for x in (b.mate1, b.mate2)]


@pytest.mark.parametrize("sample", [0, 1, 2, 3])
def test_profile_is_fixed_log_normal_quantiles(sample):
    p = reads.profile(120, 1.0, 2.0, sample)
    assert np.array_equal(p, reads.profile(120, 1.0, 2.0, sample)) and abs(p.sum() - 1) < 1e-12
    q = np.sort(p)
    assert np.allclose(q[1:] / q[:-1], np.exp(2.0 * np.diff([NormalDist().inv_cdf((i + 0.5) / 120) for i in range(120)])))
    assert not np.array_equal(p, reads.profile(120, 1.0, 2.0, sample + 1))


@pytest.mark.parametrize("weights,n", [([1, 1, 1], 10), ([0.5, 0.3, 0.2], 7), ([5.0, 0.0, 1e-9], 3), ([], 0)])
def test_apportion_sums_to_n(weights, n):
    c = reads.apportion(np.array(weights, np.float64), n)
    assert c.sum() == n and (c >= 0).all()
    if n:
        assert np.all(np.abs(c - n * np.array(weights) / np.sum(weights)) < 1)


def test_simulator_calls_n_alone_and_in_stretches():
    _, p = _pairs(4, n_rate=0.01, n_run_share=0.1)
    both = np.concatenate([p.mate1, p.mate2])
    assert 0.03 < (both == 4).mean() < 0.07  # 1% alone and a tenth of the mates with 35-75 N: about 4.7%
    runs = [r for r in both if (np.convolve(r == 4, np.ones(35, int), "valid") == 35).any()]
    assert 60 < len(runs) < 140  # about a tenth of the 1,000 mates


def test_fastq_bytes_parse_back():
    from slacken_tpu_torch import native

    _, p = _pairs(4, n_rate=0.01, n_run_share=0.1)
    buf = reads.fastq_bytes("s0r", p.mate1)
    packed, consumed = native.pack_fastq_chunk(buf)
    assert consumed == len(buf) and packed.titles == reads.titles("s0r", 500)
    assert np.array_equal(packed.codes[:, :150], p.mate1)
