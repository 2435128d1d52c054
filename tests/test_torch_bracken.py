"""Bracken weights of the port against slacken_tpu's on the CPU and against
the naive oracle of tests/test_bracken.py, same inputs from a numpy seed,
tolerance 0 (counts and bytes): the numpy path with and without N runs, the
device window classifier (torch ops) against the numpy path, fragments
split at a small FRAGMENT_MAX, a wide and a rank-table index (chunk files
and both CLIs: test_torch_bracken_cli.py)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import slacken_tpu.bracken as jbracken
from slacken_tpu.index import IndexParams as JParams
from slacken_tpu.index import KeyValueIndex as JIndex
from slacken_tpu_torch import bracken
from slacken_tpu_torch.index import IndexParams, KeyValueIndex
from test_bracken import FakeLibrary, oracle_bracken
from test_index import make_genomes, oracle_index, random_genome
from test_taxonomy import random_taxonomy

torch.set_num_threads(1)

R = 100
KINDS = {
    "narrow": dict(k=35, m=31, spaces=7),
    "wide": dict(k=50, m=45, spaces=7),
    "lexicographic": dict(k=35, m=13, spaces=3, ordering="lexicographic"),
}


class World:
    """One taxonomy and four 2,000 bp genomes on leaves, a fifth sequence of
    the first taxon made of the second genome's first 900 bp (reads that
    map to an LCA); the `ns` library has an N run in the third genome. The
    libraries also hold sequences the index never saw: one shorter than R,
    one all N and one random, so rows without windows or without hits go
    through the same batches."""

    def __init__(self):
        rng = np.random.default_rng(20261017)
        self.tax = random_taxonomy(rng)
        self.parents = {i: int(p) for i, p in enumerate(self.tax.parents)}
        genomes = make_genomes(rng, self.tax, n_genomes=5, length=2000)
        stray = genomes.pop()[0]
        genomes.append((genomes[0][0], genomes[1][1][:900]))
        g = genomes[2]
        self.indexed = {"plain": genomes,
                        "ns": genomes[:2] + [(g[0], g[1][:700] + "N" * 60 + g[1][760:])] + genomes[3:]}
        self.extra = [(genomes[3][0], random_genome(rng, 90)), (genomes[3][0], "N" * 1500),
                      (stray, random_genome(rng, 1500))]
        self._idx = {}

    def library(self, which):
        return FakeLibrary(self.indexed[which] + self.extra)

    def taxa(self, which):
        return {t for t, _ in self.indexed[which] + self.extra}

    def index(self, which, kind, package="port"):
        """The port's index of one library and kind, or slacken_tpu's."""
        key = (which, kind, package)
        if key not in self._idx:
            genomes = self.indexed[which]
            self._idx[key] = (JIndex.build(genomes, JParams(**KINDS[kind]), self.tax) if package == "jax" else
                              KeyValueIndex.build(genomes, IndexParams(**KINDS[kind]), self.tax, "cpu"))
        return self._idx[key]

    def oracle(self, which, kind):
        genomes, kms = self.indexed[which], [KINDS[kind][x] for x in ("k", "m", "spaces")]
        idx_map = oracle_index(genomes, *kms, self.parents)
        return oracle_bracken(genomes + self.extra, idx_map, self.parents, R, *kms)


@pytest.fixture(scope="module")
def world():
    return World()


def port_weights(world, which, kind, monkeypatch=None):
    """The port's weights of one World library on the CPU: by numpy, or with
    `monkeypatch` by the device window classifier (torch ops, as on the
    card). Also the rows and the taxa width of each window_classify call."""
    return weights_of(world.index(which, kind), world.library(which), world.taxa(which), monkeypatch)


def weights_of(index, library, taxa, monkeypatch=None):
    calls = []
    if monkeypatch is not None:
        real = bracken.window_classify

        def spy(scan, table, read_len, k, n_taxa):
            calls.append((scan.looked.shape[0], n_taxa))
            return real(scan, table, read_len, k, n_taxa)

        def torch_counts(self, scan, lengths):
            return bracken.window_dest_counts(scan, self._rpath_table(), R, self.index.params.k,
                                              [n - R + 1 for n in lengths])

        monkeypatch.setattr(bracken, "window_classify", spy)
        monkeypatch.setattr(bracken.BrackenWeights, "_dest_counts", torch_counts)
    return bracken.BrackenWeights(index, R, device="cpu").build_weights(library, taxa), calls


@pytest.mark.parametrize("which", ["plain", "ns"])
def test_numpy_path_matches_jax(world, which):
    want = jbracken.BrackenWeights(world.index(which, "narrow", "jax"), R).build_weights(
        world.library(which), world.taxa(which))
    got, _ = port_weights(world, which, "narrow")
    assert got == want and len(want) > 5


@pytest.mark.parametrize("which", ["plain", "ns"])
@pytest.mark.parametrize("path", ["numpy", "torch"])
def test_matches_the_oracle(world, monkeypatch, which, path):
    got, _ = port_weights(world, which, "narrow", monkeypatch if path == "torch" else None)
    assert got == world.oracle(which, "narrow")


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("which", ["plain", "ns"])
@pytest.mark.parametrize("block", [bracken.WINDOW_BLOCK, 4096])
def test_device_path_matches_numpy(world, monkeypatch, kind, which, block):
    """The device classifier serves every row, each batch (rows of 1,024 and
    of 2,048 bases) in one group as no row hits more than FEW_TAXA taxa, in
    one block of windows or in many."""
    monkeypatch.setattr(bracken, "WINDOW_BLOCK", block)
    want, _ = port_weights(world, which, kind)
    got, calls = port_weights(world, which, kind, monkeypatch)
    assert got == want and len(calls) == 2 and max(n for _, n in calls) > 1
    assert sum(rows for rows, _ in calls) == len(world.indexed[which]) + len(world.extra)


def test_rows_with_many_taxa_are_classified_apart(world, monkeypatch):
    """FEW_TAXA of 1: the rows that hit two taxa or more go through the
    classifier in a group of their own, padded to their own width."""
    want, _ = port_weights(world, "plain", "narrow")
    monkeypatch.setattr(bracken, "FEW_TAXA", 1)
    got, calls = port_weights(world, "plain", "narrow", monkeypatch)
    assert got == want and min(n for _, n in calls) <= 1 < max(n for _, n in calls)
    assert sum(rows for rows, _ in calls) == len(world.indexed["plain"]) + len(world.extra)


def test_hit_taxa_per_row(world):
    """The distinct taxa of valid, hitting windows a row, as numpy counts them."""
    rng = np.random.default_rng(3)
    looked = torch.from_numpy(rng.integers(-1, 9, (6, 40)).astype(np.int32))
    valid = torch.from_numpy(rng.random((6, 40)) < 0.7)
    valid[0] = False
    scan = bracken.FragmentScan(looked, valid, valid, valid)
    want = [len(np.unique(r[v & (r > 0)])) for r, v in zip(looked.numpy(), valid.numpy())]
    assert bracken.hit_taxa_per_row(scan).tolist() == want and want[0] == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_window_counts_match_numpy_on_random_rows(world, monkeypatch, seed):
    """window_dest_counts (torch ops) against _fragment_dest_counts (numpy)
    row by row on random fragment-pass outputs: runs of taxa drawn from 2 to
    90 nodes of the taxonomy (internal ones too, so that ties and their LCAs
    abound), misses, invalid windows, random span starts and distinct flags;
    rows of every width, the widest above FEW_TAXA."""
    monkeypatch.setattr(bracken, "WINDOW_BLOCK", 1 << 14)
    rng = np.random.default_rng(seed)
    tax = random_taxonomy(rng, size=200)
    bw = bracken.BrackenWeights(SimpleNamespace(taxonomy=tax, params=IndexParams()), R, device="cpu")
    nodes = np.arange(1, tax.size)
    b, l = 6, 1024
    looked = np.zeros((b, l), np.int32)
    for row in range(b):
        pool = rng.choice(nodes, size=90 if row == 0 else int(rng.integers(2, 60)), replace=False)
        runs = rng.integers(1, 3 if row == 0 else 12, l)
        looked[row] = np.repeat(rng.choice(np.append(pool, 0), size=l), runs)[:l]
    valid = rng.random((b, l)) < 0.97
    span_start = rng.random((b, l)) < 0.3
    distinct = rng.random((b, l)) < 0.8
    lengths = [l, l - 1, 700, 400, R, R - 1]
    scan = bracken.FragmentScan(*(torch.from_numpy(x) for x in (looked, valid, span_start, distinct)))
    got = bracken.window_dest_counts(scan, bw._rpath_table(), R, IndexParams().k, [n - R + 1 for n in lengths])
    assert got == bw._dest_counts(scan, lengths) and len(got[0]) > 3
    assert int(bracken.hit_taxa_per_row(scan).max()) > bracken.FEW_TAXA


@pytest.mark.parametrize("path", ["numpy", "torch"])
def test_split_fragments_match_jax(world, monkeypatch, path):
    """FRAGMENT_MAX of 4,096 in both packages: the 9,000 bp genomes split into
    three fragments overlapping by R - 1, and each source's reads add up to
    len - R + 1, every read window counted once."""
    monkeypatch.setattr(bracken, "FRAGMENT_MAX", 4096)
    monkeypatch.setattr(jbracken, "FRAGMENT_MAX", 4096)
    rng = np.random.default_rng(7)
    genomes = make_genomes(rng, world.tax, n_genomes=3, length=9000)
    genomes.append((genomes[0][0], genomes[1][1][:5000]))
    lib, taxa = FakeLibrary(genomes), {t for t, _ in genomes}
    jidx = JIndex.build(genomes, JParams(), world.tax)
    tidx = KeyValueIndex.build(genomes, IndexParams(), world.tax, "cpu")
    assert len(list(bracken.BrackenWeights(tidx, R, device="cpu")._iter_fragments(lib, taxa))) == 3 * 3 + 2
    got, _ = weights_of(tidx, lib, taxa, monkeypatch if path == "torch" else None)
    assert got == jbracken.BrackenWeights(jidx, R).build_weights(lib, taxa)
    per_source = {}
    for (_, source), c in got.items():
        per_source[source] = per_source.get(source, 0) + c
    want = {}
    for taxon, seq in genomes:
        want[taxon] = want.get(taxon, 0) + len(seq) - R + 1
    assert per_source == want


def test_wide_index_against_the_oracle(world, monkeypatch):
    """m = 45: the port through the wide scan and probe equals the oracle (with
    the toggle mask widened as the reference widens it); slacken_tpu's
    build_weights hands wide keys to the narrow probe and fails."""
    want = world.oracle("ns", "wide")
    assert port_weights(world, "ns", "wide")[0] == want
    assert port_weights(world, "ns", "wide", monkeypatch)[0] == want
    tiny = [world.indexed["ns"][0]]
    with pytest.raises(TypeError):
        jbracken.BrackenWeights(JIndex.build(tiny, JParams(**KINDS["wide"]), world.tax), R).build_weights(
            FakeLibrary(tiny), {tiny[0][0]})


def test_rank_table_index_matches_jax(world, monkeypatch):
    want = jbracken.BrackenWeights(world.index("ns", "lexicographic", "jax"), R).build_weights(
        world.library("ns"), world.taxa("ns"))
    assert port_weights(world, "ns", "lexicographic")[0] == want
    assert port_weights(world, "ns", "lexicographic", monkeypatch)[0] == want


def test_bracken_defaults_to_cuda(world, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bracken.BrackenWeights(world.index("plain", "narrow"), R)
