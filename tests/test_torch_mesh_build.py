"""The port's distributed build on the CPU (parallel/classifier.py's
build_distributed, parallel/mesh.py's shuffle): over 8 and 3 CPU shards equal
to the port's KeyValueIndex.build and to slacken_tpu's
build_distributed(n_devices=8), keys, taxa and the full-records sidecar, for
a narrow, a wide and a frequency-ordered index; the range boundaries against
slacken_tpu's sample_shuffle_boundaries; owners of keys placed exactly on,
below and above boundaries against a Python-integer reference; an empty
library and one whose first batch has no span."""

import numpy as np
import pytest
import torch

from slacken_tpu.index import IndexParams as JParams
from slacken_tpu.ops.minimizers import MinimizerParams as JMinimizerParams
from slacken_tpu.parallel import mesh as jmesh
from slacken_tpu.parallel.classifier import build_distributed as jbuild_distributed
from slacken_tpu_torch.index import IndexParams, KeyValueIndex, by_owner, owners, sample_boundaries
from slacken_tpu_torch.ops import encode, ordering
from slacken_tpu_torch.ops.minimizers import window_minimizers
from slacken_tpu_torch.parallel.classifier import build_distributed
from test_torch_index import shared_library
from test_taxonomy import random_taxonomy

torch.set_num_threads(1)

KINDS = {
    "narrow": dict(k=35, m=31, spaces=7),
    "wide": dict(k=50, m=45, spaces=7),
    "frequency": dict(k=25, m=11, spaces=0, ordering="frequency"),
}
BATCH = dict(batch_rows=8, row_len=1024)  # several batches a library
U64 = (1 << 64) - 1


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(20261018)
    tax = random_taxonomy(rng)
    genomes = shared_library(rng, tax, n=6, length=4000)
    tables = {}
    for kind, kw in KINDS.items():
        if kw.get("ordering") == "frequency":
            mp = IndexParams(**kw).minimizer_params
            counts = ordering.sample_mmer_counts((encode.encode_seq(s) for _, s in genomes), mp, "cpu")
            tables[kind] = ordering.frequency_lut(counts, mp.m)
    return tax, genomes, tables


def single_device(world, kind):
    tax, genomes, tables = world
    return KeyValueIndex.build(iter(genomes), IndexParams(**KINDS[kind]), tax, "cpu",
                               ordering_lut=tables.get(kind), keep_records=True, **BATCH)


@pytest.mark.parametrize("shards", [8, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_build_distributed_equals_build(world, kind, shards):
    tax, genomes, tables = world
    want = single_device(world, kind)
    got = build_distributed(iter(genomes), IndexParams(**KINDS[kind]), tax, ["cpu"] * shards,
                            ordering_lut=tables.get(kind), keep_records=True, **BATCH)
    assert want.num_records > 1000
    for a, b in ((got.keys_t, want.keys_t), (got.taxa_t, want.taxa_t),
                 (got.record_keys_t, want.record_keys_t), (got.record_taxa_t, want.record_taxa_t)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert got.record_taxa_t.shape[0] > want.num_records  # shared minimizers: several taxa a key
    assert got.params == want.params
    assert (got.ordering_lut is None) == (kind != "frequency")
    plain = build_distributed(iter(genomes), IndexParams(**KINDS[kind]), tax, ["cpu"] * shards,
                              ordering_lut=tables.get(kind), **BATCH)
    assert torch.equal(plain.keys_t, want.keys_t) and plain.record_keys_t is None


@pytest.mark.parametrize("kind", KINDS)
def test_build_distributed_equals_the_jax_package(world, kind):
    """slacken_tpu's build_distributed over 8 virtual CPU devices."""
    tax, genomes, tables = world
    want = jbuild_distributed(iter(genomes), JParams(**KINDS[kind]), tax, n_devices=8,
                              ordering_lut=tables.get(kind), keep_records=True, **BATCH)
    got = build_distributed(iter(genomes), IndexParams(**KINDS[kind]), tax, ["cpu"] * 8,
                            ordering_lut=tables.get(kind), keep_records=True, **BATCH)
    assert np.array_equal(got.keys, np.asarray(want.keys, np.uint64))
    assert np.array_equal(got.taxa, np.asarray(want.taxa))
    assert np.array_equal(got.record_keys, np.asarray(want.record_keys, np.uint64))
    assert np.array_equal(got.record_taxa, np.asarray(want.record_taxa))


@pytest.mark.parametrize("n", [2, 3, 8])
@pytest.mark.parametrize("kind", ["narrow", "wide"])
def test_boundaries_equal_the_jax_package(world, kind, n):
    """sample_boundaries of a batch's span keys against slacken_tpu's
    sample_shuffle_boundaries(_wide) of the same rows."""
    _, genomes, _ = world
    kw = KINDS[kind]
    rows = [encode.encode_seq(s)[:1024] for _, s in genomes[:6]]
    codes, _ = encode.pack_batch(rows, 1024)
    wm = window_minimizers(torch.from_numpy(codes), IndexParams(**kw).minimizer_params)
    got = sample_boundaries(wm.minimizer[wm.span_start], n, kw["m"])
    jmp = JMinimizerParams(k=kw["k"], m=kw["m"], spaces=kw["spaces"])
    if kind == "wide":
        want = jmesh.sample_shuffle_boundaries_wide(codes, jmp, n)
        assert [(h & U64, lo & U64) for h, lo in got] == [(int(h), int(lo)) for h, lo in want]
    else:
        want = jmesh.sample_shuffle_boundaries(codes, jmp, n)
        assert got == [int(x) for x in want]


def _value(key):
    """The unsigned value of an int64 key, or of an (hi64, lo64) pair."""
    if isinstance(key, tuple):
        return ((key[0] & U64) << 64) | (key[1] & U64)
    return key


@pytest.mark.parametrize("kind", ["narrow", "wide"])
def test_owners_on_boundaries(kind):
    """The owner is the number of boundaries at or below the key: keys equal
    to a boundary go to the range above it, keys one below to the range
    below; wide boundaries with lo64's top bit set compare unsigned."""
    rng = np.random.default_rng(3)
    if kind == "narrow":
        bounds = sorted(int(x) for x in rng.integers(1, 1 << 62, 7))
        keys = [b + d for b in bounds for d in (-1, 0, 1)] + [0, (1 << 62) - 1]
        t = torch.tensor(keys, dtype=torch.int64)
    else:
        bounds = sorted({(int(h), int(lo)) for h, lo in zip(rng.integers(0, 1 << 26, 7), rng.integers(-(1 << 63), (1 << 63) - 1, 7, dtype=np.int64))},
                        key=_value)
        bounds.append((bounds[-1][0], -1))  # lo64 all ones
        bounds.insert(0, (bounds[0][0], (1 << 63) - 1))  # below a boundary whose lo64 has its top bit set
        bounds = sorted(set(bounds), key=_value)

        def step(b, d):
            v = _value(b) + d
            lo = v & U64
            return (v >> 64, lo - (1 << 64) if lo >> 63 else lo)

        keys = [step(b, d) for b in bounds for d in (-1, 0, 1)] + [(0, 0)]
        t = torch.tensor(keys, dtype=torch.int64)
    want = [sum(_value(b) <= _value(k) for b in bounds) for k in keys]
    assert owners(t, bounds).tolist() == want
    taxa = torch.arange(len(keys), dtype=torch.int32)
    parts = by_owner(t, taxa, bounds, len(bounds) + 1)
    assert [p[1].tolist() for p in parts] == [[i for i, o in enumerate(want) if o == j]
                                              for j in range(len(bounds) + 1)]


@pytest.mark.parametrize("kind", ["narrow", "wide"])
def test_empty_library_and_spanless_first_batch(world, kind):
    """No sequence at all: an empty index of the right shape, as the
    single-device build. A first batch without a span (sequences shorter
    than k): uniform boundaries, and the same index as the build."""
    tax, genomes, _ = world
    params = IndexParams(**KINDS[kind])
    empty = build_distributed(iter([]), params, tax, ["cpu"] * 8, keep_records=True, **BATCH)
    want = KeyValueIndex.build(iter([]), params, tax, "cpu", keep_records=True, **BATCH)
    assert empty.num_records == 0 and empty.keys_t.shape == want.keys_t.shape
    assert empty.record_keys_t.shape == want.record_keys_t.shape
    short = [(t, s[:30]) for t, s in genomes[:5]] * 2 + genomes[:3]
    got = build_distributed(iter(short), params, tax, ["cpu"] * 8, **BATCH)
    want = KeyValueIndex.build(iter(short), params, tax, "cpu", **BATCH)
    assert got.num_records > 0 and torch.equal(got.keys_t, want.keys_t) and torch.equal(got.taxa_t, want.taxa_t)
    bounds = sample_boundaries(torch.zeros((0, 2) if kind == "wide" else 0, dtype=torch.int64), 4,
                                     params.m)
    assert [_value(b) for b in bounds] == [(i << (2 * params.m)) // 4 if kind == "wide" else i * ((1 << 62) // 4)
                                           for i in range(1, 4)]
