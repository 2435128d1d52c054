"""The probe choice's tables on the CPU (lookup.build_tiled,
lookup.build_hashed_rows) and the twins of their kernels
(lookup.lookup_taxa_tiled, lookup.lookup_taxa_hashed_rows), held at
tolerance 0 to the JAX package: the tables, as uint32 lanes with the same
tile, router bits and row_bits, to build_tiled / build_tiled_wide (with
build_router / build_router_wide) and to build_hashed_rows(_wide) and its
device builder run on the CPU; the twins to the JAX lookups and to
lookup_taxa, with hits, misses, an invalid window's -1 and keys whose
scramble has its top bit set. Indexes: narrow (35, 31, 7), wide (50, 45, 7)
and rank-table (35, 13, 3) builds of four random 5 kbp genomes, a skewed key set
whose largest router bucket holds 40 keys (the tile grows to 64), an empty
index, wide keys whose row hashes tie, a forced row_bits that grows the
tile, and the ValueError of a build that does not converge."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slacken_tpu.ops import lookup as jlookup
from slacken_tpu.ops import u128
from slacken_tpu.ops.u64 import U64
from slacken_tpu_torch.index import IndexParams, KeyValueIndex
from slacken_tpu_torch.ops import lookup
from test_taxonomy import random_taxonomy
import probe_cases
from probe_cases import table_keys
from test_index import random_genome

torch.set_num_threads(1)

BUILDS = {
    "narrow": dict(k=35, m=31, spaces=7),
    "wide": dict(k=50, m=45, spaces=7),
    "rank table": dict(k=35, m=13, spaces=3, ordering="signature"),
}
@pytest.fixture(scope="module")
def indexes():
    """kind -> (uint64 keys [N] or [N, 2], int32 taxa, key_bits)."""
    rng = np.random.default_rng(20261017)
    tax = random_taxonomy(rng)
    leaves = [int(t) for t in tax.taxa() if tax.is_leaf(t)][:4]
    lib = [(t, random_genome(rng, 5000)) for t in leaves]
    out = {}
    for kind, kms in BUILDS.items():
        idx = KeyValueIndex.build(iter(lib), IndexParams(**kms), tax, "cpu")
        assert idx.num_records > 1000
        out[kind] = idx.keys, idx.taxa, 2 * kms["m"]
    for kind in SYNTHETIC:
        out[kind] = table_keys(rng, kind)
    return out


SYNTHETIC = ("skewed", "empty", "wide, tied row hashes")
KINDS = [*BUILDS, *SYNTHETIC]


def _torch(keys, taxa):
    return torch.from_numpy(np.ascontiguousarray(keys).view(np.int64)), torch.from_numpy(taxa)


def _queries(rng, keys, key_bits):
    """Non-negative queries: every key, its neighbours, random values below
    2^key_bits (wide: with random lo64) and 1,000 random 62-bit values."""
    if keys.ndim == 2:
        k = keys.view(np.int64)
        hi_top = 1 << (key_bits - 64)
        rand = np.stack([rng.integers(0, hi_top, 1000), rng.integers(-(1 << 63), (1 << 63) - 1, 1000)], 1)
        near = k.copy()
        near[:, 1] ^= 1
        return np.concatenate([k, near, rand]).astype(np.int64)
    k = keys.view(np.int64)
    return np.concatenate([k, k + 1, np.maximum(k - 1, 0), rng.integers(0, 1 << key_bits, 1000),
                           rng.integers(0, 1 << 62, 1000)])


def _jax_u64(q):
    return U64(jnp.asarray((q.view(np.uint64) >> np.uint64(32)).astype(np.uint32)), jnp.asarray(q.astype(np.uint32)))


def _jax_u128(q):
    u = q.view(np.uint64)
    limbs = [(u[:, 0] >> np.uint64(32)), u[:, 0], (u[:, 1] >> np.uint64(32)), u[:, 1]]
    return u128.from_limbs(*(jnp.asarray(x.astype(np.uint32)) for x in limbs))


@pytest.mark.parametrize("kind", KINDS)
def test_tiled_table_equals_jax(indexes, kind):
    keys, taxa, key_bits = indexes[kind]
    got = lookup.build_tiled(*_torch(keys, taxa), key_bits)
    bits = min(jlookup.adaptive_router_bits(len(keys)), key_bits)
    if keys.ndim == 2:
        router = jlookup.build_router_wide(keys, bits, key_bits)
        table, tile = jlookup.build_tiled_wide(keys, taxa, router)
    else:
        router = jlookup.build_router(keys, bits, key_bits)
        table, tile = jlookup.build_tiled(keys, taxa, router)
    assert (got.tile, got.bits, got.key_bits) == (tile, bits, key_bits)
    assert np.array_equal(got.router.numpy(), router)
    assert got.table.dtype == torch.int32 and np.array_equal(got.table.numpy().view(np.uint32), table)
    if kind == "skewed":
        assert lookup.max_bucket_span(got.router) == 40 and got.tile == 64
    if kind == "rank table":
        assert key_bits == 26 and bits < key_bits  # the router cuts the 26-bit space of the ranks


@pytest.mark.parametrize("kind", KINDS)
def test_hashed_rows_table_equals_jax(indexes, kind):
    """The table equals the JAX package's host builder and its device
    builder (on the CPU)."""
    keys, taxa, _ = indexes[kind]
    got = lookup.build_hashed_rows(*_torch(keys, taxa))
    if keys.ndim == 2:
        table, tile, row_bits = jlookup.build_hashed_rows_wide(keys, taxa)
        limbs = [(keys[:, 0] >> np.uint64(32)), keys[:, 0], (keys[:, 1] >> np.uint64(32)), keys[:, 1]]
        dev = jlookup.build_hashed_rows_wide_device(*(x.astype(np.uint32) for x in limbs), taxa)
    else:
        table, tile, row_bits = jlookup.build_hashed_rows(keys, taxa)
        dev = jlookup.build_hashed_rows_device((keys >> np.uint64(32)).astype(np.uint32), keys.astype(np.uint32),
                                               taxa)
    assert (got.tile, got.row_bits) == (tile, row_bits) == dev[1:]
    lanes = got.table.numpy().view(np.uint32)
    assert np.array_equal(lanes, table) and np.array_equal(lanes, np.asarray(dev[0]))
    if kind == "wide, tied row hashes":
        h = lookup.wide_row_hash(_torch(keys, taxa)[0])
        assert len(torch.unique(h)) == len(keys) // 2  # every key shares its row hash with another


@pytest.mark.parametrize("kind", KINDS)
def test_twins_equal_jax_lookups_and_lookup_taxa(indexes, kind):
    """Both twins answer as lookup_taxa on every query, -1 too; on the
    non-negative ones as the JAX lookups over the JAX tables."""
    keys, taxa, key_bits = indexes[kind]
    rng = np.random.default_rng(len(keys))
    k_t, t_t = _torch(keys, taxa)
    q = _queries(rng, keys, key_bits)
    invalid = np.full((5, 2) if keys.ndim == 2 else 5, -1, np.int64)
    q_all = torch.from_numpy(np.concatenate([q, invalid]))
    want = lookup.lookup_taxa(k_t, t_t, q_all)
    tiled, rows = lookup.build_tiled(k_t, t_t, key_bits), lookup.build_hashed_rows(k_t, t_t)
    got_tiled, got_rows = lookup.lookup_taxa_tiled(tiled, q_all), lookup.lookup_taxa_hashed_rows(rows, q_all)
    assert torch.equal(got_tiled, want) and torch.equal(got_rows, want)
    assert bool((want[:len(keys)] > 0).all())  # every key is found
    n = len(q)
    tables = (tiled.table.numpy().view(np.uint32), tiled.router.numpy(), rows.table.numpy().view(np.uint32))
    if keys.ndim == 2:
        jq = _jax_u128(q)
        j_tiled = jlookup.lookup_taxa_tiled_wide(tables[0], tables[1], jq, tiled.tile, tiled.bits, key_bits)
        j_rows = jlookup.lookup_taxa_hashed_rows_wide(tables[2], jq, rows.tile, rows.row_bits)
    else:
        jq = _jax_u64(q)
        j_tiled = jlookup.lookup_taxa_tiled(tables[0], tables[1], jq, tiled.tile, tiled.bits, key_bits)
        j_rows = jlookup.lookup_taxa_hashed_rows(tables[2], jq, rows.tile, rows.row_bits)
    assert np.array_equal(np.asarray(j_tiled), got_tiled[:n].numpy())
    assert np.array_equal(np.asarray(j_rows), got_rows[:n].numpy())
    if key_bits == 62 and len(keys):  # scrambles with the top bit set and clear, hits among both
        top = lookup.xorshift64(k_t) < 0
        assert 0 < int(top.sum()) < len(keys)


def test_forced_row_bits_grow_the_tile(indexes):
    """A row_bits too small for the keys: the tile doubles instead (row_bits
    is not grown when given), as in the JAX builders."""
    keys, taxa, _ = indexes["narrow"]
    keys, taxa = keys[:600], taxa[:600]
    got = lookup.build_hashed_rows(*_torch(keys, taxa), row_bits=1)
    table, tile, row_bits = jlookup.build_hashed_rows(keys, taxa, row_bits=1)
    assert (got.tile, got.row_bits) == (tile, row_bits) == (512, 1)
    assert np.array_equal(got.table.numpy().view(np.uint32), table)
    q = torch.from_numpy(np.concatenate([keys.view(np.int64), keys.view(np.int64) + 1]))
    assert torch.equal(lookup.lookup_taxa_hashed_rows(got, q), lookup.lookup_taxa(*_torch(keys, taxa), q))


@pytest.mark.parametrize("case", ["wide", "wide, tied row hashes", *(f"full rows {t}" for t, _ in
                                                                      probe_cases.FULL_ROW_TILES)])
def test_wide_rows_twin_on_query_streams(indexes, case):
    """The tables and query streams that the probe_rows_wide kernel is held on
    (test_torch_gpu.py): the wide builds, and tables forced to tiles of 12,
    36, 512 and 1,024 lanes whose even rows are full (equal to the JAX
    builder with that tile and row_bits); runs of equal queries 1 to 9 long
    with all-ones rows between. The twin equals the JAX lookup on the stream
    and lookup_taxa on every slice of probe_cases.stream_slices."""
    rng = np.random.default_rng(len(case))
    if case.startswith("full rows"):
        tile, row_bits = next(x for x in probe_cases.FULL_ROW_TILES if case == f"full rows {x[0]}")
        keys, taxa = probe_cases.full_row_keys(rng, tile, row_bits)
        got = lookup.build_hashed_rows(*_torch(keys, taxa), tile=tile, row_bits=row_bits)
        table, j_tile, j_row_bits = jlookup.build_hashed_rows_wide(keys, taxa, tile=tile, row_bits=row_bits)
        assert (got.tile, got.row_bits) == (j_tile, j_row_bits) == (tile, row_bits)
        assert np.array_equal(got.table.numpy().view(np.uint32), table)
    else:
        keys, taxa, _ = indexes[case]
        got = lookup.build_hashed_rows(*_torch(keys, taxa))
    base = probe_cases.queries_of(rng, keys, 45).view(np.int64)
    picked = base[rng.choice(len(base), min(len(base), 2000), replace=False)]
    stream = np.concatenate([keys.view(np.int64), picked, probe_cases.query_runs(rng, picked, 500)])
    k_t, t_t = _torch(keys, taxa)
    answer = lookup.lookup_taxa_hashed_rows(got, torch.from_numpy(stream))
    j_rows = jlookup.lookup_taxa_hashed_rows_wide(got.table.numpy().view(np.uint32), _jax_u128(stream), got.tile,
                                                  got.row_bits)
    assert np.array_equal(np.asarray(j_rows), answer.numpy())
    assert bool((answer[:len(keys)] > 0).all())
    for a, b in probe_cases.stream_slices(len(stream)):
        q = torch.from_numpy(stream)[a:b]
        assert torch.equal(lookup.lookup_taxa_hashed_rows(got, q), lookup.lookup_taxa(k_t, t_t, q)), (a, b)


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_build_that_does_not_converge_raises(wide):
    """Two rows for 9,000 keys: more than MAX_TILE keys a row."""
    rng = np.random.default_rng(9)
    if wide:
        keys = np.unique(np.stack([rng.integers(0, 1 << 20, 9000), rng.integers(0, 1 << 62, 9000)], 1), axis=0)
        keys = keys.astype(np.uint64)
    else:
        keys = np.unique(rng.integers(0, 1 << 62, 9000)).astype(np.uint64)
    taxa = np.ones(len(keys), np.int32)
    build = jlookup.build_hashed_rows_wide if wide else jlookup.build_hashed_rows
    with pytest.raises(ValueError, match="did not converge"):
        build(keys, taxa, row_bits=1)
    with pytest.raises(ValueError, match="did not converge"):
        lookup.build_hashed_rows(*_torch(keys, taxa), row_bits=1)


def test_router_helpers_equal_jax():
    for n in (0, 1, 2, 3, 4, 1000, 1 << 20, (1 << 20) + 1, 1 << 30):
        assert lookup.adaptive_router_bits(n) == jlookup.adaptive_router_bits(n)
    for span in (1, 16, 17, 18, 33, 34, 1000):
        assert lookup.tile_for_span(span) == jlookup.tile_for_span(span)
    router = np.array([0, 0, 5, 5, 9], np.int32)
    assert lookup.max_bucket_span(torch.from_numpy(router)) == jlookup.max_bucket_span(router) == 5
