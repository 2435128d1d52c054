"""The tiled probe's walk (`--probe tiled`, probe_tiled_kernel in
kernels/probe_tables.cu) on the CPU, held at tolerance 0 to the JAX
package's lookup_taxa_tiled and lookup_taxa_tiled_wide: its numpy copy
(probe_cases.tiled_walk), from the record that the kernel guesses from the
query's place in its bucket and with its start forced to the bucket's first
record, the next three, its last and random ones, and the twin
(lookup.lookup_taxa_tiled), over the hand-made tables of
probe_cases.tiled_walk_case (buckets of 0 to 9 records and of the tile + 1,
starting at every record modulo 4, the first at record 0 and the last
ending at the last key; 62-bit keys, 26-bit ranks, wide keys whose l3 is 0)
and over the key sets of probe_cases.table_keys; and the plain version of
the probe's floor (lookup.router_sectors) against a count by hand."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import probe_cases
from slacken_tpu.ops import lookup as jlookup
from slacken_tpu.ops import u128
from slacken_tpu.ops.u64 import U64
from slacken_tpu_torch.ops import lookup

torch.set_num_threads(1)

#: where the model's walk starts: the kernel's guess, the bucket's first
#: record, the next three (the rest of the first two steps), the bucket's
#: last record and a random record of the bucket
STARTS = ["guess", "first record", "record 1", "record 2", "record 3", "last record", "random record"]
KEY_SETS = list(probe_cases.TABLE_KINDS)


def _jax_tiled(table, q):
    """The JAX package's lookup over the port's table, uint32 lanes."""
    lanes, router = table.table.numpy().view(np.uint32), table.router.numpy()
    u = q.view(np.uint64)
    if q.ndim == 2:
        limbs = [u[:, 0] >> np.uint64(32), u[:, 0], u[:, 1] >> np.uint64(32), u[:, 1]]
        jq = u128.from_limbs(*(jnp.asarray(x.astype(np.uint32)) for x in limbs))
        return np.asarray(jlookup.lookup_taxa_tiled_wide(lanes, router, jq, table.tile, table.bits, table.key_bits))
    jq = U64(jnp.asarray((u >> np.uint64(32)).astype(np.uint32)), jnp.asarray(u.astype(np.uint32)))
    return np.asarray(jlookup.lookup_taxa_tiled(lanes, router, jq, table.tile, table.bits, table.key_bits))


@pytest.fixture(scope="module")
def cases():
    """kind -> (table, int64 queries, the JAX answers, lookup_taxa's), built once."""
    out = {}
    for kind in [*probe_cases.TILED_WALK_KINDS, *KEY_SETS]:
        rng = np.random.default_rng(len(kind))
        if kind in probe_cases.TILED_WALK_KINDS:
            keys, taxa, key_bits, q = probe_cases.tiled_walk_case(rng, kind)
        else:
            keys, taxa, key_bits = probe_cases.table_keys(rng, kind)
            edges = np.array([0, (1 << 63) - 1, 1 << 63], np.uint64)
            q = (probe_cases.queries_of(rng, keys, 45) if keys.ndim == 2 else
                 np.concatenate([keys, keys + np.uint64(1), keys - np.uint64(1), edges,
                                 rng.integers(0, 1 << 64, 1000, dtype=np.uint64)])).view(np.int64)
        k, t = torch.from_numpy(keys.view(np.int64)), torch.from_numpy(taxa)
        table = lookup.build_tiled(k, t, key_bits)
        out[kind] = table, q, _jax_tiled(table, q), lookup.lookup_taxa(k, t, torch.from_numpy(q)).numpy()
    return out


def _start(kind, start, table, q):
    """The model's start for each query: an offset into its bucket."""
    if start == "random record":
        return np.random.default_rng(len(kind)).integers(0, table.tile + 2, len(q))
    return {"guess": None, "first record": 0, "record 1": 1, "record 2": 2, "record 3": 3,
            "last record": table.tile + 1}[start]


@pytest.mark.parametrize("start", STARTS)
@pytest.mark.parametrize("kind", [*probe_cases.TILED_WALK_KINDS, *KEY_SETS])
def test_tiled_walk_equals_jax(cases, kind, start):
    """Wherever in the bucket the walk starts, it answers as the JAX lookup
    and lookup_taxa, query by query; so does the twin."""
    table, q, want, exact = cases[kind]
    assert np.array_equal(want, exact)
    got = probe_cases.tiled_walk(table, q, _start(kind, start, table, q))
    assert np.array_equal(got, want)
    if start == "guess":
        assert np.array_equal(lookup.lookup_taxa_tiled(table, torch.from_numpy(q)).numpy(), want)
        assert int((want > 0).sum()) >= table.router[-1]  # every key is queried and found


@pytest.mark.parametrize("kind", list(probe_cases.TILED_WALK_KINDS))
def test_tiled_walk_cases_cover_the_layout(cases, kind):
    """The hand-made tables hold what the walk must meet: buckets of 0, 1,
    3, 4, 5, 8, 9 and tile + 1 records, buckets starting at records 4j, 4j +
    1, 4j + 2 and 4j + 3, the first at record 0, the last ending at the
    last key, which is the largest of the key space; the queries include
    that key, the bucket edges and invalid windows (narrow -1, wide all
    ones), which miss unread."""
    table, q, want, _ = cases[kind]
    router = table.router.numpy().astype(np.int64)
    sizes = np.diff(router)
    n = int(router[-1])
    assert table.tile == 16 and {0, 1, 3, 4, 5, 8, 9, table.tile + 1} <= set(sizes.tolist())
    assert set((router[:-1][sizes > 0] % 4).tolist()) == {0, 1, 2, 3}
    assert sizes[0] > 0 and sizes[-1] > 0 and n == int(router[-2]) + int(sizes[-1])
    assert probe_cases._as_int(q[n - 1]) == (1 << table.key_bits) - 1 and want[n - 1] > 0  # q starts with the keys
    invalid = (q == -1).all(1) if q.ndim == 2 else q == -1
    assert invalid.any() and (want[invalid] == 0).all()


@pytest.mark.parametrize("kind", list(probe_cases.TILED_WALK_KINDS))
def test_tiled_guess_lies_in_the_bucket(cases, kind):
    """The kernel's start, s + tiled_guess, lies in the query's bucket [s,
    e): the first record for a query at the bottom of the bucket's range,
    the last at its top, and the record of a key at most a few records from
    its place in a bucket of 17 keys spread evenly over the range."""
    table, q, _, _ = cases[kind]
    shift, router = table.key_bits - table.bits, table.router.numpy()
    for p in range(1 << table.bits):
        s, e = int(router[p]), int(router[p + 1])
        if e > s:
            assert probe_cases.tiled_guess(p << shift, shift, e - s) == 0
            assert probe_cases.tiled_guess(((p + 1) << shift) - 1, shift, e - s) == e - s - 1
    big = int(np.flatnonzero(np.diff(router) == table.tile + 1)[0])
    keys = [probe_cases._as_int(x) for x in q[router[big]:router[big + 1]]]  # q starts with the keys
    guesses = [probe_cases.tiled_guess(k, shift, len(keys)) for k in keys]
    assert all(0 <= g < len(keys) for g in guesses) and np.mean(np.abs(np.subtract(guesses, range(len(keys))))) < 4


def test_router_sectors_by_hand(cases):
    """The floor's plain version: for each query inside the key space,
    router[p] ^ router[p + 1], and for a non-empty bucket the xor of the 8
    lanes from its first record's first lane rounded down to a multiple of
    8; 0 outside the key space. Narrow and wide."""
    for kind in ("62-bit keys", "wide keys, l3 0"):
        table, q, _, _ = cases[kind]
        lanes = table.table.numpy().view(np.uint32).reshape(-1)
        width, router = table.table.shape[2], table.router.numpy()
        got = lookup.router_sectors(table, torch.from_numpy(q)).numpy().view(np.uint32)
        want = np.zeros(len(q), np.uint32)
        shift = table.key_bits - table.bits
        for i, x in enumerate(q):
            v = probe_cases._as_int(x)
            if (q.ndim == 1 and x < 0) or v >> table.key_bits:
                continue
            s, e = int(router[v >> shift]), int(router[(v >> shift) + 1])
            want[i] = np.uint32(s ^ e)
            if e > s:
                for lane in lanes[s * width // 8 * 8:s * width // 8 * 8 + 8]:
                    want[i] ^= lane
        assert np.array_equal(got, want) and (want == 0).any() and (want != 0).sum() > len(q) // 2
