"""The narrow row-bucket probe's walk (`--probe hashed1`, probe_rows_kernel
in kernels/probe_tables.cu) on the CPU, held at tolerance 0 to the JAX
package's lookup_taxa_hashed_rows: its numpy copy (probe_cases.rows_walk),
with the first lane forced to 0, to tile - 1, to random lanes and left to
lookup.row_guess, and the twin (lookup.lookup_taxa_hashed_rows), over the
hand-made tables of probe_cases.rows_walk_case (full and empty rows, runs of
equal hi' across a sector, the all-ones scramble with and without its key,
tiles of 12, 36 and 256) and over builds of random, rank-table and skewed
keys and of none; the guess itself; and the plain version of the probe's
floor (lookup.guess_sectors) against a count by hand."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import probe_cases
from slacken_tpu.ops import lookup as jlookup
from slacken_tpu.ops.u64 import U64
from slacken_tpu_torch.ops import lookup

torch.set_num_threads(1)

GUESSES = ["row_guess", "lane 0", "lane tile - 1", "random lanes"]
TABLE_KINDS = ["narrow", "rank table", "skewed", "empty"]


def _jax_rows(table, q):
    """The JAX package's lookup_taxa_hashed_rows over the port's table."""
    u = q.view(np.uint64)
    jq = U64(jnp.asarray((u >> np.uint64(32)).astype(np.uint32)), jnp.asarray(u.astype(np.uint32)))
    lanes = table.table.numpy().view(np.uint32)
    return np.asarray(jlookup.lookup_taxa_hashed_rows(lanes, jq, table.tile, table.row_bits))


def _case(keys, taxa, q, **kwargs):
    table = lookup.build_hashed_rows(torch.from_numpy(keys.view(np.int64)), torch.from_numpy(taxa), **kwargs)
    return table, q, _jax_rows(table, q)


@pytest.fixture(scope="module")
def cases():
    """kind -> (table, int64 queries, the JAX answers), built once."""
    out = {}
    for kind in probe_cases.ROWS_WALK_CASES:
        keys, taxa, q, tile, row_bits = probe_cases.rows_walk_case(np.random.default_rng(len(kind)), kind)
        out[kind] = _case(keys, taxa, q, tile=tile, row_bits=row_bits)
        assert (out[kind][0].tile, out[kind][0].row_bits) == (tile, row_bits)
    for kind in TABLE_KINDS:
        rng = np.random.default_rng(len(kind) + 1)
        keys, taxa, _ = probe_cases.table_keys(rng, kind)
        out[kind] = _case(keys, taxa, probe_cases.hashed_queries(rng, keys))
    return out


def _forced(kind, guess, table, n):
    rng = np.random.default_rng(len(kind) + len(guess))
    return {"row_guess": None, "lane 0": 0, "lane tile - 1": table.tile - 1,
            "random lanes": rng.integers(0, table.tile, n)}[guess]


@pytest.mark.parametrize("guess", GUESSES)
@pytest.mark.parametrize("kind", [*probe_cases.ROWS_WALK_CASES, *TABLE_KINDS])
def test_rows_walk_equals_jax(cases, kind, guess):
    """Wherever the walk starts, it answers as the JAX lookup, query by
    query; so does the twin."""
    table, q, want = cases[kind]
    got = probe_cases.rows_walk(table, q, _forced(kind, guess, table, len(q)))
    assert np.array_equal(got, want)
    if guess == "row_guess":
        assert np.array_equal(lookup.lookup_taxa_hashed_rows(table, torch.from_numpy(q)).numpy(), want)
        assert int((want > 0).sum()) >= table.n_keys  # every key is queried and found
        assert bool((want[q < 0] == 0).all()) and int((q < 0).sum()) > 0


@pytest.mark.parametrize("kind", [*probe_cases.ROWS_WALK_CASES, "narrow"])
def test_row_guess_scales_the_row_by_its_mean(cases, kind):
    """n_keys is the build's key count; row_mean is n_keys / 2^row_bits in
    16.16 fixed point, at most the tile for a build and capped at 2^31 - 1,
    where nearly every guess is the tile's last lane; row_guess is
    floor(f * mean) for the scramble's place f in its row, in [0, tile); a
    key's guess lies within 8 lanes of its lane for most keys of a random
    build."""
    table, q, _ = cases[kind]
    n = int((table.table[:, 2 * table.tile:] != -1).sum())
    assert table.n_keys == n
    mean = lookup.row_mean(table)
    assert mean == (n << 16) >> table.row_bits <= table.tile << 16
    assert lookup.row_mean(table._replace(n_keys=1 << 50)) == 0x7FFFFFFF
    s = lookup.xorshift64(torch.from_numpy(q))
    last = lookup.row_guess(s, table.row_bits, 0x7FFFFFFF, table.tile).numpy()
    assert np.mean(last == table.tile - 1) > 0.9
    g = lookup.row_guess(s, table.row_bits, mean, table.tile).numpy()
    frac = [(probe_cases._xorshift(int(x) & probe_cases.MASK64) << table.row_bits) % (1 << 64) >> 32 for x in q]
    assert np.array_equal(g, np.minimum([f * mean >> 48 for f in frac], table.tile - 1))
    if kind == "narrow":
        lanes = table.table[:, :table.tile].numpy().view(np.uint32)
        keys = q[:n]  # hashed_queries starts with the keys
        rows = lookup._top_bits(lookup.xorshift64(torch.from_numpy(keys)), table.row_bits).numpy()
        lane = [int(np.searchsorted(lanes[r], probe_cases._xorshift(int(k)) >> 32)) for r, k in zip(rows, keys)]
        assert np.mean(np.abs(np.array(lane) - g[:n]) < 8) > 0.7


def test_guess_sectors_by_hand(cases):
    """The floor's plain version: the xor of the 8 lanes from the guessed
    lane rounded down to a multiple of 8 in the query's row, 0 for a
    negative query; at tile 12, with the mean raised to the tile so that
    guesses reach the second sector, its last 4 lanes are the row's first
    lo' lanes."""
    table, q, _ = cases["tile 12"]
    table = table._replace(n_keys=1 << 40)
    lanes = table.table.numpy().view(np.uint32)
    q = np.concatenate([q[:200], [-1, -7]])
    got = lookup.guess_sectors(table, torch.from_numpy(q)).numpy().view(np.uint32)
    want = np.zeros(len(q), np.uint32)
    s = lookup.xorshift64(torch.from_numpy(q))
    g = lookup.row_guess(s, table.row_bits, lookup.row_mean(table), table.tile).numpy()
    rows = lookup._top_bits(s, table.row_bits).numpy()
    for i, x in enumerate(q):
        if x >= 0:
            for lane in lanes[rows[i], g[i] // 8 * 8:g[i] // 8 * 8 + 8]:
                want[i] ^= lane
    assert np.array_equal(got, want) and (g >= 8).any() and got[-1] == got[-2] == 0
