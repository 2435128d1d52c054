"""The bucketed probe's walk (`--probe bucketed`, probe_bucketed_kernel in
kernels/probe_tables.cu) on the CPU, held at tolerance 0 to the JAX
package's lookup_taxa_bucketed over its own router and
pad_keys_for_buckets's padded arrays: its numpy copy
(probe_cases.bucketed_walk), from the key that the kernel guesses from the
query's place in its bucket and with its start forced to the bucket's first
key, the next three, its last and random ones, and the twin
(lookup.lookup_taxa_bucketed), over the hand-made arrays of
probe_cases.bucketed_walk_case (buckets of 0 to 9 keys and of maxb,
starting at every key modulo 4, the first at key 0 and the last ending at
the last key, right before the padding; one key a bucket, a single padding
key) and over the narrow key sets of probe_cases.table_keys; and the plain
version of the probe's floor (lookup.bucket_sectors) against a count by
hand."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import probe_cases
from slacken_tpu.ops import lookup as jlookup
from slacken_tpu.ops.u64 import U64
from slacken_tpu_torch.ops import lookup

torch.set_num_threads(1)

#: where the model's walk starts: the kernel's guess, the bucket's first
#: key, the next three (the rest of the first sector at an aligned start),
#: the bucket's last key and a random key of the bucket
STARTS = ["guess", "first key", "key 1", "key 2", "key 3", "last key", "random key"]
KEY_SETS = ["narrow", "rank table", "skewed", "empty"]
KINDS = [*probe_cases.BUCKETED_WALK_KINDS, *KEY_SETS]


def _jax_bucketed(keys, taxa, key_bits, q):
    """The JAX package's lookup over its own router and padded arrays."""
    bits = min(jlookup.adaptive_router_bits(len(keys)), key_bits)
    router = jlookup.build_router(keys, bits, key_bits)
    maxb = jlookup.max_bucket_span(router)
    pad_keys, pad_taxa = jlookup.pad_keys_for_buckets(keys, taxa, maxb)
    u = q.view(np.uint64)
    jq = U64(jnp.asarray((u >> np.uint64(32)).astype(np.uint32)), jnp.asarray(u.astype(np.uint32)))
    return np.asarray(jlookup.lookup_taxa_bucketed(jlookup.keys_from_numpy(pad_keys), jnp.asarray(pad_taxa),
                                                   jnp.asarray(router), jq, maxb, bits, key_bits))


@pytest.fixture(scope="module")
def cases():
    """kind -> (arrays, int64 queries, the JAX answers, lookup_taxa's), built once."""
    out = {}
    for kind in KINDS:
        rng = np.random.default_rng(len(kind))
        if kind in probe_cases.BUCKETED_WALK_KINDS:
            keys, taxa, key_bits, q = probe_cases.bucketed_walk_case(rng, kind)
        else:
            keys, taxa, key_bits = probe_cases.table_keys(rng, kind)
            k = keys.view(np.int64)
            q = np.concatenate([k, k + 1, k - 1, [-1, 0, 1 << key_bits, (1 << 63) - 1],
                                rng.integers(-(1 << 63), (1 << 63) - 1, 1000, dtype=np.int64)])
        k, t = torch.from_numpy(keys.view(np.int64)), torch.from_numpy(taxa)
        table = lookup.build_bucketed(k, t, key_bits)
        out[kind] = table, q, _jax_bucketed(keys, taxa, key_bits, q), lookup.lookup_taxa(k, t, torch.from_numpy(q)).numpy()
    return out


def _start(kind, start, table, q):
    """The model's start for each query: an offset into its bucket."""
    if start == "random key":
        return np.random.default_rng(len(kind)).integers(0, table.maxb, len(q))
    return {"guess": None, "first key": 0, "key 1": 1, "key 2": 2, "key 3": 3, "last key": table.maxb}[start]


@pytest.mark.parametrize("start", STARTS)
@pytest.mark.parametrize("kind", KINDS)
def test_bucketed_walk_equals_jax(cases, kind, start):
    """Wherever in the bucket the walk starts, it answers as the JAX lookup
    and lookup_taxa, query by query, and reads only the padded arrays; so
    does the twin."""
    table, q, want, exact = cases[kind]
    assert np.array_equal(want, exact)
    got = probe_cases.bucketed_walk(table, q, _start(kind, start, table, q))
    assert np.array_equal(got, want)
    if start == "guess":
        assert np.array_equal(lookup.lookup_taxa_bucketed(table, torch.from_numpy(q)).numpy(), want)
        assert int((want > 0).sum()) >= table.n  # every key is queried and found


@pytest.mark.parametrize("kind", list(probe_cases.BUCKETED_WALK_KINDS))
def test_bucketed_walk_cases_cover_the_layout(cases, kind):
    """The hand-made arrays hold what the walk must meet: buckets of 0 to 9
    keys and one of maxb (or, one key a bucket, maxb 1), buckets starting at
    keys 4j, 4j + 1, 4j + 2 and 4j + 3, the first at key 0, the last ending
    at the last key, which is the largest of the key space and lies right
    before the maxb all-ones padding keys; the queries include that key, -1,
    0 and values at and above 2^key_bits, which miss unread."""
    table, q, want, _ = cases[kind]
    router, keys = table.router.numpy().astype(np.int64), table.keys.numpy()
    sizes = np.diff(router)
    n = table.n
    assert table.maxb == sizes.max() and table.bits == 12
    assert set(range(10)) <= set(sizes.tolist()) if table.maxb > 1 else set(sizes.tolist()) == {0, 1}
    assert set((router[:-1][sizes > 0] % 4).tolist()) == {0, 1, 2, 3}
    assert sizes[0] > 0 and router[0] == 0 and sizes[-1] > 0 and router[-1] == n
    assert int(keys[n - 1]) == (1 << table.key_bits) - 1 and (keys[n:] == -1).all() and len(keys) == n + table.maxb
    assert q[n - 1] == keys[n - 1] and want[n - 1] > 0  # q starts with the keys
    for x in (-1, 0, 1 << table.key_bits, (1 << table.key_bits) + 1):
        assert x in q
    outside = (q < 0) | (q >= 1 << table.key_bits)
    assert (want[outside] == 0).all()


@pytest.mark.parametrize("step", [2, 8])
def test_bucketed_walk_of_other_steps_equals_jax(cases, step):
    """The walk answers the same at 2 keys a step (one 16-byte load) and at
    8 (four), from the guess and from the bucket's first key."""
    for kind in probe_cases.BUCKETED_WALK_KINDS:
        table, q, want, _ = cases[kind]
        for start in (None, 0):
            assert np.array_equal(probe_cases.bucketed_walk(table, q, start, step=step), want), (kind, start)


def test_bucket_sectors_by_hand(cases):
    """The floor's plain version: for each query inside the key space,
    router[p] ^ router[p + 1], and for a non-empty bucket [s, e) the xor of
    the uint32 lanes of the keys of the aligned 4-key sector that holds key
    s + tiled_guess, of those pairs of keys that hold a key of the bucket;
    0 outside the key space."""
    for kind in ("62-bit keys", "26-bit ranks", "one key a bucket", "skewed"):
        table, q, _, _ = cases[kind]
        keys, router = table.keys.numpy().view(np.uint64), table.router.numpy()
        shift = table.key_bits - table.bits
        got = lookup.bucket_sectors(table, torch.from_numpy(q)).numpy().view(np.uint32)
        want = np.zeros(len(q), np.uint32)
        for i, x in enumerate(q):
            if x < 0 or int(x) >> table.key_bits:
                continue
            s, e = int(router[int(x) >> shift]), int(router[(int(x) >> shift) + 1])
            v = s ^ e
            if e > s:
                b = (s + probe_cases.tiled_guess(int(x), shift, e - s)) // 4 * 4
                for h in (0, 2):
                    if b + h + 2 > s and b + h < e:
                        for key in keys[b + h:b + h + 2]:
                            v ^= (int(key) & 0xFFFFFFFF) ^ (int(key) >> 32)
            want[i] = np.uint32(v)
        assert np.array_equal(got, want), kind
        assert (want == 0).any() and (want != 0).sum() > len(q) // 4
