"""The port's index build against slacken_tpu's KeyValueIndex.build on a
small library whose genomes share segments (so real LCAs above the leaves
occur): byte-identical keys.npy and taxa.npy, and each package loads the
other's saved index."""

import numpy as np
import pytest
import torch

from slacken_tpu.index import IndexParams as JParams
from slacken_tpu.index import KeyValueIndex as JIndex
from slacken_tpu_torch.index import IndexParams, KeyValueIndex
from test_taxonomy import random_taxonomy

torch.set_num_threads(1)

LUT = np.frombuffer(b"ACGT", np.uint8)


def shared_library(rng, tax, n=5, length=3000):
    """(taxon, sequence) pairs cut from one random genome with per-taxon
    mutations, so most minimizers are shared by several taxa; plus an
    N-containing sequence, a sequence shorter than k and an undefined taxon."""
    leaves = [t for t in tax.taxa() if tax.is_leaf(t)][:n]
    base = rng.integers(0, 4, length + 400 * n)
    lib = []
    for i, taxon in enumerate(leaves):
        g = base[i * 400 : i * 400 + length].copy()
        g[rng.random(length) < 0.01 * (i + 1)] = rng.integers(0, 4)
        lib.append((int(taxon), LUT[g].tobytes().decode()))
    lib.append((int(leaves[0]), "ACGT" * 20 + "N" * 40 + lib[1][1][:200]))
    lib.append((int(leaves[1]), lib[2][1][:30]))
    lib.append((10_000_000, lib[3][1]))
    return lib


@pytest.mark.parametrize("row_len", [1024, 4096])
def test_build_matches_jax_byte_for_byte(rng, tmp_path, row_len):
    tax = random_taxonomy(rng)
    lib = shared_library(rng, tax)
    want = JIndex.build(iter(lib), JParams(), tax, batch_rows=8, row_len=4096)
    got = KeyValueIndex.build(iter(lib), IndexParams(), tax, "cpu", batch_rows=4, row_len=row_len)
    assert got.num_records == len(want.keys) > 1000
    # real LCAs: some records carry an inner node, not the leaf of any sequence
    assert len(np.setdiff1d(got.taxa, [t for t, _ in lib])) > 0
    want.save(str(tmp_path / "jax"))
    got.save(str(tmp_path / "torch"))
    for name in ("keys.npy", "taxa.npy"):
        assert (tmp_path / "jax" / name).read_bytes() == (tmp_path / "torch" / name).read_bytes()


def test_each_package_loads_the_other(rng, tmp_path):
    tax = random_taxonomy(rng)
    lib = shared_library(rng, tax, n=3, length=1500)
    JIndex.build(iter(lib), JParams(), tax, batch_rows=8, row_len=2048).save(str(tmp_path / "j"))
    KeyValueIndex.build(iter(lib), IndexParams(), tax, "cpu").save(str(tmp_path / "t"))
    from_jax = KeyValueIndex.load(str(tmp_path / "j"))
    from_torch = JIndex.load(str(tmp_path / "t"))
    assert np.array_equal(from_jax.keys, from_torch.keys)
    assert np.array_equal(from_jax.taxa, from_torch.taxa)
    assert from_jax.params == IndexParams.from_json(from_torch.params.to_json())
    keys, taxa, directory = from_jax.device_arrays("cpu")
    assert keys.dtype == torch.int64 and taxa.dtype == torch.int32
    # about 4 keys a bucket: ceil(log2(n / 4)) prefix bits, one entry more than buckets
    assert directory.starts.shape[0] == (1 << (-(-from_jax.num_records // 4) - 1).bit_length()) + 1
    assert int(directory.starts[-1]) == from_jax.num_records


@pytest.mark.parametrize("kw", [dict(k=21, m=11, spaces=0, ordering="lexicographic"), dict(k=40, m=35, spaces=0)])
def test_unported_index_kinds_raise(rng, tmp_path, kw):
    """Explicit orderings and wide keys, which the port used to refuse, build
    to the JAX package's files byte for byte (the name dates from the
    refusal). What still raises: a rank table beside a wide m or beside
    "xor", a table-less frequency build, and tables for m > 15."""
    tax = random_taxonomy(rng)
    lib = shared_library(rng, tax)
    want = JIndex.build(iter(lib), JParams(**kw), tax, batch_rows=8, row_len=4096)
    got = KeyValueIndex.build(iter(lib), IndexParams(**kw), tax, "cpu", batch_rows=4, row_len=1024)
    assert got.num_records == len(want.keys) > 500
    assert got.keys.shape == ((got.num_records, 2) if kw["m"] > 31 else (got.num_records,))
    want.save(str(tmp_path / "jax"))
    got.save(str(tmp_path / "torch"))
    names = ["keys.npy", "taxa.npy"] + (["ordering_lut.npy"] if "ordering" in kw else [])
    for name in names:
        assert (tmp_path / "jax" / name).read_bytes() == (tmp_path / "torch" / name).read_bytes()
    assert (tmp_path / "torch" / "ordering_lut.npy").exists() == ("ordering" in kw)
    lut = np.arange(4 ** 11, dtype=np.uint32)
    for bad, error in (
        (dict(params=IndexParams(k=40, m=35, spaces=0, ordering="lexicographic")), NotImplementedError),
        (dict(params=IndexParams(k=21, m=11, spaces=0), ordering_lut=lut), ValueError),
        (dict(params=IndexParams(k=21, m=11, spaces=0, ordering="frequency")), ValueError),
        (dict(params=IndexParams(k=21, m=11, spaces=0, ordering="given"), ordering_lut=lut[:100]), ValueError),
        (dict(params=IndexParams(k=21, m=16, spaces=0, ordering="signature")), ValueError),
        (dict(params=IndexParams(k=21, m=11, spaces=0, ordering="random")), ValueError),
    ):
        with pytest.raises(error):
            KeyValueIndex.build(iter([]), taxonomy=tax, device="cpu", **bad)


def test_empty_library(rng):
    idx = KeyValueIndex.build(iter([]), IndexParams(), random_taxonomy(rng), "cpu")
    assert idx.num_records == 0 and idx.keys.dtype == np.uint64


KINDS = {
    "narrow": dict(k=35, m=31, spaces=7),
    "wide": dict(k=40, m=35, spaces=3),
    "lexicographic": dict(k=21, m=11, spaces=2, ordering="lexicographic"),
}


@pytest.mark.parametrize("kind", KINDS)
def test_keep_records_matches_jax_and_leaves_the_index_as_it_was(rng, tmp_path, kind):
    """The full-records sidecar: distinct (key, taxon) pairs in slacken_tpu's
    order, the same files; the index beside it is the one a plain build gives."""
    tax = random_taxonomy(rng)
    lib = shared_library(rng, tax)
    kw = KINDS[kind]
    want = JIndex.build(iter(lib), JParams(**kw), tax, keep_records=True)
    got = KeyValueIndex.build(iter(lib), IndexParams(**kw), tax, "cpu", batch_rows=4, row_len=1024, keep_records=True)
    plain = KeyValueIndex.build(iter(lib), IndexParams(**kw), tax, "cpu")
    assert np.array_equal(got.keys, plain.keys) and np.array_equal(got.taxa, plain.taxa)
    assert plain.record_keys_t is None and got.record_keys_t.dtype == torch.int64
    assert got.record_keys.shape == want.record_keys.shape and len(got.record_taxa) > got.num_records
    want.save(str(tmp_path / "jax"))
    got.save(str(tmp_path / "torch"))
    plain.save(str(tmp_path / "plain"))
    for name in ("keys.npy", "taxa.npy", "record_keys.npy", "record_taxa.npy"):
        assert (tmp_path / "jax" / name).read_bytes() == (tmp_path / "torch" / name).read_bytes(), name
    assert not (tmp_path / "plain" / "record_keys.npy").exists()
    loaded = KeyValueIndex.load(str(tmp_path / "jax"))
    assert torch.equal(loaded.record_keys_t, got.record_keys_t) and torch.equal(loaded.record_taxa_t, got.record_taxa_t)
    assert loaded.to("cpu") is loaded and loaded.record_keys_t.device.type == "cpu"
    empty = KeyValueIndex.build(iter([]), IndexParams(**kw), tax, "cpu", keep_records=True)
    assert empty.record_keys.shape == ((0, 2) if kind == "wide" else (0,)) and empty.build_restricted({1}).num_records == 0


@pytest.mark.parametrize("kind", KINDS)
def test_taxon_filter_and_build_restricted_match_jax(rng, kind):
    tax = random_taxonomy(rng)
    lib = shared_library(rng, tax)
    kw = KINDS[kind]
    taxon_set = tax.taxa_with_descendants([lib[0][0], lib[2][0]]) | {10_000_000}  # one outside the taxonomy
    want = JIndex.build(iter(lib), JParams(**kw), tax, taxon_filter=taxon_set)
    got = KeyValueIndex.build(iter(lib), IndexParams(**kw), tax, "cpu", taxon_filter=taxon_set)
    base = KeyValueIndex.build(iter(lib), IndexParams(**kw), tax, "cpu", keep_records=True)
    restricted = base.build_restricted(taxon_set)
    assert 0 < got.num_records < base.num_records
    for idx in (got, restricted, base.build_restricted(taxon_set, "cpu")):
        assert np.array_equal(idx.keys, want.keys) and np.array_equal(idx.taxa, want.taxa)
        assert (idx.ordering_lut is None) == (kind != "lexicographic")
    everything = base.build_restricted(set(tax.taxa()))
    assert np.array_equal(everything.keys, base.keys) and np.array_equal(everything.taxa, base.taxa)
    same = base.with_records(base.keys, base.taxa)
    assert torch.equal(same.keys_t, base.keys_t) and same.params == base.params and same.taxonomy is tax
    assert same.ordering_lut is base.ordering_lut


def test_respace_matches_jax(rng, tmp_path):
    tax = random_taxonomy(rng)
    lib = shared_library(rng, tax)
    jbase = JIndex.build(iter(lib), JParams(), tax)
    base = KeyValueIndex.build(iter(lib), IndexParams(), tax, "cpu")
    for spaces in (9, 15):
        want, got = jbase.respace(spaces), base.respace(spaces)
        assert got.params.spaces == spaces and 0 < got.num_records < base.num_records
        want.save(str(tmp_path / f"j{spaces}"))
        got.save(str(tmp_path / f"t{spaces}"))
        for name in ("keys.npy", "taxa.npy", "params.json"):
            assert (tmp_path / f"j{spaces}" / name).read_bytes() == (tmp_path / f"t{spaces}" / name).read_bytes()
    assert base.params.spaces == 7  # the index itself is untouched
    for bad in (7, 3):
        with pytest.raises(ValueError, match="Respacing must increase spaces"):
            base.respace(bad)
    lex = KeyValueIndex.build(iter(lib), IndexParams(k=21, m=11, spaces=2, ordering="lexicographic"), tax, "cpu")
    with pytest.raises(NotImplementedError, match="xor ordering"):
        lex.respace(4)


@pytest.mark.parametrize("kms,spaces", [((40, 35, 3), 9), ((40, 35, 3), 17), ((35, 33, 0), 16), ((70, 63, 7), 31)])
def test_wide_respace_against_a_reference(rng, kms, spaces):
    """slacken_tpu's respace overflows on a wide index (a mask over more than
    64 bits into np.uint64), so the port's is held to a reference in plain
    integers: mask each 2m-bit key, LCA the taxa of equal masked keys."""
    from slacken_tpu_torch.ops.minimizers import space_mask_int

    tax = random_taxonomy(rng)
    lib = shared_library(rng, tax)
    base = KeyValueIndex.build(iter(lib), IndexParams(*kms), tax, "cpu")
    with pytest.raises(OverflowError):
        JIndex.build(iter(lib), JParams(*kms), tax).respace(spaces)
    mask = space_mask_int(kms[1], spaces)
    assert mask >> 64  # the mask spans both limbs
    want = {}
    for (hi, lo), taxon in zip(base.keys.tolist(), base.taxa.tolist()):
        key = ((hi << 64) | lo) & mask
        want[key] = taxon if key not in want else tax.lca(want[key], taxon)
    got = base.respace(spaces)
    got_keys = [(hi << 64) | lo for hi, lo in got.keys.tolist()]
    assert got_keys == sorted(want) and got.taxa.tolist() == [want[k] for k in got_keys]
    assert len(got_keys) < base.num_records and got.params.spaces == spaces and got.wide
    # some masked keys merge taxa into an ancestor that no key of the run carried
    assert any(t not in set(base.taxa.tolist()) for t in got.taxa.tolist()) or len(set(got.taxa.tolist())) > 1
