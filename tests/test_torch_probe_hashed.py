"""The rest of the probe choice on the CPU (`--probe hashed`, `hashed128`,
`bucketed`), held at tolerance 0 to the JAX package: the tables
(lookup.build_hashed, build_hashed_cols, build_bucketed), lane for lane, to
build_hashed / build_hashed_cols and to build_router + pad_keys_for_buckets,
with the builders' own and with forced bits and tiles, for narrow (35, 31, 7)
and rank-table (35, 13, 3) indexes of four random 5 kbp genomes and for
hand-made key sets (`probe_cases.hashed_keys`: a run of keys of one home
slot, the key whose scramble is all ones, a table that ends mid-space, no
keys); the twins (lookup_taxa_hashed(_cols), lookup_taxa_bucketed) to the
JAX lookups and to lookup_taxa on hits, misses, -1 and the all-ones scramble;
the builds that do not converge. End to end: the port's classify and
classify2 CLIs with each of the three probes write the files of its
--probe routed run and of slacken_tpu's CLI with the same --probe; over 8
CPU shards hashed runs its own table a shard (ring and replicated) and
hashed128 and bucketed the routed probe, as slacken_tpu's MeshClassifier
does; MultiHostRingClassifier with mh_probe="hashed" (and STPU_MH_PROBE)
over 2 CPU entries, one of them an empty key range."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import probe_cases
from slacken_tpu import cli as jcli
from slacken_tpu.ops import lookup as jlookup
from slacken_tpu.ops.u64 import U64
from slacken_tpu_torch import cli, inputs
from slacken_tpu_torch.classify import Classifier, ClassifyParams
from slacken_tpu_torch.index import KeyValueIndex
from slacken_tpu_torch.ops import cuda_kernels, lookup
from slacken_tpu_torch.parallel import multihost
from slacken_tpu_torch.parallel.classifier import MeshClassifier
from slacken_tpu_torch.parallel.mesh import Mesh
from test_torch_probe_choice import CPU, make_world, routed_files, run

torch.set_num_threads(1)

KINDS = ["narrow", "rank table"]
PROBES = ["hashed", "hashed128", "bucketed"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return make_world(tmp_path_factory.mktemp("probe_hashed"), KINDS, sharded=["narrow"])


@pytest.fixture(scope="module")
def routed2(world, tmp_path_factory):
    """The files of the port's classify2 with --probe routed."""
    return run(cli.main, tmp_path_factory.mktemp("routed2"), *classify2_args(world), *CPU)


def classify2_args(world):
    return ["classify2", str(world / "reads.fastq"), "-l", str(world / "lib"), "-c", "0.0", "-D", "20",
            "-i", str(world / "narrow1")]


@pytest.fixture(scope="module")
def routed(world, tmp_path_factory):
    return routed_files(world, tmp_path_factory.mktemp("routed"), KINDS)


def _records(world, kind):
    idx = KeyValueIndex.load(str(world / f"{kind}1"))
    return idx.keys, idx.taxa, idx.key_bits


def _torch(keys, taxa):
    return torch.from_numpy(np.ascontiguousarray(keys).view(np.int64)), torch.from_numpy(taxa)


def _jax_u64(q):
    return U64(jnp.asarray((q.view(np.uint64) >> np.uint64(32)).astype(np.uint32)), jnp.asarray(q.astype(np.uint32)))


def _hashed_equal_jax(keys, taxa, cols, **kwargs):
    """The port's hashed table == the JAX builder's, lane for lane, with the
    same tile and bits; returns it."""
    got = (lookup.build_hashed_cols if cols else lookup.build_hashed)(*_torch(keys, taxa), **kwargs)
    table, tile, bits = (jlookup.build_hashed_cols if cols else jlookup.build_hashed)(keys, taxa, 62, **kwargs)
    assert (got.tile, got.bits, got.cols) == (tile, bits, cols)
    assert got.table.dtype == torch.int32 and np.array_equal(got.table.numpy().view(np.uint32), table)
    return got


def _hashed_twin_equal_jax(got, keys, taxa, q):
    """The twin == lookup_taxa == the JAX lookup over the port's table on
    queries `q` (negative ones too: the JAX answer there is 0)."""
    twin = lookup.lookup_taxa_hashed_cols if got.cols else lookup.lookup_taxa_hashed
    answer = twin(got, torch.from_numpy(q))
    assert torch.equal(answer, lookup.lookup_taxa(*_torch(keys, taxa), torch.from_numpy(q)))
    jfn = jlookup.lookup_taxa_hashed_cols if got.cols else jlookup.lookup_taxa_hashed
    assert np.array_equal(np.asarray(jfn(got.table.numpy().view(np.uint32), _jax_u64(q), got.tile, got.bits)),
                          answer.numpy())
    return answer


@pytest.mark.parametrize("cols", [False, True], ids=["hashed", "hashed128"])
@pytest.mark.parametrize("kind", KINDS)
def test_hashed_tables_of_indexes_equal_jax(world, kind, cols):
    """The builders' own geometry, bits forced one below it (the tile grows
    where the keys need it) and a forced tile of twice the least; each
    table's twin against the JAX lookup and lookup_taxa."""
    keys, taxa, key_bits = _records(world, kind)
    assert len(keys) > 1000
    auto = _hashed_equal_jax(keys, taxa, cols)
    rng = np.random.default_rng(len(keys))
    k = keys.view(np.int64)
    q = np.concatenate([k, k + 1, np.maximum(k - 1, 0), rng.integers(0, 1 << key_bits, 1000), [-1, -1]])
    least = lookup.HASHED_COLS_TILE if cols else lookup.HASHED_TILE
    forced = _hashed_equal_jax(keys, taxa, cols, bits=auto.bits - 1)
    assert forced.bits == auto.bits - 1 and forced.tile >= auto.tile
    for table in (auto, forced, _hashed_equal_jax(keys, taxa, cols, tile=2 * least)):
        assert bool((_hashed_twin_equal_jax(table, keys, taxa, q)[:len(keys)] > 0).all())
    if kind == "rank table":  # 26-bit ranks scramble into clusters: the builder grows past the least tile or bits
        assert auto.tile > least or auto.bits > max(12, int(np.ceil(np.log2(len(keys)))) + (0 if cols else 1))


@pytest.mark.parametrize("cols", [False, True], ids=["hashed", "hashed128"])
@pytest.mark.parametrize("kind", probe_cases.HASHED_KINDS)
def test_hashed_tables_of_hand_made_keys(kind, cols):
    """Hand-made key sets: the tables equal the JAX builders', the twins the
    JAX lookups and lookup_taxa, with the all-ones scramble's key among the
    queries of every set."""
    tile = lookup.HASHED_COLS_TILE if cols else lookup.HASHED_TILE
    rng = np.random.default_rng(len(kind) + tile)
    keys, taxa = probe_cases.hashed_keys(rng, kind, tile)
    table = _hashed_equal_jax(keys, taxa, cols)
    answer = _hashed_twin_equal_jax(table, keys, taxa, probe_cases.hashed_queries(rng, keys))
    assert bool((answer[:len(keys)] > 0).all())
    scrambled, _, pos, _, bits = lookup._parked(*_torch(keys, taxa), table.tile, table.bits, 0)
    if kind == "full run":  # a run of `tile` keys of one home, high in the hash space: the last parked tile - 1 on
        assert table.tile == tile and int((pos - lookup._top_bits(scrambled, bits))[-1]) == tile - 1
    if kind == "all-ones scramble":
        at = list(keys).index(np.uint64(probe_cases.ALL_ONES_KEY))
        assert int(scrambled[-1]) == -1  # the largest scramble: parked last
        q = torch.tensor([probe_cases.ALL_ONES_KEY])
        assert int(lookup.lookup_taxa_hashed(table, q)[0]) == taxa[at]
        without = _hashed_equal_jax(np.delete(keys, at), np.delete(taxa, at), cols)
        assert int(_hashed_twin_equal_jax(without, np.delete(keys, at), np.delete(taxa, at), q.numpy())[0]) == 0
        # the rows that the JAX lookup compares hold free slots, all ones like the query's scramble
        hi, lo, tx = lookup._hashed_lanes(without, torch.tensor([(1 << without.bits) - 1]) // without.tile)
        assert bool(((hi == -1) & (lo == -1) & (tx == -1)).any())
    if kind == "empty":
        assert tuple(table.table.shape) == ((3, 3 * tile) if cols else (3, tile, 3))
        assert bool((table.table == -1).all())
    if kind == "low half":  # queries whose home slot lies beyond the table's last row
        homes = lookup._top_bits(lookup.xorshift64(torch.from_numpy(probe_cases.hashed_queries(rng, keys))), table.bits)
        assert int((homes >= table.slots).sum()) > 100


@pytest.mark.parametrize("cols", [False, True], ids=["hashed", "hashed128"])
@pytest.mark.parametrize("kind", probe_cases.HASHED_KINDS)
def test_hashed_twins_on_query_streams(kind, cols):
    """The query streams that the probe_hashed kernels are held on
    (test_torch_gpu.py): runs of equal queries 1 to 9 long with -1 between;
    the twin equals the JAX lookup on the whole stream and lookup_taxa on
    every slice of probe_cases.stream_slices (an odd start, 0, 1, 3, 5 and
    4k + 3 queries)."""
    tile = lookup.HASHED_COLS_TILE if cols else lookup.HASHED_TILE
    rng = np.random.default_rng(len(kind) + tile + 1)
    keys, taxa = probe_cases.hashed_keys(rng, kind, tile)
    table = _hashed_equal_jax(keys, taxa, cols)
    base = probe_cases.hashed_queries(rng, keys)
    stream = np.concatenate([base, probe_cases.query_runs(rng, base, 3000)])
    answer = _hashed_twin_equal_jax(table, keys, taxa, stream)
    twin = lookup.lookup_taxa_hashed_cols if cols else lookup.lookup_taxa_hashed
    for a, b in probe_cases.stream_slices(len(stream)):
        q = torch.from_numpy(stream)[a:b]
        assert torch.equal(twin(table, q), lookup.lookup_taxa(*_torch(keys, taxa), q)), (a, b)
        assert torch.equal(twin(table, q), answer[a:b])


@pytest.mark.parametrize("kind", probe_cases.COLS_WALK_KINDS)
def test_hashed128_walk_cases_equal_jax(kind):
    """Hand-made hashed128 tables for the kernel's walk over 8-slot blocks of
    hi' (probe_cases.cols_walk_case: homes in a block's last lanes, a walk
    across a row, free lanes before the home slot, runs of equal hi' across
    a block, the all-ones scramble with and without its key, homes in the
    table's last rows): the table equals the JAX builder's, the twin the JAX
    lookup and lookup_taxa, and the kernel's walk modelled query by query
    (probe_cases.cols_walk) the twin, at tolerance 0."""
    rng = np.random.default_rng(len(kind))
    keys, taxa, q = probe_cases.cols_walk_case(rng, kind)
    table = _hashed_equal_jax(keys, taxa, True, bits=probe_cases.COLS_BITS)
    assert (table.tile, table.bits) == (lookup.HASHED_COLS_TILE, probe_cases.COLS_BITS)
    answer = _hashed_twin_equal_jax(table, keys, taxa, q)
    assert np.array_equal(probe_cases.cols_walk(table, q), answer.numpy())
    assert bool((answer[:len(keys)] > 0).all())
    scrambled, _, pos, _, _ = lookup._parked(*_torch(keys, taxa), table.tile, table.bits, 0)
    homes = lookup._top_bits(scrambled, table.bits)
    design = homes >= 2048  # the _low_half keys' homes lie below
    if kind in ("block end", "row crossing", "equal hi' runs"):  # a key parked a block (a row) past its home's
        crosses = design & (pos // 8 > homes // 8)
        assert bool(crosses.any()) and (kind != "row crossing" or bool((design & (pos // 128 > homes // 128)).any()))
    if kind == "free before home":  # lanes 3 to 7 of a block, every lane before it free
        lanes = sorted(int(p) % 8 for p in pos[design])
        assert lanes == [3, 4, 5, 6, 7] and bool((pos[design] == homes[design]).all())
    if kind.startswith("all-ones scramble"):
        at_key = q == np.int64(probe_cases.ALL_ONES_KEY)
        held = np.uint64(probe_cases.ALL_ONES_KEY) in keys
        assert held == (kind == "all-ones scramble") and bool(at_key.any())
        assert bool((answer.numpy()[at_key] == (taxa[list(keys).index(np.uint64(probe_cases.ALL_ONES_KEY))]
                                                if held else 0)).all())
    if kind == "table end":  # queries whose walk the table's end cuts short
        qh = lookup._top_bits(lookup.xorshift64(torch.from_numpy(q)), table.bits)
        assert int(((qh > table.slots - table.tile) & (qh < table.slots) & (torch.from_numpy(q) >= 0)).sum()) > 10


def test_hashed128_kernel_refuses_a_tile_not_a_multiple_of_8():
    """The hashed128 kernel reads 8 lanes of hi' at a time: every tile that
    build_hashed_cols makes from its default (128, doubled as the keys need)
    is a multiple of 8, and its wrapper and the floor's refuse any other
    with ValueError, before they look for a card."""
    rng = np.random.default_rng(3)
    keys, taxa = probe_cases.hashed_keys(rng, "random", lookup.HASHED_COLS_TILE)
    grown = lookup.build_hashed_cols(*_torch(keys, taxa), bits=9)
    assert grown.tile > lookup.HASHED_COLS_TILE and grown.tile % 8 == 0
    odd = lookup.build_hashed_cols(*_torch(keys, taxa), tile=12)
    assert odd.tile % 8
    q = torch.from_numpy(probe_cases.hashed_queries(rng, keys))
    for fn in (cuda_kernels.lookup_taxa_hashed_cuda, cuda_kernels.hashed_floor_cuda):
        with pytest.raises(ValueError, match="multiple of 8"):
            fn(odd, q)
        with pytest.raises(ValueError, match="CUDA tensor"):
            fn(grown, q)
    assert torch.equal(lookup.probe(None, None, odd, q), lookup.lookup_taxa(*_torch(keys, taxa), q))


@pytest.mark.parametrize("kind", [*KINDS, "random", "empty"])
def test_bucketed_arrays_and_twin_equal_jax(world, kind):
    """The router equals the JAX index's device_router (build_router at
    min(adaptive_router_bits(N), key_bits)), the keys and taxa
    pad_keys_for_buckets's; the twin the JAX lookup and lookup_taxa."""
    rng = np.random.default_rng(len(kind))
    if kind in KINDS:
        keys, taxa, key_bits = _records(world, kind)
    else:
        keys, taxa = probe_cases.hashed_keys(rng, kind, lookup.HASHED_TILE)
        key_bits = 62
    got = lookup.build_bucketed(*_torch(keys, taxa), key_bits)
    bits = min(jlookup.adaptive_router_bits(len(keys)), key_bits)
    router = jlookup.build_router(keys, bits, key_bits)
    maxb = jlookup.max_bucket_span(router)
    pad_keys, pad_taxa = jlookup.pad_keys_for_buckets(keys, taxa, maxb)
    assert (got.bits, got.maxb, got.key_bits, got.n) == (bits, maxb, key_bits, len(keys))
    assert np.array_equal(got.router.numpy(), router)
    assert np.array_equal(got.keys.numpy().view(np.uint64), pad_keys) and np.array_equal(got.taxa.numpy(), pad_taxa)
    k = keys.view(np.int64)
    q = np.concatenate([k, k + 1, np.maximum(k - 1, 0), rng.integers(0, 1 << key_bits, 1000), [-1, -5, 0]])
    answer = lookup.lookup_taxa_bucketed(got, torch.from_numpy(q))
    assert torch.equal(answer, lookup.lookup_taxa(*_torch(keys, taxa), torch.from_numpy(q)))
    want = jlookup.lookup_taxa_bucketed(jlookup.keys_from_numpy(pad_keys), jnp.asarray(pad_taxa), jnp.asarray(router),
                                        _jax_u64(q), maxb, bits, key_bits)
    assert np.array_equal(np.asarray(want), answer.numpy())
    assert bool((answer[:len(keys)] > 0).all())
    if kind == "rank table":
        assert bits < key_bits == 26


@pytest.mark.parametrize("cols", [False, True], ids=["hashed", "hashed128"])
def test_hashed_build_that_does_not_converge_raises(cols):
    """Two slots for 9,000 keys: a displacement beyond MAX_TILE - 1."""
    rng = np.random.default_rng(9)
    keys = np.unique(rng.integers(0, 1 << 62, 9000)).astype(np.uint64)
    taxa = np.ones(len(keys), np.int32)
    with pytest.raises(ValueError, match="did not converge"):
        (jlookup.build_hashed_cols if cols else jlookup.build_hashed)(keys, taxa, 62, bits=1)
    with pytest.raises(ValueError, match="did not converge"):
        (lookup.build_hashed_cols if cols else lookup.build_hashed)(*_torch(keys, taxa), bits=1)


@pytest.mark.parametrize("probe", PROBES)
@pytest.mark.parametrize("kind", KINDS)
def test_classify_cli_probe(world, routed, tmp_path, kind, probe):
    """classify --probe P on one device: the port == its routed run ==
    slacken_tpu's CLI with --probe P (per-read lines and kreports)."""
    common = ["classify", str(world / "reads.fastq"), "-c", "0.0", "0.15", "-i", str(world / f"{kind}1"),
              "--probe", probe]
    want = routed[kind]
    assert len(want) == 4 and want[os.path.join("o_c0.00", "all_kreport.txt")].count(b"\n") > 3
    assert run(cli.main, tmp_path / "port", *common, *CPU) == want
    assert run(jcli.main, tmp_path / "jax", *common) == want


@pytest.mark.parametrize("probe", PROBES)
def test_classify2_cli_probe(world, routed2, tmp_path, probe):
    """classify2 --probe P (step 1's span hits and the final classify
    through the table): the port == its routed run == slacken_tpu's
    classify2 --probe P."""
    common, want = classify2_args(world), routed2
    assert len(want["o_taxonSet.txt"].split()) == 2 and len(want) == 3
    assert run(cli.main, tmp_path / "port", *common, "--probe", probe, *CPU) == want
    assert run(jcli.main, tmp_path / "jax", *common, "--probe", probe) == want


@pytest.mark.parametrize("layout", ["ring", "replicated"])
def test_hashed_over_the_mesh(world, routed, tmp_path, layout):
    """classify --devices 8 --layout L --probe hashed from the 8 shard
    files: a hashed table a shard (its own geometry, ring) or a device
    (replicated); the routed single-device files, and slacken_tpu's mesh run."""
    common = ["classify", str(world / "reads.fastq"), "-c", "0.0", "0.15", "-i", str(world / "narrow8"),
              "--devices", "8", "--layout", layout, "--probe", "hashed"]
    assert run(cli.main, tmp_path / "port", *common, *CPU) == routed["narrow"]
    assert run(jcli.main, tmp_path / "jax", *common) == routed["narrow"]
    cls = MeshClassifier(KeyValueIndex.load(str(world / "narrow8")), Mesh([torch.device("cpu")] * 8), layout,
                         probe="hashed")
    assert cls.mesh_probe == "hashed" and all(isinstance(a[2], lookup.HashedTable) for a in cls._arrays)
    held = [int((a[2].table[..., 2] != -1).sum()) for a in cls._arrays]  # occupied slots: a taxon lane not -1
    assert sum(held) == cls.index.num_records if layout == "ring" else set(held) == {cls.index.num_records}


@pytest.mark.parametrize("probe", ["hashed128", "bucketed"])
@pytest.mark.parametrize("layout", ["ring", "replicated"])
def test_mesh_runs_routed_for_hashed128_and_bucketed(world, routed, tmp_path, layout, probe):
    """Over a mesh, hashed128 and bucketed run the routed probe (a directory
    a shard or a device), as slacken_tpu's MeshClassifier does; the routed
    single-device files."""
    idx = KeyValueIndex.load(str(world / "narrow8"))
    cls = MeshClassifier(idx, Mesh([torch.device("cpu")] * 8), layout, probe=probe)
    assert cls.probe == probe and cls.mesh_probe == "routed"
    assert all(isinstance(a[2], lookup.Directory) for a in cls._arrays)
    common = ["classify", str(world / "reads.fastq"), "-c", "0.0", "0.15", "-i", str(world / "narrow8"),
              "--devices", "8", "--layout", layout, "--probe", probe]
    assert run(cli.main, tmp_path / "port", *common, *CPU) == routed["narrow"]


def _shards_with_an_empty_first(world, loc):
    """The narrow index in 2 shard files, the first of no keys."""
    idx = KeyValueIndex.load(str(world / "narrow1"))
    idx.save_sharded(str(loc), 2)
    with open(loc / "params.json") as f:
        meta = json.load(f)
    meta["shards"] = [0, idx.num_records]
    with open(loc / "params.json", "w") as f:
        json.dump(meta, f, indent=2)
    np.save(loc / "keys.00000.npy", idx.keys[:0])
    np.save(loc / "taxa.00000.npy", idx.taxa[:0])
    np.save(loc / "keys.00001.npy", idx.keys)
    np.save(loc / "taxa.00001.npy", idx.taxa)
    return idx


@pytest.mark.parametrize("how", ["mh_probe", "STPU_MH_PROBE"])
def test_multihost_ring_with_the_hashed_probe(world, tmp_path, monkeypatch, how):
    """MultiHostRingClassifier with mh_probe="hashed" (or STPU_MH_PROBE)
    over 2 CPU entries: each entry its own hashed table, the empty key
    range's of 3 free rows; the single-device routed files."""
    idx = _shards_with_an_empty_first(world, tmp_path / "idx2")
    if how == "STPU_MH_PROBE":
        monkeypatch.setenv("STPU_MH_PROBE", "hashed")
    ctx = multihost.initialize(device="cpu", devices=2)
    cls = multihost.MultiHostRingClassifier(str(tmp_path / "idx2"), ctx,
                                            mh_probe="hashed" if how == "mh_probe" else None)
    empty, full = (a[2] for a in cls._arrays)
    assert cls.probe == "hashed" and isinstance(empty, lookup.HashedTable) and isinstance(full, lookup.HashedTable)
    assert tuple(empty.table.shape) == (3, 16, 3) and bool((empty.table == -1).all())
    assert torch.equal(full.table, lookup.build_hashed(idx.keys_t, idx.taxa_t).table)
    cpar = ClassifyParams(thresholds=[0.0, 0.15], per_read_output=True)
    packed = list(inputs.packed_reads_from_file(str(world / "reads.fastq")))
    cls.set_lockstep(sum(len(p) for p in packed), 64, 128)
    got = cls.classify_packed(iter(packed), cpar)
    assert got == Classifier(idx, "cpu").classify_packed(iter(packed), cpar)
    assert sum(r.classified for r in got[0.0]) > 60
