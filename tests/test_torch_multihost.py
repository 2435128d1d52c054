"""The port's multi-process classify (parallel/multihost.py) in one process
on the CPU: the shard ownership, the loaders and the collectives of a world
of one (with no group, and with a group of one over gloo), and
MultiHostRingClassifier over a local mesh of 2 CPU entries held at
tolerance 0 to slacken_tpu's MultiHostRingClassifier (its global mesh: the
8 virtual CPU devices of conftest) for a narrow, a wide (50, 45, 7) and a
signature (35, 13, 3) index that the JAX package built and saved in 8 shard
files, with the routed probe and with mh_probe hashed1 or tiled; the lockstep (all-padding batches, refusals) and the CLI's refusals.
Several processes: test_torch_multihost_procs.py."""

import os

import numpy as np
import pytest
import torch

from slacken_tpu import native as jnative
from slacken_tpu.classify import ClassifyParams as JClassifyParams
from slacken_tpu.index import IndexParams as JParams
from slacken_tpu.index import KeyValueIndex as JIndex
from slacken_tpu.parallel import multihost as jmultihost
from slacken_tpu_torch import cli, native
from slacken_tpu_torch.classify import Classifier, ClassifyParams
from slacken_tpu_torch.index import KeyValueIndex
from slacken_tpu_torch.ops import encode, lookup
from slacken_tpu_torch.parallel import multihost
from slacken_tpu_torch.parallel.mesh import Mesh
from test_taxonomy import random_taxonomy
from test_torch_index import shared_library
from test_torch_mesh_classify import tree

torch.set_num_threads(1)

KINDS = {
    "narrow": dict(k=35, m=31, spaces=7),
    "wide": dict(k=50, m=45, spaces=7),
    "signature": dict(k=35, m=13, spaces=3, ordering="signature"),
}


class World:
    """A library of mutated copies of one genome, 21 reads of 101 bp (the
    JAX package's multi-host tests' shape) in one 128-wide chunk, and per
    kind the JAX package's index saved in 8 shard files."""

    def __init__(self, base):
        rng = np.random.default_rng(20261021)
        self.base = base
        self.tax = random_taxonomy(rng)
        self.genomes = shared_library(rng, self.tax, n=4, length=900)
        self.reads = []
        for i in range(21):
            _, g = self.genomes[i % 4]
            s = int(rng.integers(0, len(g) - 101))
            self.reads.append(g[s : s + 101])
        self.codes, _ = encode.pack_batch([encode.encode_seq(r) for r in self.reads], 128)
        self.titles = [f"r{i}" for i in range(21)]
        self._locs = {}

    def packed(self, jax=False):
        mod = jnative if jax else native
        return mod.PackedReads(self.codes.copy(), np.full(21, 101, np.int32), list(self.titles))

    def location(self, kind):
        if kind not in self._locs:
            loc = os.path.join(self.base, f"idx_{kind}")
            JIndex.build(iter(self.genomes), JParams(**KINDS[kind]), self.tax).save_sharded(loc, n_shards=8)
            self._locs[kind] = loc
        return self._locs[kind]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return World(str(tmp_path_factory.mktemp("multihost")))


def cpu_ctx(devices=2):
    return multihost.initialize(device="cpu", devices=devices)


def fields(reads):
    return [(r.sample_id, r.classified, r.title, r.taxon, r.length_string, r.hit_details) for r in reads]


def test_one_process_context():
    ctx = multihost.initialize(device="cpu")
    assert (ctx.process_index, ctx.process_count, ctx.local_device_count, ctx.global_device_count) == (0, 1, 1, 1)
    assert not ctx.is_distributed and ctx.backend is None and list(ctx.mesh) == [torch.device("cpu")]
    assert not torch.distributed.is_initialized()
    ctx = cpu_ctx(3)
    assert ctx.local_device_count == ctx.global_device_count == 3
    assert list(multihost.initialize(devices=Mesh(["cpu"] * 2)).mesh) == [torch.device("cpu")] * 2


@pytest.mark.parametrize("processes", [1, 2, 3, 8])
def test_host_shard_ids_tile_the_shards(processes):
    owned = []
    for p in range(processes):
        ctx = multihost.HostContext(p, processes, 1, processes, Mesh(["cpu"]))
        owned += multihost.host_shard_ids(10, ctx)
    assert owned == list(range(10))


def test_load_index_for_host_is_the_whole_index(world):
    loc = world.location("narrow")
    jidx = JIndex.load(loc)
    got = multihost.load_index_for_host(loc, cpu_ctx())
    assert np.array_equal(got.keys, jidx.keys) and np.array_equal(got.taxa, jidx.taxa)
    two = [multihost.load_index_for_host(loc, multihost.HostContext(p, 2, 1, 2, Mesh(["cpu"]))) for p in range(2)]
    assert np.array_equal(np.concatenate([x.keys for x in two]), jidx.keys)
    assert all(x.num_records > 0 for x in two)


def test_collectives_of_one_process(tmp_path):
    """Without a group the inputs come back; with a group of one (gloo,
    file:// rendezvous) the same, and shutdown leaves no group."""
    counts = np.arange(10)
    assert np.array_equal(multihost.report_counts_across_hosts(counts), counts)
    assert np.array_equal(jmultihost.report_counts_across_hosts(counts), counts)
    assert multihost.allgather_objects({"a": 1}) == jmultihost.allgather_objects({"a": 1}) == [{"a": 1}]
    ctx = multihost.initialize(f"file://{tmp_path}/rdzv", 1, 0, "cpu", 2)
    try:
        assert torch.distributed.is_initialized() and ctx.backend == "gloo"
        assert (ctx.process_count, ctx.global_device_count) == (1, 2) and not ctx.is_distributed
        assert np.array_equal(multihost.report_counts_across_hosts(counts), counts)
        assert multihost.allgather_objects(("x", 2)) == [("x", 2)]
        assert multihost.initialize(device="cpu").process_count == 1  # the group exists: no second one
    finally:
        multihost.shutdown()
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("kind", KINDS)
def test_world_of_one_equals_the_jax_classifier(world, kind):
    """MultiHostRingClassifier over 2 CPU entries (4 shard files each) and
    slacken_tpu's over its 8 devices, classify_packed after
    set_lockstep(21, 16, 128), per-read mode at two thresholds; both equal
    the port's single-device classify."""
    loc = world.location(kind)
    cpar = ClassifyParams(thresholds=[0.0, 0.1], per_read_output=True)
    cls = multihost.MultiHostRingClassifier(loc, cpu_ctx())
    assert [s[0].shape[0] for s in cls._arrays] == [
        sum(np.load(os.path.join(loc, f"taxa.{i:05d}.npy")).shape[0] for i in range(j * 4, j * 4 + 4)) for j in (0, 1)]
    cls.set_lockstep(21, 16, 128)
    got = cls.classify_packed(iter([world.packed()]), cpar)
    assert cls.lockstep == (2, 16, 128) and cls.dispatches == 2 and cls.padding_dispatches == 0
    single = Classifier(KeyValueIndex.load(loc), "cpu").classify_packed(iter([world.packed()]), cpar)
    assert got == single
    assert sum(r.classified for r in got[0.0]) >= 15
    jcls = jmultihost.MultiHostRingClassifier(loc)
    jcls.set_lockstep(21, 16, 128)
    want = jcls.classify_packed(iter([world.packed(jax=True)]), JClassifyParams(thresholds=[0.0, 0.1],
                                                                                  per_read_output=True))
    for t in (0.0, 0.1):
        assert fields(want[t]) == fields(got[t])


@pytest.mark.parametrize("kind,probe", [("narrow", "hashed1"), ("wide", "hashed1"), ("signature", "tiled")])
def test_world_of_one_with_a_table_probe(world, kind, probe):
    """mh_probe="hashed1" (and "tiled"): each of the 2 CPU entries probes
    its own shards' table; the routed single-device classify, and
    slacken_tpu's MultiHostRingClassifier with the same mh_probe."""
    loc = world.location(kind)
    cpar = ClassifyParams(thresholds=[0.0, 0.1], per_read_output=True)
    cls = multihost.MultiHostRingClassifier(loc, cpu_ctx(), mh_probe=probe)
    table = {"tiled": lookup.TiledTable, "hashed1": lookup.HashedRows}[probe]
    assert cls.probe == probe and all(isinstance(a[2], table) for a in cls._arrays)
    cls.set_lockstep(21, 16, 128)
    got = cls.classify_packed(iter([world.packed()]), cpar)
    assert got == Classifier(KeyValueIndex.load(loc), "cpu").classify_packed(iter([world.packed()]), cpar)
    jcls = jmultihost.MultiHostRingClassifier(loc, mh_probe=probe)
    jcls.set_lockstep(21, 16, 128)
    want = jcls.classify_packed(iter([world.packed(jax=True)]), JClassifyParams(thresholds=[0.0, 0.1],
                                                                                  per_read_output=True))
    for t in (0.0, 0.1):
        assert fields(want[t]) == fields(got[t])


@pytest.mark.parametrize("mode", ["reports", "per_read"])
def test_padding_batches_and_part_files(world, tmp_path, mode):
    """A lockstep for a larger share than the stream holds: the batches
    beyond it are all padding and change nothing; part files carry the
    process's number, and classify_and_write_stream in a world of one
    writes the single-device files."""
    loc = world.location("narrow")
    cpar = ClassifyParams(thresholds=[0.0, 0.15], per_read_output=mode == "per_read")
    cls = multihost.MultiHostRingClassifier(loc, cpu_ctx())
    cls.set_lockstep(50, 7, 100)
    assert cls.lockstep == (7, 8, 128)  # rows to a multiple of the local mesh, the width to a power of two
    cls.classify_and_write_packed(iter([world.packed()]), str(tmp_path / "pad" / "o"), cpar)
    assert (cls.dispatches, cls.padding_dispatches) == (7, 4)
    Classifier(KeyValueIndex.load(loc), "cpu").classify_and_write_packed(iter([world.packed()]),
                                                                         str(tmp_path / "one" / "o"), cpar)
    want = tree(str(tmp_path / "one" / "o"))
    assert tree(str(tmp_path / "pad" / "o")) == want and len(want) == (4 if mode == "per_read" else 2)
    cls._part_index = 3
    cls.classify_and_write_stream(lambda: iter([world.packed()]), str(tmp_path / "s" / "o"), cpar, rows=6)
    assert cls.lockstep == (4, 6, 128) and cls.padding_dispatches == 0
    got = tree(str(tmp_path / "s" / "o"))
    assert {k.replace("part-00003", "part-00000"): v for k, v in got.items()} == want
    assert all("part-00003" in k for k in got if "part-" in k)
    # without rows, the single-device batch for the bucket (1 Mbp on the CPU), whatever ran before
    cls.classify_and_write_stream(lambda: iter([world.packed()]), str(tmp_path / "d" / "o"), cpar)
    assert cls.lockstep == (1, (1 << 20) // 128, 128)
    assert tree(str(tmp_path / "d" / "o")) == got


def test_lockstep_refusals(world, tmp_path):
    loc = world.location("narrow")
    cpar = ClassifyParams(per_read_output=False)
    cls = multihost.MultiHostRingClassifier(loc, cpu_ctx())
    with pytest.raises(RuntimeError, match="set_lockstep"):
        list(cls.packed_batches(iter([world.packed()])))
    cls.set_lockstep(21, 16, 100)
    wide = world.packed()
    wide.codes = np.pad(wide.codes, ((0, 0), (0, 128)), constant_values=encode.INVALID)
    with pytest.raises(ValueError, match="exceeds the lockstep bucket"):
        cls.classify_packed(iter([wide]), cpar)
    cls.set_lockstep(10, 16, 128)
    with pytest.raises(RuntimeError, match="more than the 1 batches"):
        cls.classify_packed(iter([world.packed()]), cpar)
    with pytest.raises(NotImplementedError):
        cls.classify_and_write([], str(tmp_path / "o"), cpar)
    with pytest.raises(ValueError, match="8 shard files not divisible by 3 devices"):
        multihost.MultiHostRingClassifier(loc, cpu_ctx(3))


def test_cli_refusals(world, tmp_path):
    """--paired and --layout replicated exit as slacken_tpu's multi-host
    classify does, before any process group is made."""
    fq = str(tmp_path / "r.fastq")
    with open(fq, "w") as f:
        f.writelines(f"@{t}\n{s}\n+\n{'I' * len(s)}\n" for t, s in zip(world.titles, world.reads))
    common = ["classify", fq, fq, "-i", world.location("narrow"), "-o", str(tmp_path / "o"), "--device", "cpu",
              "--coordinator", "127.0.0.1:1", "--num-processes", "2", "--process-id", "0"]
    with pytest.raises(SystemExit, match="does not support --paired"):
        cli.main([*common, "-p"])
    with pytest.raises(SystemExit, match="does not support --layout replicated"):
        cli.main([*common, "--layout", "replicated"])
    assert not torch.distributed.is_initialized()
