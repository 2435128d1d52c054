"""The port's device mesh on the CPU (parallel/mesh.py, parallel/classifier.py):
MeshClassifier over [cpu] * 8 and over 3 shards (rows and key ranges split
unevenly), replicated and ring, for a narrow (35, 31, 7), a wide (40, 35, 3)
and a rank-table (21, 11, 2, lexicographic) index, in reports and per-read
mode, held at tolerance 0 to the port's single-device Classifier and to
slacken_tpu's MeshClassifier(idx, 8, layout); the ring against a probe of the
whole index on a repeated device; empty shards; two-step classification
over the mesh; make_mesh's refusal of more cards than exist."""

import os

import numpy as np
import pytest
import torch

import slacken_tpu_torch.parallel.mesh as pmesh
from slacken_tpu.classify import ClassifyParams as JClassifyParams
from slacken_tpu.classify import Fragment as JFragment
from slacken_tpu.index import IndexParams as JParams
from slacken_tpu.index import KeyValueIndex as JIndex
from slacken_tpu.parallel.classifier import MeshClassifier as JMeshClassifier
from slacken_tpu_torch import dynamic, native
from slacken_tpu_torch.classify import Classifier, ClassifyParams, Fragment
from slacken_tpu_torch.index import IndexParams, KeyValueIndex
from slacken_tpu_torch.ops import encode
from slacken_tpu_torch.ops.lookup import lookup_taxa
from slacken_tpu_torch.ops.lookup import probe as probe_fn
from slacken_tpu_torch.parallel.classifier import MeshClassifier, make_classifier
from slacken_tpu_torch.parallel.mesh import Mesh, make_mesh
from test_dynamic import FakeLibrary
from test_torch_index import shared_library
from test_taxonomy import random_taxonomy

torch.set_num_threads(1)

KINDS = {
    "narrow": dict(k=35, m=31, spaces=7),
    "wide": dict(k=40, m=35, spaces=3),
    "lexicographic": dict(k=21, m=11, spaces=2, ordering="lexicographic"),
}
MODES = {"reports": False, "per_read": True}
SHARDS = {"8": 8, "3": 3}


class World:
    """A taxonomy, a library of mutated copies of one genome (most
    minimizers shared, so LCAs above the leaves), 90 single reads (every
    fifth with an N run, every seventh shorter than k) and 30 pairs."""

    def __init__(self):
        rng = np.random.default_rng(20261017)
        self.tax = random_taxonomy(rng)
        self.genomes = shared_library(rng, self.tax, n=6, length=2500)
        self.reads = []
        for i in range(90):
            _, seq = self.genomes[i % 6]
            n = 15 if i % 7 == 0 else int(rng.integers(40, 151))
            s = int(rng.integers(0, len(seq) - n))
            read = seq[s : s + n]
            if i % 5 == 0:
                read = read[:20] + "N" * 10 + read[30:]
            self.reads.append((f"r{i}", read))
        self.pairs = []
        for i in range(30):
            _, seq = self.genomes[i % 6]
            s = int(rng.integers(0, len(seq) - 300))
            self.pairs.append((f"p{i}", seq[s : s + 100], seq[s + 180 : s + 280]))
        self._indexes = {}

    def frags(self, cls):
        return [cls(*r) for r in self.reads] + [cls(*p) for p in self.pairs]

    def index(self, kind):
        """The port's index of one kind (the earlier slices hold it equal
        to slacken_tpu's)."""
        if kind not in self._indexes:
            self._indexes[kind] = KeyValueIndex.build(iter(self.genomes), IndexParams(**KINDS[kind]), self.tax, "cpu")
        return self._indexes[kind]

    def packed(self):
        """The single reads as native.PackedReads chunks of two widths."""
        seqs = [encode.encode_seq(s) for _, s in self.reads]
        titles = [t for t, _ in self.reads]
        out = []
        for lo, hi, width in ((0, 60, 128), (60, 90, 256)):
            codes, lens = encode.pack_batch(seqs[lo:hi], width)
            out.append(native.PackedReads(codes, lens, titles[lo:hi]))
        return out


@pytest.fixture(scope="module")
def world():
    return World()


def tree(prefix):
    """{path below <prefix>_c*: bytes} of a classify_and_write_packed output."""
    import gzip

    base = os.path.dirname(prefix)
    files = {}
    for root, _, names in os.walk(base):
        for name in names:
            path = os.path.join(root, name)
            with (gzip.open if name.endswith(".gz") else open)(path, "rb") as f:
                files[os.path.relpath(path, base)] = f.read()
    return files


def cpar_of(mode):
    return ClassifyParams(thresholds=[0.0, 0.15], per_read_output=MODES[mode])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("layout", ["replicated", "ring"])
@pytest.mark.parametrize("kind", KINDS)
def test_mesh_equals_single_device(world, tmp_path, kind, layout, shards, mode):
    idx = world.index(kind)
    cpar = cpar_of(mode)
    single = Classifier(idx, "cpu")
    mesh = MeshClassifier(idx, ["cpu"] * SHARDS[shards], layout)
    want = single.classify(world.frags(Fragment), cpar)
    got = mesh.classify(world.frags(Fragment), cpar)
    assert got == want
    assert sum(r.classified for r in want[0.0]) > 60
    single.classify_and_write_packed(world.packed(), str(tmp_path / "one" / "o"), cpar)
    mesh.classify_and_write_packed(world.packed(), str(tmp_path / "mesh" / "o"), cpar)
    files = tree(str(tmp_path / "one" / "o"))
    assert tree(str(tmp_path / "mesh" / "o")) == files
    assert len(files) == (4 if MODES[mode] else 2)


def _same_reads(jreads, reads):
    assert [(r.sample_id, r.classified, r.title, r.taxon, r.length_string, r.hit_details) for r in jreads] == [
        (r.sample_id, r.classified, r.title, r.taxon, r.length_string, r.hit_details) for r in reads]


@pytest.mark.parametrize("layout", ["replicated", "ring"])
@pytest.mark.parametrize("kind", KINDS)
def test_mesh_equals_the_jax_mesh(world, kind, layout):
    """slacken_tpu's MeshClassifier over 8 virtual CPU devices against the
    port's over [cpu] * 8, per-read mode (reports follow from it)."""
    idx = world.index(kind)
    jidx = JIndex(idx.keys, idx.taxa, JParams(**KINDS[kind]), world.tax)
    jidx.ordering_lut = idx.ordering_lut
    jcpar = JClassifyParams(thresholds=[0.0, 0.15], per_read_output=True)
    want = JMeshClassifier(jidx, 8, layout).classify(world.frags(JFragment), jcpar)
    got = MeshClassifier(idx, ["cpu"] * 8, layout).classify(world.frags(Fragment), cpar_of("per_read"))
    for t in (0.0, 0.15):
        _same_reads(want[t], got[t])


@pytest.mark.parametrize("kind", ["narrow", "wide"])
def test_ring_lookup_on_a_repeated_device(world, kind):
    """ring_lookup over [cpu] * 8 answers each query from the one shard that
    holds its key, and leaves its inputs as they were: queries from every
    shard's keys, keys beside them and invalid windows (-1), spread so that
    each device's queries hit every shard."""
    idx = world.index(kind)
    mesh = Mesh(["cpu"] * 8)
    shards = pmesh.shard_index(idx, mesh)
    assert sum(s[0].shape[0] for s in shards) == idx.num_records
    rng = np.random.default_rng(5)
    keys = idx.keys_t
    pick = keys[torch.from_numpy(rng.integers(0, idx.num_records, 800))]
    off = pick + 1 if kind == "narrow" else torch.stack([pick[:, 0], pick[:, 1] + 1], 1)
    q = torch.cat([pick, off, torch.full_like(pick[:50], -1)])
    q = q[torch.from_numpy(rng.permutation(q.shape[0]))]
    queries = list(torch.tensor_split(q, 8))
    before = [x.clone() for x in queries]
    got = torch.cat(pmesh.ring_lookup(mesh, shards, queries))
    assert torch.equal(got, lookup_taxa(keys, idx.taxa_t, q))
    assert (got > 0).sum() >= 800
    assert all(torch.equal(a, b) for a, b in zip(queries, before))


@pytest.mark.parametrize("probe", ["routed", "tiled", "hashed1", "hashed", "bucketed"])
def test_ring_shards_are_their_key_ranges_probe_arrays(world, probe):
    """shard_index over [cpu] * 4: each shard answers every query as the
    plain lookup of its own key range does, and is what
    KeyValueIndex.device_arrays makes of that range; an index on the CPU
    keeps its keys and its device (nothing is handed over)."""
    idx = world.index("narrow")
    keys, taxa = idx.keys_t, idx.taxa_t
    shards = pmesh.shard_index(idx, Mesh(["cpu"] * 4), probe)
    assert idx.keys_t is keys and idx.home is None and idx.device == torch.device("cpu")
    q = torch.cat([keys, keys + 1, torch.full((5,), -1, dtype=torch.int64)])
    bounds = np.linspace(0, idx.num_records, 5).astype(np.int64)
    for (a, b), shard in zip(zip(bounds[:-1], bounds[1:]), shards):
        want = lookup_taxa(keys[a:b], taxa[a:b], q)
        assert torch.equal(probe_fn(*shard, q), want)
        part = idx.with_records(keys[a:b], taxa[a:b]).device_arrays("cpu", probe)
        assert torch.equal(probe_fn(*part, q), want) and type(part[2]) is type(shard[2])
        assert int((want[:idx.num_records] > 0).sum()) == b - a  # each key of the range, and only those


@pytest.mark.parametrize("layout", ["replicated", "ring"])
def test_more_shards_than_keys(world, layout):
    """An index of 3 keys over 8 shards: five shards are empty."""
    idx = world.index("narrow")
    small = idx.with_records(idx.keys_t[1000:1003].clone(), idx.taxa_t[1000:1003].clone())
    cpar = cpar_of("per_read")
    want = Classifier(small, "cpu").classify(world.frags(Fragment), cpar)
    assert MeshClassifier(small, ["cpu"] * 8, layout).classify(world.frags(Fragment), cpar) == want
    if layout == "ring":
        assert [s[0].shape[0] for s in pmesh.shard_index(small, Mesh(["cpu"] * 8))].count(0) == 5


@pytest.mark.parametrize("records", [True, False], ids=["sidecar", "rebuild"])
@pytest.mark.parametrize("criterion", ["reads", "distinct"])
@pytest.mark.parametrize("layout", ["replicated", "ring"])
def test_dynamic_over_the_mesh(world, tmp_path, layout, criterion, records):
    """Two-step classification with devices=Mesh([cpu] * 8): the taxon set,
    kreports and per-read files of the single-device run; without a sidecar
    the dynamic index comes from build_distributed."""
    tax = world.tax
    base = KeyValueIndex.build(iter(world.genomes), IndexParams(**KINDS["narrow"]), tax, "cpu",
                               keep_records=records)
    lib = FakeLibrary(world.genomes)
    crit = dynamic.ClassifiedReadCount(3, 0.0) if criterion == "reads" else dynamic.MinimizerDistinctCount(20)
    cpar = ClassifyParams(thresholds=[0.0], per_read_output=True)
    frags = world.frags(Fragment)
    made = {}
    for where, devices in (("one", None), ("mesh", Mesh(["cpu"] * 8))):
        d = dynamic.Dynamic(base, lib, 1, crit, cpar, None, str(tmp_path / where / "dyn"), "cpu",
                            devices=devices, layout=layout if devices else None)
        made[where] = d.two_step_classify_and_write(frags)
    assert tree(str(tmp_path / "mesh" / "dyn")) == tree(str(tmp_path / "one" / "dyn"))
    assert torch.equal(made["mesh"].keys_t, made["one"].keys_t)
    assert torch.equal(made["mesh"].taxa_t, made["one"].taxa_t)
    assert len(open(tmp_path / "one" / "dyn_taxonSet.txt").read().split()) >= 2


def test_make_mesh(monkeypatch):
    assert list(make_mesh(8, "cpu")) == [torch.device("cpu")] * 8
    assert len(make_mesh(None, "cpu")) == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert list(make_mesh(2, "cuda")) == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert len(make_mesh(None, "cuda")) == 2
    with pytest.raises(ValueError, match="3-device mesh but the machine has 2"):
        make_mesh(3, "cuda")
    with pytest.raises(ValueError):
        make_mesh(0, "cpu")


def test_make_classifier_and_layouts(world):
    idx = world.index("narrow")
    assert type(make_classifier(idx, "cpu")) is Classifier
    assert type(make_classifier(idx, "cpu", 1)) is Classifier
    ring = make_classifier(idx, "cpu", 1, "ring")
    assert isinstance(ring, MeshClassifier) and ring.layout == "ring" and len(ring.mesh) == 1
    rep = make_classifier(idx, "cpu", 4)
    assert isinstance(rep, MeshClassifier) and rep.layout == "replicated" and len(rep.mesh) == 4
    with pytest.raises(ValueError, match="layout"):
        MeshClassifier(idx, ["cpu"] * 2, "tiled")
