"""Two-step classification of the port against slacken_tpu's on the CPU,
same inputs from a numpy seed, tolerance 0 (integers, text and bytes): the
span hits, the per-taxon counts, the detected taxon set with its file and
its printed lines, the gold set, the dynamic index (from the sidecar and
from the library), the classification it gives, and both CLIs' classify2.
Base indexes: narrow (35, 31, 7), wide (40, 35, 3) and a rank table
(21, 11, 2, lexicographic)."""

import glob
import gzip
import os
from collections import Counter

import numpy as np
import pytest
import torch

import slacken_tpu.dynamic as jdynamic
from slacken_tpu import cli as jcli
from slacken_tpu import native as jnative
from slacken_tpu.classify import ClassifyParams as JClassifyParams
from slacken_tpu.classify import Fragment as JFragment
from slacken_tpu.index import IndexParams as JParams
from slacken_tpu.index import KeyValueIndex as JIndex
from slacken_tpu_torch import cli, dynamic, native
from slacken_tpu_torch.classify import ClassifyParams, Fragment
from slacken_tpu_torch.index import IndexParams, KeyValueIndex
from slacken_tpu_torch.ops import encode
from test_dynamic import FakeLibrary
from test_index import random_genome
from test_inputs_cli import write_fasta, write_fastq
from test_taxonomy import random_taxonomy

torch.set_num_threads(1)

KINDS = {
    "narrow": dict(k=35, m=31, spaces=7),
    "wide": dict(k=40, m=35, spaces=3),
    "lexicographic": dict(k=21, m=11, spaces=2, ordering="lexicographic"),
}
CRITERIA = {
    "reads": ("ClassifiedReadCount", (5, 0.0)),
    "total": ("MinimizerTotalCount", (50,)),
    "distinct": ("MinimizerDistinctCount", (30,)),
    "fraction": ("MinimizerFraction", (0.2,)),
}


class World:
    """One taxonomy, five 800 bp genomes on species leaves (the second shares
    300 bp with the first, so some minimizers sit at an LCA above the
    species), and reads from the first two: 40 single, 20 pairs."""

    def __init__(self):
        rng = np.random.default_rng(20261016)
        self.tax = random_taxonomy(rng)
        leaves = [x for x in self.tax.taxa() if self.tax.is_leaf(x) and self.tax.depth(x) == 8]
        chosen = rng.choice(leaves, 5, replace=False)
        genomes = [(int(x), random_genome(rng, 800)) for x in chosen]
        genomes[1] = (genomes[1][0], genomes[0][1][:300] + genomes[1][1][300:])
        self.genomes = genomes
        self.lib = FakeLibrary(genomes)
        self.single, self.paired = [], []
        for i in range(40):
            _, seq = genomes[i % 2]
            s = int(rng.integers(0, len(seq) - 101))
            self.single.append((f"read{i}", seq[s : s + 101]))
        for i in range(20):
            _, seq = genomes[i % 2]
            s = int(rng.integers(0, len(seq) - 300))
            self.paired.append((f"pair{i}", seq[s : s + 90], seq[s + 150 : s + 260]))
        self._bases = {}

    def frags(self, paired, cls):
        return [cls(*r) for r in (self.paired if paired else self.single)]

    def bases(self, kind, records=False):
        """(the JAX package's base index, the port's) of one kind."""
        if (kind, records) not in self._bases:
            kw = KINDS[kind]
            j = JIndex.build(iter(self.genomes), JParams(**kw), self.tax, keep_records=records)
            t = KeyValueIndex.build(iter(self.genomes), IndexParams(**kw), self.tax, "cpu", keep_records=records)
            self._bases[(kind, records)] = (j, t)
        return self._bases[(kind, records)]

    def dynamics(self, kind, criterion, out, records=False, gold=None, cpar=None):
        """(slacken_tpu's Dynamic, the port's) writing under out/j and out/t."""
        name, args = CRITERIA[criterion]
        jbase, tbase = self.bases(kind, records)
        cpar = cpar or dict(thresholds=[0.0], per_read_output=False)
        jgold = jdynamic.GoldSetOptions(*gold) if gold else None
        tgold = dynamic.GoldSetOptions(*gold) if gold else None
        return (
            jdynamic.Dynamic(jbase, self.lib, 8, getattr(jdynamic, name)(*args), JClassifyParams(**cpar), jgold,
                             os.path.join(out, "j", "dyn")),
            dynamic.Dynamic(tbase, self.lib, 8, getattr(dynamic, name)(*args), ClassifyParams(**cpar), tgold,
                            os.path.join(out, "t", "dyn"), "cpu"),
        )


@pytest.fixture(scope="module")
def world():
    return World()


def tree(prefix):
    """{path below the directory of `prefix`: bytes}, .gz inflated."""
    base = os.path.dirname(prefix)
    files = {}
    for f in sorted(glob.glob(os.path.join(base, "**", "*"), recursive=True)):
        if os.path.isfile(f):
            files[os.path.relpath(f, base)] = gzip.open(f, "rb").read() if f.endswith(".gz") else open(f, "rb").read()
    return files


def pair_multiset(keys, taxa):
    keys = np.asarray(keys).reshape(len(taxa), -1)
    return Counter(zip(map(tuple, keys.tolist()), np.asarray(taxa).tolist()))


@pytest.mark.parametrize("paired", [False, True], ids=["single", "paired"])
@pytest.mark.parametrize("kind", KINDS)
def test_span_hits_match(world, tmp_path, kind, paired):
    jd, td = world.dynamics(kind, "total", str(tmp_path))
    want_keys, want_taxa = jd._span_hits(world.frags(paired, JFragment))
    keys, taxa = td._span_hits(world.frags(paired, Fragment))
    assert keys.dtype == torch.int64 and taxa.dtype == torch.int32
    assert keys.shape == want_keys.shape and len(taxa) > 100
    assert pair_multiset(keys.numpy().view(np.uint64), taxa.numpy()) == pair_multiset(want_keys, want_taxa)
    # the depth filter bites: the base index holds taxa above the species
    depth = world.tax.depth_std
    assert (depth[taxa.numpy()] >= 8).all() and (depth[world.bases(kind)[1].taxa] < 8).any()


@pytest.mark.parametrize("paired", [False, True], ids=["single", "paired"])
@pytest.mark.parametrize("kind", KINDS)
def test_per_taxon_counts_match(world, tmp_path, kind, paired):
    jd, td = world.dynamics(kind, "total", str(tmp_path))
    jf, tf = world.frags(paired, JFragment), world.frags(paired, Fragment)
    total = td.total_minimizers_per_taxon(tf)
    distinct = td.distinct_minimizers_per_taxon(tf)
    assert total == jd.total_minimizers_per_taxon(jf) and list(total) == sorted(total)
    assert distinct == jd.distinct_minimizers_per_taxon(jf) and list(distinct) == sorted(distinct)
    assert sum(distinct.values()) < sum(total.values())
    assert all(type(v) is int for v in [*total, *total.values()])
    reads = td.classified_reads_per_taxon(tf, 0.0)
    assert reads == jd.classified_reads_per_taxon(jf, 0.0) and sum(reads.values()) > 10


@pytest.mark.parametrize("criterion", CRITERIA)
@pytest.mark.parametrize("kind", KINDS)
def test_find_taxon_set_matches(world, tmp_path, capsys, kind, criterion):
    gold_file = tmp_path / "gold.txt"
    gold_file.write_text(f"{world.genomes[0][0]}\n{world.genomes[3][0]},x\n")
    jd, td = world.dynamics(kind, criterion, str(tmp_path), gold=(str(gold_file), None, False))
    capsys.readouterr()
    want = jd.find_taxon_set(world.frags(False, JFragment), str(tmp_path / "j" / "set.txt"))
    jout = capsys.readouterr()
    got = td.find_taxon_set(world.frags(False, Fragment), str(tmp_path / "t" / "set.txt"))
    tout = capsys.readouterr()
    assert got == want and world.genomes[0][0] in got
    assert (tmp_path / "t" / "set.txt").read_bytes() == (tmp_path / "j" / "set.txt").read_bytes()
    assert tout.out == jout.out and "Precision" in tout.out and "Detected set: initial scan" in tout.out
    assert "Start task: Find taxon set in subjects" in tout.err and "Finish task:" in tout.err
    assert td.fraction_filter(td.distinct_minimizers_per_taxon(world.frags(False, Fragment)), 1.1) == set()


def test_read_gold_set_matches_with_promotion(tmp_path, capsys):
    """Gold taxa missing from the library promote up the lineage; the
    promote-rank filter keeps only promotions at or below the given rank (the
    case of slacken_tpu's own test)."""
    from slacken_tpu.taxonomy import Taxonomy as JTaxonomy
    from slacken_tpu_torch.taxonomy import Taxonomy

    nodes = [(1, 1, "root"), (10, 1, "genus"), (100, 10, "species"), (200, 100, "no rank"),
             (11, 1, "genus"), (110, 11, "species"), (210, 110, "no rank")]
    names = [(x, f"n{x}") for x, _, _ in nodes]

    class Lib:
        def taxon_set(self, tax):
            return tax.taxa_with_ancestors([100])

    class Base:
        def __init__(self, t):
            self.taxonomy = t

    gold_file = tmp_path / "gold.txt"
    gold_file.write_text("200\n210\n\n")
    for promote in (None, 7, 0):
        jd = jdynamic.Dynamic(Base(JTaxonomy.from_nodes_and_names(nodes, names)), Lib(), 8,
                              jdynamic.ClassifiedReadCount(1, 0.0), JClassifyParams(),
                              jdynamic.GoldSetOptions(str(gold_file), promote, True), str(tmp_path / "j"))
        td = dynamic.Dynamic(Base(Taxonomy.from_nodes_and_names(nodes, names)), Lib(), 8,
                             dynamic.ClassifiedReadCount(1, 0.0), ClassifyParams(),
                             dynamic.GoldSetOptions(str(gold_file), promote, True), str(tmp_path / "t"), "cpu")
        capsys.readouterr()
        want = jd.read_gold_set()
        jout = capsys.readouterr().out
        got = td.read_gold_set()
        assert got == want and capsys.readouterr().out == jout
        assert {200, 210, 100} <= got and (1 in got) == (promote == 0)


def packed_factory(world, mod):
    def factory():
        rows = np.stack([np.pad(encode.encode_seq(s), (0, 128 - len(s)), constant_values=4) for _, s in world.single])
        yield mod.PackedReads(rows, np.array([len(s) for _, s in world.single], np.int32),
                              [t for t, _ in world.single])
    return factory


@pytest.mark.parametrize("mode", ["fragments", "paired", "packed"])
@pytest.mark.parametrize("records", [False, True], ids=["library", "sidecar"])
@pytest.mark.parametrize("kind", KINDS)
def test_two_step_matches(world, tmp_path, capsys, kind, records, mode):
    """The dynamic index (saved files) and everything classify2 writes, per-read
    files included, with the final pass over Fragments and over packed reads."""
    jd, td = world.dynamics(kind, "reads", str(tmp_path), records,
                           cpar=dict(thresholds=[0.0, 0.15], per_read_output=True))
    capsys.readouterr()
    if mode == "packed":
        jidx = jd.two_step_classify_and_write(world.frags(False, JFragment), True,
                                              packed_factory=packed_factory(world, jnative))
        jout = capsys.readouterr().out
        tidx = td.two_step_classify_and_write(world.frags(False, Fragment), True,
                                              packed_factory=packed_factory(world, native))
    else:
        jidx = jd.two_step_classify_and_write(world.frags(mode == "paired", JFragment), True)
        jout = capsys.readouterr().out
        # a factory: the reads are walked twice
        tidx = td.two_step_classify_and_write(lambda: iter(world.frags(mode == "paired", Fragment)), True)
    assert capsys.readouterr().out == jout and "Dynamic index:" in jout
    jidx.save(str(tmp_path / "j" / "index"))
    tidx.save(str(tmp_path / "t" / "index"))
    want, got = tree(str(tmp_path / "j" / "dyn")), tree(str(tmp_path / "t" / "dyn"))
    assert 0 < tidx.num_records < world.bases(kind, records)[1].num_records
    assert sorted(got) == sorted(want) and any(k.endswith(".gz") for k in got)
    assert {"dyn_taxonSet.txt", "dyn_dynamic_min_report.txt", "dyn_dynamic_genome_report.txt"} <= set(got)
    for name in want:
        if not name.endswith("params.json"):
            assert got[name] == want[name], name
    base_lut = world.bases(kind, records)[1].ordering_lut
    assert (tidx.ordering_lut is None) == (kind != "lexicographic") and np.array_equal(tidx.ordering_lut, base_lut)


@pytest.mark.parametrize("kind", KINDS)
def test_sidecar_matches_and_each_package_loads_the_others(world, tmp_path, kind):
    jbase, tbase = world.bases(kind, True)
    jbase.save(str(tmp_path / "j"))
    tbase.save(str(tmp_path / "t"))
    for name in ("keys.npy", "taxa.npy", "record_keys.npy", "record_taxa.npy"):
        assert (tmp_path / "j" / name).read_bytes() == (tmp_path / "t" / name).read_bytes(), name
    assert tbase.record_keys.dtype == np.uint64 and tbase.record_taxa.dtype == np.int32
    assert len(tbase.record_taxa) > tbase.num_records  # shared minimizers: several taxa a key
    plain = world.bases(kind, False)[1]
    assert np.array_equal(plain.keys, tbase.keys) and np.array_equal(plain.taxa, tbase.taxa)
    assert plain.record_keys is None and plain.record_taxa is None
    taxon_set = world.tax.taxa_with_descendants([world.genomes[0][0], world.genomes[2][0]])
    want = jbase.build_restricted(taxon_set)
    from_jax, from_torch = KeyValueIndex.load(str(tmp_path / "j")), JIndex.load(str(tmp_path / "t"))
    for got in (tbase.build_restricted(taxon_set), from_jax.build_restricted(taxon_set),
                from_torch.build_restricted(taxon_set)):
        assert np.array_equal(np.asarray(got.keys), want.keys) and np.array_equal(np.asarray(got.taxa), want.taxa)
    rebuilt = KeyValueIndex.build(iter(world.genomes), IndexParams(**KINDS[kind]), world.tax, "cpu",
                                  taxon_filter=taxon_set)
    assert np.array_equal(rebuilt.keys, want.keys) and np.array_equal(rebuilt.taxa, want.taxa)
    assert 0 < rebuilt.num_records < tbase.num_records
    with pytest.raises(ValueError, match="without full records"):
        plain.build_restricted(taxon_set)
    assert tbase.build_restricted(set()).num_records == 0


def test_dynamic_index_is_served_from_its_device(world, tmp_path, monkeypatch):
    """Between make_records and the classification nothing reads the dynamic
    index's keys back to the host, and the Classifier probes the very tensors
    that build_restricted made."""
    _, td = world.dynamics("narrow", "reads", str(tmp_path), True)
    host_reads = []
    monkeypatch.setattr(KeyValueIndex, "keys", property(lambda self: host_reads.append("keys")))
    monkeypatch.setattr(KeyValueIndex, "taxa", property(lambda self: host_reads.append("taxa")))
    seen = {}
    real = KeyValueIndex.device_arrays

    def device_arrays(self, device, probe="routed"):
        out = real(self, device, probe)
        seen[id(self)] = (out[0] is self.keys_t, out[1] is self.taxa_t)
        return out

    monkeypatch.setattr(KeyValueIndex, "device_arrays", device_arrays)
    idx = td.two_step_classify_and_write(world.frags(False, Fragment))
    assert host_reads == [] and seen[id(idx)] == (True, True)


def test_bracken_length_is_refused_before_any_work(world, tmp_path):
    """bracken_read_length is served, not refused: both packages write the
    same Bracken weights of the dynamic index, and the same classification.
    (The name dates from when the port refused the option; it is kept so
    that the test stays findable.)"""
    jd, td = world.dynamics("narrow", "reads", str(tmp_path), records=True)
    jd.two_step_classify_and_write(world.frags(False, JFragment), bracken_read_length=100)
    td.two_step_classify_and_write(world.frags(False, Fragment), bracken_read_length=100)
    want, got = tree(str(tmp_path / "j" / "dyn")), tree(str(tmp_path / "t" / "dyn"))
    assert got == want and got[os.path.join("dyn", "database100mers.kmer_distrib")].startswith(b"mapped_taxid")


def test_default_device_is_cuda_and_never_the_cpu(world, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dynamic.Dynamic(world.bases("narrow")[1], world.lib, 8, dynamic.ClassifiedReadCount(1, 0.0),
                        ClassifyParams(), None, str(tmp_path / "o"))
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["classify2", "-i", str(tmp_path), "-l", str(tmp_path), "-o", str(tmp_path / "o")])


def test_criteria_from_args_matches():
    from argparse import Namespace

    for kw in (dict(min_count=5), dict(reads=7, init_confidence=0.1), dict(min_distinct=3),
               dict(min_fraction=0.5), dict(init_confidence=0.3), dict()):
        assert repr(dynamic.criteria_from_args(Namespace(**kw))) == repr(jdynamic.criteria_from_args(Namespace(**kw)))


# -- both CLIs ---------------------------------------------------------------


@pytest.fixture(scope="module")
def cli_world(world, tmp_path_factory):
    """A library directory, a taxonomy directory, FASTQ files of the reads and
    an index with full records from each package's `build --full-records`."""
    root = tmp_path_factory.mktemp("cli")
    (root / "lib" / "library").mkdir(parents=True)
    with open(root / "lib" / "seqid2taxid.map", "w") as f:
        for i, (taxon, g) in enumerate(world.genomes):
            write_fasta(root / "lib" / "library" / f"g{i}.fna", [(f"seq{taxon}", g)])
            f.write(f"seq{taxon}\t{taxon}\n")
    world.tax.save(str(root / "taxonomy"))
    write_fastq(str(root / "reads.fastq"), world.single)
    write_fastq(str(root / "m_1.fastq"), [(t + "/1", a) for t, a, _ in world.paired])
    write_fastq(str(root / "m_2.fastq"), [(t + "/2", b) for t, _, b in world.paired])
    common = ["-l", str(root / "lib"), "-t", str(root / "taxonomy"), "--full-records"]
    assert jcli.main(["build", "-i", str(root / "jidx"), *common]) == 0
    assert cli.main(["build", "-i", str(root / "tidx"), *common, "--device", "cpu"]) == 0
    for name in ("keys.npy", "taxa.npy", "record_keys.npy", "record_taxa.npy"):
        assert (root / "jidx" / name).read_bytes() == (root / "tidx" / name).read_bytes()
    gold = root / "gold.txt"
    gold.write_text(f"{world.genomes[0][0]}\n{world.genomes[2][0]}\n")
    return root


def strip_paths(text, root):
    return text.replace(str(root / "jidx"), "IDX").replace(str(root / "tidx"), "IDX")


@pytest.mark.parametrize("case", ["default", "distinct", "fraction_reports", "paired_total", "gold"])
def test_cli_classify2_matches(cli_world, tmp_path, capsys, case):
    root = cli_world
    reads = [str(root / "reads.fastq")]
    extra = {
        "default": ["-R", "3", "--init-confidence", "0.0"],
        "distinct": ["-D", "20", "--no-detailed"],
        "fraction_reports": ["-F", "0.1", "--index-reports"],
        "paired_total": ["-C", "40", "-p"],
        "gold": ["-g", str(root / "gold.txt"), "--classify-with-gold", "--promote-gold-set", "genus", "--rank", "species"],
    }[case]
    if case == "paired_total":
        reads = [str(root / "m_1.fastq"), str(root / "m_2.fastq")]
    # slacken_tpu's index for slacken_tpu, the port's for the port: same bytes
    capsys.readouterr()
    assert jcli.main(["classify2", *reads, "-i", str(root / "jidx"), "-l", str(root / "lib"),
                      "-o", str(tmp_path / "j" / "out"), "-c", "0.0", "0.1", *extra]) == 0
    jout = capsys.readouterr().out
    assert cli.main(["classify2", *reads, "-i", str(root / "tidx"), "-l", str(root / "lib"),
                     "-o", str(tmp_path / "t" / "out"), "-c", "0.0", "0.1", "--device", "cpu", *extra]) == 0
    assert capsys.readouterr().out == jout and "Dynamic index:" in jout
    want, got = tree(str(tmp_path / "j" / "out")), tree(str(tmp_path / "t" / "out"))
    assert got == want and len(got) >= (2 if case == "distinct" else 4)
    assert ("out_taxonSet.txt" in got) == (case != "gold")
    assert ("out_dynamic_min_report.txt" in got) == (case == "fraction_reports")


def test_cli_classify2_refuses_bracken_length(cli_world, tmp_path, capsys):
    """--bracken-length is taken, not refused: both CLIs write byte-identical
    weights beside byte-identical classifications. (The name dates from when
    the port refused the option; it is kept so that the test stays
    findable.)"""
    common = [str(cli_world / "reads.fastq"), "-l", str(cli_world / "lib"), "-R", "3", "--init-confidence", "0.0",
              "--bracken-length", "100"]
    assert jcli.main(["classify2", *common, "-i", str(cli_world / "jidx"), "-o", str(tmp_path / "j" / "o")]) == 0
    jout = capsys.readouterr().out
    assert cli.main(["classify2", *common, "-i", str(cli_world / "tidx"), "-o", str(tmp_path / "t" / "o"),
                     "--device", "cpu"]) == 0
    assert capsys.readouterr().out == jout
    want, got = tree(str(tmp_path / "j" / "o")), tree(str(tmp_path / "t" / "o"))
    assert got == want and os.path.join("o", "database100mers.kmer_distrib") in got


def test_cli_classify2_falls_back_for_mates_out_of_order(cli_world, world, tmp_path):
    """Mate files in different orders: the positional reader refuses, the
    reader that joins mates by id takes the final pass; the result equals the
    run on ordered files."""
    shuffled = str(tmp_path / "m_2.fastq")
    write_fastq(shuffled, [(t + "/2", b) for t, _, b in reversed(world.paired)])
    runs = {}
    for tag, m2 in (("ordered", str(cli_world / "m_2.fastq")), ("shuffled", shuffled)):
        assert cli.main(["classify2", str(cli_world / "m_1.fastq"), m2, "-p", "-i", str(cli_world / "tidx"),
                         "-l", str(cli_world / "lib"), "-o", str(tmp_path / tag / "out"), "-R", "3",
                         "--init-confidence", "0.0", "--device", "cpu"]) == 0
        runs[tag] = tree(str(tmp_path / tag / "out"))
    line_sets = {tag: {k: sorted(v.splitlines()) for k, v in files.items()} for tag, files in runs.items()}
    assert line_sets["ordered"] == line_sets["shuffled"] and len(runs["ordered"]) == 3
