"""The port's index statistics against slacken_tpu's on the CPU, tolerance 0
(integers, text and bytes): depth histograms, the library scan, the coverage
statistics, the inspect reports with and without a library, and both CLIs'
`stats`, `inspect` and `respace`. Base indexes: narrow (35, 31, 7), a rank
table (21, 11, 2, lexicographic) and wide (40, 35, 3). slacken_tpu's library
scan fails on a wide index (it indexes the four limbs as if they were two),
so the wide cases are held to a reference written out here."""

import os
from collections import Counter

import numpy as np
import pytest
import torch

import slacken_tpu.stats as jstats
from slacken_tpu import cli as jcli
from slacken_tpu.index import IndexParams as JParams
from slacken_tpu.index import KeyValueIndex as JIndex
from slacken_tpu_torch import cli, stats
from slacken_tpu_torch.index import IndexParams, KeyValueIndex
from slacken_tpu_torch.ops import encode, minimizers
from test_index import random_genome
from test_inputs_cli import write_fasta
from test_stats import FakeLibrary
from test_taxonomy import random_taxonomy

torch.set_num_threads(1)

KINDS = {
    "narrow": dict(k=35, m=31, spaces=7),
    "lexicographic": dict(k=21, m=11, spaces=2, ordering="lexicographic"),
    "wide": dict(k=40, m=35, spaces=3),
}


class World:
    """One taxonomy and four 700 bp genomes on leaves: the first holds two
    Ns, the second shares 250 bp with the first (minimizers at an LCA above
    both), the third has two sequences."""

    def __init__(self):
        rng = np.random.default_rng(20261017)
        self.tax = random_taxonomy(rng)
        leaves = [x for x in self.tax.taxa() if self.tax.is_leaf(x)]
        chosen = [int(x) for x in rng.choice(leaves, 4, replace=False)]
        seqs = [random_genome(rng, 700) for _ in chosen]
        seqs[0] = seqs[0][:300] + "NN" + seqs[0][302:]
        seqs[1] = seqs[0][400:650] + seqs[1][250:]
        self.genomes = list(zip(chosen, seqs))
        self.lib = FakeLibrary(self.genomes)
        self._bases = {}

    def bases(self, kind):
        if kind not in self._bases:
            kw = KINDS[kind]
            self._bases[kind] = (JIndex.build(iter(self.genomes), JParams(**kw), self.tax),
                                 KeyValueIndex.build(iter(self.genomes), IndexParams(**kw), self.tax, "cpu"))
        return self._bases[kind]


@pytest.fixture(scope="module")
def world():
    return World()


def reference_span_data(world, kind):
    """({taxon: valid windows}, Counter of (key, taxon) over every span) from
    the scan's plain twin, one whole sequence a row."""
    tidx = world.bases(kind)[1]
    mp = tidx.params.minimizer_params
    lut = tidx.device_lut("cpu")
    counts, pairs = {}, Counter()
    for taxon, seq in world.genomes:
        codes = encode.encode_seq(seq)
        assert sum(all(c < 4 for c in codes[i : i + mp.k]) for i in range(len(codes) - mp.k + 1)) > 0
        wm = minimizers.window_minimizers(torch.from_numpy(codes)[None], mp, lut)
        counts[taxon] = counts.get(taxon, 0) + int(wm.valid.sum())
        keys = wm.minimizer[wm.span_start].numpy().view(np.uint64).reshape(int(wm.span_start.sum()), -1)
        pairs.update((tuple(k), taxon) for k in keys.tolist())
    return counts, pairs


def pair_counter(keys, taxa):
    keys = np.asarray(keys).reshape(len(taxa), -1)
    return Counter(zip(map(tuple, keys.tolist()), np.asarray(taxa).tolist()))


def reference_coverage(world, kind):
    """taxon_full_coverage_stats by dictionaries: a taxon's distinct span
    keys in key order, each with its multiplicity and the depth of its LCA in
    the index; depths listed as they first appear."""
    tidx = world.bases(kind)[1]
    index = dict(zip(map(tuple, tidx.keys.reshape(tidx.num_records, -1).tolist()), tidx.taxa.tolist()))
    _, pairs = reference_span_data(world, kind)
    rows = []
    for taxon in sorted({t for _, t in pairs}):
        by_depth = {}
        for key in sorted(k for k, t in pairs if t == taxon):
            d = world.tax.depth(index[key])
            a, b = by_depth.get(d, (0, 0))
            by_depth[d] = (a + pairs[(key, taxon)], b + 1)
        rows.append((taxon, "|".join(f"{d}:{v[0]}" for d, v in by_depth.items()),
                     "|".join(f"{d}:{v[1]}" for d, v in by_depth.items())))
    return rows


@pytest.mark.parametrize("kind", KINDS)
def test_depth_histograms_and_coverage_summary_match(world, kind):
    jidx, tidx = world.bases(kind)
    got = stats.depth_histograms(tidx)
    assert got == jstats.depth_histograms(jidx)
    assert sum(c for _, _, c in got[0]) == tidx.num_records and len(got[0]) > 1
    assert all(type(x) is int for row in got[0] + got[1] for x in (row[0], row[2]))
    assert stats.taxon_coverage_stats(tidx) == jstats.taxon_coverage_stats(jidx)
    assert tidx.records_per_taxon() == jidx.records_per_taxon() == tidx.distinct_minimizers_per_taxon()
    assert list(tidx.records_per_taxon()) == sorted(tidx.records_per_taxon())


@pytest.mark.parametrize("kind", KINDS)
def test_library_span_data_matches(world, kind):
    jidx, tidx = world.bases(kind)
    counts, keys, taxa = stats.library_span_data(tidx, world.lib, "cpu")
    small = stats.library_span_data(tidx, world.lib, "cpu", batch_rows=2, row_len=128)  # split rows
    want_counts, want_pairs = reference_span_data(world, kind)
    if kind != "wide":
        jcounts, jkeys, jtaxa = jstats.library_span_data(jidx, world.lib)
        assert jcounts == want_counts and pair_counter(jkeys, jtaxa) == want_pairs
    assert keys.dtype == torch.int64 and taxa.dtype == torch.int32
    assert keys.shape == ((len(taxa), 2) if kind == "wide" else (len(taxa),))
    for c, k, t in ((counts, keys, taxa), small):
        assert c == want_counts
        assert set(pair_counter(k.numpy().view(np.uint64), t.numpy())) == set(want_pairs)
    assert pair_counter(keys.numpy().view(np.uint64), taxa.numpy()) == want_pairs
    # every span's key is a key of the index built from the same library
    index_keys = set(map(tuple, tidx.keys.reshape(tidx.num_records, -1).tolist()))
    assert {k for k, _ in want_pairs} == index_keys


@pytest.mark.parametrize("kind", KINDS)
def test_taxon_full_coverage_stats_match(world, capsys, kind):
    jidx, tidx = world.bases(kind)
    got = stats.taxon_full_coverage_stats(tidx, world.lib, "cpu")
    assert got == reference_coverage(world, kind) and len(got) == 4
    assert any("|" in covs for _, covs, _ in got)  # minimizers at several depths
    if kind != "wide":
        assert got == jstats.taxon_full_coverage_stats(jidx, world.lib)
        capsys.readouterr()
        jstats.show_coverage_stats(jidx, world.lib)
        want = capsys.readouterr().out
        stats.show_coverage_stats(tidx, world.lib, "cpu")
        assert capsys.readouterr().out == want and "minimizerCoverage" in want
    empty = KeyValueIndex.build(iter([]), tidx.params, world.tax, "cpu")
    assert stats.taxon_full_coverage_stats(empty, FakeLibrary([]), "cpu") == []


@pytest.mark.parametrize("with_library", [False, True], ids=["plain", "library"])
@pytest.mark.parametrize("kind", KINDS)
def test_write_inspect_reports_match(world, tmp_path, kind, with_library):
    jidx, tidx = world.bases(kind)
    labels = tmp_path / "labels.map"
    missing = next(t for t in world.tax.taxa() if t not in set(tidx.taxa.tolist()))
    labels.write_text("".join(f"s{t}\t{t}\n" for t in [world.genomes[0][0], missing]) + "short line\n")
    lib = world.lib if with_library else None
    stats.write_inspect_reports(tidx, str(tmp_path / "t"), str(labels), lib, "cpu")
    names = ("_min_report.txt", "_genome_report.txt", "_missing_report.txt")
    if kind == "wide" and with_library:
        per_taxon = sorted(tidx.records_per_taxon().items())
        want = jstats.TotalKmerCountReport(world.tax, per_taxon, reference_span_data(world, kind)[0]).lines()
        assert (tmp_path / "t_min_report.txt").read_text().splitlines() == want
        names = names[1:]
        jlib = None
    else:
        jlib = lib
    jstats.write_inspect_reports(jidx, str(tmp_path / "j"), str(labels), jlib)
    for name in names:
        assert (tmp_path / f"t{name}").read_bytes() == (tmp_path / f"j{name}").read_bytes(), name
    assert ("TKC1-LeafOnly" in (tmp_path / "t_min_report.txt").read_text()) == with_library
    assert str(missing) in (tmp_path / "t_missing_report.txt").read_text()


def test_total_kmer_size_aggregator_matches(world):
    sizes = {t: 1000 * (i + 1) for i, (t, _) in enumerate(world.genomes)}
    inner = int(world.tax.parents[world.genomes[0][0]])
    sizes[inner] = 77
    got, want = stats.TotalKmerSizeAggregator(world.tax, sizes), jstats.TotalKmerSizeAggregator(world.tax, sizes)
    assert got.tree == want.tree
    for t in world.tax.taxa():
        assert (got.s1(t), got.s2(t), got.s3(t)) == (want.s1(t), want.s2(t), want.s3(t))
    assert stats.TotalKmerCountReport.HEADERS == jstats.TotalKmerCountReport.HEADERS


def test_library_scan_defaults_to_cuda(world, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        stats.library_span_data(world.bases("narrow")[1], world.lib)
    for argv in (["stats", "-i", "x"], ["inspect", "-i", "x", "-o", "y"], ["respace", "-i", "x", "-o", "y", "--spaces", "9"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(argv)


# -- both CLIs ---------------------------------------------------------------


@pytest.fixture(scope="module")
def cli_world(world, tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    (root / "lib" / "library").mkdir(parents=True)
    with open(root / "lib" / "seqid2taxid.map", "w") as f:
        for i, (taxon, g) in enumerate(world.genomes):
            write_fasta(root / "lib" / "library" / f"g{i}.fna", [(f"seq{i}", g)])
            f.write(f"seq{i}\t{taxon}\n")
    world.tax.save(str(root / "taxonomy"))
    common = ["-l", str(root / "lib"), "-t", str(root / "taxonomy")]
    assert jcli.main(["build", "-i", str(root / "idx_s7"), *common]) == 0
    assert cli.main(["build", "-i", str(root / "lex"), *common, "-k", "21", "-m", "11", "-s", "2",
                     "--ordering", "lexicographic", "--device", "cpu"]) == 0
    return root


@pytest.mark.parametrize("index", ["idx_s7", "lex"])
@pytest.mark.parametrize("extra", [[], ["--histogram"], ["-l", "LIB"], ["--histogram", "-l", "LIB"]],
                         ids=["plain", "histogram", "library", "histogram-library"])
def test_cli_stats_matches(cli_world, capsys, index, extra):
    """Both CLIs on one saved index (each loads either package's files)."""
    extra = [str(cli_world / "lib") if x == "LIB" else x for x in extra]
    capsys.readouterr()
    assert jcli.main(["stats", "-i", str(cli_world / index), *extra]) == 0
    want = capsys.readouterr().out
    assert cli.main(["stats", "-i", str(cli_world / index), *extra, "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want and got.startswith(f"Index {cli_world / index}: k=")
    assert ("Minimizer depth histogram" in got) == ("--histogram" in extra)
    assert ("minimizerCoverage" in got) == (len(extra) == 2 and "--histogram" not in extra)


@pytest.mark.parametrize("index", ["idx_s7", "lex"])
@pytest.mark.parametrize("extra", [[], ["--labels"], ["-l"], ["--labels", "-l"]],
                         ids=["plain", "labels", "library", "labels-library"])
def test_cli_inspect_matches(cli_world, tmp_path, index, extra):
    args = []
    if "--labels" in extra:
        args += ["--labels", str(cli_world / "lib" / "seqid2taxid.map")]
    if "-l" in extra:
        args += ["-l", str(cli_world / "lib")]
    assert jcli.main(["inspect", "-i", str(cli_world / index), "-o", str(tmp_path / "j"), *args]) == 0
    assert cli.main(["inspect", "-i", str(cli_world / index), "-o", str(tmp_path / "t"), *args, "--device", "cpu"]) == 0
    names = sorted(os.listdir(tmp_path))
    assert len(names) == (6 if "--labels" in extra else 4)
    for name in names:
        if name.startswith("j"):
            assert (tmp_path / name).read_bytes() == (tmp_path / ("t" + name[1:])).read_bytes(), name
    assert ("TKC3-AllChildren" in (tmp_path / "t_min_report.txt").read_text()) == ("-l" in extra)


def test_cli_respace_matches(cli_world, tmp_path, capsys):
    """`respace --spaces 9 11` of the s = 7 index: the output name's _s7
    becomes _s9 and _s11, the printed lines and the saved files are equal."""
    outs = {}
    for tag, main, extra in (("j", jcli.main, []), ("t", cli.main, ["--device", "cpu"])):
        capsys.readouterr()
        assert main(["respace", "-i", str(cli_world / "idx_s7"), "-o", str(tmp_path / tag / "new_s7"),
                     "--spaces", "9", "11", *extra]) == 0
        outs[tag] = capsys.readouterr().out.replace(str(tmp_path / tag), "OUT")
    assert outs["t"] == outs["j"] and "Respaced to s=11" in outs["t"] and "Tree size" in outs["t"]
    for s in (9, 11):
        for name in ("keys.npy", "taxa.npy", "params.json"):
            assert (tmp_path / "t" / f"new_s{s}" / name).read_bytes() == (tmp_path / "j" / f"new_s{s}" / name).read_bytes()
    assert cli.main(["respace", "-i", str(cli_world / "idx_s7"), "-o", str(tmp_path / "plain"), "--spaces", "8",
                     "--device", "cpu"]) == 0
    assert KeyValueIndex.load(str(tmp_path / "plain_s8")).params.spaces == 8
    with pytest.raises(NotImplementedError, match="xor ordering"):
        cli.main(["respace", "-i", str(cli_world / "lex"), "-o", str(tmp_path / "l"), "--spaces", "4", "--device", "cpu"])
