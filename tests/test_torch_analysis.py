"""The port's analysis tools against slacken_tpu's on the CPU, same inputs
from a numpy seed, tolerance 0: compareIndex (the join through the probe)
with its printed histogram and its report, narrow, rank-table and wide (the
last against a Python-integer join: slacken_tpu's fails there), compare
(both CLIs), hit categories, UniFrac, the CAMI report, the report display
filter, and a small accuracy experiment on the CPU device."""

import io

import numpy as np
import pytest
import torch

from slacken_tpu import cli as jcli
from slacken_tpu.analysis import cami as jcami
from slacken_tpu.analysis import display as jdisplay
from slacken_tpu.analysis import mapping_comparison as jmc
from slacken_tpu.analysis.migration import MinimizerMigration as JMigration
from slacken_tpu.analysis.unifrac import UniFrac as JUniFrac
from slacken_tpu.index import IndexParams as JParams
from slacken_tpu.index import KeyValueIndex as JIndex
from slacken_tpu_torch import cli
from slacken_tpu_torch.analysis import cami, display, experiment, mapping_comparison
from slacken_tpu_torch.analysis.migration import MinimizerMigration
from slacken_tpu_torch.analysis.unifrac import UniFrac
from slacken_tpu_torch.index import IndexParams, KeyValueIndex
from test_analysis import small_tax
from test_index import make_genomes
from test_taxonomy import random_taxonomy

torch.set_num_threads(1)

KINDS = {
    "narrow": dict(k=35, m=31, spaces=7),
    "lexicographic": dict(k=21, m=11, spaces=2, ordering="lexicographic"),
    "wide": dict(k=50, m=45, spaces=7),
}


class World:
    """Five 1,500 bp genomes on leaves. The index holds them all; the
    reference holds the first four plus the first genome again under the
    third taxon, so shared keys move up the tree, some to the root, and the
    fifth genome's keys are not shared at all."""

    def __init__(self):
        rng = np.random.default_rng(20261018)
        self.tax = random_taxonomy(rng)
        self.genomes = make_genomes(rng, self.tax, n_genomes=5, length=1500)
        self.ref_genomes = self.genomes[:4] + [(self.genomes[2][0], self.genomes[0][1])]
        self._idx = {}

    def indexes(self, kind):
        """(slacken_tpu's index, reference), (the port's index, reference)."""
        if kind not in self._idx:
            self._idx[kind] = tuple(
                tuple(build(g, params(**KINDS[kind]), self.tax, *dev) for g in (self.genomes, self.ref_genomes))
                for build, params, dev in ((JIndex.build, JParams, ()), (KeyValueIndex.build, IndexParams, ("cpu",))))
        return self._idx[kind]


@pytest.fixture(scope="module")
def world():
    return World()


def integer_join(index, reference):
    """(a, b, steps) of the shared keys in index order, by a dictionary of
    Python-integer keys."""
    rows = lambda idx: [tuple(r) for r in idx.keys.reshape(len(idx.taxa), -1).tolist()]  # noqa: E731
    ref = dict(zip(rows(reference), reference.taxa.tolist()))
    pairs = [(t, ref[k]) for k, t in zip(rows(index), index.taxa.tolist()) if k in ref]
    depth = reference.taxonomy.depth_std
    steps = [-100 if depth[a] == -1 else -200 if depth[b] == -1 else int(depth[a]) - int(depth[b]) for a, b in pairs]
    return [a for a, _ in pairs], [b for _, b in pairs], steps


@pytest.mark.parametrize("kind", ["narrow", "lexicographic"])
def test_taxa_distances_match_jax(world, kind):
    (ji, jr), (ti, tr) = world.indexes(kind)
    want = JMigration(ji, jr).taxa_distances()
    got = MinimizerMigration(ti, tr, "cpu").taxa_distances()
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g)
    assert 0 < len(got[0]) < ti.num_records and (got[2] > 0).any()
    assert [x.tolist() for x in got] == [list(x) for x in integer_join(ti, tr)]


def test_wide_taxa_distances_against_an_integer_join(world):
    (ji, jr), (ti, tr) = world.indexes("wide")
    a, b, steps = MinimizerMigration(ti, tr, "cpu").taxa_distances()
    assert [a.tolist(), b.tolist(), steps.tolist()] == list(map(list, integer_join(ti, tr)))
    assert 0 < len(a) < ti.num_records and (steps > 0).any()
    # slacken_tpu's np.intersect1d flattens the [N, 2] keys and indexes past the taxa
    with pytest.raises(IndexError):
        JMigration(ji, jr).taxa_distances()


@pytest.mark.parametrize("kind", ["narrow", "lexicographic", "wide"])
def test_cli_compare_index_matches(world, tmp_path, capsys, kind):
    """Both CLIs on saved indexes: printed histogram and taxaToRoot report
    identical (wide: the port against its own API and the integer join)."""
    (ji, jr), (ti, tr) = world.indexes(kind)
    for name, idx in (("i", ti), ("r", tr)):
        idx.save(str(tmp_path / name))
    capsys.readouterr()
    assert cli.main(["compareIndex", "-i", str(tmp_path / "i"), "-r", str(tmp_path / "r"),
                     "-o", str(tmp_path / "t"), "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    report = (tmp_path / "t_taxaToRoot_report.txt").read_bytes()
    if kind == "wide":
        steps = integer_join(ti, tr)[2]
        want = "steps\tcount\n" + "".join(f"{s}\t{steps.count(s)}\n" for s in sorted(set(steps)))
        assert got == want
        assert MinimizerMigration(ti, tr, "cpu").run(str(tmp_path / "api")) == {s: steps.count(s) for s in set(steps)}
        assert (tmp_path / "api_taxaToRoot_report.txt").read_bytes() == report
        return
    assert jcli.main(["compareIndex", "-i", str(tmp_path / "i"), "-r", str(tmp_path / "r"),
                      "-o", str(tmp_path / "j")]) == 0
    assert got == capsys.readouterr().out and got.startswith("steps\tcount\n")
    assert report == (tmp_path / "j_taxaToRoot_report.txt").read_bytes() and report.count(b"\n") > 2


def test_compare_index_defaults_to_cuda(world, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        MinimizerMigration(*world.indexes("narrow")[1])


def _mapping_files(tmp_path):
    """A reference mapping with a header and /1 /2 mates, and a Kraken
    per-read file: right, wrong-clade, vague and unclassified reads."""
    ref = tmp_path / "ref.tsv"
    rows = [("x", f"r{i}/1", 100) for i in range(20)] + [("x", f"r{i}/2", 100) for i in range(5)]
    rows += [("x", f"s{i}", 110) for i in range(20)] + [("x", f"v{i}", 101) for i in range(12)]
    ref.write_text("h\tid\ttaxon\n" + "".join(f"{a}\t{b}\t{c}\n" for a, b, c in rows))
    cls = tmp_path / "cls.tsv"
    out = [("C", f"r{i}", 100) for i in range(20)] + [("C", f"s{i}", 100) for i in range(15)]
    out += [("U", f"s{i}", 0) for i in range(15, 20)] + [("C", f"v{i}", 10) for i in range(12)]
    cls.write_text("".join(f"{a}\t{b}\t{c}\t101\tx\n" for a, b, c in out))
    return ref, cls


@pytest.mark.parametrize("min_count", ["1", "12"])
def test_cli_compare_matches(tmp_path, capsys, min_count):
    t = small_tax()
    t.save(str(tmp_path / "tax"))
    ref, cls = _mapping_files(tmp_path)
    # the multi-sample layout: <dir>/sample=<id> against <refs>/sample<id>/reads_mapping.tsv
    for sample, taxon in (("0", 100), ("1", 110)):
        d = tmp_path / "run_c0.00" / f"sample={sample}"
        d.mkdir(parents=True)
        (d / "part-00000.txt").write_text("".join(f"C\ts{sample}r{i}\t{taxon}\t101\tx\n" for i in range(15)))
        r = tmp_path / "refs" / f"sample{sample}"
        r.mkdir(parents=True)
        (r / "reads_mapping.tsv").write_text("".join(f"x\ts{sample}r{i}\t{taxon}\n" for i in range(15)))
    runs = [["--test-files", str(cls), "-r", str(ref), "--header", "--min-count", min_count],
            ["--multi-dirs", str(tmp_path / "run_c0.00"), "-r", str(tmp_path / "refs"), "--min-count", min_count]]
    for i, argv in enumerate(runs):
        outs = {}
        for tag, main in (("j", jcli.main), ("t", cli.main)):
            capsys.readouterr()
            assert main(["compare", "-t", str(tmp_path / "tax"), "-o", str(tmp_path / f"{tag}{i}"), *argv]) == 0
            outs[tag] = (capsys.readouterr().out.replace(f"t{i}_", f"j{i}_"),
                         (tmp_path / f"{tag}{i}_metrics.tsv").read_text())
        assert outs["t"] == outs["j"] and len(outs["t"][1].splitlines()) >= 3


def test_hit_categories_and_metrics_match():
    t = small_tax()
    taxa = [0, 1, 2, 10, 11, 100, 101, 110]
    for level in (None, 7, 8):
        for ref in taxa[1:]:
            for test in taxa:
                assert mapping_comparison.hit_category(t, ref, test, level) == jmc.hit_category(t, ref, test, level)
    rng = np.random.default_rng(3)
    ref = {f"r{i}": int(x) for i, x in enumerate(rng.choice([100, 101, 110], 200))}
    cmp_data = {f"r{i}": int(x) for i, x in enumerate(rng.choice(taxa, 250))}
    for level in (7, 8, None):
        for min_count in (1, 10):
            ours = mapping_comparison.MappingComparison(t, min_count_taxon=min_count)
            theirs = jmc.MappingComparison(t, min_count_taxon=min_count)
            assert ours.per_taxon(cmp_data, ref, level).tsv() == theirs.per_taxon(cmp_data, ref, level).tsv()
            assert ours.per_read(cmp_data, ref, level).tsv() == theirs.per_read(cmp_data, ref, level).tsv()
    assert mapping_comparison.METRICS_HEADER == jmc.METRICS_HEADER


def test_unifrac_matches():
    rng = np.random.default_rng(4)
    t = random_taxonomy(rng)
    leaves = [x for x in t.taxa() if t.is_leaf(x)]
    for _ in range(20):
        a, b = (set(rng.choice(leaves, int(rng.integers(0, 6))).tolist()) for _ in range(2))
        assert UniFrac(t, a, b).distance == JUniFrac(t, a, b).distance


def test_cami_matches(tmp_path):
    t = small_tax()
    t.save(str(tmp_path / "tax"))
    rows = ["#anonymous_read_id\tgenome_id\ttax_id\tread_id"]
    for i in range(10):
        rows += [f"S0R{i}/1\tG1\t100\tn{i}/1", f"S0R{i}/2\tG1\t100\tn{i}/2"]
    for i in range(4):
        rows += [f"S0Q{i}/1\tG2\t10\tm{i}/1", f"S0Q{i}/2\tG2\t10\tm{i}/2", f"S0P{i}\tG3\t110\tp{i}"]
    (tmp_path / "mapping.tsv").write_text("\n".join(rows) + "\nshort\tline\n")
    for rank in ("species", "genus", "root"):
        for tag, mod in (("j", jcami), ("t", cami)):
            mod.main([str(tmp_path / "tax"), rank, str(tmp_path / "mapping.tsv"), str(tmp_path / f"{tag}_{rank}")])
        for suffix in (".kreport.txt", ".ids_filtered.txt"):
            want = (tmp_path / f"j_{rank}{suffix}").read_bytes()
            assert (tmp_path / f"t_{rank}{suffix}").read_bytes() == want and want


def test_display_filter_matches(capsys):
    report = [
        "#Perc\tAggregate\tIn taxon\tRank\tTaxon\tName",
        "100.00\t90\t0\tR\t1\troot",
        " 66.00\t60\t0\tG\t10\t  GenA",
        " 33.00\t30\t30\tS\t100\t    SpA",
        " 33.00\t30\t30\tS1\t101\t    SpB",
        "  5.00\t30\t30\tS\t110\t  SpC",
        "short\tline",
    ]
    for kw in (dict(), dict(level_cutoff=7), dict(min_percent=10.0), dict(clades={10}), dict(clades={110, 1}),
               dict(level_cutoff=8, min_percent=20.0, colorize=True)):
        outs = []
        for mod in (jdisplay, display):
            buf = io.StringIO()
            mod.filter_report(report, out=buf, **kw)
            outs.append(buf.getvalue())
        assert outs[0] == outs[1]
    assert display.num_rank_for_code("G") == jdisplay.num_rank_for_code("G") == 7


def test_accuracy_experiment_matches_jax():
    """A small 1-step / 2-step / gold-set experiment on the CPU device: every
    scored row equals slacken_tpu's."""
    from slacken_tpu.analysis.experiment import run_experiment

    kw = dict(n_genera=2, genome_len=30_000, n_present=2, n_reads=300, thresholds=(0.0, 0.05), detect_count=20)
    want = run_experiment(**kw)
    got = experiment.run_experiment(**kw, device="cpu")
    row = lambda r: {k: (v.tsv() if k.startswith("per_") else v) for k, v in r.items()}  # noqa: E731
    assert [row(r) for r in got] == [row(r) for r in want] and len(got) == 3 * 2 * 2
