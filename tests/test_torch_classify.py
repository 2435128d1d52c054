"""The port's classify slice end to end on the CPU against slacken_tpu's
classify_and_write_packed (reports mode): byte-identical kreports over two
thresholds, sample regexes, min-hit-groups, paired rows, N runs, reads
shorter than k and max_taxa overflow rows; then both CLIs' build and
classify, with --no-detailed, per-read output and -p (mates in order and
out of order)."""

import gzip

import os

import pytest
import torch

from slacken_tpu import cli as jcli
from slacken_tpu import native
from slacken_tpu.classify import Classifier as JClassifier
from slacken_tpu.classify import ClassifyParams as JParams
from slacken_tpu.index import IndexParams as JIndexParams
from slacken_tpu.index import KeyValueIndex as JIndex
from slacken_tpu.ops import encode
from slacken_tpu_torch import cli
from slacken_tpu_torch.classify import Classifier, ClassifyParams
from slacken_tpu_torch.index import KeyValueIndex
from test_taxonomy import random_taxonomy
from test_torch_index import shared_library

torch.set_num_threads(1)


def _reads(rng, lib, n, width, prefix, genomes=8):
    """PackedReads sampled from the library: 1% mutations, lengths 20..width,
    every 5th read with an N run, every 4th a chimera of four genomes (many
    distinct taxa, so small max_taxa overflows), titles
    '<prefix><sample>_<i>'."""
    seqs, titles = [], []
    for i in range(n):
        length = int(rng.integers(20, width + 1))
        parts = 4 if i % 4 == 0 else 1
        pieces = []
        for j in range(parts):
            _, seq = lib[(i + j) % genomes]
            piece = length // parts
            s = int(rng.integers(0, len(seq) - piece))
            pieces.append(seq[s : s + piece])
        codes = encode.encode_seq("".join(pieces)).copy()
        length = len(codes)
        mut = rng.random(length) < 0.01
        codes[mut] = rng.integers(0, 4, int(mut.sum()))
        if i % 5 == 0:
            a = int(rng.integers(0, length))
            codes[a : a + int(rng.integers(1, 50))] = encode.INVALID
        seqs.append(codes)
        titles.append(f"{prefix}s{i % 3}_{i}")
    codes, lens = encode.pack_batch(seqs, width)
    return native.PackedReads(codes, lens, titles)


@pytest.fixture
def setup(rng, tmp_path):
    tax = random_taxonomy(rng)
    lib = shared_library(rng, tax, n=8)
    JIndex.build(iter(lib), JIndexParams(), tax, batch_rows=8, row_len=4096).save(str(tmp_path / "idx"))
    single = [_reads(rng, lib, 150, 128, "a"), _reads(rng, lib, 60, 256, "b")]
    r1, r2 = _reads(rng, lib, 70, 128, "p"), _reads(rng, lib, 70, 128, "q")
    paired = native.pack_pairs(r1, r2)
    return JIndex.load(str(tmp_path / "idx")), KeyValueIndex.load(str(tmp_path / "idx")), single, paired


def _reports(loc):
    out = {}
    for d in sorted(x for x in os.listdir(os.path.dirname(loc)) if x.startswith(os.path.basename(loc))):
        for f in sorted(os.listdir(os.path.join(os.path.dirname(loc), d))):
            with open(os.path.join(os.path.dirname(loc), d, f), "rb") as fh:
                out[(d.split("_c")[-1], f)] = fh.read()
    return out


def tree(prefix):
    """{path below <prefix>_c*: bytes} of a classify output, .gz files inflated."""
    base, stem = os.path.dirname(prefix), os.path.basename(prefix)
    out = {}
    for top in sorted(x for x in os.listdir(base) if x.startswith(stem + "_c")):
        for root, _, names in os.walk(os.path.join(base, top)):
            for name in names:
                path = os.path.join(root, name)
                with (gzip.open if name.endswith(".gz") else open)(path, "rb") as f:
                    out[os.path.relpath(path, base)[len(stem):]] = f.read()
    return out


@pytest.mark.parametrize(
    "max_taxa,mhg,regex,unclassified",
    [(32, 2, None, True), (4, 1, r"^[a-z](s\d)_", False), (4, 3, r"^([ab])", True)],
)
def test_classify_matches_jax(setup, tmp_path, max_taxa, mhg, regex, unclassified):
    jidx, idx, single, paired = setup
    kw = dict(thresholds=[0.0, 0.15], min_hit_groups=mhg, sample_regex=regex,
              with_unclassified=unclassified, per_read_output=False)
    for name, stream in (("single", single), ("paired", [paired])):
        want = JClassifier(jidx, max_taxa_per_read=max_taxa).classify_and_write_packed(
            stream, str(tmp_path / f"j{name}"), JParams(**kw))
        got = Classifier(idx, "cpu", max_taxa_per_read=max_taxa).classify_and_write_packed(
            stream, str(tmp_path / f"t{name}"), ClassifyParams(**kw))
        assert got == want
        a, b = _reports(str(tmp_path / f"j{name}")), _reports(str(tmp_path / f"t{name}"))
        assert a.keys() == b.keys() and len(a) >= 2
        for key in a:
            assert a[key] == b[key], (name, key)


def test_overflow_rows_reach_the_host_resolver(setup):
    _, idx, single, paired = setup
    cls = Classifier(idx, "cpu", max_taxa_per_read=4)
    cls._thresholds = (0.0,)
    batches = list(cls.packed_batches(single + [paired]))
    assert sum(len(b.overflow_window_taxa) for b in batches) > 0
    assert sum(len(b.titles) for b in batches) == 280


def test_detailed_output_is_a_later_slice(setup, tmp_path):
    """Per-read output is the default mode: one line per read, in input
    order, and the window taxa reach the host only in this mode."""
    _, idx, single, _ = setup
    cls = Classifier(idx, "cpu")
    assert cls.classify_and_write_packed(single, str(tmp_path / "o"), ClassifyParams()) == {0.0: ["all"]}
    with gzip.open(tmp_path / "o_c0.0" / "sample=all" / "part-00000.txt.gz", "rt") as f:
        lines = f.read().splitlines()
    assert [x.split("\t")[1] for x in lines] == [t for p in single for t in p.titles]
    assert all(x[0] in "CU" and len(x.split("\t")) == 5 for x in lines)
    assert all(b.window_taxa is not None for b in cls.packed_batches(single))
    cls._fetch_window_taxa = False
    assert all(b.window_taxa is None for b in cls.packed_batches(single))


def _write_library(tmp_path, tax, lib):
    (tmp_path / "lib" / "library").mkdir(parents=True)
    with open(tmp_path / "lib" / "library" / "g.fna", "w") as f:
        for i, (_, seq) in enumerate(lib):
            f.write(f">seq{i} desc\n")
            for a in range(0, len(seq), 70):
                f.write(seq[a : a + 70] + "\n")
    with open(tmp_path / "lib" / "seqid2taxid.map", "w") as f:
        for i, (taxon, _) in enumerate(lib):
            f.write(f"seq{i}\t{taxon}\n")
    tax.save(str(tmp_path / "tax"))


def test_cli_build_and_classify_match_jax_cli(rng, tmp_path, capsys):
    tax = random_taxonomy(rng)
    lib = shared_library(rng, tax, n=4, length=2000)
    _write_library(tmp_path, tax, lib)
    reads = _reads(rng, lib, 80, 128, "r", genomes=4)
    with open(tmp_path / "reads.fastq", "w") as f:
        for title, codes, n in zip(reads.titles, reads.codes, reads.lengths):
            f.write(f"@{title}\n{encode.decode_codes(codes[:n])}\n+\n{'I' * int(n)}\n")
    lib_dir, tax_dir = str(tmp_path / "lib"), str(tmp_path / "tax")
    assert jcli.main(["build", "-i", str(tmp_path / "jidx"), "-l", lib_dir, "-t", tax_dir]) == 0
    assert cli.main(["build", "-i", str(tmp_path / "tidx"), "-l", lib_dir, "-t", tax_dir,
                     "--device", "cpu"]) == 0
    assert "Saved" in capsys.readouterr().out
    for name in ("keys.npy", "taxa.npy"):
        assert (tmp_path / "jidx" / name).read_bytes() == (tmp_path / "tidx" / name).read_bytes()
    common = [str(tmp_path / "reads.fastq"), "--no-detailed", "-c", "0.0", "0.1"]
    assert jcli.main(["classify", "-i", str(tmp_path / "jidx"), "-o", str(tmp_path / "jout"), *common]) == 0
    assert cli.main(["classify", "-i", str(tmp_path / "tidx"), "-o", str(tmp_path / "tout"), *common,
                     "--device", "cpu"]) == 0
    a, b = _reports(str(tmp_path / "jout")), _reports(str(tmp_path / "tout"))
    assert len(a) == 2 and a == b
    # per-read output (the default) and paired input, mates in order and,
    # through the id-joining fallback, out of order
    n = len(reads.titles)
    for name, order in (("m2.fastq", range(n)), ("m2_shuffled.fastq", rng.permutation(n))):
        with open(tmp_path / name, "w") as f:
            for i in order:
                seq = encode.revcomp_str(encode.decode_codes(reads.codes[i][: reads.lengths[i]]))
                f.write(f"@{reads.titles[i]}/2\n{seq}\n+\n{'I' * len(seq)}\n")
    r1 = str(tmp_path / "reads.fastq")
    for tag, args in (("s", [r1]), ("p", ["-p", r1, str(tmp_path / "m2.fastq")]),
                      ("u", ["-p", r1, str(tmp_path / "m2_shuffled.fastq"), "--no-unclassified",
                             "--sample-regex", r"^r(s\d)"])):
        assert jcli.main(["classify", "-i", str(tmp_path / "jidx"), "-o", str(tmp_path / f"j{tag}"), *args]) == 0
        assert cli.main(["classify", "-i", str(tmp_path / "tidx"), "-o", str(tmp_path / f"t{tag}"), *args,
                         "--device", "cpu"]) == 0
        a, b = tree(str(tmp_path / f"j{tag}")), tree(str(tmp_path / f"t{tag}"))
        assert a == b and any(k.endswith(".gz") for k in a), tag
    assert b"|:|" in b"".join(tree(str(tmp_path / "tu")).values())



def test_cli_paired_fallback_is_for_mates_out_of_order_only(setup, tmp_path, monkeypatch):
    """A ValueError of the classify run itself (a kernel wrapper refusing its
    input, say) is not taken for mates out of order: it propagates."""
    _, idx, _, _ = setup
    idx.save(str(tmp_path / "tidx"))
    for name in ("a.fastq", "b.fastq"):
        (tmp_path / name).write_text("@r1\nACGT\n+\nIIII\n")

    def refuse(self, stream, location, cpar):
        raise ValueError("not a CUDA tensor")

    monkeypatch.setattr(Classifier, "classify_and_write_packed", refuse)
    monkeypatch.setattr(Classifier, "classify_and_write", lambda *a: pytest.fail("fell back"))
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        cli.main(["classify", "-i", str(tmp_path / "tidx"), "-o", str(tmp_path / "o"), "-p",
                  str(tmp_path / "a.fastq"), str(tmp_path / "b.fastq"), "--device", "cpu"])
