"""The rest of the port's single-device CLI against slacken_tpu's on the CPU:
the subcommand set, `download` with an offline fake of NCBI (and the host
helpers that come with it), `inputCheck`, `build --check`, `build`'s whole
printed output, the input helpers and IndexParams.compatibility_check, and
Classifier.classify_packed. The host-only subcommands run without CUDA."""

import gzip
import os

import numpy as np
import pytest
import torch

from slacken_tpu import cli as jcli
from slacken_tpu import download as jdownload
from slacken_tpu import inputs as jinputs
from slacken_tpu.classify import Classifier as JClassifier
from slacken_tpu.classify import ClassifyParams as JClassifyParams
from slacken_tpu.index import IndexParams as JParams
from slacken_tpu.index import KeyValueIndex as JIndex
from slacken_tpu_torch import cli, download, inputs, native
from slacken_tpu_torch.classify import Classifier, ClassifyParams
from slacken_tpu_torch.index import IndexParams, KeyValueIndex
from test_download import SUMMARY, FakeNCBI, fasta_gz
from test_index import make_genomes, random_genome
from test_inputs_cli import write_fasta
from test_taxonomy import random_taxonomy
from test_torch_classify import _reads

torch.set_num_threads(1)


def test_the_subcommands_are_the_reference_s():
    assert list(cli.COMMANDS) == list(jcli.COMMANDS) and len(cli.COMMANDS) == 11


def files_of(root):
    """{relative path: bytes} under root, .gz inflated (gzip headers carry
    the time of writing)."""
    out = {}
    for base, _, names in os.walk(root):
        for n in names:
            p = os.path.join(base, n)
            data = open(p, "rb").read()
            out[os.path.relpath(p, root)] = gzip.decompress(data) if n.endswith(".gz") else data
    return out


def _fake_with_genome():
    fake = FakeNCBI()
    fake.data[f"{download.NCBI}/genomes/refseq/archaea/assembly_summary.txt"] = (
        SUMMARY.replace("\t100\t100\t", "\t2\t2\t").encode())
    genome = random_genome(np.random.default_rng(0), 2000) + "A" * 300
    fake.data[f"{download.NCBI}/genomes/all/GCF_1/GCF_1_genomic.fna.gz"] = fasta_gz([("NC_001.1 Org A", genome)])
    return fake


@pytest.mark.parametrize("mask", [False, True])
def test_download_matches(tmp_path, mask):
    """LibraryDownloader of each package on the same fake NCBI: the same
    requests and the same files (taxonomy, libraries, seqid2taxid.map)."""
    results = {}
    for tag, mod in (("j", jdownload), ("t", download)):
        fake = _fake_with_genome()
        dl = mod.LibraryDownloader(str(tmp_path / tag), fetcher=fake, parallel=2, progress=False)
        dl.download_taxonomy()
        got = [dl.download_library("archaea", mask=mask), dl.download_library("archaea", level="Contig"),
               dl.download_library("UniVec_Core"), dl.download_library("plasmid")]
        with pytest.raises(ValueError):
            dl.download_library("nonexistent")
        results[tag] = (got, sorted(fake.requests), files_of(str(tmp_path / tag)))
    assert results["t"] == results["j"]
    assert results["t"][0][:3] == [(1, 1), (2, 2), (1, 1)]


def test_cli_download_then_build_matches(tmp_path, capsys, monkeypatch):
    """`download` through each CLI with the fake in place of the network
    fetcher, then `build` on what it wrote: the same printed lines and the
    same index files. Neither CLI needs CUDA for `download`."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    outs = {}
    for tag, main, mod, extra in (("j", jcli.main, jdownload, []), ("t", cli.main, download, ["--device", "cpu"])):
        monkeypatch.setattr(mod, "_default_fetcher", _fake_with_genome())
        db = str(tmp_path / tag)
        capsys.readouterr()
        assert main(["download", "taxonomy", "archaea", "UniVec_Core", "-d", db, "-j", "2"]) == 0
        assert main(["build", "-i", os.path.join(db, "idx"), "-l", db, "-t", os.path.join(db, "taxonomy"),
                     "-k", "21", "-m", "15", "-s", "2", *extra]) == 0
        outs[tag] = capsys.readouterr().out.replace(db, "DB")
    assert outs["t"] == outs["j"] and "archaea: 1 assemblies, 1 sequences" in outs["t"]
    for name in ("keys.npy", "taxa.npy"):
        assert (tmp_path / "t" / "idx" / name).read_bytes() == (tmp_path / "j" / "idx" / name).read_bytes()


def test_make_fai_and_masking_match(tmp_path):
    rng = np.random.default_rng(9)
    p = tmp_path / "g.fna"
    p.write_text(">s1 desc\nACGTACGTAC\nACGTA\n>s2\nGG\n>s3 x\n" + "".join(
        random_genome(rng, 70) + "\n" for _ in range(5)) + ">s4\n")
    assert open(download.make_fai(str(p))).read() == open(jdownload.make_fai(str(p))).read()
    assert inputs.read_fai(str(p) + ".fai") == jinputs.read_fai(str(p) + ".fai")
    seq = np.concatenate([rng.integers(0, 5, 300), np.zeros(200, np.int64), rng.integers(0, 4, 90),
                          np.tile([0, 3], 80)]).astype(np.uint8)
    for window, threshold in ((64, 1.2), (32, 1.5), (1000, 1.2)):
        got = download.mask_low_complexity(seq, window, threshold)
        assert np.array_equal(got, jdownload.mask_low_complexity(seq, window, threshold))
    assert (download.mask_low_complexity(seq)[300:500] == 4).all()
    data = b">s1\n" + b"ACGT" * 100 + b"\n" + b"A" * 200 + b"\nacgtnnAT" * 20 + b"\n"
    assert download.mask_low_complexity_fasta(data) == jdownload.mask_low_complexity_fasta(data)
    assert download.fasta_sequence_ids(data) == jdownload.fasta_sequence_ids(data)


def test_input_helpers_match(tmp_path):
    names = ["a.fa", "a.fasta.gz", "b.fna.bz2", "c.ffn", "d.faa", "e.frn", "f.fq", "g.fastq.gz", "h.txt", "fa"]
    for n in names:
        assert (inputs.is_fasta(n), inputs.is_fastq(n)) == (jinputs.is_fasta(n), jinputs.is_fastq(n))
    p = tmp_path / "x.fna"
    p.write_text(">s\nACGT\n")
    assert inputs.has_fai(str(p)) is jinputs.has_fai(str(p)) is False
    download.make_fai(str(p))
    assert inputs.has_fai(str(p)) is jinputs.has_fai(str(p)) is True


def test_compatibility_check_matches():
    base = dict(k=35, m=31, spaces=7)
    others = [dict(base), dict(base, buckets=7), dict(base, k=36), dict(base, m=30), dict(base, spaces=6),
              dict(base, toggle_mask=0), dict(base, canonical=False), dict(base, ordering="lexicographic")]
    for kw in others:
        outcome = []
        for params in (IndexParams, JParams):
            try:
                params(**base).compatibility_check(params(**kw))
                outcome.append(None)
            except ValueError as e:
                outcome.append(str(e).split(":")[0])
        assert outcome[0] == outcome[1]
    assert outcome[0] == "Incompatible index parameters"


@pytest.fixture(scope="module")
def library_dir(tmp_path_factory):
    """A library of three 3,000 bp genomes, a sequence of only Ns, one shorter
    than k and one with no valid run of k bases; labels for a taxon the
    taxonomy lacks; the taxonomy."""
    rng = np.random.default_rng(20261019)
    t = random_taxonomy(rng)
    root = tmp_path_factory.mktemp("lib")
    (root / "library").mkdir()
    genomes = make_genomes(rng, t, n_genomes=3, length=3000)
    records = [(f"g{i}", g) for i, (_, g) in enumerate(genomes)]
    records += [("allN", "N" * 500), ("short", "ACGTACGTAC"), ("broken", ("ACGTAGGCTA" * 3 + "N") * 20)]
    write_fasta(root / "library" / "a.fna", records[:3])
    write_fasta(root / "library" / "b.fna", records[3:])
    taxa = [tx for tx, _ in genomes]
    labels = [(h, taxa[i % 3]) for i, (h, _) in enumerate(records)] + [("ghost", 999_999)]
    (root / "seqid2taxid.map").write_text("".join(f"{h}\t{tx}\n" for h, tx in labels))
    t.save(str(root / "taxonomy"))
    return root


def _both(capsys, argv, root, tmp_path, device=True):
    """stdout of each CLI on argv, with the output paths made equal."""
    outs = []
    for tag, main in (("j", jcli.main), ("t", cli.main)):
        capsys.readouterr()
        args = [a.replace("@OUT", str(tmp_path / tag)) for a in argv]
        assert main(args + (["--device", "cpu"] if tag == "t" and device else [])) == 0
        outs.append(capsys.readouterr().out.replace(str(tmp_path / tag), "OUT"))
    return outs


def test_cli_input_check_matches_without_cuda(library_dir, tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["inputCheck", "-t", str(library_dir / "taxonomy"), "--labels", str(library_dir / "seqid2taxid.map")],
                 ["inputCheck", "-t", str(library_dir / "taxonomy")]):
        want, got = _both(capsys, argv, library_dir, tmp_path, device=False)
        assert got == want
    assert '"undefined_taxa": 1' in _both(capsys, argv[:3] + ["--labels", str(library_dir / "seqid2taxid.map")],
                                         library_dir, tmp_path, device=False)[1]


def test_cli_build_check_matches(library_dir, tmp_path, capsys):
    argv = ["build", "--check", "-i", "@OUT", "-l", str(library_dir), "-t", str(library_dir / "taxonomy"), "-k", "31"]
    want, got = _both(capsys, argv, library_dir, tmp_path)
    assert got == want and "(total 3):" in got and "  broken" in got
    assert not os.path.exists(str(tmp_path / "t"))
    assert inputs.check_input(inputs.GenomeLibrary.from_directory(str(library_dir)), 35) == \
        jinputs.check_input(jinputs.GenomeLibrary.from_directory(str(library_dir)), 35)


@pytest.mark.parametrize("flags", [[], ["-k", "21", "-m", "15", "-s", "2", "--full-records"]])
def test_cli_build_prints_what_the_reference_prints(library_dir, tmp_path, capsys, flags):
    """The whole of stdout: the file count, the saved line, the index
    statistics and the input-statistics JSON (timing goes to stderr)."""
    argv = ["build", "-i", "@OUT", "-l", str(library_dir), "-t", str(library_dir / "taxonomy"), *flags]
    want, got = _both(capsys, argv, library_dir, tmp_path)
    assert got == want
    assert got.startswith("Discovered 2 genome files\nSaved ") and "Tree size:" in got and '"sequences": 7' in got


@pytest.mark.parametrize("per_read", [False, True])
def test_classify_packed_matches_jax(per_read):
    """classify_packed of each package on the same chunks: equal reads
    (sample, flag, title, taxon, length string and hit details) at every
    threshold, the order of the stream kept."""
    rng = np.random.default_rng(20261020)
    t = random_taxonomy(rng)
    lib = make_genomes(rng, t, n_genomes=6, length=3000)
    chunks = [_reads(rng, lib, n, w, f"c{i}_", genomes=6) for i, (n, w) in enumerate([(90, 128), (40, 264), (70, 128)])]
    tchunks = [native.PackedReads(c.codes, c.lengths, list(c.titles)) for c in chunks]
    kw = dict(thresholds=[0.0, 0.1, 0.4], per_read_output=per_read, sample_regex=r"(s\d)_", min_hit_groups=2)
    want = JClassifier(JIndex.build(lib, JParams(), t)).classify_packed(iter(chunks), JClassifyParams(**kw))
    got = Classifier(KeyValueIndex.build(lib, IndexParams(), t, "cpu"), "cpu").classify_packed(
        iter(tchunks), ClassifyParams(**kw))
    fields = lambda r: (r.sample_id, r.classified, r.title, r.taxon, r.length_string, r.hit_details)  # noqa: E731
    assert list(got) == list(want)
    for th in want:
        assert [fields(r) for r in got[th]] == [fields(r) for r in want[th]] and len(got[th]) == 200
    assert sum(r.classified for r in got[0.0]) > 100
    assert all(r.hit_details == "" for r in got[0.0]) != per_read
