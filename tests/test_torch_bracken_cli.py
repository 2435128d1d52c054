"""Bracken weights of the port against slacken_tpu's on the CPU: gradual
chunk files written by one package and resumed by the other, and both CLIs'
bracken-build and classify2 --bracken-length, byte for byte. The libraries
and indexes are test_torch_bracken.py's."""

import os

import numpy as np
import pytest
import torch

import slacken_tpu.bracken as jbracken
from slacken_tpu import cli as jcli
from slacken_tpu_torch import bracken, cli
from test_inputs_cli import write_fasta, write_fastq
from test_torch_bracken import R, World

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def world():
    return World()


@pytest.mark.parametrize("first", ["jax", "port"])
def test_gradual_chunks_resume_across_packages(world, tmp_path, monkeypatch, first):
    """One package writes the chunk files, one chunk is lost, the other
    package resumes: it computes that chunk alone, and the totals equal a
    run without chunks."""
    jidx, tidx = world.index("plain", "narrow", "jax"), world.index("plain", "narrow")
    makers = {"jax": (jbracken.BrackenWeights, lambda: jbracken.BrackenWeights(jidx, R)),
              "port": (bracken.BrackenWeights, lambda: bracken.BrackenWeights(tidx, R, device="cpu"))}
    second = "port" if first == "jax" else "jax"
    lib, taxa = world.library("plain"), world.taxa("plain")
    tmp = str(tmp_path / "tmp")
    want = makers[first][1]().build_weights_gradually(lib, taxa, tmp, chunks=3)
    files = sorted(os.listdir(tmp))
    assert len(files) >= 3
    lost = os.path.join(tmp, files[-1])
    kept = dict(np.load(lost))
    os.unlink(lost)
    cls = makers[second][0]
    calls = []
    real = cls.build_weights

    def counting(self, library, taxa_set):
        calls.append(sorted(taxa_set))
        return real(self, library, taxa_set)

    monkeypatch.setattr(cls, "build_weights", counting)
    assert makers[second][1]().build_weights_gradually(lib, taxa, tmp, chunks=3) == want
    assert len(calls) == 1
    again = dict(np.load(lost))
    assert {k: v.dtype for k, v in again.items()} == {k: np.dtype(np.int64) for k in ("dest", "source", "count")}
    assert {k: v.tolist() for k, v in again.items()} == {k: v.tolist() for k, v in kept.items()}
    assert want == jbracken.BrackenWeights(jidx, R).build_weights(lib, taxa)


@pytest.fixture(scope="module")
def cli_world(world, tmp_path_factory):
    """A library directory (the `ns` library), its taxonomy, and an index of
    each kind built by each package's CLI."""
    root = tmp_path_factory.mktemp("cli")
    (root / "lib" / "library").mkdir(parents=True)
    with open(root / "lib" / "seqid2taxid.map", "w") as f:
        for i, (taxon, g) in enumerate(world.indexed["ns"] + world.extra):
            write_fasta(root / "lib" / "library" / f"g{i}.fna", [(f"seq{i}", g)])
            f.write(f"seq{i}\t{taxon}\n")
    world.tax.save(str(root / "taxonomy"))
    reads = []
    for i in range(30):
        _, g = world.indexed["ns"][i % 2]
        reads.append((f"read{i}", g[40 * i : 40 * i + 101]))
    write_fastq(str(root / "reads.fastq"), reads)
    (root / "gold.txt").write_text(f"{world.indexed['ns'][0][0]}\n{world.indexed['ns'][1][0]}\n")
    for kind, flags in (("narrow", []), ("lexicographic", ["-k", "21", "-m", "11", "-s", "2",
                                                           "--ordering", "lexicographic"])):
        common = ["-l", str(root / "lib"), "-t", str(root / "taxonomy"), *flags]
        assert jcli.main(["build", "-i", str(root / f"j{kind}"), *common]) == 0
        assert cli.main(["build", "-i", str(root / f"t{kind}"), *common, "--device", "cpu"]) == 0
    return root


@pytest.mark.parametrize("gradual", [True, False])
def test_cli_bracken_build_matches(cli_world, capsys, gradual):
    extra = [] if gradual else ["--no-gradual"]
    capsys.readouterr()
    assert jcli.main(["bracken-build", "-i", str(cli_world / "jnarrow"), "-l", str(cli_world / "lib"), *extra]) == 0
    jout = capsys.readouterr().out
    assert cli.main(["bracken-build", "-i", str(cli_world / "tnarrow"), "-l", str(cli_world / "lib"), *extra,
                     "--device", "cpu"]) == 0
    tout = capsys.readouterr().out
    want = (cli_world / "jnarrow_bracken" / "database100mers.kmer_distrib").read_bytes()
    got = (cli_world / "tnarrow_bracken" / "database100mers.kmer_distrib").read_bytes()
    assert got == want and got.count(b"\n") > 3
    assert tout.replace("tnarrow", "jnarrow") == jout and tout.startswith("Wrote ")
    assert not os.path.exists(str(cli_world / "tnarrow_bracken" / "database100mers.kmer_distrib_tmp"))


def test_cli_classify2_bracken_length_matches(cli_world, tmp_path, capsys):
    """classify2 --bracken-length over a rank-table index, the dynamic index
    made from a gold set: weights and classification byte-identical."""
    common = [str(cli_world / "reads.fastq"), "-l", str(cli_world / "lib"), "-g", str(cli_world / "gold.txt"),
              "--classify-with-gold", "--bracken-length", "100"]
    capsys.readouterr()
    assert jcli.main(["classify2", *common, "-i", str(cli_world / "jlexicographic"),
                      "-o", str(tmp_path / "j" / "o")]) == 0
    jout = capsys.readouterr().out
    assert cli.main(["classify2", *common, "-i", str(cli_world / "tlexicographic"),
                     "-o", str(tmp_path / "t" / "o"), "--device", "cpu"]) == 0
    assert capsys.readouterr().out == jout
    for rel in (("o", "database100mers.kmer_distrib"), ("o_c0.0", "all_kreport.txt")):
        want, got = (tmp_path / "j").joinpath(*rel).read_bytes(), (tmp_path / "t").joinpath(*rel).read_bytes()
        assert got == want and got.count(b"\n") >= 2
