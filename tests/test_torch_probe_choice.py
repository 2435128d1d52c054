"""The probe choice end to end on the CPU (`--probe` / `probe=`): the
port's classify CLI with --probe tiled and hashed1 on one device, for a
narrow (35, 31, 7), a wide (50, 45, 7) and a rank-table (35, 13, 3) index,
and its classify2 CLI (Dynamic: step 1's span hits and the final classify)
on one device and over the ring of 8 CPU shards, write kreports and
per-read files byte-identical to the port's --probe routed and to
slacken_tpu's CLI with the same --probe. The rejections: a wide index with
hashed, hashed128 or bucketed, unknown names, --coordinator with
hashed128 and the multi-host ring's wide tiled, each raising as the JAX
package raises; STPU_PROBE and STPU_MH_PROBE. The three narrow-only
probes: test_torch_probe_hashed.py. Over a mesh and over
processes: test_torch_probe_mesh.py."""

import gzip
import os

import numpy as np
import pytest
import torch

from slacken_tpu import cli as jcli
from slacken_tpu.classify import Classifier as JClassifier
from slacken_tpu.index import KeyValueIndex as JIndex
from slacken_tpu_torch import cli, workloads
from slacken_tpu_torch.classify import Classifier, ClassifyParams, Fragment
from slacken_tpu_torch.index import KeyValueIndex
from slacken_tpu_torch.ops import lookup
from slacken_tpu_torch.parallel import multihost
from test_index import random_genome
from test_taxonomy import random_taxonomy

torch.set_num_threads(1)

CPU = ["--device", "cpu"]
KINDS = {"narrow": [], "wide": ["-k", "50", "-m", "45"], "rank table": ["-m", "13", "-s", "3", "--ordering", "signature"]}
PROBES = ["tiled", "hashed1"]


def make_world(base, kinds, sharded=None):
    """Four 5 kbp genomes on species leaves written as a library under
    `base`, per kind of `kinds` its index in one file and, for the kinds of
    `sharded` (default: all), in 8 shard files, and 120 simulated reads of
    two of the genomes."""
    rng = np.random.default_rng(20261023)
    tax = random_taxonomy(rng)
    species = [int(x) for x in tax.taxa() if tax.is_leaf(x) and tax.depth(x) == 8]
    genomes = [(t, random_genome(rng, 5000)) for t in rng.choice(species, 4, replace=False).tolist()]
    workloads.write_library(genomes, str(base / "lib"))
    tax.save(str(base / "taxonomy"))
    reads = [workloads._simulated(seq, rng, 60, taxon) for taxon, seq in genomes[:2]]
    workloads.write_fastq(reads, str(base / "reads.fastq"))
    lib = ["-l", str(base / "lib"), "-t", str(base / "taxonomy"), *CPU]
    for kind in kinds:
        assert cli.main(["build", "-i", str(base / f"{kind}1"), *lib, *KINDS[kind]]) == 0
        if sharded is None or kind in sharded:
            assert cli.main(["build", "-i", str(base / f"{kind}8"), *lib, *KINDS[kind], "--shards", "8"]) == 0
    return base


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return make_world(tmp_path_factory.mktemp("probe_choice"), KINDS)


def tree(loc):
    """{path below loc: bytes}, .gz inflated."""
    out = {}
    for root, _, names in os.walk(loc):
        for name in names:
            path = os.path.join(root, name)
            with (gzip.open if name.endswith(".gz") else open)(path, "rb") as f:
                out[os.path.relpath(path, loc)] = f.read()
    return out


def run(main, out, *args):
    assert main([*args, "-o", str(out / "o")]) == 0
    return tree(str(out))


def routed_files(world, base, kinds):
    """kind -> the files of the port's single-device classify, --probe routed."""
    return {kind: run(cli.main, base / kind, "classify", str(world / "reads.fastq"), "-c", "0.0", "0.15",
                      "-i", str(world / f"{kind}1"), "--probe", "routed", *CPU) for kind in kinds}


@pytest.fixture(scope="module")
def routed(world, tmp_path_factory):
    return routed_files(world, tmp_path_factory.mktemp("routed"), KINDS)


@pytest.mark.parametrize("probe", PROBES)
@pytest.mark.parametrize("kind", KINDS)
def test_classify_cli_probe(world, routed, tmp_path, kind, probe):
    """classify --probe P: the port on one device == its routed run ==
    slacken_tpu's CLI with --probe P (per-read lines and kreports)."""
    common = ["classify", str(world / "reads.fastq"), "-c", "0.0", "0.15", "-i", str(world / f"{kind}1"),
              "--probe", probe]
    want = routed[kind]
    assert len(want) == 4 and want[os.path.join("o_c0.00", "all_kreport.txt")].count(b"\n") > 3
    assert run(cli.main, tmp_path / "port", *common, *CPU) == want
    assert run(jcli.main, tmp_path / "jax", *common) == want


@pytest.mark.parametrize("probe", PROBES)
def test_classify2_cli_probe(world, tmp_path, probe):
    """classify2 --probe P (step 1's span hits and the final classify
    through the table): the port == its routed run == slacken_tpu's
    classify2 --probe P; and over the ring of 8 CPU shards."""
    common = ["classify2", str(world / "reads.fastq"), "-l", str(world / "lib"), "-c", "0.0", "-D", "20",
              "-i", str(world / "narrow1")]
    want = run(cli.main, tmp_path / "routed", *common, *CPU)
    assert sorted(want) == ["o_c0.0/all_kreport.txt", "o_c0.0/sample=all/part-00000.txt.gz", "o_taxonSet.txt"]
    assert len(want["o_taxonSet.txt"].split()) == 2
    assert run(cli.main, tmp_path / "port", *common, "--probe", probe, *CPU) == want
    assert run(jcli.main, tmp_path / "jax", *common, "--probe", probe) == want
    mesh = ["--devices", "8", "--layout", "ring", "--probe", probe]
    assert run(cli.main, tmp_path / "ring", *common, *mesh, *CPU) == want


def test_later_probes_and_unknown_names_raise(world):
    """hashed, hashed128 and bucketed run on a narrow index (their tables),
    an unknown name raises ValueError (as slacken_tpu's); a wide index with
    any of the three raises NotImplementedError in both packages. Nothing
    runs another probe in their place."""
    narrow, wide = (KeyValueIndex.load(str(world / f"{k}1")) for k in ("narrow", "wide"))
    lines = (world / "reads.fastq").read_text().splitlines()
    frags = [Fragment(lines[i][1:], lines[i + 1]) for i in range(0, len(lines), 4)]
    cpar = ClassifyParams(thresholds=[0.0])
    want = Classifier(narrow, "cpu").classify(frags, cpar)
    tables = {"hashed": lookup.HashedTable, "hashed128": lookup.HashedTable, "bucketed": lookup.Bucketed}
    for probe, table in tables.items():
        cls = Classifier(narrow, "cpu", probe=probe)
        assert cls.probe == probe and isinstance(cls._directory, table)
        assert cls._directory.cols == (probe == "hashed128") if table is lookup.HashedTable else True
        assert cls.classify(frags, cpar) == want
    with pytest.raises(ValueError, match="unknown probe"):
        Classifier(narrow, "cpu", probe="nope")
    with pytest.raises(ValueError, match="unknown probe"):
        JClassifier(JIndex.load(str(world / "narrow1")), probe="nope")
    for probe in tables:
        with pytest.raises(NotImplementedError, match="routed, tiled and hashed1"):
            Classifier(wide, "cpu", probe=probe)
        with pytest.raises(NotImplementedError, match="m <= 31"):
            wide.device_arrays("cpu", probe)
        with pytest.raises(NotImplementedError, match="routed, tiled and hashed1"):
            JClassifier(JIndex.load(str(world / "wide1")), probe=probe)
    for probe in ("tiled", "hashed1"):
        assert Classifier(wide, "cpu", probe=probe).probe == probe


def test_cli_refusals(world, tmp_path):
    """--coordinator with hashed128 exits in both CLIs before any group is
    made; an unknown --probe is argparse's error in both."""
    fq = str(world / "reads.fastq")
    common = ["classify", fq, "-i", str(world / "narrow8"), "-o", str(tmp_path / "o"), "--coordinator",
              "127.0.0.1:1", "--num-processes", "2", "--process-id", "0", "--probe", "hashed128"]
    with pytest.raises(SystemExit, match="supports --probe routed/tiled/hashed/hashed1"):
        cli.main([*common, *CPU])
    # slacken_tpu's main joins jax.distributed first; its multi-host classify checks --probe before any use of it
    args = jcli._build_parser().parse_args(common)
    with pytest.raises(SystemExit, match="supports --probe routed/tiled/hashed/hashed1"):
        jcli.cmd_classify(args)
    assert not torch.distributed.is_initialized()
    for main in (cli.main, jcli.main):
        with pytest.raises(SystemExit):
            main(["classify", fq, "-i", str(world / "narrow1"), "-o", str(tmp_path / "x"), "--probe", "nope"])


def test_environment_chooses_the_probe(world, monkeypatch):
    """STPU_PROBE without probe=, STPU_MH_PROBE without mh_probe=, as the
    JAX package reads them; an explicit choice wins."""
    narrow = KeyValueIndex.load(str(world / "narrow1"))
    assert Classifier(narrow, "cpu").probe == "routed"
    monkeypatch.setenv("STPU_PROBE", "hashed1")
    assert Classifier(narrow, "cpu").probe == "hashed1"
    assert Classifier(narrow, "cpu", probe="tiled").probe == "tiled"
    ctx = multihost.initialize(device="cpu", devices=2)
    monkeypatch.setenv("STPU_MH_PROBE", "tiled")
    cls = multihost.MultiHostRingClassifier(str(world / "narrow8"), ctx)
    assert cls.probe == "tiled" and all(type(a[2]).__name__ == "TiledTable" for a in cls._arrays)
    cls = multihost.MultiHostRingClassifier(str(world / "narrow8"), ctx, mh_probe="hashed")
    assert cls.probe == "hashed" and all(type(a[2]).__name__ == "HashedTable" for a in cls._arrays)
    with pytest.raises(ValueError, match="routed/tiled/hashed/hashed1"):
        multihost.MultiHostRingClassifier(str(world / "narrow8"), ctx, mh_probe="hashed128")
    with pytest.raises(ValueError, match="routed and hashed1"):
        multihost.MultiHostRingClassifier(str(world / "wide8"), ctx)
    with pytest.raises(ValueError, match="routed and hashed1"):
        multihost.MultiHostRingClassifier(str(world / "wide8"), ctx, mh_probe="hashed")
