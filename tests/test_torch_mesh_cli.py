"""The port's CLI over a device mesh on the CPU (--device cpu --devices 8):
`build --devices 8 --shards 4`, `classify --devices 8 --layout ring` and
`replicated` (reports and per-read) and `classify2 --devices 8 --layout ring`
on a library and simulated reads made with workloads.py, byte-identical to
the port's single-device CLI and to slacken_tpu.cli with the same arguments;
--devices above the number of cards raises with --device cuda."""

import gzip
import os

import numpy as np
import pytest
import torch

from slacken_tpu import cli as jcli
from slacken_tpu_torch import cli, workloads
from slacken_tpu_torch.index import KeyValueIndex
from test_index import random_genome
from test_taxonomy import random_taxonomy

torch.set_num_threads(1)

CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A library of four 5 kbp genomes on species leaves, its single-device
    index and its index built over 8 CPU shards and saved in 4 shard files,
    and 120 simulated reads from the first two genomes."""
    base = tmp_path_factory.mktemp("mesh_cli")
    rng = np.random.default_rng(20261020)
    tax = random_taxonomy(rng)
    species = [int(x) for x in tax.taxa() if tax.is_leaf(x) and tax.depth(x) == 8]
    genomes = [(t, random_genome(rng, 5000)) for t in rng.choice(species, 4, replace=False).tolist()]
    workloads.write_library(genomes, str(base / "lib"))
    tax.save(str(base / "taxonomy"))
    reads = [workloads._simulated(seq, rng, 60, taxon) for taxon, seq in genomes[:2]]
    workloads.write_fastq(reads, str(base / "reads.fastq"))
    lib = ["-l", str(base / "lib"), "-t", str(base / "taxonomy")]
    assert cli.main(["build", "-i", str(base / "idx1"), *lib, *CPU]) == 0
    assert cli.main(["build", "-i", str(base / "idx8"), *lib, "--devices", "8", "--shards", "4", *CPU]) == 0
    return base


def tree(loc):
    """{path below loc: bytes}, .gz inflated."""
    out = {}
    for root, _, names in os.walk(loc):
        for name in names:
            path = os.path.join(root, name)
            with (gzip.open if name.endswith(".gz") else open)(path, "rb") as f:
                out[os.path.relpath(path, loc)] = f.read()
    return out


def test_build_over_the_mesh_with_shards(world, tmp_path):
    """build --devices 8 --shards 4 holds the single-device index in
    slacken_tpu's sharded files (its `build --shards 4`, byte for byte)."""
    one, eight = KeyValueIndex.load(str(world / "idx1")), KeyValueIndex.load(str(world / "idx8"))
    assert one.num_records > 5000
    assert np.array_equal(one.keys, eight.keys) and np.array_equal(one.taxa, eight.taxa)
    assert jcli.main(["build", "-i", str(tmp_path / "j"), "-l", str(world / "lib"), "-t", str(world / "taxonomy"),
                      "--shards", "4"]) == 0
    got = tree(str(world / "idx8"))
    assert got == tree(str(tmp_path / "j"))
    assert sorted(k for k in got if k.startswith("keys.")) == [f"keys.{i:05d}.npy" for i in range(4)]


@pytest.mark.parametrize("detailed", [True, False], ids=["per_read", "reports"])
@pytest.mark.parametrize("layout", ["ring", "replicated"])
def test_classify_over_the_mesh(world, tmp_path, layout, detailed):
    """classify --devices 8 --layout L from the sharded index: the files of
    the port's single-device run and of slacken_tpu's mesh run."""
    extra = [] if detailed else ["--no-detailed"]
    common = ["classify", str(world / "reads.fastq"), "-c", "0.0", "0.15", *extra]
    assert cli.main([*common, "-i", str(world / "idx1"), "-o", str(tmp_path / "one" / "o"), *CPU]) == 0
    mesh = ["--devices", "8", "--layout", layout]
    assert cli.main([*common, "-i", str(world / "idx8"), "-o", str(tmp_path / "mesh" / "o"), *mesh, *CPU]) == 0
    assert jcli.main([*common, "-i", str(world / "idx8"), "-o", str(tmp_path / "jax" / "o"), *mesh]) == 0
    want = tree(str(tmp_path / "one"))
    assert len(want) == (4 if detailed else 2)
    assert tree(str(tmp_path / "mesh")) == want
    assert tree(str(tmp_path / "jax")) == want
    report = want[os.path.join("o_c0.00", "all_kreport.txt")].decode()
    assert report.splitlines()[1].split("\t")[1:5] == ["120", "0", "R", "1"] and len(report.splitlines()) > 3


def test_classify2_over_the_mesh(world, tmp_path):
    """classify2 --devices 8 --layout ring (a minimizer criterion: the span
    hits go round the ring; the index has no sidecar, so the dynamic index
    comes from build_distributed)."""
    common = ["classify2", str(world / "reads.fastq"), "-l", str(world / "lib"), "-c", "0.0", "-D", "20"]
    assert cli.main([*common, "-i", str(world / "idx1"), "-o", str(tmp_path / "one" / "o"), *CPU]) == 0
    mesh = ["--devices", "8", "--layout", "ring"]
    assert cli.main([*common, "-i", str(world / "idx8"), "-o", str(tmp_path / "mesh" / "o"), *mesh, *CPU]) == 0
    assert jcli.main([*common, "-i", str(world / "idx8"), "-o", str(tmp_path / "jax" / "o"), *mesh]) == 0
    want = tree(str(tmp_path / "one"))
    assert sorted(want) == ["o_c0.0/all_kreport.txt", "o_c0.0/sample=all/part-00000.txt.gz", "o_taxonSet.txt"]
    assert len(want["o_taxonSet.txt"].split()) == 2
    assert tree(str(tmp_path / "mesh")) == want
    assert tree(str(tmp_path / "jax")) == want


def test_devices_above_the_cards_raise(world, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2-device mesh but the machine has 1"):
        cli.main(["classify", str(world / "reads.fastq"), "-i", str(world / "idx1"), "-o", str(tmp_path / "o"),
                  "--devices", "2", "--layout", "ring"])
    with pytest.raises(ValueError, match="2-device mesh"):
        cli.main(["build", "-i", str(tmp_path / "idx"), "-l", str(world / "lib"), "-t", str(world / "taxonomy"),
                  "--devices", "2"])
    assert not os.path.exists(tmp_path / "o_c0.0")
