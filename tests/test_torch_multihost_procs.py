"""The port's multi-process classify over two gloo ranks on the CPU, two
ring entries each: a global ring of 4 over 8 shard files, the boundary hops
crossing between the processes. The library (ranks spawned with
torch.multiprocessing, file:// rendezvous) against the single-device
classify; the CLI (classify --coordinator 127.0.0.1:<port> --num-processes 2
--process-id p, one subprocess a rank) on 101 reads, so that one rank's
share issues an all-padding batch, against the single-process port CLI and
slacken_tpu's single-process CLI: kreports byte-identical, part files
joined in name order byte-identical."""

import gzip
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import multihost_ranks
from slacken_tpu import cli as jcli
from slacken_tpu_torch import cli, workloads
from slacken_tpu_torch.classify import Classifier, ClassifyParams
from slacken_tpu_torch.index import KeyValueIndex
from test_index import random_genome
from test_taxonomy import random_taxonomy

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Three 4 kbp genomes on leaves, their index (one file, and 8 shard
    files), and 101 simulated reads of them in a FASTQ file."""
    base = tmp_path_factory.mktemp("mh_procs")
    rng = np.random.default_rng(20261022)
    tax = random_taxonomy(rng)
    leaves = [int(x) for x in tax.taxa() if tax.is_leaf(x)][:3]
    genomes = [(t, random_genome(rng, 4000)) for t in leaves]
    workloads.write_library(genomes, str(base / "lib"))
    tax.save(str(base / "taxonomy"))
    reads = [workloads._simulated(seq, rng, n, t) for (t, seq), n in zip(genomes, (34, 34, 33))]
    workloads.write_fastq(reads, str(base / "reads.fastq"))
    lib = ["-l", str(base / "lib"), "-t", str(base / "taxonomy"), "--device", "cpu"]
    assert cli.main(["build", "-i", str(base / "idx1"), *lib]) == 0
    assert cli.main(["build", "-i", str(base / "idx8"), *lib, "--shards", "8"]) == 0
    return base, reads


def files(loc):
    """{path below loc: bytes}, .gz inflated, the part files of a directory
    joined in name order under the first one's name."""
    out = {}
    for root, _, names in os.walk(loc):
        for name in sorted(names):
            path = os.path.join(root, name)
            with (gzip.open if name.endswith(".gz") else open)(path, "rb") as f:
                data = f.read()
            key = os.path.relpath(os.path.join(root, "part-00000.txt.gz" if name.startswith("part-") else name), loc)
            out[key] = out.get(key, b"") + data
    return out


def part_names(loc):
    return sorted(name for _, _, names in os.walk(loc) for name in names if name.startswith("part-"))


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_library_ring_of_two_processes(world, tmp_path):
    """Two spawned ranks, 2 CPU entries each, per-read mode in batches of 10
    rows: 6 batches a rank (51 reads the larger share), so rank 0 (50 reads)
    issues one all-padding batch; the files equal the single-device run's,
    every boundary hop sends what the shapes say, and the collectives of two
    ranks gather and sum."""
    base, reads = world
    cpar = ClassifyParams(thresholds=[0.0, 0.15], per_read_output=True)
    Classifier(KeyValueIndex.load(str(base / "idx1")), "cpu").classify_and_write_packed(
        reads, str(tmp_path / "one" / "o"), cpar)
    spec = dict(url=f"file://{tmp_path}/rdzv", device="cpu", devices=2, backend=None, index=str(base / "idx8"),
                reads=multihost_ranks.chunks_of(reads), out=str(tmp_path / "mh" / "o"), thresholds=[0.0, 0.15],
                per_read=True, rows=10, report=str(tmp_path / "rank%d.json"))
    seen = multihost_ranks.spawn(2, spec)
    want = files(tmp_path / "one")
    assert files(tmp_path / "mh") == want and len(want) == 4
    assert part_names(tmp_path / "mh") == ["part-00000.txt.gz", "part-00000.txt.gz",
                                           "part-00001.txt.gz", "part-00001.txt.gz"]
    assert [s["padding"] for s in seen] == [1, 0]
    assert [s["lockstep"] for s in seen] == [[6, 10, 128]] * 2
    # a batch: 3 hops of queries (5 rows x 128, int64) and answers (int32), then the answers home
    assert [s["p2p"] for s in seen] == [6 * (3 * 5 * 128 * 12 + 5 * 128 * 4)] * 2
    assert [s["backend"] for s in seen] == ["gloo"] * 2 and seen[0]["mesh"] == ["cpu", "cpu"]
    assert [s["gathered"] for s in seen] == [[{"rank": 0}, {"rank": 1}]] * 2
    assert [s["counts"] for s in seen] == [[0, 3, 6, 9, 12]] * 2
    assert seen[0]["samples"] == seen[1]["samples"] == {"0.0": ["all"], "0.15": ["all"]}


def test_cli_two_processes_equal_one_and_the_jax_cli(world, tmp_path):
    """classify --coordinator in two subprocesses (gloo, --devices 2,
    STPU_MH_ROWS=10) against the port's and slacken_tpu's single-process
    CLI; process 0 says it issued an all-padding batch."""
    base, _ = world
    fq = str(base / "reads.fastq")
    common = ["classify", fq, "-c", "0.0", "0.15"]
    assert cli.main([*common, "-i", str(base / "idx1"), "-o", str(tmp_path / "one" / "o"), "--device", "cpu"]) == 0
    assert jcli.main([*common, "-i", str(base / "idx1"), "-o", str(tmp_path / "jax" / "o")]) == 0
    port = free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, STPU_MH_ROWS="10", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "slacken_tpu_torch.cli", *common, "-i", str(base / "idx8"),
         "-o", str(tmp_path / "mh" / "o"), "--device", "cpu", "--devices", "2",
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2", "--process-id", str(rank)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for rank in range(2)]
    said = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=multihost_ranks.TIMEOUT)
            assert p.returncode == 0, err[-3000:]
            said.append((out, err))
    finally:
        for p in procs:
            p.kill()
    want = files(tmp_path / "one")
    assert len(want) == 4 and files(tmp_path / "jax") == want
    assert files(tmp_path / "mh") == want
    assert len(part_names(tmp_path / "mh")) == 4
    assert "6 batches of 10 x 128, 1 all padding" in said[0][1]
    assert "6 batches of 10 x 128, 0 all padding" in said[1][1]
    assert "threshold 0.0: samples ['all']" in said[0][0] and said[1][0] == ""
    report = want[os.path.join("o_c0.00", "all_kreport.txt")].decode()
    assert report.splitlines()[1].split("\t")[1:5] == ["101", "0", "R", "1"]
