"""The probe choice over a mesh and over processes on the CPU: the port's
classify CLI with --probe tiled and hashed1 over 8 CPU shards in both
layouts (against slacken_tpu's mesh run) and with --coordinator in a world
of one (a gloo group over two ring entries, each entry's own table),
narrow (35, 31, 7) and wide (50, 45, 7), writes the files of the port's
single-device --probe routed run."""

import socket

import pytest
import torch

from slacken_tpu import cli as jcli
from slacken_tpu_torch import cli
from test_torch_probe_choice import CPU, PROBES, make_world, routed_files, run

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return make_world(tmp_path_factory.mktemp("probe_mesh"), ["narrow", "wide"])


@pytest.fixture(scope="module")
def routed(world, tmp_path_factory):
    return routed_files(world, tmp_path_factory.mktemp("routed"), ["narrow", "wide"])


@pytest.mark.parametrize("probe", PROBES)
@pytest.mark.parametrize("layout", ["ring", "replicated"])
def test_classify_cli_probe_over_the_mesh(world, routed, tmp_path, layout, probe):
    """classify --devices 8 --layout L --probe P from the 8 shard files:
    the port's routed single-device files, and slacken_tpu's mesh run."""
    common = ["classify", str(world / "reads.fastq"), "-c", "0.0", "0.15", "-i", str(world / "narrow8"),
              "--devices", "8", "--layout", layout, "--probe", probe]
    assert run(cli.main, tmp_path / "port", *common, *CPU) == routed["narrow"]
    assert run(jcli.main, tmp_path / "jax", *common) == routed["narrow"]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("probe", PROBES)
@pytest.mark.parametrize("kind", ["narrow", "wide"])
def test_classify_cli_probe_over_processes(world, routed, tmp_path, monkeypatch, kind, probe):
    """classify --coordinator in a world of one (a gloo group over two
    ring entries of the CPU) with --probe P: the routed single-device files.
    A wide index takes routed and hashed1 there, and tiled exits."""
    common = ["classify", str(world / "reads.fastq"), "-c", "0.0", "0.15", "-i", str(world / f"{kind}8"), *CPU,
              "--devices", "2", "--coordinator", f"127.0.0.1:{_free_port()}", "--num-processes", "1",
              "--process-id", "0", "--probe", probe]
    monkeypatch.setenv("STPU_MH_ROWS", "64")  # batches of 64 reads, not a 1 Mbp batch of padding
    if kind == "wide" and probe == "tiled":
        with pytest.raises(ValueError, match="routed and hashed1"):
            cli.main([*common, "-o", str(tmp_path / "o")])
        assert not torch.distributed.is_initialized()
        return
    assert run(cli.main, tmp_path / "mh", *common) == routed[kind]
    assert not torch.distributed.is_initialized()
