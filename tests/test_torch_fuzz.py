"""The port's oracle fuzz harness (slacken_tpu_torch/fuzz.py) on the CPU:
seeded iterations under each of the six narrow and three wide probe choices
and over meshes of CPU shards, each holding classify, classify_packed and
the written per-read and kreport files to the oracle, dense and under hit
runs; a planted fault that the harness must report with a repro and exit 1;
and the module run as a program."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from slacken_tpu_torch import fuzz, oracle
from slacken_tpu_torch.taxonomy import ROOT

torch.set_num_threads(1)

ROOT_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")

#: two seeds under each (probe, wide) choice
CHOICE_CASES = [(p, w, seed) for j, (p, w) in enumerate(fuzz.CHOICES) for seed in (j, 100 + j)]
#: seeds whose free draw runs over a mesh: (seed, shards, layout, probe)
MESH_CASES = [(0, 3, "ring", "hashed1"), (49, 4, "replicated", "bucketed"), (60, 3, "ring", "hashed"),
              (76, 2, "ring", "hashed128"), (78, 2, "replicated", "routed")]
#: the planted fault's draw: a narrow index under the hashed probe
PLANTED_SEED, PLANTED_PROBE = 11, "hashed"
REPRO_KEYS = {"seed", "k", "m", "s", "probe", "path", "threshold", "gate", "title", "seq", "seq2", "got", "want"}


@pytest.mark.parametrize("probe,wide,seed", CHOICE_CASES,
                         ids=[f"{p}-{'wide' if w else 'narrow'}-{s}" for p, w, s in CHOICE_CASES])
def test_iteration_matches_the_oracle(probe, wide, seed, tmp_path):
    r = fuzz.fuzz_iteration(seed, seed, "cpu", probe, wide, out=str(tmp_path))
    assert r["probe"] == probe and (r["m"] > 31) == wide
    # classify, classify_packed and the per-read line a read, and the kreport, a threshold and mode
    assert r["checks"] == r["reads"] * r["thresholds"] and r["thresholds"] >= 1
    assert r["comparisons"] == 2 * r["thresholds"] * (3 * r["reads"] + 1)


@pytest.mark.parametrize("seed,shards,layout,probe", MESH_CASES)
def test_mesh_iteration_matches_the_oracle(seed, shards, layout, probe, tmp_path):
    r = fuzz.fuzz_iteration(seed, seed, "cpu", out=str(tmp_path))
    assert r["mesh"] == (shards, layout) and r["probe"] == probe


def test_draws_cover_the_edges():
    """Every draw carries the edge reads, thresholds and a gate from the
    script's sets, and a (k, m) that its probe takes; some draws are paired."""
    paired = 0
    for seed in range(30):
        case = fuzz.draw_case(0, seed, CPU)
        paired += sum(f.seq2 is not None for f in case.frags)
        titles = [f.title for f in case.frags[-5:]]
        assert titles == ["short", "allN", "kminus1", "exactk", "manyruns"]
        assert len(case.frags[-3].seq) == case.k - 1 and len(case.frags[-2].seq) == case.k
        assert case.frags[-1].seq.count("N") >= fuzz.RUNS_PIECES - 1 and len(case.frags[-1].seq) >= 18 * case.k
        assert set(case.confs) <= {0.0, 0.05, 0.15, 0.3, 0.6, 0.9} and case.mhg in (1, 2, 3)
        assert case.probe in (fuzz.PROBES if case.m <= 31 else fuzz.WIDE_PROBES)
        assert (case.k, case.m) in fuzz.KM_CHOICES and case.s in (0, 3, 7)
    assert paired > 0


def test_no_mesh_on_one_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert fuzz.mesh_devices(torch.device("cuda")) == 0
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    assert fuzz.mesh_devices(torch.device("cuda")) == 4
    assert fuzz.mesh_devices(CPU) == 4


@pytest.fixture(scope="module")
def planted():
    """The planted draw and what to change: the position of the exactk
    read's minimizer among the built index's keys, and a taxon other than
    the one stored there."""
    case = fuzz.draw_case(PLANTED_SEED, PLANTED_SEED, CPU, PLANTED_PROBE)
    assert case.m <= 31 and case.mesh is None
    index = fuzz.build_index(case, CPU)
    exactk = next(f.seq for f in case.frags if f.title == "exactk")
    value = oracle.window_minimizers(oracle.encode(exactk), case.k, case.m, case.s)[0]
    pos = int((index.keys_t == value).nonzero()[0, 0])
    old = int(index.taxa_t[pos])
    return pos, old, ROOT if old != ROOT else case.genomes[1][0]


@pytest.fixture
def plant(planted, monkeypatch):
    """Every index that the harness builds has the planted taxon changed,
    after the oracle's map has been made from the genomes."""
    pos, _, new = planted
    build = fuzz.build_index

    def tampered(case, device):
        index = build(case, device)
        index.taxa_t[pos] = new
        return index

    monkeypatch.setattr(fuzz, "build_index", tampered)
    return planted


def test_planted_fault_raises_a_repro(plant):
    pos, old, new = plant
    with pytest.raises(fuzz.FuzzMismatch) as err:
        fuzz.fuzz_iteration(PLANTED_SEED, PLANTED_SEED, "cpu", PLANTED_PROBE)
    repro = err.value.repro
    assert REPRO_KEYS <= set(repro) and repro["seed"] == PLANTED_SEED and repro["probe"] == PLANTED_PROBE
    assert repro["got"] != repro["want"] and repro["path"] == "classify"
    assert json.loads(str(err.value)) == json.loads(json.dumps(repro))


def test_planted_fault_exits_nonzero_with_the_repro(plant, capsys):
    rc = fuzz.main(["--device", "cpu", "--minutes", "0", "--seed", str(PLANTED_SEED), "--probe", PLANTED_PROBE])
    lines = capsys.readouterr().out.splitlines()
    assert rc == 1 and len(lines) == 1
    repro = json.loads(lines[0])
    assert REPRO_KEYS <= set(repro) and repro["MISMATCH"] and repro["seed"] == PLANTED_SEED


def test_unplanted_seed_is_clean(planted, capsys):
    """The same draw without the fault passes, so the fault alone fails it."""
    assert fuzz.main(["--device", "cpu", "--minutes", "0", "--seed", str(PLANTED_SEED),
                      "--probe", PLANTED_PROBE]) == 0
    summary = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert summary["iterations"] == 1 and summary["mismatches"] == 0


def test_cuda_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        fuzz.main(["--minutes", "0"])
    with pytest.raises(RuntimeError, match="CUDA"):
        fuzz.fuzz_iteration(0, 0, "cuda")


def test_module_runs_as_a_program():
    # one thread, as this file's own process: torch's default of every core
    # oversubscribes the CPU beside the other test workers
    env = dict(os.environ, PYTHONPATH=ROOT_DIR, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "slacken_tpu_torch.fuzz", "--device", "cpu", "--minutes", "0.05"],
                         cwd=ROOT_DIR, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    summary = json.loads(out.stdout.splitlines()[-1])
    assert summary["mismatches"] == 0 and summary["iterations"] >= 1 and summary["device"] == "cpu"
    assert summary["read_threshold_checks"] > 0 and summary["base_seed"] == 0


def test_hit_runs_rows_over_the_cap(monkeypatch, tmp_path):
    """The manyruns read takes a row over the cap of 16 hit runs, which the
    classifier then reads densely, by row."""
    from slacken_tpu_torch import classify

    over = []
    harvest = classify.Classifier._harvest

    def counted(self, dispatched):
        batch = harvest(self, dispatched)
        if batch.hit_runs is not None:
            over.append(len(batch.hit_runs[4]))
        return batch

    monkeypatch.setattr(classify.Classifier, "_harvest", counted)
    fuzz.fuzz_iteration(1, 1, "cpu", "routed", False, out=str(tmp_path))
    assert over and sum(over) > 0


@pytest.mark.parametrize("seed,leaves", [(1619, 6), (2079, 5)])
def test_taxonomy_with_fewer_leaves_than_genomes(seed, leaves, tmp_path):
    """Seeds whose taxonomy has fewer leaves than the 7 genomes drawn, where
    scripts/oracle_fuzz.py's draw raises: one genome a leaf."""
    rng = np.random.default_rng(seed)
    oracle.random_taxonomy(rng, int(rng.integers(12, 60)))
    assert int(rng.integers(2, 8)) == 7
    case = fuzz.draw_case(0, seed, CPU)
    assert len(case.genomes) == leaves == sum(case.taxonomy.is_leaf(x) for x in case.taxonomy.taxa())
    assert fuzz.fuzz_iteration(seed, seed, "cpu", out=str(tmp_path))["checks"] > 0
