"""Per-read mode's hit-runs reduction of the window taxa on the CPU, against
the JAX package: the plain twin of ops/hitruns.py and a numpy model of the
CUDA kernel's walk, at tolerance 0, on generated rows and on rows made by
hand at the edges of the kernel's chunks and lanes; then per-read files
under STPU_HIT_RUNS=1 with the native formatters on, stubbed to None and
absent, byte-identical to the JAX package's and to the port's dense run:
single-end and paired rows, rows over the run cap, max_taxa overflow rows, a
wide (45, 33, 7) index probed through hashed1, Classifier.classify's pairs,
and a two-device mesh in both layouts. Last, the default."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hitruns_cases
from slacken_tpu.classify import Classifier as JClassifier
from slacken_tpu.classify import ClassifyParams as JParams
from slacken_tpu.classify import Fragment as JFragment
from slacken_tpu.index import IndexParams as JIndexParams
from slacken_tpu.index import KeyValueIndex as JIndex
from slacken_tpu.ops import hitruns as jhitruns
from slacken_tpu_torch import native, workloads
from slacken_tpu_torch.classify import Classifier, ClassifyParams, Fragment
from slacken_tpu_torch.index import KeyValueIndex
from slacken_tpu_torch.ops import encode, hitruns
from slacken_tpu_torch.parallel.classifier import MeshClassifier
from test_taxonomy import random_taxonomy
from test_torch_classify import _reads, tree
from test_torch_index import shared_library

torch.set_num_threads(1)

CAP = hitruns.DEFAULT_RUNS_PER_ROW


def _case(i, rows, width, k, paired):
    return workloads.hit_runs_rows(100 + i, rows, width, k, paired)


def _jax_hit_runs(wt, valid, splits, lens, k, cap=CAP):
    chars = np.unpackbits(valid, axis=1, bitorder="little")[:, : wt.shape[1]].astype(bool)
    return np.asarray(jhitruns.hit_runs(jnp.asarray(wt), jnp.asarray(chars), jnp.asarray(splits),
                                        jnp.asarray(lens), k, cap))


@pytest.mark.parametrize("cap", [CAP, 4, 48])
@pytest.mark.parametrize("i,rows,width,k,paired", [(i, *s) for i, s in enumerate(hitruns_cases.SHAPES)])
def test_hit_runs_plain_matches_jax(i, rows, width, k, paired, cap):
    wt, valid, splits, lens = _case(i, rows, width, k, paired)
    got = hitruns.hit_runs(*(torch.from_numpy(a) for a in (wt, valid, splits, lens)), k, cap).numpy()
    want = _jax_hit_runs(wt, valid, splits, lens, k, cap)
    assert got.dtype == np.int32 and got.shape == (rows, hitruns.bundle_width(cap))
    assert np.array_equal(got, want)
    nruns = got[:, -3]
    ambiguous = ((got[:, :cap] >> 1) - 2 == -1) & (np.arange(cap) < nruns[:, None])
    assert (nruns > cap).any() == (cap <= CAP) and ambiguous.any() and (lens == 0).sum() == 2
    assert (nruns[lens == 0] == 0).all() and (got[lens == 0, -2:] == 0).all()
    assert (got[:, -1] > 0).any() == paired


@pytest.mark.parametrize("i,rows,width,k,paired", [(i, *s) for i, s in enumerate(hitruns_cases.SHAPES)])
def test_kernel_walk_model_matches_twin(i, rows, width, k, paired):
    """The CUDA kernel's chunk walk, modelled in numpy, gives the twin's
    bundle bit for bit (the gpu tests hold the kernel itself to the twin)."""
    wt, valid, splits, lens = _case(i, rows, width, k, paired)
    want = hitruns.hit_runs_plain(*(torch.from_numpy(a) for a in (wt, valid, splits, lens)), k, CAP).numpy()
    assert np.array_equal(hitruns_cases.warp_walk(wt, valid, splits, lens, k, CAP), want)
    cap = 4  # more overflow rows
    want = hitruns.hit_runs_plain(*(torch.from_numpy(a) for a in (wt, valid, splits, lens)), k, cap).numpy()
    assert np.array_equal(hitruns_cases.warp_walk(wt, valid, splits, lens, k, cap), want)


@pytest.mark.parametrize("width,k", hitruns_cases.EDGE_SHAPES)
def test_hit_runs_plain_matches_jax_on_edge_rows(width, k):
    wt, valid, splits, lens = hitruns_cases.edge_rows(width, k)
    for cap in (CAP, 4, 48):
        got = hitruns.hit_runs(*(torch.from_numpy(a) for a in (wt, valid, splits, lens)), k, cap).numpy()
        assert np.array_equal(got, _jax_hit_runs(wt, valid, splits, lens, k, cap))
    assert (lens == 0).any() and (splits >= 0).sum() >= 4 and (got[:, -1] > 0).sum() >= 4


@pytest.mark.parametrize("width,k", hitruns_cases.EDGE_SHAPES)
def test_kernel_walk_model_matches_twin_on_edge_rows(width, k):
    """The kernel's walk, modelled in numpy, on the hand-made rows: runs, an
    all-N stretch and a gap across a chunk or lane border, mate borders at
    neighbouring places of a lane and at the border, a tail chunk; caps 16,
    4 and 48."""
    wt, valid, splits, lens = hitruns_cases.edge_rows(width, k)
    for cap in (CAP, 4, 48):
        want = hitruns.hit_runs_plain(*(torch.from_numpy(a) for a in (wt, valid, splits, lens)), k, cap).numpy()
        assert np.array_equal(hitruns_cases.warp_walk(wt, valid, splits, lens, k, cap), want)
        if cap == 4 and width >= 2 * k:
            assert (want[:, -3] > cap).any()


def test_decode_matches_jax():
    wt, valid, splits, lens = _case(0, 40, 128, 35, True)
    bundle = hitruns.hit_runs_plain(*(torch.from_numpy(a) for a in (wt, valid, splits, lens)), 35, CAP).numpy()
    got, want = hitruns.decode(bundle, CAP), jhitruns.decode(bundle, CAP)
    assert len(got[4]) > 0
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_hit_runs_refuses_rows_of_2_16():
    wt = torch.zeros((1, 1 << 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="narrower"):
        hitruns.hit_runs(wt, torch.zeros((1, 1 << 13), dtype=torch.uint8), torch.zeros(1, dtype=torch.int32),
                         torch.zeros(1, dtype=torch.int32), 35)


# ---------------------------------------------------------------------------
# per-read files
# ---------------------------------------------------------------------------

MAX_TAXA = 4  # chimeras overflow it: their rows are resolved on the host
KW = dict(thresholds=[0.0, 0.15], min_hit_groups=2, per_read_output=True)


def _heavy_reads(rng, lib, n, k=35):
    """Reads of about 1000 bases that alternate 30-45 valid bases with N runs
    of k to k + 4: more hit runs than the cap."""
    seqs, titles = [], []
    for i in range(n):
        _, genome = lib[i % 4]
        s = int(rng.integers(0, len(genome) - 1000))
        codes = encode.encode_seq(genome[s : s + 1000]).copy()
        p = int(rng.integers(0, 20))
        while p < len(codes):
            p += int(rng.integers(30, 46))
            codes[p : p + k + int(rng.integers(0, 5))] = encode.INVALID
            p += k + 4
        seqs.append(codes)
        titles.append(f"heavy{i}")
    codes, lens = encode.pack_batch(seqs, 1024)
    return native.PackedReads(codes, lens, titles)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The narrow and wide indexes, the streams, and the JAX package's dense
    per-read files of each (kind, index)."""
    rng = np.random.default_rng(19)
    tax = random_taxonomy(rng)
    lib = shared_library(rng, tax, n=8)
    d = tmp_path_factory.mktemp("hitruns")
    streams = {
        "single": [_reads(rng, lib, 150, 128, "a"), _heavy_reads(rng, lib, 12)],
        "paired": [native.pack_pairs(_reads(rng, lib, 70, 128, "p"), _reads(rng, lib, 70, 128, "q"))],
    }
    out = dict(streams=streams, lib=lib, jidx={}, idx={}, want={})
    for name, params in (("narrow", JIndexParams()), ("wide", JIndexParams(k=45, m=33, spaces=7))):
        JIndex.build(iter(lib), params, tax, batch_rows=8, row_len=4096).save(str(d / name))
        out["jidx"][name], out["idx"][name] = JIndex.load(str(d / name)), KeyValueIndex.load(str(d / name))
    mp = pytest.MonkeyPatch()
    mp.setenv("STPU_HIT_RUNS", "0")
    for kind in ("single", "paired"):
        JClassifier(out["jidx"]["narrow"], max_taxa_per_read=MAX_TAXA).classify_and_write_packed(
            streams[kind], str(d / f"j{kind}"), JParams(**KW))
        out["want"][kind] = tree(str(d / f"j{kind}"))
    JClassifier(out["jidx"]["wide"], max_taxa_per_read=MAX_TAXA).classify_and_write_packed(
        streams["paired"], str(d / "jwide"), JParams(**KW))
    out["want"]["wide"] = tree(str(d / "jwide"))
    mp.undo()
    return out


@pytest.fixture
def runs(monkeypatch):
    """runs(on) sets STPU_HIT_RUNS and records every bundle that hit_runs
    makes."""
    made = []
    orig = hitruns.hit_runs

    def wrapped(*a, **kw):
        made.append(orig(*a, **kw))
        return made[-1]

    monkeypatch.setattr(hitruns, "hit_runs", wrapped)

    def set_runs(on):
        monkeypatch.setenv("STPU_HIT_RUNS", "1" if on else "0")
        return made

    return set_runs


def _overflowed(bundles):
    """Rows of the bundles over the run cap."""
    return sum(int((b[:, -3] > CAP).sum()) for b in bundles)


def _formatters(monkeypatch, how):
    if how == "stubbed":
        monkeypatch.setattr(native, "output_lines_runs", lambda *a, **k: None)
        monkeypatch.setattr(native, "output_lines_dense", lambda *a, **k: None)
    elif how == "python":
        monkeypatch.setattr(native, "_load", lambda: None)
    assert native.available() == (how != "python")


def _run(cls, stream, prefix):
    got = cls.classify_and_write_packed(stream, prefix, ClassifyParams(**KW))
    assert got == {0.0: ["all"], 0.15: ["all"]}
    return tree(prefix)


@pytest.mark.parametrize("how", ["native", "stubbed", "python"])
@pytest.mark.parametrize("kind", ["single", "paired"])
def test_per_read_files_identical(world, runs, monkeypatch, tmp_path, kind, how):
    stream, want = world["streams"][kind], world["want"][kind]
    idx = world["idx"]["narrow"]
    runs(False)
    dense = _run(Classifier(idx, "cpu", max_taxa_per_read=MAX_TAXA), stream, str(tmp_path / "dense"))
    assert dense == want
    made = runs(True)
    _formatters(monkeypatch, how)
    got = _run(Classifier(idx, "cpu", max_taxa_per_read=MAX_TAXA), stream, str(tmp_path / "runs"))
    assert made and got == want
    lines = b"".join(v for k, v in got.items() if k.endswith(".gz"))
    assert b"A:" in lines and (b"|:|" in lines) == (kind == "paired")
    if kind == "single":
        assert _overflowed(made) > 0


def test_per_read_files_identical_under_jax_hit_runs(world, runs, tmp_path):
    """The JAX package with its own hit runs on gives the same files."""
    runs(True)
    stream = world["streams"]["single"]
    JClassifier(world["jidx"]["narrow"], max_taxa_per_read=MAX_TAXA).classify_and_write_packed(
        stream, str(tmp_path / "j"), JParams(**KW))
    assert tree(str(tmp_path / "j")) == world["want"]["single"]


@pytest.mark.parametrize("how", ["native", "stubbed", "python"])
def test_wide_hashed1_identical(world, runs, monkeypatch, tmp_path, how):
    idx = world["idx"]["wide"]
    runs(False)
    cls = Classifier(idx, "cpu", max_taxa_per_read=MAX_TAXA, probe="hashed1")
    assert _run(cls, world["streams"]["paired"], str(tmp_path / "dense")) == world["want"]["wide"]
    made = runs(True)
    _formatters(monkeypatch, how)
    cls = Classifier(idx, "cpu", max_taxa_per_read=MAX_TAXA, probe="hashed1")
    assert _run(cls, world["streams"]["paired"], str(tmp_path / "runs")) == world["want"]["wide"]
    assert made


def _fragments(world, cls):
    letters = np.frombuffer(b"ACGTN", np.uint8)
    single = world["streams"]["single"][1]
    frags = [cls(t, letters[c[:n]].tobytes().decode()) for t, c, n in zip(single.titles, single.codes,
                                                                          single.lengths)]
    for i, (_, seq) in enumerate(world["lib"][:6]):
        a = 100 * i
        frags.append(cls(f"pair{i}", seq[a : a + 120], seq[a + 300 : a + 390].replace("A", "N", 3)))
        frags.append(cls(f"one{i}", seq[a + 500 : a + 640]))
    return frags


@pytest.mark.parametrize("how", ["native", "python"])
def test_classify_pairs_identical(world, runs, monkeypatch, how):
    """Classifier.classify's (hit details, length) pairs from the runs, in
    C++ (native.hit_lines_runs) or in Python, equal the JAX package's lines."""
    cpar = dict(thresholds=[0.0, 0.15], per_read_output=True)
    runs(False)
    want = JClassifier(world["jidx"]["narrow"], max_taxa_per_read=MAX_TAXA).classify(
        _fragments(world, JFragment), JParams(**cpar))
    made = runs(True)
    _formatters(monkeypatch, how)
    got = Classifier(world["idx"]["narrow"], "cpu", max_taxa_per_read=MAX_TAXA).classify(
        _fragments(world, Fragment), ClassifyParams(**cpar))
    assert made
    for t in cpar["thresholds"]:
        assert [r.output_line() for r in got[t]] == [r.output_line() for r in want[t]]
        assert any("|:|" in r.hit_details for r in got[t]) and any("A:" in r.hit_details for r in got[t])


@pytest.mark.parametrize("kind", ["single", "paired"])
@pytest.mark.parametrize("layout", ["replicated", "ring"])
def test_mesh_identical(world, runs, tmp_path, layout, kind):
    """A MeshClassifier of two CPU devices inherits the hit runs: its files
    equal the JAX package's dense files."""
    made = runs(True)
    mesh = MeshClassifier(world["idx"]["narrow"], ["cpu"] * 2, layout, max_taxa_per_read=MAX_TAXA)
    assert _run(mesh, world["streams"][kind], str(tmp_path / "mesh")) == world["want"][kind]
    assert made


def test_hit_runs_choice(world, monkeypatch):
    """As in the JAX package, hit runs are on by default only on a CPU
    device without the native formatter; STPU_HIT_RUNS overrides; never for
    rows of 2^16 or in reports mode."""
    idx = world["idx"]["narrow"]
    monkeypatch.delenv("STPU_HIT_RUNS", raising=False)

    def choice(width=128):
        cls = Classifier(idx, "cpu")
        cls._fetch_window_taxa = True
        return cls._fetch_runs(width)

    assert native.available() and not choice()
    monkeypatch.setenv("STPU_HIT_RUNS", "1")
    assert choice() and not choice(width=1 << 16) and choice(width=(1 << 16) - 8)
    assert not Classifier(idx, "cpu")._fetch_runs(128)  # reports mode until an entry point asks for lines
    monkeypatch.delenv("STPU_HIT_RUNS")
    monkeypatch.setattr(native, "_load", lambda: None)
    assert choice()
    monkeypatch.setenv("STPU_HIT_RUNS", "0")
    assert not choice()


def test_hit_runs_batches_carry_runs(world, runs):
    """Under hit runs a batch carries the decoded runs, no dense window taxa,
    and the dense rows of exactly its rows over the cap."""
    runs(True)
    cls = Classifier(world["idx"]["narrow"], "cpu", max_taxa_per_read=MAX_TAXA)
    cls._fetch_window_taxa = True
    seen = 0
    for b in cls.packed_batches(world["streams"]["single"]):
        assert b.window_taxa is None and b.hit_runs is not None
        over = set(b.hit_runs[4].tolist())
        assert over <= set(b.run_rows) and set(b.overflow_window_taxa) <= set(b.run_rows)
        seen += len(over)
    assert seen > 0


def test_kernel_wrapper_refuses_cpu_tensors():
    """On the CPU the dispatcher runs the twin and the kernel's wrapper
    raises: it never launches nor falls back."""
    from slacken_tpu_torch.ops import cuda_kernels

    args = [torch.from_numpy(a) for a in workloads.hit_runs_rows(1, 8, 128, 35)]
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_kernels.hit_runs_cuda(*args, 35, CAP)
    assert cuda_kernels.LAUNCHES["hit_runs"] == 0
    assert hitruns.hit_runs(*args, 35).shape == (8, 27)
