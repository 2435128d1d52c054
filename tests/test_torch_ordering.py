"""Explicit minimizer orderings (rank tables) in the port against the JAX
package on the CPU: the rank tables, the m-mer ids and sampled counts
behind the frequency ordering, the scan with a table (all four outputs), the
index files, an index saved by each package loaded and classified by the
other, classify end to end and both CLIs with --ordering. Every value is an
integer or text: exact equality throughout."""

import numpy as np
import pytest
import torch

from slacken_tpu import cli as jcli
from slacken_tpu.classify import Classifier as JClassifier
from slacken_tpu.classify import ClassifyParams as JCParams
from slacken_tpu.index import IndexParams as JParams
from slacken_tpu.index import KeyValueIndex as JIndex
from slacken_tpu.ops import encode as jencode
from slacken_tpu.ops import minimizers as jmin
from slacken_tpu.ops import ordering as jordering
from slacken_tpu.ops import u64
from slacken_tpu_torch import cli
from slacken_tpu_torch.classify import Classifier, ClassifyParams
from slacken_tpu_torch.index import IndexParams, KeyValueIndex
from slacken_tpu_torch.ops import cuda_kernels, encode, minimizers, ordering
from test_taxonomy import random_taxonomy
from test_torch_classify import _reads, _write_library, tree
from test_torch_index import shared_library

torch.set_num_threads(1)


def _codes(rng, shape=(6, 300), invalid=0.03):
    codes = rng.integers(0, 4, shape).astype(np.uint8)
    codes[rng.random(shape) < invalid] = encode.INVALID
    if shape[0] > 1:
        codes[1, 250:] = encode.INVALID  # padding
    return codes


@pytest.mark.parametrize("m", [1, 2, 3, 5, 8])
def test_rank_tables_match_jax(rng, m):
    n = 1 << (2 * m)
    assert np.array_equal(ordering.lexicographic_lut(m), jordering.lexicographic_lut(m))
    assert np.array_equal(ordering.signature_lut(m), jordering.signature_lut(m))
    motifs = rng.permutation(n)[: max(1, n // 3)]
    assert np.array_equal(ordering.given_lut(motifs, m), jordering.given_lut(motifs, m))
    counts = rng.integers(0, 5, n)  # many ties: the stable order decides
    got = ordering.frequency_lut(counts, m)
    assert np.array_equal(got, jordering.frequency_lut(counts, m))
    for lut in (got, ordering.signature_lut(m), ordering.given_lut(motifs, m)):
        assert lut.dtype == np.uint32 and np.array_equal(np.sort(lut), np.arange(n))


def test_rank_tables_refuse_what_jax_refuses(rng):
    assert ordering.MAX_LUT_M == jordering.MAX_LUT_M == 15
    for build in (ordering.lexicographic_lut, ordering.signature_lut,
                  lambda m: ordering.given_lut([1], m), lambda m: ordering.frequency_lut(np.zeros(4), m)):
        for m in (0, 16, 31):
            with pytest.raises(ValueError, match="m <= 15"):
                build(m)
    with pytest.raises(ValueError, match="out of range"):
        ordering.given_lut([16], 2)
    with pytest.raises(ValueError, match="duplicate"):
        ordering.given_lut([3, 3], 2)
    with pytest.raises(ValueError, match="shape"):
        ordering.frequency_lut(np.zeros(15), 2)


@pytest.mark.parametrize("kms,canonical", [((12, 6, 1), True), ((15, 8, 0), True), ((21, 9, 2), False), ((35, 13, 3), True)])
def test_mmer_rank_ids_match_jax(rng, kms, canonical):
    codes = _codes(rng)
    want = np.asarray(jordering._mmer_rank_ids(codes, jmin.MinimizerParams(*kms, canonical=canonical)))
    got = ordering.mmer_rank_ids(torch.from_numpy(codes), minimizers.MinimizerParams(*kms, canonical=canonical))
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want)
    assert (want >= 0).sum() > 1000 and (want < 0).sum() > 100


@pytest.mark.parametrize("kms,row_len", [((12, 6, 1), 1 << 15), ((21, 9, 2), 128), ((15, 8, 0), 64)])
def test_sample_mmer_counts_match_jax(rng, kms, row_len):
    """Rows longer than row_len split with m - 1 overlap, rows shorter than
    m, and more rows than one batch holds."""
    sample = [_codes(rng, (1, n))[0] for n in (400, 1000, 5, 129, 64, 333)]
    want = jordering.sample_mmer_counts(sample, jmin.MinimizerParams(*kms), row_len=row_len, batch_rows=4)
    got = ordering.sample_mmer_counts(sample, minimizers.MinimizerParams(*kms), "cpu", row_len=row_len, batch_rows=4)
    assert got.shape == (1 << (2 * kms[1]),) and np.array_equal(got, want)
    assert got.sum() > 1500
    assert np.array_equal(ordering.frequency_lut(got, kms[1]), jordering.frequency_lut(want, kms[1]))


def _table(rng, kind, kms):
    m = kms[1]
    if kind == "frequency":
        sample = [_codes(rng, (1, 400), 0.0)[0] for _ in range(3)]
        return ordering.frequency_lut(ordering.sample_mmer_counts(sample, minimizers.MinimizerParams(*kms), "cpu"), m)
    if kind == "given":
        return ordering.given_lut(rng.permutation(1 << (2 * m))[:7], m)
    return {"lexicographic": ordering.lexicographic_lut, "signature": ordering.signature_lut}[kind](m)


@pytest.mark.parametrize("kms,canonical,kind", [
    ((15, 8, 0), True, "lexicographic"), ((15, 8, 2), True, "lexicographic"),  # tests/test_ordering.py:17
    ((12, 6, 1), True, "frequency"),  # :60
    ((6, 3, 0), False, "frequency"),  # :91
    ((19, 7, 2), True, "signature"),  # :205
    ((21, 11, 0), True, "lexicographic"), ((21, 9, 2), True, "frequency"), ((25, 11, 0), True, "signature"),  # :107, :222
    ((9, 4, 1), True, "given"),
])
def test_scan_with_a_table_matches_jax(rng, kms, canonical, kind):
    codes = _codes(rng)
    lut = _table(rng, kind, kms)
    want = jmin.window_minimizers(codes, jmin.MinimizerParams(*kms, canonical=canonical), lut)
    wmin = u64.to_ints(want.minimizer).astype(np.int64)
    valid = np.asarray(want.valid)
    mp = minimizers.MinimizerParams(*kms, canonical=canonical)
    lut_t = torch.from_numpy(lut.astype(np.int32))
    packed, vbits = (torch.from_numpy(a) for a in encode.pack_2bit(np.pad(codes, ((0, 0), (0, 4)), constant_values=4)))
    cuda_kernels.reset_launch_counts()
    for got in (minimizers.window_minimizers(torch.from_numpy(codes), mp, lut_t),
                minimizers.window_minimizers(torch.from_numpy(codes), mp, lut_t.long()),
                minimizers.window_minimizers_packed(packed, vbits, mp, lut_t)):
        assert got.minimizer.dtype == torch.int64
        assert np.array_equal(got.valid.numpy()[:, :300], valid)
        assert np.array_equal(got.minimizer.numpy()[:, :300][valid], wmin[valid])
        assert bool((got.minimizer[~got.valid] == -1).all())
        assert np.array_equal(got.span_start.numpy()[:, :300], np.asarray(want.span_start))
        assert np.array_equal(got.distinct.numpy()[:, :300], np.asarray(want.distinct))
    assert not any(cuda_kernels.LAUNCHES.values())
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_kernels.window_minimizers_cuda(packed, vbits, mp, lut_t)
    if kind == "lexicographic":  # == the XOR path with a zero toggle mask
        xor0 = minimizers.window_minimizers(torch.from_numpy(codes), mp._replace(toggle_mask=0))
        for a, b in zip(got, xor0):
            assert torch.equal(a[:, :300], b)


def _frequency_table(lib, params, module, **kw):
    counts = module.sample_mmer_counts(
        [encode.encode_seq(seq) for _, seq in lib], params.minimizer_params, **kw)
    return module.frequency_lut(counts, params.m)


@pytest.mark.parametrize("kw", [
    dict(k=21, m=11, spaces=0, ordering="lexicographic"), dict(k=25, m=11, spaces=0, ordering="signature"),
    dict(k=21, m=9, spaces=2, ordering="frequency"), dict(k=35, m=13, spaces=3, ordering="signature"),
    dict(k=21, m=9, spaces=2, ordering="given"),
])
def test_rank_table_build_matches_jax_byte_for_byte(rng, tmp_path, kw):
    tax = random_taxonomy(rng)
    lib = shared_library(rng, tax)
    luts = {}
    if kw["ordering"] == "frequency":
        luts = dict(ordering_lut=_frequency_table(lib, IndexParams(**kw), ordering, device="cpu"))
        assert np.array_equal(luts["ordering_lut"], _frequency_table(lib, JParams(**kw), jordering))
    elif kw["ordering"] == "given":
        luts = dict(ordering_lut=ordering.given_lut(rng.permutation(4 ** 9)[:1000], 9))
    want = JIndex.build(iter(lib), JParams(**kw), tax, batch_rows=8, row_len=4096, **luts)
    got = KeyValueIndex.build(iter(lib), IndexParams(**kw), tax, "cpu", batch_rows=4, row_len=1024, **luts)
    assert got.num_records == len(want.keys) > 300
    assert len(np.setdiff1d(got.taxa, [t for t, _ in lib])) > 0  # real LCAs
    want.save(str(tmp_path / "jax"))
    got.save(str(tmp_path / "torch"))
    for name in ("keys.npy", "taxa.npy", "ordering_lut.npy"):
        assert (tmp_path / "jax" / name).read_bytes() == (tmp_path / "torch" / name).read_bytes()
    if kw["ordering"] == "lexicographic":  # the identity tests/test_ordering.py:17 uses
        xor0 = KeyValueIndex.build(iter(lib), IndexParams(k=21, m=11, spaces=0, toggle_mask=0), tax, "cpu")
        assert np.array_equal(got.keys, xor0.keys) and np.array_equal(got.taxa, xor0.taxa)


@pytest.fixture
def signature_setup(rng, tmp_path):
    """A signature index built and saved by each package, and reads."""
    tax = random_taxonomy(rng)
    lib = shared_library(rng, tax, n=8)
    kw = dict(k=25, m=11, spaces=2, ordering="signature")
    JIndex.build(iter(lib), JParams(**kw), tax, batch_rows=8, row_len=4096).save(str(tmp_path / "jidx"))
    KeyValueIndex.build(iter(lib), IndexParams(**kw), tax, "cpu").save(str(tmp_path / "tidx"))
    reads = [_reads(rng, lib, 150, 128, "a"), _reads(rng, lib, 60, 256, "b")]
    return str(tmp_path / "jidx"), str(tmp_path / "tidx"), reads


def test_each_package_serves_the_others_rank_table_index(signature_setup, tmp_path):
    """Classify end to end, per-read lines and kreports byte-identical: the
    JAX package on its own index against the port on the JAX package's
    index and on its own, and the JAX package on the port's index."""
    jloc, tloc, reads = signature_setup
    kw = dict(thresholds=[0.0, 0.15], per_read_output=True)
    from_jax = KeyValueIndex.load(jloc)
    assert from_jax.params.ordering == "signature" and from_jax.ordering_lut.dtype == np.uint32
    assert from_jax.device_lut("cpu").dtype == torch.int32
    assert from_jax.device_lut("cpu") is from_jax.device_lut("cpu")  # copied once
    assert np.array_equal(JIndex.load(tloc).ordering_lut, from_jax.ordering_lut)
    JClassifier(JIndex.load(jloc)).classify_and_write_packed(reads, str(tmp_path / "jj"), JCParams(**kw))
    JClassifier(JIndex.load(tloc)).classify_and_write_packed(reads, str(tmp_path / "jt"), JCParams(**kw))
    Classifier(from_jax, "cpu").classify_and_write_packed(reads, str(tmp_path / "tj"), ClassifyParams(**kw))
    Classifier(KeyValueIndex.load(tloc), "cpu").classify_and_write_packed(reads, str(tmp_path / "tt"), ClassifyParams(**kw))
    want = tree(str(tmp_path / "jj"))
    assert len(want) == 4 and sum(v.count(b"\nC\t") for v in want.values()) > 100
    for other in ("jt", "tj", "tt"):
        assert tree(str(tmp_path / other)) == want, other


def test_rank_table_index_without_its_table_is_refused(signature_setup):
    import os

    _, tloc, _ = signature_setup
    os.remove(os.path.join(tloc, "ordering_lut.npy"))
    with pytest.raises(ValueError, match="rank table"):
        KeyValueIndex.load(tloc)


def write_fastq(path, reads):
    with open(path, "w") as f:
        for title, codes, n in zip(reads.titles, reads.codes, reads.lengths):
            f.write(f"@{title}\n{jencode.decode_codes(codes[:n])}\n+\n{'I' * int(n)}\n")


@pytest.mark.parametrize("order,m", [("frequency", 9), ("signature", 11), ("lexicographic", 8)])
def test_cli_ordering_matches_jax_cli(rng, tmp_path, capsys, order, m):
    tax = random_taxonomy(rng)
    lib = shared_library(rng, tax, n=4, length=2000)
    _write_library(tmp_path, tax, lib)
    reads = _reads(rng, lib, 80, 128, "r", genomes=4)
    write_fastq(tmp_path / "reads.fastq", reads)
    build = ["-l", str(tmp_path / "lib"), "-t", str(tmp_path / "tax"), "-k", "21", "-m", str(m), "-s", "2",
             "--ordering", order]
    assert jcli.main(["build", "-i", str(tmp_path / "jidx"), *build]) == 0
    assert cli.main(["build", "-i", str(tmp_path / "tidx"), *build, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Saved" in out and ("Sampling m-mer frequencies" in out) == (order == "frequency")
    for name in ("keys.npy", "taxa.npy", "ordering_lut.npy"):
        assert (tmp_path / "jidx" / name).read_bytes() == (tmp_path / "tidx" / name).read_bytes()
    # each CLI classifies with the other's index
    common = [str(tmp_path / "reads.fastq"), "-c", "0.0", "0.1"]
    assert jcli.main(["classify", "-i", str(tmp_path / "tidx"), "-o", str(tmp_path / "jout"), *common]) == 0
    assert cli.main(["classify", "-i", str(tmp_path / "jidx"), "-o", str(tmp_path / "tout"), *common,
                     "--device", "cpu"]) == 0
    a, b = tree(str(tmp_path / "jout")), tree(str(tmp_path / "tout"))
    assert len(a) == 4 and a == b
    assert sum(v.count(b"\nC\t") for v in a.values()) > 50
