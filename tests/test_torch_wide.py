"""Wide minimizers and keys (31 < m <= 63) in the port against the JAX
package on the CPU: the scan (all four outputs; limbs (hi64, lo64) against
the JAX package's u128), the toggle mask against the oracle, the two-limb
probe twins against lookup_taxa_routed_wide, the index files, an index saved
by each package loaded and classified by the other, classify end to end and
both CLIs with -m 45. Every value is an integer or text: exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from slacken_tpu import cli as jcli
from slacken_tpu.classify import Classifier as JClassifier
from slacken_tpu.classify import ClassifyParams as JCParams
from slacken_tpu.index import IndexParams as JParams
from slacken_tpu.index import KeyValueIndex as JIndex
from slacken_tpu.ops import lookup as jlookup
from slacken_tpu.ops import minimizers as jmin
from slacken_tpu.ops import u128
from slacken_tpu_torch import cli
from slacken_tpu_torch.classify import Classifier, ClassifyParams
from slacken_tpu_torch.index import IndexParams, KeyValueIndex
from slacken_tpu_torch.ops import cuda_kernels, encode, lookup, minimizers
from test_taxonomy import random_taxonomy
from test_torch_classify import _reads, _write_library, tree
from test_torch_index import shared_library
from test_torch_ordering import write_fastq

torch.set_num_threads(1)

#: tests/test_wide.py:57-60, and m = 32 (the whole key in lo64), the widest m
#: beside a wide window, and spaces at their most
WIDE = [(35, 33, 0), (50, 45, 7), (63, 63, 0), (40, 33, 5), (35, 32, 0), (80, 63, 7), (64, 32, 16)]


def _codes(rng, shape=(16, 256)):
    """Few invalid bases, so that windows of up to 80 bases stay valid; an N
    run, padding and a row shorter than any k."""
    codes = rng.integers(0, 4, shape).astype(np.uint8)
    codes[rng.random(shape) < 0.004] = encode.INVALID
    codes[3, 40:90] = encode.INVALID
    codes[5, 200:] = encode.INVALID
    codes[9, 30:] = encode.INVALID
    return codes


@pytest.mark.parametrize("kms", WIDE)
@pytest.mark.parametrize("canonical", [True, False])
def test_wide_scan_matches_jax(rng, kms, canonical):
    codes = _codes(rng)
    want = jmin.window_minimizers(codes, jmin.MinimizerParams(*kms, canonical=canonical))
    wmin = np.stack(u128.to_u64_pair(want.minimizer), -1).view(np.int64)
    valid = np.asarray(want.valid)
    mp = minimizers.MinimizerParams(*kms, canonical=canonical)
    packed, vbits = (torch.from_numpy(a) for a in encode.pack_2bit(codes))
    cuda_kernels.reset_launch_counts()
    for got in (minimizers.window_minimizers(torch.from_numpy(codes), mp),
                minimizers.window_minimizers_packed(packed, vbits, mp)):
        assert got.minimizer.shape == (*codes.shape, 2) and got.minimizer.dtype == torch.int64
        assert got.minimizer.is_contiguous()  # a query is one 16-byte row
        assert np.array_equal(got.valid.numpy(), valid) and valid.sum() > 500
        assert np.array_equal(got.minimizer.numpy()[valid], wmin[valid])
        assert bool((got.minimizer[~got.valid] == -1).all())
        assert np.array_equal(got.span_start.numpy(), np.asarray(want.span_start))
        assert np.array_equal(got.distinct.numpy(), np.asarray(want.distinct))
    assert not any(cuda_kernels.LAUNCHES.values())
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_kernels.window_minimizers_cuda(packed, vbits, mp)
    hi = got.minimizer[..., 0][got.valid]
    assert int(hi.min()) >= 0 and int(hi.max()) < 1 << 62
    if kms[1] == 32:
        assert int(hi.max()) == 0
    else:  # lo64 uses its top bit: order on it must be unsigned
        assert int(got.minimizer[..., 1][got.valid].min()) < 0


def test_wide_scan_matches_the_oracle(rng):
    """One row against the pure-Python oracle, as tests/test_wide.py:61."""
    k, m, s = 50, 45, 7
    seq = "".join("ACGT"[i] for i in rng.integers(0, 4, 170))
    seq = seq[:90] + "N" + seq[91:]
    got = minimizers.window_minimizers(
        torch.from_numpy(encode.encode_seq(seq)[None, :]), minimizers.MinimizerParams(k, m, s))
    want = oracle.window_minimizers(oracle.encode(seq), k, m, s)
    limbs = got.minimizer[0].numpy().view(np.uint64)
    for i, w in enumerate(want):
        assert bool(got.valid[0, i]) == (w is not None)
        if w is not None:
            assert (int(limbs[i, 0]) << 64) | int(limbs[i, 1]) == w
    spans = oracle.spans(oracle.encode(seq), k, m, s)
    starts = np.flatnonzero(got.span_start[0].numpy())
    assert list(starts) == [sp[0] for sp in spans]
    assert list(got.distinct[0].numpy()[starts]) == [sp[3] for sp in spans]


def test_wide_toggle_matches_oracle():
    for m in (32, 33, 40, 45, 63, 64 - 1):
        want = oracle.wide_toggle(m, oracle.DEFAULT_TOGGLE_MASK)
        assert minimizers.wide_toggle_mask(m, minimizers.DEFAULT_TOGGLE_MASK) == want
        assert minimizers.wide_toggle_mask(m, minimizers.DEFAULT_TOGGLE_MASK) == u128.wide_toggle_mask(
            m, minimizers.DEFAULT_TOGGLE_MASK)
        hi, lo = minimizers.limbs_int64(want)
        assert ((hi & ((1 << 64) - 1)) << 64) | (lo & ((1 << 64) - 1)) == want and -(1 << 63) <= lo < 1 << 63


def _wide_keys(rng, m, n):
    """n sorted unique keys below 4^m as uint64 [n, 2] rows (hi64, lo64)."""
    hi_bits = 2 * m - 64
    hi = rng.integers(0, 1 << hi_bits, 2 * n + 4, dtype=np.uint64) if hi_bits else np.zeros(2 * n + 4, np.uint64)
    if m == 45:
        hi[: n] = hi[0]  # a long run of equal hi64
    lo = rng.integers(0, 1 << 64, 2 * n + 4, dtype=np.uint64)
    lo[:4] = [0, 1, 1 << 63, (1 << 64) - 1]  # lo64 differing only in the top bit
    rows = np.unique(np.stack([hi, lo], 1), axis=0)  # sorted by (hi64, lo64), unsigned
    return rows[np.sort(rng.permutation(len(rows))[:n])]


@pytest.mark.parametrize("m", [32, 33, 45, 63])
@pytest.mark.parametrize("n", [0, 1, 2, 129, 20_003])
def test_wide_probe_twins_match_jax(rng, m, n):
    """lookup_taxa and lookup_taxa_directory over two-limb keys against the
    JAX package's lookup_taxa_routed_wide (through KeyValueIndex.lookup_wide)
    and a dictionary: hits, misses beside every key in either limb, the
    invalid window's -1, the edges of the key space."""
    keys = _wide_keys(rng, m, n)
    taxa = rng.integers(1, 1000, len(keys)).astype(np.int32)
    one = np.array([[0, 1]], np.uint64)
    top = (1 << (2 * m - 64)) - 1
    inside = np.concatenate([keys, keys + one, keys - one, keys ^ np.array([[0, 1 << 63]], np.uint64),
                             _wide_keys(rng, m, 300), np.array([[0, 0], [0, (1 << 64) - 1], [top, (1 << 64) - 1]], np.uint64)])
    inside = inside[inside[:, 0] <= top]
    outside = np.array([[-1, -1], [top + 1, 0], [(1 << 62) - 1, 5], [-(1 << 63), 0]], np.int64)
    q = np.concatenate([inside.view(np.int64), outside])
    index = {(int(h), int(l)): int(t) for (h, l), t in zip(keys, taxa)}
    want = np.array([index.get((int(h), int(l)), 0) for h, l in q.view(np.uint64)], np.int32)
    if n:
        jidx = JIndex(keys, taxa, JParams(k=m + 3, m=m, spaces=0), None)
        want_jax = np.asarray(jidx.lookup_wide(jlookup.wide_keys_from_numpy(inside)))
        assert np.array_equal(want[: len(inside)], want_jax)
    k_t, t_t, q_t = torch.from_numpy(keys.view(np.int64)), torch.from_numpy(taxa), torch.from_numpy(q)
    got = lookup.lookup_taxa(k_t, t_t, q_t)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert int((got > 0).sum()) >= n
    cuda_kernels.reset_launch_counts()
    for bucket_keys in (lookup.BUCKET_KEYS, 1, 1 << 30):
        d = lookup.build_directory(k_t, bucket_keys)
        assert d.starts.dtype == torch.int32 and 0 <= d.shift <= 127
        assert d.buckets & (d.buckets - 1) == 0 and int(d.starts[0]) == 0 and int(d.starts[-1]) == n
        assert bool((d.starts[1:] >= d.starts[:-1]).all())
        assert np.array_equal(lookup.lookup_taxa_directory(k_t, t_t, d, q_t).numpy(), want)
        assert np.array_equal(lookup.probe(k_t, t_t, d, q_t).numpy(), want)
    assert not any(cuda_kernels.LAUNCHES.values())
    if n:
        with pytest.raises(ValueError, match="CUDA tensor"):
            cuda_kernels.lookup_taxa_directory_cuda(k_t, t_t, d, q_t)


def test_wide_directory_takes_its_prefix_from_the_widest_key(rng):
    """About 4 keys a bucket; for m = 32 and 33 the prefix comes wholly or
    mostly from lo64 (the two cases of the JAX package's build_router_wide)."""
    for m, n in ((32, 20_003), (33, 20_003), (45, 5_000), (63, 100_003)):
        keys = _wide_keys(rng, m, n) if m != 45 else np.unique(np.stack(
            [rng.integers(0, 1 << 26, n, dtype=np.uint64), rng.integers(0, 1 << 64, n, dtype=np.uint64)], 1), axis=0)
        n = len(keys)
        d = lookup.build_directory(torch.from_numpy(keys.view(np.int64)))
        b = (-(-n // 4) - 1).bit_length()
        widest = (int(keys[-1, 0]) << 64) | int(keys[-1, 1])
        assert d.buckets == 1 << b and d.shift == widest.bit_length() - b
        router = jlookup.build_router_wide(keys >> np.uint64(0), b, widest.bit_length())
        assert np.array_equal(d.starts.numpy(), router)
        sizes = d.starts[1:] - d.starts[:-1]
        assert int(sizes.sum()) == n and int(sizes.max()) < 8 * lookup.BUCKET_KEYS
    assert lookup.build_directory(torch.from_numpy(_wide_keys(rng, 32, 100).view(np.int64))).shift < 64
    with pytest.raises(ValueError, match="non-negative"):
        lookup.build_directory(torch.tensor([[-3, 5], [0, 1]]))


@pytest.mark.parametrize("kw", [dict(k=35, m=33, spaces=0), dict(k=50, m=45, spaces=7), dict(k=35, m=32, spaces=0),
                                dict(k=63, m=63, spaces=0)])
@pytest.mark.parametrize("row_len", [1024, 4096])
def test_wide_build_matches_jax_byte_for_byte(rng, tmp_path, kw, row_len):
    tax = random_taxonomy(rng)
    lib = shared_library(rng, tax)
    want = JIndex.build(iter(lib), JParams(**kw), tax, batch_rows=8, row_len=4096)
    got = KeyValueIndex.build(iter(lib), IndexParams(**kw), tax, "cpu", batch_rows=4, row_len=row_len)
    assert got.wide and got.keys.shape == (len(want.keys), 2) and got.num_records > 1000
    assert got.keys.dtype == np.uint64 and got.keys_t.dtype == torch.int64
    assert len(np.setdiff1d(got.taxa, [t for t, _ in lib])) > 0  # real LCAs
    # sorted by (hi64, lo64) unsigned, no key twice
    wide_ints = [(int(h) << 64) | int(l) for h, l in got.keys]
    assert all(a < b for a, b in zip(wide_ints, wide_ints[1:]))
    want.save(str(tmp_path / "jax"))
    got.save(str(tmp_path / "torch"))
    for name in ("keys.npy", "taxa.npy"):
        assert (tmp_path / "jax" / name).read_bytes() == (tmp_path / "torch" / name).read_bytes()
    assert not (tmp_path / "torch" / "ordering_lut.npy").exists()


def test_empty_wide_library(rng):
    idx = KeyValueIndex.build(iter([]), IndexParams(k=50, m=45), random_taxonomy(rng), "cpu")
    assert idx.num_records == 0 and idx.keys.shape == (0, 2) and idx.keys.dtype == np.uint64
    keys, taxa, directory = idx.device_arrays("cpu")
    assert lookup.probe(keys, taxa, directory, torch.zeros((5, 2), dtype=torch.int64)).tolist() == [0] * 5
    with pytest.raises(ValueError, match="do not fit m"):
        KeyValueIndex(torch.zeros(3, dtype=torch.int64), torch.zeros(3), IndexParams(k=50, m=45), None)


@pytest.mark.parametrize("kw", [dict(k=35, m=33, spaces=0), dict(k=50, m=45, spaces=7)])
@pytest.mark.parametrize("max_taxa", [32, 2])
def test_each_package_serves_the_others_wide_index(rng, tmp_path, kw, max_taxa):
    """Classify end to end, single and paired rows, per-read lines and
    kreports byte-identical: the JAX package on its own index against the
    port on the JAX package's index and on its own, and the JAX package on
    the port's index."""
    from slacken_tpu import native

    tax = random_taxonomy(rng)
    lib = shared_library(rng, tax, n=8)
    JIndex.build(iter(lib), JParams(**kw), tax, batch_rows=8, row_len=4096).save(str(tmp_path / "jidx"))
    KeyValueIndex.build(iter(lib), IndexParams(**kw), tax, "cpu").save(str(tmp_path / "tidx"))
    reads = [_reads(rng, lib, 150, 128, "a"), _reads(rng, lib, 60, 256, "b"),
             native.pack_pairs(_reads(rng, lib, 70, 128, "p"), _reads(rng, lib, 70, 128, "q"))]
    ckw = dict(thresholds=[0.0, 0.15], per_read_output=True, sample_regex=r"^[a-z](s\d)_")
    runs = {}
    for tag, loc in (("j", "jidx"), ("t", "tidx")):
        JClassifier(JIndex.load(str(tmp_path / loc)), max_taxa_per_read=max_taxa).classify_and_write_packed(
            reads, str(tmp_path / f"j{tag}"), JCParams(**ckw))
        idx = KeyValueIndex.load(str(tmp_path / loc))
        assert idx.wide and idx.keys_t.shape[1] == 2
        Classifier(idx, "cpu", max_taxa_per_read=max_taxa).classify_and_write_packed(
            reads, str(tmp_path / f"t{tag}"), ClassifyParams(**ckw))
        runs.update({f"j{tag}": tree(str(tmp_path / f"j{tag}")), f"t{tag}": tree(str(tmp_path / f"t{tag}"))})
    want = runs["jj"]
    assert sum(k.endswith(".gz") for k in want) >= 2 and sum(v.count(b"\nC\t") for v in want.values()) > 100
    assert b"|:|" in b"".join(want.values())
    for other in ("jt", "tj", "tt"):
        assert runs[other] == want, other
    # reports mode gives the same kreports
    Classifier(idx, "cpu").classify_and_write_packed(
        reads, str(tmp_path / "rep"), ClassifyParams(**dict(ckw, per_read_output=False)))
    if max_taxa == 32:
        assert tree(str(tmp_path / "rep")) == {k: v for k, v in want.items() if k.endswith(".txt")}


def test_cli_wide_matches_jax_cli(rng, tmp_path, capsys):
    tax = random_taxonomy(rng)
    lib = shared_library(rng, tax, n=4, length=2000)
    _write_library(tmp_path, tax, lib)
    reads = _reads(rng, lib, 80, 128, "r", genomes=4)
    write_fastq(tmp_path / "reads.fastq", reads)
    build = ["-l", str(tmp_path / "lib"), "-t", str(tmp_path / "tax"), "-k", "50", "-m", "45"]
    assert jcli.main(["build", "-i", str(tmp_path / "jidx"), *build]) == 0
    assert cli.main(["build", "-i", str(tmp_path / "tidx"), *build, "--device", "cpu"]) == 0
    assert "Saved" in capsys.readouterr().out
    for name in ("keys.npy", "taxa.npy"):
        assert (tmp_path / "jidx" / name).read_bytes() == (tmp_path / "tidx" / name).read_bytes()
    assert np.load(tmp_path / "tidx" / "keys.npy").shape[1] == 2
    # each CLI classifies with the other's index
    common = [str(tmp_path / "reads.fastq"), "-c", "0.0", "0.1"]
    assert jcli.main(["classify", "-i", str(tmp_path / "tidx"), "-o", str(tmp_path / "jout"), *common]) == 0
    assert cli.main(["classify", "-i", str(tmp_path / "jidx"), "-o", str(tmp_path / "tout"), *common,
                     "--device", "cpu"]) == 0
    a, b = tree(str(tmp_path / "jout")), tree(str(tmp_path / "tout"))
    assert len(a) == 4 and a == b
    assert sum(v.count(b"\nC\t") for v in a.values()) > 50
    with pytest.raises(NotImplementedError, match="m <= 31"):
        cli.main(["build", "-i", str(tmp_path / "x"), *build, "--ordering", "signature", "--device", "cpu"])
