"""The port's paired and per-record input readers against slacken_tpu's on
the same files (exact: arrays, titles and strings)."""

import gzip

import numpy as np
import pytest

from slacken_tpu import inputs as jinputs
from slacken_tpu_torch import inputs


def _write_mates(tmp_path, rng, n=60, order2=None, gz=False, suffix=True):
    """Two mate FASTQ files of n records with varying lengths, some Ns and
    lower case; file 2 in the order `order2`."""
    lut = np.frombuffer(b"ACGTNacgt", np.uint8)
    recs = []
    for i in range(n):
        s1 = lut[rng.integers(0, 9, int(rng.integers(30, 140)))].tobytes().decode()
        s2 = lut[rng.integers(0, 9, int(rng.integers(30, 140)))].tobytes().decode()
        recs.append((f"read{i}", s1, s2))
    paths = [str(tmp_path / f"m{j}.fastq{'.gz' if gz else ''}") for j in (1, 2)]
    opener = (lambda p: gzip.open(p, "wt")) if gz else (lambda p: open(p, "w"))
    for j, path in enumerate(paths):
        ids = range(n) if j == 0 or order2 is None else order2
        with opener(path) as f:
            for i in ids:
                title = f"{recs[i][0]}/{j + 1} extra" if suffix else recs[i][0]
                f.write(f"@{title}\n{recs[i][1 + j]}\n+\n{'I' * len(recs[i][1 + j])}\n")
    return paths


def _same_packed(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert np.array_equal(x.codes, y.codes) and x.codes.dtype == y.codes.dtype
        assert np.array_equal(x.lengths, y.lengths)
        assert np.array_equal(x.splits, y.splits)
        assert list(x.titles) == list(y.titles)


@pytest.mark.parametrize("gz,chunk_bytes", [(False, 64 << 20), (True, 64 << 20), (False, 1500)])
def test_packed_pairs_from_files_match(tmp_path, rng, gz, chunk_bytes):
    f1, f2 = _write_mates(tmp_path, rng, gz=gz)
    want = list(jinputs.packed_pairs_from_files(f1, f2, chunk_bytes))
    got = list(inputs.packed_pairs_from_files(f1, f2, chunk_bytes))
    assert sum(len(p) for p in got) == 60
    _same_packed(got, want)


def test_packed_pairs_out_of_order_raise(tmp_path, rng):
    f1, f2 = _write_mates(tmp_path, rng, order2=[1, 0, *range(2, 60)])
    with pytest.raises(inputs.MatesOutOfOrder, match="record order"):
        list(inputs.packed_pairs_from_files(f1, f2))


@pytest.mark.parametrize("shuffled", [False, True])
@pytest.mark.parametrize("suffix", [False, True])
def test_read_pairs_match(tmp_path, rng, shuffled, suffix):
    order2 = list(rng.permutation(60)) if shuffled else None
    f1, f2 = _write_mates(tmp_path, rng, order2=order2, suffix=suffix)
    want = list(jinputs.read_pairs(f1, f2))
    assert list(inputs.read_pairs(f1, f2)) == want and len(want) == 60
    if shuffled:
        with pytest.raises(ValueError, match="diverge"):
            list(inputs.read_pairs(f1, f2, max_pending=3))


@pytest.mark.parametrize("paired,max_fragment", [(False, None), (False, 64), (True, None)])
def test_fragments_from_files_match(tmp_path, rng, paired, max_fragment):
    f1, f2 = _write_mates(tmp_path, rng, order2=list(rng.permutation(60)))
    fasta = str(tmp_path / "x.fa")
    with open(fasta, "w") as f:
        f.write(">a desc\nACGTACGTAC\nGGGTTT\n>b\n" + "ACGTTGCA" * 30 + "\n")
    files = [f1, f2] if paired else [f1, fasta]
    (tmp_path / "list.txt").write_text("\n".join(files) + "\n")
    want = list(jinputs.fragments_from_files(files, paired, max_fragment, k=35))
    got = list(inputs.fragments_from_files([f"@{tmp_path / 'list.txt'}"], paired, max_fragment, k=35))
    assert [tuple(x) for x in got] == [tuple(x) for x in want] and len(got) >= 60
    if paired:
        with pytest.raises(ValueError, match="even number"):
            list(inputs.fragments_from_files([f1], paired=True))


def test_malformed_fastq_raises(tmp_path):
    bad = tmp_path / "bad.fastq"
    bad.write_text("@r1\nACGT\n+\nIIII\n@r2\nACGT\n")
    with pytest.raises(ValueError, match="truncated"):
        list(inputs.read_fastq(str(bad)))
