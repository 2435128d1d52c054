"""The port's own host modules against the slacken_tpu originals they were
copied from, on the same inputs (exact: arrays, text and files): taxonomy,
report, storage, zio, the native packer with and without its C++ library,
the numpy half of ops/encode, and the synthetic workloads."""

import gzip
import os
import sys

import numpy as np
import pytest

import slacken_tpu.native as jnative
import slacken_tpu.report as jreport
import slacken_tpu.storage as jstorage
import slacken_tpu.taxonomy as jtaxonomy
import slacken_tpu.zio as jzio
from slacken_tpu.ops import encode as jencode
from slacken_tpu_torch import native, report, storage, taxonomy, utils, workloads, zio
from slacken_tpu_torch.ops import encode
from test_taxonomy import random_taxonomy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(params=[True, False], ids=["native", "fallback"])
def native_on(request, monkeypatch):
    if not request.param:
        monkeypatch.setattr(native, "_load", lambda: None)
    assert native.available() == request.param
    return request.param


def test_taxonomy_load_and_tables_match(rng, tmp_path):
    jtax = random_taxonomy(rng, size=80)
    jtax.save(str(tmp_path / "j"))
    tax = taxonomy.Taxonomy.load(str(tmp_path / "j"))
    tax.save(str(tmp_path / "t"))
    for name in sorted(os.listdir(tmp_path / "j")):
        assert (tmp_path / "j" / name).read_bytes() == (tmp_path / "t" / name).read_bytes(), name
    jtax = jtaxonomy.Taxonomy.load(str(tmp_path / "t"))
    assert np.array_equal(tax.parents, jtax.parents) and np.array_equal(tax.primary, jtax.primary)
    assert np.array_equal(tax.rpath_table(), jtax.rpath_table())
    assert np.array_equal(tax.rpath_table(12), jtax.rpath_table(12))
    assert tax.max_path_len == jtax.max_path_len and list(tax.taxa()) == list(jtax.taxa())
    taxa = list(tax.taxa())
    for a, b in zip(taxa, reversed(taxa)):
        assert tax.lca(a, b) == jtax.lca(a, b)
        assert list(tax.path_to_root(a)) == list(jtax.path_to_root(a))
    assert (taxonomy.NONE, taxonomy.ROOT) == (jtaxonomy.NONE, jtaxonomy.ROOT)


@pytest.mark.parametrize("compatible,zeros", [(False, False), (True, False), (False, True)])
def test_kraken_report_text_matches(rng, compatible, zeros):
    jtax = random_taxonomy(rng, size=60)
    tax = taxonomy.Taxonomy.from_nodes_and_names(
        [(t, int(jtax.parents[t]), jtaxonomy.depth_to_title(int(jtax.rank_depth[t])) or "no rank")
         for t in jtax.taxa()],
        [(t, jtax.get_name(t)) for t in jtax.taxa()])
    counts = [(int(t), int(rng.integers(1, 500))) for t in rng.choice(list(jtax.taxa()), 25)] + [(0, 17)]
    want = jreport.KrakenReport(jtax, counts, compatible, zeros).lines()
    got = report.KrakenReport(tax, counts, compatible, zeros).lines()
    assert got == want and len(want) > 10


def test_storage_round_trip_matches(rng, tmp_path):
    arr = rng.integers(0, 1 << 62, 1000).astype(np.uint64)
    for mod, name in ((storage, "t"), (jstorage, "j")):
        loc = mod.join(str(tmp_path), name, "deep")
        mod.makedirs(loc)
        mod.np_save(mod.join(loc, "a.npy"), arr)
        with mod.open_file(mod.join(loc, "x.json"), "w") as f:
            f.write("{}")
    assert (tmp_path / "t/deep/a.npy").read_bytes() == (tmp_path / "j/deep/a.npy").read_bytes()
    for mod in (storage, jstorage):  # each reads the other's files
        other = "j" if mod is storage else "t"
        assert np.array_equal(mod.np_load(str(tmp_path / other / "deep" / "a.npy")), arr)
        assert np.array_equal(mod.np_load(str(tmp_path / other / "deep" / "a.npy"), mmap=False), arr)
        assert mod.exists(str(tmp_path / other / "deep" / "x.json"))
        assert sorted(mod.listdir(str(tmp_path / other / "deep"))) == ["a.npy", "x.json"]
    assert storage.is_remote("gs://b/x") and not storage.is_remote(str(tmp_path))


def test_zio_writer_and_reader_match(rng, tmp_path):
    blocks = [("".join(chr(65 + int(c)) for c in rng.integers(0, 26, int(n))) + "\n")
              for n in rng.integers(1, 200_000, 12)]
    for mod, name in ((zio, "t.gz"), (jzio, "j.gz")):
        with mod.ParallelGzipWriter(str(tmp_path / name), level=1) as w:
            for i, b in enumerate(blocks):
                w.write(b) if i % 2 else w.write_bytes(b.encode())
    want = "".join(blocks).encode()
    assert gzip.open(tmp_path / "t.gz").read() == want == gzip.open(tmp_path / "j.gz").read()
    with zio.open_gz_subprocess(str(tmp_path / "j.gz")) as f:
        assert f.read() == want


def test_prefetch_iterator_order_and_errors():
    assert list(utils.prefetch_iterator(iter(range(100)), depth=2)) == list(range(100))

    def boom():
        yield 1
        raise KeyError("producer failed")

    it = utils.prefetch_iterator(boom())
    assert next(it) == 1
    with pytest.raises(KeyError, match="producer failed"):
        next(it)


def test_timer_lines_match(capsys, monkeypatch):
    import slacken_tpu.utils as jutils

    clock = iter([100.0, 225.4, 100.0, 225.4, 7.0, 7.5])
    for mod in (utils, jutils):
        monkeypatch.setattr(mod.time, "time", lambda: next(clock))
    outs = []
    for mod in (utils, jutils):
        t = mod.Timer("Build dynamic index")
        assert t.finish() == pytest.approx(125.4) and t.elapsed == pytest.approx(125.4)
        outs.append(capsys.readouterr())
    assert outs[0] == outs[1] and outs[0].out == ""
    assert outs[0].err == "Start task: Build dynamic index\nFinish task: Build dynamic index [2 min 5 s]\n"
    with utils.Timer("quiet", quiet=True) as t:
        pass
    assert t.elapsed == 0.5 and capsys.readouterr().err == ""


def test_genome_library_taxon_set_matches(rng, tmp_path):
    import slacken_tpu.inputs as jinputs
    from slacken_tpu_torch import inputs

    tax = random_taxonomy(rng, size=80)
    taxa = [int(t) for t in rng.choice(list(tax.taxa()), 6, replace=False)]
    labels = tmp_path / "seqid2taxid.map"
    labels.write_text("".join(f"s{i}\t{t}\n" for i, t in enumerate(taxa + [10_000_000, 0])) + "no taxon\n")
    got = inputs.GenomeLibrary([], str(labels)).taxon_set(tax)
    assert got == jinputs.GenomeLibrary([], str(labels)).taxon_set(tax)
    assert set(taxa) <= got and 1 in got and 10_000_000 not in got and len(got) > len(taxa)


def test_dynamic_criteria_and_gold_options_match():
    import dataclasses

    import slacken_tpu.dynamic as jdynamic
    from slacken_tpu_torch import dynamic

    for name, args in (("MinimizerTotalCount", (5,)), ("MinimizerDistinctCount", (7,)),
                       ("ClassifiedReadCount", (100, 0.15)), ("MinimizerFraction", (0.25,)),
                       ("GoldSetOptions", ("gold.txt", 7, True))):
        a, b = getattr(dynamic, name)(*args), getattr(jdynamic, name)(*args)
        assert repr(a) == repr(b) and dataclasses.asdict(a) == dataclasses.asdict(b)
        assert [f.name for f in dataclasses.fields(a)] == [f.name for f in dataclasses.fields(b)]
    with pytest.raises(dataclasses.FrozenInstanceError):
        dynamic.MinimizerTotalCount(5).threshold = 6


def _fastq(rng, n, width):
    lut = np.frombuffer(b"ACGTNacgtRU", np.uint8)
    recs = []
    for i in range(n):
        s = lut[rng.integers(0, len(lut), int(rng.integers(1, width)))].tobytes().decode()
        recs.append(f"@r{i} d{i}\n{s}\n+\n{'I' * len(s)}\n")
    return "".join(recs).encode()


def _same(a, b):
    assert np.array_equal(a.codes, b.codes) and a.codes.dtype == b.codes.dtype == np.uint8
    assert np.array_equal(a.lengths, b.lengths) and list(a.titles) == list(b.titles)
    assert (a.splits is None) == (b.splits is None)
    if a.splits is not None:
        assert np.array_equal(a.splits, b.splits)


@pytest.mark.parametrize("row_len", [None, 256])
def test_pack_fastq_chunk_matches(rng, native_on, row_len):
    buf = _fastq(rng, 50, 200)
    cut = buf + b"@partial\nACG"
    want, wc = jnative.pack_fastq_chunk(cut, row_len)
    got, gc = native.pack_fastq_chunk(cut, row_len)
    assert gc == wc == len(buf) and len(got) == 50
    _same(got, want)


def test_pack_fasta_chunk_matches(rng, native_on):
    buf = b">a one\nACGTNN\nacgtt\r\n>b\n" + b"GATTACA" * 40 + b"\n>empty\n>c\nAC\n"
    _same(native.pack_fasta_chunk(buf), jnative.pack_fasta_chunk(buf))
    _same(native.pack_fasta_chunk(buf, 16), jnative.pack_fasta_chunk(buf, 16))
    assert np.array_equal(native.encode_bytes(b"ACGTUNacgtx"), jnative.encode_bytes(b"ACGTUNacgtx"))


def test_pack_pairs_matches(rng, native_on):
    p1, _ = native.pack_fastq_chunk(_fastq(rng, 40, 150))
    p2, _ = native.pack_fastq_chunk(_fastq(rng, 37, 260))
    j1 = jnative.PackedReads(p1.codes, p1.lengths, p1.titles)
    j2 = jnative.PackedReads(p2.codes, p2.lengths, p2.titles)
    got, want = native.pack_pairs(p1, p2), jnative.pack_pairs(j1, j2)
    assert len(got) == 37 and got.codes.shape[1] == p1.codes.shape[1] + 1 + p2.codes.shape[1]
    _same(got, want)


def test_hit_lines_and_output_lines_match(rng, native_on):
    """The C++ formatters of the port's own library against the original's,
    and (fallback) both return None for the caller's Python path."""
    b, l, k = 64, 128, 35
    codes = rng.integers(0, 4, (b, l)).astype(np.uint8)
    codes[rng.random((b, l)) < 0.03] = 4
    codes[:, 100:] = 4
    wt = rng.integers(0, 5, (b, l)).astype(np.int32)
    splits = np.where(np.arange(b) % 2 == 0, -1, 48).astype(np.int64)
    codes[splits >= 0, 48] = 4
    lens = np.full(b, 100, np.int64)
    got = native.hit_lines(codes, wt, splits, lens, k)
    if not native_on:
        assert got is None
        assert native.output_lines_dense(codes, wt, splits, lens, b"", np.zeros(b + 1, np.int64),
                                         np.zeros(b, np.int64), np.zeros(b, np.uint8), k, 0) is None
        return
    assert got == jnative.hit_lines(codes, wt, splits, lens, k)
    titles = [f"read{i}".encode() for i in range(b)]
    offs = np.zeros(b + 1, np.int64)
    np.cumsum([len(t) for t in titles], out=offs[1:])
    rtax = rng.integers(0, 5, b).astype(np.int64)
    cl = (rtax > 0).astype(np.uint8)
    idxs = np.arange(0, b, 3)
    outs = []
    for mod in (native, jnative):
        buf, starts, ends = mod.output_lines_dense(codes, wt, splits, lens, b"".join(titles), offs,
                                                   rtax, cl, k, 8)
        outs.append(bytes(mod.gather_rows(buf, starts, ends, idxs)))
    assert outs[0] == outs[1] and outs[0].count(b"\n") == len(idxs)


def test_hit_lines_runs_and_output_lines_runs_match(native_on):
    """The runs formatters of the port's own library against the original's
    on the same hit runs (single-end and paired rows, ambiguous runs, rows
    over the cap passed capped), and (fallback) both return None."""
    import torch

    from slacken_tpu_torch.ops import hitruns

    k, cap = 35, hitruns.DEFAULT_RUNS_PER_ROW
    wt, valid, splits, lens = workloads.hit_runs_rows(3, 64, 128, k, paired=True)
    splits[::3] = -1  # single reads among paired rows
    bundle = hitruns.hit_runs_plain(*(torch.from_numpy(a) for a in (wt, valid, splits, lens)), k, cap).numpy()
    values, counts, nruns, totals, _ = hitruns.decode(bundle, cap)
    nruns = np.minimum(nruns, cap)
    splits = splits.astype(np.int64)
    got = native.hit_lines_runs(values, counts, nruns, totals, splits, k)
    b = len(values)
    titles = [f"read{i}".encode() for i in range(b)]
    offs = np.zeros(b + 1, np.int64)
    np.cumsum([len(t) for t in titles], out=offs[1:])
    rtax = (np.arange(b) % 5).astype(np.int64)
    cl = (rtax > 0).astype(np.uint8)
    args = (values, counts, nruns, totals, splits, b"".join(titles), offs, rtax, cl, k, 8)
    if not native_on:
        assert got is None and native.output_lines_runs(*args) is None
        return
    assert got == jnative.hit_lines_runs(values, counts, nruns, totals, splits, k)
    assert any("A:" in d for d, _ in got) and any("|:|" in d for d, _ in got)
    idxs = np.arange(0, b, 3)
    outs = [bytes(mod.gather_rows(*mod.output_lines_runs(*args), idxs)) for mod in (native, jnative)]
    assert outs[0] == outs[1] and outs[0].count(b"\n") == len(idxs)


def test_native_library_is_the_ports_own():
    path = native.library_path()
    assert os.path.dirname(path) == os.path.join(ROOT, "slacken_tpu_torch", "_build")
    assert os.path.basename(path).startswith("libstpu_packer_") and native.available()
    assert os.path.exists(path)
    assert native._SRC == os.path.join(ROOT, "slacken_tpu_torch", "native", "packer.cpp")
    with open(os.path.join(ROOT, "slacken_tpu_torch", "native.py")) as f:
        assert "libslackenio" not in f.read()


def test_encode_matches(rng):
    for s in ("ACGTUacgtuNnRx-", b"GATTACA", ""):
        assert np.array_equal(encode.encode_seq(s), jencode.encode_seq(s))
    assert np.array_equal(encode.CODE_LUT, jencode.CODE_LUT) and encode.INVALID == jencode.INVALID
    codes = rng.integers(0, 5, (33, 136)).astype(np.uint8)
    for a, b in zip(encode.pack_2bit(codes), jencode.pack_2bit(codes)):
        assert np.array_equal(a, b) and a.dtype == b.dtype
    seqs = ["ACGT" * 10, encode.encode_seq("NNACGT"), b"G" * 70]
    for a, b in zip(encode.pack_batch(seqs, 48), jencode.pack_batch(seqs, 48)):
        assert np.array_equal(a, b) and a.dtype == b.dtype


def test_workloads_match_the_bench_scripts(monkeypatch):
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    sys.path.insert(0, ROOT)
    import bench
    import scale_bench

    monkeypatch.setattr(workloads, "BENCH_SIZES", {455631: 41_000, 526997: 31_000, 9606: 8_000})
    monkeypatch.setattr(bench, "synthetic_library", _small_bench_library)
    a = list(workloads.bench_library(np.random.default_rng(3)))
    assert a == list(bench.synthetic_library(np.random.default_rng(3)))
    assert list(workloads.scale_library(1_500_000, 12)) == list(scale_bench.synthetic_library(1_500_000, 12))
    assert list(workloads.scale_library(600_000, 5, seed=9)) == list(scale_bench.synthetic_library(600_000, 5, 9))
    jtax, tax = bench._bench_taxonomy(), workloads.bench_taxonomy()
    assert np.array_equal(tax.parents, jtax.parents) and tax.names == jtax.names
    assert list(workloads.scale_taxonomy(7).taxa()) == [1, *range(10, 17)]
    # the read simulators, restated from bench.py:59-74 and scale_bench.py:112-131
    for reads, lib, per, cut in (
        (workloads.bench_reads(2), workloads.bench_library(np.random.default_rng(20260816)), 3334, None),
        (workloads.scale_reads(1_500_000, 12, 4000), scale_bench.synthetic_library(1_500_000, 12), 500,
         2_000_000),
    ):
        sim_rng = np.random.default_rng(7)
        want = []
        for j, (taxon, seq) in enumerate(lib):
            if j >= 8:
                break
            codes_full = jencode.encode_seq(seq[:cut])
            starts = sim_rng.integers(0, len(codes_full) - 101, per)
            rows = codes_full[starts[:, None] + np.arange(101)[None, :]].astype(np.uint8)
            mut = sim_rng.random(rows.shape) < 0.01
            rows[mut] = sim_rng.integers(0, 4, mut.sum())
            rows = np.pad(rows, ((0, 0), (0, 27)), constant_values=4)
            want.append((rows, [f"sim{taxon}_{i}" for i in range(len(rows))]))
        assert len(reads) % len(want) == 0 and len(reads) >= len(want)
        for i, p in enumerate(reads):
            rows, titles = want[i % len(want)]
            assert np.array_equal(p.codes, rows) and p.titles == titles
            assert np.array_equal(p.lengths, np.full(len(rows), 101, np.int32)) and p.splits is None


def _small_bench_library(rng):
    """bench.synthetic_library (bench.py:39-45) at a hundredth of its sizes."""
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    for taxon, n in {455631: 41_000, 526997: 31_000, 9606: 8_000}.items():
        yield taxon, lut[rng.integers(0, 4, n)].tobytes().decode("ascii")


def test_bench_pairs_are_mates(tmp_path, monkeypatch):
    monkeypatch.setattr(workloads, "BENCH_SIZES", {455631: 41_000, 526997: 31_000, 9606: 8_000})
    pairs = workloads.bench_pairs(30)
    assert pairs == workloads.bench_pairs(30) and len({p[0] for p in pairs}) == 30
    lib = dict(workloads.bench_library(np.random.default_rng(workloads.BENCH_SEED)))
    comp = str.maketrans("ACGT", "TGCA")
    for title, s1, s2 in pairs:
        assert len(s1) == len(s2) == 101
        genome = lib[int(title[4:].split("_")[0])]
        # mutations are 1%: a 25-mer of each mate is found in the genome,
        # mate 2 on the reverse strand, 300-400 bp downstream
        hits1 = [genome.find(s1[a : a + 25]) - a for a in range(0, 76, 25)]
        rc2 = s2.translate(comp)[::-1]
        hits2 = [genome.find(rc2[a : a + 25]) - a for a in range(0, 76, 25)]
        start, end = max(hits1, key=hits1.count), max(hits2, key=hits2.count) + 101
        assert 300 <= end - start <= 400, (title, hits1, hits2)
    f1, f2 = str(tmp_path / "a_1.fastq"), str(tmp_path / "a_2.fastq")
    workloads.write_paired_fastq(pairs, f1, f2)
    from slacken_tpu_torch import inputs

    assert [(h.split("/")[0], a, b) for h, a, b in inputs.read_pairs(f1, f2)] == pairs
