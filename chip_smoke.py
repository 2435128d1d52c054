#!/usr/bin/env python3
"""Smoke run of slacken_tpu_torch on one NVIDIA GPU (H100).

Run from the repository root: `python3 chip_smoke.py`. It builds the CUDA
kernels from ops/kernels/*.cu, checks each kernel bit-exact against its
plain PyTorch twin on the card, then drives the port's paths, each with the
kernels' launch counts set to 0 just before it and read just after:

  * reports mode: build the bench library's index on the card (2,623,028
    records expected) and on the CPU, classify the bench's simulated reads
    on both and require byte-identical kreports;
  * per-read mode: the same reads with per-read output, card against CPU,
    lines and kreports byte-identical after decompression, kreports equal
    to reports mode's;
  * paired input: two FASTQ files of simulated mates through the CLI's own
    function on the card and on the CPU;
  * the programmatic API (Slacken.classify_reads, write_reports,
    Classifier.classify_and_write) on reads and pairs, card against CPU;
  * the kernel diagnostics entry point (the five mask-idiom kernels);
  * the 400 Mbp scale library, built and classified (131,190,899 records).

It prints the measured numbers, one JSON line of per-kernel results (time
beside its bound, the plain twin's time and a library call's where there is
one), and as its last line {"ok": true, "device": {...}}. It stops at the
first failure with a non-zero exit; without CUDA, or outside the repository,
it exits 1 before printing any result.
"""

from __future__ import annotations

import gzip
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_RECORDS = 2_623_028  # docs/PERF.md:299, the JAX package's bench index
SCALE_RECORDS = 131_190_899  # docs/PERF.md:328, the JAX package's scale index
SCALE_BP = 400_000_000
SCALE_TAXA = 64
PAIRS = 30_000
API_READS = 3_000
# NVIDIA H100 SXM data sheet: device memory rate, and the float32 rate
# outside the tensor cores, taken here as the ceiling for 32-bit integer
# operations too
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12


def log(*a):
    print(*a, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes, n_ops):
    """The least time the card could take: the larger of bytes over the
    memory rate (each input read once, each output written once) and
    operations over the peak rate. Returns (ms, "bytes" or "operations")."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S * 1e3, n_ops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tensor_bytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def random_codes(rng, shape, invalid=0.05):
    codes = rng.integers(0, 4, shape).astype(np.uint8)
    codes[rng.random(shape) < invalid] = 4
    return codes


def check_scan(rng, dev, results):
    import torch

    from slacken_tpu_torch.ops import cuda_kernels, encode, minimizers

    mp = minimizers.MinimizerParams()
    err = 0
    # random shapes, then the main path's: a 4 Mbp classify batch of 128 bp
    # rows, one of paired rows (two 128-wide mates and the separator, padded
    # to 264) and a build batch of 4 kbp genome rows (index._default_batch)
    for shape in [(4096, 128), (512, 1024), (32768, 128), (16384, 264), (8192, 4096)]:
        packed, valid = (torch.from_numpy(a).to(dev) for a in encode.pack_2bit(random_codes(rng, shape)))
        got = minimizers.window_minimizers_packed(packed, valid, mp)
        want = minimizers.window_minimizers(encode.unpack_2bit(packed, valid), mp)
        torch.cuda.synchronize()
        for name in ("valid", "span_start", "distinct"):
            if not torch.equal(getattr(got, name), getattr(want, name)):
                fail(f"scan {name} differs from the twin at {shape}")
        v = want.valid
        diff = (got.minimizer[v] - want.minimizer[v]).abs()
        err = max(err, int(diff.max()) if diff.numel() else 0)
        if err:
            fail(f"scan minimizers differ from the twin at {shape} (max abs err {err})")
        log(f"scan kernel == twin at {list(shape)}: valid windows {int(v.sum())}, "
            f"span starts {int(got.span_start.sum())}, max_abs_err 0")
    packed, valid = (torch.from_numpy(a).to(dev) for a in encode.pack_2bit(random_codes(rng, (32768, 128))))
    ms = cuda_ms(lambda: cuda_kernels.window_minimizers_cuda(packed, valid, mp))
    plain = cuda_ms(lambda: minimizers.window_minimizers(encode.unpack_2bit(packed, valid), mp), iters=5)
    # bytes: packed codes and validity bits in; int64 minimizers and three
    # flag arrays out. Operations: about 48 32-bit integer operations a
    # position suffice (rolling forward and reverse m-mers, spaced mask,
    # toggle, canonical min, a min over k-m+1 windows, the three flags).
    n_pos = packed.shape[0] * packed.shape[1] * 4
    bound_ms, by = bound(tensor_bytes(packed, valid) + n_pos * (8 + 3), 48 * n_pos)
    log(f"scan [32768, 128]: kernel {ms:.4f} ms, plain PyTorch on the card {plain:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({by}); no single library call computes it")
    results["scan"] = dict(max_abs_err=float(err), ms=ms, plain_ms=plain, bound_ms=bound_ms,
                           bound_by=by, library_ms=None)


def check_probe(rng, dev, results):
    import torch

    from slacken_tpu_torch.ops import cuda_kernels, lookup

    n = 2_000_000
    keys = np.unique(rng.integers(0, 1 << 62, int(n * 1.01), dtype=np.int64))[:n]
    taxa = rng.integers(1, 1 << 20, len(keys)).astype(np.int32)
    nq = 1 << 22  # one 4 Mbp batch probes every window position
    hits = keys[rng.integers(0, len(keys), nq // 2)]
    misses = rng.integers(0, 1 << 62, nq // 2 - 1000, dtype=np.int64)
    wild = rng.integers(1 << 62, (1 << 63) - 1, 1000, dtype=np.int64)  # garbage queries
    q = np.concatenate([hits, misses, wild, [-5, 0, keys[0], keys[-1], (1 << 63) - 1]])
    rng.shuffle(q)
    k_d, t_d, q_d = (torch.from_numpy(a).to(dev) for a in (keys, taxa, q))
    fence = lookup.build_fence(k_d)
    got = lookup.probe(k_d, t_d, fence, q_d)
    want = lookup.lookup_taxa(k_d, t_d, q_d)
    torch.cuda.synchronize()
    err = int((got - want).abs().max())
    if err:
        fail(f"probe differs from the twin (max abs err {err})")
    log(f"probe kernel == twin: {len(keys)} keys, {len(q)} queries, {int((got > 0).sum())} hits, max_abs_err 0")
    qm = q_d[:nq]
    ms = cuda_ms(lambda: cuda_kernels.lookup_taxa_fence_cuda(k_d, t_d, fence, qm))
    plain = cuda_ms(lambda: lookup.lookup_taxa(k_d, t_d, qm))
    library = cuda_ms(lambda: torch.searchsorted(k_d, qm))
    # bytes: queries, keys, taxa and fence in, taxa out. Operations: one
    # compare-and-step (about 3 integer operations) per level of a binary
    # search over the keys, for every query.
    out_bytes = nq * 4
    n_ops = 3 * nq * int(np.ceil(np.log2(len(keys))))
    bound_ms, by = bound(tensor_bytes(qm, k_d, t_d, fence) + out_bytes, n_ops)
    log(f"probe 2M keys x {nq} queries: kernel {ms:.4f} ms, plain twin {plain:.4f} ms, "
        f"torch.searchsorted alone {library:.4f} ms, bound {bound_ms:.4f} ms ({by})")
    results["probe"] = dict(max_abs_err=float(err), ms=ms, plain_ms=plain, bound_ms=bound_ms,
                            bound_by=by, library_ms=library)


def check_mask_idioms(dev, results):
    """Each of the five mask-idiom kernels == its twin at [8, 128] and
    [4096, 128] (the diagnostics entry point's inputs); timed at the latter."""
    import torch

    from slacken_tpu_torch import diagnostics
    from slacken_tpu_torch.ops import cuda_kernels, mask_idioms

    inputs = diagnostics.probe_inputs(dev)
    big = inputs["[4096, 128] random"]
    # select and astype are both the int32 0/1 of x > 64, which one library
    # call computes: a comparison casts its result into a non-bool `out`. The
    # other three (a shifted and, a shifted select, a sum added back) take
    # several calls each, so they have no library time.
    library_out = torch.empty_like(big)
    library = {name: (lambda: torch.gt(big, mask_idioms.THRESHOLD, out=library_out))
               for name in ("select", "astype")}
    for name, plain_fn in mask_idioms.PLAIN.items():
        err = 0
        for label, x in inputs.items():
            got, want = cuda_kernels.mask_idiom_cuda(name, x), plain_fn(x)
            torch.cuda.synchronize()
            if got.dtype != want.dtype or got.shape != want.shape:
                fail(f"{name} kernel returns {got.dtype} {tuple(got.shape)} at {label}")
            err = max(err, int((got.long() - want.long()).abs().max()))
            if err:
                fail(f"{name} kernel differs from its twin at {label} (max abs err {err})")
        ms = cuda_ms(lambda: cuda_kernels.mask_idiom_cuda(name, big), iters=50)
        plain = cuda_ms(lambda: plain_fn(big), iters=50)
        library_ms = None
        if name in library:
            if not torch.equal(library[name](), plain_fn(big)):
                fail(f"torch.gt(out=int32) is not the function of the {name} kernel")
            library_ms = cuda_ms(library[name], iters=50)
        # bytes: the array in, the array out; about 3 operations an element
        bound_ms, by = bound(2 * tensor_bytes(big), 3 * big.numel())
        log(f"{name} kernel == twin at [8, 128] and [4096, 128], max_abs_err 0; at [4096, 128]: "
            f"kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {bound_ms:.5f} ms ({by}), " +
            ("no single library call computes it" if library_ms is None
             else f"torch.gt(out=int32) {library_ms:.4f} ms"))
        results[name] = dict(max_abs_err=float(err), ms=ms, plain_ms=plain, bound_ms=bound_ms,
                             bound_by=by, library_ms=library_ms)


def check_resolve(rng, dev):
    """compact_hits, resolve_hits and finalize on the card == on the CPU."""
    import torch

    from slacken_tpu_torch.classify import finalize
    from slacken_tpu_torch.ops import resolve
    from slacken_tpu_torch.taxonomy import Taxonomy

    n = 200
    parents = [1] + [int(rng.integers(1, i)) for i in range(2, n + 1)]
    nodes = [(1, 1, "root")] + [(i, parents[i - 1], "no rank") for i in range(2, n + 1)]
    tax = Taxonomy.from_nodes_and_names(nodes, [(t, f"t{t}") for t, _, _ in nodes])
    table = tax.rpath_table()
    b, l = 4096, 128
    wt = rng.integers(1, n + 1, (b, l)).astype(np.int32)
    wt[:, : l // 2] = rng.integers(1, 6, (b, l // 2))  # few taxa per row, most rows fit T
    wt[rng.random((b, l)) < 0.2] = 0
    wt[rng.random((b, l)) < 0.1] = resolve.INVALID_WINDOW
    wt[: b // 2, 40:] = resolve.INVALID_WINDOW
    nd = rng.integers(0, 5, b).astype(np.int32)
    ambig = rng.integers(0, 3, b).astype(np.int32)
    totals = np.arange(l + 1, dtype=np.float64)
    lut = np.stack([np.ceil(t * totals) for t in (0.0, 0.15, 0.5)]).astype(np.int32)
    outs = []
    for d in ("cpu", dev):
        t = lambda a: torch.from_numpy(a).to(d)  # noqa: E731
        ch = resolve.compact_hits(t(wt), 32)
        res = resolve.resolve_hits(ch.taxa, ch.counts, t(table))
        bundle = finalize(res, t(nd), ch.n_hit_kmers, ch.n_none_kmers, ch.overflow, t(ambig), t(lut))
        outs.append([x.cpu() for x in (*ch, *res, bundle)])
    for a, c in zip(*outs):
        if not torch.equal(a, c):
            fail("compact_hits/resolve_hits/finalize differ between the card and the CPU")
    log(f"compact_hits + resolve_hits + finalize on the card == CPU: {b} rows, "
        f"{int(outs[0][4].sum())} overflow rows, {int((outs[0][-1][:, 3] > 0).sum())} classified at 0.0")


def classified_count(report_path):
    lines = open(report_path).read().splitlines()[1:]
    total = sum(int(x.split("\t")[1]) for x in lines if x.split("\t")[3] in ("U", "R"))
    uncl = next((int(x.split("\t")[1]) for x in lines if x.split("\t")[3] == "U"), 0)
    return total - uncl, total


def require_launches(path, launches, names=("scan", "probe")):
    log(f"{path}: kernel launches {launches}")
    for name in names:
        if launches[name] == 0:
            fail(f"{path} never launched the {name} kernel")


def output_tree(prefix):
    """{path below <prefix>_c*: bytes} of a classify output, .gz inflated."""
    base, stem = os.path.dirname(prefix), os.path.basename(prefix)
    files = {}
    for top in sorted(x for x in os.listdir(base) if x.startswith(stem + "_c")):
        for root, _, names in os.walk(os.path.join(base, top)):
            for name in names:
                path = os.path.join(root, name)
                with (gzip.open if name.endswith(".gz") else open)(path, "rb") as f:
                    files[os.path.relpath(path, base)[len(stem):]] = f.read()
    return files


def timed_runs(fn, n=3):
    import torch

    times = []
    for r in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(r)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def phase_bench(dev, out):
    """Reports mode. Returns what the later phases reuse: the card's and the
    CPU's index, the reads, and the reports-mode rate."""
    import torch

    from slacken_tpu_torch import workloads
    from slacken_tpu_torch.classify import Classifier, ClassifyParams
    from slacken_tpu_torch.index import IndexParams, KeyValueIndex
    from slacken_tpu_torch.ops import cuda_kernels

    tax = workloads.bench_taxonomy()
    params = IndexParams(k=35, m=31, spaces=7)
    reads = workloads.bench_reads()
    n_reads = sum(len(p) for p in reads)
    cpar = ClassifyParams(thresholds=[0.0, 0.15], per_read_output=False)
    library = lambda: workloads.bench_library(np.random.default_rng(workloads.BENCH_SEED))  # noqa: E731

    cuda_kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx = KeyValueIndex.build(library(), params, tax, dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_launches = dict(cuda_kernels.LAUNCHES)
    log(f"bench build on the card: {idx.num_records} records in {build_s:.3f} s "
        f"({8e6 / build_s / 1e6:.2f} Mbp/s incl. host packing), kernel launches {build_launches}")
    if idx.num_records != BENCH_RECORDS:
        fail(f"bench index has {idx.num_records} records, expected {BENCH_RECORDS}")
    cls = Classifier(idx, dev)
    cls.classify_and_write_packed(reads, os.path.join(out, "gpu"), cpar)  # warm
    cuda_kernels.reset_launch_counts()
    times = timed_runs(lambda r: cls.classify_and_write_packed(reads, os.path.join(out, f"gpu{r}"), cpar))
    launches = dict(cuda_kernels.LAUNCHES)
    med = statistics.median(times)
    log(f"bench classify on the card, reports mode: {n_reads} reads, runs "
        f"{[round(t, 4) for t in times]} s, median {n_reads / med:.1f} reads/s")
    require_launches("reports mode (3 runs)", launches)
    profile_run(lambda: cls.classify_and_write_packed(reads, os.path.join(out, "prof"), cpar), "reports mode")

    t0 = time.perf_counter()
    idx_cpu = KeyValueIndex.build(library(), params, tax, "cpu")
    log(f"bench build on the CPU (plain twins): {idx_cpu.num_records} records in {time.perf_counter() - t0:.1f} s")
    if not (np.array_equal(idx.keys, idx_cpu.keys) and np.array_equal(idx.taxa, idx_cpu.taxa)):
        fail("the card's bench index differs from the CPU build")
    t0 = time.perf_counter()
    Classifier(idx_cpu, "cpu").classify_and_write_packed(reads, os.path.join(out, "cpu"), cpar)
    log(f"bench classify on the CPU (plain twins): {time.perf_counter() - t0:.1f} s")
    for th in ("0.00", "0.15"):
        for run in ["gpu", "gpu0", "gpu1", "gpu2"]:
            a = open(os.path.join(out, f"{run}_c{th}", "all_kreport.txt"), "rb").read()
            b = open(os.path.join(out, f"cpu_c{th}", "all_kreport.txt"), "rb").read()
            if a != b:
                fail(f"kreport at threshold {th} differs between the card ({run}) and the CPU")
        c, total = classified_count(os.path.join(out, f"gpu_c{th}", "all_kreport.txt"))
        log(f"bench kreports byte-identical card vs CPU at {th}: classified {c} of {total}")
        if total != n_reads:
            fail(f"kreport counts {total} reads, expected {n_reads}")
    if classified_count(os.path.join(out, "gpu_c0.00", "all_kreport.txt"))[0] < 0.9 * n_reads:
        fail("fewer than 90% of the bench's simulated reads classified")
    breakdown(cls, reads, cpar)
    return dict(idx=idx, idx_cpu=idx_cpu, reads=reads, n_reads=n_reads, cls=cls,
                reports_rate=n_reads / med, launches=launches)


def phase_detailed(dev, out, bench):
    """Per-read mode on the bench reads: card against CPU, and against
    reports mode's kreports."""
    import torch

    from slacken_tpu_torch.classify import Classifier, ClassifyParams
    from slacken_tpu_torch.ops import cuda_kernels

    cls, reads, n_reads = bench["cls"], bench["reads"], bench["n_reads"]
    cpar = ClassifyParams(thresholds=[0.0, 0.15], per_read_output=True)
    cls.classify_and_write_packed(reads, os.path.join(out, "det"), cpar)  # warm
    cuda_kernels.reset_launch_counts()
    times = timed_runs(lambda r: cls.classify_and_write_packed(reads, os.path.join(out, f"det{r}"), cpar))
    launches = dict(cuda_kernels.LAUNCHES)
    rate = n_reads / statistics.median(times)
    log(f"bench classify on the card, per-read mode: {n_reads} reads, runs "
        f"{[round(t, 4) for t in times]} s, median {rate:.1f} reads/s "
        f"({rate / bench['reports_rate']:.3f} of reports mode's {bench['reports_rate']:.1f})")
    require_launches("per-read mode (3 runs)", launches)
    profile_run(lambda: cls.classify_and_write_packed(reads, os.path.join(out, "detprof"), cpar),
                "per-read mode")
    t0 = time.perf_counter()
    Classifier(bench["idx_cpu"], "cpu").classify_and_write_packed(reads, os.path.join(out, "detcpu"), cpar)
    log(f"per-read classify on the CPU (plain twins): {time.perf_counter() - t0:.1f} s")
    want = output_tree(os.path.join(out, "detcpu"))
    reports = {k: v for k, v in output_tree(os.path.join(out, "gpu")).items() if k.endswith(".txt")}
    if len(want) != 4 or len(reports) != 2:
        fail(f"per-read output holds {sorted(want)}, reports mode {sorted(reports)}")
    for run in ["det", "det0", "det1", "det2"]:
        got = output_tree(os.path.join(out, run))
        if got != want:
            fail(f"per-read output of the card ({run}) differs from the CPU's")
        if {k: v for k, v in got.items() if k.endswith(".txt")} != reports:
            fail(f"per-read mode's kreports ({run}) differ from reports mode's")
    n_lines = {k: v.count(b"\n") for k, v in want.items() if k.endswith(".gz")}
    log(f"per-read lines and kreports byte-identical card vs CPU, kreports equal to reports "
        f"mode's; lines per file {n_lines}")
    if any(n != n_reads for n in n_lines.values()):
        fail(f"per-read files hold {n_lines} lines, expected {n_reads} each")
    rows = cls.target_batch_bp // 128
    src = torch.zeros((rows, 128), dtype=torch.int32, device=dev)
    dst = torch.empty((rows, 128), dtype=torch.int32, pin_memory=True)
    ms = cuda_ms(lambda: dst.copy_(src, non_blocking=True))
    log(f"device-to-host copy of one batch's window taxa ([{rows}, 128] int32, "
        f"{tensor_bytes(src) / 2**20:.0f} MiB) into pinned memory: {ms:.4f} ms on the device, "
        f"{tensor_bytes(src) / ms / 1e6:.2f} GB/s")
    return launches


def phase_paired(dev, out, bench):
    """Paired FASTQ files through the CLI's own function, card against CPU."""
    from slacken_tpu_torch import cli, workloads
    from slacken_tpu_torch.ops import cuda_kernels

    pairs = bench["pairs"] = workloads.bench_pairs(PAIRS)
    f1, f2 = os.path.join(out, "mates_1.fastq"), os.path.join(out, "mates_2.fastq")
    workloads.write_paired_fastq(pairs, f1, f2)
    idx_dir = os.path.join(out, "idx")
    bench["idx"].save(idx_dir)
    common = ["classify", "-i", idx_dir, "-p", f1, f2, "-c", "0.0", "0.15"]
    cuda_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    if cli.main([*common, "-o", os.path.join(out, "pair")]) != 0:
        fail("the paired classify CLI failed on the card")
    dt = time.perf_counter() - t0
    launches = dict(cuda_kernels.LAUNCHES)
    require_launches("paired CLI", launches)
    t0 = time.perf_counter()
    if cli.main([*common, "-o", os.path.join(out, "paircpu"), "--device", "cpu"]) != 0:
        fail("the paired classify CLI failed on the CPU")
    log(f"paired CLI: {PAIRS} pairs, {dt:.2f} s on the card incl. index load and kernel "
        f"warm-up, {time.perf_counter() - t0:.1f} s on the CPU")
    got, want = output_tree(os.path.join(out, "pair")), output_tree(os.path.join(out, "paircpu"))
    if got != want or len(got) != 4:
        fail("paired per-read output differs between the card and the CPU")
    lines = got[os.path.join("_c0.00", "sample=all", "part-00000.txt.gz")]
    n_lines, n_borders = lines.count(b"\n"), lines.count(b"|:|")
    if n_lines != PAIRS or n_borders != PAIRS:
        fail(f"paired output holds {n_lines} lines and {n_borders} mate borders for {PAIRS} pairs")
    c, total = classified_count(os.path.join(out, "pair_c0.00", "all_kreport.txt"))
    log(f"paired lines and kreports byte-identical card vs CPU: classified {c} of {total}")
    if total != PAIRS or c < 0.9 * PAIRS:
        fail(f"paired run classified {c} of {total} pairs")
    return launches


def phase_api(dev, out, bench):
    """The programmatic entry points, card against CPU: Slacken.classify_reads
    on single reads and on pairs, Slacken.write_reports, and
    Classifier.classify_and_write on both kinds mixed."""
    from slacken_tpu_torch.api import Slacken
    from slacken_tpu_torch.classify import Classifier, ClassifyParams, Fragment
    from slacken_tpu_torch.ops import cuda_kernels

    first = bench["reads"][0]
    letters = np.frombuffer(b"ACGTN", np.uint8)
    singles = [(t, letters[c[:n]].tobytes().decode("ascii"))
               for t, c, n in zip(first.titles[:API_READS], first.codes, first.lengths)]
    pairs = bench["pairs"][:API_READS]
    mates1, mates2 = [(t, a) for t, a, _ in pairs], [(t, b) for t, _, b in pairs]
    mixed = [Fragment(*r) for r in singles] + [Fragment(*p) for p in pairs]
    cpar = ClassifyParams(thresholds=[0.0, 0.15])
    cuda_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    card = Slacken(bench["idx"], confidence=0.15)  # the default device
    if card.classifier.device.type != "cuda":
        fail(f"Slacken's default device is {card.classifier.device}")
    got = [card.classify_reads(singles), card.classify_reads(mates1, mates2)]
    card.write_reports(got[0] + got[1], os.path.join(out, "api"))
    Classifier(bench["idx"], dev).classify_and_write(mixed, os.path.join(out, "apiw"), cpar)
    dt = time.perf_counter() - t0
    launches = dict(cuda_kernels.LAUNCHES)
    require_launches("api", launches)
    host = Slacken(bench["idx_cpu"], confidence=0.15, device="cpu")
    want = [host.classify_reads(singles), host.classify_reads(mates1, mates2)]
    host.write_reports(want[0] + want[1], os.path.join(out, "apicpu"))
    Classifier(bench["idx_cpu"], "cpu").classify_and_write(mixed, os.path.join(out, "apiwcpu"), cpar)
    if got != want:
        fail("Slacken.classify_reads differs between the card and the CPU")
    if [r.title for r in got[0]] != [t for t, _ in singles] or [r.title for r in got[1]] != [t for t, _ in mates1]:
        fail("Slacken.classify_reads does not keep the input order")
    for a, b, n_files in (("api", "apicpu", 2), ("apiw", "apiwcpu", 4)):
        tree = output_tree(os.path.join(out, a))
        if tree != output_tree(os.path.join(out, b)) or len(tree) != n_files:
            fail(f"the written output {a} differs between the card and the CPU")
    n_cls = sum(r.classified for rs in got for r in rs)
    log(f"api: Slacken.classify_reads ({len(singles)} reads, {len(pairs)} pairs), write_reports and "
        f"Classifier.classify_and_write equal card vs CPU; {n_cls} of {len(singles) + len(pairs)} "
        f"classified at 0.15; {dt:.2f} s on the card")
    if n_cls < 0.9 * (len(singles) + len(pairs)):
        fail(f"the api run classified {n_cls} of {len(singles) + len(pairs)}")
    return launches


def phase_diagnostics(dev):
    """The kernel diagnostics entry point; returns its launch counts."""
    from slacken_tpu_torch import diagnostics
    from slacken_tpu_torch.ops import cuda_kernels

    cuda_kernels.reset_launch_counts()
    verdicts = diagnostics.kernel_probe(dev)
    launches = dict(cuda_kernels.LAUNCHES)
    log(f"diagnostics.kernel_probe: {verdicts}")
    if set(verdicts) != set(cuda_kernels.MASK_IDIOMS) or any(v != "ok" for v in verdicts.values()):
        fail(f"kernel_probe reports {verdicts}")
    require_launches("kernel_probe", launches, cuda_kernels.MASK_IDIOMS)
    return launches


def profile_run(fn, mode):
    """Where one warm run of fn (classify in `mode`) spends its time: the device's busy share of
    the wall (torch.profiler; kernel and copy time summed, so an upper
    bound) and the main thread's leading host functions (cProfile)."""
    import cProfile
    import pstats

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_ms = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3
    if dev_ms > 0:
        log(f"profiled classify, {mode}: wall {wall_ms:.2f} ms, device busy {dev_ms:.3f} ms "
            f"({100 * dev_ms / wall_ms:.1f}% of the wall, under the profiler)")
    else:
        log(f"profiled classify, {mode}: wall {wall_ms:.2f} ms, device busy not measured "
            "(the profiler saw no device time)")
    pr = cProfile.Profile()
    pr.enable()
    fn()
    torch.cuda.synchronize()
    pr.disable()
    stats = pstats.Stats(pr).stats  # (file, line, name) -> (cc, nc, tottime, cumtime, callers)
    top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:6]
    log(f"host self time, one classify run, {mode} (cProfile, main thread): " + ", ".join(
        f"{os.path.basename(f)}:{ln}({name}) {v[2] * 1e3:.2f} ms" for (f, ln, name), v in top))


def breakdown(cls, reads, cpar):
    """Device time per stage of one 4 Mbp classify batch (CUDA events)."""
    import torch

    from slacken_tpu_torch.classify import finalize
    from slacken_tpu_torch.ops import encode, lookup, minimizers, resolve

    codes = np.concatenate([p.codes for p in reads])[: cls.target_batch_bp // 128]
    packed, valid = (torch.from_numpy(a).to(cls.device) for a in encode.pack_2bit(codes))
    mp = cls.index.params.minimizer_params
    b, l = codes.shape
    st = {}
    st["scan"] = cuda_ms(lambda: minimizers.window_minimizers_packed(packed, valid, mp), iters=10)
    wm = minimizers.window_minimizers_packed(packed, valid, mp)
    q = wm.minimizer.reshape(-1)
    st["probe"] = cuda_ms(lambda: lookup.probe(cls._keys, cls._taxa, cls._fence, q), iters=10)
    looked = lookup.probe(cls._keys, cls._taxa, cls._fence, q).reshape(b, l)
    wt = torch.where(wm.valid, looked, resolve.INVALID_WINDOW)
    st["compact_hits"] = cuda_ms(lambda: resolve.compact_hits(wt, cls.max_taxa), iters=10)
    ch = resolve.compact_hits(wt, cls.max_taxa)
    st["resolve_hits"] = cuda_ms(lambda: resolve.resolve_hits(ch.taxa, ch.counts, cls._table), iters=10)
    res = resolve.resolve_hits(ch.taxa, ch.counts, cls._table)
    cls._thresholds = tuple(cpar.thresholds)
    lut = cls._req_lut(l)
    zero = torch.zeros(b, dtype=torch.int32, device=cls.device)
    st["finalize"] = cuda_ms(lambda: finalize(res, zero, ch.n_hit_kmers, ch.n_none_kmers, ch.overflow, zero, lut), iters=10)
    log(f"device ms per stage, one [{b}, {l}] batch: " + ", ".join(f"{k} {v:.4f}" for k, v in st.items()))


def phase_scale(dev, out):
    import torch

    from slacken_tpu_torch import workloads
    from slacken_tpu_torch.classify import Classifier, ClassifyParams
    from slacken_tpu_torch.index import IndexParams, KeyValueIndex

    tax = workloads.scale_taxonomy(SCALE_TAXA)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx = KeyValueIndex.build(workloads.scale_library(SCALE_BP, SCALE_TAXA),
                              IndexParams(k=35, m=31, spaces=7), tax, dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    log(f"scale build on the card: {SCALE_BP / 1e6:.0f} Mbp, {idx.num_records} records "
        f"(JAX package: {SCALE_RECORDS} at 400 Mbp) in {build_s:.2f} s, "
        f"{SCALE_BP / build_s / 1e6:.2f} Mbp/s incl. library generation and host packing")
    if idx.num_records != SCALE_RECORDS:
        fail(f"scale index has {idx.num_records} records, expected {SCALE_RECORDS}")
    reads = workloads.scale_reads(SCALE_BP, SCALE_TAXA)
    n_reads = sum(len(p) for p in reads)
    cls = Classifier(idx, dev)
    cpar = ClassifyParams(thresholds=[0.0], per_read_output=False)
    cls.classify_and_write_packed(reads[:1], os.path.join(out, "scale_warm"), cpar)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cls.classify_and_write_packed(reads, os.path.join(out, "scale"), cpar)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    c, total = classified_count(os.path.join(out, "scale_c0.0", "all_kreport.txt"))
    log(f"scale classify on the card: {n_reads} reads in {dt:.3f} s, {n_reads / dt:.1f} reads/s, "
        f"classified {c} ({100.0 * c / n_reads:.2f}%)")
    log(f"scale peak torch.cuda.max_memory_allocated: {torch.cuda.max_memory_allocated()} bytes")
    if total != n_reads or c < 0.99 * n_reads:
        fail(f"scale classified {c} of {total} reads")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "slacken_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)

    from slacken_tpu_torch import native
    from slacken_tpu_torch.ops import cuda_kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    log(smi[0])
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cuda_kernels.build(verbose=True)
    cuda_kernels._load()
    secs, text = cuda_kernels.build_info
    log(f"kernel build: {secs:.2f} s (nvcc), {time.perf_counter() - t0:.2f} s with loading")
    for line in text.splitlines():
        if "ptxas info" in line and ("Used" in line or "Compiling" in line):
            log("  " + line.strip())
    t0 = time.perf_counter()
    log(f"native packer: available {native.available()} "
        f"(g++ build and load {time.perf_counter() - t0:.2f} s)")
    if not native.available():
        fail("the native packer did not build: rates would be the numpy fallback's")
    rng = np.random.default_rng(20260816)
    results = {}
    check_scan(rng, dev, results)
    check_probe(rng, dev, results)
    check_mask_idioms(dev, results)
    check_resolve(rng, dev)
    out = os.path.join(HERE, ".smoke_out")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    bench = phase_bench(dev, out)
    by_path = {"reports": bench["launches"], "per_read": phase_detailed(dev, out, bench),
               "paired": phase_paired(dev, out, bench), "api": phase_api(dev, out, bench),
               "diagnostics": phase_diagnostics(dev)}
    del bench
    phase_scale(dev, out)
    shutil.rmtree(out, ignore_errors=True)
    for mod in ("jax", "slacken_tpu", "bench", "scale_bench"):
        if mod in sys.modules:
            fail(f"the port imported {mod}")
    idioms = ("slacken_tpu_torch/ops/kernels/mask_idioms.cu", "scripts/tpu_session.py:")
    sources = {"scan": ("slacken_tpu_torch/ops/kernels/scan.cu", "slacken_tpu/ops/pallas_kernels.py:26"),
               "probe": ("slacken_tpu_torch/ops/kernels/probe.cu", "slacken_tpu/ops/pallas_kernels.py:98"),
               **{name: (idioms[0], idioms[1] + str(line)) for name, line in
                  zip(cuda_kernels.MASK_IDIOMS, (1023, 1027, 1030, 1036, 1047))}}
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": sum(counts[name] for counts in by_path.values()),
         "launches_by_path": {path: counts[name] for path, counts in by_path.items() if counts[name]},
         **results[name]}
        for name, (src, rep) in sources.items()
    ]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
