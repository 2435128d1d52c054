#!/usr/bin/env python3
"""Smoke run of slacken_tpu_torch on one NVIDIA GPU (H100).

Run from the repository root: `python3 chip_smoke.py`. It builds the CUDA
kernels from ops/kernels/*.cu, checks each kernel bit-exact against its
plain PyTorch twin on the card, then drives the port's main path: build the
bench library's index on the card (2,623,028 records expected) and on the
CPU, classify the bench's simulated reads on both and require byte-identical
kreports, then build and classify the 400 Mbp scale library. It prints the
measured numbers, one JSON line of per-kernel results, and as its last line
{"ok": true, "device": {...}}. It stops at the first failure with a non-zero
exit; without CUDA, or outside the repository, it exits 1 before printing
any result.
"""

from __future__ import annotations

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
    # rows and a build batch of 4 kbp genome rows (index._default_batch)
    for shape in [(4096, 128), (512, 1024), (32768, 128), (8192, 4096)]:
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
    log(f"scan [32768, 128]: kernel {ms:.4f} ms, plain PyTorch on the card {plain:.4f} ms")
    results["scan"] = dict(max_abs_err=float(err), ms=ms, plain_ms=plain)


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
    log(f"probe 2M keys x {nq} queries: kernel {ms:.4f} ms, plain torch.searchsorted {plain:.4f} ms")
    results["probe"] = dict(max_abs_err=float(err), ms=ms, plain_ms=plain)


def check_resolve(rng, dev):
    """compact_hits, resolve_hits and finalize on the card == on the CPU."""
    import torch

    from slacken_tpu.taxonomy import Taxonomy
    from slacken_tpu_torch.classify import finalize
    from slacken_tpu_torch.ops import resolve

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


def bench_reads(n_copies=8):
    """bench.py's simulated reads (bench.py:59-74): seed 7, 1% mutations,
    101 bp padded to 128, 3 x 3,334 reads, replicated."""
    import bench
    from slacken_tpu import native
    from slacken_tpu.ops import encode

    sim_rng = np.random.default_rng(7)
    sim = []
    for taxon, seq in bench.synthetic_library(np.random.default_rng(20260816)):
        codes_full = encode.encode_seq(seq)
        starts = sim_rng.integers(0, len(codes_full) - 101, 3334)
        rows = codes_full[starts[:, None] + np.arange(101)[None, :]].astype(np.uint8)
        mut = sim_rng.random(rows.shape) < 0.01
        rows[mut] = sim_rng.integers(0, 4, mut.sum())
        rows = np.pad(rows, ((0, 0), (0, 27)), constant_values=4)
        sim.append(native.PackedReads(rows, np.full(len(rows), 101, np.int32),
                                      [f"sim{taxon}_{j}" for j in range(len(rows))]))
    return sim * n_copies


def scale_reads(total_bp, n_taxa, n_reads=200_000):
    """scripts/scale_bench.py's simulated reads (scale_bench.py:112-128)."""
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import scale_bench
    from slacken_tpu import native
    from slacken_tpu.ops import encode

    rng = np.random.default_rng(7)
    sim = []
    n_src = min(n_taxa, 8)
    per = n_reads // n_src
    for j, (taxon, seq) in enumerate(scale_bench.synthetic_library(total_bp, n_taxa)):
        if j >= n_src:
            break
        codes_full = encode.encode_seq(seq[:2_000_000])
        starts = rng.integers(0, len(codes_full) - 101, per)
        rows = codes_full[starts[:, None] + np.arange(101)[None, :]].astype(np.uint8)
        mut = rng.random(rows.shape) < 0.01
        rows[mut] = rng.integers(0, 4, int(mut.sum()))
        rows = np.pad(rows, ((0, 0), (0, 27)), constant_values=4)
        sim.append(native.PackedReads(rows, np.full(len(rows), 101, np.int32),
                                      [f"sim{taxon}_{i}" for i in range(len(rows))]))
    return sim


def classified_count(report_path):
    lines = open(report_path).read().splitlines()[1:]
    total = sum(int(x.split("\t")[1]) for x in lines if x.split("\t")[3] in ("U", "R"))
    uncl = next((int(x.split("\t")[1]) for x in lines if x.split("\t")[3] == "U"), 0)
    return total - uncl, total


def phase_bench(dev, out):
    import torch

    import bench
    from slacken_tpu_torch.classify import Classifier, ClassifyParams
    from slacken_tpu_torch.index import IndexParams, KeyValueIndex
    from slacken_tpu_torch.ops import cuda_kernels

    tax = bench._bench_taxonomy()
    params = IndexParams(k=35, m=31, spaces=7)
    reads = bench_reads()
    n_reads = sum(len(p) for p in reads)
    cpar = ClassifyParams(thresholds=[0.0, 0.15], per_read_output=False)

    cuda_kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx = KeyValueIndex.build(bench.synthetic_library(np.random.default_rng(20260816)), params, tax, dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    log(f"bench build on the card: {idx.num_records} records in {build_s:.3f} s "
        f"({8e6 / build_s / 1e6:.2f} Mbp/s incl. host packing)")
    if idx.num_records != BENCH_RECORDS:
        fail(f"bench index has {idx.num_records} records, expected {BENCH_RECORDS}")
    cls = Classifier(idx, dev)
    cls.classify_and_write_packed(reads, os.path.join(out, "gpu"), cpar)  # warm
    times = []
    for r in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cls.classify_and_write_packed(reads, os.path.join(out, f"gpu{r}"), cpar)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = dict(cuda_kernels.LAUNCHES)
    med = statistics.median(times)
    log(f"bench classify on the card: {n_reads} reads, runs {[round(t, 4) for t in times]} s, "
        f"median {n_reads / med:.1f} reads/s")
    log(f"main-path kernel launches: {launches}")
    for name, n in launches.items():
        if n == 0:
            fail(f"the main path never launched the {name} kernel")
    profile_run(lambda: cls.classify_and_write_packed(reads, os.path.join(out, "prof"), cpar))

    t0 = time.perf_counter()
    idx_cpu = KeyValueIndex.build(bench.synthetic_library(np.random.default_rng(20260816)), params, tax, "cpu")
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
    return launches


def profile_run(fn):
    """Where one warm run of fn spends its time: the device's busy share of
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
        log(f"profiled classify: wall {wall_ms:.2f} ms, device busy {dev_ms:.3f} ms "
            f"({100 * dev_ms / wall_ms:.1f}% of the wall, under the profiler)")
    else:
        log(f"profiled classify: wall {wall_ms:.2f} ms, device busy not measured "
            "(the profiler saw no device time)")
    pr = cProfile.Profile()
    pr.enable()
    fn()
    torch.cuda.synchronize()
    pr.disable()
    stats = pstats.Stats(pr).stats  # (file, line, name) -> (cc, nc, tottime, cumtime, callers)
    top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:6]
    log("host self time, one classify run (cProfile, main thread): " + ", ".join(
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

    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import scale_bench
    from slacken_tpu.taxonomy import Taxonomy
    from slacken_tpu_torch.classify import Classifier, ClassifyParams
    from slacken_tpu_torch.index import IndexParams, KeyValueIndex

    nodes = [(1, 1, "root")] + [(10 + i, 1, "species") for i in range(SCALE_TAXA)]
    tax = Taxonomy.from_nodes_and_names(nodes, [(t, f"taxon{t}") for t, _, _ in nodes])
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx = KeyValueIndex.build(scale_bench.synthetic_library(SCALE_BP, SCALE_TAXA),
                              IndexParams(k=35, m=31, spaces=7), tax, dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    log(f"scale build on the card: {SCALE_BP / 1e6:.0f} Mbp, {idx.num_records} records "
        f"(JAX package: {SCALE_RECORDS} at 400 Mbp) in {build_s:.2f} s, "
        f"{SCALE_BP / build_s / 1e6:.2f} Mbp/s incl. library generation and host packing")
    if idx.num_records != SCALE_RECORDS:
        fail(f"scale index has {idx.num_records} records, expected {SCALE_RECORDS}")
    reads = scale_reads(SCALE_BP, SCALE_TAXA)
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
    rng = np.random.default_rng(20260816)
    results = {}
    check_scan(rng, dev, results)
    check_probe(rng, dev, results)
    check_resolve(rng, dev)
    out = os.path.join(HERE, ".smoke_out")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    launches = phase_bench(dev, out)
    phase_scale(dev, out)
    shutil.rmtree(out, ignore_errors=True)
    if "jax" in sys.modules:
        fail("the port imported jax")
    sources = {"scan": ("slacken_tpu_torch/ops/kernels/scan.cu", "slacken_tpu/ops/pallas_kernels.py:26"),
               "probe": ("slacken_tpu_torch/ops/kernels/probe.cu", "slacken_tpu/ops/pallas_kernels.py:98")}
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep, "launches": launches[name],
         **results[name]}
        for name, (src, rep) in sources.items()
    ]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
