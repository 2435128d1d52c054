#!/usr/bin/env python3
"""Time the minimizer-scan kernels, the wide probe and the hashed and
row-bucket table probes on one NVIDIA GPU at the main path's shapes, to
compare two versions of the kernels inside one run on one card.

    python3 scan_timing.py [--root DIR] [--cases all|scan|probe|routed|tables|hitruns] [--tables tiled,...]

`--root` imports slacken_tpu_torch from DIR, another checkout of the
repository (the parent commit unpacked into a git-ignored directory, say);
by default this one. It builds that checkout's kernels, prints the scan
and probe kernels' registers and stack frames (ptxas; and the stack frame
of the scan's stitch, a function of its own), then one line a (kernel,
parameters, shape): the device time alone of each kernel of the call
(torch.profiler, as chip_smoke.device_ms) and back to back through the
wrapper (CUDA events, as chip_smoke.cuda_ms). The scan's rows are random
codes with 5% N (seed 20260816), at the main path's shapes, bracken's
[4, 2^20] fragment rows and the bounded build's 2,048 x 4,096 rows, both
cut into segments. The wide probe (`--cases probe`) runs at chip_smoke.py's four
shapes: 4,194,304 random queries into 2M and into 120M random wide keys,
and one 4 Mbp batch's dense minimizers on the bench and the 400 Mbp scale
library's (50, 45, 7) indexes (also random queries there), each checked
against `lookup_taxa` first; it prints the device memory of the scale
index's probe arrays, the peak while they are made, and the build's peak. A tree whose lookup has
no `build_slots` probes its keys, taxa and directory, as before the slot
table. `--cases routed` times the routed probe of narrow keys at
chip_smoke.py's four shapes (time_routed): the slot kernel, its floor and
the directory kernel on the same queries, and prints the card memory that
a classifier of the scale index holds. `--cases tables` times probe_rows, probe_hashed, probe_hashed_cols,
probe_tiled, their wide instances and probe_bucketed through
chip_smoke.time_table_probe
(each held to its twin and lookup_taxa first; the bound and the
index_select yardstick as there) at chip_smoke.py's shapes: one 4 Mbp
batch's dense minimizers and 4,194,304 random queries, into the bench
index's row-bucket, hashed and tiled tables and bucketed arrays and the
wide (50, 45, 7) bench index's row-bucket and tiled tables, then into the
400 Mbp scale library's narrow tables of the same five kinds and its wide
row-bucket and tiled tables; beside them the directory probe of `routed`
(the narrow indexes' keys, taxa and directory; its time alone, held to
lookup_taxa first); `--tables` keeps some of the kinds (hashed1, hashed,
hashed128, tiled, bucketed, routed), and builds no wide index without
hashed1 or tiled. Beside both hashed probes the floor (`floor_device_ms`:
one sector a query at its home slot, where the tree has
cuda_kernels.hashed_floor_cuda), beside the narrow row probe its own (one
sector a query from its guessed lane, where the tree has
cuda_kernels.rows_floor_cuda), beside both tiled probes theirs (the
router entries, then the sector of the bucket's first record, where the
tree has cuda_kernels.tiled_floor_cuda) and beside the bucketed probe its
own (the router entries, then the sector of keys at the guessed key, where
the tree has cuda_kernels.bucketed_floor_cuda). `--cases hitruns` times
per-read mode's hit-runs kernel (time_hit_runs), with its floor where the
tree has cuda_kernels.hit_runs_floor_cuda. Run parent, change, change, parent
in one command to compare two trees.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys

import numpy as np

import chip_smoke

#: the bounded build's batches of 4 kbp genome rows below the card's 2,112
#: warps: 2,048 rows in two segments each, stitched in the launch
BUILD_SEGMENTED = (2048, 4096)

#: the probe tables that `--cases tables` times; "routed": the directory probe
TABLE_CASES = ("hashed1", "hashed", "hashed128", "tiled", "bucketed", "routed")

#: (label, (k, m, s), rank-table m or None, shapes)
CASES = [
    ("scan", (35, 31, 7), None, [*chip_smoke.SCAN_SHAPES, chip_smoke.LONG_ROWS, BUILD_SEGMENTED]),
    ("scan_lut", (35, 13, 3), 13, [chip_smoke.SCAN_SHAPES[0], chip_smoke.LONG_ROWS, BUILD_SEGMENTED]),
    ("scan_wide", (50, 45, 7), None, [*chip_smoke.SCAN_SHAPES, chip_smoke.LONG_ROWS, BUILD_SEGMENTED]),
    ("scan_wide", (35, 33, 0), None, [chip_smoke.SCAN_SHAPES[0]]),
    ("scan_wide", (80, 63, 7), None, [chip_smoke.SCAN_SHAPES[0]]),
]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--cases", choices=("all", "scan", "probe", "routed", "tables", "hitruns"), default="all")
    ap.add_argument("--tables", default=",".join(TABLE_CASES),
                    help="the tables of --cases tables, comma-separated (default: all)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("scan_timing: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from slacken_tpu_torch.ops import cuda_kernels, encode
    from slacken_tpu_torch.ops.minimizers import MinimizerParams

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"{smi}; kernels from {cuda_kernels.__file__}", flush=True)
    dev = torch.device("cuda")
    name = os.path.relpath(args.root)
    cuda_kernels.build(verbose=True)
    lines = cuda_kernels.build_info[1].splitlines()
    for i, line in enumerate(lines):
        entry = "Compiling entry function" in line and any(x in line for x in ("scan", "probe", "floor", "hit_runs"))
        if entry or ("Function properties for" in line and "stitch" in line):
            fn = line.split(chr(39))[1] if entry else line.split("for ")[-1]
            found = [x.strip() for x in lines[i + 1:i + 4] if "Used" in x or "stack frame" in x][:2 if entry else 1]
            print(f"[{name}] {fn}: {'; '.join(found)}", flush=True)
    if args.cases in ("all", "hitruns"):
        time_hit_runs(name, dev)
    if args.cases in ("all", "tables"):
        time_tables(name, dev, args.tables.split(","))
    if args.cases in ("all", "routed"):
        time_routed(name, dev)
    if args.cases in ("all", "probe"):
        time_probe_wide(name, dev)
    if args.cases != "all" and args.cases != "scan":
        return 0
    rng = np.random.default_rng(20260816)
    for label, kms, lut_m, shapes in CASES:
        mp = MinimizerParams(*kms)
        lut = None
        if lut_m is not None:
            lut = torch.from_numpy(rng.permutation(1 << (2 * lut_m)).astype(np.int32)).to(dev)
        for shape in shapes:
            codes = chip_smoke.random_codes(rng, shape)
            packed, valid = (torch.from_numpy(a).to(dev) for a in encode.pack_2bit(codes))
            run = lambda: cuda_kernels.window_minimizers_cuda(packed, valid, mp, lut)  # noqa: E731
            ms = chip_smoke.cuda_ms(run)
            each = chip_smoke.device_ms(run, by_kernel=True)
            alone = {re.search(r"\w+_kernel(<[^>]*>)?", k).group(0) if "_kernel" in k else k[:40]: round(v, 4)
                     for k, v in each.items()}
            print(f"[{name}] {label} {kms} {list(shape)}: back to back {ms:.4f} ms; alone {alone}", flush=True)
        del lut
    return 0


def time_hit_runs(name, dev):
    """The hit-runs kernel at chip_smoke.py's timed shapes, each held to its
    twin first: the bench batch's window taxa (caps 16 and 4), the N-heavy
    batch and the long-row bucket of HIT_RUNS_TIMED (cap 16); alone, back to
    back, the bound and, where the tree has one, the floor
    (chip_smoke.time_hit_runs)."""
    import torch

    from slacken_tpu_torch import workloads
    from slacken_tpu_torch.classify import Classifier
    from slacken_tpu_torch.index import IndexParams, KeyValueIndex
    from slacken_tpu_torch.ops import cuda_kernels, hitruns

    library = workloads.bench_library(np.random.default_rng(workloads.BENCH_SEED))
    idx = KeyValueIndex.build(library, IndexParams(k=35, m=31, spaces=7), workloads.bench_taxonomy(), dev)
    k = idx.params.k
    cases = [("bench batch", chip_smoke.bench_batch(Classifier(idx, dev), workloads.bench_reads()), k, (16, 4))]
    for label, i in chip_smoke.HIT_RUNS_TIMED:
        rows, width, kk, paired = chip_smoke.HIT_RUNS_CASES[i]
        arrays = workloads.hit_runs_rows(1900 + i, rows, width, kk, paired)
        cases.append((f"{label} [{rows}, {width}]", [torch.from_numpy(a).to(dev) for a in arrays], kk, (16,)))
    for label, args, kk, caps in cases:
        for cap in caps:
            if not torch.equal(cuda_kernels.hit_runs_cuda(*args, kk, cap), hitruns.hit_runs_plain(*args, kk, cap)):
                raise SystemExit(f"scan_timing: the hit-runs kernel differs from its twin at the {label}, cap {cap}")
            r = chip_smoke.time_hit_runs(args, kk, cap)
            print(f"[{name}] {chip_smoke.fmt_hit_runs(f'hit_runs at the {label}, cap {cap}', r)}", flush=True)
    del idx


def time_tables(name, dev, only=TABLE_CASES):
    import torch

    from slacken_tpu_torch import workloads
    from slacken_tpu_torch.classify import Classifier
    from slacken_tpu_torch.index import IndexParams, KeyValueIndex
    from slacken_tpu_torch.ops import cuda_kernels, lookup

    floors = {"hashed1": "rows_floor_cuda", "tiled": "tiled_floor_cuda", "bucketed": "bucketed_floor_cuda"}

    def timed(label, index, probes, shapes):
        for probe in probes:
            if probe not in only:
                continue
            arrays = index.device_arrays(dev, probe)
            for what, queries in shapes:
                if probe == "routed":  # the routed probe on the card: its time alone, held to lookup_taxa first
                    run = lambda: lookup.probe(*arrays, queries)  # noqa: E731
                    keys, taxa = index.keys_t.to(dev), index.taxa_t.to(dev)
                    if not torch.equal(run(), lookup.lookup_taxa(keys, taxa, queries)):
                        raise SystemExit(f"scan_timing: the routed probe differs from lookup_taxa on {label}")
                    kernel = "probe_slots" if isinstance(arrays[2], getattr(lookup, "SlotTable", ())) else "probe"
                    print(f"[{name}] {kernel} {label}, {what}: back to back {chip_smoke.cuda_ms(run):.4f} ms; alone "
                          f"{chip_smoke.fmt_ms(chip_smoke.device_ms(run))}", flush=True)
                    continue
                kernel = chip_smoke.TABLE_PROBES[probe, queries.dim() == 2]
                with_floor = hasattr(cuda_kernels, floors.get(probe, "hashed_floor_cuda"))
                r = chip_smoke.time_table_probe(f"{label}, {what}", arrays[2], index.keys_t, index.taxa_t, queries,
                                                kernel, with_floor=with_floor)
                yardstick = (f"; index_select {chip_smoke.fmt_ms(r['yardstick_device_ms'])}"
                             if "yardstick_device_ms" in r else "")
                if "floor_device_ms" in r:
                    yardstick += f"; floor {chip_smoke.fmt_ms(r['floor_device_ms'])}"
                print(f"[{name}] {kernel} {label}, {what}: back to back {r['ms']:.4f} ms; alone "
                      f"{chip_smoke.fmt_ms(r['device_ms'])}; bound {r['bound_ms']:.4f} ms{yardstick}", flush=True)

    narrow, wide = IndexParams(k=35, m=31, spaces=7), IndexParams(k=50, m=45, spaces=7)
    wide_probes = ("hashed1", "tiled")
    tax, reads = workloads.bench_taxonomy(), workloads.bench_reads()
    library = lambda: workloads.bench_library(np.random.default_rng(workloads.BENCH_SEED))  # noqa: E731
    idx = KeyValueIndex.build(library(), narrow, tax, dev)
    timed("bench index", idx, TABLE_CASES, (
        ("one batch's dense minimizers", chip_smoke.batch_queries(Classifier(idx, dev), reads)[2].minimizer.reshape(-1)),
        ("random queries", chip_smoke.narrow_random_queries(dev, idx, chip_smoke.BENCH_RECORDS))))
    if set(wide_probes) & set(only):
        idx = KeyValueIndex.build(library(), wide, tax, dev)
        timed("wide bench index (50, 45, 7)", idx, wide_probes, (
            ("one batch's dense minimizers",
             chip_smoke.batch_queries(Classifier(idx, dev), reads)[2].minimizer.flatten(0, 1)),
            ("random queries", chip_smoke.random_wide_queries(dev, idx.keys_t, 1 << 22, chip_smoke.BENCH_RECORDS))))
    del idx
    genomes = list(workloads.scale_library(chip_smoke.SCALE_BP, chip_smoke.SCALE_TAXA))
    tax = workloads.scale_taxonomy(chip_smoke.SCALE_TAXA)
    reads = workloads.scale_reads(chip_smoke.SCALE_BP, chip_smoke.SCALE_TAXA, library=genomes)
    torch.cuda.empty_cache()
    idx = KeyValueIndex.build(iter(genomes), narrow, tax, dev)
    timed("scale index", idx, TABLE_CASES, (
        ("random queries", chip_smoke.narrow_random_queries(dev, idx, chip_smoke.SCALE_RECORDS + 1)),
        ("one batch's dense minimizers", chip_smoke.batch_queries(Classifier(idx, dev), reads)[2].minimizer.reshape(-1))))
    del idx
    torch.cuda.empty_cache()
    if set(wide_probes) & set(only):
        idx = KeyValueIndex.build(iter(genomes), wide, tax, dev)
        timed("wide scale index", idx, wide_probes, (
            ("random queries", chip_smoke.random_wide_queries(dev, idx.keys_t, 1 << 22, chip_smoke.SCALE_RECORDS)),
            ("one batch's dense minimizers",
             chip_smoke.batch_queries(Classifier(idx, dev), reads)[2].minimizer.flatten(0, 1))))
        del idx
        torch.cuda.empty_cache()


def time_routed(name, dev):
    """The routed probe of narrow keys at chip_smoke.py's four shapes of the
    directory kernel: 4,194,304 random queries into 2M random keys, one 4
    Mbp batch's dense minimizers into the bench index, random queries and
    one batch's dense minimizers into the 400 Mbp scale index.
    chip_smoke.time_probe over the keys' slot table (each kernel held to
    its twin and lookup_taxa first) times the slot kernel, its floor and,
    on the same queries, the directory kernel; a tree without narrow slot
    tables (no cuda_kernels.slots_floor_cuda) times the directory kernel
    alone. Then the card memory that a classifier of the scale index holds."""
    import torch

    from slacken_tpu_torch import workloads
    from slacken_tpu_torch.classify import Classifier
    from slacken_tpu_torch.index import IndexParams, KeyValueIndex
    from slacken_tpu_torch.ops import cuda_kernels, lookup

    slots = hasattr(cuda_kernels, "slots_floor_cuda")

    def timed(label, keys, taxa, queries):
        keys, taxa = keys.to(dev), taxa.to(dev)
        table = lookup.build_slots(keys, taxa) if slots else lookup.build_directory(keys)
        r = chip_smoke.time_probe(label, keys, taxa, table, queries, "probe_slots" if slots else "probe")
        for kernel, e in (("probe_slots", r), ("probe", r["directory"])) if slots else (("probe", r),):
            floor = f"; floor {chip_smoke.fmt_ms(e['floor_device_ms'])}" if "floor_device_ms" in e else ""
            print(f"[{name}] {kernel} {label}: back to back {e['ms']:.4f} ms; alone {chip_smoke.fmt_ms(e['device_ms'])}"
                  f"; bound {e['bound_ms']:.4f} ms{floor}", flush=True)

    rng = np.random.default_rng(20261019)
    n = 2_000_000
    keys = np.unique(rng.integers(0, 1 << 62, int(n * 1.01), dtype=np.int64))[:n]
    taxa = rng.integers(1, 1 << 20, len(keys)).astype(np.int32)
    timed("2M random keys, random queries", torch.from_numpy(keys), torch.from_numpy(taxa),
          torch.from_numpy(chip_smoke.random_queries(rng, keys, 1 << 22)).to(dev))
    narrow = IndexParams(k=35, m=31, spaces=7)
    idx = KeyValueIndex.build(workloads.bench_library(np.random.default_rng(workloads.BENCH_SEED)), narrow,
                              workloads.bench_taxonomy(), dev)
    cls = Classifier(idx, dev)
    timed("bench index, one batch's dense minimizers", idx.keys_t, idx.taxa_t,
          chip_smoke.batch_queries(cls, workloads.bench_reads())[2].minimizer.reshape(-1))
    del idx, cls
    genomes = list(workloads.scale_library(chip_smoke.SCALE_BP, chip_smoke.SCALE_TAXA))
    reads = workloads.scale_reads(chip_smoke.SCALE_BP, chip_smoke.SCALE_TAXA, library=genomes)
    torch.cuda.empty_cache()
    idx = KeyValueIndex.build(iter(genomes), narrow, workloads.scale_taxonomy(chip_smoke.SCALE_TAXA), dev)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    cls = Classifier(idx, dev)
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    print(f"[{name}] scale index: {idx.num_records} records; card memory {before} bytes with the index's keys and "
          f"taxa there, {after} under a classifier ({after / idx.num_records:.3f} bytes a record), keys on "
          f"{idx.keys_t.device}", flush=True)
    for label, queries in (
        ("scale index, random queries", chip_smoke.narrow_random_queries(dev, idx, chip_smoke.SCALE_RECORDS + 1)),
        ("scale index, one batch's dense minimizers", chip_smoke.batch_queries(cls, reads)[2].minimizer.reshape(-1)),
    ):
        timed(label, idx.keys_t, idx.taxa_t, queries)
    del idx, cls
    torch.cuda.empty_cache()


#: keys a bucket of the slot tables timed beside the default's
BUCKET_SWEEP = (2, 4, 8)


def probe_arrays(keys, taxa, bucket_keys=None):
    """What this tree's wide probe kernel reads: (None, None, slot table),
    or (keys, taxa, directory) in a tree without lookup.build_slots; its
    default directory, or one of about `bucket_keys` keys a bucket."""
    from slacken_tpu_torch.ops import lookup

    if not hasattr(lookup, "build_slots"):
        return keys, taxa, lookup.build_directory(keys)
    d = None if bucket_keys is None else lookup.build_directory(keys, bucket_keys)
    return None, None, lookup.build_slots(keys, taxa, d)


def time_probe_wide(name, dev):
    import torch

    from slacken_tpu_torch import workloads
    from slacken_tpu_torch.classify import Classifier
    from slacken_tpu_torch.index import IndexParams, KeyValueIndex
    from slacken_tpu_torch.ops import lookup

    def timed(label, keys, taxa, arrays, queries):
        keys, taxa = keys.to(queries.device), taxa.to(queries.device)  # on the host under a classifier's slot table
        for bucket_keys in (None, *BUCKET_SWEEP):
            if bucket_keys is not None:  # the directory's one parameter, on the slots
                if not hasattr(lookup, "build_slots"):
                    break
                arrays = probe_arrays(keys, taxa, bucket_keys)
            run = lambda: lookup.probe(*arrays, queries)  # noqa: E731
            if not torch.equal(run(), lookup.lookup_taxa(keys, taxa, queries)):
                raise SystemExit(f"scan_timing: probe_wide differs from lookup_taxa on {label}")
            ms, alone = chip_smoke.cuda_ms(run), chip_smoke.device_ms(run)
            size = "" if bucket_keys is None else f", about {bucket_keys} keys a bucket"
            print(f"[{name}] probe_wide {label}{size}: back to back {ms:.4f} ms; alone {chip_smoke.fmt_ms(alone)}",
                  flush=True)

    for label, n, hi_bits in chip_smoke.WIDE_INDEXES:
        keys, taxa = chip_smoke.random_wide_index(dev, n, hi_bits, n)
        queries = chip_smoke.random_wide_queries(dev, keys, 1 << 22, n + 1)
        timed(label, keys, taxa, probe_arrays(keys, taxa), queries)
        del keys, taxa, queries
    torch.cuda.empty_cache()
    params = IndexParams(k=50, m=45, spaces=7)
    bench = KeyValueIndex.build(workloads.bench_library(np.random.default_rng(workloads.BENCH_SEED)), params,
                                workloads.bench_taxonomy(), dev)
    cls = Classifier(bench, dev)
    queries = chip_smoke.batch_queries(cls, workloads.bench_reads())[2].minimizer.flatten(0, 1)
    label = "wide bench index (50, 45, 7), one batch's dense minimizers"
    timed(label, bench.keys_t, bench.taxa_t, bench.device_arrays(dev), queries)
    del bench, cls, queries
    genomes = list(workloads.scale_library(chip_smoke.SCALE_BP, chip_smoke.SCALE_TAXA))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    idx = KeyValueIndex.build(iter(genomes), params, workloads.scale_taxonomy(chip_smoke.SCALE_TAXA), dev)
    torch.cuda.synchronize()
    before, build_peak = torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cls = Classifier(idx, dev)  # the probe's arrays on the card: KeyValueIndex.device_arrays
    torch.cuda.synchronize()
    print(f"[{name}] wide scale index: {idx.num_records} records; the probe's arrays "
          f"{torch.cuda.memory_allocated() - before} bytes beside the index's {before}, "
          f"{torch.cuda.max_memory_allocated() - before} at the peak of their making; the build's peak "
          f"{build_peak} bytes", flush=True)
    reads = workloads.scale_reads(chip_smoke.SCALE_BP, chip_smoke.SCALE_TAXA, library=genomes)
    for label, queries in (
        ("wide scale index, random queries",
         chip_smoke.random_wide_queries(dev, idx.keys_t, 1 << 22, chip_smoke.SCALE_RECORDS)),
        ("wide scale index, one batch's dense minimizers", chip_smoke.batch_queries(cls, reads)[2].minimizer.flatten(0, 1)),
    ):
        timed(label, idx.keys_t, idx.taxa_t, idx.device_arrays(dev), queries)


if __name__ == "__main__":
    sys.exit(main())
