#!/usr/bin/env python3
"""Smoke run of slacken_tpu_torch on one NVIDIA GPU (H100).

Run from the repository root: `python3 chip_smoke.py`. It builds the CUDA
kernels from ops/kernels/*.cu, checks each kernel bit-exact against its
plain PyTorch twin on the card (the scan, its rank-table instance and the
wide scan at every main-path shape (bracken's [4, 2^20] rows too) and at other k, m, s; the directory
probe, the narrow slot probe and the wide probe on random, one-prefix and
tiny indexes, the wide probe over slot tables of both field modes and with a
raised directory, and later on the bench and the scale indexes, the narrow
slot probe there beside the directory probe), then drives the port's paths, each with the kernels'
launch counts set to 0 just before it and read just after:

  * reports mode: build the bench library's index on the card (2,623,028
    records expected) and on the CPU, classify the bench's simulated reads
    on both and require byte-identical kreports;
  * the probe choice (`phase_probes`, after reports mode): the tiled,
    hashed1, hashed and hashed128 tables and the bucketed arrays of the
    bench index and the tiled and hashed1 tables of a wide (50, 45, 7) bench
    index built on the card (time, bytes), their seven kernels against the
    twins on one batch's dense minimizers and on 4,194,304 random queries,
    and classify with each probe in both modes, over Mesh([cuda] * 8) with
    tiled and hashed, classify2 --probe hashed1 and one NCCL rank with
    --probe hashed1 and hashed, every file equal to the routed run's; after
    the scale phase the tiled, hashed1, hashed and hashed128 tables and the
    bucketed arrays of the 400 Mbp index, its reads classified with each
    probe and those kernels timed there (`phase_probes_scale`);
  * per-read mode: the same reads with per-read output, card against CPU,
    lines and kreports byte-identical after decompression, kreports equal
    to reports mode's; then under STPU_HIT_RUNS=1 (each row's hit runs in
    place of its dense window taxa, through the kernel that `check_hit_runs`
    holds to its twin first), every file equal to the dense run's, with the
    walls side by side;
  * paired input: two FASTQ files of simulated mates through the CLI's own
    function on the card (dense and under STPU_HIT_RUNS=1) and on the CPU;
  * the programmatic API (Slacken.classify_reads, write_reports,
    Classifier.classify_and_write) on reads and pairs, card against CPU;
  * the kernel diagnostics entry point (the five mask-idiom kernels);
  * the oracle fuzz harness (slacken_tpu_torch/fuzz.py, `phase_fuzz`):
    FUZZ_SEEDS under each of the six narrow and three wide probe choices, a
    random taxonomy, library, (k, m, s), thresholds, gate and adversarial
    reads each, the index built on the card, every read held bit for bit to
    the naive oracle through classify, classify_packed and the written
    per-read and kreport files, dense and under STPU_HIT_RUNS=1; the first
    mismatch prints its repro and fails;
  * the 400 Mbp scale library, built and classified (131,190,899 records);
  * wide keys: the bench library at (k, m, s) = (50, 45, 7) and (35, 33, 0),
    built, saved, loaded and classified in both modes on the card and on the
    CPU, then the scale library built wide and classified;
  * explicit orderings: the bench library at k = 35, m = 13, s = 3 with the
    signature, lexicographic and frequency orderings (the sampling pass on
    the card), saved with its rank table, loaded and classified;
  * two-step classification (classify2): at bench size with every detection
    criterion and the gold set, for a narrow, a wide and a rank-table base
    index, through Dynamic and through the CLI, card against CPU; then on
    the 400 Mbp scale library under a taxonomy with ranks, with the wall of
    each step (find the taxon set, the restricted build from the sidecar,
    the same by a rebuild from the library, the directory, the final
    classify) and the device's busy share; stats, inspect reports and respace
    on the bench and the scale index; classify2 --bracken-length 100 once;
  * Bracken weights (R = 100) on the bench library for the narrow, the wide
    and the rank-table index: the device window classifier on the card
    against the numpy counts on the CPU, kmer_distrib byte-identical;
    bracken-build through the CLI, resuming from chunk files; then two 400
    Mbp libraries on the card, the scale library and one of related genomes
    (fragment pass and device classifier timed apart, the classifier held to
    the numpy counts on one long row), each source's reads equal to its read
    windows;
  * compareIndex: the bench index against its restriction to two genomes,
    narrow and wide, card against CPU; the CLI's compareIndex, inputCheck and
    build --check;
  * the device mesh in one process, eight shards on the one card
    (Mesh([cuda] * 8)): at bench size MeshClassifier replicated and ring in
    both modes for the narrow, the wide and the signature index (files equal
    to the single-device card runs and to the mesh over eight CPU shards),
    build_distributed with the sidecar, classify2 over the ring, and the CLI
    with --devices torch.cuda.device_count() (build --shards 4, classify,
    classify2); at scale build_distributed of the 400 Mbp library (131,190,899
    records, equal to the single-device build) and the ring classify of the
    200,000 reads (the single-device kreport), with walls, peak memory and
    the device's busy share. On a machine of several cards the bench reads
    also go over distinct cards;
  * several processes (parallel/multihost.py; ranks spawned with
    torch.multiprocessing, each reporting its launches through a file): the
    three bench indexes saved as 8 shard files, classified in both modes by
    one rank with a process group under NCCL, by two ranks sharing the card
    over gloo with two ring entries each (a ring of 4 crossing between the
    processes; an odd count of reads gives one rank an all-padding batch),
    and by the CLI with --coordinator --num-processes 1; the 400 Mbp index in
    8 shard files classified by two ranks; every output byte-identical to
    the single-device files (part files joined in name order), with walls,
    P2P bytes a batch, busy share and peak memory a rank. On a machine of
    several cards also min(4, cards) ranks under NCCL, one card each, which
    `python3 chip_smoke.py --across-cards` runs alone with what it is held
    to;
  * the bounded build (index.MergeTree, after phase_scale): the bytes a
    record costs in one device sort and reduce, held to index.MERGE_BYTES;
    the 400 Mbp library built under the default budget (no leaf off the
    card, the build's phase split), under a budget forced to leaves of 8M
    records (at least 8 leave the card) and so with spill_dir, each equal to
    phase_scale's index; at bench size the forced budget and spill routes for
    wide (35, 32, 7) and (50, 45, 7) and signature (35, 13, 3) indexes with
    their sidecars against the CPU, the CLI's build --spill-dir against
    build, and build_distributed over eight shards with spill_dir (launches
    under "build_bounded").

`python3 chip_smoke.py --beyond-card` runs alone: it builds
workloads.scale_library(4e9, 256), whose one-sort build would need more
memory than the card has (about 1.31e9 records at 77.8 bytes a record),
under the default budget (keys strictly increasing, every taxon defined),
then under a quarter of the budget through host leaves and through
spill_dir (all three equal, each peak within its budget), and classifies
200,000 reads against it on the card (at least 99% classified). It first
reads the host's memory and disk and takes the largest library above 3.4
Gbp that fits them where 4 Gbp does not.

`python3 chip_smoke.py --classify2-scale` runs only two-step classification
at full size (phase_classify2_scale on the 400 Mbp library), for comparing
its step walls between two checkouts: copy the script into the other
checkout and run it there and here, in one call.

It prints the measured numbers, one JSON line of per-kernel results (time
beside its bound, the plain twin's time and a library call's where there is
one), and as its last line {"ok": true, "device": {...}}. It stops at the
first failure with a non-zero exit; without CUDA, or outside the repository,
it exits 1 before printing any result.
"""

from __future__ import annotations

import contextlib
import gzip
import io
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
#: walls of earlier phases that phase_multihost sets beside its own: what -> seconds
WALLS = {}
#: phase_build_bounded: the leaf size (records) of its forced budget at
#: scale, and the rows of its builds' batches there (about 2.7M records a
#: batch, so that leaves merge before they leave the card)
FORCED_LEAF = 8 << 20
FORCED_ROWS = 2048
#: peak device memory of the 400 Mbp build with one sort, before the merge
#: tree (measured by this script on an NVIDIA H100 80GB HBM3, PERF.md)
ONE_SORT_PEAK = 10_211_318_272
ONE_SORT_BYTES_PER_RECORD = ONE_SORT_PEAK / SCALE_RECORDS
#: --beyond-card: the library's size (bp), the least size it may be cut to
#: where the host's memory or disk hold less, and its species
BEYOND_BP = 4_000_000_000
BEYOND_MIN_BP = 3_400_000_000
BEYOND_TAXA = 256


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


def device_ms(fn, iters=20, by_kernel=False):
    """Device time of one call of fn alone: the mean duration that
    torch.profiler records for each kernel or copy of fn over `iters` calls,
    times its launches a call, summed. The host's time to enqueue a launch,
    which bounds `cuda_ms` for a kernel of a few microseconds, does not
    count. The mean is taken over the events the trace holds, because a trace
    can come back short of one (19 of 20 launches, seen on the H100 once a
    process has traced often); a plain sum over `iters` would then read low.
    None if the profiler saw no device time. by_kernel: {kernel name: ms}
    in place of the sum."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    each = {e.key: e.self_device_time_total / e.count * max(1, round(e.count / iters)) / 1e3 for e in rows}
    if by_kernel:
        return each
    return sum(each.values()) if rows else None


def fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


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


#: the scan's shapes on the main path: a 4 Mbp classify batch of 128 bp rows,
#: one of paired rows (two 128-wide mates and the separator, padded to 264)
#: and a build batch of 4 kbp genome rows (index._default_batch)
SCAN_SHAPES = [(32768, 128), (16384, 264), (8192, 4096)]
#: bracken's fragment rows: four of the longest fragment (2^20 bases), one batch
LONG_ROWS = (4, 1 << 20)
#: (k, m, s) of the rank-table scan's checks: a table in L1 (m = 5), one a
#: little over the L2 (m = 12, 64 MiB) and one far over it (m = 13, 256 MiB);
#: the last is timed at every shape
LUT_SCANS = [(21, 5, 1), (35, 12, 3), (35, 13, 3)]
#: (label, keys, bits of hi64) of the random wide indexes the probe is timed on
WIDE_INDEXES = [("2M random wide keys, random queries", 2_000_000, 62),
                ("120M random wide keys (hi64 below 2^26), random queries", 120_000_000, 26)]


#: the segment lengths forced on segment-adversarial rows
#: (workloads.segment_rows): the shortest, and one with a shorter last segment
FORCED_SEGMENTS = (128, 384)

def scan_equals_twin(rng, dev, shape, mp, lut=None, table="", codes=None, segment=None):
    """The scan kernel for these parameters == its twin, bit for bit, on
    random rows with invalid bases (or on `codes`), with the rows cut into
    segments of `segment` positions when given (the launch then counted as
    stitched, "scan_stitch", once)."""
    import torch

    from slacken_tpu_torch.ops import cuda_kernels, encode, minimizers

    if codes is None:
        codes = random_codes(rng, shape)
    shape = codes.shape
    packed, valid = (torch.from_numpy(a).to(dev) for a in encode.pack_2bit(codes))
    stitched = cuda_kernels.LAUNCHES["scan_stitch"]
    if segment is None:
        got = minimizers.window_minimizers_packed(packed, valid, mp, lut)
    else:
        got = minimizers.WindowMinimizers(*cuda_kernels.window_minimizers_cuda(packed, valid, mp, lut, _segment=segment))
    stitched = cuda_kernels.LAUNCHES["scan_stitch"] - stitched
    want = minimizers.window_minimizers(encode.unpack_2bit(packed, valid), mp, lut)
    torch.cuda.synchronize()
    what = (f"{list(shape)} k={mp.k} m={mp.m} s={mp.spaces} canonical={mp.canonical}" + table
            + ("" if segment is None else f", segment-adversarial rows in segments of {segment}"))
    if stitched != int((segment or cuda_kernels.segment_length(*shape, cuda_kernels.scan_warps(dev))) < shape[1]):
        fail(f"the scan stitched its rows in {stitched} launches at {what}")
    for name in ("valid", "span_start", "distinct"):
        if not torch.equal(getattr(got, name), getattr(want, name)):
            fail(f"scan {name} differs from the twin at {what}")
    if got.minimizer.shape != want.minimizer.shape:
        fail(f"scan minimizers are {tuple(got.minimizer.shape)}, the twin's {tuple(want.minimizer.shape)} at {what}")
    if not torch.equal(got.minimizer, want.minimizer):  # -1 at invalid windows in both
        fail(f"scan minimizers differ from the twin at {what}")
    log(f"scan kernel == twin at {what}: valid windows {int(want.valid.sum())}, "
        f"span starts {int(got.span_start.sum())}, max_abs_err 0")


def segments_equal_twin(rng, dev, mp, lut=None, table=""):
    """scan_equals_twin on workloads.segment_rows at each forced segment
    length."""
    from slacken_tpu_torch import workloads

    for segment in FORCED_SEGMENTS:
        scan_equals_twin(rng, dev, None, mp, lut, table, workloads.segment_rows(rng, segment, mp.k), segment)


def table_bytes(lut, codes, mp):
    """Device-memory bytes of a rank table that a scan of `codes` must read:
    a random 4-byte load costs a whole 32-byte sector, and each sector that
    the positions' masked canonical m-mers touch is read at least once (the
    L2 may serve it after). A spaced seed leaves only 4^(m - s) of the 4^m
    ranks reachable, so the sectors are counted from the run's data: the
    twin's priorities through an identity table are the indices the kernel
    loads, one at every position, valid or not."""
    import torch

    from slacken_tpu_torch.ops import minimizers

    identity = torch.arange(lut.numel(), dtype=torch.int32, device=lut.device)
    idx = minimizers.priorities(torch.from_numpy(codes).to(lut.device), mp, identity)
    sectors = torch.unique(idx // (32 // lut.element_size())).numel()
    return min(lut.numel() * lut.element_size(), 32 * sectors)


def one_launch(fn, what):
    """Fail unless torch.profiler's trace of fn shows one kernel, launched
    once a call (a trace late in a long process now and then comes back
    empty: up to three tries). Returns the kernel's name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    seen = {}
    for _ in range(3):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        seen = {e.key: round(e.count / 5) for e in prof.key_averages() if e.self_device_time_total > 0}
        if seen:
            break
    if list(seen.values()) != [1]:
        fail(f"{what} is not one kernel launch a call in the profiler's trace: {seen}")
    return next(iter(seen))


def time_stitch(rng, dev, shape, mp, lut=None, table=""):
    """The stitch inside the segmented scan's launch, at the segments the
    wrapper chooses for rows of `shape`, on rows that give it work
    (workloads.carry_rows: N runs that end at segment starts, some followed
    by the bases before them): the launch == the whole-row twin there, one
    kernel in the profiler's trace, and the carry cleared at least one byte
    (minimizers.carried over the summaries and the minimizers that the
    launch wrote; stitch_segments over them changes nothing); the launch's
    ms back to back and alone, the twin's (window_minimizers on these rows;
    stitch_segments alone beside it) and the bound: the scan's bytes
    (`time_scan`) and the stitch's, the summaries written and read once,
    the minimizer read and the distinct byte written at each first window
    that needs the carry."""
    import torch

    from slacken_tpu_torch import workloads
    from slacken_tpu_torch.ops import cuda_kernels, encode, minimizers

    codes = workloads.carry_rows(rng, shape, cuda_kernels.segment_length(*shape, cuda_kernels.scan_warps(dev)), mp.k)
    scan_equals_twin(rng, dev, None, mp, lut, table + ", rows whose carry clears distinct bytes", codes)
    packed, valid = (torch.from_numpy(a).to(dev) for a in encode.pack_2bit(codes))
    run = lambda: cuda_kernels.scan_pass1_cuda(packed, valid, mp, lut)  # noqa: E731
    mn, flags, summary = run()
    torch.cuda.synchronize()
    what = f"{list(shape)} k={mp.k} m={mp.m}{table}"
    cleared = minimizers.carried(mn, summary)
    if not cleared.numel():
        fail(f"the scan's carry cleared no distinct byte at {what}: the rows give the stitch no work")
    if bool(flags[2].view(-1)[cleared].any()) or not torch.equal(minimizers.stitch_segments(mn, flags[2], summary),
                                                                 flags[2]):
        fail(f"the segmented scan's distinct is not stitched at {what}")
    kernel = one_launch(run, f"the segmented scan at {what}")
    ms, dev_ms = cuda_ms(run), device_ms(run)
    plain = cuda_ms(lambda: minimizers.window_minimizers(encode.unpack_2bit(packed, valid), mp, lut), iters=3)
    stitch_plain = cuda_ms(lambda: minimizers.stitch_segments(mn, flags[2], summary), iters=3)
    n_need, n_pos = int((summary[..., 1] >= 0).sum()), shape[0] * shape[1]
    n_bytes = tensor_bytes(packed, valid) + n_pos * ((16 if mp.wide else 8) + 3)
    if lut is not None:
        n_bytes += table_bytes(lut, codes, mp)
    stitch_bytes = 2 * tensor_bytes(summary) + n_need * 8 * (2 if mp.wide else 1) + cleared.numel()
    bound_ms, by = bound(n_bytes + stitch_bytes, (96 if mp.wide else 48) * n_pos)
    log(f"scan with the stitch inside, {list(summary.shape[:2])} segments (k={mp.k} m={mp.m}"
        f"{'' if lut is None else ', rank table'}), carry rows: one kernel ({kernel[:60]}); {n_need} first windows "
        f"needed the carry, {cleared.numel()} distinct bytes cleared; {ms:.4f} ms back to back, {fmt_ms(dev_ms)} "
        f"alone, plain PyTorch on the card {plain:.4f} ms (stitch_segments alone {stitch_plain:.4f}), bound "
        f"{bound_ms:.4f} ms ({by}, {n_bytes + stitch_bytes} bytes, {stitch_bytes} of them the stitch's); == twin, "
        "max_abs_err 0")
    return dict(ms=ms, device_ms=dev_ms, plain_ms=plain, stitch_plain_ms=stitch_plain, bound_ms=bound_ms, bound_by=by,
                library_ms=None, segments=list(summary.shape[:2]), needing_carry=n_need, cleared=cleared.numel())


def time_scan(rng, dev, shape, mp, lut=None):
    """Kernel ms back to back and alone, the twin's ms and the bound at one
    shape; where the wrapper cuts these rows into segments, one kernel in
    the profiler's trace (the stitch is inside it) and `time_stitch` on rows
    that give the stitch work beside it. Bytes: packed
    codes and validity bits in; minimizers (8 bytes, 16 for a wide m) and
    three flag bytes a position out; with a rank table what `table_bytes`
    counts. Operations: about 48 32-bit integer operations a position
    suffice (rolling forward and reverse m-mers, spaced mask, toggle,
    canonical min, a min over k-m+1 windows, the three flags), twice that on
    two limbs."""
    import torch

    from slacken_tpu_torch.ops import cuda_kernels, encode, minimizers

    codes = random_codes(rng, shape)
    packed, valid = (torch.from_numpy(a).to(dev) for a in encode.pack_2bit(codes))
    run = lambda: cuda_kernels.window_minimizers_cuda(packed, valid, mp, lut)  # noqa: E731
    segment = cuda_kernels.segment_length(*shape, cuda_kernels.scan_warps(dev))
    ms = cuda_ms(run)
    if segment < shape[1]:
        one_launch(run, f"the segmented scan at {list(shape)} k={mp.k} m={mp.m}")
    dev_ms = device_ms(run)
    plain = cuda_ms(lambda: minimizers.window_minimizers(encode.unpack_2bit(packed, valid), mp, lut), iters=3)
    n_pos = shape[0] * shape[1]
    n_bytes = tensor_bytes(packed, valid) + n_pos * ((16 if mp.wide else 8) + 3)
    if lut is not None:
        n_bytes += table_bytes(lut, codes, mp)
    bound_ms, by = bound(n_bytes, (96 if mp.wide else 48) * n_pos)
    log(f"scan {list(shape)} k={mp.k} m={mp.m} s={mp.spaces}{'' if lut is None else ' with a rank table'}"
        f"{'' if segment == shape[1] else f' in segments of {segment}, stitched in the launch'}: kernel {ms:.4f} ms "
        f"back to back through the wrapper, {fmt_ms(dev_ms)} on the device alone, plain PyTorch on the card "
        f"{plain:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({by}, {n_bytes / 1e6:.1f} MB); no single library call computes it")
    out = dict(ms=ms, device_ms=dev_ms, plain_ms=plain, bound_ms=bound_ms, bound_by=by)
    if segment < shape[1]:
        out["segment"] = segment
        out["stitch"] = time_stitch(rng, dev, shape, mp, lut)
    return out


def check_scan(rng, dev, results):
    import torch

    from slacken_tpu_torch.ops import minimizers, ordering

    default = minimizers.MinimizerParams()
    P = minimizers.MinimizerParams
    # random shapes and the main path's with the default k, m, s; then other
    # parameter sets: a window inside one lane (W = 1), non-canonical, m = 1
    # (W = k), windows that reach 2 to 9 lanes ahead, k > 61 (validity over
    # several words) and rows shorter than one chunk; then rows cut into
    # segments, with N runs over whole segments and first valid windows at
    # segment starts, for Kraken 2's default instance and the generic one
    # (W = 1, k - m = 120)
    cases = [(shape, default) for shape in [(4096, 128), (512, 1024), *SCAN_SHAPES]]
    cases += [((512, 1024), mp) for mp in (
        P(21, 15, 3), P(31, 31, 0), P(35, 31, 7, canonical=False), P(35, 1, 0), P(12, 5, 1, canonical=False),
        P(38, 31, 7), P(70, 31, 7), P(100, 16, 2), P(151, 31, 0))]
    cases += [((37, 8), P(5, 3, 1)), ((37, 72), default), (LONG_ROWS, default)]
    for shape, mp in cases:
        scan_equals_twin(rng, dev, shape, mp)
    for mp in (default, P(21, 15, 3, canonical=False), P(31, 31, 0), P(151, 31, 0)):
        segments_equal_twin(rng, dev, mp)
    shapes = {str(list(shape)): time_scan(rng, dev, shape, default) for shape in (*SCAN_SHAPES, LONG_ROWS)}
    results["scan"] = dict(max_abs_err=0.0, **shapes[str(list(SCAN_SHAPES[0]))], library_ms=None, shapes=shapes)
    stitch = {f"{list(LONG_ROWS)} (35, 31, 7)": shapes[str(list(LONG_ROWS))]["stitch"]}

    # the rank-table instance, each m with the lexicographic, the signature
    # and a random order; rows shorter than k (8 < 21) and than one chunk, and
    # the main path's shapes, bracken's fragment rows and segment-adversarial
    # rows with the timed m
    shapes = {}
    timed = LUT_SCANS[-1][1]
    for mp in (P(*kms) for kms in LUT_SCANS):
        n = 1 << (2 * mp.m)
        tables = {"lexicographic": ordering.lexicographic_lut(mp.m), "signature": ordering.signature_lut(mp.m),
                  "random permutation": rng.permutation(n)}
        for name, table in tables.items():
            lut = torch.from_numpy(table.astype(np.int32)).to(dev)
            for shape in [(512, 1024), (37, 8), (37, 72), *SCAN_SHAPES, *([LONG_ROWS] if mp.m == timed else [])]:
                scan_equals_twin(rng, dev, shape, mp, lut, f", {name} table of {n} ranks")
            if mp.m == timed:
                segments_equal_twin(rng, dev, mp, lut, f", {name} table of {n} ranks")
        for shape in (*SCAN_SHAPES, LONG_ROWS) if mp.m == timed else SCAN_SHAPES[:1]:  # `lut`: the random one
            shapes[f"{list(shape)} m={mp.m}"] = time_scan(rng, dev, shape, mp, lut)
        del lut
    results["scan_lut"] = dict(max_abs_err=0.0, **shapes[f"{list(SCAN_SHAPES[0])} m={timed}"], library_ms=None, shapes=shapes)
    stitch[f"{list(LONG_ROWS)} {tuple(LUT_SCANS[-1])}, rank table"] = shapes[f"{list(LONG_ROWS)} m={timed}"]["stitch"]

    # the wide kernel: m = 32 (the key is all of lo64) and 33, the widest m,
    # spaced and not, W = 1, 3, 4, 6 and 18; segment-adversarial rows with
    # W = 1 and k - m = 120 too
    wide = (P(35, 32, 0), P(35, 33, 0), P(50, 45, 7), P(80, 63, 7), P(63, 63, 0))
    for mp in wide:
        for shape in [(512, 1024), (37, 8), (37, 72), *SCAN_SHAPES]:
            scan_equals_twin(rng, dev, shape, mp)
    scan_equals_twin(rng, dev, (512, 1024), P(50, 45, 7, canonical=False))
    scan_equals_twin(rng, dev, LONG_ROWS, P(50, 45, 7))
    for mp in (P(50, 45, 7), P(63, 63, 0, canonical=False), P(183, 63, 31)):
        segments_equal_twin(rng, dev, mp)
    shapes = {f"{list(shape)} (50, 45, 7)": time_scan(rng, dev, shape, P(50, 45, 7))
              for shape in (*SCAN_SHAPES, LONG_ROWS)}
    for mp in (P(35, 33, 0), P(80, 63, 7)):
        shapes[f"{list(SCAN_SHAPES[0])} ({mp.k}, {mp.m}, {mp.spaces})"] = time_scan(rng, dev, SCAN_SHAPES[0], mp)
    results["scan_wide"] = dict(max_abs_err=0.0, **shapes[f"{list(SCAN_SHAPES[0])} (50, 45, 7)"], library_ms=None,
                                shapes=shapes)
    stitch[f"{list(LONG_ROWS)} (50, 45, 7)"] = shapes[f"{list(LONG_ROWS)} (50, 45, 7)"]["stitch"]
    results["scan_stitch"] = dict(max_abs_err=0.0, **stitch[f"{list(LONG_ROWS)} (35, 31, 7)"], shapes=stitch,
                                  fused_into="stitch_row in the SEG instances of scan_kernel and scan_wide_kernel")


def time_probe(label, keys, taxa, table, queries, name="probe"):
    """Kernel == twin on these queries, then the kernel's time beside the
    twin's and, for narrow keys, torch.searchsorted's (a yardstick: the port
    never calls it on the card; it has no form for two-limb keys). `table`
    is what the kernel reads: a narrow index's directory (the directory
    kernel, "probe"), its slot table ("probe_slots") or a wide index's
    ("probe_wide"); `keys` and `taxa` are what the twins read, copied to the
    queries' device where they lie elsewhere (an index whose slot table is
    on the card keeps them in host memory). The bound counts what the
    layout reads, once for each distinct query, as the table probes' bounds
    count it: a directory entry and a key, and a taxon a hit (the directory
    kernel and the wide probe), or a directory entry and a slot, which holds
    the taxon or its code (a narrow slot table: a code a hit when the field
    holds codes). Over a narrow slot table also its floor (the directory
    entries, then the sector of slots at the guessed slot), and the
    directory kernel on the same keys and queries, whose entry goes under
    "directory". Returns the numbers of one entry of the probe's `shapes`."""
    import torch

    from slacken_tpu_torch.ops import cuda_kernels, lookup

    keys, taxa = keys.to(queries.device), taxa.to(queries.device)
    wide, slots = keys.dim() == 2, isinstance(table, lookup.SlotTable)
    directory = lookup.build_directory(keys) if slots else table
    before = cuda_kernels.LAUNCHES[name]
    got = lookup.probe(None if slots else keys, None if slots else taxa, table, queries)
    if cuda_kernels.LAUNCHES[name] != before + 1:
        fail(f"the probe of {label} did not launch the {name} kernel")
    want = lookup.lookup_taxa(keys, taxa, queries)
    torch.cuda.synchronize()
    err = int((got - want).abs().max())
    if slots:
        err = max(err, int((lookup.lookup_taxa_slots(table, queries) - want).abs().max()))
    if err:
        fail(f"{name} differs from the twin on {label} (max abs err {err})")
    run = ((lambda: cuda_kernels.lookup_taxa_slots_cuda(table, queries)) if slots  # noqa: E731
           else (lambda: cuda_kernels.lookup_taxa_directory_cuda(keys, taxa, directory, queries)))
    ms, dev_ms = cuda_ms(run), device_ms(run)
    floor = None
    if slots and not wide:
        if not torch.equal(cuda_kernels.slots_floor_cuda(table, queries), lookup.slot_sectors(table, queries)):
            fail(f"the slot probe's floor kernel differs from lookup.slot_sectors on {label}")
        floor = device_ms(lambda: cuda_kernels.slots_floor_cuda(table, queries))
    plain = cuda_ms(lambda: lookup.lookup_taxa(keys, taxa, queries), iters=5)
    library = None if wide else cuda_ms(lambda: torch.searchsorted(keys, queries))
    # bytes: the smaller of every array once (queries, keys, taxa and
    # directory in, or slots, directory and codes; taxa out) and what these
    # queries need (a query and its answer; once for each distinct query
    # inside the keys' range, one directory entry and one key, and one taxon
    # if it hits; over narrow slots a directory entry and a slot, and a code
    # if it hits and the field holds codes): a probe of a large index reads
    # little of it. Operations: a shift, two compares and a select or two per
    # query.
    nq, hits, key_bytes = queries.shape[0], int((want > 0).sum()), 16 if wide else 8
    if wide:
        p_lo, p_above = lookup.prefix_wide(queries, directory.shift)
        inside = (queries[:, 0] >= 0) & (p_above == 0) & (p_lo >= 0) & (p_lo < directory.buckets)
    else:
        inside = (queries >= 0) & ((queries >> directory.shift) < directory.buckets)
    seen = torch.unique(queries[inside], dim=0)
    inside = seen.shape[0]  # distinct queries inside the keys' range
    found = int((lookup.lookup_taxa(keys, taxa, seen) > 0).sum())
    if slots and not wide:
        codes = () if table.codes is None else (table.codes,)
        n_bytes = min(tensor_bytes(queries, table.slots, table.directory.starts, *codes) + 4 * nq,
                      12 * nq + 12 * inside + (4 * found if codes else 0))
    else:
        n_bytes = min(tensor_bytes(queries, keys, taxa, directory.starts) + 4 * nq,
                      (key_bytes + 4) * nq + (key_bytes + 4) * inside + 4 * found)
    bound_ms, by = bound(n_bytes, (16 if wide else 8) * nq)
    d = table.directory if slots else directory
    held = (f" of slots with a {table.c}-bit field, {'direct' if table.codes is None else 'codes'}"
            f"{'' if table.codes is None else f' ({table.codes.shape[0]} taxa)'}, "
            f"{lookup.probe_bytes(table) / max(keys.shape[0], 1):.2f} bytes a record") if slots else ""
    log(f"{name}, {label}: {keys.shape[0]} keys ({d.buckets} buckets{held}, shift {d.shift}), {nq} queries, "
        f"{hits} hits, {inside} distinct inside the keys' range, max_abs_err 0; kernel {ms:.4f} ms ({fmt_ms(dev_ms)} on "
        "the device alone), " + ("" if floor is None else f"floor: the directory entries and one sector a query at "
                                 f"its guessed slot {fmt_ms(floor)} on the device alone, ") +
        f"plain twin {plain:.4f} ms, " +
        ("no library call: torch.searchsorted takes one-limb keys only, " if wide
         else f"torch.searchsorted alone {library:.4f} ms, ") +
        f"bound {bound_ms:.4f} ms ({by}, {n_bytes / 1e6:.1f} MB)")
    entry = dict(max_abs_err=float(err), ms=ms, device_ms=dev_ms, plain_ms=plain, bound_ms=bound_ms, bound_by=by,
                 library_ms=library, **({} if floor is None else {"floor_device_ms": floor}))
    if slots and not wide:
        entry["directory"] = time_probe(label, keys, taxa, directory, queries)
        if entry["directory"]["device_ms"] is not None and dev_ms is not None:
            log(f"probe_slots against the directory kernel, {label}: {dev_ms:.4f} / "
                f"{entry['directory']['device_ms']:.4f} ms on the device alone")
    return entry


def time_routed(label, keys, taxa, table, queries, results):
    """time_probe of a narrow index's routed probe on the card (its slot
    table), with the directory kernel beside it on the same queries: the
    entries of both kernels' `shapes`."""
    entry = time_probe(label, keys, taxa, table, queries, "probe_slots")
    results["probe"]["shapes"][label] = entry.pop("directory")
    results["probe_slots"]["shapes"][label] = entry


def random_queries(rng, keys, nq):
    """Half hits, half random misses, 1,000 above 2^62, and the edges."""
    hits = keys[rng.integers(0, len(keys), nq // 2)]
    misses = rng.integers(0, 1 << 62, nq - nq // 2 - 1005, dtype=np.int64)
    wild = rng.integers(1 << 62, (1 << 63) - 1, 1000, dtype=np.int64)  # garbage queries
    q = np.concatenate([hits, misses, wild, [-5, 0, keys[0], keys[-1], (1 << 63) - 1]])
    rng.shuffle(q)
    return q


def narrow_random_queries(dev, index, seed):
    """`random_queries` of 4,194,304 around 2,097,152 keys of a narrow index,
    every draw from a generator of `seed`, on `dev`."""
    import torch

    rng = np.random.default_rng(seed)
    keys = index.keys_t  # in host memory once a classifier holds the index's slot table on the card
    host_keys = keys[torch.from_numpy(rng.integers(0, index.num_records, 1 << 21)).to(keys.device)].cpu().numpy()
    return torch.from_numpy(random_queries(rng, host_keys, 1 << 22)).to(dev)


def check_probe(rng, dev, results):
    import torch

    from slacken_tpu_torch.ops import lookup

    # adversarial indexes: tiny, all keys under one prefix, two prefixes far
    # apart, narrow keys; queries at and around every key and at the edges
    edge = np.array([-5, 0, 1, 1 << 61, 1 << 62, (1 << 63) - 1, -(1 << 63)], np.int64)
    n_cases = 0
    for n in (0, 1, 2, 127, 128, 129, 100_003):
        kinds = {
            "uniform": rng.integers(0, 1 << 62, 2 * n + 1, dtype=np.int64),
            "one prefix": (1 << 61) + rng.integers(0, 1 << 20, 2 * n + 1, dtype=np.int64),
            "two prefixes": np.concatenate([rng.integers(0, 1 << 12, n // 2, dtype=np.int64),
                                            (1 << 62) - 1 - rng.integers(0, 1 << 12, n, dtype=np.int64)]),
            "narrow keys": rng.integers(0, 1 << 30, 2 * n + 1, dtype=np.int64),
        }
        for kind, raw in kinds.items():
            keys = np.unique(raw)[:n]
            taxa = rng.integers(1, 1 << 20, len(keys)).astype(np.int32)
            q = np.concatenate([keys, keys - 1, keys + 1, edge, rng.integers(-(1 << 63), (1 << 63) - 1, 2000, dtype=np.int64)])
            k_d, t_d, q_d = (torch.from_numpy(a).to(dev) for a in (keys, taxa, q))
            for bucket_keys in (1, lookup.BUCKET_KEYS, 1 << 30):  # the last: one bucket holds every key
                d = lookup.build_directory(k_d, bucket_keys)
                got, want = lookup.probe(k_d, t_d, d, q_d), lookup.lookup_taxa(k_d, t_d, q_d)
                table = lookup.build_slots(k_d, t_d, d)  # the slot kernel, under the same directory
                slots = lookup.probe(None, None, table, q_d)
                torch.cuda.synchronize()
                if not torch.equal(got, want) or not torch.equal(lookup.lookup_taxa_directory(k_d, t_d, d, q_d), want):
                    fail(f"probe differs from the twin: {len(keys)} keys, {kind}, {d.buckets} buckets")
                if not torch.equal(slots, want) or not torch.equal(lookup.lookup_taxa_slots(table, q_d), want):
                    fail(f"probe_slots differs from the twin: {len(keys)} keys, {kind}, {d.buckets} buckets")
                n_cases += 1
    log(f"probe and probe_slots kernels == twins == directory twin on {n_cases} adversarial indexes (0 to 100,003 "
        "keys; uniform, one prefix, two prefixes, narrow keys; 1, 4 and all keys a bucket), max_abs_err 0")

    n = 2_000_000
    keys = np.unique(rng.integers(0, 1 << 62, int(n * 1.01), dtype=np.int64))[:n]
    taxa = rng.integers(1, 1 << 20, len(keys)).astype(np.int32)
    nq = 1 << 22  # one 4 Mbp batch probes every window position
    k_d, t_d, q_d = (torch.from_numpy(a).to(dev) for a in (keys, taxa, random_queries(rng, keys, nq)))
    label = "2M random keys, random queries"
    results["probe"], results["probe_slots"] = {"shapes": {}}, {"shapes": {}}
    time_routed(label, k_d, t_d, lookup.build_slots(k_d, t_d), q_d, results)
    # the directory's one parameter, timed on the same index and queries
    for bucket_keys in (2, 4, 8, 16, 64):
        d = lookup.build_directory(k_d, bucket_keys)
        ms = cuda_ms(lambda: lookup.probe(k_d, t_d, d, q_d))
        log(f"probe, 2M random keys, about {bucket_keys} keys a bucket ({d.starts.numel() * 4 / 1e6:.2f} MB "
            f"directory): {ms:.4f} ms")
    for name in ("probe", "probe_slots"):
        results[name] = dict(results[name]["shapes"][label], shapes=results[name]["shapes"])
    check_probe_wide(rng, dev, results)


def wide_rows(hi, lo):
    """Sorted unique int64 [n, 2] rows (hi64, lo64 as bit patterns) of the
    given limbs: np.unique orders uint64 rows by (hi64, lo64), unsigned."""
    return np.unique(np.stack([hi.view(np.uint64), lo.view(np.uint64)], 1), axis=0).view(np.int64)


def rand64(gen, n, dev):
    """n random 64-bit patterns as int64, from two 32-bit halves."""
    import torch

    half = lambda: torch.randint(0, 1 << 32, (n,), generator=gen, device=dev)  # noqa: E731
    return (half() << 32) | half()


def random_wide_index(dev, n, hi_bits, seed):
    """About n random sorted unique wide keys with hi64 below 2^hi_bits, made
    and sorted on the card (the build's own sort), and taxa."""
    import torch

    from slacken_tpu_torch.index import _sort_records

    gen = torch.Generator(device=dev).manual_seed(seed)
    keys = torch.stack([torch.randint(0, 1 << hi_bits, (n,), generator=gen, device=dev), rand64(gen, n, dev)], 1)
    taxa = torch.randint(1, 1 << 20, (n,), generator=gen, device=dev, dtype=torch.int32)
    keys, taxa = _sort_records(keys, taxa)
    new = torch.ones(n, dtype=torch.bool, device=dev)
    new[1:] = (keys[1:] != keys[:-1]).any(1)
    return keys[new].contiguous(), taxa[new].contiguous()


def random_wide_queries(dev, keys, nq, seed):
    """Half hits, a quarter keys with another lo64 (equal hi64, lo64
    missing), the rest random, of them 1,000 invalid windows' -1."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    keys = keys.to(dev)
    pick = lambda n: keys[torch.randint(0, keys.shape[0], (n,), generator=gen, device=dev)]  # noqa: E731
    near = pick(nq // 4).clone()
    near[:, 1] = rand64(gen, nq // 4, dev)
    n_rest = nq - nq // 2 - nq // 4
    rest = torch.stack([torch.randint(0, int(keys[-1, 0]) + 2, (n_rest,), generator=gen, device=dev),
                        rand64(gen, n_rest, dev)], 1)
    rest[:1000] = -1
    q = torch.cat([pick(nq // 2), near, rest])
    return q[torch.randperm(nq, generator=gen, device=dev)].contiguous()


def bucket_neighbours(keys, shift):
    """keys +- 2^shift as 128-bit values (int64 [2n, 2] bit patterns,
    wrapped): each key's remainder in the next and in the previous bucket,
    where the slot that the kernel loads for alignment is the last of the
    bucket before."""
    u = keys.view(np.uint64)
    d_hi, d_lo = (np.uint64(1 << (shift - 64)), np.uint64(0)) if shift >= 64 else (np.uint64(0), np.uint64(1 << shift))
    up_lo, dn_lo = u[:, 1] + d_lo, u[:, 1] - d_lo
    up = np.stack([u[:, 0] + d_hi + (up_lo < u[:, 1]), up_lo], 1)
    dn = np.stack([u[:, 0] - d_hi - (dn_lo > u[:, 1]), dn_lo], 1)
    return np.concatenate([up, dn]).view(np.int64)


def check_probe_wide(rng, dev, results):
    import torch

    from slacken_tpu_torch.ops import lookup

    # adversarial wide indexes: empty, one key, every key under one hi64,
    # hi64 = 0 throughout (m = 32), few hi64, lo64 differing only in the top
    # bit; queries at every key, beside it in either limb, with the top bit of
    # lo64 flipped, at its remainder in the neighbouring buckets, an invalid
    # window's -1, random. The slot tables reach both field modes (taxa below
    # 2^20 fit the field at hi64 below 2^26, not at 126-bit keys) and, with
    # one bucket asked for at 126-bit keys, a raised directory.
    one = np.array([[0, 1]], np.int64)
    edge = np.array([[-1, -1], [0, 0], [0, -1], [(1 << 62) - 1, -1], [-(1 << 63), 0], [1 << 61, 0]], np.int64)
    n_cases, reached = 0, set()
    for n in (0, 1, 2, 3, 127, 128, 129, 100_003):
        lo = rng.integers(-(1 << 63), (1 << 63) - 1, 2 * n + 4, dtype=np.int64)
        lo[:4] = [0, 1, -(1 << 63), -1]
        kinds = {
            "uniform": rng.integers(0, 1 << 62, 2 * n + 4, dtype=np.int64),
            "hi64 below 2^26 (m = 45)": rng.integers(0, 1 << 26, 2 * n + 4, dtype=np.int64),
            "one hi64": np.full(2 * n + 4, 12345, np.int64),
            "hi64 = 0 (m = 32)": np.zeros(2 * n + 4, np.int64),
            "three hi64": rng.integers(0, 3, 2 * n + 4, dtype=np.int64),
        }
        for kind, hi in kinds.items():
            rows = wide_rows(hi, lo)
            keys = rows[np.sort(rng.permutation(len(rows))[:n])]
            taxa = rng.integers(1, 1 << 20, len(keys)).astype(np.int32)
            q = np.concatenate([keys, keys + one, keys - one, keys + one[:, ::-1], keys ^ np.array([[0, -(1 << 63)]]),
                                edge, rng.integers(-(1 << 63), (1 << 63) - 1, (2000, 2), dtype=np.int64)])
            k_d, t_d = (torch.from_numpy(a).to(dev) for a in (keys, taxa))
            for bucket_keys in (1, lookup.BUCKET_KEYS, 1 << 30):
                d = lookup.build_directory(k_d, bucket_keys)
                table = lookup.build_slots(k_d, t_d, d)
                q_d = torch.from_numpy(np.concatenate([q, bucket_neighbours(keys, table.directory.shift)])).to(dev)
                got, want = lookup.probe(None, None, table, q_d), lookup.lookup_taxa(k_d, t_d, q_d)
                torch.cuda.synchronize()
                if not (torch.equal(got, want) and torch.equal(lookup.lookup_taxa_slots(table, q_d), want)
                        and torch.equal(lookup.lookup_taxa_directory(k_d, t_d, d, q_d), want)):
                    fail(f"wide probe differs from the twins: {len(keys)} keys, {kind}, {d.buckets} buckets")
                if int((want > 0).sum()) < len(keys):
                    fail(f"the wide twin misses keys of the index: {len(keys)} keys, {kind}")
                reached.add("direct" if table.codes is None else "codes")
                if table.directory.buckets > d.buckets:
                    reached.add("raised directory")
                n_cases += 1
    if reached != {"direct", "codes", "raised directory"}:
        fail(f"the adversarial slot tables reached only {sorted(reached)}")
    log(f"wide probe kernel == slot twin == twin == directory twin on {n_cases} adversarial indexes (0 to 100,003 "
        "keys; uniform, hi64 below 2^26, one hi64, hi64 = 0, three hi64; 1, 4 and all keys a bucket; slot fields "
        "direct and codes, and a raised directory), max_abs_err 0")
    shapes = {}
    for label, n, hi_bits in WIDE_INDEXES:
        k_d, t_d = random_wide_index(dev, n, hi_bits, n)
        q_d = random_wide_queries(dev, k_d, 1 << 22, n + 1)
        table = lookup.build_slots(k_d, t_d)
        shapes[label] = time_probe(label, k_d, t_d, table, q_d, "probe_wide")
        del k_d, t_d, q_d, table
    results["probe_wide"] = dict(shapes[WIDE_INDEXES[0][0]], shapes=shapes)


def check_mask_idioms(dev, results):
    """Each of the five mask-idiom kernels == its twin at [8, 128] and
    [4096, 128] (the diagnostics entry point's inputs); timed at the latter.
    The one-kernel sum_bool also at shapes whose grid-stride loop runs more
    than once, off a 16-byte boundary, and several launches in a row."""
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
    gen = torch.Generator(device=dev).manual_seed(5)
    flat = torch.randint(0, 129, (1201 * 1001 + 1,), generator=gen, device=dev, dtype=torch.int32)
    sum_bool_inputs = {
        "[16384, 128] random (two grid-stride rounds of 16-byte loads)":
            torch.randint(0, 129, (16384, 128), generator=gen, device=dev, dtype=torch.int32),
        "[1201, 1001] random, 4 bytes off a 16-byte boundary (the scalar path, several rounds)":
            flat[1:].view(1201, 1001),
        "[5, 16] random (under one block)": torch.randint(0, 129, (5, 16), generator=gen, device=dev, dtype=torch.int32),
    }
    for name, plain_fn in mask_idioms.PLAIN.items():
        err = 0
        cases = dict(inputs, **sum_bool_inputs) if name == "sum_bool" else inputs
        for label, x in [*cases.items(), *cases.items()]:  # twice: sum_bool's counters alternate by launch
            got, want = cuda_kernels.mask_idiom_cuda(name, x), plain_fn(x)
            torch.cuda.synchronize()
            if got.dtype != want.dtype or got.shape != want.shape:
                fail(f"{name} kernel returns {got.dtype} {tuple(got.shape)} at {label}")
            err = max(err, int((got.long() - want.long()).abs().max()))
            if err:
                fail(f"{name} kernel differs from its twin at {label} (max abs err {err})")
        # back to back through the wrapper as a caller would use it (it
        # allocates the result), then into a ready `out`, then the device
        # time alone: at this size a call is bound by the host's enqueue
        out = torch.empty_like(big)
        ms = cuda_ms(lambda: cuda_kernels.mask_idiom_cuda(name, big), iters=50)
        ms_out = cuda_ms(lambda: cuda_kernels.mask_idiom_cuda(name, big, out=out), iters=50)
        dev_ms = device_ms(lambda: cuda_kernels.mask_idiom_cuda(name, big, out=out), iters=100)
        if not torch.equal(out, plain_fn(big)):
            fail(f"{name} kernel differs from its twin when it writes into `out`")
        plain = cuda_ms(lambda: plain_fn(big), iters=50)
        library_ms = library_dev_ms = None
        if name in library:
            if not torch.equal(library[name](), plain_fn(big)):
                fail(f"torch.gt(out=int32) is not the function of the {name} kernel")
            library_ms = cuda_ms(library[name], iters=50)
            library_dev_ms = device_ms(library[name], iters=100)
        # bytes: the array in, the array out; about 3 operations an element
        bound_ms, by = bound(2 * tensor_bytes(big), 3 * big.numel())
        log(f"{name} kernel == twin at [8, 128] and [4096, 128], max_abs_err 0; at [4096, 128]: "
            f"kernel {ms:.4f} ms back to back, {ms_out:.4f} ms into a ready out, {fmt_ms(dev_ms)} on the device alone, "
            f"plain {plain:.4f} ms, bound {bound_ms:.5f} ms ({by}), " +
            ("no single library call computes it" if library_ms is None
             else f"torch.gt(out=int32) {library_ms:.4f} ms back to back, {fmt_ms(library_dev_ms)} on the device alone"))
        if name == "sum_bool":
            log(f"sum_bool is one cooperative kernel, equal to its twin also at {list(sum_bool_inputs)}; the memset "
                "and two kernels it replaced took 0.0277 ms back to back, 0.0244 into a ready out and 0.0059 on the "
                "device alone (PERF.md: an earlier run of this script, NVIDIA H100 80GB HBM3, 700.00 W)")
        results[name] = dict(max_abs_err=float(err), ms=ms, out_ms=ms_out, device_ms=dev_ms, plain_ms=plain,
                             bound_ms=bound_ms, bound_by=by, library_ms=library_ms,
                             library_device_ms=library_dev_ms)


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


def require_launches(path, launches, names=("scan", "probe_slots"), never=()):
    log(f"{path}: kernel launches {launches}")
    for name in names:
        if launches[name] == 0:
            fail(f"{path} never launched the {name} kernel")
    for name in never:
        if launches[name]:
            fail(f"{path} launched the {name} kernel, which is not of its kind of index")


@contextlib.contextmanager
def twins_forbidden():
    """While a run on the card goes, the kernels' plain twins fail the script
    if anything calls them."""
    from slacken_tpu_torch.ops import hitruns, lookup, minimizers

    def refuse(*args, **kwargs):
        fail("a kernel's plain twin was called on the card's path")

    names = ((minimizers, "window_minimizers"), (minimizers, "stitch_segments"), (lookup, "lookup_taxa"),
             (hitruns, "hit_runs_plain"),
             (lookup, "lookup_taxa_slots"), (lookup, "lookup_taxa_tiled"), (lookup, "lookup_taxa_hashed_rows"),
             (lookup, "lookup_taxa_hashed"), (lookup, "lookup_taxa_hashed_cols"), (lookup, "lookup_taxa_bucketed"))
    saved = [getattr(mod, name) for mod, name in names]
    for mod, name in names:
        setattr(mod, name, refuse)
    try:
        yield
    finally:
        for (mod, name), fn in zip(names, saved):
            setattr(mod, name, fn)


@contextlib.contextmanager
def hit_runs_on():
    """STPU_HIT_RUNS=1 while the block runs (per-read mode copies each row's
    hit runs in place of its dense window taxa); 0, as `main` sets it, after."""
    os.environ["STPU_HIT_RUNS"] = "1"
    try:
        yield
    finally:
        os.environ["STPU_HIT_RUNS"] = "0"


@contextlib.contextmanager
def count_runs_formatting():
    """While the block runs, counts of the calls of the native runs
    formatters: {"lines": output_lines_runs, "pairs": hit_lines_runs}. A
    batch with a row over the run cap formats through neither."""
    from slacken_tpu_torch import native

    calls = {"lines": 0, "pairs": 0}
    saved = native.output_lines_runs, native.hit_lines_runs

    def counted(key, fn):
        def wrapped(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapped

    native.output_lines_runs, native.hit_lines_runs = counted("lines", saved[0]), counted("pairs", saved[1])
    try:
        yield calls
    finally:
        native.output_lines_runs, native.hit_lines_runs = saved


def output_tree(prefix):
    """{path below <prefix>_c*: bytes} of a classify output, .gz inflated."""
    return {k: v for k, v in files_under(prefix).items() if k.startswith("_c")}


def files_under(prefix):
    """{what follows `prefix` in the path: bytes} of every file whose path
    starts with `prefix`, .gz inflated."""
    files = {}
    for root, _, names in os.walk(os.path.dirname(prefix)):
        for name in names:
            path = os.path.join(root, name)
            if path.startswith(prefix):
                with (gzip.open if name.endswith(".gz") else open)(path, "rb") as f:
                    files[path[len(prefix):]] = f.read()
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


def phase_bench(dev, out, results):
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
    require_launches("reports mode (3 runs)", launches, never=("scan_stitch",))  # rows of 128: a warp a row
    profile_run(lambda: cls.classify_and_write_packed(reads, os.path.join(out, "prof"), cpar), "reports mode")

    t0 = time.perf_counter()
    idx_cpu = KeyValueIndex.build(library(), params, tax, "cpu", keep_records=True)  # the sidecar: for classify2
    log(f"bench build on the CPU (plain twins, with the full-records sidecar): {idx_cpu.num_records} records, "
        f"{len(idx_cpu.record_taxa_t)} (key, taxon) pairs in {time.perf_counter() - t0:.1f} s")
    if not (np.array_equal(idx.keys, idx_cpu.keys) and np.array_equal(idx.taxa, idx_cpu.taxa)):
        fail("the card's bench index (no sidecar) differs from the CPU build with one")
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
    breakdown(cls, reads, cpar, results)
    return dict(idx=idx, idx_cpu=idx_cpu, reads=reads, n_reads=n_reads, cls=cls,
                reports_rate=n_reads / med, launches=launches)


#: the probe choice's tables and the kernels of each, (probe, wide) -> name
TABLE_PROBES = {("tiled", False): "probe_tiled", ("tiled", True): "probe_tiled_wide",
                ("hashed1", False): "probe_rows", ("hashed1", True): "probe_rows_wide",
                ("hashed", False): "probe_hashed", ("hashed128", False): "probe_hashed_cols",
                ("bucketed", False): "probe_bucketed"}
#: the probes of each kind of index in phase_probes
KIND_PROBES = {"narrow": ("tiled", "hashed1", "hashed", "hashed128", "bucketed"), "wide": ("tiled", "hashed1")}


def probe_table_bytes(table):
    return tensor_bytes(*(x for x in table if hasattr(x, "numel")))


def table_geometry(table):
    """A table's geometry and bytes, for the log."""
    from slacken_tpu_torch.ops import lookup

    if isinstance(table, lookup.TiledTable):
        return (f"router bits {table.bits} ({tensor_bytes(table.router)} bytes), tile {table.tile}, table "
                f"{tuple(table.table.shape)} ({tensor_bytes(table.table)} bytes)")
    if isinstance(table, lookup.HashedRows):
        return f"row_bits {table.row_bits}, tile {table.tile}, table {tuple(table.table.shape)}"
    if isinstance(table, lookup.HashedTable):
        return f"bits {table.bits}, tile {table.tile}, {table.slots} slots, table {tuple(table.table.shape)}"
    return (f"router bits {table.bits} ({tensor_bytes(table.router)} bytes), maxb {table.maxb}, keys and taxa "
            f"{tensor_bytes(table.keys, table.taxa)} bytes")


def build_tables(label, index, dev, probes=("tiled", "hashed1")):
    """The probe tables of an index for `probes`, built on the card by
    KeyValueIndex.device_arrays (which keeps them for the classifiers), each
    build timed; logs their geometry and bytes. Returns {probe: table}."""
    import torch

    tables = {}
    for probe in probes:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        table = index.device_arrays(dev, probe)[2]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        nb, n = probe_table_bytes(table), index.num_records
        log(f"{probe} table of the {label} ({n} records) built on the card in {secs:.4f} s: {table_geometry(table)}; "
            f"{nb} bytes, {nb / max(n, 1):.2f} bytes a record")
        tables[probe] = table
    return tables


def check_hashed_rules(label, table, keys):
    """A hashed table of `keys` (on the card) held to the JAX builders'
    rules: bits from max(12, ceil(log2 N) + 1) (hashed) or max(12, ceil(log2
    N)) (hashed128) up, the tile from 16 or 128 up, every key within tile -
    1 slots of its home slot at these bits and tile, max_pos // tile + 3
    rows, N slots holding a taxon and every other slot free (all ones)."""
    import torch

    from slacken_tpu_torch.ops import lookup

    keys = keys.to(table.table.device)
    n, rows, tile = keys.shape[0], table.table.shape[0], table.tile
    first = max(12, int(np.ceil(np.log2(max(n, 2)))) + (0 if table.cols else 1))
    least = lookup.HASHED_COLS_TILE if table.cols else lookup.HASHED_TILE
    scrambled, _, pos, _, _ = lookup._parked(keys, torch.zeros(n, dtype=torch.int32, device=keys.device), tile,
                                             table.bits, 0)
    lanes = table.table.view(rows, 3, tile).transpose(1, 2) if table.cols else table.table
    lanes = lanes.reshape(-1, 3)
    disp = int((pos - lookup._top_bits(scrambled, table.bits)).max()) if n else 0
    if not (table.bits >= first and tile >= least and disp <= tile - 1 and rows == (int(pos[-1]) if n else 0) // tile + 3
            and int((lanes[:, 2] != -1).sum()) == n and int((lanes == -1).all(1).sum()) == rows * tile - n):
        fail(f"the {label}'s {'hashed128' if table.cols else 'hashed'} table breaks the JAX builders' rules")
    return disp


def router_bucket(table, queries):
    """(inside, p) of queries into a tiled or bucketed table: whether each
    lies inside the key space that its router cuts, and its bucket there (0
    elsewhere); as lookup.router_buckets, which an older tree (a `--root` of
    scan_timing.py) lacks."""
    import torch

    from slacken_tpu_torch.ops import lookup

    shift = table.key_bits - table.bits
    if queries.dim() == 2:
        p, above = lookup.prefix_wide(queries, shift)
        inside = (queries[:, 0] >= 0) & (above == 0) & (p >= 0) & (p < 1 << table.bits)
    else:
        p = queries >> shift
        inside = (queries >= 0) & (p < 1 << table.bits)
    return inside, torch.where(inside, p, 0)


def time_table_probe(label, table, keys, taxa, queries, name, with_floor=True):
    """A table kernel == its twin == lookup_taxa (tolerance 0) on these
    queries, then its time beside the twin's and, for the tiled and the
    bucketed probe of narrow keys, torch.searchsorted's (the directory
    probe's yardstick, `library_ms`). A row-major hashed table gets
    `yardstick_device_ms`: the device time alone of one torch.index_select
    of each query's home-slot lanes ([Q, 3], the homes computed before), a
    generic gather of one scattered 12-byte read a query; it computes
    another function than the kernel, so it is no `library_ms`. Both hashed
    layouts get `floor_device_ms`: the device time alone of
    cuda_kernels.hashed_floor_cuda (held to lookup.home_sectors first), one
    aligned 32-byte sector a non-negative query at its home slot, what no
    hashed probe can beat; a narrow hashed1 table gets that of
    cuda_kernels.rows_floor_cuda (held to lookup.guess_sectors first), the
    8 hi' lanes a non-negative query from its guessed lane; a tiled table,
    narrow or wide, that of cuda_kernels.tiled_floor_cuda (held to
    lookup.router_sectors first), a query's router entries and then the
    sector of its bucket's first record; bucketed arrays that of
    cuda_kernels.bucketed_floor_cuda (held to lookup.bucket_sectors first),
    a query's router entries and then the sector of keys at its guessed
    key. A floor is neither a library call
    nor a yardstick of the same function; `with_floor` False leaves it out
    (a tree older than its kernel). The bound counts what these queries
    need: each query and its answer, and once for each distinct query
    inside the key space: tiled, its two router entries and one record if
    its bucket is not empty; bucketed, its two router entries if its
    bucket is empty, else a router entry and a key, and a taxon if it hits;
    hashed1, once for
    each distinct query that the kernel walks (narrow, a non-negative one;
    wide, one whose l3 is not all ones), one 32-byte sector of the row's
    first key block and, on a hit, one sector of each other key block and of
    the taxa; hashed and hashed128, the home slot of each distinct
    non-negative query once (12 bytes; the taxon lane only on a hit in the
    column blocks). Returns one entry of the kernel's `shapes`."""
    import torch

    from slacken_tpu_torch.ops import cuda_kernels, lookup

    keys, taxa = keys.to(queries.device), taxa.to(queries.device)  # the host's, where a slot table holds the card's
    wide = queries.dim() == 2
    twin = {lookup.TiledTable: lookup.lookup_taxa_tiled, lookup.HashedRows: lookup.lookup_taxa_hashed_rows,
            lookup.HashedTable: lookup.lookup_taxa_hashed, lookup.Bucketed: lookup.lookup_taxa_bucketed}[type(table)]
    before = cuda_kernels.LAUNCHES[name]
    got = lookup.probe(None, None, table, queries)
    if cuda_kernels.LAUNCHES[name] != before + 1:
        fail(f"the {name} probe of {label} did not launch its kernel")
    want = lookup.lookup_taxa(keys, taxa, queries)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    plain_out = twin(table, queries)  # one call, timed: the twin takes 0.04-0.4 s at these sizes
    end.record()
    torch.cuda.synchronize()
    plain = start.elapsed_time(end)
    err = max(int((got - want).abs().max()), int((plain_out - want).abs().max()))
    if err:
        fail(f"{name} differs from its twin or lookup_taxa on {label} (max abs err {err})")
    run = lambda: lookup.probe(None, None, table, queries)  # noqa: E731
    ms, dev_ms = cuda_ms(run), device_ms(run)
    routered = isinstance(table, (lookup.TiledTable, lookup.Bucketed))
    library = cuda_ms(lambda: torch.searchsorted(keys, queries)) if routered and not wide else None
    yardstick = floor = None
    if isinstance(table, lookup.HashedTable) and not table.cols:
        homes = lookup._top_bits(lookup.xorshift64(queries), table.bits).clamp(max=table.slots - 1)
        slot_lanes = table.table.view(-1, 3)
        yardstick = device_ms(lambda: torch.index_select(slot_lanes, 0, homes))
    if with_floor and isinstance(table, lookup.HashedTable):
        if not torch.equal(cuda_kernels.hashed_floor_cuda(table, queries), lookup.home_sectors(table, queries)):
            fail(f"the hashed floor kernel differs from lookup.home_sectors on {label}")
        floor = device_ms(lambda: cuda_kernels.hashed_floor_cuda(table, queries))
    if with_floor and isinstance(table, lookup.TiledTable):
        if not torch.equal(cuda_kernels.tiled_floor_cuda(table, queries), lookup.router_sectors(table, queries)):
            fail(f"the tiled floor kernel differs from lookup.router_sectors on {label}")
        floor = device_ms(lambda: cuda_kernels.tiled_floor_cuda(table, queries))
    if with_floor and isinstance(table, lookup.Bucketed):
        if not torch.equal(cuda_kernels.bucketed_floor_cuda(table, queries), lookup.bucket_sectors(table, queries)):
            fail(f"the bucketed floor kernel differs from lookup.bucket_sectors on {label}")
        floor = device_ms(lambda: cuda_kernels.bucketed_floor_cuda(table, queries))
    if with_floor and isinstance(table, lookup.HashedRows) and not wide:
        if not torch.equal(cuda_kernels.rows_floor_cuda(table, queries), lookup.guess_sectors(table, queries)):
            fail(f"the row probe's floor kernel differs from lookup.guess_sectors on {label}")
        floor = device_ms(lambda: cuda_kernels.rows_floor_cuda(table, queries))
    at = {lookup.HashedRows: "at its guessed lane", lookup.TiledTable: "after its router entries",
          lookup.Bucketed: "at its guessed key after its router entries"}.get(type(table), "at its home slot")
    nq, hits, q_bytes = queries.shape[0], int((want > 0).sum()), 16 if wide else 8
    if routered:  # each distinct query inside the key space, once
        seen = torch.unique(queries[router_bucket(table, queries)[0]], dim=0)
        p = router_bucket(table, seen)[1]
        filled = int((table.router[p + 1] > table.router[p]).sum())
        if isinstance(table, lookup.Bucketed):  # empty: two router entries; else one and a key, a taxon on a hit
            found = int((lookup.lookup_taxa(keys, taxa, seen) > 0).sum())
            need = (q_bytes + 4) * nq + 8 * (seen.shape[0] - filled) + 12 * filled + 4 * found
        else:
            need = (q_bytes + 4) * nq + 8 * seen.shape[0] + table.table.shape[2] * 4 * filled
    elif isinstance(table, lookup.HashedTable):  # the slot of each distinct non-negative query, once
        seen = torch.unique(queries[queries >= 0])
        need = 12 * nq + (8 * seen.numel() + 4 * int((lookup.lookup_taxa(keys, taxa, seen) > 0).sum())
                          if table.cols else 12 * seen.numel())
    else:  # each distinct query walked, once; nothing for a negative query (narrow) or an all-ones l3 (wide)
        seen = torch.unique(queries[(queries[:, 0] >> 32) != -1] if wide else queries[queries >= 0], dim=0)
        found = int((lookup.lookup_taxa(keys, taxa, seen) > 0).sum())
        need = (q_bytes + 4) * nq + 32 * seen.shape[0] + (4 if wide else 2) * 32 * found
    n_bytes = min(tensor_bytes(queries, *(x for x in table if hasattr(x, "numel"))) + 4 * nq, need)
    bound_ms, by = bound(n_bytes, (16 if wide else 8) * nq if routered else (32 if wide else 16) * nq)
    log(f"{name}, {label}: {keys.shape[0]} keys ({table_geometry(table)}), {nq} queries, {hits} hits, max_abs_err 0 "
        f"against the twin and lookup_taxa; kernel {ms:.4f} ms ({fmt_ms(dev_ms)} on the device alone), plain twin "
        f"{plain:.4f} ms, " + ("no library call, " if library is None else f"torch.searchsorted alone {library:.4f} ms, ")
        + ("" if yardstick is None else f"yardstick: torch.index_select of the home slots {fmt_ms(yardstick)} on the "
           "device alone, ")
        + ("" if floor is None else f"floor: one sector a query {at} {fmt_ms(floor)} on the device alone, ")
        + f"bound {bound_ms:.4f} ms ({by}, {n_bytes / 1e6:.1f} MB)")
    return dict(max_abs_err=float(err), ms=ms, device_ms=dev_ms, plain_ms=plain, bound_ms=bound_ms, bound_by=by,
                library_ms=library, **({} if yardstick is None else {"yardstick_device_ms": yardstick}),
                **({} if floor is None else {"floor_device_ms": floor}))


def phase_probes(dev, out, bench, results):
    """The probe choice (--probe tiled, hashed1, hashed, hashed128 and
    bucketed) at bench size, with the twins forbidden on its main path: the
    five tables of the narrow bench index and the tiled and hashed1 tables
    of the wide (50, 45, 7) bench index built on the card (build time,
    bytes; the geometry held to the JAX builders' rules, and the hashed
    tables and bucketed arrays equal to the CPU's builds);
    classify_and_write_packed of the bench reads with each probe in reports
    and per-read mode (narrow) and reports mode (wide), every file equal to
    the routed run's; the CLI's classify2 --probe hashed1 against --probe
    routed; MeshClassifier over Mesh([cuda] * 8) with tiled and with hashed,
    ring and replicated; the CLI's classify --coordinator --num-processes 1
    with --probe hashed1 and with --probe hashed, one rank under NCCL,
    against the single-device CLI. Before that each of the seven kernels
    against its twin and lookup_taxa on one batch's dense minimizers and on
    4,194,304 random queries, timed. Returns the main path's launch counts."""
    import torch

    from slacken_tpu_torch import cli, workloads
    from slacken_tpu_torch.classify import Classifier, ClassifyParams
    from slacken_tpu_torch.index import IndexParams, KeyValueIndex
    from slacken_tpu_torch.ops import cuda_kernels, lookup
    from slacken_tpu_torch.parallel.classifier import MeshClassifier
    from slacken_tpu_torch.parallel.mesh import Mesh

    t_phase = time.perf_counter()
    idx, reads, n_reads = bench["idx"], bench["reads"], bench["n_reads"]
    modes = {"rep": ClassifyParams(thresholds=[0.0, 0.15], per_read_output=False),
             "det": ClassifyParams(thresholds=[0.0, 0.15], per_read_output=True)}
    tax = workloads.bench_taxonomy()
    genomes = list(workloads.bench_library(np.random.default_rng(workloads.BENCH_SEED)))
    t0 = time.perf_counter()
    wide = KeyValueIndex.build(iter(genomes), IndexParams(k=50, m=45, spaces=7), tax, dev)
    log(f"probes: wide (50, 45, 7) bench index built on the card, {wide.num_records} records in "
        f"{time.perf_counter() - t0:.3f} s")
    tables = {"narrow": build_tables("bench index", idx, dev, KIND_PROBES["narrow"]),
              "wide": build_tables("wide (50, 45, 7) bench index", wide, dev, KIND_PROBES["wide"])}
    narrow = tables["narrow"]
    if (narrow["hashed1"].row_bits, probe_table_bytes(narrow["hashed1"])) != (15, 50_331_648) or (
            narrow["tiled"].bits, probe_table_bytes(narrow["tiled"])) != (23, 33_554_436 + 31_476_864):
        fail("the bench index's tables are not of the geometry that the JAX builders' rules give")
    bucketed = narrow["bucketed"]
    if (bucketed.bits, bucketed.router.shape[0], bucketed.n, bucketed.maxb) != (
            23, (1 << 23) + 1, BENCH_RECORDS, lookup.max_bucket_span(bucketed.router)):
        fail("the bench index's bucketed arrays are not of the geometry that the JAX builders' rules give")
    cpu_keys, cpu_taxa = bench["idx_cpu"].keys_t, bench["idx_cpu"].taxa_t
    for probe, build in (("hashed", lookup.build_hashed), ("hashed128", lookup.build_hashed_cols),
                         ("bucketed", lambda k, t: lookup.build_bucketed(k, t, idx.key_bits))):
        disp = check_hashed_rules("bench index", narrow[probe], idx.keys_t) if probe != "bucketed" else None
        host = build(cpu_keys, cpu_taxa)
        if not all(torch.equal(a, b.cpu()) if isinstance(a, torch.Tensor) else a == b
                   for a, b in zip(host, narrow[probe])):
            fail(f"the bench index's {probe} table built on the card differs from the CPU's build")
        log(f"probes: the {probe} table of the bench index equals the CPU's build" +
            ("" if disp is None else f"; largest displacement {disp} of tile {narrow[probe].tile}"))
    del tables, narrow, bucketed
    routed = Classifier(wide, dev)
    routed.classify_and_write_packed(reads, os.path.join(out, "probes_w_routed_rep"), modes["rep"])
    Classifier(idx, dev).classify_and_write_packed(reads, os.path.join(out, "probes_routed_det"), modes["det"])
    want = {("narrow", "rep"): output_tree(os.path.join(out, "gpu")),
            ("narrow", "det"): output_tree(os.path.join(out, "probes_routed_det")),
            ("wide", "rep"): output_tree(os.path.join(out, "probes_w_routed_rep"))}

    # files for the CLI runs: the library, the base index with its sidecar, the reads of two genomes, 8 shard files
    lib_dir, c2idx, idx8 = (os.path.join(out, x) for x in ("probes_lib", "probes_c2idx", "probes_idx8"))
    workloads.write_library(genomes, lib_dir)
    bench["idx_cpu"].save(c2idx)
    idx.save_sharded(idx8, MH_SHARDS)
    fastq = os.path.join(out, "probes_reads.fastq")
    workloads.write_fastq([p for i, p in enumerate(reads) if i % 3 != 2], fastq)
    c2 = ["classify2", fastq, "-i", c2idx, "-l", lib_dir, "-c", "0.0", "-D", "500"]
    one = ["classify", fastq, "-i", idx8, "-c", "0.0", "0.15", "--no-detailed"]
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
        for argv, o in ((c2, "probes_c2_routed"), (one, "probes_cli_routed")):
            if cli.main([*argv, "-o", os.path.join(out, o, "o")]) != 0:
                fail(f"the CLI failed: {argv}")

    batch = {"narrow": batch_queries(bench["cls"], reads)[2].minimizer.reshape(-1),
             "wide": batch_queries(routed, reads)[2].minimizer.flatten(0, 1)}
    rand = {"narrow": narrow_random_queries(dev, idx, BENCH_RECORDS),
            "wide": random_wide_queries(dev, wide.keys_t, 1 << 22, BENCH_RECORDS)}
    for kind, index in (("narrow", idx), ("wide", wide)):  # the kernels against their twins, before the main path
        label = "bench index" if kind == "narrow" else "wide bench index (50, 45, 7)"
        for probe in KIND_PROBES[kind]:
            table = index.device_arrays(dev, probe)[2]
            name = TABLE_PROBES[probe, kind == "wide"]
            shapes = {}
            for what, q in (("one batch's dense minimizers", batch[kind]), ("random queries", rand[kind])):
                shapes[f"{label}, {what}"] = time_table_probe(f"{label}, {what}", table, index.keys_t,
                                                              index.taxa_t, q, name)
            results[name] = dict(shapes[f"{label}, one batch's dense minimizers"], shapes=shapes)

    cuda_kernels.reset_launch_counts()
    walls = {}
    with twins_forbidden():
        for kind, index in (("narrow", idx), ("wide", wide)):
            for probe in KIND_PROBES[kind]:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                cls = Classifier(index, dev, probe=probe)
                torch.cuda.synchronize()
                setup = time.perf_counter() - t0
                for mode in ("rep", "det") if kind == "narrow" else ("rep",):
                    tag = f"probes_{kind}_{probe}_{mode}"
                    cls.classify_and_write_packed(reads, os.path.join(out, tag + "_warm"), modes[mode])
                    walls[kind, probe, mode] = timed_runs(
                        lambda r: cls.classify_and_write_packed(reads, os.path.join(out, tag), modes[mode]), n=1)[0]
                    if output_tree(os.path.join(out, tag)) != want[kind, mode]:
                        fail(f"{kind} classify with --probe {probe} ({mode}) differs from the routed run's files")
                log(f"probes: {kind} bench classify with probe={probe}: files equal to the routed run's; table and "
                    f"classifier set-up {setup:.3f} s; " + ", ".join(
                        f"{mode} {n_reads / w:.1f} reads/s" for (k, p, mode), w in walls.items()
                        if (k, p) == (kind, probe)) + " (one warm run each)")
                del cls
        for probe in ("tiled", "hashed"):
            for layout in ("ring", "replicated"):
                tag = f"probes_mesh_{probe}_{layout}"
                MeshClassifier(idx, Mesh([dev] * MESH_SHARDS), layout, probe=probe).classify_and_write_packed(
                    reads, os.path.join(out, tag), modes["rep"])
                if output_tree(os.path.join(out, tag)) != want["narrow", "rep"]:
                    fail(f"MeshClassifier {layout} with the {probe} probe differs from the routed run's files")
        log(f"probes: MeshClassifier over Mesh([{dev}] * {MESH_SHARDS}) with probe=tiled and probe=hashed, ring and "
            "replicated: kreports equal to the single-device routed run's")
        with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
            for argv, o in (([*c2, "--probe", "hashed1"], "probes_c2_hashed1"),
                            *(([*one, "--coordinator", f"127.0.0.1:{free_port()}", "--num-processes", "1",
                                "--process-id", "0", "--probe", p], f"probes_cli_mh_{p}") for p in ("hashed1", "hashed"))):
                if cli.main([*argv, "-o", os.path.join(out, o, "o")]) != 0:
                    fail(f"the CLI failed: {argv}")
        if torch.distributed.is_initialized():
            fail("the CLI's process group outlived its run")
    launches = dict(cuda_kernels.LAUNCHES)
    for a, b in (("probes_c2_hashed1", "probes_c2_routed"), ("probes_cli_mh_hashed1", "probes_cli_routed"),
                 ("probes_cli_mh_hashed", "probes_cli_routed")):
        got, ref = files_under(os.path.join(out, a, "")), files_under(os.path.join(out, b, ""))
        if got != ref or len(ref) < 2:
            fail(f"the CLI's {a} differs from {b} ({sorted(got)} against {sorted(ref)})")
    log("probes: classify2 --probe hashed1 (taxon set, kreport, per-read lines) and classify --coordinator "
        "--num-processes 1 with --probe hashed1 and --probe hashed (one rank under NCCL) equal to their --probe "
        "routed runs")
    require_launches("probes: the probe choice's runs", launches, ("scan", "scan_wide", *TABLE_PROBES.values()))
    log(f"phase_probes: {time.perf_counter() - t_phase:.1f} s")
    return launches


def phase_probes_scale(dev, out, results, genomes, scale_idx):
    """The probe choice at scale: the tiled, hashed1, hashed and hashed128
    tables and the bucketed arrays of the 400 Mbp index built on the card
    (build time, bytes; the hashed tables held to the JAX builders' rules),
    the 200,000 scale reads classified with each probe (reports mode; the
    kreport equal to phase_scale's routed one), and the five kernels against
    their twins on 4,194,304 random queries and on one batch's dense
    minimizers, timed. Returns the classify runs' launch counts."""
    import torch

    from slacken_tpu_torch import workloads
    from slacken_tpu_torch.classify import Classifier, ClassifyParams
    from slacken_tpu_torch.ops import cuda_kernels

    t_phase = time.perf_counter()
    idx = scale_idx.with_records(scale_idx.keys_t, scale_idx.taxa_t)  # its tables go with it
    tables = build_tables("scale index", idx, dev, ("tiled", "hashed1", "hashed", "hashed128", "bucketed"))
    for probe in ("hashed", "hashed128"):
        disp = check_hashed_rules("scale index", tables[probe], idx.keys_t)
        log(f"probes: the {probe} table of the scale index keeps the JAX builders' rules; largest displacement "
            f"{disp} of tile {tables[probe].tile}")
    reads = workloads.scale_reads(SCALE_BP, SCALE_TAXA, library=genomes)
    n_reads = sum(len(p) for p in reads)
    cpar = ClassifyParams(thresholds=[0.0], per_read_output=False)
    want = open(os.path.join(out, "scale_c0.0", "all_kreport.txt"), "rb").read()
    rand = narrow_random_queries(dev, idx, SCALE_RECORDS + 1)
    total = {}
    for probe, table in tables.items():
        cls = Classifier(idx, dev, probe=probe)
        cls.classify_and_write_packed(reads[:1], os.path.join(out, f"probes_scale_{probe}_warm"), cpar)
        cuda_kernels.reset_launch_counts()
        with twins_forbidden():
            dt = timed_runs(lambda r: cls.classify_and_write_packed(reads, os.path.join(out, f"probes_scale_{probe}"),
                                                                    cpar), n=1)[0]
        add_launches(total, cuda_kernels.LAUNCHES)
        if open(os.path.join(out, f"probes_scale_{probe}_c0.0", "all_kreport.txt"), "rb").read() != want:
            fail(f"the scale classify with probe={probe} differs from the routed kreport")
        log(f"probes: scale classify with probe={probe}: {n_reads} reads in {dt:.3f} s, {n_reads / dt:.1f} reads/s "
            f"(routed: {n_reads / WALLS['scale']:.1f}); kreport equal to the routed one")
        name = TABLE_PROBES[probe, False]
        for what, q in (("random queries", rand), ("one batch's dense minimizers",
                                                   batch_queries(cls, reads)[2].minimizer.reshape(-1))):
            results[name]["shapes"][f"scale index, {what}"] = time_table_probe(
                f"scale index, {what}", table, idx.keys_t, idx.taxa_t, q, name)
        del cls
    del idx, tables, table
    torch.cuda.empty_cache()
    require_launches("probes at scale", total, ("scan", "probe_tiled", "probe_rows", "probe_hashed",
                                                "probe_hashed_cols", "probe_bucketed"))
    log(f"phase_probes_scale: {time.perf_counter() - t_phase:.1f} s")
    return total


#: the hit-runs kernel's checks besides the bench batch: (rows, width, k,
#: paired) of workloads.hit_runs_rows (every fourth row over the cap, N runs
#: of k to 2k, padding rows), a paired batch of the bench's pairs' width, long
#: buckets up to the widest row the reduction takes, and wide k
HIT_RUNS_CASES = [(32768, 128, 35, False), (16384, 264, 35, True), (64, 4096, 35, True), (8, 32768, 35, False),
                  (3, 65528, 35, True), (8192, 128, 50, False), (4096, 264, 120, True)]


def bench_batch(cls, reads):
    """The bench's first full per-read batch on the card: (window taxa
    [rows, 128] int32, validity bits, splits, row lengths), as the
    classifier's dispatch makes them."""
    from slacken_tpu_torch import to_device
    from slacken_tpu_torch.ops import encode

    rows = cls._rows_target(128)
    codes = np.concatenate([p.codes for p in reads])[:rows]
    lens = np.concatenate([p.lengths for p in reads])[:rows].astype(np.int32)
    if codes.shape != (rows, 128):
        fail(f"the bench's reads make a batch of {codes.shape}, expected [{rows}, 128]")
    packed, valid = encode.pack_2bit(codes)
    valid_dev = to_device(valid, cls.device)
    _, wt = cls._classify_packed_rows(packed, valid, np.zeros(rows, np.int32), 128, valid_dev)
    return wt, valid_dev, to_device(np.full(rows, -1, np.int32), cls.device), to_device(lens, cls.device)


#: the hit-runs shapes timed beside the bench batch: (label, index into
#: HIT_RUNS_CASES) of the N-heavy batch (every fourth row over the cap) and
#: a long-row bucket
HIT_RUNS_TIMED = [("N-heavy batch", 0), ("long rows", 2)]


def time_hit_runs(args, k, cap):
    """hit_runs_cuda on these inputs: back to back (CUDA events) and alone
    (torch.profiler), its bound (each input once, the bundle once), and its
    floor alone (cuda_kernels.hit_runs_floor_cuda: the same loads and writes,
    no scan) where the tree has one."""
    import torch

    from slacken_tpu_torch.ops import cuda_kernels, hitruns

    wt = args[0]
    run = lambda: cuda_kernels.hit_runs_cuda(*args, k, cap)  # noqa: E731
    out = torch.empty((wt.shape[0], hitruns.bundle_width(cap)), dtype=torch.int32, device=wt.device)
    n_bytes = tensor_bytes(*args, out)
    # about 20 integer operations a window position: compares, ballots, shuffles, popcounts
    bound_ms, by = bound(n_bytes, 20 * wt.numel())
    r = dict(ms=cuda_ms(run), device_ms=device_ms(run), bound_ms=bound_ms, bound_by=by, bytes=n_bytes)
    if hasattr(cuda_kernels, "hit_runs_floor_cuda"):
        r["floor_device_ms"] = device_ms(lambda: cuda_kernels.hit_runs_floor_cuda(*args, cap))
    return r


def fmt_hit_runs(label, r):
    share = "" if r["device_ms"] is None else f", {100 * r['bound_ms'] / r['device_ms']:.1f}% of it alone"
    floor = f"; floor {fmt_ms(r['floor_device_ms'])} alone" if "floor_device_ms" in r else ""
    return (f"{label}: kernel {r['ms']:.4f} ms back to back, {fmt_ms(r['device_ms'])} alone, bound "
            f"{r['bound_ms']:.5f} ms ({r['bound_by']}, {r['bytes']} bytes){share}{floor}")


def check_hit_runs(dev, results, bench):
    """The hit-runs kernel == its twin (max_abs_err 0) on the bench batch's
    window taxa, on HIT_RUNS_CASES and on the hand-made edge rows, at the
    default cap, at 4 (more rows over it) and at 48; timed alone and back to
    back with its bound and floor at the bench batch (caps 16 and 4), the
    N-heavy batch and a long-row bucket; the twin, and the bundle's
    device-to-host copy beside the dense one's, at the bench batch."""
    import torch

    from slacken_tpu_torch import workloads
    from slacken_tpu_torch.ops import cuda_kernels, hitruns

    cap, k = hitruns.DEFAULT_RUNS_PER_ROW, bench["idx"].params.k
    batch = bench_batch(bench["cls"], bench["reads"])
    cases = {f"bench batch {list(batch[0].shape)} (the classifier's window taxa)": (batch, k)}
    for i, (rows, width, kk, paired) in enumerate(HIT_RUNS_CASES):
        label = f"[{rows}, {width}] k={kk}{' paired' if paired else ''} (workloads.hit_runs_rows)"
        arrays = workloads.hit_runs_rows(1900 + i, rows, width, kk, paired)
        cases[label] = ([torch.from_numpy(a).to(dev) for a in arrays], kk)
    for width, kk in workloads.HIT_RUNS_EDGE_SHAPES:
        arrays = workloads.hit_runs_edge_rows(width, kk, seed=width + kk)
        cases[f"edge rows [{arrays[0].shape[0]}, {width}] k={kk} (workloads.hit_runs_edge_rows)"] = (
            [torch.from_numpy(a).to(dev) for a in arrays], kk)
    err, over = 0, {}
    for label, (args, kk) in cases.items():
        for c in (cap, 4, 48):
            got, want = cuda_kernels.hit_runs_cuda(*args, kk, c), hitruns.hit_runs_plain(*args, kk, c)
            torch.cuda.synchronize()
            if got.shape != want.shape:
                fail(f"hit_runs kernel returns {tuple(got.shape)} at {label}, its twin {tuple(want.shape)}")
            err = max(err, int((got.long() - want.long()).abs().max()))
            if err:
                fail(f"hit_runs kernel differs from its twin at {label}, cap {c} (max abs err {err})")
            over[(label, c)] = int((got[:, -3] > c).sum())
    log("hit_runs kernel == twin, max_abs_err 0, caps 16, 4 and 48, at " + "; ".join(
        f"{label}: {over[(label, cap)]} rows over cap {cap}, {over[(label, 4)]} over cap 4" for label in cases))
    if not any(over[(label, cap)] for label in cases):
        fail("no hit_runs check had a row over the cap")
    labels = list(cases)
    args = cases[labels[0]][0]
    wt = args[0]
    out = torch.empty((wt.shape[0], hitruns.bundle_width(cap)), dtype=torch.int32, device=dev)
    one_launch(lambda: cuda_kernels.hit_runs_cuda(*args, k, cap), "hit_runs")
    r = time_hit_runs(args, k, cap)
    plain = cuda_ms(lambda: hitruns.hit_runs_plain(*args, k, cap), iters=5, warmup=1)
    bundle_host = torch.empty(out.shape, dtype=torch.int32, pin_memory=True)
    dense_host = torch.empty(wt.shape, dtype=torch.int32, pin_memory=True)
    d2h_bundle = cuda_ms(lambda: bundle_host.copy_(out, non_blocking=True))
    d2h_dense = cuda_ms(lambda: dense_host.copy_(wt, non_blocking=True))
    log(fmt_hit_runs(f"hit_runs at the bench batch [{wt.shape[0]}, {wt.shape[1]}], cap {cap}", r) +
        f"; plain {plain:.4f} ms; no single PyTorch call computes it; device-to-host copy of the bundle "
        f"({tensor_bytes(out)} bytes) {d2h_bundle:.4f} ms, of the dense window taxa ({tensor_bytes(wt)} bytes) "
        f"{d2h_dense:.4f} ms")
    shapes = {"bench batch, cap 4": time_hit_runs(args, k, 4)}
    for name, i in HIT_RUNS_TIMED:
        shapes[f"{name} {labels[1 + i]}, cap {cap}"] = time_hit_runs(*cases[labels[1 + i]], cap)
    for label, t in shapes.items():
        log(fmt_hit_runs(f"hit_runs at the {label}", t))
    results["hit_runs"] = dict(max_abs_err=float(err), plain_ms=plain, library_ms=None, **r, d2h_bundle_ms=d2h_bundle,
                               d2h_dense_ms=d2h_dense, shapes=shapes)


def phase_detailed(dev, out, bench):
    """Per-read mode on the bench reads: card against CPU, and against
    reports mode's kreports; then under STPU_HIT_RUNS=1, each file
    byte-identical to the dense run's and the CPU's."""
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
    require_launches("per-read mode (3 runs)", launches, never=("scan_stitch", "hit_runs"))
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
    with hit_runs_on():
        runs = Classifier(bench["idx"], dev)
    runs.classify_and_write_packed(reads, os.path.join(out, "hr"), cpar)  # warm
    cuda_kernels.reset_launch_counts()
    with twins_forbidden(), count_runs_formatting() as calls:
        runs_times = timed_runs(lambda r: runs.classify_and_write_packed(reads, os.path.join(out, f"hr{r}"), cpar))
    counts = dict(cuda_kernels.LAUNCHES)
    require_launches("per-read mode, STPU_HIT_RUNS=1 (3 runs)", counts, names=("scan", "probe_slots", "hit_runs"),
                     never=("scan_stitch",))
    add_launches(launches, counts)
    for run in ["hr", "hr0", "hr1", "hr2"]:
        if output_tree(os.path.join(out, run)) != want:
            fail(f"per-read output under STPU_HIT_RUNS=1 ({run}) differs from the dense run's and the CPU's")
    log(f"per-read files under STPU_HIT_RUNS=1 byte-identical to the dense run's and the CPU's; of "
        f"{counts['hit_runs']} batches, {calls['lines']} formatted whole by native.output_lines_runs, "
        f"{calls['pairs']} through the pairs path (native.hit_lines_runs: a row over the run cap)")
    for name, ts in (("dense", times), ("hit runs", runs_times)):
        log(f"per-read wall, {name}: runs {[round(t, 4) for t in ts]} s, median {statistics.median(ts):.4f} s "
            f"(spread {max(ts) - min(ts):.4f} s), {n_reads / statistics.median(ts):.1f} reads/s, "
            f"{statistics.median(ts) / statistics.median(times):.3f} of dense")
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
    require_launches("paired CLI", launches, never=("hit_runs",))
    with hit_runs_on(), twins_forbidden():
        cuda_kernels.reset_launch_counts()
        t0 = time.perf_counter()
        if cli.main([*common, "-o", os.path.join(out, "pairhr")]) != 0:
            fail("the paired classify CLI failed on the card under STPU_HIT_RUNS=1")
        dt_runs = time.perf_counter() - t0
        counts = dict(cuda_kernels.LAUNCHES)
    require_launches("paired CLI, STPU_HIT_RUNS=1", counts, names=("scan", "probe_slots", "hit_runs"))
    add_launches(launches, counts)
    t0 = time.perf_counter()
    if cli.main([*common, "-o", os.path.join(out, "paircpu"), "--device", "cpu"]) != 0:
        fail("the paired classify CLI failed on the CPU")
    log(f"paired CLI: {PAIRS} pairs, {dt:.2f} s on the card incl. index load and kernel "
        f"warm-up, {time.perf_counter() - t0:.1f} s on the CPU")
    got, want = output_tree(os.path.join(out, "pair")), output_tree(os.path.join(out, "paircpu"))
    if got != want or len(got) != 4:
        fail("paired per-read output differs between the card and the CPU")
    if output_tree(os.path.join(out, "pairhr")) != want:
        fail("paired per-read output under STPU_HIT_RUNS=1 differs from the dense run's and the CPU's")
    log(f"paired CLI under STPU_HIT_RUNS=1: {dt_runs:.2f} s on the card, files byte-identical to the dense run's")
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


#: the fuzz phase's seeds, each run under every (probe, wide) choice (the
#: j-th choice adds 1000 * j, so that no two choices share a draw)
FUZZ_SEEDS = range(20261018, 20261018 + 40)
#: the kernels that the fuzz phase must launch: both scans, every probe
#: kernel of the nine choices, and hit runs
FUZZ_KERNELS = ("scan", "scan_wide", "probe_slots", "probe_wide", "probe_tiled", "probe_tiled_wide", "probe_rows",
                "probe_rows_wide", "probe_hashed", "probe_hashed_cols", "probe_bucketed", "hit_runs")


def phase_fuzz(dev, out):
    """The oracle fuzz harness on the card: each of FUZZ_SEEDS under each of
    the nine (probe, wide) choices of fuzz.CHOICES, (k, m) drawn narrow or
    wide to match, with the kernels' plain twins refused. The first read
    that differs from the oracle prints the harness's JSON repro and fails.
    Returns the launch counts."""
    import torch

    from slacken_tpu_torch import fuzz
    from slacken_tpu_torch.ops import cuda_kernels

    where = os.path.join(out, "fuzz")
    os.makedirs(where, exist_ok=True)
    iterations = checks = comparisons = 0
    cuda_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with twins_forbidden():
        for j, (probe, wide) in enumerate(fuzz.CHOICES):
            for seed in (s + 1000 * j for s in FUZZ_SEEDS):
                try:
                    r = fuzz.fuzz_iteration(iterations, seed, dev, probe, wide, out=where)
                except fuzz.FuzzMismatch as e:
                    log(json.dumps(e.repro))
                    fail(f"fuzz: seed {seed} with the {'wide' if wide else 'narrow'} {probe} probe differs from "
                         "the oracle (repro above)")
                iterations += 1
                checks += r["checks"]
                comparisons += r["comparisons"]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(cuda_kernels.LAUNCHES)
    shutil.rmtree(where, ignore_errors=True)
    log(f"fuzz: {iterations} iterations ({len(FUZZ_SEEDS)} seeds x {len(fuzz.CHOICES)} probe choices), "
        f"{checks} read-threshold checks ({comparisons} comparisons), 0 mismatches, {dt:.2f} s on the card")
    require_launches("fuzz", launches, FUZZ_KERNELS)
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
    """Where one warm run of fn (classify in `mode`) spends its time: the
    main thread's leading host functions, after one plain run."""
    fn()
    host_profile(fn, f"one classify run, {mode}")


def host_profile(fn, what, top_n=6):
    """The main thread's leading host functions over one run of fn, by self
    time (cProfile)."""
    import cProfile
    import pstats

    import torch

    pr = cProfile.Profile()
    pr.enable()
    fn()
    torch.cuda.synchronize()
    pr.disable()
    stats = pstats.Stats(pr).stats  # (file, line, name) -> (cc, nc, tottime, cumtime, callers)
    top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:top_n]
    log(f"host self time, {what} (cProfile, main thread): " + ", ".join(
        f"{os.path.basename(f)}:{ln}({name}) {v[2] * 1e3:.2f} ms" for (f, ln, name), v in top))


def batch_queries(cls, reads):
    """One 4 Mbp classify batch of `reads` on the card: its packed rows and
    the probe's queries, the minimizer of every window position."""
    import torch

    from slacken_tpu_torch.ops import encode, minimizers

    codes = np.concatenate([p.codes for p in reads])[: cls.target_batch_bp // 128]
    packed, valid = (torch.from_numpy(a).to(cls.device) for a in encode.pack_2bit(codes))
    wm = minimizers.window_minimizers_packed(packed, valid, cls.index.params.minimizer_params)
    return packed, valid, wm


def breakdown(cls, reads, cpar, results):
    """Device time per stage of one 4 Mbp classify batch (CUDA events), and
    the probe against the bench index on that batch's dense minimizers."""
    import torch

    from slacken_tpu_torch.classify import finalize
    from slacken_tpu_torch.ops import lookup, minimizers, resolve

    packed, valid, wm = batch_queries(cls, reads)
    mp = cls.index.params.minimizer_params
    b, l = wm.valid.shape
    st = {}
    st["scan"] = cuda_ms(lambda: minimizers.window_minimizers_packed(packed, valid, mp), iters=10)
    q = wm.minimizer.reshape(-1)
    label = "bench index, one batch's dense minimizers"
    time_routed(label, cls.index.keys_t, cls.index.taxa_t, cls._directory, q, results)
    st["probe"] = cuda_ms(lambda: lookup.probe(cls._keys, cls._taxa, cls._directory, q), iters=10)
    looked = lookup.probe(cls._keys, cls._taxa, cls._directory, q).reshape(b, l)
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


def phase_scale(dev, out, results, genomes):
    """Build and classify at scale; the probe against an index far larger
    than L2, on random queries and on a real batch's. Returns the launch
    counts of the build and the classify, and the index with its keys and
    taxa on the card (phase_mesh_scale holds its own build to it). The
    library's (taxon, sequence) pairs are appended to `genomes` as the build
    draws them, for the later phases."""
    import torch

    from slacken_tpu_torch import workloads
    from slacken_tpu_torch.classify import Classifier, ClassifyParams
    from slacken_tpu_torch.index import IndexParams, KeyValueIndex
    from slacken_tpu_torch.ops import cuda_kernels

    def library():
        for pair in workloads.scale_library(SCALE_BP, SCALE_TAXA):
            genomes.append(pair)
            yield pair

    tax = workloads.scale_taxonomy(SCALE_TAXA)
    cuda_kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx = KeyValueIndex.build(library(), IndexParams(k=35, m=31, spaces=7), tax, dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    log(f"scale build on the card: {SCALE_BP / 1e6:.0f} Mbp, {idx.num_records} records "
        f"(JAX package: {SCALE_RECORDS} at 400 Mbp) in {build_s:.2f} s, "
        f"{SCALE_BP / build_s / 1e6:.2f} Mbp/s incl. library generation and host packing; "
        f"peak torch.cuda.max_memory_allocated of the build {torch.cuda.max_memory_allocated()} bytes "
        f"(with one sort: {ONE_SORT_PEAK})")
    if idx.num_records != SCALE_RECORDS:
        fail(f"scale index has {idx.num_records} records, expected {SCALE_RECORDS}")
    reads = workloads.scale_reads(SCALE_BP, SCALE_TAXA, library=genomes)
    n_reads = sum(len(p) for p in reads)
    cls = Classifier(idx, dev)
    cpar = ClassifyParams(thresholds=[0.0], per_read_output=False)
    cls.classify_and_write_packed(reads[:1], os.path.join(out, "scale_warm"), cpar)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cls.classify_and_write_packed(reads, os.path.join(out, "scale"), cpar)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    WALLS["scale"] = dt
    c, total = classified_count(os.path.join(out, "scale_c0.0", "all_kreport.txt"))
    log(f"scale classify on the card: {n_reads} reads in {dt:.3f} s, {n_reads / dt:.1f} reads/s, "
        f"classified {c} ({100.0 * c / n_reads:.2f}%)")
    log(f"scale peak torch.cuda.max_memory_allocated: {torch.cuda.max_memory_allocated()} bytes")
    if total != n_reads or c < 0.99 * n_reads:
        fail(f"scale classified {c} of {total} reads")
    launches = dict(cuda_kernels.LAUNCHES)
    require_launches("scale build and classify", launches)
    for label, q in (
        ("scale index, random queries", narrow_random_queries(dev, idx, SCALE_RECORDS)),
        ("scale index, one batch's dense minimizers", batch_queries(cls, reads)[2].minimizer.reshape(-1)),
    ):
        time_routed(label, idx.keys_t, idx.taxa_t, cls._directory, q, results)
    del cls
    t0 = time.perf_counter()
    spaced = idx.respace(9)
    torch.cuda.synchronize()
    log(f"respace 7 -> 9 of the scale index on the card (a mask over {idx.num_records} keys, a sort, the run "
        f"reduce): {spaced.num_records} records in {time.perf_counter() - t0:.3f} s")
    if not 0 < spaced.num_records <= idx.num_records or spaced.params.spaces != 9:
        fail(f"the respaced scale index holds {spaced.num_records} records at s = {spaced.params.spaces}")
    return launches, idx


def merge_bytes(dev, tax, scale_idx):
    """Peak bytes a record takes in one device sort and reduce
    (MergeTree._reduce), its inputs, transients and outputs included, at
    index.RANGE_ENTRIES records: narrow (keys of the scale index) and wide
    (random 90-bit keys), reduced by LCA, into distinct pairs, and in a
    keep_records build's final merge (the pairs and the index reduced from
    them). Several readings of each: two seeds, each with distinct keys and
    with every key twice under two taxa. Each must stay within
    index.MERGE_BYTES, on which the budget's sizes rest; the largest of each
    width is printed beside it."""
    import torch

    from slacken_tpu_torch.index import MERGE_BYTES, RANGE_ENTRIES, MergeTree

    n = min(RANGE_ENTRIES, scale_idx.num_records)
    above, most = [], {False: 0.0, True: 0.0}
    for seed in (11, 12):
        gen = torch.Generator(device=dev).manual_seed(seed)
        for wide in (False, True):
            for twice in (False, True):
                for mode in ("by LCA", "into distinct pairs", "final merge with the sidecar"):
                    tree = MergeTree(dev, tax, 45 if wide else 31, pairs=mode != "by LCA")
                    torch.cuda.synchronize()
                    torch.cuda.empty_cache()
                    base = torch.cuda.memory_allocated()
                    m = n // 2 if twice else n
                    if wide:
                        keys = torch.stack([torch.randint(0, 1 << 26, (m,), device=dev, generator=gen),
                                            torch.randint(-(1 << 63), (1 << 63) - 1, (m,), device=dev, generator=gen)], 1)
                    else:
                        keys = scale_idx.keys_t.to(dev)[torch.randperm(scale_idx.num_records, device=dev,
                                                                       generator=gen)[:m]]
                    if twice:
                        keys = keys.repeat(2, *([1] * (keys.dim() - 1)))
                    taxa = torch.randint(10, 10 + SCALE_TAXA, (n,), device=dev, generator=gen, dtype=torch.int32)
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    out = tree._reduce(keys, taxa, final=mode.startswith("final"))
                    torch.cuda.synchronize()
                    per = (torch.cuda.max_memory_allocated() - base) / n
                    most[wide] = max(most[wide], per)
                    log(f"one device sort and reduce of {n} {'wide' if wide else 'narrow'} records "
                        f"({'every key twice' if twice else 'distinct keys'}, seed {seed}) {mode}: peak {per:.2f} "
                        f"bytes a record (inputs {keys.element_size() * keys[0].numel() + 4} of them, "
                        f"{int(out[0].shape[0])} out; index.MERGE_BYTES {MERGE_BYTES[wide]})")
                    if per > MERGE_BYTES[wide]:
                        above.append(f"{per:.2f} bytes a record {'wide' if wide else 'narrow'}, {mode}")
                    del keys, taxa, out
    log(f"one device sort and reduce, the largest of {2 * 2 * 3} readings a width: narrow {most[False]:.2f} bytes a "
        f"record (index.MERGE_BYTES {MERGE_BYTES[False]}), wide {most[True]:.2f} ({MERGE_BYTES[True]})")
    if above:
        fail(f"a device sort and reduce takes more than index.MERGE_BYTES: {above}")


def phase_build_bounded(dev, out, genomes, scale_idx):
    """The bounded build at scale (index.MergeTree), after phase_scale: the
    bytes a record costs in one device sort and reduce (merge_bytes); then
    the 400 Mbp library (`genomes`, in memory) built three times, each equal
    to phase_scale's index (`scale_idx`) key for key: under the default
    budget (no leaf leaves the card, the index stays there; the build's
    phase split), under a budget forced to leaves of FORCED_LEAF records (at
    least 8 leave the card; the index ends on the host), and the same with
    spill_dir under `out` (the directory gone after). Walls, peak device
    memory above what was held before each build, leaves off the card and
    bytes spilled. Returns the launch counts."""
    import torch

    from slacken_tpu_torch import workloads
    from slacken_tpu_torch.index import HELD_BYTES, IndexParams, KeyValueIndex, default_device_budget
    from slacken_tpu_torch.ops import cuda_kernels

    tax = workloads.scale_taxonomy(SCALE_TAXA)
    merge_bytes(dev, tax, scale_idx)
    forced = dict(device_budget=FORCED_LEAF * 8 * HELD_BYTES[False], batch_rows=FORCED_ROWS)
    spill = os.path.join(out, "bb_spill")
    total = {}
    for label, kw in (("default budget", {}), ("forced budget", forced),
                      ("forced budget, spill_dir", dict(forced, spill_dir=spill))):
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        budget = kw.get("device_budget") or default_device_budget(dev)
        cuda_kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with twins_forbidden():
            idx = KeyValueIndex.build(iter(genomes), IndexParams(), tax, dev, trace=not kw, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(cuda_kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() - held
        s = idx.build_stats
        log(f"bounded scale build, {label}: {idx.num_records} records in {wall:.2f} s "
            f"({SCALE_BP / wall / 1e6:.2f} Mbp/s, the library in host memory), index on {idx.keys_t.device}; "
            f"peak torch.cuda.max_memory_allocated {peak} bytes above the {held} held (budget {budget} bytes; "
            f"memory_reserved {torch.cuda.memory_reserved()}; the one-sort build's peak: {ONE_SORT_PEAK}); "
            f"leaves {s['leaves']}, merges {s['merges']}, leaves off the card {s['leaves_off']}, spilled "
            f"{s['spilled_bytes']} bytes in {s['spill_ranges']} ranges; leaf limit {s['leaf_entries']} records, "
            f"range {s['range_entries']}, superbatch {s['superbatch']}")
        if idx.build_phases:
            log("  build phases (s, synchronized): " + ", ".join(f"{k} {v:.3f}" for k, v in idx.build_phases.items()))
        if not index_equal(idx, scale_idx):
            fail(f"the bounded scale build ({label}) differs from phase_scale's index")
        if peak > budget:
            fail(f"the bounded scale build ({label}) took {peak} bytes, above its budget of {budget}")
        if not kw and (s["leaves_off"] or idx.keys_t.device.type != dev.type):
            fail(f"under the default budget {s['leaves_off']} leaves left the card, the index is on {idx.keys_t.device}")
        if kw and s["leaves_off"] < 8:
            fail(f"the forced budget moved {s['leaves_off']} leaves off the card, fewer than 8")
        if "spill_dir" in kw and (os.path.exists(spill) or not s["spilled_bytes"]):
            fail(f"spill_dir: {s['spilled_bytes']} bytes spilled, directory left: {os.path.exists(spill)}")
        require_launches(f"bounded scale build, {label}", launches, ("scan",),
                         ("scan_lut", "scan_wide", "probe", "probe_slots", "probe_wide"))
        add_launches(total, launches)
        del idx
    return total


BOUNDED_BENCH = {"wide (35, 32, 7)": dict(k=35, m=32, spaces=7), "wide (50, 45, 7)": dict(k=50, m=45, spaces=7),
                 "signature (35, 13, 3)": dict(k=35, m=13, spaces=3, ordering="signature")}


def phase_build_bounded_bench(dev, out, bases):
    """The bounded build at bench size, after phase_ordering: for each kind
    of BOUNDED_BENCH, with its sidecar, the card's build under a budget
    forced to leaves of a sixth of the index (batches of 256 rows) and the
    same with spill_dir, against the CPU's build (the wide (50, 45, 7) one of
    phase_wide, in `bases`); the CLI's build --spill-dir on the card against
    its build without it (files byte for byte); build_distributed over
    MESH_SHARDS shards of the card with spill_dir and a forced budget against
    the CPU's narrow index. Returns the launch counts."""
    import torch

    from slacken_tpu_torch import cli, workloads
    from slacken_tpu_torch.index import HELD_BYTES, IndexParams, KeyValueIndex
    from slacken_tpu_torch.ops import cuda_kernels
    from slacken_tpu_torch.parallel.classifier import build_distributed
    from slacken_tpu_torch.parallel.mesh import Mesh

    tax = workloads.bench_taxonomy()
    lib = list(workloads.bench_library(np.random.default_rng(workloads.BENCH_SEED)))
    spill = os.path.join(out, "bbb_spill")
    total = {}
    kernel = {False: ("scan", "probe_slots"), True: ("scan_wide", "probe_wide")}

    def run(what, names, fn):
        cuda_kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with twins_forbidden():
            result = fn()
        torch.cuda.synchronize()
        launches = dict(cuda_kernels.LAUNCHES)
        require_launches(what, launches, names)
        add_launches(total, launches)
        return result, time.perf_counter() - t0

    def same(a, b):
        return index_equal(a, b) and all(torch.equal(x.cpu(), y.cpu()) for x, y in (
            (a.record_keys_t, b.record_keys_t), (a.record_taxa_t, b.record_taxa_t)))

    for label, kms in BOUNDED_BENCH.items():
        params = IndexParams(**kms)
        want = (bases["wide"][1] if kms["m"] == 45 else
                KeyValueIndex.build(iter(lib), params, tax, "cpu", keep_records=True))
        leaf = want.num_records // 6
        budget = leaf * 8 * HELD_BYTES[params.m > 31]
        scan = "scan_lut" if "ordering" in kms else kernel[params.m > 31][0]
        for route, extra in (("forced budget", {}), ("spill_dir", {"spill_dir": spill})):
            got, wall = run(f"bounded bench build, {label}, {route}", (scan,), lambda: KeyValueIndex.build(
                iter(lib), params, tax, dev, keep_records=True, batch_rows=256, device_budget=budget, **extra))
            st = got.build_stats
            log(f"bounded bench build {label}, {route}: {got.num_records} records, {got.record_taxa_t.shape[0]} "
                f"pairs in {wall:.2f} s on the card; leaves {st['leaves']}, merges {st['merges']}, off the card "
                f"{st['leaves_off']}, spilled {st['spilled_bytes']} bytes; the CPU's build equal: {same(got, want)}")
            if not same(got, want) or st["leaves_off"] < 2 or os.path.exists(spill):
                fail(f"bounded bench build {label}, {route}: equal {same(got, want)}, {st['leaves_off']} leaves "
                     f"off the card, spill directory left {os.path.exists(spill)}")
            del got
    lib_dir, tax_dir = os.path.join(out, "bb_lib"), os.path.join(out, "bb_tax")
    workloads.write_library(lib, lib_dir)
    tax.save(tax_dir)
    argv = ["build", "-l", lib_dir, "-t", tax_dir, "--full-records", "--device", "cuda"]
    for name, extra in (("bb_cli", []), ("bb_cli_spill", ["--spill-dir", spill])):
        rc, _ = run(f"the CLI's build {' '.join(extra)}", ("scan",),
                    lambda: cli.main([*argv, "-i", os.path.join(out, name), *extra]))
        if rc != 0:
            fail(f"the CLI's build {extra} exited {rc}")
    a, b = files_under(os.path.join(out, "bb_cli") + os.sep), files_under(os.path.join(out, "bb_cli_spill") + os.sep)
    if a != b or len(a) < 5 or os.path.exists(spill):
        fail(f"build --spill-dir wrote other files than build: {sorted(a)} / {sorted(b)}")
    log(f"the CLI's build --spill-dir on the card: {len(a)} files byte-identical to its build without it")
    leaf = bases["narrow"][1].num_records // (4 * MESH_SHARDS)  # an owner holds an eighth of the records
    got, wall = run("bounded build_distributed over 8 shards with spill_dir", ("scan",), lambda: build_distributed(
        iter(lib), IndexParams(), tax, Mesh([dev] * MESH_SHARDS), keep_records=True, batch_rows=256,
        spill_dir=spill, device_budget=MESH_SHARDS * leaf * 8 * HELD_BYTES[False]))
    off = sum(st["leaves_off"] for st in got.build_stats)
    log(f"build_distributed over {MESH_SHARDS} shards of the card with spill_dir: {got.num_records} records in "
        f"{wall:.2f} s, {off} leaves off the card; the CPU's narrow index equal: {same(got, bases['narrow'][1])}")
    if not same(got, bases["narrow"][1]) or off < MESH_SHARDS or os.path.exists(spill):
        fail("build_distributed with spill_dir differs from the CPU's index, or spilled too little")
    return total


def card_against_cpu(dev, out, tag, params, tax, library, reads, n_reads, least, table=None, keep_records=False):
    """One kind of index end to end: built on the card, saved, loaded and
    classified there in reports and per-read mode with the twins forbidden,
    then the same on the CPU; index arrays (with `keep_records` the sidecar's
    too), kreports and per-read lines must be equal. `table(device)` makes the
    rank table of a frequency ordering. Returns the card's loaded index, its
    Classifier, the launch counts and the CPU's index."""
    import torch

    from slacken_tpu_torch.classify import Classifier, ClassifyParams
    from slacken_tpu_torch.index import KeyValueIndex
    from slacken_tpu_torch.ops import cuda_kernels

    modes = {"rep": ClassifyParams(thresholds=[0.0, 0.15], per_read_output=False),
             "det": ClassifyParams(thresholds=[0.0, 0.15], per_read_output=True)}
    what = f"k={params.k} m={params.m} s={params.spaces} {params.ordering}"
    cuda_kernels.reset_launch_counts()
    with twins_forbidden():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lut = table(dev) if table else None
        t1 = time.perf_counter()
        built = KeyValueIndex.build(library(), params, tax, dev, ordering_lut=lut, keep_records=keep_records)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t1
        built.save(os.path.join(out, f"{tag}_idx"))
        idx = KeyValueIndex.load(os.path.join(out, f"{tag}_idx"))
        cls = Classifier(idx, dev)
        cls.classify_and_write_packed(reads, os.path.join(out, f"{tag}_warm"), modes["rep"])
        times = {}
        for mode, cpar in modes.items():
            times[mode] = timed_runs(
                lambda r: cls.classify_and_write_packed(reads, os.path.join(out, f"{tag}_{mode}"), cpar), n=1)[0]
    launches = dict(cuda_kernels.LAUNCHES)
    log(f"{what}: built on the card in {build_s:.3f} s ({8e6 / build_s / 1e6:.2f} Mbp/s incl. host packing"
        + (f"; its rank table in {t1 - t0:.2f} s before that" if table else "") + f"), {idx.num_records} records; "
        f"classify on the card {n_reads / times['rep']:.1f} reads/s in reports mode, "
        f"{n_reads / times['det']:.1f} in per-read mode (one warm run each)")
    keys_file = np.load(os.path.join(out, f"{tag}_idx", "keys.npy"), mmap_mode="r")
    if keys_file.shape != ((idx.num_records, 2) if params.m > 31 else (idx.num_records,)) or keys_file.dtype != np.uint64:
        fail(f"{what}: keys.npy is {keys_file.dtype} {keys_file.shape}")
    if os.path.exists(os.path.join(out, f"{tag}_idx", "ordering_lut.npy")) != (params.ordering != "xor"):
        fail(f"{what}: ordering_lut.npy is there for xor only or missing for {params.ordering}")
    t0 = time.perf_counter()
    lut_cpu = table("cpu") if table else None
    idx_cpu = KeyValueIndex.build(library(), params, tax, "cpu", ordering_lut=lut_cpu, keep_records=keep_records)
    if keep_records and not (torch.equal(idx.record_keys_t, idx_cpu.record_keys_t)
                             and torch.equal(idx.record_taxa_t, idx_cpu.record_taxa_t)):
        fail(f"{what}: the sidecar built on the card, saved and loaded differs from the CPU's")
    if idx.num_records != idx_cpu.num_records:
        fail(f"{what}: {idx.num_records} records on the card, {idx_cpu.num_records} on the CPU")
    if not (np.array_equal(idx.keys, idx_cpu.keys) and np.array_equal(idx.taxa, idx_cpu.taxa)):
        fail(f"{what}: the card's index differs from the CPU build")
    if table and not np.array_equal(idx.ordering_lut, idx_cpu.ordering_lut):
        fail(f"{what}: the rank table sampled on the card differs from the CPU's")
    cls_cpu = Classifier(idx_cpu, "cpu")
    for mode, cpar in modes.items():
        cls_cpu.classify_and_write_packed(reads, os.path.join(out, f"{tag}_{mode}cpu"), cpar)
        got, want = output_tree(os.path.join(out, f"{tag}_{mode}")), output_tree(os.path.join(out, f"{tag}_{mode}cpu"))
        if got != want or len(got) != (2 if mode == "rep" else 4):
            fail(f"{what}: the {mode} output of the card differs from the CPU's")
    if {k: v for k, v in got.items() if k.endswith(".txt")} != output_tree(os.path.join(out, f"{tag}_rep")):
        fail(f"{what}: per-read mode's kreports differ from reports mode's")
    c, total = classified_count(os.path.join(out, f"{tag}_det_c0.00", "all_kreport.txt"))
    log(f"{what}: index, kreports and per-read lines byte-identical card vs CPU ({time.perf_counter() - t0:.1f} s "
        f"of CPU build and classify); classified {c} of {total}")
    if total != n_reads or c < least * n_reads:
        fail(f"{what}: classified {c} of {total} reads")
    return idx, cls, launches, idx_cpu


def add_launches(total, launches):
    for name, n in launches.items():
        total[name] = total.get(name, 0) + n


def phase_wide(dev, out, reads, results, genomes, bases):
    """Wide keys (m > 31) end to end on the bench library at two parameter
    sets, then the 400 Mbp scale library (`genomes`) built wide and
    classified, routed and with probe="hashed1" (its row-bucket table built
    on the card; the kreport equal to the routed one), and probe_wide and
    probe_rows_wide timed there on random queries and one batch's dense
    minimizers. Returns the launch counts of the whole path; the (50, 45, 7)
    bench indexes, built with their sidecars, go into `bases` for classify2."""
    import torch

    from slacken_tpu_torch import workloads
    from slacken_tpu_torch.classify import Classifier, ClassifyParams
    from slacken_tpu_torch.index import IndexParams, KeyValueIndex
    from slacken_tpu_torch.ops import cuda_kernels

    tax = workloads.bench_taxonomy()
    library = lambda: workloads.bench_library(np.random.default_rng(workloads.BENCH_SEED))  # noqa: E731
    n_reads = sum(len(p) for p in reads)
    total = {}
    narrow = ("scan", "scan_lut", "probe", "probe_slots")
    for tag, kms in (("w45", (50, 45, 7)), ("w33", (35, 33, 0))):
        params = IndexParams(k=kms[0], m=kms[1], spaces=kms[2])
        idx, cls, launches, idx_cpu = card_against_cpu(dev, out, tag, params, tax, library, reads, n_reads, 0.8,
                                                       keep_records=tag == "w45")
        require_launches(f"wide bench {kms}: build, 3 classify runs", launches, ("scan_wide", "probe_wide"), narrow)
        add_launches(total, launches)
        if tag == "w45":
            label = "wide bench index (50, 45, 7), one batch's dense minimizers"
            q = batch_queries(cls, reads)[2].minimizer.flatten(0, 1)
            results["probe_wide"]["shapes"][label] = time_probe(  # the loaded index's keys lie on the host
                label, idx.keys_t.to(dev), idx.taxa_t.to(dev), cls._directory, q, "probe_wide")
            bases["wide"] = (idx, idx_cpu)
        del idx, cls, idx_cpu

    tax = workloads.scale_taxonomy(SCALE_TAXA)
    cuda_kernels.reset_launch_counts()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with twins_forbidden():
        idx = KeyValueIndex.build(iter(genomes), IndexParams(k=50, m=45, spaces=7), tax, dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        log(f"wide scale build on the card: {SCALE_BP / 1e6:.0f} Mbp at (50, 45, 7), {idx.num_records} records of "
            f"16 + 4 bytes in {build_s:.2f} s, {SCALE_BP / build_s / 1e6:.2f} Mbp/s incl. host packing (the library "
            f"was generated before, not inside this wall as in earlier runs); peak torch.cuda.max_memory_allocated {torch.cuda.max_memory_allocated()} bytes")
        if not idx.wide or idx.keys_t.shape != (idx.num_records, 2) or idx.num_records < SCALE_BP // 8:
            fail(f"the wide scale index holds keys of shape {tuple(idx.keys_t.shape)}")
        if not bool(((idx.keys_t[1:, 0] > idx.keys_t[:-1, 0]) | ((idx.keys_t[1:, 0] == idx.keys_t[:-1, 0]) & (
                (idx.keys_t[1:, 1] ^ -(1 << 63)) > (idx.keys_t[:-1, 1] ^ -(1 << 63))))).all()):
            fail("the wide scale index is not sorted by (hi64, lo64 unsigned) without repeats")
        reads = workloads.scale_reads(SCALE_BP, SCALE_TAXA, library=genomes)
        n_reads = sum(len(p) for p in reads)
        cls = Classifier(idx, dev)
        cpar = ClassifyParams(thresholds=[0.0], per_read_output=False)
        cls.classify_and_write_packed(reads[:1], os.path.join(out, "wscale_warm"), cpar)
        dt = timed_runs(lambda r: cls.classify_and_write_packed(reads, os.path.join(out, "wscale"), cpar), n=1)[0]
        c, total_reads = classified_count(os.path.join(out, "wscale_c0.0", "all_kreport.txt"))
        log(f"wide scale classify on the card: {n_reads} reads in {dt:.3f} s, {n_reads / dt:.1f} reads/s, "
            f"classified {c} ({100.0 * c / n_reads:.2f}%); peak torch.cuda.max_memory_allocated with it "
            f"{torch.cuda.max_memory_allocated()} bytes")
        # k = 50: a 101 bp read with 1% mutated bases keeps fewer clean windows than at k = 35
        if total_reads != n_reads or c < 0.9 * n_reads:
            fail(f"wide scale classified {c} of {total_reads} reads")
        rows = build_tables("wide scale index", idx, dev, ("hashed1",))["hashed1"]  # row_bits 21 by the rule
        hashed1 = Classifier(idx, dev, probe="hashed1")
        hashed1.classify_and_write_packed(reads[:1], os.path.join(out, "wscale_hashed1_warm"), cpar)
        dt = timed_runs(lambda r: hashed1.classify_and_write_packed(reads, os.path.join(out, "wscale_hashed1"), cpar),
                        n=1)[0]
        if (open(os.path.join(out, "wscale_hashed1_c0.0", "all_kreport.txt"), "rb").read()
                != open(os.path.join(out, "wscale_c0.0", "all_kreport.txt"), "rb").read()):
            fail("the wide scale classify with probe=hashed1 differs from the routed kreport")
        log(f"wide scale classify with probe=hashed1: {n_reads} reads in {dt:.3f} s, {n_reads / dt:.1f} reads/s; "
            "kreport equal to the routed one")
        del hashed1
    launches = dict(cuda_kernels.LAUNCHES)
    require_launches("wide scale build and classify, routed and hashed1", launches,
                     ("scan_wide", "probe_wide", "probe_rows_wide"), narrow)
    add_launches(total, launches)
    for label, q in (
        ("wide scale index, random queries", random_wide_queries(dev, idx.keys_t, 1 << 22, SCALE_RECORDS)),
        ("wide scale index, one batch's dense minimizers", batch_queries(cls, reads)[2].minimizer.flatten(0, 1)),
    ):
        results["probe_wide"]["shapes"][label] = time_probe(label, idx.keys_t, idx.taxa_t, cls._directory, q,
                                                            "probe_wide")
        results["probe_rows_wide"]["shapes"][label] = time_table_probe(label, rows, idx.keys_t, idx.taxa_t, q,
                                                                       "probe_rows_wide")
    return total


def phase_ordering(dev, out, reads, bases):
    """Explicit orderings end to end on the bench library at k = 35, m = 13,
    s = 3: signature, lexicographic and frequency (its table sampled on the
    device that builds). Returns the launch counts of the whole path; the
    lexicographic indexes, built with their sidecars, go into `bases` for
    classify2."""
    from slacken_tpu_torch import workloads
    from slacken_tpu_torch.index import IndexParams, KeyValueIndex
    from slacken_tpu_torch.ops import encode, ordering

    tax = workloads.bench_taxonomy()
    library = lambda: workloads.bench_library(np.random.default_rng(workloads.BENCH_SEED))  # noqa: E731
    n_reads = sum(len(p) for p in reads)
    kms = dict(k=35, m=13, spaces=3)

    def frequency_table(device):
        mp = IndexParams(**kms).minimizer_params
        counts = ordering.sample_mmer_counts((encode.encode_seq(seq) for _, seq in library()), mp, device)
        return ordering.frequency_lut(counts, mp.m)

    total = {}
    for name in ("signature", "lexicographic", "frequency"):
        idx, _, launches, idx_cpu = card_against_cpu(
            dev, out, name, IndexParams(**kms, ordering=name), tax, library, reads, n_reads, 0.9,
            frequency_table if name == "frequency" else None, keep_records=name == "lexicographic")
        require_launches(f"{name} ordering: build, 3 classify runs", launches, ("scan_lut", "probe_slots"),
                         ("scan", "scan_wide", "probe_wide"))
        add_launches(total, launches)
        if name == "lexicographic":  # ranks are the masked m-mers: the XOR order with no toggle
            xor0 = KeyValueIndex.build(library(), IndexParams(**kms, toggle_mask=0), tax, dev)
            if not (np.array_equal(idx.keys, xor0.keys) and np.array_equal(idx.taxa, xor0.taxa)):
                fail("the lexicographic index differs from an XOR build with toggle_mask = 0")
            log(f"lexicographic index == XOR build with toggle_mask = 0, key for key ({idx.num_records} records)")
            bases["lexicographic"] = (idx, idx_cpu)
    return total


def index_equal(a, b):
    """Two indexes hold the same keys and taxa (wherever their tensors lie)."""
    import torch

    return (a.num_records == b.num_records and torch.equal(a.keys_t.cpu(), b.keys_t.cpu())
            and torch.equal(a.taxa_t.cpu(), b.taxa_t.cpu()))


def phase_classify2(dev, out, reads, bases):
    """Two-step classification at bench size, card against CPU, for a narrow,
    a wide (50, 45, 7) and a rank-table (35, 13, 3, lexicographic) base index
    built with the full-records sidecar: reads from two of the three bench
    genomes; every detection criterion and the gold set on the narrow index,
    two criteria on the others, one of them with the dynamic index rebuilt
    from the library (no sidecar); the taxon set file, kreports, per-read
    files and --index-reports files must be byte-identical, and the dynamic
    index equal between build_restricted, build(taxon_filter=) and the CPU.
    Then the CLI's classify2, stats, inspect and respace on files written
    here, and the statistics functions, card against CPU. The card's side
    runs with the twins forbidden. Returns the card's launch counts."""
    import torch

    from slacken_tpu_torch import cli, dynamic, stats, workloads
    from slacken_tpu_torch.classify import ClassifyParams, Fragment
    from slacken_tpu_torch.index import IndexParams, KeyValueIndex
    from slacken_tpu_torch.inputs import GenomeLibrary
    from slacken_tpu_torch.ops import cuda_kernels, lookup

    tax = workloads.bench_taxonomy()
    genomes = list(workloads.bench_library(np.random.default_rng(workloads.BENCH_SEED)))
    lib_dir = os.path.join(out, "c2lib")
    workloads.write_library(genomes, lib_dir)
    lib = GenomeLibrary.from_directory(lib_dir)
    present = [p for i, p in enumerate(reads) if i % 3 != 2]  # chunks of the first two genomes
    n_reads = sum(len(p) for p in present)
    want_set = set(list(workloads.BENCH_SIZES)[:2])
    fragments = lambda: (Fragment(t, s) for t, s in workloads.read_sequences(present))  # noqa: E731
    packed = lambda: iter(present)  # noqa: E731
    gold_file = os.path.join(out, "c2gold.txt")
    with open(gold_file, "w") as f:
        f.write("".join(f"{t}\n" for t in sorted(want_set)))
    total = {}
    t0 = time.perf_counter()
    bases["narrow"] = (KeyValueIndex.build(iter(genomes), IndexParams(k=35, m=31, spaces=7), tax, dev,
                                           keep_records=True), bases["narrow"][1])
    torch.cuda.synchronize()
    idx = bases["narrow"][0]
    log(f"bench build on the card with the full-records sidecar: {idx.num_records} records, "
        f"{idx.record_taxa_t.shape[0]} (key, taxon) pairs in {time.perf_counter() - t0:.3f} s")
    if idx.num_records != BENCH_RECORDS or not torch.equal(idx.record_keys_t.cpu(), bases["narrow"][1].record_keys_t):
        fail("the bench build with keep_records differs in its records or its sidecar from the CPU's")

    reads_c, total_c, distinct_c, fraction_c = (
        dynamic.ClassifiedReadCount(100, 0.15), dynamic.MinimizerTotalCount(1000),
        dynamic.MinimizerDistinctCount(500), dynamic.MinimizerFraction(0.01))
    reports = dict(thresholds=[0.0, 0.15], per_read_output=False)
    per_read = dict(thresholds=[0.0], per_read_output=True)
    # (tag, criterion, gold set options, classify parameters, from the sidecar, --index-reports);
    # ("narrow", "total") also writes the dynamic index's Bracken weights for reads of 100 bp
    with_bracken = {("narrow", "total")}
    cases = {
        "narrow": [("reads", reads_c, None, per_read, True, True), ("total", total_c, None, reports, True, False),
                   ("distinct", distinct_c, None, reports, False, False),
                   ("fraction", fraction_c, (gold_file, None, False), reports, True, False),
                   ("gold", reads_c, (gold_file, None, True), reports, True, False)],
        "wide": [("distinct", distinct_c, None, reports, True, True), ("reads", reads_c, None, per_read, False, False)],
        "lexicographic": [("distinct", distinct_c, None, reports, True, True),
                          ("reads", reads_c, None, per_read, False, False)],
    }
    kernels = {"narrow": ("scan", "probe_slots"), "wide": ("scan_wide", "probe_wide"),
               "lexicographic": ("scan_lut", "probe_slots")}
    for kind, (card, host) in bases.items():
        card.to(dev)
        everything = set(tax.taxa())
        if not index_equal(card.build_restricted(everything), card):
            fail(f"classify2 {kind}: build_restricted over every taxon is not the base index")
        for tag, criterion, gold, cpar, sidecar, index_reports in cases[kind]:
            made = {}
            for where, base, device in (("card", card, dev), ("cpu", host, "cpu")):
                if not sidecar:  # the dynamic index by a rebuild from the library
                    base = base.with_records(base.keys_t, base.taxa_t)
                prefix = os.path.join(out, f"c2_{kind}_{tag}_{where}", "dyn")
                dyn = dynamic.Dynamic(base, lib, 8, criterion, ClassifyParams(**cpar),
                                      dynamic.GoldSetOptions(*gold) if gold else None, prefix, device)
                if where == "card":
                    cuda_kernels.reset_launch_counts()
                    with twins_forbidden():
                        t0 = time.perf_counter()
                        made[where] = dyn.two_step_classify_and_write(
                            fragments, index_reports, 100 if (kind, tag) in with_bracken else None,
                            packed_factory=packed)
                        torch.cuda.synchronize()
                        card_s = time.perf_counter() - t0
                    launches = dict(cuda_kernels.LAUNCHES)
                    require_launches(f"classify2 {kind} {tag}", launches, kernels[kind],
                                     [k for k in ("scan", "scan_lut", "scan_wide", "probe", "probe_slots", "probe_wide")
                                      if k not in kernels[kind]])
                    add_launches(total, launches)
                    on_card = [a[2] for (d, p), a in made[where]._on.items() if d.type == "cuda" and p == "routed"]
                    if not (on_card and isinstance(on_card[0], lookup.SlotTable)) or made[where].keys_t.is_cuda:
                        fail(f"classify2 {kind} {tag}: the dynamic index is not held once, as its slot table, on "
                             "the card")
                else:
                    t0 = time.perf_counter()
                    made[where] = dyn.two_step_classify_and_write(
                        fragments, index_reports, 100 if (kind, tag) in with_bracken else None, packed_factory=packed)
                    cpu_s = time.perf_counter() - t0
            got = files_under(os.path.join(out, f"c2_{kind}_{tag}_card", "dyn"))
            want = files_under(os.path.join(out, f"c2_{kind}_{tag}_cpu", "dyn"))
            n_files = (0 if gold and gold[2] else 1) + len(cpar["thresholds"]) * (2 if cpar["per_read_output"] else 1) \
                + (2 if index_reports else 0) + ((kind, tag) in with_bracken)
            if got != want or len(got) != n_files:
                fail(f"classify2 {kind} {tag}: the card wrote {sorted(got)}, the CPU {sorted(want)}, or their bytes differ")
            # narrow keys tell the genomes apart: exactly the two sources; the 13-mers of the rank-table
            # index are shared by chance, so there the absent genome may pass a minimizer criterion
            used = want_set if gold and gold[2] else {int(x) for x in got["_taxonSet.txt"].split()}
            if not want_set <= used or (kind != "lexicographic" and used != want_set):
                fail(f"classify2 {kind} {tag}: detected {sorted(used)}, the reads come from {sorted(want_set)}")
            if (kind, tag) in with_bracken:
                distrib = os.path.join(out, f"c2_{kind}_{tag}_card", "dyn", "database100mers.kmer_distrib")
                if distrib_totals(distrib) != read_windows(genomes, used, 100):
                    fail(f"classify2 {kind} {tag} --bracken-length 100: a source's reads differ from its read windows")
                log(f"classify2 {kind} {tag} --bracken-length 100: kmer_distrib byte-identical card vs CPU, "
                    f"{len(open(distrib).read().splitlines()) - 1} destination lines, each source's reads equal to "
                    "its read windows")
            if not index_equal(made["card"], made["cpu"]):
                fail(f"classify2 {kind} {tag}: the dynamic index differs between the card and the CPU")
            restricted = card.build_restricted(used)
            rebuilt = KeyValueIndex.build(iter(genomes), card.params, tax, dev, taxon_filter=used,
                                          ordering_lut=card.ordering_lut)
            if not (index_equal(made["card"], restricted) and index_equal(restricted, rebuilt)):
                fail(f"classify2 {kind} {tag}: build_restricted, build(taxon_filter=) and the run's index differ")
            c, n = classified_count(os.path.join(out, f"c2_{kind}_{tag}_card", "dyn_c0.0" + ("0" if len(cpar["thresholds"]) > 1 else ""), "all_kreport.txt"))
            log(f"classify2 {kind} {tag} ({criterion}{', gold set' if gold else ''}; dynamic index "
                f"{'from the sidecar' if sidecar else 'rebuilt from the library'}): {len(got)} files byte-identical card "
                f"vs CPU, {len(used)} taxa, dynamic index {made['card'].num_records} of {card.num_records} records equal "
                f"by all three routes, classified {c} of {n}; {card_s:.2f} s on the card, {cpu_s:.1f} s on the CPU")
            if n != n_reads or c < 0.8 * n_reads:
                fail(f"classify2 {kind} {tag}: classified {c} of {n} reads, expected {n_reads}")

    # the CLI on files: classify2 (default criterion, --index-reports), then stats, inspect and respace
    card, host = bases["narrow"]
    idx_dir, fastq = os.path.join(out, "c2idx_s7"), os.path.join(out, "c2reads.fastq")
    card.save(idx_dir)
    workloads.write_fastq(present[:2], fastq)  # one copy of the two genomes' reads
    printed = {}
    cuda_kernels.reset_launch_counts()
    for where, extra in (("card", []), ("cpu", ["--device", "cpu"])):
        runs = [
            ["classify2", fastq, "-i", idx_dir, "-l", lib_dir, "-o", os.path.join(out, f"c2cli_{where}", "o"),
             "-c", "0.0", "0.15", "--index-reports", "-R", "50"],
            ["stats", "-i", idx_dir], ["stats", "-i", idx_dir, "--histogram"], ["stats", "-i", idx_dir, "-l", lib_dir],
            ["inspect", "-i", idx_dir, "-l", lib_dir, "-o", os.path.join(out, f"c2cli_{where}", "inspect"),
             "--labels", os.path.join(lib_dir, "seqid2taxid.map")],
            ["respace", "-i", idx_dir, "-o", os.path.join(out, f"c2cli_{where}", "re_s7"), "--spaces", "9"],
        ]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), (twins_forbidden() if where == "card" else contextlib.nullcontext()):
            for argv in runs:
                if cli.main([*argv, *extra]) != 0:
                    fail(f"the CLI failed on the {where}: {argv}")
        printed[where] = buf.getvalue().replace(f"c2cli_{where}", "c2cli")
        if where == "card":
            launches = dict(cuda_kernels.LAUNCHES)
            require_launches("classify2, stats, inspect through the CLI", launches)
            add_launches(total, launches)
    got, want = files_under(os.path.join(out, "c2cli_card", "")), files_under(os.path.join(out, "c2cli_cpu", ""))
    got = {k: v for k, v in got.items() if not k.endswith("params.json") and "taxonomy" not in k}
    want = {k: v for k, v in want.items() if not k.endswith("params.json") and "taxonomy" not in k}
    if got != want or len(got) != 12 or printed["card"] != printed["cpu"]:
        fail(f"the CLI's classify2, stats, inspect or respace differ between the card and the CPU: files {sorted(got)}")
    log("classify2 --index-reports, stats (plain, --histogram, -l), inspect (-l, --labels) and respace through "
        f"cli.main: {len(got)} files and {len(printed['card'].splitlines())} printed lines equal card vs CPU; the card printed:")
    for line in printed["card"].splitlines():
        log("  | " + line)

    # the statistics functions and respace, card against CPU (the narrow and the wide index)
    for kind in ("narrow", "wide"):
        card, host = bases[kind]
        cuda_kernels.reset_launch_counts()
        with twins_forbidden():
            t0 = time.perf_counter()
            on_card = (stats.depth_histograms(card), stats.taxon_full_coverage_stats(card, lib, dev),
                       stats.total_kmer_count_report(card, lib, dev).lines())
            spaced = card.respace(9)
            torch.cuda.synchronize()
            card_s = time.perf_counter() - t0
        launches = dict(cuda_kernels.LAUNCHES)
        require_launches(f"stats on the {kind} bench index", launches, kernels[kind])
        add_launches(total, launches)
        t0 = time.perf_counter()
        on_cpu = (stats.depth_histograms(host), stats.taxon_full_coverage_stats(host, lib, "cpu"),
                  stats.total_kmer_count_report(host, lib, "cpu").lines())
        if on_card != on_cpu or len(on_card[1]) != 3:
            fail(f"depth_histograms, taxon_full_coverage_stats or the TKC report differ on the {kind} bench index")
        if spaced.keys_t.device.type != dev.type or not index_equal(spaced, host.respace(9)):
            fail(f"respace 7 -> 9 of the {kind} bench index differs between the card and the CPU")
        log(f"stats on the {kind} bench index: depth histograms {on_card[0][0]}, coverage rows {on_card[1]}, TKC report "
            f"of {len(on_card[2])} lines and respace 7 -> 9 ({card.num_records} -> {spaced.num_records} records) equal "
            f"card vs CPU; {card_s:.2f} s on the card, {time.perf_counter() - t0:.1f} s on the CPU")
    return total


def phase_classify2_scale(dev, out, genomes):
    """Two-step classification at full size: the 400 Mbp scale library under
    a taxonomy with ranks (64 species in 16 genera in 4 families), the base
    index built with its sidecar on the card, 200,000 reads from the eight
    largest genomes. Prints the wall of every step and the device's busy
    share, holds the restricted build against the rebuild from the library,
    and the whole run's files against the CPU's (which starts from a host
    copy of the card's base index: the CPU's twins would take many minutes to
    build it). Returns the card's launch counts."""
    import torch

    from slacken_tpu_torch import dynamic, workloads
    from slacken_tpu_torch.classify import Classifier, ClassifyParams, Fragment
    from slacken_tpu_torch.index import IndexParams, KeyValueIndex
    from slacken_tpu_torch.ops import cuda_kernels
    from slacken_tpu_torch.ops.lookup import build_directory

    def sync_s(t0):
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    tax = workloads.scale_taxonomy_deep(SCALE_TAXA)
    params = IndexParams(k=35, m=31, spaces=7)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cuda_kernels.reset_launch_counts()
    with twins_forbidden():
        t0 = time.perf_counter()
        base = KeyValueIndex.build(iter(genomes), params, tax, dev, keep_records=True)
        build_s = sync_s(t0)
        n_pairs = base.record_taxa_t.shape[0]
        log(f"scale build on the card with the full-records sidecar: {base.num_records} records "
            f"({tensor_bytes(base.keys_t, base.taxa_t)} bytes), sidecar {n_pairs} (key, taxon) pairs "
            f"({tensor_bytes(base.record_keys_t, base.record_taxa_t)} bytes) in {build_s:.2f} s "
            f"({SCALE_BP / build_s / 1e6:.2f} Mbp/s incl. host packing, the library made before); peak "
            f"torch.cuda.max_memory_allocated {torch.cuda.max_memory_allocated()} bytes")
        if base.num_records != SCALE_RECORDS or n_pairs < base.num_records:
            fail(f"the scale index with keep_records holds {base.num_records} records and {n_pairs} pairs")
        reads = workloads.scale_reads(SCALE_BP, SCALE_TAXA, library=genomes)
        n_reads = sum(len(p) for p in reads)
        # step 1 takes Fragments: made here once, outside every wall below, as a caller's list would be
        fragments = [Fragment(t, s) for t, s in workloads.read_sequences(reads)]
        sources = {t for t, _ in genomes[:8]}
        cpar = ClassifyParams(thresholds=[0.0], per_read_output=False)
        default = dynamic.ClassifiedReadCount(100, 0.15)
        dyn = dynamic.Dynamic(base, workloads.GenomeList(genomes), 8, default, cpar, None, os.path.join(out, "c2s_steps", "dyn"), dev)
        dyn._classifier().classify_and_write_packed(reads[:1], os.path.join(out, "c2s_warm"), cpar)  # warm
        t0 = time.perf_counter()
        taxon_set = dyn.find_taxon_set(fragments, os.path.join(out, "c2s_steps", "dyn_taxonSet.txt"))
        find_s = sync_s(t0)
        if taxon_set != sources:
            fail(f"classify2 at scale detected {sorted(taxon_set)}, the reads come from {sorted(sources)}")
        t0 = time.perf_counter()
        restricted = base.build_restricted(taxon_set)
        restrict_s = sync_s(t0)
        t0 = time.perf_counter()
        rebuilt = KeyValueIndex.build(iter(genomes), params, tax, dev, taxon_filter=taxon_set)
        rebuild_s = sync_s(t0)
        if not index_equal(restricted, rebuilt):
            fail("classify2 at scale: build_restricted differs from build(taxon_filter=) on the same library")
        del rebuilt
        t0 = time.perf_counter()
        directory = build_directory(restricted.keys_t)
        directory_s = sync_s(t0)
        del directory
        cls = Classifier(restricted, dev)
        if cls._keys is not None or restricted.keys_t.device.type != "cpu":
            fail("classify2 at scale: the card holds the dynamic index's records twice")
        t0 = time.perf_counter()
        cls.classify_and_write_packed(iter(reads), os.path.join(out, "c2s_steps", "dyn"), cpar)
        classify_s = sync_s(t0)
        share = sum(len(s) for t, s in genomes if t in taxon_set) / sum(len(s) for _, s in genomes)
        log(f"classify2 at scale, step by step ({default}): find taxon set {find_s:.3f} s ({n_reads / find_s:.1f} "
            f"reads/s, {len(taxon_set)} taxa: the eight source species and no more, {100 * share:.1f}% of the "
            f"library's bases); build_restricted {restrict_s:.4f} s for {restricted.num_records} of {base.num_records} "
            f"records from {n_pairs} pairs; the same index by a rebuild from the library {rebuild_s:.3f} s "
            f"({rebuild_s / restrict_s:.1f}x); directory {directory_s:.4f} s; final classify {classify_s:.3f} s "
            f"({n_reads / classify_s:.1f} reads/s)")
        del cls, restricted

        whole = dynamic.Dynamic(base, workloads.GenomeList(genomes), 8, default, cpar, None, os.path.join(out, "c2s_card", "dyn"), dev)
        t0 = time.perf_counter()
        made = whole.two_step_classify_and_write(fragments, packed_factory=lambda: iter(reads))
        whole_s = sync_s(t0)
        log(f"classify2 at scale, the whole (two_step_classify_and_write, a list of Fragments for step 1, packed reads for "
            f"the final pass): {whole_s:.3f} s, {n_reads / whole_s:.1f} reads/s end to end, dynamic index "
            f"{made.num_records} records; peak torch.cuda.max_memory_allocated {torch.cuda.max_memory_allocated()} bytes")
        prof = dynamic.Dynamic(base, workloads.GenomeList(genomes), 8, default, cpar, None, os.path.join(out, "c2s_prof", "dyn"), dev)
        run_whole = lambda: prof.two_step_classify_and_write(fragments, packed_factory=lambda: iter(reads))  # noqa: E731
        run_whole()
        host_profile(run_whole, "classify2 at scale, the whole", top_n=10)
        distinct = dynamic.Dynamic(base, workloads.GenomeList(genomes), 8, dynamic.MinimizerDistinctCount(1000), cpar, None,
                                   os.path.join(out, "c2s_distinct", "dyn"), dev)
        t0 = time.perf_counter()
        by_distinct = distinct.find_taxon_set(fragments)
        distinct_s = sync_s(t0)
        distinct.find_taxon_set(fragments)
        log(f"classify2 at scale, find taxon set by MinimizerDistinctCount(1000): {distinct_s:.3f} s "
            f"({n_reads / distinct_s:.1f} reads/s), {len(by_distinct)} taxa")
        if by_distinct != sources:
            fail(f"classify2 at scale detected {sorted(by_distinct)} by distinct minimizers")
    launches = dict(cuda_kernels.LAUNCHES)
    require_launches("classify2 at scale", launches)

    # the CPU's run, from a host copy of the card's base index and sidecar
    t0 = time.perf_counter()
    host = base.with_records(base.keys_t.cpu(), base.taxa_t.cpu())
    host.record_keys_t, host.record_taxa_t = base.record_keys_t.cpu(), base.record_taxa_t.cpu()
    on_cpu = dynamic.Dynamic(host, workloads.GenomeList(genomes), 8, default, cpar, None, os.path.join(out, "c2s_cpu", "dyn"), "cpu")
    made_cpu = on_cpu.two_step_classify_and_write(fragments, packed_factory=lambda: iter(reads))
    cpu_s = time.perf_counter() - t0
    got, want = files_under(os.path.join(out, "c2s_card", "dyn")), files_under(os.path.join(out, "c2s_cpu", "dyn"))
    if got != want or len(got) != 2 or not index_equal(made, made_cpu):
        fail("classify2 at scale: the taxon set file, the kreport or the dynamic index differ between the card and the CPU")
    if got != files_under(os.path.join(out, "c2s_steps", "dyn")):
        fail("classify2 at scale: the run step by step wrote other files than two_step_classify_and_write")
    c, n = classified_count(os.path.join(out, "c2s_card", "dyn_c0.0", "all_kreport.txt"))
    log(f"classify2 at scale: taxon set file, kreport and dynamic index byte-identical card vs CPU (the CPU's run, "
        f"from a host copy of the base index, took {cpu_s:.1f} s); classified {c} of {n}")
    if n != n_reads or c < 0.99 * n_reads:
        fail(f"classify2 at scale classified {c} of {n} reads")
    return launches


@contextlib.contextmanager
def timed_calls(owner, name, seconds):
    """Sum the wall of every call of owner.<name>, the device's work
    included (a synchronize on either side), into seconds[name]."""
    import torch

    real = getattr(owner, name)

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = real(*args, **kwargs)
        torch.cuda.synchronize()
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
        return result

    setattr(owner, name, timed)
    try:
        yield
    finally:
        setattr(owner, name, real)


def distrib_totals(path):
    """{source: reads} of a kmer_distrib file, from its per-destination
    counts, after checking that every total column agrees."""
    totals, columns = {}, {}
    for line in open(path).read().splitlines()[1:]:
        for piece in line.split("\t")[1].split(" "):
            src, cnt, tot = map(int, piece.split(":"))
            totals[src] = totals.get(src, 0) + cnt
            columns.setdefault(src, set()).add(tot)
    if any(columns[s] != {t} for s, t in totals.items()):
        fail(f"{path}: a source's total column disagrees with its counts")
    return totals


def read_windows(genomes, taxa, read_len):
    """{source: read windows} that bracken must count: len - R + 1 over each
    sequence of a source in `taxa` at least R long."""
    want = {}
    for taxon, seq in genomes:
        if taxon in taxa and len(seq) >= read_len:
            want[taxon] = want.get(taxon, 0) + len(seq) - read_len + 1
    return want


def phase_bracken(dev, out, bases):
    """Bracken weights at R = 100 on the bench library for the narrow, the
    wide (50, 45, 7) and the rank-table (35, 13, 3, lexicographic) index:
    the card (fragment pass and device window classifier, twins forbidden)
    against the CPU (the twins and the numpy counts), kmer_distrib
    byte-identical, each source's reads equal to its read windows. Then
    bracken-build through the CLI, resuming from chunk files a gradual run
    left with one chunk lost. Returns the card's launch counts."""
    import torch

    from slacken_tpu_torch import bracken, cli, workloads
    from slacken_tpu_torch.inputs import GenomeLibrary
    from slacken_tpu_torch.ops import cuda_kernels

    genomes = list(workloads.bench_library(np.random.default_rng(workloads.BENCH_SEED)))
    lib = workloads.GenomeList(genomes)
    kernels = {"narrow": ("scan", "probe_slots"), "wide": ("scan_wide", "probe_wide"),
               "lexicographic": ("scan_lut", "probe_slots")}
    total = {}
    for kind, (card, host) in bases.items():
        card.to(dev)
        taxa = {t for t, _ in genomes}
        paths, walls = {}, {}
        cuda_kernels.reset_launch_counts()
        with twins_forbidden(), timed_calls(bracken, "fragment_pass", walls), \
                timed_calls(bracken, "window_dest_counts", walls):
            paths["card"] = os.path.join(out, f"br_{kind}_card.kmer_distrib")
            t0 = time.perf_counter()
            bracken.BrackenWeights(card, 100, dev).build_and_write_weights(lib, taxa, paths["card"])
            torch.cuda.synchronize()
            walls["wall"] = time.perf_counter() - t0
        launches = dict(cuda_kernels.LAUNCHES)
        require_launches(f"bracken {kind}", launches, (*kernels[kind], "scan_stitch"),
                         [k for k in ("scan", "scan_lut", "scan_wide", "probe", "probe_slots", "probe_wide")
                          if k not in kernels[kind]])
        add_launches(total, launches)
        t0 = time.perf_counter()
        paths["cpu"] = os.path.join(out, f"br_{kind}_cpu.kmer_distrib")
        bracken.BrackenWeights(host, 100, device="cpu").build_and_write_weights(lib, taxa, paths["cpu"])
        cpu_s = time.perf_counter() - t0
        want = open(paths["cpu"], "rb").read()
        if open(paths["card"], "rb").read() != want:
            fail(f"bracken {kind}: the card wrote other weights than the CPU")
        if distrib_totals(paths["cpu"]) != read_windows(genomes, taxa, 100):
            fail(f"bracken {kind}: a source's reads differ from its read windows")
        n_windows = sum(read_windows(genomes, taxa, 100).values())
        n_lines = len(want.splitlines()) - 1
        log(f"bracken {kind} (k={card.params.k} m={card.params.m} s={card.params.spaces} {card.params.ordering}), R = 100, "
            f"{n_windows} read windows: kmer_distrib byte-identical card = CPU ({n_lines} destination lines); card "
            f"wall {walls['wall']:.3f} s (fragment pass {walls['fragment_pass']:.3f}, device window classifier and "
            f"counts {walls['window_dest_counts']:.3f}); CPU (numpy counts) {cpu_s:.1f} s")

    # bracken-build through the CLI: a gradual run that lost its last chunk resumes from the others
    card = bases["narrow"][0]
    lib_dir, idx_dir = os.path.join(out, "br_lib"), os.path.join(out, "br_idx")
    workloads.write_library(genomes, lib_dir)
    card.save(idx_dir)
    taxa = GenomeLibrary.from_directory(lib_dir).taxon_set(card.taxonomy)
    tmp = os.path.join(f"{idx_dir}_bracken", "database100mers.kmer_distrib_tmp")
    cuda_kernels.reset_launch_counts()
    with twins_forbidden():
        bw = bracken.BrackenWeights(card, 100, device=dev)
        chunked = bw.build_weights_gradually(GenomeLibrary.from_directory(lib_dir), taxa, tmp)
        chunks = sorted(os.listdir(tmp))
        os.remove(os.path.join(tmp, chunks[-1]))
        calls = []
        real = bracken.BrackenWeights.build_weights
        bracken.BrackenWeights.build_weights = lambda self, *a: calls.append(1) or real(self, *a)
        try:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                if cli.main(["bracken-build", "-i", idx_dir, "-l", lib_dir]) != 0:
                    fail("bracken-build failed on the card")
        finally:
            bracken.BrackenWeights.build_weights = real
    launches = dict(cuda_kernels.LAUNCHES)
    require_launches("bracken-build CLI", launches, ("scan", "scan_stitch", "probe_slots"))
    add_launches(total, launches)
    written = os.path.join(f"{idx_dir}_bracken", "database100mers.kmer_distrib")
    bracken.write_kmer_distrib(chunked, os.path.join(out, "br_chunked.kmer_distrib"))
    if (len(calls) != 1 or os.path.exists(tmp) or open(written, "rb").read()
            != open(os.path.join(out, "br_chunked.kmer_distrib"), "rb").read()
            or open(written, "rb").read() != open(os.path.join(out, "br_narrow_cpu.kmer_distrib"), "rb").read()):
        fail(f"bracken-build did not resume from {len(chunks) - 1} of {len(chunks)} chunks to the same weights "
             f"({len(calls)} chunks computed)")
    log(f"bracken-build CLI resumed from {len(chunks) - 1} of {len(chunks)} chunk files, computed 1, wrote the same "
        f"weights as the CPU; printed {buf.getvalue().strip()!r}")
    return total


#: positions of the fragment row on which the device window classifier is
#: held to the numpy counts at scale (and the numpy counts timed)
SAMPLE_POSITIONS = 1 << 18


def bracken_at_scale(dev, out, label, genomes, params, records=None):
    """Bracken weights at R = 100 of one 400 Mbp library on the card: its
    index with `params` built there (scale_taxonomy_deep), then the weights with
    the wall of the fragment passes and of the device window classifier
    timed apart, each source's reads equal to its read windows, the rows'
    hit taxa and the peak device memory; last the device classifier held to
    the numpy counts on the first SAMPLE_POSITIONS of the first fragment,
    both timed. Returns the launch counts of the weights' run."""
    import torch

    from slacken_tpu_torch import bracken, workloads
    from slacken_tpu_torch.index import KeyValueIndex
    from slacken_tpu_torch.ops import cuda_kernels, encode

    tax = workloads.scale_taxonomy_deep(SCALE_TAXA)
    torch.cuda.empty_cache()
    cuda_kernels.reset_launch_counts()
    with twins_forbidden():
        t0 = time.perf_counter()
        idx = KeyValueIndex.build(iter(genomes), params, tax, dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        if records is not None and idx.num_records != records:
            fail(f"the {label} index for bracken holds {idx.num_records} records")
        lib, taxa = workloads.GenomeList(genomes), {t for t, _ in genomes}
        bw = bracken.BrackenWeights(idx, 100, dev)
        n_windows = sum(read_windows(genomes, taxa, 100).values())
        n_fragments = sum(1 for _ in bw._iter_fragments(lib, taxa))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        seconds, row_taxa = {}, []
        real_taxa = bracken.hit_taxa_per_row

        def spy(scan):
            n = real_taxa(scan)
            row_taxa.append(n.cpu())
            return n

        bracken.hit_taxa_per_row = spy
        try:
            with timed_calls(bracken, "fragment_pass", seconds), timed_calls(bracken, "window_dest_counts", seconds):
                t0 = time.perf_counter()
                counts = bw.build_weights(lib, taxa)
                torch.cuda.synchronize()
                seconds["wall"] = time.perf_counter() - t0
        finally:
            bracken.hit_taxa_per_row = real_taxa
        peak = torch.cuda.max_memory_allocated()
        launches = dict(cuda_kernels.LAUNCHES)
        names, never = ((("scan_wide", "probe_wide"), ("scan", "scan_lut", "probe", "probe_slots")) if idx.wide
                        else (("scan", "probe_slots"), ("scan_wide", "scan_lut", "probe", "probe_wide")))
        require_launches(f"bracken at scale, {label}", launches, (*names, "scan_stitch"), never)
        # the device classifier against the numpy counts on one long row
        codes = encode.encode_seq(genomes[0][1][:SAMPLE_POSITIONS])[None, :]
        scan = bracken.fragment_pass(idx, codes, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        on_card = bracken.window_dest_counts(scan, bw._rpath_table(), 100, params.k, [SAMPLE_POSITIONS - 99])[0]
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
    host = [x.cpu().numpy()[0] for x in scan]
    t0 = time.perf_counter()
    by_numpy = bw._fragment_dest_counts(*host, SAMPLE_POSITIONS)
    numpy_s = time.perf_counter() - t0
    if on_card != by_numpy:
        fail(f"bracken at scale, {label}: the device window classifier and the numpy counts differ on a "
             f"{SAMPLE_POSITIONS}-position row")
    path = os.path.join(out, "br_scale.kmer_distrib")
    bracken.write_kmer_distrib(counts, path)
    if distrib_totals(path) != read_windows(genomes, taxa, 100):
        fail(f"bracken at scale, {label}: a source's reads differ from its read windows")
    row_taxa = torch.cat(row_taxa)
    many = int((row_taxa > bracken.FEW_TAXA).sum())
    mw = lambda s: n_windows / s / 1e6  # noqa: E731
    log(f"bracken at scale, {label}, R = 100: {sum(len(g) for _, g in genomes) / 1e6:.0f} Mbp, index "
        f"(k={params.k} m={params.m} s={params.spaces}) of "
        f"{idx.num_records} records built on the card in {build_s:.2f} s; {n_fragments} fragments, {n_windows} read "
        f"windows, {len(counts)} (destination, source) pairs, each source's reads equal to its read windows")
    log(f"bracken at scale, {label}: wall {seconds['wall']:.3f} s ({mw(seconds['wall']):.2f} Mwindows/s), fragment "
        f"passes {seconds['fragment_pass']:.3f} s ({mw(seconds['fragment_pass']):.2f} Mwindows/s), device window "
        f"classifier and counts {seconds['window_dest_counts']:.3f} s ({mw(seconds['window_dest_counts']):.2f} "
        f"Mwindows/s); hit taxa a row: median {float(row_taxa.float().median()):.0f}, max {int(row_taxa.max())}, "
        f"{many} of {len(row_taxa)} rows above {bracken.FEW_TAXA} (classified in a group of their own); peak "
        f"torch.cuda.max_memory_allocated {peak} bytes")
    n = SAMPLE_POSITIONS - 99
    log(f"bracken at scale, {label}: on the first {SAMPLE_POSITIONS} positions of taxon {genomes[0][0]} "
        f"({int(real_taxa(scan)[0])} hit taxa), device window classifier == numpy counts: card {card_s:.4f} s "
        f"({n / card_s / 1e6:.2f} Mwindows/s), numpy {numpy_s:.3f} s ({n / numpy_s / 1e6:.2f} Mwindows/s)")
    return launches


def phase_bracken_scale(dev, out, genomes):
    """Bracken at scale on the card only, on two 400 Mbp libraries of 64
    species in 16 genera in 4 families: scale_library's disjoint random
    genomes (every read window goes to its own species), and
    related_library's mutated copies (windows shared within genera and
    families, many hit taxa a row, ties), each with a narrow index; then the
    disjoint library with a wide (50, 45, 7) index (the wide scan on the
    fragment rows). Returns the launch counts."""
    from slacken_tpu_torch import workloads
    from slacken_tpu_torch.index import IndexParams

    narrow = IndexParams(k=35, m=31, spaces=7)
    launches = bracken_at_scale(dev, out, "disjoint genomes", genomes, narrow, SCALE_RECORDS)
    related = list(workloads.related_library(SCALE_BP, SCALE_TAXA))
    add_launches(launches, bracken_at_scale(dev, out, "related genomes", related, narrow))
    del related
    add_launches(launches, bracken_at_scale(dev, out, "disjoint genomes, wide index", genomes,
                                            IndexParams(k=50, m=45, spaces=7)))
    return launches


def phase_compare_index(dev, out, bases):
    """compareIndex (MinimizerMigration: the join through the probe) of the
    bench index with its dynamic index restricted to two of the three
    genomes, both ways round, narrow and wide, card (twins forbidden)
    against CPU: printed histogram and taxaToRoot report byte-identical.
    Then the CLI's compareIndex on saved indexes, and the host-only
    inputCheck and build --check. Returns the card's launch counts."""
    from slacken_tpu_torch import cli, workloads
    from slacken_tpu_torch.analysis.migration import MinimizerMigration
    from slacken_tpu_torch.ops import cuda_kernels

    keep = set(list(workloads.BENCH_SIZES)[:2]) | {1}
    total = {}
    for kind, probe_name in (("narrow", "probe_slots"), ("wide", "probe_wide")):
        card, host = bases[kind]
        card.to(dev)
        pairs = {"card": (card, card.build_restricted(keep)), "cpu": (host, host.build_restricted(keep))}
        printed = {}
        cuda_kernels.reset_launch_counts()
        for where, device in (("card", dev), ("cpu", "cpu")):
            full, restricted = pairs[where]
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf), (twins_forbidden() if where == "card" else contextlib.nullcontext()):
                t0 = time.perf_counter()
                for tag, (a, b) in (("rf", (restricted, full)), ("fr", (full, restricted))):
                    MinimizerMigration(a, b, device).run(os.path.join(out, f"ci_{kind}_{tag}_{where}"))
                dt = time.perf_counter() - t0
            printed[where] = (buf.getvalue(), dt)
            if where == "card":
                launches = dict(cuda_kernels.LAUNCHES)
                require_launches(f"compareIndex {kind}", launches, (probe_name,))
                add_launches(total, launches)
        for tag in ("rf", "fr"):
            a = open(os.path.join(out, f"ci_{kind}_{tag}_card_taxaToRoot_report.txt"), "rb").read()
            if a != open(os.path.join(out, f"ci_{kind}_{tag}_cpu_taxaToRoot_report.txt"), "rb").read():
                fail(f"compareIndex {kind} {tag}: the taxaToRoot report differs between the card and the CPU")
        if printed["card"][0] != printed["cpu"][0] or printed["card"][0].count("steps\tcount") != 2:
            fail(f"compareIndex {kind}: the printed histograms differ between the card and the CPU")
        log(f"compareIndex {kind}: bench index ({card.num_records} records) against its restriction to two genomes "
            f"({pairs['card'][1].num_records}), both ways: histograms and taxaToRoot reports byte-identical card vs CPU "
            f"({printed['card'][1]:.3f} s on the card, {printed['cpu'][1]:.3f} s on the CPU); the card printed "
            + " | ".join(printed["card"][0].splitlines()))

    # the CLI: compareIndex on saved indexes; inputCheck and build --check need no device
    card = bases["narrow"][0]
    lib_dir = os.path.join(out, "ci_lib")
    genomes = list(workloads.bench_library(np.random.default_rng(workloads.BENCH_SEED)))
    workloads.write_library(genomes + [(9606, "N" * 300)], lib_dir)
    card.save(os.path.join(out, "ci_full"))
    card.build_restricted(keep).save(os.path.join(out, "ci_restricted"))
    workloads.bench_taxonomy().save(os.path.join(out, "ci_tax"))
    runs = [["compareIndex", "-i", os.path.join(out, "ci_restricted"), "-r", os.path.join(out, "ci_full"),
             "-o", os.path.join(out, "ci_cli")],
            ["inputCheck", "-t", os.path.join(out, "ci_tax"), "--labels", os.path.join(lib_dir, "seqid2taxid.map")],
            ["build", "--check", "-i", os.path.join(out, "ci_none"), "-l", lib_dir, "-t", os.path.join(out, "ci_tax")]]
    buf = io.StringIO()
    cuda_kernels.reset_launch_counts()
    with contextlib.redirect_stdout(buf), twins_forbidden():
        for argv in runs:
            if cli.main(argv) != 0:
                fail(f"the CLI failed on the card: {argv}")
    launches = dict(cuda_kernels.LAUNCHES)
    require_launches("compareIndex CLI", launches, ("probe_slots",))
    add_launches(total, launches)
    text = buf.getvalue()
    if (open(os.path.join(out, "ci_cli_taxaToRoot_report.txt"), "rb").read()
            != open(os.path.join(out, "ci_narrow_rf_cpu_taxaToRoot_report.txt"), "rb").read()
            or '"sequences": 4' not in text or "(total 1):" not in text or os.path.exists(os.path.join(out, "ci_none"))):
        fail(f"compareIndex, inputCheck or build --check through the CLI printed {text!r}")
    log("compareIndex, inputCheck and build --check through cli.main: the report equals the API's on the CPU; "
        "printed " + " | ".join(text.splitlines()))
    return total


MESH_SHARDS = 8


def phase_mesh(dev, out, reads, bases):
    """The device mesh at bench size, with the twins forbidden on the card:
    MeshClassifier over Mesh([cuda] * 8) in the replicated and the ring
    layout, reports and per-read mode, for the narrow bench index, the wide
    (50, 45, 7) and the (35, 13, 3) signature index that the earlier phases
    saved, against their single-device card runs' files and, per-read (whose
    files include the kreports), the same mesh over [cpu] * 8;
    build_distributed over 8 shards against the single-device builds with
    their sidecars; Dynamic over the ring (span hits; with and without the
    sidecar, so the dynamic index also by build_distributed) against the
    single-device run; the CLI with --devices torch.cuda.device_count() (build
    --shards 4, classify ring and replicated, classify2) against the
    single-device CLI, and --devices one above the count refused. Returns the
    card's launch counts."""
    import torch

    from slacken_tpu_torch import cli, dynamic, workloads
    from slacken_tpu_torch.classify import Classifier, ClassifyParams, Fragment
    from slacken_tpu_torch.index import IndexParams, KeyValueIndex
    from slacken_tpu_torch.ops import cuda_kernels
    from slacken_tpu_torch.parallel.classifier import MeshClassifier, build_distributed
    from slacken_tpu_torch.parallel.mesh import Mesh

    mesh, cpu_mesh = Mesh([dev] * MESH_SHARDS), Mesh(["cpu"] * MESH_SHARDS)
    n_reads = sum(len(p) for p in reads)
    modes = {"rep": ClassifyParams(thresholds=[0.0, 0.15], per_read_output=False),
             "det": ClassifyParams(thresholds=[0.0, 0.15], per_read_output=True)}
    # kind -> (saved index, its single-device card runs in reports and per-read mode, scan, probe)
    kinds = {"narrow": ("idx", "gpu", "det", "scan", "probe_slots"),
             "wide (50, 45, 7)": ("w45_idx", "w45_rep", "w45_det", "scan_wide", "probe_wide"),
             "signature (35, 13, 3)": ("signature_idx", "signature_rep", "signature_det", "scan_lut", "probe_slots")}
    total = {}
    for kind, (idx_dir, rep_dir, det_dir, scan, probe) in kinds.items():
        idx = KeyValueIndex.load(os.path.join(out, idx_dir))
        idx_card = idx.with_records(idx.keys_t.to(dev), idx.taxa_t.to(dev))
        want = {"rep": output_tree(os.path.join(out, rep_dir)), "det": output_tree(os.path.join(out, det_dir))}
        for layout in ("replicated", "ring"):
            tag = f"mesh_{idx_dir}_{layout}"
            cuda_kernels.reset_launch_counts()
            with twins_forbidden():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                cls = MeshClassifier(idx_card, mesh, layout)
                torch.cuda.synchronize()
                setup_s = time.perf_counter() - t0
                cls.classify_and_write_packed(reads[:1], os.path.join(out, f"{tag}_warm"), modes["rep"])
                walls = {mode: timed_runs(lambda r: cls.classify_and_write_packed(
                    reads, os.path.join(out, f"{tag}_{mode}"), cpar), n=1)[0] for mode, cpar in modes.items()}
                WALLS[f"mesh {kind} {layout}"] = walls
            launches = dict(cuda_kernels.LAUNCHES)
            require_launches(f"mesh {kind} {layout}", launches, (scan, probe),
                             [k for k in ("scan", "scan_lut", "scan_wide", "probe", "probe_slots", "probe_wide")
                              if k not in (scan, probe)])
            add_launches(total, launches)
            for mode in modes:
                got = output_tree(os.path.join(out, f"{tag}_{mode}"))
                if got != want[mode] or len(got) != (2 if mode == "rep" else 4):
                    fail(f"mesh {kind} {layout}: the {mode} output differs from the single-device card run's")
            t0 = time.perf_counter()
            MeshClassifier(idx, cpu_mesh, layout).classify_and_write_packed(
                reads, os.path.join(out, f"{tag}_detcpu"), modes["det"])
            cpu_s = time.perf_counter() - t0
            if output_tree(os.path.join(out, f"{tag}_detcpu")) != want["det"]:
                fail(f"mesh {kind} {layout}: the mesh over [cpu] * {MESH_SHARDS} differs from the card's")
            log(f"mesh {kind}, {layout} over Mesh([{dev}] * {MESH_SHARDS}): kreports and per-read lines "
                f"byte-identical to the single-device card run and to the CPU mesh ({cpu_s:.1f} s per-read); "
                f"set-up {setup_s:.3f} s, {n_reads / walls['rep']:.1f} reads/s in reports mode, "
                f"{n_reads / walls['det']:.1f} per-read (one warm run each); launches {launches}")
        del idx, idx_card, cls

    # build_distributed against the single-device builds with their sidecars
    tax = workloads.bench_taxonomy()
    library = lambda: workloads.bench_library(np.random.default_rng(workloads.BENCH_SEED))  # noqa: E731
    cuda_kernels.reset_launch_counts()
    for kind, (card_idx, host_idx) in bases.items():
        with twins_forbidden():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            built = build_distributed(library(), card_idx.params, tax, mesh, ordering_lut=card_idx.ordering_lut,
                                      keep_records=True)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
        if not (index_equal(built, host_idx) and torch.equal(built.record_keys_t.cpu(), host_idx.record_keys_t)
                and torch.equal(built.record_taxa_t.cpu(), host_idx.record_taxa_t)):
            fail(f"build_distributed {kind}: keys, taxa or sidecar differ from the single-device build")
        log(f"build_distributed over Mesh([{dev}] * {MESH_SHARDS}), {kind} ({card_idx.params.k}, {card_idx.params.m}, "
            f"{card_idx.params.spaces}, {card_idx.params.ordering}): {built.num_records} records and "
            f"{built.record_taxa_t.shape[0]} sidecar pairs equal to the single-device build in {build_s:.3f} s "
            f"({8e6 / build_s / 1e6:.2f} Mbp/s incl. library generation and host packing)")
    launches = dict(cuda_kernels.LAUNCHES)
    require_launches("build_distributed at bench size", launches, ("scan", "scan_wide", "scan_lut"))
    add_launches(total, launches)

    # two-step classification over the ring against the single-device run
    genomes = list(library())
    present = [p for i, p in enumerate(reads) if i % 3 != 2]
    fragments = [Fragment(t, s) for t, s in workloads.read_sequences(present)]
    narrow = bases["narrow"][0]
    cpar = ClassifyParams(thresholds=[0.0], per_read_output=True)
    cuda_kernels.reset_launch_counts()
    for sidecar in (True, False):
        base = narrow if sidecar else narrow.with_records(narrow.keys_t, narrow.taxa_t)
        made, walls = {}, {}
        for where, devices, layout in (("one", None, None), ("ring", mesh, "ring")):
            d = dynamic.Dynamic(base, workloads.GenomeList(genomes), 8, dynamic.MinimizerDistinctCount(500), cpar,
                                None, os.path.join(out, f"mesh_c2_{sidecar}_{where}", "dyn"), dev,
                                devices=devices, layout=layout)
            with twins_forbidden():
                t0 = time.perf_counter()
                made[where] = d.two_step_classify_and_write(fragments)
                torch.cuda.synchronize()
                walls[where] = time.perf_counter() - t0
        got = files_under(os.path.join(out, f"mesh_c2_{sidecar}_ring", "dyn"))
        want = files_under(os.path.join(out, f"mesh_c2_{sidecar}_one", "dyn"))
        if got != want or len(got) != 3 or not index_equal(made["ring"], made["one"]):
            fail(f"classify2 over the ring ({'sidecar' if sidecar else 'no sidecar'}) differs from one device")
        log(f"classify2 over Mesh([{dev}] * {MESH_SHARDS}), ring, MinimizerDistinctCount(500), dynamic index "
            f"{'from the sidecar' if sidecar else 'by build_distributed'}: taxon set "
            f"{got['_taxonSet.txt'].decode().split()}, kreport and per-read lines byte-identical to one device; "
            f"{walls['ring']:.2f} s against {walls['one']:.2f} s")
    launches = dict(cuda_kernels.LAUNCHES)
    require_launches("classify2 over the ring", launches)
    add_launches(total, launches)

    # the CLI on every card of the machine
    count = torch.cuda.device_count()
    lib_dir, fastq = os.path.join(out, "c2lib"), os.path.join(out, "c2reads.fastq")
    lib = ["-l", lib_dir, "-t", os.path.join(out, "c2idx_s7", "taxonomy")]
    mesh_args = ["--devices", str(count)]
    on = ["--device", dev.type]
    cuda_kernels.reset_launch_counts()
    runs = {"build1": ["build", "-i", os.path.join(out, "mcli_idx1"), *lib],
            "buildN": ["build", "-i", os.path.join(out, "mcli_idxN"), *lib, *mesh_args, "--shards", "4"]}
    for layout in ("ring", "replicated"):
        runs[f"one_{layout}"] = ["classify", fastq, "-i", os.path.join(out, "mcli_idx1"), "-c", "0.0", "0.15",
                                 "-o", os.path.join(out, f"mcli_one_{layout}", "o")]
        runs[f"mesh_{layout}"] = ["classify", fastq, "-i", os.path.join(out, "mcli_idxN"), "-c", "0.0", "0.15",
                                  "-o", os.path.join(out, f"mcli_mesh_{layout}", "o"), *mesh_args, "--layout", layout]
    runs["c2_one"] = ["classify2", fastq, "-i", os.path.join(out, "mcli_idx1"), "-l", lib_dir, "-D", "500",
                      "-o", os.path.join(out, "mcli_c2_one", "o")]
    runs["c2_mesh"] = ["classify2", fastq, "-i", os.path.join(out, "mcli_idxN"), "-l", lib_dir, "-D", "500",
                       "-o", os.path.join(out, "mcli_c2_mesh", "o"), *mesh_args, "--layout", "ring"]
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed), twins_forbidden():
        for name, argv in runs.items():
            t0 = time.perf_counter()
            if cli.main([*argv, *on]) != 0:
                fail(f"the mesh CLI failed: {argv}")
            runs[name] = time.perf_counter() - t0
    launches = dict(cuda_kernels.LAUNCHES)
    require_launches(f"the CLI with --devices {count}", launches)
    add_launches(total, launches)
    one, many = KeyValueIndex.load(os.path.join(out, "mcli_idx1")), KeyValueIndex.load(os.path.join(out, "mcli_idxN"))
    if not index_equal(one, many) or sorted(os.listdir(os.path.join(out, "mcli_idxN")))[:4] != [
            f"keys.{i:05d}.npy" for i in range(4)]:
        fail(f"build --devices {count} --shards 4 differs from the single-device build")
    for a, b in (("mcli_one_ring", "mcli_mesh_ring"), ("mcli_one_replicated", "mcli_mesh_replicated"),
                 ("mcli_c2_one", "mcli_c2_mesh")):
        got, want = files_under(os.path.join(out, b, "")), files_under(os.path.join(out, a, ""))
        if got != want or len(got) < 3:
            fail(f"the CLI's {b} differs from {a}: {sorted(got)} against {sorted(want)}")
    log(f"CLI with --devices {count} ({'distinct cards' if count > 1 else 'the one card'}): build --shards 4 "
        f"({one.num_records} records), classify --layout ring and replicated, classify2 --layout ring byte-identical "
        "to the single-device CLI; walls " + ", ".join(f"{k} {v:.2f} s" for k, v in runs.items()))
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["classify", fastq, "-i", os.path.join(out, "mcli_idx1"), "-o", os.path.join(out, "mcli_over"),
                      "--devices", str(count + 1), "--layout", "ring"])
    except ValueError as e:
        log(f"--devices {count + 1} refused: {e}")
    else:
        fail(f"--devices {count + 1} on a machine of {count} cards did not raise")
    if count > 1:
        from slacken_tpu_torch.parallel.mesh import make_mesh

        for layout in ("replicated", "ring"):
            cls = MeshClassifier(bases["narrow"][0], make_mesh(count, "cuda"), layout)
            cls.classify_and_write_packed(reads, os.path.join(out, f"mesh_cards_{layout}"), modes["det"])
            if output_tree(os.path.join(out, f"mesh_cards_{layout}")) != output_tree(os.path.join(out, "det")):
                fail(f"the mesh over {count} cards, {layout}, differs from one card")
        log(f"the bench reads over {count} distinct cards, replicated and ring: byte-identical to one card")
    return total


def phase_mesh_scale(dev, out, genomes, scale_idx):
    """The mesh at full size: build_distributed of the 400 Mbp scale library
    (`genomes`) over Mesh([cuda] * 8) against phase_scale's index
    (`scale_idx`), then the 200,000 scale reads classified by the ring over
    8 shards against phase_scale's kreport; walls, peak device memory and the
    device's busy share. Returns the launch counts."""
    import torch

    from slacken_tpu_torch import workloads
    from slacken_tpu_torch.classify import ClassifyParams
    from slacken_tpu_torch.index import IndexParams
    from slacken_tpu_torch.ops import cuda_kernels
    from slacken_tpu_torch.parallel.classifier import MeshClassifier, build_distributed
    from slacken_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh([dev] * MESH_SHARDS)
    tax = workloads.scale_taxonomy(SCALE_TAXA)
    before = torch.cuda.memory_allocated()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cuda_kernels.reset_launch_counts()
    with twins_forbidden():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx = build_distributed(iter(genomes), IndexParams(k=35, m=31, spaces=7), tax, mesh)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        build_peak = torch.cuda.max_memory_allocated() - before
        if idx.num_records != SCALE_RECORDS:
            fail(f"build_distributed at scale gave {idx.num_records} records, expected {SCALE_RECORDS}")
        if not index_equal(idx, scale_idx):
            fail("build_distributed at scale differs from the single-device build")
        log(f"build_distributed at scale over Mesh([{dev}] * {MESH_SHARDS}): {idx.num_records} records equal to "
            f"the single-device build in {build_s:.2f} s ({SCALE_BP / build_s / 1e6:.2f} Mbp/s incl. host packing, "
            f"the library made before); peak torch.cuda.max_memory_allocated {build_peak} bytes above the "
            f"{before} bytes held before")
        reads = workloads.scale_reads(SCALE_BP, SCALE_TAXA, library=genomes)
        n_reads = sum(len(p) for p in reads)
        cpar = ClassifyParams(thresholds=[0.0], per_read_output=False)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cls = MeshClassifier(idx, mesh, "ring")
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        cls.classify_and_write_packed(reads[:1], os.path.join(out, "mscale_warm"), cpar)
        dt = timed_runs(lambda r: cls.classify_and_write_packed(reads, os.path.join(out, "mscale"), cpar), n=1)[0]
        WALLS["mesh scale ring"] = dt
        ring_peak = torch.cuda.max_memory_allocated() - before
    launches = dict(cuda_kernels.LAUNCHES)
    want = open(os.path.join(out, "scale_c0.0", "all_kreport.txt"), "rb").read()
    if open(os.path.join(out, "mscale_c0.0", "all_kreport.txt"), "rb").read() != want:
        fail("the ring over 8 shards at scale wrote another kreport than the single-device classify")
    c, total = classified_count(os.path.join(out, "mscale_c0.0", "all_kreport.txt"))
    log(f"ring classify at scale over Mesh([{dev}] * {MESH_SHARDS}): kreport byte-identical to the single-device "
        f"run; shards and their directories {setup_s:.3f} s; {n_reads} reads in {dt:.3f} s, {n_reads / dt:.1f} "
        f"reads/s, classified {c} of {total}; peak torch.cuda.max_memory_allocated {ring_peak} bytes above the "
        f"{before} held before")
    require_launches("mesh at scale (build_distributed, ring classify)", launches)
    build_distributed(iter(genomes), IndexParams(k=35, m=31, spaces=7), tax, mesh)
    cls.classify_and_write_packed(reads, os.path.join(out, "mscale_prof"), cpar)
    return launches


MH_SHARDS = 8
MH_TIMEOUT = 600  # seconds that one spawned group of ranks may take
#: kind -> (saved index, its single-device card runs in reports and per-read mode, scan, probe)
MH_KINDS = {"narrow": ("idx", "gpu", "det", "scan", "probe_slots"),
            "wide (50, 45, 7)": ("w45_idx", "w45_rep", "w45_det", "scan_wide", "probe_wide"),
            "signature (35, 13, 3)": ("signature_idx", "signature_rep", "signature_det", "scan_lut", "probe_slots")}
#: each kind's index parameters (the earlier phases build them so)
MH_PARAMS = {"narrow": dict(k=35, m=31, spaces=7), "wide (50, 45, 7)": dict(k=50, m=45, spaces=7),
             "signature (35, 13, 3)": dict(k=35, m=13, spaces=3, ordering="signature")}
#: the padding job: an odd count of reads in batches of MH_ODD_ROWS, so that
#: in two ranks the smaller share is one batch short of the larger
MH_ODD_READS, MH_ODD_ROWS = 4097, 2048


#: ports handed out by free_port in this process
_PORTS_GIVEN = set()


def free_port():
    """A TCP port of 127.0.0.1 that is free now, below the kernel's default
    range of ephemeral ports (32768 and up): a port from that range, picked
    before a run of jobs, can be taken by a socket that a job opens before
    the coordinator binds it (EADDRINUSE). Never the same port twice."""
    import random
    import socket

    pick = random.SystemRandom()
    while True:
        port = pick.randrange(20000, 32768)
        if port in _PORTS_GIVEN:
            continue
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        _PORTS_GIVEN.add(port)
        return port


def first_reads(reads, n):
    """The first n reads of single-read chunks, as chunks."""
    from slacken_tpu_torch import native

    got = []
    for p in reads:
        take = min(n - sum(len(g) for g in got), len(p))
        if take <= 0:
            break
        got.append(native.PackedReads(p.codes[:take], p.lengths[:take], list(p.titles)[:take]))
    return got


def joined_parts(files):
    """An output tree with the per-read part files of each directory joined
    in name order, under the first part's name."""
    out = {}
    for name in sorted(files):
        d, base = os.path.split(name)
        key = os.path.join(d, "part-00000.txt.gz") if base.startswith("part-") else name
        out[key] = out.get(key, b"") + files[name]
    return out


def mh_rank(rank, spec):
    """One spawned rank of phase_multihost. Library jobs first: join the
    group that `spec` describes once, then for each job a
    MultiHostRingClassifier, a warm run of one chunk and a timed run of the
    job's reads (and, where the job asks, a run under the profiler); leave
    the group. Then CLI jobs: cli.main with --coordinator on a port of the
    job's own. All with the twins forbidden; the rank's launches, walls,
    lockstep, bytes sent and peak device memory of each job go, in the
    order of the jobs, to spec["report"] % rank."""
    import torch

    from slacken_tpu_torch import cli
    from slacken_tpu_torch.classify import ClassifyParams
    from slacken_tpu_torch.ops import cuda_kernels
    from slacken_tpu_torch.parallel import multihost

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // spec["world"]))
    cuda = spec["device"].startswith("cuda")
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    lib = [job for job in spec["jobs"] if "argv" not in job]
    done = []
    with twins_forbidden() if cuda else contextlib.nullcontext():  # the twins are the CPU's path
        if lib:
            ctx = multihost.initialize(spec["url"], spec["world"], rank, spec["device"], spec["devices"],
                                       spec["backend"])
        for job in lib:
            reads = spec["reads"][job["reads"]]
            cpar = ClassifyParams(thresholds=job["thresholds"], per_read_output=job["per_read"])
            if cuda:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated() if cuda else 0
            t0 = time.perf_counter()
            cls = multihost.MultiHostRingClassifier(job["index"], ctx)
            sync()
            setup = time.perf_counter() - t0
            # the first boundary hops build the P2P channels: outside the walls
            cls.classify_and_write_stream(lambda: iter(reads[:1]), job["out"] + "_warm", cpar, job.get("rows"))
            cuda_kernels.reset_launch_counts()
            sent = cls.p2p_bytes
            sync()
            multihost.allgather_objects(None)  # every rank starts the wall together
            t0 = time.perf_counter()
            cls.classify_and_write_stream(lambda: iter(reads), job["out"], cpar, job.get("rows"))
            sync()
            wall = time.perf_counter() - t0
            done.append({"tag": job["tag"], "setup": setup, "wall": wall, "launches": dict(cuda_kernels.LAUNCHES),
                         "lockstep": cls.lockstep, "padding": cls.padding_dispatches, "p2p": cls.p2p_bytes - sent,
                         "peak": torch.cuda.max_memory_allocated() - before if cuda else None})
            if job.get("profile") and cuda:
                cls.classify_and_write_stream(lambda: iter(reads), job["out"] + "_prof", cpar, job.get("rows"))
            del cls
        if lib:
            multihost.shutdown()
        for job in spec["jobs"][len(lib):]:
            argv = [*job["argv"], "--coordinator", f"127.0.0.1:{job['port']}",
                    "--num-processes", str(spec["world"]), "--process-id", str(rank)]
            cuda_kernels.reset_launch_counts()
            said = io.StringIO()
            sync()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(said):
                rc = cli.main(argv)
            sync()
            wall = time.perf_counter() - t0
            if rc != 0:
                fail(f"rank {rank}: the CLI exited {rc}: {argv}")
            done.append({"tag": job["tag"], "wall": wall, "launches": dict(cuda_kernels.LAUNCHES),
                         "said": [x for x in said.getvalue().splitlines() if x.startswith("process ")]})
    with open(spec["report"] % rank, "w") as f:
        json.dump(done, f)


def spawn_ranks(out, name, world, spec):
    """mh_rank in `world` spawned processes; a rank that fails or a group
    that outlasts MH_TIMEOUT fails the script. Returns each rank's report
    and the wall of the whole group (process start-up included)."""
    import torch.multiprocessing as mp

    spec = dict(spec, world=world, report=os.path.join(out, f"mh_{name}_rank%d.json"))
    t0 = time.perf_counter()
    procs = mp.start_processes(mh_rank, args=(spec,), nprocs=world, join=False, start_method="spawn")
    try:
        while not procs.join(timeout=5):
            if time.perf_counter() - t0 > MH_TIMEOUT:
                fail(f"multihost {name}: the ranks did not finish in {MH_TIMEOUT} s")
    except (mp.ProcessExitedException, mp.ProcessRaisedException) as e:
        fail(f"multihost {name}: {e}")
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.kill()
    reports = []
    for r in range(world):
        with open(spec["report"] % r) as f:
            reports.append(json.load(f))
    return reports, time.perf_counter() - t0


def mh_jobs(out, variant, idx_prefix, odd=False):
    """The library jobs at bench size: every kind in reports and per-read
    mode, and with `odd` the padding job (narrow, per-read). Each names the
    output prefix it writes and the single-device run it must equal."""
    jobs = []
    for kind, (idx_dir, rep_dir, det_dir, _, _) in MH_KINDS.items():
        for mode, want in (("rep", rep_dir), ("det", det_dir)):
            prefix = os.path.join(out, f"mh_{variant}_{idx_dir}_{mode}")
            jobs.append({"tag": f"{kind} {mode}", "kind": kind, "index": os.path.join(out, idx_prefix + idx_dir),
                         "reads": "bench", "out": prefix, "prefix": prefix, "want": want, "per_read": mode == "det",
                         "thresholds": [0.0, 0.15], "profile": kind == "narrow" and mode == "rep"})
    if odd:
        prefix = os.path.join(out, f"mh_{variant}_odd")
        jobs.append({"tag": f"padding: {MH_ODD_READS} reads in batches of {MH_ODD_ROWS}", "kind": "narrow",
                     "index": os.path.join(out, idx_prefix + "idx"), "reads": "odd", "out": prefix, "prefix": prefix,
                     "want": "mh_single_odd", "per_read": True, "thresholds": [0.0, 0.15], "rows": MH_ODD_ROWS})
    return jobs


def mh_scale_job(out, variant):
    """The scale job: the 400 Mbp index's 8 shard files, the 200,000 scale
    reads in reports mode, against phase_scale's kreport."""
    prefix = os.path.join(out, f"mh_{variant}_scale")
    return {"tag": "scale reports", "kind": "narrow", "index": os.path.join(out, "idx8_scale"), "reads": "scale",
            "out": prefix, "prefix": prefix, "want": "scale", "per_read": False, "thresholds": [0.0], "profile": True}


def mh_cli_jobs(out, variant, fastq, device, kinds):
    """The CLI's jobs: classify --coordinator of the bench FASTQ against each
    kind's 8 shard files in both modes (the rank adds its group's options)."""
    jobs = []
    for kind in kinds:
        idx_dir, rep_dir, det_dir = MH_KINDS[kind][:3]
        for mode, want in (("rep", rep_dir), ("det", det_dir)):
            prefix = os.path.join(out, f"mh{variant}_{idx_dir}_{mode}", "o")
            argv = ["classify", fastq, "-i", os.path.join(out, f"mh_{idx_dir}"), "-c", "0.0", "0.15", "-o", prefix,
                    "--device", device, *(["--no-detailed"] if mode == "rep" else [])]
            jobs.append({"tag": f"{kind} {mode}", "kind": kind, "argv": argv, "port": free_port(), "prefix": prefix,
                         "want": want, "per_read": mode == "det"})
    return jobs


def check_mh(out, what, jobs, reports, total, single_walls):
    """Hold every job of a multihost variant to its single-device files
    (the part files joined in name order), require its kind's kernels on
    every rank, add the launches to `total`, and log the walls beside the
    single-device ones, the lockstep, the bytes a batch and the memory."""
    world = len(reports)
    for j, job in enumerate(jobs):
        recs = [r[j] for r in reports]
        scan, probe = MH_KINDS[job["kind"]][3:]
        for r, rec in enumerate(recs):
            require_launches(f"multihost {what}, rank {r}, {job['tag']}", rec["launches"], (scan, probe),
                             [k for k in ("scan", "scan_lut", "scan_wide", "probe", "probe_slots", "probe_wide")
                              if k not in (scan, probe)])
            add_launches(total, rec["launches"])
        got = output_tree(job["prefix"])
        want = output_tree(os.path.join(out, job["want"]))
        parts = sum("part-" in k for k in got)
        if joined_parts(got) != want or not want or (world > 1 and job["per_read"] and parts < 2):
            fail(f"multihost {what}, {job['tag']}: the output differs from the single-device files "
                 f"({sorted(got)} against {sorted(want)})")
        wall = max(rec["wall"] for rec in recs)
        line = (f"multihost {what}, {job['tag']}: byte-identical to one device ({len(got)} files, {parts} part "
                f"files); wall {wall:.3f} s (ranks {[round(rec['wall'], 3) for rec in recs]})")
        if job["tag"] in single_walls:
            line += f" against {single_walls[job['tag']]:.3f} s on one device"
        if "lockstep" in recs[0]:
            n_disp, rows, bucket = recs[0]["lockstep"]
            line += (f"; {n_disp} batches of {rows} x {bucket} a rank, all-padding {[rec['padding'] for rec in recs]}, "
                     f"P2P bytes a batch sent by each rank {[rec['p2p'] // n_disp for rec in recs]}; shards and "
                     f"directories {max(rec['setup'] for rec in recs):.3f} s; peak device memory a rank "
                     f"{[rec['peak'] for rec in recs]} bytes")
        else:
            line += "; " + " | ".join(x for rec in recs for x in rec["said"])
        log(line)


def mh_prepare(dev, out, reads):
    """What the multihost runs are held to and timed against: each bench
    kind's index saved again as 8 shard files; its single-device walls of the
    bench reads in both modes (job tag -> s); the padding job's reads and
    their single-device files; the bench reads as a FASTQ file."""
    from slacken_tpu_torch import workloads
    from slacken_tpu_torch.classify import Classifier, ClassifyParams
    from slacken_tpu_torch.index import KeyValueIndex

    modes = {"rep": ClassifyParams(thresholds=[0.0, 0.15], per_read_output=False),
             "det": ClassifyParams(thresholds=[0.0, 0.15], per_read_output=True)}
    odd = first_reads(reads, MH_ODD_READS)
    single = {}
    for kind, (idx_dir, *_) in MH_KINDS.items():
        idx = KeyValueIndex.load(os.path.join(out, idx_dir))
        idx.save_sharded(os.path.join(out, f"mh_{idx_dir}"), MH_SHARDS)
        cls = Classifier(idx, dev)
        cls.classify_and_write_packed(reads[:1], os.path.join(out, "mh_single_warm"), modes["rep"])
        for mode, cpar in modes.items():
            single[f"{kind} {mode}"] = timed_runs(lambda r: cls.classify_and_write_packed(
                reads, os.path.join(out, f"mh_single_{idx_dir}_{mode}"), cpar), n=1)[0]
        if kind == "narrow":
            cls.classify_and_write_packed(odd, os.path.join(out, "mh_single_odd"), modes["det"])
        del idx, cls
    fastq = os.path.join(out, "bench.fastq")
    workloads.write_fastq(reads, fastq)
    return dict(single=single, odd=odd, fastq=fastq)


def phase_multihost(dev, out, reads, genomes, prep):
    """Several processes (parallel/multihost.py, spawned ranks) on the one
    card at bench size and at scale, every output held to the single-device
    files of the earlier phases, the part files joined in name order: the
    narrow, wide (50, 45, 7) and signature (35, 13, 3) bench indexes in 8
    shard files (`mh_prepare`), classified in reports and per-read mode (1)
    by one rank with a process group under NCCL, then in the same process by
    the CLI with --coordinator --num-processes 1; (2) by two ranks sharing the
    card over gloo, two ring entries each (a ring of 4 crossing between the
    processes), which then classify an odd count of reads (the smaller share
    issues an all-padding batch) and the 200,000 scale reads against the 400
    Mbp index in 8 shard files (phase_scale's kreport). Walls beside the
    single-device walls of the same reads, P2P bytes a batch, the device's
    busy share and the peak device memory a rank. Returns the launch
    counts."""
    from slacken_tpu_torch import cli, workloads

    card = "cuda:0" if dev.type == "cuda" else "cpu"
    nccl = "nccl" if dev.type == "cuda" else "gloo"
    single, odd, fastq = prep["single"], prep["odd"], prep["fastq"]
    total, cli_single = {}, {}
    with contextlib.redirect_stdout(io.StringIO()), twins_forbidden():
        for mode in ("rep", "det"):  # the single-device CLI, beside the CLI's runs
            t0 = time.perf_counter()
            if cli.main(["classify", fastq, "-i", os.path.join(out, "idx"), "-c", "0.0", "0.15", "--device", dev.type,
                         "-o", os.path.join(out, f"mhcli_single_{mode}", "o"),
                         *(["--no-detailed"] if mode == "rep" else [])]) != 0:
                fail("the single-device CLI failed")
            cli_single[f"narrow {mode}"] = time.perf_counter() - t0
    # one process under NCCL (a group of one): the library, then the CLI with --num-processes 1
    lib_jobs, cli_jobs = mh_jobs(out, "world1", "mh_"), mh_cli_jobs(out, "cli1", fastq, dev.type, MH_KINDS)
    reports, group_s = spawn_ranks(out, "world1", 1, dict(
        url=f"tcp://127.0.0.1:{free_port()}", device=card, devices=1, backend=nccl, reads={"bench": reads},
        jobs=lib_jobs + cli_jobs))
    n = len(lib_jobs)
    check_mh(out, f"1 rank on {card}, {nccl}, 1 ring entry (process {group_s:.1f} s with start-up and the CLI)",
             lib_jobs, [r[:n] for r in reports], total, single)
    check_mh(out, f"the CLI, --num-processes 1 ({nccl})", cli_jobs, [r[n:] for r in reports], total, cli_single)
    # two ranks sharing the card over gloo, two ring entries each: the bench jobs, the padding job, the scale job
    jobs = mh_jobs(out, "gloo2", "mh_", odd=True) + [mh_scale_job(out, "gloo2")]
    scale = workloads.scale_reads(SCALE_BP, SCALE_TAXA, library=genomes)
    reports, group_s = spawn_ranks(out, "gloo2", 2, dict(
        url=f"tcp://127.0.0.1:{free_port()}", device=card, devices=2, backend="gloo",
        reads={"bench": reads, "odd": odd, "scale": scale}, jobs=jobs))
    what = f"2 ranks on {card}, gloo, 2 ring entries each (group {group_s:.1f} s with start-up)"
    check_mh(out, what, jobs, reports, total, dict(single, **{"scale reports": WALLS["scale"]}))
    if not any(r[len(jobs) - 2]["padding"] for r in reports):
        fail(f"multihost {what}: no rank issued an all-padding batch")
    log(f"multihost at scale against the one-process ring over 8 shards (phase_mesh_scale, this run): "
        f"{max(r[-1]['wall'] for r in reports):.3f} s against {WALLS['mesh scale ring']:.3f} s")
    for kind in MH_KINDS:
        ring = WALLS.get(f"mesh {kind} ring")
        if ring:
            log(f"one-process ring over 8 shards, {kind} (phase_mesh, this run): reports {ring['rep']:.3f} s, "
                f"per-read {ring['det']:.3f} s")
    return total


def phase_multihost_cards(dev, out, reads, genomes, prep):
    """On a machine of two or more cards: min(4, cards) ranks under NCCL, one
    card each, the boundary hops between cards: the bench jobs of
    phase_multihost (three kinds, both modes, the padding job) and the scale
    job in one group, then the CLI (narrow, both modes), each against the
    single-device files. Returns the launch counts."""
    import torch

    from slacken_tpu_torch import workloads

    world = min(4, torch.cuda.device_count())
    total = {}
    scale = workloads.scale_reads(SCALE_BP, SCALE_TAXA, library=genomes)
    jobs = mh_jobs(out, "cards", "mh_", odd=True) + [mh_scale_job(out, "cards")]
    reports, group_s = spawn_ranks(out, "cards", world, dict(
        url=f"tcp://127.0.0.1:{free_port()}", device="cuda", devices=1, backend="nccl",
        reads={"bench": reads, "odd": prep["odd"], "scale": scale}, jobs=jobs))
    walls = dict(prep["single"], **{"scale reports": WALLS["scale"]})
    check_mh(out, f"{world} ranks, one card each, nccl (group {group_s:.1f} s with start-up)", jobs, reports, total,
             walls)
    jobs = mh_cli_jobs(out, "clicards", prep["fastq"], "cuda", ["narrow"])
    reports, group_s = spawn_ranks(out, "clicards", world, dict(device="cuda", jobs=jobs))
    check_mh(out, f"the CLI, --num-processes {world}, one card each (group {group_s:.1f} s with start-up)", jobs,
             reports, total, {})
    return total


def main_across_cards(dev, out):
    """`chip_smoke.py --across-cards`, on a machine of two or more cards:
    only what phase_multihost_cards runs and what it is held to. The three
    bench indexes built on the card and classified there (the single-device
    files), the scale library built and classified, then
    phase_multihost_cards. Returns its launch counts."""
    import torch

    from slacken_tpu_torch import workloads
    from slacken_tpu_torch.classify import Classifier, ClassifyParams
    from slacken_tpu_torch.index import IndexParams, KeyValueIndex

    if torch.cuda.device_count() < 2:
        fail(f"--across-cards needs two or more cards, the machine has {torch.cuda.device_count()}")
    reads = workloads.bench_reads()
    library = lambda: workloads.bench_library(np.random.default_rng(workloads.BENCH_SEED))  # noqa: E731
    for kind, (idx_dir, rep_dir, det_dir, _, _) in MH_KINDS.items():
        KeyValueIndex.build(library(), IndexParams(**MH_PARAMS[kind]), workloads.bench_taxonomy(), dev).save(
            os.path.join(out, idx_dir))
        cls = Classifier(KeyValueIndex.load(os.path.join(out, idx_dir)), dev)
        for d, per_read in ((rep_dir, False), (det_dir, True)):
            cls.classify_and_write_packed(reads, os.path.join(out, d),
                                          ClassifyParams(thresholds=[0.0, 0.15], per_read_output=per_read))
    genomes = list(workloads.scale_library(SCALE_BP, SCALE_TAXA))
    idx = KeyValueIndex.build(iter(genomes), IndexParams(), workloads.scale_taxonomy(SCALE_TAXA), dev)
    if idx.num_records != SCALE_RECORDS:
        fail(f"scale index has {idx.num_records} records, expected {SCALE_RECORDS}")
    idx.save_sharded(os.path.join(out, "idx8_scale"), MH_SHARDS)
    cls = Classifier(idx, dev)
    scale = workloads.scale_reads(SCALE_BP, SCALE_TAXA, library=genomes)
    cpar = ClassifyParams(thresholds=[0.0], per_read_output=False)
    cls.classify_and_write_packed(scale[:1], os.path.join(out, "scale_warm"), cpar)
    WALLS["scale"] = timed_runs(lambda r: cls.classify_and_write_packed(scale, os.path.join(out, "scale"), cpar),
                                n=1)[0]
    log(f"scale index on the card: {idx.num_records} records; one device classifies the {sum(map(len, scale))} "
        f"reads in {WALLS['scale']:.3f} s")
    del idx, cls
    launches = phase_multihost_cards(dev, out, reads, genomes, mh_prepare(dev, out, reads))
    require_launches("multihost across cards", launches)
    return launches


def beyond_card_bp(out):
    """The --beyond-card library's size: BEYOND_BP where the host holds it,
    else the largest size above BEYOND_MIN_BP that it holds (in steps of 100
    Mbp). Host memory: the library (1 byte a base), the host leaves (12
    bytes a record) and a host index's pieces and their concatenation (24);
    disk under `out`: the spilled leaves (12); records at the scale
    library's 0.328 a base, with a fifth more for room. Prints `free -g` and
    `df`."""
    for cmd in (["free", "-g"], ["df", "-h", out]):
        log(subprocess.run(cmd, capture_output=True, text=True).stdout.rstrip())
    ram = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_AVPHYS_PAGES")
    disk = shutil.disk_usage(out).free
    per_bp = SCALE_RECORDS / SCALE_BP * 1.2
    for bp in range(BEYOND_BP, BEYOND_MIN_BP - 1, -100_000_000):
        need_ram, need_disk = bp * (1 + 36 * per_bp), bp * 12 * per_bp
        if need_ram <= ram and need_disk <= disk:
            log(f"--beyond-card: {bp} bp (host memory {ram} bytes free, needs about {need_ram:.0f}; disk {disk} "
                f"bytes free, needs about {need_disk:.0f})")
            return bp
    fail(f"--beyond-card: neither host memory ({ram} bytes) nor disk ({disk} bytes) holds a {BEYOND_MIN_BP} bp library")


def main_beyond_card(dev, out):
    """`chip_smoke.py --beyond-card`: a library whose one-sort build the card
    could not hold, built three times: under the default budget (the index
    stays on the card; keys strictly increasing, every taxon defined), and
    under a quarter of the budget then left, beside that index, through host
    leaves and through spill_dir (leaves leave the card; the index comes
    back on the host). All three equal, each build's peak device memory
    within its budget. Then 200,000 reads classified against the index on
    the card. Returns the launch counts."""
    import torch

    from slacken_tpu_torch import workloads
    from slacken_tpu_torch.classify import Classifier, ClassifyParams
    from slacken_tpu_torch.index import IndexParams, KeyValueIndex, default_device_budget
    from slacken_tpu_torch.ops import cuda_kernels

    bp = beyond_card_bp(out)
    tax = workloads.scale_taxonomy(BEYOND_TAXA)
    t0 = time.perf_counter()
    genomes = list(workloads.scale_library(bp, BEYOND_TAXA))
    log(f"library: {bp} bp in {len(genomes)} genomes, made in {time.perf_counter() - t0:.1f} s")
    card = torch.cuda.get_device_properties(dev).total_memory
    cuda_kernels.reset_launch_counts()
    first = None
    for route, kw in (("default budget", {}), ("host leaves", {"quarter": True}),
                      ("spill_dir", {"quarter": True, "spill_dir": os.path.join(out, "beyond_spill")})):
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        budget = default_device_budget(dev) // (4 if kw.pop("quarter", False) else 1)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with twins_forbidden():
            idx = KeyValueIndex.build(iter(genomes), IndexParams(), tax, dev, trace=True, device_budget=budget, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - held
        s = idx.build_stats
        log(f"beyond-card build, {route}: {idx.num_records} records in {wall:.2f} s ({bp / wall / 1e6:.2f} Mbp/s, "
            f"the library in host memory), index on {idx.keys_t.device}; peak torch.cuda.max_memory_allocated "
            f"{peak} bytes above the {held} held, budget {budget} bytes, memory_reserved "
            f"{torch.cuda.memory_reserved()}; a one-sort build at {ONE_SORT_BYTES_PER_RECORD:.1f} bytes a record "
            f"would take {idx.num_records * ONE_SORT_BYTES_PER_RECORD:.0f} of the card's {card}; leaves "
            f"{s['leaves']}, merges {s['merges']}, off the card {s['leaves_off']}, spilled {s['spilled_bytes']} "
            f"bytes in {s['spill_ranges']} ranges; leaf limit {s['leaf_entries']}, range {s['range_entries']}")
        log("  build phases (s, synchronized): " + ", ".join(f"{k} {v:.3f}" for k, v in idx.build_phases.items()))
        if idx.num_records * ONE_SORT_BYTES_PER_RECORD <= card:
            fail(f"{idx.num_records} records would fit a one-sort build on the card")
        if peak > budget:
            fail(f"beyond-card build, {route}: peak {peak} bytes above the budget {budget}")
        if first is None:
            if idx.keys_t.device.type != dev.type:
                fail(f"under the default budget the beyond-card index came back on {idx.keys_t.device}")
            keys, defined = idx.keys_t, torch.tensor(sorted(tax.taxa()), dtype=torch.int32, device=dev)
            if not bool((keys[1:] > keys[:-1]).all()) or not bool(torch.isin(idx.taxa_t, defined).all()):
                fail("the beyond-card index has keys out of order or repeated, or an undefined taxon")
            del keys, defined
            first = idx
            continue
        if s["leaves_off"] < 2 or ("spill_dir" in kw and (os.path.exists(kw["spill_dir"]) or not s["spilled_bytes"])):
            fail(f"beyond-card build, {route}: {s['leaves_off']} leaves off the card, {s['spilled_bytes']} bytes "
                 "spilled, or the spill directory was left")
        same = all(torch.equal(x, y.to(dev)) for x, y in ((first.keys_t, idx.keys_t), (first.taxa_t, idx.taxa_t)))
        if not same:
            fail(f"the beyond-card build through {route} differs from the one under the default budget")
        del idx
    log(f"beyond-card: the three builds give the same {first.num_records} records, keys strictly increasing, every "
        "taxon defined")
    reads = workloads.scale_reads(bp, BEYOND_TAXA, library=genomes)
    del genomes
    n_reads = sum(len(p) for p in reads)
    t0 = time.perf_counter()
    cls = Classifier(first, dev)
    cpar = ClassifyParams(thresholds=[0.0], per_read_output=False)
    cls.classify_and_write_packed(reads[:1], os.path.join(out, "beyond_warm"), cpar)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    dt = timed_runs(lambda r: cls.classify_and_write_packed(reads, os.path.join(out, "beyond"), cpar), n=1)[0]
    c, total = classified_count(os.path.join(out, "beyond_c0.0", "all_kreport.txt"))
    log(f"beyond-card classify on the card: {n_reads} reads in {dt:.3f} s ({n_reads / dt:.1f} reads/s; the "
        f"directory and a warm batch {load_s:.2f} s), classified {c} ({100.0 * c / n_reads:.2f}%); peak "
        f"torch.cuda.max_memory_allocated {torch.cuda.max_memory_allocated()} bytes")
    if total != n_reads or c < 0.99 * n_reads:
        fail(f"beyond-card classified {c} of {total} reads")
    launches = dict(cuda_kernels.LAUNCHES)
    require_launches("beyond-card builds and classify", launches)
    return launches


def main_classify2_scale(dev, out):
    """--classify2-scale: phase_classify2_scale alone, on the scale library
    made in host memory."""
    from slacken_tpu_torch import workloads

    phase_classify2_scale(dev, out, list(workloads.scale_library(SCALE_BP, SCALE_TAXA)))


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "slacken_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    # per-read mode's default on the card, the dense copy; the per-read and
    # paired phases turn hit runs on around their own runs
    os.environ["STPU_HIT_RUNS"] = "0"

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
        if "ptxas info" in line and ("Used" in line or "Compiling" in line) or "spill" in line:
            log("  " + line.strip())
    t0 = time.perf_counter()
    log(f"native packer: available {native.available()} "
        f"(g++ build and load {time.perf_counter() - t0:.2f} s)")
    if not native.available():
        fail("the native packer did not build: rates would be the numpy fallback's")
    out = os.path.join(HERE, ".smoke_out")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    if sys.argv[1:] in (["--across-cards"], ["--beyond-card"], ["--classify2-scale"]):
        {"--across-cards": main_across_cards, "--beyond-card": main_beyond_card,
         "--classify2-scale": main_classify2_scale}[sys.argv[1]](dev, out)
        shutil.rmtree(out, ignore_errors=True)
        log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                "count": torch.cuda.device_count()}}))
        return 0
    rng = np.random.default_rng(20260816)
    results = {}
    check_scan(rng, dev, results)
    check_probe(rng, dev, results)
    check_mask_idioms(dev, results)
    check_resolve(rng, dev)
    bench = phase_bench(dev, out, results)
    check_hit_runs(dev, results, bench)
    by_path = {"reports": bench["launches"], "probes": phase_probes(dev, out, bench, results),
               "per_read": phase_detailed(dev, out, bench),
               "paired": phase_paired(dev, out, bench), "api": phase_api(dev, out, bench),
               "diagnostics": phase_diagnostics(dev), "fuzz": phase_fuzz(dev, out)}
    reads = bench["reads"]
    bases = {"narrow": (None, bench["idx_cpu"])}  # kind -> (card's, CPU's) base index with its sidecar
    del bench
    genomes = []
    by_path["scale"], scale_idx = phase_scale(dev, out, results, genomes)
    add_launches(by_path["probes"], phase_probes_scale(dev, out, results, genomes, scale_idx))
    by_path["build_bounded"] = phase_build_bounded(dev, out, genomes, scale_idx)
    by_path["mesh"] = phase_mesh_scale(dev, out, genomes, scale_idx)
    scale_idx.save_sharded(os.path.join(out, "idx8_scale"), MH_SHARDS)  # for phase_multihost
    del scale_idx
    by_path["wide"] = phase_wide(dev, out, reads, results, genomes, bases)
    by_path["ordering"] = phase_ordering(dev, out, reads, bases)
    add_launches(by_path["build_bounded"], phase_build_bounded_bench(dev, out, bases))
    by_path["classify2"] = phase_classify2(dev, out, reads, bases)
    by_path["bracken"] = phase_bracken(dev, out, bases)
    by_path["compare_index"] = phase_compare_index(dev, out, bases)
    add_launches(by_path["mesh"], phase_mesh(dev, out, reads, bases))
    del bases
    prep = mh_prepare(dev, out, reads)
    by_path["multihost"] = phase_multihost(dev, out, reads, genomes, prep)
    if torch.cuda.device_count() > 1:
        add_launches(by_path["multihost"], phase_multihost_cards(dev, out, reads, genomes, prep))
    del prep
    add_launches(by_path["classify2"], phase_classify2_scale(dev, out, genomes))
    add_launches(by_path["bracken"], phase_bracken_scale(dev, out, genomes))
    shutil.rmtree(out, ignore_errors=True)
    for mod in ("jax", "slacken_tpu", "bench", "scale_bench"):
        if mod in sys.modules:
            fail(f"the port imported {mod}")
    idioms = ("slacken_tpu_torch/ops/kernels/mask_idioms.cu", "scripts/tpu_session.py:")
    # the rank-table and wide kernels replace code that the JAX package left
    # to XLA, not a Pallas kernel: their lines name that code (the stitch,
    # inside the segmented scan's launch: _carry_forward, whose carry it
    # takes across segments)
    scan_cu, probe_cu = "slacken_tpu_torch/ops/kernels/scan.cu", "slacken_tpu_torch/ops/kernels/probe.cu"
    tables_cu = "slacken_tpu_torch/ops/kernels/probe_tables.cu"
    sources = {"scan": (scan_cu, "slacken_tpu/ops/pallas_kernels.py:26"),
               "scan_lut": (scan_cu, "slacken_tpu/ops/minimizers.py:195"),
               "scan_wide": (scan_cu, "slacken_tpu/ops/minimizers.py:372"),
               "scan_stitch": (scan_cu, "slacken_tpu/ops/minimizers.py:417"),
               "probe": (probe_cu, "slacken_tpu/ops/pallas_kernels.py:98"),
               "probe_slots": (tables_cu, "slacken_tpu/ops/pallas_kernels.py:98"),
               "probe_wide": (probe_cu, "slacken_tpu/ops/lookup.py:161"),
               "probe_tiled": (tables_cu, "slacken_tpu/ops/lookup.py:333"),
               "probe_tiled_wide": (tables_cu, "slacken_tpu/ops/lookup.py:212"),
               "probe_rows": (tables_cu, "slacken_tpu/ops/lookup.py:740"),
               "probe_rows_wide": (tables_cu, "slacken_tpu/ops/lookup.py:891"),
               "probe_hashed": (tables_cu, "slacken_tpu/ops/lookup.py:478"),
               "probe_hashed_cols": (tables_cu, "slacken_tpu/ops/lookup.py:566"),
               "probe_bucketed": (tables_cu, "slacken_tpu/ops/lookup.py:269"),
               "hit_runs": ("slacken_tpu_torch/ops/kernels/hitruns.cu", "slacken_tpu/ops/hitruns.py:43"),
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
