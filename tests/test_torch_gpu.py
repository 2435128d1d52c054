"""The CUDA kernels against their plain PyTorch twins, on the card. Marked
`gpu`: each test skips without CUDA. The repository's conftest imports JAX,
which the GPU host lacks, so run these there with

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_gpu.py
"""

import gzip
import os

import numpy as np
import pytest
import torch

import hitruns_cases
import probe_cases
from slacken_tpu_torch import diagnostics, workloads
from slacken_tpu_torch.ops import cuda_kernels, encode, lookup, mask_idioms, minimizers, ordering

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _codes(shape, seed=5):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, shape).astype(np.uint8)
    codes[rng.random(shape) < 0.05] = encode.INVALID
    return codes


def _assert_scan_matches_twin(cuda, codes, mp, lut=None, segment=None):
    """The kernel for these parameters (scan, scan_lut with a rank table,
    scan_wide for m > 31) launched once, and the stitch once where the rows
    are cut into segments (of `segment` positions when given, else as the
    wrapper chooses), and equal to the twin in all four outputs."""
    packed, valid = (torch.from_numpy(a).to(cuda) for a in encode.pack_2bit(codes))
    name = "scan_wide" if mp.wide else "scan" if lut is None else "scan_lut"
    b, L = codes.shape
    launches = {name: 1}
    if (segment or cuda_kernels.segment_length(b, L, cuda_kernels.scan_warps(cuda))) < L:
        launches["scan_stitch"] = 1
    before = dict(cuda_kernels.LAUNCHES)
    if segment is None:
        got = minimizers.window_minimizers_packed(packed, valid, mp, None if lut is None else lut.to(cuda))
    else:
        got = minimizers.WindowMinimizers(*cuda_kernels.window_minimizers_cuda(
            packed, valid, mp, None if lut is None else lut.to(cuda), _segment=segment))
    assert {k: v - before[k] for k, v in cuda_kernels.LAUNCHES.items() if v != before[k]} == launches
    want = minimizers.window_minimizers(torch.from_numpy(codes), mp, lut)
    assert torch.equal(got.valid.cpu(), want.valid)
    assert torch.equal(got.span_start.cpu(), want.span_start)
    assert torch.equal(got.distinct.cpu(), want.distinct)
    assert torch.equal(got.minimizer.cpu(), want.minimizer)  # -1 at invalid windows in both


@pytest.mark.parametrize("shape", [(64, 128), (8, 1024), (3, 136)])
@pytest.mark.parametrize("kms", [(35, 31, 7), (21, 15, 3), (31, 31, 0)])
def test_scan_kernel_matches_twin(cuda, shape, kms):
    _assert_scan_matches_twin(cuda, _codes(shape), minimizers.MinimizerParams(*kms))


@pytest.mark.parametrize("shape", [(5, 264), (9, 104), (16, 4096)])
@pytest.mark.parametrize("kms,canonical", [
    ((35, 31, 7), False),  # the forward m-mer alone
    ((35, 1, 0), True),    # m = 1: the window is k priorities wide
    ((12, 5, 1), False),
    ((36, 31, 7), True), ((38, 31, 7), True),  # windows that end one to three priorities into the next lane
    ((70, 31, 7), True),   # k > 61: validity over several words
    ((100, 16, 2), True),  # a window 22 lanes wide
    ((8, 8, 0), True),     # W = 1: no neighbour at all
])
def test_scan_kernel_other_parameters(cuda, shape, kms, canonical):
    mp = minimizers.MinimizerParams(*kms, canonical=canonical)
    _assert_scan_matches_twin(cuda, _codes(shape, seed=kms[0]), mp)


@pytest.mark.parametrize("shape", [(64, 128), (5, 264), (9, 104), (4, 4096), (3, 8), (33, 72)])
@pytest.mark.parametrize("kms", [
    (35, 32, 0), (35, 33, 0), (50, 45, 7), (80, 63, 7), (63, 63, 0), (40, 33, 5), (32, 32, 7),
    (152, 32, 0), (183, 63, 31),  # the widest window the kernel takes
])
def test_scan_wide_kernel_matches_twin(cuda, shape, kms):
    for canonical in (True, False):
        mp = minimizers.MinimizerParams(*kms, canonical=canonical)
        _assert_scan_matches_twin(cuda, _codes(shape, seed=kms[0]), mp)


def test_scan_wide_kernel_rows_at_any_byte(cuda):
    codes = _codes((33, 264))
    packed, valid = (torch.from_numpy(a).to(cuda) for a in encode.pack_2bit(codes))
    mp = minimizers.MinimizerParams(50, 45, 7)
    got = minimizers.window_minimizers_packed(packed[1:], valid[1:], mp)
    want = minimizers.window_minimizers(torch.from_numpy(codes[1:]), mp)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_scan_kernel_rows_at_any_byte(cuda):
    """Rows of 66 packed bytes start at every alignment; a view that skips
    the first row starts off a 4-byte boundary."""
    codes = _codes((33, 264))
    packed, valid = (torch.from_numpy(a).to(cuda) for a in encode.pack_2bit(codes))
    mp = minimizers.MinimizerParams()
    got = minimizers.window_minimizers_packed(packed[1:], valid[1:], mp)
    want = minimizers.window_minimizers(torch.from_numpy(codes[1:]), mp)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


#: (k, m, s, canonical, table) of each scan instance on segment-adversarial
#: rows: scan<35, 31>, the generic narrow scan (W = 1, k - m = 120), scan_lut
#: and scan_wide (W = 1, k - m = 120)
SEGMENT_CASES = [
    (35, 31, 7, True, None), (21, 15, 3, False, None), (31, 31, 0, True, None), (151, 31, 0, True, None),
    (12, 6, 1, True, "random"), (35, 13, 3, True, "signature"),
    (50, 45, 7, True, None), (63, 63, 0, False, None), (183, 63, 31, True, None),
]


def _segment_table(m, table):
    if table is None:
        return None
    lut = ordering.signature_lut(m) if table == "signature" else np.random.default_rng(m).permutation(1 << (2 * m))
    return torch.from_numpy(lut.astype(np.int32))


@pytest.mark.parametrize("segment", [128, 384])
@pytest.mark.parametrize("case", SEGMENT_CASES)
def test_scan_kernel_in_segments_matches_twin(cuda, case, segment):
    """Every instance with its rows forced into short segments, on rows with
    N runs over whole segments, first valid windows at segment starts, an
    all-invalid row and a short last segment: the scan and the stitch each
    launched once, all four outputs equal to the twin's."""
    *kms, canonical, table = case
    mp = minimizers.MinimizerParams(*kms, canonical=canonical)
    codes = workloads.segment_rows(np.random.default_rng(kms[0] + segment), segment, mp.k)
    _assert_scan_matches_twin(cuda, codes, mp, _segment_table(mp.m, table), segment)


def _kernels_in_trace(fn, calls=3, tries=3):
    """{kernel name: launches a call} of fn under torch.profiler. A trace
    that holds no device event at all is a fault of the profiler, not a count:
    on the H100, once a scan in the process has read a 4 GiB rank table
    (test_scan_kernel_rank_table's (135, 15, 7) case), half or more of the
    traces hold none, whatever the caching allocator holds; so the tests
    that count kernels in a trace are defined before that test, and run
    first. fn is profiled again, up to `tries` traces, and the test fails
    naming the profiler if none holds one."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        seen = {e.key: round(e.count / calls) for e in prof.key_averages() if e.self_device_time_total > 0}
        if seen:
            return seen
    pytest.fail(f"torch.profiler recorded no device event in {tries} traces of {calls} calls each")


@pytest.mark.parametrize("empty", [1, 3])
def test_kernels_in_trace_profiles_again_after_an_empty_trace(cuda, monkeypatch, empty):
    """The first `empty` traces come back without a device event: after one
    the helper counts the next trace's kernels; after three it fails, naming
    the profiler."""
    import torch.profiler

    real, made = torch.profiler.profile, []

    class Empty:
        def __init__(self, *a, **kw):
            self.prof = real(*a, **kw)

        def __enter__(self):
            self.prof.__enter__()
            return self

        def __exit__(self, *exc):
            return self.prof.__exit__(*exc)

        def key_averages(self):
            return []

    def profile(*a, **kw):
        made.append(None)
        return (Empty if len(made) <= empty else real)(*a, **kw)

    monkeypatch.setattr(torch.profiler, "profile", profile)
    x = torch.zeros((64, 128), dtype=torch.int32, device=cuda)
    run = lambda: cuda_kernels.mask_idiom_cuda("select", x)  # noqa: E731
    if empty < 3:
        assert list(_kernels_in_trace(run).values()) == [1] and len(made) == empty + 1
    else:
        with pytest.raises(pytest.fail.Exception, match="torch.profiler recorded no device event in 3 traces"):
            _kernels_in_trace(run)
        assert len(made) == 3


def _counters_zero(cuda):
    """Every (device, stream)'s segmented-scan counters on the cards are 0."""
    torch.cuda.synchronize()
    kept = [c for (d, _), c in cuda_kernels._scan_counters.items() if d.type == cuda.type]
    return bool(kept) and all(int(c.abs().sum()) == 0 for c in kept)


@pytest.mark.parametrize("case", SEGMENT_CASES)
def test_scan_stitch_kernel_matches_twin(cuda, case):
    """The stitch inside the segmented scan's launch, each instance's rows in
    segments of 256: one kernel in the profiler's trace; `stitch_segments`
    over the summaries that the launch wrote changes nothing (its distinct
    is final), the carry cleared bytes there, all four outputs equal the
    whole-row twin's, and the arrival counters are 0 after."""
    *kms, canonical, table = case
    mp = minimizers.MinimizerParams(*kms, canonical=canonical)
    codes = workloads.segment_rows(np.random.default_rng(kms[0]), 256, mp.k)
    lut = _segment_table(mp.m, table)
    packed, valid = (torch.from_numpy(a).to(cuda) for a in encode.pack_2bit(codes))
    lut_d = None if lut is None else lut.to(cuda)
    run = lambda: cuda_kernels.scan_pass1_cuda(packed, valid, mp, lut_d, 256)  # noqa: E731
    before = dict(cuda_kernels.LAUNCHES)
    mn, flags, summary = run()
    assert _launched(before) == {"scan_wide" if mp.wide else "scan" if lut is None else "scan_lut": 1, "scan_stitch": 1}
    assert summary is not None and summary.shape == (8, -(-codes.shape[1] // 256), 4)
    assert list(_kernels_in_trace(run).values()) == [1]
    assert torch.equal(minimizers.stitch_segments(mn, flags[2], summary), flags[2])
    cleared = minimizers.carried(mn, summary)
    assert cleared.numel() > 0 and not bool(flags[2].view(-1)[cleared].any())
    want = minimizers.window_minimizers(torch.from_numpy(codes), mp, lut)
    for got, w in zip((mn, *flags), want):
        assert torch.equal(got.cpu(), w)
    assert _counters_zero(cuda)


def test_hit_runs_one_kernel_in_trace(cuda):
    """At the bench batch's shape a call of hit_runs_cuda is one kernel in
    the profiler's trace."""
    args = [torch.from_numpy(a).to(cuda) for a in workloads.hit_runs_rows(7, 32768, 128, 35)]
    assert list(_kernels_in_trace(lambda: cuda_kernels.hit_runs_cuda(*args, 35, 16)).values()) == [1]


@pytest.mark.parametrize("shape", [(64, 128), (5, 264), (9, 104), (4, 4096), (3, 8)])
@pytest.mark.parametrize("kms,table", [
    ((15, 8, 2), "lexicographic"), ((19, 7, 2), "signature"), ((12, 6, 1), "random"),
    ((35, 13, 3), "signature"), ((6, 3, 0), "random"), ((135, 15, 7), "lexicographic"),
])
def test_scan_kernel_rank_table(cuda, shape, kms, table):
    m = kms[1]
    lut = {"lexicographic": ordering.lexicographic_lut, "signature": ordering.signature_lut,
           "random": lambda m: np.random.default_rng(m).permutation(1 << (2 * m))}[table](m)
    lut = torch.from_numpy(lut.astype(np.int32))
    for canonical in (True, False):
        mp = minimizers.MinimizerParams(*kms, canonical=canonical)
        _assert_scan_matches_twin(cuda, _codes(shape, seed=kms[0]), mp, lut)


@pytest.mark.parametrize("kms", [(35, 31, 7), (12, 6, 1), (50, 45, 7)])
def test_scan_stitch_kernel_on_hand_made_summaries(cuda, kms):
    """Rows made by hand for the stitch (workloads.carry_rows) in 70 segments
    of 128 a row, so that the row's last warp takes its summaries in three
    chunks of 32 and some walks carry a holder across a chunk: one launch,
    bytes cleared at the first windows that need the carry, all four outputs
    equal to the whole-row twin's (a rank table for m = 6), counters 0."""
    mp = minimizers.MinimizerParams(*kms)
    lut = _segment_table(mp.m, "random" if mp.m == 6 else None)
    codes = workloads.carry_rows(np.random.default_rng(kms[0]), (3, 70 * 128), 128, mp.k)
    packed, valid = (torch.from_numpy(a).to(cuda) for a in encode.pack_2bit(codes))
    mn, flags, summary = cuda_kernels.scan_pass1_cuda(packed, valid, mp, None if lut is None else lut.to(cuda), 128)
    first = summary[..., 1].cpu()
    crossing = [(r, j) for r in range(3) for j in range(33, 70, 32) if first[r, j] >= 0 and not summary[r, j - 1, 0]]
    assert crossing and minimizers.carried(mn, summary).numel() > 10
    want = minimizers.window_minimizers(torch.from_numpy(codes), mp, lut)
    for got, w in zip((mn, *flags), want):
        assert torch.equal(got.cpu(), w)
    assert _counters_zero(cuda)


def test_segmented_scans_in_a_row_and_on_two_streams(cuda):
    """Two segmented launches in a row on one stream (the second with more
    rows: the counters grow), then one on each of two streams at once
    (each stream its own counters): every result equal to the whole-row
    twin's, every counter 0 after."""
    mp = minimizers.MinimizerParams()
    codes = workloads.carry_rows(np.random.default_rng(2), (8, 40 * 128), 128, mp.k)
    want = minimizers.window_minimizers(torch.from_numpy(codes), mp)
    packed, valid = (torch.from_numpy(a).to(cuda) for a in encode.pack_2bit(codes))

    def scan(rows):
        return cuda_kernels.window_minimizers_cuda(packed[:rows], valid[:rows], mp, _segment=128)

    for rows in (2, 8):
        got = scan(rows)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w[:rows])
    assert _counters_zero(cuda)
    streams = [torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)]
    torch.cuda.synchronize()
    outs = []
    for st in streams:
        with torch.cuda.stream(st):
            outs.append(scan(8))
    torch.cuda.synchronize()
    for got in outs:
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
    buffers = [cuda_kernels._scan_counters[(packed.device, st.cuda_stream)] for st in streams]
    assert buffers[0].data_ptr() != buffers[1].data_ptr() and _counters_zero(cuda)


def test_scan_kernel_refuses_what_it_does_not_take(cuda):
    packed = torch.zeros((4, 32), dtype=torch.uint8, device=cuda)
    valid = torch.zeros((4, 16), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="m <= k <= m \\+ 120"):
        cuda_kernels.window_minimizers_cuda(packed, valid, minimizers.MinimizerParams(160, 31, 0))
    with pytest.raises(ValueError, match="m <= k <= m \\+ 120"):
        cuda_kernels.window_minimizers_cuda(packed, valid, minimizers.MinimizerParams(184, 63, 0))
    mp = minimizers.MinimizerParams(15, 8, 2)
    for bad in (torch.zeros(4 ** 8, dtype=torch.int64, device=cuda), torch.zeros(4 ** 7, dtype=torch.int32, device=cuda),
                torch.zeros(4 ** 8, dtype=torch.int32)):
        with pytest.raises(ValueError):
            cuda_kernels.window_minimizers_cuda(packed, valid, mp, bad)
    with pytest.raises(ValueError, match="m <= 15"):
        cuda_kernels.window_minimizers_cuda(packed, valid, minimizers.MinimizerParams(40, 16, 2),
                                            torch.zeros(4 ** 8, dtype=torch.int32, device=cuda))


def _probe_case(cuda, keys, q, bucket_keys):
    taxa = (np.arange(len(keys)) % 1000 + 1).astype(np.int32)
    k_d, t_d, q_d = (torch.from_numpy(a).to(cuda) for a in (keys, taxa, q))
    before = cuda_kernels.LAUNCHES["probe"]
    got = lookup.probe(k_d, t_d, lookup.build_directory(k_d, bucket_keys), q_d)
    assert cuda_kernels.LAUNCHES["probe"] == before + (1 if len(keys) else 0)
    want = lookup.lookup_taxa(torch.from_numpy(keys), torch.from_numpy(taxa), torch.from_numpy(q))
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("n", [1, 127, 128, 129, 100_000])
def test_probe_kernel_matches_twin(cuda, n):
    rng = np.random.default_rng(n)
    keys = np.unique(rng.integers(0, 1 << 62, 2 * n, dtype=np.int64))[:n]
    q = np.concatenate([keys, rng.integers(-(1 << 63), (1 << 63) - 1, 5000, dtype=np.int64)])
    _probe_case(cuda, keys, q, lookup.BUCKET_KEYS)


EDGE_QUERIES = np.array([-5, -(1 << 63), 0, 1, 1 << 61, 1 << 62, (1 << 63) - 1], np.int64)


@pytest.mark.parametrize("n", [0, 1, 2, 127, 128, 129])
@pytest.mark.parametrize("kind", ["uniform", "one prefix", "two prefixes", "narrow keys"])
@pytest.mark.parametrize("bucket_keys", [1, lookup.BUCKET_KEYS, 1 << 30])
def test_probe_kernel_adversarial(cuda, n, kind, bucket_keys):
    """Tiny indexes, every key under one prefix, one bucket for the whole
    index, and the queries -5, 0, 2^62, 2^63 - 1 beside every key +- 1."""
    rng = np.random.default_rng(n)
    raw = {
        "uniform": rng.integers(0, 1 << 62, 2 * n + 1, dtype=np.int64),
        "one prefix": (1 << 61) + rng.integers(0, 1 << 20, 2 * n + 1, dtype=np.int64),
        "two prefixes": np.concatenate([rng.integers(0, 1 << 12, n // 2, dtype=np.int64),
                                        (1 << 62) - 1 - rng.integers(0, 1 << 12, n, dtype=np.int64)]),
        "narrow keys": rng.integers(0, 1 << 30, 2 * n + 1, dtype=np.int64),
    }[kind]
    keys = np.unique(raw)[:n]
    q = np.concatenate([keys, keys - 1, keys + 1, EDGE_QUERIES,
                        rng.integers(-(1 << 63), (1 << 63) - 1, 500, dtype=np.int64)])
    _probe_case(cuda, keys, q, bucket_keys)


def _wide_keys(rng, kind, n):
    """n sorted unique [n, 2] int64 rows (hi64, lo64 as bit patterns)."""
    lo = rng.integers(-(1 << 63), (1 << 63) - 1, 2 * n + 2, dtype=np.int64)
    hi = {
        "uniform": lambda: rng.integers(0, 1 << 62, 2 * n + 2, dtype=np.int64),
        "m = 45": lambda: rng.integers(0, 1 << 26, 2 * n + 2, dtype=np.int64),
        "one hi64": lambda: np.full(2 * n + 2, 12345, np.int64),
        "m = 32": lambda: np.zeros(2 * n + 2, np.int64),
        "few hi64": lambda: rng.integers(0, 3, 2 * n + 2, dtype=np.int64),
    }[kind]()
    if kind == "m = 32" and n > 4:
        lo[:4] = [0, 1, -(1 << 63), -1]  # lo64 differing only in its top bit
    # np.unique sorts the rows by (hi64, lo64), unsigned
    rows = np.unique(np.stack([hi.view(np.uint64), lo.view(np.uint64)], 1), axis=0)
    return rows[np.sort(rng.permutation(len(rows))[:n])].view(np.int64)


@pytest.mark.parametrize("n", [0, 1, 2, 3, 127, 128, 129, 100_001])
@pytest.mark.parametrize("kind", ["uniform", "m = 45", "one hi64", "m = 32", "few hi64"])
@pytest.mark.parametrize("bucket_keys", [1, lookup.BUCKET_KEYS, 1 << 30])
def test_probe_wide_kernel_adversarial(cuda, n, kind, bucket_keys):
    """Tiny indexes, every key under one hi64, hi64 = 0 throughout, keys
    whose lo64 differ only in the top bit; queries at every key, beside it
    in either limb, -1 (an invalid window) and random."""
    rng = np.random.default_rng(n)
    keys = _wide_keys(rng, kind, n)
    taxa = (np.arange(len(keys)) % 1000 + 1).astype(np.int32)
    one = np.array([[0, 1]], np.int64)
    q = np.concatenate([keys, keys + one, keys - one, keys ^ np.array([[0, -(1 << 63)]], np.int64),
                        keys + one[:, ::-1], np.array([[-1, -1], [0, 0], [0, -1], [(1 << 62) - 1, -1]], np.int64),
                        rng.integers(-(1 << 63), (1 << 63) - 1, (500, 2), dtype=np.int64)])
    k_d, t_d, q_d = (torch.from_numpy(a).to(cuda) for a in (keys, taxa, q))
    d = lookup.build_directory(k_d, bucket_keys)
    table = lookup.build_slots(k_d, t_d, d)
    before = cuda_kernels.LAUNCHES["probe_wide"]
    got = lookup.probe(None, None, table, q_d)
    assert cuda_kernels.LAUNCHES["probe_wide"] == before + (1 if len(keys) else 0)
    want = lookup.lookup_taxa(torch.from_numpy(keys), torch.from_numpy(taxa), torch.from_numpy(q))
    assert torch.equal(got.cpu(), want)
    assert torch.equal(lookup.lookup_taxa_slots(table, q_d).cpu(), want)
    assert torch.equal(lookup.lookup_taxa_directory(k_d, t_d, d, q_d).cpu(), want)
    assert int((want > 0).sum()) >= len(keys)


def _slot_case(cuda, keys, taxa, q, bucket_keys):
    """The slot kernel on the card == its twin on the card == lookup_taxa on
    the CPU, with the keys' neighbours in the table's own buckets among the
    queries; returns the table."""
    k_d, t_d = torch.from_numpy(keys.view(np.int64)).to(cuda), torch.from_numpy(taxa).to(cuda)
    table = lookup.build_slots(k_d, t_d, lookup.build_directory(k_d, bucket_keys))
    q = np.concatenate([q, probe_cases.neighbours(keys, table.directory.shift)]).view(np.int64)
    q_d = torch.from_numpy(q).to(cuda)
    before = cuda_kernels.LAUNCHES["probe_wide"]
    got = lookup.probe(None, None, table, q_d)
    assert cuda_kernels.LAUNCHES["probe_wide"] == before + (1 if len(keys) else 0)
    want = lookup.lookup_taxa(torch.from_numpy(keys.view(np.int64)), torch.from_numpy(taxa), torch.from_numpy(q))
    assert torch.equal(got.cpu(), want)
    assert torch.equal(lookup.lookup_taxa_slots(table, q_d).cpu(), want)
    return table


@pytest.mark.parametrize("m", [32, 33, 45, 56, 63])
@pytest.mark.parametrize("kind", ["small", "wide", "distinct"])
@pytest.mark.parametrize("bucket_keys", [1, lookup.BUCKET_KEYS, 1 << 30])
def test_probe_wide_kernel_over_slot_tables(cuda, m, kind, bucket_keys):
    """Small, wide and distinct taxa (both field modes, and at m = 63 in one
    bucket a raised directory), 1 to 3,000 keys."""
    rng = np.random.default_rng(m)
    for n in (1, 2, 3, 129, 3000):
        keys = probe_cases.wide_keys(rng, m, n)
        _slot_case(cuda, keys, probe_cases.taxa_of(rng, kind, n), probe_cases.queries_of(rng, keys, m), bucket_keys)


@pytest.mark.parametrize("case", probe_cases.NAMED, ids=[c[0] for c in probe_cases.NAMED])
def test_probe_wide_kernel_field_modes(cuda, case):
    """Each field mode, and the raised directory, reached by name."""
    _, m, n, kind, bucket_keys, field, rises = case
    rng = np.random.default_rng(n)
    keys = probe_cases.wide_keys(rng, m, n)
    table = _slot_case(cuda, keys, probe_cases.taxa_of(rng, kind, n), probe_cases.queries_of(rng, keys, m),
                       bucket_keys)
    default = lookup.build_directory(torch.from_numpy(keys.view(np.int64)), bucket_keys)
    assert probe_cases.mode(table) == field and (table.directory.buckets > default.buckets) == rises


def test_probe_wide_kernel_refuses_what_it_does_not_take(cuda):
    keys = torch.tensor([[0, 5], [1, 7], [2, 1], [3, 0]], device=cuda)
    taxa = torch.ones(4, dtype=torch.int32, device=cuda)
    table = lookup.build_slots(keys, taxa, lookup.build_directory(keys))
    with pytest.raises(ValueError, match="slot table"):
        lookup.probe(keys, taxa, lookup.build_directory(keys), keys)
    with pytest.raises(ValueError, match="16-byte aligned"):
        cuda_kernels.lookup_taxa_slots_cuda(table._replace(slots=table.slots.flatten()[1:7].view(3, 2)), keys)
    with pytest.raises(ValueError, match="does not fit"):
        cuda_kernels.lookup_taxa_slots_cuda(table._replace(c=33), keys)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_kernels.lookup_taxa_slots_cuda(table, torch.cat([keys, keys], 1)[:, :2])


def _narrow_slot_case(cuda, rng, keys, taxa, bucket_keys):
    """The narrow slot kernel over build_slots' table of these keys, made on
    the card, launched once (none for an empty index), == its twin on the
    card == lookup_taxa on the CPU, on probe_cases.narrow_slot_queries at
    the directory's shift and at the table's own; returns the table and
    the queries on the card."""
    k_d, t_d = torch.from_numpy(keys).to(cuda), torch.from_numpy(taxa).to(cuda)
    d = lookup.build_directory(k_d, bucket_keys)
    table = lookup.build_slots(k_d, t_d, d)
    q = np.concatenate([probe_cases.narrow_slot_queries(rng, keys, d.shift),
                        probe_cases.narrow_slot_queries(rng, keys, table.directory.shift)])
    q_d = torch.from_numpy(q).to(cuda)
    before = cuda_kernels.LAUNCHES["probe_slots"]
    got = lookup.probe(None, None, table, q_d)
    assert cuda_kernels.LAUNCHES["probe_slots"] == before + (1 if len(keys) else 0)
    want = lookup.lookup_taxa(torch.from_numpy(keys), torch.from_numpy(taxa), torch.from_numpy(q))
    assert torch.equal(got.cpu(), want)
    assert torch.equal(lookup.lookup_taxa_slots(table, q_d).cpu(), want)
    return table, q_d


@pytest.mark.parametrize("bucket_keys", [1, lookup.BUCKET_KEYS, 1 << 30])
@pytest.mark.parametrize("taxa_kind", ["small", "wide", "distinct"])
@pytest.mark.parametrize("kind", probe_cases.NARROW_SLOT_KINDS)
def test_probe_slots_kernel_matches_twin(cuda, kind, taxa_kind, bucket_keys):
    """probe_slots_kernel over narrow slot tables of 0 to 3,000 keys
    (62-bit, one prefix, two prefixes, dense with shift 0, 63-bit; direct
    taxa and codes; 1, 4 and all keys a bucket, and the raised directories
    that codes need there; slots with the top bit set) == its twin ==
    lookup_taxa."""
    rng = np.random.default_rng(len(kind) * 11 + len(taxa_kind) + bucket_keys % 7)
    for n in (0, 1, 2, 3, 127, 128, 129, 3000):
        keys = probe_cases.narrow_slot_keys(rng, kind, n)
        _narrow_slot_case(cuda, rng, keys, probe_cases.taxa_of(rng, taxa_kind, len(keys)), bucket_keys)


@pytest.mark.parametrize("n", [2_000_000, 131_190_899], ids=["2M keys", "scale index's records"])
def test_probe_slots_kernel_at_the_bench_and_scale_sizes(cuda, n):
    """Random 62-bit indexes of 2M keys (chip_smoke.py's random shape) and
    of the scale index's 131,190,899 records, made on the card, under
    4,194,304 queries (half hits, random misses, the edges, -1): the kernel
    == its twin == lookup_taxa; direct taxa, 8 bytes a slot, a directory of
    about BUCKET_KEYS keys a bucket."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(n)
    keys = torch.unique(torch.randint(0, 1 << 62, (n + n // 50,), generator=gen, device=cuda))[:n].clone()
    taxa = torch.randint(1, 1 << 20, (keys.shape[0],), generator=gen, device=cuda, dtype=torch.int32)
    table = lookup.build_slots(keys, taxa)
    assert table.codes is None and table.slots.shape == keys.shape and table.directory.buckets * 8 > keys.shape[0]
    nq = 1 << 22
    edges = torch.tensor([-1, -(1 << 63), 0, (1 << 63) - 1, int(keys[0]), int(keys[-1])], device=cuda)
    q = torch.cat([keys[torch.randint(0, keys.shape[0], (nq // 2,), generator=gen, device=cuda)],
                   torch.randint(0, 1 << 62, (nq // 2 - edges.shape[0],), generator=gen, device=cuda), edges])
    got = lookup.probe(None, None, table, q)
    want = lookup.lookup_taxa(keys, taxa, q)
    assert torch.equal(got, want) and torch.equal(lookup.lookup_taxa_slots(table, q), want)
    assert int((want > 0).sum()) >= nq // 2


@pytest.mark.parametrize("kind", ["uniform", "one prefix", "63-bit"])
def test_slots_floor_kernel_reads_the_guessed_sector(cuda, kind):
    """The narrow slot probe's floor (slots_floor_cuda, on no path) ==
    lookup.slot_sectors, its plain version."""
    rng = np.random.default_rng(len(kind))
    for n in (1, 129, 3000):
        keys = probe_cases.narrow_slot_keys(rng, kind, n)
        table, q = _narrow_slot_case(cuda, rng, keys, probe_cases.taxa_of(rng, "small", len(keys)),
                                     lookup.BUCKET_KEYS)
        assert torch.equal(cuda_kernels.slots_floor_cuda(table, q), lookup.slot_sectors(table, q))


def test_probe_slots_kernel_refuses_what_it_does_not_take(cuda):
    keys = torch.arange(0, 40, 3, device=cuda)
    table = lookup.build_slots(keys, torch.ones(keys.shape[0], dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="does not fit"):
        cuda_kernels.lookup_taxa_slots_cuda(table._replace(c=64 - table.directory.shift + 1), keys)
    with pytest.raises(ValueError, match="a readable word past the last"):
        cuda_kernels.lookup_taxa_slots_cuda(table._replace(slots=table.slots.clone()), keys)
    with pytest.raises(ValueError, match="16-byte aligned"):
        padded = torch.zeros(keys.shape[0] + 3, dtype=torch.int64, device=cuda)
        cuda_kernels.lookup_taxa_slots_cuda(table._replace(slots=padded[1:keys.shape[0] + 1]), keys)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_kernels.lookup_taxa_slots_cuda(table, torch.stack([keys, keys], 1)[:, 0])


def _random_index(cuda, n, seed):
    """A narrow KeyValueIndex of n random 62-bit keys made on the card, its
    taxa those of _small_library's taxonomy; and its records on the host."""
    from slacken_tpu_torch.index import KeyValueIndex

    tax, _, params = _small_library("narrow")
    gen = torch.Generator(device=cuda)
    gen.manual_seed(seed)
    keys = torch.unique(torch.randint(0, 1 << 62, (n + n // 50,), generator=gen, device=cuda))[:n].clone()
    defined = torch.tensor([10, 11, 12, 13, 14, 15, 100, 101], dtype=torch.int32, device=cuda)
    taxa = defined[torch.randint(0, defined.shape[0], (n,), generator=gen, device=cuda)]
    return KeyValueIndex(keys, taxa, params, tax), keys.cpu(), taxa.cpu()


@pytest.mark.parametrize("kind", ["narrow", "wide"])
def test_classifier_holds_the_index_once_on_the_card(cuda, kind):
    """Classifier(...) on the card over an index that lives there: its
    routed slot table replaces the keys and taxa on the card, which the
    index keeps in host memory, unchanged. Narrow, 2^24 records:
    torch.cuda.memory_allocated() ends 4 bytes a record below the directory
    layout (keys, taxa and directory on the card), give or take 4 MB."""
    from slacken_tpu_torch.classify import Classifier
    from slacken_tpu_torch.index import KeyValueIndex

    if kind == "wide":
        tax, genomes, params = _small_library("wide")
        idx = KeyValueIndex.build(iter(genomes), params, tax, cuda)
        host_keys, host_taxa = idx.keys_t.cpu(), idx.taxa_t.cpu()
    else:
        idx, host_keys, host_taxa = _random_index(cuda, 1 << 24, 24)
    torch.cuda.synchronize()
    directory = lookup.build_directory(idx.keys_t)
    torch.cuda.synchronize()
    directory_layout = torch.cuda.memory_allocated()
    del directory
    cls = Classifier(idx, cuda)
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    assert idx.keys_t.device.type == "cpu" and idx.taxa_t.device.type == "cpu"
    assert torch.equal(idx.keys_t, host_keys) and torch.equal(idx.taxa_t, host_taxa)
    assert cls._keys is None and cls._taxa is None and isinstance(cls._directory, lookup.SlotTable)
    assert cls._directory.slots.dim() == (2 if kind == "wide" else 1)
    if kind == "narrow":
        n = idx.num_records
        assert abs((directory_layout - after) - 4 * n) < 4 << 20
    assert Classifier(idx, cuda)._directory is cls._directory  # made once a (device, probe)


@pytest.mark.parametrize("kind", ["narrow", "wide"])
def test_index_work_stays_on_the_card_after_a_classifier(cuda, kind, monkeypatch):
    """Once a Classifier's slot table holds the records on the card and the
    keys wait in host memory, the card is still the index's device: the
    per-taxon counts, stats.depth_histograms and respace run there (every
    torch.unique of theirs on the card; the respaced index's keys on the
    card), and give what the same index on the CPU gives."""
    from slacken_tpu_torch import stats
    from slacken_tpu_torch.classify import Classifier
    from slacken_tpu_torch.index import KeyValueIndex

    tax, genomes, params = _small_library(kind)
    idx = KeyValueIndex.build(iter(genomes), params, tax, cuda)
    host = idx.with_records(idx.keys_t.cpu(), idx.taxa_t.cpu())
    Classifier(idx, cuda)
    assert idx.keys_t.device.type == "cpu" and idx.home == cuda and idx.device == cuda
    real, seen = torch.unique, []

    def unique(t, *a, **kw):
        seen.append(t.device.type)
        return real(t, *a, **kw)

    monkeypatch.setattr(torch, "unique", unique)
    got = (idx.records_per_taxon(), stats.depth_histograms(idx))
    monkeypatch.setattr(torch, "unique", real)
    assert seen and set(seen) == {"cuda"}
    assert got == (host.records_per_taxon(), stats.depth_histograms(host))
    spaced = idx.respace(params.spaces + 2)
    want = host.respace(params.spaces + 2)
    assert spaced.keys_t.device.type == "cuda" and spaced.num_records == want.num_records
    assert torch.equal(spaced.keys_t.cpu(), want.keys_t) and torch.equal(spaced.taxa_t.cpu(), want.taxa_t)
    assert idx.keys_t.device.type == "cpu"  # the work copied the keys; the index still holds them once
    idx.to(cuda)
    assert idx.home is None and idx.device == idx.keys_t.device


def test_ring_on_the_card_holds_the_records_once(cuda):
    """A ring MeshClassifier over Mesh([cuda] * 8) of an index on the card:
    each shard is a slot table of its own, and the index hands its keys and
    taxa over to host memory, so that torch.cuda.memory_allocated() ends at
    what it was less 12 bytes a record plus the shards' probe arrays (about 9
    bytes a record), give or take 4 MB. Its classify equals the single-device
    classifier's on the CPU."""
    from slacken_tpu_torch.classify import Classifier, ClassifyParams, Fragment
    from slacken_tpu_torch.index import KeyValueIndex
    from slacken_tpu_torch.parallel.classifier import MeshClassifier

    idx, host_keys, host_taxa = _random_index(cuda, 1 << 23, 23)
    n = idx.num_records
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    cls = MeshClassifier(idx, [cuda] * 8, "ring")
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    held = lookup.probe_bytes(cls._arrays)
    assert all(k is None and isinstance(s, lookup.SlotTable) for k, _, s in cls._arrays)
    assert idx.keys_t.device.type == "cpu" and idx.home.type == "cuda"
    assert torch.equal(idx.keys_t, host_keys) and torch.equal(idx.taxa_t, host_taxa)
    assert held < 9.5 * n and abs(after - (before - 12 * n + held)) < 4 << 20
    del cls

    tax, genomes, params = _small_library("narrow")
    idx = KeyValueIndex.build(iter(genomes), params, tax, cuda)
    cpu = idx.with_records(idx.keys_t.cpu(), idx.taxa_t.cpu())
    frags = [Fragment(f"r{i}", genomes[i % 6][1][i * 20 : i * 20 + 101]) for i in range(100)]
    cpar = ClassifyParams(thresholds=[0.0, 0.15])
    got = MeshClassifier(idx, [cuda] * 8, "ring").classify(frags, cpar)
    assert idx.keys_t.device.type == "cpu"
    assert got == Classifier(cpu, "cpu").classify(frags, cpar)
    assert sum(r.classified for r in got[0.0]) > 50


@pytest.mark.parametrize("per_read", [False, True], ids=["reports", "per_read"])
@pytest.mark.parametrize("kind", ["narrow", "lexicographic"])
def test_slot_probe_outputs_equal_the_directory_kernels(cuda, kind, per_read, tmp_path, monkeypatch):
    """Reports mode's kreports and per-read mode's files classified on the
    card through the slot kernel are byte-identical to those through the
    directory kernel (the index's keys, taxa and directory on the card, as
    before the slot table), each path launching its own kernel."""
    from slacken_tpu_torch import native
    from slacken_tpu_torch.classify import Classifier, ClassifyParams
    from slacken_tpu_torch.index import KeyValueIndex

    tax, genomes, params = _small_library(kind)
    rng = np.random.default_rng(31)
    letters = np.frombuffer(b"ACGTN", np.uint8)
    reads = []
    for i in range(300):
        _, g = genomes[i % 6]
        s = int(rng.integers(0, len(g) - 150))
        codes = encode.encode_seq(g[s : s + 150]).copy()
        codes[rng.integers(0, 150, 2)] = encode.INVALID
        reads.append(letters[codes].tobytes())
    codes, lens = encode.pack_batch(reads, 256)
    stream = [native.PackedReads(codes, lens, [f"r{i}" for i in range(len(reads))])]
    cpar = ClassifyParams(thresholds=[0.0, 0.15], per_read_output=per_read)

    def files(prefix):
        idx = KeyValueIndex.build(iter(genomes), params, tax, cuda)
        before = dict(cuda_kernels.LAUNCHES)
        Classifier(idx, cuda).classify_and_write_packed(stream, str(tmp_path / prefix), cpar)
        out = {}
        for root, _, names in os.walk(tmp_path):
            for n in names:
                path = os.path.join(root, n)
                if path.startswith(str(tmp_path / prefix) + "_c"):
                    with (gzip.open if n.endswith(".gz") else open)(path, "rb") as f:
                        out[os.path.relpath(path, tmp_path)[len(prefix):]] = f.read()
        return out, {k for k in ("probe", "probe_slots") if cuda_kernels.LAUNCHES[k] != before[k]}

    got, slot_kernel = files("slots")
    with monkeypatch.context() as m:
        m.setattr(KeyValueIndex, "device_arrays",
                  lambda self, device, probe="routed": (self.keys_t, self.taxa_t, lookup.build_directory(self.keys_t)))
        want, directory_kernel = files("directory")
    assert slot_kernel == {"probe_slots"} and directory_kernel == {"probe"}
    assert got == want and len(want) == (4 if per_read else 2)
    assert any(b"\tS\t" in v for v in want.values())  # reads classified to species


def test_probe_kernel_refuses_what_it_does_not_take(cuda):
    keys = torch.arange(10, device=cuda)
    taxa = torch.ones(10, dtype=torch.int32, device=cuda)
    d = lookup.build_directory(keys)
    with pytest.raises(ValueError, match="16-byte aligned"):
        cuda_kernels.lookup_taxa_directory_cuda(keys[1:], taxa[1:], lookup.build_directory(keys[1:]), keys)
    with pytest.raises(ValueError, match="do not fit"):
        cuda_kernels.lookup_taxa_directory_cuda(keys, taxa[:5], d, keys)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_kernels.lookup_taxa_directory_cuda(keys, taxa, d, torch.arange(20, device=cuda)[::2])


def _table_queries(rng, keys):
    """Queries of a tiled or row-bucket table's tests: every key, keys
    beside it, random values of any sign (wide: probe_cases.queries_of,
    with the all-ones rows of invalid windows) and -1."""
    if keys.ndim == 2:
        return probe_cases.queries_of(rng, keys, 45).view(np.int64)
    k = keys.view(np.int64)
    return np.concatenate([k, k + 1, k - 1, EDGE_QUERIES, [-1],
                           rng.integers(-(1 << 63), (1 << 63) - 1, 2000, dtype=np.int64)])


def _build_table(probe, keys, taxa, key_bits, **kwargs):
    if probe == "tiled":
        return lookup.build_tiled(keys, taxa, key_bits, **kwargs)
    return lookup.build_hashed_rows(keys, taxa, **kwargs)


def _assert_table_probe(cuda, probe, keys, taxa, key_bits, q, **kwargs):
    """The table built on the card == built on the CPU; its kernel (one
    launch, of the kind's name) == the twin == lookup_taxa on `q`."""
    k, t, q = torch.from_numpy(keys.view(np.int64)), torch.from_numpy(taxa), torch.from_numpy(q)
    host, card = (_build_table(probe, k.to(d), t.to(d), key_bits, **kwargs) for d in ("cpu", cuda))
    for a, b in zip(host, card):
        assert torch.equal(a, b.cpu()) if isinstance(a, torch.Tensor) else a == b
    name = ("probe_tiled" if probe == "tiled" else "probe_rows") + ("_wide" if keys.ndim == 2 else "")
    before = dict(cuda_kernels.LAUNCHES)
    got = lookup.probe(None, None, card, q.to(cuda))
    assert {k: v - before[k] for k, v in cuda_kernels.LAUNCHES.items() if v != before[k]} == {name: 1}
    want = lookup.lookup_taxa(k, t, q)
    assert torch.equal(got.cpu(), want) and torch.equal(lookup.probe(None, None, host, q), want)
    assert bool((want[:len(keys)] > 0).all())
    return card


@pytest.mark.parametrize("probe", ["tiled", "hashed1"])
@pytest.mark.parametrize("kind", probe_cases.TABLE_KINDS)
def test_table_probe_kernels_match_twins(cuda, kind, probe):
    """probe_tiled(_wide) and probe_rows(_wide) over tables built on the
    card: narrow keys (scrambles with the top bit set and clear), wide,
    26-bit ranks, a router bucket of 40 keys, none, and row hashes that tie."""
    rng = np.random.default_rng(len(kind))
    keys, taxa, key_bits = probe_cases.table_keys(rng, kind)
    table = _assert_table_probe(cuda, probe, keys, taxa, key_bits, _table_queries(rng, keys))
    if kind == "skewed" and probe == "tiled":
        assert table.tile == 64


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_row_probe_kernel_on_grown_tiles(cuda, wide):
    """A forced row_bits of 1: the tile grows to 512 and 1,024 lanes a block."""
    rng = np.random.default_rng(3)
    keys, taxa, key_bits = probe_cases.table_keys(rng, "wide" if wide else "narrow")
    for n, tile in ((600, 512), (1500, 1024)):
        table = _assert_table_probe(cuda, "hashed1", keys[:n], taxa[:n], key_bits,
                                    _table_queries(rng, keys[:n]), row_bits=1)
        assert (table.tile, table.row_bits) == (tile, 1)


def _assert_on_slices(cuda, card, host, keys, taxa, stream, name):
    """The kernel `name` over every slice of probe_cases.stream_slices of
    `stream`, each a view into one tensor on the card (an odd start lies 8
    bytes past a 16-byte boundary for int64 queries): one launch a non-empty
    slice, none for an empty one, == the twin over the CPU's table ==
    lookup_taxa (tolerance 0)."""
    k, t = torch.from_numpy(keys.view(np.int64)), torch.from_numpy(taxa)
    whole = torch.from_numpy(stream).to(cuda)
    for a, b in probe_cases.stream_slices(len(stream)):
        q = whole[a:b]
        before = dict(cuda_kernels.LAUNCHES)
        got = lookup.probe(None, None, card, q)
        assert _launched(before) == ({name: 1} if b > a else {}), (a, b)
        want = lookup.lookup_taxa(k, t, q.cpu())
        assert torch.equal(got.cpu(), want), (a, b)
        assert torch.equal(lookup.probe(None, None, host, q.cpu()), want), (a, b)


@pytest.mark.parametrize("kind", ["wide", "wide, tied row hashes"])
def test_row_probe_wide_kernel_on_query_streams(cuda, kind):
    """probe_rows_wide on runs of equal queries 1 to 9 long with -1 rows
    between, over every slice of probe_cases.stream_slices."""
    rng = np.random.default_rng(len(kind) + 7)
    keys, taxa, _ = probe_cases.table_keys(rng, kind)
    k, t = torch.from_numpy(keys.view(np.int64)), torch.from_numpy(taxa)
    host, card = lookup.build_hashed_rows(k, t), lookup.build_hashed_rows(k.to(cuda), t.to(cuda))
    base = probe_cases.queries_of(rng, keys, 45).view(np.int64)
    stream = np.concatenate([base, probe_cases.query_runs(rng, base, 3000)])
    _assert_on_slices(cuda, card, host, keys, taxa, stream, "probe_rows_wide")


@pytest.mark.parametrize("tile,row_bits", probe_cases.FULL_ROW_TILES)
def test_row_probe_wide_kernel_on_full_rows(cuda, tile, row_bits):
    """probe_rows_wide over tables forced to tiles of 12, 36, 512 and 1,024
    lanes whose even rows hold no free lane (their scans run to the tile),
    with queries all ones in every limb among the streams."""
    rng = np.random.default_rng(tile)
    keys, taxa = probe_cases.full_row_keys(rng, tile, row_bits)
    k, t = torch.from_numpy(keys.view(np.int64)), torch.from_numpy(taxa)
    host = lookup.build_hashed_rows(k, t, tile=tile, row_bits=row_bits)
    card = lookup.build_hashed_rows(k.to(cuda), t.to(cuda), tile=tile, row_bits=row_bits)
    assert (card.tile, card.row_bits) == (tile, row_bits) and torch.equal(host.table, card.table.cpu())
    base = probe_cases.queries_of(rng, keys, 45).view(np.int64)
    stream = np.concatenate([base, probe_cases.query_runs(rng, base, 500)])
    _assert_on_slices(cuda, card, host, keys, taxa, stream, "probe_rows_wide")


@pytest.mark.parametrize("kind", list(probe_cases.ROWS_WALK_CASES))
def test_row_probe_kernel_on_walk_cases(cuda, kind):
    """probe_rows on the hand-made narrow tables of
    probe_cases.rows_walk_case (full and empty rows, runs of equal hi' across
    a sector, the all-ones scramble with and without its key, tiles of 12,
    36 and 256): one launch, equal to the twin and lookup_taxa; the same
    with the walk started at lane 0 (n_keys 0), at floor(f * tile) (a
    mean of the tile) and at the tile's last lane for nearly every query
    (n_keys 2^50: the mean capped at 2^31 - 1), which moves where it
    starts, not what it answers; every negative query answered 0."""
    keys, taxa, q, tile, row_bits = probe_cases.rows_walk_case(np.random.default_rng(len(kind)), kind)
    card = _assert_table_probe(cuda, "hashed1", keys, taxa, 62, q, tile=tile, row_bits=row_bits)
    q = torch.from_numpy(q)
    want = lookup.lookup_taxa(torch.from_numpy(keys.view(np.int64)), torch.from_numpy(taxa), q)
    for n_keys in (0, tile << row_bits, 1 << 50):
        before = dict(cuda_kernels.LAUNCHES)
        got = lookup.probe(None, None, card._replace(n_keys=n_keys), q.to(cuda))
        assert _launched(before) == {"probe_rows": 1} and torch.equal(got.cpu(), want)
    assert bool((want[q < 0] == 0).all()) and int((q < 0).sum()) > 0


@pytest.mark.parametrize("kind", ["narrow", "tile 12"])
def test_row_probe_kernel_on_query_streams(cuda, kind):
    """probe_rows on runs of equal queries 1 to 9 long with an invalid
    window's -1 between, over every slice of probe_cases.stream_slices (an
    odd start 8 bytes past a 16-byte boundary, 0, 1, 3, 5 and 4k + 3
    queries): random narrow keys, and the hand-made table of tile 12."""
    rng = np.random.default_rng(len(kind) + 11)
    if kind == "narrow":
        keys, taxa, _ = probe_cases.table_keys(rng, kind)
        base, shape = probe_cases.hashed_queries(rng, keys), {}
    else:
        keys, taxa, base, tile, row_bits = probe_cases.rows_walk_case(rng, kind)
        shape = dict(tile=tile, row_bits=row_bits)
    k, t = torch.from_numpy(keys.view(np.int64)), torch.from_numpy(taxa)
    host, card = lookup.build_hashed_rows(k, t, **shape), lookup.build_hashed_rows(k.to(cuda), t.to(cuda), **shape)
    stream = np.concatenate([base, probe_cases.query_runs(rng, base, 3000)])
    _assert_on_slices(cuda, card, host, keys, taxa, stream, "probe_rows")


@pytest.mark.parametrize("kind", ["narrow", "tile 12"])
def test_rows_floor_kernel_reads_the_guessed_sector(cuda, kind):
    """The narrow row probe's floor (a measurement on no path) equals its
    plain version, lookup.guess_sectors, with the build's mean, with one
    that sends the guesses across the whole tile and with one that sends
    them to its last lane (past it at tile 12: the row's first lo' lanes),
    and launches no counted kernel; it takes no wide table."""
    rng = np.random.default_rng(len(kind) + 5)
    if kind == "narrow":
        keys, taxa, _ = probe_cases.table_keys(rng, kind)
        q, shape = probe_cases.hashed_queries(rng, keys), {}
    else:
        keys, taxa, q, tile, row_bits = probe_cases.rows_walk_case(rng, kind)
        shape = dict(tile=tile, row_bits=row_bits)
    table = lookup.build_hashed_rows(torch.from_numpy(keys.view(np.int64)).to(cuda),
                                     torch.from_numpy(taxa).to(cuda), **shape)
    q = torch.from_numpy(q).to(cuda)
    for n_keys in (table.n_keys, table.tile << table.row_bits, 1 << 50):
        before = dict(cuda_kernels.LAUNCHES)
        got = cuda_kernels.rows_floor_cuda(table._replace(n_keys=n_keys), q)
        assert _launched(before) == {}
        want = lookup.guess_sectors(table._replace(n_keys=n_keys), q)
        assert torch.equal(got, want)
        if n_keys < 1 << 50:  # the last sector of a narrow row here is free lanes, whose xor is 0
            assert int((want != 0).sum()) > len(keys) // 2
    wide_keys, wide_taxa, _ = probe_cases.table_keys(rng, "wide")
    wide = lookup.build_hashed_rows(torch.from_numpy(wide_keys.view(np.int64)).to(cuda),
                                    torch.from_numpy(wide_taxa).to(cuda))
    with pytest.raises(ValueError, match="narrow"):
        cuda_kernels.rows_floor_cuda(wide, torch.from_numpy(wide_keys.view(np.int64)).to(cuda))


@pytest.mark.parametrize("kind", list(probe_cases.TILED_WALK_KINDS))
def test_tiled_probe_kernel_on_walk_cases(cuda, kind):
    """probe_tiled(_wide) on the hand-made tables of
    probe_cases.tiled_walk_case (buckets of 0 to 9 records and of the tile +
    1, starting at every record modulo 4, the first at record 0, the last
    ending at the last key; 62-bit keys, 26-bit ranks, wide keys whose l3
    is 0): one launch, equal to the twin and lookup_taxa; then on runs of
    equal queries with invalid windows between, over every slice of
    probe_cases.stream_slices."""
    rng = np.random.default_rng(len(kind))
    keys, taxa, key_bits, q = probe_cases.tiled_walk_case(rng, kind)
    card = _assert_table_probe(cuda, "tiled", keys, taxa, key_bits, q)
    host = lookup.build_tiled(torch.from_numpy(keys.view(np.int64)), torch.from_numpy(taxa), key_bits)
    stream = np.concatenate([q, probe_cases.query_runs(rng, q, 3000)])
    _assert_on_slices(cuda, card, host, keys, taxa, stream, "probe_tiled_wide" if keys.ndim == 2 else "probe_tiled")


@pytest.mark.parametrize("kind", [*probe_cases.TILED_WALK_KINDS, "wide"])
def test_tiled_floor_kernel_reads_the_first_sector(cuda, kind):
    """The tiled probe's floor (a measurement on no path) equals its plain
    version, lookup.router_sectors, narrow and wide, and launches no counted
    kernel."""
    rng = np.random.default_rng(len(kind) + 3)
    if kind == "wide":
        keys, taxa, key_bits = probe_cases.table_keys(rng, kind)
        q = probe_cases.queries_of(rng, keys, 45).view(np.int64)
    else:
        keys, taxa, key_bits, q = probe_cases.tiled_walk_case(rng, kind)
    table = lookup.build_tiled(torch.from_numpy(keys.view(np.int64)).to(cuda), torch.from_numpy(taxa).to(cuda),
                               key_bits)
    q = torch.from_numpy(q).to(cuda)
    before = dict(cuda_kernels.LAUNCHES)
    got = cuda_kernels.tiled_floor_cuda(table, q)
    assert _launched(before) == {}
    want = lookup.router_sectors(table, q)
    assert torch.equal(got, want) and int((want != 0).sum()) > q.shape[0] // 2


def test_tiled_probe_refuses_records_off_16_bytes(cuda):
    """The tiled probe and its floor read records 16 bytes at a time: a
    table whose records start 4 bytes past a 16-byte boundary raises
    ValueError, and so does one whose router does not fit."""
    keys, taxa, key_bits = probe_cases.table_keys(np.random.default_rng(2), "narrow")
    k = torch.from_numpy(keys.view(np.int64)).to(cuda)
    table = lookup.build_tiled(k, torch.from_numpy(taxa).to(cuda), key_bits)
    shifted = torch.empty(table.table.numel() + 4, dtype=torch.int32, device=cuda)[1:1 + table.table.numel()]
    shifted = shifted.view_as(table.table).copy_(table.table)
    assert shifted.data_ptr() % 16 == 4
    for fn in (cuda_kernels.lookup_taxa_tiled_cuda, cuda_kernels.tiled_floor_cuda):
        with pytest.raises(ValueError, match="16-byte aligned"):
            fn(table._replace(table=shifted), k)
        with pytest.raises(ValueError, match="does not fit"):
            fn(table._replace(bits=table.bits + 1), k)
    assert torch.equal(cuda_kernels.lookup_taxa_tiled_cuda(table, k).cpu(), torch.from_numpy(taxa))


def test_table_probe_kernels_refuse_what_they_do_not_take(cuda):
    keys = torch.arange(0, 1 << 40, 1 << 30, device=cuda)
    taxa = torch.ones(keys.shape[0], dtype=torch.int32, device=cuda)
    tiled, rows = lookup.build_tiled(keys, taxa, 62), lookup.build_hashed_rows(keys, taxa)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_kernels.lookup_taxa_tiled_cuda(tiled, keys.cpu())
    with pytest.raises(ValueError, match="does not fit"):
        cuda_kernels.lookup_taxa_tiled_cuda(tiled._replace(bits=tiled.bits + 1), keys)
    with pytest.raises(ValueError, match="does not fit"):
        cuda_kernels.lookup_taxa_rows_cuda(rows._replace(row_bits=rows.row_bits + 1), keys)
    with pytest.raises(ValueError, match="does not fit"):
        cuda_kernels.lookup_taxa_rows_cuda(rows._replace(n_keys=-1), keys)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_kernels.lookup_taxa_rows_cuda(rows, torch.arange(20, device=cuda)[::2])
    with pytest.raises(ValueError, match="1-d"):
        cuda_kernels.lookup_taxa_rows_cuda(rows, keys.view(-1, 2))


def _launched(before):
    return {k: v - before[k] for k, v in cuda_kernels.LAUNCHES.items() if v != before[k]}


def _assert_hashed_probe(cuda, keys, taxa, q, cols, **kwargs):
    """The hashed table built on the card == built on the CPU; its kernel
    (one launch of probe_hashed or probe_hashed_cols) == the twin ==
    lookup_taxa on `q`. Returns the card's table."""
    build = lookup.build_hashed_cols if cols else lookup.build_hashed
    k, t, q = torch.from_numpy(keys.view(np.int64)), torch.from_numpy(taxa), torch.from_numpy(q)
    host, card = build(k, t, **kwargs), build(k.to(cuda), t.to(cuda), **kwargs)
    assert (host.tile, host.bits) == (card.tile, card.bits) and torch.equal(host.table, card.table.cpu())
    before = dict(cuda_kernels.LAUNCHES)
    got = lookup.probe(None, None, card, q.to(cuda))
    assert _launched(before) == {"probe_hashed_cols" if cols else "probe_hashed": 1}
    want = lookup.lookup_taxa(k, t, q)
    assert torch.equal(got.cpu(), want) and torch.equal(lookup.probe(None, None, host, q), want)
    assert bool((want[:len(keys)] > 0).all())
    return card


@pytest.mark.parametrize("cols", [False, True], ids=["hashed", "hashed128"])
@pytest.mark.parametrize("kind", probe_cases.HASHED_KINDS)
def test_hashed_probe_kernel_matches_twin(cuda, kind, cols):
    """probe_hashed and probe_hashed_cols over tables built on the card:
    random keys, clustered 26-bit ranks, a full run of displacement tile - 1
    ending at the table's last occupied slot, the all-ones scramble's key
    parked last (and the same table without it), homes beyond the table's
    end, no keys; random queries of any sign."""
    tile = lookup.HASHED_COLS_TILE if cols else lookup.HASHED_TILE
    rng = np.random.default_rng(len(kind) + tile)
    keys, taxa = probe_cases.hashed_keys(rng, kind, tile)
    q = probe_cases.hashed_queries(rng, keys)
    _assert_hashed_probe(cuda, keys, taxa, q, cols)
    if kind == "all-ones scramble":
        keep = keys != np.uint64(probe_cases.ALL_ONES_KEY)
        _assert_hashed_probe(cuda, keys[keep], taxa[keep], probe_cases.hashed_queries(rng, keys[keep]), cols)


@pytest.mark.parametrize("cols", [False, True], ids=["hashed", "hashed128"])
def test_hashed_probe_kernel_on_grown_tiles(cuda, cols):
    """Forced bits below the keys' need (2,048 slots for 3,000 keys): the
    tile grows to 1,024 slots."""
    rng = np.random.default_rng(4)
    keys, taxa = probe_cases.hashed_keys(rng, "random", 16)
    table = _assert_hashed_probe(cuda, keys, taxa, probe_cases.hashed_queries(rng, keys), cols, bits=11)
    assert (table.tile, table.bits) == (1024, 11)


@pytest.mark.parametrize("cols", [False, True], ids=["hashed", "hashed128"])
@pytest.mark.parametrize("kind", probe_cases.HASHED_KINDS)
def test_hashed_probe_kernel_on_query_streams(cuda, kind, cols):
    """probe_hashed (and probe_hashed_cols) on runs of equal queries 1 to 9
    long with -1 between, over every slice of probe_cases.stream_slices: an
    odd start 8 bytes past a 16-byte boundary, 0, 1, 3, 5 and 4k + 3
    queries; the hashed key sets hold homes past the table's end, a key at
    displacement tile - 1 and the all-ones scramble."""
    tile = lookup.HASHED_COLS_TILE if cols else lookup.HASHED_TILE
    rng = np.random.default_rng(len(kind) + tile + 1)
    keys, taxa = probe_cases.hashed_keys(rng, kind, tile)
    k, t = torch.from_numpy(keys.view(np.int64)), torch.from_numpy(taxa)
    build = lookup.build_hashed_cols if cols else lookup.build_hashed
    host, card = build(k, t), build(k.to(cuda), t.to(cuda))
    base = probe_cases.hashed_queries(rng, keys)
    stream = np.concatenate([base, probe_cases.query_runs(rng, base, 3000)])
    _assert_on_slices(cuda, card, host, keys, taxa, stream, "probe_hashed_cols" if cols else "probe_hashed")


@pytest.mark.parametrize("kind", probe_cases.COLS_WALK_KINDS)
def test_hashed_cols_kernel_on_walk_cases(cuda, kind):
    """probe_hashed_cols on the hand-made hashed128 tables of
    probe_cases.cols_walk_case (homes in a block's last lanes, a walk across
    a row, free lanes before the home slot, runs of equal hi' across a
    block, the all-ones scramble with and without its key, homes in the
    table's last rows): one launch, equal to the twin and lookup_taxa."""
    keys, taxa, q = probe_cases.cols_walk_case(np.random.default_rng(len(kind)), kind)
    _assert_hashed_probe(cuda, keys, taxa, q, True, bits=probe_cases.COLS_BITS)


@pytest.mark.parametrize("cols", [False, True], ids=["hashed", "hashed128"])
def test_hashed_floor_kernel_reads_the_home_sector(cuda, cols):
    """The floor of the hashed probes (a measurement on no path) equals its
    plain version, lookup.home_sectors, and launches no counted kernel."""
    rng = np.random.default_rng(6)
    keys, taxa = probe_cases.hashed_keys(rng, "low half", lookup.HASHED_COLS_TILE)
    build = lookup.build_hashed_cols if cols else lookup.build_hashed
    table = build(torch.from_numpy(keys.view(np.int64)).to(cuda), torch.from_numpy(taxa).to(cuda))
    q = torch.from_numpy(probe_cases.hashed_queries(rng, keys)).to(cuda)
    before = dict(cuda_kernels.LAUNCHES)
    got = cuda_kernels.hashed_floor_cuda(table, q)
    assert _launched(before) == {}
    want = lookup.home_sectors(table, q)
    assert torch.equal(got, want) and int((want != 0).sum()) > len(keys) // 2


@pytest.mark.parametrize("kind", ["narrow", "rank table", "skewed", "empty"])
def test_hashed_probe_bucketed_route_matches_twin(cuda, kind):
    """--probe bucketed on the card: probe_bucketed_kernel over the router
    and the padded arrays (one launch, none for an empty index) ==
    lookup_taxa_bucketed over them == lookup_taxa; the arrays built on the
    card == on the CPU."""
    rng = np.random.default_rng(len(kind))
    keys, taxa, key_bits = probe_cases.table_keys(rng, kind)
    k, t = torch.from_numpy(keys.view(np.int64)), torch.from_numpy(taxa)
    q = torch.from_numpy(_table_queries(rng, keys))
    host, card = lookup.build_bucketed(k, t, key_bits), lookup.build_bucketed(k.to(cuda), t.to(cuda), key_bits)
    for a, b in zip(host, card):
        assert torch.equal(a, b.cpu()) if isinstance(a, torch.Tensor) else a == b
    before = dict(cuda_kernels.LAUNCHES)
    got = lookup.probe(None, None, card, q.to(cuda))
    assert _launched(before) == ({"probe_bucketed": 1} if len(keys) else {})
    want = lookup.lookup_taxa(k, t, q)
    assert torch.equal(got.cpu(), want) and torch.equal(lookup.lookup_taxa_bucketed(host, q), want)
    if kind == "skewed":
        assert card.maxb == 40


def test_hashed_probe_routes_refuse_what_they_do_not_take(cuda):
    """What the hashed kernel and the bucketed kernel do not take raises
    ValueError."""
    keys = torch.arange(0, 1 << 40, 1 << 30, device=cuda)
    taxa = torch.ones(keys.shape[0], dtype=torch.int32, device=cuda)
    hashed, bucketed = lookup.build_hashed(keys, taxa), lookup.build_bucketed(keys, taxa, 62)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_kernels.lookup_taxa_hashed_cuda(hashed, keys.cpu())
    with pytest.raises(ValueError, match="does not fit"):
        cuda_kernels.lookup_taxa_hashed_cuda(hashed._replace(tile=hashed.tile + 1), keys)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_kernels.lookup_taxa_hashed_cuda(hashed, torch.arange(20, device=cuda)[::2])
    with pytest.raises(ValueError, match="1-d"):
        cuda_kernels.lookup_taxa_hashed_cuda(hashed, keys.view(-1, 2))
    with pytest.raises(ValueError, match="does not fit"):
        cuda_kernels.lookup_taxa_bucketed_cuda(bucketed._replace(bits=bucketed.bits + 1), keys)
    with pytest.raises(ValueError, match="do not fit"):
        cuda_kernels.lookup_taxa_bucketed_cuda(bucketed._replace(taxa=bucketed.taxa[1:]), keys)
    with pytest.raises(ValueError, match="16-byte aligned"):
        cuda_kernels.lookup_taxa_bucketed_cuda(bucketed._replace(keys=bucketed.keys[1:], taxa=bucketed.taxa[1:]),
                                               keys)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_kernels.lookup_taxa_bucketed_cuda(bucketed, torch.arange(20, device=cuda)[::2])


def _bucketed(cuda, keys, taxa, key_bits):
    """The bucketed arrays of these keys built on the CPU and on the card,
    held equal."""
    k, t = torch.from_numpy(keys.view(np.int64)), torch.from_numpy(taxa)
    host, card = lookup.build_bucketed(k, t, key_bits), lookup.build_bucketed(k.to(cuda), t.to(cuda), key_bits)
    for a, b in zip(host, card):
        assert torch.equal(a, b.cpu()) if isinstance(a, torch.Tensor) else a == b
    return host, card


@pytest.mark.parametrize("kind", [*probe_cases.BUCKETED_WALK_KINDS, "narrow", "skewed"])
def test_bucketed_probe_kernel_on_walk_cases(cuda, kind):
    """probe_bucketed on the hand-made arrays of
    probe_cases.bucketed_walk_case (buckets of 0 to 9 keys and of maxb,
    starting at every key modulo 4, the first at key 0, the last ending at
    the last key right before the padding; one key a bucket, maxb 1) and on
    probe_cases.table_keys' random keys and 40 keys under one prefix: one
    launch, equal to the twin, to the kernel's numpy walk and to
    lookup_taxa; then on runs of equal queries with invalid windows
    between, over every slice of probe_cases.stream_slices."""
    rng = np.random.default_rng(len(kind))
    if kind in probe_cases.BUCKETED_WALK_KINDS:
        keys, taxa, key_bits, q = probe_cases.bucketed_walk_case(rng, kind)
    else:
        keys, taxa, key_bits = probe_cases.table_keys(rng, kind)
        q = _table_queries(rng, keys)
    host, card = _bucketed(cuda, keys, taxa, key_bits)
    before = dict(cuda_kernels.LAUNCHES)
    got = lookup.probe(None, None, card, torch.from_numpy(q).to(cuda))
    assert _launched(before) == {"probe_bucketed": 1}
    want = lookup.lookup_taxa(torch.from_numpy(keys.view(np.int64)), torch.from_numpy(taxa), torch.from_numpy(q))
    assert torch.equal(got.cpu(), want) and torch.equal(lookup.lookup_taxa_bucketed(host, torch.from_numpy(q)), want)
    assert np.array_equal(probe_cases.bucketed_walk(host, q), want.numpy()) and bool((want[:len(keys)] > 0).all())
    stream = np.concatenate([q, probe_cases.query_runs(rng, q, 3000)])
    _assert_on_slices(cuda, card, host, keys, taxa, stream, "probe_bucketed")


@pytest.mark.parametrize("kind", [*probe_cases.BUCKETED_WALK_KINDS, "skewed"])
def test_bucketed_floor_kernel_reads_the_guessed_sector(cuda, kind):
    """The bucketed probe's floor (a measurement on no path) equals its
    plain version, lookup.bucket_sectors, and launches no counted kernel."""
    rng = np.random.default_rng(len(kind) + 3)
    if kind in probe_cases.BUCKETED_WALK_KINDS:
        keys, taxa, key_bits, q = probe_cases.bucketed_walk_case(rng, kind)
    else:
        keys, taxa, key_bits = probe_cases.table_keys(rng, kind)
        q = _table_queries(rng, keys)
    _, card = _bucketed(cuda, keys, taxa, key_bits)
    q = torch.from_numpy(q).to(cuda)
    before = dict(cuda_kernels.LAUNCHES)
    got = cuda_kernels.bucketed_floor_cuda(card, q)
    assert _launched(before) == {}
    want = lookup.bucket_sectors(card, q)
    assert torch.equal(got, want) and int((want != 0).sum()) > q.shape[0] // 4


def test_bucketed_probe_refuses_keys_off_16_bytes(cuda):
    """The bucketed probe and its floor read two keys a load: keys that
    start 8 bytes past a 16-byte boundary raise ValueError, and so does a
    router that does not fit."""
    keys, taxa, key_bits = probe_cases.table_keys(np.random.default_rng(2), "narrow")
    k = torch.from_numpy(keys.view(np.int64)).to(cuda)
    table = lookup.build_bucketed(k, torch.from_numpy(taxa).to(cuda), key_bits)
    shifted = torch.empty(table.keys.numel() + 2, dtype=torch.int64, device=cuda)[1:1 + table.keys.numel()]
    shifted.copy_(table.keys)
    assert shifted.data_ptr() % 16 == 8
    for fn in (cuda_kernels.lookup_taxa_bucketed_cuda, cuda_kernels.bucketed_floor_cuda):
        with pytest.raises(ValueError, match="16-byte aligned"):
            fn(table._replace(keys=shifted), k)
        with pytest.raises(ValueError, match="does not fit"):
            fn(table._replace(bits=table.bits + 1), k)
    assert torch.equal(cuda_kernels.lookup_taxa_bucketed_cuda(table, k).cpu(), torch.from_numpy(taxa))


@pytest.mark.parametrize("shape", [(8, 128), (4096, 128), (5, 16), (33, 1000)])
@pytest.mark.parametrize("name", cuda_kernels.MASK_IDIOMS)
def test_mask_idiom_kernel_matches_twin(cuda, name, shape):
    rng = np.random.default_rng(7)
    x = rng.integers(0, 129, shape).astype(np.int32)
    x[0, :3] = [np.iinfo(np.int32).max, np.iinfo(np.int32).min, 65]
    before = cuda_kernels.LAUNCHES[name]
    got = mask_idioms.run(name, torch.from_numpy(x).to(cuda))
    assert cuda_kernels.LAUNCHES[name] == before + 1
    want = mask_idioms.PLAIN[name](torch.from_numpy(x))
    assert got.dtype == want.dtype and torch.equal(got.cpu(), want)


@pytest.mark.parametrize("name", cuda_kernels.MASK_IDIOMS)
def test_mask_idiom_kernel_writes_into_out(cuda, name):
    x = torch.from_numpy(np.random.default_rng(11).integers(0, 129, (33, 1000)).astype(np.int32)).to(cuda)
    out = torch.full_like(x, -7)
    assert cuda_kernels.mask_idiom_cuda(name, x, out=out) is out
    assert torch.equal(out.cpu(), mask_idioms.PLAIN[name](x.cpu()))
    for bad in (x, out[:5], out.long()):
        with pytest.raises(ValueError):
            cuda_kernels.mask_idiom_cuda(name, x, out=bad)


def test_mask_idiom_kernel_rejects_what_it_does_not_take(cuda):
    for bad in (torch.zeros((8, 8), dtype=torch.int32), torch.zeros((8, 128), dtype=torch.int64),
                torch.zeros(128, dtype=torch.int32)):
        with pytest.raises(ValueError):
            mask_idioms.run("select", bad.to(cuda))
    with pytest.raises(ValueError, match="contiguous"):
        mask_idioms.run("select", torch.zeros((8, 256), dtype=torch.int32, device=cuda)[:, ::2])


def test_kernel_probe_says_ok(cuda):
    assert diagnostics.kernel_probe(cuda) == {name: "ok" for name in cuda_kernels.MASK_IDIOMS}


@pytest.mark.parametrize("shape,offset", [
    ((5, 16), 0),         # under one block
    ((8, 128), 0),
    ((4096, 128), 0),     # the diagnostics' shape: one int4 a thread
    ((16384, 128), 0),    # more vectors than the resident grid has threads: several grid-stride rounds
    ((1201, 1001), 1),    # off a 16-byte boundary: the scalar path, several rounds, an odd tail
])
def test_sum_bool_cooperative_kernel_matches_twin(cuda, shape, offset):
    """The one-kernel k_sum_bool at five shapes, launched three times in a row
    (its two counters alternate by launch parity and are never memset)."""
    rng = np.random.default_rng(shape[0])
    n = shape[0] * shape[1]
    flat = rng.integers(0, 129, n + offset).astype(np.int32)
    flat[offset : offset + 3] = [np.iinfo(np.int32).max, np.iinfo(np.int32).min, 65]
    x = torch.from_numpy(flat).to(cuda)[offset:].view(shape)
    want = mask_idioms.sum_bool_plain(torch.from_numpy(flat[offset:]).view(shape))
    before = cuda_kernels.LAUNCHES["sum_bool"]
    for _ in range(3):
        assert torch.equal(mask_idioms.run("sum_bool", x).cpu(), want)
    assert cuda_kernels.LAUNCHES["sum_bool"] == before + 3
    other = torch.cuda.Stream()
    with torch.cuda.stream(other):  # another stream has counters of its own
        got = mask_idioms.run("sum_bool", x)
    other.synchronize()
    assert torch.equal(got.cpu(), want)


def _small_library(kind):
    """(taxonomy, genomes, index parameters) of six 3 kbp genomes, 2.6 kbp of
    each its own and 400 bp shared within its genus, under a two-level
    taxonomy with species at depth 8."""
    from slacken_tpu_torch.index import IndexParams
    from slacken_tpu_torch.taxonomy import Taxonomy

    rng = np.random.default_rng(12)
    nodes = [(1, 1, "root"), (100, 1, "genus"), (101, 1, "genus")]
    nodes += [(10 + i, 100 + i // 3, "species") for i in range(6)]
    tax = Taxonomy.from_nodes_and_names(nodes, [(t, f"t{t}") for t, _, _ in nodes])
    letters = np.frombuffer(b"ACGT", np.uint8)
    own, shared = rng.integers(0, 4, (6, 2600)), rng.integers(0, 4, (2, 400))
    genomes = [(10 + i, letters[np.concatenate([own[i], shared[i // 3]])].tobytes().decode()) for i in range(6)]
    params = {"narrow": IndexParams(), "wide": IndexParams(k=50, m=45, spaces=7),
              "lexicographic": IndexParams(k=21, m=11, spaces=2, ordering="lexicographic")}[kind]
    return tax, genomes, params


@pytest.mark.parametrize("kind", ["narrow", "wide", "lexicographic"])
def test_restricted_build_respace_and_span_hits_on_the_card(cuda, kind, tmp_path):
    """build_restricted, respace and Dynamic._span_hits on cuda against the
    same on the CPU; the restricted index stays on the card."""
    from slacken_tpu_torch import dynamic
    from slacken_tpu_torch.classify import ClassifyParams, Fragment
    from slacken_tpu_torch.index import KeyValueIndex

    tax, genomes, params = _small_library(kind)
    on = {d: KeyValueIndex.build(iter(genomes), params, tax, d, keep_records=True) for d in ("cpu", cuda)}
    assert torch.equal(on[cuda].record_keys_t.cpu(), on["cpu"].record_keys_t)
    assert torch.equal(on[cuda].record_taxa_t.cpu(), on["cpu"].record_taxa_t)
    taxon_set = {10, 11, 14, 100}
    got, want = on[cuda].build_restricted(taxon_set), on["cpu"].build_restricted(taxon_set)
    assert got.keys_t.device.type == "cuda" and 0 < got.num_records < on[cuda].num_records
    assert torch.equal(got.keys_t.cpu(), want.keys_t) and torch.equal(got.taxa_t.cpu(), want.taxa_t)
    from_host = on["cpu"].build_restricted(taxon_set, cuda)  # a sidecar on the host, reduced on the card
    assert from_host.keys_t.device.type == "cuda" and torch.equal(from_host.keys_t.cpu(), want.keys_t)
    rebuilt = KeyValueIndex.build(iter(genomes), params, tax, cuda, taxon_filter=taxon_set)
    assert torch.equal(rebuilt.keys_t, got.keys_t) and torch.equal(rebuilt.taxa_t, got.taxa_t)
    if kind != "lexicographic":
        a, b = on[cuda].respace(params.spaces + 4), on["cpu"].respace(params.spaces + 4)
        assert a.keys_t.device.type == "cuda" and 0 < a.num_records <= on[cuda].num_records and a.params.spaces == params.spaces + 4
        assert torch.equal(a.keys_t.cpu(), b.keys_t) and torch.equal(a.taxa_t.cpu(), b.taxa_t)
    frags = [Fragment(f"r{i}", genomes[i % 3][1][i * 20 : i * 20 + 101]) for i in range(100)]
    frags += [Fragment(f"p{i}", genomes[4][1][i * 10 : i * 10 + 90], genomes[4][1][i * 10 + 200 : i * 10 + 300])
              for i in range(50)]
    hits = {}
    for d in ("cpu", cuda):
        dyn = dynamic.Dynamic(on[d], None, 8, dynamic.MinimizerDistinctCount(5), ClassifyParams(), None,
                              str(tmp_path / str(d)), d)
        before = dict(cuda_kernels.LAUNCHES)
        keys, taxa = dyn._span_hits(frags)
        launched = {k: v - before[k] for k, v in cuda_kernels.LAUNCHES.items() if v != before[k]}
        scan = "scan_wide" if kind == "wide" else "scan_lut" if kind == "lexicographic" else "scan"
        assert launched == ({} if d == "cpu" else {scan: 2, "probe_wide" if kind == "wide" else "probe_slots": 2})
        assert keys.device.type == torch.device(d).type
        hits[d] = (keys.cpu(), taxa.cpu(), dyn.distinct_minimizers_per_taxon(frags),
                   dyn.total_minimizers_per_taxon(frags))
    from slacken_tpu_torch.index import distinct_pairs
    assert len(hits[cuda][1]) > 100 and hits[cuda][2:] == hits["cpu"][2:]
    for a, b in zip(distinct_pairs(*hits[cuda][:2]), distinct_pairs(*hits["cpu"][:2])):
        assert torch.equal(a, b)
    assert torch.equal(hits[cuda][0], hits["cpu"][0]) and torch.equal(hits[cuda][1], hits["cpu"][1])


@pytest.mark.parametrize("kind", ["narrow", "wide", "lexicographic"])
def test_fragment_pass_of_long_rows_matches_the_twins(cuda, kind):
    """bracken.fragment_pass at [4, 1 << 20], a batch of four rows of the
    longest fragment: the scan kernel (512 segments a row), the stitch and
    the probe kernel (of this kind of index) each launched once, all four
    outputs equal to the twins'."""
    from slacken_tpu_torch import bracken
    from slacken_tpu_torch.index import KeyValueIndex

    tax, genomes, params = _small_library(kind)
    idx = KeyValueIndex.build(iter(genomes), params, tax, "cpu")
    codes = _codes((4, 1 << 20), seed=41)
    for r in range(4):  # genome sequence near both ends of each row, so that it hits the index there
        for off in (1000 * r, (1 << 20) - 7000 + 1000 * r):
            codes[r, off : off + 3000] = encode.encode_seq(genomes[r][1])
    scan = {"narrow": "scan", "wide": "scan_wide", "lexicographic": "scan_lut"}[kind]
    before = dict(cuda_kernels.LAUNCHES)
    got = bracken.fragment_pass(idx, codes, cuda)
    assert {k: v - before[k] for k, v in cuda_kernels.LAUNCHES.items() if v != before[k]} == {
        scan: 1, "scan_stitch": 1, "probe_wide" if kind == "wide" else "probe_slots": 1}
    want = bracken.fragment_pass(idx, codes, "cpu")
    for g, w in zip(got, want):
        assert g.shape == (4, 1 << 20) and torch.equal(g.cpu(), w)
    assert int((want.looked[:, -7000:] > 0).sum()) > 1000


@pytest.mark.parametrize("kind", ["narrow", "wide", "lexicographic"])
@pytest.mark.parametrize("few_taxa", [64, 1])
def test_bracken_device_path_matches_numpy_on_the_card(cuda, kind, few_taxa, monkeypatch):
    """BrackenWeights on the card (the device window classifier serves every
    row) equal to the numpy path on the CPU; fragments split at 2,048 bases
    so that several rows share a batch; with FEW_TAXA of 1 the rows that hit
    two taxa or more (some in every batch) are classified in a group of
    their own."""
    from slacken_tpu_torch import bracken
    from slacken_tpu_torch.index import KeyValueIndex
    from slacken_tpu_torch.workloads import GenomeList

    monkeypatch.setattr(bracken, "FRAGMENT_MAX", 2048)
    tax, genomes, params = _small_library(kind)
    lib, taxa = GenomeList(genomes), {t for t, _ in genomes}
    want = bracken.BrackenWeights(KeyValueIndex.build(iter(genomes), params, tax, "cpu"), 100,
                                  device="cpu").build_weights(lib, taxa)
    idx = KeyValueIndex.build(iter(genomes), params, tax, cuda)
    monkeypatch.setattr(bracken, "FEW_TAXA", few_taxa)
    calls = []
    real = bracken.window_classify
    monkeypatch.setattr(bracken, "window_classify",
                        lambda scan, *a: calls.append((scan.looked.shape[0], a[-1])) or real(scan, *a))
    assert bracken.BrackenWeights(idx, 100, device=cuda).build_weights(lib, taxa) == want
    rows = sum(1 for _ in bracken.BrackenWeights(idx, 100, device=cuda)._iter_fragments(lib, taxa))
    assert sum(r for r, _ in calls) == rows and max(n for _, n in calls) > 1


def test_window_counts_match_numpy_on_random_rows_on_the_card(cuda):
    """bracken.window_dest_counts on the card against the numpy path on the
    CPU, row by row, on random fragment-pass outputs over a random
    200-node taxonomy: runs of taxa from pools of 2 to 90 nodes (ties and
    LCAs abound), misses, invalid windows, random span starts and flags;
    rows of 2^16 positions, the widest above FEW_TAXA."""
    from types import SimpleNamespace

    from slacken_tpu_torch import bracken
    from slacken_tpu_torch.index import IndexParams
    from slacken_tpu_torch.taxonomy import Taxonomy

    rng = np.random.default_rng(5)
    nodes = [(1, 1, "root")] + [(t, int(rng.integers(1, t)), "no rank") for t in range(2, 201)]
    tax = Taxonomy.from_nodes_and_names(nodes, [(t, f"t{t}") for t, _, _ in nodes])
    b, l = 8, 1 << 16
    looked = np.zeros((b, l), np.int32)
    for row in range(b):
        pool = rng.choice(np.arange(1, 201), size=90 if row == 0 else int(rng.integers(2, 60)), replace=False)
        looked[row] = np.repeat(rng.choice(np.append(pool, 0), size=l), rng.integers(1, 3 if row == 0 else 12, l))[:l]
    flags = [rng.random((b, l)) < p for p in (0.97, 0.3, 0.8)]
    host = bracken.FragmentScan(torch.from_numpy(looked), *(torch.from_numpy(f) for f in flags))
    lengths = [l - 7 * r for r in range(b)]
    index = SimpleNamespace(taxonomy=tax, params=IndexParams())
    on_card = bracken.BrackenWeights(index, 100, device=cuda)
    got = on_card._dest_counts(bracken.FragmentScan(*(x.to(cuda) for x in host)), lengths)
    want = bracken.BrackenWeights(index, 100, device="cpu")._dest_counts(host, lengths)
    assert got == want and int(bracken.hit_taxa_per_row(host).max()) > bracken.FEW_TAXA


@pytest.mark.parametrize("layout", ["replicated", "ring"])
@pytest.mark.parametrize("kind", ["narrow", "wide", "lexicographic"])
def test_mesh_classifier_on_the_card(cuda, kind, layout):
    """MeshClassifier over Mesh([cuda:0] * 8) against the same over [cpu] * 8
    and the single-device classifier on the card, per-read mode; each of the
    8 row chunks of a batch launches its scan, and the ring probes every
    visiting chunk in every shard."""
    from slacken_tpu_torch.classify import Classifier, ClassifyParams, Fragment
    from slacken_tpu_torch.index import KeyValueIndex
    from slacken_tpu_torch.parallel.classifier import MeshClassifier

    tax, genomes, params = _small_library(kind)
    idx = KeyValueIndex.build(iter(genomes), params, tax, "cpu")
    frags = [Fragment(f"r{i}", genomes[i % 6][1][i * 20 : i * 20 + 101]) for i in range(100)]
    frags += [Fragment(f"p{i}", genomes[4][1][i * 10 : i * 10 + 90], genomes[4][1][i * 10 + 200 : i * 10 + 300])
              for i in range(40)]
    cpar = ClassifyParams(thresholds=[0.0, 0.15])
    card = MeshClassifier(idx, [torch.device("cuda", 0)] * 8, layout)
    before = dict(cuda_kernels.LAUNCHES)
    got = card.classify(frags, cpar)
    launched = {k: v - before[k] for k, v in cuda_kernels.LAUNCHES.items() if v != before[k]}
    scan = "scan_wide" if kind == "wide" else "scan_lut" if kind == "lexicographic" else "scan"
    probe = "probe_wide" if kind == "wide" else "probe_slots"
    batches = 2  # single reads in 128-wide rows, pairs in 256-wide rows
    assert launched == {scan: 8 * batches, probe: (64 if layout == "ring" else 8) * batches}
    assert got == MeshClassifier(idx, ["cpu"] * 8, layout).classify(frags, cpar)
    assert got == Classifier(idx, cuda).classify(frags, cpar)
    assert sum(r.classified for r in got[0.0]) > 100


@pytest.mark.parametrize("layout", ["replicated", "ring"])
def test_mesh_with_empty_shards_on_the_card(cuda, layout):
    """Three keys over 8 shards on the card: the empty shards' probes answer
    0 without a launch."""
    from slacken_tpu_torch.classify import Classifier, ClassifyParams, Fragment
    from slacken_tpu_torch.index import KeyValueIndex
    from slacken_tpu_torch.parallel.classifier import MeshClassifier

    tax, genomes, params = _small_library("narrow")
    idx = KeyValueIndex.build(iter(genomes), params, tax, "cpu")
    small = idx.with_records(idx.keys_t[100:103].clone(), idx.taxa_t[100:103].clone())
    frags = [Fragment(f"r{i}", genomes[i % 6][1][i * 20 : i * 20 + 101]) for i in range(60)]
    cpar = ClassifyParams(thresholds=[0.0])
    got = MeshClassifier(small, [torch.device("cuda", 0)] * 8, layout).classify(frags, cpar)
    assert got == Classifier(small, "cpu").classify(frags, cpar)


@pytest.mark.parametrize("kind", ["narrow", "wide", "lexicographic"])
def test_build_distributed_on_the_card(cuda, kind):
    """build_distributed over Mesh([cuda:0] * 8) against the same over
    [cpu] * 8 and the single-device build on the card: keys, taxa, sidecar."""
    from slacken_tpu_torch.index import KeyValueIndex
    from slacken_tpu_torch.parallel.classifier import build_distributed

    tax, genomes, params = _small_library(kind)
    batch = dict(batch_rows=16, row_len=1024)
    got = build_distributed(iter(genomes), params, tax, [torch.device("cuda", 0)] * 8, keep_records=True, **batch)
    on_cpu = build_distributed(iter(genomes), params, tax, ["cpu"] * 8, keep_records=True, **batch)
    single = KeyValueIndex.build(iter(genomes), params, tax, cuda, keep_records=True)
    assert got.keys_t.device.type == "cuda" and got.num_records > 1000
    for want in (on_cpu, single):
        for a, b in ((got.keys_t, want.keys_t), (got.taxa_t, want.taxa_t),
                     (got.record_keys_t, want.record_keys_t), (got.record_taxa_t, want.record_taxa_t)):
            assert torch.equal(a.cpu(), b.cpu())


@pytest.mark.parametrize("layout", ["replicated", "ring"])
def test_span_hits_over_the_mesh_on_the_card(cuda, layout, tmp_path):
    """Dynamic._span_hits with devices=Mesh([cuda:0] * 8) against the
    single-device run on the card."""
    from slacken_tpu_torch import dynamic
    from slacken_tpu_torch.classify import ClassifyParams, Fragment
    from slacken_tpu_torch.index import KeyValueIndex
    from slacken_tpu_torch.parallel.mesh import Mesh

    tax, genomes, params = _small_library("narrow")
    idx = KeyValueIndex.build(iter(genomes), params, tax, cuda)
    frags = [Fragment(f"r{i}", genomes[i % 3][1][i * 20 : i * 20 + 101]) for i in range(100)]
    hits = []
    for devices in (None, Mesh([torch.device("cuda", 0)] * 8)):
        dyn = dynamic.Dynamic(idx, None, 8, dynamic.MinimizerDistinctCount(5), ClassifyParams(), None,
                              str(tmp_path / "d"), cuda, devices=devices, layout=layout if devices else None)
        hits.append(dyn._span_hits(frags))
    assert len(hits[0][1]) > 100
    assert torch.equal(hits[0][0], hits[1][0]) and torch.equal(hits[0][1], hits[1][1])


def test_mesh_over_distinct_cards(cuda, tmp_path):
    """On a machine of two or more cards (skips on one): build_distributed,
    MeshClassifier replicated and ring, and two-step classification over
    make_mesh(every card), where every hop and every owner's slice is a copy
    between cards, against one card; and the CLI's --devices."""
    import gzip
    import os

    from slacken_tpu_torch import cli, dynamic, workloads
    from slacken_tpu_torch.classify import Classifier, ClassifyParams, Fragment
    from slacken_tpu_torch.index import KeyValueIndex
    from slacken_tpu_torch.parallel.classifier import MeshClassifier, build_distributed
    from slacken_tpu_torch.parallel.mesh import make_mesh

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA devices")
    mesh = make_mesh(n, "cuda")
    assert list(mesh) == [torch.device("cuda", i) for i in range(n)]
    tax, genomes, params = _small_library("narrow")
    batch = dict(batch_rows=16, row_len=1024)
    single = KeyValueIndex.build(iter(genomes), params, tax, cuda, keep_records=True, **batch)
    built = build_distributed(iter(genomes), params, tax, mesh, keep_records=True, **batch)
    for a, b in ((built.keys_t, single.keys_t), (built.taxa_t, single.taxa_t),
                 (built.record_keys_t, single.record_keys_t), (built.record_taxa_t, single.record_taxa_t)):
        assert torch.equal(a.cpu(), b.cpu())
    frags = [Fragment(f"r{i}", genomes[i % 6][1][i * 13 % 2800 : i * 13 % 2800 + 101]) for i in range(200)]
    cpar = ClassifyParams(thresholds=[0.0, 0.15])
    want = Classifier(single, cuda).classify(frags, cpar)
    assert sum(r.classified for r in want[0.0]) > 150
    for layout in ("replicated", "ring"):
        cls = MeshClassifier(built, mesh, layout)
        if layout == "ring":
            assert [s[0].device for s in cls._arrays] == list(mesh)
        assert cls.classify(frags, cpar) == want
    files = {}
    for where, devices in (("one", None), ("cards", mesh)):
        base = single.with_records(single.keys_t, single.taxa_t)  # no sidecar: build_distributed makes the dynamic index
        d = dynamic.Dynamic(base, workloads.GenomeList(genomes), 8, dynamic.MinimizerDistinctCount(5),
                            ClassifyParams(thresholds=[0.0]), None, str(tmp_path / where / "dyn"), cuda,
                            devices=devices, layout="ring" if devices else None)
        d.two_step_classify_and_write(frags)
        files[where] = sorted((os.path.relpath(os.path.join(r, f), tmp_path / where), open(os.path.join(r, f), "rb").read())
                              for r, _, fs in os.walk(tmp_path / where) for f in fs)
    assert files["cards"] == files["one"] and len(files["one"]) == 3
    workloads.write_library(genomes, str(tmp_path / "lib"))
    tax.save(str(tmp_path / "tax"))
    fastq = str(tmp_path / "r.fastq")
    with open(fastq, "w") as f:
        f.writelines(f"@{x.title}\n{x.seq}\n+\n{'I' * len(x.seq)}\n" for x in frags)
    lib = ["-l", str(tmp_path / "lib"), "-t", str(tmp_path / "tax")]
    assert cli.main(["build", "-i", str(tmp_path / "i1"), *lib]) == 0
    assert cli.main(["build", "-i", str(tmp_path / "iN"), *lib, "--devices", str(n), "--shards", str(n)]) == 0
    out = {}
    for tag, extra in (("one", ["-i", str(tmp_path / "i1")]),
                       ("ring", ["-i", str(tmp_path / "iN"), "--devices", str(n), "--layout", "ring"]),
                       ("replicated", ["-i", str(tmp_path / "iN"), "--devices", str(n)])):
        assert cli.main(["classify", fastq, "-o", str(tmp_path / f"c_{tag}" / "o"), *extra]) == 0
        out[tag] = {os.path.relpath(os.path.join(r, f), tmp_path / f"c_{tag}"): gzip.open(os.path.join(r, f)).read()
                    if f.endswith(".gz") else open(os.path.join(r, f), "rb").read()
                    for r, _, fs in os.walk(tmp_path / f"c_{tag}") for f in fs}
    assert out["ring"] == out["one"] == out["replicated"] and len(out["one"]) == 2
    with pytest.raises(ValueError, match="mesh"):
        make_mesh(n + 1, "cuda")


def _multihost_run(tmp_path, kind, world, **spec):
    """The small library's index in 8 shard files and 201 reads of it,
    classified (per-read mode, batches of 20 rows) by `world` spawned ranks
    (multihost_ranks.run_rank) and on one card; returns the ranks' reports
    after holding their files (part files joined in name order) to the
    single card's."""
    import gzip
    import os
    import socket

    import multihost_ranks
    from slacken_tpu_torch import native
    from slacken_tpu_torch.classify import Classifier, ClassifyParams
    from slacken_tpu_torch.index import KeyValueIndex

    tax, genomes, params = _small_library(kind)
    KeyValueIndex.build(iter(genomes), params, tax, "cpu").save_sharded(str(tmp_path / "idx8"), 8)
    seqs = [encode.encode_seq(genomes[i % 6][1][i * 13 % 2800 : i * 13 % 2800 + 101]) for i in range(201)]
    codes, lens = encode.pack_batch(seqs, 128)
    reads = [native.PackedReads(codes, lens, [f"r{i}" for i in range(201)])]
    cpar = ClassifyParams(thresholds=[0.0, 0.15])
    Classifier(KeyValueIndex.load(str(tmp_path / "idx8")), torch.device("cuda", 0)).classify_and_write_packed(
        reads, str(tmp_path / "one" / "o"), cpar)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        url = f"tcp://127.0.0.1:{s.getsockname()[1]}"
    seen = multihost_ranks.spawn(world, dict(spec, url=url, index=str(tmp_path / "idx8"),
                                             reads=multihost_ranks.chunks_of(reads), out=str(tmp_path / "mh" / "o"),
                                             thresholds=[0.0, 0.15], per_read=True, rows=20,
                                             report=str(tmp_path / "rank%d.json")))

    def files(loc):
        out = {}
        for root, _, names in os.walk(loc):
            for name in sorted(names):
                with (gzip.open if name.endswith(".gz") else open)(os.path.join(root, name), "rb") as f:
                    key = os.path.relpath(os.path.join(root, "part" if name.startswith("part-") else name), loc)
                    out[key] = out.get(key, b"") + f.read()
        return out

    want = files(tmp_path / "one")
    assert files(tmp_path / "mh") == want and len(want) == 4
    scan = "scan_wide" if kind == "wide" else "scan_lut" if kind == "lexicographic" else "scan"
    probe = {None: "probe_slots", "tiled": "probe_tiled", "hashed1": "probe_rows", "hashed": "probe_hashed"}[
        spec.get("mh_probe")]
    probe = "probe_wide" if kind == "wide" and probe == "probe_slots" else probe + ("_wide" if kind == "wide" else "")
    assert all(set(s["launched"]) == {scan, probe} for s in seen)
    return seen


@pytest.mark.parametrize("kind", ["narrow", "wide", "lexicographic"])
def test_multihost_world_of_one_under_nccl(cuda, tmp_path, kind):
    """One rank with a process group under NCCL, two ring entries on its
    card: the single card's files; no byte crosses between processes."""
    seen = _multihost_run(tmp_path, kind, 1, device="cuda", devices=2, backend=None)
    assert seen[0]["backend"] == "nccl" and seen[0]["mesh"] == ["cuda:0", "cuda:0"] and seen[0]["p2p"] == 0
    assert seen[0]["counts"] == [0, 1, 2, 3, 4] and seen[0]["gathered"] == [{"rank": 0}]


@pytest.mark.parametrize("kind", ["narrow", "wide", "lexicographic"])
def test_multihost_two_ranks_share_the_card_over_gloo(cuda, tmp_path, kind):
    """Two ranks on cuda:0, two ring entries each, gloo (each boundary hop
    through host memory): 6 batches of 20 rows a rank, one of them all
    padding for rank 0 (100 reads against 101)."""
    seen = _multihost_run(tmp_path, kind, 2, device="cuda:0", devices=2, backend="gloo")
    assert [s["backend"] for s in seen] == ["gloo"] * 2 and [s["padding"] for s in seen] == [1, 0]
    width = 2 if kind == "wide" else 1
    assert [s["p2p"] for s in seen] == [6 * (3 * 10 * 128 * (8 * width + 4) + 10 * 128 * 4)] * 2
    assert [s["counts"] for s in seen] == [[0, 3, 6, 9, 12]] * 2


@pytest.mark.parametrize("kind", ["narrow", "wide", "lexicographic"])
def test_multihost_world_of_one_with_the_hashed1_probe(cuda, tmp_path, kind):
    """One NCCL rank, two ring entries, mh_probe="hashed1": each entry's
    row-bucket table and its kernel; the single card's files."""
    seen = _multihost_run(tmp_path, kind, 1, device="cuda", devices=2, backend=None, mh_probe="hashed1")
    assert seen[0]["backend"] == "nccl" and seen[0]["p2p"] == 0


@pytest.mark.parametrize("kind", ["narrow", "lexicographic"])
def test_multihost_world_of_one_with_the_hashed_probe(cuda, tmp_path, kind):
    """One NCCL rank, two ring entries, mh_probe="hashed": each entry's
    hashed table and the probe_hashed kernel; the single card's files."""
    seen = _multihost_run(tmp_path, kind, 1, device="cuda", devices=2, backend=None, mh_probe="hashed")
    assert seen[0]["backend"] == "nccl" and seen[0]["p2p"] == 0


@pytest.mark.parametrize("probe", ["hashed", "hashed128", "bucketed"])
@pytest.mark.parametrize("kind", ["narrow", "lexicographic"])
def test_hashed_probe_choice_on_the_card(cuda, kind, probe):
    """Classifier(probe=) on the card == the routed probe on the card == the
    same probe on the CPU, per-read mode; MeshClassifier over
    Mesh([cuda:0] * 8), ring and replicated: hashed's table a shard, and for
    hashed128 and bucketed the routed probe (as the JAX package's mesh)."""
    from slacken_tpu_torch.classify import Classifier, ClassifyParams, Fragment
    from slacken_tpu_torch.index import KeyValueIndex
    from slacken_tpu_torch.parallel.classifier import MeshClassifier

    tax, genomes, params = _small_library(kind)
    idx = KeyValueIndex.build(iter(genomes), params, tax, cuda)
    frags = [Fragment(f"r{i}", genomes[i % 6][1][i * 20 : i * 20 + 101]) for i in range(100)]
    cpar = ClassifyParams(thresholds=[0.0, 0.15])
    want = Classifier(idx, cuda).classify(frags, cpar)
    assert sum(r.classified for r in want[0.0]) > 70
    name = {"hashed": "probe_hashed", "hashed128": "probe_hashed_cols", "bucketed": "probe_bucketed"}[probe]
    scan = "scan_lut" if kind == "lexicographic" else "scan"
    on_mesh = "probe_hashed" if probe == "hashed" else "probe_slots"
    for layout, probes in ((None, 1), ("ring", 64), ("replicated", 8)):
        before = dict(cuda_kernels.LAUNCHES)
        cls = (Classifier(idx, cuda, probe=probe) if layout is None
               else MeshClassifier(idx, [torch.device("cuda", 0)] * 8, layout, probe=probe))
        assert cls.classify(frags, cpar) == want
        assert _launched(before) == {scan: 1 if layout is None else 8, name if layout is None else on_mesh: probes}
    assert Classifier(idx.to("cpu"), "cpu", probe=probe).classify(frags, cpar) == want


@pytest.mark.parametrize("probe", ["tiled", "hashed1"])
@pytest.mark.parametrize("kind", ["narrow", "wide", "lexicographic"])
def test_probe_choice_on_the_card(cuda, kind, probe):
    """Classifier(probe=) on the card == the routed probe on the card == the
    same probe on the CPU, and MeshClassifier over Mesh([cuda:0] * 8) in the
    ring (a table a shard: 64 probes a batch) and replicated; per-read mode."""
    from slacken_tpu_torch.classify import Classifier, ClassifyParams, Fragment
    from slacken_tpu_torch.index import KeyValueIndex
    from slacken_tpu_torch.parallel.classifier import MeshClassifier

    tax, genomes, params = _small_library(kind)
    idx = KeyValueIndex.build(iter(genomes), params, tax, cuda)
    frags = [Fragment(f"r{i}", genomes[i % 6][1][i * 20 : i * 20 + 101]) for i in range(100)]
    cpar = ClassifyParams(thresholds=[0.0, 0.15])
    want = Classifier(idx, cuda).classify(frags, cpar)
    assert sum(r.classified for r in want[0.0]) > 70
    name = ("probe_tiled" if probe == "tiled" else "probe_rows") + ("_wide" if kind == "wide" else "")
    scan = "scan_wide" if kind == "wide" else "scan_lut" if kind == "lexicographic" else "scan"
    for layout, probes in ((None, 1), ("ring", 64), ("replicated", 8)):
        before = dict(cuda_kernels.LAUNCHES)
        cls = (Classifier(idx, cuda, probe=probe) if layout is None
               else MeshClassifier(idx, [torch.device("cuda", 0)] * 8, layout, probe=probe))
        assert cls.classify(frags, cpar) == want
        launched = {k: v - before[k] for k, v in cuda_kernels.LAUNCHES.items() if v != before[k]}
        assert launched == {scan: 1 if layout is None else 8, name: probes}
    assert Classifier(idx.to("cpu"), "cpu", probe=probe).classify(frags, cpar) == want


def test_nccl_refuses_two_ranks_on_one_card(cuda, tmp_path):
    """Why two ranks that share a card take gloo: NCCL refuses a group whose
    ranks are on one card when it connects (initialize passes device_id)."""
    import torch.multiprocessing as mp

    with pytest.raises(mp.ProcessRaisedException, match="Duplicate GPU detected"):
        _multihost_run(tmp_path, "narrow", 2, device="cuda:0", devices=1, backend=None)


def test_multihost_ranks_one_card_each(cuda, tmp_path):
    """On a machine of two or more cards (skips on one): min(4, cards)
    ranks under NCCL, one card each, the boundary hops between cards."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA devices")
    world = min(4, n)
    seen = _multihost_run(tmp_path, "narrow", world, device="cuda", devices=1, backend=None)
    assert [s["mesh"] for s in seen] == [[f"cuda:{r}"] for r in range(world)]
    assert all(s["backend"] == "nccl" and s["p2p"] > 0 for s in seen)


@pytest.mark.parametrize("keep", [False, True], ids=["index", "records"])
@pytest.mark.parametrize("kind", ["narrow", "wide", "lexicographic"])
def test_bounded_build_on_the_card(cuda, kind, keep, tmp_path):
    """KeyValueIndex.build on the card under a forced budget (leaves of
    2,000 records off the card, ranges of a few hundred) and with spill_dir,
    against the CPU build: keys, taxa and sidecar equal; the merge tree's
    counts the same on both; the spill directory gone; the default budget
    moves no leaf and leaves the index on the card."""
    from slacken_tpu_torch.index import HELD_BYTES, KeyValueIndex, default_device_budget

    tax, genomes, params = _small_library(kind)
    budget = 2000 * 8 * HELD_BYTES[params.m > 31]
    want = KeyValueIndex.build(iter(genomes), params, tax, "cpu", keep_records=keep, batch_rows=4, row_len=1024)
    assert default_device_budget(cuda) > 10 * (1 << 30) and default_device_budget("cpu") is None
    plain = KeyValueIndex.build(iter(genomes), params, tax, cuda, keep_records=keep, batch_rows=4, row_len=1024)
    assert plain.build_stats["leaves_off"] == 0 and plain.keys_t.device.type == "cuda"
    runs = {}
    for route in ("budget", "spill"):
        extra = {"spill_dir": str(tmp_path / "spill")} if route == "spill" else {}
        for d in ("cpu", cuda):
            runs[route, d] = KeyValueIndex.build(iter(genomes), params, tax, d, keep_records=keep, batch_rows=4,
                                                 row_len=1024, superbatch=300, device_budget=budget, **extra)
            assert not (tmp_path / "spill").exists()
        got, cpu = runs[route, cuda], runs[route, "cpu"]
        assert got.build_stats["leaves_off"] >= 2 and got.build_stats == cpu.build_stats
        for idx in (got, plain):
            for a, b in ((idx.keys_t, want.keys_t), (idx.taxa_t, want.taxa_t)):
                assert torch.equal(a.cpu(), b)
            if keep:
                assert torch.equal(idx.record_keys_t.cpu(), want.record_keys_t)
                assert torch.equal(idx.record_taxa_t.cpu(), want.record_taxa_t)


def test_build_distributed_with_spill_on_the_card(cuda, tmp_path):
    """build_distributed over Mesh([cuda:0] * 8) with spill_dir and a budget
    that sends each owner's leaves to its range files, against the CPU
    build."""
    from slacken_tpu_torch.index import KeyValueIndex
    from slacken_tpu_torch.parallel.classifier import build_distributed
    from slacken_tpu_torch.parallel.mesh import Mesh

    tax, genomes, params = _small_library("narrow")
    want = KeyValueIndex.build(iter(genomes), params, tax, "cpu", keep_records=True)
    got = build_distributed(iter(genomes), params, tax, Mesh([torch.device("cuda", 0)] * 8), keep_records=True,
                            spill_dir=str(tmp_path / "spill"), batch_rows=4, row_len=1024, superbatch=60,
                            device_budget=8 * 8 * 12 * 150)
    assert sum(s["leaves_off"] for s in got.build_stats) >= 8 and not (tmp_path / "spill").exists()
    for a, b in ((got.keys_t, want.keys_t), (got.taxa_t, want.taxa_t), (got.record_keys_t, want.record_keys_t),
                 (got.record_taxa_t, want.record_taxa_t)):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("keep", [False, True], ids=["index", "records"])
def test_build_distributed_over_distinct_cards(cuda, keep):
    """build_distributed over min(4, cards) distinct cards (skips on one):
    under the default budget the index gathers on cuda:0; under a budget
    that holds each owner's range on its card but not all of them on cuda:0
    it gathers on the host. Both equal the CPU build."""
    from slacken_tpu_torch.index import KeyValueIndex
    from slacken_tpu_torch.parallel.classifier import build_distributed
    from slacken_tpu_torch.parallel.mesh import Mesh

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA devices")
    mesh = Mesh([torch.device("cuda", i) for i in range(min(4, n))])
    tax, genomes, params = _small_library("narrow")
    want = KeyValueIndex.build(iter(genomes), params, tax, "cpu", keep_records=keep)
    cols = [want.keys_t, want.taxa_t] + ([want.record_keys_t, want.record_taxa_t] if keep else [])
    result = sum(x.numel() * x.element_size() for x in cols)
    for budget, home in ((None, "cuda:0"), (3 * result, "cpu")):
        got = build_distributed(iter(genomes), params, tax, mesh, keep_records=keep, device_budget=budget)
        assert str(got.keys_t.device) == home
        got_cols = [got.keys_t, got.taxa_t] + ([got.record_keys_t, got.record_taxa_t] if keep else [])
        for a, b in zip(got_cols, cols):
            assert torch.equal(a.cpu(), b)


#: the CPU cases' shapes, the bench batch, a 4 kbp bucket single-end and
#: paired, long buckets up to the widest row a reduction takes, and wide k
HIT_RUNS_SHAPES = [*hitruns_cases.SHAPES, (32768, 128, 35, False), (64, 4096, 35, False), (64, 4096, 35, True),
                   (8, 32768, 35, True), (3, 65528, 35, False), (256, 264, 120, True), (64, 128, 128, False)]


@pytest.mark.parametrize("i,rows,width,k,paired", [(i, *s) for i, s in enumerate(HIT_RUNS_SHAPES)])
def test_hit_runs_kernel_matches_twin(cuda, i, rows, width, k, paired):
    """hit_runs_cuda equals hit_runs_plain on the card (max_abs_err 0) at the
    default cap, at a cap below a tile and at one above it, in one launch
    each; no launch for zero rows."""
    from slacken_tpu_torch.ops import hitruns

    args = [torch.from_numpy(a).to(cuda) for a in workloads.hit_runs_rows(100 + i, rows, width, k, paired)]
    for cap in (hitruns.DEFAULT_RUNS_PER_ROW, 4, 48):
        before = cuda_kernels.LAUNCHES["hit_runs"]
        got = hitruns.hit_runs(*args, k, cap)
        assert cuda_kernels.LAUNCHES["hit_runs"] == before + 1
        want = hitruns.hit_runs_plain(*args, k, cap)
        torch.cuda.synchronize()
        assert got.shape == want.shape and int((got.long() - want.long()).abs().max()) == 0
        if cap == 4 and width >= 2 * k:
            assert int((got[:, -3] > cap).sum()) > 0
    empty = [a[:0] for a in args]
    before = cuda_kernels.LAUNCHES["hit_runs"]
    assert cuda_kernels.hit_runs_cuda(*empty, k, 16).shape == (0, 27)
    assert cuda_kernels.LAUNCHES["hit_runs"] == before


@pytest.mark.parametrize("width,k", hitruns_cases.EDGE_SHAPES)
def test_hit_runs_kernel_on_edge_rows(cuda, width, k):
    """hit_runs_cuda equals hit_runs_plain (max_abs_err 0) on the rows made
    by hand at the edges of its chunks and lanes (runs, an all-N stretch and a
    gap across a chunk or lane border, mate borders at neighbouring places of
    a lane and at the border, a tail chunk), at caps 16, 4 and 48, one launch
    each."""
    from slacken_tpu_torch.ops import hitruns

    args = [torch.from_numpy(a).to(cuda) for a in hitruns_cases.edge_rows(width, k)]
    for cap in (hitruns.DEFAULT_RUNS_PER_ROW, 4, 48):
        before = cuda_kernels.LAUNCHES["hit_runs"]
        got = hitruns.hit_runs(*args, k, cap)
        assert cuda_kernels.LAUNCHES["hit_runs"] == before + 1
        want = hitruns.hit_runs_plain(*args, k, cap)
        torch.cuda.synchronize()
        assert got.shape == want.shape and int((got.long() - want.long()).abs().max()) == 0


def test_hit_runs_refuses_misaligned_window_taxa(cuda):
    """The kernel reads 16 bytes a lane: window taxa at a storage offset of
    one int32 raise ValueError, and nothing launches."""
    wt, valid, splits, lens = (torch.from_numpy(a).to(cuda) for a in workloads.hit_runs_rows(8, 16, 128, 35))
    shifted = torch.empty(wt.numel() + 1, dtype=torch.int32, device=cuda)[1:].view(wt.shape)
    shifted.copy_(wt)
    assert shifted.is_contiguous() and shifted.storage_offset() == 1
    before = cuda_kernels.LAUNCHES["hit_runs"]
    with pytest.raises(ValueError, match="16-byte aligned"):
        cuda_kernels.hit_runs_cuda(shifted, valid, splits, lens, 35, 16)
    assert cuda_kernels.LAUNCHES["hit_runs"] == before


@pytest.mark.parametrize("on", [False, True], ids=["dense", "hit runs"])
def test_per_read_hit_runs_on_the_card(cuda, on, tmp_path, monkeypatch):
    """Per-read files on the card, dense and under STPU_HIT_RUNS=1, equal the
    CPU's dense files; hit runs launch their kernel and never its twin, the
    dense run never launches it."""
    from slacken_tpu_torch import native
    from slacken_tpu_torch.classify import Classifier, ClassifyParams
    from slacken_tpu_torch.index import KeyValueIndex
    from slacken_tpu_torch.ops import hitruns

    tax, genomes, params = _small_library("narrow")
    rng = np.random.default_rng(3)
    letters = np.frombuffer(b"ACGTN", np.uint8)
    reads = []
    for i in range(300):
        _, g = genomes[i % 6]
        s = int(rng.integers(0, len(g) - 150))
        codes = encode.encode_seq(g[s : s + 150]).copy()
        if i % 3 == 0:
            for a in rng.integers(0, 150, 3):
                codes[a : a + int(rng.integers(1, 45))] = encode.INVALID
        reads.append(letters[codes].tobytes())
    codes, lens = encode.pack_batch(reads, 256)
    stream = [native.PackedReads(codes, lens, [f"r{i}" for i in range(len(reads))])]
    cpar = ClassifyParams(thresholds=[0.0, 0.15], per_read_output=True)

    def files(device, prefix):
        idx = KeyValueIndex.build(iter(genomes), params, tax, device)
        Classifier(idx, device, max_taxa_per_read=4).classify_and_write_packed(stream, str(tmp_path / prefix), cpar)
        out = {}
        for root, _, names in os.walk(tmp_path):
            for n in names:
                path = os.path.join(root, n)
                if path.startswith(str(tmp_path / prefix) + "_c"):
                    with (gzip.open if n.endswith(".gz") else open)(path, "rb") as f:
                        out[os.path.relpath(path, tmp_path)[len(prefix):]] = f.read()
        return out

    monkeypatch.setenv("STPU_HIT_RUNS", "0")
    want = files("cpu", "cpu")
    monkeypatch.setenv("STPU_HIT_RUNS", "1" if on else "0")
    monkeypatch.setattr(hitruns, "hit_runs_plain", None)  # the card never runs the twin
    before = cuda_kernels.LAUNCHES["hit_runs"]
    got = files(cuda, "card")
    assert got == want and len(got) == 4
    assert (cuda_kernels.LAUNCHES["hit_runs"] > before) == on


FUZZ_KERNELS = {("routed", False): "probe_slots", ("tiled", False): "probe_tiled", ("hashed1", False): "probe_rows",
                ("hashed", False): "probe_hashed", ("hashed128", False): "probe_hashed_cols",
                ("bucketed", False): "probe_bucketed", ("routed", True): "probe_wide",
                ("tiled", True): "probe_tiled_wide", ("hashed1", True): "probe_rows_wide"}


@pytest.mark.parametrize("probe,wide", list(FUZZ_KERNELS), ids=[f"{p}-{'wide' if w else 'narrow'}"
                                                                for p, w in FUZZ_KERNELS])
def test_fuzz_on_the_card(cuda, probe, wide, tmp_path):
    """Two oracle fuzz iterations (slacken_tpu_torch/fuzz.py) under the
    probe choice on the card: every read equal to the oracle through
    classify, classify_packed and the written files, dense and under hit
    runs, through the choice's scan, probe and hit-runs kernels."""
    from slacken_tpu_torch import fuzz

    cuda_kernels.reset_launch_counts()
    for seed in (3, 17):
        r = fuzz.fuzz_iteration(seed, seed, cuda, probe, wide, out=str(tmp_path))
        assert r["probe"] == probe and (r["m"] > 31) == wide and r["checks"] > 0
    for name in ("scan_wide" if wide else "scan", FUZZ_KERNELS[probe, wide], "hit_runs"):
        assert cuda_kernels.LAUNCHES[name] > 0, name
