"""The port's recorder of spans and counters (slacken_tpu_torch.utils): its
nesting, threads, request ids and clock; the spans and counts of the
classify path in reports and per-read mode, checked against the arrays a
batch moves; the benchmark's readers of them; the build's phases on it; and
the prefetch thread's stop on close. The test marked `gpu` skips without a
card; run it there with

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_tracing.py
"""

import gzip
import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from slacken_tpu_torch import classify as classify_mod
from slacken_tpu_torch import utils, workloads
from slacken_tpu_torch.classify import Classifier, ClassifyParams
from slacken_tpu_torch.index import IndexParams, KeyValueIndex
from slacken_tpu_torch.inputs import packed_pairs_from_files
from slacken_tpu_torch.ops import encode
from slacken_tpu_torch.taxonomy import Taxonomy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.pbcore import manifest  # noqa: E402

torch.set_num_threads(1)

THRESHOLDS = (0.0, 0.3)
#: the readers of the program's spans and counters (portbench/layer_metrics)
READERS = ("parse_busy_pct.reads", "input_wait_pct.reads", "dispatch_busy_pct.reads", "device_wait_pct.reads",
           "output_busy_pct.reads", "padded_rows_pct.reads", "h2d_bytes_per_read.reads",
           "d2h_bytes_per_read.reads", "host_resolved_rows_pct.reads", "index_bytes_per_record.reads")
#: the counters that the readers read
COUNTERS = {"reads", "rows", "padded_rows", "h2d_bytes", "d2h_bytes", "host_resolved_rows", "index_bytes",
            "index_records"}
#: the main thread's spans directly under a classify.request
REQUEST_CHILDREN = {"input.wait", "batch.assemble", "dispatch", "harvest", "output.finalize", "output.count",
                    "lines.emit", "lines.write", "lines.close", "reports.write"}


class _Reading:
    def __init__(self, window_s):
        self.window_s = window_s


# -- the recorder --------------------------------------------------------------


def test_nesting_self_time_and_counts():
    utils.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with utils.span("outer") as outer:
            utils.count("n", 2)
            with utils.span("inner") as inner:
                time.sleep(0.02)
                utils.count("n", 3)
            time.sleep(0.01)
            utils.count("n", 1)
    got = {s.name: s for s in utils.spans()}
    assert set(got) == {"outer", "inner"} and got["outer"] is outer and got["inner"] is inner
    assert inner.parent == outer.id and outer.parent is None
    assert outer.counts == {"n": 3} and inner.counts == {"n": 3}
    assert inner.start_ns >= outer.start_ns and inner.end_ns <= outer.end_ns
    assert outer.child_ns == inner.end_ns - inner.start_ns
    assert outer.self_seconds == pytest.approx(outer.seconds - inner.seconds, abs=1e-9)
    assert outer.self_seconds >= 0.009 and inner.self_seconds == inner.seconds >= 0.019


def test_each_thread_has_its_own_stack():
    utils.reset()
    barrier = threading.Barrier(4)

    def work(name):
        with utils.span(name):
            barrier.wait(timeout=10)  # every thread's outer span is open at once
            with utils.span(name + ".child"):
                utils.count("k", 1)
                barrier.wait(timeout=10)

    with profile(activities=[ProfilerActivity.CPU]):
        threads = [threading.Thread(target=work, args=(f"t{i}",)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
            assert not t.is_alive()
    spans = {s.name: s for s in utils.spans()}
    assert len(spans) == 8
    for i in range(4):
        outer, child = spans[f"t{i}"], spans[f"t{i}.child"]
        assert child.parent == outer.id and outer.parent is None
        assert child.thread == outer.thread and child.counts == {"k": 1} and outer.counts == {}
    assert len({spans[f"t{i}"].thread for i in range(4)}) == 4


def test_nothing_is_recorded_outside_a_profiler():
    utils.reset()
    assert not autograd_profiler._is_profiler_enabled
    with utils.span("classify.request", request=True) as s:
        utils.count("reads", 5)
        assert s is None
    assert utils.spans() == [] and utils.chrome_events() == []


def test_the_profiler_flag_reads_true_in_every_thread():
    seen = []
    with profile(activities=[ProfilerActivity.CPU]):
        t = threading.Thread(target=lambda: seen.append(autograd_profiler._is_profiler_enabled))
        t.start()
        t.join(timeout=10)
        seen.append(autograd_profiler._is_profiler_enabled)
    assert seen == [True, True] and not autograd_profiler._is_profiler_enabled


def test_the_request_id_reaches_the_prefetch_thread():
    utils.reset()

    def chunks():
        for i in range(5):
            with utils.span("input.parse"):
                utils.count("reads", i)
            yield i

    with profile(activities=[ProfilerActivity.CPU]):
        with utils.span("classify.request", request=True) as req:
            assert list(utils.prefetch_iterator(chunks(), depth=2)) == list(range(5))
        with utils.span("classify.request", request=True) as req2:
            pass
    spans = utils.spans()
    parse = [s for s in spans if s.name == "input.parse"]
    waits = [s for s in spans if s.name == "input.wait"]
    assert len(parse) == 5 and len(waits) == 6  # the last wait takes the end of the stream
    assert {s.request for s in parse + waits} == {req.request}
    assert req.request is not None and req2.request != req.request
    assert {s.thread for s in parse} != {req.thread} and {s.thread for s in waits} == {req.thread}
    assert all(s.parent is None for s in parse) and all(s.parent == req.id for s in waits)
    assert sum(s.counts["reads"] for s in parse) == 10


def test_chrome_events_are_on_the_profilers_clock(tmp_path):
    """Each span lies inside its own record_function event on the exported
    trace's clock (ts plus baseTimeNanoseconds / 1000), within 1 ms, and
    the closest start of five lies within 1 ms of its event's: an error in
    the clocks' offset would move every start alike, a stall of the thread
    only some."""
    utils.reset()
    names = [f"span{i}" for i in range(5)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for name in names:
            with utils.span(name):
                time.sleep(0.005)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    base_us = trace.get("baseTimeNanoseconds", 0) / 1000
    mine = {e["name"]: e for e in utils.chrome_events()}
    assert set(mine) == set(names)
    starts = []
    for name, e in mine.items():
        assert e["ph"] == "X" and e["tid"] == threading.get_native_id() and e["args"]["parent"] is None
        theirs = [x for x in trace["traceEvents"] if x.get("name") == name and x.get("ph") == "X"]
        assert len(theirs) == 1
        ts, dur = float(theirs[0]["ts"]) + base_us, float(theirs[0]["dur"])
        assert ts <= e["ts"] + 1000 and e["ts"] + e["dur"] <= ts + dur + 1000
        starts.append(abs(e["ts"] - ts))
    assert min(starts) < 1000


def test_phase_timers_run_on_the_recorder():
    utils.reset()
    pt = utils.PhaseTimers(True)
    with pt.phase("outer"):
        time.sleep(0.01)
        with pt.phase("inner"):
            time.sleep(0.02)
    with pt.phase("inner"):
        time.sleep(0.005)
    assert list(pt.timed("items", iter(range(3)))) == [0, 1, 2]
    spans = utils.spans()
    assert [s.name for s in spans] == ["inner", "outer", "inner", "items", "items", "items", "items"]
    assert pt.seconds["outer"] == pytest.approx(spans[1].self_seconds)
    assert pt.seconds["inner"] == pytest.approx(spans[0].seconds + spans[2].seconds)
    assert 0.009 <= pt.seconds["outer"] < spans[1].seconds
    assert not hasattr(pt, "_inner")
    off = utils.PhaseTimers()
    with off.phase("quiet"):
        pass
    assert off.seconds == {} and len(utils.spans()) == 7


def test_build_phases_still_add_up(tmp_path):
    tax, lib = _deployment()
    t0 = time.perf_counter()
    idx = KeyValueIndex.build(iter(lib), IndexParams(), tax, "cpu", batch_rows=8, row_len=4096, trace=True)
    wall = time.perf_counter() - t0
    phases = idx.build_phases
    assert {"fragment source", "packing", "scan dispatch", "leaf reduce"} <= set(phases)
    assert all(v >= 0 for v in phases.values())
    assert sum(phases.values()) <= wall


def test_prefetch_thread_stops_when_closed():
    produced = []

    def endless():
        i = 0
        while True:
            produced.append(i)
            yield i
            i += 1

    before = set(threading.enumerate())
    it = utils.prefetch_iterator(endless(), depth=2)
    assert next(it) == 0
    worker = [t for t in threading.enumerate() if t not in before and t.name == "stpu-prefetch"]
    assert len(worker) == 1
    time.sleep(0.2)  # the worker fills the queue and blocks on it
    t0 = time.perf_counter()
    it.close()
    worker[0].join(timeout=1.0)
    assert not worker[0].is_alive() and time.perf_counter() - t0 < 1.0
    assert len(produced) <= 2 + 3  # the queue's depth, the item taken, the one in hand


# -- the classify path -----------------------------------------------------------


def _deployment():
    """A two-genus taxonomy of six species and their genomes: each genus's
    species differ from its genome by 2% of bases, so reads hit several
    taxa and chimeric pairs overflow a small max_taxa."""
    nodes = [(1, 1, "no rank"), (2, 1, "genus"), (3, 1, "genus")]
    nodes += [(10 + i, 2 + i // 3, "species") for i in range(6)]
    tax = Taxonomy.from_nodes_and_names(nodes, [(t, f"taxon{t}") for t, _, _ in nodes])
    rng = np.random.default_rng(11)
    lib = []
    for g in range(2):
        base = rng.integers(0, 4, 12_000)
        for i in range(3):
            seq = base.copy()
            mut = rng.random(len(seq)) < 0.02
            seq[mut] = rng.integers(0, 4, int(mut.sum()))
            lib.append((10 + 3 * g + i, "".join("ACGT"[c] for c in seq)))
    return tax, lib


def _pairs(lib, n, seed=3):
    """(title, mate 1, mate 2): 2x100 bp from one genome, every 7th pair's
    mates from two genomes, every 5th with an N run in its first mate."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        a = lib[i % len(lib)][1]
        b = lib[(i + 2) % len(lib)][1] if i % 7 == 0 else a
        s1, s2 = int(rng.integers(0, len(a) - 100)), int(rng.integers(0, len(b) - 100))
        m1, m2 = list(a[s1 : s1 + 100]), b[s2 : s2 + 100]
        if i % 5 == 0:
            p = int(rng.integers(0, 60))
            m1[p : p + 40] = "N" * 40
        out.append((f"r{i}", "".join(m1), m2))
    return out


@pytest.fixture(scope="module")
def deployment(tmp_path_factory):
    tax, lib = _deployment()
    idx = KeyValueIndex.build(iter(lib), IndexParams(), tax, "cpu", batch_rows=8, row_len=4096)
    d = tmp_path_factory.mktemp("reads")
    files = (str(d / "r_1.fq"), str(d / "r_2.fq"))
    workloads.write_paired_fastq(_pairs(lib, 700), *files)
    return idx, files


def _outputs(prefix):
    """{path below <prefix>_c*: bytes}, .gz files inflated."""
    base, stem = os.path.dirname(prefix), os.path.basename(prefix)
    out = {}
    for top in sorted(x for x in os.listdir(base) if x.startswith(stem + "_c")):
        for root, _, names in os.walk(os.path.join(base, top)):
            for name in names:
                path = os.path.join(root, name)
                with (gzip.open if name.endswith(".gz") else open)(path, "rb") as f:
                    out[os.path.relpath(path, base)[len(stem):]] = f.read()
    return out


def _classify(idx, files, device, out, per_read, traced, spy=None):
    """One request of classify_and_write_packed in batches of 64 rows,
    under the profiler when `traced`; `spy` wraps the classifier's copies
    to the device and its 2-bit packing."""
    cls = Classifier(idx, device, max_taxa_per_read=2)
    cls.target_batch_bp = 64 * 201
    cpar = ClassifyParams(thresholds=THRESHOLDS, per_read_output=per_read)
    stream = packed_pairs_from_files(*files, chunk_bytes=20_000)
    if not traced:
        return cls.classify_and_write_packed(stream, out, cpar)
    with profile(activities=[ProfilerActivity.CPU]):
        return cls.classify_and_write_packed(stream, out, cpar)


class _Spy:
    """Bytes handed to the device and the rows of every packed batch."""

    def __init__(self, monkeypatch):
        self.h2d, self.rows = 0, []
        to_device, pack = classify_mod.to_device, encode.pack_2bit

        def spy_to_device(a, device):
            self.h2d += a.nbytes
            return to_device(a, device)

        def spy_pack(codes):
            self.rows.append(codes.shape)
            return pack(codes)

        monkeypatch.setattr(classify_mod, "to_device", spy_to_device)
        monkeypatch.setattr(encode, "pack_2bit", spy_pack)


def _check_tree(spans, per_read, n_reads):
    """The span tree of one request; returns {name: [spans]}."""
    by = {}
    for s in spans:
        by.setdefault(s.name, []).append(s)
    (req,) = by["classify.request"]
    ids = {s.id: s for s in spans}
    main = req.thread
    assert {s.request for s in spans} == {req.request} and req.request is not None
    want = {"classify.request", "input.parse", "input.pair", "input.wait", "batch.assemble", "dispatch",
            "dispatch.pad", "dispatch.ambig", "dispatch.pack", "dispatch.launch", "harvest", "harvest.wait",
            "output.finalize", "output.count", "lines.close", "reports.write"}
    # per-read mode copies every row's window taxa; reports mode fetches the rows over max_taxa
    want |= {"lines.emit", "lines.write"} if per_read else {"harvest.overflow"}
    assert set(by) == want
    for s in by["input.parse"] + by["input.pair"]:
        assert s.thread != main and s.parent is None
    for s in spans:
        if s.thread == main and s is not req:
            assert s.parent is not None and ids[s.parent].thread == main
            assert s.start_ns >= ids[s.parent].start_ns and s.end_ns <= ids[s.parent].end_ns
    assert {s.name for s in spans if s.parent == req.id} == REQUEST_CHILDREN - (
        set() if per_read else {"lines.emit", "lines.write"})
    for name in ("dispatch.pad", "dispatch.ambig", "dispatch.pack", "dispatch.launch"):
        assert [ids[s.parent].name for s in by[name]] == ["dispatch"] * len(by["dispatch"])
    for name in ("harvest.wait", "harvest.overflow"):
        assert {ids[s.parent].name for s in by.get(name, [])} <= {"harvest"}
    assert len(by["harvest"]) == len(by["dispatch"]) == len(by["harvest.wait"])
    for d, h in zip(sorted(by["dispatch"], key=lambda s: s.start_ns), sorted(by["harvest"], key=lambda s: s.start_ns)):
        assert d.end_ns <= h.start_ns  # each batch is harvested after its dispatch
    assert req.counts == {"reads": n_reads}
    assert len(by["output.finalize"]) == len(THRESHOLDS) * len(by["dispatch"])
    # each counter is one that a reader of portbench/layer_metrics reads
    assert {c for s in spans for c in s.counts} <= COUNTERS
    return by


@pytest.mark.parametrize("per_read", [False, True], ids=["reports", "per_read"])
def test_classify_records_its_spans_and_counts(deployment, tmp_path, monkeypatch, per_read):
    idx, files = deployment
    utils.reset()
    plain = str(tmp_path / "plain" / "out")
    _classify(idx, files, "cpu", plain, per_read, traced=False)
    assert utils.spans() == []
    spy = _Spy(monkeypatch)
    traced = str(tmp_path / "traced" / "out")
    _classify(idx, files, "cpu", traced, per_read, traced=True)
    assert _outputs(traced) == _outputs(plain) and len(_outputs(plain)) == (4 if per_read else 2)
    by = _check_tree(utils.spans(), per_read, 700)
    disp = sorted(by["dispatch"], key=lambda s: s.start_ns)
    assert [s.counts["rows"] for s in disp] == [r for r, _ in spy.rows]
    assert sum(s.counts["padded_rows"] for s in disp) == sum(r for r, _ in spy.rows) - 700
    assert sum(s.counts.get("h2d_bytes", 0) for s in utils.spans()) == spy.h2d
    nthr = len(THRESHOLDS)
    bundles = sum(r * (3 + nthr) * 4 for r, _ in spy.rows)
    overflow, rest = divmod(sum(s.counts.get("host_resolved_rows", 0) for s in by["output.finalize"]), nthr)
    assert overflow > 0 and rest == 0  # each row over max_taxa resolved on the host at every threshold
    width = spy.rows[0][1]
    window_taxa = 700 * width * 4 if per_read else overflow * width * 4  # dense rows, or the overflow fetch
    assert sum(s.counts.get("d2h_bytes", 0) for s in utils.spans()) == bundles + window_taxa


def test_the_readers_read_the_recorder(deployment, tmp_path):
    idx, files = deployment
    utils.reset()
    readers = {name: manifest.reader(name) for name in READERS}
    context = {"reading": _Reading(100.0), "thresholds": len(THRESHOLDS), "traced": [0]}
    assert all(read(context) is None for read in readers.values())
    t0 = time.perf_counter()
    _classify(idx, files, "cpu", str(tmp_path / "out"), True, traced=True)
    context["reading"] = _Reading(time.perf_counter() - t0)
    got = {name: read(context) for name, read in readers.items()}
    assert all(isinstance(v, float) for v in got.values()), got
    for name in READERS:
        if name.endswith("_pct.reads"):
            assert 0 <= got[name] <= 100, (name, got[name])
    spans = utils.spans()
    disp = [s for s in spans if s.name == "dispatch"]
    rows = sum(s.counts["rows"] for s in disp)
    assert got["padded_rows_pct.reads"] == 100.0 * (rows - 700) / rows
    assert got["h2d_bytes_per_read.reads"] == sum(s.counts.get("h2d_bytes", 0) for s in utils.spans()) / 700
    assert got["d2h_bytes_per_read.reads"] == sum(s.counts.get("d2h_bytes", 0) for s in spans) / 700
    assert got["host_resolved_rows_pct.reads"] > 0
    # on the CPU the routed probe reads the keys (8 bytes), taxa (4) and directory
    keys, taxa, directory = idx.device_arrays("cpu")
    assert got["index_bytes_per_record.reads"] == (
        keys.numel() * 8 + taxa.numel() * 4 + directory.starts.numel() * 4) / idx.num_records
    assert [s.counts["index_records"] for s in disp] == [idx.num_records] * len(disp)
    assert got["dispatch_busy_pct.reads"] == pytest.approx(
        100.0 * sum(s.seconds for s in disp) / context["reading"].window_s)
    main = [s for s in spans if s.name == "classify.request"][0]
    covered = sum(s.seconds for s in spans if s.parent == main.id)
    assert covered <= main.seconds
    utils.reset()
    assert all(read(context) is None for read in readers.values())


def test_the_readers_keep_the_traced_requests():
    """Spans of earlier requests in the process (an earlier traced run)
    are left out: the readers take the last len(traced) request ids."""
    utils.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        for reads, rows in ((100, 128), (50, 64), (10, 16)):
            with utils.span("classify.request", request=True):
                utils.count("reads", reads)
                with utils.span("dispatch"):
                    utils.count("rows", rows)
                    utils.count("padded_rows", rows - reads)
                    utils.count("h2d_bytes", 3 * rows)
    with utils.span("dispatch", record=True):  # outside any request: never read
        pass
    reqs = [s for s in utils.spans() if s.name == "classify.request"]
    disp = [s for s in utils.spans() if s.name == "dispatch" and s.request is not None]
    h2d, padded, busy = (manifest.reader(n) for n in ("h2d_bytes_per_read.reads", "padded_rows_pct.reads",
                                                     "dispatch_busy_pct.reads"))
    one = {"reading": _Reading(1.0), "traced": [7]}
    two = {"reading": _Reading(1.0), "traced": [6, 7]}
    assert h2d(one) == 3 * 16 / 10 and h2d(two) == 3 * (64 + 16) / 60
    assert padded(one) == 100.0 * 6 / 16 and padded(two) == 100.0 * (14 + 6) / (64 + 16)
    assert busy(one) == pytest.approx(100.0 * disp[-1].seconds)
    assert busy(two) == pytest.approx(100.0 * (disp[-2].seconds + disp[-1].seconds))
    assert [s.request for s in reqs] == sorted(s.request for s in reqs)
    assert h2d({"reading": _Reading(1.0), "traced": []}) is None
    utils.reset()


def test_the_index_reader_reads_the_dispatch_counts():
    """index_bytes_per_record.reads: total index_bytes over total
    index_records of the traced requests' dispatch spans; None where the
    dispatch spans do not count them (a program without the counters)."""
    read = manifest.reader("index_bytes_per_record.reads")
    utils.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with utils.span("classify.request", request=True):
            with utils.span("dispatch"):
                utils.count("rows", 16)
    assert read({"reading": _Reading(1.0), "traced": [0]}) is None
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            with utils.span("classify.request", request=True):
                for _ in range(3):
                    with utils.span("dispatch"):
                        utils.count("index_bytes", 9 * 1000 + 1024)
                        utils.count("index_records", 1000)
    assert read({"reading": _Reading(1.0), "traced": [0, 1]}) == (9 * 1000 + 1024) / 1000
    assert read({"reading": _Reading(1.0), "traced": []}) is None
    utils.reset()


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("per_read", [False, True], ids=["reports", "per_read"])
def test_classify_spans_on_the_card(cuda, deployment, tmp_path, monkeypatch, per_read):
    """The same span tree and counters on the card, and each batch's
    harvest.wait ending no earlier than its device chain: the host interval
    from the launch's start to the wait's end covers the CUDA-event time
    from before the batch's kernels to its done event."""
    idx, files = deployment
    plain = str(tmp_path / "plain" / "out")
    _classify(idx, files, cuda, plain, per_read, traced=False)
    utils.reset()
    spy = _Spy(monkeypatch)
    starts, dones = [], []
    event = torch.cuda.Event
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: event(enable_timing=True))
    classify_rows, harvest = Classifier._classify_packed_rows, Classifier._harvest

    def timed_rows(self, *a, **k):
        starts.append(event(enable_timing=True))
        starts[-1].record()
        return classify_rows(self, *a, **k)

    def timed_harvest(self, dispatched):
        dones.append(dispatched[2])
        return harvest(self, dispatched)

    monkeypatch.setattr(Classifier, "_classify_packed_rows", timed_rows)
    monkeypatch.setattr(Classifier, "_harvest", timed_harvest)
    traced = str(tmp_path / "traced" / "out")
    _classify(idx, files, cuda, traced, per_read, traced=True)
    assert _outputs(traced) == _outputs(plain)
    by = _check_tree(utils.spans(), per_read, 700)
    disp = sorted(by["dispatch"], key=lambda s: s.start_ns)
    assert [s.counts["rows"] for s in disp] == [r for r, _ in spy.rows]
    assert sum(s.counts.get("h2d_bytes", 0) for s in utils.spans()) == spy.h2d
    launches = sorted(by["dispatch.launch"], key=lambda s: s.start_ns)
    waits = sorted(by["harvest.wait"], key=lambda s: s.start_ns)
    assert len(starts) == len(dones) == len(launches) == len(waits)
    for start, done, launch, wait in zip(starts, dones, launches, waits):
        device_ns = start.elapsed_time(done) * 1e6
        assert wait.end_ns - launch.start_ns >= device_ns - 1e4
