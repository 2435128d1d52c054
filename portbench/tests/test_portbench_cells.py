"""Every cell at a test's size on the CPU: the port agrees with the plain
reference, the control (the reference with keys cut to their top bits in
the program's place) does not, and a run with the timed path broken
underneath comes out not correct, for each fault the cell can have."""

import os

import numpy as np
import pytest

from portbench import control
from portbench.pbcore import harness
from portbench.tests.conftest import ALL_CELLS, run_tiny


@pytest.mark.parametrize("cell", ALL_CELLS)
def test_port_agrees_with_the_reference(cell):
    r = run_tiny(cell)
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert all(c["value"] == 0 and c["limit"] == 0 for c in r["checks"].values())
    assert list(r)[-1] == "checks"
    assert r["device"]["platform"] == "cpu" and r["device"]["memory_peak_bytes"] == 0


@pytest.mark.parametrize("cell", ALL_CELLS)
def test_the_control_is_not_correct(cell):
    r = run_tiny(cell, seed=99, control=control.DROP_BITS)
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


def _halve_pairs(monkeypatch):
    """Half of each batch of read pairs left out where the reader packs it."""
    from slacken_tpu_torch import inputs, native

    pack = native.pack_pairs

    def half(p1, p2):
        out = pack(p1, p2)
        n = len(out) // 2
        return native.PackedReads(out.codes[:n], out.lengths[:n], out.titles[:n], splits=out.splits[:n])

    monkeypatch.setattr(inputs.native, "pack_pairs", half)


def _alter_taxon(monkeypatch):
    """One read's taxon altered where the classifier produces it."""
    from slacken_tpu_torch.classify import Classifier

    orig = Classifier._finalize_taxa

    def altered(self, batch, threshold, cpar):
        taxon, classified = orig(self, batch, threshold, cpar)
        taxon = taxon.copy()
        taxon[0] = 1 if taxon[0] != 1 else 2000
        classified = classified.copy()
        classified[0] = True
        return taxon, classified

    monkeypatch.setattr(Classifier, "_finalize_taxa", altered)


def _no_output(monkeypatch):
    """A request that returns without doing its work."""
    from slacken_tpu_torch.classify import Classifier

    monkeypatch.setattr(Classifier, "classify_and_write_packed", lambda self, it, out, cpar: {})


def _halve_rows(monkeypatch):
    """Half of each build batch's rows left out."""
    from slacken_tpu_torch import index

    orig = index._batches

    def half(*a, **k):
        for codes, taxa, n in orig(*a, **k):
            codes = codes.copy()
            codes[n // 2 : n] = 4
            yield codes, taxa, n

    monkeypatch.setattr(index, "_batches", half)


def _alter_record(monkeypatch):
    """One record's taxon altered where the build produces it."""
    from slacken_tpu_torch.index import KeyValueIndex

    orig = KeyValueIndex.build.__func__

    def altered(cls, *a, **k):
        idx = orig(cls, *a, **k)
        idx.taxa_t = idx.taxa_t.clone()
        idx.taxa_t[len(idx.taxa_t) // 2] = 1 if int(idx.taxa_t[len(idx.taxa_t) // 2]) != 1 else 10
        return idx

    monkeypatch.setattr(KeyValueIndex, "build", classmethod(altered))


def _stale_build(monkeypatch):
    """A build that hands back the same index as its first, whatever it is
    given: its state unchanged."""
    from slacken_tpu_torch.index import KeyValueIndex

    orig = KeyValueIndex.build.__func__
    first = []

    def stale(cls, fragments, *a, **k):
        if not first:
            first.append(orig(cls, list(fragments)[:1], *a, **k))
        return first[0]

    monkeypatch.setattr(KeyValueIndex, "build", classmethod(stale))


def _halve_fragments(monkeypatch):
    """Half of each batch of Bracken fragments left out."""
    from slacken_tpu_torch.bracken import BrackenWeights

    orig = BrackenWeights._dest_counts

    def half(self, scan, lengths):
        out = orig(self, scan, lengths)
        return [d if i % 2 == 0 else {} for i, d in enumerate(out)]

    monkeypatch.setattr(BrackenWeights, "_dest_counts", half)


def _alter_count(monkeypatch):
    """One (destination, source) count altered where it is produced."""
    from slacken_tpu_torch.bracken import BrackenWeights

    orig = BrackenWeights.build_weights

    def altered(self, library, taxa):
        out = dict(orig(self, library, taxa))
        key = sorted(out)[0]
        out[key] += 1
        return out

    monkeypatch.setattr(BrackenWeights, "build_weights", altered)


def _no_weights(monkeypatch):
    from slacken_tpu_torch.bracken import BrackenWeights

    monkeypatch.setattr(BrackenWeights, "build_weights", lambda self, library, taxa: {})


FAULTS = {
    "marine.reports": [_halve_pairs, _alter_taxon, _no_output],
    "strain.per_read": [_halve_pairs, _alter_taxon, _no_output],
    "marine.build": [_halve_rows, _alter_record, _stale_build],
    "strain.bracken": [_halve_fragments, _alter_count, _no_weights],
}


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in FAULTS.items() for f in fs],
                         ids=lambda x: x if isinstance(x, str) else x.__name__)
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    r = run_tiny(cell, seed=7)
    assert r["correct"] is False, r["checks"]


def test_every_cell_has_its_faults():
    assert set(FAULTS) == set(ALL_CELLS)


@pytest.mark.parametrize("in_memory", [True, False])
def test_sample_files_read_back_by_name(in_memory, tmp_path, monkeypatch):
    """The sample files that the reader opens by name hold the FASTQ bytes,
    in memory files where the host gives them and on disk where it does not."""
    from portbench.kinds import classify

    from slacken_tpu_torch.inputs import packed_pairs_from_files

    if not in_memory:
        monkeypatch.setattr(classify, "memory_files", lambda workdir: False)
    drv = classify.Traffic.__new__(classify.Traffic)
    drv.ctx, drv.memfds, drv.memory_files = harness.Context(None, 0, "cpu", str(tmp_path), None, False), [], None
    data = [b"".join(b"@s0r%07d\nACGTN%s\n+\n%s\n" % (i, b"A" * 40, b"I" * 45) for i in range(9)) for _ in range(2)]
    paths = [str(tmp_path / f"sample0_{m}.fq") for m in (1, 2)]
    for p, d in zip(paths, data):
        drv._write_input(p, d)
    assert drv.memory_files is in_memory and os.path.islink(paths[0]) is in_memory
    assert all(open(p, "rb").read() == d for p, d in zip(paths, data))
    rows = list(packed_pairs_from_files(*paths))
    assert sum(len(r.titles) for r in rows) == 9
    for fd in drv.memfds:
        os.close(fd)
