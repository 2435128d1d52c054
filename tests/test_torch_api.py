"""The port's programmatic API and Classifier.classify against slacken_tpu's
on one saved index (exact: every field of every ClassifiedRead, in input
order, and the files write_reports leaves)."""

import dataclasses

import pytest
import torch

from slacken_tpu.api import Slacken as JSlacken
from slacken_tpu.classify import Classifier as JClassifier
from slacken_tpu.classify import ClassifyParams as JParams
from slacken_tpu.classify import Fragment as JFragment
from slacken_tpu.ops import encode
from slacken_tpu_torch import native
from slacken_tpu_torch.api import Slacken
from slacken_tpu_torch.classify import Classifier, ClassifyParams, Fragment
from test_torch_classify import setup, tree  # noqa: F401  (setup is a fixture)

torch.set_num_threads(1)


def _fragments(rng, single, paired):
    """(title, seq, seq2 or None) from the packed chunks, shuffled so that
    length buckets (128, 256, 512) and single/paired rows interleave."""
    out = []
    for p in single:
        for t, c, n in zip(p.titles, p.codes, p.lengths):
            out.append((t, encode.decode_codes(c[:n]), None))
    for t, c, n, s in zip(paired.titles, paired.codes, paired.lengths, paired.splits):
        out.append((t, encode.decode_codes(c[:s]), encode.decode_codes(c[s + 1 : n])))
    return [out[i] for i in rng.permutation(len(out))]


def _fields(reads):
    return [dataclasses.astuple(r) for r in reads]


@pytest.mark.parametrize("per_read,native_on", [(True, True), (True, False), (False, True)])
def test_classify_order_and_fields_match_jax(setup, rng, monkeypatch, per_read, native_on):  # noqa: F811
    jidx, idx, single, paired = setup
    frags = _fragments(rng, single, paired)
    kw = dict(thresholds=[0.0, 0.2], min_hit_groups=1, sample_regex=r"^[a-z](s\d)_",
              per_read_output=per_read)
    want = JClassifier(jidx, max_taxa_per_read=3).classify([JFragment(*f) for f in frags], JParams(**kw))
    if not native_on:
        monkeypatch.setattr(native, "_load", lambda: None)
    cls = Classifier(idx, "cpu", max_taxa_per_read=3)
    cls.target_batch_bp = 1 << 13  # several batches per bucket
    got = cls.classify((Fragment(*f) for f in frags), ClassifyParams(**kw))
    assert got.keys() == want.keys()
    for t in want:
        assert [r.title for r in got[t]] == [f[0] for f in frags]
        assert _fields(got[t]) == _fields(want[t])
    assert any("|:|" in r.hit_details for r in got[0.0]) == per_read


def test_classify_and_write_matches_jax(setup, rng, tmp_path):  # noqa: F811
    jidx, idx, single, paired = setup
    frags = _fragments(rng, single, paired)
    kw = dict(thresholds=[0.0, 0.1], sample_regex=r"^([abpq])", with_unclassified=False)
    want = JClassifier(jidx).classify_and_write([JFragment(*f) for f in frags], str(tmp_path / "j"), JParams(**kw))
    got = Classifier(idx, "cpu").classify_and_write([Fragment(*f) for f in frags], str(tmp_path / "t"),
                                                    ClassifyParams(**kw))
    assert got == want
    a, b = tree(str(tmp_path / "j")), tree(str(tmp_path / "t"))
    assert a == b and len(a) >= 8


@pytest.mark.parametrize("detailed,unclassified", [(True, False), (True, True), (False, True)])
def test_api_matches_jax(setup, tmp_path, detailed, unclassified):  # noqa: F811
    _, idx, single, paired = setup
    kw = dict(detailed=detailed, confidence=0.05, unclassified=unclassified, sample_regex=r"^([a-z])")
    jsl = JSlacken(idx.location, **kw)
    sl = Slacken(idx.location, device="cpu", **kw)
    reads = [(t, encode.decode_codes(c[:n])) for p in single for t, c, n in zip(p.titles, p.codes, p.lengths)]
    want, got = jsl.classify_reads(reads), sl.classify_reads(iter(reads))
    assert _fields(got) == _fields(want) and len(got) == len(reads)
    r1 = [(t, encode.decode_codes(c[:s])) for t, c, s in zip(paired.titles, paired.codes, paired.splits)]
    r2 = [(t, encode.decode_codes(c[s + 1 : n]))
          for t, c, s, n in zip(paired.titles, paired.codes, paired.splits, paired.lengths)]
    wantp = jsl.classify_reads(r1, r2)
    gotp = sl.classify_reads([Fragment(*r) for r in r1], r2)
    assert _fields(gotp) == _fields(wantp) and len(gotp) == len(r1)
    a = jsl.write_reports(want + wantp, str(tmp_path / "j"))
    b = sl.write_reports(got + gotp, str(tmp_path / "t"))
    assert [x.replace(str(tmp_path / "j"), "") for x in a] == [x.replace(str(tmp_path / "t"), "") for x in b]
    assert tree(str(tmp_path / "j")) == tree(str(tmp_path / "t"))


def test_api_rejects_bad_arguments(setup, monkeypatch):  # noqa: F811
    _, idx, _, _ = setup
    with pytest.raises(ValueError, match="confidence"):
        Slacken(idx, confidence=1.5, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Slacken(idx)
