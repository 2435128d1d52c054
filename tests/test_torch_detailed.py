"""Per-read (detailed) output of the port on the CPU against slacken_tpu's
classify_and_write_packed(per_read_output=True): the per-read lines (after
decompression) and the kreports are byte-identical (tolerance 0: text), for
single and paired rows, two thresholds, sample regexes, --no-unclassified,
N runs longer and shorter than k, reads shorter than k, max_taxa overflow
rows, and with the native line formatter on and stubbed off."""

import pytest
import torch

from slacken_tpu.classify import Classifier as JClassifier
from slacken_tpu.classify import ClassifyParams as JParams
from slacken_tpu_torch import native
from slacken_tpu_torch.classify import Classifier, ClassifyParams
from test_torch_classify import setup, tree  # noqa: F401  (setup is a fixture)

torch.set_num_threads(1)


@pytest.mark.parametrize(
    "max_taxa,mhg,regex,unclassified,native_on",
    [
        (32, 2, None, True, True),
        (2, 1, r"^[a-z](s\d)_", False, True),
        (2, 3, r"^([ab])", True, False),
        (32, 2, None, False, False),
    ],
)
@pytest.mark.parametrize("kind", ["single", "paired"])
def test_detailed_matches_jax(setup, tmp_path, monkeypatch, kind, max_taxa, mhg, regex,  # noqa: F811
                              unclassified, native_on):
    jidx, idx, single, paired = setup
    stream = single if kind == "single" else [paired]
    kw = dict(thresholds=[0.0, 0.15], min_hit_groups=mhg, sample_regex=regex,
              with_unclassified=unclassified, per_read_output=True)
    want = JClassifier(jidx, max_taxa_per_read=max_taxa).classify_and_write_packed(
        stream, str(tmp_path / "j"), JParams(**kw))
    if not native_on:
        monkeypatch.setattr(native, "_load", lambda: None)
    assert native.available() == native_on
    cls = Classifier(idx, "cpu", max_taxa_per_read=max_taxa)
    got = cls.classify_and_write_packed(stream, str(tmp_path / "t"), ClassifyParams(**kw))
    assert got == want
    a, b = tree(str(tmp_path / "j")), tree(str(tmp_path / "t"))
    assert a.keys() == b.keys()
    assert sum(k.endswith(".gz") for k in a) >= 2 and sum(k.endswith(".txt") for k in a) >= 2
    for key in a:
        assert a[key] == b[key], key
    lines = b"".join(v for k, v in b.items() if k.endswith(".gz") and k.startswith("_c0.00"))
    n_reads = sum(len(p) for p in stream)
    assert (lines.count(b"\n") == n_reads) if unclassified else (0 < lines.count(b"\n") < n_reads)
    if kind == "paired":
        assert b"|:|" in lines
    assert b"A:" in lines  # an N run of at least k


def test_per_read_kreports_equal_reports_mode(setup, tmp_path):  # noqa: F811
    _, idx, single, paired = setup
    cls = Classifier(idx, "cpu", max_taxa_per_read=2)
    for per_read in (True, False):
        cls.classify_and_write_packed(
            single + [paired], str(tmp_path / f"o{per_read}"),
            ClassifyParams(thresholds=[0.0, 0.15], per_read_output=per_read))
    a = {k: v for k, v in tree(str(tmp_path / "oTrue")).items() if k.endswith(".txt")}
    assert a and a == tree(str(tmp_path / "oFalse"))
