"""Programmatic API (counterpart of slacken_tpu/api.py).

Example:

    from slacken_tpu_torch.api import Slacken
    sl = Slacken("/path/to/index", detailed=True, confidence=0.05)
    results = sl.classify_reads(reads)           # list of (title, seq) pairs
    sl.write_reports(results, "/out/run1")
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple, Union

from . import get_device
from .classify import (
    ClassifiedRead,
    Classifier,
    ClassifyParams,
    Fragment,
    format_threshold,
    write_per_sample_output,
)
from .index import KeyValueIndex


class Slacken:
    def __init__(
        self,
        index: Union[str, KeyValueIndex],
        detailed: bool = True,
        sample_regex: Optional[str] = None,
        confidence: float = 0.0,
        min_hit_groups: int = 2,
        unclassified: bool = False,
        device: str = "cuda",
    ):
        if confidence < 0 or confidence > 1:
            raise ValueError(f"confidence must be in [0, 1] ({confidence} was given)")
        self.index = KeyValueIndex.load(index) if isinstance(index, str) else index
        self.confidence = confidence
        self.cpar = ClassifyParams(
            min_hit_groups=min_hit_groups,
            with_unclassified=unclassified,
            thresholds=[confidence],
            sample_regex=sample_regex,
            per_read_output=detailed,
        )
        self.classifier = Classifier(self.index, get_device(device))

    def classify_reads(
        self,
        reads: Iterable[Union[Fragment, Tuple[str, str]]],
        reads2: Optional[Iterable[Tuple[str, str]]] = None,
    ) -> List[ClassifiedRead]:
        """Classify reads; `reads` yields Fragments or (title, sequence)
        pairs; `reads2` optionally provides R2 mates in the same order."""
        frags: List[Fragment] = []
        if reads2 is not None:
            for r1, r2 in zip(reads, reads2):
                frags.append(Fragment(r1[0], r1[1], r2[1]))
        else:
            for r in reads:
                frags.append(r if isinstance(r, Fragment) else Fragment(r[0], r[1]))
        return self.classifier.classify(frags, self.cpar)[self.confidence]

    def write_reports(self, classified: List[ClassifiedRead], location: str) -> List[str]:
        """Write per-sample outputs + kreports; returns report file paths."""
        loc = location + "_c" + format_threshold(self.confidence, self.cpar.thresholds)
        samples = write_per_sample_output(classified, loc, self.cpar, self.index.taxonomy)
        return [f"{loc}/{s}_kreport.txt" for s in samples]
