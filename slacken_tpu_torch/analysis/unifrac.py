"""Unweighted UniFrac distance between two taxon sets over the taxonomy tree
(counterpart of slacken_tpu/analysis/unifrac.py; reference:
analysis/UniFrac.scala)."""

from __future__ import annotations

from ..taxonomy import ROOT, Taxonomy


class UniFrac:
    def __init__(self, tax: Taxonomy, sample1, sample2):
        self.tax = tax
        self.tree1 = self._full_tree(sample1)
        self.tree2 = self._full_tree(sample2)
        self.shared = self.tree1 & self.tree2
        self.distinct1 = self.tree1 - self.shared
        self.distinct2 = self.tree2 - self.shared
        self.both = self._full_tree(set(sample1) | set(sample2))

    def _full_tree(self, sample):
        return self.tax.taxa_with_ancestors(sample) - {ROOT}

    @property
    def distance(self) -> float:
        unique = len(self.distinct1) + len(self.distinct2)
        total = len(self.both)
        return unique / total if total else 0.0
