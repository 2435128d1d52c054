"""Kraken 1/2-style hierarchical reports (reference: KrakenReport.scala)."""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

from .taxonomy import NONE, RANK_CODE, ROOT, Taxonomy


class TreeAggregator:
    """Clade aggregation up the tree (KrakenReport.scala:27-41)."""

    def __init__(self, taxonomy: Taxonomy, counts: Iterable[Tuple[int, int]]):
        self.taxon_counts: Dict[int, int] = {}
        self.clade_totals: Dict[int, int] = {}
        for taxid, count in counts:
            self.taxon_counts[taxid] = self.taxon_counts.get(taxid, 0) + count
        for taxid, count in self.taxon_counts.items():
            for p in taxonomy.path_to_root(taxid):
                self.clade_totals[p] = self.clade_totals.get(p, 0) + count
            if taxid == NONE:  # path_to_root doesn't include NONE
                self.clade_totals[taxid] = self.clade_totals.get(taxid, 0) + count

    @property
    def keys(self):
        return self.taxon_counts.keys()


class KrakenReport:
    """Kraken-format report: DFS over the taxonomy with clade-aggregated
    counts, children sorted by descending clade count
    (KrakenReport.scala:50-116)."""

    def __init__(
        self,
        taxonomy: Taxonomy,
        counts: Iterable[Tuple[int, int]],
        compatible_format: bool = False,
        report_zeros: bool = False,
    ):
        self.taxonomy = taxonomy
        agg = TreeAggregator(taxonomy, counts)
        self.clade_totals = agg.clade_totals
        self.taxon_counts = agg.taxon_counts
        self.total_sequences = sum(self.taxon_counts.values())
        self.compatible_format = compatible_format
        self.report_zeros = report_zeros

    HEADERS = "#Perc\tAggregate\tIn taxon\tRank\tTaxon\tName"

    def _data_columns(self, taxid: int) -> str:
        clade = self.clade_totals.get(taxid, 0)
        own = self.taxon_counts.get(taxid, 0)
        total = self.total_sequences or 1
        percent = "%6.2f" % (100.0 * clade / total)
        return f"{percent}\t{clade}\t{own}"

    def _line(self, taxid: int, rank_depth: int, sub_depth: int, indent: int) -> str:
        code = RANK_CODE.get(rank_depth, "-")
        depth_str = "" if sub_depth == 0 else str(sub_depth)
        name = self.taxonomy.get_name(taxid) or ""
        pad = "  " * indent
        return f"{self._data_columns(taxid)}\t{code}{depth_str}\t{taxid}\t{pad}{name}"

    def lines(self) -> List[str]:
        out: List[str] = []
        if not self.compatible_format:
            out.append(self.HEADERS)
        unclassified = self.taxon_counts.get(NONE, 0)
        if unclassified != 0 or self.report_zeros:
            out.append(self._line(NONE, -1, 0, 0))
        # iterative DFS matching reportDFS (KrakenReport.scala:82-101)
        stack = [(ROOT, 0, 0, 0)]  # taxid, inherited rank depth, sub depth, indent
        while stack:
            taxid, rank, sub, indent = stack.pop()
            d = int(self.taxonomy.rank_depth[taxid])
            from .taxonomy import NO_RANK

            if d != NO_RANK:
                rank_next, sub_next = d, 0
            else:
                rank_next, sub_next = rank, sub + 1
            out.append(self._line(taxid, rank_next, sub_next, indent))
            children = [
                (c, self.clade_totals.get(c, 0)) for c in self.taxonomy.children[taxid]
            ]
            # sort by descending clade count; stable, preserving the
            # descending-taxid child order on ties (Taxonomy.scala:193-201)
            children.sort(key=lambda x: -x[1])
            # push in reverse so the highest-count child is visited first
            for c, count in reversed(children):
                if self.report_zeros or count > 0:
                    stack.append((c, rank_next, sub_next, indent + 1))
        return out

    def write(self, path: str):
        with open(path, "w") as f:
            for line in self.lines():
                f.write(line + "\n")

    def print(self, file=None):
        import sys

        for line in self.lines():
            print(line, file=file or sys.stdout)
