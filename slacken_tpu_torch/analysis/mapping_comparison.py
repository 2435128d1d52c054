"""Classification quality evaluation vs a reference mapping
(counterpart of slacken_tpu/analysis/mapping_comparison.py; reference:
analysis/MappingComparison.scala).

Computes per-taxon precision/recall (with a presence threshold) and per-read
TruePos/VaguePos/FalsePos/FalseNeg in the Kraken 2 paper's strain-exclusion
categories, at Genus and Species levels, emitting *_metrics.tsv."""

from __future__ import annotations

import gzip
import os
import re
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

from ..taxonomy import NONE, ROOT, Taxonomy

GENUS_DEPTH = 7
SPECIES_DEPTH = 8
RANK_NAME = {GENUS_DEPTH: "Genus", SPECIES_DEPTH: "Species"}


@dataclass
class PerTaxonMetrics:
    classified_count: int
    ref_count: int
    precision: float
    recall: float

    HEADER = "taxon_classified\ttaxon_total\ttaxon_precision\ttaxon_recall"

    def tsv(self) -> str:
        return f"{self.classified_count}\t{self.ref_count}\t{self.precision}\t{self.recall}"


@dataclass
class PerReadMetrics:
    classified_count: int
    total_count: int
    tp: int
    fp: int
    vp: int
    fn: int
    ppv: float
    sensitivity: float
    index: float

    HEADER = (
        "read_classified\tread_total\tread_tp\tread_fp\tread_vp\tread_fn"
        "\tread_ppv\tread_sensitivity\tread_index"
    )

    def tsv(self) -> str:
        return (
            f"{self.classified_count}\t{self.total_count}\t{self.tp}\t{self.fp}"
            f"\t{self.vp}\t{self.fn}\t{self.ppv}\t{self.sensitivity}\t{self.index}"
        )


METRICS_HEADER = (
    "title\tfamily\tgroup\tsample\tlibrary\tk\tm\tfrequency\tfl\ts\tc\trank\t"
    + PerTaxonMetrics.HEADER
    + "\t"
    + PerReadMetrics.HEADER
)

#: filename pattern for experiment-variable extraction
#: (MappingComparison.scala:53)
TITLE_PATTERN = re.compile(
    r"(.*)/(.*)/(.+)_(\d+)_(\d+)_s(\d+)_c([\d.]+)_classified/sample=(.*)"
)


def hit_category(
    tax: Taxonomy, ref_taxon: int, test_taxon: int, level_depth: Optional[int]
) -> Tuple[str, Optional[int]]:
    """Kraken 2 strain-exclusion categories (MappingComparison.scala:313-331).
    Returns (category, index)."""
    if test_taxon == NONE:
        return "FalseNeg", 9
    ref_ancestor = None
    if level_depth is not None:
        ref_ancestor = tax.standard_ancestor_at_level(ref_taxon, level_depth)
    if ref_ancestor is None:
        ref_ancestor = ref_taxon
    if ref_taxon == test_taxon:
        return "TruePos", 0
    if ref_ancestor != ROOT and tax.has_ancestor(test_taxon, ref_ancestor):
        return "TruePos", 0
    if ref_ancestor == ROOT or tax.has_ancestor(ref_taxon, test_taxon):
        return "VaguePos", tax.standard_steps_to_ancestor(ref_taxon, test_taxon)
    if test_taxon == ROOT:
        return "VaguePos", tax.standard_steps_to_ancestor(ref_taxon, test_taxon)
    return "FalsePos", 9


class MappingComparison:
    def __init__(
        self,
        tax: Taxonomy,
        ref_id_col: int = 2,
        ref_taxon_col: int = 3,
        with_header: bool = False,
        min_count_taxon: int = 10,
        multi_sample: bool = False,
    ):
        self.tax = tax
        self.ref_id_col = ref_id_col
        self.ref_taxon_col = ref_taxon_col
        self.with_header = with_header
        self.min_count = min_count_taxon
        self.multi_sample = multi_sample

    # -- readers ------------------------------------------------------------

    def read_reference(self, path: str) -> Dict[str, int]:
        """Reference mapping: id -> primary taxon, skipping /2 mates and
        undefined taxa (MappingComparison.scala:119-132, 265-274)."""
        out = {}
        with _open(path) as f:
            first = True
            for line in f:
                if first and self.with_header:
                    first = False
                    continue
                first = False
                parts = line.rstrip("\n").split("\t")
                if len(parts) < max(self.ref_id_col, self.ref_taxon_col):
                    continue
                rid = parts[self.ref_id_col - 1]
                if "/2" in rid:
                    continue
                rid = rid.replace("/1", "")
                taxon = int(self.tax.primary[int(parts[self.ref_taxon_col - 1])])
                if self.tax.is_defined(taxon):
                    out[rid] = taxon
        return out

    def read_kraken(self, location: str) -> Dict[str, int]:
        """Kraken-format per-read output: col 2 = id, col 3 = taxon
        (MappingComparison.scala:259-263). Accepts a file or directory."""
        out = {}
        paths = []
        if os.path.isdir(location):
            for root, _, names in os.walk(location):
                paths += [os.path.join(root, n) for n in sorted(names) if "kreport" not in n]
        else:
            paths = [location]
        for p in paths:
            with _open(p) as f:
                for line in f:
                    parts = line.rstrip("\n").split("\t")
                    if len(parts) >= 3:
                        out[parts[1]] = int(self.tax.primary[int(parts[2])])
        return out

    # -- metrics ------------------------------------------------------------

    def per_taxon(
        self, cmp_data: Dict[str, int], ref_data: Dict[str, int], level_depth: Optional[int]
    ) -> PerTaxonMetrics:
        tax = self.tax

        def at_level(x):
            if level_depth is None:
                return x
            return tax.standard_ancestor_at_level(x, level_depth)

        cmp_taxa_counts: Dict[int, int] = {}
        for t in cmp_data.values():
            a = at_level(t)
            if a is not None and a != NONE:
                cmp_taxa_counts[a] = cmp_taxa_counts.get(a, 0) + 1

        ref_taxa = set()
        for t in ref_data.values():
            a = at_level(t)
            if a is not None:
                ref_taxa.add(a)
        vague = tax.taxa_with_ancestors(ref_taxa) - ref_taxa

        cmp_taxa = {
            t
            for t, c in cmp_taxa_counts.items()
            if c >= self.min_count
            and (level_depth is not None or tax.depth(t) >= SPECIES_DEPTH)
        }

        tp = len(ref_taxa & cmp_taxa)
        fp = len((cmp_taxa - ref_taxa) - vague)
        fn = len(ref_taxa - cmp_taxa)
        denom = len(cmp_taxa - vague)
        precision = tp / denom if denom else 0.0
        recall = tp / len(ref_taxa) if ref_taxa else 0.0
        return PerTaxonMetrics(len(cmp_taxa), len(ref_taxa), precision, recall)

    def per_read(
        self, cmp_data: Dict[str, int], ref_data: Dict[str, int], level_depth: Optional[int]
    ) -> PerReadMetrics:
        cats: Dict[str, int] = {}
        idx_sum, idx_n = 0.0, 0
        total = 0
        classified = 0
        for rid, test in cmp_data.items():
            ref = ref_data.get(rid)
            if ref is None:
                continue
            total += 1
            if test != NONE:
                classified += 1
            cat, index = hit_category(self.tax, ref, test, level_depth)
            cats[cat] = cats.get(cat, 0) + 1
            if index is not None:
                idx_sum += index
                idx_n += 1
        tp = cats.get("TruePos", 0)
        fp = cats.get("FalsePos", 0)
        vp = cats.get("VaguePos", 0)
        fn = cats.get("FalseNeg", 0)
        sens = tp / total if total else 0.0
        ppv = tp / (tp + fp) if tp + fp else 0.0
        avg_index = idx_sum / idx_n if idx_n else float("nan")
        return PerReadMetrics(classified, total, tp, fp, vp, fn, ppv, sens, avg_index)

    def all_metrics(self, data_file: str, reference: str) -> List[str]:
        ref_data = self.read_reference(reference)
        cmp_all = self.read_kraken(data_file)
        # inner join on the reference (MappingComparison.scala:154-158)
        cmp_data = {rid: t for rid, t in cmp_all.items() if rid in ref_data}
        spl = data_file.rstrip("/").split("/")
        title = "/".join(spl[-4:]) if self.multi_sample else spl[-1]
        lines = []
        for depth in (GENUS_DEPTH, SPECIES_DEPTH):
            pt = self.per_taxon(cmp_data, ref_data, depth)
            pr = self.per_read(cmp_data, ref_data, depth)
            m = TITLE_PATTERN.match(title)
            if m:
                family, group, library, k, mm, s, c, sample = m.groups()
                lines.append(
                    f"{title}\t{family}\t{group}\t{sample}\t{library}\t{k}\t{mm}\t0\t0"
                    f"\t{s}\t{c}\t{RANK_NAME[depth]}\t{pt.tsv()}\t{pr.tsv()}"
                )
            else:
                lines.append(
                    f"{title}\t-\t-\t-\t-\t-\t-\t0\t0\t-\t-\t{RANK_NAME[depth]}"
                    f"\t{pt.tsv()}\t{pr.tsv()}"
                )
        return lines

    def process_files(self, files: Iterable[str], output_prefix: str, reference: str):
        lines = [METRICS_HEADER]
        for f in files:
            lines.extend(self.all_metrics(f, reference))
        out = (output_prefix or "comparison") + "_metrics.tsv"
        with open(out, "w") as fh:
            fh.write("\n".join(lines) + "\n")
        print(f"Wrote {out}")

    def process_directories(self, dirs: Iterable[str], output_prefix: str, reference_prefix: str):
        """Multi-sample: <dir>/sample=<id> compared against
        <refPrefix>/sample<id>/reads_mapping.tsv (MappingComparison.scala:90-103)."""
        lines = [METRICS_HEADER]
        pattern = re.compile(r".*sample=(.+)")
        for d in dirs:
            for sub in sorted(os.listdir(d)):
                m = pattern.match(sub)
                if not m:
                    continue
                sample = m.group(1)
                ref = os.path.join(reference_prefix, f"sample{sample}", "reads_mapping.tsv")
                lines.extend(self.all_metrics(os.path.join(d, sub), ref))
        out = (output_prefix or "comparison") + "_metrics.tsv"
        with open(out, "w") as fh:
            fh.write("\n".join(lines) + "\n")
        print(f"Wrote {out}")


def _open(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path)
