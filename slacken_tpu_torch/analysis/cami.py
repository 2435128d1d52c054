"""CAMI2 gold-standard read mapping -> Kraken-style report + filtered ID list
(counterpart of slacken_tpu/analysis/cami.py; reference:
analysis/CAMIToKrakenReport.scala).

Input mapping format (TSV with header):
#anonymous_read_id  genome_id  tax_id  read_id
"""

from __future__ import annotations

import gzip
from typing import Dict, Optional

from ..report import KrakenReport
from ..taxonomy import Taxonomy


class CAMIToKrakenReport:
    def __init__(self, mapping_location: str, tax: Taxonomy, min_rank_depth: Optional[int]):
        self.tax = tax
        self.min_depth = min_rank_depth
        self.rows = []  # (anonymous id, taxon)
        op = gzip.open if mapping_location.endswith(".gz") else open
        with op(mapping_location, "rt") as f:
            header = True
            for line in f:
                if header:
                    header = False
                    continue
                parts = line.rstrip("\n").split("\t")
                if len(parts) < 3:
                    continue
                taxon = int(tax.primary[int(parts[2])])
                if self.min_depth is None or tax.depth(taxon) >= self.min_depth:
                    self.rows.append((parts[0], taxon))

    def write_filtered_ids(self, location: str):
        with open(location, "w") as f:
            for rid, _ in self.rows:
                f.write(rid + "\n")

    def write_filtered_report(self, location: str):
        """Counts by taxon, halved to convert single-mate rows to pair counts
        (CAMIToKrakenReport.scala:107-113)."""
        counts: Dict[int, int] = {}
        for _, taxon in self.rows:
            counts[taxon] = counts.get(taxon, 0) + 1
        pairs = [(t, c // 2) for t, c in sorted(counts.items())]
        KrakenReport(self.tax, pairs).write(location)


def main(argv=None):
    """CLI: taxonomy_dir min_rank mapping_file output_prefix
    (CAMIToKrakenReport.main, CAMIToKrakenReport.scala:52-61)."""
    import sys

    argv = argv if argv is not None else sys.argv[1:]
    tax_dir, min_rank, mapping, out = argv[0], argv[1], argv[2], argv[3]
    from ..taxonomy import RANK_DEPTH, Taxonomy

    tax = Taxonomy.load(tax_dir)
    depth = RANK_DEPTH.get(min_rank.lower()) if min_rank.lower() != "root" else None
    c2r = CAMIToKrakenReport(mapping, tax, depth)
    c2r.write_filtered_report(f"{out}.kreport.txt")
    c2r.write_filtered_ids(f"{out}.ids_filtered.txt")


if __name__ == "__main__":
    main()
