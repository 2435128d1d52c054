"""Index statistics and inspection reports (counterpart of
slacken_tpu/stats.py; reference: IndexStatistics.scala,
KeyValueIndex.report/kmerDepthHistogram, KeyValueIndex.scala:240-344).

Counts over the index (per-taxon records, depth histograms) are taken where
its tensors lie. The library scan behind the k-mer count columns and the
coverage statistics is scan-only on `device` (the CUDA scan kernel on the
card): valid windows are summed per row there, span keys are selected by
mask and stay there, and the coverage lookup goes through the probe.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import get_device, to_device
from .index import _batches, _differs, key_columns, sort_order
from .ops import encode
from .ops.lookup import probe
from .ops.minimizers import window_minimizers_packed
from .report import KrakenReport
from .taxonomy import depth_to_title


def depth_histograms(idx) -> Tuple[List[Tuple[int, str, int]], List[Tuple[int, str, int]]]:
    """(minimizer-depth histogram, taxon-depth histogram): rows of
    (depth, rank title, count) sorted by depth (KeyValueIndex.scala:326-336),
    counted on the index's device."""
    depth_std = torch.from_numpy(idx.taxonomy.depth_std).to(idx.device)
    taxa = idx.taxa_t.to(idx.device)

    def rows(taxa):
        d, c = torch.unique(depth_std[taxa.long()], return_counts=True)
        return [(d, depth_to_title(d) or str(d), c) for d, c in zip(d.tolist(), c.tolist())]

    return rows(taxa), rows(torch.unique(taxa))


def taxon_coverage_stats(idx) -> Dict[str, float]:
    """Fraction of minimizers assigned at leaf taxa vs lifted to ancestors
    (IndexStatistics.scala:61-111 summary)."""
    per_taxon = idx.records_per_taxon()
    leaf = sum(c for t, c in per_taxon.items() if idx.taxonomy.is_leaf(t))
    total = sum(per_taxon.values())
    return {
        "total_minimizers": total,
        "leaf_minimizers": leaf,
        "leaf_fraction": leaf / total if total else 0.0,
    }


def show_coverage_stats(idx, library, device="cuda"):
    """Per-taxon minimizer coverage of library taxa in the index
    (showTaxonFullCoverageStats, IndexStatistics.scala:86-111)."""
    per_taxon = idx.records_per_taxon()
    lib_taxa = sorted({t for t in library.labels.values()})
    present = [t for t in lib_taxa if per_taxon.get(t, 0) > 0]
    print(f"Library taxa: {len(lib_taxa)}, with own minimizers in index: {len(present)}")
    cov = taxon_coverage_stats(idx)
    print(
        f"Total minimizers {cov['total_minimizers']}, at leaf taxa "
        f"{cov['leaf_minimizers']} ({100 * cov['leaf_fraction']:.2f}%)"
    )
    rows = taxon_full_coverage_stats(idx, library, device)
    print("taxon\tminimizerCoverage\tdistinctMinimizerCoverage")
    for taxon, covs, dcovs in rows:
        print(f"{taxon}\t{covs}\t{dcovs}")


def write_inspect_reports(idx, output: str, labels: Optional[str] = None, library=None,
                          device="cuda"):
    """Kraken-style quasi reports describing the index
    (KeyValueIndex.scala:274-306):
      <out>_min_report.txt     index contents in minimizers
      <out>_genome_report.txt  stored taxa (count 1 each)
      <out>_missing_report.txt label taxa missing from the index
    With a genome library, the minimizer report gains TKC1/2/3 k-mer count
    columns (KeyValueIndex.scala:279-284) from a scan of it on `device`.
    """
    per_taxon = sorted(idx.records_per_taxon().items())
    if library is not None:
        total_kmer_count_report(idx, library, device).write(output + "_min_report.txt")
    else:
        KrakenReport(idx.taxonomy, per_taxon).write(output + "_min_report.txt")
    KrakenReport(idx.taxonomy, [(t, 1) for t, _ in per_taxon]).write(
        output + "_genome_report.txt"
    )
    if labels:
        label_taxa = set()
        with open(labels) as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) >= 2:
                    label_taxa.add(int(parts[1]))
        present = {t for t, _ in per_taxon}
        missing = sorted(label_taxa - present)
        KrakenReport(idx.taxonomy, [(t, 1) for t in missing]).write(
            output + "_missing_report.txt"
        )


# ---------------------------------------------------------------------------
# Total k-mer count report (reference: IndexStatistics.scala:38-52, 114-222)
# ---------------------------------------------------------------------------


def library_span_data(idx, library, device="cuda", batch_rows: int = 64, row_len: int = 1 << 16):
    """Scan the genome library on `device`: ({taxon: total k-mers (valid
    windows)}, the minimizer key of every span, the span's source taxon).
    The keys (int64 [S], or [S, 2] rows of (hi64, lo64) for a wide index)
    and the taxa (int32 [S]) stay on the device. Sequences go in under their
    label's taxon as it stands, in the index build's rows."""
    device = get_device(device)
    mp = idx.params.minimizer_params
    lut = idx.device_lut(device)
    kmer_counts: Dict[int, int] = {}
    span_keys, span_taxa = [], []
    fragments = ((taxon, seq) for taxon, _, seq in library.sequences())
    for codes, row_taxa, n in _batches(fragments, idx.params, None, batch_rows, row_len):
        packed, valid = encode.pack_2bit(codes)
        wm = window_minimizers_packed(to_device(packed, device), to_device(valid, device), mp, lut)
        per_row = wm.valid.sum(dim=1).cpu().numpy()
        for t in np.unique(row_taxa[:n]):
            kmer_counts[int(t)] = kmer_counts.get(int(t), 0) + int(per_row[:n][row_taxa[:n] == t].sum())
        rt = torch.from_numpy(row_taxa).to(device)
        span_keys.append(wm.minimizer[wm.span_start])
        span_taxa.append(rt[:, None].expand(-1, row_len)[wm.span_start])
    if span_keys:
        return kmer_counts, torch.cat(span_keys), torch.cat(span_taxa)
    return (kmer_counts, torch.zeros((0, 2) if mp.wide else 0, dtype=torch.int64, device=device),
            torch.zeros(0, dtype=torch.int32, device=device))


class TotalKmerSizeAggregator:
    """Clade-averaged genome k-mer sizes, three strategies
    (TotalKmerSizeAggregator, IndexStatistics.scala:130-222)."""

    def __init__(self, taxonomy, genome_sizes: dict):
        self.tax = taxonomy
        self.sizes = dict(genome_sizes)
        # (sum of leaf-accessible genome sizes, genome count) per taxon
        self.tree = {}
        self._compute(1)

    def _compute(self, root):
        # iterative post-order DFS
        stack = [(root, False)]
        while stack:
            taxon, done = stack.pop()
            if not done:
                stack.append((taxon, True))
                for c in self.tax.children[taxon]:
                    stack.append((c, False))
            else:
                s, n = (self.sizes.get(taxon, 0), 1 if taxon in self.sizes else 0)
                for c in self.tax.children[taxon]:
                    cs, cn = self.tree[c]
                    s += cs
                    n += cn
                self.tree[taxon] = (s, n)

    def s1(self, taxon) -> float:
        """Average over all leaf genomes in the clade (TKC1-LeafOnly)."""
        children = self.tax.children[taxon]
        if children:
            s = sum(self.tree[c][0] for c in children)
            n = sum(self.tree[c][1] for c in children)
        else:
            s, n = self.tree.get(taxon, (0, 0))
        if taxon in self.sizes and children:
            s += self.sizes[taxon]
            n += 1
        return s / n if n else 0.0

    def s2(self, taxon) -> float:
        """Average of immediate children's averages (TKC2-FirstChildren)."""
        children = self.tax.children[taxon]
        if children:
            vals = [
                self.tree[c][0] / self.tree[c][1]
                for c in children
                if self.tree[c][1] > 0
            ]
            if taxon in self.sizes:
                vals = [float(self.sizes[taxon])] + vals
            return sum(vals) / len(vals) if vals else 0.0
        s, n = self.tree.get(taxon, (0, 0))
        return s / n if n else 0.0

    def s3(self, taxon) -> float:
        """Weighted mix of S1 and S2 (TKC3-AllChildren)."""
        children_nz = [
            self.tree[c] for c in self.tax.children[taxon] if self.tree[c][1] > 0
        ]
        if children_nz:
            s = sum(x[0] for x in children_nz)
            n = sum(x[1] for x in children_nz)
        else:
            s, n = self.tree.get(taxon, (0, 0))
        m = len(children_nz)
        if n + m == 0:
            return 0.0
        return (self.s1(taxon) * n + self.s2(taxon) * m) / (n + m)


class TotalKmerCountReport(KrakenReport):
    """KrakenReport with TKC1/2/3 clade-average columns
    (TotalKmerCountReport, IndexStatistics.scala:114-128)."""

    HEADERS = KrakenReport.HEADERS.replace(
        "#Perc\tAggregate\tIn taxon",
        "#Perc\tAggregate\tIn taxon\tTKC1-LeafOnly\tTKC2-FirstChildren\tTKC3-AllChildren",
    )

    def __init__(self, taxonomy, counts, genome_sizes: dict):
        super().__init__(taxonomy, counts)
        self.agg = TotalKmerSizeAggregator(taxonomy, genome_sizes)

    def _data_columns(self, taxid):
        base = super()._data_columns(taxid)
        s1 = round(self.agg.s1(taxid))
        s2 = round(self.agg.s2(taxid))
        s3 = round(self.agg.s3(taxid))
        return f"{base}\t{s1}\t{s2}\t{s3}"


def total_kmer_count_report(idx, library, device="cuda") -> TotalKmerCountReport:
    """Per-taxon minimizer counts + genome k-mer size averages
    (IndexStatistics.totalKmerCountReport, IndexStatistics.scala:38-52)."""
    kmer_counts, _, _ = library_span_data(idx, library, device)
    per_taxon = sorted(idx.records_per_taxon().items())
    return TotalKmerCountReport(idx.taxonomy, per_taxon, kmer_counts)


def taxon_full_coverage_stats(idx, library, device="cuda"):
    """For each library taxon: minimizer counts (total and distinct) grouped
    by the depth of each minimizer's index LCA, as 'depth:count|...' strings
    (showTaxonFullCoverageStats, IndexStatistics.scala:86-111). Depths come
    in the order in which a taxon's minimizers, sorted by key, first reach
    them."""
    device = get_device(device)
    _, keys, taxa = library_span_data(idx, library, device)
    if keys.shape[0] == 0:
        return []
    # count (minimizer, taxon) multiplicities: sort by taxon, then key
    order = sort_order(taxa, *key_columns(keys))
    keys, taxa = keys[order], taxa[order]
    newpair = torch.ones_like(taxa, dtype=torch.bool)
    newpair[1:] = _differs(keys) | _differs(taxa)
    u_keys, u_taxa = keys[newpair].contiguous(), taxa[newpair]
    starts = torch.nonzero(newpair)[:, 0]
    count_all = torch.diff(starts, append=starts.new_tensor([keys.shape[0]]))

    lca = probe(*idx.device_arrays(device), u_keys)
    found = lca > 0
    depth_std = torch.from_numpy(idx.taxonomy.depth_std).to(device)
    depth = depth_std[lca[found].long()].cpu().numpy().astype(int)
    t_found = u_taxa[found].cpu().numpy()
    ca = count_all[found].cpu().numpy()

    out = []
    bounds = np.flatnonzero(np.diff(t_found, prepend=t_found[:1] - 1, append=t_found[-1:] + 1)) if len(t_found) else []
    for a, b in zip(bounds[:-1], bounds[1:]):  # t_found is sorted: one slice a taxon
        d, c = depth[a:b], ca[a:b]
        levels, first = np.unique(d, return_index=True)
        levels = levels[np.argsort(first)]
        covs = "|".join(f"{x}:{int(c[d == x].sum())}" for x in levels)
        dcovs = "|".join(f"{x}:{int((d == x).sum())}" for x in levels)
        out.append((int(t_found[a]), covs, dcovs))
    return out
