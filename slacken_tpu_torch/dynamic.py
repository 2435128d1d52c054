"""Two-step dynamic classification (counterpart of slacken_tpu/dynamic.py;
reference: Dynamic.scala), on one device or over a device mesh.

Step 1: detect a taxon set present in the sample, by one of four criteria
(total minimizer hits, distinct minimizer hits, the distinct hits' share of
the index, or classified read counts against the base index). Step 2: build
a sample-tailored index restricted to that taxon set (plus descendants) and
classify all reads against it.

The span hits behind the minimizer criteria are made and counted on the
device a batch at a time: the scan kernel, the probe kernel, one mask (span
start, found, deep enough) and a select; total counts add up batch by batch
on the device, and each batch's (key, taxon) hits go into a bounded merge
tree of distinct pairs (index.MergeTree); only the per-taxon counts reach the
host. The dynamic index comes from the base index's full-records sidecar
where it has one (`KeyValueIndex.build_restricted`, no second scan of the
genomes), else from the library with a taxon filter; either way its keys and
taxa stay on the device and the final classification probes them there.

With `devices` and `layout` (as the classify CLI's --devices and --layout)
every step runs over the mesh, as in the reference every step is a
distributed job (Dynamic.scala:320-354): the span hits and step 1's
classification through a MeshClassifier, the dynamic index (without a
sidecar) through build_distributed, and the final classification.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

import torch

from . import get_device
from .classify import Classifier, ClassifyParams, Fragment, _row_length_bucket
from .index import KeyValueIndex, MergeTree, taxon_counts
from .ops import encode
from .parallel.classifier import build_distributed, make_classifier, requested_mesh
from .report import TreeAggregator
from .taxonomy import Taxonomy
from .utils import Timer


@dataclass(frozen=True)
class MinimizerTotalCount:
    """Include taxa with >= threshold total minimizer hits (Dynamic.scala:34)."""

    threshold: int


@dataclass(frozen=True)
class MinimizerDistinctCount:
    """Include taxa with >= threshold distinct minimizer hits (Dynamic.scala:37)."""

    threshold: int


@dataclass(frozen=True)
class ClassifiedReadCount:
    """Include taxa with >= threshold classified reads at the given
    confidence (Dynamic.scala:41)."""

    threshold: int
    confidence: float


@dataclass(frozen=True)
class MinimizerFraction:
    """Include taxa whose clade-aggregated distinct minimizer hits cover
    >= threshold fraction of the clade's minimizers in the index.

    The reference DECLARES this criterion (Dynamic.scala:43) but leaves its
    counting method unimplemented (`???`, Dynamic.scala:255); these are this
    framework's semantics, chosen to be self-consistent: the numerator is
    the sample's distinct (minimizer, LCA taxon) hit count, the denominator
    the index's minimizer count per LCA taxon, both clade-aggregated with
    TreeAggregator — so a clade is kept when the sample has touched at least
    `threshold` of the index content that can possibly vote for it."""

    threshold: float


@dataclass
class GoldSetOptions:
    """User-supplied gold taxon set (Dynamic.scala:62)."""

    taxon_file: str
    promote_rank_depth: Optional[int]
    classify_with: bool


def criteria_from_args(args):
    if getattr(args, "min_count", None):
        return MinimizerTotalCount(args.min_count)
    if getattr(args, "reads", None):
        return ClassifiedReadCount(args.reads, args.init_confidence)
    if getattr(args, "min_distinct", None):
        return MinimizerDistinctCount(args.min_distinct)
    if getattr(args, "min_fraction", None):
        return MinimizerFraction(args.min_fraction)
    return ClassifiedReadCount(100, getattr(args, "init_confidence", 0.15))


class Dynamic:
    """Two-step classification (Dynamic.scala:78) on `device`, or over the
    mesh that `devices` (a number of devices of `device`'s kind, or a
    mesh.Mesh) and `layout` ask for, as parallel.classifier.make_classifier
    takes them, through the probe `probe` (classify.probe_choice) in both
    steps: step 1's span hits and the final classification."""

    def __init__(
        self,
        base: KeyValueIndex,
        genomes,
        reclassify_rank_depth: int,
        criteria,
        cpar: ClassifyParams,
        gold: Optional[GoldSetOptions],
        output_location: str,
        device="cuda",
        devices=None,
        layout: Optional[str] = None,
        device_budget: Optional[int] = None,
        probe: Optional[str] = None,
    ):
        self.base = base
        self.genomes = genomes
        self.rank_depth = reclassify_rank_depth
        self.criteria = criteria
        self.cpar = cpar
        self.gold = gold
        self.output = output_location
        self.device = get_device(device)
        self.devices = devices
        self.layout = layout
        #: bytes of the merge tree that collects distinct span hits (None:
        #: index.default_device_budget)
        self.device_budget = device_budget
        self.probe = probe
        self._base_classifier: Optional[Classifier] = None

    @property
    def taxonomy(self) -> Taxonomy:
        return self.base.taxonomy

    def _make_classifier(self, idx: KeyValueIndex) -> Classifier:
        return make_classifier(idx, self.device, self.devices, self.layout, probe=self.probe)

    def _classifier(self) -> Classifier:
        """The base index's classifier, made once: it puts the index and its
        directory on the device (or the mesh)."""
        if self._base_classifier is None:
            self._base_classifier = self._make_classifier(self.base)
        return self._base_classifier

    # -- counting methods (Dynamic.scala:95-142) ----------------------------

    def _span_hit_batches(self, fragments: Sequence[Fragment]):
        """Per-span (minimizer key, LCA taxon) pairs against the base index,
        for spans whose taxon is at depth >= the reclassify rank, a batch's
        rows at a time (over a mesh, a device's chunk of them), as tensors on
        the classifier's (first) device: int64 [S] keys (int64 [S, 2] rows
        of (hi64, lo64) for a wide index) and int32 [S] taxa."""
        cls = self._classifier()
        home = cls.device
        depth = torch.from_numpy(self.taxonomy.depth_std)
        depths = {}
        for bucket, frags in _bucketize(fragments, cls):
            packed, valid = encode.pack_2bit(cls._pack_rows(frags, bucket).codes)
            for wm, looked in cls.scan_probe(packed, valid):
                dev = looked.device
                if dev not in depths:
                    depths[dev] = depth.to(dev)
                # span_start implies valid: the scan sets it on valid windows only
                # (kernels and twin alike), and an invalid window's -1 finds nothing
                keep = wm.span_start & (looked > 0) & (depths[dev][looked.long()] >= self.rank_depth)
                yield wm.minimizer[keep].to(home, non_blocking=True), looked[keep].to(home, non_blocking=True)

    def _span_hits(self, fragments: Sequence[Fragment]) -> Tuple[torch.Tensor, torch.Tensor]:
        """Every span hit of `_span_hit_batches`, gathered in row order (for
        the tests; the counts below never hold them all at once)."""
        batches = list(self._span_hit_batches(fragments))
        if not batches:
            home = self._classifier().device
            return (
                torch.zeros((0, 2) if self.base.wide else 0, dtype=torch.int64, device=home),
                torch.zeros(0, dtype=torch.int32, device=home),
            )
        return torch.cat([k for k, _ in batches]), torch.cat([t for _, t in batches])

    def total_minimizers_per_taxon(self, fragments) -> Dict[int, int]:
        """Span hits per taxon, in taxon order: each batch's counts added on
        the classifier's device, read once at the end."""
        total = torch.zeros(len(self.taxonomy.depth_std), dtype=torch.int64, device=self._classifier().device)
        for _, taxa in self._span_hit_batches(fragments):
            total.index_add_(0, taxa.long(), torch.ones_like(taxa, dtype=torch.int64))
        found = torch.nonzero(total).flatten()
        return dict(zip(found.tolist(), total[found].tolist()))

    def distinct_minimizers_per_taxon(self, fragments) -> Dict[int, int]:
        """Distinct (key, taxon) span hits per taxon, in taxon order: each
        batch's hits go into a MergeTree of pairs on the classifier's device,
        bounded by `device_budget`, whose leaves and merges drop repeats."""
        tree = MergeTree(self._classifier().device, self.taxonomy, self.base.params.m, pairs=True,
                         device_budget=self.device_budget)
        for keys, taxa in self._span_hit_batches(fragments):
            tree.add(keys, taxa)
        return taxon_counts(tree.finish(index=False)[1])

    def classified_reads_per_taxon(self, fragments, confidence: float) -> Dict[int, int]:
        cpar = ClassifyParams(
            min_hit_groups=self.cpar.min_hit_groups,
            thresholds=[confidence],
            per_read_output=False,
        )
        reads = self._classifier().classify(fragments, cpar)[confidence]
        counts: Dict[int, int] = {}
        for r in reads:
            if r.classified:
                counts[r.taxon] = counts.get(r.taxon, 0) + 1
        return counts

    # -- taxon set detection (Dynamic.scala:189-280) ------------------------

    def count_filter(self, counts: Dict[int, int], threshold: int) -> Set[int]:
        """Clade-aggregated counts >= threshold at depth >= rank
        (CountFilter, Dynamic.scala:191-201)."""
        agg = TreeAggregator(self.taxonomy, counts.items())
        return {
            t
            for t in agg.clade_totals
            if self.taxonomy.depth(t) >= self.rank_depth
            and agg.clade_totals[t] >= threshold
        }

    def fraction_filter(self, counts: Dict[int, int], threshold: float) -> Set[int]:
        """Clade hit fraction of the clade's index minimizers >= threshold
        at depth >= rank (the MinimizerFraction criterion — see its
        docstring; the reference declares but never implements it,
        Dynamic.scala:255)."""
        tax = self.taxonomy
        hits = TreeAggregator(tax, counts.items()).clade_totals
        denom = TreeAggregator(tax, self.base.records_per_taxon().items()).clade_totals
        return {
            x
            for x, h in hits.items()
            if tax.depth(x) >= self.rank_depth
            and h >= threshold * denom.get(x, float("inf"))
        }

    def find_taxon_set(self, fragments, write_location: Optional[str] = None) -> Set[int]:
        t = Timer("Find taxon set in subjects")
        c = self.criteria
        if isinstance(c, MinimizerTotalCount):
            counts = self.total_minimizers_per_taxon(fragments)
            keep = self.count_filter(counts, c.threshold)
        elif isinstance(c, MinimizerDistinctCount):
            counts = self.distinct_minimizers_per_taxon(fragments)
            keep = self.count_filter(counts, c.threshold)
        elif isinstance(c, MinimizerFraction):
            counts = self.distinct_minimizers_per_taxon(fragments)
            keep = self.fraction_filter(counts, c.threshold)
        elif isinstance(c, ClassifiedReadCount):
            counts = self.classified_reads_per_taxon(fragments, c.confidence)
            keep = self.count_filter(counts, c.threshold)
        else:
            raise ValueError(f"Unsupported criterion {c}")

        if write_location:
            os.makedirs(os.path.dirname(write_location) or ".", exist_ok=True)
            with open(write_location, "w") as f:
                for x in sorted(keep):
                    f.write(f"{x}\n")

        if self.gold is not None:
            gold_set = self.read_gold_set()
            tp = len(keep & gold_set)
            fp = len(keep - gold_set)
            fn = len(gold_set - keep)
            prec = tp / (tp + fp) if tp + fp else 0.0
            rec = tp / len(gold_set) if gold_set else 0.0
            print(
                f"Comparing detected set with supplied gold set. True Positives: {tp}, "
                f"False Positives: {fp}, False Negatives: {fn}, "
                f"Precision: {prec * 100:.2f}%, Recall: {rec * 100:.2f}%"
            )

        with_desc = self.taxonomy.taxa_with_descendants(keep)
        t.finish()
        print(
            f"Detected set: initial scan (criterion {c}) produced {len(keep)} taxa, "
            f"expanded with descendants to {len(with_desc)}"
        )
        return with_desc

    def read_gold_set(self) -> Set[int]:
        """Read + canonicalise the gold set, promoting taxa missing from the
        library up their lineage (Dynamic.scala:284-312)."""
        tax = self.taxonomy
        with open(self.gold.taxon_file) as f:
            gold = {
                int(tax.primary[int(line.strip().split(",")[0])])
                for line in f
                if line.strip()
            }
        print(f"Gold set contained {len(gold)} taxa")
        lib_set = self.genomes.taxon_set(tax)
        not_found = gold - lib_set
        promoted = set()
        for t in not_found:
            for p in tax.path_to_root(t):
                if p in lib_set:
                    promoted.add(p)
                    break
        print(f"{len(not_found)} taxa from gold set not found in library, promoted to {len(promoted)} taxa.")
        if self.gold.promote_rank_depth is not None:
            kept_promoted = {t for t in promoted if tax.depth(t) >= self.gold.promote_rank_depth}
        else:
            kept_promoted = set()
        total = gold | promoted
        filtered = {t for t in total if tax.depth(t) >= self.rank_depth} | kept_promoted
        print(f"Initial adjusted gold set size {len(total)}, filtered to {len(filtered)}")
        return filtered

    # -- two-step pipeline (Dynamic.scala:320-374) --------------------------

    def make_records(self, fragments) -> Tuple[KeyValueIndex, Set[int]]:
        """(the dynamic index, its taxon set). The index's keys and taxa are
        made, and stay, on the device."""
        if self.gold is not None and self.gold.classify_with:
            taxon_set = self.taxonomy.taxa_with_descendants(self.read_gold_set())
        else:
            taxon_set = self.find_taxon_set(fragments, self.output + "_taxonSet.txt")

        t = Timer("Build dynamic index")
        mesh = requested_mesh(self.device, self.devices, self.layout)
        if self.base.record_keys_t is not None:
            # fast path: filter + re-reduce the base index's full records
            dynamic = self.base.build_restricted(taxon_set, self.device)
        elif mesh is not None:
            dynamic = build_distributed(
                self.genomes.taxa_sequences(),
                self.base.params,
                self.taxonomy,
                mesh,
                taxon_filter=taxon_set,
                ordering_lut=self.base.ordering_lut,
            )
        else:
            dynamic = KeyValueIndex.build(
                self.genomes.taxa_sequences(),
                self.base.params,
                self.taxonomy,
                self.device,
                taxon_filter=taxon_set,
                ordering_lut=self.base.ordering_lut,
            )
        t.finish()
        return dynamic, taxon_set

    def two_step_classify_and_write(
        self,
        fragments,
        dynamic_reports: bool = False,
        bracken_read_length: Optional[int] = None,
        packed_factory=None,
    ):
        """fragments: a sequence of Fragments, or a zero-arg callable
        returning a fresh iterator (streaming mode — reads are re-read for
        each of the two passes instead of being held in memory, like the
        reference re-evaluating its reads Dataset, Dynamic.scala:320-324).

        packed_factory: optional zero-arg callable yielding native
        PackedReads batches for the SAME reads — the final classification
        then takes the fast streaming path (classify_and_write_packed, the
        same writer the 1-step CLI uses).

        bracken_read_length: also write the Bracken weights of the dynamic
        index for reads of this length, over the taxa it was made from, to
        <output_location>/database<R>mers.kmer_distrib."""
        if callable(fragments):
            factory = fragments
        else:
            frags_list = list(fragments)
            factory = lambda: iter(frags_list)  # noqa: E731
        dynamic_index, used_taxa = self.make_records(factory())
        print(f"Dynamic index: {dynamic_index.num_records} records, {len(used_taxa)} taxa")

        if dynamic_reports:
            from .stats import write_inspect_reports

            write_inspect_reports(dynamic_index, self.output + "_dynamic")

        if bracken_read_length:
            from .bracken import BrackenWeights

            t = Timer("Build library and Bracken weights")
            bw = BrackenWeights(dynamic_index, bracken_read_length, device=self.device)
            os.makedirs(self.output, exist_ok=True)
            bw.build_and_write_weights(
                self.genomes,
                used_taxa,
                os.path.join(self.output, f"database{bracken_read_length}mers.kmer_distrib"),
            )
            t.finish()

        t = Timer("Classify reads")
        cls = self._make_classifier(dynamic_index)
        if packed_factory is not None:
            cls.classify_and_write_packed(packed_factory(), self.output, self.cpar)
        else:
            cls.classify_and_write(factory(), self.output, self.cpar)
        t.finish()
        return dynamic_index


def _bucketize(fragments: Sequence[Fragment], cls: Classifier):
    """(row width, fragments) batches by length bucket; a pair takes one row,
    its mates joined by one INVALID code."""
    pending: Dict[int, List[Fragment]] = {}
    for f in fragments:
        n = len(f.seq) + (len(f.seq2) + 1 if f.seq2 is not None else 0)
        bucket = _row_length_bucket(n)
        lst = pending.setdefault(bucket, [])
        lst.append(f)
        if len(lst) >= cls._rows_target(bucket):
            yield bucket, lst
            pending[bucket] = []
    for bucket, lst in pending.items():
        if lst:
            yield bucket, lst
