"""Reproducible synthetic accuracy corpus: 1-step vs 2-step vs gold-set
(counterpart of slacken_tpu/analysis/experiment.py, on an explicit device).

The reference's headline claim is that 2-step "dynamic" classification
improves precision and read sensitivity over a 1-step pass with the full
index (README.md:300-330); its shipped evidence is metrics/All_metrics.tsv
(14,080 scored CAMI2 experiments, metrics/README.md:1-12). Real CAMI2 data
is unfetchable in this environment (no egress — see BASELINE.md), so this
module reproduces the experiment synthetically-but-reproducibly: a library
of genera with 70%-identical sibling species (the confusion source that
makes the full index over-call), a community of a subset of species, mutated
reads with known ground truth, and MappingComparison scoring at genus and
species rank — the same four hit categories and metrics as the reference's
corpus (analysis/MappingComparison.scala:95-158).

Three classification modes are scored, mirroring the reference experiment
families (Dynamic.scala:320-374):
  1step — the full base index (Kraken 2-style single pass);
  2step — classify2: taxon set detected from the sample (ClassifiedReadCount
          criterion), dynamic index built from it, sample re-classified;
  gold  — the dynamic index built from the TRUE taxon set (upper bound).

`run_experiment` returns the scored rows and optionally writes an
All_metrics-style TSV (column layout = mapping_comparison.METRICS_HEADER).
The index build, both classifications and the dynamic index run on
`device` (default cuda), through the port's Classifier and Dynamic.
"""

from __future__ import annotations

import os
import tempfile
from typing import Dict, List, Optional, Tuple

import numpy as np

from .mapping_comparison import GENUS_DEPTH, SPECIES_DEPTH

_LUT = np.frombuffer(b"ACGT", dtype=np.uint8)


def _gen(rng, n: int) -> str:
    return _LUT[rng.integers(0, 4, n)].tobytes().decode()


def _mutate(rng, seq: str, rate: float) -> str:
    arr = np.frombuffer(seq.encode(), np.uint8).copy()
    pos = rng.random(len(arr)) < rate
    arr[pos] = _LUT[rng.integers(0, 4, pos.sum())]
    return arr.tobytes().decode()


def build_community(rng, n_genera: int, genome_len: int, shared_frac: float = 0.7):
    """Taxonomy of n_genera x 2 sibling species; siblings share
    `shared_frac` of their genome (the 2-step experiment's confusion
    source). Returns (taxonomy, [(taxon, genome)])."""
    from ..taxonomy import Taxonomy

    nodes = [(1, 1, "root")]
    for g in range(n_genera):
        nodes.append((10 + g, 1, "genus"))
        nodes.append((100 + 2 * g, 10 + g, "species"))
        nodes.append((101 + 2 * g, 10 + g, "species"))
    tax = Taxonomy.from_nodes_and_names(nodes, [(t, f"n{t}") for t, _, _ in nodes])

    shared = int(genome_len * shared_frac)
    genomes = []
    for g in range(n_genera):
        core = _gen(rng, shared)
        genomes.append((100 + 2 * g, core + _gen(rng, genome_len - shared)))
        genomes.append((101 + 2 * g, core + _gen(rng, genome_len - shared)))
    return tax, genomes


def sample_reads(rng, genomes, present, n_reads: int, read_len: int = 150,
                 mutation_rate: float = 0.02):
    """Mutated reads uniformly from the `present` species; returns
    (fragments, {read_id: true taxon})."""
    from ..classify import Fragment

    by_taxon = dict(genomes)
    frags, truth = [], {}
    for i in range(n_reads):
        src = present[i % len(present)]
        g = by_taxon[src]
        s = int(rng.integers(0, len(g) - read_len))
        frags.append(Fragment(f"read{i}", _mutate(rng, g[s : s + read_len], mutation_rate)))
        truth[f"read{i}"] = src
    return frags, truth


def run_experiment(
    out_tsv: Optional[str] = None,
    n_genera: int = 10,
    genome_len: int = 1_500_000,
    n_present: int = 5,
    n_reads: int = 20_000,
    thresholds: Tuple[float, ...] = (0.0, 0.05, 0.15),
    detect_count: int = 100,
    detect_confidence: float = 0.15,
    seed: int = 11,
    group: str = "sibling70",
    device="cuda",
) -> List[dict]:
    """Run the full 1-step / 2-step / gold-set experiment and score it.

    Returns one row dict per (mode, confidence, rank); writes an
    All_metrics-style TSV to `out_tsv` when given. Every random choice
    derives from `seed`, so the corpus is exactly reproducible. The 2-step
    mode's taxon set file goes to a temporary directory."""
    from .mapping_comparison import MappingComparison
    from ..classify import Classifier, ClassifyParams
    from ..dynamic import ClassifiedReadCount, Dynamic
    from ..index import IndexParams, KeyValueIndex
    from .. import get_device
    from ..workloads import GenomeList
    from ..taxonomy import NONE

    device = get_device(device)
    rng = np.random.default_rng(seed)
    tax, genomes = build_community(rng, n_genera, genome_len)
    params = IndexParams()
    idx = KeyValueIndex.build(
        genomes, params, tax, device, batch_rows=64, row_len=1 << 16, keep_records=True
    )

    present = sorted(
        rng.choice([t for t, _ in genomes], size=n_present, replace=False).tolist()
    )
    frags, truth = sample_reads(rng, genomes, present, n_reads)

    cpar = ClassifyParams(thresholds=list(thresholds), per_read_output=False)
    runs: Dict[str, Dict[float, list]] = {}
    runs["1step"] = Classifier(idx, device).classify(frags, cpar)

    # 2-step: detect the taxon set from the sample, rebuild, re-classify
    # (Dynamic.scala:320-374; the detection pass uses the first threshold's
    # confidence for its ClassifiedReadCount criterion)
    with tempfile.TemporaryDirectory() as work:
        dyn = Dynamic(
            idx, GenomeList(genomes), SPECIES_DEPTH,
            ClassifiedReadCount(detect_count, detect_confidence),
            cpar, None, os.path.join(work, "accuracy_corpus"), device,
        )
        dyn_idx, detected = dyn.make_records(frags)
    runs["2step"] = Classifier(dyn_idx, device).classify(frags, cpar)

    # gold set: dynamic index from the TRUE taxon set (the reference's
    # -gold mode upper bound, Dynamic.scala:179-204)
    gold_idx = idx.build_restricted(tax.taxa_with_descendants(set(present)))
    runs["gold"] = Classifier(gold_idx, device).classify(frags, cpar)

    mc = MappingComparison(tax, 2, 3, False, min_count_taxon=10)
    rows: List[dict] = []
    for library, by_conf in runs.items():
        for c in thresholds:
            cmp_data = {r.title: (r.taxon if r.classified else NONE) for r in by_conf[c]}
            for rank_name, depth in (("Genus", GENUS_DEPTH), ("Species", SPECIES_DEPTH)):
                pt = mc.per_taxon(cmp_data, truth, depth)
                pr = mc.per_read(cmp_data, truth, depth)
                rows.append(
                    {
                        "title": f"synthetic/{group}/S0_{library}_c{c}",
                        "family": "synthetic",
                        "group": group,
                        "sample": "S0",
                        "library": library,
                        "k": params.k,
                        "m": params.m,
                        "frequency": 0,
                        "fl": 0,
                        "s": params.spaces,
                        "c": c,
                        "rank": rank_name,
                        "per_taxon": pt,
                        "per_read": pr,
                    }
                )

    if out_tsv:
        from .mapping_comparison import METRICS_HEADER

        os.makedirs(os.path.dirname(out_tsv) or ".", exist_ok=True)
        with open(out_tsv, "w") as f:
            f.write(METRICS_HEADER + "\n")
            for r in rows:
                pre = "\t".join(
                    str(r[k])
                    for k in (
                        "title", "family", "group", "sample", "library",
                        "k", "m", "frequency", "fl", "s", "c", "rank",
                    )
                )
                f.write(f"{pre}\t{r['per_taxon'].tsv()}\t{r['per_read'].tsv()}\n")
    return rows
