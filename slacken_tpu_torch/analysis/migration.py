"""Index-vs-index minimizer migration comparison (counterpart of
slacken_tpu/analysis/migration.py; reference:
analysis/MinimizerMigration.scala): join two indexes on the minimizer and
histogram how far each LCA moved up the tree.

The join runs on the device: every key of `index` is probed in
`reference`'s sorted keys through its prefix directory (the probe kernel on
the card, `probe_wide` for wide keys, the twin on the CPU). A key is shared
where the probe finds a taxon: no index stores taxon 0. The index's keys
are sorted, so the shared keys come in sorted order, as a sorted-array
intersection gives them.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .. import get_device
from ..ops.lookup import probe
from ..report import KrakenReport
from ..taxonomy import ROOT

CELLULAR_ORGANISMS = 131567  # MinimizerMigration.scala:76


class MinimizerMigration:
    def __init__(self, index, reference, device="cuda"):
        self.index = index
        self.reference = reference
        self.device = get_device(device)

    def taxa_distances(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(taxon in index, taxon in reference, steps moved up) for the
        shared minimizers, in key order, as host arrays."""
        keys, taxa, directory = self.reference.device_arrays(self.device)
        queries = self.index.keys_t.to(self.device).contiguous()
        looked = probe(keys, taxa, directory, queries)
        found = looked > 0
        a = self.index.taxa_t.to(self.device)[found]
        b = looked[found]
        depth = torch.from_numpy(self.reference.taxonomy.depth_std.astype(np.int32)).to(self.device)
        d1, d2 = depth[a.long()], depth[b.long()]
        steps = torch.where(d1 == -1, -100, torch.where(d2 == -1, -200, d1 - d2))
        return a.cpu().numpy(), b.cpu().numpy(), steps.cpu().numpy()

    def run(self, output: str):
        a, b, steps = self.taxa_distances()
        hist: Dict[int, int] = {}
        for s, c in zip(*np.unique(steps, return_counts=True)):
            hist[int(s)] = int(c)
        print("steps\tcount")
        for s in sorted(hist):
            print(f"{s}\t{hist[s]}")

        # records that migrated to ROOT/cellular organisms ("almost nothing
        # known") in the reference (MinimizerMigration.scala:74-84)
        to_root = (np.isin(b, [ROOT, CELLULAR_ORGANISMS])) & ~np.isin(
            a, [ROOT, CELLULAR_ORGANISMS]
        )
        vals, counts = np.unique(a[to_root], return_counts=True)
        report = KrakenReport(
            self.index.taxonomy, [(int(v), int(c)) for v, c in zip(vals, counts)]
        )
        report.write(output + "_taxaToRoot_report.txt")
        return hist
