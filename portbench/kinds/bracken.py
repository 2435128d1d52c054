"""Bracken weight traffic: the program's index of the deployment's library
built at set-up; each request is BrackenWeights.build_weights over the
library for one chunk of the taxon set, the chunks cycled. With "chunks":
"family", a chunk is the species of one family of the taxonomy, as
Slacken's buildWeightsGradually splits the taxon set into parts.

Traffic parameters: chunks, trace_requests. The read length is the
deployment's (reads.read_len).

The check compares, once the window has closed, the index built at set-up
with the reference's, and every completed request's (destination, source)
read counts with the reference's for its chunk.
"""

from __future__ import annotations

from typing import Dict, List, Set

from ..pbcore.log import Phases
from ..pbcore.trace import span
from ..reference import bracken as ref
from ..reference.minimizers import MinimizerSpec
from . import common


def family_chunks(nodes) -> List[Set[int]]:
    """The species of each family, families in taxid order."""
    parent = {t: p for t, p, _ in nodes}
    rank = {t: r for t, _, r in nodes}
    fams: Dict[int, Set[int]] = {}
    for t, _, r in nodes:
        if r == "species":
            f = t
            while rank.get(f) != "family" and f != 1:
                f = parent[f]
            fams.setdefault(f, set()).add(t)
    return [fams[f] for f in sorted(fams)]


class Traffic:
    def __init__(self, ctx):
        self.ctx = ctx
        self.config, self.traffic = ctx.cell.config, ctx.cell.traffic
        self.read_len = int(self.config["reads"]["read_len"])
        self.results = {}

    def setup(self):
        ctx, cfg = self.ctx, self.config
        if self.traffic["chunks"] != "family":
            raise ValueError(f"unknown chunking {self.traffic['chunks']!r}")
        step = Phases("set-up")
        self.genomes = common.library(cfg, ctx.seed)
        step("library")
        self.chunks = family_chunks(common.tree_tuples(cfg)[0])
        self.windows = [sum(max(len(s) - self.read_len + 1, 0) for t, s in self.genomes if t in c)
                        for c in self.chunks]
        if ctx.control:
            self.tree = common.reference_tree(cfg)
            self.control_index = common.reference_index(self.genomes, cfg, self.tree, ctx.device, ctx.control)
        else:
            from slacken_tpu_torch.bracken import BrackenWeights

            taxonomy = common.program_taxonomy(cfg)
            self.index = common.build_program_index(self.genomes, cfg, taxonomy, ctx.device)
            self.weights = BrackenWeights(self.index, self.read_len, ctx.device)
        step("index build")
        self._weights(0)
        step("warm-up request")

    def _weights(self, c: int) -> dict:
        if self.ctx.control:
            return ref.weights(self.genomes, self.chunks[c], self.control_index, MinimizerSpec.of(self.config),
                               self.tree, self.read_len, self.ctx.device)
        with span("bracken chunk"):
            return self.weights.build_weights(common.GenomeList(self.genomes), self.chunks[c])

    def request(self, i: int, traced: bool = False):
        c = i % len(self.chunks)
        self.results[i] = self._weights(c)
        return self.windows[c]

    def close_window(self, done: List[dict]):
        self.done = done
        if self.ctx.control:
            self.port_keys, self.port_taxa = self.control_index.keys, self.control_index.taxa
        else:
            self.port_keys, self.port_taxa = self.index.keys_t, self.index.taxa_t
            self.weights = self.index = None

    def end_to_end(self, done: List[dict], elapsed: float) -> dict:
        return {"bracken_mwindows_per_s": sum(d["units"] for d in done) / 1e6 / elapsed}

    def check(self):
        cfg, dev = self.config, self.ctx.device
        tree = common.reference_tree(cfg)
        index = common.reference_index(self.genomes, cfg, tree, dev)
        spec = MinimizerSpec.of(cfg)
        want: Dict[int, dict] = {}
        pairs_diff = 0
        for d in self.done:
            c = d["i"] % len(self.chunks)
            if c not in want:
                want[c] = ref.weights(self.genomes, self.chunks[c], index, spec, tree, self.read_len, dev)
            got = self.results[d["i"]]
            pairs_diff += sum(got.get(key) != n for key, n in want[c].items())
            pairs_diff += sum(key not in want[c] for key in got)
        return [("index_diff", common.index_diff(self.port_keys, self.port_taxa, index), 0),
                ("weights_diff", pairs_diff, 0)]

    def layer_context(self, traced: List[int]) -> dict:
        return {}
