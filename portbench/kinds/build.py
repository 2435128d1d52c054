"""Index build traffic: the deployment's library generated once at set-up
and held in host memory as the CLI holds a read FASTA; each request is
KeyValueIndex.build of the whole library on the device under the default
budget, the previous request's index freed first.

Traffic parameters: trace_requests.

The check compares, once the window has closed, every build's fingerprint
(records, and a position-weighted sum of keys and taxa, queued on the device
right after the build and read only after the window) with the reference
index's, and the last build's index with the reference's, record for record.
"""

from __future__ import annotations

import time
from typing import List

from ..pbcore.log import Phases
from ..pbcore.trace import span
from . import common


class Traffic:
    def __init__(self, ctx):
        self.ctx = ctx
        self.config = ctx.cell.config
        self.index = None
        self.fingerprints = {}
        self.peaks = {}
        self.phases = {}
        self.walls = {}

    def setup(self):
        ctx, cfg = self.ctx, self.config
        step = Phases("set-up")
        self.genomes = common.library(cfg, ctx.seed)
        self.bp = sum(len(s) for _, s in self.genomes)
        step("library")
        self.taxonomy = common.program_taxonomy(cfg)
        if ctx.control:
            self.tree = common.reference_tree(cfg)
        self._build(False)
        self.index = None
        step("warm-up build")

    def _build(self, traced: bool):
        if self.ctx.control:
            ref = common.reference_index(self.genomes, self.config, self.tree, self.ctx.device, self.ctx.control)
            self.index = _Records(ref.keys, ref.taxa)
            return
        with span("build request"):
            self.index = common.build_program_index(self.genomes, self.config, self.taxonomy, self.ctx.device,
                                                    trace=traced)

    def request(self, i: int, traced: bool = False):
        self.index = None  # the previous index is freed before the build
        t = time.perf_counter()
        self.peaks[i] = self.ctx.memory.request_peak(lambda: self._build(traced))
        self.walls[i] = time.perf_counter() - t
        if traced and getattr(self.index, "build_phases", None):
            self.phases[i] = dict(self.index.build_phases)
        self.fingerprints[i] = common.fingerprint(self.index.keys_t, self.index.taxa_t)
        return self.bp

    def close_window(self, done: List[dict]):
        self.done = done
        self.last = self.index
        self.index = None

    def end_to_end(self, done: List[dict], elapsed: float) -> dict:
        out = {"build_mbp_per_s": sum(d["units"] for d in done) / 1e6 / elapsed}
        if self.ctx.device.type == "cuda":
            out["build_peak_gib"] = max(self.peaks[d["i"]] for d in done) / (1 << 30)
        return out

    def check(self):
        cfg = self.config
        ref = common.reference_index(self.genomes, cfg, common.reference_tree(cfg), self.ctx.device)
        want = _read(common.fingerprint(ref.keys, ref.taxa))
        bad = sum(_read(self.fingerprints[d["i"]]) != want for d in self.done)
        last = self.last
        diff = common.index_diff(last.keys_t, last.taxa_t, ref) if last is not None else int(ref.keys.shape[0])
        return [("builds_differing", bad, 0), ("index_diff", diff, 0)]

    def layer_context(self, traced: List[int]) -> dict:
        return {"build_phases": [self.phases[i] for i in traced if i in self.phases],
                "build_walls": [self.walls[i] for i in traced if i in self.phases]}


def _read(fp):
    """A fingerprint as two numbers."""
    return fp[0], int(fp[1])


class _Records:
    """The control's index in the program index's attribute names."""

    def __init__(self, keys, taxa):
        self.keys_t, self.taxa_t = keys, taxa
