"""Classify traffic: paired FASTQ samples written at set-up, each request
one sample streamed from its files by the CLI's reader
(inputs.packed_pairs_from_files) into Classifier.classify_and_write_packed,
kreports (and, in per-read mode, gzip per-read files) written and closed
inside the request. Samples are cycled.

Traffic parameters: per_read_output, thresholds, pairs_per_sample, samples,
lines_compared_per_sample (per-read lines compared in each request, drawn
from the seed), trace_requests.

The check compares, once the window has closed: the index built at set-up
with the reference's, key for key; every completed request's kreports at
every threshold with the reference's, line for line; and in per-read mode,
in every completed request, the per-read file of one threshold (request i
takes threshold (i // samples) mod thresholds, so that every sample meets
every threshold): its number of lines, and a sample of its lines drawn from
the seed, with the reference's.
"""

from __future__ import annotations

import glob
import gzip
import os
import shutil
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from ..gen import reads as simulator
from ..gen.libraries import encode
from ..pbcore.log import Phases
from ..pbcore.trace import span
from ..reference import classify as ref
from ..reference.minimizers import MinimizerSpec
from . import common


def _timed(stream, seconds: List[float]):
    """The stream, with the time spent inside each next() added to
    seconds[0] (input parsing, wherever the consumer's thread runs it)."""
    it = iter(stream)
    while True:
        t = time.perf_counter()
        try:
            x = next(it)
        except StopIteration:
            seconds[0] += time.perf_counter() - t
            return
        seconds[0] += time.perf_counter() - t
        yield x


class Traffic:
    def __init__(self, ctx):
        self.ctx = ctx
        self.config, self.traffic = ctx.cell.config, ctx.cell.traffic
        self.thresholds = [float(t) for t in self.traffic["thresholds"]]
        self.per_read = bool(self.traffic["per_read_output"])
        self.n_pairs = int(self.traffic["pairs_per_sample"])
        self.n_samples = int(self.traffic["samples"])
        self.outputs: Dict[int, str] = {}
        self.parse_s: Dict[int, float] = {}
        self.done: List[dict] = []
        self.memfds: List[int] = []  # the sample files' memory, closed with the window
        self.memory_files = None

    # -- set-up ---------------------------------------------------------------

    def setup(self):
        from slacken_tpu_torch.classify import Classifier, ClassifyParams

        ctx, cfg = self.ctx, self.config
        step = Phases("set-up")
        self.genomes = common.library(cfg, ctx.seed)
        step("library")
        if ctx.control:
            self.samples = self._write_samples()
            self.control = self.reference(ctx.control)
            return
        self.taxonomy = common.program_taxonomy(cfg)
        self.index = common.build_program_index(self.genomes, cfg, self.taxonomy, ctx.device)
        step("index build")
        self.classifier = Classifier(self.index, ctx.device, probe=cfg["index"]["probe"])
        self.cpar = ClassifyParams(min_hit_groups=int(cfg["classify"]["min_hit_groups"]),
                                   with_unclassified=bool(cfg["classify"]["with_unclassified"]),
                                   thresholds=self.thresholds, per_read_output=self.per_read)
        self.samples = self._write_samples()
        step("samples")
        for j in range(self.n_samples):  # every sample's files and batches once, as the window will read them
            self._request(j, os.path.join(ctx.workdir, "warm", "out"))
            shutil.rmtree(os.path.join(ctx.workdir, "warm"), ignore_errors=True)
            step(f"warm-up request {j}")

    def _write_samples(self):
        """The samples' FASTQ files and the mates' codes: each sample with
        log-normal abundances of its own (the same for every seed), pairs
        from the library and a share from genomes outside it."""
        r = self.config["reads"]
        codes = [encode(seq) for _, seq in self.genomes]
        g_out = common.rng(self.ctx.seed, common.OUTSIDE)
        outside = [g_out.integers(0, 4, int(r["outside_bp"])).astype(np.uint8)
                   for _ in range(int(r["outside_genomes"]))]
        g = common.rng(self.ctx.seed, common.READS)
        samples = []
        for j in range(self.n_samples):
            ab = simulator.profile(len(codes), float(r["abundance_mu"]), float(r["abundance_sigma"]), j)
            p = simulator.simulate(g, codes, outside, ab, self.n_pairs, int(r["read_len"]), float(r["frag_mean"]),
                                   float(r["frag_sd"]), float(r["sub_rate"]), float(r["outside_share"]),
                                   float(r["n_rate"]), float(r["n_run_share"]), r["n_run_len"])
            prefix = f"s{j}r"
            files = []
            for mate, m in ((1, p.mate1), (2, p.mate2)):
                path = os.path.join(self.ctx.workdir, f"sample{j}_{mate}.fq")
                self._write_input(path, simulator.fastq_bytes(prefix, m))
                files.append(path)
            samples.append({"files": files, "pairs": p, "prefix": prefix})
        print(f"portbench: set-up: sample files {'in memory' if self.memory_files else 'on disk'}", file=sys.stderr)
        return samples

    def _write_input(self, path: str, data: bytes) -> None:
        """A sample file at `path`. Its bytes stay in memory, as a file that
        was read before sits in the page cache: an anonymous memory file
        (memfd) that `path` links to, so that the reader opens it by its
        name. Where the host cannot give that (memory_files), a file on
        disk, written back in set-up, not during the window."""
        if self.memory_files is None:
            self.memory_files = memory_files(self.ctx.workdir)
        if not self.memory_files:
            with open(path, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            return
        fd = os.memfd_create(os.path.basename(path))
        self.memfds.append(fd)
        with open(fd, "wb", closefd=False) as f:
            f.write(data)
        os.symlink(f"/proc/self/fd/{fd}", path)

    # -- the window -------------------------------------------------------------

    def _request(self, j: int, out: str) -> float:
        from slacken_tpu_torch.inputs import packed_pairs_from_files

        seconds = [0.0]
        stream = _timed(packed_pairs_from_files(*self.samples[j]["files"]), seconds)
        with span("classify request"):
            self.classifier.classify_and_write_packed(stream, out, self.cpar)
        return seconds[0]

    def request(self, i: int, traced: bool = False):
        out = os.path.join(self.ctx.workdir, f"req{i:05d}", "out")
        if self.ctx.control:
            self._control_request(i % self.n_samples, out)
        else:
            self.parse_s[i] = self._request(i % self.n_samples, out)
        self.outputs[i] = out
        return self.n_pairs

    def _control_request(self, j: int, out: str):
        """The control's outputs of sample j, in the program's layout."""
        index, per_sample, spec = self.control
        c = per_sample[j]["classified"]
        for t, thr in enumerate(self.thresholds):
            d = f"{out}_c{thr!r}"
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, "all_kreport.txt"), "w") as f:
                f.write("\n".join(per_sample[j]["kreports"][t]) + "\n")
            if self.per_read:
                os.makedirs(os.path.join(d, "sample=all"))
                if "hits" not in per_sample[j]:
                    wt = c.window_taxa.cpu().numpy()
                    per_sample[j]["hits"] = [ref.hit_string(w, spec.k) for w in wt]
                titles = simulator.titles(self.samples[j]["prefix"], self.n_pairs)
                with gzip.open(os.path.join(d, "sample=all", "part-00000.txt.gz"), "wt", compresslevel=1) as f:
                    f.write("".join(ref.read_line(title, int(c.taxa[t, r]), None, 0, hits=per_sample[j]["hits"][r])
                                    + "\n" for r, title in enumerate(titles)))

    def close_window(self, done: List[dict]):
        """Keep the program's index for the check; free the classifier."""
        self.done = done
        for fd in self.memfds:
            os.close(fd)
        self.memfds = []
        if self.ctx.control:
            self.port_keys, self.port_taxa = self.control[0].keys, self.control[0].taxa
            return
        self.port_keys, self.port_taxa = self.index.keys_t, self.index.taxa_t
        del self.classifier
        self.index = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def end_to_end(self, done: List[dict], elapsed: float) -> dict:
        return {"reads_per_s": sum(d["units"] for d in done) / elapsed}

    # -- the check --------------------------------------------------------------

    def reference(self, drop_bits: int = 0):
        """The reference's index and, for each sample, its classification
        and kreports at every threshold."""
        cfg, dev = self.config, self.ctx.device
        tree = common.reference_tree(cfg)
        spec = MinimizerSpec.of(cfg)
        index = common.reference_index(self.genomes, cfg, tree, dev, drop_bits)
        per_sample = []
        for s in self.samples:
            c = ref.classify_pairs(s["pairs"].mate1, s["pairs"].mate2, index, spec, tree, self.thresholds,
                                   int(cfg["classify"]["min_hit_groups"]), dev)
            per_sample.append({"classified": c, "kreports": [ref.kreport_lines(tree, c.taxa[t])
                                                             for t in range(len(self.thresholds))]})
        return index, per_sample, spec

    def check(self):
        step = Phases("check")
        index, per_sample, spec = self.reference()
        step("reference")
        self.per_sample = per_sample
        checks = compare(self, index, per_sample, spec)
        step("comparison")
        return checks

    def layer_context(self, traced: List[int]) -> dict:
        """What the readers of the classify metrics need, for the traced
        requests: reads, bases, distinct minimizers of each request's
        sample, thresholds, and the seconds spent parsing input."""
        R = int(self.config["reads"]["read_len"])
        return {
            "reads": [self.n_pairs for _ in traced],
            "bases": [2 * R * self.n_pairs for _ in traced],
            "distinct_minimizers": [self.per_sample[i % self.n_samples]["classified"].distinct_minimizers
                                    for i in traced],
            "thresholds": len(self.thresholds),
            "parse_s": [self.parse_s[i] for i in traced if i in self.parse_s],
        }


def memory_files(workdir: str) -> bool:
    """Whether a memory file linked from `workdir` reads back by its name."""
    data, link, fd = b"@r\nACGT\n+\nIIII\n", os.path.join(workdir, "probe.fq"), None
    try:
        fd = os.memfd_create("probe.fq")
        os.write(fd, data)
        os.symlink(f"/proc/self/fd/{fd}", link)
        with open(link, "rb") as f:
            return f.read() == data
    except (AttributeError, OSError):
        return False
    finally:
        if os.path.islink(link):
            os.unlink(link)
        if fd is not None:
            os.close(fd)


def compare(drv: Traffic, index, per_sample, spec) -> list:
    """(name, value, limit) of each number compared, every one exact."""
    checks = [("index_diff", common.index_diff(drv.port_keys, drv.port_taxa, index), 0)]
    kreport_diff = line_diff = 0
    n_lines = int(drv.traffic.get("lines_compared_per_sample", 0))
    picks = {}
    if drv.per_read and n_lines:
        g = common.rng(drv.ctx.seed, common.SAMPLE)
        picks = {j: np.sort(g.choice(drv.n_pairs, min(n_lines, drv.n_pairs), replace=False))
                 for j in range(drv.n_samples)}
    hits: Dict[int, Dict[int, str]] = {}
    for d in drv.done:
        i = d["i"]
        j = i % drv.n_samples
        out = drv.outputs[i]
        for t, lines in enumerate(per_sample[j]["kreports"]):
            kreport_diff += _lines_differ(_read(_threshold_dir(out, drv.thresholds, t), "all_kreport.txt"), lines)
        if drv.per_read:
            t = (i // drv.n_samples) % len(drv.thresholds)
            got = _per_read_lines(_threshold_dir(out, drv.thresholds, t))
            if j not in hits:
                hits[j] = _hit_strings(per_sample[j]["classified"], picks.get(j, []), spec.k)
            line_diff += abs(len(got) - drv.n_pairs) + _picked_lines_differ(
                got, drv, per_sample[j]["classified"].taxa[t], j, hits[j])
        shutil.rmtree(os.path.dirname(out), ignore_errors=True)
    checks.append(("kreport_diff", kreport_diff, 0))
    if drv.per_read:
        checks.append(("line_diff", line_diff, 0))
    return checks


def _threshold_dir(out: str, thresholds: List[float], t: int) -> str:
    """The output directory of threshold t: <out>_c<threshold>, found by
    its value whatever its decimals."""
    dirs = {float(p[len(out) + 2 :]): p for p in glob.glob(out + "_c*")}
    return dirs.get(thresholds[t], out + "_c(missing)")


def _read(directory: str, name: str) -> List[str]:
    path = os.path.join(directory, name)
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return f.read().splitlines()


def _lines_differ(got: List[str], want: List[str]) -> int:
    return abs(len(got) - len(want)) + sum(a != b for a, b in zip(got, want))


def _per_read_lines(directory: str) -> List[str]:
    """Every line of the per-read files under a threshold's directory, in
    the files' order."""
    out: List[str] = []
    for path in sorted(glob.glob(os.path.join(directory, "sample=*", "*.txt.gz"))):
        with gzip.open(path, "rb") as f:
            out += f.read().decode().splitlines()
    return out


def _hit_strings(c, picks, k: int) -> Dict[int, str]:
    """{read: the threshold-free tail of its line} of the picked reads."""
    idx = torch.as_tensor(np.asarray(picks, np.int64), device=c.window_taxa.device)
    wt = c.window_taxa[idx].cpu().numpy()
    return {int(r): ref.hit_string(wt[n], k) for n, r in enumerate(picks)}


def _picked_lines_differ(got: List[str], drv: Traffic, taxa: np.ndarray, j: int, hits: Dict[int, str]) -> int:
    """Picked reads whose line differs from the reference's, each found at
    its read's place in the file or else by its title."""
    prefix = drv.samples[j]["prefix"]
    by_title = None
    bad = 0
    for r, tail in hits.items():
        title = simulator.title(prefix, r)
        want = ref.read_line(title, int(taxa[r]), None, 0, hits=tail)
        if r < len(got) and got[r] == want:
            continue
        if by_title is None:
            by_title = {x.split("\t", 2)[1] if x.count("\t") >= 2 else x: x for x in got}
        bad += by_title.get(title) != want
    return bad
