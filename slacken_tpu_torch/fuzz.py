"""Randomised end-to-end oracle fuzz of the port's classifier (counterpart
of scripts/oracle_fuzz.py).

Each iteration draws a random taxonomy, a genome library, index parameters
(k, m: narrow, boundary and wide; a spaced seed), a probe, three confidence
thresholds and a min-hit-groups gate, builds the index on the device and
classifies a batch of adversarial reads (mutated, N-riddled, random, paired,
shorter than k, exactly k, all N, and one of pieces of two genomes between N
stretches that runs over the cap of 16 hit runs). Every read's (classified,
taxon, hit_details, length_string) is held bit for bit to the naive
string-level oracle (oracle.py) at every threshold, through each entry
point:

  * `Classifier.classify` on the fragments;
  * `Classifier.classify_packed` on the same reads parsed from FASTQ bytes
    by native.pack_fastq_chunk (mates joined by native.pack_pairs), as the
    CLI packs them;
  * the files of `Classifier.classify_and_write`: every per-read line equals
    the Kraken line the oracle's answer formats to, and every threshold's
    kreport holds the unclassified row and each taxon's direct and clade
    read counts tallied from the oracle's answers over the taxonomy's
    parents;

each once with STPU_HIT_RUNS=0 (the dense window taxa) and once with
STPU_HIT_RUNS=1 (each row's hit runs; rows over the run cap take the dense
path). On the CPU an iteration sometimes runs over a mesh of 2 to 4 CPU
shards (ring or replicated); on the card only where there are several cards.

    python -m slacken_tpu_torch.fuzz [--minutes 30] [--seed 0]
        [--device cuda|cpu] [--probe P]

The first mismatch stops the run: it prints a JSON repro (seed, k, m, s,
probe, path, threshold, gate, read, got, want) and exits 1. A clean run
prints one JSON summary line. "cuda" without CUDA raises; nothing falls back
to the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import json
import os
import sys
import tempfile
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import get_device, native, oracle
from .classify import PROBES, WIDE_PROBES, Classifier, ClassifyParams, Fragment, format_threshold
from .index import IndexParams, KeyValueIndex
from .parallel.classifier import make_classifier
from .taxonomy import NONE, ROOT, Taxonomy

#: (k, m): narrow, boundary (m = 31 / 32) and wide, as scripts/oracle_fuzz.py
KM_CHOICES = [
    (21, 15), (31, 25), (35, 31), (35, 27), (45, 31), (45, 32),
    (45, 33), (51, 45), (63, 55),
]
#: the nine (probe, wide) choices: each narrow probe, each wide one
CHOICES = [(p, False) for p in PROBES] + [(p, True) for p in WIDE_PROBES]
#: the share of iterations that run over a mesh, where one can be drawn
MESH_SHARE = 0.25
#: the pieces of the edge read "manyruns", which runs over the cap of 16 hit runs
RUNS_PIECES = 18
#: the build's batch: several rows a genome (the k - 1 overlap split), few rows
BUILD_ROWS, BUILD_ROW_LEN = 16, 512


class FuzzMismatch(AssertionError):
    """A read (or a kreport) that differs from the oracle; `repro` is the
    JSON-ready dict that reproduces it."""

    def __init__(self, repro: dict):
        self.repro = repro
        super().__init__(json.dumps(repro))


@dataclass
class Case:
    """One iteration's draw: everything but the index."""

    it: int
    seed: int
    taxonomy: Taxonomy
    parents: Dict[int, int]
    genomes: List[Tuple[int, str]]
    k: int
    m: int
    s: int
    probe: str
    mhg: int
    confs: List[float]
    frags: List[Fragment]
    #: (shards, layout) of a mesh, or None for one device
    mesh: Optional[Tuple[int, str]]


def mesh_devices(device: torch.device) -> int:
    """The most shards an iteration's mesh may have: 4 CPU shards, or the
    cards up to 4 where there are at least two, else 0 (no mesh)."""
    if device.type == "cpu":
        return 4
    count = torch.cuda.device_count()
    return min(4, count) if count >= 2 else 0


def draw_case(it: int, seed: int, device: torch.device, probe: Optional[str] = None,
              wide: Optional[bool] = None) -> Case:
    """The draws of scripts/oracle_fuzz.py from `seed`: taxonomy, genomes,
    (k, m) (narrow or wide to match `probe` and `wide` where given), s, the
    probe (`probe`, or one that the drawn m takes), the gate, thresholds and
    reads; then whether a mesh runs it."""
    rng = np.random.default_rng(seed)
    t = oracle.random_taxonomy(rng, int(rng.integers(12, 60)))
    parents = {i: int(p) for i, p in enumerate(t.parents)}
    # at most one genome a leaf: scripts/oracle_fuzz.py draws up to 7 and
    # fails where the taxonomy has fewer leaves (seed 1619: 6)
    n_genomes = min(int(rng.integers(2, 8)), sum(t.is_leaf(x) for x in t.taxa()))
    glen = int(rng.integers(300, 1500))
    genomes = oracle.make_genomes(rng, t, n_genomes=n_genomes, length=glen)
    kms = [(k, m) for k, m in KM_CHOICES
           if (wide is None or (m > 31) == wide) and (probe is None or m <= 31 or probe in WIDE_PROBES)]
    k, m = kms[int(rng.integers(len(kms)))]
    s = int(rng.choice([0, 3, 7]))
    probes = PROBES if m <= 31 else WIDE_PROBES
    drawn = probes[int(rng.integers(len(probes)))]
    probe = drawn if probe is None else probe
    mhg = int(rng.choice([1, 2, 3]))
    confs = sorted({float(c) for c in rng.choice([0.0, 0.05, 0.15, 0.3, 0.6, 0.9], 3)})

    frags = []
    for i in range(int(rng.integers(10, 36))):
        _, g = genomes[int(rng.integers(len(genomes)))]
        length = int(rng.integers(max(4, k - 6), min(len(g), 240)))
        start = int(rng.integers(0, max(1, len(g) - length)))
        seq = g[start : start + length]
        r = rng.random()
        if r < 0.15:
            seq = oracle.random_genome(rng, length)  # unclassifiable
        elif r < 0.35:
            chars = list(seq)
            for p in rng.integers(0, len(seq), int(rng.integers(1, 12))):
                chars[int(p)] = "N"
            seq = "".join(chars)
        elif r < 0.45:
            chars = list(seq)  # point mutations
            for p in rng.integers(0, len(seq), int(rng.integers(1, 6))):
                chars[int(p)] = "ACGT"[int(rng.integers(4))]
            seq = "".join(chars)
        if rng.random() < 0.3:
            _, g2 = genomes[int(rng.integers(len(genomes)))]
            s2 = int(rng.integers(0, max(1, len(g2) - 90)))
            frags.append(Fragment(f"r{i}", seq, g2[s2 : s2 + 90]))
        else:
            frags.append(Fragment(f"r{i}", seq))
    frags.append(Fragment("short", "ACGTACG"))
    frags.append(Fragment("allN", "N" * int(rng.integers(10, 90))))
    frags.append(Fragment("kminus1", genomes[0][1][: k - 1]))
    frags.append(Fragment("exactk", genomes[0][1][:k]))
    # over the hit-runs cap: pieces of two genomes in turn, each at least k
    # long, between N stretches of 1 to k + 3 (an ambiguous run from k on)
    pieces = []
    for j in range(RUNS_PIECES):
        g = genomes[j % min(2, len(genomes))][1]
        length = k + int(rng.integers(0, 8))
        start = int(rng.integers(0, len(g) - length))
        pieces.append(g[start : start + length])
    gaps = ["N" * int(rng.integers(1, k + 4)) for _ in range(RUNS_PIECES - 1)]
    frags.append(Fragment("manyruns", "".join(p + n for p, n in zip(pieces, gaps + [""]))))

    mesh = None
    most = mesh_devices(device)
    if most >= 2 and rng.random() < MESH_SHARE:
        mesh = (int(rng.integers(2, most + 1)), ("ring", "replicated")[int(rng.integers(2))])
    return Case(it, seed, t, parents, genomes, k, m, s, probe, mhg, confs, frags, mesh)


def build_index(case: Case, device: torch.device) -> KeyValueIndex:
    """The case's index, built on `device` from its genomes."""
    params = IndexParams(k=case.k, m=case.m, spaces=case.s)
    return KeyValueIndex.build(case.genomes, params, case.taxonomy, device,
                               batch_rows=BUILD_ROWS, row_len=BUILD_ROW_LEN)


def fastq_packs(frags: List[Fragment]) -> List[native.PackedReads]:
    """The fragments as the CLI packs them: the singles parsed from FASTQ
    bytes, the pairs from two mate files' bytes joined by pack_pairs."""

    def parse(titled_seqs):
        buf = "".join(f"@{t}\n{q}\n+\n{'I' * len(q)}\n" for t, q in titled_seqs).encode("ascii")
        packed, used = native.pack_fastq_chunk(buf)
        assert used == len(buf) and len(packed) == len(titled_seqs), (used, len(buf))
        return packed

    singles = [f for f in frags if f.seq2 is None]
    pairs = [f for f in frags if f.seq2 is not None]
    packs = []
    if singles:
        packs.append(parse([(f.title, f.seq) for f in singles]))
    if pairs:
        packs.append(native.pack_pairs(parse([(f.title, f.seq) for f in pairs]),
                                       parse([(f.title, f.seq2) for f in pairs])))
    return packs


def kraken_line(title: str, answer: tuple) -> str:
    """The per-read Kraken line of an oracle answer."""
    classified, taxon, details, lengths = answer
    return f"{'C' if classified else 'U'}\t{title}\t{taxon}\t{lengths}\t{details}"


def oracle_report(parents: Dict[int, int], taxa: List[int]) -> Dict[int, Tuple[int, int]]:
    """{taxon: (clade reads, direct reads)} of the rows a kreport holds for
    reads classified to `taxa` (NONE for unclassified), tallied over the
    parents: the unclassified row where a read is unclassified, the root,
    and every taxon whose clade holds a read."""
    direct: Dict[int, int] = {}
    for t in taxa:
        direct[t] = direct.get(t, 0) + 1
    clade: Dict[int, int] = {}
    for t, n in direct.items():
        x = t
        if x == NONE:
            clade[NONE] = clade.get(NONE, 0) + n
        while x != NONE:
            clade[x] = clade.get(x, 0) + n
            x = parents[x]
    rows = {t: (c, direct.get(t, 0)) for t, c in clade.items()}
    rows.setdefault(ROOT, (0, 0))
    return rows


def report_rows(path: str) -> Dict[int, Tuple[int, int]]:
    """{taxon: (clade reads, direct reads)} of a written kreport's rows."""
    rows = {}
    with open(path) as f:
        for line in f.read().splitlines()[1:]:
            cols = line.split("\t")
            rows[int(cols[4])] = (int(cols[1]), int(cols[2]))
    return rows


@contextlib.contextmanager
def hit_runs_env(mode: int):
    """STPU_HIT_RUNS=`mode` while the block runs (Classifier reads it at
    construction), the caller's value after."""
    saved = os.environ.get("STPU_HIT_RUNS")
    os.environ["STPU_HIT_RUNS"] = str(mode)
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("STPU_HIT_RUNS", None)
        else:
            os.environ["STPU_HIT_RUNS"] = saved


def check_case(case: Case, index: KeyValueIndex, device: torch.device, out: Optional[str] = None) -> int:
    """Hold every entry point on `device` to the oracle for the case, dense
    and under hit runs. Returns the number of comparisons: a read's answer
    through classify, classify_packed and its per-read line, and each
    kreport, for every threshold in both modes. Raises FuzzMismatch on the
    first difference."""
    k, m, s = case.k, case.m, case.s
    idx_map = oracle.oracle_index(case.genomes, k, m, s, case.parents)
    want = {conf: [oracle.oracle_classify(f.seq, f.seq2, idx_map, case.parents, k, m, s, conf, case.mhg)
                   for f in case.frags] for conf in case.confs}
    cpar = ClassifyParams(thresholds=case.confs, min_hit_groups=case.mhg)
    packs = fastq_packs(case.frags)
    checked = 0

    def mismatch(path, runs, conf, frag, got, expected):
        raise FuzzMismatch({
            "MISMATCH": True, "iteration": case.it, "seed": case.seed, "k": k, "m": m, "s": s,
            "probe": case.probe, "mesh": case.mesh, "path": path, "hit_runs": runs, "threshold": conf,
            "gate": case.mhg, "title": frag and frag.title, "seq": frag and frag.seq,
            "seq2": frag and frag.seq2, "got": got, "want": expected})

    with contextlib.ExitStack() as stack:
        if out is None:
            out = stack.enter_context(tempfile.TemporaryDirectory(prefix="stpu_fuzz_"))
        for runs in (0, 1):
            with hit_runs_env(runs):
                if case.mesh is None:
                    cls = Classifier(index, device, probe=case.probe)
                else:
                    cls = make_classifier(index, device, devices=case.mesh[0], layout=case.mesh[1],
                                          probe=case.probe)
            res = cls.classify(case.frags, cpar)
            pres = cls.classify_packed(iter(packs), cpar)
            prefix = os.path.join(out, f"it{case.it}_runs{runs}")
            cls.classify_and_write(case.frags, prefix, cpar)
            for conf in case.confs:
                by_title = {r.title: r for r in pres[conf]}
                if len(res[conf]) != len(case.frags) or len(by_title) != len(case.frags):
                    mismatch("read count", runs, conf, None, [len(res[conf]), len(by_title)], len(case.frags))
                for f, r, w in zip(case.frags, res[conf], want[conf]):
                    got = (r.classified, r.taxon, r.hit_details, r.length_string)
                    if r.title != f.title:
                        mismatch("classify order", runs, conf, f, r.title, f.title)
                    if got != w:
                        mismatch("classify", runs, conf, f, got, w)
                    p = by_title.get(f.title)
                    got = p and (p.classified, p.taxon, p.hit_details, p.length_string)
                    if got != w:
                        mismatch("classify_packed", runs, conf, f, got, w)
                    checked += 2
                loc = prefix + "_c" + format_threshold(conf, case.confs)
                with gzip.open(os.path.join(loc, "sample=all", "part-00000.txt.gz"), "rt") as fh:
                    lines = fh.read().splitlines()
                for i, f in enumerate(case.frags):
                    line = lines[i] if i < len(lines) else None
                    if line != kraken_line(f.title, want[conf][i]):
                        mismatch("per-read file", runs, conf, f, line, kraken_line(f.title, want[conf][i]))
                    checked += 1
                if len(lines) != len(case.frags):
                    mismatch("per-read file", runs, conf, None, len(lines), len(case.frags))
                rows = report_rows(os.path.join(loc, "all_kreport.txt"))
                expected = oracle_report(case.parents, [w[1] for w in want[conf]])
                if rows != expected:
                    mismatch("kreport", runs, conf, None, sorted(rows.items()), sorted(expected.items()))
                checked += 1
    return checked


def fuzz_iteration(it: int, seed: int, device, probe: Optional[str] = None, wide: Optional[bool] = None,
                   out: Optional[str] = None) -> dict:
    """One iteration from `seed` on `device` (probe and key width drawn, or
    as given). Returns what was drawn and the number of checks; raises
    FuzzMismatch on the first difference from the oracle. "checks" counts
    (read, threshold) pairs, as scripts/oracle_fuzz.py does; "comparisons"
    counts check_case's."""
    device = get_device(str(device))
    case = draw_case(it, seed, device, probe, wide)
    index = build_index(case, device)
    comparisons = check_case(case, index, device, out)
    return {"seed": seed, "k": case.k, "m": case.m, "s": case.s, "probe": case.probe, "mesh": case.mesh,
            "reads": len(case.frags), "thresholds": len(case.confs), "checks": len(case.frags) * len(case.confs),
            "comparisons": comparisons}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m slacken_tpu_torch.fuzz",
                                 description="Randomised end-to-end oracle fuzz of the classifier.")
    ap.add_argument("--minutes", type=float, default=30.0,
                    help="run iterations until this many minutes have passed (at least one)")
    ap.add_argument("--seed", type=int, default=0, help="iteration i draws from seed + i")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--probe", choices=PROBES, default=None, help="force the probe (default: drawn)")
    args = ap.parse_args(argv)
    device = get_device(args.device)
    t0 = time.time()
    it = checks = comparisons = meshes = 0
    while it == 0 or time.time() - t0 < args.minutes * 60:
        try:
            r = fuzz_iteration(it, args.seed + it, device, args.probe)
        except FuzzMismatch as e:
            print(json.dumps(e.repro), flush=True)
            return 1
        checks += r["checks"]
        comparisons += r["comparisons"]
        meshes += r["mesh"] is not None
        it += 1
        if it % 10 == 0:
            print(f"[fuzz {time.strftime('%T')}] {it} iterations, {checks} read-threshold checks, all exact",
                  file=sys.stderr, flush=True)
    print(json.dumps({"iterations": it, "read_threshold_checks": checks, "mismatches": 0,
                      "minutes": (time.time() - t0) / 60, "base_seed": args.seed, "device": str(device),
                      "comparisons": comparisons, "mesh_iterations": meshes}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
