"""Synthetic workloads for smoke runs and measurements: the libraries,
taxonomies and simulated reads of bench.py and scripts/scale_bench.py, made
with the same generator calls in the same order, so the same seeds give the
same sequences (and the same index record counts: 2,623,028 for the bench
library, 131,190,899 for the 400 Mbp scale library at k=35 m=31 s=7).
"""

from __future__ import annotations

import os
from typing import Iterator, List, Tuple

import numpy as np

from . import native
from .ops import encode
from .ops.resolve import INVALID_WINDOW
from .taxonomy import Taxonomy

BENCH_SEED = 20260816
SCALE_SEED = 20260818
READ_SEED = 7
READ_LEN = 101
#: bench library: three genomes sized like the reference's tiny test data
BENCH_SIZES = {455631: 4_100_000, 526997: 3_100_000, 9606: 800_000}

_ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
_COMPLEMENT = str.maketrans("ACGT", "TGCA")


def bench_library(rng) -> Iterator[Tuple[int, str]]:
    """(taxon, sequence) for the three bench genomes, 8 Mbp in all."""
    for taxon, n in BENCH_SIZES.items():
        yield taxon, _ACGT[rng.integers(0, 4, n)].tobytes().decode("ascii")


def _star_taxonomy(taxa) -> Taxonomy:
    nodes = [(1, 1, "root")] + [(t, 1, "species") for t in taxa]
    return Taxonomy.from_nodes_and_names(nodes, [(t, f"taxon{t}") for t, _, _ in nodes])


def bench_taxonomy() -> Taxonomy:
    return _star_taxonomy(BENCH_SIZES)


def scale_library(total_bp: int, n_taxa: int, seed=SCALE_SEED) -> Iterator[Tuple[int, str]]:
    """Deterministic genomes: n_taxa species (taxa 10, 11, ...) under one
    root, sizes Zipf-like (a few large genomes and a tail), totalling
    total_bp."""
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, n_taxa + 1)
    sizes = np.maximum((total_bp * w / w.sum()).astype(np.int64), 50_000)
    for i, n in enumerate(sizes):
        codes = rng.integers(0, 4, int(n), dtype=np.int64).astype(np.uint8)
        yield 10 + i, _ACGT[codes].tobytes().decode("ascii")


def related_library(total_bp: int, n_taxa: int, seed=SCALE_SEED,
                    rates=(0.05, 0.03, 0.01)) -> Iterator[Tuple[int, str]]:
    """Genomes of related species on scale_taxonomy_deep's tree, sized as
    scale_library's: one random ancestor; each family's genome is the
    ancestor with a share rates[0] of its bases substituted, each genus's is
    its family's with rates[1], each species's its genus's with rates[2]
    (about 98% identity within a genus, 92% within a family, 83% across
    families), cut to the species' size."""
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, n_taxa + 1)
    sizes = np.maximum((total_bp * w / w.sum()).astype(np.int64), 50_000)

    def mutated(codes, rate, n):
        out = codes[:n].copy()
        hit = np.flatnonzero(rng.random(n) < rate)
        out[hit] = (out[hit] + rng.integers(1, 4, len(hit), dtype=np.uint8)) % 4
        return out

    ancestor = rng.integers(0, 4, int(sizes.max()), dtype=np.int64).astype(np.uint8)
    family = genus = None
    for i, n in enumerate(sizes):  # sizes fall with i: the first of a group is its longest
        if i % 16 == 0:
            family = mutated(ancestor, rates[0], int(n))
        if i % 4 == 0:
            genus = mutated(family, rates[1], int(n))
        yield 10 + i, _ACGT[mutated(genus, rates[2], int(n))].tobytes().decode("ascii")


def scale_taxonomy(n_taxa: int) -> Taxonomy:
    return _star_taxonomy(range(10, 10 + n_taxa))


def scale_taxonomy_deep(n_taxa: int) -> Taxonomy:
    """scale_library's species (taxa 10, 11, ...) four to a genus (1000,
    1001, ...) and four genera to a family (2000, ...) under the root, with
    the standard rank names, so that a species stands at depth 8 and two-step
    classification has ranks to work with."""
    genera, families = -(-n_taxa // 4), -(-n_taxa // 16)
    nodes = [(1, 1, "root")]
    nodes += [(2000 + f, 1, "family") for f in range(families)]
    nodes += [(1000 + g, 2000 + g // 4, "genus") for g in range(genera)]
    nodes += [(10 + i, 1000 + i // 4, "species") for i in range(n_taxa)]
    return Taxonomy.from_nodes_and_names(nodes, [(t, f"taxon{t}") for t, _, _ in nodes])


def _simulated(seq: str, rng, n: int, taxon: int) -> native.PackedReads:
    """n reads of READ_LEN bp from random offsets of seq with 1% mutated
    bases, in 128-wide rows, titled sim<taxon>_<i>."""
    codes_full = encode.encode_seq(seq)
    starts = rng.integers(0, len(codes_full) - READ_LEN, n)
    rows = codes_full[starts[:, None] + np.arange(READ_LEN)[None, :]].astype(np.uint8)
    mut = rng.random(rows.shape) < 0.01
    rows[mut] = rng.integers(0, 4, int(mut.sum()))
    rows = np.pad(rows, ((0, 0), (0, 128 - READ_LEN)), constant_values=encode.INVALID)
    return native.PackedReads(rows, np.full(n, READ_LEN, np.int32),
                              [f"sim{taxon}_{i}" for i in range(n)])


def bench_reads(n_copies: int = 8) -> List[native.PackedReads]:
    """The bench's simulated reads: 3,334 from each bench genome (read seed
    7), the three chunks repeated n_copies times."""
    rng = np.random.default_rng(READ_SEED)
    sim = [_simulated(seq, rng, 3334, taxon)
           for taxon, seq in bench_library(np.random.default_rng(BENCH_SEED))]
    return sim * n_copies


def scale_reads(total_bp: int, n_taxa: int, n_reads: int = 200_000, library=None) -> List[native.PackedReads]:
    """The scale run's simulated reads: n_reads spread over the first 2 Mbp
    of each of the first eight genomes of scale_library(total_bp, n_taxa),
    or of `library`, those genomes made already."""
    rng = np.random.default_rng(READ_SEED)
    n_src = min(n_taxa, 8)
    sim = []
    for j, (taxon, seq) in enumerate(library or scale_library(total_bp, n_taxa)):
        if j >= n_src:
            break
        sim.append(_simulated(seq[:2_000_000], rng, n_reads // n_src, taxon))
    return sim


def segment_rows(rng, segment: int, k: int, n_segments: int = 6) -> np.ndarray:
    """Codes uint8 [8, L] that stress a minimizer scan cut into segments of
    `segment` positions (a multiple of 128; L is n_segments and a half
    segments, so the last is shorter) for windows of k bases. Row 0: random
    with 5% N; 1: all N; 2: an N run over three whole segments, after which
    the first valid window repeats the bases of the last one before it; 3:
    the same with the run ending exactly at a segment start and covering the
    128 positions before it; 4: such a run followed by other bases; 5: valid
    bases only in the last segment; 6: a motif of 23 bases repeated, whose
    windows share minimizers across segment starts, with an N run after
    which the sequence goes on in phase; 7: N runs of k/2 to 3k bases at
    random."""
    S, N = segment, encode.INVALID
    L = n_segments * S + S // 2
    codes = rng.integers(0, 4, (8, L)).astype(np.uint8)

    def run(r, a, b, repeat):
        codes[r, a:b] = N
        if repeat:
            codes[r, b : b + k] = codes[r, a - k : a]

    codes[0, rng.random(L) < 0.05] = N
    codes[1] = N
    a = max(S + 40, k + 8)
    run(2, a, a + 3 * S, True)
    j = max(2, -(-(k + 128) // S))  # the first segment start with k bases before its warm-up chunk
    run(3, j * S - 128, j * S, True)
    run(4, j * S - S - 128, (j + 1) * S, False)
    codes[5, : (n_segments - 1) * S + 8] = N
    codes[6] = np.resize(rng.integers(0, 4, 23).astype(np.uint8), L)
    a = 3 * S - 60
    b = a + S
    codes[6, a : b + (a - k - b) % 23] = N
    starts = np.flatnonzero(rng.random(L) < 1 / (4 * k))
    for a, n in zip(starts, rng.integers(k // 2, 3 * k + 1, len(starts))):
        codes[7, a : a + n] = N
    return codes



def carry_rows(rng, shape: Tuple[int, int], segment: int, k: int) -> np.ndarray:
    """Codes uint8 `shape` (random bases) for a scan cut into segments of
    `segment` positions (>= k + 64) for windows of k bases, in which the
    stitch has work at every third segment start s = 3 S, 6 S, ....
    By turns: an N run over the 128 positions before s, the k bases before
    the run repeated from s (the carry comes from the segment before and
    clears s's distinct byte); an N run over the whole segment before too,
    repeated (the walk passes over a segment without a valid window, and
    clears); the same run not repeated (nothing to clear)."""
    if segment < k + 64:
        raise ValueError(f"carry_rows needs segments of at least k + 64 = {k + 64} positions, got {segment}")
    S, N = segment, encode.INVALID
    codes = rng.integers(0, 4, shape).astype(np.uint8)
    for r in range(shape[0]):
        for j in range(3, shape[1] // S, 3):
            s, kind = j * S, (j // 3 + r) % 3
            a = s - 128 if kind == 0 else s - S - 128
            codes[r, a:s] = N
            if kind < 2:
                codes[r, s : s + k] = codes[r, a - k : a]
    return codes

def hit_runs_rows(seed: int, rows: int, width: int, k: int, paired: bool = False, taxa: int = 6):
    """Inputs of the hit-runs reduction (ops/hitruns.py) as the classifier
    makes them: (window taxa int32 [rows, width], pack_2bit's validity bits
    uint8 [rows, width/8], splits int32 [rows] (-1 single-end), row lengths
    int32 [rows]); width a multiple of 8. A window is valid when its k chars
    are, and valid windows carry piecewise-constant taxa (NONE = 0 among
    them, up to 2^30). Rows cycle through four kinds: clean, a few Ns, N runs
    of k to 2k bases (ambiguous runs), and full rows with one N in 100 and 60
    taxon changes (more runs than the cap); the first two rows are padding
    (length 0) and the third is full.
    Paired rows put N runs against the mate border, one side or the other."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (rows, width)).astype(np.uint8)
    lens = rng.integers(min(k, width) // 2, width + 1, rows)
    lens[:2] = 0
    lens[2 % rows] = width
    splits = np.full(rows, -1, np.int64)
    for i in range(rows):
        n, kind = int(lens[i]), i % 4
        if kind == 1:
            codes[i, rng.integers(0, width, 3)] = encode.INVALID
        elif kind == 2:
            for a in rng.integers(0, width, 2):
                codes[i, a : a + int(rng.integers(k, 2 * k + 1))] = encode.INVALID
        elif kind == 3:
            codes[i, rng.random(width) < 0.01] = encode.INVALID
            lens[i] = n = width
        if paired and n >= 3:
            s = int(rng.integers(1, n - 1))
            splits[i] = s
            codes[i, s] = encode.INVALID
            if i % 5 == 0:
                codes[i, max(0, s - k - int(rng.integers(0, 3))) : s] = encode.INVALID
            elif i % 5 == 1:
                codes[i, s + 1 : s + 1 + k + int(rng.integers(0, 3))] = encode.INVALID
        codes[i, n:] = encode.INVALID
    win_ok = _windows_valid(codes, k)
    pos = np.arange(width)
    pool = np.concatenate([[0], rng.integers(1, 1 << 30, taxa)]).astype(np.int32)
    wt = np.empty((rows, width), np.int32)
    for i in range(rows):
        cuts = np.sort(rng.integers(0, width, 60 if i % 4 == 3 else int(rng.integers(0, 5))))
        seg = np.searchsorted(cuts, pos, side="right")
        wt[i] = pool[rng.integers(0, len(pool), len(cuts) + 1)][seg]
    wt[~win_ok] = INVALID_WINDOW
    _, valid = encode.pack_2bit(codes)
    return wt, valid, splits.astype(np.int32), lens.astype(np.int32)


def _windows_valid(codes: np.ndarray, k: int) -> np.ndarray:
    """[rows, width] bool: the k chars from each position lie in the row and
    are all valid."""
    rows, width = codes.shape
    bad = np.concatenate([np.zeros((rows, 1), np.int64), np.cumsum(codes == encode.INVALID, axis=1)], axis=1)
    pos = np.arange(width)
    end = np.minimum(pos + k, width)
    return (pos + k <= width)[None, :] & (bad[:, end] - bad[:, pos] == 0)


#: positions a lane of the hit-runs kernel scans a step
HIT_RUNS_PER_LANE = 16
#: (width, k) of hit_runs_edge_rows that the tests and chip_smoke.py run:
#: one chunk of 16 and of 32 lanes (a lane border at 128), two chunks with a
#: tail of 8 positions, three chunks
HIT_RUNS_EDGE_SHAPES = [(136, 7), (136, 35), (264, 35), (520, 7), (1032, 50)]


def hit_runs_lanes(width: int) -> int:
    """Lanes of the hit-runs kernel a row of this width: the fewest of 8, 16
    and 32 whose chunk (HIT_RUNS_PER_LANE a lane) covers the row, at most a
    warp."""
    return 8 if width <= 8 * HIT_RUNS_PER_LANE else 16 if width <= 16 * HIT_RUNS_PER_LANE else 32


def hit_runs_edge_rows(width: int, k: int, seed: int = 0):
    """Hand-made inputs of the hit-runs reduction, as hit_runs_rows returns
    them, at the edges of the kernel's walk (kernels/hitruns.cu:
    HIT_RUNS_PER_LANE positions a lane, hit_runs_lanes(width) lanes a chunk)
    around a border c, the first chunk border of a row wider than one chunk,
    else the lane border at 128: a padding row; runs that cross c or start
    at it and at other places of a lane; an all-N stretch (ambiguous
    windows) across c; a gap shorter than k across it between equal taxa
    (one run, carried over the first lanes after it); mate borders at four
    neighbouring places of a lane, with N runs ending at the border and
    starting after it, and at c; a full row and one ending in N, for the
    tail chunk when width is not a multiple of the chunk. width a multiple of
    8 above 128."""
    if width % 8 or width <= 128:
        raise ValueError(f"edge rows need a width that is a multiple of 8 above 128, got {width}")
    chunk = HIT_RUNS_PER_LANE * hit_runs_lanes(width)
    c = chunk if width > chunk else 128
    mid = 4 * (width // 8)
    # (N stretches, length, split, taxon cuts) a row
    spec = [
        ([], 0, -1, []),
        ([], width, -1, [5, 20, 40, 60, c - 8]),
        ([], width, -1, [c - 4, c - 2, c, c + 1, c + 3]),
        ([(c - 28, c + k + 12)], width, -1, [40]),
        ([(c + 2, c + 2 + max(1, k // 4))], width, -1, []),
        ([], width, -1, [width - k - 2]),
        ([(width - k - 3, width)], width, -1, [c + 2]),
    ]
    for j in range(4):
        s = mid - 1 + j  # mate 2 starts at mid + j
        stretch = [(s - k - 1, s)] if j == 0 else [(s + 1, s + k + 3)] if j == 1 else []
        spec.append((stretch, width, s, [] if j < 3 else [s - 5, s + 3]))
    if c + k <= width:
        spec.append(([], width, c - 1, [c - 6]))
    rng = np.random.default_rng(seed)
    rows = len(spec)
    codes = rng.integers(0, 4, (rows, width)).astype(np.uint8)
    lens, splits = np.zeros(rows, np.int32), np.full(rows, -1, np.int32)
    pool = rng.integers(1, 1 << 30, 4).astype(np.int32)
    taxa = np.empty((rows, width), np.int32)
    pos = np.arange(width)
    for i, (stretches, n, s, cuts) in enumerate(spec):
        for a, b in stretches:
            codes[i, max(a, 0) : b] = encode.INVALID
        if s >= 0:
            codes[i, s] = encode.INVALID
        codes[i, n:] = encode.INVALID
        lens[i], splits[i] = n, s
        taxa[i] = pool[np.searchsorted(np.sort(cuts), pos, side="right") % len(pool)]
    wt = np.where(_windows_valid(codes, k), taxa, INVALID_WINDOW).astype(np.int32)
    _, valid = encode.pack_2bit(codes)
    return wt, valid, splits, lens


_LETTERS = np.frombuffer(b"ACGTN", np.uint8)


def read_sequences(reads: List[native.PackedReads]) -> Iterator[Tuple[str, str]]:
    """(title, sequence) of every read of packed single-read chunks."""
    for p in reads:
        for title, codes, n in zip(p.titles, p.codes, p.lengths):
            yield title, _LETTERS[codes[:n]].tobytes().decode("ascii")


def write_fastq(reads: List[native.PackedReads], path: str) -> None:
    """Write packed single-read chunks as one FASTQ file."""
    with open(path, "w") as f:
        for title, seq in read_sequences(reads):
            f.write(f"@{title}\n{seq}\n+\n{'I' * len(seq)}\n")


class GenomeList:
    """The genome library interface (inputs.GenomeLibrary's `sequences`,
    `taxa_sequences` and `taxon_set`) over (taxon, sequence) pairs held in
    memory."""

    def __init__(self, genomes):
        self.genomes = genomes

    def sequences(self):
        for i, (taxon, seq) in enumerate(self.genomes):
            yield taxon, f"seq{i}", seq

    def taxa_sequences(self):
        return iter(self.genomes)

    def taxon_set(self, taxonomy):
        return taxonomy.taxa_with_ancestors([t for t, _ in self.genomes])


def write_library(genomes, location: str) -> None:
    """Write (taxon, sequence) genomes as a genome library directory:
    library/g<i>.fna with one sequence each and seqid2taxid.map."""
    os.makedirs(os.path.join(location, "library"), exist_ok=True)
    with open(os.path.join(location, "seqid2taxid.map"), "w") as labels:
        for i, (taxon, seq) in enumerate(genomes):
            with open(os.path.join(location, "library", f"g{i}.fna"), "w") as f:
                f.write(f">seq{i}\n")
                f.writelines(seq[a : a + 80] + "\n" for a in range(0, len(seq), 80))
            labels.write(f"seq{i}\t{taxon}\n")


def bench_pairs(n_pairs: int, seed: int = READ_SEED) -> List[Tuple[str, str, str]]:
    """(title, mate 1, mate 2) read pairs from the bench library: the two
    READ_LEN bp ends of a 300-400 bp fragment, the second mate
    reverse-complemented, 1% of the bases mutated."""
    rng = np.random.default_rng(seed)
    lib = list(bench_library(np.random.default_rng(BENCH_SEED)))
    pairs = []
    for i in range(n_pairs):
        taxon, seq = lib[i % len(lib)]
        size = int(rng.integers(300, 401))
        start = int(rng.integers(0, len(seq) - size))
        frag = np.frombuffer(seq[start : start + size].encode("ascii"), np.uint8).copy()
        mut = rng.random(size) < 0.01
        frag[mut] = _ACGT[rng.integers(0, 4, int(mut.sum()))]
        frag = frag.tobytes().decode("ascii")
        mate2 = frag[-READ_LEN:].translate(_COMPLEMENT)[::-1]
        pairs.append((f"pair{taxon}_{i}", frag[:READ_LEN], mate2))
    return pairs


def write_paired_fastq(pairs, path1: str, path2: str) -> None:
    """Write (title, mate 1, mate 2) pairs as two FASTQ files whose titles
    end in /1 and /2."""
    with open(path1, "w") as f1, open(path2, "w") as f2:
        for title, s1, s2 in pairs:
            f1.write(f"@{title}/1\n{s1}\n+\n{'I' * len(s1)}\n")
            f2.write(f"@{title}/2\n{s2}\n+\n{'I' * len(s2)}\n")
