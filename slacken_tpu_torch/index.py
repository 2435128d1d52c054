"""The minimizer-LCA key-value index (counterpart of slacken_tpu/index.py).

Same on-disk layout, so each package loads the other's index:

    <loc>/params.json       k, m, spaces, toggle mask, canonical, ordering, counts
    <loc>/keys.npy          uint64 [N] sorted ascending; for a wide m
                            (m > 31) uint64 [N, 2] rows (hi64, lo64) of the
                            2m-bit key, sorted by its value
    <loc>/taxa.npy          int32  [N]
    <loc>/ordering_lut.npy  uint32 [4^m] rank table, explicit orderings only
    <loc>/record_keys.npy   uint64 [R] or [R, 2], record_taxa.npy int32 [R]:
                            the full-records sidecar of a keep_records build
    <loc>/taxonomy/         nodes.dmp, names.dmp, merged.dmp

or, saved in S contiguous key ranges (`save_sharded`, "shards" in
params.json holding each range's record count), keys.<i:05d>.npy and
taxa.<i:05d>.npy for i < S in place of keys.npy and taxa.npy.

With an explicit ordering (ops/ordering.py, m <= 15) a key is the rank of
its minimizer in the index's table. The build is one pass for every kind:
scan each batch of genome rows (a CUDA scan kernel on the card) and keep the
span-start minimizers with their row's taxon. Every valid window's minimizer
is the minimizer of its span's start, so these records hold exactly each
sequence's distinct valid-window minimizers; LCA ignores order and
duplicates, so no (key, taxon) pair sort or dedup is needed.

The records go through a merge tree within a device memory budget
(`MergeTree`, the device_reduce route of slacken_tpu's build): every
`superbatch` raw records are sorted (two stable torch.sort passes over the
limbs of wide keys) and reduced, a segment LCA per run of equal keys, into a
leaf; leaves merge pairwise; a leaf that reaches the budget's leaf size
leaves the device, to host memory or with `spill_dir` to a `SpillCollector`'s
range files; and the last merge runs range by range on the device. LCA is
associative, so this is the index of one sort over every record. An index
within the budget ends on the build's device, a larger one on the host.

A keep_records build also keeps the distinct (key, taxon) pairs, sorted by
key and then taxon (one more stable sort pass, the taxon first): the sidecar
from which `build_restricted` makes the index of a taxon subset by a mask, a
select and the same run reduce, without a second scan of the genomes. Its
leaves hold such pairs, and the index is reduced from them range by range.
`respace` is one mask over the keys, a sort and that reduce again.

IndexParams and the host-side fragment splitting follow
slacken_tpu/index.py's.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import shutil
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Set, Tuple

import numpy as np
import torch

from . import storage, to_device
from .ops import encode, ordering
from .ops.lca import segment_lca_table
from .ops.lookup import (
    Bucketed,
    Directory,
    HashedRows,
    HashedTable,
    SlotTable,
    TiledTable,
    build_bucketed,
    build_directory,
    build_hashed,
    build_hashed_cols,
    build_hashed_rows,
    build_slots,
    build_tiled,
)
from .ops.minimizers import (
    DEFAULT_TOGGLE_MASK,
    INT64_MIN,
    MinimizerParams,
    limbs_int64,
    space_mask_int,
    window_minimizers_packed,
)
from .taxonomy import Taxonomy
from .utils import PhaseTimers

FORMAT_VERSION = 1
ORDERINGS = ("xor", "lexicographic", "signature", "frequency", "given")


@dataclass
class IndexParams:
    k: int = 35
    m: int = 31
    spaces: int = 7
    toggle_mask: int = DEFAULT_TOGGLE_MASK
    canonical: bool = True
    buckets: int = 200
    #: "xor" (Kraken 2's order) or an explicit rank-table ordering (ORDERINGS)
    ordering: str = "xor"

    @property
    def minimizer_params(self) -> MinimizerParams:
        return MinimizerParams(
            k=self.k, m=self.m, spaces=self.spaces,
            toggle_mask=self.toggle_mask, canonical=self.canonical,
        )

    def to_json(self) -> dict:
        return {
            "version": FORMAT_VERSION,
            "k": self.k,
            "m": self.m,
            "spaces": self.spaces,
            "toggle_mask": f"{self.toggle_mask:#x}",
            "canonical": self.canonical,
            "buckets": self.buckets,
            "ordering": self.ordering,
        }

    @classmethod
    def from_json(cls, d: dict) -> "IndexParams":
        ver = d.get("version", 0)
        if ver > FORMAT_VERSION:
            raise ValueError(f"Unsupported index format version {ver}")
        return cls(
            k=d["k"], m=d["m"], spaces=d["spaces"],
            toggle_mask=int(d["toggle_mask"], 16), canonical=d["canonical"],
            buckets=d.get("buckets", 200), ordering=d.get("ordering", "xor"),
        )

    def compatibility_check(self, other: "IndexParams"):
        if (self.k, self.m, self.spaces, self.toggle_mask, self.canonical, self.ordering) != (
            other.k, other.m, other.spaces, other.toggle_mask, other.canonical, other.ordering,
        ):
            raise ValueError(f"Incompatible index parameters: {self} vs {other}")


def _rank_table(params: IndexParams, ordering_lut: Optional[np.ndarray]) -> Optional[np.ndarray]:
    """The uint32 rank table a build with `params` uses, or None for "xor":
    lexicographic and signature make their own, frequency and given need
    one (rules as slacken_tpu's build)."""
    if params.ordering not in ORDERINGS:
        raise ValueError(f"ordering must be one of {ORDERINGS}, got {params.ordering!r}")
    if params.ordering == "xor":
        if ordering_lut is not None:
            raise ValueError('ordering_lut given but params.ordering == "xor"')
        return None
    if params.m > 31:
        raise NotImplementedError("explicit orderings require m <= 31")
    if params.ordering == "lexicographic":
        return ordering.lexicographic_lut(params.m)
    if params.ordering == "signature":
        return ordering.signature_lut(params.m)
    if ordering_lut is None:
        raise ValueError(f"ordering {params.ordering!r} requires an explicit rank LUT")
    ordering_lut = np.asarray(ordering_lut)
    if ordering_lut.shape != (1 << (2 * params.m),) or params.m > ordering.MAX_LUT_M:
        raise ValueError(f"a rank table for m = {params.m} has 4^m entries and m <= {ordering.MAX_LUT_M}")
    return ordering_lut.astype(np.uint32)


def sort_order(*columns: torch.Tensor) -> torch.Tensor:
    """The permutation that sorts rows by integer columns, the first the most
    significant. torch.sort takes one key: one pass a column from the last
    to the first, every pass after the first a stable one."""
    order = torch.sort(columns[-1]).indices
    for col in reversed(columns[:-1]):
        order = order[torch.sort(col[order], stable=True).indices]
    return order


def key_columns(keys: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The sort columns of keys: the key, or for wide keys [R, 2] hi64 and
    lo64 with its sign bit flipped (lo64 orders unsigned)."""
    return (keys,) if keys.dim() == 1 else (keys[:, 0], keys[:, 1] ^ INT64_MIN)


def _sort_records(keys: torch.Tensor, taxa: torch.Tensor, by_taxon: bool = False):
    """(keys, taxa) sorted by key, and with `by_taxon` by taxon among equal
    keys (the order of slacken_tpu's dedup_pairs and dedup_pairs_wide)."""
    if keys.dim() == 1 and not by_taxon:
        keys, order = torch.sort(keys)
        return keys, taxa[order]
    order = sort_order(*key_columns(keys), *((taxa,) if by_taxon else ()))
    return keys[order], taxa[order]


def _differs(x: torch.Tensor) -> torch.Tensor:
    """bool [R - 1]: row i + 1 of x ([R] or [R, 2]) differs from row i."""
    d = x[1:] != x[:-1]
    return d.any(1) if x.dim() == 2 else d


def distinct_pairs(keys: torch.Tensor, taxa: torch.Tensor):
    """The distinct (key, taxon) pairs, sorted by key and then taxon: a sort
    (one stable pass a column) and an adjacent-difference select."""
    keys, taxa = _sort_records(keys, taxa, by_taxon=True)
    if keys.shape[0] == 0:
        return keys, taxa
    new = torch.ones_like(taxa, dtype=torch.bool)
    new[1:] = _differs(keys) | _differs(taxa)
    return keys[new], taxa[new]


def taxon_counts(taxa: torch.Tensor) -> Dict[int, int]:
    """taxon -> occurrences, in taxon order, counted where `taxa` lies."""
    t, c = torch.unique(taxa, return_counts=True)
    return dict(zip(t.tolist(), c.tolist()))


def _reduce_sorted(keys: torch.Tensor, taxa: torch.Tensor, taxonomy: Taxonomy,
                   table: Optional[torch.Tensor] = None):
    """(distinct keys, the LCA of each key's taxa) of records sorted by key:
    the tail that build, build_restricted and respace share. `table` is the
    taxonomy's rpath table on the records' device, copied there if None."""
    if keys.shape[0] == 0:
        return keys, taxa
    new = torch.ones_like(taxa, dtype=torch.bool)
    new[1:] = _differs(keys)
    run_ids = torch.cumsum(new, 0) - 1
    uniq = keys[new]
    if table is None:
        table = torch.from_numpy(taxonomy.rpath_table()).to(keys.device)
    return uniq, segment_lca_table(run_ids, taxa, table, int(uniq.shape[0]))


# ---------------------------------------------------------------------------
# Key ranges: boundaries, owners, cuts of sorted runs
# ---------------------------------------------------------------------------


def _wide_pattern(v: int) -> Tuple[int, int]:
    """(hi64, lo64) of a non-negative 128-bit value as int64 bit patterns."""
    lo = v & ((1 << 64) - 1)
    return v >> 64, lo - (1 << 64) if lo >> 63 else lo


def sample_boundaries(keys: torch.Tensor, n: int, m: int) -> list:
    """n - 1 range boundaries from a sample of span keys (int64 [S], or
    [S, 2] for a wide m): the keys at positions i * S // n of the sorted
    sample, as slacken_tpu's sample_shuffle_boundaries takes them; without a
    sample, n-quantiles of the 2m-bit key space. Python ints (narrow) or
    (hi64, lo64) pairs of int64 bit patterns (wide)."""
    wide = keys.dim() == 2
    s = keys.shape[0]
    if s == 0:
        if wide:
            return [_wide_pattern((i << (2 * m)) // n) for i in range(1, n)]
        return [i * ((1 << 62) // n) for i in range(1, n)]
    keys = keys[sort_order(*key_columns(keys))]
    picked = keys[torch.tensor([i * s // n for i in range(1, n)], dtype=torch.long, device=keys.device)]
    return [tuple(row) for row in picked.tolist()] if wide else picked.tolist()


def owners(keys: torch.Tensor, bounds: list) -> torch.Tensor:
    """int64 [S]: the owner of each key, the number of boundaries at or below
    it (wide keys: hi64, then lo64 unsigned)."""
    dest = torch.zeros(keys.shape[0], dtype=torch.int64, device=keys.device)
    if keys.dim() == 1:
        for b in bounds:
            dest += keys >= b
        return dest
    hi, lo = keys[:, 0], keys[:, 1] ^ INT64_MIN
    for b_hi, b_lo in bounds:
        dest += (hi > b_hi) | ((hi == b_hi) & (lo >= (b_lo ^ INT64_MIN)))
    return dest


def by_owner(keys: torch.Tensor, taxa: torch.Tensor, bounds: list, n: int):
    """[(keys, taxa)] of each owner 0..n-1, on the records' device."""
    dest, order = torch.sort(owners(keys, bounds), stable=True)
    counts = torch.bincount(dest, minlength=n).tolist()
    return list(zip(torch.split(keys[order], counts), torch.split(taxa[order], counts)))


def _bounds_tensor(bounds: list, wide: bool) -> torch.Tensor:
    """Boundaries as sample_boundaries gives them, as an int64 [n] or [n, 2]
    tensor on the host."""
    t = torch.tensor(bounds, dtype=torch.int64)
    return t.reshape(-1, 2) if wide else t.reshape(-1)


def _positions(keys: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """int64 [n]: in sorted keys ([R] or [R, 2], ordered as key_columns
    orders them), the first position whose key is at or above each of the
    sorted `bounds` (on the keys' device). Wide keys: the run of equal hi64
    by searchsorted, then lo64 (unsigned) inside it, a bound at a time."""
    if keys.dim() == 1:
        return torch.searchsorted(keys, bounds)
    hi = keys[:, 0].contiguous()
    first = torch.searchsorted(hi, bounds[:, 0].contiguous())
    last = torch.searchsorted(hi, bounds[:, 0].contiguous(), right=True)
    out = first.clone()
    for j in torch.nonzero(last > first).flatten().tolist():
        a, b = int(first[j]), int(last[j])
        lo = keys[a:b, 1] ^ INT64_MIN
        out[j] = a + torch.searchsorted(lo, bounds[j : j + 1, 1] ^ INT64_MIN)[0]
    return out


def _range_cuts(runs: List[torch.Tensor], limit: int) -> List[List[int]]:
    """Cut positions [0, p_1, ..., n] in each sorted run of keys (on any
    device) at common boundary keys, so that no key spans two ranges and each
    range holds at most `limit` entries of all the runs together (save one
    key alone holding more, which only pairs of one key with many taxa
    could). The boundaries come from a sample of every run at a stride s of
    limit / (4 runs): a range holding j sample keys holds fewer than
    (j + runs) s entries, so a range takes at most limit / s - runs of them."""
    step = max(1, limit // (4 * len(runs)))
    per_range = max(1, limit // step - len(runs))
    sample = torch.cat([k[::step].cpu() for k in runs])
    rows = sample[sort_order(*key_columns(sample))].tolist()
    bounds, held = [], 0
    for i, row in enumerate(rows):
        if held >= per_range and row != rows[i - 1]:
            bounds.append(row)
            held = 0
        held += 1
    if not bounds:
        return [[0, int(k.shape[0])] for k in runs]
    b = _bounds_tensor(bounds, runs[0].dim() == 2)
    return [[0, *_positions(k, b.to(k.device)).tolist(), int(k.shape[0])] for k in runs]


# ---------------------------------------------------------------------------
# The bounded build: the leaf merge tree and the spill collector
# ---------------------------------------------------------------------------

#: bytes a record held on a device takes: an int64 key (two for a wide m)
#: and an int32 taxon
HELD_BYTES = {False: 12, True: 20}
#: peak bytes a record takes in one device sort and reduce
#: (MergeTree._reduce), its inputs, the sort's transients and the outputs
#: included: the largest of 12 readings a width at 2^25 records on an NVIDIA
#: H100 (chip_smoke.py's merge_bytes: by LCA, into pairs and a keep_records
#: final merge, with distinct keys and with every key twice; narrow 87.00,
#: wide 111.00, each by LCA and in the final merge), plus about 10%
MERGE_BYTES = {False: 96, True: 124}
#: the most records one device sort takes: a merge of more goes range by
#: range, so that a merge's transients stay small beside the leaves
RANGE_ENTRIES = 1 << 25
#: device memory that the build leaves out of its budget: the scan batch
#: (about 1 GB at 8192 x 4096 positions) and what runs beside the build
DEVICE_RESERVE = 4 << 30


def default_device_budget(device) -> Optional[int]:
    """Bytes of device memory that a build's merge tree may take on `device`:
    on a card what is free now (mem_get_info's free bytes, and the blocks
    that PyTorch's caching allocator holds unused) less DEVICE_RESERVE; None
    on the CPU, where leaves off the device would land in the same memory."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    cached = torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    return max(free + cached - DEVICE_RESERVE, 0)


class MergeTree:
    """(key, taxon) records collected on one device within a memory budget:
    the device_reduce route of slacken_tpu's KeyValueIndex.build
    (slacken_tpu/index.py:1005-1311, `_reduce_chunks_kernel`), with
    explicit sizes in place of its STPU_BUILD_SUPERBATCH and
    STPU_BUILD_DEVICE_BUDGET.

      * Raw records `add`ed batch by batch gather until `superbatch` of them,
        then one sort and reduce makes them a leaf.
      * The two newest leaves merge while the older holds at most twice the
        newer (`reduce_raw`), never one growing carry against each batch,
        which is quadratic.
      * A leaf that reaches `leaf_entries` leaves the device: to host
        memory, or with `spill_dir` to a SpillCollector's range files.
      * `finish` merges what is left: on the device if nothing left it, else
        from the host or the range files, range by range on the device.

    A leaf holds distinct keys with the LCA of their taxa so far, or with
    `pairs` the distinct (key, taxon) pairs sorted by key, then taxon. LCA is
    associative and ignores duplicates, so any grouping of the records into
    leaves reduces to the index of one sort over them all.

    Sizes from a budget of B bytes (h = HELD_BYTES, c = MERGE_BYTES; the
    default B is default_device_budget, none on the CPU):
      * one device sort takes at most range_entries = min(RANGE_ENTRIES,
        B / 4c) records: a quarter of B for a merge's sort and reduce;
        larger merges go range by range, cut at common keys;
      * leaf_entries = B / 8h. The leaves on the device hold fewer than 2
        leaf_entries records (each older leaf holds over twice the next), a
        merge writes at most as many again in range pieces and, once its
        inputs are freed, their concatenation: under 4 leaf_entries records
        held, B / 2;
      * raw chunks reach superbatch (default range_entries) and one batch;
      * the final merge writes to the device where its output, pieces and
        concatenation, takes at most B / 2.
    On an H100 with 84 GB free, B is about 80 GB: leaves of up to 835M
    narrow records stay on the card, and a sort takes 33.5M.
    `stats` counts leaves, merges, leaves off the device and bytes spilled;
    `phases` (utils.PhaseTimers) times leaf reduce, leaf merges, leaves off
    the card, spill writes and the final range merge."""

    def __init__(self, device, taxonomy: Taxonomy, m: int, pairs: bool = False,
                 superbatch: Optional[int] = None, device_budget: Optional[int] = None,
                 spill_dir: Optional[str] = None, phases: Optional[PhaseTimers] = None):
        self.device = torch.device(device)
        self.taxonomy = taxonomy
        self.wide = m > 31
        self.pairs = pairs
        self.budget = default_device_budget(self.device) if device_budget is None else device_budget
        held, merge = HELD_BYTES[self.wide], MERGE_BYTES[self.wide]
        if self.budget is None:
            self.range_entries, self.leaf_entries = RANGE_ENTRIES, None
        else:
            self.range_entries = max(1, min(RANGE_ENTRIES, self.budget // (4 * merge)))
            self.leaf_entries = max(1, self.budget // (8 * held))
        self.superbatch = superbatch or self.range_entries
        self.phases = phases or PhaseTimers()
        self.spill = SpillCollector(spill_dir, m=m) if spill_dir else None
        self._table: Optional[torch.Tensor] = None
        self._index = True  # finish's reduce also makes the index from pairs
        self.chunks: List[Tuple[torch.Tensor, torch.Tensor]] = []
        self.raw = 0
        self.leaves: List[tuple] = []  # on the device, oldest first
        self.off: List[tuple] = []  # leaves in host memory
        self.stats = {"leaves": 0, "merges": 0, "leaves_off": 0, "spilled_bytes": 0, "spill_ranges": 0,
                      "leaf_entries": self.leaf_entries, "range_entries": self.range_entries,
                      "superbatch": self.superbatch, "budget": self.budget}

    def _empty(self, device) -> tuple:
        keys = torch.zeros((0, 2) if self.wide else 0, dtype=torch.int64, device=device)
        return keys, torch.zeros(0, dtype=torch.int32, device=device)

    def _columns(self) -> int:
        return 4 if self.pairs and self._index else 2

    def add(self, keys: torch.Tensor, taxa: torch.Tensor) -> None:
        """Raw records on the tree's device: int64 [R] (or [R, 2]) keys, int32
        [R] taxa."""
        if keys.shape[0] == 0:
            return
        self.chunks.append((keys, taxa))
        self.raw += int(keys.shape[0])
        if self.raw >= self.superbatch:
            self._leaf_from_chunks()

    def _reduce(self, keys: torch.Tensor, taxa: torch.Tensor, final: bool = False) -> tuple:
        """One sort and reduce on the device: (distinct keys, their LCA) or
        with `pairs` the distinct pairs; `final` with pairs adds the index
        reduced from the pairs in front of them."""
        if self._table is None:
            self._table = torch.from_numpy(self.taxonomy.rpath_table()).to(self.device)
        if not self.pairs:
            return _reduce_sorted(*_sort_records(keys, taxa), self.taxonomy, self._table)
        keys, taxa = distinct_pairs(keys, taxa)
        if final and self._index:
            return (*_reduce_sorted(keys, taxa, self.taxonomy, self._table), keys, taxa)
        return keys, taxa

    def _leaf_from_chunks(self) -> None:
        """Reduce the raw chunks into a leaf, merge the newest leaves while
        within 2x of each other, and move a leaf at leaf_entries off."""
        with self.phases.phase("leaf reduce"):
            keys = torch.cat([k for k, _ in self.chunks])
            taxa = torch.cat([t for _, t in self.chunks])
            self.chunks, self.raw = [], 0
            self.leaves.append(self._reduce(keys, taxa))
            del keys, taxa
        self.stats["leaves"] += 1
        while len(self.leaves) > 1 and _n(self.leaves[-2]) <= 2 * _n(self.leaves[-1]):
            with self.phases.phase("leaf merges"):
                self.leaves.append(self._merge([self.leaves.pop(-2), self.leaves.pop()], self.device))
            self.stats["merges"] += 1
        # older leaves hold over twice the newest, and each was below
        # leaf_entries when it was the newest
        while self.leaves and self.leaf_entries is not None and _n(self.leaves[-1]) >= self.leaf_entries:
            self._move_off(self.leaves.pop())

    def _move_off(self, leaf: tuple) -> None:
        self.stats["leaves_off"] += 1
        with self.phases.phase("leaves off the card"):
            if self.spill is None:
                # .cpu() copies synchronously: the host arrays are complete
                self.off.append(tuple(x.cpu() for x in leaf))
                return
            with self.phases.phase("spill writes"):
                self.spill.add(*leaf, sorted=True)

    def _pieces(self, runs: list, out, final: bool = False) -> List[tuple]:
        """Merge sorted runs of (keys, taxa) (on the device or the host):
        one sort where they hold at most range_entries records, else range
        by range, each range's slices copied to the device, reduced there and
        moved to `out`. `runs` is emptied before the pieces are returned."""
        total = sum(_n(r) for r in runs)
        if total <= self.range_entries:
            cuts = [[0, _n(r)] for r in runs]
        else:
            cuts = _range_cuts([k for k, _ in runs], self.range_entries)
        pieces = []
        for j in range(len(cuts[0]) - 1 if cuts else 0):
            parts = [(k[c[j] : c[j + 1]], t[c[j] : c[j + 1]]) for (k, t), c in zip(runs, cuts) if c[j + 1] > c[j]]
            if not parts:
                continue
            keys = torch.cat([k.to(self.device) for k, _ in parts])
            taxa = torch.cat([t.to(self.device) for _, t in parts])
            del parts
            pieces.append(tuple(x.to(out) for x in self._reduce(keys, taxa, final)))
            del keys, taxa
        runs.clear()
        return pieces

    def _merge(self, runs: list, out, final: bool = False) -> tuple:
        return _concat(self._pieces(runs, out, final), self._columns() if final else 2, self._empty(out))

    def _out(self, entries: int) -> torch.device:
        """Where the final merge writes: the device, where the result (at
        most `entries` records a column pair), its pieces and their
        concatenation take at most half the budget; else the host."""
        fits = self.budget is None or entries * HELD_BYTES[self.wide] * self._columns() <= self.budget // 2
        return self.device if fits else torch.device("cpu")

    def finish(self, index: bool = True) -> tuple:
        """The merged records: (keys, taxa) of the index, or with `pairs` the
        distinct pairs after the index's two columns (without `index`, the
        pairs alone). On the device where they fit within the budget, else
        on the host. Removes the spill directory once merged."""
        self._index = index
        if self.chunks:
            self._leaf_from_chunks()
        with self.phases.phase("final range merge"):
            if not self.stats["leaves_off"]:
                result = self._finish_resident()
            else:
                while self.leaves:
                    self._move_off(self.leaves.pop())
                if self.spill is None:
                    result = self._merge(self.off, self._out(sum(_n(r) for r in self.off)), final=True)
                else:
                    out = self._out(self.spill.entries)
                    pieces = [p for runs in self.spill.ranges() for p in self._pieces(runs, out, final=True)]
                    result = _concat(pieces, self._columns(), self._empty(out))
                    self.stats["spilled_bytes"] = self.spill.bytes
                    self.stats["spill_ranges"] = sum(1 for r in self.spill.runs if r)
        if self.spill is not None:
            self.spill.cleanup()
        return result

    def _finish_resident(self) -> tuple:
        """finish where every leaf stayed on the device. One leaf is the
        result as it is (slacken_tpu's reduce_chunks), with pairs and the
        index the index reduced from it (sorted already) in front."""
        if not self.leaves:
            return _concat([], self._columns(), self._empty(self.device))
        if len(self.leaves) == 1:
            leaf = self.leaves.pop()
            if self._columns() == 4:
                return (*_reduce_sorted(*leaf, self.taxonomy, self._table), *leaf)
            return leaf
        return self._merge(self.leaves, self.device, final=True)


def _n(records: tuple) -> int:
    return int(records[0].shape[0])


def _concat(pieces: List[tuple], columns: int, empty: tuple) -> tuple:
    """Pieces of `columns` columns concatenated column by column; `empty`'s
    (keys, taxa) shapes for each pair of columns where there is none."""
    if not pieces:
        return empty * (columns // 2)
    if len(pieces) == 1:
        return pieces[0]
    return tuple(torch.cat([p[c] for p in pieces]) for c in range(columns))


class SpillCollector:
    """Records cut into key ranges on disk, for builds beyond device and host
    memory (counterpart of slacken_tpu/index.py's SpillCollector). Each
    batch of records `add`ed is sorted, cut at fixed range boundaries and
    appended to the range's files k{r:04d}.bin (uint64 keys, [N] or [N, 2]
    rows) and t{r:04d}.bin (int32 taxa); each add's part of a range is one
    sorted run, whose length is kept. `ranges` then reads one range at a
    time, for MergeTree to merge on the device (a range larger than its
    range limit is cut again at its own quantiles). The boundaries are the
    n_ranges-quantiles of the first batch's keys (sample_boundaries), not
    slacken_tpu's uniform bounds of the key space, under which rank-table
    keys (all below 4^m) would fill one range. A crashed build's range files
    in the directory are removed first; `cleanup` removes the directory."""

    def __init__(self, directory: str, n_ranges: int = 64, m: int = 31):
        os.makedirs(directory, exist_ok=True)
        for stale in glob.glob(os.path.join(directory, "k[0-9]*.bin")) + glob.glob(
                os.path.join(directory, "t[0-9]*.bin")):
            os.unlink(stale)
        self.dir = directory
        self.n_ranges = n_ranges
        self.m = m
        self.wide = m > 31
        self.bounds: Optional[torch.Tensor] = None
        self.runs: List[List[int]] = [[] for _ in range(n_ranges)]  # lengths of the runs of each range
        self.entries = 0
        self.bytes = 0

    def _paths(self, r: int) -> Tuple[str, str]:
        return os.path.join(self.dir, f"k{r:04d}.bin"), os.path.join(self.dir, f"t{r:04d}.bin")

    def add(self, keys, taxa, sorted: bool = False) -> None:
        """Records as tensors (anywhere) or host arrays (uint64 keys, int32
        taxa); `sorted` if they are sorted by key already."""
        if isinstance(keys, np.ndarray):
            keys = torch.from_numpy(np.ascontiguousarray(keys, np.uint64).view(np.int64))
            taxa = torch.from_numpy(np.ascontiguousarray(taxa, np.int32))
        if keys.shape[0] == 0:
            return
        if not sorted:
            keys, taxa = _sort_records(keys, taxa)
        if self.bounds is None:
            sample = keys[:: max(1, keys.shape[0] >> 16)]
            self.bounds = _bounds_tensor(sample_boundaries(sample, self.n_ranges, self.m), self.wide)
        cuts = [0, *_positions(keys, self.bounds.to(keys.device)).tolist(), int(keys.shape[0])]
        keys, taxa = keys.cpu().numpy(), taxa.cpu().numpy()
        for r in range(self.n_ranges):
            a, b = cuts[r], cuts[r + 1]
            if a == b:
                continue
            kp, tp = self._paths(r)
            with open(kp, "ab") as kf, open(tp, "ab") as tf:
                kf.write(keys[a:b].tobytes())
                tf.write(taxa[a:b].tobytes())
            self.runs[r].append(b - a)
            self.entries += b - a
            self.bytes += keys[a:b].nbytes + taxa[a:b].nbytes

    def ranges(self):
        """Each non-empty range, in key order, as its runs: [(keys, taxa)]
        host tensors read from its files."""
        for r, runs in enumerate(self.runs):
            if not runs:
                continue
            kp, tp = self._paths(r)
            keys = torch.from_numpy(np.fromfile(kp, dtype=np.int64))
            taxa = torch.from_numpy(np.fromfile(tp, dtype=np.int32))
            if self.wide:
                keys = keys.reshape(-1, 2)
            yield list(zip(torch.split(keys, runs), torch.split(taxa, runs)))

    def cleanup(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)


def _default_batch(device: torch.device) -> Tuple[int, int]:
    """(rows, row length) per build batch: 32 Mbp in 4 kbp rows on the card
    (one scan block per row, several waves of blocks on 132 SMs), 2 Mbp on
    the CPU. The split overlaps rows by k-1, so it never changes the index."""
    return (8192, 1 << 12) if device.type == "cuda" else (512, 1 << 12)


def _batches(fragments, params: IndexParams, taxonomy: Optional[Taxonomy], batch_rows: int,
             row_len: int, taxon_filter: Optional[Set[int]] = None):
    """Host side of the build: (codes [batch_rows, row_len] uint8, row taxa
    [batch_rows] int32, number of rows in use) batches, splitting sequences
    longer than row_len with k-1 overlap and skipping taxa the taxonomy does
    not define, or that lie outside `taxon_filter` when one is given (as
    slacken_tpu's build). Without a taxonomy every sequence goes in under
    the taxon it came with (the library scan of stats.py)."""
    rows: List[np.ndarray] = []
    row_taxa: List[int] = []

    def flush():
        codes = np.full((batch_rows, row_len), encode.INVALID, np.uint8)
        for r, seq in enumerate(rows):
            codes[r, : len(seq)] = seq
        taxa = np.zeros(batch_rows, np.int32)
        n = len(row_taxa)
        taxa[:n] = row_taxa
        rows.clear()
        row_taxa.clear()
        return codes, taxa, n

    step = row_len - (params.k - 1)
    for taxon, seq in fragments:
        if taxonomy is not None:
            taxon = int(taxonomy.primary[taxon]) if taxon < len(taxonomy.primary) else taxon
            if not taxonomy.is_defined(taxon):
                continue
        if taxon_filter is not None and taxon not in taxon_filter:
            continue
        if isinstance(seq, str):
            seq = encode.encode_seq(seq)
        for off in range(0, max(len(seq) - params.k + 1, 1), step):
            rows.append(seq[off : off + row_len])
            row_taxa.append(taxon)
            if len(rows) >= batch_rows:
                yield flush()
    if rows:
        yield flush()


def probe_arrays(keys: torch.Tensor, taxa: torch.Tensor, probe: str, m: int) -> Tuple[
        Optional[torch.Tensor], Optional[torch.Tensor],
        Directory | SlotTable | TiledTable | HashedRows | HashedTable | Bucketed]:
    """What `lookup.probe` reads for the probe `probe`, built from sorted
    keys and taxa of minimizer length `m` where they lie (see
    KeyValueIndex.device_arrays)."""
    wide = m > 31
    if wide and probe in ("hashed", "hashed128", "bucketed"):
        raise NotImplementedError(f"the {probe} probe requires m <= 31")
    if probe == "tiled":
        return None, None, build_tiled(keys, taxa, 2 * m)
    if probe == "hashed1":
        return None, None, build_hashed_rows(keys, taxa)
    if probe == "hashed":
        return None, None, build_hashed(keys, taxa)
    if probe == "hashed128":
        return None, None, build_hashed_cols(keys, taxa)
    if probe == "bucketed":
        return None, None, build_bucketed(keys, taxa, 2 * m)
    if probe != "routed":
        raise ValueError(f"no probe arrays for the probe {probe!r}")
    if keys.device.type == "cuda":
        return None, None, build_slots(keys, taxa)
    return keys, taxa, build_directory(keys)


class KeyValueIndex:
    """Sorted minimizer -> LCA taxon index with its parameters and taxonomy.
    Keys and taxa live as torch tensors on one device, or in host memory
    once a card holds their slot table in their place (device_arrays): then
    `home` is that card, and the index's own work (respace, the per-taxon
    counts, stats.depth_histograms) still runs there, on a copy; `device`
    says where. Keys are int64 [N] (every key is below 2^62), or for a wide
    m int64 [N, 2] rows holding the bit patterns of (hi64, lo64). The host
    arrays materialise on demand.
    `ordering_lut` is the uint32 rank table of an explicit ordering.
    `record_keys_t` and `record_taxa_t` are the full-records sidecar of a
    keep_records build (distinct (key, taxon) pairs sorted by key, then
    taxon; keys shaped like `keys_t`), or None."""

    def __init__(self, keys: torch.Tensor, taxa: torch.Tensor, params: IndexParams,
                 taxonomy: Taxonomy, location: Optional[str] = None,
                 ordering_lut: Optional[np.ndarray] = None):
        if keys.shape[1:] != ((2,) if params.m > 31 else ()):
            raise ValueError(f"keys of shape {tuple(keys.shape)} do not fit m = {params.m}")
        if (ordering_lut is None) != (params.ordering == "xor"):
            raise ValueError(f"ordering {params.ordering!r} with{'out' if ordering_lut is None else ''} a rank table")
        self.keys_t = keys.to(torch.int64)
        self.taxa_t = taxa.to(torch.int32)
        self.params = params
        self.taxonomy = taxonomy
        self.location = location
        self.ordering_lut = ordering_lut
        self.record_keys_t: Optional[torch.Tensor] = None
        self.record_taxa_t: Optional[torch.Tensor] = None
        self.home: Optional[torch.device] = None
        #: a build's MergeTree counts, and with trace its phase walls (seconds)
        self.build_stats: Optional[dict] = None
        self.build_phases: Optional[Dict[str, float]] = None
        self._on = {}
        self._luts = {}

    @property
    def wide(self) -> bool:
        """Keys wider than one int64 (m > 31): [N, 2] rows."""
        return self.params.m > 31

    @property
    def num_records(self) -> int:
        return int(self.keys_t.shape[0])

    @property
    def keys(self) -> np.ndarray:
        """Host uint64 keys (the on-disk dtype), [N] or [N, 2]."""
        return self.keys_t.cpu().numpy().view(np.uint64)

    @property
    def taxa(self) -> np.ndarray:
        return self.taxa_t.cpu().numpy()

    @property
    def record_keys(self) -> Optional[np.ndarray]:
        """Host uint64 keys of the sidecar, [R] or [R, 2]; None without one."""
        return None if self.record_keys_t is None else self.record_keys_t.cpu().numpy().view(np.uint64)

    @property
    def record_taxa(self) -> Optional[np.ndarray]:
        return None if self.record_taxa_t is None else self.record_taxa_t.cpu().numpy()

    @property
    def device(self) -> torch.device:
        """Where the index's own work runs: where its keys lie, or the card
        whose slot table holds them while they wait in host memory."""
        return self.keys_t.device if self.home is None else self.home

    def to(self, device) -> "KeyValueIndex":
        """Move the keys, the taxa and the sidecar to `device`, in place."""
        device = torch.device(device)
        self.keys_t, self.taxa_t = self.keys_t.to(device), self.taxa_t.to(device)
        self.home = None
        if self.record_keys_t is not None:
            self.record_keys_t = self.record_keys_t.to(device)
            self.record_taxa_t = self.record_taxa_t.to(device)
        return self

    @property
    def key_bits(self) -> int:
        """The width of the key space: 2m bits (priorities and rank-table
        ranks alike), whose top bits the tiled table's router takes."""
        return 2 * self.params.m

    def device_arrays(self, device, probe: str = "routed") -> Tuple[
            Optional[torch.Tensor], Optional[torch.Tensor],
            Directory | SlotTable | TiledTable | HashedRows | HashedTable | Bucketed]:
        """What `lookup.probe` reads on `device` for the probe `probe`,
        copied or built there once a (device, probe): "routed", (keys, taxa,
        prefix directory) on the CPU, or on the card (None, None, slot
        table), whose slots hold key remainder and taxon together (8 bytes a
        narrow record, 16 a wide one); "tiled", (None, None,
        TiledTable); "hashed1", (None, None, HashedRows); "hashed" and
        "hashed128", (None, None, HashedTable) of build_hashed and
        build_hashed_cols; "bucketed", (None, None, Bucketed). The tables
        are built on the device from the keys there (the card's own copy of
        an index built on the card). The last three take narrow keys only,
        as the JAX index's device_hashed, device_hashed_cols and
        device_bucketed do. A routed slot table built on a card from the
        keys that live there hands the records over to it (`hand_over`), so
        that the card holds them once."""
        device = torch.device(device)
        if (device, probe) not in self._on:
            keys, taxa = self.keys_t.to(device), self.taxa_t.to(device)
            self._on[device, probe] = arrays = probe_arrays(keys, taxa, probe, self.params.m)
            if probe == "routed" and arrays[0] is None and keys is self.keys_t:
                self.hand_over(device)
        return self._on[device, probe]

    def hand_over(self, device: torch.device) -> None:
        """Keep the keys and taxa in host memory from now on: tables on
        `device` hold the records in their place there, and `device` stays
        the index's home, where its own work runs."""
        self.keys_t, self.taxa_t = self.keys_t.cpu(), self.taxa_t.cpu()
        self.home = torch.device(device)

    def device_lut(self, device) -> Optional[torch.Tensor]:
        """The rank table on `device` as int32 (every rank is below 2^30),
        copied there once; None for the XOR order."""
        device = torch.device(device)
        if self.ordering_lut is not None and device not in self._luts:
            self._luts[device] = torch.from_numpy(self.ordering_lut.astype(np.int32)).to(device)
        return self._luts.get(device)

    # -- construction -------------------------------------------------------

    @classmethod
    def build(
        cls,
        fragments: Iterable[Tuple[int, str]],
        params: IndexParams,
        taxonomy: Taxonomy,
        device,
        batch_rows: Optional[int] = None,
        row_len: Optional[int] = None,
        ordering_lut: Optional[np.ndarray] = None,
        taxon_filter: Optional[Set[int]] = None,
        keep_records: bool = False,
        spill_dir: Optional[str] = None,
        superbatch: Optional[int] = None,
        device_budget: Optional[int] = None,
        trace: bool = False,
    ) -> "KeyValueIndex":
        """Build from (taxon, sequence) pairs on `device`. `ordering_lut` is
        the rank table of a "frequency" or "given" ordering; `taxon_filter`
        drops sequences whose taxon is outside the set (dynamic builds);
        `keep_records` keeps the full-records sidecar for build_restricted.
        The records go through a MergeTree on `device`: `device_budget`
        (bytes; default default_device_budget) and `superbatch` (raw records
        a leaf) size it, and `spill_dir` sends its leaves off the device to
        a SpillCollector's range files there in place of host memory (the
        directory is removed after the build). The index ends on `device`
        where it fits within the budget, else on the host. `trace` records
        the walls of the build's phases (fragment source, packing, scan
        dispatch and the tree's) in `build_phases`; `build_stats` holds the
        tree's counts."""
        device = torch.device(device)
        mp = params.minimizer_params.validate()
        ordering_lut = _rank_table(params, ordering_lut)
        lut = None
        if ordering_lut is not None:
            lut = torch.from_numpy(ordering_lut.astype(np.int32)).to(device)
        d_rows, d_len = _default_batch(device)
        batch_rows = batch_rows or d_rows
        row_len = row_len or d_len
        if row_len % 8 or row_len < params.k:
            raise ValueError(f"row_len must be a multiple of 8 and >= k, got {row_len}")
        phases = PhaseTimers(trace, device)
        tree = MergeTree(device, taxonomy, params.m, pairs=keep_records, superbatch=superbatch,
                         device_budget=device_budget, spill_dir=spill_dir, phases=phases)
        fragments = phases.timed("fragment source", fragments)
        for codes, row_taxa, _ in phases.timed("packing", _batches(fragments, params, taxonomy, batch_rows, row_len,
                                                                   taxon_filter)):
            with phases.phase("packing"):
                packed, valid = encode.pack_2bit(codes)
                packed, valid = to_device(packed, device), to_device(valid, device)
                rt = torch.from_numpy(row_taxa).to(device)
            with phases.phase("scan dispatch"):
                wm = window_minimizers_packed(packed, valid, mp, lut)
                keys = wm.minimizer[wm.span_start]
                taxa = rt[:, None].expand(-1, row_len)[wm.span_start]
                del wm
            tree.add(keys, taxa)
        cols = tree.finish()
        idx = cls(cols[0], cols[1], params, taxonomy, None, ordering_lut)
        if keep_records:
            idx.record_keys_t, idx.record_taxa_t = cols[2], cols[3]
        if lut is not None:
            idx._luts[device] = lut  # the build's copy serves classify on this device
        idx.build_stats = tree.stats
        idx.build_phases = phases.seconds if trace else None
        return idx

    def with_records(self, keys, taxa) -> "KeyValueIndex":
        """An index of these sorted keys and taxa (tensors, or host arrays in
        the on-disk dtypes) with this one's parameters, taxonomy, location and
        rank table."""
        if isinstance(keys, np.ndarray):
            keys = torch.from_numpy(np.ascontiguousarray(keys, np.uint64).view(np.int64))
        if isinstance(taxa, np.ndarray):
            taxa = torch.from_numpy(np.ascontiguousarray(taxa, np.int32))
        return KeyValueIndex(keys, taxa, self.params, self.taxonomy, self.location, self.ordering_lut)

    def build_restricted(self, taxon_set: Set[int], device=None) -> "KeyValueIndex":
        """The index of the sequences whose taxon is in `taxon_set`, from the
        full-records sidecar without a second scan of the genomes: the fast
        path of two-step classification. All on `device` (default: where the
        sidecar lies; a sidecar elsewhere is copied there for this call): a
        bool table over the taxonomy in place of a set lookup, a mask select
        (the sidecar is sorted already) and the build's run reduce. The
        result's keys and taxa stay on the device."""
        if self.record_keys_t is None:
            raise ValueError("index was built/saved without full records")
        device = self.record_keys_t.device if device is None else torch.device(device)
        rec_keys, rec_taxa = self.record_keys_t.to(device), self.record_taxa_t.to(device)
        size = len(self.taxonomy.parents)
        allowed = np.zeros(size, bool)
        allowed[[t for t in taxon_set if 0 <= t < size]] = True
        mask = torch.from_numpy(allowed).to(device)[rec_taxa.long()]
        keys, taxa = _reduce_sorted(rec_keys[mask], rec_taxa[mask], self.taxonomy)
        return KeyValueIndex(keys, taxa, self.params, self.taxonomy, None, self.ordering_lut)

    def respace(self, spaces: int) -> "KeyValueIndex":
        """Project this index to a larger number of spaced-seed spaces and
        reduce again (KeyValueIndex.scala:353-382): an index with s spaces
        holds all that one with s' > s needs. On the index's device. The
        mask of a wide key splits over its two limbs."""
        if spaces <= self.params.spaces:
            raise ValueError(
                f"Respacing must increase spaces (was {self.params.spaces}, got {spaces})"
            )
        if self.params.ordering != "xor":
            # rank-table keys are opaque ranks; re-masking them is meaningless
            raise NotImplementedError("respace requires the xor ordering")
        keys, taxa = self.keys_t.to(self.device), self.taxa_t.to(self.device)
        mask = space_mask_int(self.params.m, spaces)
        if self.wide:
            hi, lo = limbs_int64(mask)
            keys = torch.stack([keys[:, 0] & hi, keys[:, 1] & lo], dim=1)
        else:
            keys = keys & mask
        keys, taxa = _reduce_sorted(*_sort_records(keys, taxa), self.taxonomy)
        return KeyValueIndex(keys, taxa, dataclasses.replace(self.params, spaces=spaces), self.taxonomy)

    def records_per_taxon(self) -> Dict[int, int]:
        """taxon -> number of stored minimizers, in taxon order; counted on
        the index's device."""
        return taxon_counts(self.taxa_t.to(self.device))

    def distinct_minimizers_per_taxon(self) -> Dict[int, int]:
        # keys are unique already, so this equals records_per_taxon
        return self.records_per_taxon()

    # -- persistence --------------------------------------------------------

    def save(self, location: str):
        storage.makedirs(location)
        meta = self.params.to_json()
        meta["num_records"] = self.num_records
        with storage.open_file(storage.join(location, "params.json"), "w") as f:
            json.dump(meta, f, indent=2)
        storage.np_save(storage.join(location, "keys.npy"), self.keys)
        storage.np_save(storage.join(location, "taxa.npy"), self.taxa)
        if self.ordering_lut is not None:
            storage.np_save(storage.join(location, "ordering_lut.npy"), self.ordering_lut)
        if self.record_keys_t is not None:
            storage.np_save(storage.join(location, "record_keys.npy"), self.record_keys)
            storage.np_save(storage.join(location, "record_taxa.npy"), self.record_taxa)
        self.taxonomy.save(storage.join(location, "taxonomy"))
        self.location = location

    @classmethod
    def load(cls, location: str, taxonomy: Optional[Taxonomy] = None) -> "KeyValueIndex":
        with storage.open_file(storage.join(location, "params.json")) as f:
            meta = json.load(f)
        params = IndexParams.from_json(meta)
        if "shards" in meta:
            return cls.load_shards(location, taxonomy=taxonomy)
        keys = storage.np_load(storage.join(location, "keys.npy"), mmap=False).astype(np.uint64)
        taxa = storage.np_load(storage.join(location, "taxa.npy"), mmap=False).astype(np.int32)
        if taxonomy is None:
            taxonomy = Taxonomy.load(storage.join(location, "taxonomy"))
        idx = cls(
            torch.from_numpy(keys.view(np.int64)), torch.from_numpy(taxa), params,
            taxonomy, location, _saved_lut(location),
        )
        rk = storage.join(location, "record_keys.npy")
        if storage.exists(rk):
            rec_keys = storage.np_load(rk, mmap=False).astype(np.uint64)
            rec_taxa = storage.np_load(storage.join(location, "record_taxa.npy"), mmap=False).astype(np.int32)
            idx.record_keys_t = torch.from_numpy(rec_keys.view(np.int64))
            idx.record_taxa_t = torch.from_numpy(rec_taxa)
        return idx

    def save_sharded(self, location: str, n_shards: Optional[int] = None):
        """Save as `n_shards` (default params.buckets) contiguous key ranges,
        np.linspace bounds over the records, so that each process of a
        multi-host run can load only its ranges (the bucketed layout of the
        reference, KeyValueIndex.scala:125-139). The files are byte for byte
        slacken_tpu's save_sharded's; the full-records sidecar is not saved."""
        n_shards = n_shards or self.params.buckets
        storage.makedirs(location)
        bounds = np.linspace(0, self.num_records, n_shards + 1).astype(np.int64)
        meta = self.params.to_json()
        meta["num_records"] = self.num_records
        meta["shards"] = [int(bounds[i + 1] - bounds[i]) for i in range(n_shards)]
        with storage.open_file(storage.join(location, "params.json"), "w") as f:
            json.dump(meta, f, indent=2)
        keys, taxa = self.keys, self.taxa
        for i in range(n_shards):
            storage.np_save(storage.join(location, f"keys.{i:05d}.npy"), keys[bounds[i] : bounds[i + 1]])
            storage.np_save(storage.join(location, f"taxa.{i:05d}.npy"), taxa[bounds[i] : bounds[i + 1]])
        if self.ordering_lut is not None:
            # rank-table keys are ranks: without the table they would probe nothing
            storage.np_save(storage.join(location, "ordering_lut.npy"), self.ordering_lut)
        self.taxonomy.save(storage.join(location, "taxonomy"))

    @classmethod
    def load_shards(cls, location: str, shard_ids: Optional[List[int]] = None,
                    taxonomy: Optional[Taxonomy] = None) -> "KeyValueIndex":
        """The index of the shards `shard_ids` (default: all, in order) of a
        save_sharded layout; the keys of shards given in order are sorted."""
        with storage.open_file(storage.join(location, "params.json")) as f:
            meta = json.load(f)
        params = IndexParams.from_json(meta)
        ids = list(range(len(meta["shards"]))) if shard_ids is None else list(shard_ids)
        if ids:
            keys = np.concatenate([storage.np_load(storage.join(location, f"keys.{i:05d}.npy"), mmap=False)
                                   for i in ids]).astype(np.uint64)
            taxa = np.concatenate([storage.np_load(storage.join(location, f"taxa.{i:05d}.npy"), mmap=False)
                                   for i in ids]).astype(np.int32)
        else:
            keys = np.zeros((0, 2) if params.m > 31 else 0, np.uint64)
            taxa = np.zeros(0, np.int32)
        if taxonomy is None:
            taxonomy = Taxonomy.load(storage.join(location, "taxonomy"))
        return cls(torch.from_numpy(keys.view(np.int64)), torch.from_numpy(taxa), params, taxonomy, location,
                   _saved_lut(location))


def _saved_lut(location: str) -> Optional[np.ndarray]:
    """The rank table saved with an index, or None (the XOR order)."""
    path = storage.join(location, "ordering_lut.npy")
    return storage.np_load(path, mmap=False).astype(np.uint32) if storage.exists(path) else None
