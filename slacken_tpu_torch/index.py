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
scan each batch of genome rows (a CUDA scan kernel on the card), keep the
span-start minimizers with their row's taxon, then one sort by key (two
stable torch.sort passes over the limbs of wide keys) and a segment LCA
per run of equal keys. Every valid window's minimizer is the minimizer
of its span's start, so these records hold exactly each sequence's distinct
valid-window minimizers; LCA ignores order and duplicates, so no
(key, taxon) pair sort or dedup is needed.

A keep_records build also keeps the distinct (key, taxon) pairs, sorted by
key and then taxon (one more stable sort pass, the taxon first): the sidecar
from which `build_restricted` makes the index of a taxon subset by a mask, a
select and the same run reduce, without a second scan of the genomes.
`respace` is one mask over the keys, a sort and that reduce again.

IndexParams and the host-side fragment splitting follow
slacken_tpu/index.py's.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Set, Tuple

import numpy as np
import torch

from . import storage, to_device
from .ops import encode, ordering
from .ops.lca import segment_lca_table
from .ops.lookup import Directory, SlotTable, build_directory, build_slots
from .ops.minimizers import (
    DEFAULT_TOGGLE_MASK,
    INT64_MIN,
    MinimizerParams,
    limbs_int64,
    space_mask_int,
    window_minimizers_packed,
)
from .taxonomy import Taxonomy

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


def _reduce_sorted(keys: torch.Tensor, taxa: torch.Tensor, taxonomy: Taxonomy):
    """(distinct keys, the LCA of each key's taxa) of records sorted by key:
    the tail that build, build_restricted and respace share."""
    if keys.shape[0] == 0:
        return keys, taxa
    new = torch.ones_like(taxa, dtype=torch.bool)
    new[1:] = _differs(keys)
    run_ids = torch.cumsum(new, 0) - 1
    uniq = keys[new]
    table = torch.from_numpy(taxonomy.rpath_table()).to(keys.device)
    return uniq, segment_lca_table(run_ids, taxa, table, int(uniq.shape[0]))


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


class KeyValueIndex:
    """Sorted minimizer -> LCA taxon index with its parameters and taxonomy.
    Keys and taxa live as torch tensors on one device: int64 [N] keys (every
    key is below 2^62), or for a wide m int64 [N, 2] rows holding the bit
    patterns of (hi64, lo64). The host arrays materialise on demand.
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

    def to(self, device) -> "KeyValueIndex":
        """Move the keys, the taxa and the sidecar to `device`, in place."""
        device = torch.device(device)
        self.keys_t, self.taxa_t = self.keys_t.to(device), self.taxa_t.to(device)
        if self.record_keys_t is not None:
            self.record_keys_t = self.record_keys_t.to(device)
            self.record_taxa_t = self.record_taxa_t.to(device)
        return self

    def device_arrays(self, device) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor], Directory | SlotTable]:
        """What `lookup.probe` reads on `device`, copied or built there once:
        (keys, taxa, prefix directory); for a wide index on the card
        (None, None, slot table), whose rows hold key and taxon together."""
        device = torch.device(device)
        if device not in self._on:
            keys, taxa = self.keys_t.to(device), self.taxa_t.to(device)
            if self.wide and device.type == "cuda":
                self._on[device] = (None, None, build_slots(keys, taxa))
            else:
                self._on[device] = (keys, taxa, build_directory(keys))
        return self._on[device]

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
    ) -> "KeyValueIndex":
        """Build from (taxon, sequence) pairs on `device`. `ordering_lut` is
        the rank table of a "frequency" or "given" ordering; `taxon_filter`
        drops sequences whose taxon is outside the set (dynamic builds);
        `keep_records` keeps the full-records sidecar for build_restricted."""
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
        keys_parts, taxa_parts = [], []
        for codes, row_taxa, _ in _batches(fragments, params, taxonomy, batch_rows, row_len, taxon_filter):
            packed, valid = encode.pack_2bit(codes)
            wm = window_minimizers_packed(to_device(packed, device), to_device(valid, device), mp, lut)
            rt = torch.from_numpy(row_taxa).to(device)
            keys_parts.append(wm.minimizer[wm.span_start])
            taxa_parts.append(rt[:, None].expand(-1, row_len)[wm.span_start])
        if keys_parts:
            keys = torch.cat(keys_parts)
            taxa = torch.cat(taxa_parts)
        else:
            keys = torch.zeros((0, 2) if mp.wide else 0, dtype=torch.int64, device=device)
            taxa = torch.zeros(0, dtype=torch.int32, device=device)
        del keys_parts, taxa_parts
        keys, taxa = distinct_pairs(keys, taxa) if keep_records else _sort_records(keys, taxa)
        uniq, red = _reduce_sorted(keys, taxa, taxonomy)
        idx = cls(uniq, red, params, taxonomy, None, ordering_lut)
        if keep_records:
            idx.record_keys_t, idx.record_taxa_t = keys, taxa
        if lut is not None:
            idx._luts[device] = lut  # the build's copy serves classify on this device
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
        holds all that one with s' > s needs. Where the keys lie. The mask of
        a wide key splits over its two limbs."""
        if spaces <= self.params.spaces:
            raise ValueError(
                f"Respacing must increase spaces (was {self.params.spaces}, got {spaces})"
            )
        if self.params.ordering != "xor":
            # rank-table keys are opaque ranks; re-masking them is meaningless
            raise NotImplementedError("respace requires the xor ordering")
        keys, taxa = self.keys_t, self.taxa_t
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
        return taxon_counts(self.taxa_t)

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
