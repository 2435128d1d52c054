"""The minimizer-LCA key-value index (counterpart of slacken_tpu/index.py).

Same on-disk layout, so each package loads the other's index:

    <loc>/params.json       k, m, spaces, toggle mask, canonical, ordering, counts
    <loc>/keys.npy          uint64 [N] sorted ascending; for a wide m
                            (m > 31) uint64 [N, 2] rows (hi64, lo64) of the
                            2m-bit key, sorted by its value
    <loc>/taxa.npy          int32  [N]
    <loc>/ordering_lut.npy  uint32 [4^m] rank table, explicit orderings only
    <loc>/taxonomy/         nodes.dmp, names.dmp, merged.dmp

With an explicit ordering (ops/ordering.py, m <= 15) a key is the rank of
its minimizer in the index's table. The build is one pass for every kind:
scan each batch of genome rows (a CUDA scan kernel on the card), keep the
span-start minimizers with their row's taxon, then one sort by key (two
stable torch.sort passes over the limbs of wide keys) and a segment LCA
per run of equal keys. Every valid window's minimizer is the minimizer
of its span's start, so these records hold exactly each sequence's distinct
valid-window minimizers; LCA ignores order and duplicates, so no
(key, taxon) pair sort or dedup is needed.

IndexParams and the host-side fragment splitting follow
slacken_tpu/index.py's.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch

from . import storage, to_device
from .ops import encode, ordering
from .ops.lca import segment_lca_table
from .ops.lookup import Directory, build_directory
from .ops.minimizers import DEFAULT_TOGGLE_MASK, MinimizerParams, window_minimizers_packed
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


def _sort_records(keys: torch.Tensor, taxa: torch.Tensor):
    """(keys, taxa) sorted by key. Wide keys [R, 2] sort by (hi64, lo64
    unsigned): torch.sort takes one key, so lo64 first, its sign bit flipped,
    then hi64 with a stable sort."""
    if keys.dim() == 1:
        keys, order = torch.sort(keys)
        return keys, taxa[order]
    order = torch.sort(keys[:, 1] ^ -(1 << 63)).indices
    order = order[torch.sort(keys[order, 0], stable=True).indices]
    return keys[order], taxa[order]


def _default_batch(device: torch.device) -> Tuple[int, int]:
    """(rows, row length) per build batch: 32 Mbp in 4 kbp rows on the card
    (one scan block per row, several waves of blocks on 132 SMs), 2 Mbp on
    the CPU. The split overlaps rows by k-1, so it never changes the index."""
    return (8192, 1 << 12) if device.type == "cuda" else (512, 1 << 12)


def _batches(fragments, params: IndexParams, taxonomy: Taxonomy, batch_rows: int,
             row_len: int):
    """Host side of the build: (codes [batch_rows, row_len] uint8, row taxa)
    batches, splitting sequences longer than row_len with k-1 overlap and
    skipping taxa the taxonomy does not define (as slacken_tpu's build)."""
    rows: List[np.ndarray] = []
    row_taxa: List[int] = []

    def flush():
        codes = np.full((batch_rows, row_len), encode.INVALID, np.uint8)
        for r, seq in enumerate(rows):
            codes[r, : len(seq)] = seq
        taxa = np.zeros(batch_rows, np.int32)
        taxa[: len(row_taxa)] = row_taxa
        rows.clear()
        row_taxa.clear()
        return codes, taxa

    step = row_len - (params.k - 1)
    for taxon, seq in fragments:
        taxon = int(taxonomy.primary[taxon]) if taxon < len(taxonomy.primary) else taxon
        if not taxonomy.is_defined(taxon):
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
    `ordering_lut` is the uint32 rank table of an explicit ordering."""

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

    def device_arrays(self, device) -> Tuple[torch.Tensor, torch.Tensor, Directory]:
        """(keys, taxa, prefix directory) on `device`, copied or built there once."""
        device = torch.device(device)
        if device not in self._on:
            keys = self.keys_t.to(device)
            self._on[device] = (keys, self.taxa_t.to(device), build_directory(keys))
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
    ) -> "KeyValueIndex":
        """Build from (taxon, sequence) pairs on `device`. `ordering_lut` is
        the rank table of a "frequency" or "given" ordering."""
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
        for codes, row_taxa in _batches(fragments, params, taxonomy, batch_rows, row_len):
            packed, valid = encode.pack_2bit(codes)
            wm = window_minimizers_packed(to_device(packed, device), to_device(valid, device), mp, lut)
            rt = torch.from_numpy(row_taxa).to(device)
            keys_parts.append(wm.minimizer[wm.span_start])
            taxa_parts.append(rt[:, None].expand(-1, row_len)[wm.span_start])
        if not keys_parts:
            empty = torch.zeros((0, 2) if mp.wide else 0, dtype=torch.int64, device=device)
            no_taxa = torch.zeros(0, dtype=torch.int32, device=device)
            return cls(empty, no_taxa, params, taxonomy, None, ordering_lut)
        keys = torch.cat(keys_parts)
        taxa = torch.cat(taxa_parts)
        del keys_parts, taxa_parts
        keys, taxa = _sort_records(keys, taxa)
        new = torch.ones_like(taxa, dtype=torch.bool)
        differs = keys[1:] != keys[:-1]
        new[1:] = differs.any(1) if mp.wide else differs
        del differs
        run_ids = torch.cumsum(new, 0) - 1
        uniq = keys[new]
        table = torch.from_numpy(taxonomy.rpath_table()).to(device)
        red = segment_lca_table(run_ids, taxa, table, int(uniq.shape[0]))
        idx = cls(uniq, red, params, taxonomy, None, ordering_lut)
        if lut is not None:
            idx._luts[device] = lut  # the build's copy serves classify on this device
        return idx

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
        self.taxonomy.save(storage.join(location, "taxonomy"))
        self.location = location

    @classmethod
    def load(cls, location: str, taxonomy: Optional[Taxonomy] = None) -> "KeyValueIndex":
        with storage.open_file(storage.join(location, "params.json")) as f:
            meta = json.load(f)
        params = IndexParams.from_json(meta)
        if "shards" in meta:
            raise NotImplementedError(
                "sharded indexes are not ported yet (ROADMAP.md, port queue: multi-GPU)"
            )
        keys = storage.np_load(storage.join(location, "keys.npy"), mmap=False).astype(np.uint64)
        taxa = storage.np_load(storage.join(location, "taxa.npy"), mmap=False).astype(np.int32)
        if taxonomy is None:
            taxonomy = Taxonomy.load(storage.join(location, "taxonomy"))
        lut = None
        if storage.exists(storage.join(location, "ordering_lut.npy")):
            lut = storage.np_load(storage.join(location, "ordering_lut.npy"), mmap=False).astype(np.uint32)
        return cls(
            torch.from_numpy(keys.view(np.int64)), torch.from_numpy(taxa), params,
            taxonomy, location, lut,
        )
