"""The minimizer-LCA key-value index (counterpart of slacken_tpu/index.py).

Same on-disk layout, so each package loads the other's index:

    <loc>/params.json       k, m, spaces, toggle mask, canonical, counts
    <loc>/keys.npy          uint64 [N] sorted ascending
    <loc>/taxa.npy          int32  [N]
    <loc>/taxonomy/         nodes.dmp, names.dmp, merged.dmp

Narrow (m <= 31) XOR-ordered builds only. The build is one pass: scan each
batch of genome rows (the CUDA scan kernel on the card), keep the span-start
minimizers with their row's taxon, then one torch.sort by key and a segment
LCA per run of equal keys. Every valid window's minimizer is the minimizer
of its span's start, so these records hold exactly each sequence's distinct
valid-window minimizers; LCA ignores order and duplicates, so no
(key, taxon) pair sort or dedup is needed.

IndexParams and the host-side fragment splitting are copies of
slacken_tpu/index.py's (that module imports JAX).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch

from slacken_tpu import storage
from slacken_tpu.taxonomy import Taxonomy

from . import to_device
from .ops import encode
from .ops.lca import segment_lca_table
from .ops.lookup import build_fence
from .ops.minimizers import DEFAULT_TOGGLE_MASK, MinimizerParams, window_minimizers_packed

FORMAT_VERSION = 1
NOT_PORTED = "ROADMAP.md, port queue: explicit orderings and wide keys"


@dataclass
class IndexParams:
    k: int = 35
    m: int = 31
    spaces: int = 7
    toggle_mask: int = DEFAULT_TOGGLE_MASK
    canonical: bool = True
    buckets: int = 200
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


def _check_supported(params: IndexParams) -> None:
    if params.ordering != "xor":
        raise NotImplementedError(
            f"ordering {params.ordering!r} is not ported yet ({NOT_PORTED})"
        )
    if params.m > 31:
        raise NotImplementedError(f"wide keys (m = {params.m} > 31) are not ported yet ({NOT_PORTED})")


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
    Keys and taxa live as torch tensors on one device (int64 keys: every
    key is below 2^62); the host arrays materialise on demand."""

    def __init__(self, keys: torch.Tensor, taxa: torch.Tensor, params: IndexParams,
                 taxonomy: Taxonomy, location: Optional[str] = None):
        _check_supported(params)
        self.keys_t = keys.to(torch.int64)
        self.taxa_t = taxa.to(torch.int32)
        self.params = params
        self.taxonomy = taxonomy
        self.location = location
        self._on = {}

    @property
    def num_records(self) -> int:
        return int(self.keys_t.shape[0])

    @property
    def keys(self) -> np.ndarray:
        """Host uint64 keys (the on-disk dtype)."""
        return self.keys_t.cpu().numpy().view(np.uint64)

    @property
    def taxa(self) -> np.ndarray:
        return self.taxa_t.cpu().numpy()

    def device_arrays(self, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(keys, taxa, fence) on `device`, copied there once."""
        device = torch.device(device)
        if device not in self._on:
            keys = self.keys_t.to(device)
            self._on[device] = (keys, self.taxa_t.to(device), build_fence(keys))
        return self._on[device]

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
    ) -> "KeyValueIndex":
        """Build from (taxon, sequence) pairs on `device`."""
        _check_supported(params)
        device = torch.device(device)
        mp = params.minimizer_params.validate()
        d_rows, d_len = _default_batch(device)
        batch_rows = batch_rows or d_rows
        row_len = row_len or d_len
        if row_len % 8 or row_len < params.k:
            raise ValueError(f"row_len must be a multiple of 8 and >= k, got {row_len}")
        keys_parts, taxa_parts = [], []
        for codes, row_taxa in _batches(fragments, params, taxonomy, batch_rows, row_len):
            packed, valid = encode.pack_2bit(codes)
            wm = window_minimizers_packed(to_device(packed, device), to_device(valid, device), mp)
            rt = torch.from_numpy(row_taxa).to(device)
            keys_parts.append(wm.minimizer[wm.span_start])
            taxa_parts.append(rt[:, None].expand(-1, row_len)[wm.span_start])
        if not keys_parts:
            empty = torch.zeros(0, dtype=torch.int64, device=device)
            return cls(empty, empty.to(torch.int32), params, taxonomy)
        keys = torch.cat(keys_parts)
        taxa = torch.cat(taxa_parts)
        del keys_parts, taxa_parts
        keys, order = torch.sort(keys)
        taxa = taxa[order]
        del order
        new = torch.ones_like(keys, dtype=torch.bool)
        new[1:] = keys[1:] != keys[:-1]
        run_ids = torch.cumsum(new, 0) - 1
        uniq = keys[new]
        table = torch.from_numpy(taxonomy.rpath_table()).to(device)
        red = segment_lca_table(run_ids, taxa, table, int(uniq.shape[0]))
        return cls(uniq, red, params, taxonomy)

    # -- persistence --------------------------------------------------------

    def save(self, location: str):
        storage.makedirs(location)
        meta = self.params.to_json()
        meta["num_records"] = self.num_records
        with storage.open_file(storage.join(location, "params.json"), "w") as f:
            json.dump(meta, f, indent=2)
        storage.np_save(storage.join(location, "keys.npy"), self.keys)
        storage.np_save(storage.join(location, "taxa.npy"), self.taxa)
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
        return cls(
            torch.from_numpy(keys.view(np.int64)), torch.from_numpy(taxa), params,
            taxonomy, location,
        )
