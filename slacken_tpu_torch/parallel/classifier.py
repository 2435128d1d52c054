"""Classification and index build over a device mesh (counterpart of
slacken_tpu/parallel/classifier.py), in one process.

`MeshClassifier` is a `Classifier` whose batches run over a `mesh.Mesh`:
replicated (the index on every device, the rows split) or ring (the index cut
into key ranges, the queries going round). Everything on the host (packing,
the pipeline, per-threshold finalisation, per-read lines, reports) is the
single-device classifier's, so `classify --devices N` writes the files of a
single-device run byte for byte.

`build_distributed` builds the index with the mesh's shuffle: each device
scans its share of a batch's rows and sends every span-start record to the
device that owns its key range, and each owner collects its range in a
bounded merge tree (index.MergeTree) on its device.
The ranges are disjoint and in key order, so the concatenation is the
single-device build's index (and sidecar) exactly.
"""

from __future__ import annotations

import os
import shutil
from typing import Iterable, Optional, Set, Tuple

import numpy as np
import torch

from .. import to_device
from ..classify import Classifier
from ..index import (
    IndexParams,
    KeyValueIndex,
    MergeTree,
    _batches,
    _default_batch,
    _rank_table,
    by_owner,
    default_device_budget,
    sample_boundaries,
)
from ..ops import encode
from ..ops.lookup import probe_bytes
from ..ops.minimizers import window_minimizers_packed
from ..taxonomy import Taxonomy
from . import mesh as pmesh

LAYOUTS = ("replicated", "ring")
#: the probes that a mesh runs as asked; the JAX package's MeshClassifier
#: runs the routed probe for the others (hashed128, bucketed), in both layouts
MESH_PROBES = ("routed", "tiled", "hashed1", "hashed")


class MeshClassifier(Classifier):
    """Classifier running each batch over `mesh` (a mesh.Mesh or a list of
    devices). layout 'replicated': the index on every device, a batch's rows
    split into contiguous chunks, one a device. layout 'ring': the index cut
    into len(mesh) key ranges, one a device, and the queries going round.
    `probe` as for Classifier: in the ring each shard has its own table.
    hashed128 and bucketed run the routed probe over a mesh
    (`mesh_probe`), as the JAX package's MeshClassifier runs them."""

    def __init__(self, index: KeyValueIndex, mesh, layout: str = "replicated", max_taxa_per_read: int = 32,
                 probe: Optional[str] = None):
        if layout not in LAYOUTS:
            raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
        self.mesh = pmesh.as_mesh(mesh)
        self.layout = layout
        super().__init__(index, self.mesh[0], max_taxa_per_read, probe)

    @property
    def mesh_probe(self) -> str:
        """The probe the mesh's devices run: `probe`, or routed for hashed128
        and bucketed."""
        return self.probe if self.probe in MESH_PROBES else "routed"

    def _place_index(self) -> None:
        """Per device, once: the rank table and the rpath table; the probe
        arrays of the whole index (replicated, made once a device, so a
        repeated device shares them) or of its shard (ring)."""
        idx = self.index
        table = torch.from_numpy(idx.taxonomy.rpath_table())
        self._luts = {d: idx.device_lut(d) for d in self.mesh.distinct}
        self._tables = {d: table.to(d) for d in self.mesh.distinct}
        if self.layout == "replicated":
            self._arrays = [idx.device_arrays(d, self.mesh_probe) for d in self.mesh]
        else:
            self._arrays = self._ring_shards()
        self._index_bytes = probe_bytes(self._arrays)  # a repeated device's arrays once

    def _ring_shards(self):
        """The ring's shards, one a mesh entry: the index cut into key ranges."""
        return pmesh.shard_index(self.index, self.mesh, self.mesh_probe)

    def _padded_rows(self, n: int) -> int:
        """A power of two and a multiple of the mesh size: chunks of equal rows."""
        return -(-super()._padded_rows(n) // len(self.mesh)) * len(self.mesh)

    def scan_probe(self, packed: np.ndarray, valid: np.ndarray):
        n = len(self.mesh)
        if packed.shape[0] % n:  # INVALID rows (all bits clear): no valid window
            extra = n - packed.shape[0] % n
            packed = np.pad(packed, ((0, extra), (0, 0)))
            valid = np.pad(valid, ((0, extra), (0, 0)))
        fn = pmesh.scan_probe_replicated if self.layout == "replicated" else pmesh.scan_probe_ring
        return fn(self.mesh, self._arrays, self._luts, packed, valid, self.index.params.minimizer_params)

    def _classify_packed_rows(self, packed, valid, ambig, tmax: int, valid_dev=None):
        req_luts = {d: self._req_lut(tmax, d) for d in self.mesh.distinct}
        return pmesh.classify_rows(self.mesh, self.scan_probe(packed, valid), ambig, self._tables, req_luts,
                                   self.max_taxa)


def requested_mesh(device="cuda", devices=None, layout: Optional[str] = None) -> Optional[pmesh.Mesh]:
    """The mesh that `devices` (a number of devices of `device`'s kind, as
    mesh.make_mesh takes it, or a Mesh) and `layout` ask for, or None for a
    single-device run: neither given, or one device in the replicated layout."""
    if devices is None and layout is None:
        return None
    mesh = devices if isinstance(devices, pmesh.Mesh) else pmesh.make_mesh(devices, device)
    return None if len(mesh) == 1 and layout in (None, "replicated") else mesh


def make_classifier(index: KeyValueIndex, device="cuda", devices=None, layout: Optional[str] = None,
                    **kwargs) -> Classifier:
    """The CLI's classifier: a MeshClassifier over `requested_mesh`, or the
    single-device Classifier on `device`; `kwargs` (max_taxa_per_read,
    probe) go to either."""
    mesh = requested_mesh(device, devices, layout)
    if mesh is None:
        return Classifier(index, device, **kwargs)
    return MeshClassifier(index, mesh, layout or "replicated", **kwargs)


def build_distributed(
    fragments: Iterable[Tuple[int, str]],
    params: IndexParams,
    taxonomy: Taxonomy,
    mesh,
    batch_rows: Optional[int] = None,
    row_len: Optional[int] = None,
    ordering_lut: Optional[np.ndarray] = None,
    taxon_filter: Optional[Set[int]] = None,
    keep_records: bool = False,
    spill_dir: Optional[str] = None,
    superbatch: Optional[int] = None,
    device_budget: Optional[int] = None,
) -> KeyValueIndex:
    """KeyValueIndex.build over `mesh` (a mesh.Mesh or a list of devices)
    with the key-range shuffle: the batches of `index._batches` (default
    size that of mesh[0]'s kind) are split into len(mesh) contiguous chunks
    of rows; each device scans its chunk and keeps its span-start (key,
    taxon) records; each record goes to the owner of its key's range (range
    boundaries: the n-quantiles of the first batch's span keys); each owner
    collects its records in a MergeTree on its device (with `keep_records`,
    distinct pairs), which a device's share of `device_budget` (bytes;
    default default_device_budget) bounds, with `spill_dir` spilling to the
    range files of its own subdirectory `owner<j:04d>` (`spill_dir` is
    removed after the build). The ranges concatenated in key order are the
    index, and with `keep_records` its sidecar: on mesh[0] where every
    owner's result stayed on its device and together they take at most half
    of mesh[0]'s budget, else on the host."""
    mesh = pmesh.as_mesh(mesh)
    n = len(mesh)
    mp = params.minimizer_params.validate()
    ordering_lut = _rank_table(params, ordering_lut)
    luts = {d: None if ordering_lut is None else torch.from_numpy(ordering_lut.astype(np.int32)).to(d)
            for d in mesh.distinct}
    d_rows, d_len = _default_batch(mesh[0])
    batch_rows = batch_rows or d_rows
    row_len = row_len or d_len
    if row_len % 8 or row_len < params.k:
        raise ValueError(f"row_len must be a multiple of 8 and >= k, got {row_len}")
    budgets = {d: default_device_budget(d) if device_budget is None else device_budget for d in mesh.distinct}
    trees = [MergeTree(dev, taxonomy, params.m, pairs=keep_records, superbatch=superbatch,
                       device_budget=None if budgets[dev] is None else budgets[dev] // list(mesh).count(dev),
                       spill_dir=spill_dir and os.path.join(spill_dir, f"owner{j:04d}"))
             for j, dev in enumerate(mesh)]
    bounds = None
    for codes, row_taxa, used in _batches(fragments, params, taxonomy, batch_rows, row_len, taxon_filter):
        records = []
        for (a, b), dev in zip(pmesh.chunk_bounds(used, n), mesh):
            if a == b:
                continue
            packed, valid = encode.pack_2bit(codes[a:b])
            wm = window_minimizers_packed(to_device(packed, dev), to_device(valid, dev), mp, luts[dev])
            rt = torch.from_numpy(row_taxa[a:b]).to(dev)
            records.append((wm.minimizer[wm.span_start], rt[:, None].expand(-1, row_len)[wm.span_start]))
        if bounds is None:
            bounds = sample_boundaries(torch.cat([k.to(mesh[0]) for k, _ in records]), n, params.m)
        for keys, taxa in records:
            for j, (k, t) in enumerate(by_owner(keys, taxa, bounds, n)):
                trees[j].add(k.to(mesh[j], non_blocking=True), t.to(mesh[j], non_blocking=True))
    ranges = [tree.finish() for tree in trees]
    if spill_dir:
        shutil.rmtree(spill_dir, ignore_errors=True)
    # the ranges gather on mesh[0] where each stayed on its device and their
    # copies there and the concatenation take at most half of mesh[0]'s
    # budget, as in MergeTree._out (on distinct cards each owner had a whole
    # card's budget, so together they may not fit on one), else on the host
    held = 2 * sum(x.numel() * x.element_size() for r in ranges for x in r)
    fits = budgets[mesh[0]] is None or held <= budgets[mesh[0]] // 2
    on_devices = all(r[0].device.type == dev.type for r, dev in zip(ranges, mesh))
    home = mesh[0] if fits and on_devices else torch.device("cpu")
    # a copy to the host waits (a non_blocking one would land in pinned memory
    # that is read before the copy ends)
    cols = [torch.cat([r[c].to(home, non_blocking=home.type == "cuda") for r in ranges])
            for c in range(len(ranges[0]))]
    idx = KeyValueIndex(cols[0], cols[1], params, taxonomy, None, ordering_lut)
    if keep_records:
        idx.record_keys_t, idx.record_taxa_t = cols[2], cols[3]
    if luts[mesh[0]] is not None:
        idx._luts[mesh[0]] = luts[mesh[0]]  # the build's copy serves classify on this device
    idx.build_stats = [tree.stats for tree in trees]
    return idx
