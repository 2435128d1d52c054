"""The device mesh in one process (counterpart of slacken_tpu/parallel/mesh.py).

A `Mesh` is an ordered list of torch devices, one a shard, in the role of a
one-axis `jax.sharding.Mesh`. A device may appear more than once: on the CPU
that is the only way to have several shards, and on one card it runs every
shard's work on that card. Each shard's tensors live on its device, and the
JAX package's collectives become explicit copies between devices (`t.to(dev,
non_blocking=True)`, which PyTorch orders against the current streams of
both devices; on a repeated device the copy is the tensor itself, so nothing
here updates a tensor in place):

  * **replicated**: every device holds the whole index (its probe arrays
    for the classifier's probe, made once a device) and scans and probes its contiguous chunk of a
    batch's rows (`scan_probe_replicated`, after classify_replicated_fn);
  * **ring**: the index is cut into len(mesh) contiguous key ranges
    (`shard_index`, np.linspace bounds, so shards differ by at most one key
    and may be empty); each device scans its rows, and the dense minimizers
    go round the ring len(mesh) - 1 times, each shard probing the queries
    that visit it; a last hop brings the answers home (`ring_lookup`, after
    ring_lookup and classify_ring_fn). A key lies in one shard and a miss is
    0, so the running answer is a max. The JAX package compacts the queries
    to one a span before the ring to save ICI bandwidth; compaction does not
    change a result, and it is left out here;
  * **the build shuffle** (after sample_shuffle_boundaries and
    build_shuffle_fn, narrow and wide): each device scans its rows and keeps
    its span-start (key, taxon) records; the owner of a record is the number
    of range boundaries at or below its key (`owners`), the boundaries being
    the n-quantiles of the first batch's span keys (`sample_boundaries`), and
    each owner receives its slice of every device's records (`by_owner`).
    These three live in index.py, whose SpillCollector cuts ranges the same
    way, and parallel/classifier.py's build_distributed runs the shuffle.

The psum of per-taxon report counts has no counterpart: the host counts
reports from the bundles, as it does for one device. Across processes
(multihost.py) the ring's hop from a process's last entry to the next
process's first is a `torch.distributed` send and receive (`boundary`).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import get_device, to_device
from ..classify import postprocess, scan_probe
from ..index import probe_arrays
from ..ops.lookup import probe
from ..ops.minimizers import window_minimizers_packed


class Mesh:
    """An ordered list of torch devices, one a shard; entries may repeat."""

    def __init__(self, devices: Sequence):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    def __len__(self) -> int:
        return len(self.devices)

    def __iter__(self):
        return iter(self.devices)

    def __getitem__(self, i) -> torch.device:
        return self.devices[i]

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"

    @property
    def distinct(self) -> Tuple[torch.device, ...]:
        """The devices of the mesh, each once, in mesh order."""
        return tuple(dict.fromkeys(self.devices))


def as_mesh(mesh) -> Mesh:
    return mesh if isinstance(mesh, Mesh) else Mesh(mesh)


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> Mesh:
    """A mesh of `n_devices` devices of `device`'s kind: cuda:0 ... cuda:n-1
    on the card (default: every card), n entries of the CPU on the CPU
    (default 1). Asking for more cards than the machine has raises, as
    slacken_tpu's make_mesh does: nothing folds the mesh onto fewer cards or
    repeats a card (build Mesh([cuda:0] * n) for that)."""
    device = get_device(str(device))
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"a mesh needs at least one device, got {n_devices}")
    if device.type == "cuda":
        count = torch.cuda.device_count()
        n = count if n_devices is None else n_devices
        if n > count:
            raise ValueError(f"requested a {n}-device mesh but the machine has {count} CUDA devices")
        return Mesh([torch.device("cuda", i) for i in range(n)])
    return Mesh([device] * (n_devices or 1))


def chunk_bounds(rows: int, n: int) -> List[Tuple[int, int]]:
    """Contiguous [a, b) row ranges of n chunks, as even as can be."""
    edges = [i * rows // n for i in range(n + 1)]
    return list(zip(edges[:-1], edges[1:]))


def shard_index(index, mesh: Mesh, probe: str = "routed"):
    """The ring's shards: len(mesh) contiguous key ranges of `index` at
    np.linspace bounds (save_sharded's), each as `lookup.probe` reads it on
    its device for `probe` (index.probe_arrays: keys, taxa and directory on
    the CPU, a slot table on the card, or the shard's own tiled or row-bucket
    table). A shard may be empty. Once the shards' slot tables hold the
    records on the cards, an index whose keys lie on a card hands them over
    (KeyValueIndex.hand_over), so that the cards hold the records once."""
    bounds = np.linspace(0, index.num_records, len(mesh) + 1).astype(np.int64)
    shards = [place_shard(index.with_records(index.keys_t[bounds[i]:bounds[i + 1]],
                                             index.taxa_t[bounds[i]:bounds[i + 1]]), dev, probe)
              for i, dev in enumerate(mesh)]
    if probe == "routed" and index.keys_t.is_cuda and all(s[0] is None for s in shards):
        index.hand_over(index.keys_t.device)
    return shards


def place_shard(shard, dev, probe: str = "routed"):
    """One shard (an index of a key range) as `lookup.probe` reads it on `dev`
    for `probe`. Each shard has a table of its own geometry: the hops carry
    queries and answers, never tables."""
    keys, taxa = shard.keys_t.to(dev), shard.taxa_t.to(dev)
    if keys.data_ptr() % 16:  # the probe kernels load 16 bytes at a time
        keys = keys.clone()
    return probe_arrays(keys, taxa, probe, shard.params.m)


def scan_chunks(mesh: Mesh, packed: np.ndarray, valid: np.ndarray, luts: Dict):
    """Each device's contiguous chunk of pack_2bit's rows, copied to it;
    `luts` maps a device to its rank table (or None)."""
    return [(to_device(packed[a:b], dev), to_device(valid[a:b], dev), luts[dev])
            for (a, b), dev in zip(chunk_bounds(packed.shape[0], len(mesh)), mesh)]


def scan_probe_replicated(mesh: Mesh, arrays, luts: Dict, packed: np.ndarray, valid: np.ndarray, mp):
    """[(WindowMinimizers, looked-up taxa)] a device, in row order: each
    device scans its rows and probes them in its own copy of the index
    (`arrays[i]`: the probe arrays on mesh[i])."""
    return [scan_probe(p, v, *arrays[i], mp, lut)
            for i, (p, v, lut) in enumerate(scan_chunks(mesh, packed, valid, luts))]


def _hop(mesh: Mesh, items, boundary):
    """items[i], a tuple of tensors on mesh[i], moved one step round the ring:
    a copy from mesh[i - 1] to mesh[i], and from the last entry to mesh[0]
    through `boundary` (the next process's entry 0 receives it, and this
    process's entry 0 what the previous process's last entry sent) or, in
    one process, by a copy."""
    last = items[-1]
    first = tuple(t.to(mesh[0], non_blocking=True) for t in last) if boundary is None else boundary(last)
    return [first] + [tuple(t.to(mesh[i], non_blocking=True) for t in items[i - 1]) for i in range(1, len(mesh))]


def ring_lookup(mesh: Mesh, shards, queries: List[torch.Tensor], boundary=None) -> List[torch.Tensor]:
    """The ring: queries[i] (int64 [Q_i] or [Q_i, 2], on mesh[i]) visit every
    shard, one hop from mesh[i] to mesh[i + 1] a step, and each shard probes
    the queries that visit it; answers[i], on mesh[i], is each query's taxon
    in the shard that holds its key, or 0. With a `boundary`
    (multihost.BoundaryHop) the ring runs through boundary.world processes,
    len(mesh) entries each, every one with queries of one shape: the hops
    number len(mesh) * world - 1, then one brings the answers home. Out of
    place throughout: on a repeated device a hop returns the same tensor."""
    n = len(mesh)
    steps = n * (1 if boundary is None else boundary.world)
    qs = list(queries)
    acc = [probe(*shards[i], qs[i]) for i in range(n)]
    for _ in range(steps - 1):
        moved = _hop(mesh, list(zip(qs, acc)), boundary)
        qs = [q for q, _ in moved]
        acc = [torch.maximum(a, probe(*shards[i], q)) for i, (q, a) in enumerate(moved)]
    if steps > 1:  # one last hop brings the answers home
        acc = [a for (a,) in _hop(mesh, [(a,) for a in acc], boundary)]
    return acc


def scan_probe_ring(mesh: Mesh, shards, luts: Dict, packed: np.ndarray, valid: np.ndarray, mp, boundary=None):
    """scan_probe_replicated for the ring: each device scans its rows, and
    their dense minimizers go round the ring of index shards (through
    `boundary` across processes, as ring_lookup)."""
    wms = [window_minimizers_packed(p, v, mp, lut) for p, v, lut in scan_chunks(mesh, packed, valid, luts)]
    looked = ring_lookup(mesh, shards, [wm.minimizer.flatten(0, 1) for wm in wms], boundary)
    return [(wm, a.reshape(wm.valid.shape)) for wm, a in zip(wms, looked)]


def classify_rows(mesh: Mesh, pairs, ambig: np.ndarray, tables: Dict, req_luts: Dict, max_taxa: int):
    """Each device's postprocess of its (scan, probe) pair, then the bundles
    and window taxa gathered onto mesh[0] in row order."""
    out = []
    for (a, b), dev, (wm, looked) in zip(chunk_bounds(ambig.shape[0], len(mesh)), mesh, pairs):
        out.append(postprocess(wm, looked, to_device(ambig[a:b], dev), tables[dev], req_luts[dev], max_taxa))
    home = mesh[0]
    return tuple(torch.cat([x[j].to(home, non_blocking=True) for x in out]) for j in range(2))

