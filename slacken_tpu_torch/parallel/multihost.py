"""Several processes (counterpart of slacken_tpu/parallel/multihost.py) on
`torch.distributed`.

The reference scales across machines with a Spark cluster; the JAX package
with one `jax.distributed` process a host. Here one process a rank joins a
`torch.distributed` process group (NCCL between cards, gloo on the CPU), and
each rank holds a local `mesh.Mesh` of L entries. The ranks' meshes in rank
order form one global ring of P * L entries: entry g = rank * L + i. A
`save_sharded` index of S shard files (S a multiple of P * L) is cut so that
entry g loads only files g * S/(P*L) ... (g + 1) * S/(P*L) - 1, and the
queries go round the whole ring. A hop inside a rank is a copy between its
devices (as in mesh.py); the hop from a rank's last entry to the next rank's
entry 0 is a `dist.batch_isend_irecv` (`BoundaryHop`).

Usage (the same program on every rank):

    from slacken_tpu_torch.parallel import multihost

    ctx = multihost.initialize("host:port", num_processes, process_id)
    cls = multihost.MultiHostRingClassifier("idx_sharded", ctx)
    cls.classify_and_write_stream(lambda: packed_reads(...), "out/o", cpar)
    multihost.shutdown()

Without a coordinator (and without torchrun's environment) `initialize`
returns the one-process context and creates no group, and every function
degenerates to the local behaviour, as the JAX module does.

The probe (`mh_probe`, STPU_MH_PROBE, the CLI's --probe) is routed, tiled,
hashed or hashed1, wide indexes routed or hashed1, as the JAX package takes
them (hashed128 and bucketed are refused there and here); each ring entry
builds its own table from its shard (`ring_index_for_host`: for hashed and
hashed1 the counterpart of `ring_hashed_tables_for_host`'s two kinds, an
entry of an empty key range the 3 sentinel rows of an empty build_hashed).
The JAX function agrees one table geometry across processes by an
allgather fixed point because its probe is one SPMD program; the port's
kernels take each shard's own geometry and length and give the same
answers, so the ranks agree on nothing and pad no shard. `global_rows` and
`collect_local` have no counterpart: they are the plumbing of jax.Arrays
that span processes; here each rank keeps its own rows, as the port's mesh
keeps each device's rows (mesh.py's psum).
"""

from __future__ import annotations

import collections
import datetime
import json
import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from .. import native, storage
from ..classify import _row_length_bucket
from ..index import KeyValueIndex
from ..ops import encode
from . import mesh as pmesh
from .classifier import MeshClassifier

#: how long a collective waits for the other ranks before the run fails
TIMEOUT = datetime.timedelta(seconds=300)


@dataclass
class HostContext:
    """This process's place in the (possibly one-process) job, with its
    local mesh and the process group's backend (None without a group)."""

    process_index: int
    process_count: int
    local_device_count: int
    global_device_count: int
    mesh: pmesh.Mesh
    backend: Optional[str] = None

    @property
    def is_distributed(self) -> bool:
        return self.process_count > 1


def _init_method(address: str) -> str:
    """host:port -> tcp://host:port; a URL (tcp://, file://, env://) as is."""
    return address if "://" in address else f"tcp://{address}"


def local_mesh(device="cuda", devices=None, process_id: int = 0) -> pmesh.Mesh:
    """A rank's local mesh: `devices` (a Mesh, or a number of entries,
    default 1) of `device`. A "cuda" without an index is the rank's card:
    cuda:<LOCAL_RANK>, or cuda:<process_id % device_count> without torchrun's
    LOCAL_RANK."""
    if isinstance(devices, (pmesh.Mesh, list, tuple)):
        return pmesh.as_mesh(devices)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        from .. import get_device

        get_device("cuda")
        local = os.environ.get("LOCAL_RANK")
        device = torch.device("cuda", int(local) if local is not None else process_id % torch.cuda.device_count())
    return pmesh.Mesh([device] * (devices or 1))


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device="cuda",
    devices=None,
    backend: Optional[str] = None,
) -> HostContext:
    """Join the process group when one is asked for, and return this
    process's context; otherwise the local one-process context, with no
    group.

    A group is asked for by `coordinator_address` (host:port, or an
    init_method URL such as file:///shared/rdzv) with `num_processes` and
    `process_id`, or by torchrun's environment (MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK). The backend is NCCL when the local mesh is on the
    card and gloo on the CPU, unless `backend` says otherwise: gloo on the
    card moves each boundary hop through host memory (two ranks cannot share
    one card under NCCL). Nothing switches backend on a failure. A
    collective that waits longer than TIMEOUT for the other ranks fails the
    run. Safe to call again once the group exists."""
    import torch.distributed as dist

    if coordinator_address is not None:
        url = _init_method(coordinator_address)
    elif "MASTER_ADDR" in os.environ and "MASTER_PORT" in os.environ:
        url = "env://"
    else:
        url = None
    if url is None and not dist.is_initialized():
        mesh = local_mesh(device, devices)
        return HostContext(0, 1, len(mesh), len(mesh), mesh)
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    else:
        world = int(num_processes if num_processes is not None else os.environ["WORLD_SIZE"])
        rank = int(process_id if process_id is not None else os.environ["RANK"])
        if not 0 <= rank < world:
            raise ValueError(f"process id {rank} is outside a world of {world} processes")
    mesh = local_mesh(device, devices, rank)
    if not dist.is_initialized():
        backend = backend or ("nccl" if mesh[0].type == "cuda" else "gloo")
        kwargs = {}
        if backend == "nccl":
            torch.cuda.set_device(mesh[0])
            kwargs["device_id"] = mesh[0]
        dist.init_process_group(backend, init_method=url, world_size=world, rank=rank, timeout=TIMEOUT, **kwargs)
    return HostContext(rank, world, len(mesh), world * len(mesh), mesh, dist.get_backend())


def shutdown() -> None:
    """Leave the process group, if there is one."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def host_shard_ids(n_shards: int, ctx: HostContext) -> List[int]:
    """Contiguous shard ids owned by this process (ranges in rank order, so
    that their concatenation across processes is the sorted key array)."""
    bounds = np.linspace(0, n_shards, ctx.process_count + 1).astype(int)
    return list(range(bounds[ctx.process_index], bounds[ctx.process_index + 1]))


def _shard_count(location: str) -> int:
    with storage.open_file(storage.join(location, "params.json")) as f:
        return len(json.load(f)["shards"])


def load_index_for_host(location: str, ctx: HostContext, taxonomy=None) -> KeyValueIndex:
    """Only this process's key-range shards of a `save_sharded` layout: the
    processes' ranges tile the index exactly."""
    return KeyValueIndex.load_shards(location, host_shard_ids(_shard_count(location), ctx), taxonomy=taxonomy)


def ring_index_for_host(location: str, ctx: HostContext, taxonomy=None, probe: str = "routed") -> list:
    """The ring's shards of this process's mesh entries, each as
    `lookup.probe` reads it on its device for `probe` (its own tiled,
    hashed or row-bucket table for those probes): global entry g = rank * L
    + i owns shard files g * s0 ... (g + 1) * s0 - 1, s0 = files / (P * L),
    and this process loads only those of its own entries. Shards may differ
    in length; nothing is padded."""
    n_shards, n = _shard_count(location), ctx.global_device_count
    if n_shards % n:
        raise ValueError(f"{n_shards} shard files not divisible by {n} devices")
    s0 = n_shards // n
    shards = []
    for i, dev in enumerate(ctx.mesh):
        g = ctx.process_index * ctx.local_device_count + i
        part = KeyValueIndex.load_shards(location, range(g * s0, (g + 1) * s0), taxonomy=taxonomy)
        shards.append(pmesh.place_shard(part, dev, probe))
    return shards


def allgather_objects(obj) -> list:
    """One picklable object a process, gathered in process order on every
    process; [obj] without a group."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def report_counts_across_hosts(local_counts: np.ndarray) -> np.ndarray:
    """Per-taxon report counts summed over the processes (an all_reduce; on
    the card under NCCL); the array itself without a group."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return np.asarray(local_counts)
    dev = torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl" else torch.device("cpu")
    t = torch.from_numpy(np.asarray(local_counts, np.int64).copy()).to(dev)
    dist.all_reduce(t)
    return t.cpu().numpy()


class BoundaryHop:
    """The ring's hop across processes: this process's last entry sends its
    tensors to the next process (rank + 1) and its entry 0 receives the
    previous process's (rank - 1), in one `dist.batch_isend_irecv`. Every
    process sends tensors of the shapes it receives. Under gloo a tensor on
    the card goes through host memory. Counts the bytes sent."""

    def __init__(self, ctx: HostContext):
        self.world = ctx.process_count
        self.next = (ctx.process_index + 1) % ctx.process_count
        self.prev = (ctx.process_index - 1) % ctx.process_count
        self.device = ctx.mesh[0]
        self.via_host = ctx.backend != "nccl" and self.device.type == "cuda"
        self.bytes_sent = 0

    def __call__(self, tensors):
        import torch.distributed as dist

        sends = [(t.cpu() if self.via_host else t).contiguous() for t in tensors]
        recvs = [torch.empty_like(t) for t in sends]
        ops = [dist.P2POp(dist.isend, t, self.next, tag=i) for i, t in enumerate(sends)]
        ops += [dist.P2POp(dist.irecv, t, self.prev, tag=i) for i, t in enumerate(recvs)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()  # under NCCL: the current stream waits, the host does not
        self.bytes_sent += sum(t.numel() * t.element_size() for t in sends)
        return tuple(t.to(self.device, non_blocking=True) if self.via_host else t for t in recvs)


class MultiHostRingClassifier(MeshClassifier):
    """Classification over processes: each loads only its own key-range
    shards of a `save_sharded` index (`ring_index_for_host`), its local mesh
    entries and those of every other process form one ring, and the queries
    go round it, crossing between processes through `BoundaryHop`.

    Lockstep: every process must make the same hops with tensors of the same
    shapes, so batches are of one fixed (rows, bucket) shape
    (`set_lockstep`); each process classifies a contiguous share of the read
    stream, pads its last batch with INVALID rows, and issues whole
    all-INVALID batches until it has issued as many as the largest share
    needs. Per-read lines go to part-<process:05d>.txt.gz in each sample's
    directory, so that the part files joined in name order are the
    one-process output; the kreports are merged across processes and
    written by process 0.

    `mh_probe` (default STPU_MH_PROBE, else "routed") is the ring's probe:
    routed, tiled, hashed or hashed1, a wide index routed or hashed1; any
    other name raises ValueError, as there."""

    def __init__(self, location: str, ctx: Optional[HostContext] = None, max_taxa_per_read: int = 32,
                 mh_probe: Optional[str] = None):
        self.ctx = ctx or initialize()
        self._location = location
        self.lockstep = None
        self._boundary = BoundaryHop(self.ctx) if self.ctx.is_distributed else None
        self.dispatches = self.padding_dispatches = 0
        # the empty key range: parameters, taxonomy and rank table only;
        # the ring's shards come from the files of this process's entries
        local = KeyValueIndex.load_shards(location, [])
        mh_probe = mh_probe or os.environ.get("STPU_MH_PROBE", "routed")
        if mh_probe not in ("routed", "tiled", "hashed", "hashed1"):
            raise ValueError(f"multi-host ring supports routed/tiled/hashed/hashed1 probes, not {mh_probe!r}")
        if local.wide and mh_probe not in ("routed", "hashed1"):
            raise ValueError("wide (m > 31) multi-host indexes support the routed and hashed1 probes")
        super().__init__(local, self.ctx.mesh, "ring", max_taxa_per_read, mh_probe)
        self._part_index = self.ctx.process_index

    def _ring_shards(self):
        return ring_index_for_host(self._location, self.ctx, self.index.taxonomy, self.probe)

    @property
    def p2p_bytes(self) -> int:
        """Bytes this process has sent to the next one over the ring."""
        return 0 if self._boundary is None else self._boundary.bytes_sent

    def set_lockstep(self, max_share_reads: int, rows: int, bucket: int) -> None:
        """Fix the schedule from the largest share of reads of any process:
        ceil(max_share / rows) batches of `rows` (rounded up to a multiple of
        the local mesh) by `bucket` codes (rounded up to a power of two, at
        least 128). Every process must compute the three inputs from the
        same read stream."""
        n = len(self.mesh)
        rows = -(-rows // n) * n
        self.lockstep = (max(1, -(-int(max_share_reads) // rows)), rows, _row_length_bucket(bucket))

    def _rows_target(self, width: int) -> int:
        return super()._rows_target(width) if self.lockstep is None else self.lockstep[1]

    def _padded_rows(self, n: int) -> int:
        """Every batch is of the lockstep's rows."""
        return self.lockstep[1]

    def scan_probe(self, packed: np.ndarray, valid: np.ndarray):
        return pmesh.scan_probe_ring(self.mesh, self._arrays, self._luts, packed, valid,
                                     self.index.params.minimizer_params, self._boundary)

    def _dispatch(self, codes, titles, splits, row_lens):
        self.dispatches += 1
        if self.dispatches > self.lockstep[0]:
            raise RuntimeError(f"more than the {self.lockstep[0]} batches of set_lockstep's largest share")
        return super()._dispatch(codes, titles, splits, row_lens)

    def _widened(self, packed_iter, bucket: int):
        """The chunks with their rows padded to the bucket's width."""
        for packed in packed_iter:
            codes = np.asarray(packed.codes)
            if codes.shape[1] > bucket:
                raise ValueError(f"read width {codes.shape[1]} exceeds the lockstep bucket {bucket}; "
                                 "compute set_lockstep from the whole input")
            if codes.shape[1] < bucket:
                codes = np.pad(codes, ((0, 0), (0, bucket - codes.shape[1])), constant_values=encode.INVALID)
            yield native.PackedReads(codes, packed.lengths, packed.titles, getattr(packed, "splits", None))

    def packed_batches(self, packed_iter):
        """The single-device pipeline over batches of the lockstep's shape,
        then the all-INVALID batches that bring this process's count up to
        the schedule's (they yield nothing)."""
        if self.lockstep is None:
            raise RuntimeError("call set_lockstep() before classifying")
        n_disp, _, bucket = self.lockstep
        self.dispatches = self.padding_dispatches = 0
        yield from super().packed_batches(self._widened(packed_iter, bucket))
        while self.dispatches < n_disp:
            self.padding_dispatches += 1
            empty = np.full((0, bucket), encode.INVALID, np.uint8)
            for _ in self._drain(collections.deque([self._dispatch(empty, [], [], [])]), 0):
                pass

    def classify_and_write_stream(self, chunks, output_location: str, cpar, rows: Optional[int] = None):
        """Classify this process's share of a read stream that every process
        reads whole, and write as classify_and_write_packed does (part files
        of this process, kreports merged by process 0). `chunks()` gives the
        stream's native.PackedReads anew: a first pass counts the reads and
        the widest row, the same on every process; process p takes reads
        [p * n // P, (p + 1) * n // P). `rows` (default the single-device
        batch for the bucket, 4 Mbp on the card) sets the lockstep batch."""
        total, width = 0, 1
        for p in chunks():
            total += len(p)
            width = max(width, p.codes.shape[1])
        nproc, me = self.ctx.process_count, self.ctx.process_index
        lo, hi = me * total // nproc, (me + 1) * total // nproc
        share_max = max((q + 1) * total // nproc - q * total // nproc for q in range(nproc))
        self.set_lockstep(share_max, rows or super()._rows_target(_row_length_bucket(width)), width)

        def share():
            i = 0
            for p in chunks():
                n = len(p)
                a, b = max(lo, i), min(hi, i + n)
                if b > a:
                    sl = slice(a - i, b - i)
                    splits = getattr(p, "splits", None)
                    yield native.PackedReads(np.asarray(p.codes)[sl], np.asarray(p.lengths)[sl], list(p.titles)[sl],
                                             None if splits is None else np.asarray(splits)[sl])
                i += n

        return self.classify_and_write_packed(share(), output_location, cpar)

    def classify_and_write(self, fragments, output_location: str, cpar):
        raise NotImplementedError("across processes, classify packed reads: classify_and_write_stream or "
                                  "classify_and_write_packed")

    def _write_reports(self, counts, output_location: str, cpar):
        """Merge the (threshold, sample, taxon, count) rows of every process;
        process 0 writes the kreports. Every process returns the same sample
        lists."""
        thr = list(counts)
        rows = [(i, sample, int(taxon), int(c)) for i, t in enumerate(thr)
                for sample, agg in counts[t].items() for taxon, c in agg.items()]
        merged = {t: {} for t in thr}
        for proc_rows in allgather_objects(rows):
            for i, sample, taxon, c in proc_rows:
                agg = merged[thr[i]].setdefault(sample, {})
                agg[taxon] = agg.get(taxon, 0) + c
        if self.ctx.process_index == 0:
            return super()._write_reports(merged, output_location, cpar)
        return {t: list(per) for t, per in merged.items()}
