"""Build, load and launch the hand-written CUDA kernels (ops/kernels/*.cu).

The sources compile at first use with nvcc for sm_90a, one compiler process
a source and all at once, into one shared library with a plain C interface,
bound through ctypes (no PyTorch headers, so a build takes seconds). The library's file name carries a hash of the
sources, so a stale binary is never loaded. Kernels launch on PyTorch's
current stream and allocate nothing: the wrappers allocate outputs with
torch.empty, check every input, and raise on any launch error.

`LAUNCHES` counts kernel launches per kernel; a wrapper adds one exactly
where it launches, so a run can show that its main path went through the
kernels.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Optional

import torch

from .lookup import Bucketed, Directory, HashedRows, HashedTable, SlotTable, TiledTable, row_mean
from .minimizers import space_mask_int, wide_toggle_mask

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = sorted(glob.glob(os.path.join(_HERE, "kernels", "*.cu")))
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
NVCC_FLAGS = ["-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a", "-Xcompiler", "-fPIC"]

#: the five mask-idiom kernels (kernels/mask_idioms.cu)
MASK_IDIOMS = ("select", "astype", "concat", "carry", "sum_bool")

#: the probes of the tiled and row-bucket tables (kernels/probe_tables.cu),
#: narrow and wide; of the hashed table in its two layouts and of the
#: bucketed arrays (the same file)
TABLE_PROBES = ("probe_tiled", "probe_tiled_wide", "probe_rows", "probe_rows_wide", "probe_hashed",
                "probe_hashed_cols", "probe_bucketed")

#: scan: the XOR-ordered narrow scan; scan_lut: its rank-table instance;
#: scan_wide, probe_wide: the kernels for m > 31; probe: the directory
#: probe over narrow keys and taxa; probe_slots: the routed probe of a
#: narrow index on the card, over its slot table; scan_stitch: the scan
#: launches (of any of the three) whose rows were cut into segments and
#: stitched inside the launch (kernels/scan.cu, stitch_row), counted beside
#: the scan's own name; hit_runs: per-read mode's reduction of the window
#: taxa (kernels/hitruns.cu)
LAUNCHES: Dict[str, int] = {
    name: 0 for name in ("scan", "scan_lut", "scan_wide", "scan_stitch", "probe", "probe_slots", "probe_wide",
                         *TABLE_PROBES, "hit_runs", *MASK_IDIOMS)
}

#: warps a scan launch should have in flight on each SM: four a scheduler,
#: four schedulers an SM. Fewer rows than `scan_warps` are cut into
#: segments, one warp each
SCAN_WARPS_PER_SM = 16
#: the shortest segment: its warm-up chunk (128 positions computed and not
#: written) then costs at most 6%
MIN_SEGMENT = 2048
#: a segment length is a multiple of the scan's chunk
CHUNK = 128

_lib = None
#: device index -> scan_warps
_scan_warps: Dict[int, int] = {}
#: (device, stream) -> [the sum_bool kernel's two counters, the next launch's parity]
_sum_bool_counters: Dict[tuple, list] = {}
#: (device, stream) -> the segmented scan's int32 arrival counters, one a
#: row, all 0 between launches (the kernel sets each back)
_scan_counters: Dict[tuple, torch.Tensor] = {}
#: (seconds, compiler output) of the build this process ran, if any
build_info: Optional[tuple] = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libstpu_kernels_{h.hexdigest()[:16]}.so")


def build(verbose: bool = False) -> str:
    """Compile the kernels unless this exact source set is already built.
    verbose adds -Xptxas -v (registers, shared memory, spills per kernel) to
    the compiler output kept in `build_info`."""
    global build_info
    path = library_path()
    if os.path.exists(path) and not verbose:
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    nvcc = [_nvcc(), *NVCC_FLAGS]
    objects = [f"{tmp}.{os.path.basename(src)}.o" for src in SOURCES]
    t0 = time.perf_counter()
    try:
        compiles = [
            subprocess.Popen(
                [*nvcc, *(["-Xptxas", "-v"] if verbose else []), "-c", src, "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(SOURCES, objects)
        ]
        outputs = [proc.communicate()[0] for proc in compiles]
        link = subprocess.run([*nvcc, "-shared", "-o", tmp, *objects], capture_output=True, text=True)
        outputs.append(link.stdout + link.stderr)
        failed = [proc.returncode for proc in (*compiles, link) if proc.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed ({failed[0]}):\n" + "\n".join(outputs))
        os.replace(tmp, path)
    finally:
        for obj in objects:
            if os.path.exists(obj):
                os.remove(obj)
    build_info = (time.perf_counter() - t0, "".join(outputs))
    return path


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build())
    p, i32, i64, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_ulonglong
    lib.stpu_scan.argtypes = [p, p, i64, i32, i32, i32, i32, i32, u64, u64, p, p, p, p, p, p, p, p]
    lib.stpu_scan_wide.argtypes = [p, p, i64, i32, i32, i32, i32, i32, u64, u64, u64, u64, p, p, p, p, p, p, p]
    lib.stpu_probe.argtypes = [p, p, i64, p, i64, i32, p, i64, p, p]
    lib.stpu_probe_wide.argtypes = [p, p, p, i64, i32, i32, p, i64, p, p]
    lib.stpu_probe_tiled.argtypes = [p, i64, i32, p, i32, p, i64, p, p]
    lib.stpu_tiled_floor.argtypes = [p, i64, i32, p, i32, p, i64, p, p]
    lib.stpu_probe_bucketed.argtypes = [p, i64, i32, p, p, p, i64, p, p]
    lib.stpu_probe_slots.argtypes = [p, i64, i32, i32, p, p, p, i64, p, p]
    lib.stpu_bucketed_floor.argtypes = [p, i64, i32, p, p, i64, p, p]
    lib.stpu_probe_rows.argtypes = [p, i32, i32, ctypes.c_uint, i32, p, i64, p, p]
    lib.stpu_rows_floor.argtypes = [p, i32, i32, ctypes.c_uint, p, i64, p, p]
    lib.stpu_probe_hashed.argtypes = [p, i64, i32, i32, i32, p, i64, p, p]
    lib.stpu_hashed_floor.argtypes = [p, i64, i32, i32, i32, p, i64, p, p]
    lib.stpu_hit_runs.argtypes = [p, p, p, p, i64, i32, i32, i32, p, p]
    lib.stpu_hit_runs_floor.argtypes = [p, p, p, p, i64, i32, i32, p, p]
    for fn in (lib.stpu_scan, lib.stpu_scan_wide, lib.stpu_probe, lib.stpu_probe_wide, lib.stpu_probe_tiled,
               lib.stpu_tiled_floor, lib.stpu_probe_bucketed, lib.stpu_probe_slots, lib.stpu_bucketed_floor,
               lib.stpu_probe_rows, lib.stpu_rows_floor, lib.stpu_probe_hashed, lib.stpu_hashed_floor,
               lib.stpu_hit_runs, lib.stpu_hit_runs_floor):
        fn.restype = i32
    for name in MASK_IDIOMS:
        fn = getattr(lib, f"stpu_mask_{name}")
        fn.argtypes = [p, p, p, i32, i64, i64, p] if name == "sum_bool" else [p, p, i64, i64, p]
        fn.restype = i32
    _lib = lib
    return lib


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def _require(t: torch.Tensor, what: str, dtype: torch.dtype, ndim: int) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(
            f"{what} must be a contiguous {ndim}-d {dtype} tensor, got "
            f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
        )


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch(t: torch.Tensor, fn, *args) -> int:
    """fn(*args) with t's card as the current device: the runtime launches a
    kernel on the current device, into a stream (`_stream(t)`) that must be
    that device's, and a mesh's devices need not be the current one."""
    with torch.cuda.device(t.device):
        return fn(*args)


def scan_warps(device: torch.device) -> int:
    """The warps a scan launch on this CUDA device should have in flight:
    SCAN_WARPS_PER_SM on each of its SMs (2,112 on an H100 SXM's 132)."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    if index not in _scan_warps:
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        _scan_warps[index] = SCAN_WARPS_PER_SM * sms
    return _scan_warps[index]


def segment_length(rows: int, L: int, warps: int) -> int:
    """The positions a warp of the scan takes: the whole row (L) when the
    rows alone give `warps` warps (`scan_warps`), or when L is short; else
    the largest multiple of CHUNK that still gives that many, but no less
    than MIN_SEGMENT. With an H100's 2,112 warps, [32768, 128], [16384, 264]
    and [8192, 4096] take L; bracken's [4, 2^20] takes 2,048 (512 segments
    a row)."""
    per_row = -(-warps // max(rows, 1))  # segments a row needs
    if per_row == 1:
        return L
    # ceil(L / s) >= per_row  <=>  s * (per_row - 1) < L
    s = max(MIN_SEGMENT, (L - 1) // (per_row - 1) // CHUNK * CHUNK)
    return L if s >= L else s


def scan_counters(t: torch.Tensor, rows: int) -> torch.Tensor:
    """The segmented scan's arrival counters for t's (device, current
    stream): int32, at least `rows` of them, all 0. Zeroed once, and again
    only when a launch has more rows than before; each launch leaves them 0,
    and two streams never share them."""
    key = (t.device, _stream(t))
    counters = _scan_counters.get(key)
    if counters is None or counters.shape[0] < rows:
        counters = torch.zeros(max(rows, 2 * (0 if counters is None else counters.shape[0])), dtype=torch.int32,
                               device=t.device)
        _scan_counters[key] = counters
    return counters


def scan_pass1_cuda(packed: torch.Tensor, valid: torch.Tensor, params, lut=None, segment=None):
    """The minimizer scan (kernels/scan.cu) over pack_2bit's [B, L/4] codes
    and [B, L/8] validity bits in one launch, one warp a row or, when
    `segment` (a multiple of CHUNK; default `segment_length`) is below L, a
    warp a segment of that many positions, the rows stitched inside the
    launch. Returns (minimizer, flags, summary): the minimizer int64 [B, L]
    (or [B, L, 2] for a wide m), flags bool [3, B, L] (valid, span_start,
    distinct; `distinct` is final), and the int64 [B, nseg, 4] segment
    summaries that the stitch read (minimizers.stitch_segments' layout,
    from which `minimizers.carried` counts the bytes that the carry
    cleared), or None for one segment a row."""
    _require(packed, "packed", torch.uint8, 2)
    _require(valid, "valid", torch.uint8, 2)
    b, l4 = packed.shape
    L = 4 * l4
    k, m = params.k, params.m
    if tuple(valid.shape) != (b, L // 8) or L % 8 or valid.device != packed.device:
        raise ValueError(f"valid must be [{b}, {L // 8}] on {packed.device}, got {tuple(valid.shape)} on {valid.device}")
    if not 1 <= m <= 63 or not 0 <= k - m <= 120:
        raise ValueError(
            f"the scan kernels take 1 <= m <= 63 and m <= k <= m + 120, got k={k} m={m}"
        )
    if lut is not None:
        _require(lut, "lut", torch.int32, 1)
        if m > 15 or lut.shape[0] != 1 << (2 * m) or lut.device != packed.device:
            raise ValueError(
                f"a rank table takes m <= 15 and 4^m entries on {packed.device}, got m={m} "
                f"and {lut.shape[0]} entries on {lut.device}"
            )
    if segment is None:
        segment = segment_length(b, L, scan_warps(packed.device))
    elif segment < 1 or (segment % CHUNK and segment < L):
        raise ValueError(f"a segment is a positive multiple of {CHUNK} positions, got {segment}")
    segment = min(segment, L)
    nseg = -(-L // segment) if segment else 1
    lib = _load()
    flags = torch.empty((3, b, L), dtype=torch.bool, device=packed.device)
    summary = counters = None
    if nseg > 1:
        summary = torch.empty((b, nseg, 4), dtype=torch.int64, device=packed.device)
        counters = scan_counters(packed, b).data_ptr()
    f0 = flags.data_ptr()
    outs = (f0, f0 + b * L, f0 + 2 * b * L, None if summary is None else summary.data_ptr(), counters,
            _stream(packed))
    common = (packed.data_ptr(), valid.data_ptr(), b, L, segment, k, m, int(bool(params.canonical)))
    smask = space_mask_int(m, params.spaces)
    if params.wide:
        name = "scan_wide"
        mn = torch.empty((b, L, 2), dtype=torch.int64, device=packed.device)
        limbs = [x for mask in (wide_toggle_mask(m, params.toggle_mask), smask)
                 for x in (mask >> 64, mask & ((1 << 64) - 1))]
        rc = _launch(packed, lib.stpu_scan_wide, *common, *limbs, mn.data_ptr(), *outs)
    else:
        name = "scan" if lut is None else "scan_lut"
        mn = torch.empty((b, L), dtype=torch.int64, device=packed.device)
        rc = _launch(
            packed, lib.stpu_scan, *common, params.toggle_mask & ((1 << (2 * m)) - 1), smask,
            None if lut is None else lut.data_ptr(), mn.data_ptr(), *outs,
        )
    _check(rc, name)
    LAUNCHES[name] += 1
    if summary is not None:
        LAUNCHES["scan_stitch"] += 1
    return mn, flags, summary


def window_minimizers_cuda(packed: torch.Tensor, valid: torch.Tensor, params, lut=None, *, _segment=None):
    """Fused unpack + minimizer scan (kernels/scan.cu) over pack_2bit's
    [B, L/4] codes and [B, L/8] validity bits. Returns (minimizer, valid,
    span_start, distinct bool [B, L]); the minimizer is int64 [B, L], or
    int64 [B, L, 2] (hi64, lo64) for a wide m, and -1 in every limb at an
    invalid window. `lut` is an int32 rank table of 4^m entries on the same
    device (explicit orderings, m <= 15). Few long rows are cut into
    segments (`segment_length`; `_segment` forces a length, for tests),
    stitched in the same launch: one launch for every shape."""
    mn, flags, _ = scan_pass1_cuda(packed, valid, params, lut, _segment)
    return (mn, *flags.unbind(0))


def lookup_taxa_directory_cuda(
    keys: torch.Tensor, taxa: torch.Tensor, directory: Directory, queries: torch.Tensor
) -> torch.Tensor:
    """Exact-match probe (kernels/probe.cu): int32 taxon per query, 0 on a
    miss. keys sorted int64 [N] with int64 [Q] queries, taxa int32 [N],
    directory = lookup.build_directory(keys). A wide index is probed through
    its slot table (`lookup_taxa_slots_cuda`)."""
    if keys.dim() == 2 and keys.device.type == "cuda":
        raise ValueError("a wide probe on the card reads the index's slot table (lookup.build_slots), not its keys")
    starts, shift = directory
    _require(keys, "keys", torch.int64, 1)
    _require(taxa, "taxa", torch.int32, 1)
    _require(starts, "directory.starts", torch.int32, 1)
    _require(queries, "queries", torch.int64, 1)
    n, buckets = keys.shape[0], directory.buckets
    if taxa.shape[0] != n or buckets < 1 or buckets & (buckets - 1) or not 0 <= shift <= 63:
        raise ValueError(
            f"taxa [{taxa.shape[0]}] or a directory of {buckets} buckets and shift {shift} "
            f"do not fit {n} keys"
        )
    if len({keys.device, taxa.device, starts.device, queries.device}) != 1:
        raise ValueError("keys, taxa, directory and queries must be on one device")
    if keys.data_ptr() % 16:
        raise ValueError("keys must be 16-byte aligned (the probe loads 16 bytes at a time)")
    out = torch.empty(queries.shape[0], dtype=torch.int32, device=queries.device)
    if n == 0:  # an empty index: every query misses
        return out.zero_()
    rc = _launch(
        queries, _load().stpu_probe, keys.data_ptr(), taxa.data_ptr(), n, starts.data_ptr(), buckets, shift,
        queries.data_ptr(), queries.shape[0], out.data_ptr(), _stream(queries),
    )
    _check(rc, "probe")
    LAUNCHES["probe"] += 1
    return out


def lookup_taxa_slots_cuda(table: SlotTable, queries: torch.Tensor) -> torch.Tensor:
    """Exact-match probe of an index through its slot table: int32 taxon per
    query, 0 on a miss. A narrow table (slots int64 [N], queries int64 [Q];
    kernels/probe_tables.cu, probe_slots_kernel, counted as "probe_slots")
    or a wide one (slots [N, 2], queries [Q, 2] as (hi64, lo64);
    kernels/probe.cu, probe_wide_kernel, counted as "probe_wide"). Twin:
    lookup.lookup_taxa_slots."""
    slots, c, codes, directory = table
    starts, shift = directory
    wide = slots.dim() == 2
    _require(slots, "slots", torch.int64, 2 if wide else 1)
    _require(starts, "directory.starts", torch.int32, 1)
    _require(queries, "queries", torch.int64, 2 if wide else 1)
    if codes is not None:
        _require(codes, "codes", torch.int32, 1)
    n, buckets, width = slots.shape[0], directory.buckets, 128 if wide else 64
    if wide and (slots.shape[1] != 2 or queries.shape[1] != 2):
        raise ValueError(f"slots and queries are [N, 2] and [Q, 2], got {tuple(slots.shape)} and {tuple(queries.shape)}")
    if (buckets < 1 or buckets & (buckets - 1) or not 0 <= shift < width
            or not 1 <= c <= min(32, width - shift) or (codes is not None and codes.shape[0] == 0)):
        raise ValueError(
            f"a slot table of {n} rows with a field of {c} bits and codes "
            f"{None if codes is None else codes.shape[0]} does not fit a directory of {buckets} buckets and shift {shift}"
        )
    if len({slots.device, starts.device, queries.device, *(() if codes is None else (codes.device,))}) != 1:
        raise ValueError("slots, directory, codes and queries must be on one device")
    if slots.data_ptr() % 16 or (wide and queries.data_ptr() % 16):
        raise ValueError("slots and wide queries must be 16-byte aligned (the probe loads 16 bytes at a time)")
    if not wide and slots.untyped_storage().nbytes() < 8 * (slots.storage_offset() + n + 1):
        raise ValueError("narrow slots need a readable word past the last (build_slots allocates one)")
    out = torch.empty(queries.shape[0], dtype=torch.int32, device=queries.device)
    if n == 0 or queries.shape[0] == 0:  # an empty index, or nothing to launch
        return out.zero_()
    code_ptr = None if codes is None else codes.data_ptr()
    if wide:
        name = "probe_wide"
        rc = _launch(queries, _load().stpu_probe_wide, slots.data_ptr(), code_ptr, starts.data_ptr(), buckets, shift,
                     c, queries.data_ptr(), queries.shape[0], out.data_ptr(), _stream(queries))
    else:
        name = "probe_slots"
        rc = _launch(queries, _load().stpu_probe_slots, starts.data_ptr(), buckets, shift, c, slots.data_ptr(),
                     code_ptr, queries.data_ptr(), queries.shape[0], out.data_ptr(), _stream(queries))
    _check(rc, name)
    LAUNCHES[name] += 1
    return out


def slots_floor_cuda(table: SlotTable, queries: torch.Tensor) -> torch.Tensor:
    """A measurement on no path (kernels/probe_tables.cu,
    bucketed_floor_kernel over a narrow slot table's directory and slots):
    for each non-negative query inside the key space, starts[p] ^
    starts[p + 1] and, if its bucket is not empty, the xor of the aligned
    32-byte sector of slots that holds its guessed slot (the 16-byte halves
    that hold a slot of the bucket); else 0. int32 [Q]. What the narrow
    slot probe cannot beat: its directory entries and one dependent sector
    a query in a non-empty bucket. Not counted in LAUNCHES. Plain version:
    lookup.slot_sectors."""
    slots, _, _, directory = table
    _require(slots, "slots", torch.int64, 1)
    _require(directory.starts, "directory.starts", torch.int32, 1)
    _table_queries(queries, False, slots)
    out = torch.empty(queries.shape[0], dtype=torch.int32, device=queries.device)
    rc = _launch(queries, _load().stpu_bucketed_floor, directory.starts.data_ptr(), directory.buckets,
                 directory.shift, slots.data_ptr(), queries.data_ptr(), queries.shape[0], out.data_ptr(),
                 _stream(queries))
    _check(rc, "slots_floor")
    return out


def _table_queries(queries: torch.Tensor, wide: bool, table: torch.Tensor) -> None:
    """Check the queries of a table probe: int64 [Q] or, wide, [Q, 2],
    16-byte aligned, on the table's device."""
    _require(queries, "queries", torch.int64, 2 if wide else 1)
    if wide and (queries.shape[1] != 2 or queries.data_ptr() % 16):
        raise ValueError(f"wide queries are [Q, 2] and 16-byte aligned, got {tuple(queries.shape)}")
    if queries.device != table.device:
        raise ValueError(f"the table lies on {table.device}, the queries on {queries.device}")


def _tiled_table(table: TiledTable, queries: torch.Tensor) -> bool:
    """Check a tiled table and its queries; True for a wide table. The
    records are 16-byte aligned: the probe reads two records as 3 (wide 5)
    8-byte loads, its floor a sector as two 16-byte loads."""
    router, records, tile, bits, key_bits = table
    _require(router, "router", torch.int32, 1)
    _require(records, "table", torch.int32, 3)
    lanes = records.shape[2]
    wide = lanes == 5
    shift = key_bits - bits
    if (lanes not in (3, 5) or records.shape[1] != tile or router.shape[0] != (1 << bits) + 1
            or not 0 <= shift <= (127 if wide else 63) or router.device != records.device):
        raise ValueError(f"a tiled table of {tuple(records.shape)} lanes with a router of {router.shape[0]} entries "
                         f"on {router.device} does not fit tile {tile}, {bits} bits of {key_bits}")
    if records.data_ptr() % 16:
        raise ValueError("a tiled table's records must be 16-byte aligned (the probe loads 16 bytes at a time)")
    _table_queries(queries, wide, records)
    return wide


def _launch_tiled(fn, table: TiledTable, queries: torch.Tensor, wide: bool, name: str) -> torch.Tensor:
    """fn (the tiled probe or its floor) over the queries; no launch for none."""
    out = torch.empty(queries.shape[0], dtype=torch.int32, device=queries.device)
    if queries.shape[0]:
        rc = _launch(queries, fn, table.router.data_ptr(), 1 << table.bits, table.key_bits - table.bits,
                     table.table.data_ptr(), int(wide), queries.data_ptr(), queries.shape[0], out.data_ptr(),
                     _stream(queries))
        _check(rc, name)
    return out


def lookup_taxa_tiled_cuda(table: TiledTable, queries: torch.Tensor) -> torch.Tensor:
    """Exact-match probe of a tiled table (kernels/probe_tables.cu,
    probe_tiled_kernel): int32 taxon per int64 [Q] query, or per [Q, 2]
    query of a wide table, 0 on a miss. Reads the router bucket of the
    query's prefix, then the bucket's records two a step from the record
    that the query's place in the bucket's range guesses, a step's loads
    issued together. Twin: lookup.lookup_taxa_tiled."""
    wide = _tiled_table(table, queries)
    name = "probe_tiled_wide" if wide else "probe_tiled"
    out = _launch_tiled(_load().stpu_probe_tiled, table, queries, wide, name)
    if queries.shape[0]:
        LAUNCHES[name] += 1
    return out


def tiled_floor_cuda(table: TiledTable, queries: torch.Tensor) -> torch.Tensor:
    """A measurement on no path (kernels/probe_tables.cu,
    tiled_floor_kernel): for each query inside the key space, router[p] ^
    router[p + 1] and, if its bucket is not empty, the xor of the aligned
    32-byte sector that holds the first lane of the bucket's first record;
    else 0. int32 [Q]. What the tiled probe cannot beat: its router entries
    and one dependent sector a query. Not counted in LAUNCHES. Plain
    version: lookup.router_sectors."""
    return _launch_tiled(_load().stpu_tiled_floor, table, queries, _tiled_table(table, queries), "tiled_floor")


def _bucketed_table(table: Bucketed, queries: torch.Tensor) -> None:
    """Check bucketed arrays and their queries. The keys are 16-byte
    aligned: the probe and its floor read two keys a load."""
    router, keys, taxa, maxb, bits, key_bits = table
    _require(router, "router", torch.int32, 1)
    _require(keys, "keys", torch.int64, 1)
    _require(taxa, "taxa", torch.int32, 1)
    if maxb < 1 or table.n < 0 or taxa.shape != keys.shape or not 0 <= key_bits - bits <= 63:
        raise ValueError(f"bucketed arrays of {keys.shape[0]} keys and {taxa.shape[0]} taxa do not fit maxb {maxb}, "
                         f"{bits} bits of {key_bits}")
    if router.shape[0] != (1 << bits) + 1 or len({router.device, keys.device, taxa.device}) != 1:
        raise ValueError(f"a router of {router.shape[0]} entries on {router.device} does not fit {bits} bits and "
                         f"keys on {keys.device}")
    if keys.data_ptr() % 16:
        raise ValueError("bucketed keys must be 16-byte aligned (the probe loads 16 bytes at a time)")
    _table_queries(queries, False, keys)


def lookup_taxa_bucketed_cuda(table: Bucketed, queries: torch.Tensor) -> torch.Tensor:
    """Exact-match probe of the bucketed arrays (`--probe bucketed`;
    kernels/probe_tables.cu, probe_bucketed_kernel): int32 taxon per int64
    [Q] query, 0 on a miss. Reads the router entries of the query's prefix
    (an empty bucket reads no key), then the bucket's keys 4 a step (an
    aligned 32-byte sector) from the key that the query's place in the
    bucket's range guesses, and the taxon of an equal key. Twin:
    lookup.lookup_taxa_bucketed."""
    _bucketed_table(table, queries)
    out = torch.empty(queries.shape[0], dtype=torch.int32, device=queries.device)
    if table.n == 0 or queries.shape[0] == 0:  # an empty index, or nothing to launch
        return out.zero_()
    rc = _launch(queries, _load().stpu_probe_bucketed, table.router.data_ptr(), 1 << table.bits,
                 table.key_bits - table.bits, table.keys.data_ptr(), table.taxa.data_ptr(), queries.data_ptr(),
                 queries.shape[0], out.data_ptr(), _stream(queries))
    _check(rc, "probe_bucketed")
    LAUNCHES["probe_bucketed"] += 1
    return out


def bucketed_floor_cuda(table: Bucketed, queries: torch.Tensor) -> torch.Tensor:
    """A measurement on no path (kernels/probe_tables.cu,
    bucketed_floor_kernel): for each non-negative query inside the key
    space, router[p] ^ router[p + 1] and, if its bucket is not empty, the
    xor of the aligned 32-byte sector of keys that holds its guessed key
    (the 16-byte halves that hold a key of the bucket); else 0. int32 [Q].
    What the bucketed probe cannot beat: its router entries and one
    dependent sector a query in a non-empty bucket. Not counted in
    LAUNCHES. Plain version: lookup.bucket_sectors."""
    _bucketed_table(table, queries)
    out = torch.empty(queries.shape[0], dtype=torch.int32, device=queries.device)
    rc = _launch(queries, _load().stpu_bucketed_floor, table.router.data_ptr(), 1 << table.bits,
                 table.key_bits - table.bits, table.keys.data_ptr(), queries.data_ptr(), queries.shape[0],
                 out.data_ptr(), _stream(queries))
    _check(rc, "bucketed_floor")
    return out


def _rows_table(table: HashedRows, queries: torch.Tensor) -> bool:
    """Check a row-bucket table and its queries; True for a wide table."""
    rows, tile, row_bits = table.table, table.tile, table.row_bits
    _require(rows, "table", torch.int32, 2)
    wide = rows.shape[1] == 5 * tile
    if (rows.shape[1] not in (3 * tile, 5 * tile) or rows.shape[0] != 1 << row_bits or not 1 <= row_bits <= 63
            or tile < 4 or tile % 4 or rows.data_ptr() % 16 or table.n_keys < 0):
        raise ValueError(f"a row-bucket table of {tuple(rows.shape)} lanes does not fit tile {tile} and "
                         f"{row_bits} row bits and {table.n_keys} keys (tile a multiple of 4, 16-byte aligned)")
    _table_queries(queries, wide, rows)
    return wide


def lookup_taxa_rows_cuda(table: HashedRows, queries: torch.Tensor) -> torch.Tensor:
    """Exact-match probe of a row-bucket table (kernels/probe_tables.cu,
    probe_rows_kernel and probe_rows_wide_kernel): int32 taxon per int64 [Q]
    query, or per [Q, 2] query of a wide table, 0 on a miss. Narrow, one
    thread a query reads its row's hi' lanes 8 at a time (a 32-byte sector
    at tile 128) from the lane that `lookup.row_guess` gives, a sector to
    the left or right until one holds the first lane not below the query,
    then that lane's lo' and taxon together, and a negative query (an
    invalid window) not at all; wide, four threads a query walk its l3 and
    l2 lanes together. Twin: lookup.lookup_taxa_hashed_rows."""
    wide = _rows_table(table, queries)
    out = torch.empty(queries.shape[0], dtype=torch.int32, device=queries.device)
    if queries.shape[0] == 0:  # nothing to launch
        return out
    name = "probe_rows_wide" if wide else "probe_rows"
    rc = _launch(queries, _load().stpu_probe_rows, table.table.data_ptr(), table.tile, table.row_bits,
                 row_mean(table), int(wide), queries.data_ptr(), queries.shape[0], out.data_ptr(), _stream(queries))
    _check(rc, name)
    LAUNCHES[name] += 1
    return out


def rows_floor_cuda(table: HashedRows, queries: torch.Tensor) -> torch.Tensor:
    """A measurement on no path (kernels/probe_tables.cu, rows_floor_kernel):
    for each non-negative int64 query of a narrow row-bucket table, the xor
    of the 8 hi' lanes of its row from its guessed lane rounded down to a
    multiple of 8, else 0; int32 [Q]. What the narrow row probe cannot beat:
    one sector a query. Not counted in LAUNCHES. Plain version:
    lookup.guess_sectors."""
    if _rows_table(table, queries):
        raise ValueError("the row probe's floor takes a narrow table")
    out = torch.empty(queries.shape[0], dtype=torch.int32, device=queries.device)
    rc = _launch(queries, _load().stpu_rows_floor, table.table.data_ptr(), table.tile, table.row_bits,
                 row_mean(table), queries.data_ptr(), queries.shape[0], out.data_ptr(), _stream(queries))
    _check(rc, "rows_floor")
    return out


def _hashed_table(table: HashedTable, queries: torch.Tensor) -> None:
    """Check a hashed table and its queries. A column-block table's tile is
    a multiple of 8 (every tile build_hashed_cols makes from its default,
    128 doubled) and its lanes 16-byte aligned: the kernel reads 8 lanes of
    a block at a time."""
    rows, tile, bits = table
    if table.cols and tile % 8:
        raise ValueError(f"a column-block hashed table's tile is a multiple of 8, got {tile}")
    _require(rows, "table", torch.int32, rows.dim())
    shape = (3 * tile,) if table.cols else (tile, 3)
    if rows.dim() not in (2, 3) or tuple(rows.shape[1:]) != shape or tile < 1 or not 1 <= bits <= 63:
        raise ValueError(f"a hashed table of {tuple(rows.shape)} lanes does not fit tile {tile} and {bits} bits")
    if table.cols and rows.data_ptr() % 16:
        raise ValueError("a column-block hashed table must be 16-byte aligned (the probe loads 16 bytes at a time)")
    _table_queries(queries, False, rows)


def lookup_taxa_hashed_cuda(table: HashedTable, queries: torch.Tensor) -> torch.Tensor:
    """Exact-match probe of a hashed table (kernels/probe_tables.cu): int32
    taxon per int64 [Q] query, 0 on a miss. A [rows, tile, 3] table
    (`--probe hashed`, probe_hashed_kernel) walks the slots from the
    scrambled query's home slot and counts as "probe_hashed"; a [rows, 3 *
    tile] one (`hashed128`, probe_hashed_cols_kernel) walks 8-slot blocks of
    hi' from there and counts as "probe_hashed_cols". Twin:
    lookup.lookup_taxa_hashed."""
    _hashed_table(table, queries)
    out = torch.empty(queries.shape[0], dtype=torch.int32, device=queries.device)
    if queries.shape[0] == 0:  # nothing to launch
        return out
    name = "probe_hashed_cols" if table.cols else "probe_hashed"
    rc = _launch(queries, _load().stpu_probe_hashed, table.table.data_ptr(), table.slots, table.tile, table.bits,
                 int(table.cols), queries.data_ptr(), queries.shape[0], out.data_ptr(), _stream(queries))
    _check(rc, name)
    LAUNCHES[name] += 1
    return out


def hashed_floor_cuda(table: HashedTable, queries: torch.Tensor) -> torch.Tensor:
    """A measurement on no path (kernels/probe_tables.cu,
    hashed_floor_kernel): for each non-negative int64 query whose home slot
    lies in the table, the xor of the 8 lanes of the aligned 32-byte sector
    that holds that slot (of the hi' block in column blocks, of the [slots,
    3] lanes row-major), else 0; int32 [Q]. What a hashed probe cannot beat:
    one sector a query. Not counted in LAUNCHES."""
    _hashed_table(table, queries)
    if table.table.data_ptr() % 16:
        raise ValueError("the floor reads 16 bytes at a time: the table must be 16-byte aligned")
    out = torch.empty(queries.shape[0], dtype=torch.int32, device=queries.device)
    rc = _launch(queries, _load().stpu_hashed_floor, table.table.data_ptr(), table.slots, table.tile, table.bits,
                 int(table.cols), queries.data_ptr(), queries.shape[0], out.data_ptr(), _stream(queries))
    _check(rc, "hashed_floor")
    return out


def _hit_runs_inputs(window_taxa, valid, splits, row_lens, k: int, cap: int) -> torch.Tensor:
    """Check the hit-runs kernels' inputs; the [B, cap + cap/2 + 3] int32 bundle to write."""
    _require(window_taxa, "window_taxa", torch.int32, 2)
    _require(valid, "valid", torch.uint8, 2)
    _require(splits, "splits", torch.int32, 1)
    _require(row_lens, "row_lens", torch.int32, 1)
    b, L = window_taxa.shape
    if L % 8 or L >= 1 << 16 or tuple(valid.shape) != (b, L // 8):
        raise ValueError(f"window taxa [{b}, {L}] need L a multiple of 8 below 2^16 and valid [{b}, {L // 8}], "
                         f"got valid {tuple(valid.shape)}")
    if splits.shape[0] != b or row_lens.shape[0] != b:
        raise ValueError(f"splits [{splits.shape[0]}] and row_lens [{row_lens.shape[0]}] must have {b} rows")
    if len({window_taxa.device, valid.device, splits.device, row_lens.device}) != 1:
        raise ValueError("window_taxa, valid, splits and row_lens must be on one device")
    if cap < 2 or cap % 2 or cap > 4096 or k < 1:
        raise ValueError(f"hit runs take an even cap in [2, 4096] and k >= 1, got cap={cap} k={k}")
    if window_taxa.data_ptr() % 16:
        raise ValueError("window_taxa must be 16-byte aligned (the kernel reads 16 bytes at a time)")
    return torch.empty((b, cap + cap // 2 + 3), dtype=torch.int32, device=window_taxa.device)


def hit_runs_cuda(window_taxa: torch.Tensor, valid: torch.Tensor, splits: torch.Tensor, row_lens: torch.Tensor,
                  k: int, cap: int) -> torch.Tensor:
    """Each row's final hit runs (kernels/hitruns.cu), 8, 16 or 32 lanes a
    row: the [B, cap + cap/2 + 3] int32 bundle of hitruns.hit_runs_plain
    from the [B, L] int32 window taxa, pack_2bit's [B, L/8] uint8 validity
    bits and int32 [B] splits (-1 single-end) and row lengths. L is a
    multiple of 8 below 2^16, cap even, k positive; the window taxa 16-byte
    aligned (the kernel reads them 16 bytes a load)."""
    out = _hit_runs_inputs(window_taxa, valid, splits, row_lens, k, cap)
    b, L = window_taxa.shape
    if b == 0:
        return out
    rc = _launch(
        window_taxa, _load().stpu_hit_runs, window_taxa.data_ptr(), valid.data_ptr(), splits.data_ptr(),
        row_lens.data_ptr(), b, L, k, cap, out.data_ptr(), _stream(window_taxa),
    )
    _check(rc, "hit_runs")
    LAUNCHES["hit_runs"] += 1
    return out


def hit_runs_floor_cuda(window_taxa: torch.Tensor, valid: torch.Tensor, splits: torch.Tensor,
                        row_lens: torch.Tensor, cap: int) -> torch.Tensor:
    """A measurement on no path (kernels/hitruns.cu, hit_runs_floor_kernel):
    hit_runs_cuda's grid and loads, and a bundle of its shape written from
    the xor of what each row's warp read, with no scan. What the kernel
    cannot beat. Not counted in LAUNCHES."""
    out = _hit_runs_inputs(window_taxa, valid, splits, row_lens, 1, cap)
    b, L = window_taxa.shape
    if b:
        rc = _launch(window_taxa, _load().stpu_hit_runs_floor, window_taxa.data_ptr(), valid.data_ptr(),
                     splits.data_ptr(), row_lens.data_ptr(), b, L, cap, out.data_ptr(), _stream(window_taxa))
        _check(rc, "hit_runs_floor")
    return out


def mask_idiom_cuda(name: str, x: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the mask-idiom kernel `name` (kernels/mask_idioms.cu) on a
    contiguous int32 [R, C] CUDA tensor with C >= 16; int32 [R, C] out,
    written into `out` (same shape, not `x` itself) when one is given."""
    if name not in MASK_IDIOMS:
        raise ValueError(f"unknown mask idiom {name!r}")
    _require(x, "x", torch.int32, 2)
    rows, cols = x.shape
    if cols < 16:
        raise ValueError(f"the mask-idiom kernels take at least 16 columns, got {cols}")
    if out is None:
        out = torch.empty_like(x)
    else:
        _require(out, "out", torch.int32, 2)
        if out.shape != x.shape or out.device != x.device or out.data_ptr() == x.data_ptr():
            raise ValueError(f"out must be another {tuple(x.shape)} tensor on {x.device}")
    lib = _load()
    fn = getattr(lib, f"stpu_mask_{name}")
    if name == "sum_bool":
        # two counters a stream, zeroed once: the kernel alternates between
        # them by launch parity and zeroes the one its successor will use
        key = (x.device, _stream(x))
        if key not in _sum_bool_counters:
            _sum_bool_counters[key] = [torch.zeros(2, dtype=torch.int32, device=x.device), 0]
        state = _sum_bool_counters[key]
        rc = _launch(x, fn, x.data_ptr(), out.data_ptr(), state[0].data_ptr(), state[1], rows, cols, _stream(x))
        if rc == 0:
            state[1] ^= 1
    else:
        rc = _launch(x, fn, x.data_ptr(), out.data_ptr(), rows, cols, _stream(x))
    _check(rc, name)
    LAUNCHES[name] += 1
    return out
