"""ctypes bindings for the native C++ IO layer (native/packer.cpp, the
port's own copy of the source).

The shared library is built at first use with g++ into the package's
_build/ directory, under a name that carries a hash of the source and the
compiler flags, so a stale or foreign binary is never loaded. The flags name
no host-specific instruction set (no -march=native): a tree copied to
another machine may carry its _build/ along. Every entry point has a numpy
fallback so the package works without a compiler; `available()` reports
which path is active.

Counterpart of slacken_tpu/native.py, without the binding for the radix
sort, which nothing in this package calls.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

from .ops.encode import CODE_LUT

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "native", "packer.cpp")
BUILD_DIR = os.path.join(_HERE, "_build")
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_lib = None
_tried = False


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libstpu_packer_{h.hexdigest()[:16]}.so")


def _build_lib() -> Optional[str]:
    if not os.path.exists(_SRC):
        return None
    path = library_path()
    if os.path.exists(path):
        return path
    # build to a unique temp path and rename atomically (parallel test
    # workers may compile concurrently)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        try:
            subprocess.run(["g++", *CXX_FLAGS, "-fopenmp", "-o", tmp, _SRC],
                           check=True, capture_output=True)
        except subprocess.CalledProcessError:
            # toolchains without OpenMP: the pragmas compile away harmlessly
            subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, _SRC],
                           check=True, capture_output=True)
        os.replace(tmp, path)
        return path
    except (OSError, subprocess.CalledProcessError):
        return None


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    path = _build_lib()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    i64 = ctypes.c_int64
    p_u8 = ctypes.POINTER(ctypes.c_uint8)
    p_i32 = ctypes.POINTER(ctypes.c_int32)
    p_i64 = ctypes.POINTER(ctypes.c_int64)
    lib.stpu_encode.argtypes = [ctypes.c_char_p, i64, p_u8]
    lib.stpu_fastq_scan.argtypes = [ctypes.c_char_p, i64, p_i64, p_i64]
    lib.stpu_fastq_scan.restype = i64
    lib.stpu_fastq_fill.argtypes = [ctypes.c_char_p, i64, i64, i64, p_u8, p_i32, p_i64, p_i32]
    lib.stpu_fastq_fill.restype = i64
    lib.stpu_fasta_scan.argtypes = [ctypes.c_char_p, i64, p_i64, p_i64]
    lib.stpu_fasta_scan.restype = i64
    lib.stpu_fasta_fill.argtypes = [ctypes.c_char_p, i64, i64, i64, p_u8, p_i32, p_i64, p_i32]
    lib.stpu_fasta_fill.restype = i64
    lib.stpu_hit_lines.argtypes = [p_u8, p_i32, i64, i64, p_i64, p_i64, i64, ctypes.c_char_p, p_i64]
    lib.stpu_hit_lines.restype = i64
    lib.stpu_hit_lines_runs.argtypes = [
        p_i32, p_i32, p_i64, p_i64, p_i64, i64, i64, i64, i64,
        ctypes.c_char_p, p_i64,
    ]
    lib.stpu_hit_lines_runs.restype = i64
    lib.stpu_output_lines_runs.argtypes = [
        p_i32, p_i32, p_i64, p_i64, p_i64, ctypes.c_char_p, p_i64, p_i64,
        p_u8, i64, i64, i64, i64, ctypes.c_char_p, p_i64,
    ]
    lib.stpu_output_lines_runs.restype = i64
    lib.stpu_output_lines_dense.argtypes = [
        p_u8, p_i32, p_i64, p_i64, ctypes.c_char_p, p_i64, p_i64,
        p_u8, i64, i64, i64, i64, ctypes.c_char_p, p_i64,
    ]
    lib.stpu_output_lines_dense.restype = i64
    lib.stpu_gather_rows.argtypes = [
        ctypes.c_char_p, p_i64, p_i64, p_i64, i64, ctypes.c_char_p,
    ]
    lib.stpu_gather_rows.restype = i64
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _as_ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


class PackedReads:
    """A parsed chunk: codes [n, row_len] uint8, true lengths, titles.

    For paired reads, `splits` holds the R1 length per row (the row layout is
    R1 + one INVALID separator + R2) and `lengths` the combined row length.
    """

    def __init__(self, codes, lengths, titles, splits=None):
        self.codes = codes
        self.lengths = lengths
        self.titles = titles
        self.splits = splits

    def __len__(self):
        return len(self.lengths)


def pack_pairs(p1: "PackedReads", p2: "PackedReads") -> "PackedReads":
    """Combine two mate chunks (same record order) into paired rows:
    R1 + INVALID separator + R2."""
    n = min(len(p1), len(p2))
    l1 = int(p1.codes.shape[1])
    l2 = int(p2.codes.shape[1])
    out = np.full((n, l1 + 1 + l2), 4, np.uint8)
    out[:, :l1] = p1.codes[:n]
    # place R2 right after each row's true R1 end + separator
    len1 = np.asarray(p1.lengths[:n], np.int64)
    len2 = np.asarray(p2.lengths[:n], np.int64)
    # vectorised ragged copy via flat indexing
    rows = np.repeat(np.arange(n), len2)
    src_cols = np.concatenate([np.arange(x) for x in len2]) if n else np.zeros(0, np.int64)
    dst_cols = src_cols + np.repeat(len1 + 1, len2)
    out[rows, dst_cols] = p2.codes[:n][rows, src_cols]
    # clear everything between true R1 end and separator (R1 rows are padded
    # to l1 with INVALID already, so only ensure separator region is INVALID)
    out[np.arange(n), np.minimum(len1, l1)] = 4
    lengths = (len1 + 1 + len2).astype(np.int32)
    return PackedReads(out, lengths, p1.titles[:n], splits=len1)


def pack_fastq_chunk(buf: bytes, row_len: Optional[int] = None) -> Tuple[PackedReads, int]:
    """Parse a FASTQ byte chunk (starting at a record boundary).

    Returns (packed reads, consumed byte count); the unconsumed tail belongs
    to the next chunk. Falls back to a pure-Python parse when the native
    library is unavailable.
    """
    lib = _load()
    if lib is None:
        return _pack_fastq_py(buf, row_len)
    n_records = ctypes.c_int64()
    max_len = ctypes.c_int64()
    consumed = lib.stpu_fastq_scan(buf, len(buf), ctypes.byref(n_records), ctypes.byref(max_len))
    if consumed < 0:
        raise ValueError("malformed FASTQ chunk")
    n = n_records.value
    L = row_len or _round_up(max_len.value)
    codes = np.empty((n, L), np.uint8)
    lengths = np.empty(n, np.int32)
    t_off = np.empty(n, np.int64)
    t_len = np.empty(n, np.int32)
    if n:
        lib.stpu_fastq_fill(
            buf,
            consumed,
            n,
            L,
            _as_ptr(codes, ctypes.c_uint8),
            _as_ptr(lengths, ctypes.c_int32),
            _as_ptr(t_off, ctypes.c_int64),
            _as_ptr(t_len, ctypes.c_int32),
        )
    titles = [buf[o : o + l].decode("ascii", "replace") for o, l in zip(t_off, t_len)]
    return PackedReads(codes, lengths, titles), consumed


def pack_fasta_chunk(buf: bytes, row_len: Optional[int] = None) -> PackedReads:
    """Parse a whole FASTA byte buffer."""
    lib = _load()
    if lib is None:
        return _pack_fasta_py(buf, row_len)
    n_records = ctypes.c_int64()
    max_len = ctypes.c_int64()
    lib.stpu_fasta_scan(buf, len(buf), ctypes.byref(n_records), ctypes.byref(max_len))
    n = n_records.value
    L = row_len or _round_up(max_len.value)
    codes = np.empty((n, L), np.uint8)
    lengths = np.empty(n, np.int32)
    t_off = np.empty(n, np.int64)
    t_len = np.empty(n, np.int32)
    if n:
        rc = lib.stpu_fasta_fill(
            buf,
            len(buf),
            n,
            L,
            _as_ptr(codes, ctypes.c_uint8),
            _as_ptr(lengths, ctypes.c_int32),
            _as_ptr(t_off, ctypes.c_int64),
            _as_ptr(t_len, ctypes.c_int32),
        )
        if rc != 0:
            raise ValueError("malformed FASTA buffer")
    titles = [buf[o : o + l].decode("ascii", "replace") for o, l in zip(t_off, t_len)]
    return PackedReads(codes, lengths, titles)


def encode_bytes(data: bytes) -> np.ndarray:
    lib = _load()
    out = np.empty(len(data), np.uint8)
    if lib is None:
        return CODE_LUT[np.frombuffer(data, np.uint8)]
    lib.stpu_encode(data, len(data), _as_ptr(out, ctypes.c_uint8))
    return out


def _round_up(n: int, m: int = 128) -> int:
    return max(m, ((n + m - 1) // m) * m)


# -- python fallbacks --------------------------------------------------------


def _pack_fastq_py(buf: bytes, row_len):
    lines = buf.split(b"\n")
    n_complete = (len(lines) - 1) // 4  # last element may be partial
    titles, seqs = [], []
    consumed = 0
    for i in range(n_complete):
        h, s = lines[4 * i], lines[4 * i + 1]
        titles.append(h[1:].decode("ascii", "replace"))
        seqs.append(s)
        consumed += len(h) + len(s) + len(lines[4 * i + 2]) + len(lines[4 * i + 3]) + 4
    L = row_len or _round_up(max((len(s) for s in seqs), default=0))
    codes = np.full((len(seqs), L), 4, np.uint8)
    lengths = np.zeros(len(seqs), np.int32)
    for i, s in enumerate(seqs):
        c = CODE_LUT[np.frombuffer(s, np.uint8)]
        codes[i, : min(len(c), L)] = c[:L]
        lengths[i] = len(c)
    return PackedReads(codes, lengths, titles), consumed


def _pack_fasta_py(buf: bytes, row_len):
    titles, seqs = [], []
    cur: List[bytes] = []
    for line in buf.split(b"\n"):
        line = line.rstrip(b"\r")
        if line.startswith(b">"):
            if titles:
                seqs.append(b"".join(cur))
            titles.append(line[1:].decode("ascii", "replace"))
            cur = []
        elif line:
            cur.append(line)
    if titles:
        seqs.append(b"".join(cur))
    L = row_len or _round_up(max((len(s) for s in seqs), default=0))
    codes = np.full((len(seqs), L), 4, np.uint8)
    lengths = np.zeros(len(seqs), np.int32)
    for i, s in enumerate(seqs):
        c = CODE_LUT[np.frombuffer(s, np.uint8)]
        codes[i, : min(len(c), L)] = c[:L]
        lengths[i] = len(c)
    return PackedReads(codes, lengths, titles)


def hit_lines(codes, window_taxa, splits, row_lens, k):
    """Per-read (hit_details, length_string) pairs, C++-accelerated.
    Returns None when the native library is unavailable (caller falls back).
    codes: [B, L] uint8; window_taxa: [B, L] int32; splits: -1 or R1 length.
    """
    lib = _load()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, np.uint8)
    wt = np.ascontiguousarray(window_taxa, np.int32)
    b, l = codes.shape
    splits_arr = np.asarray(splits, np.int64)
    lens_arr = np.asarray(row_lens, np.int64)
    cap_row = l * 14 + 64
    out = _emit_buffer(b * cap_row)
    offsets = np.empty(b + 1, np.int64)
    lib.stpu_hit_lines(
        _as_ptr(codes, ctypes.c_uint8),
        _as_ptr(wt, ctypes.c_int32),
        b,
        l,
        _as_ptr(splits_arr, ctypes.c_int64),
        _as_ptr(lens_arr, ctypes.c_int64),
        k,
        out,
        _as_ptr(offsets, ctypes.c_int64),
    )
    # each row writes into its private slot [r*cap_row, offsets[r]) so the
    # C++ loop parallelises row-wise; offsets[r] is the row's END
    mv = memoryview(out)
    result = []
    for r in range(b):
        row = str(mv[r * cap_row : offsets[r] - 1], "ascii")  # strip \n
        details, _, length = row.rpartition("\t")
        result.append((details, length))
    return result


def hit_lines_runs(values, counts, nruns, totals, splits, k):
    """Per-read (hit_details, length_string) from device-reduced hit runs
    (ops/hitruns.py); O(runs) per row instead of O(row length). Returns
    None when the native library is unavailable (caller falls back)."""
    lib = _load()
    if lib is None:
        return None
    values = np.ascontiguousarray(values, np.int32)
    counts = np.ascontiguousarray(counts, np.int32)
    b, cap = values.shape
    nruns_arr = np.ascontiguousarray(nruns, np.int64)
    totals_arr = np.ascontiguousarray(totals, np.int64)
    splits_arr = np.ascontiguousarray(splits, np.int64)
    cap_row = cap * 24 + 64
    out = _emit_buffer(b * cap_row)
    offsets = np.empty(b + 1, np.int64)
    lib.stpu_hit_lines_runs(
        _as_ptr(values, ctypes.c_int32),
        _as_ptr(counts, ctypes.c_int32),
        _as_ptr(nruns_arr, ctypes.c_int64),
        _as_ptr(totals_arr, ctypes.c_int64),
        _as_ptr(splits_arr, ctypes.c_int64),
        b,
        cap,
        k,
        cap_row,
        out,
        _as_ptr(offsets, ctypes.c_int64),
    )
    mv = memoryview(out)
    result = []
    for r in range(b):
        row = str(mv[r * cap_row : offsets[r] - 1], "ascii")
        details, _, length = row.rpartition("\t")
        result.append((details, length))
    return result


#: reused private-slot emit buffer for the output_lines_*/hit_lines*
#: formatters — a fresh multi-MB allocation per batch costs more in page
#: faults than the C++ emit loop itself. THREAD-LOCAL so concurrent
#: Classifier streams never share a buffer; within a thread the buffer is
#: consumed (gathered/joined/decoded) by the caller before the next
#: formatter call overwrites it.
_emit_tls = threading.local()


def _emit_buffer(size: int):
    buf = getattr(_emit_tls, "buf", None)
    if buf is None or len(buf) < size:
        buf = ctypes.create_string_buffer(max(size, 1 << 20))
        _emit_tls.buf = buf
    return buf


def output_lines_runs(values, counts, nruns, totals, splits, titles_blob,
                      title_offs, rtax, classified, k, max_title):
    """Full per-read Kraken output lines from device hit runs. Returns
    (buf, starts [B] int64, ends [B] int64) or None (no native lib); row
    r's line is buf[starts[r]:ends[r]] including the trailing newline.
    `buf` is the SHARED emit buffer — consume before the next formatter
    call (gather_rows or a memoryview join)."""
    lib = _load()
    if lib is None:
        return None
    values = np.ascontiguousarray(values, np.int32)
    counts = np.ascontiguousarray(counts, np.int32)
    b, cap = values.shape
    cap_row = cap * 24 + int(max_title) + 80
    out = _emit_buffer(b * cap_row)
    ends = np.empty(b, np.int64)
    lib.stpu_output_lines_runs(
        _as_ptr(values, ctypes.c_int32),
        _as_ptr(counts, ctypes.c_int32),
        _as_ptr(np.ascontiguousarray(nruns, np.int64), ctypes.c_int64),
        _as_ptr(np.ascontiguousarray(totals, np.int64), ctypes.c_int64),
        _as_ptr(np.ascontiguousarray(splits, np.int64), ctypes.c_int64),
        titles_blob,
        _as_ptr(np.ascontiguousarray(title_offs, np.int64), ctypes.c_int64),
        _as_ptr(np.ascontiguousarray(rtax, np.int64), ctypes.c_int64),
        _as_ptr(np.ascontiguousarray(classified, np.uint8), ctypes.c_uint8),
        b,
        cap,
        k,
        cap_row,
        out,
        _as_ptr(ends, ctypes.c_int64),
    )
    starts = np.arange(b, dtype=np.int64) * cap_row
    return out, starts, ends


def output_lines_dense(codes, window_taxa, splits, row_lens, titles_blob,
                       title_offs, rtax, classified, k, max_title):
    """Full per-read Kraken output lines from DENSE window taxa (the
    per-read mode's device-to-host transfer) — no per-read Python.
    Returns (buf, starts [B] int64, ends [B] int64) or None (no native
    lib); row r's line is buf[starts[r]:ends[r]] incl. newline. `buf` is
    the SHARED emit buffer — consume before the next formatter call."""
    lib = _load()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, np.uint8)
    wt = np.ascontiguousarray(window_taxa, np.int32)
    b, l = codes.shape
    cap_row = l * 14 + int(max_title) + 80
    out = _emit_buffer(b * cap_row)
    ends = np.empty(b, np.int64)
    lib.stpu_output_lines_dense(
        _as_ptr(codes, ctypes.c_uint8),
        _as_ptr(wt, ctypes.c_int32),
        _as_ptr(np.ascontiguousarray(splits, np.int64), ctypes.c_int64),
        _as_ptr(np.ascontiguousarray(row_lens, np.int64), ctypes.c_int64),
        titles_blob,
        _as_ptr(np.ascontiguousarray(title_offs, np.int64), ctypes.c_int64),
        _as_ptr(np.ascontiguousarray(rtax, np.int64), ctypes.c_int64),
        _as_ptr(np.ascontiguousarray(classified, np.uint8), ctypes.c_uint8),
        b,
        l,
        k,
        cap_row,
        out,
        _as_ptr(ends, ctypes.c_int64),
    )
    starts = np.arange(b, dtype=np.int64) * cap_row
    return out, starts, ends


def gather_rows(buf, starts, ends, idxs) -> bytearray:
    """Concatenate rows `idxs` of an output_lines_* emit buffer into one
    contiguous bytearray (C memcpy loop; no per-row Python)."""
    lib = _load()
    starts = np.ascontiguousarray(starts, np.int64)
    ends = np.ascontiguousarray(ends, np.int64)
    idxs = np.ascontiguousarray(idxs, np.int64)
    if lib is None:  # pure-Python fallback (tests stub the formatters)
        mv = memoryview(buf)
        return bytearray(b"").join(
            [mv[starts[i] : ends[i]] for i in idxs.tolist()]
        )
    total = int((ends[idxs] - starts[idxs]).sum())
    dst = bytearray(total)
    if total == 0:
        return dst
    lib.stpu_gather_rows(
        buf,
        _as_ptr(starts, ctypes.c_int64),
        _as_ptr(ends, ctypes.c_int64),
        _as_ptr(idxs, ctypes.c_int64),
        len(idxs),
        (ctypes.c_char * total).from_buffer(dst),
    )
    return dst
