"""Index probe: exact-match lookup of minimizer keys in a sorted index.

The index carries a prefix directory (`build_directory`): the top bits of a
key name a bucket of a few neighbouring keys, so a probe is a directory
load and a short scan instead of a bisection of the whole
array. `lookup_taxa` is the plain PyTorch twin (torch.searchsorted over the
sorted int64 keys); `lookup_taxa_directory` walks the directory with tensor
ops (the CUDA kernel, kernels/probe.cu, scans forward from the bucket's
start where this bisects the bucket); `probe` is the entry
point the pipeline calls: the kernel for CUDA tensors, the twin for CPU
tensors. All return the key's taxon, or 0 (NONE) on a miss, for any int64
query.

Wide keys (m > 31) are rows of an interleaved int64 [N, 2] tensor, the
(hi64, lo64) limbs of a 2m-bit value, sorted by the value; hi64 is below
2^62 and lo64 is compared unsigned. Every function here takes either kind
and tells them apart by `keys.dim()`; queries are [Q] or [Q, 2] to match.
The directory's prefix then comes from the top of the widest 128-bit key
(wholly or mostly from lo64 when m is 32 or 33), and its shift reaches 127.
On the card a wide index is probed through its slot table (`build_slots`):
each key's remainder below its bucket's prefix and its taxon (or the
taxon's code) in one 16-byte row, so that a hit reads its taxon with its
key; `lookup_taxa_slots` is that walk's twin.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

#: mean keys per directory bucket: one 32-byte sector (measured on an H100
#: against 2, 8, 16 and 64)
BUCKET_KEYS = 4
#: mean keys per bucket of a slot table's directory (build_slots): fewer
#: slots to walk and an empty bucket walks none, for 4 bytes of directory a
#: key (measured on an H100 against 2, 4 and 8 with scan_timing.py; PERF.md)
SLOT_BUCKET_KEYS = 1
#: rows a step of a wide directory's or a slot table's construction: a few
#: temporaries of this many rows beside the index, not of the whole index
CHUNK_ROWS = 1 << 24


class Directory(NamedTuple):
    """Prefix directory over sorted non-negative keys: bucket p holds the
    keys with `key >> shift == p`, at `starts[p] : starts[p + 1]`."""

    starts: torch.Tensor  # int32 [2^b + 1], starts[2^b] = number of keys
    shift: int  # 0 <= shift <= 63, or <= 127 over wide keys

    @property
    def buckets(self) -> int:
        return self.starts.shape[0] - 1


def build_directory(keys: torch.Tensor, bucket_keys: int = BUCKET_KEYS) -> Directory:
    """Directory of the sorted, unique, non-negative `keys` with about
    `bucket_keys` keys a bucket: b = ceil(log2(n / bucket_keys)) prefix bits,
    taken from the top of the widest key. One pass over the keys; index
    preparation, not part of a probe."""
    n = keys.shape[0]
    if n >= 1 << 31:
        raise ValueError(f"the directory's int32 entries hold fewer than 2^31 keys, got {n}")
    if keys.dim() == 2:
        return _build_directory_wide(keys, bucket_keys)
    if n and int(keys[0]) < 0:
        raise ValueError("index keys must be non-negative")
    width = int(keys[-1]).bit_length() if n else 0
    b = prefix_bits(n, width, bucket_keys)
    shift = width - b
    edges = torch.arange((1 << b) + 1, dtype=torch.int64, device=keys.device) << shift
    starts = torch.searchsorted(keys, edges).to(torch.int32)
    starts[-1] = n  # 2^b << shift overflows int64 when width is 63
    return Directory(starts, shift)


def prefix_bits(n: int, width: int, bucket_keys: int = BUCKET_KEYS) -> int:
    """b of the directory of n keys of `width` bits with about `bucket_keys`
    keys a bucket: ceil(log2(n / bucket_keys)), at most the width."""
    return min((max(-(-n // bucket_keys), 1) - 1).bit_length(), width)


def lookup_taxa(keys: torch.Tensor, taxa: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Plain exact-match probe: int32 taxon per query, 0 on a miss."""
    n = keys.shape[0]
    if n == 0:
        return torch.zeros(queries.shape[:1], dtype=torch.int32, device=queries.device)
    if keys.dim() == 2:
        return _lookup_taxa_wide(keys, taxa, queries)
    pos = torch.searchsorted(keys, queries)
    idx = pos.clamp(max=n - 1)
    found = (pos < n) & (keys[idx] == queries)
    return torch.where(found, taxa[idx], 0).to(torch.int32)


def lookup_taxa_directory(
    keys: torch.Tensor, taxa: torch.Tensor, directory: Directory, queries: torch.Tensor
) -> torch.Tensor:
    """A walk of the directory in tensor ops: prefix, the bucket's two
    directory entries, bisection of the bucket, one taxon gather. Holds the
    directory and its edge cases against `lookup_taxa` on the CPU; off the
    pipeline's path."""
    n = keys.shape[0]
    starts, shift = directory
    if n == 0 or queries.numel() == 0:
        return torch.zeros(queries.shape[:1], dtype=torch.int32, device=queries.device)
    if keys.dim() == 2:
        return _lookup_taxa_directory_wide(keys, taxa, directory, queries)
    # a negative query, or one above the widest key's prefix, misses unsearched
    prefix = queries >> shift
    inside = (queries >= 0) & (prefix < directory.buckets)
    p = torch.where(inside, prefix, 0)
    lo, hi = starts[p].long(), starts[p + 1].long()
    end = hi
    for _ in range(int((hi - lo).max()).bit_length()):
        mid = (lo + hi) >> 1
        less = (lo < hi) & (keys[mid.clamp(max=n - 1)] < queries)
        lo, hi = torch.where(less, mid + 1, lo), torch.where(less | (lo >= hi), hi, mid)
    idx = lo.clamp(max=n - 1)
    found = inside & (lo < end) & (keys[idx] == queries)
    return torch.where(found, taxa[idx], 0).to(torch.int32)


def probe(keys, taxa, directory, queries: torch.Tensor) -> torch.Tensor:
    """Probe `queries` (int64 [Q], or [Q, 2] in a wide index) in the index:
    a directory kernel on CUDA, the plain twin on the CPU. A wide index on
    the card passes its slot table (`build_slots`) as `directory`; the
    kernel, or on the CPU its twin `lookup_taxa_slots`, then reads neither
    `keys` nor `taxa`, which may be None."""
    slots = isinstance(directory, SlotTable)
    if queries.device.type == "cpu":
        return lookup_taxa_slots(directory, queries) if slots else lookup_taxa(keys, taxa, queries)
    from . import cuda_kernels

    if slots:
        return cuda_kernels.lookup_taxa_slots_cuda(directory, queries)
    return cuda_kernels.lookup_taxa_directory_cuda(keys, taxa, directory, queries)


# ---------------------------------------------------------------------------
# Wide keys: int64 [N, 2] rows of (hi64, lo64)
# ---------------------------------------------------------------------------

_SIGN = -(1 << 63)  # x ^ _SIGN: unsigned order of x as signed order


def prefix_wide(k2: torch.Tensor, shift: int):
    """(low 64 bits, the bits above them) of the 128-bit values `k2 >> shift`
    with hi64 >= 0, 0 <= shift <= 127."""
    hi, lo = k2[:, 0], k2[:, 1]
    if shift >= 64:
        return hi >> (shift - 64), torch.zeros_like(hi)
    if shift == 0:
        return lo, hi
    lo_part = (lo >> shift) & ((1 << (64 - shift)) - 1)  # a logical shift
    return (hi << (64 - shift)) | lo_part, hi >> shift


def _build_directory_wide(keys: torch.Tensor, bucket_keys: int) -> Directory:
    n = keys.shape[0]
    if n and int(keys[0, 0]) < 0:
        raise ValueError("index keys must be non-negative")
    widest = ((int(keys[-1, 0]) << 64) | (int(keys[-1, 1]) & ((1 << 64) - 1))) if n else 0
    width = widest.bit_length()
    return _directory_wide(keys, prefix_bits(n, width, bucket_keys), width)


def _directory_wide(keys: torch.Tensor, b: int, width: int) -> Directory:
    """The directory of 2^b buckets named by the top b of `width` bits,
    made in steps of CHUNK_ROWS keys and of as many buckets."""
    shift = width - b
    prefixes = torch.empty(keys.shape[0], dtype=torch.int64, device=keys.device)
    for i in range(0, keys.shape[0], CHUNK_ROWS):  # below 2^b, b <= 31: sorted as signed
        prefixes[i:i + CHUNK_ROWS] = prefix_wide(keys[i:i + CHUNK_ROWS], shift)[0]
    starts = torch.empty((1 << b) + 1, dtype=torch.int32, device=keys.device)
    for e in range(0, starts.shape[0], CHUNK_ROWS):
        edges = torch.arange(e, min(e + CHUNK_ROWS, starts.shape[0]), dtype=torch.int64, device=keys.device)
        starts[e:e + edges.shape[0]] = torch.searchsorted(prefixes, edges, out_int32=True)
    return Directory(starts, shift)


def _bisect_wide(keys, queries, lo, hi):
    """First position in [lo, hi) whose key is not below its query, by
    bisection on both limbs, each compared unsigned; `hi` where every key of
    the range is below."""
    n = keys.shape[0]
    q_hi, q_lo = queries[:, 0] ^ _SIGN, queries[:, 1] ^ _SIGN
    for _ in range(int((hi - lo).max()).bit_length()):
        mid = ((lo + hi) >> 1).clamp(max=n - 1)
        k_hi, k_lo = keys[mid, 0] ^ _SIGN, keys[mid, 1] ^ _SIGN
        less = (lo < hi) & ((k_hi < q_hi) | ((k_hi == q_hi) & (k_lo < q_lo)))
        lo, hi = torch.where(less, mid + 1, lo), torch.where(less | (lo >= hi), hi, mid)
    return lo


def _taxa_at(keys, taxa, queries, pos, end, inside):
    idx = pos.clamp(max=keys.shape[0] - 1)
    found = inside & (pos < end) & (keys[idx] == queries).all(1)
    return torch.where(found, taxa[idx], 0).to(torch.int32)


def _lookup_taxa_wide(keys, taxa, queries):
    """torch.searchsorted has no pair form: the run of keys with the
    query's hi64 from two searches, then a bisection of lo64 inside it. A
    negative hi64 (an invalid window's -1) matches no key."""
    if queries.shape[0] == 0:
        return torch.zeros(0, dtype=torch.int32, device=queries.device)
    hi = keys[:, 0].contiguous()
    q_hi = queries[:, 0].contiguous()
    lo, end = torch.searchsorted(hi, q_hi), torch.searchsorted(hi, q_hi, right=True)
    pos = _bisect_wide(keys, queries, lo, end)
    return _taxa_at(keys, taxa, queries, pos, end, q_hi >= 0)


def _bucket_wide(directory: Directory, queries: torch.Tensor):
    """(inside, start, end) of each wide query's bucket: a negative hi64 (an
    invalid window's -1) or a prefix beyond every bucket is not inside, and
    gets bucket 0's range."""
    starts, shift = directory
    p_lo, p_above = prefix_wide(queries, shift)
    inside = (queries[:, 0] >= 0) & (p_above == 0) & (p_lo >= 0) & (p_lo < directory.buckets)
    p = torch.where(inside, p_lo, 0)
    return inside, starts[p].long(), starts[p + 1].long()


def _lookup_taxa_directory_wide(keys, taxa, directory, queries):
    inside, lo, end = _bucket_wide(directory, queries)
    pos = _bisect_wide(keys, queries, lo, end)
    return _taxa_at(keys, taxa, queries, pos, end, inside)


# ---------------------------------------------------------------------------
# The slot table of a wide index: key and taxon in one 16-byte row
# ---------------------------------------------------------------------------


class SlotTable(NamedTuple):
    """A wide index as the probe kernel reads it. Inside bucket p of
    `directory` every key is (p << shift) | r with r < 2^shift, so a row
    holds the 128-bit value (r << c) | f as (hi64, lo64), in key order: the
    key's remainder above a field f of c bits, which is the taxon itself
    (`codes` None) or its position in `codes`."""

    slots: torch.Tensor  # int64 [N, 2]; hi64 may have its top bit set
    c: int  # 1 <= c <= 32, and directory.shift + c <= 128
    codes: Optional[torch.Tensor]  # int32 [D]: the index's distinct taxa, sorted; None: f is the taxon
    directory: Directory  # the index's directory, with b raised where the fit rule needs it


def slot_fit(shift: int, top: int, n_taxa: int) -> Tuple[int, int, bool]:
    """The fit rule of a slot's field, for an index whose directory has this
    shift, whose largest taxon is `top` and which holds `n_taxa` distinct
    taxa: (bits by which the directory's b must rise, c, direct). The field
    takes the c = min(32, 128 - shift) bits that the remainder leaves. It
    holds the taxon itself if every taxon is below 2^c (always when shift <=
    96, for taxa are int32), else the taxon's code, which needs
    bitlen(n_taxa - 1) bits; where those are more than c, each bit by which
    b rises takes one from the remainder and gives it to the field.

    With at most 4 keys a bucket (SLOT_BUCKET_KEYS, BUCKET_KEYS) no rise is
    needed: either b is the whole width (shift = 0, c = 32, direct), or
    b = bitlen(ceil(n / 4) - 1) >= bitlen(n - 1) - 2 over n keys (more with
    smaller buckets), and then shift = width - b <= 126 - b, so
    c >= min(32, b + 2) >= min(32, bitlen(n - 1)) >= bitlen(n_taxa - 1), as
    n_taxa <= n < 2^31. Only a directory asked for with larger buckets needs
    the rise."""
    c = min(32, 128 - shift)
    if top < 1 << c:
        return 0, c, True
    rise = max(0, (n_taxa - 1).bit_length() - c)
    return rise, c + rise, False


def _low_bits(k2: torch.Tensor, shift: int):
    """(hi64, lo64) of the 128-bit values `k2` modulo 2^shift, 0 <= shift <= 127."""
    hi, lo = k2[:, 0], k2[:, 1]
    if shift >= 64:
        return hi & ((1 << (shift - 64)) - 1), lo
    return torch.zeros_like(hi), lo & ((1 << shift) - 1)


def _shl(hi: torch.Tensor, lo: torch.Tensor, c: int):
    """(hi64, lo64) of the 128-bit values (hi, lo) << c, 1 <= c <= 32, for
    values below 2^(128 - c); the bits that cross into hi64 by a logical shift."""
    return (hi << c) | ((lo >> (64 - c)) & ((1 << c) - 1)), lo << c


def build_slots(keys: torch.Tensor, taxa: torch.Tensor, directory: Optional[Directory] = None) -> SlotTable:
    """The slot table of the sorted, unique wide `keys` ([N, 2]) with int32
    `taxa` under `directory` (by default build_directory(keys,
    SLOT_BUCKET_KEYS)), by the fit rule (`slot_fit`), in torch ops on the
    keys' device. Index preparation, once an index and device."""
    n = keys.shape[0]
    if keys.dim() != 2 or taxa.shape != (n,):
        raise ValueError(f"slots take wide keys [N, 2] and taxa [N], got {tuple(keys.shape)} and {tuple(taxa.shape)}")
    if directory is None:
        directory = build_directory(keys, SLOT_BUCKET_KEYS)
    if n and int(taxa.min()) < 0:
        raise ValueError("taxa must be non-negative")
    b = directory.buckets.bit_length() - 1
    top = int(taxa.max()) if n else 0
    codes = torch.unique(taxa) if top >> min(32, 128 - directory.shift) else None
    rise, c, direct = slot_fit(directory.shift, top, 0 if codes is None else codes.shape[0])
    if rise:
        directory = _directory_wide(keys, b + rise, directory.shift + b)
    slots = torch.empty((n, 2), dtype=torch.int64, device=keys.device)
    for i in range(0, n, CHUNK_ROWS):
        t = taxa[i:i + CHUNK_ROWS]
        hi, lo = _shl(*_low_bits(keys[i:i + CHUNK_ROWS], directory.shift), c)
        slots[i:i + CHUNK_ROWS, 0] = hi
        slots[i:i + CHUNK_ROWS, 1] = lo | (t.long() if direct else torch.searchsorted(codes, t))
    return SlotTable(slots, c, codes, directory)


def lookup_taxa_slots(table: SlotTable, queries: torch.Tensor) -> torch.Tensor:
    """The slot kernel's walk in tensor ops: the query's bucket from the
    directory, Q = (query mod 2^shift) << c, a bisection of the bucket for
    its first slot not below Q (unsigned in both limbs), a hit where that
    slot's bits above the field equal Q's, then the field or its code.
    int32 [Q], 0 on a miss. The tests' and chip_smoke.py's twin of the
    kernel; off the pipeline's path."""
    slots, c, codes, directory = table
    n = slots.shape[0]
    if n == 0 or queries.shape[0] == 0:
        return torch.zeros(queries.shape[:1], dtype=torch.int32, device=queries.device)
    inside, lo, end = _bucket_wide(directory, queries)
    q = torch.stack(_shl(*_low_bits(queries, directory.shift), c), 1)
    pos = _bisect_wide(slots, q, lo, end)
    s = slots[pos.clamp(max=n - 1)]
    found = inside & (pos < end) & (s[:, 0] == q[:, 0]) & (((s[:, 1] ^ q[:, 1]) >> c) == 0)
    field = s[:, 1] & ((1 << c) - 1)
    taxon = field if codes is None else codes[torch.where(found, field, 0)]
    return torch.where(found, taxon, 0).to(torch.int32)
