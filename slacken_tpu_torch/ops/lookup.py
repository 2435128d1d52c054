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
On the card an index is probed through its slot table (`build_slots`):
each key's remainder below its bucket's prefix and its taxon (or the
taxon's code) in one word, 8 bytes for narrow keys and 16 for wide, so that
a hit reads its taxon with its key and the card holds the records once;
`lookup_taxa_slots` is that walk's twin.

The JAX package's other probe tables, which `--probe` picks, are here too,
narrow and wide, built in torch ops on the keys' device with the JAX
builders' layouts and growth rules: the tiled table (`build_tiled`: a
prefix router and the records in key order as [rows, tile, 3|5] uint32
lanes) and the row-bucket table of `hashed1` (`build_hashed_rows`: the top
row_bits of a scrambled key name its row of [3|5 * tile] uint32 lanes).
`lookup_taxa_tiled` and `lookup_taxa_hashed_rows` are their lookups as the
JAX package writes them (gathers of whole rows), the twins of the kernels in
kernels/probe_tables.cu. For narrow keys also the displacement-bounded
hashed table of `hashed` and `hashed128` (`build_hashed`,
`build_hashed_cols`: each scrambled key parked within tile - 1 slots of its
home slot, in [rows, tile, 3] or [rows, 3 * tile] lanes), probed by
`lookup_taxa_hashed(_cols)` on the CPU and by probe_tables.cu's
probe_hashed kernel on the card, and the padded arrays of `bucketed`
(`build_bucketed`: the tiled table's router over the keys and taxa padded by
the largest bucket), probed by `lookup_taxa_bucketed` on the CPU and by
probe_tables.cu's probe_bucketed kernel on the card. Tables hold uint32
lanes as int32 bit patterns.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
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
    return _directory_narrow(keys, prefix_bits(n, width, bucket_keys), width)


def _directory_narrow(keys: torch.Tensor, b: int, width: int) -> Directory:
    """The directory of 2^b buckets named by the top b of `width` bits of
    the sorted narrow `keys`, made in steps of CHUNK_ROWS buckets."""
    shift = width - b
    starts = torch.empty((1 << b) + 1, dtype=torch.int32, device=keys.device)
    for e in range(0, starts.shape[0], CHUNK_ROWS):
        edges = torch.arange(e, min(e + CHUNK_ROWS, starts.shape[0]), dtype=torch.int64, device=keys.device)
        starts[e:e + edges.shape[0]] = torch.searchsorted(keys, edges << shift, out_int32=True)
    starts[-1] = keys.shape[0]  # 2^b << shift overflows int64 when width is 63
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
    if n == 0 or queries.numel() == 0:
        return torch.zeros(queries.shape[:1], dtype=torch.int32, device=queries.device)
    if keys.dim() == 2:
        return _lookup_taxa_directory_wide(keys, taxa, directory, queries)
    inside, lo, end = _bucket(directory, queries)
    pos = _bisect(keys, queries, lo, end)
    idx = pos.clamp(max=n - 1)
    found = inside & (pos < end) & (keys[idx] == queries)
    return torch.where(found, taxa[idx], 0).to(torch.int32)


def _bucket(directory: Directory, queries: torch.Tensor):
    """(inside, start, end) of each narrow query's bucket: a negative query
    (an invalid window's -1), or one above the widest key's prefix, is not
    inside, and gets bucket 0's range."""
    starts, shift = directory
    prefix = queries >> shift
    inside = (queries >= 0) & (prefix < directory.buckets)
    p = torch.where(inside, prefix, 0)
    return inside, starts[p].long(), starts[p + 1].long()


def _bisect(keys, queries, lo, hi):
    """First position in [lo, hi) of the int64 `keys` not below its query,
    both compared unsigned, by bisection; `hi` where every key of the range
    is below."""
    n = keys.shape[0]
    q = queries ^ _SIGN
    for _ in range(int((hi - lo).max()).bit_length()):
        mid = (lo + hi) >> 1
        less = (lo < hi) & ((keys[mid.clamp(max=n - 1)] ^ _SIGN) < q)
        lo, hi = torch.where(less, mid + 1, lo), torch.where(less | (lo >= hi), hi, mid)
    return lo


def probe(keys, taxa, directory, queries: torch.Tensor) -> torch.Tensor:
    """Probe `queries` (int64 [Q], or [Q, 2] in a wide index) in the index:
    a kernel on CUDA, the plain twin on the CPU. The routed probe of an
    index on the card passes its slot table (`build_slots`; narrow or wide)
    as `directory`, and the other probes their `TiledTable`, `HashedRows`,
    `HashedTable` or `Bucketed`;
    the kernel, or on the CPU its twin, then reads neither `keys` nor
    `taxa`, which may be None."""
    kind = type(directory)
    if queries.device.type == "cpu":
        twin = {SlotTable: lookup_taxa_slots, TiledTable: lookup_taxa_tiled, HashedRows: lookup_taxa_hashed_rows,
                HashedTable: lookup_taxa_hashed, Bucketed: lookup_taxa_bucketed}.get(kind)
        return lookup_taxa(keys, taxa, queries) if twin is None else twin(directory, queries)
    from . import cuda_kernels

    kernel = {SlotTable: cuda_kernels.lookup_taxa_slots_cuda, TiledTable: cuda_kernels.lookup_taxa_tiled_cuda,
              HashedRows: cuda_kernels.lookup_taxa_rows_cuda, HashedTable: cuda_kernels.lookup_taxa_hashed_cuda,
              Bucketed: cuda_kernels.lookup_taxa_bucketed_cuda}.get(kind)
    if kernel is None:
        return cuda_kernels.lookup_taxa_directory_cuda(keys, taxa, directory, queries)
    return kernel(directory, queries)


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
# The slot table: key remainder and taxon in one word, 8 bytes a narrow key
# and 16 a wide one
# ---------------------------------------------------------------------------


class SlotTable(NamedTuple):
    """An index as the routed probe kernels read it on the card. Inside
    bucket p of `directory` every key is (p << shift) | r with r < 2^shift,
    so a slot holds the value (r << c) | f, in key order: the key's
    remainder above a field f of c bits, which is the taxon itself (`codes`
    None) or its position in `codes`. A narrow index's slot is one int64, a
    wide index's the 128-bit value as a row (hi64, lo64)."""

    slots: torch.Tensor  # int64 [N] (narrow) or [N, 2] (wide); the top bit may be set
    c: int  # 1 <= c <= 32, and directory.shift + c <= 64 (narrow) or 128 (wide)
    codes: Optional[torch.Tensor]  # int32 [D]: the index's distinct taxa, sorted; None: f is the taxon
    directory: Directory  # the index's directory, with b raised where the fit rule needs it


def slot_fit(shift: int, top: int, n_taxa: int, width: int = 128) -> Tuple[int, int, bool]:
    """The fit rule of a slot's field, for an index whose directory has this
    shift, whose largest taxon is `top` and which holds `n_taxa` distinct
    taxa, in slots of `width` bits (64 narrow, 128 wide): (bits by which the
    directory's b must rise, c, direct). The field takes the c = min(32,
    width - shift) bits that the remainder leaves. It holds the taxon
    itself if every taxon is below 2^c (always when shift <= width - 32, for
    taxa are int32), else the taxon's code, which needs bitlen(n_taxa - 1)
    bits; where those are more than c, each bit by which b rises takes one
    from the remainder and gives it to the field.

    With at most 4 keys a bucket (SLOT_BUCKET_KEYS, BUCKET_KEYS) no rise is
    needed: either b is the whole key width (shift = 0, c = 32, direct), or
    b = bitlen(ceil(n / 4) - 1) >= bitlen(n - 1) - 2 over n keys (more with
    smaller buckets), and then shift = key width - b <= width - 2 - b, as
    narrow keys are below 2^62 and wide ones below 2^126, so c >= min(32, b
    + 2) >= min(32, bitlen(n - 1)) >= bitlen(n_taxa - 1), as n_taxa <= n <
    2^31. Only a directory asked for with larger buckets, or over narrow
    keys of 63 bits, needs the rise."""
    c = min(32, width - shift)
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


def _remainder(queries: torch.Tensor, shift: int, c: int) -> torch.Tensor:
    """Q = (query mod 2^shift) << c of narrow int64 queries, 0 <= shift <=
    63, as an int64 bit pattern (its top bit may be set)."""
    return (queries & ((1 << shift) - 1)) << c


def build_slots(keys: torch.Tensor, taxa: torch.Tensor, directory: Optional[Directory] = None) -> SlotTable:
    """The slot table of the sorted, unique `keys` (int64 [N], or [N, 2]
    wide) with int32 `taxa` under `directory` (by default
    build_directory(keys) with BUCKET_KEYS keys a bucket for narrow keys,
    one 32-byte sector of slots, and SLOT_BUCKET_KEYS for wide), by the fit
    rule (`slot_fit`, over 64 or 128 bits), in torch ops on the keys'
    device, CHUNK_ROWS rows a step. Index preparation, once an index and
    device."""
    n, wide = keys.shape[0], keys.dim() == 2
    if keys.dim() not in (1, 2) or keys.shape[1:] not in ((), (2,)) or taxa.shape != (n,):
        raise ValueError(f"slots take keys [N] or [N, 2] and taxa [N], got {tuple(keys.shape)} and {tuple(taxa.shape)}")
    if directory is None:
        directory = build_directory(keys, SLOT_BUCKET_KEYS if wide else BUCKET_KEYS)
    if n and int(taxa.min()) < 0:
        raise ValueError("taxa must be non-negative")
    width = 128 if wide else 64
    b = directory.buckets.bit_length() - 1
    top = int(taxa.max()) if n else 0
    codes = torch.unique(taxa) if top >> min(32, width - directory.shift) else None
    rise, c, direct = slot_fit(directory.shift, top, 0 if codes is None else codes.shape[0], width)
    if rise:
        directory = (_directory_wide if wide else _directory_narrow)(keys, b + rise, directory.shift + b)
    if wide:
        slots = torch.empty((n, 2), dtype=torch.int64, device=keys.device)
    else:  # a word past the last slot, which the kernel's 16-byte loads may read
        slots = torch.zeros(n + 1, dtype=torch.int64, device=keys.device)[:n]
    for i in range(0, n, CHUNK_ROWS):
        t = taxa[i:i + CHUNK_ROWS]
        f = t.long() if direct else torch.searchsorted(codes, t)
        if wide:
            hi, lo = _shl(*_low_bits(keys[i:i + CHUNK_ROWS], directory.shift), c)
            slots[i:i + CHUNK_ROWS, 0] = hi
            slots[i:i + CHUNK_ROWS, 1] = lo | f
        else:
            slots[i:i + CHUNK_ROWS] = _remainder(keys[i:i + CHUNK_ROWS], directory.shift, c) | f
    return SlotTable(slots, c, codes, directory)


def lookup_taxa_slots(table: SlotTable, queries: torch.Tensor) -> torch.Tensor:
    """The slot kernels' walk in tensor ops: the query's bucket from the
    directory, Q = (query mod 2^shift) << c, a bisection of the bucket for
    its first slot not below Q (unsigned, in both limbs of a wide slot), a
    hit where that slot's bits above the field equal Q's, then the field or
    its code. int32 [Q] for int64 queries [Q] (narrow) or [Q, 2] (wide), 0
    on a miss. The tests' and chip_smoke.py's twin of the kernels; off the
    pipeline's path."""
    slots, c, codes, directory = table
    n = slots.shape[0]
    if n == 0 or queries.shape[0] == 0:
        return torch.zeros(queries.shape[:1], dtype=torch.int32, device=queries.device)
    if slots.dim() == 2:
        inside, lo, end = _bucket_wide(directory, queries)
        q = torch.stack(_shl(*_low_bits(queries, directory.shift), c), 1)
        pos = _bisect_wide(slots, q, lo, end)
        s = slots[pos.clamp(max=n - 1)]
        found = inside & (pos < end) & (s[:, 0] == q[:, 0]) & (((s[:, 1] ^ q[:, 1]) >> c) == 0)
        field = s[:, 1] & ((1 << c) - 1)
    else:
        inside, lo, end = _bucket(directory, queries)
        q = _remainder(queries, directory.shift, c)
        pos = _bisect(slots, q, lo, end)
        s = slots[pos.clamp(max=n - 1)]
        found = inside & (pos < end) & (((s ^ q) >> c) == 0)
        field = s & ((1 << c) - 1)
    taxon = field if codes is None else codes[torch.where(found, field, 0)]
    return torch.where(found, taxon, 0).to(torch.int32)


def probe_bytes(arrays) -> int:
    """The bytes of the tensors among probe arrays (KeyValueIndex.device_arrays'
    triple, the fields of its table and of their directory), each once."""
    seen, total, todo = set(), 0, [arrays]
    while todo:
        a = todo.pop()
        if isinstance(a, torch.Tensor) and id(a) not in seen:
            seen.add(id(a))
            total += a.numel() * a.element_size()
        elif isinstance(a, (tuple, list)):
            todo.extend(a)
    return total


# ---------------------------------------------------------------------------
# The tiled and row-bucket tables of the probe choice (`--probe tiled|hashed1`)
# ---------------------------------------------------------------------------

#: the tiled table's least tile, and the row-bucket table's
TILED_TILE = 16
ROWS_TILE = 128
#: the largest tile either table grows to before its build gives up
MAX_TILE = 1 << 12
#: the router's largest prefix bits (a 2^24 + 1 entry router, 64 MiB)
ROUTER_MAX_BITS = 24
#: lanes a twin gathers at once: a chunk of queries holds this many
TWIN_LANES = 1 << 22


class TiledTable(NamedTuple):
    """The tiled table of an index (the JAX package's build_tiled /
    build_tiled_wide with build_router / build_router_wide): `router[p]` is
    the position of the first key whose top `bits` of `key_bits` are >= p,
    and `table` holds the records in key order, `tile` a row, each as
    uint32 lanes (hi, lo, taxon), or (l3, l2, l1, l0, taxon) for wide keys,
    padded with all-ones keys and taxon 0. Rows pos // tile and pos // tile +
    1 cover every router bucket (`tile_for_span`)."""

    router: torch.Tensor  # int32 [2^bits + 1]
    table: torch.Tensor  # int32 [rows, tile, 3 | 5]
    tile: int
    bits: int
    key_bits: int  # 2m: the width of the key space the router cuts


class HashedRows(NamedTuple):
    """The row-bucket table of `--probe hashed1` (build_hashed_rows): row r
    holds every key whose row hash has r as its top `row_bits`, in column
    blocks of `tile` lanes: (hi', lo', taxon) of the xorshift-scrambled key
    for narrow keys, in scrambled order; for wide keys the raw (l3, l2, l1,
    l0, taxon), in the order of the row hash. Free lanes are all ones (the
    taxon lane reads -1). `n_keys` is the number of keys, whose mean a row
    steers where the narrow kernel's walk starts (`row_guess`); any value
    gives the same answers."""

    table: torch.Tensor  # int32 [2^row_bits, 3 * tile | 5 * tile]
    tile: int
    row_bits: int
    n_keys: int


def adaptive_router_bits(n_keys: int, max_bits: int = ROUTER_MAX_BITS) -> int:
    """Prefix bits of the router of n_keys keys: about two entries a key,
    between 12 and max_bits."""
    if n_keys <= 1:
        return 12
    return min(max_bits, max(12, (n_keys - 1).bit_length() + 1))


def build_router(keys: torch.Tensor, bits: int, key_bits: int) -> torch.Tensor:
    """int32 [2^bits + 1]: entry p is the position of the first of the
    sorted `keys` (int64 [N], or [N, 2] wide) whose top `bits` of `key_bits`
    are >= p."""
    if keys.dim() == 2:
        return _directory_wide(keys, bits, key_bits).starts
    edges = torch.arange((1 << bits) + 1, dtype=torch.int64, device=keys.device) << (key_bits - bits)
    return torch.searchsorted(keys, edges, out_int32=True)


def max_bucket_span(router: torch.Tensor) -> int:
    """The most keys under one router prefix (at least 1)."""
    if router.shape[0] <= 1:
        return 1
    return max(1, int((router[1:] - router[:-1]).max()))


def tile_for_span(maxb: int, tile: int = TILED_TILE) -> int:
    """The least power-of-two multiple of `tile` with tile + 1 >= maxb: two
    consecutive rows then cover any router bucket."""
    while tile + 1 < maxb:
        tile *= 2
    return tile


def _limbs(keys: torch.Tensor):
    """The uint32 limbs of int64 keys ([N]: hi, lo; [N, 2]: l3, l2, l1, l0),
    most significant first, as int32 bit patterns."""
    words = (keys[:, 0], keys[:, 1]) if keys.dim() == 2 else (keys,)
    return [limb for w in words for limb in ((w >> 32).to(torch.int32), w.to(torch.int32))]


def build_tiled(keys: torch.Tensor, taxa: torch.Tensor, key_bits: int, tile: int = TILED_TILE) -> TiledTable:
    """The tiled table of the sorted, unique `keys` (int64 [N], or [N, 2]
    wide) with int32 `taxa`, in torch ops on their device: the router at
    min(adaptive_router_bits(N), key_bits) bits, the tile grown from `tile`
    until two rows cover its largest bucket, and ceil(N / tile) + 2 rows.
    Equal, lane for lane, to the JAX package's build_tiled(_wide)."""
    n = keys.shape[0]
    bits = min(adaptive_router_bits(n), key_bits)
    router = build_router(keys, bits, key_bits)
    tile = tile_for_span(max_bucket_span(router), tile)
    n_rows = -(-n // tile) + 2
    limbs = _limbs(keys)
    table = torch.empty((n_rows * tile, len(limbs) + 1), dtype=torch.int32, device=keys.device)
    for i, limb in enumerate(limbs):
        table[:n, i] = limb
    table[:n, -1] = taxa
    table[n:, :-1] = -1
    table[n:, -1] = 0
    return TiledTable(router, table.view(n_rows, tile, len(limbs) + 1), tile, bits, key_bits)


def router_buckets(table, queries: torch.Tensor):
    """(inside, p): whether each query lies inside the key space that the
    router of a TiledTable or Bucketed cuts (narrow: non-negative, its
    prefix below 2^bits), and its router bucket there (0 elsewhere)."""
    shift = table.key_bits - table.bits
    if queries.dim() == 2:
        p, above = prefix_wide(queries, shift)
        inside = (queries[:, 0] >= 0) & (above == 0) & (p >= 0) & (p < 1 << table.bits)
    else:
        p = queries >> shift
        inside = (queries >= 0) & (p < 1 << table.bits)
    return inside, torch.where(inside, p, 0)


def lookup_taxa_tiled(table: TiledTable, queries: torch.Tensor) -> torch.Tensor:
    """The tiled lookup as the JAX package writes it (lookup_taxa_tiled,
    lookup_taxa_tiled_wide): the router entry of the query's prefix, the two
    rows from that entry's row, the taxon of a lane equal to the query in
    every limb, else 0. A query that is negative (an invalid window's -1) or
    beyond the key space misses unsearched. int32 [Q]; the twin of the
    probe_tiled kernels."""
    router, rows, tile = table.router, table.table, table.tile
    out = torch.zeros(queries.shape[0], dtype=torch.int32, device=queries.device)
    step = max(1, TWIN_LANES // (2 * rows.shape[1] * rows.shape[2]))  # queries a gather
    for a in range(0, queries.shape[0], step):
        q = queries[a:a + step]
        inside, p = router_buckets(table, q)
        row = router[p].long() // tile
        both = torch.cat([rows[row], rows[row + 1]], 1)  # [q, 2 * tile, 3 | 5]
        eq = torch.stack([both[:, :, i] == limb[:, None] for i, limb in enumerate(_limbs(q))]).all(0)
        taxon = torch.where(eq, both[:, :, -1], 0).amax(1)
        out[a:a + step] = torch.where(inside, taxon, 0)
    return out


def router_sectors(table: TiledTable, queries: torch.Tensor) -> torch.Tensor:
    """Plain version of the tiled probe's floor (cuda_kernels.tiled_floor_cuda,
    a measurement on no path): for each query inside the key space,
    router[p] ^ router[p + 1] and, if its bucket is not empty, the xor of
    the 8 lanes of the aligned 32-byte sector that holds the first lane of
    the bucket's first record; else 0. int32 [Q]."""
    inside, p = router_buckets(table, queries)
    start, end = table.router[p], table.router[p + 1]
    filled = inside & (end > start)
    sector = _xor8(table.table.reshape(-1), torch.where(filled, start.long() * table.table.shape[2] // 8 * 8, 0))
    return torch.where(inside, start ^ end ^ torch.where(filled, sector, 0), 0)


def bucket_sectors(table: Bucketed, queries: torch.Tensor) -> torch.Tensor:
    """Plain version of the bucketed probe's floor (cuda_kernels.bucketed_floor_cuda,
    a measurement on no path): for each query inside the key space,
    router[p] ^ router[p + 1] and, if its bucket [s, e) is not empty, the
    xor of the uint32 lanes of the aligned 4-key sector that holds the key
    that the probe guesses, of those 16-byte halves of it that hold a key of
    the bucket; else 0. int32 [Q]."""
    inside, p = router_buckets(table, queries)
    start, end = table.router[p].long(), table.router[p + 1].long()
    filled = inside & (end > start)
    # the guess: the query's place in its bucket's range, the top 32 bits of
    # its low `shift` bits over 2^32, times the bucket's length
    shift = table.key_bits - table.bits
    low = torch.where(filled, queries, 0) & ((1 << shift) - 1)
    place = low << (32 - shift) if shift <= 32 else low >> (shift - 32)
    b = (start + ((place * (end - start)) >> 32)) // 4 * 4
    out = start ^ end
    for r in range(4):
        h = r // 2 * 2  # the sector's 16-byte half that holds key b + r
        held = filled & (b + h + 2 > start) & (b + h < end)
        key = table.keys[torch.where(held, b + r, 0)]
        out = out ^ torch.where(held, (key ^ (key >> 32)) & 0xFFFFFFFF, 0)
    return torch.where(inside, out, 0).to(torch.int32)


def slot_sectors(table: SlotTable, queries: torch.Tensor) -> torch.Tensor:
    """Plain version of the narrow slot probe's floor (cuda_kernels.slots_floor_cuda,
    a measurement on no path): bucket_sectors over the table's directory as
    the router and its slots, with the word past the last, as the keys.
    int32 [Q]."""
    d, slots = table.directory, table.slots
    b = d.buckets.bit_length() - 1
    padded = torch.cat([slots, slots.new_zeros(1)])  # build_slots' word past the last
    return bucket_sectors(Bucketed(d.starts, padded, None, 1, b, d.shift + b), queries)


def xorshift64(x: torch.Tensor) -> torch.Tensor:
    """The bijective xorshift64 mix (13, 7, 17) of int64 bit patterns, with a
    logical right shift."""
    x = x ^ (x << 13)
    x = x ^ ((x >> 7) & ((1 << 57) - 1))
    return x ^ (x << 17)


def wide_row_hash(keys: torch.Tensor) -> torch.Tensor:
    """The row hash of wide keys ([N, 2] int64): xorshift64(hi64 ^
    xorshift64(lo64)), which mixes lo64's entropy into the top bits."""
    return xorshift64(keys[:, 0] ^ xorshift64(keys[:, 1]))


def _top_bits(x: torch.Tensor, bits: int) -> torch.Tensor:
    """The top `bits` of int64 bit patterns, read unsigned."""
    return (x >> (64 - bits)) & ((1 << bits) - 1)


def build_hashed_rows(keys: torch.Tensor, taxa: torch.Tensor, tile: int = ROWS_TILE,
                      row_bits: Optional[int] = None) -> HashedRows:
    """The row-bucket table of the unique `keys` (int64 [N], or [N, 2] wide)
    with int32 `taxa`, in torch ops on their device: a stable sort by the
    row hash (the scrambled key, or `wide_row_hash`) read unsigned, the
    count of each row, and a scatter into [2^row_bits, lanes * tile] lanes.
    row_bits starts at ceil(log2(N / tile)) unless given; while the fullest
    row holds more than `tile` keys it grows, up to min(28, start + 8) (only
    when not given), then the tile doubles up to MAX_TILE, and past that the
    build raises ValueError. Equal, lane for lane, to the JAX package's
    build_hashed_rows(_wide) and its device builders."""
    n, wide = keys.shape[0], keys.dim() == 2
    dev = keys.device
    h = wide_row_hash(keys) if wide else xorshift64(keys)
    order_key, order = torch.sort(h ^ _SIGN, stable=True)  # ^ _SIGN: the unsigned order
    if wide:
        lanes = _limbs(keys[order])
    else:
        lanes = _limbs(order_key ^ _SIGN)  # the scrambled key is the row hash
    taxa = taxa[order].to(torch.int32)
    auto = row_bits is None
    if auto:
        row_bits = max(1, int(np.ceil(np.log2(max(n, 2) / tile))))
    max_bits = min(28, row_bits + 8)
    starts = None
    while n:
        edges = (torch.arange(1 << row_bits, dtype=torch.int64, device=dev) << (64 - row_bits)) ^ _SIGN
        starts = torch.searchsorted(order_key, edges)
        fullest = int(torch.diff(starts, append=starts.new_tensor([n])).max())
        if fullest <= tile:
            break
        if auto and row_bits < max_bits:
            row_bits += 1
        elif tile < MAX_TILE:
            tile *= 2
        else:
            raise ValueError(f"{'wide ' if wide else ''}hashed-rows layout did not converge (n={n}); "
                             "use the tiled or routed probe")
    width = (len(lanes) + 1) * tile
    table = torch.full((1 << row_bits, width), -1, dtype=torch.int32, device=dev)
    if n:
        rows = _top_bits(order_key ^ _SIGN, row_bits)
        at = rows * width + torch.arange(n, device=dev) - starts[rows]
        flat = table.view(-1)
        for i, lane in enumerate([*lanes, taxa]):
            flat[at + i * tile] = lane
    return HashedRows(table, tile, row_bits, n)


def lookup_taxa_hashed_rows(table: HashedRows, queries: torch.Tensor) -> torch.Tensor:
    """The row-bucket lookup as the JAX package writes it
    (lookup_taxa_hashed_rows, lookup_taxa_hashed_rows_wide): the query's row
    by its row hash, the taxon of a lane equal to the scrambled query (wide:
    the raw query) in every limb, else 0, and at least 0 (a free lane's -1).
    int32 [Q]; the twin of the probe_rows kernels."""
    rows, tile, row_bits = table.table, table.tile, table.row_bits
    wide = queries.dim() == 2
    out = torch.zeros(queries.shape[0], dtype=torch.int32, device=queries.device)
    step = max(1, TWIN_LANES // rows.shape[1])  # queries a gather
    for a in range(0, queries.shape[0], step):
        q = queries[a:a + step]
        h = wide_row_hash(q) if wide else xorshift64(q)
        r = rows[_top_bits(h, row_bits)]  # [q, lanes * tile]
        limbs = _limbs(q if wide else h)
        eq = torch.stack([r[:, i * tile:(i + 1) * tile] == limb[:, None] for i, limb in enumerate(limbs)]).all(0)
        out[a:a + step] = torch.where(eq, r[:, len(limbs) * tile:], 0).amax(1).clamp(min=0)
    return out


def row_mean(table: HashedRows) -> int:
    """The table's mean keys a row, n_keys / 2^row_bits, in 16.16 fixed
    point: the scale of `row_guess`. A build's keys fit its rows, so its
    mean is at most the tile; a larger n_keys sends the guesses to the
    tile's last lane (2^31 - 1 at most, so that row_guess's product of two
    32-bit values fits an int64)."""
    return min((table.n_keys << 16) >> table.row_bits, 0x7FFFFFFF)


def row_guess(scrambled: torch.Tensor, row_bits: int, mean: int, tile: int) -> torch.Tensor:
    """The lane where the narrow row probe's walk starts (probe_rows_kernel):
    the scramble's place in its row's range, the top 32 bits of (s <<
    row_bits) over 2^32, times the mean keys a row (16.16 fixed point), at
    most tile - 1. The keys of a row are spread evenly over its range, so
    the first lane not below the query lies near it. int64 [Q]."""
    f = ((scrambled << row_bits) >> 32) & 0xFFFFFFFF
    return ((f * mean) >> 48).clamp(max=tile - 1)


def guess_sectors(table: HashedRows, queries: torch.Tensor) -> torch.Tensor:
    """Plain version of the narrow row probe's floor (cuda_kernels.rows_floor_cuda,
    a measurement on no path): for each non-negative query, the xor of the 8
    hi' lanes from row_guess rounded down to a multiple of 8 in its row (a
    32-byte sector at tile 128; lanes past the tile are the row's first lo'
    lanes), else 0. int32 [Q]."""
    lanes, tile, row_bits = table.table.reshape(-1), table.tile, table.row_bits
    s = xorshift64(queries)
    g = row_guess(s, row_bits, row_mean(table), tile)
    first = torch.where(queries >= 0, _top_bits(s, row_bits) * 3 * tile + g // 8 * 8, 0)
    return torch.where(queries >= 0, _xor8(lanes, first), 0)


def _xor8(lanes: torch.Tensor, first: torch.Tensor) -> torch.Tensor:
    """The xor of lanes first .. first + 7 of the flat int32 `lanes`, a row a
    query: what the floor kernels fold a sector into."""
    words = lanes[first[:, None] + torch.arange(8, device=lanes.device)]
    out = words[:, 0]
    for i in range(1, 8):
        out = out ^ words[:, i]
    return out


# ---------------------------------------------------------------------------
# The displacement-bounded hashed tables and the bucketed arrays
# (`--probe hashed|hashed128|bucketed`, narrow keys only)
# ---------------------------------------------------------------------------

#: the least tile of the hashed table, and of its column-block layout
HASHED_TILE = 16
HASHED_COLS_TILE = 128


class HashedTable(NamedTuple):
    """A displacement-bounded hashed table (the JAX package's build_hashed
    and build_hashed_cols): the xorshift-scrambled keys, in scrambled order,
    each parked at the first free slot at or after its home slot (its
    scramble's top `bits`), at most tile - 1 slots on. A slot is (hi', lo',
    taxon) as uint32 lanes; a free slot is all ones (its taxon lane reads
    -1). `table` is [rows, tile, 3] (row-major slots, `--probe hashed`) or
    [rows, 3 * tile] (a row's hi', lo' and taxon blocks of `tile` lanes,
    `--probe hashed128`)."""

    table: torch.Tensor  # int32 [rows, tile, 3] | [rows, 3 * tile]
    tile: int
    bits: int

    @property
    def cols(self) -> bool:
        return self.table.dim() == 2

    @property
    def slots(self) -> int:
        return self.table.shape[0] * self.tile


class Bucketed(NamedTuple):
    """The arrays of `--probe bucketed` (the JAX package's device_bucketed):
    the router of `build_tiled` (entry p: the first key whose top `bits` of
    `key_bits` are >= p), and the sorted keys and taxa padded with `maxb`
    all-ones keys and taxa 0 (pad_keys_for_buckets), where `maxb` is the
    most keys under one prefix."""

    router: torch.Tensor  # int32 [2^bits + 1]
    keys: torch.Tensor  # int64 [N + maxb]
    taxa: torch.Tensor  # int32 [N + maxb]
    maxb: int
    bits: int
    key_bits: int

    @property
    def n(self) -> int:
        return self.keys.shape[0] - self.maxb


def _parked(keys: torch.Tensor, taxa: torch.Tensor, tile: int, bits: Optional[int], first_bits: int):
    """The parking of build_hashed and build_hashed_cols: (scrambled keys in
    unsigned order, their taxa, slot of each, tile, bits). Slot i of the
    sorted scrambles h_i (nondecreasing homes) is cummax(h - i) + i; bits
    start at `first_bits` unless given, and while some key lies tile or more
    slots past its home they grow (only when not given) up to min(30, start
    + 6), then the tile doubles up to MAX_TILE, and past that the build
    raises ValueError."""
    n = keys.shape[0]
    order_key, order = torch.sort(xorshift64(keys) ^ _SIGN)  # ^ _SIGN: the unsigned order
    scrambled, taxa = order_key ^ _SIGN, taxa[order].to(torch.int32)
    auto = bits is None
    if auto:
        bits = first_bits
    max_bits = min(30, bits + 6)
    ar = torch.arange(n, device=keys.device)
    pos = ar
    while n:
        h = _top_bits(scrambled, bits)
        pos = torch.cummax(h - ar, 0).values + ar
        if int((pos - h).max()) <= tile - 1:
            break
        if auto and bits < max_bits:
            bits += 1
        elif tile < MAX_TILE:
            tile *= 2
        else:
            raise ValueError(f"hashed layout did not converge (n={n}); use the tiled/routed probe")
    return scrambled, taxa, pos, tile, bits


def build_hashed(keys: torch.Tensor, taxa: torch.Tensor, tile: int = HASHED_TILE,
                 bits: Optional[int] = None) -> HashedTable:
    """The hashed table of `--probe hashed` for the unique narrow `keys`
    (int64 [N]) with int32 `taxa`, in torch ops on their device: bits start
    at max(12, ceil(log2 N) + 1) (`_parked`), max_pos // tile + 3 rows of
    [tile, 3] lanes, filled with all ones, each key's (hi', lo', taxon) at
    its slot. Equal, lane for lane, to the JAX package's build_hashed."""
    n = keys.shape[0]
    scrambled, taxa, pos, tile, bits = _parked(keys, taxa, tile, bits, max(12, int(np.ceil(np.log2(max(n, 2)))) + 1))
    n_rows = (int(pos[-1]) if n else 0) // tile + 3
    table = torch.full((n_rows * tile, 3), -1, dtype=torch.int32, device=keys.device)
    for i, lane in enumerate([*_limbs(scrambled), taxa]):
        table[pos, i] = lane
    return HashedTable(table.view(n_rows, tile, 3), tile, bits)


def build_hashed_cols(keys: torch.Tensor, taxa: torch.Tensor, tile: int = HASHED_COLS_TILE,
                      bits: Optional[int] = None) -> HashedTable:
    """The column-block hashed table of `--probe hashed128`: the parking of
    build_hashed with bits starting at max(12, ceil(log2 N)) (a load near
    one: the 127-slot displacement budget absorbs the clustering), in
    [rows, 3 * tile] lanes: slot s lies in row s // tile, its hi', lo' and
    taxon in lanes s % tile of the row's three blocks. Equal, lane for lane,
    to the JAX package's build_hashed_cols."""
    n = keys.shape[0]
    scrambled, taxa, pos, tile, bits = _parked(keys, taxa, tile, bits, max(12, int(np.ceil(np.log2(max(n, 2))))))
    n_rows = (int(pos[-1]) if n else 0) // tile + 3
    table = torch.full((n_rows, 3 * tile), -1, dtype=torch.int32, device=keys.device)
    at = (pos // tile) * (3 * tile) + pos % tile
    flat = table.view(-1)
    for i, lane in enumerate([*_limbs(scrambled), taxa]):
        flat[at + i * tile] = lane
    return HashedTable(table, tile, bits)


def _hashed_lanes(table: HashedTable, row: torch.Tensor):
    """(hi', lo', taxon) lanes [q, 2 * tile] of rows `row` and `row + 1`,
    each clamped onto the last row (all free), as the JAX gathers clamp."""
    rows, tile = table.table, table.tile
    last = rows.shape[0] - 1
    r0, r1 = rows[row.clamp(max=last)], rows[(row + 1).clamp(max=last)]
    if table.cols:
        return [torch.cat([r0[:, i * tile:(i + 1) * tile], r1[:, i * tile:(i + 1) * tile]], 1) for i in range(3)]
    return [torch.cat([r0[:, :, i], r1[:, :, i]], 1) for i in range(3)]


def lookup_taxa_hashed(table: HashedTable, queries: torch.Tensor) -> torch.Tensor:
    """The hashed lookup as the JAX package writes it (lookup_taxa_hashed):
    the home slot h of the scrambled query, the two aligned rows h // tile
    and h // tile + 1, the taxon of a slot equal to the scrambled query,
    else 0, and at least 0 (a free slot's -1). A negative query (an invalid
    window's -1) misses unsearched: no key is negative, so the JAX lookup's
    answer is 0 too (only a free slot can equal it, and its -1 does not
    beat 0). int32 [Q]; the twin of the probe_hashed kernel, and of
    probe_hashed_cols for a column-block table (`lookup_taxa_hashed_cols`)."""
    out = torch.zeros(queries.shape[0], dtype=torch.int32, device=queries.device)
    step = max(1, TWIN_LANES // (6 * table.tile))  # queries a gather
    for a in range(0, queries.shape[0], step):
        q = queries[a:a + step]
        s = xorshift64(q)
        hi, lo, tx = _hashed_lanes(table, _top_bits(s, table.bits) // table.tile)
        q_hi, q_lo = _limbs(s)
        taxon = torch.where((hi == q_hi[:, None]) & (lo == q_lo[:, None]), tx, 0).amax(1).clamp(min=0)
        out[a:a + step] = torch.where(q >= 0, taxon, 0)
    return out


def lookup_taxa_hashed_cols(table: HashedTable, queries: torch.Tensor) -> torch.Tensor:
    """lookup_taxa_hashed over a column-block table (the JAX package's
    lookup_taxa_hashed_cols: the same two aligned rows, [3 * tile] lanes
    each)."""
    if not table.cols:
        raise ValueError("a column-block table is [rows, 3 * tile]")
    return lookup_taxa_hashed(table, queries)


def home_sectors(table: HashedTable, queries: torch.Tensor) -> torch.Tensor:
    """Plain version of the hashed probes' floor (cuda_kernels.hashed_floor_cuda,
    a measurement on no path): for each non-negative query whose home slot h
    lies in the table, the xor of the 8 lanes of the aligned 32-byte sector
    that holds h's first lane (hi' in column blocks), else 0. int32 [Q]."""
    lanes, tile = table.table.reshape(-1), table.tile
    h = _top_bits(xorshift64(queries), table.bits)
    inside = (queries >= 0) & (h < table.slots)
    h = torch.where(inside, h, 0)
    first = (h // tile * 3 * tile + h % tile // 8 * 8) if table.cols else 3 * h // 8 * 8
    return torch.where(inside, _xor8(lanes, first), 0)


def build_bucketed(keys: torch.Tensor, taxa: torch.Tensor, key_bits: int) -> Bucketed:
    """The arrays of `--probe bucketed` for the sorted, unique narrow `keys`
    (int64 [N]) with int32 `taxa`, in torch ops on their device: the router
    at min(adaptive_router_bits(N), key_bits) bits (the JAX index's
    device_router), maxb = max_bucket_span(router), and the keys and taxa
    padded as pad_keys_for_buckets pads them."""
    n = keys.shape[0]
    bits = min(adaptive_router_bits(n), key_bits)
    router = build_router(keys, bits, key_bits)
    maxb = max_bucket_span(router)
    padded_keys = torch.cat([keys, keys.new_full((maxb,), -1)])
    padded_taxa = torch.cat([taxa.to(torch.int32), taxa.new_zeros(maxb, dtype=torch.int32)])
    return Bucketed(router, padded_keys, padded_taxa, maxb, bits, key_bits)


def lookup_taxa_bucketed(table: Bucketed, queries: torch.Tensor) -> torch.Tensor:
    """The direct-bucket lookup as the JAX package writes it
    (lookup_taxa_bucketed): the router entry of the query's prefix, the
    `maxb` padded keys and taxa from there, the taxon of a key equal to the
    query, else 0. A negative query (an invalid window's -1) misses
    unsearched: the JAX lookup gives it 0 too (only the all-ones padding, of
    taxon 0, can equal it). int32 [Q]; the twin of the probe_bucketed
    kernel."""
    router, keys, taxa, maxb, bits, key_bits = table
    out = torch.zeros(queries.shape[0], dtype=torch.int32, device=queries.device)
    span = torch.arange(maxb, device=queries.device)
    step = max(1, TWIN_LANES // maxb)
    for a in range(0, queries.shape[0], step):
        q = queries[a:a + step]
        p = q >> (key_bits - bits)
        inside = (q >= 0) & (p < 1 << bits)
        at = router[torch.where(inside, p, 0)].long()[:, None] + span  # [q, maxb]
        taxon = torch.where(keys[at] == q[:, None], taxa[at], 0).amax(1)
        out[a:a + step] = torch.where(inside, taxon, 0)
    return out
