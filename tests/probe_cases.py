"""Wide indexes and queries for the slot table's tests, shared by its
twin's (test_torch_probe_slots.py) and its kernel's (test_torch_gpu.py);
key sets for the tiled and row-bucket tables' tests
(test_torch_probe_tables.py, test_torch_probe_rows.py and
test_torch_gpu.py), for the hashed tables' (test_torch_probe_hashed.py
and test_torch_gpu.py) and for the bucketed arrays'
(test_torch_probe_bucketed.py and test_torch_gpu.py)."""

import numpy as np
import torch

from slacken_tpu_torch.ops import lookup

TOP = (1 << 31) - 1  # the widest taxon

#: (label, m, n, taxa, keys a bucket, the field mode, whether b rises)
NAMED = [
    ("m = 45, wide taxa: shift <= 96 holds any taxon", 45, 3000, "wide", lookup.BUCKET_KEYS, "direct", False),
    ("m = 32, one bucket: shift 64, 32 bits of field", 32, 3000, "distinct", 1 << 30, "direct", False),
    ("m = 63, small taxa in the 12 bits left", 63, 3000, "small", lookup.BUCKET_KEYS, "direct", False),
    ("m = 63, wide taxa: codes", 63, 3000, "wide", lookup.BUCKET_KEYS, "code", False),
    ("m = 63, distinct taxa: codes", 63, 3000, "distinct", lookup.BUCKET_KEYS, "code", False),
    ("m = 56, distinct taxa in one bucket: 16 bits hold 3,000 codes", 56, 3000, "distinct", 1 << 30, "code", False),
    ("m = 63, distinct taxa in one bucket: b rises", 63, 3000, "distinct", 1 << 30, "code", True),
    ("m = 63, small taxa in one bucket: b rises", 63, 129, "small", 1 << 30, "code", True),
    ("m = 49, one key a bucket: shift 90", 49, 129, "wide", 1, "direct", False),
    ("m = 56, one key a bucket, wide taxa: codes", 56, 129, "wide", 1, "code", False),
]


def wide_keys(rng, m, n):
    """n sorted unique keys below 4^m as uint64 [n, 2] rows (hi64, lo64);
    a long run of equal hi64, and lo64 that differ only in the top bit."""
    hi_bits = 2 * m - 64
    hi = rng.integers(0, 1 << hi_bits, 2 * n + 4, dtype=np.uint64) if hi_bits else np.zeros(2 * n + 4, np.uint64)
    hi[: n // 2] = hi[0]
    lo = rng.integers(0, 1 << 64, 2 * n + 4, dtype=np.uint64)
    lo[:4] = [0, 1, 1 << 63, (1 << 64) - 1]
    rows = np.unique(np.stack([hi, lo], 1), axis=0)  # sorted by (hi64, lo64), unsigned
    return rows[np.sort(rng.permutation(len(rows))[:n])]


def taxa_of(rng, kind, n):
    """small: below 1,000; wide: some 2^31 - 1, which forces codes at m = 63;
    distinct: n different taxa up to 2^31 - 1, the most codes."""
    if kind == "small":
        return rng.integers(1, 1000, n).astype(np.int32)
    if kind == "wide":
        taxa = rng.integers(1, 1000, n).astype(np.int32)
        taxa[rng.random(n) < 0.3] = TOP
        return taxa
    return rng.permutation(np.unique(rng.integers(1, TOP, 2 * n + 8))[:n]).astype(np.int32)


def add128(rows, hi, lo, sign):
    """rows + sign * (hi, lo) as 128-bit values, wrapped: uint64 [n, 2]."""
    r_lo = rows[:, 1] + np.uint64(lo) if sign > 0 else rows[:, 1] - np.uint64(lo)
    carry = ((r_lo < rows[:, 1]) if sign > 0 else (r_lo > rows[:, 1])).astype(np.uint64)
    r_hi = rows[:, 0] + np.uint64(hi) + carry if sign > 0 else rows[:, 0] - np.uint64(hi) - carry
    return np.stack([r_hi, r_lo], 1)


def neighbours(keys, shift):
    """Each key's remainder in the next and in the previous bucket: key +-
    2^shift. The slot before a bucket, which the kernel loads for alignment,
    holds the remainder of the previous bucket's last key."""
    d = (1 << (shift - 64), 0) if shift >= 64 else (0, 1 << shift)
    return np.concatenate([add128(keys, *d, 1), add128(keys, *d, -1)])


def queries_of(rng, keys, m):
    """uint64 [Q, 2] queries that do not depend on the directory: every key,
    +-1 in either limb, with lo64's top bit flipped, other keys below 4^m,
    the edges of the key space, random rows and invalid windows' -1."""
    top = (1 << (2 * m - 64)) - 1
    return np.concatenate([
        keys, add128(keys, 0, 1, 1), add128(keys, 0, 1, -1), add128(keys, 1, 0, 1), add128(keys, 1, 0, -1),
        keys ^ np.array([[0, 1 << 63]], np.uint64), wide_keys(rng, m, 300),
        np.array([[0, 0], [0, (1 << 64) - 1], [top, (1 << 64) - 1]], np.uint64),
        rng.integers(0, 1 << 64, (300, 2), dtype=np.uint64),
        np.full((3, 2), (1 << 64) - 1, np.uint64),
    ])


def mode(table):
    return "direct" if table.codes is None else "code"


#: narrow key sets of the one-limb slot table's tests: 62-bit keys, one
#: prefix, two prefixes far apart, dense small keys (shift 0 at one key a
#: bucket) and 63-bit keys (shift 63 with one bucket; codes need a rise)
NARROW_SLOT_KINDS = ("uniform", "one prefix", "two prefixes", "dense", "63-bit")


def narrow_slot_keys(rng, kind, n):
    """n sorted unique non-negative int64 keys of `kind` (fewer where the
    kind has fewer)."""
    if kind == "uniform":
        raw = rng.integers(0, 1 << 62, 2 * n + 1, dtype=np.int64)
    elif kind == "one prefix":
        raw = (1 << 61) + rng.integers(0, 1 << 20, 2 * n + 1, dtype=np.int64)
    elif kind == "two prefixes":
        raw = np.concatenate([rng.integers(0, 1 << 12, n // 2 + 1, dtype=np.int64),
                              (1 << 62) - 1 - rng.integers(0, 1 << 12, n, dtype=np.int64)])
    elif kind == "dense":
        raw = np.arange(n, dtype=np.int64)
    else:
        raw = np.concatenate([rng.integers(0, (1 << 63) - 1, 2 * n, dtype=np.int64), [(1 << 63) - 1]])
    keys = np.unique(raw)
    return keys[np.sort(rng.permutation(len(keys))[:n])]


def narrow_slot_queries(rng, keys, shift):
    """int64 queries around narrow `keys`: every key, +-1, each key's
    remainder in the neighbouring buckets (key +- 2^shift), the edges of the
    key space, random ones, and invalid windows' -1."""
    k, u, d = keys.astype(np.int64), keys.astype(np.uint64), np.uint64(1) << np.uint64(shift)
    near = np.concatenate([k, k + 1, k - 1, (u + d).view(np.int64), (u - d).view(np.int64)])  # wrapped
    return np.concatenate([
        near, [-1, -1, -(1 << 63), 0, 1, 1 << 62, (1 << 62) - 1, (1 << 63) - 1],
        rng.integers(0, 1 << 62, 300, dtype=np.int64), rng.integers(-(1 << 63), (1 << 63) - 1, 300, dtype=np.int64),
    ]).astype(np.int64)


def decode_slots(table):
    """(keys, taxa) of a narrow slot table, int64 [N] and int32 [N]: each
    slot's bucket p from the directory, its remainder r = slot >> c read
    unsigned, the key (p << shift) | r, the taxon its field or the field's
    code."""
    slots, c, codes, (starts, shift) = table
    n = slots.shape[0]
    pos = torch.arange(n, dtype=torch.int64)
    p = torch.searchsorted(starts.long(), pos, right=True) - 1
    r = (slots >> c) & ((1 << (64 - c)) - 1)
    field = slots & ((1 << c) - 1)
    taxa = field if codes is None else codes.long()[field]
    return (p << shift) | r, taxa.to(torch.int32)


MASK64 = (1 << 64) - 1


def _xorshift(x: int) -> int:
    x ^= (x << 13) & MASK64
    x ^= x >> 7
    return x ^ ((x << 17) & MASK64)


def _inverse_xorshift(x: int) -> int:
    """The 64-bit value whose _xorshift is x: each step undone in turn."""
    for shift, left in ((17, True), (7, False), (13, True)):
        y = x
        for _ in range(64 // shift + 1):
            y = x ^ (((y << shift) & MASK64) if left else (y >> shift))
        x = y
    return x


def _skewed(rng):
    """1,000 narrow keys, 40 of them under one 12-bit router prefix."""
    spread = rng.integers(0, 1 << 62, 960, dtype=np.int64)
    crowd = (np.int64(1234) << np.int64(50)) + rng.integers(0, 1 << 20, 40, dtype=np.int64)
    return np.unique(np.concatenate([spread, crowd]))


def _tied(rng):
    """Wide (m = 45) keys in pairs whose row hashes are equal: beside a key
    (hi, lo), the key (hi ^ d, lo') with xorshift64(lo') = xorshift64(lo) ^ d."""
    rows = []
    for _ in range(150):
        hi, lo, d = int(rng.integers(0, 1 << 26)), int(rng.integers(0, 1 << 62)), int(rng.integers(1, 1 << 26))
        rows += [(hi, lo), (hi ^ d, _inverse_xorshift(_xorshift(lo) ^ d))]
    return np.unique(np.array(rows, dtype=np.uint64), axis=0)


#: the key sets of `table_keys`
TABLE_KINDS = ("narrow", "wide", "rank table", "skewed", "empty", "wide, tied row hashes")


def table_keys(rng, kind):
    """(sorted unique uint64 keys [N] or [N, 2], int32 taxa, key_bits) of
    one kind of `TABLE_KINDS`: random 62-bit keys, random (50, 45) keys,
    random 26-bit ranks (m = 13), `_skewed`, none, `_tied`."""
    keys, key_bits = {
        "narrow": lambda: (np.unique(rng.integers(0, 1 << 62, 3000)).astype(np.uint64), 62),
        "wide": lambda: (wide_keys(rng, 45, 3000), 90),
        "rank table": lambda: (np.unique(rng.integers(0, 1 << 26, 3000)).astype(np.uint64), 26),
        "skewed": lambda: (_skewed(rng).astype(np.uint64), 62),
        "empty": lambda: (np.zeros(0, np.uint64), 62),
        "wide, tied row hashes": lambda: (_tied(rng), 90),
    }[kind]()
    return keys, rng.integers(1, 1 << 20, len(keys)).astype(np.int32), key_bits


#: the key whose scramble is all ones (above 2^62: no index of m <= 31 holds it)
ALL_ONES_KEY = _inverse_xorshift(MASK64)

#: the key sets of `hashed_keys`
HASHED_KINDS = ("random", "rank table", "full run", "all-ones scramble", "low half", "empty")


def _with_scrambles(scrambles):
    return np.array([_inverse_xorshift(int(s)) for s in scrambles], np.uint64)


def _low_half(rng, n):
    """n non-negative keys whose scrambles have their top bit clear: the
    table ends near the middle of the hash space."""
    keys = _with_scrambles(rng.integers(0, 1 << 63, 2 * n + 8, dtype=np.uint64))
    return keys[keys < np.uint64(1 << 63)][:n]


def hashed_keys(rng, kind, tile):
    """(sorted unique uint64 keys, int32 taxa) of one kind of `HASHED_KINDS`
    for a hashed table of `tile` (16 or 128): random 62-bit keys; 26-bit
    ranks (m = 13, clustered scrambles: the tile grows); a run of `tile`
    keys of one home slot high in the hash space (the last parked tile - 1
    slots on, the table's last occupied slot) above 300 `_low_half` keys;
    six keys whose scrambles are the six largest, the all-ones one
    (ALL_ONES_KEY, parked last) among them, above 300 `_low_half` keys;
    3,000 `_low_half` keys (queries whose home slot lies beyond the table);
    none."""
    if kind == "random":
        keys = np.unique(rng.integers(0, 1 << 62, 3000)).astype(np.uint64)
    elif kind == "rank table":
        keys = np.unique(rng.integers(0, 1 << 26, 3000)).astype(np.uint64)
    elif kind == "full run":
        home = (3 << 62) | (int(rng.integers(0, 1 << 20)) << 40)  # one home for bits <= 24
        run = _with_scrambles(home | rng.integers(0, 1 << 40, 4 * tile + 16, dtype=np.uint64))
        keys = np.concatenate([run[run < np.uint64(1 << 63)][:tile], _low_half(rng, 300)])
    elif kind == "all-ones scramble":
        keys = np.concatenate([_with_scrambles(MASK64 - np.arange(6, dtype=np.uint64)), _low_half(rng, 300)])
    elif kind == "low half":
        keys = _low_half(rng, 3000)
    else:
        keys = np.zeros(0, np.uint64)
    keys = np.unique(keys[keys < np.uint64(1 << 63)])  # index keys are non-negative int64
    return keys, rng.integers(1, 1 << 20, len(keys)).astype(np.int32)


def hashed_queries(rng, keys):
    """int64 queries of a hashed table's tests: every key, keys beside it,
    ALL_ONES_KEY, random values of any sign, the edges and -1."""
    k = keys.view(np.int64)
    return np.concatenate([k, k + 1, k - 1, [ALL_ONES_KEY, ALL_ONES_KEY - 1, -1, -5, 0, (1 << 63) - 1],
                           rng.integers(0, 1 << 62, 1000), rng.integers(-(1 << 63), (1 << 63) - 1, 1000)])


def query_runs(rng, queries, n):
    """About n queries drawn from `queries` (int64 [Q], or [Q, 2] wide) in
    runs of equal queries 1 to 9 long, as a dense batch repeats a super-mer's
    minimizer, with an invalid window's -1 (all ones in every limb) between
    about a third of the runs."""
    invalid = np.full((1, *queries.shape[1:]), -1, np.int64)
    parts = []
    while sum(len(p) for p in parts) < n:
        parts.append(np.repeat(queries[int(rng.integers(0, len(queries)))][None], int(rng.integers(1, 10)), 0))
        if rng.random() < 0.3:
            parts.append(invalid)
    return np.concatenate(parts)


def stream_slices(n):
    """(start, stop) of the slices of an n-query stream that the probes are
    held on: the whole, from an odd start (8 bytes past a 16-byte boundary
    for int64 queries), and 0, 1, 3, 5 and 4k + 3 queries from either."""
    k3 = 4 * ((n - 2) // 4 - 1) + 3
    return [(0, n), (1, n), *((a, a + m) for a in (0, 1) for m in (0, 1, 3, 5, k3))]


#: forced (tile, row_bits) of the row-bucket tables whose rows are full:
#: tiles that are not a multiple of a 32-lane step, and grown tiles
FULL_ROW_TILES = ((12, 2), (36, 2), (512, 1), (1024, 1))


def full_row_keys(rng, tile, row_bits):
    """(sorted unique uint64 wide (m = 45) keys [N, 2], int32 taxa) for
    build_hashed_rows(tile=tile, row_bits=row_bits): `tile` keys in every
    even row, so their scans meet no free lane, and 0 to tile - 1 in each
    odd row."""
    keys = wide_keys(rng, 45, 4 * tile << row_bits)
    rows = lookup._top_bits(lookup.wide_row_hash(torch.from_numpy(keys.view(np.int64))), row_bits).numpy()
    keep = np.zeros(len(keys), bool)
    for r in range(1 << row_bits):
        at = np.flatnonzero(rows == r)
        keep[at[:tile if r % 2 == 0 else int(rng.integers(0, tile))]] = True
    assert all((rows[keep] == r).sum() == tile for r in range(0, 1 << row_bits, 2))
    return keys[keep], rng.integers(1, 1 << 20, int(keep.sum())).astype(np.int32)


#: the forced bits of the hashed128 walk cases: 4,096 home slots, 32 rows of
#: the default tile (128)
COLS_BITS = 12
#: the hand-made hashed128 tables of `cols_walk_case`
COLS_WALK_KINDS = ("block end", "row crossing", "free before home", "equal hi' runs", "all-ones scramble",
                   "all-ones scramble, no key", "table end")


def _at_home(rng, n, home, hi=None):
    """n distinct scrambles whose top COLS_BITS bits are `home` (and, given
    `hi`, whose top 32 bits are `hi`), each the scramble of a non-negative
    int64 key."""
    out = set()
    while len(out) < n:
        s = (hi << 32) | int(rng.integers(0, 1 << 32)) if hi is not None else \
            (home << (64 - COLS_BITS)) | int(rng.integers(0, 1 << (64 - COLS_BITS), dtype=np.uint64))
        if _inverse_xorshift(s) < 1 << 63:
            out.add(s)
    return sorted(out)


def _homes(rng, homes):
    """A scramble of a non-negative key (or not) with each home of `homes`."""
    return [(h << (64 - COLS_BITS)) | int(rng.integers(0, 1 << (64 - COLS_BITS), dtype=np.uint64)) for h in homes]


def cols_walk_case(rng, kind):
    """(sorted unique uint64 keys, int32 taxa, int64 queries) of a hashed128
    table built with bits COLS_BITS that stresses its kernel's walk over
    8-slot blocks of hi', above 300 `_low_half` keys (homes below 2,048):
    "block end", runs of 2 to 4 keys from homes in the last lanes of a block,
    their last keys a block on; "row crossing", 6 keys of home 128 * 20 + 125,
    parked across rows 20 and 21; "free before home", lone keys at lanes 3
    to 7 of blocks with every lane before them free; "equal hi' runs", 12
    keys of one hi' and different lo' from lane 3 of a block (across it) and
    3 of another hi' behind a key of a smaller hi' of their home; "all-ones
    scramble", the six largest scrambles (home 4,095, parked across the
    block and the row at slot 4,096), ALL_ONES_KEY among them, and "..., no
    key" without it; "table end", queries whose homes lie in the table's
    last two (free) rows, its last block and past it. The queries: every
    key, hashed_queries', each designed scramble plus and minus one in lo'
    and in hi', the scrambles between a run's lo', and homes near each
    designed home."""
    low = _low_half(rng, 300)
    design, near = [], []
    if kind == "block end":
        for j, (lane, n) in enumerate([(6, 3), (7, 2), (7, 4), (5, 4)]):
            h = 2048 + 64 * j + 8 * j + lane
            design += _at_home(rng, n, h)
            near += [h - 1, h + 1, h + 2, h + n]
    elif kind == "row crossing":
        h = 128 * 20 + 125
        design = _at_home(rng, 6, h)
        near = [h - 1, h + 3, 128 * 21, 128 * 21 + 1]
    elif kind == "free before home":
        for j, lane in enumerate(range(3, 8)):
            h = 2048 + 24 * j + lane
            design += _at_home(rng, 1, h)
            near += [h - lane, h - 1, h + 1]
    elif kind == "equal hi' runs":
        hi_a = (2500 << 20) + 3 * (1 << 17)  # home 2,500: lane 4 of its block
        hi_b = (2603 << 20) + 5
        design = _at_home(rng, 12, 2500, hi=hi_a) + _at_home(rng, 1, 2603, hi=hi_b - 1) + _at_home(rng, 3, 2603, hi=hi_b)
        runs = [s for s in design if s >> 32 != hi_b - 1]
        near = [2499, 2500, 2501, 2602, 2603]
        design_queries = [(a + b) // 2 for a, b in zip(runs, runs[1:]) if b - a > 1]
        design_queries += [(hi_a << 32), (hi_a << 32) | 0xFFFFFFFF, (hi_b << 32), (hi_b << 32) | 0xFFFFFFFF]
    elif kind.startswith("all-ones scramble"):
        design = [s for s in range(MASK64 - 5, MASK64 + (kind == "all-ones scramble")) if _inverse_xorshift(s) < 1 << 63]
        near = [4094, 4095]
    if kind != "equal hi' runs":
        design_queries = []
    keys = np.unique(np.concatenate([low, np.array([_inverse_xorshift(s) for s in design], np.uint64)]))
    taxa = rng.integers(1, 1 << 20, len(keys)).astype(np.int32)
    table = lookup.build_hashed_cols(torch.from_numpy(keys.view(np.int64)), torch.from_numpy(taxa), bits=COLS_BITS)
    if kind == "table end":
        slots = table.slots
        near = [*range(slots - 2 * table.tile, slots, 5), slots - 8, slots - 1, slots, slots + 9]
    scrambles = design_queries + [MASK64]
    for s in design:
        scrambles += [s, s ^ 1, (s + 1) & MASK64, (s - 1) & MASK64, (s + (1 << 32)) & MASK64, (s - (1 << 32)) & MASK64]
    scrambles += _homes(rng, [h for h in near if 0 <= h < 1 << COLS_BITS for _ in range(4)])
    q = np.array([_inverse_xorshift(s) for s in scrambles], np.uint64).view(np.int64)
    return keys, taxa, np.concatenate([hashed_queries(rng, keys), q])


def cols_walk(table, queries):
    """probe_hashed_cols_kernel (kernels/probe_tables.cu) query by query in
    numpy: the 8-lane blocks of hi' from the block that holds the home slot,
    lanes outside [home, min(home + tile, slots)) masked; the lanes not below
    the query in hi', in order: the first above it ends the walk (absent),
    one equal to it reads its lo' and taxon and answers if lo' is not below
    the query's, else passes to the next; a block with none, to the next
    block. int32 [Q]."""
    lanes = table.table.numpy().reshape(-1).view(np.uint32)
    tile, bits, slots = table.tile, table.bits, table.slots
    out = np.zeros(len(queries), np.int32)
    for qi, x in enumerate(queries):
        if x < 0:
            continue
        s = _xorshift(int(x))
        sh, sl = s >> 32, s & 0xFFFFFFFF
        home = s >> (64 - bits)
        end = min(home + tile, slots)
        b, done = home & ~7, False
        while b < end and not done:
            at = b // tile * 3 * tile + b % tile
            for i in range(8):
                if not home <= b + i < end or lanes[at + i] < sh:
                    continue
                done = True
                if lanes[at + i] > sh or lanes[at + tile + i] > sl:
                    break
                if lanes[at + tile + i] == sl:
                    out[qi] = max(int(lanes[at + 2 * tile + i].view(np.int32)), 0)
                    break
                done = False
            b += 8
    return out


#: the hand-made narrow row-bucket tables of `rows_walk_case`: (tile,
#: row_bits, keys a row (None: random), runs of equal hi' as (row, lanes
#: before the run, its length)); rows 5 (full) and 6 (empty) at tile 128
ROWS_WALK_CASES = {
    "tile 128": (128, 4, {5: 128, 6: 0, 7: 1, 9: 70, 10: 20}, ((9, 5, 6), (10, 0, 3))),
    "all-ones scramble": (128, 4, {}, ()),
    "all-ones scramble, no key": (128, 4, {}, ()),
    "tile 12": (12, 3, {0: 12, 1: 0, 2: 12, 3: 5, 4: 1}, ((2, 6, 4), (3, 0, 2))),
    "tile 36": (36, 3, {0: 36, 1: 0, 3: 30, 5: 20}, ((3, 13, 6), (5, 0, 8))),
    "tile 256": (256, 2, {0: 256, 1: 0, 2: 200}, ((2, 61, 7),)),
}


def _scrambles_in(rng, n, lo, hi):
    """n distinct scrambles in [lo, hi), each the scramble of a non-negative
    int64 key, sorted."""
    out = set()
    while len(out) < n:
        s = int(rng.integers(lo, hi, dtype=np.uint64))
        if _inverse_xorshift(s) < 1 << 63:
            out.add(s)
    return sorted(out)


def rows_walk_case(rng, kind):
    """(sorted unique uint64 keys, int32 taxa, int64 queries, tile,
    row_bits) of a narrow row-bucket table, built with that tile and
    row_bits, that stresses the probe_rows walk (ROWS_WALK_CASES): full rows
    (no free lane), empty rows, rows of one key, runs of equal hi' with
    different lo' (one across a sector, one from lane 0) in the middle of
    their row's range, tiles of 12 and 36 (not a multiple of 8) and 256; the
    other rows hold 0 to 3/4 of the tile. "all-ones scramble": the six
    largest scrambles of non-negative keys in the last row, ALL_ONES_KEY
    among them, and "..., no key" without it. The queries: hashed_queries',
    each scramble plus and minus one in lo' and in hi', the scrambles between
    a run's lo', its hi' with lo' 0 and all ones, and each row's range ends."""
    tile, row_bits, counts, runs = ROWS_WALK_CASES[kind]
    span = 1 << (64 - row_bits)
    runs = {r: (before, n) for r, before, n in runs}
    design, queries = [], [MASK64]
    for r in range(1 << row_bits):
        lo, hi = r * span, (r + 1) * span
        queries += [lo, lo + 1, hi - 1, hi - 2]
        n = counts.get(r, int(rng.integers(0, 3 * tile // 4)))
        if r in runs:
            before, length = runs[r]
            h = (lo + span // 2) >> 32  # the run's hi'
            run = _scrambles_in(rng, length, h << 32, (h + 1) << 32)
            design += _scrambles_in(rng, before, lo, h << 32) + run
            design += _scrambles_in(rng, n - before - length, (h + 1) << 32, hi)
            queries += [(a + b) // 2 for a, b in zip(run, run[1:]) if b - a > 1] + [h << 32, (h << 32) | 0xFFFFFFFF]
        else:
            design += _scrambles_in(rng, n, lo, hi)
    if kind.startswith("all-ones scramble"):
        top = MASK64 + (kind == "all-ones scramble")
        design = [s for s in design if s < MASK64 - 5] + [s for s in range(MASK64 - 5, top)
                                                         if _inverse_xorshift(s) < 1 << 63]
    for s in design:
        queries += [s, s ^ 1, (s + 1) & MASK64, (s - 1) & MASK64, (s + (1 << 32)) & MASK64, (s - (1 << 32)) & MASK64]
    keys = np.unique(np.array([_inverse_xorshift(s) for s in design], np.uint64))
    taxa = rng.integers(1, 1 << 20, len(keys)).astype(np.int32)
    q = np.array([_inverse_xorshift(s) for s in queries], np.uint64).view(np.int64)
    return keys, taxa, np.concatenate([hashed_queries(rng, keys), q]), tile, row_bits


def rows_walk(table, queries, guess=None):
    """probe_rows_kernel (kernels/probe_tables.cu) query by query in numpy:
    a negative query answers 0 unread; else the 8-lane sectors of its row's
    hi' from the one that holds the first lane (`guess`: an int or int64
    [Q] in [0, tile), by default lookup.row_guess), lanes past the tile
    masked; a sector whose first lane is not below the query passes the
    walk to the left unless every lane before it is known below, one whose
    lanes are all below it to the right, until the first lane not below the
    query is found or the row ends; that lane, if equal in hi', and each
    equal one behind it read lo' and taxon: equal answers max(taxon, 0),
    above 0, below the next. int32 [Q]."""
    lanes = table.table.numpy().reshape(-1).view(np.uint32)
    tile, row_bits = table.tile, table.row_bits
    if guess is None:
        s = lookup.xorshift64(torch.from_numpy(np.asarray(queries, np.int64)))
        guess = lookup.row_guess(s, row_bits, lookup.row_mean(table), tile).numpy()
    guess = np.broadcast_to(np.asarray(guess), len(queries))
    out = np.zeros(len(queries), np.int32)
    for qi, x in enumerate(queries):
        if x < 0:
            continue
        s = _xorshift(int(x))
        sh, sl = s >> 32, s & 0xFFFFFFFF
        hi = (s >> (64 - row_bits)) * 3 * tile
        below_to, first, b = 0, tile, int(guess[qi]) & ~7
        while True:
            n = min(tile - b, 8)
            below = int((lanes[hi + b:hi + b + n] < sh).sum())
            if below < n:
                first = b + below
                if below or b == below_to:
                    break
                b -= 8
            else:
                below_to = b + n
                if below_to == first:
                    break
                b += 8
        for i in range(first, tile):
            if lanes[hi + i] != sh or lanes[hi + tile + i] > sl:
                break
            if lanes[hi + tile + i] == sl:
                out[qi] = max(int(lanes[hi + 2 * tile + i].view(np.int32)), 0)
                break
    return out


#: the hand-made tiled tables of `tiled_walk_case`: (key_bits, wide)
TILED_WALK_KINDS = {"62-bit keys": (62, False), "26-bit ranks": (26, False), "wide keys, l3 0": (90, True)}
#: bucket sizes of `tiled_walk_case`, in router order from prefix 1: empty
#: buckets among them, 1 to 9 records, and 17 (the tile + 1 at tile 16),
#: so that buckets start at records 4j, 4j + 1, 4j + 2 and 4j + 3
TILED_BUCKETS = (3, 0, 4, 5, 1, 8, 9, 0, 17, 2, 1, 1, 6, 7, 0, 3, 9, 4, 17, 5, 1, 0, 8, 2)


def tiled_walk_case(rng, kind):
    """(sorted unique uint64 keys [N] or [N, 2], int32 taxa, key_bits,
    int64 queries [Q] or [Q, 2]) of a tiled table with a 12-bit router
    (`TILED_WALK_KINDS`: 62-bit keys, 26-bit ranks, or wide (m = 45) keys,
    whose l3 is 0 throughout): one key in bucket 0 (the first record), the
    buckets of TILED_BUCKETS from prefix 1, then 1 to 5 keys in every 37th
    prefix, and 4 keys in the top prefix, the last of them the largest key
    of the space (the last bucket ends at N). The largest bucket is 17, so
    build_tiled's tile is 16. The queries: every key and each key plus and
    minus one, the first and last value of every designed bucket's range,
    random values inside the space and of any sign (wide: random rows), and
    -1 (wide: an all-ones row)."""
    key_bits, wide = TILED_WALK_KINDS[kind]
    shift = key_bits - 12
    sizes = {0: 1, **{1 + i: n for i, n in enumerate(TILED_BUCKETS)}, 4095: 4}
    for p in range(40, 4095, 37):
        sizes[p] = int(rng.integers(1, 6))
    keys = []
    for p, n in sizes.items():
        low = rng.choice(1 << min(shift, 40), n, replace=False).astype(object) << max(shift - 40, 0)
        keys += [(p << shift) | int(x) for x in low]
    keys[-1] = (1 << key_bits) - 1
    keys = sorted(set(keys))
    edges = [e for p in sizes for e in ((p << shift), ((p + 1) << shift) - 1)]
    top = (1 << key_bits) - 1
    values = keys + [min(k + 1, top) for k in keys] + [max(k - 1, 0) for k in keys] + edges
    values += [int(x) for x in rng.integers(0, 1 << min(key_bits, 62), 500)]
    taxa = rng.integers(1, 1 << 20, len(keys)).astype(np.int32)
    if wide:
        as_rows = lambda v: np.array([(x >> 64, x & MASK64) for x in v], np.uint64)  # noqa: E731
        q = np.concatenate([as_rows(values), rng.integers(0, 1 << 64, (300, 2), dtype=np.uint64),
                            np.full((2, 2), MASK64, np.uint64)])
        return as_rows(keys), taxa, key_bits, q.view(np.int64)
    q = np.concatenate([np.array(values, np.uint64).view(np.int64),
                        rng.integers(-(1 << 63), (1 << 63) - 1, 500, dtype=np.int64), [-1]])
    return np.array(keys, np.uint64), taxa, key_bits, q


def _as_int(row):
    """A key or query as a non-negative Python int: uint64, or (hi64, lo64)."""
    row = np.asarray(row).view(np.uint64)
    return int(row) if row.ndim == 0 else (int(row[0]) << 64) | int(row[1])


def tiled_guess(query, shift, length):
    """The offset into its bucket of `length` records where the tiled
    probe's walk starts (probe_tiled_kernel): the query's place in its
    bucket's range, the top 32 bits of its low `shift` bits over 2^32, times
    the length, rounded down."""
    low = query & ((1 << shift) - 1)
    place = low << (32 - shift) if shift <= 32 else low >> (shift - 32)
    return place * length >> 32


#: records a step of probe_tiled_kernel
TILED_STEP = 2


def tiled_walk(table, queries, start=None):
    """probe_tiled_kernel (kernels/probe_tables.cu) query by query in numpy:
    a query beyond the key space, or whose router bucket [s, e) is empty,
    answers 0 unread; else the walk reads TILED_STEP records a step from
    record s + start (`start`: an int or int64 [Q] offset into the bucket,
    at most e - s - 1; by default the kernel's, `tiled_guess`) rounded down
    to a multiple of TILED_STEP,
    comparing the records of the step that lie in the bucket (those past it
    count as above the query, those before it as below); the first record
    not below the query answers its taxon if equal, else the walk ends on a
    miss, unless it is the step's first record and the bucket holds earlier
    records not known below (a start past the query): then the walk steps
    left; a step whose records are all below the query passes to the right,
    until the bucket ends. int32 [Q]."""
    lanes = table.table.numpy().view(np.uint32)
    n_lanes = lanes.shape[2]
    lanes = lanes.reshape(-1, n_lanes)
    router = table.router.numpy()
    inside, p = (x.numpy() for x in lookup.router_buckets(table, torch.from_numpy(queries)))
    offset = None if start is None else np.broadcast_to(np.asarray(start), len(queries))
    shift = table.key_bits - table.bits
    out = np.zeros(len(queries), np.int32)
    limbs = lanes[:, :-1].astype(np.uint64)
    words = (limbs[:, 0::2] << np.uint64(32)) | limbs[:, 1::2]  # [rows, 1 | 2]: the key as uint64 words
    key = [_as_int(w if len(w) == 2 else w[0]) for w in words].__getitem__
    for qi in np.flatnonzero(inside):
        s, e = int(router[p[qi]]), int(router[p[qi] + 1])
        if s >= e:
            continue
        q = _as_int(queries[qi])
        b = (s + (tiled_guess(q, shift, e - s) if offset is None else min(int(offset[qi]), e - s - 1))) & -TILED_STEP
        right = left = False
        while True:
            r0, r1 = max(s - b, 0), min(e - b, TILED_STEP)
            ge = [r >= r1 or (r >= r0 and key(b + r) >= q) for r in range(TILED_STEP)]
            if any(ge):
                j = ge.index(True)
                if j < r1 and key(b + j) == q:
                    out[qi] = lanes[b + j, -1].view(np.int32)
                    break
                if j > 0 or b <= s or right:
                    break
                b, left = b - TILED_STEP, True
            else:
                if left or b + TILED_STEP >= e:
                    break
                b, right = b + TILED_STEP, True
    return out


#: the hand-made bucketed arrays of `bucketed_walk_case`
BUCKETED_WALK_KINDS = ("62-bit keys", "26-bit ranks", "one key a bucket")


def bucketed_walk_case(rng, kind):
    """(sorted unique uint64 keys [N], int32 taxa, key_bits, int64 queries
    [Q]) of bucketed arrays with a 12-bit router (`BUCKETED_WALK_KINDS`):
    tiled_walk_case's narrow key sets (buckets of 0 to 9 keys and of 17,
    the largest, so maxb 17; buckets starting at every key modulo 4, the
    first at key 0, the last ending at the last key, which is the largest
    of the key space, right before the padding), or one key in each of
    about 1,000 prefixes from prefix 0 to the top one (maxb 1: a single
    padding key after the last). The queries: tiled_walk_case's (every key,
    key + 1 and - 1, both edges of every designed bucket's prefix, random
    values inside the space and of any sign, -1), then 0, 2^key_bits and
    values above it."""
    if kind == "one key a bucket":
        key_bits, shift = 62, 50
        prefixes = np.unique(np.concatenate([[0, 4095], rng.choice(4096, 1000, replace=False)])).astype(np.uint64)
        keys = (prefixes << np.uint64(shift)) | rng.integers(0, 1 << shift, len(prefixes), dtype=np.uint64)
        keys[-1] = np.uint64((1 << key_bits) - 1)
        edges = np.concatenate([prefixes << np.uint64(shift), ((prefixes + np.uint64(1)) << np.uint64(shift)) - 1])
        q = np.concatenate([keys, keys + np.uint64(1), keys - np.uint64(1), edges,
                            rng.integers(0, 1 << key_bits, 500, dtype=np.uint64)]).view(np.int64)
        q = np.concatenate([q, rng.integers(-(1 << 63), (1 << 63) - 1, 500, dtype=np.int64), [-1]])
        taxa = rng.integers(1, 1 << 20, len(keys)).astype(np.int32)
    else:
        keys, taxa, key_bits, q = tiled_walk_case(rng, kind)
    beyond = np.array([0, 1 << key_bits, (1 << key_bits) + 1, 1 << 62, (1 << 63) - 1], np.int64)
    return keys, taxa, key_bits, np.concatenate([q, beyond])


#: keys a step of probe_bucketed_kernel: an aligned 32-byte sector
BUCKETED_STEP = 4


def bucketed_walk(table, queries, start=None, step=BUCKETED_STEP):
    """probe_bucketed_kernel (kernels/probe_tables.cu) query by query in
    numpy: a negative query, one beyond the key space, or one whose router
    bucket [s, e) is empty answers 0 unread; else the walk reads `step`
    keys a step (two a 16-byte load, only the loads that hold a key of the
    bucket; each asserted to lie in the padded arrays) from key s + start
    (`start`: an int or int64 [Q] offset into the bucket, at most e - s -
    1; by default the kernel's guess, `tiled_guess`) rounded down to a
    multiple of `step`. Keys past the bucket count as not below the query,
    keys before it as below; the first key not below the query answers
    max(taxon, 0) if equal, else a miss, unless it is the step's first key
    and the bucket holds earlier keys not known below (a step left); a step
    whose keys are all below passes to the right, until the bucket ends.
    int32 [Q]."""
    keys, taxa, router = table.keys.numpy(), table.taxa.numpy(), table.router.numpy()
    inside, p = (x.numpy() for x in lookup.router_buckets(table, torch.from_numpy(queries)))
    offset = None if start is None else np.broadcast_to(np.asarray(start), len(queries))
    shift = table.key_bits - table.bits
    out = np.zeros(len(queries), np.int32)
    for qi in np.flatnonzero(inside):
        s, e = int(router[p[qi]]), int(router[p[qi] + 1])
        if s >= e:
            continue
        q = int(queries[qi])
        b = (s + (tiled_guess(q, shift, e - s) if offset is None else min(int(offset[qi]), e - s - 1))) // step * step
        right = left = False
        while True:
            r0, r1 = max(s - b, 0), min(e - b, step)
            k = [0] * step
            for h in range(0, step, 2):
                if b + h + 2 > s and b + h < e:
                    assert 0 <= b + h and b + h + 1 < len(keys), (b, h, len(keys))
                    k[h], k[h + 1] = (int(x) & MASK64 for x in keys[b + h:b + h + 2])
            ge = [r >= r1 or (r >= r0 and k[r] >= q) for r in range(step)]
            if any(ge):
                j = ge.index(True)
                if j < r1 and k[j] == q:
                    out[qi] = max(int(taxa[b + j]), 0)
                    break
                if j > 0 or b <= s or right:
                    break
                b, left = b - step, True
            else:
                if left or b + step >= e:
                    break
                b, right = b + step, True
    return out
