// Exact-match probes of the JAX package's other probe tables, which
// `--probe tiled`, `hashed1`, `hashed`, `hashed128` and `bucketed` choose:
// the tiled table (a prefix router over the records in key order), the
// row-bucket table (a row a hash of the key), the displacement-bounded
// hashed table (a key parked near the slot that its hash names), the last
// in two layouts, and the bucketed arrays (a prefix router over the sorted
// keys and, apart, their taxa). Each kernel returns the taxon of the key
// equal to the query, or 0; the tables come from lookup.build_tiled,
// lookup.build_hashed_rows, lookup.build_hashed, lookup.build_hashed_cols
// and lookup.build_bucketed, lane for lane the JAX builders' layouts.
//
// Replaces XLA code of the JAX package, not a Pallas kernel:
//   probe_tiled       lookup_taxa_tiled            slacken_tpu/ops/lookup.py:333
//   probe_tiled_wide  lookup_taxa_tiled_wide       slacken_tpu/ops/lookup.py:212
//   probe_rows        lookup_taxa_hashed_rows      slacken_tpu/ops/lookup.py:740
//   probe_rows_wide   lookup_taxa_hashed_rows_wide slacken_tpu/ops/lookup.py:891
//   probe_hashed      lookup_taxa_hashed           slacken_tpu/ops/lookup.py:478
//   probe_hashed_cols lookup_taxa_hashed_cols      slacken_tpu/ops/lookup.py:566
//   probe_bucketed    lookup_taxa_bucketed         slacken_tpu/ops/lookup.py:269
// Their twins are lookup.lookup_taxa_tiled, lookup.lookup_taxa_hashed_rows,
// lookup.lookup_taxa_hashed(_cols) and lookup.lookup_taxa_bucketed.
//
// Design. The JAX lookups gather whole rows per query ([Q, 2 * tile, 3|5]
// and [Q, 3|5 * tile] lanes) because a TPU gathers at a rate of rows, not of
// bytes; on the H100 that spends bytes (6.4 GB for one 4 Mbp batch of narrow
// queries against a hashed1 table of tile 128), so each kernel reads only
// what can hold the answer, one thread a query (four for the wide rows):
//   * tiled: the router entries p and p + 1 (one sector; an empty bucket
//     reads nothing more), then the records of bucket [router[p], router[p
//     + 1]) in key order, two a step (narrow 3 uint2, wide 5), the loads of
//     a step that hold a lane of a record of the bucket issued before any
//     compare. The walk starts at the step that holds the record the
//     query's place in its bucket's range guesses (keys spread evenly over
//     a bucket's range); the first record of the step not below the query
//     ends it: its taxon, read in the same loads, if it equals the query,
//     else a miss; unless it is the step's first record and the bucket
//     holds earlier ones (the guess passed the query: a step left), or the
//     step's records are all below the query (a step right, until the
//     bucket ends). Records past the bucket count as above the query (later
//     buckets, or the all-ones padding) and records before it as below
//     (earlier buckets), so neither needs its loads. The JAX lookup's two
//     rows cover the bucket (tile_for_span), and a key of another bucket
//     never equals the query, so the answer is the same. The walk it
//     replaces waited on each record's compare before loading the next:
//     4-5 dependent trips at scale (7.8 records a bucket, up to 129). At
//     bench size a bucket holds 0.31 records on average and the router
//     decides. On an H100 (PERF.md) the walk from the bucket's first record,
//     8 records a step, every load of a step read, a bucket of one record
//     read in a branch of its own, and 4 records a step (3 or 5 uint4; the
//     wide instance at 40 registers, or forced to 32 with a spill) were
//     slower; one compare a record for "below", with the lanes of the first
//     record not below selected after it, costs fewer instructions than an
//     "equal" compare a record as well.
//   * bucketed: the tiled probe's walk over 8-byte keys, their taxa apart.
//     One thread a query reads the router entries p and p + 1 (an empty
//     bucket, 73% of them at bench size, answers 0 with no key read), then
//     the aligned 32-byte sector of keys that holds the key the query's
//     place in its bucket's range guesses, 4 keys as two 16-byte loads, only
//     those that hold a key of the bucket, issued together; a sector left
//     or right until one holds the first key not below the query, as the
//     tiled walk steps; an equal key reads its taxon (a third dependent
//     trip, 4 bytes). Keys past the bucket count as not below the query
//     (later buckets, or the maxb all-ones padding keys, which are -1 as
//     int64 and so never compared), keys before it as below; no load leaves
//     the bucket, so none leaves the padded arrays. The JAX lookup compares
//     the query with the maxb keys from router[p], which cover the bucket,
//     and a key of another bucket never equals it: the same answer,
//     max(taxon, 0) as its reduction gives. It replaces the directory
//     kernel of probe.cu run over the router, which read no bucket end: a
//     key sector to learn that a bucket is empty, a walk from the bucket's
//     first key 4 keys a step (1-3 dependent trips at 7.8 keys a bucket).
//     On an H100 (PERF.md) 2 keys a step (one 16-byte load), the guessed
//     sector's taxa read with its keys (a hit in two trips, at the cost of a
//     taxa sector for every query in a non-empty bucket) and the walk from
//     the bucket's first key were slower; the kernel is 1.4-1.6x its floor,
//     the difference being a hit's taxon sector, which the JAX layout keeps
//     apart from the keys.
//   * slots (`--probe routed`, narrow keys, on the card): the bucketed walk
//     over the index's slot table, 8 bytes a record, each the key's
//     remainder below its bucket's prefix above a c-bit field that holds
//     the taxon or its code (lookup.build_slots), under the prefix directory
//     of about 4 keys a bucket (BUCKET_KEYS), which takes the router's place.
//     One thread a query reads the directory entries p and p + 1 (an empty
//     bucket answers 0 with no slot read), then the aligned 32-byte sector
//     of 4 slots that holds the slot the query's place in its bucket's range
//     guesses, a sector left or right as the bucketed walk steps, comparing
//     Q = (query mod 2^shift) << c unsigned (a slot's top bit may be set).
//     The first slot not below Q is a hit if its bits above the field equal
//     Q's; its taxon is the field, from the same load, or the field's code
//     (a table of the index's distinct taxa, small enough to stay in the
//     L2). A hit costs two dependent trips (directory, one sector) where the
//     directory kernel of probe.cu walked the keys from the bucket's start
//     and then read the taxon apart, and the card holds 8 bytes a record,
//     not 12, and no second copy of the keys. The slot table is allocated
//     with a word past its last slot, which a 16-byte load of the last
//     sector may read (the bucketed arrays have their padding keys there).
//   * rows, narrow: the row of the scrambled query s holds its keys sorted
//     by scrambled value, the free all-ones lanes last, and their scrambles
//     are spread evenly over the row's range, so the first lane not below
//     the query lies near g = f * c, f = (s << row_bits) / 2^64 its place in
//     the range and c the table's mean keys a row (row_guess; 80 at bench
//     size, 62.6 at scale). One thread a query reads the 8 hi' lanes that
//     hold g (a 32-byte sector at tile 128, two 16-byte loads; lanes past
//     the tile masked), then steps a sector left while a sector's first lane
//     is not below the query and lanes before it are not known below, or
//     right while all its lanes are below, until a sector holds the first
//     lane not below the query or the row ends (lane 0, lane tile). That
//     lane, if equal in hi', reads its lo' and taxon together (one trip):
//     lo' equal answers max(taxon, 0), above 0, below passes to the next
//     lane of the run of equal hi'. A miss costs about 1.6 dependent
//     sectors, where a bisection of the 512-byte hi' block paid 7-8 loads;
//     the guess only moves the start, never the answer. On an H100 (PERF.md)
//     16 lanes in the first trip lost up to 16%, a second sector only near
//     a sector's edge up to 25%, and the guessed sector's lo' and taxa read
//     with its hi' (a hit in one trip, 46 registers) 1.3-1.6x; stepping by
//     the sector's spread of hi' took more steps in a model of the walk. The
//     taxon is max(taxon, 0), as the JAX lookup's reduction:
//     a query that equals the all-ones free lanes finds their -1; a real
//     key of the all-ones scramble sorts before them. A negative query (an
//     invalid window's -1) is answered 0 unread: its scramble equals no
//     key's.
//   * rows, wide: the row holds raw limbs in the order of the row hash, so
//     there is no order to bisect: its keys fill lanes 0..n-1 and the free
//     all-ones lanes follow (l3 of a key is below 2^30). A group of GROUP =
//     4 threads takes a query; each step the group reads 16 lanes of l3 and
//     the same 16 of l2 (64 bytes of each, 16 bytes of each a thread, both
//     loads issued together), reads l1, l0 and the taxon of a lane equal in
//     l3 and l2 together (one trip), and a vote over the group ends the
//     walk at a step that holds a free lane or the key. l2 is read with l3
//     because l3 does not tell keys apart below m = 48 (at (50, 45, 7) it
//     is 0 in every key), so reading l2 lane by lane behind each equal l3
//     would cost a dependent load a lane. A miss among about 71 occupied lanes (load 0.56, tile 128)
//     takes 5 dependent steps, not 18, and 4 threads a query at 32
//     registers keep 512 queries a SM in flight. The answer is max(taxon,
//     0) of the lane equal in all four limbs; a query whose l3 is all ones
//     (an invalid window) equals only free lanes and is answered 0 unread.
//   * hashed (both layouts): the JAX lookup compares the scrambled query
//     with the 2 * tile slots of the aligned rows h // tile and h // tile +
//     1, h the home slot (the scramble's top bits); the kernel walks the
//     slots from h forward instead and stops at the first whose scrambled
//     key is not below the query's (unsigned), after tile slots, or at the
//     table's end. Two facts of the parking placement (slot i of the i-th
//     smallest scramble is cummax(h - i) + i) make that the JAX answer:
//     occupied slots hold ascending scrambles, and a key parked at pos
//     with home h has every slot of [h, pos) occupied. So the query's key,
//     if present, lies at pos <= h + tile - 1 (the build's bound), every
//     slot before it from h holds a smaller key, and the walk reaches it;
//     these slots are among those the JAX rows cover. A free slot is all
//     ones in all three lanes, so no query is above its key and the walk
//     ends there. The hard case is a query whose scramble is all ones: it
//     equals a free slot's key, and a real key of that scramble (parked
//     last) equals it too. The taxon lane tells them apart: max(taxon, 0),
//     as the JAX reduction, is 0 for the free slot's -1 and the taxon for
//     the real key. The row-major slots (hashed, load 0.31-0.49): one
//     thread a query reads the three lanes of a slot together, so a key at
//     its home slot costs one round trip, not a second one for the taxon
//     behind the compare. Reading slots h and h + 1 before any compare (24
//     bytes; 5 pairs in 8 straddle a sector), or several queries a thread,
//     was slower on an H100 (PERF.md). Repeats of a super-mer's minimizer
//     are neighbouring threads with one query, whose loads fall in one
//     sector.
//   * hashed128 (column blocks, load 0.49-0.63): the hi' of neighbouring
//     slots are neighbouring lanes, so one thread a query walks 8-slot
//     blocks of hi', one 32-byte sector (two 16-byte loads) a step, from
//     the block that holds h. Lanes before h (free, or smaller scrambles)
//     and at or past min(h + tile, slots) are masked. The unmasked lanes
//     whose hi' is not below the query's decide in order: the first above it
//     means the key is absent; one equal to it reads its lo' and taxon
//     together (one trip, two sectors) and answers max(taxon, 0) if lo'
//     equals, 0 if above, and passes to the next such lane if below (a run
//     of equal hi' is rare); a block with none passes the walk on to the
//     next (the lanes of slot j lie at (j / tile) * 3 * tile + j % tile:
//     tile is a multiple of 8, so a block never straddles two rows, and
//     crossing a row moves 3 * tile lanes). That is the first slot of [h,
//     end) whose key is not below the query, as the slot-by-slot walk finds
//     it. A miss costs one sector (two when its walk crosses a block), a hit
//     three in two trips, where the slot-by-slot walk paid a hi' and a lo'
//     sector a slot and a third for the taxon. On random queries the kernel
//     is bound by the rate of scattered sectors, as the floor shows: reading
//     the home slot's lo' and taxon with the first block (a hit at h in one
//     trip) cost 1.7x at scale, and reading the block's 8 lo' and 8 taxon
//     lanes behind an equal hi' (48 registers) 1.5x on the bench batch
//     (PERF.md).
// `hashed_floor_kernel`, `rows_floor_kernel`, `tiled_floor_kernel` and
// `bucketed_floor_kernel` are on no path: a measurement of what the hashed
// probes, the narrow row probe, the tiled probes and the bucketed probe
// cannot beat, each query's one aligned 32-byte sector at its home slot (of
// the hi' block, or of the row-major slots), of its row's hi' lanes at its
// guessed lane, or after its router entries of its bucket's first record or
// (bucketed) of the keys at its guessed key, read and folded into one int.
// An invalid window's -1 (narrow) has a prefix beyond every router bucket
// and misses without a load; its scramble matches no key, and the hashed,
// row and bucketed probes skip every negative query (no key is negative).
// Wide, its l3 is all ones: the tiled probe finds it beyond the buckets, the
// row probe answers it 0 without a load.
//
// Bound: as for the directory probe, the rate at which scattered 32-byte
// sectors come from the L2 or device memory, not the bytes streamed.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr unsigned FREE = 0xFFFFFFFFu;  // a free lane of a row-bucket table

__device__ __forceinline__ unsigned long long xorshift64(unsigned long long x) {
  x ^= x << 13;
  x ^= x >> 7;
  x ^= x << 17;
  return x;
}

__device__ __forceinline__ unsigned long long join(unsigned hi, unsigned lo) {
  return ((unsigned long long)hi << 32) | lo;
}

// the eight lanes of a 32-byte sector, 16-byte aligned
__device__ __forceinline__ void sector8(const unsigned* p, unsigned (&v)[8]) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(p)), b = __ldg(reinterpret_cast<const uint4*>(p) + 1);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// The router bucket p of query qi of a tiled table whose router cuts the
// key space at `shift`, and the query as (hi, lo) (narrow: hi 0); false for
// a query beyond the key space (an invalid window's -1: narrow, its prefix
// lies beyond every bucket; wide, its all-ones l3 lies above the space).
template <bool WIDE>
__device__ __forceinline__ bool tiled_bucket(const long long* __restrict__ queries, long long qi, int shift,
                                             unsigned long long buckets, unsigned long long& hi,
                                             unsigned long long& lo, unsigned long long& p) {
  unsigned long long above = 0;
  hi = 0;
  if (WIDE) {
    const ulonglong2 x = __ldcs(reinterpret_cast<const ulonglong2*>(queries) + qi);
    hi = x.x;
    lo = x.y;
    if (shift >= 64) {
      p = hi >> (shift - 64);
    } else if (shift == 0) {
      p = lo;
      above = hi;
    } else {
      p = (hi << (64 - shift)) | (lo >> shift);
      above = hi >> shift;
    }
  } else {
    lo = (unsigned long long)__ldcs(queries + qi);
    p = lo >> shift;  // logical: a negative query's prefix lies beyond every bucket
  }
  return above == 0 && p < buckets;
}

// The top 32 bits of the low `shift` bits of the key (hi, lo): the query's
// place inside its router bucket's range, over 2^32.
__device__ __forceinline__ unsigned bucket_place(unsigned long long hi, unsigned long long lo, int shift) {
  if (shift <= 32) return (unsigned)(lo << (32 - shift));
  const int s = shift - 32;
  return (unsigned)(s < 64 ? (lo >> s) | (hi << (64 - s)) : hi >> (s - 64));
}

// records a step of the tiled probe
constexpr int TILED_STEP = 2;

// Records of a tiled table: LANES = LIMBS + 1 uint32 lanes each (the key's
// limbs, most significant first, then the taxon), sorted by key, 8-byte
// aligned. A step is records b and b + 1, b even: LANES uint2.
template <bool WIDE>
__global__ void __launch_bounds__(THREADS)
probe_tiled_kernel(const int* __restrict__ router, unsigned long long buckets, int shift,
                   const unsigned* __restrict__ records, const long long* __restrict__ queries, long long nq,
                   int* __restrict__ out) {
  constexpr int LANES = WIDE ? 5 : 3;
  const long long qi = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (qi >= nq) return;
  unsigned long long hi, lo, p;
  int taxon = 0;
  if (tiled_bucket<WIDE>(queries, qi, shift, buckets, hi, lo, p)) {
    const int start = __ldg(router + p), end = __ldg(router + p + 1);
    // the step of the record that the query's place in the bucket's range guesses
    const int guess = (int)(((unsigned long long)bucket_place(hi, lo, shift) * (unsigned)(end - start)) >> 32);
    int b = (start + guess) & -TILED_STEP;
    // an empty bucket reads no record; `right`: every record before b is
    // below the query; `left`: the record at b + TILED_STEP is not
    for (bool right = false, left = false; start < end;) {
      // records [r0, r1) of the step lie in the bucket: the loads that hold
      // none of their lanes are not issued, and records past the bucket
      // count as not below the query (they are: later buckets, or the
      // all-ones padding), records before it as below (earlier buckets)
      const int r0 = max(start - b, 0), r1 = min(end - b, TILED_STEP);
      const uint2* at = reinterpret_cast<const uint2*>(records + (long long)b * LANES);
      unsigned w[TILED_STEP * LANES];
#pragma unroll
      for (int i = 0; i < LANES; ++i) {
        const uint2 x = 2 * i + 2 > LANES * r0 && 2 * i < LANES * r1 ? __ldg(at + i) : make_uint2(0, 0);
        w[2 * i] = x.x, w[2 * i + 1] = x.y;
      }
      unsigned below = 0;
#pragma unroll
      for (int r = 0; r < TILED_STEP; ++r) {
        const unsigned* k = w + LANES * r;
        const unsigned long long k_hi = WIDE ? join(k[0], k[1]) : 0, k_lo = join(k[LANES - 3], k[LANES - 2]);
        below |= (unsigned)(k_hi < hi || (k_hi == hi && k_lo < lo)) << r;
      }
      const int j = __ffs((~below & (~0u << r0)) | (~0u << r1)) - 1;  // the first record not below the query
      if (j < TILED_STEP) {
        if (j < r1) {  // in the bucket: its lanes decide
          unsigned k[LANES];
#pragma unroll
          for (int i = 0; i < LANES; ++i) k[i] = j ? w[LANES + i] : w[i];
          if ((WIDE ? join(k[0], k[1]) : 0) == hi && join(k[LANES - 3], k[LANES - 2]) == lo) {
            taxon = (int)k[LANES - 1];
            break;
          }
        }
        // a miss, unless the guess passed the query: the step's first
        // record is above it and the bucket holds earlier ones
        if (j > 0 || b <= start || right) break;
        b -= TILED_STEP;
        left = true;
      } else {
        if (left || b + TILED_STEP >= end) break;  // every record of the bucket is below the query
        b += TILED_STEP;
        right = true;
      }
    }
  }
  __stcs(out + qi, taxon);
}

// On no path: each query inside the key space reads its router entries p
// and p + 1 and, if the bucket is not empty, the aligned 32-byte sector
// that holds the first lane of its first record, folded into one int, so
// that the loads cannot be dropped.
template <bool WIDE>
__global__ void __launch_bounds__(THREADS)
tiled_floor_kernel(const int* __restrict__ router, unsigned long long buckets, int shift,
                   const unsigned* __restrict__ records, const long long* __restrict__ queries, long long nq,
                   int* __restrict__ out) {
  constexpr int LANES = WIDE ? 5 : 3;
  const long long qi = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (qi >= nq) return;
  unsigned long long hi, lo, p;
  unsigned v = 0;
  if (tiled_bucket<WIDE>(queries, qi, shift, buckets, hi, lo, p)) {
    const int start = __ldg(router + p), end = __ldg(router + p + 1);
    v = (unsigned)(start ^ end);
    if (start < end) {
      unsigned w[8];
      sector8(records + ((long long)start * LANES & ~7ll), w);
#pragma unroll
      for (int i = 0; i < 8; ++i) v ^= w[i];
    }
  }
  __stcs(out + qi, (int)v);
}

// keys a step of the bucketed probe, and of its floor: an aligned 32-byte
// sector
constexpr int BUCKETED_STEP = 4;

// The bucket [start, end) of a non-negative query x inside the key space
// of a bucketed router that cuts it at `shift` (its entries p and p + 1,
// usually one sector), and the key of the bucket that x's place in the
// bucket's range guesses, as the tiled probe guesses a record; false for
// any other query.
__device__ __forceinline__ bool bucketed_bucket(const int* __restrict__ router, unsigned long long buckets, int shift,
                                                const long long* __restrict__ queries, long long qi,
                                                unsigned long long& x, int& start, int& end, int& guess) {
  unsigned long long hi, p;
  if (!tiled_bucket<false>(queries, qi, shift, buckets, hi, x, p) || (long long)x < 0) return false;
  start = __ldg(router + p);
  end = __ldg(router + p + 1);
  guess = start + (int)(((unsigned long long)bucket_place(0, x, shift) * (unsigned)(end - start)) >> 32);
  return true;
}

// Keys [b, b + N) of the sorted keys (b a multiple of N), two a 16-byte
// load, only the loads that hold a key of [start, end) issued, before any
// compare; the others read as 0.
template <int N>
__device__ __forceinline__ void bucket_keys(const long long* __restrict__ keys, int b, int start, int end,
                                            unsigned long long (&k)[N]) {
#pragma unroll
  for (int h = 0; h < N; h += 2) {
    const bool held = b + h + 2 > start && b + h < end;
    const longlong2 x = held ? __ldg(reinterpret_cast<const longlong2*>(keys + b + h)) : make_longlong2(0, 0);
    k[h] = (unsigned long long)x.x, k[h + 1] = (unsigned long long)x.y;
  }
}

// The walk of a bucket [start, end) of sorted 8-byte words from word b,
// the guess (see the header): the answer to x. SLOTS false: the bucketed
// table's keys, x the query, the taxon of an equal key read from `taxa`.
// SLOTS true: a narrow slot table's slots (r << c) | f, x = Q the query's
// remainder << c, a hit the first slot not below Q whose bits above the
// field equal Q's, its taxon the field f or, given `taxa` (the codes),
// taxa[f], from the same load. Words compare unsigned either way.
template <bool SLOTS>
__device__ __forceinline__ int bucket_walk(const long long* __restrict__ keys, const int* __restrict__ taxa,
                                           int start, int end, int b, unsigned long long x,
                                           unsigned long long field) {
  b &= -BUCKETED_STEP;
  // an empty bucket reads no key; `right`: every key before b is below the
  // query; `left`: the key at b + BUCKETED_STEP is not
  for (bool right = false, left = false; start < end;) {
    // keys [r0, r1) of the step lie in the bucket; those past it count as
    // not below the query, those before it as below
    const int r0 = max(start - b, 0), r1 = min(end - b, BUCKETED_STEP);
    unsigned long long k[BUCKETED_STEP];
    bucket_keys(keys, b, start, end, k);
    unsigned below = 0, equal = 0;
#pragma unroll
    for (int r = 0; r < BUCKETED_STEP; ++r) {
      below |= (unsigned)(k[r] < x) << r;
      equal |= (unsigned)(SLOTS ? (k[r] ^ x) <= field : k[r] == x) << r;
    }
    const int j = __ffs((~below & (~0u << r0)) | (~0u << r1)) - 1;  // the first key not below the query
    if (j < BUCKETED_STEP) {
      if (j < r1 && (equal >> j & 1)) {  // in the bucket, and equal
        if (!SLOTS) return max(__ldg(taxa + b + j), 0);
        unsigned long long s = k[0];
#pragma unroll
        for (int r = 1; r < BUCKETED_STEP; ++r) s = j == r ? k[r] : s;  // selects: no local memory
        const int f = (int)(s & field);
        return taxa ? __ldg(taxa + f) : f;
      }
      // a miss, unless the guess passed the query: the step's first key
      // is above it and the bucket holds earlier ones
      if (j > 0 || b <= start || right) return 0;
      b -= BUCKETED_STEP;
      left = true;
    } else {
      if (left || b + BUCKETED_STEP >= end) return 0;  // every key of the bucket is below the query
      b += BUCKETED_STEP;
      right = true;
    }
  }
  return 0;
}

// The sorted keys and their taxa of a bucketed table, apart, and its
// router (see the header)
__global__ void __launch_bounds__(THREADS)
probe_bucketed_kernel(const int* __restrict__ router, unsigned long long buckets, int shift,
                      const long long* __restrict__ keys, const int* __restrict__ taxa,
                      const long long* __restrict__ queries, long long nq, int* __restrict__ out) {
  const long long qi = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (qi >= nq) return;
  unsigned long long x;
  int start, end, b, taxon = 0;
  if (bucketed_bucket(router, buckets, shift, queries, qi, x, start, end, b))
    taxon = bucket_walk<false>(keys, taxa, start, end, b, x, 0);
  __stcs(out + qi, taxon);
}

// A narrow index's slot table under its prefix directory (see the header)
__global__ void __launch_bounds__(THREADS)
probe_slots_kernel(const int* __restrict__ starts, unsigned long long buckets, int shift, int c,
                   const long long* __restrict__ slots, const int* __restrict__ codes,
                   const long long* __restrict__ queries, long long nq, int* __restrict__ out) {
  const long long qi = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (qi >= nq) return;
  unsigned long long x;
  int start, end, b, taxon = 0;
  if (bucketed_bucket(starts, buckets, shift, queries, qi, x, start, end, b))
    taxon = bucket_walk<true>(slots, codes, start, end, b, (x & ((1ull << shift) - 1)) << c, (1ull << c) - 1);
  __stcs(out + qi, taxon);
}

// On no path: each non-negative query inside the key space reads its
// router entries p and p + 1 and, if the bucket is not empty, the aligned
// 32-byte sector of keys that holds its guessed key (the 16-byte halves
// that hold a key of the bucket, as the probe's first step), folded into
// one int, so that the loads cannot be dropped.
__global__ void __launch_bounds__(THREADS)
bucketed_floor_kernel(const int* __restrict__ router, unsigned long long buckets, int shift,
                      const long long* __restrict__ keys, const long long* __restrict__ queries, long long nq,
                      int* __restrict__ out) {
  const long long qi = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (qi >= nq) return;
  unsigned long long x;
  int start, end, guess;
  unsigned v = 0;
  if (bucketed_bucket(router, buckets, shift, queries, qi, x, start, end, guess)) {
    v = (unsigned)(start ^ end);
    if (start < end) {
      unsigned long long k[BUCKETED_STEP];
      bucket_keys(keys, guess & -BUCKETED_STEP, start, end, k);
#pragma unroll
      for (int r = 0; r < BUCKETED_STEP; ++r) v ^= (unsigned)k[r] ^ (unsigned)(k[r] >> 32);
    }
  }
  __stcs(out + qi, (int)v);
}

// The lane where the narrow row walk starts (lookup.row_guess): the
// scramble's place in its row's range, the top 32 bits of s << row_bits over
// 2^32, times the table's mean keys a row (16.16 fixed point), at most
// tile - 1.
__device__ __forceinline__ int row_guess(unsigned long long s, int row_bits, unsigned mean, int tile) {
  const unsigned long long f = (s << row_bits) >> 32;
  return (int)min((f * mean) >> 48, (unsigned long long)(tile - 1));
}

// a narrow row-bucket table: [2^row_bits, 3 * tile] lanes, a row's hi', lo'
// and taxon blocks; 8 lanes of hi' a step from the guessed one (see the header)
__global__ void __launch_bounds__(THREADS)
probe_rows_kernel(const unsigned* __restrict__ table, int tile, int row_bits, unsigned mean,
                  const long long* __restrict__ queries, long long nq, int* __restrict__ out) {
  const long long qi = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (qi >= nq) return;
  const long long x = __ldcs(queries + qi);
  int taxon = 0;
  if (x >= 0) {  // no key is negative: an invalid window's -1 misses unsearched
    const unsigned long long s = xorshift64((unsigned long long)x);
    const unsigned sh = (unsigned)(s >> 32), sl = (unsigned)s;
    const unsigned* hi = table + (long long)(s >> (64 - row_bits)) * 3 * tile;
    // every lane before `below_to` is below sh; lane `first` is not (tile:
    // none is), its hi' `at_first`; the row is sorted, its free lanes last
    int below_to = 0, first = tile, b = row_guess(s, row_bits, mean, tile) & ~7;
    unsigned at_first = FREE;
    for (;;) {
      unsigned kh[8];
      sector8(hi + b, kh);  // past the tile (tile % 8 == 4): the row's lo' lanes, masked
      const int n = min(tile - b, 8);
      unsigned lt = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) lt |= (unsigned)(i < n && kh[i] < sh) << i;
      const int below = __popc(lt);  // a prefix of the sector's lanes
      if (below < n) {
        first = b + below;
#pragma unroll
        for (int i = 0; i < 8; ++i) at_first = i == below ? kh[i] : at_first;
        if (below > 0 || b == below_to) break;
        b -= 8;  // the sector's first lane is not below sh: the answer may lie to the left
      } else {
        below_to = b + n;
        if (below_to == first) break;
        b += 8;  // every lane below sh: to the right
      }
    }
    // lane `first` and the run of equal hi' behind it: lo' decides
    if (first < tile && at_first == sh) {
      for (int i = first; i < tile && (i == first || __ldg(hi + i) == sh); ++i) {
        const unsigned l = __ldg(hi + tile + i);  // with the taxon: one trip
        const int t = __ldg(reinterpret_cast<const int*>(hi) + 2 * tile + i);
        if (l < sl) continue;
        if (l == sl) taxon = max(t, 0);
        break;
      }
    }
  }
  __stcs(out + qi, taxon);
}

// On no path: each non-negative query's 8 hi' lanes of its row from its
// guessed lane rounded down to a multiple of 8 (a 32-byte sector at tile
// 128), folded into one int, so that the load cannot be dropped.
__global__ void __launch_bounds__(THREADS)
rows_floor_kernel(const unsigned* __restrict__ table, int tile, int row_bits, unsigned mean,
                  const long long* __restrict__ queries, long long nq, int* __restrict__ out) {
  const long long qi = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (qi >= nq) return;
  const long long x = __ldcs(queries + qi);
  unsigned v = 0;
  if (x >= 0) {
    const unsigned long long s = xorshift64((unsigned long long)x);
    unsigned w[8];
    sector8(table + (long long)(s >> (64 - row_bits)) * 3 * tile + (row_guess(s, row_bits, mean, tile) & ~7), w);
#pragma unroll
    for (int i = 0; i < 8; ++i) v ^= w[i];
  }
  __stcs(out + qi, (int)v);
}

// threads a query of probe_rows_wide_kernel, and the lanes a step of the
// group reads: 16 bytes of l3 and 16 of l2 a thread
constexpr int GROUP = 4;
constexpr int STEP = 4 * GROUP;

// at most 32 registers: 2,048 threads (512 queries) a SM in flight
__global__ void __launch_bounds__(THREADS, 2048 / THREADS)
probe_rows_wide_kernel(const unsigned* __restrict__ table, int tile, int row_bits,
                       const ulonglong2* __restrict__ queries, long long nq, int* __restrict__ out) {
  const long long qi = ((long long)blockIdx.x * THREADS + threadIdx.x) / GROUP;
  if (qi >= nq) return;  // the whole group: its threads share qi, and the vote is the group's
  const int rank = threadIdx.x % GROUP;
  const unsigned group = ((1u << GROUP) - 1) << (threadIdx.x % 32 / GROUP * GROUP);
  const ulonglong2 x = __ldcs(queries + qi);
  const unsigned q3 = (unsigned)(x.x >> 32), q2 = (unsigned)x.x, q1 = (unsigned)(x.y >> 32), q0 = (unsigned)x.y;
  int taxon = 0;
  // a key's l3 is below 2^30: a query whose l3 is all ones (an invalid
  // window) equals only free lanes, whose -1 gives 0, so it is not walked
  if (q3 != FREE) {
    const unsigned long long h = xorshift64(x.x ^ xorshift64(x.y));
    const unsigned* l3 = table + (long long)(h >> (64 - row_bits)) * 5 * tile;
    for (int step = 0; step < tile; step += STEP) {
      const int i = step + 4 * rank;  // tile is a multiple of 4: 4 lanes lie all inside the row or all past it
      const bool in = i < tile;
      const uint4 v3 = in ? __ldg(reinterpret_cast<const uint4*>(l3 + i)) : make_uint4(FREE, FREE, FREE, FREE);
      const uint4 v2 = in ? __ldg(reinterpret_cast<const uint4*>(l3 + tile + i)) : make_uint4(FREE, FREE, FREE, FREE);
      const unsigned k3[4] = {v3.x, v3.y, v3.z, v3.w}, k2[4] = {v2.x, v2.y, v2.z, v2.w};
      bool stop = false;  // this thread's lanes hold a free lane or the key
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (k3[j] == FREE) {
          stop = true;  // the rest of the row is free
        } else if (k3[j] == q3 && k2[j] == q2) {
          const unsigned* at = l3 + step + 4 * rank + j;
          const unsigned k1 = __ldg(at + 2 * tile), k0 = __ldg(at + 3 * tile);
          const int t = __ldg(reinterpret_cast<const int*>(at) + 4 * tile);
          if (k1 == q1 && k0 == q0) {
            taxon = max(t, 0);
            stop = true;
          }
        }
      }
      if (__any_sync(group, stop)) break;
    }
  }
  taxon = __reduce_max_sync(group, taxon);  // one thread at most found the key
  if (rank == 0) __stcs(out + qi, taxon);
}

// a hashed table of row-major slots: [slots, 3] lanes, a slot's hi', lo' and
// taxon together
__global__ void __launch_bounds__(THREADS)
probe_hashed_kernel(const unsigned* __restrict__ table, long long slots, int tile, int bits,
                    const long long* __restrict__ queries, long long nq, int* __restrict__ out) {
  const long long qi = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (qi >= nq) return;
  const long long x = __ldcs(queries + qi);
  int taxon = 0;
  if (x >= 0) {  // no key is negative: an invalid window's -1 misses unsearched
    const unsigned long long s = xorshift64((unsigned long long)x);
    const long long home = (long long)(s >> (64 - bits));
    const long long end = min(home + tile, slots);
    for (long long j = home; j < end; ++j) {
      const unsigned* lane = table + 3 * j;
      // the taxon, in the key's 12 bytes, is read with it: a hit costs one round trip
      const int tx = __ldg(reinterpret_cast<const int*>(lane) + 2);
      const unsigned long long key = join(__ldg(lane), __ldg(lane + 1));
      if (key < s) continue;
      if (key == s) taxon = max(tx, 0);
      break;  // found, a free slot, or passed where the key would be
    }
  }
  __stcs(out + qi, taxon);
}

// a hashed table in column blocks: [rows, 3 * tile] lanes (slot j in row j /
// tile, its hi', lo' and taxon at lanes j % tile of the row's three blocks),
// tile a multiple of 8; 8 slots of hi' a step (see the header)
__global__ void __launch_bounds__(THREADS)
probe_hashed_cols_kernel(const unsigned* __restrict__ table, long long slots, int tile, int bits,
                         const long long* __restrict__ queries, long long nq, int* __restrict__ out) {
  const long long qi = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (qi >= nq) return;
  const long long x = __ldcs(queries + qi);
  int taxon = 0;
  const unsigned long long s = xorshift64((unsigned long long)x);
  const long long home = (long long)(s >> (64 - bits));
  // no key is negative: an invalid window's -1 misses unsearched; slots % 8
  // == 0, so a block that starts below the table's end lies in it
  if (x >= 0 && home < slots) {
    const unsigned sh = (unsigned)(s >> 32), sl = (unsigned)s;
    const long long end = min(home + tile, slots);
    long long b = home & ~7ll;
    int col = (int)(b % tile);
    const unsigned* at = table + b / tile * 3 * tile + col;  // the block's hi' lanes
    for (bool done = false; !done;) {
      unsigned kh[8];
      sector8(at, kh);
      const long long first = max(home - b, 0ll), last = min(end - b, 8ll);  // the lanes of [home, end)
      unsigned gt = 0, eq = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const bool in = i >= first && i < last;
        gt |= (unsigned)(in && kh[i] > sh) << i;
        eq |= (unsigned)(in && kh[i] == sh) << i;
      }
      // the lanes not below the query in hi', in order: above it, the key
      // is absent; equal, lo' decides (a run of equal hi' is rare)
      for (unsigned ge = gt | eq; ge && !done; ge &= ge - 1) {
        const int i = __ffs(ge) - 1;
        done = true;
        if ((gt >> i) & 1) break;
        const unsigned lo = __ldg(at + tile + i);  // with the taxon: one trip, two sectors
        const int tx = __ldg(reinterpret_cast<const int*>(at) + 2 * tile + i);
        if (lo > sl) break;
        if (lo == sl) {
          taxon = max(tx, 0);
          break;
        }
        done = false;  // below the query: the next lane
      }
      b += 8;  // every lane of [home, end) in this block is below the query: the next block
      if (done || b >= end) break;
      at += 8;
      col += 8;
      if (col == tile) {  // the next row: past its lo' and taxon blocks
        col = 0;
        at += 2 * tile;
      }
    }
  }
  __stcs(out + qi, taxon);
}

// On no path: each non-negative query's aligned 32-byte sector at its home
// slot (cols: of the hi' block; else of the row-major [slots, 3] lanes),
// folded into one int, so that the load cannot be dropped.
__global__ void __launch_bounds__(THREADS)
hashed_floor_kernel(const unsigned* __restrict__ table, long long slots, int tile, int bits, int cols,
                    const long long* __restrict__ queries, long long nq, int* __restrict__ out) {
  const long long qi = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (qi >= nq) return;
  const long long x = __ldcs(queries + qi);
  unsigned v = 0;
  if (x >= 0) {
    const long long home = (long long)(xorshift64((unsigned long long)x) >> (64 - bits));
    if (home < slots) {
      const long long lane = cols ? home / tile * 3 * tile + (home % tile & ~7ll) : 3 * home & ~7ll;
      unsigned w[8];
      sector8(table + lane, w);
#pragma unroll
      for (int i = 0; i < 8; ++i) v ^= w[i];
    }
  }
  __stcs(out + qi, (int)v);
}

unsigned blocks_of(long long nq) { return (unsigned)((nq + THREADS - 1) / THREADS); }

}  // namespace

// router: int32 [buckets + 1] (buckets = 2^bits), the first record of each
// prefix of the key >> shift; records: [rows * tile, 3 | 5] uint32 lanes in
// key order (wide: the four limbs of the 128-bit key, then the taxon),
// 16-byte aligned, with at least two records of padding past the last key
// (lookup.build_tiled keeps two rows); queries: int64 [nq] or, wide,
// [nq, 2] (hi64, lo64), 16-byte aligned; out: int32 [nq]. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int stpu_probe_tiled(const void* router, long long buckets, int shift, const void* records, int wide,
                                const void* queries, long long nq, void* out, void* stream) {
  if (nq <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(records) % 16) return (int)cudaErrorInvalidValue;
  const auto kernel = wide ? probe_tiled_kernel<true> : probe_tiled_kernel<false>;
  kernel<<<blocks_of(nq), THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)router, (unsigned long long)buckets, shift, (const unsigned*)records, (const long long*)queries,
      nq, (int*)out);
  return (int)cudaGetLastError();
}

// The floor of the tiled probe (tiled_floor_kernel), on no path: the
// arguments of stpu_probe_tiled; out: int32 [nq], router[p] ^ router[p + 1]
// and the xor of the sector of a non-empty bucket's first record for each
// query inside the key space, else 0.
extern "C" int stpu_tiled_floor(const void* router, long long buckets, int shift, const void* records, int wide,
                                const void* queries, long long nq, void* out, void* stream) {
  if (nq <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(records) % 16) return (int)cudaErrorInvalidValue;
  const auto kernel = wide ? tiled_floor_kernel<true> : tiled_floor_kernel<false>;
  kernel<<<blocks_of(nq), THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)router, (unsigned long long)buckets, shift, (const unsigned*)records, (const long long*)queries,
      nq, (int*)out);
  return (int)cudaGetLastError();
}

// router: int32 [buckets + 1] (buckets = 2^bits), the first key of each
// prefix of the key >> shift; keys: the sorted non-negative int64 keys,
// 16-byte aligned, then at least one padding key (lookup.build_bucketed
// pads maxb >= 1 all-ones keys); taxa: int32, a key's at its position;
// queries: int64 [nq]; out: int32 [nq]. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int stpu_probe_bucketed(const void* router, long long buckets, int shift, const void* keys,
                                   const void* taxa, const void* queries, long long nq, void* out, void* stream) {
  if (nq <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(keys) % 16) return (int)cudaErrorInvalidValue;
  probe_bucketed_kernel<<<blocks_of(nq), THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)router, (unsigned long long)buckets, shift, (const long long*)keys, (const int*)taxa,
      (const long long*)queries, nq, (int*)out);
  return (int)cudaGetLastError();
}

// The floor of the bucketed probe (bucketed_floor_kernel), on no path: the
// arguments of stpu_probe_bucketed but the taxa; out: int32 [nq],
// router[p] ^ router[p + 1] and the xor of the guessed sector's keys of a
// non-empty bucket for each non-negative query inside the key space, else 0.
extern "C" int stpu_bucketed_floor(const void* router, long long buckets, int shift, const void* keys,
                                   const void* queries, long long nq, void* out, void* stream) {
  if (nq <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(keys) % 16) return (int)cudaErrorInvalidValue;
  bucketed_floor_kernel<<<blocks_of(nq), THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)router, (unsigned long long)buckets, shift, (const long long*)keys, (const long long*)queries, nq,
      (int*)out);
  return (int)cudaGetLastError();
}

// starts: int32 [buckets + 1], the prefix directory of the narrow keys >>
// shift (0 <= shift <= 63); slots: int64 [n] (lookup.build_slots' (r << c)
// | f in key order, 1 <= c <= min(32, 64 - shift)), 16-byte aligned, with
// a readable word past the last (build_slots allocates one); codes: int32
// table of the distinct taxa, or null when the field is the taxon;
// queries: int64 [nq]; out: int32 [nq]. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int stpu_probe_slots(const void* starts, long long buckets, int shift, int c, const void* slots,
                                const void* codes, const void* queries, long long nq, void* out, void* stream) {
  if (nq <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(slots) % 16) return (int)cudaErrorInvalidValue;
  probe_slots_kernel<<<blocks_of(nq), THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)starts, (unsigned long long)buckets, shift, c, (const long long*)slots, (const int*)codes,
      (const long long*)queries, nq, (int*)out);
  return (int)cudaGetLastError();
}

// table: [2^row_bits, 3 * tile] (narrow: hi', lo', taxon blocks of the
// scrambled keys) or [2^row_bits, 5 * tile] (wide: l3, l2, l1, l0, taxon)
// uint32 lanes, 16-byte aligned, tile a multiple of 4; mean (narrow): the
// table's mean keys a row in 16.16 fixed point (lookup.row_mean), which only
// steers where the walk starts; queries: int64 [nq] or, wide, [nq, 2],
// 16-byte aligned; out: int32 [nq]. Returns the cudaError_t of the launch (0
// on success).
extern "C" int stpu_probe_rows(const void* table, int tile, int row_bits, unsigned mean, int wide,
                               const void* queries, long long nq, void* out, void* stream) {
  if (nq <= 0) return 0;
  if (wide) {
    probe_rows_wide_kernel<<<blocks_of(nq * GROUP), THREADS, 0, (cudaStream_t)stream>>>(
        (const unsigned*)table, tile, row_bits, (const ulonglong2*)queries, nq, (int*)out);
  } else {
    probe_rows_kernel<<<blocks_of(nq), THREADS, 0, (cudaStream_t)stream>>>(
        (const unsigned*)table, tile, row_bits, mean, (const long long*)queries, nq, (int*)out);
  }
  return (int)cudaGetLastError();
}

// The floor of the narrow row probe (rows_floor_kernel), on no path: the
// arguments of stpu_probe_rows for a narrow table; out: int32 [nq], the xor
// of each non-negative query's 8 hi' lanes from its guessed lane.
extern "C" int stpu_rows_floor(const void* table, int tile, int row_bits, unsigned mean, const void* queries,
                               long long nq, void* out, void* stream) {
  if (nq <= 0) return 0;
  if (tile % 4 || reinterpret_cast<uintptr_t>(table) % 16) return (int)cudaErrorInvalidValue;
  rows_floor_kernel<<<blocks_of(nq), THREADS, 0, (cudaStream_t)stream>>>(
      (const unsigned*)table, tile, row_bits, mean, (const long long*)queries, nq, (int*)out);
  return (int)cudaGetLastError();
}

// table: a hashed table of `slots` slots (rows * tile), uint32 lanes,
// [rows, tile, 3] (cols 0) or [rows, 3 * tile] (cols 1: tile a multiple of
// 8, 16-byte aligned), from lookup.build_hashed(_cols) with these tile and
// bits (1 <= bits <= 63); queries: int64 [nq]; out: int32 [nq]. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int stpu_probe_hashed(const void* table, long long slots, int tile, int bits, int cols,
                                 const void* queries, long long nq, void* out, void* stream) {
  if (nq <= 0) return 0;
  if (cols && (tile % 8 || reinterpret_cast<uintptr_t>(table) % 16)) return (int)cudaErrorInvalidValue;
  const auto kernel = cols ? probe_hashed_cols_kernel : probe_hashed_kernel;
  kernel<<<blocks_of(nq), THREADS, 0, (cudaStream_t)stream>>>((const unsigned*)table, slots, tile, bits,
                                                              (const long long*)queries, nq, (int*)out);
  return (int)cudaGetLastError();
}

// The floor of the hashed probes (hashed_floor_kernel), on no path: the
// arguments of stpu_probe_hashed, the table 16-byte aligned (and tile a
// multiple of 8 for cols); out: int32 [nq], the xor of each query's sector.
extern "C" int stpu_hashed_floor(const void* table, long long slots, int tile, int bits, int cols,
                                 const void* queries, long long nq, void* out, void* stream) {
  if (nq <= 0) return 0;
  if ((cols && tile % 8) || reinterpret_cast<uintptr_t>(table) % 16) return (int)cudaErrorInvalidValue;
  hashed_floor_kernel<<<blocks_of(nq), THREADS, 0, (cudaStream_t)stream>>>(
      (const unsigned*)table, slots, tile, bits, cols, (const long long*)queries, nq, (int*)out);
  return (int)cudaGetLastError();
}
