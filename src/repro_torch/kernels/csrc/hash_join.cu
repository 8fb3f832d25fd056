// Radix-partitioned hash join with its aggregate fused (RRJ's and GHJ's
// local join, paper §5.1-5.2), for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package's local join
// (src/repro/core/shuffle.py: local_join + join_agg) is jnp.sort and
// searchsorted under XLA, and the port's plain twin sorts R's keys widened
// to int64, gathers and searches 2A slots a relation.  This kernel computes
// the same function in place of those library calls:
//
//   out = sum over S rows with a match in R of rv[match] * sv   (mod 2^32)
//
// on u32 words carried as int32 bit patterns.  R's keys are unique (the
// build side).  A row whose key is MISS (0xFFFFFFFF) is no row, on either
// side: the route leaves its empty slots so.  Five kernels, all named
// join_*, on the caller's stream, with no host sync:
//
//   join_hist     R's and S's keys counted by partition, p = h >> (32 - b)
//                 of the multiplicative hash h = key * 0x9E3779B1 (odd, so a
//                 bijection of u32: clustered keys spread, and equal hashes
//                 are equal keys).  A shared histogram of the 2^b <= 2^15
//                 partitions a block, one global atomic a nonzero bin.
//   join_scan     one block a relation: each partition's first row, and
//                 with two radix passes each coarse group's first row and
//                 the second pass's tiles.  Zeroes the output word.
//   join_scatter  the first radix pass over the relation's slots in tiles
//                 of 8192: each valid row's (h, value) pair, ranked by digit
//                 in shared memory, staged in digit order and written as
//                 contiguous runs at cursors reserved with one atomic a
//                 digit a tile.  The digit is the partition (b <= 8, one
//                 pass) or its top b - 8 bits (at most 128 coarse groups).
//                 A quad of MISS keys loads no values.
//   join_refine   the second pass, where b > 8: each coarse group's pairs,
//                 in tiles that never straddle two groups, into its 256
//                 partitions.  Passes have at most 256 digits because one
//                 pass into thousands leaves a row or two a digit a tile,
//                 and each 8 B pair then takes a sector of its own.
//   join_probe    persistent blocks, partitions strided over them: a block
//                 loads R's rows of a partition into an open-addressing
//                 table in shared memory (keys and values, linear probing,
//                 slot from the hash bits below the partition's), streams
//                 S's rows of the partition through it and keeps the u32
//                 product sum in registers; at the end one u32 atomicAdd a
//                 block.  An R partition above half the table is built in
//                 chunks of half a table, each probed by all of S's rows of
//                 the partition: R's keys are unique, so an S row matches
//                 in one chunk at most, and a skewed input is exact, only
//                 slower.
//
// The wrapper's plan() sizes the partitions from |R| (slots, MISS
// included): 2^b partitions so that an average partition fills at most half
// of a table of up to 2^14 entries (128 KB), and the table by the same
// average.  The empty marker is hash(MISS), which no valid key has.
//
// Bound: bytes.  The least a join reads is its four int32 columns once,
// 16 B a slot pair.  This design reads the keys twice (the histogram and
// the first pass), the values of valid quads once, writes and reads each
// valid row's 8 B pair once a pass, and reads it once more to build or
// probe: about 13 GB at 2 x 256M slots with half of them valid, against
// the 4.1 GB bound.  Against that it keeps every pass a stream: the tables
// live in shared memory and no pass reads at random from device memory.
#include <cuda_runtime.h>
#include <stdint.h>

// What one call runs, as the wrapper's plan() gives it.  At namespace
// scope: the C entry point takes it.
struct JoinArgs {
  const void* rk;           // R's keys (nr,) u32 as int32
  const void* rv;           // R's values (nr,)
  long long nr;
  const void* sk;           // S's keys (ns,)
  const void* sv;           // S's values (ns,)
  long long ns;
  int bits;                 // log2 partitions, 1..15
  int lo_bits;              // 0: one radix pass; else the second pass's
                            // digits (8)
  int table;                // entries of the probe's table (power of 2)
  int grid_hist;            // blocks of join_hist a relation
  int grid_pass;            // blocks of join_scatter and join_refine
  int grid_probe;           // blocks of join_probe
  void* meta;               // ints, meta_ints(2^bits) of them
  void* pairs_r;            // (nr,) int2
  void* pairs_s;            // (ns,) int2
  void* tmp;                // (max(nr, ns),) int2 with two passes
  void* out;                // one u32
  int device;
  void* stream;
};

namespace {

constexpr int kThreads = 1024;             // join_scatter, join_refine
constexpr int kTileRows = 8;               // rows a thread a tile
constexpr int kTile = kThreads * kTileRows;  // rows a tile
constexpr int kMaxDigits = 256;            // digits of one radix pass
constexpr int kMaxCoarse = 128;            // groups of the first of two
constexpr int kHistThreads = 1024;
constexpr int kScanThreads = 1024;
constexpr int kProbeThreads = 1024;
constexpr int kUnroll = 2;                 // quads in flight a thread
constexpr int kMinTable = 64;
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMiss = -1;
constexpr unsigned kHashMul = 0x9E3779B1u;
constexpr unsigned kEmpty = 0u - kHashMul;  // hash(MISS)

__device__ __forceinline__ unsigned hash_key(int k) {
  return (unsigned)k * kHashMul;
}

// One relation's meta, ints: start (P + 1) | cur (P) | scur (kMaxCoarse)
// | sstart (kMaxCoarse + 1) | tstart (kMaxCoarse + 1).  The two
// relations' counts (2P) come first, so one memset zeroes both.
struct Rel {
  int *start, *cur, *scur, *sstart, *tstart;
};

constexpr int kRelExtra = 1 + 3 * kMaxCoarse + 2;

__host__ __device__ inline Rel rel_at(int* m, int P) {
  Rel r;
  r.start = m;
  r.cur = r.start + P + 1;
  r.scur = r.cur + P;
  r.sstart = r.scur + kMaxCoarse;
  r.tstart = r.sstart + kMaxCoarse + 1;
  return r;
}

// Rows 4q .. 4q+3 of keys: 16-byte loads where the quad is whole and
// aligned, MISS past the end.
__device__ __forceinline__ void load_keys(const int* __restrict__ x,
                                          long long N, long long q, bool vec,
                                          int kx[4]) {
  const long long i = q * 4;
  if (vec && i + 4 <= N) {
    const int4 a = __ldcs(reinterpret_cast<const int4*>(x) + q);
    kx[0] = a.x; kx[1] = a.y; kx[2] = a.z; kx[3] = a.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) kx[e] = i + e < N ? x[i + e] : kMiss;
  }
}

// The values of rows 4q .. 4q+3, read only when some key of the quad is
// valid (a quad of empty slots costs its keys alone).
__device__ __forceinline__ void load_vals(const int* __restrict__ v,
                                          long long N, long long q, bool vec,
                                          const int kx[4], int vx[4]) {
  const long long i = q * 4;
  const bool any = kx[0] != kMiss || kx[1] != kMiss || kx[2] != kMiss ||
                   kx[3] != kMiss;
  if (!any) {
#pragma unroll
    for (int e = 0; e < 4; ++e) vx[e] = 0;
  } else if (vec && i + 4 <= N) {
    const int4 a = __ldcs(reinterpret_cast<const int4*>(v) + q);
    vx[0] = a.x; vx[1] = a.y; vx[2] = a.z; vx[3] = a.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) vx[e] = i + e < N ? v[i + e] : 0;
  }
}

// h[p] += 1 for every lane with p >= 0; the lanes that hold lane 0's p
// add with one atomic.  Every lane of the warp calls it.
__device__ __forceinline__ void warp_count(int* h, int p) {
  const int p0 = __shfl_sync(kFull, p, 0);
  const bool same = p == p0;
  const unsigned m = __ballot_sync(kFull, same);
  if (p0 >= 0 && __popc(m) > 1) {
    if ((threadIdx.x & 31) == 0) atomicAdd(&h[p0], __popc(m));
    if (!same && p >= 0) atomicAdd(&h[p], 1);
  } else if (p >= 0) {
    atomicAdd(&h[p], 1);
  }
}

// Blocks [0, G) count R, [G, 2G) count S, into counts[0 .. P) and
// counts[P .. 2P).
__global__ void __launch_bounds__(kHistThreads)
join_hist(const int* __restrict__ rk, long long nr,
          const int* __restrict__ sk, long long ns, int bits, bool vec_r,
          bool vec_s, int* __restrict__ counts) {
  extern __shared__ int h[];
  const int P = 1 << bits;
  const int G = gridDim.x / 2;
  const bool is_s = (int)blockIdx.x >= G;
  const int* x = is_s ? sk : rk;
  const long long N = is_s ? ns : nr;
  const bool vec = is_s ? vec_s : vec_r;
  const long long blk = is_s ? blockIdx.x - G : blockIdx.x;
  for (int k = threadIdx.x; k < P; k += blockDim.x) h[k] = 0;
  __syncthreads();
  const int shift = 32 - bits;
  const int lane = threadIdx.x & 31;
  const long long nq = (N + 3) >> 2;
  const long long stride = (long long)G * blockDim.x * kUnroll;
  // q0 - lane is the warp's first quad, so the loop is uniform per warp
  for (long long q0 = blk * blockDim.x * kUnroll + threadIdx.x;
       q0 - lane < nq; q0 += stride) {
    int kx[kUnroll][4];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      load_keys(x, N, q0 + (long long)u * blockDim.x, vec, kx[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        warp_count(h, kx[u][e] != kMiss ? (int)(hash_key(kx[u][e]) >> shift)
                                         : -1);
  }
  __syncthreads();
  int* c = counts + (is_s ? P : 0);
  for (int k = threadIdx.x; k < P; k += blockDim.x)
    if (h[k] != 0) atomicAdd(&c[k], h[k]);
}

// inclusive sum of v over the lanes up to this one
__device__ __forceinline__ int warp_scan(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// exclusive block-wide sum of v in thread order; the total in *total.
// Every thread of the block calls it; wsum holds 32 ints.
__device__ __forceinline__ int block_scan(int v, int* wsum, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int incl = warp_scan(v, lane);
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = warp_scan(lane < nw ? wsum[lane] : 0, lane);
    if (lane < nw) wsum[lane] = w;
  }
  __syncthreads();
  const int out = incl - v + (warp > 0 ? wsum[warp - 1] : 0);
  *total = wsum[nw - 1];
  __syncthreads();
  return out;
}

// Block 0 scans R's counts, block 1 S's: start (exclusive, start[P] the
// valid rows), cur = start; with two passes (lo_bits > 0) each coarse
// group g of 2^lo_bits partitions: its first row (scur, sstart; sstart[C]
// the total) and the first of its tiles of the second pass (tstart;
// tstart[C] the total).  Block 0 zeroes the output word.
__global__ void __launch_bounds__(kScanThreads)
join_scan(int bits, int lo_bits, const int* __restrict__ counts, Rel r,
          Rel s, unsigned* __restrict__ out) {
  __shared__ int wsum[32];
  const int P = 1 << bits;
  const int* c = counts + (blockIdx.x ? P : 0);
  const Rel m = blockIdx.x ? s : r;
  if (blockIdx.x == 0 && threadIdx.x == 0) *out = 0u;
  const int per = (P + blockDim.x - 1) / blockDim.x;
  const int lo = min((int)threadIdx.x * per, P);
  const int hi = min(lo + per, P);
  int rows = 0;
  for (int p = lo; p < hi; ++p) rows += c[p];
  int total;
  int run = block_scan(rows, wsum, &total);
  for (int p = lo; p < hi; ++p) {
    m.start[p] = run;
    m.cur[p] = run;
    run += c[p];
  }
  if (threadIdx.x == 0) m.start[P] = total;
  if (lo_bits == 0) return;
  __syncthreads();
  const int C = P >> lo_bits;                // <= kMaxCoarse threads
  const int g = threadIdx.x;
  int s0 = 0, n = 0;
  if (g < C) {
    s0 = m.start[g << lo_bits];
    n = m.start[(g + 1) << lo_bits] - s0;
  }
  int tiles_all;
  const int t0 = block_scan((n + kTile - 1) / kTile, wsum, &tiles_all);
  if (g < C) {
    m.scur[g] = s0;
    m.sstart[g] = s0;
    m.tstart[g] = t0;
  }
  if (g == 0) {
    m.sstart[C] = total;
    m.tstart[C] = tiles_all;
  }
}

// One tile of a radix pass: each thread holds kTileRows rows as (digit d,
// hash hh, value v), d = -1 for no row; a row's digit is (hh >> shift) &
// dmask < nd <= kMaxDigits.  The rows are ranked per digit (shared
// atomics; the lanes that hold lane 0's digit take consecutive ranks from
// one), staged in shared memory in digit order while each digit's run is
// reserved in the cursors cur[d] (one atomic a digit a tile), and written
// out as contiguous runs of (hh, v) pairs.  Every thread of the block
// calls it; lh is zero on entry and on return.
__device__ __forceinline__ void tile_scatter(
    const int (&d)[kTileRows], const unsigned (&hh)[kTileRows],
    const int (&v)[kTileRows], int nd, int shift, unsigned dmask,
    int* __restrict__ cur, int2* __restrict__ dst, int* lh, int* lstart,
    int* gbase, int2* stage) {
  const int lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  int r[kTileRows];
#pragma unroll
  for (int k = 0; k < kTileRows; ++k) {
    const int d0 = __shfl_sync(kFull, d[k], 0);
    const bool same = d[k] == d0;
    const unsigned mm = __ballot_sync(kFull, same);
    int rk = 0;
    if (d0 >= 0 && __popc(mm) > 1) {
      int base = 0;
      if (lane == 0) base = atomicAdd(&lh[d0], __popc(mm));
      base = __shfl_sync(kFull, base, 0);
      if (same) rk = base + __popc(mm & lt);
      else if (d[k] >= 0) rk = atomicAdd(&lh[d[k]], 1);
    } else if (d[k] >= 0) {
      rk = atomicAdd(&lh[d[k]], 1);
    }
    r[k] = rk;
  }
  __syncthreads();
  // warp 0: exclusive scan of lh (8 digits a lane) into lstart, the
  // tile's total in lstart[kMaxDigits]
  if (threadIdx.x < 32) {
    constexpr int kPer = kMaxDigits / 32;
    const int base = kPer * lane;
    int c[kPer], sum = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      c[k] = base + k < nd ? lh[base + k] : 0;
      sum += c[k];
    }
    int run = warp_scan(sum, lane) - sum;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (base + k < nd) lstart[base + k] = run;
      run += c[k];
    }
    if (lane == 31) lstart[kMaxDigits] = run;
  }
  __syncthreads();
  // threads < nd reserve their digit's run while the block stages
  if ((int)threadIdx.x < nd) {
    const int c = lh[threadIdx.x];
    if (c > 0) gbase[threadIdx.x] = atomicAdd(&cur[threadIdx.x], c);
    lh[threadIdx.x] = 0;
  }
#pragma unroll
  for (int k = 0; k < kTileRows; ++k)
    if (d[k] >= 0) stage[lstart[d[k]] + r[k]] = make_int2((int)hh[k], v[k]);
  __syncthreads();
  const int total = lstart[kMaxDigits];
  for (int j = threadIdx.x; j < total; j += blockDim.x) {
    const int2 p = stage[j];
    const int dd = (int)(((unsigned)p.x >> shift) & dmask);
    dst[gbase[dd] + (j - lstart[dd])] = p;
  }
  __syncthreads();
}

// Shared memory of a radix pass: lh, lstart, gbase, then the stage.
constexpr int kScatterHead = 3 * kMaxDigits + 2;   // ints, even
constexpr size_t kScatterSmem =
    kScatterHead * sizeof(int) + kTile * sizeof(int2);

// keys, then the values of the quads that hold a valid key, of tile t
__device__ __forceinline__ void load_tile(const int* __restrict__ x,
                                          const int* __restrict__ vals,
                                          long long N, long long t, bool vec,
                                          int (&kx)[kTileRows],
                                          int (&vx)[kTileRows]) {
#pragma unroll
  for (int j = 0; j < kTileRows / 4; ++j)
    load_keys(x, N, t * (kTile / 4) + (long long)j * blockDim.x + threadIdx.x,
              vec, kx + 4 * j);
#pragma unroll
  for (int j = 0; j < kTileRows / 4; ++j)
    load_vals(vals, N,
              t * (kTile / 4) + (long long)j * blockDim.x + threadIdx.x, vec,
              kx + 4 * j, vx + 4 * j);
}

// The first radix pass over a relation's slots: each valid row's (hash,
// value) pair into dst at the cursors cur of its digit (hash >> shift) &
// dmask.  The next tile's loads start before a tile is ranked and
// written.
__global__ void __launch_bounds__(kThreads, 1)
join_scatter(const int* __restrict__ x, const int* __restrict__ vals,
             long long N, bool vec, int shift, unsigned dmask,
             int* __restrict__ cur, int2* __restrict__ dst) {
  extern __shared__ __align__(16) int sh[];
  int* lh = sh;
  int* lstart = lh + kMaxDigits;             // kMaxDigits + 1
  int* gbase = lstart + kMaxDigits + 1;      // kMaxDigits
  int2* stage = reinterpret_cast<int2*>(sh + kScatterHead);
  const int nd = (int)dmask + 1;
  for (int k = threadIdx.x; k < kMaxDigits; k += blockDim.x) lh[k] = 0;
  __syncthreads();
  const long long ntiles = (N + kTile - 1) / kTile;
  int kx[kTileRows], vx[kTileRows];
  if ((long long)blockIdx.x < ntiles)
    load_tile(x, vals, N, blockIdx.x, vec, kx, vx);
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    int d[kTileRows], v[kTileRows];
    unsigned hh[kTileRows];
#pragma unroll
    for (int k = 0; k < kTileRows; ++k) {
      hh[k] = hash_key(kx[k]);
      d[k] = kx[k] != kMiss ? (int)((hh[k] >> shift) & dmask) : -1;
      v[k] = vx[k];
    }
    if (t + gridDim.x < ntiles)
      load_tile(x, vals, N, t + gridDim.x, vec, kx, vx);
    tile_scatter(d, hh, v, nd, shift, dmask, cur, dst, lh, lstart, gbase,
                 stage);
  }
}

// The tile t of the second pass: its coarse group g (the last with
// tstart[g] <= t) and its rows [r0, r1) of the first pass's pairs.
__device__ __forceinline__ void refine_tile(const int* __restrict__ sstart,
                                            const int* __restrict__ tstart,
                                            int C, int t, int& g, int& r0,
                                            int& r1) {
  int lo = 0, hi = C - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tstart[mid] <= t) lo = mid; else hi = mid - 1;
  }
  g = lo;
  r0 = sstart[g] + (t - tstart[g]) * kTile;
  r1 = r0 + kTile < sstart[g + 1] ? r0 + kTile : sstart[g + 1];
}

__device__ __forceinline__ void load_pairs(const int2* __restrict__ src,
                                           int r0, int r1,
                                           int2 (&p)[kTileRows],
                                           bool (&ok)[kTileRows]) {
#pragma unroll
  for (int k = 0; k < kTileRows; ++k) {
    const int i = r0 + k * (int)blockDim.x + (int)threadIdx.x;
    ok[k] = i < r1;
    p[k] = ok[k] ? __ldcs(src + i) : make_int2(0, 0);
  }
}

// The second radix pass: the first pass's pairs, coarse group by group in
// tiles that never straddle two (sstart, tstart), each into its 2^lo_bits
// partitions: digit (hash >> shift) & dmask, at the cursors cur of the
// group's partitions.
__global__ void __launch_bounds__(kThreads, 1)
join_refine(const int2* __restrict__ src, int C,
            const int* __restrict__ sstart, const int* __restrict__ tstart,
            int shift, unsigned dmask, int lo_bits, int* __restrict__ cur,
            int2* __restrict__ dst) {
  extern __shared__ __align__(16) int sh[];
  int* lh = sh;
  int* lstart = lh + kMaxDigits;
  int* gbase = lstart + kMaxDigits + 1;
  int2* stage = reinterpret_cast<int2*>(sh + kScatterHead);
  const int nd = (int)dmask + 1;
  for (int k = threadIdx.x; k < kMaxDigits; k += blockDim.x) lh[k] = 0;
  __syncthreads();
  const int ntiles = tstart[C];
  int g = 0, r0 = 0, r1 = 0;
  int2 p[kTileRows];
  bool ok[kTileRows];
  if ((int)blockIdx.x < ntiles) {
    refine_tile(sstart, tstart, C, blockIdx.x, g, r0, r1);
    load_pairs(src, r0, r1, p, ok);
  }
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    int d[kTileRows], v[kTileRows];
    unsigned hh[kTileRows];
#pragma unroll
    for (int k = 0; k < kTileRows; ++k) {
      hh[k] = (unsigned)p[k].x;
      v[k] = p[k].y;
      d[k] = ok[k] ? (int)((hh[k] >> shift) & dmask) : -1;
    }
    int* c = cur + (g << lo_bits);
    if (t + (int)gridDim.x < ntiles) {
      refine_tile(sstart, tstart, C, t + gridDim.x, g, r0, r1);
      load_pairs(src, r0, r1, p, ok);
    }
    tile_scatter(d, hh, v, nd, shift, dmask, c, dst, lh, lstart, gbase,
                 stage);
  }
}

constexpr int kU = 4;                      // pairs in flight a thread

// The pairs i0, i0 + NT, ... (kU of them) below end, kEmpty past it.
__device__ __forceinline__ void load_batch(const int2* __restrict__ src,
                                           int i0, int end, int2 (&q)[kU]) {
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int i = i0 + u * (int)blockDim.x;
    q[u] = i < end ? __ldcs(src + i) : make_int2((int)kEmpty, 0);
  }
}

// R's pairs into the table of 2^lw slots (linear probing from the lw bits
// below the partition's); the table has room: 2^lw >= twice the rows.
__device__ __forceinline__ void insert_batch(const int2 (&q)[kU],
                                             unsigned* tk, unsigned* tv,
                                             int bits, int lw) {
  const unsigned wm = (1u << lw) - 1u;
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const unsigned h = (unsigned)q[u].x;
    if (h == kEmpty) continue;
    unsigned slot = (h << bits) >> (32 - lw);
    while (true) {
      const unsigned old = atomicCAS(&tk[slot], kEmpty, h);
      if (old == kEmpty) {
        tv[slot] = (unsigned)q[u].y;
        break;
      }
      slot = (slot + 1u) & wm;
    }
  }
}

// S's pairs against the table: sum += the matched R value * the S value.
__device__ __forceinline__ void probe_batch(const int2 (&q)[kU],
                                            const unsigned* tk,
                                            const unsigned* tv, int bits,
                                            int lw, unsigned& sum) {
  const unsigned wm = (1u << lw) - 1u;
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const unsigned h = (unsigned)q[u].x;
    if (h == kEmpty) continue;
    unsigned slot = (h << bits) >> (32 - lw);
    while (true) {
      const unsigned k = tk[slot];
      if (k == h) {
        sum += tv[slot] * (unsigned)q[u].y;
        break;
      }
      if (k == kEmpty) break;
      slot = (slot + 1u) & wm;
    }
  }
}

// Partitions strided over the blocks; for each, R's rows in chunks of at
// most table / 2 into a table of W = max(kMinTable, the chunk's rows
// rounded up to a power of 2, times 2) <= table slots, probed by every S
// row of the partition.  A chunk's first batch of R pairs and the
// partition's first batch of S pairs are loaded together, while the table
// is cleared, so a partition of at most kU rows a thread on each side
// waits for memory once.  One u32 atomicAdd a block into out.
__global__ void __launch_bounds__(kProbeThreads, 1)
join_probe(const int2* __restrict__ pr, const int* __restrict__ rstart,
           const int2* __restrict__ ps, const int* __restrict__ sstart,
           int bits, int table, unsigned* __restrict__ out) {
  extern __shared__ __align__(16) unsigned tab[];
  unsigned* tk = tab;                        // table keys (hashes)
  unsigned* tv = tab + table;                // table values
  unsigned* wsum = tab + 2 * table;          // 32 warps' sums
  const int P = 1 << bits;
  const int T = (int)threadIdx.x, NT = (int)blockDim.x;
  unsigned sum = 0;
  for (int part = blockIdx.x; part < P; part += gridDim.x) {
    const int a0 = rstart[part], a1 = rstart[part + 1];
    const int b0 = sstart[part], b1 = sstart[part + 1];
    if (a0 == a1 || b0 == b1) continue;      // uniform across the block
    for (int c0 = a0; c0 < a1; c0 += table / 2) {
      const int c1 = c0 + table / 2 < a1 ? c0 + table / 2 : a1;
      int W = 1 << (32 - __clz(2 * (c1 - c0) - 1));
      W = W < kMinTable ? kMinTable : W > table ? table : W;
      const int lw = 31 - __clz(W);
      int2 qr[kU], qs[kU];
      load_batch(pr, c0 + T, c1, qr);
      load_batch(ps, b0 + T, b1, qs);
      for (int k = T; k < W; k += NT) tk[k] = kEmpty;
      __syncthreads();
      insert_batch(qr, tk, tv, bits, lw);
      for (int i0 = c0 + T + kU * NT; i0 < c1; i0 += kU * NT) {
        load_batch(pr, i0, c1, qr);
        insert_batch(qr, tk, tv, bits, lw);
      }
      __syncthreads();
      probe_batch(qs, tk, tv, bits, lw, sum);
      for (int i0 = b0 + T + kU * NT; i0 < b1; i0 += kU * NT) {
        load_batch(ps, i0, b1, qs);
        probe_batch(qs, tk, tv, bits, lw, sum);
      }
      __syncthreads();
    }
  }
  sum = __reduce_add_sync(kFull, sum);
  if ((T & 31) == 0) wsum[T >> 5] = sum;
  __syncthreads();
  if (T < 32) {
    unsigned v = T < (NT >> 5) ? wsum[T] : 0u;
    v = __reduce_add_sync(kFull, v);
    if (T == 0 && v != 0u) atomicAdd(out, v);
  }
}

bool g_ready[kMaxDevices];
int g_sms[kMaxDevices], g_smem_block[kMaxDevices], g_smem_sm[kMaxDevices];

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// the device's attributes, and every kernel with dynamic shared memory
// allowed all of a block's, once per device
cudaError_t ready(int device) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (g_ready[device]) return cudaSuccess;
  cudaError_t e = cudaDeviceGetAttribute(
      &g_sms[device], cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&g_smem_block[device],
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&g_smem_sm[device],
                               cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                               device);
  const int b = g_smem_block[device];
  if (e == cudaSuccess) e = allow_smem(join_hist, b);
  if (e == cudaSuccess) e = allow_smem(join_scatter, b);
  if (e == cudaSuccess) e = allow_smem(join_refine, b);
  if (e == cudaSuccess) e = allow_smem(join_probe, b);
  if (e == cudaSuccess) g_ready[device] = true;
  return e;
}

cudaError_t run(const JoinArgs& a) {
  cudaStream_t st = (cudaStream_t)a.stream;
  const int P = 1 << a.bits;
  int* meta = (int*)a.meta;
  const Rel r = rel_at(meta + 2 * P, P);
  const Rel s = rel_at(meta + 2 * P + (2 * P + kRelExtra), P);
  unsigned* out = (unsigned*)a.out;
  const bool vec_r = (((uintptr_t)a.rk | (uintptr_t)a.rv) & 15u) == 0;
  const bool vec_s = (((uintptr_t)a.sk | (uintptr_t)a.sv) & 15u) == 0;
  cudaError_t e = cudaMemsetAsync(meta, 0, (size_t)2 * P * sizeof(int), st);
  if (e != cudaSuccess) return e;
  join_hist<<<2 * a.grid_hist, kHistThreads, (size_t)P * sizeof(int), st>>>(
      (const int*)a.rk, a.nr, (const int*)a.sk, a.ns, a.bits, vec_r, vec_s,
      meta);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  join_scan<<<2, kScanThreads, 0, st>>>(a.bits, a.lo_bits, meta, r, s, out);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const int* keys[2] = {(const int*)a.rk, (const int*)a.sk};
  const int* vals[2] = {(const int*)a.rv, (const int*)a.sv};
  const long long rows[2] = {a.nr, a.ns};
  const bool vec[2] = {vec_r, vec_s};
  const Rel rel[2] = {r, s};
  int2* pairs[2] = {(int2*)a.pairs_r, (int2*)a.pairs_s};
  for (int k = 0; k < 2; ++k) {
    if (a.lo_bits == 0) {                    // one pass: digit = partition
      join_scatter<<<a.grid_pass, kThreads, kScatterSmem, st>>>(
          keys[k], vals[k], rows[k], vec[k], 32 - a.bits,
          (unsigned)P - 1u, rel[k].cur, pairs[k]);
    } else {                                 // coarse groups, then parts
      const int C = P >> a.lo_bits;
      join_scatter<<<a.grid_pass, kThreads, kScatterSmem, st>>>(
          keys[k], vals[k], rows[k], vec[k], 32 - a.bits + a.lo_bits,
          (unsigned)C - 1u, rel[k].scur, (int2*)a.tmp);
      if ((e = cudaGetLastError()) != cudaSuccess) return e;
      join_refine<<<a.grid_pass, kThreads, kScatterSmem, st>>>(
          (const int2*)a.tmp, C, rel[k].sstart, rel[k].tstart, 32 - a.bits,
          (1u << a.lo_bits) - 1u, a.lo_bits, rel[k].cur, pairs[k]);
    }
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  join_probe<<<a.grid_probe, kProbeThreads,
               ((size_t)2 * a.table + 32) * sizeof(unsigned), st>>>(
      (const int2*)a.pairs_r, r.start, (const int2*)a.pairs_s, s.start,
      a.bits, a.table, out);
  return cudaGetLastError();
}

// runs fn on `device`, the caller's device restored after
template <class F>
int on_device(int device, F fn) {
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e == cudaSuccess && cur != device) e = cudaSetDevice(device);
  if (e == cudaSuccess) e = ready(device);
  if (e == cudaSuccess) e = fn();
  if (cur >= 0 && cur != device) cudaSetDevice(cur);
  return (int)e;
}

}  // namespace

extern "C" {

// sms, shared bytes a block may opt in to, shared bytes an SM: what the
// wrapper's plan() sizes grids and the table by.
int hash_join_device_info(int device, int* info) {
  return on_device(device, [&]() {
    info[0] = g_sms[device];
    info[1] = g_smem_block[device];
    info[2] = g_smem_sm[device];
    return cudaSuccess;
  });
}

// Ints of meta for 2^bits partitions (the wrapper allocates them).
int hash_join_meta_ints(int bits) {
  const int P = 1 << bits;
  return 2 * P + 2 * (2 * P + kRelExtra);
}

// Launches the join on `stream` of `device`; nr and ns at least 1.
int hash_join_run(const JoinArgs* a) {
  if (a->bits < 1 || a->bits > 15 || a->nr < 1 || a->ns < 1 ||
      (a->lo_bits != 0 && (a->bits <= a->lo_bits ||
                           a->bits - a->lo_bits > 7 || a->lo_bits > 8)) ||
      (a->lo_bits == 0 && a->bits > 8) || a->table < kMinTable ||
      (a->table & (a->table - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  return on_device(a->device, [&]() { return run(*a); });
}

}  // extern "C"
