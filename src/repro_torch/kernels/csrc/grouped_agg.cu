// Grouped scatter-add (RDMA-AGG's pre-aggregation, paper §5.3), for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/grouped_agg.py (grouped_agg,
// pallas_call at :47) and the jnp scatter-adds the JAX operators run in its
// place (core/aggregation.py: segment_sum_by_key, preagg_table and
// RDMA-AGG's (chunks, n, gsz) partition table).  One templated body per
// pass, instantiated for
//
//   f32 values, slot array   table[s] = sum of vals[i] over slot[i] == s:
//                            the TPU kernel's own function (a one-hot
//                            matmul there);
//   u32 values, slot array   the same with a wrapping add: the JAX
//                            package's "uint64" sums are u32 with x64 off;
//   u32 values, u32 keys     the slot computed in registers from the key:
//                            s = key % G, then RDMA-AGG's phase-1 layout
//                            (c*n + min(s / gsz, n - 1))*gsz + s % gsz for
//                            row i of chunk c (chunk boundaries every clen
//                            rows); with chunks = n = 1 the slot is s.  The
//                            divisions are multiply-high by a magic number
//                            (Granlund-Montgomery) computed by the wrapper.
//
// A slot outside [0, S) is skipped: nothing is written out of bounds.  The
// wrapper picks one of three paths for the table size (its plan(), plain
// Python):
//
//   shared     S*4 B fits shared memory.  Blocks stream rows with 16-byte
//              loads, two quads of rows in flight a thread, into `copies`
//              private tables per block (warp w adds into copy w % copies,
//              so a hot slot serialises a few warps, not the block), then
//              add each nonzero slot of their copies to the output with one
//              global atomic.  out is zeroed first (a memset of S*4 B).
//   global     the same stream with global atomics into the zeroed output:
//              for more than 2^28 slots or 2^31 rows, which the partition
//              path's bucket count and 32-bit row positions do not take.
//   partition  tables above shared memory, up to 2^28 slots: partition the
//              rows by bucket (2^bits slots, a table that fits shared
//              memory), then aggregate each bucket in shared memory.
//                part_hist     rows counted per bucket (shared histogram,
//                              one global atomic a bucket a block);
//                part_scan     one block: each bucket's first row, the
//                              batches' cursors, and its work items:
//                              ceil(rows / R) parts of at most R rows (1 for
//                              an empty bucket), so a hot bucket is split
//                              over several blocks;
//                part_scatter  a radix pass over tiles of 4096 rows into at
//                              most 128 digits: the bucket where there are
//                              at most 128 (S <= 2^22), else the super-
//                              bucket of 2^lo_bits buckets.  A tile is ranked
//                              per digit (shared atomics), staged in shared
//                              memory in digit order, and written as
//                              contiguous runs at cursors reserved with one
//                              atomic a digit a tile, while the next tile's
//                              loads are in flight.  8 B (slot, value)
//                              pairs.  The same blocks zero the output of
//                              every split bucket;
//                part_refine   the second radix pass, where there are two:
//                              each super-bucket's pairs into its buckets,
//                              in tiles that never straddle two supers;
//                part_agg      one block a work item: the item's rows into a
//                              shared table, then a bucket of one item
//                              stores its whole slot range (every slot
//                              written once, no memset) and a split bucket
//                              adds its nonzero slots atomically.
//              With two passes the rows run in two batches: each batch is
//              counted apart and gets its own cursors into one layout of
//              all the rows' pairs, the first pass reuses one batch's
//              scratch, and part_agg runs once.  The scratch is 12 B a row
//              (8 B with one pass), below the 16 B a row of the int64 slot
//              arrays the keys entry replaces.  Passes have at most 128
//              digits because one pass into thousands of buckets leaves a
//              few rows a bucket a tile, so each 8 B pair takes a sector of
//              its own (5.5 ms at N = 128M on an H100, against 1.0 ms for
//              the same pass into 8 buckets).
//
// Lanes of a warp that hold lane 0's slot add their sum with one atomic
// (__reduce_add_sync for u32, a shuffle tree for f32); every other lane adds
// its own.  So one hot slot (G = 1, a skewed key) costs one atomic a warp.
//
// Bound: bytes.  Each row is read once (4 B slot or key + 4 B value) and the
// table written once: 8N + 4S.  The shared and global paths move that plus
// the memset; the partition path 4N (hist) + 16N a radix pass + 8N (agg) +
// 4S: 28N + 4S with one pass, 44N + 4S with two.  f32 sums are added in an
// order that changes from run to run; u32 sums are exact in any order.
#include <cuda_runtime.h>
#include <stdint.h>

// What one call runs, as the wrapper's plan() and the caller give it.  At
// namespace scope: the C entry points take it, and a type of the anonymous
// namespace would give them internal linkage.
struct AggArgs {
  const void* x;            // slot (N,) int32, or u32 keys as int32
  const void* vals;         // (N,) f32 or u32 words
  long long N;
  int S;                    // table slots
  int kind;                 // 0 slot array, 1 u32 keys
  unsigned g_d, g_m;        // FastDiv of G (kind 1)
  int g_sh;
  unsigned z_d, z_m;        // FastDiv of gsz (kind 1)
  int z_sh;
  int n, chunks;            // owners and chunks (kind 1)
  long long clen;           // rows a chunk (kind 1)
  int path;                 // 0 shared, 1 global, 2 partition
  int copies;               // shared: table copies a block
  int bits;                 // partition: log2 slots a bucket
  int lo_bits;              // partition: log2 buckets a super-bucket of
                            // the first of two radix passes (0: one pass)
  int rows_per_part;        // partition: most rows a work item
  long long batch;          // partition: rows a batch (at most 2 batches;
                            // tmp holds one)
  int grid;                 // blocks of the streaming passes
  void* meta;               // partition: Meta's ints
  void* pairs;              // partition: (N,) int2
  void* tmp;                // partition, two passes: (batch,) int2
  void* out;                // (S,) f32 or u32
  int device;
  void* stream;
};

namespace {

constexpr int kThreads = 512;
constexpr int kUnroll = 2;                 // quads of rows in flight a thread
constexpr int kTileRows = 8;               // rows a thread a scatter tile
constexpr int kTile = kThreads * kTileRows;  // rows a scatter tile
constexpr int kMaxDigits = 128;            // buckets of one radix pass
constexpr int kMaxBatches = 2;             // batches of rows a call
constexpr int kScanThreads = 1024;
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

// floor(x / d) for u32 x and 1 <= d < 2^31: with l = ceil(log2 d),
// m = floor(2^32 (2^l - d) / d) + 1 and sh = l - 1, t = mulhi(m, x) and
// q = (t + ((x - t) >> 1)) >> sh.  d == 1 takes q = x.
struct FastDiv {
  unsigned d, m;
  int sh;
};

__device__ __forceinline__ unsigned udiv(unsigned x, const FastDiv& f) {
  if (f.d == 1u) return x;
  const unsigned t = __umulhi(x, f.m);
  return (t + ((x - t) >> 1)) >> f.sh;
}

// The slot of row i (counted from the batch's first row, row0 rows into
// the call) from the int32 the caller gave; -1 skips the row.
struct SlotArray {
  int S;
  long long row0;
  __device__ __forceinline__ int operator()(int x, long long) const {
    return (unsigned)x < (unsigned)S ? x : -1;
  }
};

// (c*n + min(s / gsz, n - 1))*gsz + s % gsz = c*csz + (the slot in the
// chunk's table), csz = n*gsz; with n = 1 the slot in the table is s.
struct SlotKey {
  FastDiv g, gsz;
  int n, chunks;
  unsigned csz;                            // slots a chunk's tables
  long long clen;                          // rows a chunk
  long long row0;
  __device__ __forceinline__ int operator()(int x, long long i) const {
    const unsigned k = (unsigned)x;
    unsigned s = k - udiv(k, g) * g.d;
    if (n > 1) {
      const unsigned q = udiv(s, gsz);
      const unsigned owner = q < (unsigned)(n - 1) ? q : (unsigned)(n - 1);
      s = owner * gsz.d + (s - q * gsz.d);
    }
    if (chunks > 1) {
      const long long r = row0 + i;
      unsigned c = 0;
      for (long long end = clen; c + 1 < (unsigned)chunks && r >= end;
           end += clen)
        ++c;
      s += c * csz;
    }
    return (int)s;
  }
};

template <typename T>
__device__ __forceinline__ T from_bits(int b);
template <>
__device__ __forceinline__ float from_bits<float>(int b) {
  return __int_as_float(b);
}
template <>
__device__ __forceinline__ unsigned from_bits<unsigned>(int b) {
  return (unsigned)b;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v);
template <>
__device__ __forceinline__ unsigned warp_sum<unsigned>(unsigned v) {
  return __reduce_add_sync(kFull, v);
}
template <>
__device__ __forceinline__ float warp_sum<float>(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// tab[s] += v for every lane with s >= 0.  The lanes that hold lane 0's
// slot add their sum with one atomic when there are two or more of them;
// every other lane adds its own.  Every lane of the warp calls it.
template <typename T>
__device__ __forceinline__ void warp_add(T* tab, int s, T v) {
  const int s0 = __shfl_sync(kFull, s, 0);
  const bool same = s == s0;
  const unsigned m = __ballot_sync(kFull, same);
  if (s0 >= 0 && __popc(m) > 1) {
    const T sum = warp_sum<T>(same ? v : T(0));
    if ((threadIdx.x & 31) == 0) atomicAdd(&tab[s0], sum);
    if (!same && s >= 0) atomicAdd(&tab[s], v);
  } else if (s >= 0) {
    atomicAdd(&tab[s], v);
  }
}

// rows 4q .. 4q+3 of x (and of v when kVals): 16-byte loads where both
// arrays are 16-byte aligned and the quad is whole, else one at a time.
template <bool kVals>
__device__ __forceinline__ void load_quad(const int* __restrict__ x,
                                          const int* __restrict__ v,
                                          long long N, long long q, bool vec,
                                          int kx[4], int vx[4]) {
  const long long i = q * 4;
  if (vec && i + 4 <= N) {
    const int4 a = __ldcs(reinterpret_cast<const int4*>(x) + q);
    kx[0] = a.x; kx[1] = a.y; kx[2] = a.z; kx[3] = a.w;
    if (kVals) {
      const int4 b = __ldcs(reinterpret_cast<const int4*>(v) + q);
      vx[0] = b.x; vx[1] = b.y; vx[2] = b.z; vx[3] = b.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      kx[e] = i + e < N ? x[i + e] : 0;
      if (kVals) vx[e] = i + e < N ? v[i + e] : 0;
    }
  }
}

// The shared and global paths: rows streamed by a grid of persistent
// blocks into `copies` tables in shared memory (kShared) or into out.
template <typename T, class Slot, bool kShared>
__global__ void __launch_bounds__(kThreads, 2)
agg_kernel(const int* __restrict__ x, const int* __restrict__ vals,
           long long N, Slot f, int S, int copies, bool vec,
           T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* tab = reinterpret_cast<T*>(smem);
  if (kShared) {
    for (int k = threadIdx.x; k < copies * S; k += blockDim.x) tab[k] = T(0);
    __syncthreads();
  }
  T* dst = kShared ? tab + (size_t)((threadIdx.x >> 5) % copies) * S : out;
  const int lane = threadIdx.x & 31;
  const long long nq = (N + 3) >> 2;
  const long long stride = (long long)gridDim.x * blockDim.x * kUnroll;
  // q0 - lane is the warp's first quad, so the loop is uniform per warp
  for (long long q0 = (long long)blockIdx.x * blockDim.x * kUnroll +
                      threadIdx.x;
       q0 - lane < nq; q0 += stride) {
    int kx[kUnroll][4], vx[kUnroll][4];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      load_quad<true>(x, vals, N, q0 + (long long)u * blockDim.x, vec, kx[u],
                      vx[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long row = (q0 + (long long)u * blockDim.x) * 4 + e;
        const int s = row < N ? f(kx[u][e], row) : -1;
        warp_add<T>(dst, s, from_bits<T>(vx[u][e]));
      }
    }
  }
  if (kShared) {
    __syncthreads();
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      T t = T(0);
      for (int c = 0; c < copies; ++c) t += tab[(size_t)c * S + s];
      if (t != T(0)) atomicAdd(&out[s], t);
    }
  }
}

// meta, ints, for K batches of rows: counts (K nb: each batch's rows a
// bucket) | total (nb) | start (nb) | cursor (K nb: where each batch's
// pairs of a bucket go) | item (nb + 1) | split (nb) | nsplit (1) | then
// per batch and super-bucket of the first of two radix passes: scur
// (K kMaxDigits) | sstart (K (kMaxDigits + 1)) | tstart (K (kMaxDigits +
// 1)).  counts is zeroed before part_hist; part_scan writes the rest.
// (2 K + 4) nb + 2 + 386 K ints in all.
struct Meta {
  int *counts, *total, *start, *cursor, *item, *split, *nsplit, *scur,
      *sstart, *tstart;
  __host__ __device__ Meta(int* m, int nb, int K)
      : counts(m), total(m + K * nb), start(total + nb), cursor(start + nb),
        item(cursor + K * nb), split(item + nb + 1), nsplit(split + nb),
        scur(nsplit + 1), sstart(scur + K * kMaxDigits),
        tstart(sstart + K * (kMaxDigits + 1)) {}
};

template <class Slot>
__global__ void __launch_bounds__(kThreads, 2)
part_hist(const int* __restrict__ x, long long N, Slot f, int bits, int nb,
          bool vec, int* __restrict__ counts) {
  extern __shared__ int h[];
  for (int k = threadIdx.x; k < nb; k += blockDim.x) h[k] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long nq = (N + 3) >> 2;
  const long long stride = (long long)gridDim.x * blockDim.x * kUnroll;
  for (long long q0 = (long long)blockIdx.x * blockDim.x * kUnroll +
                      threadIdx.x;
       q0 - lane < nq; q0 += stride) {
    int kx[kUnroll][4], unused[4];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      load_quad<false>(x, nullptr, N, q0 + (long long)u * blockDim.x, vec,
                       kx[u], unused);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long row = (q0 + (long long)u * blockDim.x) * 4 + e;
        const int s = row < N ? f(kx[u][e], row) : -1;
        warp_add<unsigned>(reinterpret_cast<unsigned*>(h),
                           s >= 0 ? s >> bits : -1, 1u);
      }
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < nb; k += blockDim.x)
    if (h[k] != 0) atomicAdd(&counts[k], h[k]);
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

// exclusive block-wide sum of v in thread order; total in *total.  Every
// thread of the block calls it; wsum holds kScanThreads / 32 ints.
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

// One block: total = the batches' counts summed, start = its exclusive
// scan, each batch's cursor (start + the rows of the batches before it),
// the work items of each bucket (max(1, ceil(rows / rpp)) parts; item =
// exclusive scan, item[nb] their total) and the list of split buckets.
// Each thread takes a contiguous run of buckets.  With two radix passes
// (lo_bits > 0), also each batch's super-buckets: their first row in the
// first pass's scratch, a cursor, and the second pass's tiles.
__global__ void __launch_bounds__(kScanThreads)
part_scan(int nb, int K, int rpp, int lo_bits, int* __restrict__ meta) {
  __shared__ int wsum[kScanThreads / 32];
  Meta m(meta, nb, K);
  const int per = (nb + blockDim.x - 1) / blockDim.x;
  const int lo = min((int)threadIdx.x * per, nb);
  const int hi = min(lo + per, nb);
  int rows = 0, items = 0, splits = 0;
  for (int b = lo; b < hi; ++b) {
    int c = 0;
    for (int k = 0; k < K; ++k) c += m.counts[k * nb + b];
    m.total[b] = c;
    const int p = c > rpp ? (int)(((long long)c + rpp - 1) / rpp) : 1;
    rows += c;
    items += p;
    splits += p > 1;
  }
  int total;
  int r = block_scan(rows, wsum, &total);
  int it = block_scan(items, wsum, &total);
  if (threadIdx.x == 0) m.item[nb] = total;
  int sp = block_scan(splits, wsum, &total);
  if (threadIdx.x == 0) *m.nsplit = total;
  for (int b = lo; b < hi; ++b) {
    const int c = m.total[b];
    const int p = c > rpp ? (int)(((long long)c + rpp - 1) / rpp) : 1;
    m.start[b] = r;
    int cur = r;
    for (int k = 0; k < K; ++k) {
      m.cursor[k * nb + b] = cur;
      cur += m.counts[k * nb + b];
    }
    m.item[b] = it;
    if (p > 1) m.split[sp++] = b;
    r += c;
    it += p;
  }
  if (lo_bits == 0) return;
  const int nsup = (nb + (1 << lo_bits) - 1) >> lo_bits;
  const int u = threadIdx.x;                   // nsup <= kMaxDigits threads
  for (int k = 0; k < K; ++k) {
    int mine = 0;
    if (u < nsup)
      for (int b = u << lo_bits; b < min((u + 1) << lo_bits, nb); ++b)
        mine += m.counts[k * nb + b];
    int rows_all, tiles_all;
    const int s0 = block_scan(mine, wsum, &rows_all);
    const int tiles = (mine + kTile - 1) / kTile;
    const int t0 = block_scan(tiles, wsum, &tiles_all);
    int* sstart = m.sstart + k * (kMaxDigits + 1);
    int* tstart = m.tstart + k * (kMaxDigits + 1);
    if (u < nsup) {
      m.scur[k * kMaxDigits + u] = s0;
      sstart[u] = s0;
      tstart[u] = t0;
    }
    if (u == 0) {
      sstart[nsup] = rows_all;
      tstart[nsup] = tiles_all;
    }
  }
}

// One tile of a radix pass: each thread holds kTileRows rows as (slot a,
// value v), a = -1 for a row to skip; a row's digit is (a >> dshift) &
// dmask < nd <= kMaxDigits.  The rows are ranked per digit (shared
// atomics; lanes that hold lane 0's digit take consecutive ranks from
// one), the pairs are staged in shared memory in digit order while each
// digit's run is reserved in the global cursors cur[d] (one atomic a digit
// a tile), and written out as contiguous runs: (a & amask, v) at cur's
// reservation.  Every thread of the block calls it; lh is zero on entry
// and on return.
__device__ __forceinline__ void tile_scatter(
    const int (&a)[kTileRows], const int (&v)[kTileRows], int nd, int dshift,
    int dmask, int amask, int* __restrict__ cur, int2* __restrict__ dst,
    int* lh, int* lstart, int* gbase, int2* stage) {
  const int lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  int r[kTileRows];
#pragma unroll
  for (int k = 0; k < kTileRows; ++k) {
    const int d = a[k] >= 0 ? (a[k] >> dshift) & dmask : -1;
    const int d0 = __shfl_sync(kFull, d, 0);
    const bool same = d == d0;
    const unsigned mm = __ballot_sync(kFull, same);
    int rk = 0;
    if (d0 >= 0 && __popc(mm) > 1) {
      int base = 0;
      if (lane == 0) base = atomicAdd(&lh[d0], __popc(mm));
      base = __shfl_sync(kFull, base, 0);
      if (same) rk = base + __popc(mm & lt);
      else if (d >= 0) rk = atomicAdd(&lh[d], 1);
    } else if (d >= 0) {
      rk = atomicAdd(&lh[d], 1);
    }
    r[k] = rk;
  }
  __syncthreads();
  // warp 0: exclusive scan of lh (4 digits a lane) into lstart, the
  // tile's total in lstart[kMaxDigits]
  if (threadIdx.x < 32) {
    const int lane4 = 4 * lane;
    int c[4], sum = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      c[k] = lane4 + k < nd ? lh[lane4 + k] : 0;
      sum += c[k];
    }
    int run = warp_scan(sum, lane) - sum;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (lane4 + k < nd) lstart[lane4 + k] = run;
      run += c[k];
    }
    if (lane == 31) lstart[kMaxDigits] = run;
  }
  __syncthreads();
  // threads < nd reserve their digit's run while the block stages
  if (threadIdx.x < nd) {
    const int c = lh[threadIdx.x];
    if (c > 0) gbase[threadIdx.x] = atomicAdd(&cur[threadIdx.x], c);
    lh[threadIdx.x] = 0;
  }
#pragma unroll
  for (int k = 0; k < kTileRows; ++k)
    if (a[k] >= 0)
      stage[lstart[(a[k] >> dshift) & dmask] + r[k]] = make_int2(a[k], v[k]);
  __syncthreads();
  const int total = lstart[kMaxDigits];
  for (int j = threadIdx.x; j < total; j += blockDim.x) {
    const int2 p = stage[j];
    const int dd = (p.x >> dshift) & dmask;
    dst[gbase[dd] + (j - lstart[dd])] = make_int2(p.x & amask, p.y);
  }
  __syncthreads();
}

// Shared memory of a radix pass: lh, lstart, gbase, then the stage.
constexpr size_t kScatterSmem =
    (3 * kMaxDigits + 4) * sizeof(int) + kTile * sizeof(int2);

// rows 4q .. 4q+3 of each of the thread's kTileRows / 4 quads of tile t
__device__ __forceinline__ void load_tile(const int* __restrict__ x,
                                          const int* __restrict__ vals,
                                          long long N, long long t, bool vec,
                                          int (&kx)[kTileRows],
                                          int (&vx)[kTileRows]) {
#pragma unroll
  for (int j = 0; j < kTileRows / 4; ++j)
    load_quad<true>(x, vals, N,
                    t * (kTile / 4) + (long long)j * blockDim.x + threadIdx.x,
                    vec, kx + 4 * j, vx + 4 * j);
}

// The first radix pass, over the rows: digit s >> dshift (the bucket with
// one pass, the super-bucket with two), pairs (s & amask, value) into
// `dst` at the cursors `cur`.  The next tile's loads are issued before a
// tile is ranked and written.  Then the output of every split bucket is
// zeroed (part_agg adds into it).
template <class Slot>
__global__ void __launch_bounds__(kThreads, 2)
part_scatter(const int* __restrict__ x, const int* __restrict__ vals,
             long long N, Slot f, int nd, int dshift, int amask, bool vec,
             int bits, int nb, int K, int S, bool zero_split,
             int* __restrict__ meta, int* __restrict__ cur,
             int2* __restrict__ dst, int* __restrict__ out) {
  extern __shared__ __align__(16) int sh[];
  int* lh = sh;
  int* lstart = lh + kMaxDigits;             // kMaxDigits + 1
  int* gbase = lstart + kMaxDigits + 1;
  int2* stage = reinterpret_cast<int2*>(sh + 3 * kMaxDigits + 4);
  for (int k = threadIdx.x; k < kMaxDigits; k += blockDim.x) lh[k] = 0;
  __syncthreads();
  const long long ntiles = (N + kTile - 1) / kTile;
  int kx[kTileRows], vx[kTileRows];
  if (blockIdx.x < ntiles) load_tile(x, vals, N, blockIdx.x, vec, kx, vx);
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    int a[kTileRows], v[kTileRows];
#pragma unroll
    for (int j = 0; j < kTileRows / 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long row =
            (t * (kTile / 4) + (long long)j * blockDim.x + threadIdx.x) * 4 +
            e;
        a[4 * j + e] = row < N ? f(kx[4 * j + e], row) : -1;
        v[4 * j + e] = vx[4 * j + e];
      }
    if (t + gridDim.x < ntiles)
      load_tile(x, vals, N, t + gridDim.x, vec, kx, vx);
    tile_scatter(a, v, nd, dshift, 0x7fffffff, amask, cur, dst, lh, lstart,
                 gbase, stage);
  }
  Meta m(meta, nb, K);
  const int nsplit = zero_split ? *m.nsplit : 0;
  for (int k = blockIdx.x; k < nsplit; k += gridDim.x) {
    const long long lo = (long long)m.split[k] << bits;
    const long long hi = lo + (1LL << bits) < S ? lo + (1LL << bits) : S;
    for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) out[i] = 0;
  }
}

// The tile t of a batch's second pass: its super-bucket u (the last with
// tstart[u] <= t) and its rows [r0, r1) of the first pass's pairs.
__device__ __forceinline__ void refine_tile(const int* __restrict__ sstart,
                                            const int* __restrict__ tstart,
                                            int nsup, int t, int& u,
                                            long long& r0, long long& r1) {
  int lo = 0, hi = nsup - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tstart[mid] <= t) lo = mid; else hi = mid - 1;
  }
  u = lo;
  r0 = sstart[u] + (long long)(t - tstart[u]) * kTile;
  r1 = r0 + kTile < sstart[u + 1] ? r0 + kTile : sstart[u + 1];
}

// The second radix pass over one batch: the first pass's pairs, super-
// bucket by super-bucket in tiles that never straddle two (sstart,
// tstart), each into its 2^lo_bits buckets: digit (s >> bits) &
// (2^lo_bits - 1), pairs (s & (2^bits - 1), value) into `dst` at the
// batch's bucket cursors `cur`.  The next tile's loads are issued before
// a tile is ranked and written.
__global__ void __launch_bounds__(kThreads, 2)
part_refine(const int2* __restrict__ src, int nb, int bits, int lo_bits,
            const int* __restrict__ sstart, const int* __restrict__ tstart,
            int* __restrict__ cur, int2* __restrict__ dst) {
  extern __shared__ __align__(16) int sh[];
  int* lh = sh;
  int* lstart = lh + kMaxDigits;             // kMaxDigits + 1
  int* gbase = lstart + kMaxDigits + 1;
  int2* stage = reinterpret_cast<int2*>(sh + 3 * kMaxDigits + 4);
  for (int k = threadIdx.x; k < kMaxDigits; k += blockDim.x) lh[k] = 0;
  __syncthreads();
  const int nsup = (nb + (1 << lo_bits) - 1) >> lo_bits;
  const int ntiles = tstart[nsup];
  const int nd = 1 << lo_bits;
  int u;
  long long r0, r1;
  int2 p[kTileRows];
  if ((int)blockIdx.x < ntiles) {
    refine_tile(sstart, tstart, nsup, blockIdx.x, u, r0, r1);
#pragma unroll
    for (int k = 0; k < kTileRows; ++k) {
      const long long i = r0 + (long long)k * blockDim.x + threadIdx.x;
      p[k] = i < r1 ? __ldcs(src + i) : make_int2(-1, 0);
    }
  }
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    int a[kTileRows], v[kTileRows];
#pragma unroll
    for (int k = 0; k < kTileRows; ++k) {
      a[k] = p[k].x;
      v[k] = p[k].y;
    }
    int* c = cur + (u << lo_bits);
    if (t + (int)gridDim.x < ntiles) {
      refine_tile(sstart, tstart, nsup, t + gridDim.x, u, r0, r1);
#pragma unroll
      for (int k = 0; k < kTileRows; ++k) {
        const long long i = r0 + (long long)k * blockDim.x + threadIdx.x;
        p[k] = i < r1 ? __ldcs(src + i) : make_int2(-1, 0);
      }
    }
    tile_scatter(a, v, nd, bits, nd - 1, (1 << bits) - 1, c, dst, lh, lstart,
                 gbase, stage);
  }
}

// One block a work item: its rows' pairs into a shared table of the
// bucket's slots, then out.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
part_agg(const int2* __restrict__ pairs, const int* __restrict__ meta,
         int nb, int K, int bits, int S, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* tab = reinterpret_cast<T*>(smem);
  Meta m(const_cast<int*>(meta), nb, K);
  const int j = blockIdx.x;
  if (j >= m.item[nb]) return;                 // uniform across the block
  int lo = 0, hi = nb - 1;                     // last b with item[b] <= j
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (m.item[mid] <= j) lo = mid; else hi = mid - 1;
  }
  const int b = lo;
  const int parts = m.item[b + 1] - m.item[b];
  const int part = j - m.item[b];
  const int c = m.total[b];
  const int per = (int)(((long long)c + parts - 1) / parts);
  const long long r0 = (long long)m.start[b] + (long long)part * per;
  long long r1 = r0 + per;
  if (r1 > (long long)m.start[b] + c) r1 = (long long)m.start[b] + c;
  const long long base = (long long)b << bits;
  const int W = (int)(base + (1LL << bits) <= S ? (1LL << bits) : S - base);
  for (int k = threadIdx.x; k < W; k += blockDim.x) tab[k] = T(0);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)blockDim.x * 4;
  for (long long i0 = r0 + threadIdx.x; i0 - lane < r1; i0 += stride) {
    int2 p[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const long long i = i0 + (long long)u * blockDim.x;
      p[u] = i < r1 ? __ldcs(pairs + i) : make_int2(-1, 0);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) warp_add<T>(tab, p[u].x, from_bits<T>(p[u].y));
  }
  __syncthreads();
  if (parts == 1) {
    for (int k = threadIdx.x; k < W; k += blockDim.x) out[base + k] = tab[k];
  } else {
    for (int k = threadIdx.x; k < W; k += blockDim.x)
      if (tab[k] != T(0)) atomicAdd(&out[base + k], tab[k]);
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

// the device's attributes, and every kernel allowed all of a block's
// shared memory, once per device
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
  if (e == cudaSuccess) e = allow_smem(agg_kernel<float, SlotArray, true>, b);
  if (e == cudaSuccess)
    e = allow_smem(agg_kernel<unsigned, SlotArray, true>, b);
  if (e == cudaSuccess) e = allow_smem(agg_kernel<unsigned, SlotKey, true>, b);
  if (e == cudaSuccess) e = allow_smem(part_hist<SlotArray>, b);
  if (e == cudaSuccess) e = allow_smem(part_hist<SlotKey>, b);
  if (e == cudaSuccess) e = allow_smem(part_scatter<SlotArray>, b);
  if (e == cudaSuccess) e = allow_smem(part_scatter<SlotKey>, b);
  if (e == cudaSuccess) e = allow_smem(part_refine, b);
  if (e == cudaSuccess) e = allow_smem(part_agg<float>, b);
  if (e == cudaSuccess) e = allow_smem(part_agg<unsigned>, b);
  if (e == cudaSuccess) g_ready[device] = true;
  return e;
}

template <typename T, class Slot>
cudaError_t run(const AggArgs& a, const Slot& f) {
  cudaStream_t st = (cudaStream_t)a.stream;
  const bool vec = (((uintptr_t)a.x | (uintptr_t)a.vals) & 15u) == 0;
  const int* x = (const int*)a.x;
  const int* v = (const int*)a.vals;
  T* out = (T*)a.out;
  if (a.path != 2) {
    cudaError_t e = cudaMemsetAsync(out, 0, (size_t)a.S * sizeof(T), st);
    if (e != cudaSuccess || a.N <= 0) return e;
    if (a.path == 0)
      agg_kernel<T, Slot, true><<<a.grid, kThreads,
                                  (size_t)a.copies * a.S * sizeof(T), st>>>(
          x, v, a.N, f, a.S, a.copies, vec, out);
    else
      agg_kernel<T, Slot, false><<<a.grid, kThreads, 0, st>>>(
          x, v, a.N, f, a.S, 1, vec, out);
    return cudaGetLastError();
  }
  // rows in K batches of a.batch rows: part_hist counts each batch apart,
  // part_scan gives each batch its own cursors into one layout of all the
  // rows' pairs, and the first of two radix passes reuses one batch's
  // scratch (a.tmp); part_agg then runs once over all the pairs
  const int nb = (int)(((long long)a.S + (1LL << a.bits) - 1) >> a.bits);
  const int K = (int)((a.N + a.batch - 1) / a.batch) > 1
                    ? (int)((a.N + a.batch - 1) / a.batch) : 1;
  if (K > kMaxBatches) return cudaErrorInvalidValue;
  int* meta = (int*)a.meta;
  const Meta m(meta, nb, K);
  const int mask = (1 << a.bits) - 1;
  cudaError_t e = cudaMemsetAsync(meta, 0, (size_t)K * nb * sizeof(int), st);
  for (int k = 0; k < K && e == cudaSuccess; ++k) {
    const long long r0 = k * a.batch;
    const long long n = a.N - r0 < a.batch ? a.N - r0 : a.batch;
    if (n <= 0) continue;
    Slot fb = f;
    fb.row0 = r0;
    part_hist<Slot><<<a.grid, kThreads, (size_t)nb * sizeof(int), st>>>(
        x + r0, n, fb, a.bits, nb, vec && r0 % 4 == 0, m.counts + k * nb);
    e = cudaGetLastError();
  }
  if (e != cudaSuccess) return e;
  part_scan<<<1, kScanThreads, 0, st>>>(nb, K, a.rows_per_part, a.lo_bits,
                                         meta);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  for (int k = 0; k < K; ++k) {
    const long long r0 = k * a.batch;
    const long long n = a.N - r0 < a.batch ? a.N - r0 : a.batch;
    const int* xb = x + r0;
    const int* vb = v + r0;
    const bool bvec = vec && r0 % 4 == 0;
    Slot fb = f;
    fb.row0 = r0;
    if (a.lo_bits == 0) {                      // one pass: digit = bucket
      part_scatter<Slot><<<a.grid, kThreads, kScatterSmem, st>>>(
          xb, vb, n, fb, nb, a.bits, mask, bvec, a.bits, nb, K, a.S, k == 0,
          meta, m.cursor + k * nb, (int2*)a.pairs, (int*)out);
    } else {                                   // super-buckets, then buckets
      const int nsup = (nb + (1 << a.lo_bits) - 1) >> a.lo_bits;
      part_scatter<Slot><<<a.grid, kThreads, kScatterSmem, st>>>(
          xb, vb, n, fb, nsup, a.bits + a.lo_bits, 0x7fffffff, bvec, a.bits,
          nb, K, a.S, k == 0, meta, m.scur + k * kMaxDigits, (int2*)a.tmp,
          (int*)out);
      if ((e = cudaGetLastError()) != cudaSuccess) return e;
      part_refine<<<a.grid, kThreads, kScatterSmem, st>>>(
          (const int2*)a.tmp, nb, a.bits, a.lo_bits,
          m.sstart + k * (kMaxDigits + 1), m.tstart + k * (kMaxDigits + 1),
          m.cursor + k * nb, (int2*)a.pairs);
    }
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  const long long items = nb + a.N / a.rows_per_part;
  const long long W = (1LL << a.bits) < a.S ? (1LL << a.bits) : a.S;
  part_agg<T><<<(unsigned)items, kThreads, (size_t)W * sizeof(T), st>>>(
      (const int2*)a.pairs, meta, nb, K, a.bits, a.S, out);
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
// wrapper's plan() sizes grids and tables by.  Cached per device.
int grouped_agg_device_info(int device, int* info) {
  return on_device(device, [&]() {
    info[0] = g_sms[device];
    info[1] = g_smem_block[device];
    info[2] = g_smem_sm[device];
    return cudaSuccess;
  });
}

// dtype 0: f32 values (slot array only); 1: u32 words.  Launches on
// `stream` of `device`.
int grouped_agg_run(const AggArgs* a, int dtype) {
  return on_device(a->device, [&]() {
    if (a->kind == 0) {
      const SlotArray f{a->S, 0};
      return dtype == 0 ? run<float>(*a, f) : run<unsigned>(*a, f);
    }
    if (dtype != 1) return cudaErrorInvalidValue;
    const SlotKey f{FastDiv{a->g_d, a->g_m, a->g_sh},
                    FastDiv{a->z_d, a->z_m, a->z_sh}, a->n, a->chunks,
                    (unsigned)a->n * a->z_d, a->clen, 0};
    return run<unsigned>(*a, f);
  });
}

}  // extern "C"
