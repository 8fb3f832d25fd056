// Radix partitioner into software-managed buffers, for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/radix_partition.py
// (radix_partition, pallas_call at :72) and the jnp twin the JAX commit path
// runs instead of it (plan_route + _scatter_rows, src/repro/fabric/router.py).
// Two entry points, so a routed commit runs both on every round:
//
//   radix_rank     dest (A,) -> slot, keep, overflow (A,), counts (n,):
//                  the stable arrival-order rank of each request in its
//                  bucket (plan_route).  Three launches:
//                    1. per-block bucket histograms (shared-memory atomics:
//                       counts do not depend on order), stored bucket-major
//                       (n, nblocks) so each bucket's column is contiguous;
//                    2. an exclusive scan over blocks, one block a bucket:
//                       each thread sums a contiguous run of the column, a
//                       block scan (warp shuffles, then the warps' totals)
//                       gives each run its offset, and each thread writes
//                       its run's offsets back;
//                    3. the rank inside a block: tiles of 256 requests in
//                       arrival order, warp ballots (__match_any_sync +
//                       __popc(peers & lanemask_lt)) for the rank inside a
//                       warp, per-warp counts in shared memory for the
//                       warps before it, and a running count per bucket for
//                       the tiles before it.  No atomic decides a rank, so
//                       the rank is stable.
//                  dest < 0 or dest >= n is filtered: no rank, not a drop.
//   radix_scatter  rows (A, w), slot (A,) and counts (n,) from radix_rank,
//                  optional mask -> the (n*cap, w + 1) wire buffer with
//                  each kept, unmasked row in its slot and a ones valid
//                  lane after it (the Pallas kernel's fuse_valid form),
//                  zeros elsewhere.  One launch: row blocks, then tail
//                  blocks that zero each bucket's empty slots (below).
//
// Bound: bytes.  The rank reads 4 B and writes 6 B per request; the scatter
// reads each kept row, slot and mask once and writes the buffer once.  The
// rank's scan over blocks moves 8 B per (bucket, block of 4096 requests),
// little beside the rank's 10 B a request at small n; at a join (A = 128M,
// 31 250 blocks) one bucket's blocks are split among 1024 threads, not
// walked by one.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTiles = 16;                    // tiles of kThreads per block
constexpr int kItems = kThreads * kTiles;     // requests ranked per block
constexpr int kScanThreads = 1024;            // most threads a bucket's scan
constexpr unsigned kFull = 0xffffffffu;

__global__ void hist_kernel(const int* __restrict__ dest, long long A, int n,
                            int* __restrict__ hist) {
  extern __shared__ int sh[];
  for (int d = threadIdx.x; d < n; d += blockDim.x) sh[d] = 0;
  __syncthreads();
  const long long base = (long long)blockIdx.x * kItems;
  const long long end = base + kItems < A ? base + kItems : A;
  for (long long i = base + threadIdx.x; i < end; i += blockDim.x) {
    const int d = dest[i];
    if (d >= 0 && d < n) atomicAdd(&sh[d], 1);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < n; d += blockDim.x)
    hist[(long long)d * gridDim.x + blockIdx.x] = sh[d];
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

// hist (n, nblocks) -> exclusive per-bucket offsets over blocks, in place;
// counts[d] = min(total of bucket d, cap).  Block d scans bucket d's
// column; blockDim.x is a multiple of 32.
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(int* __restrict__ hist, int nblocks, int cap,
            int* __restrict__ counts) {
  __shared__ int wsum[kScanThreads / 32];
  int* col = hist + (long long)blockIdx.x * nblocks;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int per = (nblocks + blockDim.x - 1) / blockDim.x;
  const int lo = min((int)threadIdx.x * per, nblocks);
  const int hi = min(lo + per, nblocks);
  int run = 0;
  for (int k = lo; k < hi; ++k) run += col[k];
  const int incl = warp_scan(run, lane);
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = warp_scan(lane < nw ? wsum[lane] : 0, lane);
    if (lane < nw) wsum[lane] = w;
  }
  __syncthreads();
  int acc = incl - run + (warp > 0 ? wsum[warp - 1] : 0);
  for (int k = lo; k < hi; ++k) {
    const int c = col[k];
    col[k] = acc;
    acc += c;
  }
  if (threadIdx.x == 0) {
    const int total = wsum[nw - 1];
    counts[blockIdx.x] = total < cap ? total : cap;
  }
}

__global__ void rank_kernel(const int* __restrict__ dest, long long A, int n,
                            int cap, const int* __restrict__ offs,
                            int* __restrict__ slot, uint8_t* __restrict__ keep,
                            uint8_t* __restrict__ overflow) {
  extern __shared__ int sh[];
  int* running = sh;          // (n,)  requests of this block ranked so far
  int* wcnt = sh + n;         // (kWarps, n)  this tile's per-warp counts
  for (int k = threadIdx.x; k < n; k += blockDim.x)
    running[k] = offs[(long long)k * gridDim.x + blockIdx.x];
  for (int k = threadIdx.x; k < kWarps * n; k += blockDim.x) wcnt[k] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const long long base = (long long)blockIdx.x * kItems;
  for (int t = 0; t < kTiles; ++t) {
    const long long tile = base + (long long)t * kThreads;
    if (tile >= A) break;                     // uniform across the block
    const long long i = tile + threadIdx.x;
    const bool in = i < A;
    const int d = in ? dest[i] : -1;
    const bool ok = in && d >= 0 && d < n;
    const unsigned peers = __match_any_sync(0xffffffffu, ok ? d : -1);
    const int before = __popc(peers & lt);
    const bool leader = ok && before == 0;
    if (leader) wcnt[warp * n + d] = __popc(peers);
    __syncthreads();
    int r = 0;
    if (ok) {
      r = running[d] + before;
      for (int w = 0; w < warp; ++w) r += wcnt[w * n + d];
    }
    __syncthreads();
    if (leader) {
      atomicAdd(&running[d], __popc(peers));  // a count: order-free
      wcnt[warp * n + d] = 0;
    }
    __syncthreads();
    if (in) {
      const bool k = ok && r < cap;
      keep[i] = k;
      overflow[i] = ok && r >= cap;
      slot[i] = k ? d * cap + r : n * cap;
    }
  }
}

// ------------------------------------------------------------- scatter --
//
// The slots come from radix_rank, so in bucket d the slots
// [d*cap, d*cap + counts[d]) belong to one kept row each and the rest of
// the bucket is empty.  Every int of the buffer is written exactly once: by
// its row (the row's lanes and a valid lane of 1, or w + 1 zeros where the
// mask is clear) or by a tail block (zeros).  Nothing fills it first.

constexpr int kRowThreads = 256;
constexpr int kWideWarps = kRowThreads / 32;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// One thread: init the barrier, then bulk-copy `bytes` (a multiple of 16,
// both addresses 16-byte aligned) from global to shared memory; the bytes
// complete on the barrier.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// One thread: bulk-copy shared -> global and wait until shared memory has
// been read (the block may exit then).
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(dst), "r"(src), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// Tail block zb of nzb: zeros rows [d*cap + counts[d], (d+1)*cap) of every
// bucket d.  The whole 16-byte chunks of all tails, flattened in bucket
// order, are strided over the tail blocks' threads; the <= 3 ints at each
// end of a tail that share a chunk with a kept row or the next bucket are
// stored one int at a time by one thread.
__device__ void zero_tails(unsigned zb, unsigned nzb,
                           const int* __restrict__ counts, int n,
                           long long cap, int wo, int* __restrict__ out) {
  const long long step = (long long)nzb * blockDim.x;
  long long t = (long long)zb * blockDim.x + threadIdx.x;
  long long off = 0;            // chunks of the tails before bucket d
  int4* out4 = reinterpret_cast<int4*>(out);
  for (int d = 0; d < n; ++d) {
    const int c = counts[d];
    const long long kept = c < 0 ? 0 : (c > cap ? cap : c);
    const long long lo = ((long long)d * cap + kept) * wo;
    const long long hi = ((long long)d + 1) * cap * wo;
    if (lo >= hi) continue;
    const long long a = (lo + 3) >> 2, b = hi >> 2;   // whole chunks [a, b)
    if (zb == 0 && threadIdx.x == (unsigned)(d % kRowThreads)) {
      const long long head_end = a < b ? a << 2 : hi;
      for (long long k = lo; k < head_end; ++k) out[k] = 0;
      if (a < b)
        for (long long k = b << 2; k < hi; ++k) out[k] = 0;
    }
    const long long m = a < b ? b - a : 0;
    for (; t < off + m; t += step) out4[a + (t - off)] = make_int4(0, 0, 0, 0);
    off += m;
  }
}

// The tile's in-range slots over the block: ext = {min, max, count}.
// Every thread calls it with its own partials.
__device__ __forceinline__ void block_extent(int lo, int hi, int cnt,
                                             int* ext) {
  lo = __reduce_min_sync(kFull, lo);
  hi = __reduce_max_sync(kFull, hi);
  cnt = __reduce_add_sync(kFull, cnt);
  if (threadIdx.x == 0) {
    ext[0] = 0x7fffffff;
    ext[1] = -1;
    ext[2] = 0;
  }
  __syncthreads();
  if ((threadIdx.x & 31) == 0 && cnt > 0) {
    atomicMin(&ext[0], lo);
    atomicMax(&ext[1], hi);
    atomicAdd(&ext[2], cnt);
  }
  __syncthreads();
}

// Stores the block's run [g0, g1) of buffer ints, composed in `tile` from
// buffer int g0 & ~3 on (so 16-byte chunks of the buffer are 16-byte
// chunks of the tile): the <= 3 ints at each end one at a time, the chunks
// between with one bulk store.  Every thread calls it, after the tile is
// written, fenced for the async proxy and synchronised.
__device__ __forceinline__ void store_run(const int* tile, long long g0,
                                          long long g1,
                                          int* __restrict__ out) {
  const long long base = g0 & ~3ll;
  const long long a = (g0 + 3) >> 2, b = g1 >> 2;   // whole chunks [a, b)
  if (threadIdx.x == 0) {
    const long long head_end = a < b ? a << 2 : g1;
    for (long long g = g0; g < head_end; ++g) out[g] = tile[g - base];
  }
  if (a >= b) return;
  if (threadIdx.x == 32)
    for (long long g = b << 2; g < g1; ++g) out[g] = tile[g - base];
  if (threadIdx.x == 64)
    bulk_store(out + (a << 2), smem_addr(tile + ((a << 2) - base)),
               (uint32_t)((b - a) * 16));
}

// Narrow rows (w <= 7): a block takes TR consecutive rows, RPT a thread.
// One thread stages the tile's lanes with one cp.async.bulk load (the
// ragged last tile, or a misaligned input, loads them row by row), while
// each thread reads its rows' slots and masks once.  When the tile's
// in-range slots are one run [smin, smin + K) (every tile at n = 1: stable
// ranks are consecutive), the block composes the run's (w+1)-int rows in
// shared memory and stores them with one bulk store (store_run).  Other
// tiles store row by row.
template <int W>
struct Narrow {
  static constexpr int WO = W + 1;
  static constexpr int RPT = W <= 4 ? 4 : 2;
  static constexpr int TR = kRowThreads * RPT;
};

template <int W>
__global__ void __launch_bounds__(kRowThreads)
    scatter_narrow(const int* __restrict__ rows, const int* __restrict__ slot,
                   const uint8_t* __restrict__ mask,
                   const int* __restrict__ counts, long long A, int n,
                   long long cap, unsigned rblocks, unsigned nzb,
                   int* __restrict__ out) {
  constexpr int WO = Narrow<W>::WO, RPT = Narrow<W>::RPT,
                TR = Narrow<W>::TR, VW = W > 0 ? W : 1;
  if (blockIdx.x >= rblocks) {
    zero_tails(blockIdx.x - rblocks, nzb, counts, n, cap, WO, out);
    return;
  }
  __shared__ __align__(16) int tile[TR * WO + 4];
  __shared__ __align__(16) int staged[TR * VW];
  __shared__ unsigned long long bar;
  __shared__ int ext[3];
  const long long num_slots = (long long)n * cap;
  const long long i0 = (long long)blockIdx.x * TR;
  const int T = (int)(A - i0 < TR ? A - i0 : TR);
  const int* src = rows + i0 * W;
  const bool bulk_in = W > 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0
                       && ((T * W) & 3) == 0;
  if (threadIdx.x == 0 && bulk_in)
    bulk_load(smem_addr(staged), src, (uint32_t)(T * W * 4), smem_addr(&bar));
  int s[RPT];
  bool m[RPT];
  int lo = 0x7fffffff, hi = -1, cnt = 0;
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int r = threadIdx.x + k * kRowThreads;
    s[k] = -1;
    m[k] = false;
    if (r < T) {
      const int sv = slot[i0 + r];
      if (sv >= 0 && sv < num_slots) {
        s[k] = sv;
        m[k] = mask == nullptr || mask[i0 + r];
        lo = min(lo, sv);
        hi = max(hi, sv);
        ++cnt;
      }
    }
  }
  block_extent(lo, hi, cnt, ext);
  if (bulk_in) mbar_wait(smem_addr(&bar), 0);
  const int K = ext[2], smin = ext[0];
  if (K == 0) return;
  int v[RPT][VW];
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int r = threadIdx.x + k * kRowThreads;
    if (s[k] < 0 || !m[k]) continue;
    const int* p = bulk_in ? staged + r * W : src + r * W;
#pragma unroll
    for (int c = 0; c < W; ++c) v[k][c] = p[c];
  }
  if (ext[1] - smin + 1 != K) {                // not one run: row by row
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      if (s[k] < 0) continue;
      int* o = out + (long long)s[k] * WO;
#pragma unroll
      for (int c = 0; c < W; ++c) o[c] = m[k] ? v[k][c] : 0;
      o[W] = m[k];
    }
    return;
  }
  const long long g0 = (long long)smin * WO;
  const long long base = g0 & ~3ll;
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    if (s[k] < 0) continue;
    int* t = tile + ((long long)s[k] * WO - base);
#pragma unroll
    for (int c = 0; c < W; ++c) t[c] = m[k] ? v[k][c] : 0;
    t[W] = m[k];
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  store_run(tile, g0, g0 + (long long)K * WO, out);
}

// Medium rows (w >= 8, and 4 rows of w + (w+1) ints fit kMediumBytes of
// shared memory; the OLTP install's 259 lanes): the narrow body's design
// with a warp per row.  A block takes TR rows (a multiple of 4, so the
// tile's first row is 16-byte aligned), one thread stages their lanes with
// one cp.async.bulk load, warps compose the (w+1)-int rows in shared
// memory, and a run of slots leaves with one bulk store; other tiles store
// row by row from shared memory.
constexpr int kMediumBytes = 40960;
constexpr int kMaxTR = kRowThreads;

__global__ void __launch_bounds__(kRowThreads)
    scatter_medium(const int* __restrict__ rows, const int* __restrict__ slot,
                   const uint8_t* __restrict__ mask,
                   const int* __restrict__ counts, long long A, int w, int n,
                   long long cap, int TR, unsigned rblocks, unsigned nzb,
                   int* __restrict__ out) {
  const int wo = w + 1;
  if (blockIdx.x >= rblocks) {
    zero_tails(blockIdx.x - rblocks, nzb, counts, n, cap, wo, out);
    return;
  }
  extern __shared__ __align__(16) int smem[];
  __shared__ int srow[kMaxTR];
  __shared__ uint8_t mrow[kMaxTR];
  __shared__ unsigned long long bar;
  __shared__ int ext[3];
  int* staged = smem;                          // (TR, w), then the tile
  int* tile = smem + ((TR * w + 3) & ~3);
  const long long num_slots = (long long)n * cap;
  const long long i0 = (long long)blockIdx.x * TR;
  const int T = (int)(A - i0 < TR ? A - i0 : TR);
  const int* src = rows + i0 * w;
  const bool bulk_in =
      (reinterpret_cast<uintptr_t>(src) & 15) == 0 && ((T * w) & 3) == 0;
  if (threadIdx.x == 0 && bulk_in)
    bulk_load(smem_addr(staged), src, (uint32_t)(T * w * 4), smem_addr(&bar));
  int lo = 0x7fffffff, hi = -1, cnt = 0;
  if (threadIdx.x < T) {
    const int sv = slot[i0 + threadIdx.x];
    const bool in = sv >= 0 && sv < num_slots;
    srow[threadIdx.x] = in ? sv : -1;
    mrow[threadIdx.x] = in && (mask == nullptr || mask[i0 + threadIdx.x]);
    if (in) {
      lo = hi = sv;
      cnt = 1;
    }
  }
  if (!bulk_in)
    for (int e = threadIdx.x; e < T * w; e += kRowThreads) staged[e] = src[e];
  block_extent(lo, hi, cnt, ext);
  if (bulk_in) mbar_wait(smem_addr(&bar), 0);
  const int K = ext[2], smin = ext[0];
  if (K == 0) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool run = ext[1] - smin + 1 == K;
  const long long g0 = (long long)smin * wo;
  const long long base = g0 & ~3ll;
  for (int r = warp; r < T; r += kWideWarps) {
    const int s = srow[r];
    if (s < 0) continue;
    const bool m = mrow[r];
    const int* in = staged + r * w;
    int* o = run ? tile + ((long long)s * wo - base) : out + (long long)s * wo;
    for (int c = lane; c < wo; c += 32) o[c] = !m ? 0 : (c < w ? in[c] : 1);
  }
  if (!run) return;
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  store_run(tile, g0, g0 + (long long)K * wo, out);
}

// Medium rows a block for width w (0 if 4 rows do not fit).
inline int medium_rows(int w) {
  int tr = (kMediumBytes / 4 / (2 * w + 1)) & ~3;
  return tr > kMaxTR ? kMaxTR : tr;
}

// Wide rows (medium_rows(w) == 0: a PS push's 4 rows of 23.4 M or 92 M
// lanes, RDMA-AGG's flush of 4 rows of up to 2^26): a kept row's
// destination out[s*wo, s*wo + wo) is one contiguous span, so the body is
// a streaming shifted copy.  A block takes one (row, span) item; a span is
// kSpan 16-byte chunks of the row's destination (16 KB), each warp
// kUnroll runs of 32 chunks one after another, a chunk a lane a run.  A
// row splits into a head (the <= 3 ints before its first 16-byte
// boundary), a middle of whole chunks that hold lanes of the row alone,
// and a tail (the <= 3 lanes after it and the valid lane); span 0's block
// writes the head and the tail one int a thread.  A middle chunk takes its
// 4 ints from the row's aligned source chunks q and q + 1, shifted by the
// row's e = (source - destination) mod 4 ints: each lane loads its q with
// one 16-byte load and takes q + 1 from the next lane by a shuffle (lane
// 31 from lane 0's chunk of its next run); only lane 31's last run, and
// the row's last chunk, load q + 1 themselves.  Every alignment of w + 1
// and of the row base is the same body, e = 0 without the shuffles.
// Stores are 16 bytes with the streaming hint (st.global.cs).  A masked
// row stores zeros and loads nothing.  A lane issues all its kUnroll
// loads before its first store, and one block an item lets the card keep
// as many blocks resident as fit, each with 16 KB of loads in flight.  On
// an H100 at a PS push's and RDMA-AGG's flush's rows this ran faster than
// a grid of 4 to 16 blocks an SM walking the items, than 8 or 16 chunks a
// lane, and than non-allocating loads (ld.global.nc.L1::no_allocate) in
// place of plain ones; a head peeled to a 128-byte boundary changed
// nothing.
constexpr int kUnroll = 4;
constexpr int kSpan = kRowThreads * kUnroll;

__device__ __forceinline__ void st_stream(int4* p, int4 v) {
  asm volatile("st.global.cs.v4.s32 [%0], {%1, %2, %3, %4};" ::"l"(p),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
}

__device__ __forceinline__ int4 shfl_down4(int4 v) {
  v.x = __shfl_down_sync(kFull, v.x, 1);
  v.y = __shfl_down_sync(kFull, v.y, 1);
  v.z = __shfl_down_sync(kFull, v.z, 1);
  v.w = __shfl_down_sync(kFull, v.w, 1);
  return v;
}

__device__ __forceinline__ int4 shfl0(int4 v) {
  v.x = __shfl_sync(kFull, v.x, 0);
  v.y = __shfl_sync(kFull, v.y, 0);
  v.z = __shfl_sync(kFull, v.z, 0);
  v.w = __shfl_sync(kFull, v.w, 0);
  return v;
}

// ints e .. e + 3 of the 8 in (x, y), e in 1 .. 3
__device__ __forceinline__ int4 funnel(int4 x, int4 y, int e) {
  return e == 1 ? make_int4(x.y, x.z, x.w, y.x)
       : e == 2 ? make_int4(x.z, x.w, y.x, y.y)
                : make_int4(x.w, y.x, y.y, y.z);
}

// Blocks [0, rblocks) take items it = blockIdx.x, + rblocks, ...: row it /
// spans, span it % spans (one item each when rblocks = A spans).
__global__ void __launch_bounds__(kRowThreads)
    scatter_wide(const int* __restrict__ rows, const int* __restrict__ slot,
                 const uint8_t* __restrict__ mask,
                 const int* __restrict__ counts, long long A, int w, int n,
                 long long cap, int spans, unsigned rblocks, unsigned nzb,
                 int* __restrict__ out) {
  const long long wo = (long long)w + 1;
  if (blockIdx.x >= rblocks) {
    zero_tails(blockIdx.x - rblocks, nzb, counts, n, cap, (int)wo, out);
    return;
  }
  const long long num_slots = (long long)n * cap;
  const long long items = A * spans;
  const int lane = threadIdx.x & 31;
  // the lane's first chunk of a span: the warp's runs one after another
  const int first = (threadIdx.x >> 5) * 32 * kUnroll + lane;
  for (long long it = blockIdx.x; it < items; it += rblocks) {
    const long long i = it / spans;
    const int k = (int)(it - i * spans);
    const int s = slot[i];
    if (s < 0 || s >= num_slots) continue;
    const bool m = mask == nullptr || mask[i];
    const int* src = rows + i * w;
    int* dst = out + (long long)s * wo;
    // head: ints [0, hd) up to dst's first 16-byte boundary; middle:
    // chunks [0, n4) from int hd on, every int of them a lane < w; tail:
    // ints [hd + 4 n4, wo), the valid lane last
    const int hd = (int)((16 - (reinterpret_cast<uintptr_t>(dst) & 15))
                         & 15) >> 2;
    const long long n4 = w > hd ? (w - hd) >> 2 : 0;
    if (k == 0 && threadIdx.x < 8) {
      const long long p = threadIdx.x < 4 ? threadIdx.x
                                          : hd + 4 * n4 + threadIdx.x - 4;
      if ((threadIdx.x < 4 ? p < hd : true) && p < wo)
        dst[p] = !m ? 0 : (p < w ? src[p] : 1);
    }
    const long long j0 = (long long)k * kSpan;
    const long long j1 = j0 + kSpan < n4 ? j0 + kSpan : n4;
    if (j0 >= j1) continue;
    int4* d4 = reinterpret_cast<int4*>(dst + hd);
    const long long jl = j0 + first;
    if (!m) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (jl + 32 * u < j1)
          st_stream(d4 + jl + 32 * u, make_int4(0, 0, 0, 0));
      continue;
    }
    const uintptr_t sp = reinterpret_cast<uintptr_t>(src + hd);
    const int e = (int)(sp >> 2) & 3;         // uniform across the block
    const int4* s4 = reinterpret_cast<const int4*>(sp & ~uintptr_t(15));
    // every load first: the lane's chunks q, and lane 31's q + 1 past
    // its last run
    int4 x[kUnroll], last = make_int4(0, 0, 0, 0);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = jl + 32 * u;
      x[u] = j < j1 ? s4[j] : make_int4(0, 0, 0, 0);
    }
    if (e != 0 && lane == 31 && jl + 32 * (kUnroll - 1) < j1)
      last = s4[jl + 32 * (kUnroll - 1) + 1];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = jl + 32 * u;
      int4 v = x[u];
      if (e != 0) {
        int4 y = shfl_down4(v);               // every lane shuffles
        const int4 next_run = shfl0(x[u + 1 < kUnroll ? u + 1 : u]);
        if (lane == 31) y = u + 1 < kUnroll ? next_run : last;
        // q + 1 past the row's middle: no lane loaded it
        if (j + 1 == j1 && (lane != 31 || u + 1 < kUnroll)) y = s4[j + 1];
        v = funnel(v, y, e);
      }
      if (j < j1) st_stream(d4 + j, v);
    }
  }
}

constexpr int kMaxDevices = 64;
int g_sms[kMaxDevices];

cudaError_t sm_count(int device, int* out) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (g_sms[device] == 0) {
    cudaError_t e = cudaDeviceGetAttribute(
        &g_sms[device], cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return e;
  }
  *out = g_sms[device];
  return cudaSuccess;
}

struct ScatterArgs {
  const int* rows;
  const int* slot;
  const uint8_t* mask;
  const int* counts;
  long long A;
  int w, n;
  long long cap;
  unsigned nzb;
  int* out;
  cudaStream_t st;
};

template <int W>
cudaError_t launch_narrow(const ScatterArgs& a) {
  const unsigned rb = (unsigned)((a.A + Narrow<W>::TR - 1) / Narrow<W>::TR);
  scatter_narrow<W><<<rb + a.nzb, kRowThreads, 0, a.st>>>(
      a.rows, a.slot, a.mask, a.counts, a.A, a.n, a.cap, rb, a.nzb, a.out);
  return cudaGetLastError();
}

cudaError_t narrow(const ScatterArgs& a) {
  switch (a.w) {
    case 0: return launch_narrow<0>(a);
    case 1: return launch_narrow<1>(a);
    case 2: return launch_narrow<2>(a);
    case 3: return launch_narrow<3>(a);
    case 4: return launch_narrow<4>(a);
    case 5: return launch_narrow<5>(a);
    case 6: return launch_narrow<6>(a);
    default: return launch_narrow<7>(a);
  }
}

cudaError_t medium(const ScatterArgs& a, int tr) {
  const unsigned rb = (unsigned)((a.A + tr - 1) / tr);
  const size_t bytes = (((size_t)tr * a.w + 3) / 4 * 4 +
                        (size_t)tr * (a.w + 1) + 4) * sizeof(int);
  scatter_medium<<<rb + a.nzb, kRowThreads, bytes, a.st>>>(
      a.rows, a.slot, a.mask, a.counts, a.A, a.w, a.n, a.cap, tr, rb, a.nzb,
      a.out);
  return cudaGetLastError();
}

cudaError_t wide(const ScatterArgs& a) {
  // spans a row: its middle holds at most w / 4 chunks; span 0 also
  // writes the head and the tail.  One block an item (at most 2^30
  // blocks; past that, blocks take several).
  long long spans = ((long long)a.w / 4 + kSpan - 1) / kSpan;
  spans = spans > 0 ? spans : 1;
  const long long items = a.A * spans;
  const long long rb = items < (1LL << 30) ? items : (1LL << 30);
  scatter_wide<<<(unsigned)rb + a.nzb, kRowThreads, 0, a.st>>>(
      a.rows, a.slot, a.mask, a.counts, a.A, a.w, a.n, a.cap, (int)spans,
      (unsigned)rb, a.nzb, a.out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int radix_items_per_block() { return kItems; }

int radix_warps_per_block() { return kWarps; }

// hist: (nblocks * n) int32 scratch, nblocks = ceil(A / items per block).
// Shared memory: (kWarps+1)*n ints, so n is limited by the caller to fit
// the 48 KB default.  Launches on `stream` of `device`.
int radix_rank(const void* dest, long long A, int n, int cap, void* hist,
               void* counts, void* slot, void* keep, void* overflow,
               int device, void* stream) {
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e == cudaSuccess && cur != device) e = cudaSetDevice(device);
  cudaStream_t st = (cudaStream_t)stream;
  const int nblocks = (int)((A + kItems - 1) / kItems);
  if (e == cudaSuccess && nblocks > 0) {
    hist_kernel<<<nblocks, kThreads, n * sizeof(int), st>>>(
        (const int*)dest, A, n, (int*)hist);
    e = cudaGetLastError();
  }
  if (e == cudaSuccess) {
    const int threads = nblocks >= kScanThreads ? kScanThreads
                        : nblocks > 32 ? (nblocks + 31) / 32 * 32 : 32;
    scan_kernel<<<n, threads, 0, st>>>((int*)hist, nblocks, cap,
                                       (int*)counts);
    e = cudaGetLastError();
  }
  if (e == cudaSuccess && nblocks > 0) {
    rank_kernel<<<nblocks, kThreads, (kWarps + 1) * n * sizeof(int), st>>>(
        (const int*)dest, A, n, cap, (const int*)hist, (int*)slot,
        (uint8_t*)keep, (uint8_t*)overflow);
    e = cudaGetLastError();
  }
  if (cur >= 0 && cur != device) cudaSetDevice(cur);
  return (int)e;
}

// out: (n * cap, w + 1) int32, written whole (no fill needed); slot (A,)
// from radix_rank with its counts (n,); mask may be null.  The body goes
// by the row width w: narrow, medium or wide.  Launches on `stream` of
// `device`.
int radix_scatter(const void* rows, const void* slot, const void* mask,
                  const void* counts, long long A, int w, int n,
                  long long cap, void* out, int device, void* stream) {
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e == cudaSuccess && cur != device) e = cudaSetDevice(device);
  int sms = 0;
  if (e == cudaSuccess) e = sm_count(device, &sms);
  if (e == cudaSuccess) {
    // tail blocks: 16 chunks a thread of the whole buffer, 1 .. 2 per SM
    const long long chunks = (long long)n * cap * (w + 1) / 4;
    long long nzb = (chunks + kRowThreads * 16 - 1) / (kRowThreads * 16);
    nzb = nzb < 1 ? 1 : (nzb > 2LL * sms ? 2LL * sms : nzb);
    const ScatterArgs a{(const int*)rows, (const int*)slot,
                        (const uint8_t*)mask, (const int*)counts, A, w, n,
                        cap, (unsigned)nzb, (int*)out, (cudaStream_t)stream};
    const int tr = medium_rows(w);
    if (w <= 7)
      e = narrow(a);
    else if (tr >= 4)
      e = medium(a, tr);
    else
      e = wide(a);
  }
  if (cur >= 0 && cur != device) cudaSetDevice(cur);
  return (int)e;
}

}  // extern "C"
