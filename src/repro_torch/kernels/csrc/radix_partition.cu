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
//                       counts do not depend on order);
//                    2. an exclusive scan over blocks, one thread per bucket;
//                    3. the rank inside a block: tiles of 256 requests in
//                       arrival order, warp ballots (__match_any_sync +
//                       __popc(peers & lanemask_lt)) for the rank inside a
//                       warp, per-warp counts in shared memory for the
//                       warps before it, and a running count per bucket for
//                       the tiles before it.  No atomic decides a rank, so
//                       the rank is stable.
//                  dest < 0 or dest >= n is filtered: no rank, not a drop.
//   radix_scatter  rows (A, w), slot (A,), optional mask -> the zeroed
//                  (num_slots, w + 1) wire buffer with each kept, unmasked
//                  row in its slot and a ones valid lane after it (the
//                  Pallas kernel's fuse_valid form).
//
// Bound: bytes.  The rank reads 4 B and writes 6 B per request; the scatter
// moves each row once and writes the buffer once (memset + rows).  The
// design keeps every pass a coalesced stream; the rank's scan is serial per
// bucket over blocks of 4096 requests, which is short at the main path's
// sizes (n = 1 shard, A = T*W).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTiles = 16;                    // tiles of kThreads per block
constexpr int kItems = kThreads * kTiles;     // requests ranked per block

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
    hist[(long long)blockIdx.x * n + d] = sh[d];
}

// hist (nblocks, n) -> exclusive per-bucket offsets, in place; counts[d] =
// min(total of bucket d, cap).
__global__ void scan_kernel(int* __restrict__ hist, int nblocks, int n,
                            int cap, int* __restrict__ counts) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= n) return;
  int acc = 0;
  for (int b = 0; b < nblocks; ++b) {
    const long long k = (long long)b * n + d;
    const int c = hist[k];
    hist[k] = acc;
    acc += c;
  }
  counts[d] = acc < cap ? acc : cap;
}

__global__ void rank_kernel(const int* __restrict__ dest, long long A, int n,
                            int cap, const int* __restrict__ offs,
                            int* __restrict__ slot, uint8_t* __restrict__ keep,
                            uint8_t* __restrict__ overflow) {
  extern __shared__ int sh[];
  int* running = sh;          // (n,)  requests of this block ranked so far
  int* wcnt = sh + n;         // (kWarps, n)  this tile's per-warp counts
  for (int k = threadIdx.x; k < n; k += blockDim.x)
    running[k] = offs[(long long)blockIdx.x * n + k];
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

__global__ void scatter_kernel(const int* __restrict__ rows,
                               const int* __restrict__ slot,
                               const uint8_t* __restrict__ mask, long long A,
                               int w, int wo, long long num_slots,
                               int* __restrict__ out) {
  const long long total = A * wo;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const long long i = e / wo;
    const int c = (int)(e - i * wo);
    const long long s = slot[i];
    if (s < 0 || s >= num_slots) continue;
    if (mask != nullptr && !mask[i]) continue;
    out[s * wo + c] = c < w ? rows[i * w + c] : 1;
  }
}

inline int grid_for(long long work, int threads) {
  long long g = (work + threads - 1) / threads;
  const long long cap = 132LL * 16;
  return (int)(g < 1 ? 1 : (g > cap ? cap : g));
}

}  // namespace

extern "C" {

int radix_items_per_block() { return kItems; }

int radix_warps_per_block() { return kWarps; }

// hist: (max(nblocks, 1) * n) int32 scratch.  Shared memory: (kWarps+1)*n
// ints, so n is limited by the caller to fit the 48 KB default.
int radix_rank(const void* dest, long long A, int n, int cap, void* hist,
               void* counts, void* slot, void* keep, void* overflow,
               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int nblocks = (int)((A + kItems - 1) / kItems);
  if (nblocks > 0) {
    hist_kernel<<<nblocks, kThreads, n * sizeof(int), st>>>(
        (const int*)dest, A, n, (int*)hist);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  scan_kernel<<<(n + 127) / 128, 128, 0, st>>>((int*)hist, nblocks, n, cap,
                                               (int*)counts);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (nblocks > 0) {
    rank_kernel<<<nblocks, kThreads, (kWarps + 1) * n * sizeof(int), st>>>(
        (const int*)dest, A, n, cap, (const int*)hist, (int*)slot,
        (uint8_t*)keep, (uint8_t*)overflow);
    e = cudaGetLastError();
  }
  return (int)e;
}

// out: (num_slots, w + 1) int32; mask may be null.
int radix_scatter(const void* rows, const void* slot, const void* mask,
                  long long A, int w, long long num_slots, void* out,
                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int wo = w + 1;
  cudaError_t e = cudaMemsetAsync(out, 0, (size_t)num_slots * wo * sizeof(int),
                                  st);
  if (e != cudaSuccess) return (int)e;
  if (A > 0) {
    scatter_kernel<<<grid_for(A * wo, 256), 256, 0, st>>>(
        (const int*)rows, (const int*)slot, (const uint8_t*)mask, A, w, wo,
        num_slots, (int*)out);
    e = cudaGetLastError();
  }
  return (int)e;
}

}  // extern "C"
