// Grouped scatter-add (RDMA-AGG's pre-aggregation, paper §5.3), for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/grouped_agg.py (grouped_agg,
// pallas_call at :47) and the jnp scatter-adds the JAX operators run in its
// place (core/aggregation.py: segment_sum_by_key, preagg_table and
// RDMA-AGG's (chunks, n, gsz) partition table).  One templated body, two
// entry points:
//
//   grouped_agg_f32   table[s] = sum of vals[i] (f32) over slot[i] == s: the
//                     TPU kernel's own function (a one-hot matmul there);
//   grouped_sum_u32   the same on u32 words with a wrapping add: what the
//                     operators need, since the JAX package's "uint64" sums
//                     are u32 with x64 off.
//
// slot (N,) int32, vals (N,), out (S,) zeroed here.  A slot outside [0, S)
// is skipped: the kernel never writes out of bounds.
//
// Bound: bytes.  Each row is read once (4 B slot + 4 B value) and the table
// written once (4 B a slot): 8N + 4S bytes.  The TPU kernel keeps the table
// in VMEM across a sequential grid; here blocks run in parallel, so:
//   * small tables (S * 4 B <= kMaxSharedBytes): each block sums its share
//     of rows into a private table in shared memory (shared atomics), then
//     adds each nonzero slot to the output with one global atomic;
//   * larger tables: global atomics straight into the output.
// Either way, lanes of a warp that hit the same slot first sum their values
// among themselves (a tree over the peers that __match_any_sync finds), and
// only the lowest such lane issues the atomic: a single hot slot (G = 1, or
// a skewed key) costs one atomic per warp, not one per row.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxSharedBytes = 200 * 1024;   // of the 227 KB a block may have
constexpr int kDefaultSharedBytes = 48 * 1024;

// Sum of x over the lanes in `peers` (which holds the calling lane), valid
// in the lowest peer.  Every lane of the warp must call it.  A tree: in
// round r each remaining lane adds the value of the next remaining peer
// above it, then the lanes at odd positions drop out.
template <typename T>
__device__ __forceinline__ T peer_sum(unsigned peers, T x) {
  const int lane = threadIdx.x & 31;
  int rel = __popc(peers & ((1u << lane) - 1u));   // position among peers
  unsigned above = peers & (0xfffffffeu << lane);  // peers above this lane
  while (__any_sync(0xffffffffu, above != 0u)) {
    const int next = __ffs(above);                 // 0 when none is left
    const T t = __shfl_sync(0xffffffffu, x, next > 0 ? next - 1 : lane);
    if (next > 0) x += t;
    above &= __ballot_sync(0xffffffffu, (rel & 1) == 0);
    rel >>= 1;
  }
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
agg_kernel(const int* __restrict__ slot, const T* __restrict__ vals,
           long long N, int S, bool shared_table, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* table = reinterpret_cast<T*>(smem);
  if (shared_table) {
    for (int s = threadIdx.x; s < S; s += blockDim.x) table[s] = T(0);
    __syncthreads();
  }
  T* dst = shared_table ? table : out;
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * blockDim.x;
  // the loop bound is uniform across the block, so every lane of a warp
  // reaches the warp-wide intrinsics together
  for (long long base = (long long)blockIdx.x * blockDim.x; base < N;
       base += stride) {
    const long long i = base + threadIdx.x;
    const int s = i < N ? slot[i] : -1;
    const bool ok = s >= 0 && s < S;
    const T v = ok ? vals[i] : T(0);
    const unsigned peers = __match_any_sync(0xffffffffu, ok ? s : -1);
    const T sum = peer_sum(peers, v);
    if (ok && lane == __ffs(peers) - 1) atomicAdd(&dst[s], sum);
  }
  if (shared_table) {
    __syncthreads();
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      const T t = table[s];
      if (t != T(0)) atomicAdd(&out[s], t);
    }
  }
}

template <typename T>
int launch(const void* slot, const void* vals, long long N, int S, void* out,
           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(out, 0, (size_t)S * sizeof(T), st);
  if (e != cudaSuccess || N <= 0) return (int)e;
  const size_t bytes = (size_t)S * sizeof(T);
  const bool shared_table = bytes <= (size_t)kMaxSharedBytes;
  const size_t smem = shared_table ? bytes : 0;
  if (smem > (size_t)kDefaultSharedBytes) {
    e = cudaFuncSetAttribute(agg_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int dev = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, agg_kernel<T>,
                                                      kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  // enough blocks to fill the card, and no more: each block of the shared
  // path flushes its whole table once
  long long grid = (N + kThreads - 1) / kThreads;
  const long long full = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (grid > full) grid = full;
  agg_kernel<T><<<(int)grid, kThreads, smem, st>>>(
      (const int*)slot, (const T*)vals, N, S, shared_table, (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest S whose table the shared-memory path takes.
int grouped_agg_max_shared_slots() { return kMaxSharedBytes / 4; }

// slot (N,) int32, vals (N,) f32 -> out (S,) f32.
int grouped_agg_f32(const void* slot, const void* vals, long long N, int S,
                    void* out, void* stream) {
  return launch<float>(slot, vals, N, S, out, stream);
}

// slot (N,) int32, vals (N,) u32 words -> out (S,) u32 sums mod 2**32.
int grouped_sum_u32(const void* slot, const void* vals, long long N, int S,
                    void* out, void* stream) {
  return launch<unsigned int>(slot, vals, N, S, out, stream);
}

}  // extern "C"
