// Multi-request compare-and-swap with deterministic arbitration, for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/cas_lock.py (cas_lock,
// pallas_call at :60) with the semantics of the verb the JAX commit path
// really runs, src/repro/fabric/verbs.py::cas: among the requests whose
// `expected` equals the stored word, the first in (priority, arrival) order
// wins and installs `new`.  cas_lock is the case priority = arrival,
// new = expected | 1<<31.  Words are u32 bit patterns in int32.
//
// Three launches (the TPU kernel walked the requests in one sequential
// loop; here every request is a thread, and atomics on a packed 64-bit key
// pick the winner):
//   1. match[i] = 0 <= idx < R ? ... : words[min(idx, R-1)] == expected[i],
//      read from the original words.  A match atomicMin's the key
//      ((u64)(prio ^ 0x80000000) << 32) | i into best[idx]; the sign flip
//      keeps negative priorities in order.
//   2. ok[i] = match[i] && best[idx] == key_i; winners write new[i].
//   3. reset the touched best entries, so the scratch stays all ones.
// JAX's verb gathers with a clamp and arbitrates in a (R+1)-slot table
// whose last slot collects every non-contender, so a request with idx == R
// can win there (and write nothing).  Two scalars, pr and ar, play that
// slot's (priority, arrival) minima, which keeps the kernel bit-exact with
// the verb for every index.
//
// Bound: bytes.  Each request reads idx, expected, new, priority and one
// word and writes one flag; each winner writes one word.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned long long key_of(int prio, long long i) {
  return ((unsigned long long)((unsigned)prio ^ 0x80000000u) << 32) |
         (unsigned long long)(unsigned)i;
}

// Warp-aggregated atomicMin on one scalar; every lane of the warp calls it.
__device__ __forceinline__ void warp_min(unsigned* dst, unsigned v) {
  const unsigned m = __reduce_min_sync(kFull, v);
  if ((threadIdx.x & 31) == 0 && m != 0xffffffffu) atomicMin(dst, m);
}

// state[i]: 1 = matched (after launch 1); 1 = won / 2 = tied in slot R
// (after launch 2); ok (after launch 3).  slotR = {pr, ar}.
__global__ void cas_match(const int* __restrict__ words, long long R,
                          const int* __restrict__ idx,
                          const int* __restrict__ expected,
                          const int* __restrict__ prio, long long A,
                          unsigned long long* __restrict__ best,
                          unsigned* __restrict__ slotR,
                          uint8_t* __restrict__ state) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long b = (long long)blockIdx.x * blockDim.x; b < A; b += stride) {
    const long long i = b + threadIdx.x;
    const bool in = i < A;
    unsigned to_r = 0xffffffffu;
    if (in) {
      const int r = idx[i];
      const long long rc = r < R ? r : R - 1;
      const bool c = r >= 0 && words[rc] == expected[i];
      state[i] = c;
      const long long seg = c ? r : R;
      if (seg < R)
        atomicMin(&best[seg], key_of(prio[i], i));
      else if (seg == R)
        to_r = (unsigned)prio[i] ^ 0x80000000u;
    }
    warp_min(&slotR[0], to_r);
  }
}

__global__ void cas_resolve(int* __restrict__ words, long long R,
                            const int* __restrict__ idx,
                            const int* __restrict__ prio,
                            const int* __restrict__ newv, long long A,
                            const unsigned long long* __restrict__ best,
                            unsigned* __restrict__ slotR,
                            uint8_t* __restrict__ state) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const unsigned pr = slotR[0];
  for (long long b = (long long)blockIdx.x * blockDim.x; b < A; b += stride) {
    const long long i = b + threadIdx.x;
    const bool in = i < A;
    unsigned to_r = 0xffffffffu;
    if (in) {
      const int r = idx[i];
      const bool c = state[i] != 0;
      const unsigned pk = (unsigned)prio[i] ^ 0x80000000u;
      bool tied = false;
      uint8_t s = 0;
      if (c && r < R) {
        const unsigned long long bk = best[r];
        tied = (unsigned)(bk >> 32) == pk;
        if (bk == key_of(prio[i], i)) {
          words[r] = newv[i];
          s = 1;
        }
      } else if (c) {
        tied = pk == pr;
        s = tied ? 2 : 0;
      }
      // slot R's arrival minimum: every request not tied, and the tied
      // ones whose idx is exactly R
      if (!tied || r == R) to_r = (unsigned)i;
      state[i] = s;
    }
    warp_min(&slotR[1], to_r);
  }
}

__global__ void cas_finish(const int* __restrict__ idx, long long R,
                           long long A, unsigned long long* __restrict__ best,
                           const unsigned* __restrict__ slotR,
                           uint8_t* __restrict__ state) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const unsigned ar = slotR[1];
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < A;
       i += stride) {
    const int r = idx[i];
    if (r >= 0 && r < R) best[r] = ~0ull;
    const uint8_t s = state[i];
    state[i] = s == 1 || (s == 2 && (unsigned)i == ar);
  }
}

inline int grid_for(long long work, int threads) {
  long long g = (work + threads - 1) / threads;
  const long long cap = 132LL * 16;
  return (int)(g < 1 ? 1 : (g > cap ? cap : g));
}

}  // namespace

extern "C" {

// words (R,) int32, updated in place; idx/expected/newv/prio (A,) int32;
// best (>= R,) u64 scratch holding all ones on entry and on return;
// slotR (2,) u32 scratch; ok (A,) uint8 output.
int cas_arbitrate(void* words, long long R, const void* idx,
                  const void* expected, const void* newv, const void* prio,
                  long long A, void* best, void* slotR, void* ok,
                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(slotR, 0xff, 2 * sizeof(unsigned), st);
  if (e != cudaSuccess || A == 0) return (int)e;
  const int g = grid_for(A, 256);
  cas_match<<<g, 256, 0, st>>>((const int*)words, R, (const int*)idx,
                               (const int*)expected, (const int*)prio, A,
                               (unsigned long long*)best, (unsigned*)slotR,
                               (uint8_t*)ok);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  cas_resolve<<<g, 256, 0, st>>>((int*)words, R, (const int*)idx,
                                 (const int*)prio, (const int*)newv, A,
                                 (const unsigned long long*)best,
                                 (unsigned*)slotR, (uint8_t*)ok);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  cas_finish<<<g, 256, 0, st>>>((const int*)idx, R, A,
                                (unsigned long long*)best,
                                (const unsigned*)slotR, (uint8_t*)ok);
  return (int)cudaGetLastError();
}

}  // extern "C"
