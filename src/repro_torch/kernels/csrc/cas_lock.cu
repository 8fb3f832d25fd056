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
// One cooperative launch, three phases between grid-wide barriers (the TPU
// kernel walked the requests in one sequential loop; here every request is
// a thread, and atomics on a packed 64-bit key pick the winner):
//   1. match[i] = 0 <= idx < R ? ... : words[min(idx, R-1)] == expected[i],
//      read from the original words.  A match atomicMin's the key
//      ((u64)(prio ^ 0x80000000) << 32) | i into best[idx]; the sign flip
//      keeps negative priorities in order.
//   2. ok[i] = match[i] && best[idx] == key_i; winners write new[i].
//   3. reset the touched best entries, so the scratch stays all ones.
// JAX's verb gathers with a clamp and arbitrates in a (R+1)-slot table
// whose last slot collects every non-contender, so a request with idx == R
// can win there (and write nothing).  Two scalars, slotR = {pr, ar}, play
// that slot's (priority, arrival) minima, which keeps the kernel bit-exact
// with the verb for every index.  pr is all ones on entry and phase 3 puts
// it back (every thread read it in phase 2); phase 1 sets ar, which phase 2
// fills and phase 3 reads.  So a call is one device operation: no fill.
//
// Bound: bytes.  Each request reads idx, expected, new, priority and one
// word and writes one flag; each winner writes one word.  At the commit's
// shape (A = 28 672) that is a fraction of a microsecond, so what a call
// costs is launches and host work: hence one launch, and the grid sized
// once per device for co-residency (cudaLaunchCooperativeKernel refuses a
// grid that does not fit, and the wrapper raises).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ unsigned long long key_of(int prio, long long i) {
  return ((unsigned long long)((unsigned)prio ^ 0x80000000u) << 32) |
         (unsigned long long)(unsigned)i;
}

// Warp-aggregated atomicMin on one scalar; every lane of the warp calls it.
__device__ __forceinline__ void warp_min(unsigned* dst, unsigned v) {
  const unsigned m = __reduce_min_sync(kFull, v);
  if ((threadIdx.x & 31) == 0 && m != 0xffffffffu) atomicMin(dst, m);
}

// state[i] (the ok buffer): 1 = matched after phase 1; 1 = won / 2 = tied
// in slot R after phase 2; ok after phase 3.  Every thread walks the same
// requests in every phase, so it reads back only its own state.  Values
// other blocks wrote (best, slotR) are read through L2 (__ldcg).
__global__ void __launch_bounds__(kThreads)
    cas_kernel(int* __restrict__ words, long long R,
               const int* __restrict__ idx, const int* __restrict__ expected,
               const int* __restrict__ newv, const int* __restrict__ prio,
               long long A, unsigned long long* __restrict__ best,
               unsigned* __restrict__ slotR, uint8_t* __restrict__ state) {
  cg::grid_group grid = cg::this_grid();
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x;
  const bool leader = blockIdx.x == 0 && threadIdx.x == 0;

  if (leader) slotR[1] = kFull;
  for (long long b = first; b < A; b += stride) {
    const long long i = b + threadIdx.x;
    unsigned to_r = kFull;
    if (i < A) {
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
  grid.sync();

  const unsigned pr = __ldcg(&slotR[0]);
  for (long long b = first; b < A; b += stride) {
    const long long i = b + threadIdx.x;
    unsigned to_r = kFull;
    if (i < A) {
      const int r = idx[i];
      const bool c = state[i] != 0;
      const unsigned pk = (unsigned)prio[i] ^ 0x80000000u;
      bool tied = false;
      uint8_t s = 0;
      if (c && r < R) {
        const unsigned long long bk = __ldcg(&best[r]);
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
  grid.sync();

  if (leader) slotR[0] = kFull;
  const unsigned ar = __ldcg(&slotR[1]);
  for (long long i = first + threadIdx.x; i < A; i += stride) {
    const int r = idx[i];
    if (r >= 0 && r < R) best[r] = ~0ull;
    const uint8_t s = state[i];
    state[i] = s == 1 || (s == 2 && (unsigned)i == ar);
  }
}

// Co-resident blocks of cas_kernel on each device, found once, and each
// device's scratch (cas_scratch).
int g_blocks[kMaxDevices];
unsigned long long* g_best[kMaxDevices];
unsigned* g_slotR[kMaxDevices];

cudaError_t max_blocks(int device, int* out) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (g_blocks[device] == 0) {
    int per_sm = 0, sms = 0;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, cas_kernel, kThreads, 0);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return e;
    g_blocks[device] = per_sm * sms;
  }
  *out = g_blocks[device];
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The scratch of `device`'s calls: best (>= R,) u64 holding all ones, and
// slotR (2,) u32 whose first entry is all ones; every call leaves them so.
int cas_scratch(int device, void* best, void* slotR) {
  if (device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  g_best[device] = (unsigned long long*)best;
  g_slotR[device] = (unsigned*)slotR;
  return 0;
}

// words (R,) int32, updated in place, R no longer than the scratch table;
// idx/expected/newv/prio (A,) int32, A >= 1; ok (A,) uint8 output.
// Launches on `stream` of `device`.
int cas_arbitrate(void* words, long long R, const void* idx,
                  const void* expected, const void* newv, const void* prio,
                  long long A, void* ok, int device, void* stream) {
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e == cudaSuccess && cur != device) e = cudaSetDevice(device);
  int cap = 0;
  if (e == cudaSuccess) e = max_blocks(device, &cap);
  if (e == cudaSuccess) {
    const long long need = (A + kThreads - 1) / kThreads;
    const int grid = (int)(need < cap ? need : cap);
    int* w = (int*)words;
    const int* ix = (const int*)idx;
    const int* ex = (const int*)expected;
    const int* nv = (const int*)newv;
    const int* pr = (const int*)prio;
    unsigned long long* bt = g_best[device];
    unsigned* sr = g_slotR[device];
    uint8_t* st = (uint8_t*)ok;
    void* args[] = {&w, &R, &ix, &ex, &nv, &pr, &A, &bt, &sr, &st};
    e = cudaLaunchCooperativeKernel((const void*)cas_kernel, dim3(grid),
                                    dim3(kThreads), args, 0,
                                    (cudaStream_t)stream);
  }
  if (cur >= 0 && cur != device) cudaSetDevice(cur);
  return (int)e;
}

}  // extern "C"
