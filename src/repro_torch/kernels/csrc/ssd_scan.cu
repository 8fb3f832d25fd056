// Mamba2 SSD scan (the prefill step of every SSM model), for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/ssd_scan.py (ssd_scan,
// pallas_call at :63) and the chunked jnp SSD the JAX model runs in its
// place (models/ssm.py: ssd_chunked).  Both compute the recurrence
//
//   state_t = state_{t-1} * exp(dt_t * a) + dt_t * x_t (x) B_t     (hd, N) f32
//   y_t     = C_t . state_t                                          (hd,)
//
// per (batch, head), xh (B, S, H, hd), bv/cv (B, S, N), dt (B, S, H) f32,
// a (H,) f32 negative; y in xh's type, and the final state (B, H, hd, N) f32,
// from an optional initial one (zeros otherwise).  The TPU kernel carries
// the state across a sequential grid axis of chunks; here the sequence is a
// loop inside the block, and the plain recurrence takes the place of the
// chunked form: the same function, in another order of f32 additions.
//
// Bound: bytes at the chunked form's operation count (a mamba2 layer at
// B = 8, S = 8192: 0.58 GB moved, 107 GFLOP in the chunked form at chunk
// 256).  This design is simple, not at that bound: it does the recurrence's
// 4 B S H hd N f32 operations on the CUDA cores.  One block per (32-column
// slice of hd, head, batch); each hd column is held by NS = N / NPT lanes of
// one warp, each with NPT entries of the state in registers, so a step is
// NPT fused multiply-adds for the state and NPT for y, then log2(NS)
// shuffles to sum y over the lanes.  B_t, C_t, x_t and dt_t of 32 steps at
// a time are staged in shared memory as f32, each lane's NPT entries of B
// and C padded apart so the lanes of one column read them as float4 without
// bank conflicts; y of the 32 steps is written back in one coalesced pass.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTT = 32;     // steps staged at a time
constexpr int kDB = 32;     // hd columns a block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

// shared floats of one block
__host__ __device__ constexpr int smem_floats(int N, int NPT) {
  return 2 * kTT * (N / NPT) * (NPT + 4) + 2 * kTT * kDB + kTT;
}

template <typename T, int NPT>
__global__ void __launch_bounds__(1024)
ssd_kernel(const T* __restrict__ x, const T* __restrict__ bm,
           const T* __restrict__ cm, const float* __restrict__ dt,
           const float* __restrict__ a, const float* __restrict__ state0,
           T* __restrict__ y, float* __restrict__ state_out, int S, int H,
           int P, int N) {
  const int NS = N / NPT;               // lanes a column (a power of two)
  const int RS = NS * (NPT + 4);        // padded floats of one B or C row
  extern __shared__ __align__(16) float sm[];
  float* Bs = sm;                       // (kTT, RS)
  float* Cs = Bs + kTT * RS;            // (kTT, RS)
  float* Xs = Cs + kTT * RS;            // (kTT, kDB)
  float* Ys = Xs + kTT * kDB;           // (kTT, kDB)
  float* Ds = Ys + kTT * kDB;           // (kTT,)

  const int d0 = blockIdx.x * kDB, h = blockIdx.y, b = blockIdx.z;
  const int g = threadIdx.x / NS;       // this thread's column in the block
  const int j = threadIdx.x % NS;       // and its slice of N
  const int d = d0 + g;
  const int DB = min(kDB, P - d0);      // columns of this block
  const bool live = g < DB;
  const float ah = a[h];

  float s[NPT];
  const long long st_off = (((long long)b * H + h) * P + d) * N + j * NPT;
#pragma unroll
  for (int i = 0; i < NPT; ++i)
    s[i] = (state0 != nullptr && live) ? state0[st_off + i] : 0.f;

  for (int t0 = 0; t0 < S; t0 += kTT) {
    const int tn = min(kTT, S - t0);
    __syncthreads();                    // the last tile's Ys are written out
    for (int i = threadIdx.x; i < tn * N; i += blockDim.x) {
      const int tt = i / N, n = i % N;
      const long long src = ((long long)b * S + t0 + tt) * N + n;
      const int dst = tt * RS + (n / NPT) * (NPT + 4) + n % NPT;
      Bs[dst] = to_f(bm[src]);
      Cs[dst] = to_f(cm[src]);
    }
    for (int i = threadIdx.x; i < tn * DB; i += blockDim.x) {
      const int tt = i / DB, c = i % DB;
      Xs[tt * kDB + c] =
          to_f(x[(((long long)b * S + t0 + tt) * H + h) * P + d0 + c]);
    }
    for (int i = threadIdx.x; i < tn; i += blockDim.x)
      Ds[i] = dt[((long long)b * S + t0 + i) * H + h];
    __syncthreads();

    for (int tt = 0; tt < tn; ++tt) {
      const float dtv = Ds[tt];
      const float dA = expf(dtv * ah);
      const float bx = live ? dtv * Xs[tt * kDB + g] : 0.f;
      const float4* b4 =
          reinterpret_cast<const float4*>(Bs + tt * RS + j * (NPT + 4));
      const float4* c4 =
          reinterpret_cast<const float4*>(Cs + tt * RS + j * (NPT + 4));
      float y0 = 0.f, y1 = 0.f, y2 = 0.f, y3 = 0.f;
#pragma unroll
      for (int i = 0; i < NPT / 4; ++i) {
        const float4 bb = b4[i], cc = c4[i];
        s[4 * i + 0] = fmaf(s[4 * i + 0], dA, bx * bb.x);
        s[4 * i + 1] = fmaf(s[4 * i + 1], dA, bx * bb.y);
        s[4 * i + 2] = fmaf(s[4 * i + 2], dA, bx * bb.z);
        s[4 * i + 3] = fmaf(s[4 * i + 3], dA, bx * bb.w);
        y0 = fmaf(cc.x, s[4 * i + 0], y0);
        y1 = fmaf(cc.y, s[4 * i + 1], y1);
        y2 = fmaf(cc.z, s[4 * i + 2], y2);
        y3 = fmaf(cc.w, s[4 * i + 3], y3);
      }
      float yp = (y0 + y1) + (y2 + y3);
      for (int off = NS / 2; off > 0; off >>= 1)
        yp += __shfl_xor_sync(kFull, yp, off);
      if (j == 0 && live) Ys[tt * kDB + g] = yp;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < tn * DB; i += blockDim.x) {
      const int tt = i / DB, c = i % DB;
      store(y + (((long long)b * S + t0 + tt) * H + h) * P + d0 + c,
            Ys[tt * kDB + c]);
    }
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < NPT; ++i) state_out[st_off + i] = s[i];
  }
}

template <typename T, int NPT>
int launch(const void* x, const void* bm, const void* cm, const void* dt,
           const void* a, const void* state0, void* y, void* state_out,
           int B, int S, int H, int P, int N, cudaStream_t st) {
  const int threads = kDB * (N / NPT);
  const size_t smem = sizeof(float) * smem_floats(N, NPT);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_kernel<T, NPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((P + kDB - 1) / kDB, H, B);
  ssd_kernel<T, NPT><<<grid, threads, smem, st>>>(
      (const T*)x, (const T*)bm, (const T*)cm, (const float*)dt,
      (const float*)a, (const float*)state0, (T*)y, (float*)state_out, S, H,
      P, N);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int npt, const void* x, const void* bm, const void* cm,
             const void* dt, const void* a, const void* state0, void* y,
             void* state_out, int B, int S, int H, int P, int N,
             cudaStream_t st) {
  switch (npt) {
    case 4:
      return launch<T, 4>(x, bm, cm, dt, a, state0, y, state_out, B, S, H, P,
                          N, st);
    case 8:
      return launch<T, 8>(x, bm, cm, dt, a, state0, y, state_out, B, S, H, P,
                          N, st);
    case 16:
      return launch<T, 16>(x, bm, cm, dt, a, state0, y, state_out, B, S, H,
                           P, N, st);
    case 32:
      return launch<T, 32>(x, bm, cm, dt, a, state0, y, state_out, B, S, H,
                           P, N, st);
  }
  return (int)cudaErrorInvalidValue;
}

// State entries a lane holds for a state width N: the largest of 32, 16, 8,
// 4 that divides N with N / NPT a power of two up to 32; 0 if none does
// (the wrapper refuses such an N).
int state_per_lane(int N) {
  for (int npt = 32; npt >= 4; npt /= 2) {
    if (N % npt) continue;
    const int ns = N / npt;
    if (ns <= 32 && (ns & (ns - 1)) == 0) return npt;
  }
  return 0;
}

}  // namespace

extern "C" {

// xh (B, S, H, P) and bv/cv (B, S, N) f32 (is_bf16 = 0) or bf16 (1);
// dt (B, S, H) f32, a (H,) f32, state0 (B, H, P, N) f32 or null; y like xh,
// state_out (B, H, P, N) f32.  All contiguous.
int ssd_scan_fwd(const void* x, const void* bm, const void* cm,
                 const void* dt, const void* a, const void* state0, void* y,
                 void* state_out, int B, int S, int H, int P, int N,
                 int is_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int npt = state_per_lane(N);
  if (is_bf16)
    return dispatch<bf16>(npt, x, bm, cm, dt, a, state0, y, state_out, B, S,
                          H, P, N, st);
  return dispatch<float>(npt, x, bm, cm, dt, a, state0, y, state_out, B, S,
                         H, P, N, st);
}

}  // extern "C"
