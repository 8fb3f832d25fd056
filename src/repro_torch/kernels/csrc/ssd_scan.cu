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
// from an optional initial one (zeros otherwise).
//
// Bound: bytes (a mamba2 layer at B = 8, S = 8192: 0.587 GB moved, 0.175 ms
// at 3.35 TB/s; the chunked form's 107.5 GFLOP at chunk 256 take 0.109 ms
// at 989 TFLOP/s).
//
//   bf16 (ssd_chunk_bf16): the chunked SSD, as the TPU kernel computes it,
//     on the tensor cores.  For each chunk of L steps (32 at the mamba2
//     head; 64 or 16 where the shared memory of the widths favours it),
//     with seg = cumsum(dt a):
//
//       y     = (C B^T o exp(seg_i - seg_j) dt_j, j <= i) X
//               + (C state^T) o exp(seg_i)
//       state = state exp(seg_L) + (X o exp(seg_L - seg) dt)^T B
//
//     One block of 8 warps per (head, 64-column tile of hd, batch), heads
//     fastest, so the heads of one batch row run together and read that
//     row's B and C chunks from L2.  The chunk axis the TPU kernel walks as
//     a sequential grid axis is a loop in the block.  The f32 state lives
//     in registers across it, in the accumulators of the update's MMAs
//     (four 16 x 16 tiles a warp at the mamba2 head, eight for the widest
//     N).  Each chunk's x, B, C and dt are staged by cp.async into one of
//     two buffers while the block computes the other.  Every product is
//     mma.sync m16n8k16 (bf16 in, f32 accumulate), operands fed by
//     ldmatrix (.trans where the operand is stored k-major).  C B^T is
//     exact; the three f32 operands (the masked decay matrix, the state
//     read for C state^T, and X o w of the update) are each split into a
//     bf16 high part and a bf16 remainder, staged in shared memory, and
//     both go through the MMA: the sum carries 16 bits of mantissa, where
//     one bf16 rounding (2^-9) would eat most of y's 2e-2 and the state's
//     2e-3 over a long sequence (tests/test_torch_ssd_precision.py emulates
//     this arithmetic).  seg is a warp scan that each warp runs for itself,
//     so a chunk needs two block barriers: one after its loads land, one
//     after the split operands are written.  The plan (chunk, hd tile)
//     prefers two blocks an SM, 97.5 KB of shared memory each at the
//     mamba2 head, so one block's barriers overlap the other's work.  Steps
//     past S are zero-filled with dt = 0, which leaves the state alone.  hd
//     must be a multiple of 8 and N a power of two from 8 (the wrapper
//     zero-pads); N is padded to 16 in shared memory.
//
//   f32 (ssd_kernel): the plain recurrence on the CUDA cores, the f32
//     state in registers.  One block per (32-column slice of hd, head,
//     batch); each hd column is held by NS = N / NPT lanes of one warp,
//     each with NPT entries of the state in registers, so a step is NPT
//     fused multiply-adds for the state and NPT for y, then log2(NS)
//     shuffles to sum y over the lanes.  B_t, C_t, x_t and dt_t of 32 steps
//     at a time are staged in shared memory, each lane's NPT entries of B
//     and C padded apart so the lanes of one column read them as float4
//     without bank conflicts; y of the 32 steps is written back in one
//     coalesced pass.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr unsigned kFull = 0xffffffffu;

// ------------------------------------------------- f32, the recurrence --

constexpr int kTT = 32;     // steps staged at a time
constexpr int kDB = 32;     // hd columns a block

// shared floats of one block
__host__ __device__ constexpr int smem_floats(int N, int NPT) {
  return 2 * kTT * (N / NPT) * (NPT + 4) + 2 * kTT * kDB + kTT;
}

template <int NPT>
__global__ void __launch_bounds__(1024)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ bm,
           const float* __restrict__ cm, const float* __restrict__ dt,
           const float* __restrict__ a, const float* __restrict__ state0,
           float* __restrict__ y, float* __restrict__ state_out, int S, int H,
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
      Bs[dst] = bm[src];
      Cs[dst] = cm[src];
    }
    for (int i = threadIdx.x; i < tn * DB; i += blockDim.x) {
      const int tt = i / DB, c = i % DB;
      Xs[tt * kDB + c] = x[(((long long)b * S + t0 + tt) * H + h) * P + d0 + c];
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
      y[(((long long)b * S + t0 + tt) * H + h) * P + d0 + c] = Ys[tt * kDB + c];
    }
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < NPT; ++i) state_out[st_off + i] = s[i];
  }
}

template <int NPT>
int launch_f32(const void* x, const void* bm, const void* cm, const void* dt,
               const void* a, const void* state0, void* y, void* state_out,
               int B, int S, int H, int P, int N, cudaStream_t st) {
  const int threads = kDB * (N / NPT);
  const size_t smem = sizeof(float) * smem_floats(N, NPT);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_kernel<NPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((P + kDB - 1) / kDB, H, B);
  ssd_kernel<NPT><<<grid, threads, smem, st>>>(
      (const float*)x, (const float*)bm, (const float*)cm, (const float*)dt,
      (const float*)a, (const float*)state0, (float*)y, (float*)state_out, S,
      H, P, N);
  return (int)cudaGetLastError();
}

int dispatch_f32(int npt, const void* x, const void* bm, const void* cm,
                 const void* dt, const void* a, const void* state0, void* y,
                 void* state_out, int B, int S, int H, int P, int N,
                 cudaStream_t st) {
  switch (npt) {
    case 4:
      return launch_f32<4>(x, bm, cm, dt, a, state0, y, state_out, B, S, H,
                           P, N, st);
    case 8:
      return launch_f32<8>(x, bm, cm, dt, a, state0, y, state_out, B, S, H,
                           P, N, st);
    case 16:
      return launch_f32<16>(x, bm, cm, dt, a, state0, y, state_out, B, S, H,
                            P, N, st);
    case 32:
      return launch_f32<32>(x, bm, cm, dt, a, state0, y, state_out, B, S, H,
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

// ---------------------------------------- bf16, the chunked SSD on MMAs --

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

// Shared memory of one block, in bytes from its start.  Row strides are
// padded by 8 halves (16 bytes) so the eight rows an ldmatrix phase reads
// fall in distinct 16-byte bank groups.
struct Layout {
  int L, PB, NP;        // chunk, hd columns, N padded to 16
  int xs, bs, ms, ws, ss;   // row strides (halves): X, B and C, M, Xw, state
  int x, bm, cm, mh, ml, wh, wl, sh, sl, dt, seg, bytes;
};

__host__ __device__ constexpr Layout layout(int L, int PB, int NP) {
  Layout s{};
  s.L = L;
  s.PB = PB;
  s.NP = NP;
  s.xs = PB + 8;
  s.bs = NP + 8;
  s.ms = L + 8;
  s.ws = L + 8;
  s.ss = NP + 8;
  int o = 0;
  s.x = o;   o += 2 * L * s.xs * 2;         // X (2 buffers, L, PB) bf16
  s.bm = o;  o += 2 * L * s.bs * 2;         // B (2, L, NP)
  s.cm = o;  o += 2 * L * s.bs * 2;         // C (2, L, NP)
  s.mh = o;  o += L * s.ms * 2;             // M (L, L): high part
  s.ml = o;  o += L * s.ms * 2;             //   and remainder
  s.wh = o;  o += PB * s.ws * 2;            // (X o w)^T (PB, L): high
  s.wl = o;  o += PB * s.ws * 2;            //   and remainder
  s.sh = o;  o += PB * s.ss * 2;            // state (PB, NP): high
  s.sl = o;  o += PB * s.ss * 2;            //   and remainder
  s.dt = o;  o += 2 * L * 4;                // dt (2, L) f32
  s.seg = o; o += kWarps * 3 * L * 4;       // per warp: seg, exp(seg), w
  s.bytes = o;
  return s;
}

__host__ __device__ constexpr int ilog2(int v) {
  int r = 0;
  while (v > 1) {
    v >>= 1;
    ++r;
  }
  return r;
}

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp16(uint32_t dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp4(uint32_t dst, const void* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void ldm(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldm_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a b, m16n8k16, bf16 in, f32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (u, v) as a bf16 pair, u in the low half, and the pair of remainders
__device__ __forceinline__ void split(float u, float v, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(u, v);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(u - hf.x, v - hf.y));
}

// Stage chunk c's steps t0 .. t0 + L into buffer `buf`: X's PB columns
// (xb: this block's x at step 0, rows xrow apart), B and C (bb, cb: this
// batch row's at step 0), dt (db, rows H apart); steps past S read as
// zeros (dt = 0 leaves the state alone).  Columns past P and past N are
// never written, so they keep the zeros the block starts with.  PB / 8 and
// N / 8 are powers of two (2^lgx, 2^lgn).
__device__ __forceinline__ void stage(const Layout& ly, char* smc, int buf,
                                      int t0, const bf16* xb, long long xrow,
                                      const bf16* bb, const bf16* cb,
                                      const float* db, int S, int H, int N,
                                      int xcols, int lgx, int lgn) {
  const int L = ly.L;
  const uint32_t xs = saddr(smc + ly.x) + buf * L * ly.xs * 2;
  const uint32_t bs = saddr(smc + ly.bm) + buf * L * ly.bs * 2;
  const uint32_t cs = saddr(smc + ly.cm) + buf * L * ly.bs * 2;
  const uint32_t ds = saddr(smc + ly.dt) + buf * L * 4;
  for (int i = threadIdx.x; i < (L << lgx); i += kThreads) {
    const int r = i >> lgx, q = i & ((1 << lgx) - 1), t = t0 + r;
    if (q * 8 >= xcols) continue;
    const bool ok = t < S;
    cp16(xs + (r * ly.xs + q * 8) * 2, ok ? xb + t * xrow + q * 8 : xb,
         ok ? 16 : 0);
  }
  for (int i = threadIdx.x; i < (L << lgn); i += kThreads) {
    const int r = i >> lgn, q = i & ((1 << lgn) - 1), t = t0 + r;
    const bool ok = t < S;
    const long long off = ok ? (long long)t * N + q * 8 : 0;
    const uint32_t dst = (r * ly.bs + q * 8) * 2;
    cp16(bs + dst, bb + off, ok ? 16 : 0);
    cp16(cs + dst, cb + off, ok ? 16 : 0);
  }
  if (threadIdx.x < L) {
    const int t = t0 + threadIdx.x;
    const bool ok = t < S;
    cp4(ds + threadIdx.x * 4, ok ? db + (long long)t * H : db, ok ? 4 : 0);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// The state's 16 x 16 tiles a warp holds in registers: (PB / 16) * (NP /
// 16) tiles over 8 warps, UPW a warp at most.  Two blocks share an SM at
// UPW = 4 (128 registers a thread), one at UPW = 8.  CL, CPB and CNP fix
// the chunk, hd tile and padded N at compile time (0: the arguments give
// them), so the mamba2 head's plan runs with its loops unrolled and its
// shared-memory offsets folded.
template <int UPW, int CL, int CPB, int CNP>
__global__ void __launch_bounds__(kThreads, UPW == 4 ? 2 : 1)
ssd_chunk_bf16(const bf16* __restrict__ x, const bf16* __restrict__ bm,
               const bf16* __restrict__ cm, const float* __restrict__ dt,
               const float* __restrict__ a, const float* __restrict__ state0,
               bf16* __restrict__ y, float* __restrict__ state_out, int S,
               int H, int P, int N, int L_, int PB_, int NP_) {
  extern __shared__ __align__(16) char smc[];
  const int L = CL ? CL : L_, PB = CPB ? CPB : PB_, NP = CNP ? CNP : NP_;
  if (CNP > 16) N = CNP;                        // N is a power of two
  const Layout ly = layout(L, PB, NP);
  const int h = blockIdx.x, p0 = blockIdx.y * PB, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;       // mma's groupID, thread in group
  const int lm = lane >> 3, lr = lane & 7;      // ldmatrix: matrix, row
  const float ah = a[h];
  const int nc = (S + L - 1) / L;
  const int lt = L / 16;                        // 16-step tiles of a chunk
  const int nk = NP / 16;                       // 16-wide k steps over N
  const int pt = PB / 16;                       // 16-column tiles of hd
  // this warp's 16 x 16 tiles: of y (L, PB) u = warp + 8k, all in step
  // tile ym; of the state (PB, NP) u = warp + 8k, all in hd tile srow
  const int yu = lt * pt, ym = warp % lt;
  const int nyu = warp < yu ? (yu - warp + kWarps - 1) / kWarps : 0;
  const int su = pt * nk, srow = warp % pt;

  for (int i = threadIdx.x; i < ly.bytes / 16; i += kThreads)
    reinterpret_cast<int4*>(smc)[i] = make_int4(0, 0, 0, 0);
  // the f32 state, in the mma accumulator layout
  float sacc[UPW][2][4];
  const long long s_base = ((long long)b * H + h) * P;
#pragma unroll
  for (int k = 0; k < UPW; ++k)
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int u = warp + k * kWarps;
        const int p = p0 + srow * 16 + g + (e >> 1) * 8;
        const int n = (u / pt) * 16 + q * 8 + tg * 2 + (e & 1);
        sacc[k][q][e] = (state0 != nullptr && u < su && p < P && n < N)
                            ? state0[(s_base + p) * N + n] : 0.f;
      }
  __syncthreads();
  const int lgx = ilog2(PB / 8), lgn = ilog2(N / 8);
  const long long xrow = (long long)H * P;
  const bf16* xb = x + ((long long)b * S * H + h) * P + p0;
  const bf16* bb = bm + (long long)b * S * N;
  const bf16* cb = cm + (long long)b * S * N;
  const float* db = dt + (long long)b * S * H + h;
  const int xcols = min(PB, P - p0);
  stage(ly, smc, 0, 0, xb, xrow, bb, cb, db, S, H, N, xcols, lgx, lgn);

  float* sg = reinterpret_cast<float*>(smc + ly.seg) + warp * 3 * L;
  float* eg = sg + L;                           // exp(seg)
  float* wg = eg + L;                           // exp(seg_L - seg) dt
  bf16* mhp = reinterpret_cast<bf16*>(smc + ly.mh);
  bf16* mlp = reinterpret_cast<bf16*>(smc + ly.ml);
  bf16* whp = reinterpret_cast<bf16*>(smc + ly.wh);
  bf16* wlp = reinterpret_cast<bf16*>(smc + ly.wl);
  bf16* shp = reinterpret_cast<bf16*>(smc + ly.sh);
  bf16* slp = reinterpret_cast<bf16*>(smc + ly.sl);
  const uint32_t mh = saddr(mhp), ml = saddr(mlp), wh = saddr(whp),
                 wl = saddr(wlp), sh = saddr(shp), sl = saddr(slp);

  for (int c = 0; c < nc; ++c) {
    const int buf = c & 1, t0 = c * L;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();        // chunk c landed; chunk c-1 is done everywhere
    if (c + 1 < nc)
      stage(ly, smc, buf ^ 1, t0 + L, xb, xrow, bb, cb, db, S, H, N, xcols,
            lgx, lgn);
    const bf16* xp = reinterpret_cast<const bf16*>(smc + ly.x) + buf * L * ly.xs;
    const uint32_t xs = saddr(xp);
    const uint32_t bs = saddr(smc + ly.bm) + buf * L * ly.bs * 2;
    const uint32_t cs = saddr(smc + ly.cm) + buf * L * ly.bs * 2;
    const float* dts = reinterpret_cast<const float*>(smc + ly.dt) + buf * L;

    // seg = cumsum(dt a) over the chunk, in this warp (steps lane, lane+32)
    {
      float v0 = lane < L ? dts[lane] * ah : 0.f;
      float v1 = lane + 32 < L ? dts[lane + 32] * ah : 0.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u0 = __shfl_up_sync(kFull, v0, o);
        const float u1 = __shfl_up_sync(kFull, v1, o);
        if (lane >= o) {
          v0 += u0;
          v1 += u1;
        }
      }
      v1 += __shfl_sync(kFull, v0, 31);
      const float last = __shfl_sync(kFull, L > 32 ? v1 : v0, (L - 1) & 31);
      if (lane < L) {
        sg[lane] = v0;
        eg[lane] = expf(v0);
        wg[lane] = expf(last - v0) * dts[lane];
      }
      if (lane + 32 < L) {
        sg[lane + 32] = v1;
        eg[lane + 32] = expf(v1);
        wg[lane + 32] = expf(last - v1) * dts[lane + 32];
      }
      __syncwarp();
    }

    // ---- phase A: the state entering the chunk, split, to shared memory;
    // (X o w)^T split; M = (C B^T o decay, causal) split
#pragma unroll
    for (int k = 0; k < UPW; ++k) {
      const int u = warp + k * kWarps;
      if (u >= su) break;
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int o = (srow * 16 + g + hf * 8) * ly.ss + (u / pt) * 16 +
                        q * 8 + tg * 2;
          uint32_t hi, lo;
          split(sacc[k][q][2 * hf], sacc[k][q][2 * hf + 1], hi, lo);
          *reinterpret_cast<uint32_t*>(shp + o) = hi;
          *reinterpret_cast<uint32_t*>(slp + o) = lo;
        }
    }
#pragma unroll
    for (int i = threadIdx.x; i < PB * (L / 2); i += kThreads) {
      const int p = i & (PB - 1), t = 2 * (i >> (lgx + 3));
      const float x0 = __bfloat162float(xp[t * ly.xs + p]);
      const float x1 = __bfloat162float(xp[(t + 1) * ly.xs + p]);
      uint32_t hi, lo;
      split(x0 * wg[t], x1 * wg[t + 1], hi, lo);
      *reinterpret_cast<uint32_t*>(whp + p * ly.ws + t) = hi;
      *reinterpret_cast<uint32_t*>(wlp + p * ly.ws + t) = lo;
    }
    for (int u = warp; u < lt * (lt + 1) / 2; u += kWarps) {
      int mi = 0, nj = u;
      while (nj > mi) nj -= ++mi;               // u -> (mi, nj <= mi)
      float acc[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < nk; ++kk) {
        uint32_t af[4], bf[4];
        ldm(af, cs + ((mi * 16 + (lm & 1) * 8 + lr) * ly.bs + kk * 16 +
                      (lm >> 1) * 8) * 2);
        ldm(bf, bs + ((nj * 16 + (lm >> 1) * 8 + lr) * ly.bs + kk * 16 +
                      (lm & 1) * 8) * 2);
        mma(acc[0], af, bf[0], bf[1]);
        mma(acc[1], af, bf[2], bf[3]);
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int i = mi * 16 + g + hf * 8;
          const int j = nj * 16 + q * 8 + tg * 2;
          const float si = sg[i];
          const float m0 = j <= i ? acc[q][2 * hf] * (__expf(si - sg[j]) *
                                                     dts[j]) : 0.f;
          const float m1 = j + 1 <= i ? acc[q][2 * hf + 1] *
                                            (__expf(si - sg[j + 1]) *
                                             dts[j + 1]) : 0.f;
          uint32_t hi, lo;
          split(m0, m1, hi, lo);
          *reinterpret_cast<uint32_t*>(mhp + i * ly.ms + j) = hi;
          *reinterpret_cast<uint32_t*>(mlp + i * ly.ms + j) = lo;
        }
      }
    }
    __syncthreads();        // the state, Xw and M are in shared memory

    // ---- phase B: y = (C state^T) o exp(seg) + M X, stored; then the
    // state in registers: state exp(seg_L) + (X o w)^T B
    for (int k = 0; k < nyu; ++k) {
      const int pj = (warp + k * kWarps) / lt;
      float yh[2][4] = {}, yl[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < nk; ++kk) {
        uint32_t af[4], bh[4], bl[4];
        ldm(af, cs + ((ym * 16 + (lm & 1) * 8 + lr) * ly.bs + kk * 16 +
                      (lm >> 1) * 8) * 2);
        const int o = ((pj * 16 + (lm >> 1) * 8 + lr) * ly.ss + kk * 16 +
                       (lm & 1) * 8) * 2;
        ldm(bh, sh + o);
        ldm(bl, sl + o);
        mma(yh[0], af, bh[0], bh[1]);
        mma(yh[1], af, bh[2], bh[3]);
        mma(yl[0], af, bl[0], bl[1]);
        mma(yl[1], af, bl[2], bl[3]);
      }
      const float e0 = eg[ym * 16 + g], e1 = eg[ym * 16 + g + 8];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        yh[q][0] = (yh[q][0] + yl[q][0]) * e0;
        yh[q][1] = (yh[q][1] + yl[q][1]) * e0;
        yh[q][2] = (yh[q][2] + yl[q][2]) * e1;
        yh[q][3] = (yh[q][3] + yl[q][3]) * e1;
      }
      for (int kk = 0; kk <= ym; ++kk) {
        uint32_t ah_[4], al_[4], bf[4];
        const int o = ((ym * 16 + (lm & 1) * 8 + lr) * ly.ms + kk * 16 +
                       (lm >> 1) * 8) * 2;
        ldm(ah_, mh + o);
        ldm(al_, ml + o);
        ldm_t(bf, xs + ((kk * 16 + (lm & 1) * 8 + lr) * ly.xs + pj * 16 +
                        (lm >> 1) * 8) * 2);
        mma(yh[0], ah_, bf[0], bf[1]);
        mma(yh[1], ah_, bf[2], bf[3]);
        mma(yh[0], al_, bf[0], bf[1]);
        mma(yh[1], al_, bf[2], bf[3]);
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int p = p0 + pj * 16 + q * 8 + tg * 2;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int t = t0 + ym * 16 + g + hf * 8;
          if (t < S && p < P)
            *reinterpret_cast<__nv_bfloat162*>(
                y + (((long long)b * S + t) * H + h) * P + p) =
                __floats2bfloat162_rn(yh[q][2 * hf], yh[q][2 * hf + 1]);
        }
      }
    }

    const float dl = eg[L - 1];
#pragma unroll
    for (int k = 0; k < UPW; ++k)
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[k][q][e] *= dl;
#pragma unroll
    for (int kk = 0; kk < lt; ++kk) {
      uint32_t ahi[4], alo[4];
      const int o = ((srow * 16 + (lm & 1) * 8 + lr) * ly.ws + kk * 16 +
                     (lm >> 1) * 8) * 2;
      ldm(ahi, wh + o);
      ldm(alo, wl + o);
#pragma unroll
      for (int k = 0; k < UPW; ++k) {
        const int u = warp + k * kWarps;
        if (u >= su) break;
        uint32_t bf[4];
        ldm_t(bf, bs + ((kk * 16 + (lm & 1) * 8 + lr) * ly.bs + (u / pt) * 16 +
                        (lm >> 1) * 8) * 2);
        mma(sacc[k][0], ahi, bf[0], bf[1]);
        mma(sacc[k][1], ahi, bf[2], bf[3]);
        mma(sacc[k][0], alo, bf[0], bf[1]);
        mma(sacc[k][1], alo, bf[2], bf[3]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < UPW; ++k)
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int u = warp + k * kWarps;
        const int p = p0 + srow * 16 + g + (e >> 1) * 8;
        const int n = (u / pt) * 16 + q * 8 + tg * 2 + (e & 1);
        if (u < su && p < P && n < N)
          state_out[(s_base + p) * N + n] = sacc[k][q][e];
      }
}

// The chunk and hd tile for (P, N): the widest hd tile (64, 32 or 16
// columns, no wider than P needs) whose state (tile x N) fits 8 warps' 64
// tiles of registers, then the longest chunk, with which two blocks share
// an SM's shared memory (smem_sm bytes, 1 KB of it reserved a block) and
// four state tiles a warp suffice; failing that, the first whose block
// fits the opt-in limit smem_max alone.  Returns the state tiles a warp
// holds (4 or 8), or -1.
int chunk_plan(int P, int N, int smem_sm, int smem_max, int* L, int* PB,
               int* NP) {
  *NP = (N + 15) / 16 * 16;
  const int pb0 = P > 32 ? 64 : (P > 16 ? 32 : 16);
  for (int pass = 0; pass < 2; ++pass)
    for (int pb = pb0; pb >= 16; pb /= 2) {
      const int upw = (pb / 16) * (*NP / 16) <= 4 * kWarps ? 4 : 8;
      if ((pb / 16) * (*NP / 16) > upw * kWarps || (pass == 0 && upw > 4))
        continue;
      for (int l = 64; l >= 16; l /= 2) {
        const int bytes = layout(l, pb, *NP).bytes;
        if (pass == 0 ? 2 * (bytes + 1024) <= smem_sm : bytes <= smem_max) {
          *L = l;
          *PB = pb;
          return upw;
        }
      }
    }
  return -1;
}

template <int UPW, int CL, int CPB, int CNP>
int launch_chunked(const void* x, const void* bm, const void* cm,
                   const void* dt, const void* a, const void* state0, void* y,
                   void* state_out, int B, int S, int H, int P, int N, int L,
                   int PB, int NP, cudaStream_t st) {
  const int bytes = layout(L, PB, NP).bytes;
  auto* kern = ssd_chunk_bf16<UPW, CL, CPB, CNP>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(H, (P + PB - 1) / PB, B);
  kern<<<grid, kThreads, bytes, st>>>(
      (const bf16*)x, (const bf16*)bm, (const bf16*)cm, (const float*)dt,
      (const float*)a, (const float*)state0, (bf16*)y, (float*)state_out, S,
      H, P, N, L, PB, NP);
  return (int)cudaGetLastError();
}

// chunk_plan under the current device's shared-memory limits; sets *upw.
cudaError_t device_plan(int P, int N, int* L, int* PB, int* NP, int* upw) {
  int dev = 0, smem_sm = 0, smem_max = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem_sm,
                               cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  *upw = chunk_plan(P, N, smem_sm, smem_max, L, PB, NP);
  return *upw < 0 ? cudaErrorInvalidValue : cudaSuccess;
}

int launch_bf16(const void* x, const void* bm, const void* cm, const void* dt,
                const void* a, const void* state0, void* y, void* state_out,
                int B, int S, int H, int P, int N, cudaStream_t st) {
  if (P % 8 || N < 8 || (N & (N - 1))) return (int)cudaErrorInvalidValue;
  int L, PB, NP, upw;
  const cudaError_t e = device_plan(P, N, &L, &PB, &NP, &upw);
  if (e != cudaSuccess) return (int)e;
  if (upw == 4 && L == 32 && PB == 64 && NP == 128)     // the mamba2 head
    return launch_chunked<4, 32, 64, 128>(x, bm, cm, dt, a, state0, y,
                                          state_out, B, S, H, P, N, L, PB,
                                          NP, st);
  if (upw == 4)
    return launch_chunked<4, 0, 0, 0>(x, bm, cm, dt, a, state0, y, state_out,
                                      B, S, H, P, N, L, PB, NP, st);
  if (upw == 8)
    return launch_chunked<8, 0, 0, 0>(x, bm, cm, dt, a, state0, y, state_out,
                                      B, S, H, P, N, L, PB, NP, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// xh (B, S, H, P) and bv/cv (B, S, N) f32 (is_bf16 = 0) or bf16 (1);
// dt (B, S, H) f32, a (H,) f32, state0 (B, H, P, N) f32 or null; y like xh,
// state_out (B, H, P, N) f32.  All contiguous; bf16 needs P and N
// multiples of 8 and 16-byte aligned x, bv, cv.  Launches on the current
// device.
int ssd_scan_fwd(const void* x, const void* bm, const void* cm,
                 const void* dt, const void* a, const void* state0, void* y,
                 void* state_out, int B, int S, int H, int P, int N,
                 int is_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return launch_bf16(x, bm, cm, dt, a, state0, y, state_out, B, S, H, P, N,
                       st);
  return dispatch_f32(state_per_lane(N), x, bm, cm, dt, a, state0, y,
                      state_out, B, S, H, P, N, st);
}

// The bf16 body's chunk length, hd tile and shared bytes for (P, N) on the
// current device (for the record).
int ssd_chunk_plan(int P, int N, int* out3) {
  int L, PB, NP, upw;
  const cudaError_t e = device_plan(P, N, &L, &PB, &NP, &upw);
  if (e != cudaSuccess) return (int)e;
  out3[0] = L;
  out3[1] = PB;
  out3[2] = layout(L, PB, NP).bytes;
  return 0;
}

}  // extern "C"
