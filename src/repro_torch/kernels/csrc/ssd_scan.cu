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
//   The chunked SSD, as the TPU kernel computes it, on the tensor cores,
//   one body for both input types (ssd_chunk_bf16, ssd_chunk_f32).  For
//   each chunk of L steps, with seg = cumsum(dt a):
//
//       y     = (C B^T o exp(seg_i - seg_j) dt_j, j <= i) X
//               + (C state^T) o exp(seg_i)
//       state = state exp(seg_L) + (X o exp(seg_L - seg) dt)^T B
//
//   One block of 8 warps per (head, hd tile of 16, 32 or 64 columns,
//   batch), heads fastest, so the heads of one batch row run together and
//   read that row's B and C chunks from L2.  The chunk axis the TPU kernel
//   walks as a sequential grid axis is a loop in the block.  The f32 state
//   lives in registers across it, in the accumulators of the update's MMAs
//   (four 16 x 16 tiles a warp at the mamba2 head, eight for the widest N).
//   Each chunk's x, B, C and dt are staged by cp.async into one of two
//   buffers while the block computes the other (one buffer, and no
//   overlap, where two do not fit: f32 at N = 1024).  Every product is
//   mma.sync m16n8k16 (bf16 in, f32 accumulate), operands fed by ldmatrix
//   (.trans where the operand is stored k-major).  The f32 operands (the
//   masked decay matrix, the state read for C state^T, and X o w of the
//   update) are each split into a bf16 high part and a bf16 remainder,
//   staged in shared memory, and both go through the MMA: the sum carries
//   16 bits of mantissa, where one bf16 rounding (2^-9) would eat most of
//   y's 2e-2 and the state's 2e-3 over a long sequence.  seg is a warp scan
//   that each warp runs for itself.  Steps past S are zero-filled with dt =
//   0, which leaves the state alone.  hd must be a multiple of 8 and N a
//   power of two from 8 (the wrapper zero-pads); N is padded to 16 in
//   shared memory.  tests/test_torch_ssd_precision.py emulates both
//   instances' arithmetic.
//
//   bf16 (ssd_chunk_bf16): x, B and C are exact bf16 operands, so C B^T,
//     M X and the update's B take one MMA per term of the split, and a
//     chunk needs two block barriers: one after its loads land, one after
//     the split operands are written.  The plan prefers two blocks an SM
//     (chunk 32 and a 64-column hd tile at the mamba2 head, 97.5 KB each),
//     so one block's barriers overlap the other's work.
//
//   f32 (ssd_chunk_f32): x, B and C land as f32 (row stride width + 4
//     floats) and a pass splits each row in place into a bf16 high part
//     (the row's first half) and a bf16 remainder (its second half), every
//     row read by one warp before it writes; the same pass forms X o w from
//     the f32 x.  Every product of two inputs takes three MMAs, hi.hi +
//     hi.lo + lo.hi (C B^T, M X, C state^T, (X o w)^T B), so each carries
//     ~16 bits, as the bf16 instance's f32 operands do, and y and the state
//     hold 2e-3 against an f32 reference.  The split pass adds a third
//     block barrier a chunk.  At the mamba2 head the f32 staging doubles x,
//     B and C: the plan keeps two blocks an SM with chunks of 16 steps
//     (84.6 KB each; chunk 32 would take 135 KB and one block an SM), and
//     at N = 1024 one buffer of 16 steps (199 KB) is all that fits.
//
// Bound: bytes at the mamba2 head in either type (bf16: 0.587 GB moved,
// 0.175 ms at 3.35 TB/s; f32: 1.16 GB, 0.346 ms).  The chunked form's
// products at chunk 256 are 107.5 GFLOP, 0.109 ms at 989 TFLOP/s; the
// split products repeat each product two or three times at a shorter
// chunk, still under the bytes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr unsigned kFull = 0xffffffffu;

// ------------------------------------------ the chunked SSD on MMAs --

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxPairs = 16;   // f32 split: column pairs a lane holds of a
                                // B or C row (N up to 1024)

// Shared memory of one block, in bytes from its start.  Row strides are
// padded so the eight rows an ldmatrix phase reads fall in distinct
// 16-byte bank groups: by 8 halves (16 bytes) for bf16 rows, by 4 floats
// for f32 rows, whose first half then holds the bf16 high parts and the
// second half the remainders (at halves xlo, blo of the row).
struct Layout {
  int L, PB, NP, stages;    // chunk, hd columns, N padded to 16, buffers
  int xs, bs, ms, ws, ss;   // row strides (halves): X, B and C, M, Xw, state
  int xlo, blo;             // f32: a row's remainders, in halves from it
  int x, bm, cm, mh, ml, wh, wl, sh, sl, dt, seg, bytes;
};

// esz: bytes of a staged x, B or C element (2 for bf16, 4 for f32)
__host__ __device__ constexpr Layout layout(int L, int PB, int NP, int esz,
                                            int stages) {
  Layout s{};
  s.L = L;
  s.PB = PB;
  s.NP = NP;
  s.stages = stages;
  s.xs = esz == 2 ? PB + 8 : 2 * (PB + 4);
  s.bs = esz == 2 ? NP + 8 : 2 * (NP + 4);
  s.xlo = esz == 2 ? 0 : PB;
  s.blo = esz == 2 ? 0 : NP;
  s.ms = L + 8;
  s.ws = L + 8;
  s.ss = NP + 8;
  int o = 0;
  s.x = o;   o += stages * L * s.xs * 2;    // X (buffers, L, PB)
  s.bm = o;  o += stages * L * s.bs * 2;    // B (buffers, L, NP)
  s.cm = o;  o += stages * L * s.bs * 2;    // C (buffers, L, NP)
  s.mh = o;  o += L * s.ms * 2;             // M (L, L): high part
  s.ml = o;  o += L * s.ms * 2;             //   and remainder
  s.wh = o;  o += PB * s.ws * 2;            // (X o w)^T (PB, L): high
  s.wl = o;  o += PB * s.ws * 2;            //   and remainder
  s.sh = o;  o += PB * s.ss * 2;            // state (PB, NP): high
  s.sl = o;  o += PB * s.ss * 2;            //   and remainder
  s.dt = o;  o += stages * L * 4;           // dt (buffers, L) f32
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

__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// y's two neighbouring columns in the output type
__device__ __forceinline__ void store2(bf16* p, float u, float v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(u, v);
}
__device__ __forceinline__ void store2(float* p, float u, float v) {
  *reinterpret_cast<float2*>(p) = make_float2(u, v);
}

// Stage chunk c's steps t0 .. t0 + L into buffer `buf`: X's PB columns
// (xb: this block's x at step 0, rows xrow apart; xcols of them real), B
// and C's NP columns (bb, cb: this batch row's at step 0; N real), dt (db,
// rows H apart).  Steps past S, and columns past xcols and N, land as
// zeros (dt = 0 leaves the state alone).  Copies are 16 bytes, E = 16 /
// sizeof(T) elements; PB / E = 2^lgx and NP / E = 2^lgn copies a row.
template <typename T>
__device__ __forceinline__ void stage(const Layout& ly, char* smc, int buf,
                                      int t0, const T* xb, long long xrow,
                                      const T* bb, const T* cb,
                                      const float* db, int S, int H, int N,
                                      int xcols, int lgx, int lgn) {
  constexpr int E = 16 / sizeof(T);
  const int L = ly.L;
  const uint32_t xs = saddr(smc + ly.x) + buf * L * ly.xs * 2;
  const uint32_t bs = saddr(smc + ly.bm) + buf * L * ly.bs * 2;
  const uint32_t cs = saddr(smc + ly.cm) + buf * L * ly.bs * 2;
  const uint32_t ds = saddr(smc + ly.dt) + buf * L * 4;
  for (int i = threadIdx.x; i < (L << lgx); i += kThreads) {
    const int r = i >> lgx, q = i & ((1 << lgx) - 1), t = t0 + r;
    const bool ok = t < S && q * E < xcols;
    cp16(xs + r * ly.xs * 2 + q * 16, ok ? xb + t * xrow + q * E : xb,
         ok ? 16 : 0);
  }
  for (int i = threadIdx.x; i < (L << lgn); i += kThreads) {
    const int r = i >> lgn, q = i & ((1 << lgn) - 1), t = t0 + r;
    const bool ok = t < S && q * E < N;
    const long long off = ok ? (long long)t * N + q * E : 0;
    const uint32_t dst = r * ly.bs * 2 + q * 16;
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

// f32: the staged rows of one buffer split in place.  X's rows go in
// pairs (t, t + 1), a lane a column pair (PB <= 64), and (X o w)^T's
// split is written beside; then B's and C's rows one at a time, a lane up
// to NPL column pairs.  Each row is read whole by its warp before the warp
// writes it.
template <int NPL>
__device__ __forceinline__ void split_rows(const Layout& ly, char* smc,
                                           int buf, const float* wg,
                                           bf16* whp, bf16* wlp, int warp,
                                           int lane) {
  const int L = ly.L, PB = ly.PB, NP = ly.NP;
  const int rx = ly.xs / 2, rb = ly.bs / 2;       // f32 row strides
  float* xr = reinterpret_cast<float*>(smc + ly.x) + buf * L * rx;
  const int p = 2 * lane;
  for (int t = 2 * warp; t < L; t += 2 * kWarps) {
    float2 u0 = make_float2(0.f, 0.f), u1 = u0;
    if (p < PB) {
      u0 = *reinterpret_cast<const float2*>(xr + t * rx + p);
      u1 = *reinterpret_cast<const float2*>(xr + (t + 1) * rx + p);
    }
    __syncwarp();
    if (p < PB) {
      bf16* h0 = reinterpret_cast<bf16*>(xr + t * rx);
      bf16* h1 = reinterpret_cast<bf16*>(xr + (t + 1) * rx);
      uint32_t hi, lo;
      split(u0.x, u0.y, hi, lo);
      *reinterpret_cast<uint32_t*>(h0 + p) = hi;
      *reinterpret_cast<uint32_t*>(h0 + PB + p) = lo;
      split(u1.x, u1.y, hi, lo);
      *reinterpret_cast<uint32_t*>(h1 + p) = hi;
      *reinterpret_cast<uint32_t*>(h1 + PB + p) = lo;
      split(u0.x * wg[t], u1.x * wg[t + 1], hi, lo);
      *reinterpret_cast<uint32_t*>(whp + p * ly.ws + t) = hi;
      *reinterpret_cast<uint32_t*>(wlp + p * ly.ws + t) = lo;
      split(u0.y * wg[t], u1.y * wg[t + 1], hi, lo);
      *reinterpret_cast<uint32_t*>(whp + (p + 1) * ly.ws + t) = hi;
      *reinterpret_cast<uint32_t*>(wlp + (p + 1) * ly.ws + t) = lo;
    }
  }
  float* br = reinterpret_cast<float*>(smc + ly.bm) + buf * L * rb;
  float* cr = reinterpret_cast<float*>(smc + ly.cm) + buf * L * rb;
  for (int r = warp; r < 2 * L; r += kWarps) {
    float* row = (r < L ? br : cr) + (r % L) * rb;
    float2 u[NPL];
#pragma unroll
    for (int i = 0; i < NPL; ++i)
      if (p + 64 * i < NP)
        u[i] = *reinterpret_cast<const float2*>(row + p + 64 * i);
    __syncwarp();
    bf16* h = reinterpret_cast<bf16*>(row);
#pragma unroll
    for (int i = 0; i < NPL; ++i)
      if (p + 64 * i < NP) {
        uint32_t hi, lo;
        split(u[i].x, u[i].y, hi, lo);
        *reinterpret_cast<uint32_t*>(h + p + 64 * i) = hi;
        *reinterpret_cast<uint32_t*>(h + NP + p + 64 * i) = lo;
      }
  }
}

// The body of both instances.  T: the type of x, B, C and y.  The state's
// 16 x 16 tiles a warp holds in registers: (PB / 16) * (NP / 16) tiles
// over 8 warps, UPW a warp at most.  Two blocks share an SM at UPW = 4
// (128 registers a thread), one at UPW = 8.  CL, CPB and CNP fix the
// chunk, hd tile and padded N at compile time (0: the arguments give
// them), so the mamba2 head's plan runs with its loops unrolled and its
// shared-memory offsets folded.
template <typename T, int UPW, int CL, int CPB, int CNP>
__device__ __forceinline__ void ssd_chunk(
    const T* __restrict__ x, const T* __restrict__ bm,
    const T* __restrict__ cm, const float* __restrict__ dt,
    const float* __restrict__ a, const float* __restrict__ state0,
    T* __restrict__ y, float* __restrict__ state_out, int S, int H, int P,
    int N, int L_, int PB_, int NP_, int stages) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int kE = 16 / sizeof(T);            // elements a 16-byte copy
  extern __shared__ __align__(16) char smc[];
  const int L = CL ? CL : L_, PB = CPB ? CPB : PB_, NP = CNP ? CNP : NP_;
  if (CNP > 16) N = CNP;                        // N is a power of two
  const Layout ly = layout(L, PB, NP, sizeof(T), stages);
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
  const int lgx = ilog2(PB / kE), lgn = ilog2(NP / kE), lgp = ilog2(PB);
  const long long xrow = (long long)H * P;
  const T* xb = x + ((long long)b * S * H + h) * P + p0;
  const T* bb = bm + (long long)b * S * N;
  const T* cb = cm + (long long)b * S * N;
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
  const int xlo = 2 * ly.xlo, blo = 2 * ly.blo;  // f32: remainders, bytes

  for (int c = 0; c < nc; ++c) {
    const int buf = stages == 2 ? c & 1 : 0, t0 = c * L;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();        // chunk c landed; chunk c-1 is done everywhere
    if (stages == 2 && c + 1 < nc)
      stage(ly, smc, buf ^ 1, t0 + L, xb, xrow, bb, cb, db, S, H, N, xcols,
            lgx, lgn);
    const T* xp = reinterpret_cast<const T*>(smc + ly.x) + buf * L * ly.xs *
                  2 / sizeof(T);
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
    // (X o w)^T split; f32: x, B and C split in place, then a barrier;
    // M = (C B^T o decay, causal) split
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
    if constexpr (kF32) {
      split_rows<CNP ? (CNP + 63) / 64 : kMaxPairs>(ly, smc, buf, wg, whp,
                                                     wlp, warp, lane);
      __syncthreads();      // x, B and C are split
    } else {
#pragma unroll
      for (int i = threadIdx.x; i < PB * (L / 2); i += kThreads) {
        const int p = i & (PB - 1), t = 2 * (i >> lgp);
        const float x0 = to_f32(xp[t * ly.xs + p]);
        const float x1 = to_f32(xp[(t + 1) * ly.xs + p]);
        uint32_t hi, lo;
        split(x0 * wg[t], x1 * wg[t + 1], hi, lo);
        *reinterpret_cast<uint32_t*>(whp + p * ly.ws + t) = hi;
        *reinterpret_cast<uint32_t*>(wlp + p * ly.ws + t) = lo;
      }
    }
    for (int u = warp; u < lt * (lt + 1) / 2; u += kWarps) {
      int mi = 0, nj = u;
      while (nj > mi) nj -= ++mi;               // u -> (mi, nj <= mi)
      float acc[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < nk; ++kk) {
        uint32_t af[4], bf[4];
        const uint32_t ao = ((mi * 16 + (lm & 1) * 8 + lr) * ly.bs + kk * 16 +
                             (lm >> 1) * 8) * 2;
        const uint32_t bo = ((nj * 16 + (lm >> 1) * 8 + lr) * ly.bs + kk * 16 +
                             (lm & 1) * 8) * 2;
        ldm(af, cs + ao);
        ldm(bf, bs + bo);
        if constexpr (kF32) {                   // C_hi B_lo + C_lo B_hi
          uint32_t al[4], bl[4];
          ldm(al, cs + ao + blo);
          ldm(bl, bs + bo + blo);
          mma(acc[0], af, bl[0], bl[1]);
          mma(acc[1], af, bl[2], bl[3]);
          mma(acc[0], al, bf[0], bf[1]);
          mma(acc[1], al, bf[2], bf[3]);
        }
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
        const uint32_t ao = ((ym * 16 + (lm & 1) * 8 + lr) * ly.bs + kk * 16 +
                             (lm >> 1) * 8) * 2;
        ldm(af, cs + ao);
        const int o = ((pj * 16 + (lm >> 1) * 8 + lr) * ly.ss + kk * 16 +
                       (lm & 1) * 8) * 2;
        ldm(bh, sh + o);
        ldm(bl, sl + o);
        mma(yh[0], af, bh[0], bh[1]);
        mma(yh[1], af, bh[2], bh[3]);
        mma(yl[0], af, bl[0], bl[1]);
        mma(yl[1], af, bl[2], bl[3]);
        if constexpr (kF32) {                   // C_lo state_hi
          uint32_t al[4];
          ldm(al, cs + ao + blo);
          mma(yl[0], al, bh[0], bh[1]);
          mma(yl[1], al, bh[2], bh[3]);
        }
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
        const uint32_t xo = ((kk * 16 + (lm & 1) * 8 + lr) * ly.xs + pj * 16 +
                             (lm >> 1) * 8) * 2;
        ldm(ah_, mh + o);
        ldm(al_, ml + o);
        ldm_t(bf, xs + xo);
        if constexpr (kF32) {                   // M_hi X_lo
          uint32_t xl[4];
          ldm_t(xl, xs + xo + xlo);
          mma(yh[0], ah_, xl[0], xl[1]);
          mma(yh[1], ah_, xl[2], xl[3]);
        }
        mma(yh[0], al_, bf[0], bf[1]);
        mma(yh[1], al_, bf[2], bf[3]);
        mma(yh[0], ah_, bf[0], bf[1]);
        mma(yh[1], ah_, bf[2], bf[3]);
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int p = p0 + pj * 16 + q * 8 + tg * 2;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int t = t0 + ym * 16 + g + hf * 8;
          if (t < S && p < P)
            store2(y + (((long long)b * S + t) * H + h) * P + p,
                   yh[q][2 * hf], yh[q][2 * hf + 1]);
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
        const uint32_t bo = ((kk * 16 + (lm & 1) * 8 + lr) * ly.bs +
                             (u / pt) * 16 + (lm >> 1) * 8) * 2;
        ldm_t(bf, bs + bo);
        if constexpr (kF32) {                   // (X o w)_hi B_lo
          uint32_t bl[4];
          ldm_t(bl, bs + bo + blo);
          mma(sacc[k][0], ahi, bl[0], bl[1]);
          mma(sacc[k][1], ahi, bl[2], bl[3]);
        }
        mma(sacc[k][0], ahi, bf[0], bf[1]);
        mma(sacc[k][1], ahi, bf[2], bf[3]);
        mma(sacc[k][0], alo, bf[0], bf[1]);
        mma(sacc[k][1], alo, bf[2], bf[3]);
      }
    }
    if (stages == 1 && c + 1 < nc) {
      __syncthreads();      // every warp is done with the one buffer
      stage(ly, smc, 0, t0 + L, xb, xrow, bb, cb, db, S, H, N, xcols, lgx,
            lgn);
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

template <int UPW, int CL, int CPB, int CNP>
__global__ void __launch_bounds__(kThreads, UPW == 4 ? 2 : 1)
ssd_chunk_bf16(const bf16* __restrict__ x, const bf16* __restrict__ bm,
               const bf16* __restrict__ cm, const float* __restrict__ dt,
               const float* __restrict__ a, const float* __restrict__ state0,
               bf16* __restrict__ y, float* __restrict__ state_out, int S,
               int H, int P, int N, int L, int PB, int NP, int stages) {
  ssd_chunk<bf16, UPW, CL, CPB, CNP>(x, bm, cm, dt, a, state0, y, state_out,
                                     S, H, P, N, L, PB, NP, stages);
}

template <int UPW, int CL, int CPB, int CNP>
__global__ void __launch_bounds__(kThreads, UPW == 4 ? 2 : 1)
ssd_chunk_f32(const float* __restrict__ x, const float* __restrict__ bm,
              const float* __restrict__ cm, const float* __restrict__ dt,
              const float* __restrict__ a, const float* __restrict__ state0,
              float* __restrict__ y, float* __restrict__ state_out, int S,
              int H, int P, int N, int L, int PB, int NP, int stages) {
  ssd_chunk<float, UPW, CL, CPB, CNP>(x, bm, cm, dt, a, state0, y,
                                      state_out, S, H, P, N, L, PB, NP,
                                      stages);
}

// The chunk and hd tile for (P, N) and staged elements of esz bytes: the
// widest hd tile (64, 32 or 16 columns, no wider than P needs) whose state
// (tile x N) fits 8 warps' 64 tiles of registers, then the longest chunk,
// with which two blocks share an SM's shared memory (smem_sm bytes, 1 KB
// of it reserved a block) and four state tiles a warp suffice; failing
// that, the first whose block fits the opt-in limit smem_max alone with
// two buffers; failing that, with one.  Returns the state tiles a warp
// holds (4 or 8), or -1.
int chunk_plan(int P, int N, int esz, int smem_sm, int smem_max, int* L,
               int* PB, int* NP, int* stages) {
  *NP = (N + 15) / 16 * 16;
  const int pb0 = P > 32 ? 64 : (P > 16 ? 32 : 16);
  for (int pass = 0; pass < 3; ++pass)
    for (int pb = pb0; pb >= 16; pb /= 2) {
      const int upw = (pb / 16) * (*NP / 16) <= 4 * kWarps ? 4 : 8;
      if ((pb / 16) * (*NP / 16) > upw * kWarps || (pass == 0 && upw > 4))
        continue;
      const int st = pass < 2 ? 2 : 1;
      for (int l = 64; l >= 16; l /= 2) {
        const int bytes = layout(l, pb, *NP, esz, st).bytes;
        if (pass == 0 ? 2 * (bytes + 1024) <= smem_sm : bytes <= smem_max) {
          *L = l;
          *PB = pb;
          *stages = st;
          return upw;
        }
      }
    }
  return -1;
}

template <typename T, int UPW, int CL, int CPB, int CNP>
int launch_chunked(const void* x, const void* bm, const void* cm,
                   const void* dt, const void* a, const void* state0, void* y,
                   void* state_out, int B, int S, int H, int P, int N, int L,
                   int PB, int NP, int stages, cudaStream_t st) {
  const int bytes = layout(L, PB, NP, sizeof(T), stages).bytes;
  void (*kern)(const T*, const T*, const T*, const float*, const float*,
               const float*, T*, float*, int, int, int, int, int, int, int,
               int);
  if constexpr (sizeof(T) == 4)
    kern = ssd_chunk_f32<UPW, CL, CPB, CNP>;
  else
    kern = ssd_chunk_bf16<UPW, CL, CPB, CNP>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(H, (P + PB - 1) / PB, B);
  kern<<<grid, kThreads, bytes, st>>>(
      (const T*)x, (const T*)bm, (const T*)cm, (const float*)dt,
      (const float*)a, (const float*)state0, (T*)y, (float*)state_out, S, H,
      P, N, L, PB, NP, stages);
  return (int)cudaGetLastError();
}

// chunk_plan under the current device's shared-memory limits; sets *upw.
cudaError_t device_plan(int P, int N, int esz, int* L, int* PB, int* NP,
                        int* stages, int* upw) {
  int dev = 0, smem_sm = 0, smem_max = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem_sm,
                               cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  *upw = chunk_plan(P, N, esz, smem_sm, smem_max, L, PB, NP, stages);
  return *upw < 0 ? cudaErrorInvalidValue : cudaSuccess;
}

// The mamba2 head's plan in each type (hd 64, N 128: bf16 chunk 32, f32
// chunk 16, both two blocks an SM) runs a specialised instance.
template <typename T>
int launch(const void* x, const void* bm, const void* cm, const void* dt,
           const void* a, const void* state0, void* y, void* state_out, int B,
           int S, int H, int P, int N, cudaStream_t st) {
  if (P % 8 || N < 8 || (N & (N - 1))) return (int)cudaErrorInvalidValue;
  int L, PB, NP, stages, upw;
  const cudaError_t e =
      device_plan(P, N, sizeof(T), &L, &PB, &NP, &stages, &upw);
  if (e != cudaSuccess) return (int)e;
  constexpr int kHeadL = sizeof(T) == 4 ? 16 : 32;
  if (upw == 4 && L == kHeadL && PB == 64 && NP == 128 && stages == 2)
    return launch_chunked<T, 4, kHeadL, 64, 128>(
        x, bm, cm, dt, a, state0, y, state_out, B, S, H, P, N, L, PB, NP,
        stages, st);
  if (upw == 4)
    return launch_chunked<T, 4, 0, 0, 0>(x, bm, cm, dt, a, state0, y,
                                         state_out, B, S, H, P, N, L, PB, NP,
                                         stages, st);
  if (upw == 8)
    return launch_chunked<T, 8, 0, 0, 0>(x, bm, cm, dt, a, state0, y,
                                         state_out, B, S, H, P, N, L, PB, NP,
                                         stages, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// xh (B, S, H, P) and bv/cv (B, S, N) f32 (is_bf16 = 0) or bf16 (1);
// dt (B, S, H) f32, a (H,) f32, state0 (B, H, P, N) f32 or null; y like xh,
// state_out (B, H, P, N) f32.  All contiguous and 16-byte aligned; P a
// multiple of 8 and N a power of two from 8 up to 1024.  Launches on the
// current device.
int ssd_scan_fwd(const void* x, const void* bm, const void* cm,
                 const void* dt, const void* a, const void* state0, void* y,
                 void* state_out, int B, int S, int H, int P, int N,
                 int is_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return launch<bf16>(x, bm, cm, dt, a, state0, y, state_out, B, S, H, P,
                        N, st);
  return launch<float>(x, bm, cm, dt, a, state0, y, state_out, B, S, H, P,
                       N, st);
}

// The chunk length, hd tile, shared bytes and buffers for (P, N) in bf16
// (is_bf16 = 1) or f32 on the current device (for the record).
int ssd_chunk_plan(int P, int N, int is_bf16, int* out4) {
  int L, PB, NP, stages, upw;
  const int esz = is_bf16 ? 2 : 4;
  const cudaError_t e = device_plan(P, N, esz, &L, &PB, &NP, &stages, &upw);
  if (e != cudaSuccess) return (int)e;
  out4[0] = L;
  out4[1] = PB;
  out4[2] = layout(L, PB, NP, esz, stages).bytes;
  out4[3] = stages;
  return 0;
}

}  // extern "C"
