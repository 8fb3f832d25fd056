// Blockwise causal GQA attention (the prefill step of every attention
// model), for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py
// (flash_attention, pallas_call at :76) and the chunked jnp stand-in the
// JAX model runs in its place (models/attention.py: grouped_attend).  The
// function, not the TPU's block layout:
//
//   q (B, S, H, D), k/v (B, T, KH, D), H % KH == 0; head h reads kv head
//   h / (H / KH).  s = q.k * D^-0.5 in f32; with `causal` a key at k_pos
//   is seen by a query at q_pos iff k_pos <= q_pos, both counted from 0.
//   Online softmax with (m, l, acc) in f32, p cast to v's type before P.V,
//   o = acc / max(l, 1e-30) in q's type.  Key tiles wholly above the
//   diagonal are skipped.  Ragged S and T are masked here (the TPU kernel
//   asserts block multiples; that is Pallas's limit, not the function's).
//
// Bound: operations at long S (a causal glm4 layer at S = 8192: 4 S^2 D H / 2
// = 550 GFLOP against 0.25 GB of q, k, v and o).  The design is the simple
// one: one block of 4 warps per (64-row query tile, head, batch); each key
// tile of 64 rows is staged in shared memory, zero-padded to DP columns.
//
//   bf16: both products on the tensor cores through nvcuda::wmma 16x16x16
//         fragments (f32 accumulators).  Each warp owns 16 query rows: it
//         writes its scores to shared memory, two lanes a row run the
//         online softmax, and the f32 output accumulator lives in shared
//         memory, rescaled by the lanes and reloaded as a wmma accumulator
//         for P.V.  D a multiple of 8 up to 128, padded to a multiple of 16.
//   f32:  FMA on the CUDA cores, no TF32, so it agrees with an f32
//         reference to 2e-5.  Two threads a query row, each with its half of
//         the tile's scores and of the output in registers; a row's
//         probabilities pass between the pair by shuffles.
//
// No TMA, no wgmma, no pipelining of loads against math: that is the work
// of the PRs that make it fast.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <cmath>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;       // query rows a block
constexpr int kBK = 64;       // key rows a tile
constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

// Rows [0, 64) of a strided (rows, D) matrix into shared memory with row
// stride ldd, zero beyond rows_valid rows and beyond D columns (up to DP).
// 16 bytes a thread and copy; D is a multiple of 16 / sizeof(T).
template <typename T, int DP>
__device__ __forceinline__ void load_tile(T* dst, int ldd, const T* src,
                                          long long ld_src, int rows_valid,
                                          int D) {
  constexpr int E = 16 / sizeof(T);
  constexpr int CH = DP / E;
  for (int i = threadIdx.x; i < 64 * CH; i += kThreads) {
    const int r = i / CH, c = (i % CH) * E;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows_valid && c < D)
      val = *reinterpret_cast<const uint4*>(src + r * ld_src + c);
    *reinterpret_cast<uint4*>(dst + r * ldd + c) = val;
  }
}

// ------------------------------------------------------ bf16, wmma ------

template <int DP>
struct BfLayout {
  static constexpr int LDQ = DP + 8;    // bf16 rows of the Q, K and V tiles
  static constexpr int LDS = kBK + 4;   // f32 scores
  static constexpr int LDP = kBK + 8;   // bf16 probabilities
  static constexpr int LDO = DP + 4;    // f32 output accumulator
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + sizeof(bf16) * kBQ * LDQ;
  static constexpr size_t v_off = k_off + sizeof(bf16) * kBK * LDQ;
  static constexpr size_t s_off = v_off + sizeof(bf16) * kBK * LDQ;
  static constexpr size_t p_off = s_off + sizeof(float) * kBQ * LDS;
  static constexpr size_t o_off = p_off + sizeof(bf16) * kBQ * LDP;
  static constexpr size_t m_off = o_off + sizeof(float) * kBQ * LDO;
  static constexpr size_t bytes = m_off + sizeof(float) * 2 * kBQ;
};

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, bf16* __restrict__ o, int S, int T,
           int H, int KH, int D, int causal, float scale) {
  using L = BfLayout<DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q_off);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::k_off);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::v_off);
  float* Ss = reinterpret_cast<float*>(smem + L::s_off);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::p_off);
  float* Os = reinterpret_cast<float*>(smem + L::o_off);
  float* Ms = reinterpret_cast<float*>(smem + L::m_off);
  float* Ls = Ms + kBQ;

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long q_ld = (long long)H * D, kv_ld = (long long)KH * D;
  const bf16* kb = k + (long long)b * T * kv_ld + (long long)kh * D;
  const bf16* vb = v + (long long)b * T * kv_ld + (long long)kh * D;

  load_tile<bf16, DP>(Qs, L::LDQ,
                      q + ((long long)b * S + q0) * q_ld + (long long)h * D,
                      q_ld, min(kBQ, S - q0), D);
  for (int i = threadIdx.x; i < kBQ * L::LDO; i += kThreads) Os[i] = 0.f;
  if (threadIdx.x < kBQ) {
    Ms[threadIdx.x] = kNegInf;
    Ls[threadIdx.x] = 0.f;
  }
  // keys a query of this tile can see: k_pos <= q0 + 63 when causal
  const int kv_end = causal ? min(T, q0 + kBQ) : T;
  const int r = warp * 16 + lane / 2;   // this lane's softmax row ...
  const int half = lane & 1;            // ... and half of its 64 keys
  const int qpos = q0 + r;

  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();                    // the last tile's K, V are spent
    load_tile<bf16, DP>(Ks, L::LDQ, kb + (long long)k0 * kv_ld, kv_ld,
                        min(kBK, T - k0), D);
    load_tile<bf16, DP>(Vs, L::LDQ, vb + (long long)k0 * kv_ld, kv_ld,
                        min(kBK, T - k0), D);
    __syncthreads();

    // scores of the warp's 16 rows against the 64 keys
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kBK / 16];
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
      for (int kk = 0; kk < DP; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, Qs + warp * 16 * L::LDQ + kk, L::LDQ);
#pragma unroll
        for (int j = 0; j < kBK / 16; ++j) {
          // K stored (key, d) row-major is K^T column-major
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
              fb;
          wmma::load_matrix_sync(fb, Ks + j * 16 * L::LDQ + kk, L::LDQ);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j)
        wmma::store_matrix_sync(Ss + warp * 16 * L::LDS + j * 16, acc[j],
                                L::LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax: two lanes a row, 32 keys each
    float sv[32];
    unsigned valid = 0u;
    float mx = kNegInf;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int col = half * 32 + c, kpos = k0 + col;
      const bool ok = kpos < T && (!causal || kpos <= qpos);
      sv[c] = ok ? Ss[r * L::LDS + col] * scale : kNegInf;
      valid |= (ok ? 1u : 0u) << c;
      mx = fmaxf(mx, sv[c]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    const float m_prev = Ms[r];
    const float m_new = fmaxf(m_prev, mx);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const float p = (valid >> c) & 1u ? expf(sv[c] - m_new) : 0.f;
      Ps[r * L::LDP + half * 32 + c] = __float2bfloat16(p);
      sum += p;
    }
    sum += __shfl_xor_sync(kFull, sum, 1);
    const float corr = expf(m_prev - m_new);
    __syncwarp();                       // both lanes of the row read Ms[r]
    if (half == 0) {
      Ms[r] = m_new;
      Ls[r] = Ls[r] * corr + sum;
    }
    for (int d = half; d < DP; d += 2) Os[r * L::LDO + d] *= corr;
    __syncwarp();

    // acc += P.V on the warp's 16 rows
#pragma unroll
    for (int dj = 0; dj < DP; dj += 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc;
      wmma::load_matrix_sync(oacc, Os + warp * 16 * L::LDO + dj, L::LDO,
                             wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fp;
        wmma::load_matrix_sync(fp, Ps + warp * 16 * L::LDP + kk, L::LDP);
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fv;
        wmma::load_matrix_sync(fv, Vs + kk * L::LDQ + dj, L::LDQ);
        wmma::mma_sync(oacc, fp, fv, oacc);
      }
      wmma::store_matrix_sync(Os + warp * 16 * L::LDO + dj, oacc, L::LDO,
                              wmma::mem_row_major);
    }
    __syncwarp();
  }

  for (int i = lane; i < 16 * DP; i += 32) {
    const int rr = warp * 16 + i / DP, d = i % DP;
    if (q0 + rr < S && d < D) {
      const float l = fmaxf(Ls[rr], 1e-30f);
      o[((long long)b * S + q0 + rr) * q_ld + (long long)h * D + d] =
          __float2bfloat16(Os[rr * L::LDO + d] / l);
    }
  }
}

// ------------------------------------------------------- f32, FMA ------

template <int DP>
struct F32Layout {
  static constexpr int LD = DP + 4;
  static constexpr size_t bytes = sizeof(float) * (kBQ + 2 * kBK) * LD;
};

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_f32(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o, int S, int T,
          int H, int KH, int D, int causal, float scale) {
  constexpr int LD = F32Layout<DP>::LD;
  constexpr int HD = DP / 2;            // output columns a thread holds
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + kBQ * LD;
  float* Vs = Ks + kBK * LD;

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int lane = threadIdx.x % 32;
  const long long q_ld = (long long)H * D, kv_ld = (long long)KH * D;
  const float* kb = k + (long long)b * T * kv_ld + (long long)kh * D;
  const float* vb = v + (long long)b * T * kv_ld + (long long)kh * D;

  load_tile<float, DP>(Qs, LD,
                       q + ((long long)b * S + q0) * q_ld + (long long)h * D,
                       q_ld, min(kBQ, S - q0), D);
  const int r = threadIdx.x / 2, half = threadIdx.x & 1;
  const int qpos = q0 + r;
  const int kv_end = causal ? min(T, q0 + kBQ) : T;
  float acc[HD];                        // columns 2j + half of the row
#pragma unroll
  for (int j = 0; j < HD; ++j) acc[j] = 0.f;
  float m_run = kNegInf, l_run = 0.f;

  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();
    load_tile<float, DP>(Ks, LD, kb + (long long)k0 * kv_ld, kv_ld,
                         min(kBK, T - k0), D);
    load_tile<float, DP>(Vs, LD, vb + (long long)k0 * kv_ld, kv_ld,
                         min(kBK, T - k0), D);
    __syncthreads();

    float sv[32];
#pragma unroll
    for (int c = 0; c < 32; ++c) sv[c] = 0.f;
    for (int d = 0; d < DP; d += 4) {
      const float4 q4 = *reinterpret_cast<const float4*>(Qs + r * LD + d);
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        const float4 k4 = *reinterpret_cast<const float4*>(
            Ks + (half * 32 + c) * LD + d);
        sv[c] = fmaf(q4.x, k4.x, sv[c]);
        sv[c] = fmaf(q4.y, k4.y, sv[c]);
        sv[c] = fmaf(q4.z, k4.z, sv[c]);
        sv[c] = fmaf(q4.w, k4.w, sv[c]);
      }
    }
    unsigned valid = 0u;
    float mx = kNegInf;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int kpos = k0 + half * 32 + c;
      const bool ok = kpos < T && (!causal || kpos <= qpos);
      sv[c] = ok ? sv[c] * scale : kNegInf;
      valid |= (ok ? 1u : 0u) << c;
      mx = fmaxf(mx, sv[c]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    const float m_new = fmaxf(m_run, mx);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      sv[c] = (valid >> c) & 1u ? expf(sv[c] - m_new) : 0.f;
      sum += sv[c];
    }
    sum += __shfl_xor_sync(kFull, sum, 1);
    const float corr = expf(m_run - m_new);
    l_run = l_run * corr + sum;
    m_run = m_new;
#pragma unroll
    for (int j = 0; j < HD; ++j) acc[j] *= corr;
    // the pair's 64 probabilities, key by key, from the lane that has it
#pragma unroll
    for (int c = 0; c < kBK; ++c) {
      const float p = __shfl_sync(kFull, sv[c % 32], (lane & ~1) | (c / 32));
      const float* vrow = Vs + c * LD + half;
#pragma unroll
      for (int j = 0; j < HD; ++j) acc[j] = fmaf(p, vrow[2 * j], acc[j]);
    }
  }

  if (qpos < S) {
    const float l = fmaxf(l_run, 1e-30f);
    float* orow = o + ((long long)b * S + qpos) * q_ld + (long long)h * D;
#pragma unroll
    for (int j = 0; j < HD; ++j)
      if (2 * j + half < D) orow[2 * j + half] = acc[j] / l;
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int T, int H, int KH, int D, int causal, int is_bf16,
           cudaStream_t st) {
  const float scale = (float)(1.0 / sqrt((double)D));
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  cudaError_t e;
  if (is_bf16) {
    const size_t smem = BfLayout<DP>::bytes;
    e = allow_smem(flash_bf16<DP>, smem);
    if (e != cudaSuccess) return (int)e;
    flash_bf16<DP><<<grid, kThreads, smem, st>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, S, T, H,
        KH, D, causal, scale);
  } else {
    const size_t smem = F32Layout<DP>::bytes;
    e = allow_smem(flash_f32<DP>, smem);
    if (e != cudaSuccess) return (int)e;
    flash_f32<DP><<<grid, kThreads, smem, st>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o, S, T,
        H, KH, D, causal, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, S, H, D), k/v (B, T, KH, D), o (B, S, H, D), all contiguous, 16-byte
// aligned, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1).  D a multiple of 8 up
// to 128, H % KH == 0, S, T >= 1: the wrapper checks.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int T, int H, int KH, int D,
                        int causal, int is_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D <= 32)
    return launch<32>(q, k, v, o, B, S, T, H, KH, D, causal, is_bf16, st);
  if (D <= 64)
    return launch<64>(q, k, v, o, B, S, T, H, KH, D, causal, is_bf16, st);
  return launch<128>(q, k, v, o, B, S, T, H, KH, D, causal, is_bf16, st);
}

}  // extern "C"
