// Blockwise causal GQA attention (the prefill step of every attention
// model), for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py
// (flash_attention, pallas_call at :76) and the chunked jnp stand-in the
// JAX model runs in its place (models/attention.py: grouped_attend).  The
// function, not the TPU's block layout:
//
//   q (B, S, H, D), k (B, T, KH, D), v (B, T, KH, Dv), H % KH == 0; head h
//   reads kv head h / (H / KH).  s = q.k * D^-0.5 in f32 (D is q's and k's
//   width; Dv = D but in the MLA entry); with `causal` a key at k_pos
//   is seen by a query at q_pos iff k_pos <= q_pos, both counted from 0.
//   Online softmax with (m, l, acc) in f32, p cast to v's type before P.V,
//   o (B, S, H, Dv) = acc / max(l, 1e-30) in q's type.  Key tiles wholly
//   above the diagonal are skipped.  Ragged S and T are masked here (the
//   TPU kernel asserts block multiples; that is Pallas's limit, not the
//   function's).
//   The TPU kernel takes one width; the model it serves gives DeepSeek's
//   MLA layers (q.k 192 = nope 128 + rope 64, v 128) to its chunked
//   stand-in, which reads the output width from v.
//
// Bound: operations at long S (a causal glm4 layer at S = 8192: 4 S^2 D H / 2
// = 550 GFLOP against 0.25 GB of q, k, v and o; a deepseek MLA layer:
// 2 S^2 (D + Dv) H / 2 = 2.75 TFLOP against 1.3 GB).
//
//   bf16 (flash_bf16): persistent blocks, one an SM, that walk work units
//     (a query tile, a head, a batch row): 128 query rows, or 192 in the
//     64-wide body.  Warpgroup 0 is the producer: one thread claims the
//     units from a counter with an atomic add, in the order a grid of one
//     block a unit had (below), and issues every load by TMA (a unit's Q
//     once; K and V tiles of 128 keys into a ring of stages, each with
//     full and empty mbarriers), and the group gives up its registers
//     (setmaxnreg).  The other warpgroups, the consumers (two; three in
//     the 64-wide body), own 64 query rows of each unit and take those
//     registers.  The consumers release a unit's Q after its last S, so
//     the next unit's Q and first K and V tiles load while they finish
//     the last P.V and store O: a block's start and end, which a short
//     unit (12-13 key tiles at T = 1500-1601) paid alone before, run
//     under its neighbours' work.  S = Q.K^T is one wgmma m64n128k16 per
//     16 columns of D, both operands read from shared memory through
//     128-byte-swizzle descriptors, the f32 scores left in registers (64
//     a thread).  The online softmax runs there: a row's max over the
//     quad of lanes that holds it by two shuffles, exp2 with D^-0.5
//     log2(e) folded in, the masks only on the diagonal tile and on the
//     ragged last tile.  P goes to bf16 in registers in wgmma's A-operand
//     layout (the accumulator's layout is that layout), and O += P.V is a
//     register-A wgmma with V read MN-major through the descriptor's
//     transpose bit, so nothing transposes V.  A consumer issues S_j and
//     P_j-1.V_j-1 together and waits for S_j alone, so the softmax of
//     tile j (as many ex2 as the products' FLOP / 256: at D = 64 the
//     MUFU's 16 a clock an SM take as long as the products) runs under
//     P_j-1.V_j-1; it waits for that product only to rescale O and pack
//     P_j (FlashAttention-3's intra-warpgroup overlap); the 64-wide
//     body's three consumers take turns to issue (a token ring of named
//     barriers).  O (DV / 2 f32 a thread), m and l stay in registers to
//     the end of the unit.  Tensor
//     maps carry the true widths, so TMA zero-fills columns D..DQ-1 of Q
//     and K, Dv..DV-1 of V, and rows past S or T.  (DQ, DV), the padded
//     widths, is (64, 64), (128, 128) or, the MLA entry, (192, 128): a
//     192-wide row is three 64-column boxes, S = Q.K^T takes 12 k-steps in
//     place of 8, and Q and two ring stages of K and V take 48 + 2 (48 +
//     32) = 208 KB of shared memory (160 KB at (128, 128), 88 KB at (64,
//     64) with its 192-row Q); the S and O registers are those of (128,
//     128).  Query tiles run longest first (the causal tail).  Units take
//     heads fastest when one batch row's K and V fit half the 50 MB L2
//     (glm4: 8.4 MB), so every head's longest tile starts first; else
//     query tiles fastest, so the units in flight share one or two heads'
//     K and V in L2 (MLA's 128 heads hold 671 MB: heads fastest re-read
//     each head's K and V from HBM for every query tile, 21 GB a layer).
//   f32 (flash_f32): the same function in f32, both products on the
//     tensor cores as three TF32 MMAs a product (the error-compensated
//     "3xTF32" product): each operand x is split into hi = TF32(x) and lo
//     = TF32(x - hi), both rounded as cvt.rna.tf32.f32 rounds (to nearest,
//     ties away; done as an integer add and mask) and x - hi exact in f32,
//     and a.b is taken as hi.lo + lo.hi + hi.hi, small terms first, every
//     MMA accumulating in f32: about 2^-22 of each product, against f32's
//     2^-24, which holds the f32 tolerance of 2e-5
//     (tests/test_torch_flash_f32_split.py emulates it; one TF32 pass is
//     1e-3 off).  S = Q.K^T is scaled by D^-0.5 after the product and the
//     softmax takes exp in natural units, as the plain version does.  S
//     is not the plain f32 product bit for bit, and glm4's reference init
//     (scaled scores of rms ~500) turns any rounding of S into gradients
//     ~1 % apart: chip_smoke.py's phase train holds glm4's f32 gradient
//     check within twice the spread that other sound roundings of S give
//     the plain path (S in f64 rounded once, d reversed, d in halves).
//     The tensor cores do not round an accumulation to nearest, and an
//     error that leans one way grows with the chain, so P.V sums a tile's
//     keys into a fresh accumulator for each 8 columns, added to O by an
//     f32 fma (a glm4 layer's O would otherwise take 3072 MMAs in one
//     accumulator); S's chain is the 3 DP / 8 MMAs of one score tile.
//     A block is 8 warps of 16 query rows, a 128-row query tile.  The
//     block splits Q once, from device memory into shared memory, and
//     each K tile once, after it lands (cp.async) in a raw slot, into its
//     split slot.  Both split layouts hold a row's hi and lo in the MMA
//     fragments' order, so a lane's A or B fragment of a k-step, hi and
//     lo, is one 16-byte load, free of bank conflicts with the 16-byte
//     units of odd rows swapped in pairs (no padding); the warps then run
//     S with no CUDA-core work beside the MMAs.  A warp holds S in
//     m16n8k8 accumulators' layout, and the softmax runs there as in the
//     bf16 body (a row's max and sum over the quad of lanes that holds
//     it; masks, -inf after the product, only on the diagonal tiles and
//     the ragged last one).  P's layout is then the A operand of O += P.V
//     once the keys of each 8-key step are taken in the order (0, 2, 4,
//     6, 1, 3, 5, 7), V's B fragments read raw in that order and split in
//     registers, so P never moves between lanes.  K tiles (raw and split)
//     and V tiles of 64 keys up to DP = 64, 48 at DP = 128, where split Q
//     takes 128 KB: 225.5 KB at DP = 128, 130 KB at 64 (one block an SM),
//     66 KB at 32 (two).  The raw K slot and the V slot form a ring
//     filled by cp.async: K_{j+1} lands while the block runs S, the
//     softmax and P.V of tile j, V_{j+1} while it splits K_{j+1} and runs
//     S_{j+1}.  Query tiles run longest first, heads fastest unless one
//     batch row's K and V pass half the L2 (as flash_bf16).
//     Bound: both products as three TF32 products at 495 TFLOP/s, the
//     f32-accurate work the card can do (a glm4 layer: 3 x 550 GFLOP,
//     3.33 ms).
#include <cuda.h>             // CUtensorMap and its enums (no -lcuda: the
                              // encoder is found at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <map>
#include <utility>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256; // f32: threads a block
constexpr unsigned kFull = 0xffffffffu;

// ------------------------------------------- bf16, wgmma + TMA ring ------

constexpr int kTile = 128;         // key rows a tile
constexpr int kWg = 128;           // threads a warpgroup
constexpr int kHalf = kTile * 128; // bytes of 128 rows x 64 bf16 columns:
                                   // one TMA box, one 128-byte swizzle span
constexpr long long kL2Bytes = 50ll << 20;   // H100's L2

constexpr int kStages = 2;         // K/V ring depth (3 and 4 measured no
                                   // faster at D = 64)

// Consumer warpgroups of 64 query rows in the body of q.k width DQ: three
// in the 64-wide body, a 192-row unit (its softmax costs as much as its
// products, and a third warpgroup's work hides more of either), two
// elsewhere; and the block's threads with the producer's warpgroup.
template <int DQ>
constexpr int kConsumers = DQ == 64 ? 3 : 2;
template <int DQ>
constexpr int kBfThreads = (kConsumers<DQ> + 1) * kWg;

template <int DQ, int DV>
struct BfLayout {
  static constexpr int consumers = kConsumers<DQ>;
  static constexpr int rows = 64 * consumers;        // a unit's query rows
  static constexpr int threads = kBfThreads<DQ>;
  // registers a thread after setmaxnreg: 40 * 128 + 232 * 256 = 168 * 384
  // and 32 * 128 + 160 * 384 = 128 * 512, the registers at launch
  static constexpr int producer_regs = consumers == 2 ? 40 : 32;
  static constexpr int consumer_regs = consumers == 2 ? 232 : 160;
  static constexpr int qk_halves = DQ / 64;
  static constexpr int v_halves = DV / 64;
  static constexpr int qk_tile = qk_halves * kHalf;  // a K tile
  static constexpr int v_tile = v_halves * kHalf;    // a V tile
  static constexpr int q_tile = rows * 128 * qk_halves;
  static constexpr int q_off = 0;
  static constexpr int k_off = q_off + q_tile;
  static constexpr int v_off = k_off + kStages * qk_tile;
  static constexpr int bar_off = v_off + kStages * v_tile;
  // q_full, q_empty, then k_full, v_full, k_empty, v_empty: kStages each
  static constexpr int bars = 2 + 4 * kStages;
  static constexpr int unit_off = bar_off + 8 * bars;   // the unit's index
  // + 1024: the swizzle needs 1024-byte aligned tiles
  static constexpr size_t bytes = unit_off + 16 + 1024;
  // S = Q.K^T steps through Q's and K's 64-column halves alike
  static_assert(qk_halves == 1 || rows == kTile, "one Q half, or 128 rows");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Returns once the phase of the given parity has completed.
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

// One box of a 4-D tensor map (coordinates innermost first) into shared
// memory; its bytes complete on the barrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar) : "memory");
}

// wgmma's shared-memory matrix descriptor for a 128-byte swizzled operand:
// start address, leading and stride byte offsets (16-byte units), layout 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Returns once at most N committed groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the fences around it.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The scores of a 64 x 128 tile, laid out as a wgmma accumulator (below),
// set to -inf where a key is past T or, with `causal`, after the query.
__device__ __forceinline__ void mask_tile(float (&sc)[64], int k0, int row0,
                                          int col0, int T, int causal) {
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int kpos = k0 + 8 * (i / 4) + col0 + (i % 2);
    const int qpos = row0 + 8 * ((i / 2) % 2);
    if (kpos >= T || (causal && kpos > qpos)) sc[i] = -INFINITY;
  }
}

// One key tile of the online softmax for this thread's rows row0 (i = 0)
// and row0 + 8 (i = 1): the scores become p = 2^(s scale_log2 - m) in
// place, m moves on, and the output so far is to be scaled by corr.  l is
// this thread's part of each row's sum; the quad's parts are added at the
// end (they share m, so they take the same corr).
__device__ __forceinline__ void softmax_step(float (&sc)[64], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             float scale_log2) {
  float use[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * i], sc[4 * j + 2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
    const float m_new = fmaxf(m[i], mx * scale_log2);
    use[i] = m_new == -INFINITY ? 0.f : m_new;   // a row with no key yet
    corr[i] = ex2(m[i] - use[i]);
    m[i] = m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int pp = 0; pp < 32; ++pp) {
    const int i = pp % 2;
    sc[2 * pp] = ex2(fmaf(sc[2 * pp], scale_log2, -use[i]));
    sc[2 * pp + 1] = ex2(fmaf(sc[2 * pp + 1], scale_log2, -use[i]));
    sum[i] += sc[2 * pp] + sc[2 * pp + 1];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + sum[i];
}

// The output so far, rows row0 and row0 + 8, brought to the new running
// max.
template <int N>
__device__ __forceinline__ void rescale(float (&acc)[N],
                                        const float (&corr)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] *= corr[(i / 2) % 2];
}

// p to bf16 pairs: pa[4kk .. 4kk + 3] is the A operand of k-step kk.
__device__ __forceinline__ void pack_p(const float (&sc)[64],
                                       uint32_t (&pa)[32]) {
#pragma unroll
  for (int pp = 0; pp < 32; ++pp)
    pa[pp] = pack_bf16(sc[2 * pp], sc[2 * pp + 1]);
}

// d = A (64 x 16, K-major in shared memory)
// . B (16 x 128), B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n128_init(float (&d)[64], uint64_t a,
                                                  uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]),
        "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]),
        "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]),
        "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
        "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(a), "l"(b), "r"(0));
}

// d += A (64 x 16, K-major in shared memory)
// . B (16 x 128), B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// d += A (64 x 16 bf16 in registers)
// . B (16 x 128), B MN-major in shared memory (transposed read).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += A (64 x 16 bf16 in registers)
// . B (16 x 64), B MN-major in shared memory (transposed read).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t b) {
  wgmma_rs_n128(d, a, b);
}
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
  wgmma_rs_n64(d, a, b);
}

// S = Q.K^T for 64 query rows at qa and a 128-key tile at kt, issued as
// one group: one wgmma a 16 columns of DQ, both operands K-major.  The
// first k-step writes sc without reading it, so sc holds nothing live
// before the product and its registers serve other values in between.
template <int DQ>
__device__ __forceinline__ void issue_scores(float (&sc)[64], uint32_t qa,
                                             uint32_t kt) {
  // Each k-step's descriptors are the base's plus a constant.  The empty
  // asm hides qa's constancy, so that the compiler derives them here and
  // does not keep DQ / 16 loop-invariant ones in registers.
  asm volatile("" : "+r"(qa));
  const uint64_t dq = sw128_desc(qa, 16, 1024), dk = sw128_desc(kt, 16, 1024);
  wg_fence();
  wgmma_ss_n128_init(sc, dq, dk);
#pragma unroll
  for (int kk = 1; kk < DQ / 16; ++kk) {
    const uint32_t off = ((kk / 4) * kHalf + (kk % 4) * 32) >> 4;
    wgmma_ss_n128(sc, dq + off, dk + off);
  }
  wg_commit();
  pin(sc);
}

// O += P.V for the 128-key tile of V at vt, issued as one group: one wgmma
// a 16 keys, P from registers, V read MN-major (rows 16kk .. 16kk + 15;
// the second 64 columns one half on).
template <int N>
__device__ __forceinline__ void issue_pv(float (&acc)[N], uint32_t (&pa)[32],
                                         uint32_t vt) {
  const uint64_t dv = sw128_desc(vt, kHalf, 1024);
  pin(acc);
  pin(pa);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                           pa[4 * kk + 3]};
    wgmma_rs(acc, a, dv + ((kk * 16 * 128) >> 4));
  }
  wg_commit();
  pin(acc);
}

// Shared memory of a block: the Q tile, a ring of kStages stages of K and
// of V tiles, and their barriers: q_full and q_empty, then kStages each of
// full-K, full-V, empty-K and empty-V.
struct Ring {
  uint32_t k, v, bars, k_tile, v_tile;
  __device__ uint32_t q_full() const { return bars; }
  __device__ uint32_t q_empty() const { return bars + 8u; }
  __device__ uint32_t k_full(int s) const { return bars + 8u * (2 + s); }
  __device__ uint32_t v_full(int s) const {
    return bars + 8u * (2 + kStages + s);
  }
  __device__ uint32_t k_empty(int s) const {
    return bars + 8u * (2 + 2 * kStages + s);
  }
  __device__ uint32_t v_empty(int s) const {
    return bars + 8u * (2 + 3 * kStages + s);
  }
};

// A work unit: the query tile of BM rows at q0 of head h of batch row b,
// and its n_kt key tiles.  Unit u is block u (x fastest) of a grid of one
// block a unit: the longest query tile first, heads fastest, or query
// tiles fastest when one batch row's K and V pass half the L2
// (tiles_fastest).  tests/test_torch_flash_sched.py mirrors this line by
// line.
struct Unit {
  int q0, h, b, n_kt;
};
template <int BM>
__device__ __forceinline__ Unit unit_at(int u, int n_qt, int H, int T,
                                        int causal, int tiles_fastest) {
  Unit w;
  int qt;
  if (tiles_fastest) {
    qt = u % n_qt;
    w.h = (u / n_qt) % H;
    w.b = u / (n_qt * H);
  } else {
    w.h = u % H;
    qt = (u / H) % n_qt;
    w.b = u / (H * n_qt);
  }
  w.q0 = (n_qt - 1 - qt) * BM;
  const int kv_end = causal ? min(T, w.q0 + BM) : T;
  w.n_kt = (kv_end + kTile - 1) / kTile;
  return w;
}

// Turns among three consumers (FlashAttention-3's scheduler barrier), a
// token passed round the ring: consumer c issues its products after
// bar.sync 1 + c and hands the turn on with bar.arrive at c + 1's, so the
// consumers' softmaxes do not all meet on the MUFU at once.  Two
// consumers take no turns: ping-pong measured slower there.
template <int NC>
__device__ __forceinline__ void take_turn(int c) {
  if (NC > 2) asm volatile("bar.sync %0, 256;" ::"r"(1 + c) : "memory");
}
template <int NC>
__device__ __forceinline__ void pass_turn(int c) {
  if (NC > 2)
    asm volatile("bar.arrive %0, 256;" ::"r"(1 + (c + 1) % NC) : "memory");
}

// The masks of key tile j: on the diagonal tile and the ragged last one
// only.
__device__ __forceinline__ void mask_if_needed(float (&sc)[64], int j,
                                               int row0, int col0,
                                               int first_row, int T,
                                               int causal) {
  const int k0 = j * kTile;
  if (k0 + kTile > T || (causal && k0 + kTile - 1 > first_row))
    mask_tile(sc, k0, row0, col0, T, causal);
}

// One unit's key tiles, the softmax under the products
// (FlashAttention-3's intra-warpgroup pipelining): S_j and O += P_j-1.V_j-1
// are issued together, S_j is waited on alone, its masks (on the diagonal
// tile and the ragged last one only) and online softmax run while
// P_j-1.V_j-1 is in flight, and that product is waited on only where O is
// rescaled and P_j is packed into its registers.  Ring slot of tile j: it
// + j.  The issues take turns with the other consumers' (take_turn).
// (Each product waited on as it was issued measured slower on every
// path shape.)
template <int DQ, int DV, int NC>
__device__ __forceinline__ void run_unit(
    const Ring& ring, int it, int n_kt, int c, uint32_t qa, float (&sc)[64],
    uint32_t (&pa)[32], float (&acc)[DV / 2], float (&m)[2], float (&l)[2],
    int row0, int col0, int first_row, int T, int causal, float scale_log2) {
  float corr[2];
  {
    const int s = it % kStages;
    mbar_wait(ring.k_full(s), (it / kStages) & 1);
    take_turn<NC>(c);
    issue_scores<DQ>(sc, qa, ring.k + s * ring.k_tile);
    pass_turn<NC>(c);
    wg_wait<0>();
    pin(sc);
    mbar_arrive(ring.k_empty(s));
    if (n_kt == 1) mbar_arrive(ring.q_empty());
    mask_if_needed(sc, 0, row0, col0, first_row, T, causal);
    softmax_step(sc, m, l, corr, scale_log2);    // O is 0: no rescale
    pack_p(sc, pa);
  }
  for (int j = 1; j < n_kt; ++j) {
    const int s = (it + j) % kStages, sp = (it + j - 1) % kStages;
    mbar_wait(ring.k_full(s), ((it + j) / kStages) & 1);
    mbar_wait(ring.v_full(sp), ((it + j - 1) / kStages) & 1);
    take_turn<NC>(c);
    issue_scores<DQ>(sc, qa, ring.k + s * ring.k_tile);
    issue_pv(acc, pa, ring.v + sp * ring.v_tile);
    pass_turn<NC>(c);
    wg_wait<1>();                        // S_j; P_j-1.V_j-1 in flight
    pin(sc);
    mbar_arrive(ring.k_empty(s));
    if (j == n_kt - 1) mbar_arrive(ring.q_empty());
    mask_if_needed(sc, j, row0, col0, first_row, T, causal);
    softmax_step(sc, m, l, corr, scale_log2);
    wg_wait<0>();
    pin(acc);
    pin(pa);
    mbar_arrive(ring.v_empty(sp));
    rescale(acc, corr);
    pack_p(sc, pa);
  }
  const int s = (it + n_kt - 1) % kStages;
  mbar_wait(ring.v_full(s), ((it + n_kt - 1) / kStages) & 1);
  take_turn<NC>(c);
  issue_pv(acc, pa, ring.v + s * ring.v_tile);
  pass_turn<NC>(c);
  wg_wait<0>();
  pin(acc);
  pin(pa);
  mbar_arrive(ring.v_empty(s));
}

// The accumulator of a 64 x N wgmma: thread t of the warpgroup holds rows
// r = 16 (t / 32) + (t % 32) / 4 and r + 8, columns 8j + 2 (t % 4) + {0, 1};
// register 4j + 2i + e is row r + 8i, column 8j + 2 (t % 4) + e.  Its pairs
// 4kk + {0, 1, 2, 3} (columns 16kk .. 16kk + 15) are, cast to bf16, the
// register A operand of the k-step kk of the next product.
//
// A persistent block: one a card's SM (gridDim.x = min(units, SMs)).  The
// producer's thread claims units from sched[0] (an atomic add) one ahead,
// and for each writes the unit's index into shared memory and loads its
// Q, then its K and V tiles through the ring; it loads a unit's Q once the
// consumers have released the last one (q_empty, after their last S), so
// the next unit's loads run under this unit's last P.V and stores.  An
// index of -1 ends the block.  Each block makes one claim past the last
// unit and then counts itself in sched[1]; the last to do so sets both
// words back to 0, as the next launch on the stream finds them.
template <int DQ, int DV>
__global__ void __launch_bounds__(kBfThreads<DQ>, 1)
flash_bf16(const __grid_constant__ CUtensorMap tq,
           const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
           int S, int T, int H, int KH, int Dv, int causal,
           float scale_log2, int tiles_fastest, int n_units,
           unsigned* __restrict__ sched) {
  using L = BfLayout<DQ, DV>;
  constexpr int NC = L::consumers, BM = L::rows;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sq = base + L::q_off;
  const Ring ring{base + L::k_off, base + L::v_off, base + L::bar_off,
                  L::qk_tile, L::v_tile};
  volatile int* unit_slot = reinterpret_cast<volatile int*>(
      smem_raw + (base - raw) + L::unit_off);
  const int n_qt = (S + BM - 1) / BM;

  if (threadIdx.x == 0) {
    mbar_init(ring.q_full(), 1);
    mbar_init(ring.q_empty(), NC * kWg);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(ring.k_full(s), 1);
      mbar_init(ring.v_full(s), 1);
      mbar_init(ring.k_empty(s), NC * kWg);
      mbar_init(ring.v_empty(s), NC * kWg);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < kWg) {
    // ---- producer: one thread claims the units and keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(
        L::producer_regs));
    if (threadIdx.x == 0) {
      unsigned u = atomicAdd(sched, 1u);
      int it = 0;                        // key tiles loaded so far
      for (int n = 0;; ++n) {
        if (n > 0) mbar_wait(ring.q_empty(), (n - 1) & 1);
        if (u >= (unsigned)n_units) {
          *unit_slot = -1;
          mbar_arrive(ring.q_full());
          __threadfence();               // this block's claims, then its count
          if (atomicAdd(sched + 1, 1u) == gridDim.x - 1) {
            atomicExch(sched, 0u);       // every claim of the launch made
            atomicExch(sched + 1, 0u);
          }
          break;
        }
        *unit_slot = (int)u;
        const Unit w =
            unit_at<BM>((int)u, n_qt, H, T, causal, tiles_fastest);
        const int kh = w.h / (H / KH);
        mbar_expect_tx(ring.q_full(), L::q_tile);
        for (int hf = 0; hf < L::qk_halves; ++hf)
          tma_load(sq + hf * BM * 128, &tq, ring.q_full(), 64 * hf, w.h,
                   w.q0, w.b);
        u = atomicAdd(sched, 1u);        // the next, under these loads
        for (int j = 0; j < w.n_kt; ++j, ++it) {
          const int s = it % kStages;
          const uint32_t free_parity = ((it / kStages) & 1) ^ 1;
          mbar_wait(ring.k_empty(s), free_parity);
          mbar_expect_tx(ring.k_full(s), L::qk_tile);
          for (int hf = 0; hf < L::qk_halves; ++hf)
            tma_load(ring.k + s * L::qk_tile + hf * kHalf, &tk,
                     ring.k_full(s), 64 * hf, kh, j * kTile, w.b);
          mbar_wait(ring.v_empty(s), free_parity);
          mbar_expect_tx(ring.v_full(s), L::v_tile);
          for (int hf = 0; hf < L::v_halves; ++hf)
            tma_load(ring.v + s * L::v_tile + hf * kHalf, &tv,
                     ring.v_full(s), 64 * hf, kh, j * kTile, w.b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows of each unit each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(
        L::consumer_regs));
    const int c = threadIdx.x / kWg - 1;
    const int tid = threadIdx.x % kWg;
    const int r_in = 64 * c + 16 * (tid / 32) + (tid % 32) / 4;
    const int col0 = 2 * (tid % 4);
    // this consumer's 64 rows of Q: 64 * 128 bytes into each half
    const uint32_t qa = sq + 64 * c * 128;

    float sc[64];                 // scores, then p: 64 x 128 over the group
    uint32_t pa[32];              // p in bf16: the next product's A operand
    float acc[DV / 2];            // output, 64 x DV
    // the last consumer hands consumer 0 the token first
    if (NC > 2 && c == NC - 1)
      asm volatile("bar.arrive 1, 256;" ::: "memory");
    int it = 0;                   // key tiles consumed so far
    for (int n = 0;; ++n) {
      mbar_wait(ring.q_full(), n & 1);
      const int u = *unit_slot;
      if (u < 0) break;
      const Unit w = unit_at<BM>(u, n_qt, H, T, causal, tiles_fastest);
      const int row0 = w.q0 + r_in, first_row = w.q0 + 64 * c;
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
      float m[2] = {-INFINITY, -INFINITY};   // running max, log2 units
      float l[2] = {0.f, 0.f};               // this thread's part of the sum
      run_unit<DQ, DV, NC>(ring, it, w.n_kt, c, qa, sc, pa, acc, m, l, row0,
                           col0, first_row, T, causal, scale_log2);
      it += w.n_kt;

      // o = acc / max(l, 1e-30), rows past S and columns past Dv not
      // written
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(kFull, l[i], 1);
        l[i] += __shfl_xor_sync(kFull, l[i], 2);
        l[i] = fmaxf(l[i], 1e-30f);
      }
      const long long ld = (long long)H * Dv;
      bf16* ob = o + (long long)w.b * S * ld + (long long)w.h * Dv;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row0 + 8 * i;
        if (row < S) {
          bf16* orow = ob + row * ld;
#pragma unroll
          for (int jj = 0; jj < DV / 8; ++jj) {
            const int col = 8 * jj + col0;
            if (col < Dv)
              *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                  __floats2bfloat162_rn(acc[4 * jj + 2 * i] / l[i],
                                        acc[4 * jj + 2 * i + 1] / l[i]);
          }
        }
      }
    }
    // the token's last pass, to consumer 0, taken
    if (NC > 2 && c == 0) asm volatile("bar.sync 1, 256;" ::: "memory");
  }
}

// -------------------------------------- f32, 3xTF32 on mma.sync ------

// A block is 8 warps of 16 query rows (a 128-row query tile); K and V
// tiles of BK keys.  Q (split once a block) and each K tile (split once a
// tile) are kept as TF32 parts in the fragments' order: in a row, the 8
// columns 8b .. 8b + 7 take 16 words, 4 for each t in 0..3: (hi of 8b + t,
// hi of 8b + t + 4, lo of 8b + t, lo of 8b + t + 4), so a lane's A or B
// fragment of a k-step, hi and lo, is one 16-byte load.  Split rows are
// LS = 2 DP words, the 16-byte units of odd rows swapped in pairs (unit u
// at u ^ 4: swz), so that the 16-byte loads of two neighbouring rows, and
// the split's stores, are free of bank conflicts with no padding.  Raw
// rows are LD = DP + 4 floats apart (4 mod 32): the loads of raw K rows
// that the split reads and the scalar loads of V down its keys for P.V
// are then free of bank conflicts too.
template <int DP>
struct F32Layout {
  static constexpr int BQ = 128;                  // query rows a block
  static constexpr int BK = DP <= 64 ? 64 : 48;   // keys a tile
  static constexpr int NT = BK / 8;               // 8-key steps a tile
  static constexpr int LD = DP + 4;               // floats a raw row
  static constexpr int LS = 2 * DP;               // words a split row
  // split Q, split K, then the ring's raw K slot and V slot
  static constexpr size_t bytes =
      sizeof(float) * ((size_t)(BQ + BK) * LS + 2 * BK * LD);
  static constexpr int min_blocks = bytes <= 113 * 1024 ? 2 : 1;
};

// word w of split row r as stored: 16-byte units of odd rows swapped in
// pairs
__device__ __forceinline__ int swz(int r, int w) { return w ^ ((r & 1) << 4); }

// Rows [0, ROWS) of a strided (rows, D) f32 matrix into shared memory
// with row stride ldd by cp.async, 16 bytes a copy; rows past rows_valid
// and columns D .. DP - 1 land as zeros.  D is a multiple of 4.
template <int DP, int ROWS>
__device__ __forceinline__ void cp_tile(float* dst, int ldd, const float* src,
                                        long long ld_src, int rows_valid,
                                        int D) {
  constexpr int CH = DP / 4;
  for (int i = threadIdx.x; i < ROWS * CH; i += kThreads) {
    const int r = i / CH, c = (i % CH) * 4;
    const bool ok = r < rows_valid && c < D;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst + r * ldd + c)),
                 "l"(ok ? src + r * ld_src + c : src), "r"(ok ? 16 : 0));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Returns once at most N of this thread's cp.async groups are pending.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero: cvt.rna.tf32.f32's rounding of a finite x, as an add and a mask on
// its bits (two instructions; the cvt also handles NaN and infinity and
// takes four).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x as hi = TF32(x) and lo = TF32(x - hi): x - hi is exact in f32, so
// hi + lo carries 22 bits of x's 24.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// (hi a, hi b, lo a, lo b): a split row's 4 words for one t
__device__ __forceinline__ uint4 split_pair(float a, float b) {
  uint4 r;
  split_tf32(a, r.x, r.z);
  split_tf32(b, r.y, r.w);
  return r;
}

// Item i of splitting a tile of DP columns, two values an item: its row
// r, the raw column c of its first value (the second is c + 4) and the
// word o of its 4 words in the split row.  A warp's 32 items are 2 rows x
// 4 column groups x 4 t, so the raw loads r LD + c of a warp hit 32 banks.
template <int DP>
__device__ __forceinline__ void split_item(int i, int& r, int& c, int& o) {
  constexpr int NB4 = DP / 32;
  const int t = i & 3, rest = i >> 5;
  const int b = 4 * (rest % NB4) + ((i >> 2) & 3);
  r = 2 * (rest / NB4) + ((i >> 4) & 1);
  c = 8 * b + t;
  o = 16 * b + 4 * t;
}

// c += a b: m16n8k8, TF32 in, f32 accumulate.  a: (g, t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4); b: (k t, n g), (k t + 4, n g); c: (g, 2t),
// (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1); g = lane / 4, t = lane % 4.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a as its TF32 high parts and remainders
__device__ __forceinline__ void split_a(const float (&a)[4], uint32_t (&ah)[4],
                                        uint32_t (&al)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[i], al[i]);
}

// c += a b as three TF32 products, small terms first: hi.lo + lo.hi +
// hi.hi (a given split, b as its two f32 values).
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], float b0,
                                           float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bh0, bh1);
}

// One block: BQ query rows of head h (8 warps of 16 rows), K and V tiles
// of BK keys through a two-slot ring.  A lane holds S in the layout of
// m16n8k8 accumulators: tile nt covers keys 8 nt .. 8 nt + 7 (the lane's
// rows g and g + 8 of its warp's 16, keys 8 nt + 2t and + 1); tile dt of
// O columns 8 dt .. 8 dt + 7.
template <int DP>
__global__ void __launch_bounds__(kThreads, F32Layout<DP>::min_blocks)
flash_f32(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o, int S, int T,
          int H, int KH, int D, int causal, float scale,
          int tiles_fastest) {
  using L = F32Layout<DP>;
  constexpr int LD = L::LD, LS = L::LS, BQ = L::BQ, BK = L::BK, NT = L::NT;
  extern __shared__ __align__(128) unsigned char smem[];
  uint32_t* Qs = reinterpret_cast<uint32_t*>(smem);
  uint32_t* Ks = Qs + BQ * LS;
  float* Kr = reinterpret_cast<float*>(Ks + BK * LS);
  float* Vs = Kr + BK * LD;

  // longest query tile first, in each head (tiles_fastest) or across them
  const int h = tiles_fastest ? blockIdx.y : blockIdx.x, b = blockIdx.z;
  const int n_qt = tiles_fastest ? gridDim.x : gridDim.y;
  const int q0 = (n_qt - 1 - (tiles_fastest ? blockIdx.x : blockIdx.y)) *
                 BQ;
  const int kh = h / (H / KH);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const long long q_ld = (long long)H * D, kv_ld = (long long)KH * D;
  const float* kb = k + (long long)b * T * kv_ld + (long long)kh * D;
  const float* vb = v + (long long)b * T * kv_ld + (long long)kh * D;
  const int kv_end = causal ? min(T, q0 + BQ) : T;
  const int n_kt = (kv_end + BK - 1) / BK;

  // groups in flight: {K_0}, then {V_0}; Q is read and split meanwhile
  cp_tile<DP, BK>(Kr, LD, kb, kv_ld, min(BK, T), D);
  cp_tile<DP, BK>(Vs, LD, vb, kv_ld, min(BK, T), D);
  {
    const float* qb = q + ((long long)b * S + q0) * q_ld + (long long)h * D;
    const int rows = min(BQ, S - q0);
    for (int i = threadIdx.x; i < BQ * DP / 2; i += kThreads) {
      int r, c, w;
      split_item<DP>(i, r, c, w);
      const bool ok = r < rows && c < D;     // D % 8 == 0: c + 4 < D too
      *reinterpret_cast<uint4*>(Qs + r * LS + swz(r, w)) =
          split_pair(ok ? qb[r * q_ld + c] : 0.f,
                     ok ? qb[r * q_ld + c + 4] : 0.f);
    }
  }

  const int row0 = q0 + 16 * warp + g;     // the lane's rows: row0, + 8
  // the lane's 16-byte units of its A fragments (rows g and g + 8 of its
  // warp's, + 2 LS for the second) and of its B fragments (key g of each
  // 8-key step nt, + 2 LS nt); its rows' parity is g's, so k-step ks is
  // unit 4 ks + t of an even row and 4 (ks ^ 1) + t of an odd one: from
  // qe and ke at even ks, qo and ko at odd
  const int sw = 4 * (g & 1);
  const uint4* qe = reinterpret_cast<const uint4*>(Qs + (16 * warp + g) * LS)
                    + t + sw;
  const uint4* ke = reinterpret_cast<const uint4*>(Ks + g * LS) + t + sw;
  const uint4* qo = qe - 2 * sw;
  const uint4* ko = ke - 2 * sw;
  const float* vw = Vs + 2 * t * LD + g;   // its V fragments
  float acc[DP / 8][4];
#pragma unroll
  for (int i = 0; i < DP / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  // running max, and this lane's part of the sum, of each of its rows
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int j = 0; j < n_kt; ++j) {
    const int k0 = j * BK;
    const bool more = j + 1 < n_kt;
    cp_wait<1>();                        // K_j landed
    __syncthreads();                     // (and every warp is past S_{j-1})
    for (int i = threadIdx.x; i < BK * DP / 2; i += kThreads) {
      int r, c, w;
      split_item<DP>(i, r, c, w);
      *reinterpret_cast<uint4*>(Ks + r * LS + swz(r, w)) =
          split_pair(Kr[r * LD + c], Kr[r * LD + c + 4]);
    }
    __syncthreads();                     // K_j split, its raw slot free
    if (more)
      cp_tile<DP, BK>(Kr, LD, kb + (long long)(k0 + BK) * kv_ld, kv_ld,
                      min(BK, T - k0 - BK), D);

    // ---- S = Q.K_j^T as three TF32 products (hi.lo + lo.hi + hi.hi
    // each k-step), f32 accumulate, then scaled by D^-0.5 ----
    float sc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DP / 8; ++ks) {
      const uint4* qw = ks & 1 ? qo : qe;
      const uint4* kw = ks & 1 ? ko : ke;
      const uint4 qa = qw[4 * ks], qc = qw[2 * LS + 4 * ks];
      const uint32_t ah[4] = {qa.x, qc.x, qa.y, qc.y};
      const uint32_t al[4] = {qa.z, qc.z, qa.w, qc.w};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint4 kv = kw[2 * LS * nt + 4 * ks];
        mma_tf32(sc[nt], ah, kv.z, kv.w);
        mma_tf32(sc[nt], al, kv.x, kv.y);
        mma_tf32(sc[nt], ah, kv.x, kv.y);
      }
    }

    // ---- masks, then the online softmax on the lane's rows ----
    const bool masked = k0 + BK > T || (causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[nt][e] *= scale;
        const int kpos = k0 + 8 * nt + 2 * t + (e & 1);
        const int qpos = row0 + 8 * (e >> 1);
        if (masked && (kpos >= T || (causal && kpos > qpos)))
          sc[nt][e] = -INFINITY;
      }
    float use[2], corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mx = fmaxf(mx, fmaxf(sc[nt][2 * i], sc[nt][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      use[i] = m_new == -INFINITY ? 0.f : m_new;   // no key yet
      corr[i] = __expf(m[i] - use[i]);
      m[i] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[nt][e] = __expf(sc[nt][e] - use[e >> 1]);
        sum[e >> 1] += sc[nt][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + sum[i];

    // ---- O = O corr + P.V_j: step nt takes keys 8 nt + (2t, 2t + 1) as
    // its k indices (t, t + 4), so P's accumulator is already its A
    // operand.  Each 8 columns of P.V_j (3 NT MMAs) go to a fresh
    // accumulator, added to O by an f32 fma; one key step's split of P is
    // live at a time ----
    if (more) cp_wait<1>(); else cp_wait<0>();   // V_j landed
    __syncthreads();
    float part[DP / 8][4];
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt)
      part[dt][0] = part[dt][1] = part[dt][2] = part[dt][3] = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float p[4] = {sc[nt][0], sc[nt][2], sc[nt][1], sc[nt][3]};
      uint32_t ph[4], pl[4];
      split_a(p, ph, pl);
#pragma unroll
      for (int dt = 0; dt < DP / 8; ++dt) {
        const int w = 8 * nt * LD + 8 * dt;
        mma_3xtf32(part[dt], ph, pl, vw[w], vw[w + LD]);
      }
    }
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[dt][e] = fmaf(acc[dt][e], corr[e >> 1], part[dt][e]);
    __syncthreads();                     // every warp has read V_j
    if (more)
      cp_tile<DP, BK>(Vs, LD, vb + (long long)(k0 + BK) * kv_ld, kv_ld,
                      min(BK, T - k0 - BK), D);
  }

  // o = acc / max(l, 1e-30), as a product with the row's reciprocal; rows
  // past S and columns past D not written
  float* ob = o + (long long)b * S * q_ld + (long long)h * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(kFull, li, 1);
    li += __shfl_xor_sync(kFull, li, 2);
    li = __frcp_rn(fmaxf(li, 1e-30f));
    const int row = row0 + 8 * i;
    if (row < S) {
      float* orow = ob + row * q_ld;
#pragma unroll
      for (int dt = 0; dt < DP / 8; ++dt) {
        const int col = 8 * dt + 2 * t;
        if (col < D)
          *reinterpret_cast<float2*>(orow + col) =
              make_float2(acc[dt][2 * i] * li, acc[dt][2 * i + 1] * li);
      }
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// cuTensorMapEncodeTiled, looked up in the driver once.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

constexpr int kMapError = 10000;   // + the CUresult of a refused encoding

// A (B, rows, heads, D) bf16 tensor as dims (D, heads, rows, B), innermost
// first; boxes of 64 columns x 1 head x box_rows rows x 1 batch, 128-byte
// swizzle.  The extent D is the true one: columns D .. 63 (or 127) of a
// box, and rows past `rows`, read as zeros.
int tensor_map(CUtensorMap* map, const void* ptr, int B, int rows, int heads,
               int D, int box_rows) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return kMapError;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)rows, (cuuint64_t)B};
  const cuuint64_t strides[3] = {2ull * D, 2ull * heads * D,
                                 2ull * rows * heads * D};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kMapError + (int)r;
}

// The schedule's two words (next unit, blocks done) of a (card, stream):
// allocated and zeroed on the stream once; each launch leaves them at 0.
// Launches on one stream run in order, so each finds them so; a stream of
// its own keeps concurrent launches apart.  Callers hold the wrapper's
// lock.
int sched_for(int dev, cudaStream_t st, unsigned** out) {
  static std::map<std::pair<int, cudaStream_t>, unsigned*> table;
  const auto key = std::make_pair(dev, st);
  auto found = table.find(key);
  if (found == table.end()) {
    unsigned* words = nullptr;
    cudaError_t e = cudaMalloc(&words, 2 * sizeof(unsigned));
    if (e == cudaSuccess) e = cudaMemsetAsync(words, 0, 2 * sizeof(unsigned),
                                              st);
    if (e != cudaSuccess) return (int)e;
    found = table.emplace(key, words).first;
  }
  *out = found->second;
  return 0;
}

template <int DQ, int DV>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int S, int T, int H, int KH, int D, int Dv, int causal,
                cudaStream_t st) {
  using L = BfLayout<DQ, DV>;
  CUtensorMap mq, mk, mv;
  int e = tensor_map(&mq, q, B, S, H, D, L::rows);
  if (e == 0) e = tensor_map(&mk, k, B, T, KH, D, kTile);
  if (e == 0) e = tensor_map(&mv, v, B, T, KH, Dv, kTile);
  if (e != 0) return e;
  const size_t smem = L::bytes;
  static bool smem_allowed[64] = {};     // once per card and width
  static int sms[64] = {};               // the card's SMs, read once
  int dev = 0;
  cudaError_t ce = cudaGetDevice(&dev);
  if (ce != cudaSuccess) return (int)ce;
  if (dev >= 64 || !smem_allowed[dev]) {
    ce = allow_smem(flash_bf16<DQ, DV>, smem);
    if (ce != cudaSuccess) return (int)ce;
    if (dev < 64) smem_allowed[dev] = true;
  }
  int n_sm = dev < 64 ? sms[dev] : 0;
  if (n_sm == 0) {
    ce = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (ce != cudaSuccess) return (int)ce;
    if (dev < 64) sms[dev] = n_sm;
  }
  unsigned* sched = nullptr;
  e = sched_for(dev, st, &sched);
  if (e != 0) return e;
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  const int n_qt = (S + L::rows - 1) / L::rows;
  const int n_units = n_qt * H * B;      // < 2^31: the wrapper checks
  const int tiles_fastest =
      2ll * KH * T * (D + Dv) > kL2Bytes / 2 ? 1 : 0;
  const int grid = n_units < n_sm ? n_units : n_sm;
  flash_bf16<DQ, DV><<<grid, L::threads, smem, st>>>(
      mq, mk, mv, (bf16*)o, S, T, H, KH, Dv, causal, scale_log2,
      tiles_fastest, n_units, sched);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int S, int T, int H, int KH, int D, int causal,
               cudaStream_t st) {
  using L = F32Layout<DP>;
  const float scale = (float)(1.0 / sqrt((double)D));
  const int n_qt = (S + L::BQ - 1) / L::BQ;
  const int tiles_fastest =
      (2ll * KH * T * D * 4 > kL2Bytes / 2 || n_qt > 65535) ? 1 : 0;
  const dim3 grid = tiles_fastest ? dim3(n_qt, H, B) : dim3(H, n_qt, B);
  const cudaError_t e = allow_smem(flash_f32<DP>, L::bytes);
  if (e != cudaSuccess) return (int)e;
  flash_f32<DP><<<grid, kThreads, L::bytes, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, S, T, H,
      KH, D, causal, scale, tiles_fastest);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, S, H, D), k (B, T, KH, D), v (B, T, KH, Dv), o (B, S, H, Dv), all
// contiguous, 16-byte aligned, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1).
// D and Dv multiples of 8; bf16: D up to 192 and Dv up to 128 (above 128,
// D takes the MLA entry (192, 128)); f32: Dv == D up to 128.  H % KH == 0,
// S, T >= 1: the wrapper checks.  Returns 0, a CUDA error, or 10000 + the
// CUresult of a refused tensor-map encoding.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int T, int H, int KH, int D, int Dv,
                        int causal, int is_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    if (D <= 64 && Dv <= 64)
      return launch_bf16<64, 64>(q, k, v, o, B, S, T, H, KH, D, Dv, causal,
                                 st);
    if (D <= 128 && Dv <= 128)
      return launch_bf16<128, 128>(q, k, v, o, B, S, T, H, KH, D, Dv, causal,
                                   st);
    if (D <= 192 && Dv <= 128)
      return launch_bf16<192, 128>(q, k, v, o, B, S, T, H, KH, D, Dv, causal,
                                   st);
    return (int)cudaErrorInvalidValue;
  }
  if (Dv != D) return (int)cudaErrorInvalidValue;
  if (D <= 32)
    return launch_f32<32>(q, k, v, o, B, S, T, H, KH, D, causal, st);
  if (D <= 64)
    return launch_f32<64>(q, k, v, o, B, S, T, H, KH, D, causal, st);
  return launch_f32<128>(q, k, v, o, B, S, T, H, KH, D, causal, st);
}

}  // extern "C"
