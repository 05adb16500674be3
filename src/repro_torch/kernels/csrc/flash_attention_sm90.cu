// GQA flash attention on bf16 for Hopper's tensor cores (sm_90a): the
// forward and both halves of the flash-2 backward.
//
// Replaces three Pallas TPU kernels of src/repro/kernels/flash_attention.py:
//   flash_fwd_sm90_kernel      _fwd_kernel (line 50, through _flash_fwd)
//   flash_bwd_dkv_sm90_kernel  _bwd_dkv_kernel (line 131, through _flash_bwd)
//   flash_bwd_dq_sm90_kernel   _bwd_dq_kernel (line 168, through _flash_bwd)
// for bf16 inputs, the dtype of every main path.  The f32 route stays in
// flash_attention.cu.  The function is that file's:
// the same layouts (q (B, S, KV, G, D), k / v (B, Sk, KV, D), lse and delta
// f32 (B, KV, G, S)), the same masks (causal, sliding window, ragged S and
// Sk), the same finite NEG_INF = -1e30, o = acc / max(l, 1e-30) and
// lse = m + log(max(l, 1e-30)).  The backward recomputes p from the lse:
//   p = exp(scale s - lse) where allowed, else exactly 0;
//   dv += p^T do;  ds = p (dp - delta) scale with dp = do v^T;  dk += ds^T q;
//   dq += ds k.
//
// Numerics: every product runs on the tensor cores with bf16 operands and
// f32 accumulation.  p (forward), p^T, ds^T and ds (backward) are rounded to
// bf16 in registers before the product that consumes them, as
// FlashAttention-2 and -3 do; softmax statistics, the row sums l and the
// lse stay f32.  The exponentials are ex2.approx (MUFU) on log2e-scaled
// scores.
//
// Bound on this card: operations.  Causal attention does 2 S Sk D flops per
// (b, head) in the forward, 4 S Sk D in dK/dV and 3 S Sk D in dQ (half of
// full attention each), against q, k, v, o (and do, lse, delta, dq, dk, dv)
// read or written once: ~1000 flops per byte at the main paths' shapes,
// above the ~295 at
// which the bf16 tensor cores (989 TFLOP/s dense) and not HBM (3.35 TB/s)
// are the limit.  So the design feeds the tensor cores from shared memory
// and keeps every S x S intermediate in registers:
//
// * Tiles stay bf16 in shared memory, in the 128-byte swizzled layout that
//   both TMA and wgmma read: each tile is split in panels of 64 columns
//   (128 bytes a row); D < 64 (the smoke configs' 32) and the ragged last
//   tile of S or Sk are zero-filled by TMA's out-of-bounds fill.
// * Each block has three warpgroups: two consumers of 64 rows each, and a
//   producer whose one thread keeps a 2-stage ring of TMA loads
//   (cp.async.bulk.tensor, tensor maps built on the host and passed as
//   __grid_constant__) in flight, each stage completed on an mbarrier and
//   released by the consumers' arrivals.  setmaxnreg moves registers from
//   the producer (24) to the consumers (240).
// * Forward: one block per (b, kv, g, 128-row query tile), the Q tile
//   loaded once; 128-key K and V tiles arrive through the ring and are
//   shared by the two consumer warpgroups (GQA's groups run in separate
//   blocks: the two consumers split one head's 128 query rows, which halves
//   K/V traffic against 64-row blocks whatever G is).  S = Q K^T by
//   wgmma m64n128k16 with both operands in shared memory; the online
//   softmax runs on the accumulator fragment (a row spans 4 lanes: two
//   __shfl_xor_sync steps); P is packed to bf16 in registers and is
//   wgmma's register A operand for O += P V, V read as a transposed
//   (MN-major) B operand.  O never leaves registers until the epilogue.
//   Key tiles outside the causal / window band are skipped, as in
//   flash_attention.cu, and query tiles are issued heaviest first.
// * dK/dV: one block per (b, kv, 128-key tile), 64 keys per consumer; K
//   and V stay in shared memory for the whole block, dK and dV in
//   registers.  The block loops over the G groups and the band's 64-row
//   query tiles, Q and dO arriving through the ring: S^T = K Q^T and
//   dP^T = V dO^T (wgmma, shared-memory operands), P^T and dS^T in
//   registers, dV += P^T dO and dK += dS^T Q with P^T and dS^T as register
//   A operands.  No atomics: each block owns its keys and sums in one fixed
//   order, so a step is deterministic.  Key tiles are issued heaviest first.
// * dQ: the forward's shape, Q-stationary: one block per (b, kv, g, 128-row
//   query tile), Q and dO loaded once and resident, 128-key K and V tiles
//   through the ring over the band only.  S = Q K^T and dP = dO V^T by
//   wgmma from shared memory (K-major, as the forward's S); p from the lse
//   on the fragment (each thread keeps its two rows' lse and delta in
//   registers for the whole block); dS packed to bf16 is the register A
//   operand of dQ += dS K, the same K tile read as an MN-major B operand,
//   as the forward reads V.  dQ stays in f32 registers until the epilogue.
//   At D = 128 each key tile is taken in two 64-key halves, so the S and dP
//   fragments (32 registers each, not 64) fit beside dQ's 64 without
//   spilling.  No atomics: each block owns its query rows and sums its key
//   tiles in one fixed order.

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kConsumers = 2;                  // consumer warpgroups a block
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kStages = 2;                     // depth of the TMA ring
constexpr int kFwdBQ = 64 * kConsumers;        // forward: query rows a block
constexpr int kFwdBK = 128;                    // forward: keys a tile
constexpr int kBwdBK = 64 * kConsumers;        // dK/dV: keys a block
constexpr int kBwdBQ = 64;                     // dK/dV: query rows a tile
constexpr int kDqBQ = 64 * kConsumers;         // dQ: query rows a block
constexpr int kDqBK = 128;                     // dQ: keys a tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegInf2 = -1e30f * kLog2e;    // NEG_INF on the log2 scale
constexpr unsigned kFull = 0xFFFFFFFFu;

// -- shared memory, mbarriers, TMA ------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Wait until the barrier's phase `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA box of a (batch, rows, heads, dim) tensor: 64 columns from c0 of
// head h, `rows` rows from r0, batch b (the box's rows are the map's).
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int h, int r0,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(h), "r"(r0), "r"(b),
      "r"(smem_u32(bar))
      : "memory");
}

// A tile of R rows and DP columns: DP / 64 panels of R x 64, one box each.
template <int DP, int R>
__device__ __forceinline__ void load_tile(bf16* dst, const CUtensorMap* map,
                                          uint64_t* bar, int h, int r0, int b) {
#pragma unroll
  for (int p = 0; p < DP / 64; ++p)
    tma_load(dst + p * R * 64, map, bar, 64 * p, h, r0, b);
}

// -- wgmma ------------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle (the layout TMA writes
// with CU_TENSOR_MAP_SWIZZLE_128B; tiles are 1024-byte aligned).
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

// K-major operand (the contraction runs along a tile's columns): rows
// [row0, row0 + 64 or N) of a tile of R rows, columns [16 kk, 16 kk + 16).
// 8-row groups are 1024 bytes apart; a 16-column step inside a 128-byte
// panel row moves the start by 32 bytes (the swizzle is applied on the
// address bits, so the tile's alignment keeps it right).
template <int R>
__device__ __forceinline__ uint64_t desc_k(const bf16* tile, int row0, int kk) {
  return make_desc(tile + (kk / 4) * R * 64 + row0 * 64 + (kk % 4) * 16, 16,
                   1024);
}

// MN-major B operand (the contraction runs along a tile's rows): rows
// [16 kk, 16 kk + 16) as K, the 64 columns of panel p as N.
template <int R>
__device__ __forceinline__ uint64_t desc_mn(const bf16* tile, int kk, int p) {
  return make_desc(tile + p * R * 64 + kk * 16 * 64, R * 128, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of wgmma's registers across
// the fence, commit and wait above.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D (64 x N, f32) (+)= A (64 x 16) B (16 x N): both from shared memory, B
// K-major.  scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
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
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, f32) (+)= A (64 x 16) B (16 x 64): A bf16 in registers, in
// the accumulator fragment's layout (two values a register), B MN-major.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// 2^x on the special-function unit (MUFU.EX2), denormal results flushed to 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo, low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void setmaxnreg_producer() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
}
__device__ __forceinline__ void setmaxnreg_consumer() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
}

__device__ __forceinline__ bf16* align1024(unsigned char* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  return reinterpret_cast<bf16*>((a + 1023) & ~static_cast<uintptr_t>(1023));
}

__device__ __forceinline__ bool masked(int qpos, int kpos, int causal,
                                       int window) {
  return (causal && qpos < kpos) || (window > 0 && qpos - kpos >= window);
}

// Accumulator fragment of a 64 x N wgmma tile, thread t of the warpgroup:
// register 4 j + e holds row 16 (t / 32) + (t % 32) / 4 + 8 (e / 2) and
// column 8 j + 2 (t % 4) + e % 2.

// -- forward ----------------------------------------------------------------

template <int DP>
constexpr int fwd_smem_bytes() {  // Q, then the K and V rings, + alignment
  return (kFwdBQ * DP + 2 * kStages * kFwdBK * DP) * 2 + 1024;
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      bf16* __restrict__ o, float* __restrict__ lse, int S,
                      int Sk, int KV, int G, int D, int causal, int window,
                      float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t q_full, k_full[kStages], v_full[kStages],
      empty[kStages];
  bf16* sQ = align1024(smem_raw);
  bf16* sK = sQ + kFwdBQ * DP;
  bf16* sV = sK + kStages * kFwdBK * DP;

  const int bkg = blockIdx.x;                   // (b * KV + kv) * G + g
  const int g = bkg % G, kvh = (bkg / G) % KV, b = bkg / (G * KV);
  const int h = kvh * G + g;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kFwdBQ;  // heaviest first

  // the band of key tiles (flash_attention.cu's rule)
  const int q1 = min(q0 + kFwdBQ, S) - 1;       // last real row of the tile
  const int n_kt = (Sk + kFwdBK - 1) / kFwdBK;
  const int kt_end = causal ? min(n_kt, q1 / kFwdBK + 1) : n_kt;
  int kt_begin = 0;
  if (window > 0 && q1 - window + 1 <= Sk - 1)
    kt_begin = max(0, q0 - window + 1) / kFwdBK;
  const int n_tiles = max(0, kt_end - kt_begin);

  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---- producer: one thread keeps the ring full ----
    setmaxnreg_producer();
    if (threadIdx.x == 128 * kConsumers) {
      constexpr uint32_t tile_bytes = kFwdBK * DP * 2;
      mbar_expect_tx(&q_full, kFwdBQ * DP * 2);
      load_tile<DP, kFwdBQ>(sQ, &tq, &q_full, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages, n = i / kStages;
        const int k0 = (kt_begin + i) * kFwdBK;
        mbar_wait(&empty[s], (n & 1) ^ 1);
        mbar_expect_tx(&k_full[s], tile_bytes);
        load_tile<DP, kFwdBK>(sK + s * kFwdBK * DP, &tk, &k_full[s], kvh, k0, b);
        mbar_expect_tx(&v_full[s], tile_bytes);
        load_tile<DP, kFwdBK>(sV + s * kFwdBK * DP, &tv, &v_full[s], kvh, k0, b);
      }
    }
  } else {
    // ---- consumer warpgroup wg: query rows q0 + 64 wg + [0, 64) ----
    setmaxnreg_consumer();
    const int t = threadIdx.x % 128, lane = t % 32;
    const int row = q0 + 64 * wg + 16 * (t / 32) + lane / 4;  // and row + 8
    const int col = 2 * (lane % 4);                           // in an 8-group
    const int wq_lo = q0 + 64 * wg, wq_hi = wq_lo + 63;

    float m[2] = {kNegInf2, kNegInf2}, l[2] = {0.0f, 0.0f};
    float acc[DP / 64][32];
#pragma unroll
    for (int p = 0; p < DP / 64; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[p][i] = 0.0f;

    mbar_wait(&q_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      const uint32_t par = (i / kStages) & 1;
      const int k0 = (kt_begin + i) * kFwdBK;
      const bf16* tK = sK + s * kFwdBK * DP;
      const bf16* tV = sV + s * kFwdBK * DP;

      // S = Q K^T
      float sc[64];
      mbar_wait(&k_full[s], par);
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss_n128(sc, desc_k<kFwdBQ>(sQ, 64 * wg, kk),
                      desc_k<kFwdBK>(tK, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // scale, mask (only a tile on the band's edge needs it: selects, no
      // branches), online softmax on the fragment
      const bool edge = k0 + kFwdBK > Sk || (causal && k0 + kFwdBK - 1 > wq_lo) ||
                        (window > 0 && wq_hi - k0 >= window);
#pragma unroll
      for (int r = 0; r < 64; ++r) sc[r] *= scale_log2;
      if (edge) {
#pragma unroll
        for (int r = 0; r < 64; ++r) {
          const int kpos = k0 + 8 * (r / 4) + col + (r % 2);
          const int qpos = row + 8 * ((r % 4) / 2);
          const float x = masked(qpos, kpos, causal, window) ? kNegInf2 : sc[r];
          sc[r] = kpos >= Sk ? -INFINITY : x;  // no such key
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int r = 0; r < 64; ++r)
        mx[(r % 4) / 2] = fmaxf(mx[(r % 4) / 2], sc[r]);
      float alpha[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mx[e] = fmaxf(mx[e], __shfl_xor_sync(kFull, mx[e], 1));
        mx[e] = fmaxf(mx[e], __shfl_xor_sync(kFull, mx[e], 2));
        const float m_new = fmaxf(m[e], mx[e]);
        alpha[e] = ex2(m[e] - m_new);
        m[e] = m_new;
      }
      float rs[2] = {0.0f, 0.0f};
#pragma unroll
      for (int r = 0; r < 64; ++r) {
        const float p = ex2(sc[r] - m[(r % 4) / 2]);
        sc[r] = p;
        rs[(r % 4) / 2] += p;
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) l[e] = l[e] * alpha[e] + rs[e];  // own lanes
      uint32_t pa[32];                     // P in bf16: the A operand
#pragma unroll
      for (int r = 0; r < 32; ++r) pa[r] = pack_bf16(sc[2 * r], sc[2 * r + 1]);
#pragma unroll
      for (int p = 0; p < DP / 64; ++p)
#pragma unroll
        for (int r = 0; r < 32; ++r) acc[p][r] *= alpha[(r % 4) / 2];

      // O += P V
      mbar_wait(&v_full[s], par);
#pragma unroll
      for (int p = 0; p < DP / 64; ++p) fence_regs(acc[p]);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kFwdBK / 16; ++kk)
#pragma unroll
        for (int p = 0; p < DP / 64; ++p)
          wgmma_rs_n64(acc[p], pa + 4 * kk, desc_mn<kFwdBK>(tV, kk, p), 1);
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int p = 0; p < DP / 64; ++p) fence_regs(acc[p]);
      mbar_arrive(&empty[s]);
    }

    // epilogue: o = acc / max(l, 1e-30) in bf16, lse = m + log(max(l, 1e-30))
    const int64_t q_stride = static_cast<int64_t>(KV) * G * D;
    bf16* ob = o + static_cast<int64_t>(b) * S * q_stride + h * D;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      l[e] += __shfl_xor_sync(kFull, l[e], 1);
      l[e] += __shfl_xor_sync(kFull, l[e], 2);
      const int qpos = row + 8 * e;
      if (qpos >= S) continue;
      const float lc = fmaxf(l[e], 1e-30f), inv = 1.0f / lc;
#pragma unroll
      for (int p = 0; p < DP / 64; ++p)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = 64 * p + 8 * j + col;
          if (c < D)
            *reinterpret_cast<__nv_bfloat162*>(ob + qpos * q_stride + c) =
                __floats2bfloat162_rn(acc[p][4 * j + 2 * e] * inv,
                                      acc[p][4 * j + 2 * e + 1] * inv);
        }
      if (lane % 4 == 0)
        lse[static_cast<int64_t>(bkg) * S + qpos] = m[e] * kLn2 + logf(lc);
    }
  }
}

// -- dK / dV ----------------------------------------------------------------

template <int DP>
constexpr int dkv_smem_bytes() {  // K, V, then the Q and dO rings
  return (2 * kBwdBK * DP + 2 * kStages * kBwdBQ * DP) * 2 + 1024;
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int S,
                          int Sk, int KV, int G, int D, int causal, int window,
                          float scale, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t kv_full, full[kStages], empty[kStages];
  bf16* sK = align1024(smem_raw);
  bf16* sV = sK + kBwdBK * DP;
  bf16* sQ = sV + kBwdBK * DP;
  bf16* sdO = sQ + kStages * kBwdBQ * DP;

  const int bkv = blockIdx.x;                   // b * KV + kv
  const int kvh = bkv % KV, b = bkv / KV;
  const int k0 = blockIdx.y * kBwdBK;           // heaviest (causal) first

  // the query tiles that meet this key tile
  const int n_qt = (S + kBwdBQ - 1) / kBwdBQ;
  const int k_last = min(k0 + kBwdBK, Sk) - 1;
  const int qt_begin = causal ? min(n_qt, k0 / kBwdBQ) : 0;
  int qt_end = n_qt;
  if (window > 0) {  // the last query that may see key k_last
    const long long last = (static_cast<long long>(k_last) + window - 1) / kBwdBQ + 1;
    if (last < n_qt) qt_end = static_cast<int>(last);
  }
  const int nq = max(0, qt_end - qt_begin);
  const int n_tiles = G * nq;

  if (threadIdx.x == 0) {
    mbar_init(&kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---- producer ----
    setmaxnreg_producer();
    if (threadIdx.x == 128 * kConsumers) {
      mbar_expect_tx(&kv_full, 2 * kBwdBK * DP * 2);
      load_tile<DP, kBwdBK>(sK, &tk, &kv_full, kvh, k0, b);
      load_tile<DP, kBwdBK>(sV, &tv, &kv_full, kvh, k0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages, n = i / kStages;
        const int g = i / nq, q0 = (qt_begin + i % nq) * kBwdBQ;
        mbar_wait(&empty[s], (n & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * kBwdBQ * DP * 2);
        load_tile<DP, kBwdBQ>(sQ + s * kBwdBQ * DP, &tq, &full[s], kvh * G + g,
                              q0, b);
        load_tile<DP, kBwdBQ>(sdO + s * kBwdBQ * DP, &tdo, &full[s],
                              kvh * G + g, q0, b);
      }
    }
  } else {
    // ---- consumer warpgroup wg: keys k0 + 64 wg + [0, 64) ----
    setmaxnreg_consumer();
    const int t = threadIdx.x % 128, lane = t % 32;
    const int key = k0 + 64 * wg + 16 * (t / 32) + lane / 4;  // and key + 8
    const int col = 2 * (lane % 4);                           // in an 8-group
    const int wk_lo = k0 + 64 * wg, wk_hi = wk_lo + 63;

    float adk[DP / 64][32], adv[DP / 64][32];
#pragma unroll
    for (int p = 0; p < DP / 64; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) adk[p][i] = adv[p][i] = 0.0f;

    mbar_wait(&kv_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      const uint32_t par = (i / kStages) & 1;
      const int g = i / nq, q0 = (qt_begin + i % nq) * kBwdBQ;
      const bf16* tQ = sQ + s * kBwdBQ * DP;
      const bf16* tdO = sdO + s * kBwdBQ * DP;

      // this thread's query columns: 8 j + col + {0, 1}
      const int64_t head_row = (static_cast<int64_t>(bkv) * G + g) * S;
      float l2[16], dl[16];
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int qpos = q0 + 8 * (c / 2) + col + c % 2;
        l2[c] = qpos < S ? lse[head_row + qpos] * kLog2e : 0.0f;
        dl[c] = qpos < S ? delta[head_row + qpos] : 0.0f;
      }

      // S^T = K Q^T and dP^T = V dO^T
      float st[32], dpt[32];
      mbar_wait(&full[s], par);
      fence_regs(st);
      fence_regs(dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss_n64(st, desc_k<kBwdBK>(sK, 64 * wg, kk),
                     desc_k<kBwdBQ>(tQ, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss_n64(dpt, desc_k<kBwdBK>(sV, 64 * wg, kk),
                     desc_k<kBwdBQ>(tdO, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(st);
      fence_regs(dpt);

      // P^T = exp(scale S^T - lse) (0 where masked), dS^T = P^T (dP^T - delta) scale
      const bool edge = q0 + kBwdBQ > S || wk_hi >= Sk ||
                        (causal && wk_hi > q0) ||
                        (window > 0 && q0 + kBwdBQ - 1 - wk_lo >= window);
#pragma unroll
      for (int r = 0; r < 32; ++r) st[r] = ex2(st[r] * scale_log2 - l2[2 * (r / 4) + r % 2]);
      if (edge) {  // selects, no branches
#pragma unroll
        for (int r = 0; r < 32; ++r) {
          const int qpos = q0 + 8 * (r / 4) + col + r % 2;
          const int kpos = key + 8 * ((r % 4) / 2);
          const bool ok = qpos < S && kpos < Sk && !masked(qpos, kpos, causal, window);
          st[r] = ok ? st[r] : 0.0f;
        }
      }
      uint32_t pa[16], da[16];
#pragma unroll
      for (int r = 0; r < 32; ++r)
        dpt[r] = st[r] * (dpt[r] - dl[2 * (r / 4) + r % 2]) * scale;
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        pa[r] = pack_bf16(st[2 * r], st[2 * r + 1]);
        da[r] = pack_bf16(dpt[2 * r], dpt[2 * r + 1]);
      }

      // dV += P^T dO, dK += dS^T Q
#pragma unroll
      for (int p = 0; p < DP / 64; ++p) {
        fence_regs(adv[p]);
        fence_regs(adk[p]);
      }
      fence_regs(pa);
      fence_regs(da);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBwdBQ / 16; ++kk)
#pragma unroll
        for (int p = 0; p < DP / 64; ++p) {
          wgmma_rs_n64(adv[p], pa + 4 * kk, desc_mn<kBwdBQ>(tdO, kk, p), 1);
          wgmma_rs_n64(adk[p], da + 4 * kk, desc_mn<kBwdBQ>(tQ, kk, p), 1);
        }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int p = 0; p < DP / 64; ++p) {
        fence_regs(adv[p]);
        fence_regs(adk[p]);
      }
      mbar_arrive(&empty[s]);
    }

    // epilogue: dk, dv rows key and key + 8, bf16
    const int64_t k_stride = static_cast<int64_t>(KV) * D;
    const int64_t kv_off = static_cast<int64_t>(b) * Sk * k_stride + kvh * D;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int kpos = key + 8 * e;
      if (kpos >= Sk) continue;
#pragma unroll
      for (int p = 0; p < DP / 64; ++p)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = 64 * p + 8 * j + col;
          if (c >= D) continue;
          const int64_t at = kv_off + kpos * k_stride + c;
          *reinterpret_cast<__nv_bfloat162*>(dk + at) = __floats2bfloat162_rn(
              adk[p][4 * j + 2 * e], adk[p][4 * j + 2 * e + 1]);
          *reinterpret_cast<__nv_bfloat162*>(dv + at) = __floats2bfloat162_rn(
              adv[p][4 * j + 2 * e], adv[p][4 * j + 2 * e + 1]);
        }
    }
  }
}

// -- dQ ---------------------------------------------------------------------

template <int DP>
constexpr int dq_smem_bytes() {  // Q, dO, then the K and V rings
  return (2 * kDqBQ * DP + 2 * kStages * kDqBK * DP) * 2 + 1024;
}

// D (64 x N, f32) (+)= A (64 x 16) B (16 x N), both from shared memory.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (N == 128)
    wgmma_ss_n128(d, da, db, scale_d);
  else
    wgmma_ss_n64(d, da, db, scale_d);
}

// One block per (b, kv, g, 128-row query tile), as the forward; Q and dO
// stay in shared memory, K and V tiles of 128 keys arrive through the ring.
// Each key tile is taken in NK-key halves (NK = 128 at D <= 64; 64 at
// D = 128, where 128-key S and dP fragments beside dQ would spill).
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dq, int S, int Sk, int KV, int G,
                         int D, int causal, int window, float scale,
                         float scale_log2) {
  constexpr int NK = DP == 128 ? 64 : 128;      // keys a product covers
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t q_full, k_full[kStages], v_full[kStages],
      empty[kStages];
  bf16* sQ = align1024(smem_raw);
  bf16* sdO = sQ + kDqBQ * DP;
  bf16* sK = sdO + kDqBQ * DP;
  bf16* sV = sK + kStages * kDqBK * DP;

  const int bkg = blockIdx.x;                   // (b * KV + kv) * G + g
  const int g = bkg % G, kvh = (bkg / G) % KV, b = bkg / (G * KV);
  const int h = kvh * G + g;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kDqBQ;  // heaviest first

  // the band of key tiles: a tile in which every pair is masked adds nothing
  const int q1 = min(q0 + kDqBQ, S) - 1;        // last real row of the tile
  const int n_kt = (Sk + kDqBK - 1) / kDqBK;
  const int kt_end = causal ? min(n_kt, q1 / kDqBK + 1) : n_kt;
  const int kt_begin = window > 0 ? max(0, q0 - window + 1) / kDqBK : 0;
  const int n_tiles = max(0, kt_end - kt_begin);

  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---- producer: one thread keeps the ring full ----
    setmaxnreg_producer();
    if (threadIdx.x == 128 * kConsumers) {
      constexpr uint32_t tile_bytes = kDqBK * DP * 2;
      mbar_expect_tx(&q_full, 2 * kDqBQ * DP * 2);
      load_tile<DP, kDqBQ>(sQ, &tq, &q_full, h, q0, b);
      load_tile<DP, kDqBQ>(sdO, &tdo, &q_full, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages, n = i / kStages;
        const int k0 = (kt_begin + i) * kDqBK;
        mbar_wait(&empty[s], (n & 1) ^ 1);
        mbar_expect_tx(&k_full[s], tile_bytes);
        load_tile<DP, kDqBK>(sK + s * kDqBK * DP, &tk, &k_full[s], kvh, k0, b);
        mbar_expect_tx(&v_full[s], tile_bytes);
        load_tile<DP, kDqBK>(sV + s * kDqBK * DP, &tv, &v_full[s], kvh, k0, b);
      }
    }
  } else {
    // ---- consumer warpgroup wg: query rows q0 + 64 wg + [0, 64) ----
    setmaxnreg_consumer();
    const int t = threadIdx.x % 128, lane = t % 32;
    const int row = q0 + 64 * wg + 16 * (t / 32) + lane / 4;  // and row + 8
    const int col = 2 * (lane % 4);                           // in an 8-group
    const int wq_lo = q0 + 64 * wg, wq_hi = wq_lo + 63;

    // the two rows' lse (log2 scale) and delta, for the whole block
    float l2[2], dl[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int qpos = row + 8 * e;
      l2[e] = qpos < S ? lse[static_cast<int64_t>(bkg) * S + qpos] * kLog2e : 0.0f;
      dl[e] = qpos < S ? delta[static_cast<int64_t>(bkg) * S + qpos] : 0.0f;
    }

    float acc[DP / 64][32];
#pragma unroll
    for (int p = 0; p < DP / 64; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[p][i] = 0.0f;

    mbar_wait(&q_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      const uint32_t par = (i / kStages) & 1;
      const bf16* tK = sK + s * kDqBK * DP;
      const bf16* tV = sV + s * kDqBK * DP;
      mbar_wait(&k_full[s], par);
      mbar_wait(&v_full[s], par);
#pragma unroll
      for (int half = 0; half < kDqBK / NK; ++half) {
        const int k0 = (kt_begin + i) * kDqBK + NK * half;

        // S = Q K^T and dP = dO V^T over keys [k0, k0 + NK)
        float sc[NK / 2], dp[NK / 2];
        fence_regs(sc);
        fence_regs(dp);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          wgmma_ss<NK>(sc, desc_k<kDqBQ>(sQ, 64 * wg, kk),
                       desc_k<kDqBK>(tK, NK * half, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          wgmma_ss<NK>(dp, desc_k<kDqBQ>(sdO, 64 * wg, kk),
                       desc_k<kDqBK>(tV, NK * half, kk), kk > 0);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);
        fence_regs(dp);

        // p = exp(scale s - lse), exactly 0 where masked or past Sk (only a
        // tile on the band's edge needs the selects);
        // ds = p (dp - delta) scale, rounded to bf16: the A operand
        const bool edge = k0 + NK > Sk || (causal && k0 + NK - 1 > wq_lo) ||
                          (window > 0 && wq_hi - k0 >= window);
#pragma unroll
        for (int r = 0; r < NK / 2; ++r)
          sc[r] = ex2(sc[r] * scale_log2 - l2[(r % 4) / 2]);
        if (edge) {
#pragma unroll
          for (int r = 0; r < NK / 2; ++r) {
            const int kpos = k0 + 8 * (r / 4) + col + (r % 2);
            const int qpos = row + 8 * ((r % 4) / 2);
            const bool ok = kpos < Sk && !masked(qpos, kpos, causal, window);
            sc[r] = ok ? sc[r] : 0.0f;
          }
        }
        uint32_t da[NK / 4];
#pragma unroll
        for (int r = 0; r < NK / 2; ++r)
          dp[r] = sc[r] * (dp[r] - dl[(r % 4) / 2]) * scale;
#pragma unroll
        for (int r = 0; r < NK / 4; ++r) da[r] = pack_bf16(dp[2 * r], dp[2 * r + 1]);

        // dQ += dS K, K read as an MN-major B operand (as the forward's V)
#pragma unroll
        for (int p = 0; p < DP / 64; ++p) fence_regs(acc[p]);
        fence_regs(da);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < NK / 16; ++kk)
#pragma unroll
          for (int p = 0; p < DP / 64; ++p)
            wgmma_rs_n64(acc[p], da + 4 * kk,
                         desc_mn<kDqBK>(tK, NK / 16 * half + kk, p), 1);
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int p = 0; p < DP / 64; ++p) fence_regs(acc[p]);
      }
      mbar_arrive(&empty[s]);
    }

    // epilogue: dq rows row and row + 8, bf16
    const int64_t q_stride = static_cast<int64_t>(KV) * G * D;
    bf16* dqb = dq + static_cast<int64_t>(b) * S * q_stride + h * D;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int qpos = row + 8 * e;
      if (qpos >= S) continue;
#pragma unroll
      for (int p = 0; p < DP / 64; ++p)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = 64 * p + 8 * j + col;
          if (c < D)
            *reinterpret_cast<__nv_bfloat162*>(dqb + qpos * q_stride + c) =
                __floats2bfloat162_rn(acc[p][4 * j + 2 * e],
                                      acc[p][4 * j + 2 * e + 1]);
        }
    }
  }
}

// -- host: tensor maps and launches -----------------------------------------

// Error codes of this library beyond cudaError_t's.
constexpr int kErrNoEncoder = 10001;  // cuTensorMapEncodeTiled not found
constexpr int kErrTensorMap = 10002;  // a tensor map was refused

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime: the library
// links no -lcuda.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor (batch, rows, heads, dim), contiguous, as a 4-D map whose
// boxes are 64 columns of one head over `box_rows` rows, 128-byte swizzled;
// out-of-bounds elements (dim < 64, rows past the end) read as zero.
int make_map(CUtensorMap* map, const void* ptr, int dim, int heads, int rows,
             int batch, int box_rows) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dim),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {dims[0] * 2, dims[0] * dims[1] * 2,
                                 dims[0] * dims[1] * dims[2] * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                         const_cast<void*>(ptr), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap;
}

template <int DP>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
               int B, int S, int Sk, int KV, int G, int D, int causal,
               int window, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, D, KV * G, S, B, kFwdBQ);
  if (!err) err = make_map(&tk, k, D, KV, Sk, B, kFwdBK);
  if (!err) err = make_map(&tv, v, D, KV, Sk, B, kFwdBK);
  if (err) return err;
  auto kernel = flash_fwd_sm90_kernel<DP>;
  constexpr int bytes = fwd_smem_bytes<DP>();
  cudaError_t cerr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (cerr != cudaSuccess) return cerr;
  const dim3 grid(B * KV * G, (S + kFwdBQ - 1) / kFwdBQ);
  kernel<<<grid, kThreads, bytes, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), static_cast<float*>(lse), S, Sk, KV,
      G, D, causal, window, scale * kLog2e);
  return cudaGetLastError();
}

template <int DP>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int B,
               int S, int Sk, int KV, int G, int D, int causal, int window,
               float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  int err = make_map(&tq, q, D, KV * G, S, B, kBwdBQ);
  if (!err) err = make_map(&tdo, dout, D, KV * G, S, B, kBwdBQ);
  if (!err) err = make_map(&tk, k, D, KV, Sk, B, kBwdBK);
  if (!err) err = make_map(&tv, v, D, KV, Sk, B, kBwdBK);
  if (err) return err;
  auto kernel = flash_bwd_dkv_sm90_kernel<DP>;
  constexpr int bytes = dkv_smem_bytes<DP>();
  cudaError_t cerr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (cerr != cudaSuccess) return cerr;
  const dim3 grid(B * KV, (Sk + kBwdBK - 1) / kBwdBK);
  kernel<<<grid, kThreads, bytes, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), S, Sk, KV, G, D, causal, window, scale,
      scale * kLog2e);
  return cudaGetLastError();
}

template <int DP>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int S,
              int Sk, int KV, int G, int D, int causal, int window,
              float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  int err = make_map(&tq, q, D, KV * G, S, B, kDqBQ);
  if (!err) err = make_map(&tdo, dout, D, KV * G, S, B, kDqBQ);
  if (!err) err = make_map(&tk, k, D, KV, Sk, B, kDqBK);
  if (!err) err = make_map(&tv, v, D, KV, Sk, B, kDqBK);
  if (err) return err;
  auto kernel = flash_bwd_dq_sm90_kernel<DP>;
  constexpr int bytes = dq_smem_bytes<DP>();
  cudaError_t cerr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (cerr != cudaSuccess) return cerr;
  const dim3 grid(B * KV * G, (S + kDqBQ - 1) / kDqBQ);
  kernel<<<grid, kThreads, bytes, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), S, Sk, KV, G,
      D, causal, window, scale, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Run on `stream`, allocate nothing, do not synchronise, and return 0 when
// the launch was accepted, else a cudaError_t or one of the codes above.
// The caller checks shapes: contiguous bf16 q (B, S, KV, G, D), k and v
// (B, Sk, KV, D), every pointer 16-byte aligned, 8 <= D <= 128 with
// D % 8 == 0, S, Sk >= 1, B * KV * G < 2^31, ceil(S / 128) <= 65535; o like
// q, lse f32 (B, KV, G, S).

int flash_fwd_sm90_launch(const void* q, const void* k, const void* v,
                          void* o, void* lse, int B, int S, int Sk, int KV,
                          int G, int D, int causal, int window, float scale,
                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D <= 64 ? launch_fwd<64>(q, k, v, o, lse, B, S, Sk, KV, G, D, causal,
                                  window, scale, s)
                 : launch_fwd<128>(q, k, v, o, lse, B, S, Sk, KV, G, D,
                                   causal, window, scale, s);
}

// The forward's shapes and rules, plus dout like q, lse and delta f32
// (B, KV, G, S), dk and dv like k; ceil(Sk / 128) <= 65535.
int flash_bwd_dkv_sm90_launch(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, void* dk, void* dv, int B,
                              int S, int Sk, int KV, int G, int D, int causal,
                              int window, float scale, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D <= 64 ? launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, B, S, Sk,
                                  KV, G, D, causal, window, scale, s)
                 : launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, B, S,
                                   Sk, KV, G, D, causal, window, scale, s);
}

// The forward's shapes and rules, plus dout like q, lse and delta f32
// (B, KV, G, S), dq like q.
int flash_bwd_dq_sm90_launch(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dq, int B, int S,
                             int Sk, int KV, int G, int D, int causal,
                             int window, float scale, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D <= 64 ? launch_dq<64>(q, k, v, dout, lse, delta, dq, B, S, Sk, KV,
                                 G, D, causal, window, scale, s)
                 : launch_dq<128>(q, k, v, dout, lse, delta, dq, B, S, Sk,
                                  KV, G, D, causal, window, scale, s);
}

const char* kernel_error_string(int err) {
  if (err == kErrNoEncoder)
    return "cuTensorMapEncodeTiled not found (TMA needs CUDA 12)";
  if (err == kErrTensorMap)
    return "cuTensorMapEncodeTiled refused a tensor map (alignment or shape)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
