// The decode attention kernel over the packed KV cache: its templates,
// included by decode_attention.cu (the bf16 tensor-core instantiations)
// and decode_attention_f32.cu (the f32 CUDA-core ones), built as two
// libraries in parallel.  The design and the function are described in
// decode_attention.cu.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;     // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 16;      // query rows a CTA (mma's M)
constexpr int kMaxSplit = 8;      // CTAs a cluster (portable limit)
constexpr int kScorePad = 8;      // floats after each row of scores
constexpr float kNegInf = -1e30f; // the reference's finite mask value

// cache element kinds
enum Code { kInt8 = 0, kInt4 = 1, kBf16 = 2, kF32 = 3 };

template <int CODE, int HD>
struct Layout {
  // bytes of one cache row (a slot of one KV head) and of a stage
  static constexpr int row_bytes =
      CODE == kInt8 ? HD : CODE == kInt4 ? HD / 2 : CODE == kBf16 ? 2 * HD : 4 * HD;
  static constexpr bool scaled = CODE == kInt8 || CODE == kInt4;
  // slots a tile, 8 a warp (an mma's n), and the stages of the ring: two
  // tiles of packed codes in flight while one is worked on (a short cache's
  // two tiles of K, then of V, load together), bf16 / f32 rows double
  // buffered.  A CTA walks only the tiles that meet its row's valid
  // interval (valid_interval), so its time follows the tiles it walks, not
  // the slots it holds.  Shared memory follows the slots it holds: at 32k
  // slots (B 16, G 4: 4 splits of 8,192) ~174 KB, one CTA an SM; at B 8,
  // 8 splits of 4,096, ~107 KB, two
  static constexpr int tile = 8 * kWarps;
  static constexpr int stages = scaled ? 3 : 2;
  static constexpr int stage_bytes = tile * row_bytes + (scaled ? tile * 4 : 0);
};

template <bool BF16>
struct Ct;
template <>
struct Ct<true> {
  using T = __nv_bfloat16;
  static constexpr int pad = 8;   // row stride HD + 8: ldmatrix conflict-free
};
template <>
struct Ct<false> {
  using T = float;
  static constexpr int pad = 4;
};

template <int CODE, bool BF16, int HD>
struct Smem {
  using L = Layout<CODE, HD>;
  using T = typename Ct<BF16>::T;
  static constexpr int xs = HD + Ct<BF16>::pad;           // X row stride
  static constexpr int raw = 0;
  static constexpr int x = raw + L::stages * L::stage_bytes;
  static constexpr int x_bytes = L::tile * xs * static_cast<int>(sizeof(T));
  // the query rows: in bf16 they share the X tile (their mma fragments are
  // in registers before the first tile is dequantized into it), in f32 the
  // FMAs read them through pass 1
  static constexpr int qs = HD + 8;                       // bf16 q row stride
  static constexpr int q_bytes = BF16 ? kMaxRows * qs * 2 : kMaxRows * HD * 4;
  static constexpr int q = BF16 ? x : x + x_bytes;
  static_assert(!BF16 || q_bytes <= x_bytes, "the bf16 query rows fit the X tile");
  // a row's max and sum, and each warp's partial of them
  static constexpr int red = BF16 ? x + x_bytes : q + q_bytes;
  static constexpr int red_bytes = (2 + kWarps) * kMaxRows * 4;
  static constexpr int scores = red + red_bytes;
  static_assert(x % 16 == 0 && q % 16 == 0 && scores % 16 == 0, "alignment");
  // the partial output (rows x HD f32) reuses the X tile after pass 2
  static_assert(kMaxRows * HD * 4 <= x_bytes, "opart fits the X tile");
  static int bytes(int rows, int sc) {
    return scores + rows * (sc + kScorePad) * 4;
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldsm_x2_trans(unsigned (&r)[2], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s));
}

// d += a * b, m16n8k16, bf16 inputs, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// x rounded to the compute dtype, as a float
template <bool BF16>
__device__ __forceinline__ float rnd(float x) {
  return BF16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// a signed byte of w (w already XORed with 0x80808080) as an exact float:
// the byte lands in the mantissa of 2^23, which the subtraction removes
__device__ __forceinline__ float s8_at(unsigned w, int k) {
  return __int_as_float(__byte_perm(w, 0x4B000000u, 0x7440 | k)) - 8388736.0f;
}

// nibble m of w (w already XORed with 0x88888888), sign-extended, exact
__device__ __forceinline__ float s4_at(unsigned w, int m) {
  return __int_as_float(0x4B000000u | ((w >> (4 * m)) & 0xFu)) - 8388616.0f;
}

__device__ __forceinline__ bool slot_valid(int j, int p, int s_all, int window,
                                           int ring) {
  if (ring) {
    int r = (p - j) % s_all;
    if (r < 0) r += s_all;
    return p - r >= 0;
  }
  return j <= p && (window <= 0 || p - j < window);
}

// The slots [a, b) of the launch's block (slot s is the cache's lo + s, s in
// [0, S)) that slot_valid admits for position p: one interval, causal
// [0, p], within the window [p - window + 1, p], on a ring of s_all slots
// [0, min(p, s_all - 1)] (a ring's block lies in [0, s_all): the wrapper
// checks).  a >= b where none is.  decode_attention.py::valid_interval is
// its twin.
__device__ __forceinline__ void valid_interval(int p, int lo, int S, int s_all,
                                               int window, int ring, int& a,
                                               int& b) {
  int64_t g0, g1;   // the cache's valid slots [g0, g1]
  if (ring) {
    g0 = 0, g1 = min(p, s_all - 1);
  } else {
    g0 = window > 0 ? static_cast<int64_t>(p) - window + 1 : static_cast<int64_t>(lo);
    g1 = p;
  }
  const int64_t x = g0 - lo, y = g1 - lo + 1;
  a = static_cast<int>(x < 0 ? 0 : x > S ? S : x);
  b = static_cast<int>(y < 0 ? 0 : y > S ? S : y);
}

// cp.async of a tile's cache rows [r0, r1) (slot after slot from row0,
// `stride` rows apart in the cache) and their scales into one stage
template <int CODE, int HD>
__device__ __forceinline__ void issue_tile(unsigned char* dst,
                                           const unsigned char* codes,
                                           const float* scales, int64_t row0,
                                           int stride, int r0, int r1, int tid) {
  using L = Layout<CODE, HD>;
  constexpr int chunks = L::row_bytes / 16;
  constexpr int per = (L::tile * chunks + kThreads - 1) / kThreads;
#pragma unroll
  for (int k = 0; k < per; ++k) {
    const int u = tid + k * kThreads;
    const int jj = u / chunks, ch = u - jj * chunks;
    if (jj >= r0 && jj < r1)
      cp_async16(dst + jj * L::row_bytes + ch * 16,
                 codes + (row0 + static_cast<int64_t>(jj) * stride) * L::row_bytes +
                     ch * 16);
  }
  if constexpr (L::scaled) {
    float* sd = reinterpret_cast<float*>(dst + L::tile * L::row_bytes);
    for (int jj = r0 + tid; jj < r1; jj += kThreads)
      cp_async4(sd + jj, scales + row0 + static_cast<int64_t>(jj) * stride);
  }
}

// 8 packed codes (unit cu of a row) times the row's scale, exact in f32
template <int CODE, int HD>
__device__ __forceinline__ void dequant8(const unsigned char* row, float s, int cu,
                                         float (&v)[8]) {
  if constexpr (CODE == kInt8) {
    const uint2 w = *reinterpret_cast<const uint2*>(row + cu * 8);
    const unsigned lo = w.x ^ 0x80808080u, hi = w.y ^ 0x80808080u;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[k] = s8_at(lo, k) * s;
      v[4 + k] = s8_at(hi, k) * s;
    }
  } else {
    const unsigned w = *reinterpret_cast<const unsigned*>(row + cu * 4) ^ 0x88888888u;
#pragma unroll
    for (int m = 0; m < 8; ++m) v[m] = s4_at(w, m) * s;
  }
}

// one stage's rows [r0, r1) dequantized (and rounded to the compute dtype)
// into the X tile, 8 values a unit; the other rows (padding past the cache,
// slots outside the row's valid interval, never loaded) become zeros, so
// that a slot of probability 0 multiplies zeros.  FULL: every row is in
// [r0, r1), and no row is checked (without the checks the compiler batches
// a thread's units: ~6% of the kernel's time on an H100 where most tiles
// are whole)
template <int CODE, bool BF16, int HD, bool FULL = false>
__device__ __forceinline__ void dequant_tile(const unsigned char* raw,
                                             typename Ct<BF16>::T* X, int r0,
                                             int r1, int tid) {
  using L = Layout<CODE, HD>;
  constexpr int units = HD / 8;
  constexpr int xs = Smem<CODE, BF16, HD>::xs;
  const float* sc = reinterpret_cast<const float*>(raw + L::tile * L::row_bytes);
  static_assert(L::tile * units % kThreads == 0, "whole units a thread");
#pragma unroll
  for (int k = 0; k < L::tile * units / kThreads; ++k) {
    const int u = tid + k * kThreads;
    const int jj = u / units, cu = u - jj * units;
    const unsigned char* row = raw + jj * L::row_bytes;
    uint4* dst = reinterpret_cast<uint4*>(X + jj * xs + cu * 8);
    if constexpr (!L::scaled) {   // the cache's own values, copied
      constexpr int vec = CODE == kBf16 ? 1 : 2;
#pragma unroll
      for (int i = 0; i < vec; ++i)
        dst[i] = FULL || (jj >= r0 && jj < r1)
                     ? reinterpret_cast<const uint4*>(row)[cu * vec + i]
                     : make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    float v[8] = {};
    if (FULL || (jj >= r0 && jj < r1)) dequant8<CODE, HD>(row, sc[jj], cu, v);
    if constexpr (BF16) {
      dst[0] = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                          pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
    } else {
      dst[0] = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                          __float_as_uint(v[2]), __float_as_uint(v[3]));
      dst[1] = make_uint4(__float_as_uint(v[4]), __float_as_uint(v[5]),
                          __float_as_uint(v[6]), __float_as_uint(v[7]));
    }
  }
}

template <int CODE, bool BF16, bool MMA, int HD>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const void* __restrict__ qp, int64_t q_sb,
                            int64_t q_sh, const void* __restrict__ k_codes,
                            const void* __restrict__ v_codes,
                            const float* __restrict__ k_scale,
                            const float* __restrict__ v_scale,
                            const int* __restrict__ pos, float* __restrict__ out,
                            int S, int KV, int G, int q0, int n, int lo,
                            int s_all, int window, int ring, int round_p,
                            float scale_attn, int sc_len, int nsplit,
                            unsigned long long* __restrict__ tiles_walked) {
  using L = Layout<CODE, HD>;
  using SM = Smem<CODE, BF16, HD>;
  using T = typename Ct<BF16>::T;
  static_assert(!MMA || BF16, "the tensor-core path takes bf16");
  extern __shared__ __align__(16) unsigned char smem[];
  T* X = reinterpret_cast<T*>(smem + SM::x);
  float* red_max = reinterpret_cast<float*>(smem + SM::red);
  float* red_sum = red_max + kMaxRows;
  float* red_warp = red_sum + kMaxRows;   // [kWarps][kMaxRows]
  float* scores = reinterpret_cast<float*>(smem + SM::scores);
  const int scs = sc_len + kScorePad;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int split = blockIdx.x, b = blockIdx.z;
  const int g = q0 / G + blockIdx.y;
  const int hs = max(q0, g * G), he = min(q0 + n, (g + 1) * G);
  const int R = he - hs;
  const int s_begin = split * sc_len;
  const int nloc = max(0, min(S, s_begin + sc_len) - s_begin);
  const int p = pos[b];
  const int64_t row0 = (static_cast<int64_t>(b) * S + s_begin) * KV + g;
  // the CTA's slots [ca, cb) that are valid for p, and the tiles [t0, t1)
  // that meet them: the only tiles it loads and walks.  A row with no valid
  // slot takes every slot (the softmax averages them all, as the plain
  // version's does).  A CTA whose slots hold none walks no tile: a max of
  // -inf, a sum of 0 and a zero partial in the cluster's combine.
  int va, vb;
  valid_interval(p, lo, S, s_all, window, ring, va, vb);
  if (va >= vb) va = 0, vb = S;
  const int ca = max(va - s_begin, 0), cb = min(vb - s_begin, nloc);
  const int t0 = ca < cb ? ca / L::tile : 0;
  const int t1 = ca < cb ? (cb + L::tile - 1) / L::tile : 0;
  if (tiles_walked != nullptr && tid == 0)
    atomicAdd(tiles_walked, static_cast<unsigned long long>(t1 - t0));

  // the query rows, rounded to the compute dtype
  {
    const T* q = static_cast<const T*>(qp) + b * q_sb + (hs - q0) * q_sh;
    for (int i = tid; i < kMaxRows * HD; i += kThreads) {
      const int r = i / HD, d = i - r * HD;
      const float v = r < R ? rnd<BF16>(to_f32(q[r * q_sh + d])) : 0.0f;
      if constexpr (BF16)
        reinterpret_cast<__nv_bfloat16*>(smem + SM::q)[r * SM::qs + d] =
            __float2bfloat16_rn(v);
      else
        reinterpret_cast<float*>(smem + SM::q)[r * HD + d] = v;
    }
  }

  // tile t's rows that are valid slots (the ring's stages indexed from t0)
  auto tile_r0 = [&](int t) { return max(ca - t * L::tile, 0); };
  auto tile_r1 = [&](int t) { return min(cb - t * L::tile, L::tile); };
  auto issue = [&](const void* codes, const float* scales, int t) {
    if (t < t1)
      issue_tile<CODE, HD>(smem + SM::raw + ((t - t0) % L::stages) * L::stage_bytes,
                           static_cast<const unsigned char*>(codes), scales,
                           row0 + static_cast<int64_t>(t) * L::tile * KV, KV,
                           tile_r0(t), tile_r1(t), tid);
    cp_async_commit();
  };
  // the ring's loop over one pass's tiles: tile i arrives, the next load
  // goes out, tile i is dequantized into X, then `work(i)` takes it
  auto walk = [&](const void* codes, const float* scales, auto&& work) {
    for (int i = t0; i < t1; ++i) {
      cp_async_wait<L::stages - 2>();
      __syncthreads();
      issue(codes, scales, i + L::stages - 1);
      const unsigned char* raw = smem + SM::raw + ((i - t0) % L::stages) * L::stage_bytes;
      const int r0 = tile_r0(i), r1 = tile_r1(i);
      if (r0 == 0 && r1 == L::tile)
        dequant_tile<CODE, BF16, HD, true>(raw, X, r0, r1, tid);
      else
        dequant_tile<CODE, BF16, HD>(raw, X, r0, r1, tid);
      __syncthreads();
      work(i);
    }
  };

  for (int t = 0; t < L::stages - 1; ++t) issue(k_codes, k_scale, t0 + t);
  __syncthreads();   // the query rows

  // ---- pass 1: scores ----------------------------------------------------
  auto store_score = [&](int r, int jl, float acc) {
    const int s = s_begin + jl;
    scores[r * scs + jl] = slot_valid(lo + s, p, s_all, window, ring)
                               ? acc * scale_attn
                               : kNegInf;
  };
  if constexpr (MMA) {
    unsigned qa[HD / 16][4];
    const __nv_bfloat16* qs = reinterpret_cast<const __nv_bfloat16*>(smem + SM::q);
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks)
      ldsm_x4(qa[ks], qs + (lane & 15) * SM::qs + ks * 16 + (lane >> 4) * 8);
    walk(k_codes, k_scale, [&](int i) {
      // this warp's 8 slots of the tile; even and odd k-steps in two
      // accumulators (two mma chains in flight)
      float acc[2][4] = {};
      const int sw = warp * 8;
#pragma unroll
      for (int kp = 0; kp < HD / 32; ++kp) {
        unsigned bk[4];
        ldsm_x4(bk, X + (sw + (lane & 7)) * SM::xs + kp * 32 + (lane >> 3) * 8);
        mma_bf16(acc[0], qa[2 * kp], bk[0], bk[1]);
        mma_bf16(acc[1], qa[2 * kp + 1], bk[2], bk[3]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = (lane >> 2) + (e >> 1) * 8;
        const int jl = i * L::tile + sw + 2 * (lane & 3) + (e & 1);
        if (r < R && jl < nloc) store_score(r, jl, acc[0][e] + acc[1][e]);
      }
    });
  } else {
    const float* qf = reinterpret_cast<const float*>(smem + SM::q);
    walk(k_codes, k_scale, [&](int i) {
      const int jl = i * L::tile + tid;
      if (tid < L::tile && jl < nloc) {
        float acc[kMaxRows] = {};
        const T* x = X + tid * SM::xs;
        for (int d = 0; d < HD; ++d) {
          const float kv = to_f32(x[d]);
#pragma unroll
          for (int r = 0; r < kMaxRows; ++r)
            if (r < R) acc[r] = fmaf(qf[r * HD + d], kv, acc[r]);
        }
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r)
          if (r < R) store_score(r, jl, acc[r]);
      }
    });
  }
  __syncthreads();
  // V's first tiles go out while the softmax runs (the stages are free)
  for (int t = 0; t < L::stages - 1; ++t) issue(v_codes, v_scale, t0 + t);

  // ---- softmax over every slot of the row, the cluster's max and sum
  // combined before any probability is formed.  Only the walked slots
  // [w0, w1) are summed: a slot outside them is masked, and its exp(-1e30 -
  // max) is 0, so each thread keeping the slots jl = tid (mod kThreads) of a
  // walk over every slot sums what that walk sums, bit for bit -------------
  cg::cluster_group cluster = cg::this_cluster();
  // a row's reduction over the CTA's threads (each its slots jl = tid,
  // tid + kThreads, ...): the lanes by a shuffle tree, the warps in order;
  // then over the cluster's CTAs in rank order.  Fixed orders: the result
  // is the same at every launch.
  auto reduce_rows = [&](float (&x)[kMaxRows], float* dst, bool is_max) {
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      if (r >= R) break;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float y = __shfl_xor_sync(0xFFFFFFFFu, x[r], o);
        x[r] = is_max ? fmaxf(x[r], y) : x[r] + y;
      }
      if (lane == 0) red_warp[warp * kMaxRows + r] = x[r];
    }
    __syncthreads();
    if (tid < R) {
      float v = red_warp[tid];
      for (int w = 1; w < kWarps; ++w)
        v = is_max ? fmaxf(v, red_warp[w * kMaxRows + tid]) : v + red_warp[w * kMaxRows + tid];
      dst[tid] = v;
    }
    __syncthreads();
    if (nsplit > 1) cluster.sync();
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      if (r >= R) break;
      if (nsplit > 1) {
        float v = *cluster.map_shared_rank(dst + r, 0);
        for (int c = 1; c < nsplit; ++c) {
          const float y = *cluster.map_shared_rank(dst + r, c);
          v = is_max ? fmaxf(v, y) : v + y;
        }
        x[r] = v;
      } else {
        x[r] = dst[r];
      }
    }
  };
  const int w0 = t0 * L::tile, w1 = min(t1 * L::tile, nloc);
  const int first = w0 + ((tid - w0) % kThreads + kThreads) % kThreads;
  float m[kMaxRows], sum[kMaxRows];
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) m[r] = -INFINITY, sum[r] = 0.0f;
  for (int jl = first; jl < w1; jl += kThreads)
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r)
      if (r < R) m[r] = fmaxf(m[r], scores[r * scs + jl]);
  reduce_rows(m, red_max, true);
  for (int jl = first; jl < w1; jl += kThreads)
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r)
      if (r < R) {
        const float e = expf(scores[r * scs + jl] - m[r]);
        scores[r * scs + jl] = e;
        sum[r] += e;
      }
  reduce_rows(sum, red_sum, false);
  for (int jl = w0 + tid; jl < t1 * L::tile; jl += kThreads)
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r)
      if (r < R) {
        float pr = 0.0f;   // padded slots: probability 0
        if (jl < nloc) {
          pr = scores[r * scs + jl] / sum[r];
          if (round_p) pr = rnd<BF16>(pr);
        }
        scores[r * scs + jl] = pr;
      }
  __syncthreads();

  // ---- pass 2: P.V ---------------------------------------------------------
  float* opart = reinterpret_cast<float*>(smem + SM::x);   // after the pass
  if constexpr (MMA) {
    constexpr int nbw = (HD / 8 + kWarps - 1) / kWarps;   // n-blocks a warp
    float acc[nbw][4] = {};
    walk(v_codes, v_scale, [&](int i) {
#pragma unroll
      for (int ks = 0; ks < L::tile / 16; ++ks) {
        const int c0 = i * L::tile + ks * 16 + 2 * (lane & 3);
        unsigned pa[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = (lane >> 2) + (e & 1) * 8, c = c0 + (e >> 1) * 8;
          const float2 pv = r < R ? *reinterpret_cast<const float2*>(scores + r * scs + c)
                                  : make_float2(0.0f, 0.0f);
          pa[e] = pack_bf16(pv.x, pv.y);
        }
#pragma unroll
        for (int j = 0; j < nbw; ++j) {
          const int nb = warp * nbw + j;
          if (nb < HD / 8) {
            unsigned bv[2];
            ldsm_x2_trans(bv, X + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * SM::xs +
                                  nb * 8);
            mma_bf16(acc[j], pa, bv[0], bv[1]);
          }
        }
      }
    });
    __syncthreads();   // X free: it becomes opart
#pragma unroll
    for (int j = 0; j < nbw; ++j) {
      const int nb = warp * nbw + j;
      if (nb < HD / 8)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = (lane >> 2) + h * 8;
          if (r < R)
            *reinterpret_cast<float2*>(opart + r * HD + nb * 8 + 2 * (lane & 3)) =
                make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
        }
    }
  } else {
    float acc[kMaxRows] = {};
    walk(v_codes, v_scale, [&](int i) {
      if (tid < HD) {
        for (int jj = 0; jj < L::tile; ++jj) {
          const float vv = to_f32(X[jj * SM::xs + tid]);
#pragma unroll
          for (int r = 0; r < kMaxRows; ++r)
            if (r < R) acc[r] = fmaf(scores[r * scs + i * L::tile + jj], vv, acc[r]);
        }
      }
    });
    __syncthreads();
    if (tid < HD)
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r)
        if (r < R) opart[r * HD + tid] = acc[r];
  }
  __syncthreads();

  // ---- the output: this CTA's rows, summed over the cluster in rank order
  float* o = out + (static_cast<int64_t>(b) * n + (hs - q0)) * HD;
  if (nsplit == 1) {
    for (int e = tid; e < R * HD; e += kThreads) o[e] = opart[e];
    return;
  }
  cluster.sync();
  const int chunk = (R * HD + nsplit - 1) / nsplit;
  const int e1 = min(R * HD, (split + 1) * chunk);
  for (int e = split * chunk + tid; e < e1; e += kThreads) {
    float acc = 0.0f;
    for (int c = 0; c < nsplit; ++c) acc += *cluster.map_shared_rank(opart + e, c);
    o[e] = acc;
  }
  cluster.sync();   // keep this CTA's shared memory until every rank has read it
}

struct Plan {
  int nsplit, sc_len, smem;
};

int sm_count(int device) {
  static int cached[64] = {};
  if (device < 0 || device >= 64) return 132;
  if (cached[device] == 0) {
    int v = 0;
    if (cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, device) != cudaSuccess || v <= 0)
      v = 132;
    cached[device] = v;
  }
  return cached[device];
}

constexpr int kMaxSmem = 232448;   // 227 KB: a block's shared memory on an H100

// The split of the slots: the fewest CTAs a (row, KV head) whose scores fit
// shared memory, then more while the grid holds fewer than two CTAs an SM
// and each CTA keeps at least two tiles.
template <int CODE, bool BF16, int HD>
Plan plan_for(int B, int S, int kvb, int rows, int device) {
  using SM = Smem<CODE, BF16, HD>;
  constexpr int kT = Layout<CODE, HD>::tile;
  const int target = 2 * sm_count(device);
  Plan pl{0, 0, 0};
  for (int ns = 1; ns <= kMaxSplit; ns *= 2) {
    const int sc = ((S + ns - 1) / ns + kT - 1) / kT * kT;
    const int smem = SM::bytes(rows, sc);
    if (smem > kMaxSmem) continue;
    pl = Plan{ns, sc, smem};
    const bool more = static_cast<int64_t>(B) * kvb * ns < target &&
                      (S + 2 * ns - 1) / (2 * ns) >= 2 * kT;
    if (!more) break;
  }
  return pl;
}

template <int CODE, bool BF16, bool MMA, int HD>
int launch(const void* q, int64_t q_sb, int64_t q_sh, const void* kc,
           const void* vc, const void* ks, const void* vs, const void* pos,
           void* out, int B, int S, int KV, int G, int q0, int n, int lo,
           int s_all, int window, int ring, int round_p, float scale,
           int device, cudaStream_t stream, int* plan_out,
           unsigned long long* tiles_walked) {
  const int kvb = (q0 + n - 1) / G - q0 / G + 1;
  const int rows = min(G, n);
  const Plan pl = plan_for<CODE, BF16, HD>(B, S, kvb, rows, device);
  if (plan_out) {
    plan_out[0] = pl.nsplit;
    plan_out[1] = pl.smem;
    plan_out[2] = pl.sc_len;
  }
  if (pl.nsplit == 0) return -1;   // the scores of one (row, KV head) do not fit 8 CTAs
  if (!out) return 0;              // plan only
  auto kernel = decode_attention_kernel<CODE, BF16, MMA, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.nsplit, kvb, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, q, q_sb, q_sh, kc, vc,
                           static_cast<const float*>(ks), static_cast<const float*>(vs),
                           static_cast<const int*>(pos), static_cast<float*>(out), S,
                           KV, G, q0, n, lo, s_all, window, ring, round_p, scale,
                           pl.sc_len, pl.nsplit, tiles_walked);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int CODE, bool BF16, bool MMA>
int by_hd(int hd, const void* q, int64_t q_sb, int64_t q_sh, const void* kc,
          const void* vc, const void* ks, const void* vs, const void* pos,
          void* out, int B, int S, int KV, int G, int q0, int n, int lo,
          int s_all, int window, int ring, int round_p, float scale, int device,
          cudaStream_t stream, int* plan_out, unsigned long long* tiles_walked) {
#define DA_ARGS q, q_sb, q_sh, kc, vc, ks, vs, pos, out, B, S, KV, G, q0, n, lo, \
                s_all, window, ring, round_p, scale, device, stream, plan_out,   \
                tiles_walked
  switch (hd) {
    case 32: return launch<CODE, BF16, MMA, 32>(DA_ARGS);
    case 64: return launch<CODE, BF16, MMA, 64>(DA_ARGS);
    case 128: return launch<CODE, BF16, MMA, 128>(DA_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef DA_ARGS
}

}  // namespace

