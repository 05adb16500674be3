// GQA flash attention, forward and backward, on f32 for Hopper (sm_90a).
//
// Three kernels on the CUDA cores, each with its own note below: the
// forward (flash_fwd_kernel), and the flash-2 backward split as in the
// reference, dK/dV (flash_bwd_dkv_kernel) then dQ (flash_bwd_dq_kernel).
// They serve the f32 route; bf16 inputs, the main paths' dtype, run all
// three on the tensor cores in flash_attention_sm90.cu.
//
// The forward replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::_fwd_kernel (through _flash_fwd).
// Same function:
//
//   q (B, S, KV, G, D), k / v (B, Sk, KV, D), f32, contiguous.
//   s = (q . k) * scale in f32, scale = D^-0.5;
//   key t of query s is masked to the finite NEG_INF = -1e30 when
//   (causal and s < t) or (window > 0 and s - t >= window);
//   online softmax over key tiles with running (m, l, acc) in f32;
//   o = acc / max(l, 1e-30) in q's dtype, lse = m + log(max(l, 1e-30)) f32
//   (B, KV, G, S).
//
// A finite NEG_INF keeps the reference's arithmetic: a row whose keys so far
// are all masked carries m = -1e30 and p = exp(0) = 1, and the first real
// key wipes that state with alpha = exp(-1e30 - m) = 0.  Keys past Sk (the
// ragged last tile) do not exist in the reference; they are -inf here, so
// they add exactly nothing.  Key tiles wholly after the causal diagonal, or
// wholly before the sliding window of every row of the query tile, are
// skipped: each such tile leaves the state unchanged, or is wiped by the
// first real key, exactly as above.  (When some row has no real key at all,
// no tile is skipped before the band.)
//
// Design.  One block of 256 threads per (b, kv, g, 64-row query tile); the
// query tile sits in shared memory, key and value tiles of 64 rows are
// staged there in turn (D zero-padded to 64 or 128).
// A 16 x 16 thread grid: thread (ty, tx) owns query rows 4ty..4ty+3, holds
// their scores for keys tx + 16j (j < 4), their (m, l), and their output
// columns in float4 groups tx + 16jj.  Row max and row sum are 16-lane
// __shfl_xor_sync reductions.  P goes to shared memory, over the key tile
// it replaces, and acc += P V reads it back as float4.  Rows of the shared
// tiles are padded by 4 floats, so the float4 reads are free of bank
// conflicts.  Query tiles are issued heaviest (most keys) first.
//
// Bound on this card: operations.  4 B H S Sk D flops for full attention
// (half for causal) against q, k, v, o read or written once; at prefill
// shapes that is ~1000 flops per byte, above the tensor cores' ~295.  This
// kernel runs its products on the fp32 CUDA cores (67 TFLOP/s), so it now
// serves the f32 route only: bf16 inputs, the main paths' dtype, run in
// flash_attention_sm90.cu on the tensor cores (wgmma, TMA).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;           // query rows per block
constexpr int kBK = 64;           // keys per tile
constexpr int kThreads = 256;     // 16 x 16
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <int DP>
constexpr int smem_bytes() {
  return (2 * kBK * (DP + 4) + kBK * DP) * 4;  // Q and K/P padded, V dense
}

// Stage rows [r0, r0 + 64) of a (rows, D) slice with row stride `stride`
// into shared memory as f32, row stride `ld`, zero past `rows` and past D.
template <int DP>
__device__ __forceinline__ void stage(float* dst, int ld, const float* src,
                                      int64_t stride, int r0, int rows,
                                      int D) {
  for (int idx = threadIdx.x; idx < 64 * DP; idx += kThreads) {
    const int r = idx / DP, c = idx % DP;
    float val = 0.0f;
    if (r0 + r < rows && c < D) val = src[(r0 + r) * stride + c];
    dst[r * ld + c] = val;
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int S, int Sk, int KV, int G, int D,
                 int causal, int window, float scale) {
  constexpr int QS = DP + 4;       // row stride of the Q and K tiles
  constexpr int PS = kBK + 4;      // row stride of P (fits in the K tile)
  constexpr int NG = DP / 64;      // float4 output groups per thread
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + kBQ * QS;
  float* sV = sK + kBK * QS;
  float* sP = sK;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bkg = blockIdx.x;               // (b * KV + kv) * G + g
  const int g = bkg % G, kvh = (bkg / G) % KV, b = bkg / (G * KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int64_t q_stride = static_cast<int64_t>(KV) * G * D;
  const int64_t k_stride = static_cast<int64_t>(KV) * D;
  const int64_t head = static_cast<int64_t>(b) * S * q_stride + (kvh * G + g) * D;
  const float* qb = q + head;
  float* ob = o + head;
  const int64_t kv_off = static_cast<int64_t>(b) * Sk * k_stride + kvh * D;

  stage<DP>(sQ, QS, qb, q_stride, q0, S, D);

  const int q1 = min(q0 + kBQ, S) - 1;     // last real row of the tile
  const int n_kt = (Sk + kBK - 1) / kBK;
  const int kt_end = causal ? min(n_kt, q1 / kBK + 1) : n_kt;
  int kt_begin = 0;
  if (window > 0 && q1 - window + 1 <= Sk - 1)
    kt_begin = max(0, q0 - window + 1) / kBK;

  float m[4], l[4], acc[4][NG][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int jj = 0; jj < NG; ++jj)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[i][jj][u] = 0.0f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's P and V are no longer read
    stage<DP>(sK, QS, k + kv_off, k_stride, k0, Sk, D);
    stage<DP>(sV, DP, v + kv_off, k_stride, k0, Sk, D);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d4 = 0; d4 < DP / 4; ++d4) {
      float4 qf[4], kf[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qf[i] = *reinterpret_cast<const float4*>(&sQ[(ty * 4 + i) * QS + d4 * 4]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kf[j] = *reinterpret_cast<const float4*>(&sK[(tx + 16 * j) * QS + d4 * 4]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qf[i].x, kf[j].x, s[i][j]);
          s[i][j] = fmaf(qf[i].y, kf[j].y, s[i][j]);
          s[i][j] = fmaf(qf[i].z, kf[j].z, s[i][j]);
          s[i][j] = fmaf(qf[i].w, kf[j].w, s[i][j]);
        }
    }
    __syncthreads();  // every thread is done with sK: P may overwrite it

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (kpos >= Sk)
          x = -INFINITY;  // no such key
        else if ((causal && qpos < kpos) ||
                 (window > 0 && qpos - kpos >= window))
          x = kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], max16(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sP[(ty * 4 + i) * PS + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = l[i] * alpha + sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < NG; ++jj)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[i][jj][u] *= alpha;
    }
    __syncthreads();

#pragma unroll 2
    for (int k4 = 0; k4 < kBK / 4; ++k4) {
      float4 pf[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pf[i] = *reinterpret_cast<const float4*>(&sP[(ty * 4 + i) * PS + k4 * 4]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int jj = 0; jj < NG; ++jj) {
          const float4 vf = *reinterpret_cast<const float4*>(
              &sV[(k4 * 4 + kk) * DP + (tx + 16 * jj) * 4]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = comp(pf[i], kk);
            acc[i][jj][0] = fmaf(p, vf.x, acc[i][jj][0]);
            acc[i][jj][1] = fmaf(p, vf.y, acc[i][jj][1]);
            acc[i][jj][2] = fmaf(p, vf.z, acc[i][jj][2]);
            acc[i][jj][3] = fmaf(p, vf.w, acc[i][jj][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= S) continue;
    const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < NG; ++jj)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = (tx + 16 * jj) * 4 + u;
        if (c < D) ob[qpos * q_stride + c] = acc[i][jj][u] / lc;
      }
    if (tx == 0) lse[static_cast<int64_t>(bkg) * S + qpos] = m[i] + logf(lc);
  }
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int S, int Sk, int KV, int G, int D,
                   int causal, int window, float scale, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<DP>;
  constexpr int bytes = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * KV * G, (S + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), S, Sk, KV, G, D, causal, window, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward.  Both kernels recompute p from the forward's lse, as the
// reference's flash-2 backward does:
//
//   s  = (q . k) * scale,  p = mask ? exp(s - lse) : 0,
//   dp = do . v,           ds = p * (dp - delta) * scale,
//   dv = sum p^T do,  dk = sum ds^T q,  dq = sum ds k,
//
// with delta = sum(o * do) over D (B, KV, G, S) computed by the caller, all
// products in f32.  The mask is the forward's (causal,
// sliding window); a query or key past S or Sk (a ragged last tile) is
// masked too.  A masked p is exactly 0, so a query row with no allowed key
// gets a zero gradient (the reference's where(mask, ..., 0)), and a tile
// in which every pair is masked adds exactly nothing: both kernels skip the
// tiles outside the causal / window band.
//
// Bound on this card: operations.  Per (b, kv, g): 8 S Sk D flops for
// dK/dV (four products) and 6 S Sk D for dQ (three), half of each for
// causal, against q, k, v, do, lse, delta read and the gradients written
// once; at training shapes that is ~1000 flops per byte, above the tensor
// cores' ~295.  Like the forward, these kernels run their products on the
// fp32 CUDA cores (67 TFLOP/s); bf16 runs both on the tensor cores
// (flash_attention_sm90.cu).
// ---------------------------------------------------------------------------

template <int DP>
constexpr int dkv_smem_bytes() {  // K, V, Q, dO padded; P and dS
  return (4 * kBK * (DP + 4) + 2 * kBQ * (kBK + 4)) * 4;
}

template <int DP>
constexpr int dq_smem_bytes() {   // Q, dO, K, V padded; dS over V
  return 4 * kBK * (DP + 4) * 4;
}

// s[i][j] = sum_d A[row 4ty+i][d] * B[row tx+16j][d] over the padded D of
// two shared tiles of row stride QS (the S = Q K^T and dP = dO V^T tiles).
template <int DP>
__device__ __forceinline__ void tile_dot(float (&s)[4][4], const float* A,
                                         const float* Bm, int tx, int ty) {
  constexpr int QS = DP + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
  for (int d4 = 0; d4 < DP / 4; ++d4) {
    float4 af[4], bf[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      af[i] = *reinterpret_cast<const float4*>(&A[(ty * 4 + i) * QS + d4 * 4]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bf[j] = *reinterpret_cast<const float4*>(&Bm[(tx + 16 * j) * QS + d4 * 4]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(af[i].x, bf[j].x, s[i][j]);
        s[i][j] = fmaf(af[i].y, bf[j].y, s[i][j]);
        s[i][j] = fmaf(af[i].z, bf[j].z, s[i][j]);
        s[i][j] = fmaf(af[i].w, bf[j].w, s[i][j]);
      }
  }
}

__device__ __forceinline__ bool allowed(int qpos, int kpos, int S, int Sk,
                                        int causal, int window) {
  return qpos < S && kpos < Sk && !(causal && qpos < kpos) &&
         !(window > 0 && qpos - kpos >= window);
}

// dK / dV.  Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::_bwd_dkv_kernel (through _flash_bwd).
// The TPU grid (B, KV, nk, G, nq) sweeps (g, qi) in order and carries dk, dv
// in VMEM scratch; here one block of 256 threads per (b, kv, 64-key tile)
// loops over the G groups and the query tiles of the band itself, dk and dv
// in registers: no atomics, and the sum runs in one fixed order, so the
// result is deterministic.  K and V stay in shared memory for the whole
// block; each step stages one (g, query tile) of Q and dO (f32, rows padded
// by 4 floats, D zero-padded to 64 or 128).  A 16 x 16 thread grid: for the
// score tiles thread (ty, tx) owns query rows 4ty..4ty+3 and keys tx + 16j,
// writes P and dS to shared memory, then for the sums owns keys 4ty..4ty+3
// and the float4 column groups tx + 16jj of dk and dv.  Key tiles are issued
// heaviest first (under causal the first key tile meets every query tile).
template <int DP>
__global__ void __launch_bounds__(kThreads, DP == 64 ? 2 : 1)
flash_bwd_dkv_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int S, int Sk, int KV, int G,
                     int D, int causal, int window, float scale) {
  constexpr int QS = DP + 4;
  constexpr int PS = kBK + 4;
  constexpr int NG = DP / 64;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + kBK * QS;
  float* sQ = sV + kBK * QS;
  float* sdO = sQ + kBQ * QS;
  float* sP = sdO + kBQ * QS;
  float* sdS = sP + kBQ * PS;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bkv = blockIdx.x;               // b * KV + kv
  const int kvh = bkv % KV, b = bkv / KV;
  const int k0 = blockIdx.y * kBK;
  const int64_t q_stride = static_cast<int64_t>(KV) * G * D;
  const int64_t k_stride = static_cast<int64_t>(KV) * D;
  const int64_t kv_off = static_cast<int64_t>(b) * Sk * k_stride + kvh * D;

  stage<DP>(sK, QS, k + kv_off, k_stride, k0, Sk, D);
  stage<DP>(sV, QS, v + kv_off, k_stride, k0, Sk, D);

  // query tiles that meet this key tile (kBQ == kBK, so under causal the
  // first is the key tile's own index)
  const int n_qt = (S + kBQ - 1) / kBQ;
  const int k_last = min(k0 + kBK, Sk) - 1;
  const int qt_begin = causal ? min(n_qt, static_cast<int>(blockIdx.y)) : 0;
  int qt_end = n_qt;
  if (window > 0) {  // the last query that may see key k_last is k_last + window - 1
    const long long last = (static_cast<long long>(k_last) + window - 1) / kBQ + 1;
    if (last < n_qt) qt_end = static_cast<int>(last);
  }

  float adk[4][NG][4], adv[4][NG][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < NG; ++jj)
#pragma unroll
      for (int u = 0; u < 4; ++u) adk[i][jj][u] = adv[i][jj][u] = 0.0f;

  for (int g = 0; g < G; ++g) {
    const int64_t head = static_cast<int64_t>(b) * S * q_stride + (kvh * G + g) * D;
    const float* lse_r = lse + (static_cast<int64_t>(bkv) * G + g) * S;
    const float* delta_r = delta + (static_cast<int64_t>(bkv) * G + g) * S;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();  // the previous step's reads of Q, dO, P, dS are done
      stage<DP>(sQ, QS, q + head, q_stride, q0, S, D);
      stage<DP>(sdO, QS, dout + head, q_stride, q0, S, D);
      __syncthreads();

      float s[4][4], dp[4][4];
      tile_dot<DP>(s, sQ, sK, tx, ty);
      tile_dot<DP>(dp, sdO, sV, tx, ty);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qpos = q0 + ty * 4 + i;
        const float l = qpos < S ? lse_r[qpos] : 0.0f;
        const float dl = qpos < S ? delta_r[qpos] : 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kpos = k0 + tx + 16 * j;
          const float p = allowed(qpos, kpos, S, Sk, causal, window)
                              ? expf(s[i][j] * scale - l)
                              : 0.0f;
          sP[(ty * 4 + i) * PS + tx + 16 * j] = p;
          sdS[(ty * 4 + i) * PS + tx + 16 * j] = p * (dp[i][j] - dl) * scale;
        }
      }
      __syncthreads();

      // dv[key][c] += sum_r P[r][key] dO[r][c];  dk[key][c] += dS[r][key] Q[r][c]
#pragma unroll 2
      for (int r = 0; r < kBQ; ++r) {
        const float4 pf = *reinterpret_cast<const float4*>(&sP[r * PS + ty * 4]);
        const float4 sf = *reinterpret_cast<const float4*>(&sdS[r * PS + ty * 4]);
#pragma unroll
        for (int jj = 0; jj < NG; ++jj) {
          const float4 of = *reinterpret_cast<const float4*>(
              &sdO[r * QS + (tx + 16 * jj) * 4]);
          const float4 qf = *reinterpret_cast<const float4*>(
              &sQ[r * QS + (tx + 16 * jj) * 4]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pi = comp(pf, i), si = comp(sf, i);
            adv[i][jj][0] = fmaf(pi, of.x, adv[i][jj][0]);
            adv[i][jj][1] = fmaf(pi, of.y, adv[i][jj][1]);
            adv[i][jj][2] = fmaf(pi, of.z, adv[i][jj][2]);
            adv[i][jj][3] = fmaf(pi, of.w, adv[i][jj][3]);
            adk[i][jj][0] = fmaf(si, qf.x, adk[i][jj][0]);
            adk[i][jj][1] = fmaf(si, qf.y, adk[i][jj][1]);
            adk[i][jj][2] = fmaf(si, qf.z, adk[i][jj][2]);
            adk[i][jj][3] = fmaf(si, qf.w, adk[i][jj][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + ty * 4 + i;
    if (kpos >= Sk) continue;
#pragma unroll
    for (int jj = 0; jj < NG; ++jj)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = (tx + 16 * jj) * 4 + u;
        if (c < D) {
          dk[kv_off + kpos * k_stride + c] = adk[i][jj][u];
          dv[kv_off + kpos * k_stride + c] = adv[i][jj][u];
        }
      }
  }
}

// dQ.  Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::_bwd_dq_kernel (through _flash_bwd).
// The TPU grid (B, KV, G, nq, nk) sweeps the key blocks in order and
// carries dq in VMEM scratch; here one block of 256 threads per
// (b, kv, g, 64-query tile), as the forward, loops over the key tiles of the
// band, dq in registers.  Q and dO stay in shared memory; each step stages
// one tile of K and V, computes the score and dP tiles as the dK/dV kernel
// does, writes dS over the V tile, and adds dS K into rows 4ty..4ty+3,
// column groups tx + 16jj.  Query tiles are issued heaviest first.
template <int DP>
__global__ void __launch_bounds__(kThreads, DP == 64 ? 2 : 1)
flash_bwd_dq_kernel(const float* __restrict__ q,
                    const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int S, int Sk, int KV, int G, int D, int causal,
                    int window, float scale) {
  constexpr int QS = DP + 4;
  constexpr int PS = kBK + 4;      // row stride of dS (fits in the V tile)
  constexpr int NG = DP / 64;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sdO = sQ + kBQ * QS;
  float* sK = sdO + kBQ * QS;
  float* sV = sK + kBK * QS;
  float* sdS = sV;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bkg = blockIdx.x;               // (b * KV + kv) * G + g
  const int g = bkg % G, kvh = (bkg / G) % KV, b = bkg / (G * KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int64_t q_stride = static_cast<int64_t>(KV) * G * D;
  const int64_t k_stride = static_cast<int64_t>(KV) * D;
  const int64_t head = static_cast<int64_t>(b) * S * q_stride + (kvh * G + g) * D;
  const int64_t kv_off = static_cast<int64_t>(b) * Sk * k_stride + kvh * D;

  stage<DP>(sQ, QS, q + head, q_stride, q0, S, D);
  stage<DP>(sdO, QS, dout + head, q_stride, q0, S, D);

  float l[4], dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    l[i] = qpos < S ? lse[static_cast<int64_t>(bkg) * S + qpos] : 0.0f;
    dl[i] = qpos < S ? delta[static_cast<int64_t>(bkg) * S + qpos] : 0.0f;
  }

  const int q1 = min(q0 + kBQ, S) - 1;     // last real row of the tile
  const int n_kt = (Sk + kBK - 1) / kBK;
  const int kt_end = causal ? min(n_kt, q1 / kBK + 1) : n_kt;
  const int kt_begin = window > 0 ? max(0, q0 - window + 1) / kBK : 0;

  float acc[4][NG][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < NG; ++jj)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[i][jj][u] = 0.0f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's K and dS are no longer read
    stage<DP>(sK, QS, k + kv_off, k_stride, k0, Sk, D);
    stage<DP>(sV, QS, v + kv_off, k_stride, k0, Sk, D);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dot<DP>(s, sQ, sK, tx, ty);
    tile_dot<DP>(dp, sdO, sV, tx, ty);
    __syncthreads();  // every thread is done with V: dS may overwrite it
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const float p = allowed(qpos, kpos, S, Sk, causal, window)
                            ? expf(s[i][j] * scale - l[i])
                            : 0.0f;
        sdS[(ty * 4 + i) * PS + tx + 16 * j] = p * (dp[i][j] - dl[i]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int k4 = 0; k4 < kBK / 4; ++k4) {
      float4 sf[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        sf[i] = *reinterpret_cast<const float4*>(&sdS[(ty * 4 + i) * PS + k4 * 4]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int jj = 0; jj < NG; ++jj) {
          const float4 kf = *reinterpret_cast<const float4*>(
              &sK[(k4 * 4 + kk) * QS + (tx + 16 * jj) * 4]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float d = comp(sf[i], kk);
            acc[i][jj][0] = fmaf(d, kf.x, acc[i][jj][0]);
            acc[i][jj][1] = fmaf(d, kf.y, acc[i][jj][1]);
            acc[i][jj][2] = fmaf(d, kf.z, acc[i][jj][2]);
            acc[i][jj][3] = fmaf(d, kf.w, acc[i][jj][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= S) continue;
#pragma unroll
    for (int jj = 0; jj < NG; ++jj)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = (tx + 16 * jj) * 4 + u;
        if (c < D) dq[head + qpos * q_stride + c] = acc[i][jj][u];
      }
  }
}

template <int DP>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int S, int Sk, int KV, int G,
                       int D, int causal, int window, float scale,
                       cudaStream_t stream) {
  auto kernel = flash_bwd_dkv_kernel<DP>;
  constexpr int bytes = dkv_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * KV, (Sk + kBK - 1) / kBK);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), S, Sk, KV, G, D, causal,
      window, scale);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int B, int S, int Sk, int KV, int G, int D,
                      int causal, int window, float scale,
                      cudaStream_t stream) {
  auto kernel = flash_bwd_dq_kernel<DP>;
  constexpr int bytes = dq_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * KV * G, (S + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), S, Sk, KV, G, D, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Runs on `stream`, allocates nothing, does not synchronise, and returns
// cudaGetLastError() after the launch (0 when it was accepted).  Every
// launcher takes f32 only (bf16 runs in flash_attention_sm90.cu).  The
// caller checks shapes: contiguous q (B, S, KV, G, D), k and v
// (B, Sk, KV, D), 1 <= D <= 128, S, Sk >= 1, B * KV * G < 2^31,
// ceil(S / 64) <= 65535; o like q, lse f32 (B, KV, G, S).

int flash_fwd_launch(const void* q, const void* k, const void* v, void* o,
                     void* lse, int B, int S, int Sk, int KV, int G, int D,
                     int causal, int window, float scale, int device,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D <= 64 ? launch<64>(q, k, v, o, lse, B, S, Sk, KV, G, D, causal,
                              window, scale, s)
                 : launch<128>(q, k, v, o, lse, B, S, Sk, KV, G, D, causal,
                               window, scale, s);
}

// The backward launchers take the forward's shapes and rules, plus dout
// like q, lse and delta f32 (B, KV, G, S); dk and dv like k (B * KV and
// ceil(Sk / 64) <= 65535), dq like q.

int flash_bwd_dkv_launch(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dk, void* dv, int B, int S, int Sk, int KV,
                         int G, int D, int causal, int window, float scale,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D <= 64 ? launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, B, S, Sk,
                                  KV, G, D, causal, window, scale, s)
                 : launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, B, S,
                                   Sk, KV, G, D, causal, window, scale, s);
}

int flash_bwd_dq_launch(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dq, int B, int S, int Sk, int KV, int G, int D,
                        int causal, int window, float scale, int device,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D <= 64 ? launch_dq<64>(q, k, v, dout, lse, delta, dq, B, S, Sk, KV,
                                 G, D, causal, window, scale, s)
                 : launch_dq<128>(q, k, v, dout, lse, delta, dq, B, S, Sk, KV,
                                  G, D, causal, window, scale, s);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
