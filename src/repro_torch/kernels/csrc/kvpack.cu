// Packed KV-cache rows: per-row absmax quantization to int8 / int4 and its
// inverse, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels src/repro/kernels/kvpack.py::_quant_kernel
// and ::_dequant_kernel.  Same function, bit for bit, as the plain versions
// (repro_torch/kernels/ref.py::kv_quant_ref / kv_dequant_ref):
//
//   quant:   x f32 or bf16 [rows, d] -> codes int8 [rows, d] (8 bits) or
//            [rows, d/2] (4 bits) + scale f32 [rows].
//            qmax = 2^(bits-1) - 1; amax = max |x| over the row;
//            scale = amax > 0 ? amax / qmax : 1;
//            q = clamp(rint(x / scale), -qmax, qmax)   (half to even);
//            int4: byte j = (q[2j] & 0xF) | (q[2j+1] << 4), the even column
//            in the low nibble.
//   dequant: codes, scale -> f32 q * scale, int4 nibbles sign-extended with
//            ((v & 0xF) ^ 0x8) - 0x8.
//   quant_store: one decode step's write into the packed cache, the
//            reference's update_cache (src/repro/models/layers.py:339:
//            _quant_rows, then dynamic_update_slice, which XLA fuses under
//            jit): the K and V rows of k_new, v_new (B, 1, KV, D) quantized
//            as above, codes and scale written at [b, clamp(slot[b], 0,
//            S - 1), h] of the cache, in place.
//
// Both divisions are IEEE quotients: the library is built without
// --use_fast_math, so `/` on floats rounds correctly, as PyTorch's division
// of two device tensors does.
//
// Design.  One warp per row: each lane owns column pairs (2i, 2i+1) for
// i = lane, lane + 32, ..., so an int4 byte is written by the lane that
// holds both of its codes, and loads are 8 (f32) or 4 (bf16) contiguous
// bytes per lane.  The row maximum is a 5-step __shfl_xor_sync reduction.
// Rows are independent, so any row count works; the TPU's multiple-of-8
// row tile is not part of the function.  The row body is one __device__
// function (quant_row) that quant_kernel and quant_store_kernel share.
//
// Bound on this card: bytes.  A value costs a handful of ALU operations
// (abs, max, one division, rint, clamp, pack) against 2-4 bytes read and
// 0.5-1 byte written; the division is the costliest and still far below
// the ~20 operations per byte at which the ALUs would limit.
//
// quant_store at the serve shape (B = 8, KV = 8, D = 128, bf16, 8 bits)
// moves 2 B KV D 2 = 32,768 bytes in and 2 B KV D + 8 B KV = 16,896 out:
// 49,664 bytes, 0.0000148 ms at 3.35 TB/s.  Its 128 rows are 16 blocks of
// 8 warps, so in practice a launch costs what any launch costs: ~1.9 us of
// device time on an H100 (NVIDIA H100 80GB HBM3, 700 W), where a one-element
// fill_ takes ~1.0 us, whatever the body.  What the fused design saves is
// launches: one a layer and step where the unfused path took two quant
// launches, their two input copies and four index_put_ scatters (with the
// arange and clamp that fed them).  Each block reads slot[b] itself.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ float2 load_pair(const float* row, int i) {
  return reinterpret_cast<const float2*>(row)[i];
}

__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* row, int i) {
  return __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(row)[i]);
}

__device__ __forceinline__ int quantize(float x, float scale, float qmax) {
  return static_cast<int>(fminf(fmaxf(rintf(x / scale), -qmax), qmax));
}

// One row of quant: the warp's lanes load column pairs of `src`, reduce
// the row's absmax by shuffles, and write the row's codes to `dst` (d bytes
// at 8 bits, d / 2 at 4) and its scale to `*scale_out`.  Both kernels below
// call it, so kv_quant and the fused cache store give the same bits.
template <typename T>
__device__ __forceinline__ void quant_row(const T* __restrict__ src,
                                          int8_t* __restrict__ dst,
                                          float* __restrict__ scale_out, int d,
                                          int bits, int lane) {
  const int pairs = d / 2;
  float amax = 0.0f;
  for (int i = lane; i < pairs; i += 32) {
    const float2 v = load_pair(src, i);
    amax = fmaxf(amax, fmaxf(fabsf(v.x), fabsf(v.y)));
  }
#pragma unroll
  for (int k = 16; k > 0; k >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(kFull, amax, k));
  const float qmax = static_cast<float>((1 << (bits - 1)) - 1);
  const float scale = amax > 0.0f ? amax / qmax : 1.0f;
  if (bits == 8) {
    char2* out = reinterpret_cast<char2*>(dst);
    for (int i = lane; i < pairs; i += 32) {
      const float2 v = load_pair(src, i);
      out[i] = make_char2(static_cast<signed char>(quantize(v.x, scale, qmax)),
                          static_cast<signed char>(quantize(v.y, scale, qmax)));
    }
  } else {
    for (int i = lane; i < pairs; i += 32) {
      const float2 v = load_pair(src, i);
      const int lo = quantize(v.x, scale, qmax) & 0xF;
      const int hi = quantize(v.y, scale, qmax) & 0xF;
      dst[i] = static_cast<int8_t>(lo | (hi << 4));
    }
  }
  if (lane == 0) *scale_out = scale;
}

template <typename T>
__global__ void quant_kernel(const T* __restrict__ x,
                             int8_t* __restrict__ codes,
                             float* __restrict__ scales, int64_t rows, int d,
                             int bits) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warp leaves together
  const int cd = bits == 8 ? d : d / 2;
  quant_row(x + row * d, codes + row * cd, scales + row, d, bits,
            threadIdx.x & 31);
}

// The packed cache's write of one decode step: rows [0, B*KV) are the new K
// rows (b, h) of k_new (B, 1, KV, D), rows [B*KV, 2*B*KV) the V rows.  Each
// goes to [b, clamp(slot[b], 0, S - 1), h] of its cache (B, S, KV, cd) and
// scale (B, S, KV, 1) tensors; nothing else of the cache is touched.
template <typename T>
__global__ void quant_store_kernel(const T* __restrict__ k_new,
                                   const T* __restrict__ v_new,
                                   const int* __restrict__ slot,
                                   int8_t* __restrict__ cache_k,
                                   int8_t* __restrict__ cache_v,
                                   float* __restrict__ k_scale,
                                   float* __restrict__ v_scale, int batch,
                                   int s_cache, int kv_heads, int d, int bits) {
  const int per = batch * kv_heads;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= 2 * per) return;  // whole warp leaves together
  const bool is_v = row >= per;
  const int r = is_v ? row - per : row;  // b * KV + h
  const int b = r / kv_heads;
  const int s = min(max(slot[b], 0), s_cache - 1);
  const int64_t dst = (static_cast<int64_t>(b) * s_cache + s) * kv_heads +
                      (r - b * kv_heads);
  const int cd = bits == 8 ? d : d / 2;
  quant_row((is_v ? v_new : k_new) + static_cast<int64_t>(r) * d,
            (is_v ? cache_v : cache_k) + dst * cd,
            (is_v ? v_scale : k_scale) + dst, d, bits, threadIdx.x & 31);
}

__device__ __forceinline__ float sext4(int v) {
  return static_cast<float>(((v & 0xF) ^ 0x8) - 0x8);
}

__global__ void dequant_kernel(const int8_t* __restrict__ codes,
                               const float* __restrict__ scales,
                               float* __restrict__ out, int64_t rows, int d,
                               int bits) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float scale = scales[row];
  const int pairs = d / 2;
  float2* dst = reinterpret_cast<float2*>(out + row * d);
  if (bits == 8) {
    const char2* src = reinterpret_cast<const char2*>(codes + row * d);
    for (int i = lane; i < pairs; i += 32) {
      const char2 c = src[i];
      dst[i] = make_float2(static_cast<float>(c.x) * scale,
                           static_cast<float>(c.y) * scale);
    }
  } else {
    const int8_t* src = codes + row * pairs;
    for (int i = lane; i < pairs; i += 32) {
      const int c = src[i];
      dst[i] = make_float2(sext4(c) * scale, sext4(c >> 4) * scale);
    }
  }
}

unsigned blocks_for(int64_t rows) {
  return static_cast<unsigned>((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace

extern "C" {

// The launchers run on `stream`, allocate nothing, do not synchronise, and
// return cudaGetLastError() after the launch (0 when it was accepted).
// The caller checks shapes: rows > 0, d even and > 0, bits 8 or 4,
// contiguous row-major buffers; `x_is_bf16` selects bf16 input, else f32.

int kv_quant_launch(const void* x, int x_is_bf16, void* codes, void* scales,
                    int64_t rows, int d, int bits, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    quant_kernel<__nv_bfloat16><<<blocks_for(rows), kWarpsPerBlock * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(codes),
        static_cast<float*>(scales), rows, d, bits);
  } else {
    quant_kernel<float><<<blocks_for(rows), kWarpsPerBlock * 32, 0, s>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(codes),
        static_cast<float*>(scales), rows, d, bits);
  }
  return cudaGetLastError();
}

// k_new, v_new (batch, 1, kv_heads, d); slot int32 (batch,); cache_k,
// cache_v int8 (batch, s_cache, kv_heads, d or d / 2); k_scale, v_scale f32
// (batch, s_cache, kv_heads, 1); batch, s_cache, kv_heads > 0.
int kv_quant_store_launch(const void* k_new, const void* v_new, int x_is_bf16,
                          const void* slot, void* cache_k, void* cache_v,
                          void* k_scale, void* v_scale, int batch, int s_cache,
                          int kv_heads, int d, int bits, int device,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = blocks_for(2 * static_cast<int64_t>(batch) * kv_heads);
  const int* sl = static_cast<const int*>(slot);
  int8_t *ck = static_cast<int8_t*>(cache_k), *cv = static_cast<int8_t*>(cache_v);
  float *ks = static_cast<float*>(k_scale), *vs = static_cast<float*>(v_scale);
  if (x_is_bf16) {
    quant_store_kernel<__nv_bfloat16><<<blocks, kWarpsPerBlock * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(k_new),
        static_cast<const __nv_bfloat16*>(v_new), sl, ck, cv, ks, vs, batch,
        s_cache, kv_heads, d, bits);
  } else {
    quant_store_kernel<float><<<blocks, kWarpsPerBlock * 32, 0, s>>>(
        static_cast<const float*>(k_new), static_cast<const float*>(v_new), sl,
        ck, cv, ks, vs, batch, s_cache, kv_heads, d, bits);
  }
  return cudaGetLastError();
}

int kv_dequant_launch(const void* codes, const void* scales, void* out,
                      int64_t rows, int d, int bits, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  dequant_kernel<<<blocks_for(rows), kWarpsPerBlock * 32, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(codes), static_cast<const float*>(scales),
      static_cast<float*>(out), rows, d, bits);
  return cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
