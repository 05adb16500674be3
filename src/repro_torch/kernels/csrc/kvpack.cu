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
// row tile is not part of the function.
//
// Bound on this card: bytes.  A value costs a handful of ALU operations
// (abs, max, one division, rint, clamp, pack) against 2-4 bytes read and
// 0.5-1 byte written; the division is the costliest and still far below
// the ~20 operations per byte at which the ALUs would limit.

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

template <typename T>
__global__ void quant_kernel(const T* __restrict__ x,
                             int8_t* __restrict__ codes,
                             float* __restrict__ scales, int64_t rows, int d,
                             int bits) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warp leaves together
  const T* src = x + row * d;
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
    char2* dst = reinterpret_cast<char2*>(codes + row * d);
    for (int i = lane; i < pairs; i += 32) {
      const float2 v = load_pair(src, i);
      dst[i] = make_char2(static_cast<signed char>(quantize(v.x, scale, qmax)),
                          static_cast<signed char>(quantize(v.y, scale, qmax)));
    }
  } else {
    int8_t* dst = codes + row * pairs;
    for (int i = lane; i < pairs; i += 32) {
      const float2 v = load_pair(src, i);
      const int lo = quantize(v.x, scale, qmax) & 0xF;
      const int hi = quantize(v.y, scale, qmax) & 0xF;
      dst[i] = static_cast<int8_t>(lo | (hi << 4));
    }
  }
  if (lane == 0) scales[row] = scale;
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

// Both launchers run on `stream`, allocate nothing, do not synchronise, and
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
