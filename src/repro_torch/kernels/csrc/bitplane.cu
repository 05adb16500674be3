// Delta + bitplane pack / unpack for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels src/repro/kernels/bitplane.py::_pack_kernel
// and ::_unpack_kernel.  Same function, bit for bit:
//
//   pack:   int32 codes [N, block] -> uint32 planes [N, block/32 * bits].
//           d[k] = q[k] - q[k-1] along the WHOLE row (d[0] = q[0]), wrapped
//           modulo 2^32, masked to `bits`; each 32-word group g becomes `bits`
//           plane words, plane j holding bit j of word i at bit i; output
//           order [row, group, plane].
//   unpack: the inverse: planes -> words (lane i takes bit i of each plane),
//           sign-extend from `bits` with (v ^ h) - h (not for bits == 32), then
//           an inclusive prefix sum over the whole row, modulo 2^32.
//
// Design.  One warp per row, walking the row's groups in order: lane i holds
// word i of the group.  On the TPU the plane transpose is a shift/or network
// over vregs; here it is one __ballot_sync per plane (the ballot of bit j of
// the 32 lanes IS plane j, word i -> bit i).  Unpack broadcasts each plane
// with __shfl_sync and rebuilds the row with a 5-step warp scan plus a carry
// from group to group.  All arithmetic is uint32, so the wrap is defined.
//
// Bound on this card: bytes.  A word costs 4 bytes of traffic in and
// bits/8 bytes out, and a few dozen 32-bit ALU operations, far below the
// ~20 operations per byte at which the ALUs would limit.  The loads of a
// warp are one 128-byte line per group (coalesced); each group's planes are
// `bits` consecutive words written by lanes 0..bits-1.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kGroup = 32;
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t low_mask(int bits) {
  return bits >= 32 ? 0xFFFFFFFFu : ((1u << bits) - 1u);
}

__global__ void pack_kernel(const int32_t* __restrict__ q,
                            uint32_t* __restrict__ out, int64_t n_rows,
                            int block, int bits) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // whole warp leaves together
  const int groups = block / kGroup;
  const int32_t* src = q + row * block;
  uint32_t* dst = out + row * static_cast<int64_t>(groups) * bits;
  const uint32_t mask = low_mask(bits);
  uint32_t prev_last = 0;  // word 32g-1 of the row: the delta crosses groups
  for (int g = 0; g < groups; ++g) {
    const uint32_t v = static_cast<uint32_t>(src[g * kGroup + lane]);
    uint32_t prev = __shfl_up_sync(kFull, v, 1);
    if (lane == 0) prev = prev_last;
    prev_last = __shfl_sync(kFull, v, 31);
    const uint32_t d = (v - prev) & mask;
    uint32_t mine = 0;
    for (int j = 0; j < bits; ++j) {
      const uint32_t plane = __ballot_sync(kFull, (d >> j) & 1u);
      if (lane == j) mine = plane;
    }
    if (lane < bits) dst[g * bits + lane] = mine;
  }
}

__global__ void unpack_kernel(const uint32_t* __restrict__ planes,
                              int32_t* __restrict__ out, int64_t n_rows,
                              int block, int bits) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const int groups = block / kGroup;
  const uint32_t* src = planes + row * static_cast<int64_t>(groups) * bits;
  int32_t* dst = out + row * block;
  const uint32_t h = bits < 32 ? (1u << (bits - 1)) : 0u;
  uint32_t carry = 0;  // running sum of the row up to the previous group
  for (int g = 0; g < groups; ++g) {
    const uint32_t my_plane = lane < bits ? src[g * bits + lane] : 0u;
    uint32_t v = 0;
    for (int j = 0; j < bits; ++j) {
      const uint32_t plane = __shfl_sync(kFull, my_plane, j);
      v |= ((plane >> lane) & 1u) << j;
    }
    if (bits < 32) v = (v ^ h) - h;  // sign-extend from `bits`
#pragma unroll
    for (int k = 1; k < 32; k <<= 1) {  // inclusive warp scan, mod 2^32
      const uint32_t up = __shfl_up_sync(kFull, v, k);
      if (lane >= k) v += up;
    }
    v += carry;
    dst[g * kGroup + lane] = static_cast<int32_t>(v);
    carry = __shfl_sync(kFull, v, 31);
  }
}

int blocks_for(int64_t n_rows) {
  return static_cast<int>((n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace

extern "C" {

// Both launchers run on `stream`, allocate nothing, do not synchronise, and
// return cudaGetLastError() after the launch (0 when it was accepted).
// The caller checks shapes: block % 32 == 0, 1 <= bits <= 32, n_rows > 0.

int bitplane_pack_launch(const void* q, void* out, int64_t n_rows, int block,
                         int bits, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  pack_kernel<<<blocks_for(n_rows), kWarpsPerBlock * 32, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(q), static_cast<uint32_t*>(out), n_rows,
      block, bits);
  return cudaGetLastError();
}

int bitplane_unpack_launch(const void* planes, void* out, int64_t n_rows,
                           int block, int bits, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  unpack_kernel<<<blocks_for(n_rows), kWarpsPerBlock * 32, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(planes), static_cast<int32_t*>(out),
      n_rows, block, bits);
  return cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
