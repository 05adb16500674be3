// Chunked jacobi-1d with the irredundant inter-chunk carry, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/jacobi_mars.py::_kernel
// (reached through jacobi_chunked).  Same function: T steps of the f32
// 3-point update v' = (a + b + c) / 3 over W-wide chunks taken in order,
// with the MARS carry -- the last two cells of each time level of chunk c,
// 2 x T floats -- handed to chunk c+1 on chip.  The carry is never re-read
// from device memory and never recomputed: the paper's irredundancy.
// Output is skewed: y[cW + k] = cell cW - T + k at time T.
//
// Design.  The TPU runs the chunks on a sequential grid with the carry in
// VMEM scratch.  Blocks of a CUDA grid run in no order and share no memory,
// so here ONE persistent block sweeps all chunks in order, the carry living
// in its shared memory.  Per chunk: load W cells into a (W + 2)-float buffer
// at offset 2; for each level s, the two leading cells come from carry[s-1],
// which is then overwritten with this chunk's last two cells of level s-1
// (read first, then write, as the TPU kernel does); the update ping-pongs
// between two buffers, one __syncthreads per level.  Thread `tid` owns cells
// k = tid, tid + blockDim, ...; the owners of cells W-2 and W-1 move the
// carry, so no extra barrier is needed for it.  Initial carry: x[0] at every
// level (the ghost region left of cell 0 is constant).
//
// Bound on this card: it moves 8 bytes per cell and does 3 T float operations
// per cell, so at T = 64 operations and bytes bound it about equally -- but
// one block uses one SM of 132 and waits on a barrier every level, so it runs
// far above both bounds.  Spreading the chunks over SMs with a chained
// wavefront is later work.  Built without --use_fast_math: the division by 3
// stays IEEE and the sum keeps its order, so the kernel matches the plain
// PyTorch version bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void jacobi_chunked_kernel(const float* __restrict__ x,
                                      float* __restrict__ y, int64_t n,
                                      int t_steps, int width) {
  extern __shared__ float smem[];
  float* buf[2] = {smem, smem + (width + 2)};
  float* carry = smem + 2 * (width + 2);  // [t_steps][2]
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int64_t chunks = n / width;

  const float x0 = x[0];
  for (int i = tid; i < 2 * t_steps; i += nt) carry[i] = x0;
  __syncthreads();

  for (int64_t c = 0; c < chunks; ++c) {
    const float* xc = x + c * width;
    // level 0: the chunk's own cells; owners of W-2, W-1 take carry level 0
    float* a = buf[0];
    for (int k = tid; k < width; k += nt) {
      const float v = xc[k];
      a[2 + k] = v;
      const int t = k - (width - 2);
      if (t >= 0 && t_steps > 0) {
        a[t] = carry[t];
        carry[t] = v;
      }
    }
    __syncthreads();
    for (int s = 1; s <= t_steps; ++s) {
      const float* src = buf[(s - 1) & 1];
      float* dst = buf[s & 1];
      for (int k = tid; k < width; k += nt) {
        const float v = (src[k] + src[k + 1] + src[k + 2]) / 3.0f;
        dst[2 + k] = v;
        const int t = k - (width - 2);
        if (t >= 0 && s < t_steps) {  // carry level s for the next step
          dst[t] = carry[2 * s + t];
          carry[2 * s + t] = v;
        }
      }
      __syncthreads();
    }
    const float* res = buf[t_steps & 1];
    float* yc = y + c * width;
    for (int k = tid; k < width; k += nt) yc[k] = res[2 + k];
    __syncthreads();  // the next chunk overwrites the buffers
  }
}

}  // namespace

extern "C" {

// Runs on `stream`, allocates nothing, does not synchronise, and returns
// cudaGetLastError() after the launch (0 when it was accepted).  The caller
// checks n % width == 0, 0 <= t_steps < width - 2 and n > 0.
int jacobi_chunked_launch(const void* x, void* y, int64_t n, int t_steps,
                          int width, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const size_t smem = sizeof(float) * (2 * (width + 2) + 2 * t_steps);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(jacobi_chunked_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int threads = width < 1024 ? ((width + 31) / 32) * 32 : 1024;
  jacobi_chunked_kernel<<<1, threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), n, t_steps,
      width);
  return cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
