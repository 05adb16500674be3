// Chunked jacobi-1d with the irredundant inter-chunk carry, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/jacobi_mars.py::_kernel
// (reached through jacobi_chunked).  Same function: T steps of the f32
// 3-point update v' = (a + b + c) / 3 over chunks taken left to right, with
// the MARS carry -- the last two cells of each time level of a chunk,
// 2 x T floats -- handed to the chunk on its right.  Output is skewed:
// y[j] = cell j - T at time T, where the cells left of cell 0 are the
// ghost x[0] evolved by the same update (the plain version's 2T copies of
// x[0]; the reference freezes that ghost at x[0], which differs from it by
// rounding only within 2T cells of the left edge).  That buffer does not
// depend on the chunk width W (level s of a chunk reads only its own level
// s - 1 and the carry of level s - 1 from its left), so the kernel tiles by
// its own width and only W's checks remain in the wrapper.
//
// Design: a wavefront over every SM.  Level s of a tile needs level s - 1 of
// itself and of its left neighbour only, so the dependency depth is T, not
// the number of tiles: every resident tile advances one level at a time,
// each a little behind its left neighbour.
//
// * A block holds kTile = 4096 cells in registers: 4 warps, 32 consecutive
//   cells a lane.  A level takes the two cells left of a lane from lane - 1
//   by __shfl_up_sync; lane 0 takes them from the carry.  No __syncthreads
//   in the level loop.
// * Carry between the warps of a block: a ring of kRing levels in shared
//   memory, with a published-level counter per producer warp and a
//   consumed-level counter per consumer warp (the producer waits only when
//   it is kRing levels ahead).
// * Carry between blocks: lane 31 of the last warp writes each level's two
//   cells to its tile's slot in a global workspace ([tiles][T] float2), then
//   publishes the level count with st.release.gpu; lane 0 of the right
//   tile's first warp reads the count with ld.acquire.gpu, then the carry
//   (through L2).  Only those 2 x T floats cross a tile boundary; every cell
//   is read from and written to device memory once and computed once.
// * Deadlock: a block takes its tile from a global atomic ticket, not from
//   blockIdx, so the tile it waits on belongs to a block that started
//   earlier and is resident or finished.  The ticket and the level counts
//   are zeroed by the wrapper before each launch.
// * The last tile may be ragged: cells past n are 0 and never stored; the
//   update only reads to the left, so they reach no real cell.
//
// Bound on this card: 8 bytes per cell moved and 3 T float operations per
// cell, which at T = 64 bound it about equally (~0.19 ms for 2^26 cells).
// The instructions issued per cell and level set the floor, the division
// most of all: div.rn.f32 by 3 compiles to a reciprocal refinement with a
// slow-path check.  div3 below gives the same bits in three instructions
// (jacobi_div3_check compares the two over all 2^32 inputs).  The sum keeps
// its order and the build has no --use_fast_math, so the kernel matches the
// plain PyTorch version bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCells = 32;                        // cells a lane holds
constexpr int kWarps = 4;                         // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = kThreads * kCells;          // cells a block holds
constexpr int kRing = 32;                         // carry levels between warps
constexpr unsigned kFull = 0xFFFFFFFFu;

// x / 3 rounded to nearest even, as div.rn.f32 gives it: q0 = x RN(1/3),
// then one FMA step on the exact remainder x - 3 q0 (Markstein's
// correction).  The step would turn -0 into +0 and inf into NaN; those
// inputs, and only those (q0 == x exactly at zeros and infinities), keep q0.
__device__ __forceinline__ float div3(float x) {
  constexpr float r = 1.0f / 3.0f;
  const float q0 = __fmul_rn(x, r);
  const float q = __fmaf_rn(__fmaf_rn(-q0, 3.0f, x), r, q0);
  return q0 == x ? q0 : q;
}

__device__ __forceinline__ float update(float a, float b, float c) {
  return div3(a + b + c);
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// flags: [1 + tiles] ints, zero at launch: the ticket, then each tile's
// count of published carry levels.  carry: [tiles][t_steps] float2.
__global__ void __launch_bounds__(kThreads)
jacobi_wavefront_kernel(const float* __restrict__ x, float* __restrict__ y,
                        int64_t n, int t_steps, int* __restrict__ flags,
                        float2* __restrict__ carry) {
  __shared__ int s_tile;
  __shared__ float2 ring[kWarps - 1][kRing];
  __shared__ volatile int produced[kWarps], consumed[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) s_tile = atomicAdd(flags, 1);
  if (threadIdx.x < kWarps) {
    produced[threadIdx.x] = 0;
    consumed[threadIdx.x] = 0;
  }
  __syncthreads();
  const int64_t tile = s_tile;
  int* published = flags + 1;

  // level 0: this lane's cells [base, base + kCells)
  const int64_t base = tile * kTile + static_cast<int64_t>(threadIdx.x) * kCells;
  float c[kCells];
  const bool whole = base + kCells <= n;
  if (whole) {
#pragma unroll
    for (int i = 0; i < kCells / 4; ++i) {
      const float4 v = reinterpret_cast<const float4*>(x + base)[i];
      c[4 * i] = v.x;
      c[4 * i + 1] = v.y;
      c[4 * i + 2] = v.z;
      c[4 * i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kCells; ++k) c[k] = base + k < n ? x[base + k] : 0.0f;
  }

  const bool ghost_left = tile == 0 && warp == 0;
  float ghost = c[0];  // x[0] in lane 0 of tile 0's first warp
  int seen = 0;  // lane 0 of warp 0: carry levels the left tile has published
  for (int s = 0; s < t_steps; ++s) {
    // this lane's last two cells of level s: the carry to its right
    const float r0 = c[kCells - 2], r1 = c[kCells - 1];
    if (lane == 31) {
      if (warp + 1 < kWarps) {
        while (consumed[warp + 1] <= s - kRing) {
        }
        __threadfence_block();
        ring[warp][s % kRing] = make_float2(r0, r1);
        __threadfence_block();
        produced[warp] = s + 1;
      } else {
        __stcg(&carry[tile * t_steps + s], make_float2(r0, r1));
        st_release(&published[tile], s + 1);
      }
    }
    // the two cells of level s left of this lane
    float l0 = __shfl_up_sync(kFull, r0, 1);
    float l1 = __shfl_up_sync(kFull, r1, 1);
    if (lane == 0) {
      if (ghost_left) {
        l0 = l1 = ghost;
        ghost = update(ghost, ghost, ghost);
      } else if (warp > 0) {
        while (produced[warp - 1] <= s) {
        }
        __threadfence_block();
        const float2 in = ring[warp - 1][s % kRing];
        l0 = in.x;
        l1 = in.y;
        __threadfence_block();
        consumed[warp] = s + 1;
      } else {
        while (seen <= s) seen = ld_acquire(&published[tile - 1]);
        const float2 in = __ldcg(&carry[(tile - 1) * t_steps + s]);
        l0 = in.x;
        l1 = in.y;
      }
    }
    // level s + 1, right to left so that each cell's inputs are still level s
#pragma unroll
    for (int k = kCells - 1; k >= 2; --k) c[k] = update(c[k - 2], c[k - 1], c[k]);
    c[1] = update(l1, c[0], c[1]);
    c[0] = update(l0, l1, c[0]);
  }

  if (whole) {
#pragma unroll
    for (int i = 0; i < kCells / 4; ++i)
      reinterpret_cast<float4*>(y + base)[i] =
          make_float4(c[4 * i], c[4 * i + 1], c[4 * i + 2], c[4 * i + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < kCells; ++k)
      if (base + k < n) y[base + k] = c[k];
  }
}

// Adds to *mismatches the f32 inputs, of all 2^32 bit patterns, whose div3
// differs from div.rn.f32 (NaN against NaN counts as equal).
__global__ void div3_check_kernel(unsigned long long* mismatches) {
  unsigned long long bad = 0;
  for (uint64_t i = blockIdx.x * static_cast<uint64_t>(blockDim.x) + threadIdx.x;
       i < (1ull << 32); i += static_cast<uint64_t>(gridDim.x) * blockDim.x) {
    const float x = __uint_as_float(static_cast<uint32_t>(i));
    const float want = __fdiv_rn(x, 3.0f), got = div3(x);
    bad += __float_as_uint(got) != __float_as_uint(want) &&
           !(got != got && want != want);
  }
  if (bad) atomicAdd(mismatches, bad);
}

}  // namespace

extern "C" {

// Cells a block holds: the wrapper sizes the workspace by it.
int jacobi_chunked_tile() { return kTile; }

// Runs on `stream`, allocates nothing, does not synchronise, and returns
// cudaGetLastError() after the launch (0 when it was accepted).  The caller
// checks n > 0 and t_steps >= 0, passes x and y 16-byte aligned, `flags`
// as 1 + ceil(n / tile) zeroed ints and `carry` as ceil(n / tile) * t_steps
// float2 on the same stream.
int jacobi_chunked_launch(const void* x, void* y, int64_t n, int t_steps,
                          void* flags, void* carry, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int64_t tiles = (n + kTile - 1) / kTile;
  jacobi_wavefront_kernel<<<static_cast<unsigned>(tiles), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), n, t_steps,
      static_cast<int*>(flags), static_cast<float2*>(carry));
  return cudaGetLastError();
}

// Runs div3_check_kernel on `stream`; `mismatches` is one zeroed uint64.
int jacobi_div3_check(void* mismatches, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  div3_check_kernel<<<132 * 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(mismatches));
  return cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
