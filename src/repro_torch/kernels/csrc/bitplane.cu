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
//   unpack: the inverse: planes -> words (word i takes bit i of each plane),
//           sign-extend from `bits` with (v ^ h) - h (not for bits == 32), then
//           an inclusive prefix sum over the whole row, modulo 2^32.
//
// Bound on this card: bytes.  A word costs 4 bytes of traffic in and bits/8
// out (pack; the mirror for unpack), so at [2^18, 256] and 8 bits the 320 MiB
// take 0.100 ms at the H100 data sheet's 3.35 TB/s.  Two things keep a kernel
// from that bound, and the design answers each:
//
// * Bytes in flight.  Little's law at HBM's loaded latency asks for some
//   25-32 KB in flight per SM.  A block of 256 threads takes a TILE of up to
//   256 consecutive 32-word groups (whole rows, or a 256-group chunk of a
//   row longer than that) and streams tiles through a double buffer in
//   shared memory with cp.async: tile i + 1 is in flight while tile i is
//   transposed.  Pack's tile is 32 KB of codes, so with the 2 blocks an SM
//   that the launch plan gives, an SM has 64 KB requested.  The grid is
//   persistent and each block walks its units (a set of whole rows, or one
//   long row chunk by chunk) in order.
// * Instructions per group, and which pipe.  The previous design (one warp
//   per row, a ballot per plane and a 5-step shuffle scan per group) spent
//   ~10-14 instructions per group on the shuffle/vote pipe, which issues
//   one warp instruction a clock per SM: on that pipe alone, about as long
//   as the byte bound.  Here ONE THREAD OWNS ONE GROUP: its 32 words sit in
//   registers, the delta is a register subtraction, and the bit transpose
//   is done in byte slices: bits 8s..8s+7 of an octet of words are gathered
//   into 64 bits with PRMT, transposed as an 8x8 bit matrix (three
//   shift/xor stages, Hacker's Delight 7-3), and the planes reassembled with
//   PRMT.  No shuffle or vote is left in pack; unpack rebuilds its words the
//   same way, takes the prefix sum inside the thread, and joins the groups
//   of a row with ONE block-wide scan of the group totals (5 shuffles per
//   warp per tile, where the previous design took 5 per group), with a
//   running carry across the chunks of a long row.
//
// Shared memory.  The 32 words of a group are read by their one thread as 8
// 16-byte vectors; the vectors of group g are stored XOR-swizzled (vector c
// at slot c ^ (g & 7)), so that 8 threads reading vector c of 8 groups hit 8
// distinct bank quads: no conflict, and each thread still reads its words in
// order into fixed registers.  The packed side (planes) is ragged: a tile's
// span of planes starts at any 4-byte address.  It is kept in shared memory
// at the same address modulo 16 as in device memory, so the aligned body of
// the span moves in 16-byte vectors and only its head and tail in words.
// Codes whose base address is not 16-byte aligned are copied word by word
// into the same swizzled layout.
//
// All arithmetic is uint32, so the wraps are defined.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kGroup = 32;
constexpr int kThreads = 256;     // one 32-word group per thread
constexpr int kTileGroups = kThreads;
// resident blocks an SM: the launch plan's grid (kernels/bitplane.py
// BLOCKS_PER_SM, held equal by tests/test_torch_bitplane.py) counts on it
constexpr int kBlocksPerSm = 2;

// ---------------------------------------------------------------------------
// cp.async helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_prev() {  // all but the newest group
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// ---------------------------------------------------------------------------
// The 8x8 bit transpose of 64 bits held as (lo, hi): bit j of byte k moves
// to bit k of byte j.  Three stages of the block-swap network.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void transpose8(uint32_t& lo, uint32_t& hi) {
  uint32_t t;
  t = (lo ^ (lo >> 7)) & 0x00AA00AAu; lo ^= t ^ (t << 7);
  t = (hi ^ (hi >> 7)) & 0x00AA00AAu; hi ^= t ^ (t << 7);
  t = (lo ^ (lo >> 14)) & 0x0000CCCCu; lo ^= t ^ (t << 14);
  t = (hi ^ (hi >> 14)) & 0x0000CCCCu; hi ^= t ^ (t << 14);
  t = (lo ^ (hi << 4)) & 0xF0F0F0F0u; lo ^= t; hi ^= t >> 4;
}

// Byte `sel`'s nibble picks from {b:a}: gather byte s of a and of b into the
// two low bytes, then two such pairs into one word.
__device__ __forceinline__ uint32_t gather4(uint32_t a, uint32_t b, uint32_t c,
                                            uint32_t d, uint32_t sel) {
  return __byte_perm(__byte_perm(a, b, sel), __byte_perm(c, d, sel), 0x5410);
}

// ---------------------------------------------------------------------------
// The launch plan's tiles (kernels/bitplane.py::launch_plan computes the
// same): unit u = rows [u*R, u*R + R) when a row fits a tile (chunks == 1),
// else row u taken in chunks of `chunk` groups.
// ---------------------------------------------------------------------------

struct Plan {
  int64_t n_rows;
  int groups;          // groups per row (block / 32)
  int bits;
  int rows_per_tile;   // R
  int chunk;           // groups per tile of a long row
  int chunks;          // tiles per unit
  int64_t units;
};

struct Tile {
  int64_t g0;  // first group, counted over the whole array
  int ng;      // groups in the tile (<= kTileGroups)
  int c;       // chunk of the row (0 when rows fit a tile)
};

__device__ __forceinline__ Tile tile_of(const Plan& p, int64_t step) {
  const int64_t u = blockIdx.x + (step / p.chunks) * gridDim.x;
  const int c = static_cast<int>(step % p.chunks);
  const int64_t row0 = u * p.rows_per_tile;
  Tile t;
  t.c = c;
  if (p.chunks == 1) {
    t.g0 = row0 * p.groups;
    const int64_t rows = p.n_rows - row0 < p.rows_per_tile ? p.n_rows - row0
                                                           : p.rows_per_tile;
    t.ng = static_cast<int>(rows) * p.groups;
  } else {
    t.g0 = row0 * p.groups + static_cast<int64_t>(c) * p.chunk;
    const int left = p.groups - c * p.chunk;
    t.ng = left < p.chunk ? left : p.chunk;
  }
  return t;
}

__device__ __forceinline__ int64_t steps_of(const Plan& p) {
  const int64_t mine = (p.units - blockIdx.x + gridDim.x - 1) / gridDim.x;
  return mine * p.chunks;
}

// Words of a ragged span live in shared memory at the same address modulo
// 16 bytes as in device memory: `shift` words in.
__device__ __forceinline__ int span_shift(const void* g) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(g) >> 2) & 3);
}

// Swizzled slot of vector c (4 words) of group g in a tile of codes.
__device__ __forceinline__ int code_vec(int g, int c) { return g * 8 + (c ^ (g & 7)); }

// Codes of a tile -> swizzled shared memory (16-byte copies when aligned).
__device__ __forceinline__ void load_codes(uint32_t* buf, const int32_t* src, int ng,
                                           bool vec) {
  if (vec) {
    for (int i = threadIdx.x; i < ng * 8; i += kThreads)
      cp_async16(buf + code_vec(i >> 3, i & 7) * 4, src + i * 4);
  } else {
    for (int i = threadIdx.x; i < ng * kGroup; i += kThreads)
      cp_async4(buf + code_vec(i >> 5, (i >> 2) & 7) * 4 + (i & 3), src + i);
  }
}

// A ragged span of `len` words -> shared memory at `buf + span_shift(src)`.
__device__ __forceinline__ void load_span(uint32_t* buf, const uint32_t* src,
                                          int len) {
  const int shift = span_shift(src);
  int head = (4 - shift) & 3;
  head = head < len ? head : len;
  const int nvec = (len - head) >> 2;
  uint32_t* dst = buf + shift;
  for (int i = threadIdx.x; i < nvec; i += kThreads)
    cp_async16(dst + head + 4 * i, src + head + 4 * i);
  const int tail0 = head + 4 * nvec;
  for (int i = threadIdx.x; i < head + (len - tail0); i += kThreads) {
    const int w = i < head ? i : tail0 + (i - head);
    cp_async4(dst + w, src + w);
  }
}

// Shared memory at `buf + span_shift(dst)` -> a ragged span of `len` words.
__device__ __forceinline__ void store_span(uint32_t* dst, const uint32_t* buf,
                                           int len) {
  const int shift = span_shift(dst);
  int head = (4 - shift) & 3;
  head = head < len ? head : len;
  const int nvec = (len - head) >> 2;
  const uint32_t* src = buf + shift;
  for (int i = threadIdx.x; i < nvec; i += kThreads)
    *reinterpret_cast<uint4*>(dst + head + 4 * i) =
        *reinterpret_cast<const uint4*>(src + head + 4 * i);
  const int tail0 = head + 4 * nvec;
  for (int i = threadIdx.x; i < head + (len - tail0); i += kThreads) {
    const int w = i < head ? i : tail0 + (i - head);
    dst[w] = src[w];
  }
}

// ---------------------------------------------------------------------------
// pack
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
pack_kernel(const int32_t* __restrict__ q, uint32_t* __restrict__ out, Plan p) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int in_words = kTileGroups * kGroup;
  uint32_t* stage = smem + 2 * in_words;
  const int t = threadIdx.x;
  const int bits = p.bits;
  const int nslices = (bits + 7) >> 3;
  const bool vec = (reinterpret_cast<uintptr_t>(q) & 15) == 0;
  const int64_t steps = steps_of(p);
  if (steps == 0) return;

  {
    const Tile t0 = tile_of(p, 0);
    load_codes(smem, q + t0.g0 * kGroup, t0.ng, vec);
  }
  cp_async_commit();
  for (int64_t i = 0; i < steps; ++i) {
    if (i + 1 < steps) {
      const Tile tn = tile_of(p, i + 1);
      load_codes(smem + ((i + 1) & 1) * in_words, q + tn.g0 * kGroup, tn.ng, vec);
    }
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();

    const Tile tl = tile_of(p, i);
    const uint32_t* buf = smem + (i & 1) * in_words;
    uint32_t* planes_out = out + tl.g0 * bits;
    const int shift = span_shift(planes_out);
    if (t < tl.ng) {
      uint32_t w[kGroup];
      const uint4* v4 = reinterpret_cast<const uint4*>(buf);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const uint4 v = v4[code_vec(t, c)];
        w[4 * c] = v.x; w[4 * c + 1] = v.y; w[4 * c + 2] = v.z; w[4 * c + 3] = v.w;
      }
      // the word before the group: 0 at a row's start, else the previous
      // group's last word (from this tile, or from memory before a chunk)
      const bool row_start = p.chunks == 1 ? (t % p.groups) == 0 : (tl.c == 0 && t == 0);
      uint32_t prev = 0;
      if (!row_start) {
        prev = t > 0 ? buf[code_vec(t - 1, 7) * 4 + 3]
                     : static_cast<uint32_t>(__ldg(q + tl.g0 * kGroup - 1));
      }
#pragma unroll
      for (int k = kGroup - 1; k > 0; --k) w[k] -= w[k - 1];
      w[0] -= prev;
      // planes j >= bits are never written, so the mask to `bits` is free
      uint32_t* st = stage + shift + t * bits;
      for (int s = 0; s < nslices; ++s) {
        const uint32_t sel = s | ((s + 4) << 4);
        uint32_t lo[4], hi[4];
#pragma unroll
        for (int o = 0; o < 4; ++o) {
          lo[o] = gather4(w[8 * o], w[8 * o + 1], w[8 * o + 2], w[8 * o + 3], sel);
          hi[o] = gather4(w[8 * o + 4], w[8 * o + 5], w[8 * o + 6], w[8 * o + 7], sel);
          transpose8(lo[o], hi[o]);
        }
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int j = 8 * s + r;
          const uint32_t sr = (r & 3) | (((r & 3) + 4) << 4);
          const uint32_t* x = r < 4 ? lo : hi;
          if (j < bits) st[j] = gather4(x[0], x[1], x[2], x[3], sr);
        }
      }
    }
    __syncthreads();
    store_span(planes_out, stage, tl.ng * bits);
  }
}

// ---------------------------------------------------------------------------
// unpack
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
unpack_kernel(const uint32_t* __restrict__ planes, int32_t* __restrict__ out,
              Plan p) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int bits = p.bits;
  const int in_words = (kTileGroups * bits + 4 + 3) & ~3;
  uint32_t* stage = smem + 2 * in_words;        // kTileGroups * 32 words
  // kThreads + 12 words: the exclusive scan, 8 warp sums, the tile's total
  uint32_t* scan = stage + kTileGroups * kGroup;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int nslices = (bits + 7) >> 3;
  const uint32_t h = bits < 32 ? (1u << (bits - 1)) : 0u;
  const int64_t steps = steps_of(p);
  if (steps == 0) return;

  {
    const Tile t0 = tile_of(p, 0);
    load_span(smem, planes + t0.g0 * bits, t0.ng * bits);
  }
  cp_async_commit();
  uint32_t carry = 0;  // sum of the row before this chunk (long rows)
  for (int64_t i = 0; i < steps; ++i) {
    if (i + 1 < steps) {
      const Tile tn = tile_of(p, i + 1);
      load_span(smem + ((i + 1) & 1) * in_words, planes + tn.g0 * bits, tn.ng * bits);
    }
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();

    const Tile tl = tile_of(p, i);
    const uint32_t* src = planes + tl.g0 * bits;
    const uint32_t* pl = smem + (i & 1) * in_words + span_shift(src) + t * bits;
    uint32_t v[kGroup];
#pragma unroll
    for (int k = 0; k < kGroup; ++k) v[k] = 0;
    if (t < tl.ng) {
      for (int s = 0; s < nslices; ++s) {
        uint32_t pw[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) pw[r] = 8 * s + r < bits ? pl[8 * s + r] : 0u;
        // byte k of a transposed word goes to byte s of its code word
        uint32_t put[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          put[k] = (0x3210u & ~(0xFu << (4 * s))) | ((4u + k) << (4 * s));
#pragma unroll
        for (int o = 0; o < 4; ++o) {
          const uint32_t sel = o | ((o + 4) << 4);
          uint32_t lo = gather4(pw[0], pw[1], pw[2], pw[3], sel);
          uint32_t hi = gather4(pw[4], pw[5], pw[6], pw[7], sel);
          transpose8(lo, hi);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            v[8 * o + k] = __byte_perm(v[8 * o + k], lo, put[k]);
            v[8 * o + 4 + k] = __byte_perm(v[8 * o + 4 + k], hi, put[k]);
          }
        }
      }
      if (bits < 32) {
#pragma unroll
        for (int k = 0; k < kGroup; ++k) v[k] = (v[k] ^ h) - h;
      }
#pragma unroll
      for (int k = 1; k < kGroup; ++k) v[k] += v[k - 1];
    }
    // the groups of a row: one block-wide scan of the group totals, then
    // each group subtracts the scan at its row's first group in the tile
    const uint32_t total = v[kGroup - 1];
    uint32_t x = total;
#pragma unroll
    for (int k = 1; k < 32; k <<= 1) {
      const uint32_t up = __shfl_up_sync(0xFFFFFFFFu, x, k);
      if (lane >= k) x += up;
    }
    if (lane == 31) scan[kThreads + warp] = x;
    __syncthreads();
    for (int w2 = 0; w2 < warp; ++w2) x += scan[kThreads + w2];
    scan[t] = x - total;
    if (t == kThreads - 1) scan[kThreads + 8] = x;  // the tile's total
    __syncthreads();
    if (tl.c == 0) carry = 0;
    const int first = p.chunks == 1 ? t - t % p.groups : 0;
    const uint32_t before = scan[t] - scan[first] + carry;
    carry += scan[kThreads + 8];
    uint4* st4 = reinterpret_cast<uint4*>(stage);
#pragma unroll
    for (int c = 0; c < 8; ++c)
      st4[code_vec(t, c)] = make_uint4(v[4 * c] + before, v[4 * c + 1] + before,
                                       v[4 * c + 2] + before, v[4 * c + 3] + before);
    __syncthreads();
    uint4* dst = reinterpret_cast<uint4*>(out + tl.g0 * kGroup);
    for (int j = t; j < tl.ng * 8; j += kThreads)
      dst[j] = st4[code_vec(j >> 3, j & 7)];
  }
}

constexpr int kMaxDevices = 64;

// Allow a kernel `smem` bytes of dynamic shared memory on `device`.  The
// attribute is per device; it is set again only when a launch asks for more
// than before, so a stream of launches at one width sets it once.
cudaError_t allow_smem(const void* kernel, int which, int device, int smem) {
  static int allowed[2][kMaxDevices] = {};
  const bool known = device >= 0 && device < kMaxDevices;
  if (known && smem <= allowed[which][device]) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && known) allowed[which][device] = smem;
  return err;
}

cudaError_t launch(const void* kernel, int which, int device, int grid,
                   int smem, void** args, void* stream) {
  cudaError_t err = allow_smem(kernel, which, device, smem);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernel(kernel, dim3(grid), dim3(kThreads), args, smem,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Both launchers run on `stream`, allocate nothing, do not synchronise, and
// return the CUDA error of the launch (0 when it was accepted).  The caller
// (kernels/bitplane.py) checks shapes and computes the launch plan: grid
// blocks of 256 threads, `smem` bytes of dynamic shared memory, and the
// tiles (rows_per_tile, chunk, chunks, units).  `out` of unpack and `q` of
// pack hold whole groups; `out` of unpack is 16-byte aligned.

int bitplane_pack_launch(const void* q, void* out, int64_t n_rows, int block,
                         int bits, int rows_per_tile, int chunk, int chunks,
                         int64_t units, int grid, int smem, int device,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Plan p{n_rows, block / kGroup, bits, rows_per_tile, chunk, chunks, units};
  const int32_t* qp = static_cast<const int32_t*>(q);
  uint32_t* op = static_cast<uint32_t*>(out);
  void* args[] = {&qp, &op, &p};
  return launch(reinterpret_cast<const void*>(pack_kernel), 0, device, grid,
                smem, args, stream);
}

int bitplane_unpack_launch(const void* planes, void* out, int64_t n_rows,
                           int block, int bits, int rows_per_tile, int chunk,
                           int chunks, int64_t units, int grid, int smem,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Plan p{n_rows, block / kGroup, bits, rows_per_tile, chunk, chunks, units};
  const uint32_t* pp = static_cast<const uint32_t*>(planes);
  int32_t* op = static_cast<int32_t*>(out);
  void* args[] = {&pp, &op, &p};
  return launch(reinterpret_cast<const void*>(unpack_kernel), 1, device, grid,
                smem, args, stream);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
