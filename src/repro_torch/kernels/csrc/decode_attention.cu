// One decode step's attention over the packed KV cache, for Hopper (sm_90a):
// the codes are read from device memory once, dequantized on chip, and
// attended, one launch a layer and step.
//
// Redesign of the dequant kernel (src/repro/kernels/kvpack.py::_dequant_kernel,
// ported as csrc/kvpack.cu's dequant_kernel) for its consumer: the
// reference's decode softmax (src/repro/models/layers.py::decode_attention,
// the region its comment says deploys as kvpack dequant fused into
// flash-decode, codes read once and dequantized in VMEM).  The unfused port
// wrote the whole cache as f32, cast it to bf16 and back, and ran two f32
// einsums: ~21x the bytes of the codes a layer and step.
//
// The function (the plain version, repro_torch/kernels/decode_attention.py::
// kv_decode_attention_plain, computes it op by op):
//
//   k[j] = rnd(f32(code[j]) * scale[j]), v likewise  (bits 8 / 4; int4 byte j
//          holds column 2j in its low nibble, 2j + 1 in its high, sign-
//          extended); at bits 16 the cache's own bf16 / f32 values;
//   q    = rnd(q),       rnd = rounding to the compute dtype (bf16 or f32);
//   s[h][j] = (sum_d q[h][d] k[j][d]) * scale_attn  in f32, j valid for pos,
//          else -1e30 (the reference's finite NEG_INF); valid: causal
//          (j <= pos), within the window (pos - j < window), or on a ring
//          slot whose key position pos - ((pos - j) mod S_all) is >= 0;
//   p    = exp(s - max) / sum exp(s - max) over every slot of the row,
//          rounded to the compute dtype where round_p;
//   o[h] = sum_j p[h][j] v[j]  in f32.
//
// Query head h (of [q0, q0 + n)) reads KV head h / G, so a head block that
// cuts a KV group is taken as it comes: each CTA serves the query heads of
// one KV head that fall in the block (1 to G rows).
//
// Design.  Grid (split, KV head, row b); a CTA of 8 warps walks its slots
// in tiles of 64, only those that meet the row's valid interval (for every
// mask the slots valid for pos form one interval: causal [0, pos], window
// [pos - window + 1, pos], ring [0, min(pos, S_all - 1)]; a row with none
// walks every slot): cp.async brings a tile's codes and scales into a ring of
// shared-memory stages (packed codes: 3, two tiles in flight while one is
// worked on; bf16 / f32 rows: 2); the tile is dequantized once, each value
// by one thread, into a bf16 (or f32) tile in shared memory; then the
// warps take their products from it.  Pass 1 writes the scaled, masked
// scores of the CTA's walked slots into shared memory (G x slots f32), pass
// 2 walks V the same way.  In bf16 with round_p the products run on the
// tensor cores, mma.sync m16n8k16 (bf16 x bf16 -> f32; the query rows
// padded to 16): the product of two bf16 values is exact in f32, so only
// the order of the sums differs from the reference.  In f32 the CUDA cores
// take f32 FMAs (probabilities rounded or not).
//
// A long cache splits its slots over a cluster of up to 8 CTAs (the grid's
// x), so that a CTA's scores fit its shared memory (granite-8b at 32,768
// slots: 512 KiB of scores a KV head) and the card has enough CTAs.  The
// CTAs of a cluster combine the softmax's max and sum through distributed
// shared memory before any probability is formed, as the reference's split
// softmax combines them over ranks; each then forms its normalised,
// rounded P and its partial P.V, and the partials are summed in rank order
// over the cluster.  No unnormalised partial output is rescaled: the
// probabilities are the single-CTA ones, up to the order of the sums.
// Every sum runs in a fixed order, so the kernel is deterministic (a
// replayed CUDA graph gives the eager step's bits).
//
// Slots outside the interval are masked: a walked tile's rows outside it are
// not loaded and are dequantized to zeros, a tile outside it is not walked,
// and the softmax's sums skip them.  Each skipped slot's exp(-1e30 - max) is
// 0 and its probability 0, and the sums keep their order, so for a finite
// cache the output is the one a walk of every slot gives, bit for bit.  A
// CTA whose slots hold no valid one walks nothing and still joins the
// cluster's combine.  A tile whose rows are all valid is dequantized by an
// instance of its own that checks no row.
//
// Bound on this card.  By bytes a layer's step reads the codes and scales of
// the valid slots once: at B 8 x S 32,768, 8 KV heads of 128, int8, every
// slot valid, 554 MB, 0.165 ms at 3.35 TB/s.  Its operations, 8 FLOP per
// int8 code byte at G = 4 (16 per int4 byte), are far below the tensor
// cores' rate; the dequant costs a byte permute, an add and a multiply a
// value (the integer to float conversion by the 2^23 trick, not the
// quarter-rate I2F) and a pack of two values to bf16.  In practice the
// kernel runs well below the byte bound, paced by its tile iterations (load,
// dequantize, products, two barriers each; no one phase dominates), so its
// time follows the tiles it walks: a chat batch whose rows sit at position
// t of 2,048 slots walks ceil((t + 1) / 64) of a row's 32 tiles.
//
// The launch reads pos on the device, allocates nothing, does not
// synchronise: it can be captured in a CUDA graph.

#include "decode_attention.cuh"

extern "C" {

// q (B, 1, n, hd) of the compute dtype, element strides q_sb (rows) and
// q_sh (heads), hd contiguous; k_codes, v_codes the cache (B, S, KV, cd)
// contiguous, 16-byte aligned: int8 codes (code 0: cd = hd; code 1, int4:
// cd = hd / 2) with f32 scales (B, S, KV, 1), or the bf16 (code 2) or f32
// (code 3) values with null scales; pos int32 (B,); out f32 (B, 1, n, hd).
// This library: the compute dtype bf16 (ct_bf16 1) with round_p 1, codes
// 0, 1, 2, on the tensor cores; decode_attention_f32.cu's: f32 (ct_bf16 0),
// codes 0, 1, 3.  hd 32, 64 or 128; G <= 16.  With out null only the plan
// is made.  plan_out (nullable) gets the split, the shared memory bytes
// and the slots a CTA.  tiles_walked (nullable, an unsigned 64-bit counter on
// the device) gets the tiles each CTA walks added, one atomic a CTA.  Returns cudaGetLastError() after the launch, -1
// when one (row, KV head)'s scores do not fit a cluster of 8 CTAs.
int kv_decode_attention_launch(const void* q, int64_t q_sb, int64_t q_sh,
                               const void* k_codes, const void* v_codes,
                               const void* k_scale, const void* v_scale,
                               const void* pos, void* out, int code, int ct_bf16,
                               int round_p, int B, int S, int KV, int G, int hd,
                               int q0, int n, int lo, int s_all, int window,
                               int ring, float scale, int device, void* stream,
                               int* plan_out, void* tiles_walked) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (!ct_bf16 || !round_p) return cudaErrorInvalidValue;   // not this library's
#define DA_CALL(CODE)                                                            \
  by_hd<CODE, true, true>(hd, q, q_sb, q_sh, k_codes, v_codes, k_scale, v_scale, \
                          pos, out, B, S, KV, G, q0, n, lo, s_all, window, ring, \
                          round_p, scale, device, static_cast<cudaStream_t>(stream), \
                          plan_out, static_cast<unsigned long long*>(tiles_walked))
  switch (code) {
    case kInt8: return DA_CALL(kInt8);
    case kInt4: return DA_CALL(kInt4);
    case kBf16: return DA_CALL(kBf16);
    default: return cudaErrorInvalidValue;
  }
#undef DA_CALL
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
