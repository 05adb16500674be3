// The f32 instantiations of the decode attention kernel (the CUDA cores'
// f32 FMAs; probabilities rounded or kept): the f32 models' decode, in the
// tests' and the parity phases' configs.  The kernel and its design are in
// decode_attention.cuh and decode_attention.cu; this library is built
// beside that one, in parallel.

#include "decode_attention.cuh"

extern "C" {

// As decode_attention.cu's launcher, for the compute dtype f32 (ct_bf16 0):
// codes 0, 1 (int8, int4 with f32 scales) and 3 (an f32 cache).
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
  if (ct_bf16) return cudaErrorInvalidValue;   // not this library's
#define DA_CALL(CODE)                                                              \
  by_hd<CODE, false, false>(hd, q, q_sb, q_sh, k_codes, v_codes, k_scale, v_scale, \
                            pos, out, B, S, KV, G, q0, n, lo, s_all, window, ring, \
                            round_p, scale, device, static_cast<cudaStream_t>(stream), \
                            plan_out, static_cast<unsigned long long*>(tiles_walked))
  switch (code) {
    case kInt8: return DA_CALL(kInt8);
    case kInt4: return DA_CALL(kInt4);
    case kF32: return DA_CALL(kF32);
    default: return cudaErrorInvalidValue;
  }
#undef DA_CALL
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
