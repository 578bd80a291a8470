// Per-head short-sequence attention body, shared by the attention kernels
// (short_attention.cu) and the fused-block kernels (fused_block.cu).
//
// One warp computes one head of one image: N tokens, head width D, q/k/v
// rows `ld` elements apart (in shared or global memory).  Everything is
// float32; outputs are rounded once to T.  Follows the body of the TPU
// kernel vit_marl_tpu/ops/attention_kernel.py::_attn_body: q is scaled
// before the logits, the softmax takes the row max first, P stays float32
// through P v.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace attn_body {

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// P = softmax_j((q_i*scale) . k_j) into the (N, N+1)-strided float tile P.
// Lanes cover the (i, j) pairs, then one lane per row.
template <typename T>
__device__ __forceinline__ void head_softmax(const T* q, const T* k, int ldq,
                                             int ldk, int N, int D,
                                             float scale, float* P,
                                             int lane) {
  const int ld_p = N + 1;
  for (int p = lane; p < N * N; p += 32) {
    const int i = p / N, j = p - i * N;
    const T* qi = q + i * ldq;
    const T* kj = k + j * ldk;
    float acc = 0.f;
    for (int d = 0; d < D; ++d) acc += (ld(qi + d) * scale) * ld(kj + d);
    P[i * ld_p + j] = acc;
  }
  __syncwarp();
  if (lane < N) {
    float* row = P + lane * ld_p;
    float m = row[0];
    for (int j = 1; j < N; ++j) m = fmaxf(m, row[j]);
    float l = 0.f;
    for (int j = 0; j < N; ++j) {
      const float e = expf(row[j] - m);
      row[j] = e;
      l += e;
    }
    const float inv = 1.f / l;
    for (int j = 0; j < N; ++j) row[j] *= inv;
  }
  __syncwarp();
}

// o_i = sum_j P_ij v_j, lanes over d; o rows `ldo` elements apart.
template <typename T>
__device__ __forceinline__ void head_pv(const float* P, const T* v, int ldv,
                                        int N, int D, T* o, int ldo,
                                        int lane) {
  for (int d = lane; d < D; d += 32) {
    for (int i = 0; i < N; ++i) {
      const float* p = P + i * (N + 1);
      float acc = 0.f;
      for (int j = 0; j < N; ++j) acc += p[j] * ld(v + j * ldv + d);
      st(o + i * ldo + d, acc);
    }
  }
}

}  // namespace attn_body
