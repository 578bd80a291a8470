// Tensor-core body of one head of short-sequence attention (bf16), shared
// by the attention kernels (short_attention.cu) and fused_ln_qkv_attn's
// tensor-core kernel (fused_block.cu).
//
// One warp computes one (image, head): q, k and v are (16*MT, DP) bf16
// tiles read with ldmatrix from shared memory, rows `ldt` values apart
// (DP = the head width padded to a multiple of 16; the padding of q or k
// must read as zeros, and v's rows past the N tokens must be finite).
// The products are mma.sync m16n8k16 (bf16 in, float32 sums); the
// softmax runs on the accumulator fragments (a row on a quad of lanes),
// keys j >= N masked; P enters P v as bf16 hi + lo (about 16 mantissa
// bits).  A layout L gives the tile shape: members NP (rows, 16*MT), DP
// and ldt.  short_attention.cu documents the rounding plan.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace mma_attn {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldsm(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_t(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
// (x, y) -> bf16 pairs hi = bf16(x, y) and lo = bf16(x - hi_x, y - hi_y).
__device__ __forceinline__ void split(float x, float y, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// acc[mt][nt] = A B^T over DP columns: A (16*MT, DP) and B (8*NT, DP)
// tiles, both row-major in shared memory (q k^T, g v^T).
template <int MT, class L>
__device__ __forceinline__ void product_nt(float (&acc)[MT][2 * MT][4],
                                           const bf16* A, const bf16* B,
                                           const L& r, int lane) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < 2 * MT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
  const bf16* a_row = A + (lane & 15) * r.ldt + (lane >> 4) * 8;
  const bf16* b_row =
      B + ((lane & 7) + ((lane >> 4) << 3)) * r.ldt + ((lane >> 3) & 1) * 8;
  for (int k0 = 0; k0 < r.DP; k0 += 16) {
    uint32_t a[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) ldsm(a[m], a_row + m * 16 * r.ldt + k0);
#pragma unroll
    for (int n = 0; n < MT; ++n) {
      uint32_t b[4];
      ldsm(b, b_row + n * 16 * r.ldt + k0);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        mma(acc[m][2 * n], a[m], b[0], b[1]);
        mma(acc[m][2 * n + 1], a[m], b[2], b[3]);
      }
    }
  }
}

// P = softmax_j(scale * S) on the accumulator fragments, keys j >= N
// masked; rows i >= N set to 0.  Lane (g, t) holds rows g and g + 8 of
// each m-tile, columns 2t and 2t + 1 of each 8-key n-tile.
template <int MT>
__device__ __forceinline__ void softmax_rows(float (&s)[MT][2 * MT][4],
                                             int N, float scale, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int n = 0; n < 2 * MT; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = s[m][n][2 * half + c];
          x = 8 * n + 2 * t + c < N ? x * scale : -CUDART_INF_F;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      float l = 0.f;
#pragma unroll
      for (int n = 0; n < 2 * MT; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = s[m][n][2 * half + c];
          x = expf(x - mx);
          l += x;
        }
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = 16 * m + 8 * half + g < N ? 1.f / l : 0.f;
#pragma unroll
      for (int n = 0; n < 2 * MT; ++n) {
        s[m][n][2 * half] *= inv;
        s[m][n][2 * half + 1] *= inv;
      }
    }
}

// Accumulator fragments of a (16*MT, 16*MT) float32 tile -> hi and lo A
// fragments of the same tile, for [m-tile][16-column k-step].
template <int MT>
__device__ __forceinline__ void a_fragments(const float (&s)[MT][2 * MT][4],
                                            uint32_t (&hi)[MT][MT][4],
                                            uint32_t (&lo)[MT][MT][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int k = 0; k < MT; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* c = s[m][2 * k + (e >> 1)] + 2 * (e & 1);
        split(c[0], c[1], hi[m][k][e], lo[m][k][e]);
      }
}

// Writes the fragment pair of an m16 x n16 product (n-tiles d0 and d0 + 8)
// times `mul` into an output tile as bf16 pairs, rows < N and columns < D.
template <class L>
__device__ __forceinline__ void put(bf16* tile, const L& r,
                                    const float (&o)[2][4], int row0, int d0,
                                    int N, int D, float mul, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    if (d0 + 8 * n >= D) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + g + 8 * half;
      if (row < N)
        *reinterpret_cast<__nv_bfloat162*>(tile + row * r.ldt + d0 + 8 * n +
                                           2 * t) =
            __floats2bfloat162_rn(o[n][2 * half] * mul,
                                  o[n][2 * half + 1] * mul);
    }
  }
}

// out = A B over the padded tokens, into `out` (rows < N, columns < D)
// times `mul`: A given as hi/lo fragment pairs [m][k], B a (16*MT, DP)
// row-major tile read along its rows (ldmatrix.trans).
template <int MT, class L>
__device__ __forceinline__ void product_pv(const uint32_t (&hi)[MT][MT][4],
                                           const uint32_t (&lo)[MT][MT][4],
                                           const bf16* B, bf16* out,
                                           const L& r, int N, int D,
                                           float mul, int lane) {
  const bf16* b_row =
      B + ((lane & 7) + ((lane >> 3) & 1) * 8) * r.ldt + (lane >> 4) * 8;
  for (int d0 = 0; d0 < r.DP; d0 += 16) {
    float o[MT][2][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int e = 0; e < 8; ++e) o[m][e >> 2][e & 3] = 0.f;
#pragma unroll
    for (int k = 0; k < MT; ++k) {
      uint32_t b[4];
      ldsm_t(b, b_row + k * 16 * r.ldt + d0);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        mma(o[m][0], hi[m][k], b[0], b[1]);
        mma(o[m][0], lo[m][k], b[0], b[1]);
        mma(o[m][1], hi[m][k], b[2], b[3]);
        mma(o[m][1], lo[m][k], b[2], b[3]);
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) put(out, r, o[m], 16 * m, d0, N, D, mul, lane);
  }
}

}  // namespace mma_attn
