// Attention over images of more than 32 tokens, for the fused-block
// kernels 5 (fused_ln_qkv_attn) and 7 (fused_block_full) of fused_block.cu.
//
// Up to 32 tokens those kernels hold each image whole in a CTA's tile and
// its (N, N) logits in one warp's registers (mma_attention.cuh) or one
// warp's shared memory (attention_body.cuh).  Past 32 tokens the logits
// tile grows as N^2, and past 64 (float32) or 128 (bf16) rows an image no
// longer fits a CTA tile at all, while each of its query rows needs every
// key and value of the image.  So the route past 32 tokens stages the
// image's qkv rows through a global buffer: the LN1+QKV kernel of
// fused_block.cu (6a's kernel; the tensor-core one in bf16) writes the
// (rows, 3W) qkv, the kernels below read each (image, head) back, and
// kernel 7 then runs 6b's kernel (projection, LN2, MLP) on their output.
// The kernel boundaries order the stages: no CTA reads an image's k or v
// before every CTA that writes them has finished, with no grid-wide
// barrier.  The buffer costs a write and a read of qkv (3W bf16 a row),
// against tiles that keep it on chip up to 32 tokens; a later design may
// keep one image a CTA instead.
//
// Both kernels take the keys in tiles of 32 with a running row maximum and
// sum (online softmax), so registers and shared memory do not grow with N.
// A CTA takes one (image, head) and a block of query rows; every tile of
// keys and values is staged in shared memory once for all of the CTA's
// warps.  Keys past N are masked and their rows of v are zeros.
//
// - bf16 (tensor cores): 4 warps, 16 query rows each (64 a CTA); S = q k^T
//   and P v are mma.sync m16n8k16 with float32 sums, as in
//   mma_attention.cuh; P (the unnormalised exp(s - m), in [0, 1]) enters
//   P v as a bf16 pair hi + lo, about 16 mantissa bits, the rounding plan
//   of mma_attention.cuh; the output is divided by the row sum at the end
//   and rounded once to bf16.
// - float32 (CUDA cores): 8 warps, 4 query rows each (32 a CTA); a lane
//   takes one key of the tile for the logits and D / 32 columns of the
//   output; q is scaled before the logits, as in attention_body.cuh.
//
// Only images of more than 32 tokens come here: shorter ones keep the
// fused kernels' one-tile attention and its numerics.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "mma_attention.cuh"

namespace long_attn {

using bf16 = __nv_bfloat16;

constexpr int kKeys = 32;            // keys a tile
constexpr int kMaxD = 128;           // head width at most
constexpr int kMmaWarps = 4;
constexpr int kMmaRows = 16 * kMmaWarps;   // query rows a bf16 CTA
constexpr int kLdt = kMaxD + 8;      // bf16 tile rows, 16 bytes of padding
constexpr int kSimtWarps = 8;
constexpr int kSimtRowsPerWarp = 4;
constexpr int kSimtRows = kSimtWarps * kSimtRowsPerWarp;

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Rows r0 .. r0 + n - 1 of one head's (N, D) slice of q, k or v (`src`:
// the slice's row 0, rows `ld` apart) into a (n, kLdt) bf16 tile, zeros
// past N or past D up to DP.
__device__ __forceinline__ void stage_bf16(bf16* tile, const bf16* src,
                                           size_t ld, int r0, int n, int N,
                                           int D, int DP) {
  const int chunks = DP / 8;    // 16-byte chunks a row
  for (int i = threadIdx.x; i < n * chunks; i += blockDim.x) {
    const int r = i / chunks, c = (i - r * chunks) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < N && c < D)
      v = *reinterpret_cast<const uint4*>(src + (r0 + r) * ld + c);
    *reinterpret_cast<uint4*>(tile + r * kLdt + c) = v;
  }
}

// grid (images, heads, ceil(N / 64)), 128 threads.  qkv (rows, 3W) bf16,
// lanes [q | k | v], heads contiguous; out (rows, W) bf16.
__global__ void __launch_bounds__(32 * kMmaWarps)
mma_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int N,
           int W, int D, float scale) {
  using namespace mma_attn;
  __shared__ __align__(16) bf16 sq[kMmaRows * kLdt];
  __shared__ __align__(16) bf16 sk[kKeys * kLdt];
  __shared__ __align__(16) bf16 sv[kKeys * kLdt];
  const int img = blockIdx.x, h = blockIdx.y, q0 = blockIdx.z * kMmaRows;
  const int DP = (D + 15) & ~15;
  const size_t ld = 3 * size_t(W);
  const bf16* base = qkv + size_t(img) * N * ld + h * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool active = q0 + 16 * warp < N;
  stage_bf16(sq, base, ld, q0, kMmaRows, N, D, DP);

  float o[2 * kMaxD / 16][4];
#pragma unroll
  for (int n = 0; n < 2 * kMaxD / 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  const bf16* a_row = sq + (16 * warp + (lane & 15)) * kLdt + (lane >> 4) * 8;
  const bf16* k_row =
      sk + ((lane & 7) + ((lane >> 4) << 3)) * kLdt + ((lane >> 3) & 1) * 8;
  const bf16* v_row =
      sv + ((lane & 7) + ((lane >> 3) & 1) * 8) * kLdt + (lane >> 4) * 8;

  for (int j0 = 0; j0 < N; j0 += kKeys) {
    __syncthreads();    // the previous tile is consumed
    stage_bf16(sk, base + W, ld, j0, kKeys, N, D, DP);
    stage_bf16(sv, base + 2 * W, ld, j0, kKeys, N, D, DP);
    __syncthreads();
    if (!active) continue;
    // S = q k^T: 16 rows x 32 keys, 8-key n-tiles
    float s[kKeys / 8][4];
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    for (int k0 = 0; k0 < DP; k0 += 16) {
      uint32_t a[4];
      ldsm(a, a_row + k0);
#pragma unroll
      for (int n = 0; n < kKeys / 16; ++n) {
        uint32_t b[4];
        ldsm(b, k_row + n * 16 * kLdt + k0);
        mma(s[2 * n], a, b[0], b[1]);
        mma(s[2 * n + 1], a, b[2], b[3]);
      }
    }
    // online softmax: lane (g, t) holds rows g and g + 8, keys 8n + 2t + c
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = s[n][2 * half + c];
          x = j0 + 8 * n + 2 * t + c < N ? x * scale : -CUDART_INF_F;
          mx = fmaxf(mx, x);
        }
      const float mn = fmaxf(m[half], quad_max(mx));   // key j0 < N: finite
      const float corr = expf(m[half] - mn);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = s[n][2 * half + c];
          x = expf(x - mn);
          sum += x;
        }
      l[half] = l[half] * corr + quad_sum(sum);
      m[half] = mn;
#pragma unroll
      for (int n = 0; n < 2 * kMaxD / 16; ++n) {
        o[n][2 * half] *= corr;
        o[n][2 * half + 1] *= corr;
      }
    }
    // P as A fragments of the two 16-key k-steps, each a bf16 pair hi + lo
    uint32_t hi[kKeys / 16][4], lo[kKeys / 16][4];
#pragma unroll
    for (int k = 0; k < kKeys / 16; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* c = s[2 * k + (e >> 1)] + 2 * (e & 1);
        split(c[0], c[1], hi[k][e], lo[k][e]);
      }
    // o += P v, 16 columns at a time
#pragma unroll
    for (int p = 0; p < kMaxD / 16; ++p) {
      if (16 * p >= DP) break;
#pragma unroll
      for (int k = 0; k < kKeys / 16; ++k) {
        uint32_t b[4];
        ldsm_t(b, v_row + k * 16 * kLdt + 16 * p);
        mma(o[2 * p], hi[k], b[0], b[1]);
        mma(o[2 * p], lo[k], b[0], b[1]);
        mma(o[2 * p + 1], hi[k], b[2], b[3]);
        mma(o[2 * p + 1], lo[k], b[2], b[3]);
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + 16 * warp + g + 8 * half;
    if (row >= N) continue;
    const float inv = 1.f / l[half];
    bf16* dst = out + (size_t(img) * N + row) * W + h * D;
#pragma unroll
    for (int n = 0; n < 2 * kMaxD / 16; ++n) {
      const int col = 8 * n + 2 * t;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(dst + col) =
            __floats2bfloat162_rn(o[n][2 * half] * inv,
                                  o[n][2 * half + 1] * inv);
    }
  }
}

// grid (images, heads, ceil(N / 32)), 256 threads, dynamic shared memory
// simt_smem(D).  qkv (rows, 3W) float32; out (rows, W) float32.
__host__ __device__ __forceinline__ size_t simt_smem(int D) {
  return sizeof(float) * (size_t(kSimtRows) * D + size_t(kKeys) * (D + 1) +
                          size_t(kKeys) * D);
}

__global__ void __launch_bounds__(32 * kSimtWarps)
simt_kernel(const float* __restrict__ qkv, float* __restrict__ out, int N,
            int W, int D, float scale) {
  extern __shared__ float smem[];
  float* sq = smem;                          // (32, D), q * scale
  float* sk = sq + kSimtRows * D;            // (32, D + 1)
  float* sv = sk + kKeys * (D + 1);          // (32, D)
  const int img = blockIdx.x, h = blockIdx.y, q0 = blockIdx.z * kSimtRows;
  const size_t ld = 3 * size_t(W);
  const float* base = qkv + size_t(img) * N * ld + h * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < kSimtRows * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D;
    sq[i] = q0 + r < N ? base[(q0 + r) * ld + d] * scale : 0.f;
  }
  constexpr int kCols = kMaxD / 32;
  float m[kSimtRowsPerWarp], l[kSimtRowsPerWarp];
  float o[kSimtRowsPerWarp][kCols];
#pragma unroll
  for (int i = 0; i < kSimtRowsPerWarp; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[i][c] = 0.f;
  }
  for (int j0 = 0; j0 < N; j0 += kKeys) {
    __syncthreads();
    for (int i = threadIdx.x; i < kKeys * D; i += blockDim.x) {
      const int r = i / D, d = i - r * D;
      const bool in = j0 + r < N;
      sk[r * (D + 1) + d] = in ? base[(j0 + r) * ld + W + d] : 0.f;
      sv[i] = in ? base[(j0 + r) * ld + 2 * W + d] : 0.f;
    }
    __syncthreads();
    const bool key = j0 + lane < N;
    const int n_keys = min(kKeys, N - j0);
#pragma unroll
    for (int i = 0; i < kSimtRowsPerWarp; ++i) {
      const int row = kSimtRowsPerWarp * warp + i;
      if (q0 + row >= N) break;
      const float* qi = sq + row * D;
      const float* kj = sk + lane * (D + 1);
      float s = 0.f;
      for (int d = 0; d < D; ++d) s += qi[d] * kj[d];
      s = key ? s : -CUDART_INF_F;
      float mx = s;
#pragma unroll
      for (int off = 16; off; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx);
      const float corr = expf(m[i] - mn);
      const float p = key ? expf(s - mn) : 0.f;
      float sum = p;
#pragma unroll
      for (int off = 16; off; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < kCols; ++c) o[i][c] *= corr;
      for (int j = 0; j < n_keys; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
        const float* vj = sv + j * D;
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          if (lane + 32 * c < D) o[i][c] += pj * vj[lane + 32 * c];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kSimtRowsPerWarp; ++i) {
    const int row = q0 + kSimtRowsPerWarp * warp + i;
    if (row >= N) break;
    float* dst = out + (size_t(img) * N + row) * W + h * D;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (lane + 32 * c < D) dst[lane + 32 * c] = o[i][c] * inv;
  }
}

// Launches the attention of (rows / N) images of N tokens and H heads of
// width D = W / H on `st`: bf16 (dtype 1) on the tensor cores, float32
// (dtype 0) on the CUDA cores.  cudaErrorInvalidValue for a shape it does
// not take (N >= 1 dividing rows, D a multiple of 8 up to 128).
inline cudaError_t launch(const void* qkv, void* out, int rows, int N, int H,
                          int W, float scale, int dtype, cudaStream_t st) {
  if (N < 1 || rows < 0 || rows % N || H < 1 || W % H) {
    return cudaErrorInvalidValue;
  }
  const int D = W / H;
  if (D % 8 || D > kMaxD || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const int B = rows / N;
  if (B == 0) return cudaSuccess;
  if (dtype == 1) {
    const dim3 grid(B, H, (N + kMmaRows - 1) / kMmaRows);
    mma_kernel<<<grid, 32 * kMmaWarps, 0, st>>>(
        static_cast<const bf16*>(qkv), static_cast<bf16*>(out), N, W, D,
        scale);
    return cudaGetLastError();
  }
  const size_t smem = simt_smem(D);
  cudaError_t e = cudaFuncSetAttribute(
      simt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(B, H, (N + kSimtRows - 1) / kSimtRows);
  simt_kernel<<<grid, 32 * kSimtWarps, smem, st>>>(
      static_cast<const float*>(qkv), static_cast<float*>(out), N, W, D,
      scale);
  return cudaGetLastError();
}

}  // namespace long_attn
