// Short-sequence attention, forward and backward, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernels of vit_marl_tpu/ops/attention_kernel.py: the
// forward _kernel_call (:253, body _attn_body :60) and the backward
// _bwd_kernel_call (:286, body _attn_bwd_body :134).  Per image of N
// tokens and H heads of width D, on the flat layout the ViT's fused QKV
// projection gives: qkv rows (B*N, 3W), W = H*D, lanes [q | k | v] with
// heads contiguous (lane h*D + d of each third).
//
//   forward:  qs = q*scale; S = qs k^T; P = softmax_j(S); out = P v
//   backward: dv = P^T g; dP = g v^T; delta_i = sum_j P_ij dP_ij;
//             dS = P (dP - delta); dq = dS k * scale; dk = dS^T qs
//
// All arithmetic is float32; each output is rounded once to the input
// type.  The plain PyTorch versions of the same functions are
// short_attention_reference / short_attention_bwd_reference in
// vit_marl_tpu_torch/ops/attention_kernel.py.
//
// Two routes, chosen by the dtype alone (one C entry point each):
//
// - bfloat16, the ViT's compute type: the tensor-core route (_mma entry
//   points), below.
// - float32: the CUDA-core route (_simt entry points): one block per
//   image, one warp per head, float32 FMAs from padded shared-memory
//   tiles (attention_body.cuh).  Tensor cores would take float32 only as
//   TF32, which misses the float32 tolerance of 1e-5.
//
// Bound at the main path's shapes (ViT-Small, N = 11, W = 384, bf16),
// moving each input once and each output once at 3.35 TB/s:
//   forward, rollout (B = 1,024):     34.6 MB,  10.3 us
//   forward, PPO minibatch (32,768):  1,107.3 MB, 330.5 us
//   backward, PPO minibatch (32,768): 1,937.8 MB, 578.4 us
// The arithmetic (6.1 GFLOP forward and 15.2 backward at B = 32,768) is
// far below the card's rate: both kernels are bound by bytes.  One
// PyTorch call computes the same function
// (torch.nn.functional.scaled_dot_product_attention on (B, H, N, D)); the
// port does not call it.
//
// The bf16 route.  A unit of work is one (image, head): N rows of D
// values from each of q, k and v (backward also g), 4.2 KB at ViT-Small.
// Every warp of a persistent grid walks its own units (unit = first +
// i * all warps, heads fastest, so a block's warps share an image) with
// a private ring of two shared-memory stages: 16-byte cp.async copies
// bring the next unit while the warp computes this one, and the warps
// need no block barrier.  A stage holds each tile as 16*MT rows
// (N padded to 16 or 32) of DP columns (D padded to a multiple of 16),
// rows DP + 8 values apart: an odd number of 16-byte chunks, so the eight
// rows an ldmatrix reads fall on distinct banks.  The padding is zeroed
// once and never written, so padded keys and values are 0; padded keys
// are set to -inf before the softmax.
//
// The products run on the tensor cores with mma.sync m16n8k16 (bf16 in,
// float32 accumulation) and ldmatrix (.trans for operands read along
// keys: v, k, q and g in P v, dq, dk and dv).  Not wgmma: its 64-row tile
// against 11 tokens per head would be 5/6 padding, and the kernel is
// bound by bytes, so mma.sync's rate is far more than enough.  A product
// of two bf16 values is exact in float32, so q k^T and g v^T differ from
// the plain version only in the order of summation; `scale` multiplies
// the float32 logits, and dq and dk after their products.  The softmax
// and the delta row sums run in registers on the accumulator fragments:
// a row lives on a quad of lanes (two __shfl_xor steps).  P and dS stay
// float32: where they enter a product they are split into hi = bf16(x)
// and lo = bf16(x - hi), two mmas, about 16 bits of mantissa.  The
// backward needs P^T and dS^T as A operands: their hi and lo tiles go
// through the warp's shared scratch and come back with ldmatrix.trans.
// Outputs are written as bf16 pairs into the stage's spent tiles and
// leave with 16-byte stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

#include "attention_body.cuh"
#include "mma_attention.cuh"

namespace {

constexpr int kSimtWarps = 8;
constexpr int kMmaWarps = 8;
constexpr size_t kMaxSmem = 227 * 1024;

using attn_body::ld;
using attn_body::st;
using bf16 = __nv_bfloat16;
using mma_attn::a_fragments;
using mma_attn::ldsm_t;
using mma_attn::product_nt;
using mma_attn::product_pv;
using mma_attn::smem_addr;
using mma_attn::softmax_rows;
using mma_attn::split;

__host__ __device__ __forceinline__ size_t align16(size_t n) {
  return (n + 15) & ~size_t(15);
}

// ============================ float32 route ============================

// Shape of one warp's slice of shared memory: `n_tiles` (N, ldr) tiles of
// float with the row stride padded by 16 bytes, then `n_f32` (N, N+1)
// float tiles.
struct Slice {
  int N, D, ldr;
  size_t tile;   // bytes of one tile
  __host__ __device__ Slice(int n, int d)
      : N(n), D(d), ldr(d + 4), tile(align16(size_t(n) * (d + 4) * 4)) {}
  __host__ __device__ size_t bytes(int n_tiles, int n_f32) const {
    return n_tiles * tile + align16(size_t(n_f32) * N * (N + 1) * 4);
  }
};

// Warp copy of N rows of D floats: from global rows of `stride` values
// into a padded tile, or back.
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int stride, const Slice& s,
                                          int lane) {
  const int vpr = s.D / 4;
  for (int v = lane; v < s.N * vpr; v += 32) {
    const int r = v / vpr, c = v - r * vpr;
    reinterpret_cast<float4*>(dst + r * s.ldr)[c] =
        reinterpret_cast<const float4*>(src + size_t(r) * stride)[c];
  }
}
__device__ __forceinline__ void store_tile(float* dst, int stride,
                                           const float* src, const Slice& s,
                                           int lane) {
  const int vpr = s.D / 4;
  for (int v = lane; v < s.N * vpr; v += 32) {
    const int r = v / vpr, c = v - r * vpr;
    reinterpret_cast<float4*>(dst + size_t(r) * stride)[c] =
        reinterpret_cast<const float4*>(src + r * s.ldr)[c];
  }
}

__global__ void attn_fwd_simt(const float* __restrict__ qkv,
                              float* __restrict__ out, int N, int H, int D,
                              float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Slice s(N, D);
  const int W = H * D, W3 = 3 * W;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  unsigned char* mine = smem + warp * s.bytes(4, 1);
  float* q = reinterpret_cast<float*>(mine);
  float* k = reinterpret_cast<float*>(mine + s.tile);
  float* v = reinterpret_cast<float*>(mine + 2 * s.tile);
  float* o = reinterpret_cast<float*>(mine + 3 * s.tile);
  float* P = reinterpret_cast<float*>(mine + 4 * s.tile);
  const float* x = qkv + size_t(blockIdx.x) * N * W3;
  float* y = out + size_t(blockIdx.x) * N * W;

  for (int h = warp; h < H; h += blockDim.x / 32) {
    load_tile(q, x + h * D, W3, s, lane);
    load_tile(k, x + W + h * D, W3, s, lane);
    load_tile(v, x + 2 * W + h * D, W3, s, lane);
    __syncwarp();
    attn_body::head_softmax(q, k, s.ldr, s.ldr, N, D, scale, P, lane);
    attn_body::head_pv(P, v, s.ldr, N, D, o, s.ldr, lane);
    __syncwarp();
    store_tile(y + h * D, W, o, s, lane);
    __syncwarp();
  }
}

__global__ void attn_bwd_simt(const float* __restrict__ qkv,
                              const float* __restrict__ g,
                              float* __restrict__ dqkv, int N, int H, int D,
                              float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Slice s(N, D);
  const int W = H * D, W3 = 3 * W;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ld_p = N + 1;
  unsigned char* mine = smem + warp * s.bytes(7, 2);
  float* q = reinterpret_cast<float*>(mine);
  float* k = reinterpret_cast<float*>(mine + s.tile);
  float* v = reinterpret_cast<float*>(mine + 2 * s.tile);
  float* gh = reinterpret_cast<float*>(mine + 3 * s.tile);
  float* dq = reinterpret_cast<float*>(mine + 4 * s.tile);
  float* dk = reinterpret_cast<float*>(mine + 5 * s.tile);
  float* dv = reinterpret_cast<float*>(mine + 6 * s.tile);
  float* P = reinterpret_cast<float*>(mine + 7 * s.tile);
  float* dS = P + N * ld_p;
  const float* x = qkv + size_t(blockIdx.x) * N * W3;
  const float* gx = g + size_t(blockIdx.x) * N * W;
  float* y = dqkv + size_t(blockIdx.x) * N * W3;

  for (int h = warp; h < H; h += blockDim.x / 32) {
    load_tile(q, x + h * D, W3, s, lane);
    load_tile(k, x + W + h * D, W3, s, lane);
    load_tile(v, x + 2 * W + h * D, W3, s, lane);
    load_tile(gh, gx + h * D, W, s, lane);
    __syncwarp();
    attn_body::head_softmax(q, k, s.ldr, s.ldr, N, D, scale, P, lane);
    for (int p = lane; p < N * N; p += 32) {   // dP = g v^T
      const int i = p / N, j = p - i * N;
      float acc = 0.f;
      for (int d = 0; d < D; ++d)
        acc += ld(gh + i * s.ldr + d) * ld(v + j * s.ldr + d);
      dS[i * ld_p + j] = acc;
    }
    __syncwarp();
    if (lane < N) {   // dS = P (dP - delta), delta_i = sum_j P_ij dP_ij
      const float* p = P + lane * ld_p;
      float* r = dS + lane * ld_p;
      float delta = 0.f;
      for (int j = 0; j < N; ++j) delta += p[j] * r[j];
      for (int j = 0; j < N; ++j) r[j] = p[j] * (r[j] - delta);
    }
    __syncwarp();
    for (int d = lane; d < D; d += 32) {
      for (int i = 0; i < N; ++i) {   // dq_i = scale * sum_j dS_ij k_j
        const float* r = dS + i * ld_p;
        float acc = 0.f;
        for (int j = 0; j < N; ++j) acc += r[j] * ld(k + j * s.ldr + d);
        st(dq + i * s.ldr + d, acc * scale);
      }
      for (int j = 0; j < N; ++j) {   // dk_j = sum_i dS_ij qs_i; dv_j
        float ak = 0.f, av = 0.f;
        for (int i = 0; i < N; ++i) {
          ak += dS[i * ld_p + j] * (ld(q + i * s.ldr + d) * scale);
          av += P[i * ld_p + j] * ld(gh + i * s.ldr + d);
        }
        st(dk + j * s.ldr + d, ak);
        st(dv + j * s.ldr + d, av);
      }
    }
    __syncwarp();
    store_tile(y + h * D, W3, dq, s, lane);
    store_tile(y + W + h * D, W3, dk, s, lane);
    store_tile(y + 2 * W + h * D, W3, dv, s, lane);
    __syncwarp();
  }
}

// Warps per block: one per head, at most kSimtWarps, and no more than the
// shared memory holds.
int simt_warps(int H, size_t per_warp) {
  int w = H < kSimtWarps ? H : kSimtWarps;
  while (w > 1 && w * per_warp > kMaxSmem) --w;
  return w;
}

// ============================ bfloat16 route ============================

// Stages of each warp's ring: one unit computed while the next loads.  A
// third stage measured slower on the H100 (fewer warps fit per SM).
constexpr int kStages = 2;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
}

// One warp's shared memory: kStages stages of `tiles` (NP, ldt) bf16
// tiles, then (backward) four (NP, NP + 8) scratch tiles: P hi, P lo,
// dS hi, dS lo.
struct Ring {
  int NP, DP, ldt, lds;
  size_t tile, stage, scratch, warp;
  __host__ __device__ Ring(int np, int d, int tiles, bool bwd)
      : NP(np), DP((d + 15) & ~15), ldt(DP + 8), lds(np + 8),
        tile(size_t(np) * ldt * 2), stage(tiles * tile),
        scratch(bwd ? 4 * size_t(np) * lds * 2 : 0),
        warp(kStages * stage + scratch) {}
};

// How a warp's lanes cover the rows of a tile with 16-byte chunks: cpr
// chunks per row, lanes in groups of lpr (a power of two >= cpr), each
// group one row, 32 / lpr rows per pass.
struct Chunks {
  int cpr, sub, row0, rstep;
  __device__ Chunks(int D, int lane) : cpr(D / 8) {
    int shift = 0;
    while ((1 << shift) < cpr) ++shift;
    sub = lane & ((1 << shift) - 1);
    row0 = lane >> shift;
    rstep = 32 >> shift;
  }
};

// Start the copies of one unit's tiles: tile t's N rows come from global
// rows `stride` values apart starting at src[t].
template <int T>
__device__ __forceinline__ void load_unit(bf16* stage, const Ring& r,
                                          const Chunks& c, int N,
                                          const bf16* const (&src)[T],
                                          const int (&stride)[T]) {
  if (c.sub >= c.cpr) return;
#pragma unroll
  for (int t = 0; t < T; ++t)
    for (int i = c.row0; i < N; i += c.rstep)
      cp_async16(stage + t * r.NP * r.ldt + i * r.ldt + 8 * c.sub,
                 src[t] + size_t(i) * stride[t] + 8 * c.sub);
}

// 16-byte stores of an (N, D) output tile to global rows `stride` apart.
__device__ __forceinline__ void store_tile(bf16* dst, int stride,
                                           const bf16* tile, const Ring& r,
                                           const Chunks& c, int N) {
  if (c.sub >= c.cpr) return;
  for (int i = c.row0; i < N; i += c.rstep)
    *reinterpret_cast<int4*>(dst + size_t(i) * stride + 8 * c.sub) =
        *reinterpret_cast<const int4*>(tile + i * r.ldt + 8 * c.sub);
}

__device__ void zero_smem(unsigned char* p, size_t n, int lane) {
  for (size_t i = 16 * size_t(lane); i < n; i += 16 * 32)
    *reinterpret_cast<int4*>(p + i) = make_int4(0, 0, 0, 0);
}

// Transposed A fragments [m][k] of a (16*MT, 16*MT) scratch tile X:
// A[m = j][k = i] = X[i][j].
template <int MT>
__device__ __forceinline__ void a_transposed(uint32_t (&a)[MT][MT][4],
                                             const bf16* X, const Ring& r,
                                             int lane) {
  const bf16* row =
      X + ((lane & 7) + (lane >> 4) * 8) * r.lds + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int k = 0; k < MT; ++k) ldsm_t(a[m][k], row + k * 16 * r.lds + m * 16);
}

// Accumulator fragments of a float32 tile -> hi and lo bf16 scratch tiles.
template <int MT>
__device__ __forceinline__ void put_split(const float (&s)[MT][2 * MT][4],
                                          bf16* hi, bf16* lo, const Ring& r,
                                          int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < 2 * MT; ++n)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t h, l;
        split(s[m][n][2 * half], s[m][n][2 * half + 1], h, l);
        const int at = (16 * m + g + 8 * half) * r.lds + 8 * n + 2 * t;
        *reinterpret_cast<uint32_t*>(hi + at) = h;
        *reinterpret_cast<uint32_t*>(lo + at) = l;
      }
}

template <int MT>
__global__ void __launch_bounds__(32 * kMmaWarps)
    attn_fwd_mma(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                 int units, int N, int H, int D, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const Ring r(16 * MT, D, 3, false);
  unsigned char* mine = smem + (threadIdx.x >> 5) * r.warp;
  zero_smem(mine, r.warp, lane);
  __syncwarp();
  const Chunks c(D, lane);
  const int W = H * D, W3 = 3 * W;
  const int first = blockIdx.x * warps + (threadIdx.x >> 5);
  const int step = gridDim.x * warps;
  auto stage = [&](int s) {
    return reinterpret_cast<bf16*>(mine + s * r.stage);
  };
  auto load = [&](int u, int s) {
    if (u < units) {
      const int b = u / H, h = u - b * H;
      const bf16* x = qkv + size_t(b) * N * W3 + h * D;
      const bf16* const src[3] = {x, x + W, x + 2 * W};
      const int stride[3] = {W3, W3, W3};
      load_unit<3>(stage(s), r, c, N, src, stride);
    }
    cp_async_commit();
  };
  for (int s = 0; s < kStages - 1; ++s) load(first + s * step, s);
  int s = 0;
  for (int u = first; u < units; u += step) {
    load(u + (kStages - 1) * step, s == 0 ? kStages - 1 : s - 1);
    cp_async_wait_ring();
    __syncwarp();
    bf16* q = stage(s);
    const bf16* k = q + r.NP * r.ldt;
    const bf16* v = k + r.NP * r.ldt;
    float p[MT][2 * MT][4];
    product_nt<MT>(p, q, k, r, lane);
    softmax_rows<MT>(p, N, scale, lane);
    uint32_t hi[MT][MT][4], lo[MT][MT][4];
    a_fragments<MT>(p, hi, lo);
    __syncwarp();   // q is spent: the output takes its tile
    product_pv<MT>(hi, lo, v, q, r, N, D, 1.f, lane);
    __syncwarp();
    const int b = u / H, h = u - b * H;
    store_tile(out + size_t(b) * N * W + h * D, W, q, r, c, N);
    __syncwarp();   // the stage is free for the copies of a later unit
    s = s + 1 == kStages ? 0 : s + 1;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int MT>
__global__ void __launch_bounds__(32 * kMmaWarps)
    attn_bwd_mma(const bf16* __restrict__ qkv, const bf16* __restrict__ g,
                 bf16* __restrict__ dqkv, int units, int N, int H,
                 int D, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const Ring r(16 * MT, D, 4, true);
  unsigned char* mine = smem + (threadIdx.x >> 5) * r.warp;
  zero_smem(mine, r.warp, lane);
  __syncwarp();
  const Chunks c(D, lane);
  const int W = H * D, W3 = 3 * W;
  const int first = blockIdx.x * warps + (threadIdx.x >> 5);
  const int step = gridDim.x * warps;
  const int sq = r.NP * r.lds;   // one scratch tile, in values
  bf16* p_hi = reinterpret_cast<bf16*>(mine + kStages * r.stage);
  bf16* p_lo = p_hi + sq;
  bf16* s_hi = p_lo + sq;
  bf16* s_lo = s_hi + sq;
  auto stage = [&](int s) {
    return reinterpret_cast<bf16*>(mine + s * r.stage);
  };
  auto load = [&](int u, int s) {
    if (u < units) {
      const int b = u / H, h = u - b * H;
      const bf16* x = qkv + size_t(b) * N * W3 + h * D;
      const bf16* const src[4] = {x, x + W, x + 2 * W,
                                  g + size_t(b) * N * W + h * D};
      const int stride[4] = {W3, W3, W3, W};
      load_unit<4>(stage(s), r, c, N, src, stride);
    }
    cp_async_commit();
  };
  for (int s = 0; s < kStages - 1; ++s) load(first + s * step, s);
  int s = 0;
  for (int u = first; u < units; u += step) {
    load(u + (kStages - 1) * step, s == 0 ? kStages - 1 : s - 1);
    cp_async_wait_ring();
    __syncwarp();
    bf16* q = stage(s);
    bf16* k = q + r.NP * r.ldt;
    bf16* v = k + r.NP * r.ldt;
    const bf16* gh = v + r.NP * r.ldt;
    float p[MT][2 * MT][4], ds[MT][2 * MT][4];
    product_nt<MT>(p, q, k, r, lane);
    softmax_rows<MT>(p, N, scale, lane);
    product_nt<MT>(ds, gh, v, r, lane);   // dP = g v^T
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float delta = 0.f;
#pragma unroll
        for (int n = 0; n < 2 * MT; ++n)
          delta += p[m][n][2 * half] * ds[m][n][2 * half] +
                   p[m][n][2 * half + 1] * ds[m][n][2 * half + 1];
        delta += __shfl_xor_sync(0xffffffffu, delta, 1);
        delta += __shfl_xor_sync(0xffffffffu, delta, 2);
#pragma unroll
        for (int n = 0; n < 2 * MT; ++n)
#pragma unroll
          for (int e = 2 * half; e < 2 * half + 2; ++e)
            ds[m][n][e] = p[m][n][e] * (ds[m][n][e] - delta);
      }
    put_split<MT>(p, p_hi, p_lo, r, lane);
    put_split<MT>(ds, s_hi, s_lo, r, lane);
    uint32_t hi[MT][MT][4], lo[MT][MT][4];
    a_fragments<MT>(ds, hi, lo);
    __syncwarp();   // scratch written; v is spent: dq takes its tile
    product_pv<MT>(hi, lo, k, v, r, N, D, scale, lane);   // dq = dS k
    a_transposed<MT>(hi, s_hi, r, lane);
    a_transposed<MT>(lo, s_lo, r, lane);
    __syncwarp();   // k is spent: dk takes its tile
    product_pv<MT>(hi, lo, q, k, r, N, D, scale, lane);   // dk = dS^T q
    a_transposed<MT>(hi, p_hi, r, lane);
    a_transposed<MT>(lo, p_lo, r, lane);
    __syncwarp();   // q is spent: dv takes its tile
    product_pv<MT>(hi, lo, gh, q, r, N, D, 1.f, lane);    // dv = P^T g
    __syncwarp();
    const int b = u / H, h = u - b * H;
    bf16* y = dqkv + size_t(b) * N * W3 + h * D;
    store_tile(y, W3, v, r, c, N);
    store_tile(y + W, W3, k, r, c, N);
    store_tile(y + 2 * W, W3, q, r, c, N);
    __syncwarp();   // the stage is free for the copies of a later unit
    s = s + 1 == kStages ? 0 : s + 1;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A persistent launch: warps per block as many as kMmaWarps and the
// shared memory allow, blocks as many as fit on every SM at once.
struct Config {
  int warps, per_sm, sms;
  size_t smem;
};

// The Config of one kernel at one size of a warp's shared memory on the
// current device, worked out once: the attribute and occupancy calls
// would otherwise add host time to every launch, which the rollout's
// small launches feel.  The kernel's shared-memory limit only ever rises,
// so every Config worked out before stays launchable.
int persistent_config(const void* kernel, size_t per_warp, Config* out) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, size_t, int>, Config> known;
  static std::map<std::pair<const void*, int>, size_t> limit;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(kernel, per_warp, dev);
  const auto it = known.find(key);
  if (it != known.end()) {
    *out = it->second;
    return 0;
  }
  Config c{kMmaWarps, 0, 0, 0};
  while (c.warps > 1 && c.warps * per_warp > kMaxSmem) --c.warps;
  c.smem = c.warps * per_warp;
  size_t& lim = limit[std::make_pair(kernel, dev)];
  if (c.smem > lim) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)c.smem);
    if (e != cudaSuccess) return (int)e;
    lim = c.smem;
  }
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c.per_sm, kernel,
                                                      32 * c.warps, c.smem);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (c.per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  known[key] = c;
  *out = c;
  return 0;
}

// No more blocks than the units need.
int blocks_for(const Config& c, int units) {
  const int need = (units + c.warps - 1) / c.warps;
  return need < c.sms * c.per_sm ? need : c.sms * c.per_sm;
}

template <int MT>
int launch_fwd_mma(const void* qkv, void* out, int B, int N, int H, int D,
                   float scale, cudaStream_t st) {
  const int units = B * H;
  Config c;
  const int err = persistent_config((const void*)attn_fwd_mma<MT>,
                                    Ring(16 * MT, D, 3, false).warp, &c);
  if (err) return err;
  attn_fwd_mma<MT><<<blocks_for(c, units), 32 * c.warps, c.smem, st>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out), units, N, H,
      D, scale);
  return (int)cudaGetLastError();
}

template <int MT>
int launch_bwd_mma(const void* qkv, const void* g, void* dqkv, int B, int N,
                   int H, int D, float scale, cudaStream_t st) {
  const int units = B * H;
  Config c;
  const int err = persistent_config((const void*)attn_bwd_mma<MT>,
                                    Ring(16 * MT, D, 4, true).warp, &c);
  if (err) return err;
  attn_bwd_mma<MT><<<blocks_for(c, units), 32 * c.warps, c.smem, st>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(g),
      static_cast<bf16*>(dqkv), units, N, H, D, scale);
  return (int)cudaGetLastError();
}

// Also keeps B * H (the bf16 route's units), and the next unit a warp
// loads, inside int.
bool shape_ok(int B, int N, int H, int D) {
  return N >= 1 && N <= 32 && H >= 1 && D >= 8 && D <= 128 && D % 8 == 0 &&
         (long long)B * H <= (1LL << 30);
}

}  // namespace

// Pointers must be 16-byte aligned and the tensors contiguous.  Each
// entry point returns cudaGetLastError() after its launch.

// float32, the CUDA-core route.
extern "C" int short_attention_fwd_simt(const void* qkv, void* out, int B,
                                        int N, int H, int D, float scale,
                                        void* stream) {
  if (B <= 0) return 0;
  if (!shape_ok(B, N, H, D)) return (int)cudaErrorInvalidValue;
  const size_t per_warp = Slice(N, D).bytes(4, 1);
  const int warps = simt_warps(H, per_warp);
  const size_t smem = warps * per_warp;
  cudaError_t e = cudaFuncSetAttribute(
      attn_fwd_simt, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  attn_fwd_simt<<<B, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(qkv), static_cast<float*>(out), N, H, D,
      scale);
  return (int)cudaGetLastError();
}

extern "C" int short_attention_bwd_simt(const void* qkv, const void* g,
                                        void* dqkv, int B, int N, int H,
                                        int D, float scale, void* stream) {
  if (B <= 0) return 0;
  if (!shape_ok(B, N, H, D)) return (int)cudaErrorInvalidValue;
  const size_t per_warp = Slice(N, D).bytes(7, 2);
  const int warps = simt_warps(H, per_warp);
  const size_t smem = warps * per_warp;
  cudaError_t e = cudaFuncSetAttribute(
      attn_bwd_simt, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  attn_bwd_simt<<<B, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(g),
      static_cast<float*>(dqkv), N, H, D, scale);
  return (int)cudaGetLastError();
}

// bfloat16, the tensor-core route.
extern "C" int short_attention_fwd_mma(const void* qkv, void* out, int B,
                                       int N, int H, int D, float scale,
                                       void* stream) {
  if (B <= 0) return 0;
  if (!shape_ok(B, N, H, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return N <= 16 ? launch_fwd_mma<1>(qkv, out, B, N, H, D, scale, st)
                 : launch_fwd_mma<2>(qkv, out, B, N, H, D, scale, st);
}

extern "C" int short_attention_bwd_mma(const void* qkv, const void* g,
                                       void* dqkv, int B, int N, int H,
                                       int D, float scale, void* stream) {
  if (B <= 0) return 0;
  if (!shape_ok(B, N, H, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return N <= 16 ? launch_bwd_mma<1>(qkv, g, dqkv, B, N, H, D, scale, st)
                 : launch_bwd_mma<2>(qkv, g, dqkv, B, N, H, D, scale, st);
}

extern "C" const char* short_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
