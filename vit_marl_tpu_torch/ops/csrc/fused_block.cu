// Fused pre-LN transformer-block kernels for NVIDIA Hopper (sm_90a).
//
// Replace the TPU kernels of vit_marl_tpu/ops/block_kernel.py:
//
//   fused_ln_qkv      (:88, body _ln_qkv_kernel :75)       LN1(x) Wqkv + b
//   fused_proj_mlp    (:169, body _proj_mlp_kernel :141)   x1 = x + (a Wp + bp);
//                     out = x1 + (gelu(LN2(x1) W1 + b1) W2 + b2)
//   fused_block_full  (:286, body _full_block_kernel :251) the whole block:
//                     LN1, QKV, attention, projection, residual, LN2, MLP,
//                     residual
//   fused_ln_qkv_attn (:408, body _ln_qkv_attn_kernel :383)
//                     attention(LN1(x) Wqkv + b)
//
// Rows are flat token rows (B*N, W) in the compute type T (bf16 or f32);
// images are N consecutive rows.  Weights are in T in torch's Linear layout
// (out, in), row-major; LayerNorm scales and every bias are float32.
// Rounding follows the TPU bodies: LayerNorm statistics in float32 (eps
// 1e-6) and its output rounded to T before the product; products
// accumulate in float32; each bias is added in float32 before the rounding
// to T; residual adds are in T; GELU (tanh form) takes the T-rounded
// pre-activation; the attention runs in float32 from the T-rounded qkv
// and rounds its output once (attention_body.cuh, shared with
// short_attention.cu).  The plain PyTorch versions of the same functions,
// the oracles, are in vit_marl_tpu_torch/ops/block_kernel.py.
//
// Design.  The TPU kernels keep every weight in fast memory under constant
// index maps; ViT-Small's block weights are 3.5 MB in bf16, far more than
// the 227 KB of shared memory a block may use.  Here a block owns a tile
// of at most 64 rows, which stays in shared memory with its intermediates
// (LN output, qkv, attention rows, the MLP hidden) while the weights
// stream from global memory, where they stay warm in the 50 MB L2.  The
// 8 warps of a block split every product's output columns: each warp
// reads its columns' weight fragments from global memory once per tile
// and the tile's rows from shared memory.  bf16 products run on the
// tensor cores through mma.sync m16n8k16 (float32 accumulation); float32
// products are scalar FMAs.  Kernels that attend hold whole images: a
// tile is n_img images, their rows padded to a multiple of 16.  The MLP
// runs in hidden chunks of 64 or 128 columns, its output accumulated in a
// float32 tile, and the residual x1 waits in the output rows, so the
// shared-memory plan fits every supported shape (W a multiple of 64 up to
// 512, N <= 32, D a multiple of 8 up to 128, bf16 or float32): the host
// picks the largest tile, and where qkv would not fit, computes it for a
// group of heads at a time.
//
// Bound at the PPO minibatch of the ViT-Small path (B = 32,768 images,
// N = 11, W = 384, hidden 1,536, bf16), each input read once and each
// output written once at 3.35 TB/s, the bf16 products at 989 TFLOP/s and
// the float32 attention (6.1 GFLOP) at 67 TFLOP/s:
//   fused_ln_qkv       1,108 MB, 0.331 ms;   319 GFLOP, 0.322 ms
//   fused_proj_mlp       833 MB, 0.249 ms;   957 GFLOP, 0.967 ms
//   fused_block_full     557 MB, 0.166 ms; 1,276 GFLOP, 1.381 ms
//   fused_ln_qkv_attn    555 MB, 0.166 ms;   319 GFLOP, 0.413 ms
// so all but fused_ln_qkv are bound by operations (chip_smoke.py computes
// the same from the shapes).  No single PyTorch call computes any of them.
// This first version is simple rather than fast: no TMA or wgmma, no pipelining of the weight
// loads, one block per SM at the largest tiles, and every tile rereads
// the weights from L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_body.cuh"

namespace {

using attn_body::ld;
using attn_body::st;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 64;
constexpr size_t kMaxSmem = 227 * 1024;
constexpr float kEps = 1e-6f;

enum Kind { kLnQkv = 0, kProjMlp = 1, kFullBlock = 2, kLnQkvAttn = 3 };

struct Args {
  const void* x;       // (rows, W): block input; proj_mlp: attention rows
  const void* res;     // proj_mlp: the residual x (rows, W)
  const float* g1;
  const float* b1;
  const void* wqkv;    // (K, W), K = 3W for the attention kernels
  const float* bqkv;
  const void* wp;      // (W, W)
  const float* bp;
  const float* g2;
  const float* b2;
  const void* w1;      // (Hd, W)
  const float* bm1;
  const void* w2;      // (W, Hd)
  const float* bm2;
  void* out;
  int rows, W, K, Hd, N, H, D;
  float scale;
  // plan: rows per tile, images per tile, heads per qkv group, MLP chunk,
  // shared-memory offsets and size in bytes
  int rt, n_img, G, hc;
  int o_h, o_att, o_q, o_p, o_acc, smem;
};

template <typename T>
__host__ __device__ __forceinline__ int pad_ld(int w) {
  return w + int(16 / sizeof(T));   // rows padded by 16 bytes
}
__host__ __device__ __forceinline__ size_t align16(size_t n) {
  return (n + 15) & ~size_t(15);
}

__device__ __forceinline__ float rnd(float v, const float*) { return v; }
__device__ __forceinline__ float rnd(float v, const bf16*) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float gelu(float x) {   // tanh form
  const float c = 0.7978845608028654f;             // sqrt(2 / pi)
  return x * (0.5f * (1.f + tanhf(c * (x + 0.044715f * (x * x * x)))));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// LayerNorm of rows [0, n_valid) of x (rows ldx apart) into the tile out,
// rounded to T; rows [n_valid, rt) of the tile are zeroed.  One warp per
// row; float32 mean, then the mean of squared deviations.
template <typename T>
__device__ void ln_rows(const T* x, int ldx, int n_valid, int rt, int W,
                        const float* g, const float* b, T* out, int ldo) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rt; r += kWarps) {
    T* o = out + r * ldo;
    if (r >= n_valid) {
      for (int c = lane; c < W; c += 32) st(o + c, 0.f);
      continue;
    }
    const T* xr = x + size_t(r) * ldx;
    float s = 0.f;
    for (int c = lane; c < W; c += 32) s += ld(xr + c);
    const float mu = warp_sum(s) / W;
    float v = 0.f;
    for (int c = lane; c < W; c += 32) {
      const float d = ld(xr + c) - mu;
      v += d * d;
    }
    const float rstd = rsqrtf(warp_sum(v) / W + kEps);
    for (int c = lane; c < W; c += 32)
      st(o + c, ((ld(xr + c) - mu) * rstd) * g[c] + b[c]);
  }
}

// ---- products: out(r, c) = sum_k A[r][k] Wg[c][k], r < 16*MT, c < ncols;
// epi(r, c, value) receives each float32 sum once.

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t ldg32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Tensor cores: each warp takes NT n-tiles of 8 columns at a time over all
// MT m-tiles; A fragments from shared memory, B fragments straight from
// global memory (torch's (out, in) layout is mma's column-major B).
template <int MT, int NT, class Epi>
__device__ void mma_gemm(const bf16* A, int lda, const bf16* Wg, int ldw,
                         int kin, int ncols, Epi epi) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  for (int c0 = warp * 8 * NT; c0 < ncols; c0 += kWarps * 8 * NT) {
    float acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    const bf16* wrow[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      wrow[j] = Wg + size_t(c0 + 8 * j + g) * ldw + 2 * t;
#pragma unroll 2
    for (int k0 = 0; k0 < kin; k0 += 16) {
      uint32_t b[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        b[j][0] = ldg32(wrow[j] + k0);
        b[j][1] = ldg32(wrow[j] + k0 + 8);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const bf16* ar = A + (16 * i + g) * lda + k0 + 2 * t;
        const uint32_t a0 = lds32(ar), a1 = lds32(ar + 8 * lda);
        const uint32_t a2 = lds32(ar + 8), a3 = lds32(ar + 8 * lda + 8);
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma_bf16(acc[i][j], a0, a1, a2, a3, b[j][0], b[j][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int r = 16 * i + g, c = c0 + 8 * j + 2 * t;
        epi(r, c, acc[i][j][0]);
        epi(r, c + 1, acc[i][j][1]);
        epi(r + 8, c, acc[i][j][2]);
        epi(r + 8, c + 1, acc[i][j][3]);
      }
  }
}

template <int MT, class Epi>
__device__ __forceinline__ void gemm(const bf16* A, int lda, const bf16* Wg,
                                     int ldw, int kin, int ncols, Epi epi) {
  if (ncols % 32 == 0)
    mma_gemm<MT, 4>(A, lda, Wg, ldw, kin, ncols, epi);
  else
    mma_gemm<MT, 1>(A, lda, Wg, ldw, kin, ncols, epi);
}

// float32: one thread per output column over all rows, scalar FMAs, the
// tile's rows broadcast from shared memory, 16-byte loads along k.
template <int MT, class Epi>
__device__ __forceinline__ void gemm(const float* A, int lda,
                                     const float* Wg, int ldw, int kin,
                                     int ncols, Epi epi) {
  constexpr int R = 16 * MT;
  for (int c = threadIdx.x; c < ncols; c += kThreads) {
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    const float* w = Wg + size_t(c) * ldw;
    for (int k = 0; k < kin; k += 4) {
      const float4 wv = __ldg(reinterpret_cast<const float4*>(w + k));
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 av = *reinterpret_cast<const float4*>(A + r * lda + k);
        acc[r] += av.x * wv.x;
        acc[r] += av.y * wv.y;
        acc[r] += av.z * wv.z;
        acc[r] += av.w * wv.w;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) epi(r, c, acc[r]);
  }
}

// ---- block phases

// LN1 of the tile's rows, qkv for a group of heads at a time, and the
// attention of each (image, head) pair by one warp; the attention rows go
// to att (ldatt apart: a shared-memory tile or the output rows).
template <typename T, int MT>
__device__ void ln_qkv_attn_tile(const Args& a, const T* x, int n_img_valid,
                                 T* h, T* q, float* P, T* att, int ldatt) {
  const int W = a.W, N = a.N, D = a.D, ldh = pad_ld<T>(W);
  const int ldq = pad_ld<T>(3 * a.G * D);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  ln_rows<T>(x, W, n_img_valid * N, a.rt, W, a.g1, a.b1, h, ldh);
  __syncthreads();
  float* Pw = P + warp * N * (N + 1);
  for (int g0 = 0; g0 < a.H; g0 += a.G) {
    const int gc = min(a.G, a.H - g0), gd = gc * D;
    for (int part = 0; part < 3; ++part) {   // the q, k and v columns
      const int col0 = part * W + g0 * D;
      T* dst = q + part * gd;
      const float* bias = a.bqkv + col0;
      gemm<MT>(h, ldh, static_cast<const T*>(a.wqkv) + size_t(col0) * W, W,
               W, gd, [&](int r, int c, float v) {
                 st(dst + r * ldq + c, v + bias[c]);
               });
    }
    __syncthreads();
    for (int p = warp; p < n_img_valid * gc; p += kWarps) {
      const int e = p / gc, hh = p - e * gc;
      const T* qe = q + e * N * ldq + hh * D;
      attn_body::head_softmax(qe, qe + gd, ldq, ldq, N, D, a.scale, Pw,
                              lane);
      attn_body::head_pv(Pw, qe + 2 * gd, ldq, N, D,
                         att + size_t(e) * N * ldatt + (g0 + hh) * D, ldatt,
                         lane);
      __syncwarp();
    }
    __syncthreads();
  }
}

// x1 = x + round(att Wp + bp) into the output rows; h2 = LN2(x1) into the
// tile h2; the float32 MLP accumulator zeroed.
template <typename T, int MT>
__device__ void proj_ln2(const Args& a, const T* att, const T* x, T* out,
                         int n_valid, T* h2, float* acc) {
  const int W = a.W, ldt = pad_ld<T>(W);
  gemm<MT>(att, ldt, static_cast<const T*>(a.wp), W, W, W,
           [&](int r, int c, float v) {
             if (r < n_valid) {
               const size_t i = size_t(r) * W + c;
               st(out + i, ld(x + i) + rnd(v + a.bp[c], x));
             }
           });
  __syncthreads();
  ln_rows<T>(out, W, n_valid, a.rt, W, a.g2, a.b2, h2, ldt);
  for (int i = threadIdx.x; i < a.rt * (W + 4); i += kThreads) acc[i] = 0.f;
  __syncthreads();
}

// out = x1 + round(gelu(round(h2 W1 + b1)) W2 + b2), the hidden in chunks
// of hc columns; x1 is read back from the output rows.
template <typename T, int MT>
__device__ void mlp(const Args& a, const T* h2, T* hid, float* acc, T* out,
                    int n_valid) {
  const int W = a.W, Hd = a.Hd, hc = a.hc;
  const int ldt = pad_ld<T>(W), ldc = pad_ld<T>(hc), lda = W + 4;
  for (int c0 = 0; c0 < Hd; c0 += hc) {
    const float* bias = a.bm1 + c0;
    gemm<MT>(h2, ldt, static_cast<const T*>(a.w1) + size_t(c0) * W, W, W,
             hc, [&](int r, int c, float v) {
               st(hid + r * ldc + c, gelu(rnd(v + bias[c], h2)));
             });
    __syncthreads();
    gemm<MT>(hid, ldc, static_cast<const T*>(a.w2) + c0, Hd, hc, W,
             [&](int r, int c, float v) { acc[r * lda + c] += v; });
    __syncthreads();
  }
  for (int i = threadIdx.x; i < n_valid * W; i += kThreads) {
    const int r = i / W, c = i - r * W;
    st(out + i, ld(out + i) + rnd(acc[r * lda + c] + a.bm2[c], h2));
  }
}

// ---- kernels (rt = 16 * MT rows per tile)

template <typename T, int MT>
__global__ void __launch_bounds__(kThreads) ln_qkv_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* h = reinterpret_cast<T*>(smem + a.o_h);
  const int W = a.W, K = a.K, ldh = pad_ld<T>(W);
  const size_t row0 = size_t(blockIdx.x) * a.rt;
  const int n_valid = min(a.rt, int(a.rows - row0));
  ln_rows<T>(static_cast<const T*>(a.x) + row0 * W, W, n_valid, a.rt, W,
             a.g1, a.b1, h, ldh);
  __syncthreads();
  T* out = static_cast<T*>(a.out) + row0 * K;
  gemm<MT>(h, ldh, static_cast<const T*>(a.wqkv), W, W, K,
           [&](int r, int c, float v) {
             if (r < n_valid) st(out + size_t(r) * K + c, v + a.bqkv[c]);
           });
}

template <typename T, int MT>
__global__ void __launch_bounds__(kThreads) proj_mlp_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* at = reinterpret_cast<T*>(smem + a.o_h);     // attention rows, then h2
  T* hid = reinterpret_cast<T*>(smem + a.o_att);
  float* acc = reinterpret_cast<float*>(smem + a.o_acc);
  const int W = a.W, ldt = pad_ld<T>(W);
  const size_t row0 = size_t(blockIdx.x) * a.rt;
  const int n_valid = min(a.rt, int(a.rows - row0));
  const T* src = static_cast<const T*>(a.x) + row0 * W;
  for (int i = threadIdx.x; i < a.rt * W; i += kThreads) {
    const int r = i / W, c = i - r * W;
    st(at + r * ldt + c, r < n_valid ? ld(src + i) : 0.f);
  }
  __syncthreads();
  T* out = static_cast<T*>(a.out) + row0 * W;
  proj_ln2<T, MT>(a, at, static_cast<const T*>(a.res) + row0 * W, out,
                  n_valid, at, acc);
  mlp<T, MT>(a, at, hid, acc, out, n_valid);
}

template <typename T, int MT>
__global__ void __launch_bounds__(kThreads) full_block_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* h = reinterpret_cast<T*>(smem + a.o_h);       // LN1, then h2
  T* att = reinterpret_cast<T*>(smem + a.o_att);   // attention, then hidden
  T* q = reinterpret_cast<T*>(smem + a.o_q);       // qkv, then ...
  float* acc = reinterpret_cast<float*>(smem + a.o_acc);   // ... MLP sums
  float* P = reinterpret_cast<float*>(smem + a.o_p);
  const int B = a.rows / a.N, img0 = blockIdx.x * a.n_img;
  const int n_img_valid = min(a.n_img, B - img0);
  const size_t row0 = size_t(img0) * a.N;
  const T* x = static_cast<const T*>(a.x) + row0 * a.W;
  T* out = static_cast<T*>(a.out) + row0 * a.W;
  ln_qkv_attn_tile<T, MT>(a, x, n_img_valid, h, q, P, att, pad_ld<T>(a.W));
  const int n_valid = n_img_valid * a.N;
  proj_ln2<T, MT>(a, att, x, out, n_valid, h, acc);
  mlp<T, MT>(a, h, att, acc, out, n_valid);
}

template <typename T, int MT>
__global__ void __launch_bounds__(kThreads) ln_qkv_attn_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* h = reinterpret_cast<T*>(smem + a.o_h);
  T* q = reinterpret_cast<T*>(smem + a.o_q);
  float* P = reinterpret_cast<float*>(smem + a.o_p);
  const int B = a.rows / a.N, img0 = blockIdx.x * a.n_img;
  const size_t row0 = size_t(img0) * a.N;
  ln_qkv_attn_tile<T, MT>(a, static_cast<const T*>(a.x) + row0 * a.W,
                          min(a.n_img, B - img0), h, q, P,
                          static_cast<T*>(a.out) + row0 * a.W, a.W);
}

// ---- host side

// The largest tile whose shared-memory plan fits; false if none does.
template <typename T>
bool make_plan(Args& a, int kind) {
  const int W = a.W;
  auto tile = [](int rt, int w) {
    return align16(size_t(rt) * pad_ld<T>(w) * sizeof(T));
  };
  const size_t pb = align16(size_t(kWarps) * a.N * (a.N + 1) * 4);
  auto set = [&](int rt, int n_img, int G, size_t o_att, size_t o_q,
                 size_t o_p, size_t o_acc, size_t smem) {
    if (smem > kMaxSmem) return false;
    a.rt = rt; a.n_img = n_img; a.G = G;
    a.o_h = 0; a.o_att = int(o_att); a.o_q = int(o_q); a.o_p = int(o_p);
    a.o_acc = int(o_acc); a.smem = int(smem);
    return true;
  };
  if (kind == kLnQkv || kind == kProjMlp) {
    for (int rt = kMaxRows; rt >= 16; rt -= 16) {
      const size_t accb = align16(size_t(rt) * (W + 4) * 4);
      if (kind == kLnQkv ? set(rt, 0, 0, 0, 0, 0, 0, tile(rt, W))
                         : set(rt, 0, 0, tile(rt, W), 0, 0,
                               tile(rt, W) + tile(rt, a.hc),
                               tile(rt, W) + tile(rt, a.hc) + accb))
        return true;
    }
    return false;
  }
  for (int n_img = a.N <= kMaxRows ? kMaxRows / a.N : 0; n_img >= 1;
       --n_img) {
    const int rt = (n_img * a.N + 15) / 16 * 16;
    const size_t accb = align16(size_t(rt) * (W + 4) * 4);
    for (int G = a.H; G >= 1; --G) {
      const size_t qb = tile(rt, 3 * G * a.D);
      if (kind == kFullBlock) {
        const size_t o_q = 2 * tile(rt, W);
        const size_t un = qb + pb > accb ? qb + pb : accb;
        if (set(rt, n_img, G, tile(rt, W), o_q, o_q + qb, o_q, o_q + un))
          return true;
      } else {
        const size_t o_q = tile(rt, W);
        if (set(rt, n_img, G, 0, o_q, o_q + qb, 0, o_q + qb + pb))
          return true;
      }
    }
  }
  return false;
}

template <typename T, int MT>
cudaError_t launch_mt(int kind, const Args& a, int grid, cudaStream_t st) {
  void (*k)(Args) = kind == kLnQkv       ? ln_qkv_kernel<T, MT>
                    : kind == kProjMlp   ? proj_mlp_kernel<T, MT>
                    : kind == kFullBlock ? full_block_kernel<T, MT>
                                         : ln_qkv_attn_kernel<T, MT>;
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (e != cudaSuccess) return e;
  k<<<grid, kThreads, a.smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
int launch(int kind, Args a, cudaStream_t st) {
  a.hc = (a.Hd % 128 == 0 && a.W >= 128) ? 128 : 64;
  if (!make_plan<T>(a, kind)) return (int)cudaErrorInvalidValue;
  const int grid = (kind == kLnQkv || kind == kProjMlp)
                       ? (a.rows + a.rt - 1) / a.rt
                       : (a.rows / a.N + a.n_img - 1) / a.n_img;
  if (grid == 0) return 0;
  switch (a.rt / 16) {
    case 1: return (int)launch_mt<T, 1>(kind, a, grid, st);
    case 2: return (int)launch_mt<T, 2>(kind, a, grid, st);
    case 3: return (int)launch_mt<T, 3>(kind, a, grid, st);
    default: return (int)launch_mt<T, 4>(kind, a, grid, st);
  }
}

// The shapes every kernel takes (the wrappers check them first).
bool shape_ok(int kind, const Args& a) {
  if (a.rows < 0 || a.W < 64 || a.W > 512 || a.W % 64) return false;
  if (kind == kLnQkv) return a.K > 0 && a.K <= 2048 && a.K % 64 == 0;
  if (kind != kLnQkvAttn && (a.Hd <= 0 || a.Hd > 2048 || a.Hd % 64))
    return false;
  if (kind == kProjMlp) return true;
  return a.N >= 1 && a.N <= 32 && a.H >= 1 && a.W % a.H == 0 &&
         a.D == a.W / a.H && a.D % 8 == 0 && a.D <= 128 && a.rows % a.N == 0;
}

int run(int kind, Args a, int dtype, void* stream) {
  if (!shape_ok(kind, a)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(kind, a, st);
  if (dtype == 1) return launch<bf16>(kind, a, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Row tensors and weights in that type,
// LayerNorm parameters and biases float32; all contiguous and 16-byte
// aligned.  Each returns cudaGetLastError() after its launch (or
// cudaErrorInvalidValue for a shape it does not take).
extern "C" int fused_ln_qkv(const void* x, const float* g, const float* b,
                            const void* w, const float* bias, void* out,
                            int rows, int W, int K, int dtype,
                            void* stream) {
  Args a = {};
  a.x = x; a.g1 = g; a.b1 = b; a.wqkv = w; a.bqkv = bias; a.out = out;
  a.rows = rows; a.W = W; a.K = K;
  return run(kLnQkv, a, dtype, stream);
}

extern "C" int fused_proj_mlp(const void* att, const void* x, const void* wp,
                              const float* bp, const float* g2,
                              const float* b2, const void* w1,
                              const float* bm1, const void* w2,
                              const float* bm2, void* out, int rows, int W,
                              int Hd, int dtype, void* stream) {
  Args a = {};
  a.x = att; a.res = x; a.wp = wp; a.bp = bp; a.g2 = g2; a.b2 = b2;
  a.w1 = w1; a.bm1 = bm1; a.w2 = w2; a.bm2 = bm2; a.out = out;
  a.rows = rows; a.W = W; a.Hd = Hd;
  return run(kProjMlp, a, dtype, stream);
}

extern "C" int fused_block_full(const void* x, const float* g1,
                                const float* b1, const void* wqkv,
                                const float* bqkv, const void* wp,
                                const float* bp, const float* g2,
                                const float* b2, const void* w1,
                                const float* bm1, const void* w2,
                                const float* bm2, void* out, int rows, int N,
                                int H, int W, int Hd, float scale, int dtype,
                                void* stream) {
  Args a = {};
  a.x = x; a.g1 = g1; a.b1 = b1; a.wqkv = wqkv; a.bqkv = bqkv; a.wp = wp;
  a.bp = bp; a.g2 = g2; a.b2 = b2; a.w1 = w1; a.bm1 = bm1; a.w2 = w2;
  a.bm2 = bm2; a.out = out;
  a.rows = rows; a.N = N; a.H = H; a.W = W; a.D = H > 0 ? W / H : 0;
  a.Hd = Hd; a.scale = scale;
  return run(kFullBlock, a, dtype, stream);
}

extern "C" int fused_ln_qkv_attn(const void* x, const float* g,
                                 const float* b, const void* w,
                                 const float* bias, void* out, int rows,
                                 int N, int H, int W, float scale, int dtype,
                                 void* stream) {
  Args a = {};
  a.x = x; a.g1 = g; a.b1 = b; a.wqkv = w; a.bqkv = bias; a.out = out;
  a.rows = rows; a.N = N; a.H = H; a.W = W; a.D = H > 0 ? W / H : 0;
  a.scale = scale;
  return run(kLnQkvAttn, a, dtype, stream);
}

// The plan a launch would use: {rows per tile, images per tile, heads per
// qkv group, shared-memory bytes}; returns 0, or cudaErrorInvalidValue.
extern "C" int fused_block_plan(int kind, int rows, int N, int H, int W,
                                int K, int Hd, int dtype, int* plan) {
  Args a = {};
  a.rows = rows; a.N = N; a.H = H; a.W = W; a.K = K; a.Hd = Hd;
  a.D = H > 0 ? W / H : 0;
  if (kind < 0 || kind > 3 || !shape_ok(kind, a) || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  a.hc = (a.Hd % 128 == 0 && a.W >= 128) ? 128 : 64;
  const bool ok = dtype == 0 ? make_plan<float>(a, kind)
                             : make_plan<bf16>(a, kind);
  if (!ok) return (int)cudaErrorInvalidValue;
  plan[0] = a.rt; plan[1] = a.n_img; plan[2] = a.G; plan[3] = a.smem;
  return 0;
}

extern "C" const char* fused_block_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
