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
// pre-activation; the MLP's second product keeps one float32 sum over the
// whole hidden width; the attention runs from the T-rounded qkv in float32
// and rounds its output once (attention_body.cuh, shared with
// short_attention.cu; bf16 fused_ln_qkv_attn takes the tensor-core body of
// mma_attention.cuh, whose P enters P v as bf16 hi + lo).  The plain
// PyTorch versions of the same functions, the oracles, are in
// vit_marl_tpu_torch/ops/block_kernel.py.
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
// the same from the shapes; fused_ln_qkv_attn's attention on the tensor
// cores leaves the products' 0.322 ms).  No single PyTorch call computes
// any of them.
//
// Two routes, chosen by the dtype alone (one C entry point each): bf16
// takes the tensor-core kernels of namespace tc (the second half of this
// file, entry points *_tc), float32 the first design below.  Every
// accepted bf16 shape has a tc plan (tests/test_torch_block.py walks
// them), so no shape rule sends bf16 to the first design.
//
// Past 32 tokens (both dtypes) kernels 5 and 7 attend on the route of
// long_attention.cuh: their entries here take N <= 32 only, and the
// wrappers run the same function as three launches on one stream, the
// qkv staged through a global buffer: fused_ln_qkv's kernel (K = 3W),
// fused_block_long_attention (keys in tiles, online softmax), and for
// kernel 7 fused_proj_mlp's kernel.  long_attention.cuh says why.
//
// First design (all four functions, float32).  The TPU kernels keep
// every weight in fast memory under constant index maps; ViT-Small's
// block weights are 3.5 MB in bf16, far more than the 227 KB of shared
// memory a block may use.
// Here a block owns a tile of at most 64 rows, which stays in shared
// memory with its intermediates (LN output, qkv, attention rows, the MLP
// hidden) while the weights stream from global memory, where they stay
// warm in the 50 MB L2.  The 8 warps of a block split every product's
// output columns: each thread reads its column's weights from global
// memory once per tile and the tile's rows from shared memory, in scalar
// float32 FMAs.  Kernels that
// attend hold whole images: a tile is n_img images, their rows padded to
// a multiple of 16.  The MLP runs in hidden chunks of 64 or 128 columns,
// its output accumulated in a float32 tile, and the residual x1 waits in
// the output rows, so the shared-memory plan fits every supported shape
// (W a multiple of 64 up to 512, N <= 32, D a multiple of 8 up to 128):
// the host picks the largest tile, and where qkv would not fit, computes
// it for a group of heads at a time.  It is simple rather than fast: no
// pipelining of the weight loads, one block per SM at the largest tiles,
// and every tile rereads the weights from L2.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>
#include <map>
#include <mutex>
#include <tuple>

#include "attention_body.cuh"
#include "long_attention.cuh"
#include "mma_attention.cuh"

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

// The first design runs float32 only (dtype 0); bf16 is the tc route's.
int run(int kind, Args a, int dtype, void* stream) {
  if (!shape_ok(kind, a) || dtype != 0) return (int)cudaErrorInvalidValue;
  return launch<float>(kind, a, static_cast<cudaStream_t>(stream));
}

// ============== bf16 route of fused_proj_mlp and fused_block_full ==========
//
// Tensor-core kernels for Hopper (kernels 6b and 7, bf16 only), on the
// plan that block_kernel.py::wgmma_plan computes (tc::plan_ok checks it).
//
// A CTA holds a tile of 64 token rows (wgmma's M; kernel 7: the whole
// images that fit, 5 x 11 = 55 rows at ViT-Small) and runs 3 warpgroups:
// thread 0 of the first (setmaxnreg 40) is the producer, the other two
// (setmaxnreg 232) are consumers that split the output columns of every
// product in halves.  The weights never pass through registers: the
// producer copies them by TMA (tensor maps over torch's (out, in)
// layout, boxes of 64 columns x 64 or 32 rows, 128-byte swizzle) into a
// ring of `stages` slots of 64 rows x 64 columns (8 KB), with a full and
// an empty mbarrier a slot; a warpgroup's k-block of a product takes one
// slot per 64 rows, the two warpgroups' slots alternating.  A cluster of
// 2 CTAs walks its tiles together: the CTAs issue a slot's boxes in turn,
// each multicast into both, and a slot is refilled only when every
// consumer warp of the cluster has freed it; so each weight byte read
// from L2 feeds 128 tile rows (kernel 7: 110 tokens at N=11; clusters of
// 3 would feed 165, but leave 15 SMs idle, 39 clusters a wave, and ran
// 18% slower).  The grid is persistent:
// as many clusters as fit on the card walk the tiles, the producer
// running ahead across tile boundaries.
//
// Products run as wgmma m64nNk16 (N = 64, or 32 for a remainder; the
// widths are compile-time, four instantiations by W) with both operands
// in shared memory: B from the ring, A from the CTA's own bf16 tiles in
// the same swizzled layout (64 rows of 128 bytes a k-block): the
// attention rows of the tile (6b, by cp.async), LN1 (7), the attention
// rows of a head group (7; copied there by the warp that computed them),
// LN2, the GELU hidden (two buffers, one barrier a chunk).  Accumulators
// stay in registers: the projection (kernel 7: summed over head groups,
// the attention rows being its k dimension), then the MLP's float32 sum
// over the whole hidden width (128 columns a chunk); a second set holds
// a qkv part (64 columns at a time) or a hidden chunk.  A k-block's slots
// are freed as soon as its wgmmas complete (wait_group 0).  x1 and LN2
// are one epilogue: the row statistics reduce over a quad, then between
// the warpgroups through shared memory.  Biases wait in shared memory.
// Kernel 7's attention runs one warp per (image, head) on the float32
// body of attention_body.cuh, qkv in a padded tile (q, k and v slots of
// a head group (2 at ViT-Small), its output written over q.
//
// What bounds it (B = 32,768 at ViT-Small, 957 / 1,276 GFLOP in bf16):
// the tensor cores at 0.97 / 1.38 ms (with kernel 7's float32 attention
// at 67 TFLOP/s).  At 64 rows a CTA each weight byte written into shared
// memory feeds 128 FLOP: the ring's fill and the wgmma reads take about
// the shared memory's 128 bytes an SM-clock at the tensor cores' full
// rate.  Measured (tools/torch_ab_block.py --profile, PERF.md): the
// consumers spend about a third of their cycles on the CUDA-core
// epilogues (GELU, x1 + LN2) with the tensor cores idle, a fifth waiting
// for slots, and kernel 7 a fifth more on the float32 attention.

namespace tc {

constexpr int kRows = 64;           // token rows of a CTA tile: wgmma's M
constexpr int kConsumers = 256;     // two consumer warpgroups
constexpr int kThreads = 128 + kConsumers;   // after a producer warpgroup
constexpr int kProducerRegs = 40;   // setmaxnreg: 128 x 40 + 256 x 232
constexpr int kConsumerRegs = 232;  //   of the SM's 65,536 registers
constexpr int kSlotRows = 64;       // a ring slot: 64 weight rows of one
constexpr int kSlotBytes = kSlotRows * 128;   //   64-column k-block
constexpr int kKbBytes = kRows * 128;       // one 64-wide k-block of a tile
// The main accumulator (the projection, then the MLP's sum) holds
// NM = W / 4 floats a thread (64 rows x W / 2 columns over 128 threads),
// rounded up to 32: the kernels are instantiated for NM = 32, 64, 96, 128.
constexpr int kAcc2 = 32;           // floats: 64 rows x 64 columns / 128
constexpr int kAccMlp = 64;         // floats: 64 rows x 128 columns / 128
constexpr long long kSpinCycles = 1ll << 34;   // ~8 s: a lost barrier traps

// block_kernel.py::wgmma_plan, field for field; byte offsets from the
// 1024-aligned base of dynamic shared memory (the ring is at 0).
struct Plan {
  int kind, rows, images, cluster, stages, stage_bytes, head_group, slot,
      gdp, hc, hid_bufs, ldq, attn_warps, o_h, o_qkv, o_p, o_at, o_hid,
      o_bias, o_bar, smem, nc, qkv_rows;
};
constexpr int kPlanFields = sizeof(Plan) / sizeof(int);

struct Params {
  CUtensorMap tm_qkv, tm_p, tm_1, tm_2;   // (out, in) weights
  CUtensorMap tm_x, tm_out;   // 5 and 6a: block input rows; 6a: qkv rows
  const bf16* x;       // block input (5, 6a, 7) / attention rows (6b)
  const bf16* res;     // 6b: the residual x
  const float *g1, *b1, *bqkv, *bp, *g2, *b2, *bm1, *bm2;
  bf16* out;
  int rows, W, Hd, N, H, D, K;
  float scale;
  Plan p;
};

// Cycles by phase of thread 0 of each warpgroup of CTA 0, compiled in
// with -DFUSED_BLOCK_PROFILE (fused_block_profile; tools/torch_ab_block.py
// --profile): a mark(p) charges the cycles since the last mark to p.
enum Phase {
  kPhLoad, kPhWaitFull, kPhMma, kPhEpilogue, kPhSync, kPhLn2, kPhAttention,
  kPhWaitEmpty, kPhIssue, kPhWaitX, kPhases
};
#ifdef FUSED_BLOCK_PROFILE
__device__ unsigned long long g_profile[4][3][kPhases];
__device__ __forceinline__ long long now() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;\n" : "=l"(t));
  return t;
}
struct Prof {
  long long t, c[kPhases] = {};
  __device__ Prof() : t(now()) {}
  __device__ void mark(int p) {
    const long long n = now();
    c[p] += n - t;
    t = n;
  }
  __device__ void flush(int kind) {
    if (blockIdx.x == 0 && threadIdx.x % 128 == 0)
      for (int p = 0; p < kPhases; ++p)
        g_profile[kind][threadIdx.x / 128][p] = c[p];
  }
};
#else
struct Prof {
  __device__ void mark(int) {}
  __device__ void flush(int) {}
};
#endif

// ---- PTX wrappers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}

// Waits for the phase of parity `par` to complete; traps instead of
// hanging if it never does.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t par) {
  uint32_t done = 0;
  long long t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(par)
        : "memory");
    if (done) return;
    const long long t = clock64();
    if (t0 == 0) t0 = t;
    else if (t - t0 > kSpinCycles) __trap();
  }
}

// Arrive on the barrier at the same offset in CTA `cta` of the cluster.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar,
                                                    uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 ra;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n" ::
          "r"(bar), "r"(cta)
      : "memory");
}

// A TMA box (64 columns from c0, 32 rows from c1) into dst of every CTA
// in `mask`, each CTA's barrier at `bar` counting its bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* tm,
                                         int c0, int c1, uint32_t bar,
                                         uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(bar), "r"(c0), "r"(c1),
      "h"(mask)
      : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

__device__ __forceinline__ uint32_t special(int which) {
  uint32_t v;
  if (which == 0) asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(v));
  else if (which == 1) asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(v));
  else asm volatile("mov.u32 %0, %%nclusterid.x;\n" : "=r"(v));
  return v;
}

// The two consumer warpgroups (named barrier 1).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// Generic-proxy writes to shared memory, made visible to wgmma.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Shared-memory matrix descriptor: K-major, 128-byte swizzle, 8-row
// groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(64) << 32) | (uint64_t(1) << 62);
}

#define TC_F8(i)                                                  \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),     \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d(64 x 64) += A(64 x 16) B(64 x 16)^T, float32 sums.
__device__ __forceinline__ void mma_n64(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : TC_F8(0), TC_F8(8), TC_F8(16), TC_F8(24)
      : "l"(da), "l"(db), "r"(1));
}

// d(64 x 32) += A(64 x 16) B(32 x 16)^T.
__device__ __forceinline__ void mma_n32(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : TC_F8(0), TC_F8(8)
      : "l"(da), "l"(db), "r"(1));
}
// d(64 x 128) += A(64 x 16) B(128 x 16)^T: B two ring slots' worth of rows
// (a 16 KB stage of kernel 6a).
__device__ __forceinline__ void mma_n128(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, "
      "1, 0, 0;\n}\n"
      : TC_F8(0), TC_F8(8), TC_F8(16), TC_F8(24), TC_F8(32), TC_F8(40),
        TC_F8(48), TC_F8(56)
      : "l"(da), "l"(db), "r"(1));
}
#undef TC_F8

// The wgmmas of one k16 step over NC columns (a multiple of 32): an n64
// block a ring slot (sb[j]: columns 64 j on, in acc[32 j ...]), an n32
// block for a remainder.  No branch: a wgmma on a path the compiler
// cannot prove uniform is serialized.
template <int NC, int NACC, int Q>
__device__ __forceinline__ void issue(float (&acc)[NACC], uint64_t da,
                                      const uint32_t (&sb)[Q], int koff) {
  static_assert(NC % 32 == 0 && NC / 2 <= NACC && Q == (NC + 63) / 64,
                "accumulator or slots do not match the columns");
#pragma unroll
  for (int j = 0; j < NC / 64; ++j) mma_n64(&acc[32 * j], da, desc(sb[j] + koff));
  if constexpr (NC % 64 != 0)
    mma_n32(&acc[32 * (NC / 64)], da, desc(sb[NC / 64] + koff));
}

// Keeps the compiler from moving register reads or writes of acc across
// the asynchronous products.
template <int NACC>
__device__ __forceinline__ void fence_acc(float (&acc)[NACC]) {
#pragma unroll
  for (int i = 0; i < NACC; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}

template <int NACC>
__device__ __forceinline__ void zero_acc(float (&acc)[NACC]) {
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  fence_acc(acc);
}

// Rows of a TMA box for weight segments of `half` rows (a multiple of 32).
__host__ __device__ __forceinline__ int box_rows(int half) {
  return half % 64 == 0 ? 64 : 32;
}

// Byte offset of element (r, c) of a tile of 64-row k-blocks (128-byte
// rows, swizzled as TMA's 128-byte mode: 16-byte chunk ^ row % 8).
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (c >> 6) * kKbBytes + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) +
         ((c & 7) << 1);
}

__device__ __forceinline__ uint32_t pack(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}
__device__ __forceinline__ float rnd16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// GELU, tanh form, with tanh(u) = 1 - 2 / (1 + e^(2u)) on the hardware
// exponential: within about 1e-7 |x| of the form on tanhf, far below the
// bf16 rounding that follows; a fifth of the instructions.
__device__ __forceinline__ float gelu_fast(float x) {
  const float u = 0.7978845608028654f * (x + 0.044715f * (x * x * x));
  const float t = 1.f - __fdividef(2.f, 1.f + __expf(2.f * u));
  return x * (0.5f * (1.f + t));
}

// ---- the weight ring

// `stages` slots of SB bytes (kSlotBytes for 6b and 7), each with a full
// and an empty barrier.
struct Ring {
  uint32_t base, full, empty;
  int S, C, SB;
  __device__ Ring(uint32_t b, const Plan& p)
      : base(b), full(b + p.o_bar), empty(b + p.o_bar + 8 * p.stages),
        S(p.stages), C(p.cluster), SB(p.stage_bytes) {}
};

// The producer (thread 0) fills the slots in the consumers' order: a
// 64-column k-block of one warpgroup's weight rows, 64 rows a slot.
// (Four producer threads, each filling every fourth slot, measured no
// faster.)
struct Producer {
  Ring r;
  uint32_t rank, slot = 0, phase = 0, turn = 0;
  uint16_t mask;
  Prof prof;
  __device__ Producer(const Ring& ring, uint32_t rk)
      : r(ring), rank(rk), mask(uint16_t((1u << ring.C) - 1)) {}

  // One slot: 64 columns from kcol of `rows` (at most 64) weight rows from
  // row0, in the map's boxes of `box` rows; the CTAs of the cluster issue
  // the boxes in turn.
  __device__ __forceinline__ void kblock(const CUtensorMap* tm, int box,
                                         int kcol, int row0, int rows) {
    const uint32_t full = r.full + 8 * slot;
    prof.mark(kPhIssue);
    mbar_wait(r.empty + 8 * slot, phase ^ 1);
    prof.mark(kPhWaitEmpty);
    mbar_expect_tx(full, uint32_t(rows * 128));
    for (int q = 0; q < rows; q += box) {
      if (turn == rank)
        tma_load(r.base + slot * r.SB + q * 128, tm, kcol, row0 + q,
                 full, mask);
      if (++turn == uint32_t(r.C)) turn = 0;
    }
    if (++slot == uint32_t(r.S)) {
      slot = 0;
      phase ^= 1;
    }
  }

  // One product: n_kb k-blocks from column kcol0 of `rows` weight rows a
  // warpgroup, the second warpgroup's `stride` rows after the first's;
  // the two warpgroups' slots alternate.
  __device__ __forceinline__ void product(const CUtensorMap* tm, int box,
                                          int kcol0, int n_kb, int row0,
                                          int rows, int stride) {
    for (int kb = 0; kb < n_kb; ++kb)
      for (int j = 0; j < rows; j += kSlotRows)
        for (int wg = 0; wg < 2; ++wg)
          kblock(tm, box, kcol0 + 64 * kb, row0 + wg * stride + j,
                 min(kSlotRows, rows - j));
  }
};

// A consumer warpgroup: acc += A B^T over its `ncols` columns, A the
// 64-row tile at a_tile (n_kb k-blocks kKbBytes apart), B a k-block at a
// time from the ring: Q slots of 64 rows, alternating with the other
// warpgroup's (slot j of warpgroup wg is n + 2 j + wg).
struct Consumer {
  Ring r;
  int wg;
  uint32_t n = 0;   // this warpgroup's stages so far
  Prof prof;
  __device__ Consumer(const Ring& ring, int w) : r(ring), wg(w) {}

  __device__ __forceinline__ void sync() {
    consumers_sync();
    prof.mark(kPhSync);
  }

  __device__ __forceinline__ void release(uint32_t slot) {
    if ((threadIdx.x & 31) == 0)
      for (int c = 0; c < r.C; ++c) mbar_arrive_cluster(r.empty + 8 * slot, c);
  }

  // A k-block's slots are freed as soon as its wgmmas are done (keeping
  // one k-block in flight instead holds twice the slots and starves the
  // ring: slower, and a deadlock on kernel 7's smaller rings).
  template <int NC, int NACC>
  __device__ __forceinline__ void product_nc(float (&acc)[NACC],
                                             uint32_t a_tile, int n_kb) {
    constexpr int Q = (NC + 63) / 64;
    for (int kb = 0; kb < n_kb; ++kb, n += 2 * Q) {
      uint32_t sb[Q];
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        const uint32_t g = n + 2 * j + wg, slot = g % r.S;
        mbar_wait(r.full + 8 * slot, (g / r.S) & 1);
        sb[j] = r.base + slot * kSlotBytes;
      }
      __syncwarp();
      prof.mark(kPhWaitFull);
      const uint32_t ab = a_tile + kb * kKbBytes;
      wg_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k) issue<NC>(acc, desc(ab + 32 * k), sb, 32 * k);
      wg_commit();
      wg_wait<0>();
#pragma unroll
      for (int j = 0; j < Q; ++j) release((n + 2 * j + wg) % r.S);
      prof.mark(kPhMma);
    }
    fence_acc(acc);
  }

  // ncols is uniform and one of the two widths an accumulator of NACC
  // floats serves (2 NACC - 32 or 2 NACC columns: each instantiation's
  // W / 2, or 32 and 64 for the 32-float one): each case one straight
  // path of wgmmas, and the kernel's code stays small.
  template <int NACC>
  __device__ __forceinline__ void product(float (&acc)[NACC],
                                          uint32_t a_tile, int n_kb,
                                          int ncols) {
    if (ncols == 2 * NACC) product_nc<2 * NACC>(acc, a_tile, n_kb);
    else product_nc<2 * NACC - 32>(acc, a_tile, n_kb);
  }

  // The MLP's first product: a warpgroup's half of a chunk of 4 NACC,
  // 128 or 64 columns.
  template <int NACC>
  __device__ __forceinline__ void product_hidden(float (&acc)[NACC],
                                                 uint32_t a_tile, int n_kb,
                                                 int ncols) {
    if constexpr (NACC >= 64) {
      if (ncols == 128) {
        product_nc<128>(acc, a_tile, n_kb);
        return;
      }
    }
    if (ncols == 64) product_nc<64>(acc, a_tile, n_kb);
    else product_nc<32>(acc, a_tile, n_kb);
  }
};

// ---- row phases (the 8 consumer warps)

// LayerNorm of the rows of a 64-row swizzled tile t, rounded to bf16:
// rows < n_valid from load(r, c) (the pair of row r at columns c, c + 1),
// rows >= n_valid zeroed.  Warp cw of nw takes rows cw, cw + nw, ...,
// RPI at a time (their loads, then their reductions, together); float32
// mean, then the mean of squared deviations (eps 1e-6).
template <int RPI, class Load>
__device__ __forceinline__ void ln_swizzled(unsigned char* t, int W,
                                            int n_valid, const float* g,
                                            const float* b, int cw, int nw,
                                            Load load) {
  const int lane = threadIdx.x & 31;
  float2 gv[8], bv[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (64 * i < W) {
      gv[i] = *reinterpret_cast<const float2*>(g + 64 * i + 2 * lane);
      bv[i] = *reinterpret_cast<const float2*>(b + 64 * i + 2 * lane);
    }
  for (int r0 = cw; r0 < kRows; r0 += RPI * nw) {
    float2 v[RPI][8];
#pragma unroll
    for (int h = 0; h < RPI; ++h)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (64 * i < W && r0 + nw * h < n_valid)
          v[h][i] = load(r0 + nw * h, 64 * i + 2 * lane);
#pragma unroll
    for (int h = 0; h < RPI; ++h) {
      const int r = r0 + nw * h;
      if (r >= n_valid) {
        for (int c = 2 * lane; c < W; c += 64)
          *reinterpret_cast<uint32_t*>(t + swz(r, c)) = 0u;
        continue;
      }
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (64 * i < W) s += v[h][i].x + v[h][i].y;
      const float mu = warp_sum(s) / W;
      float q = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (64 * i < W) {
          const float dx = v[h][i].x - mu, dy = v[h][i].y - mu;
          q += dx * dx + dy * dy;
        }
      const float rstd = rsqrtf(warp_sum(q) / W + kEps);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (64 * i < W)
          *reinterpret_cast<uint32_t*>(t + swz(r, 64 * i + 2 * lane)) =
              pack(((v[h][i].x - mu) * rstd) * gv[i].x + bv[i].x,
                   ((v[h][i].y - mu) * rstd) * gv[i].y + bv[i].y);
    }
  }
}

// LN1 of the tile's rows x (rows < n_valid) into the swizzled tile t by
// the 8 consumer warps, rows >= n_valid zeroed.
__device__ __forceinline__ void ln_tile(unsigned char* t, const bf16* x,
                                        int W, int n_valid,
                                        const float* __restrict__ g,
                                        const float* __restrict__ b) {
  ln_swizzled<2>(t, W, n_valid, g, b, (threadIdx.x >> 5) - 4, 8,
              [&](int r, int c) {
                return unpack(*reinterpret_cast<const uint32_t*>(
                    x + size_t(r) * W + c));
              });
}

// An epilogue over this thread's accumulator, 64 columns at a time: for
// each block its bias pairs (bias[col(c)], for columns c < ncols) and,
// where res is given, its residual pairs (res rows r and r + 8, columns
// c0 + c; 0 past n_valid) are loaded together first, then f(row, c, i,
// residual pair, bias pair) runs for each pair, acc[i] and acc[i + 1].
template <int NACC, class Col, class F>
__device__ __forceinline__ void epilogue(int ncols,
                                         const float* bias,
                                         Col col, const bf16* res, int W,
                                         int c0, int n_valid, F f) {
  const int lane = threadIdx.x & 31;
  const int r = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  const int t2 = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < (NACC + 31) / 32; ++j) {
    if (64 * j >= ncols) break;
    float2 bv[8];
    uint32_t xv[16];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int c = 64 * j + 8 * k + t2;
      if (32 * j + 4 * k < NACC && c < ncols) {
        bv[k] = *reinterpret_cast<const float2*>(bias + col(c));
        if (res) {
          const bf16* p = res + size_t(r) * W + c0 + c;
          xv[2 * k] = r < n_valid ? *reinterpret_cast<const uint32_t*>(p) : 0u;
          xv[2 * k + 1] = r + 8 < n_valid
                              ? *reinterpret_cast<const uint32_t*>(p + 8 * W)
                              : 0u;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int c = 64 * j + 8 * k + t2, i = 32 * j + 4 * k;
      if (i < NACC && c < ncols) {
        f(r, c, i, xv[2 * k], bv[k]);
        f(r + 8, c, i + 2, xv[2 * k + 1], bv[k]);
      }
    }
  }
}

// The biases and LN2's scale and shift, staged in shared memory once a
// CTA: [bqkv (kernel 7) | bp | bm1 | bm2 | g2 | b2], then room for LN2's
// row statistics, [2 warpgroups][sum, squares][64 rows].
struct Biases {
  const float *qkv, *p, *m1, *m2, *g2, *b2;
  float* stats;
  __device__ Biases(float* s, const Params& a, bool qkv_too) {
    const int W = a.W, nq = qkv_too ? 3 * W : 0;
    const float* src[6] = {a.bqkv, a.bp, a.bm1, a.bm2, a.g2, a.b2};
    const int len[6] = {nq, W, a.Hd, W, W, W};
    float* d = s;
    for (int k = 0; k < 6; d += len[k], ++k)
      for (int i = threadIdx.x - 128; i < len[k]; i += kConsumers)
        d[i] = src[k][i];
    qkv = s;
    p = s + nq;
    m1 = p + W;
    m2 = m1 + a.Hd;
    g2 = m2 + W;
    b2 = g2 + W;
    stats = const_cast<float*>(b2) + W;
  }
};

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// x1 = x + round(acc + bp) into the output rows (rows < n_valid) and, as
// floats of the bf16 values, into acc; then h2 = LN2(x1), rounded, into
// the swizzled tile t (zeros past n_valid).  A row's statistics: this
// thread's columns, its quad's, then the two warpgroups' halves through
// bs.stats; the mean first, then the mean of squared deviations (eps
// 1e-6), as the plain version takes them.
template <int NM>
__device__ __forceinline__ void x1_ln2(float (&acc)[NM], const Params& a,
                                       const Biases& bs, const bf16* x,
                                       bf16* out, int n_valid,
                                       Consumer& cons, unsigned char* t) {
  const int W = a.W, wg = cons.wg, c0 = wg * (W / 2);
  epilogue<NM>(W / 2, bs.p, [&](int c) { return c0 + c; }, x, W, c0,
               n_valid, [&](int r, int c, int i, uint32_t xp, float2 b) {
                 float2 v = make_float2(0.f, 0.f);
                 if (r < n_valid) {
                   const float2 xv = unpack(xp);
                   const uint32_t u = pack(xv.x + rnd16(acc[i] + b.x),
                                           xv.y + rnd16(acc[i + 1] + b.y));
                   *reinterpret_cast<uint32_t*>(out + size_t(r) * W + c0 +
                                                c) = u;
                   v = unpack(u);
                 }
                 acc[i] = v.x;
                 acc[i + 1] = v.y;
               });
  const int lane = threadIdx.x & 31, t2 = (lane & 3) * 2;
  const int r = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  auto row_stat = [&](int which, float lo, float hi) {   // both halves
    lo = quad_sum(lo);
    hi = quad_sum(hi);
    float* s = bs.stats + which * 64;
    if ((lane & 3) == 0) {
      s[wg * 128 + r] = lo;
      s[wg * 128 + r + 8] = hi;
    }
    cons.sync();
    return make_float2(s[r] + s[128 + r], s[r + 8] + s[128 + r + 8]);
  };
  float lo = 0.f, hi = 0.f;
#pragma unroll
  for (int i = 0; i < NM; i += 4)
    if ((i >> 5) * 64 + ((i & 31) >> 2) * 8 + t2 < W / 2) {
      lo += acc[i] + acc[i + 1];
      hi += acc[i + 2] + acc[i + 3];
    }
  const float2 sum = row_stat(0, lo, hi);
  const float mu_lo = sum.x / W, mu_hi = sum.y / W;
  lo = hi = 0.f;
#pragma unroll
  for (int i = 0; i < NM; i += 4)
    if ((i >> 5) * 64 + ((i & 31) >> 2) * 8 + t2 < W / 2) {
      const float d0 = acc[i] - mu_lo, d1 = acc[i + 1] - mu_lo;
      const float d2 = acc[i + 2] - mu_hi, d3 = acc[i + 3] - mu_hi;
      lo += d0 * d0 + d1 * d1;
      hi += d2 * d2 + d3 * d3;
    }
  const float2 sq = row_stat(1, lo, hi);
  const float rs_lo = rsqrtf(sq.x / W + kEps), rs_hi = rsqrtf(sq.y / W + kEps);
#pragma unroll
  for (int i = 0; i < NM; i += 4) {
    const int c = (i >> 5) * 64 + ((i & 31) >> 2) * 8 + t2;
    if (c < W / 2) {
      const float2 g = *reinterpret_cast<const float2*>(bs.g2 + c0 + c);
      const float2 b = *reinterpret_cast<const float2*>(bs.b2 + c0 + c);
      *reinterpret_cast<uint32_t*>(t + swz(r, c0 + c)) =
          r < n_valid ? pack(((acc[i] - mu_lo) * rs_lo) * g.x + b.x,
                             ((acc[i + 1] - mu_lo) * rs_lo) * g.y + b.y)
                      : 0u;
      *reinterpret_cast<uint32_t*>(t + swz(r + 8, c0 + c)) =
          r + 8 < n_valid
              ? pack(((acc[i + 2] - mu_hi) * rs_hi) * g.x + b.x,
                     ((acc[i + 3] - mu_hi) * rs_hi) * g.y + b.y)
              : 0u;
    }
  }
}

// The MLP of the tile: h2 (swizzled, in t) -> out = x1 + round(sum +
// bm2), x1 read back from the output rows (this thread wrote them).  With
// two GELU tiles a chunk's goes to the one the last chunk did not use;
// with one, it is written once both warpgroups are done reading the last
// (a second barrier, after the first product).
template <int NM, int NA2>
__device__ __forceinline__ void mlp(float (&acc)[NM], float (&acc2)[NA2],
                                    const Params& a, const Biases& bs,
                                    Consumer& cons, unsigned char* t,
                                    unsigned char* hid, bf16* out,
                                    int n_valid) {
  const int W = a.W, hc = a.p.hc, wg = cons.wg, half = W / 2;
  const uint32_t t_addr = smem_u32(t);
  zero_acc(acc);
  for (int c0 = 0, k = 0; c0 < a.Hd; c0 += hc, ++k) {
    unsigned char* hb = hid + (k % a.p.hid_bufs) * (kRows * hc * 2);
    const int h0 = c0 + wg * (hc / 2);
    zero_acc(acc2);
    cons.product_hidden(acc2, t_addr, W / 64, hc / 2);
    if (a.p.hid_bufs == 1 && c0 > 0)
      cons.sync();   // the last chunk's second products are done
    epilogue<NA2>(hc / 2, bs.m1, [&](int c) { return h0 + c; }, nullptr, 0,
                    0, 0, [&](int r, int c, int i, uint32_t, float2 b) {
                      *reinterpret_cast<uint32_t*>(
                          hb + swz(r, wg * (hc / 2) + c)) =
                          pack(gelu_fast(rnd16(acc2[i] + b.x)),
                               gelu_fast(rnd16(acc2[i + 1] + b.y)));
                    });
    fence_async_smem();
    cons.prof.mark(kPhEpilogue);
    cons.sync();
    cons.product(acc, smem_u32(hb), hc / 64, half);
  }
  epilogue<NM>(half, bs.m2, [&](int c) { return wg * half + c; }, out, W,
               wg * half, n_valid,
               [&](int r, int c, int i, uint32_t xp, float2 b) {
                 if (r < n_valid) {
                   const float2 x1 = unpack(xp);
                   *reinterpret_cast<uint32_t*>(out + size_t(r) * W +
                                                wg * half + c) =
                       pack(x1.x + rnd16(acc[i] + b.x),
                            x1.y + rnd16(acc[i + 1] + b.y));
                 }
               });
  cons.prof.mark(kPhEpilogue);
}

// The producer's stream for one tile's MLP.
__device__ __forceinline__ void produce_mlp(Producer& pr, const Params& a) {
  const int W = a.W, hc = a.p.hc;
  for (int c0 = 0; c0 < a.Hd; c0 += hc) {
    pr.product(&a.tm_1, box_rows(hc / 2), 0, W / 64, c0, hc / 2, hc / 2);
    pr.product(&a.tm_2, box_rows(W / 2), c0, hc / 64, 0, W / 2, W / 2);
  }
}

// Cluster tiles: each cluster walks tiles t = cluster id + k clusters;
// its CTA of rank r takes CTA tile t * C + r.
struct Walk {
  int rank, first, step, n_ct;
  __device__ Walk(int n_tiles, int C)
      : rank(int(special(0))), first(int(special(1))),
        step(int(special(2))), n_ct((n_tiles + C - 1) / C) {}
};

// ---- kernel 6b: x1 = x + att Wp + bp; out = x1 + MLP(LN2(x1))

__device__ __forceinline__ void produce_proj_mlp(const Params& a,
                                                 const Ring& ring) {
  const int W = a.W;
  const Walk w((a.rows + kRows - 1) / kRows, a.p.cluster);
  Producer pr(ring, w.rank);
  for (int t = w.first; t < w.n_ct; t += w.step) {
    pr.product(&a.tm_p, box_rows(W / 2), 0, W / 64, 0, W / 2, W / 2);
    produce_mlp(pr, a);
  }
  pr.prof.flush(kProjMlp);
}

template <int NM>
__device__ __forceinline__ void consume_proj_mlp(const Params& a,
                                                 unsigned char* sm,
                                                 const Ring& ring) {
  const Plan& p = a.p;
  const int W = a.W, C = p.cluster;
  const Walk w((a.rows + kRows - 1) / kRows, C);
  Consumer cons(ring, (threadIdx.x >> 7) - 1);
  const int ct = threadIdx.x - 128;
  unsigned char* X = sm + p.o_h;
  unsigned char* hid = sm + p.o_hid;
  const Biases bs(reinterpret_cast<float*>(sm + p.o_bias), a, false);
  float acc[NM], acc2[kAccMlp];
  for (int t = w.first; t < w.n_ct; t += w.step) {
    const int tile = t * C + w.rank;
    const long long left = (long long)a.rows - (long long)tile * kRows;
    const int n_valid = left <= 0 ? 0 : (left < kRows ? int(left) : kRows);
    const size_t row0 = size_t(tile) * kRows;
    // the attention rows -> X (swizzled), zeros past n_valid
    const int cpr = W / 8;
    for (int i = ct; i < kRows * cpr; i += kConsumers) {
      const int r = i / cpr, c = (i - r * cpr) * 8;
      unsigned char* dst = X + swz(r, c);
      if (r < n_valid)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                         smem_u32(dst)),
                     "l"(a.x + (row0 + r) * W + c)
                     : "memory");
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    fence_async_smem();
    cons.prof.mark(kPhLoad);
    cons.sync();
    zero_acc(acc);
    cons.product(acc, smem_u32(X), W / 64, W / 2);
    cons.sync();   // both warpgroups are done with X
    bf16* out = a.out + row0 * W;
    x1_ln2(acc, a, bs, a.res + row0 * W, out, n_valid, cons, X);
    fence_async_smem();
    cons.prof.mark(kPhLn2);
    cons.sync();
    mlp(acc, acc2, a, bs, cons, X, hid, out, n_valid);
  }
  cons.prof.flush(kProjMlp);
}

// ---- kernel 7: the whole block

__device__ __forceinline__ void produce_full_block(const Params& a,
                                                   const Ring& ring) {
  const Plan& p = a.p;
  const int W = a.W, D = a.D, G = p.head_group, half_q = p.gdp / 2;
  const int B = a.rows / a.N;
  const Walk w((B + p.images - 1) / p.images, p.cluster);
  Producer pr(ring, w.rank);
  for (int t = w.first; t < w.n_ct; t += w.step) {
    for (int g0 = 0; g0 < a.H; g0 += G) {
      for (int part = 0; part < 3; ++part)
        for (int o = 0; o < half_q; o += 64)
          pr.product(&a.tm_qkv, box_rows(half_q), 0, W / 64,
                     part * W + g0 * D + o, min(64, half_q - o), half_q);
      pr.product(&a.tm_p, box_rows(W / 2), g0 * D, (p.slot + 63) / 64, 0,
                 W / 2, W / 2);
    }
    produce_mlp(pr, a);
  }
  pr.prof.flush(kFullBlock);
}

template <int NM>
__device__ __forceinline__ void consume_full_block(const Params& a,
                                                   unsigned char* sm,
                                                   const Ring& ring) {
  const Plan& p = a.p;
  const int W = a.W, N = a.N, D = a.D, C = p.cluster;
  const int G = p.head_group, SW = p.slot, ldq = p.ldq;
  const int half_q = p.gdp / 2;
  const int B = a.rows / N, n_img = p.images;
  const Walk w((B + n_img - 1) / n_img, C);
  const int at_kb = (SW + 63) / 64;   // the projection's k-blocks a group
  Consumer cons(ring, (threadIdx.x >> 7) - 1);
  const int wg = cons.wg, lane = threadIdx.x & 31;
  const int ct = threadIdx.x - 128, cw = ct >> 5;
  unsigned char* Ht = sm + p.o_h;
  bf16* qkv = reinterpret_cast<bf16*>(sm + p.o_qkv);
  float* Pw = reinterpret_cast<float*>(sm + p.o_p) + cw * N * (N + 1);
  unsigned char* AT = sm + p.o_at;
  unsigned char* hid = sm + p.o_hid;
  const Biases bs(reinterpret_cast<float*>(sm + p.o_bias), a, true);
  float acc[NM], acc2[kAcc2];
  for (int t = w.first; t < w.n_ct; t += w.step) {
    const int tile = t * C + w.rank;
    const int img0 = tile * n_img;
    const int n_img_valid = max(0, min(n_img, B - min(B, img0)));
    const int n_valid = n_img_valid * N;
    const size_t row0 = size_t(min(B, img0)) * N;
    const bf16* x = a.x + row0 * W;
    ln_tile(Ht, x, W, n_valid, a.g1, a.b1);
    fence_async_smem();
    cons.prof.mark(kPhLoad);
    cons.sync();
    zero_acc(acc);
    for (int g0 = 0; g0 < a.H; g0 += G) {
      const int gd = min(G, a.H - g0) * D;   // this group's valid columns
      // q, k and v of the group, each in products of at most 64 of a
      // warpgroup's columns (its half of the group's gdp)
      for (int part = 0; part < 3; ++part)
        for (int o = 0; o < half_q; o += 64) {
          const int wc0 = wg * half_q + o;
          const float* bqkv = bs.qkv + part * W;
          zero_acc(acc2);
          cons.product(acc2, smem_u32(Ht), W / 64, min(64, half_q - o));
          epilogue<kAcc2>(
              min(64, half_q - o), bqkv,
              [&](int c) { return wc0 + c < gd ? g0 * D + wc0 + c : 0; },
              nullptr, 0, 0, 0, [&](int r, int c, int i, uint32_t, float2 b) {
                if (wc0 + c < gd)
                  *reinterpret_cast<uint32_t*>(qkv + r * ldq + part * SW +
                                               wc0 + c) =
                      pack(acc2[i] + b.x, acc2[i + 1] + b.y);
              });
          cons.prof.mark(kPhEpilogue);
        }
      cons.sync();   // the group's qkv is in the tile
      const int gh = gd / D, units = n_img_valid * gh;
      if (cw < p.attn_warps)
        for (int u = cw; u < units; u += p.attn_warps) {
          const int e = u / gh, hh = u - e * gh;
          bf16* qe = qkv + e * N * ldq + hh * D;
          attn_body::head_softmax(qe, qe + SW, ldq, ldq, N, D, a.scale, Pw,
                                  lane);
          attn_body::head_pv(Pw, qe + 2 * SW, ldq, N, D, qe, ldq, lane);
          __syncwarp();
          const int cpr = D / 8;
          for (int i = lane; i < N * cpr; i += 32) {
            const int rr = i / cpr, c = hh * D + (i - rr * cpr) * 8;
            const int r = e * N + rr;
            *reinterpret_cast<uint4*>(AT + swz(r, c)) =
                *reinterpret_cast<const uint4*>(qkv + r * ldq + c);
          }
          __syncwarp();
        }
      const int per = (64 * at_kb - gd) / 8;   // zeros past the group's heads
      for (int i = ct; i < kRows * per; i += kConsumers) {
        const int r = i / per, c = gd + (i - r * per) * 8;
        *reinterpret_cast<uint4*>(AT + swz(r, c)) = make_uint4(0, 0, 0, 0);
      }
      fence_async_smem();
      cons.prof.mark(kPhAttention);
      cons.sync();   // the group's attention rows are in AT
      cons.product(acc, smem_u32(AT), at_kb, W / 2);
    }
    bf16* out = a.out + row0 * W;
    x1_ln2(acc, a, bs, x, out, n_valid, cons, Ht);
    fence_async_smem();
    cons.prof.mark(kPhLn2);
    cons.sync();
    mlp(acc, acc2, a, bs, cons, Ht, hid, out, n_valid);
  }
  cons.prof.flush(kFullBlock);
}

// ---- kernels 6a and 5 (bf16): LN1(x) Wqkv + b, and its attention
//
// Replace vit_marl_tpu/ops/block_kernel.py::fused_ln_qkv (:88) and
// fused_ln_qkv_attn (:408) on the bf16 route.  A CTA tile holds 128
// token rows (kernel 5: the whole images that fit, 11 x 11 = 121 at
// ViT-Small); each consumer warpgroup owns 64 of them and computes every
// output column for them, so each ring stage (nc weight rows of a
// 64-column k-block) feeds both warpgroups and, multicast to the cluster
// of 2, 256 tile rows a weight fetch from L2.  The block input comes by
// TMA (boxes of 64 x 64, zeros past the last row) into the warpgroup's
// A tile, in the swizzled layout the wgmmas read, and LN1 runs there in
// place; the next tile's input is loaded a k-block at a time as the last
// chunk's products finish reading the A tile.  Products are wgmma
// m64n128k16 (6a) or m64n64k16 (5) with both operands in shared memory,
// a chunk of nc output columns at a time, into one accumulator set while
// the epilogue of the previous chunk runs from the other (after the
// chunk's first two k-blocks are issued).  6a's epilogue adds the
// bias, rounds and stages the chunk (swizzled) for TMA stores, which
// clip the ragged last tile and K.  Kernel 5's writes q, k and v of a
// head group into the group's qkv tile (a head's columns padded to 16,
// the padding zeros); after the group's v, the attention of each (image,
// head) runs on the tensor cores (mma_attention.cuh), its output written
// over q and copied out in 16-byte rows.  Where no 128-row plan fits
// (large W x D), kernel 5 takes 64-row tiles and one consumer warpgroup.
//
// What bounds them (B = 32,768, ViT-Small): the tensor cores at 0.32 ms
// for both, and 6a's 1,108 MB at 0.33 ms.  Shared memory comes close:
// each k16 step of a warpgroup reads A (2 KB) and B (nc x 32 bytes), and
// the ring's fill, the output staging and LN1 add about half as much
// again, near its 128 bytes an SM-clock at the tensor cores' full rate.
// Measured (tools/torch_ab_block.py --profile, --ablate; PERF.md): both
// warpgroups run LN1 at each tile's start with the tensor cores idle
// (the ring they share lets neither run ahead), about a quarter of 6a's
// time and an eighth of 5's; the epilogues and kernel 5's attention stop
// them at each chunk and head group; a quarter goes to waits for weight
// slots.  Tried and slower: LN1 two or four rows a warp at a time (the
// consumers' code is compiled for 168 registers), from global memory,
// chunks of 64 columns for 6a, 64-row tiles, stores straight from the
// accumulators, images of each warpgroup its own in kernel 5, an L2
// prefetch of the next tile's input, the warpgroups' epilogues staggered.

__host__ __device__ __forceinline__ int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// CTA tiles of a kind: 6a and 6b rows of p.rows, 5 and 7 whole images.
__host__ __device__ __forceinline__ int n_tiles(int kind, const Params& a) {
  if (kind == kLnQkv || kind == kProjMlp)
    return (a.rows + a.p.rows - 1) / a.p.rows;
  return (a.rows / a.N + a.p.images - 1) / a.p.images;
}

// Named barrier of one consumer warpgroup (ids 2 and 3), and of the n
// active consumer threads (id 1).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}
__device__ __forceinline__ void active_sync(int n) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(n) : "memory");
}

// A TMA box (64 columns from c0, 64 rows from c1) into this CTA alone.
__device__ __forceinline__ void tma_load_own(uint32_t dst,
                                             const CUtensorMap* tm, int c0,
                                             int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// A TMA box from shared memory to global memory, clipped at the tensor's
// edges; bulk_wait_read: the issued boxes have left shared memory.
__device__ __forceinline__ void tma_store(const CUtensorMap* tm, int c0,
                                          int c1, uint32_t src) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, "
      "%3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(tm)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The wgmmas of one k16 step over one ring stage of NC weight rows.
template <int NC>
__device__ __forceinline__ void issue_nc(float (&acc)[NC / 2], uint64_t da,
                                         uint64_t db) {
  if constexpr (NC == 128) mma_n128(acc, da, db);
  else mma_n64(acc, da, db);
}

// A warp frees a ring slot in every CTA of the cluster.
__device__ __forceinline__ void release_slot(const Ring& r, uint32_t slot) {
  if ((threadIdx.x & 31) == 0)
    for (int c = 0; c < r.C; ++c) mbar_arrive_cluster(r.empty + 8 * slot, c);
}

// A tile's output columns in chunks of NC weight rows, one ring stage a
// 64-column k-block, in the order the producer streams them and the
// consumers compute them.  6a: columns c0 = 0, NC, ... of K (rows past K
// read as zeros).  5: for each head group (g0 on, gd() = its heads' D
// columns a part), its q, k and v parts, each in pieces of 64 columns
// (o = 0, 64, ...; columns past gd() are computed and dropped).
template <int KIND>
struct Chunks {
  int W, D, H, G, K, NC;
  int c0 = 0, g0 = 0, part = 0, o = 0;
  __device__ explicit Chunks(const Params& a)
      : W(a.W), D(a.D), H(a.H), G(a.p.head_group), K(a.K), NC(a.p.nc) {}
  __device__ bool done() const { return KIND == kLnQkv ? c0 >= K : g0 >= H; }
  __device__ int gd() const { return min(G, H - g0) * D; }
  __device__ int row() const {
    return KIND == kLnQkv ? c0 : part * W + g0 * D + o;
  }
  __device__ bool group_end() const {
    return KIND == kLnQkvAttn && part == 2 && o + 64 >= gd();
  }
  __device__ void next() {
    if (KIND == kLnQkv) {
      c0 += NC;
    } else if ((o += 64) >= gd()) {
      o = 0;
      if (++part == 3) {
        part = 0;
        g0 += G;
      }
    }
  }
};

template <int KIND>
__device__ __forceinline__ void produce_qkv(const Params& a,
                                            const Ring& ring) {
  const Walk w(n_tiles(KIND, a), a.p.cluster);
  Producer pr(ring, w.rank);
  for (int t = w.first; t < w.n_ct; t += w.step)
    for (Chunks<KIND> c(a); !c.done(); c.next())
      for (int kb = 0; kb < a.W / 64; ++kb)
        pr.kblock(&a.tm_qkv, 64, 64 * kb, c.row(), a.p.nc);
  pr.prof.flush(KIND);
}

// The tile layout mma_attention.cuh reads q, k and v in.
struct HeadTiles {
  int NP, DP, ldt;
};

// A consumer warpgroup of kernels 6a and 5 (p.rows / 64 of them active).
// It owns rows 64 wg on of the CTA's tile and computes every output
// column for them; the warpgroups share the ring, and in kernel 5, whose
// images straddle them, meet at each head group's attention.  Per tile:
// LN1 in place over the block input, which TMA brought into the A tile a
// k-block at a time as the tile before finished reading it; then each
// chunk's products into nxt, the epilogue of the chunk before running
// from cur once the chunk's first two k-blocks are issued, and a head
// group's attention with it.  A k-block's slot is freed as soon as its
// wgmmas are done.
template <int KIND, int NC, int MT>
__device__ __forceinline__ void consume_qkv(const Params& a,
                                            unsigned char* sm,
                                            const Ring& ring) {
  constexpr int NA = NC / 2;   // accumulator floats a thread
  const Plan& p = a.p;
  const int W = a.W, N = a.N, D = a.D, n_kb = W / 64;
  const int n_wg = p.rows / kRows, n_act = 128 * n_wg;
  const int wg = (threadIdx.x >> 7) - 1, wi = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, ct = threadIdx.x - 128;
  const int r_acc = wi * 16 + (lane >> 2), t2 = (lane & 3) * 2;
  const bool lead = (threadIdx.x & 127) == 0;
  if (wg >= n_wg) return;
  // [bqkv, zeros to nb | g1 | b1]
  const int nb = KIND == kLnQkv ? round_up(a.K, NC) : 3 * W;
  float* bias = reinterpret_cast<float*>(sm + p.o_bias);
  for (int i = ct; i < nb + 2 * W; i += n_act)
    bias[i] = i < a.K ? a.bqkv[i]
              : i < nb ? 0.f
              : i < nb + W ? a.g1[i - nb] : a.b1[i - nb - W];
  bf16* qkv = reinterpret_cast<bf16*>(sm + p.o_qkv);
  const int ldq = p.ldq, sl = p.slot, DP = round_up(D, 16);
  if (KIND == kLnQkvAttn)   // the heads' padding columns and rows stay 0
    for (int i = ct; i < p.qkv_rows * ldq / 8; i += n_act)
      reinterpret_cast<uint4*>(qkv)[i] = make_uint4(0, 0, 0, 0);
  active_sync(n_act);
  const float* g1 = bias + nb;
  const float* b1 = g1 + W;
  bf16* qkv_w = qkv + wg * kRows * ldq;   // this warpgroup's rows
  unsigned char* At = sm + p.o_h + wg * (kRows * W * 2);
  const uint32_t a_addr = smem_u32(At);
  const uint32_t xbar = ring.full + 16 * p.stages + 8 * wg;
  const Walk w(n_tiles(KIND, a), p.cluster);
  Prof prof;
  // A tile's rows: this warpgroup's first (row0) and how many (nv); in
  // kernel 5 the CTA's images (n_img, an rows from arow0).
  struct Rows {
    size_t row0, arow0;
    int nv, an, n_img;
  };
  auto rows_of = [&](int t) {
    const int tile = t * p.cluster + w.rank;
    Rows r{0, 0, 0, 0, 0};
    if (KIND == kLnQkv) {
      const long long first = (long long)tile * p.rows + wg * kRows;
      r.row0 = size_t(first);
      r.nv = int(max(0LL, min((long long)kRows, (long long)a.rows - first)));
    } else {
      const int B = a.rows / N, img0 = tile * p.images;
      r.n_img = max(0, min(p.images, B - min(B, img0)));
      r.arow0 = size_t(min(B, img0)) * N;
      r.an = r.n_img * N;
      r.row0 = r.arow0 + wg * kRows;
      r.nv = max(0, min(kRows, r.an - wg * kRows));
    }
    return r;
  };
  float cur[NA], nxt[NA];
  // The epilogue of chunk c from cur.  6a: bias, rounding, the chunk
  // staged (swizzled) and stored by TMA.  5: bias and rounding into the
  // group's qkv tile; after a group's v, the attention of each (image,
  // head), one warp a unit, written over q, then copied out in 16-byte
  // rows.
  auto finish = [&](const Chunks<KIND>& c, const Rows& cr) {
    fence_acc(cur);
    if constexpr (KIND == kLnQkv) {
      unsigned char* st = sm + p.o_qkv + wg * (kRows * NC * 2);
      const uint32_t st_addr = smem_u32(st);
      if (lead) bulk_wait_read();
      wg_sync(wg);
#pragma unroll
      for (int j = 0; j < NC / 8; ++j) {
        const int col = 8 * j + t2;
        const float2 b = *reinterpret_cast<const float2*>(bias + c.c0 + col);
        *reinterpret_cast<uint32_t*>(st + swz(r_acc, col)) =
            pack(cur[4 * j] + b.x, cur[4 * j + 1] + b.y);
        *reinterpret_cast<uint32_t*>(st + swz(r_acc + 8, col)) =
            pack(cur[4 * j + 2] + b.x, cur[4 * j + 3] + b.y);
      }
      fence_async_smem();
      wg_sync(wg);
      if (lead) {
        if (cr.nv > 0)
          for (int h = 0; h < NC / 64; ++h)
            if (c.c0 + 64 * h < a.K)
              tma_store(&a.tm_out, c.c0 + 64 * h, int(cr.row0),
                        st_addr + h * kKbBytes);
        bulk_commit();
      }
      prof.mark(kPhEpilogue);
    } else {
      const int gd = c.gd();
      const float* bq = bias + c.part * W + c.g0 * D;
#pragma unroll
      for (int j = 0; j < NC / 8; ++j) {
        const int col = c.o + 8 * j + t2;   // column of the part
        if (col < gd) {
          const int hh = col / D;
          bf16* dst = qkv_w + c.part * sl + hh * DP + (col - hh * D);
          const float2 b = *reinterpret_cast<const float2*>(bq + col);
          *reinterpret_cast<uint32_t*>(dst + r_acc * ldq) =
              pack(cur[4 * j] + b.x, cur[4 * j + 1] + b.y);
          *reinterpret_cast<uint32_t*>(dst + (r_acc + 8) * ldq) =
              pack(cur[4 * j + 2] + b.x, cur[4 * j + 3] + b.y);
        }
      }
      prof.mark(kPhEpilogue);
      if (c.group_end()) {
        active_sync(n_act);   // the group's q, k and v are in the tile
        prof.mark(kPhSync);
        const int gh = gd / D, units = cr.n_img * gh;
        const HeadTiles ht{16 * MT, DP, ldq};
        for (int u = ct >> 5; u < units; u += n_act >> 5) {
          const int e = u / gh, hh = u - e * gh;
          bf16* q = qkv + e * N * ldq + hh * DP;
          float s[MT][2 * MT][4];
          mma_attn::product_nt<MT>(s, q, q + sl, ht, lane);
          mma_attn::softmax_rows<MT>(s, N, a.scale, lane);
          uint32_t hi[MT][MT][4], lo[MT][MT][4];
          mma_attn::a_fragments<MT>(s, hi, lo);
          __syncwarp();
          mma_attn::product_pv<MT>(hi, lo, q + 2 * sl, q, ht, N, D, 1.f,
                                   lane);
          __syncwarp();
        }
        active_sync(n_act);   // the group's attention rows are over q
        prof.mark(kPhAttention);
        const int cpr = gd / 8;
        for (int i = ct; i < cr.an * cpr; i += n_act) {
          const int rr = i / cpr, c8 = (i - rr * cpr) * 8, hh = c8 / D;
          *reinterpret_cast<uint4*>(a.out + (cr.arow0 + rr) * W + c.g0 * D +
                                    c8) =
              *reinterpret_cast<const uint4*>(qkv + rr * ldq + hh * DP +
                                              (c8 - hh * D));
        }
        active_sync(n_act);   // q is free for the next group
        prof.mark(kPhEpilogue);
      }
    }
  };
  uint32_t n = 0, xph = 0;   // ring stages consumed; A tiles loaded
  Rows cr{0, 0, 0, 0, 0}, nr{0, 0, 0, 0, 0};
  if (w.first < w.n_ct) {
    nr = rows_of(w.first);
    if (lead && nr.nv > 0) {
      mbar_expect_tx(xbar, uint32_t(n_kb * kKbBytes));
      for (int kb = 0; kb < n_kb; ++kb)
        tma_load_own(a_addr + kb * kKbBytes, &a.tm_x, 64 * kb,
                     int(nr.row0), xbar);
    }
  }
  for (int t = w.first; t < w.n_ct; t += w.step) {
    cr = nr;
    const bool more = t + w.step < w.n_ct;
    if (more) nr = rows_of(t + w.step);
    if (cr.nv > 0) mbar_wait(xbar, xph++ & 1);
    prof.mark(kPhWaitX);
    // a row at a time: two or four together measured slower
    ln_swizzled<1>(At, W, cr.nv, g1, b1, wi, 4, [&](int r, int c) {
      return unpack(*reinterpret_cast<const uint32_t*>(At + swz(r, c)));
    });
    fence_async_smem();
    wg_sync(wg);
    prof.mark(kPhLoad);
    Chunks<KIND> c(a), prev(a);
    bool have_prev = false;
#pragma unroll 1
    for (; !c.done(); c.next()) {
      Chunks<KIND> after = c;
      after.next();
      // the A tile's last products: the next tile's input follows them in
      const bool refill = after.done() && more && nr.nv > 0;
      if (refill && lead) mbar_expect_tx(xbar, uint32_t(n_kb * kKbBytes));
      zero_acc(nxt);
      for (int kb = 0; kb < n_kb; ++kb, ++n) {
        const uint32_t slot = n % ring.S;
        mbar_wait(ring.full + 8 * slot, (n / ring.S) & 1);
        prof.mark(kPhWaitFull);
        const uint32_t sb = ring.base + slot * ring.SB;
        const uint32_t ab = a_addr + kb * kKbBytes;
        wg_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k)
          issue_nc<NC>(nxt, desc(ab + 32 * k), desc(sb + 32 * k));
        wg_commit();
        // the last chunk's epilogue under this chunk's first k-blocks
        if (kb == min(1, n_kb - 1) && have_prev) finish(prev, cr);
        wg_wait<0>();
        release_slot(ring, slot);
        prof.mark(kPhMma);
        if (refill) {   // k-block kb of the A tile is read
          wg_sync(wg);
          if (lead)
            tma_load_own(ab, &a.tm_x, 64 * kb, int(nr.row0), xbar);
        }
      }
      fence_acc(nxt);
#pragma unroll
      for (int i = 0; i < NA; ++i) cur[i] = nxt[i];
      prev = c;
      have_prev = true;
    }
    if (have_prev) finish(prev, cr);
  }
  if (KIND == kLnQkv && lead) bulk_wait();
  prof.flush(KIND);
}

template <int KIND, int NC, int MT>
__global__ void __launch_bounds__(kThreads, 1)
    qkv_kernel(const __grid_constant__ Params a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const Ring ring(smem_u32(sm), a.p);
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.p.stages; ++s) {
      mbar_init(ring.full + 8 * s, 1);
      mbar_init(ring.empty + 8 * s, 4 * (a.p.rows / kRows) * a.p.cluster);
    }
    for (int wg = 0; wg < 2; ++wg)   // the A tiles' block-input loads
      mbar_init(ring.full + 16 * a.p.stages + 8 * wg, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) produce_qkv<KIND>(a, ring);
    __syncwarp();
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    consume_qkv<KIND, NC, MT>(a, sm, ring);
  }
  cluster_sync();
}

template <int KIND, int NM>
__global__ void __launch_bounds__(kThreads, 1)
    tc_kernel(const __grid_constant__ Params a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const Ring ring(smem_u32(sm), a.p);
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.p.stages; ++s) {
      mbar_init(ring.full + 8 * s, 1);
      mbar_init(ring.empty + 8 * s, 4 * a.p.cluster);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();   // every CTA's barriers exist before any copy or arrival
  // Each role's code lies under its own setmaxnreg, nothing after the
  // split but the cluster barrier.
  if (threadIdx.x < 128) {   // the producer warpgroup: thread 0 issues
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      if constexpr (KIND == kProjMlp) produce_proj_mlp(a, ring);
      else produce_full_block(a, ring);
    }
    __syncwarp();
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    if constexpr (KIND == kProjMlp) consume_proj_mlp<NM>(a, sm, ring);
    else consume_full_block<NM>(a, sm, ring);
  }
  cluster_sync();   // no CTA leaves while a peer may still signal it
}

// ---- host side

using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);

EncodeFn encode_fn() {
  static EncodeFn fn = nullptr;
  static std::once_flag once;
  std::call_once(once, [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeFn>(f);
  });
  return fn;
}

// A (rows, cols) bf16 weight, read in segments of `half` rows: boxes of
// 64 columns x box_rows(half) rows, 128-byte swizzle, zeros past its
// edges.
bool weight_map(CUtensorMap* m, const void* w, int rows, int cols,
                int half) {
  const EncodeFn enc = encode_fn();
  if (!enc) return false;
  const cuuint64_t dim[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  const cuuint64_t stride[1] = {cuuint64_t(cols) * 2};
  const cuuint32_t box[2] = {64, cuuint32_t(box_rows(half))};
  const cuuint32_t es[2] = {1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w),
             dim, stride, box, es, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The checks the C entry makes of a plan it is given (it derives none).
bool plan_ok(const Plan& p, int kind, const Params& a) {
  const int W = a.W, hc = p.hc;
  if (p.kind != kind || p.rows != kRows || p.cluster < 1 || p.cluster > 4)
    return false;
  if (p.stage_bytes != kSlotBytes) return false;
  if ((hc != 64 && hc != 128 && hc != 256) || a.Hd % hc ||
      (kind == kFullBlock && hc > 2 * kAcc2 * 2) || p.hid_bufs < 1 ||
      p.hid_bufs > 2)
    return false;
  int need = max(W / 2, hc / 2);   // weight rows of a warpgroup's k-block
  int end_at = p.o_h + kKbBytes * (W / 64);
  if (p.o_h < p.stages * p.stage_bytes || p.o_h % 1024) return false;
  if (kind == kProjMlp) {
    if (p.o_hid < end_at || p.o_hid % 1024) return false;
    end_at = p.o_hid + p.hid_bufs * kRows * hc * 2;
  } else {
    const int G = p.head_group, gd = G * a.D;
    if (G < 1 || G > a.H || p.images < 1 || p.images * a.N > kRows)
      return false;
    if (p.slot != round_up(gd, 16) || p.gdp != round_up(gd, 64) ||
        p.gdp > 192 || p.ldq < 3 * p.slot || p.ldq % 8)
      return false;
    const int pbytes = p.attn_warps * a.N * (a.N + 1) * 4;
    if (p.attn_warps < 1 || p.attn_warps > 8) return false;
    if (p.o_qkv < end_at || p.o_qkv % 1024 || p.o_hid != p.o_qkv ||
        p.o_p < p.o_qkv + kRows * p.ldq * 2 || p.o_p % 16 ||
        p.o_at < p.o_p + pbytes ||
        p.o_at < p.o_hid + p.hid_bufs * kRows * hc * 2 ||
        p.o_at % 1024)
      return false;
    end_at = p.o_at + kKbBytes * ((p.slot + 63) / 64);
  }
  const int n_bias = 4 * W + a.Hd + (kind == kFullBlock ? 3 * W : 0) + 256;
  if (p.o_bias < end_at || p.o_bias % 16) return false;
  end_at = p.o_bias + 4 * n_bias;
  return p.stages >= 2 * ((need + kSlotRows - 1) / kSlotRows) &&
         p.o_bar >= end_at && p.o_bar % 8 == 0 &&
         p.smem >= p.o_bar + 16 * p.stages + 1024 &&
         p.smem <= int(kMaxSmem);
}

// The same for kernels 6a and 5 (K = 3W for 5).
bool plan_ok_qkv(const Plan& p, int kind, const Params& a) {
  const int W = a.W, nc = p.nc, n_wg = p.rows / kRows;
  if (p.kind != kind || (p.rows != 64 && p.rows != 128) || p.cluster < 1 ||
      p.cluster > 4)
    return false;
  if ((kind == kLnQkv ? nc != 64 && nc != 128 : nc != 64) ||
      p.stage_bytes != nc * 128 || p.stages < 3)
    return false;
  if (p.o_h < p.stages * p.stage_bytes || p.o_h % 1024) return false;
  int end_at = p.o_h + p.rows * W * 2, n_bias;
  if (kind == kLnQkv) {   // the output staging: 64 rows x nc a warpgroup
    if (p.o_qkv < end_at || p.o_qkv % 1024) return false;
    end_at = p.o_qkv + n_wg * kRows * nc * 2;
    n_bias = round_up(a.K, nc) + 2 * W;
  } else {   // the qkv tile of a head group
    const int DP = round_up(a.D, 16), NP = a.N <= 16 ? 16 : 32;
    const int G = p.head_group;
    if (p.images < 1 || p.images * a.N > p.rows || G < 1 || G > a.H ||
        p.slot != G * DP || p.ldq < 3 * p.slot || p.ldq % 8 ||
        p.qkv_rows < max(p.rows, (p.images - 1) * a.N + NP))
      return false;
    if (p.o_qkv < end_at || p.o_qkv % 16) return false;
    end_at = p.o_qkv + p.qkv_rows * p.ldq * 2;
    n_bias = 5 * W;
  }
  if (p.o_bias < end_at || p.o_bias % 16) return false;
  end_at = p.o_bias + 4 * n_bias;
  return p.o_bar >= end_at && p.o_bar % 8 == 0 &&
         p.smem >= p.o_bar + 16 * p.stages + 16 + 1024 &&
         p.smem <= int(kMaxSmem);
}

// The instantiation for width W (NM = W / 4 rounded up to 32).
template <int KIND>
void (*kernel_for(int W))(Params) {
  const int nm = (W / 4 + 31) / 32 * 32;
  return nm <= 32 ? tc_kernel<KIND, 32>
         : nm <= 64 ? tc_kernel<KIND, 64>
         : nm <= 96 ? tc_kernel<KIND, 96>
                    : tc_kernel<KIND, 128>;
}

// The tc kernel of any kind under its plan (5: by the tokens' mma tiles).
void (*tc_kernel_for(int kind, const Params& a))(Params) {
  switch (kind) {
    case kLnQkv:
      return a.p.nc == 128 ? qkv_kernel<kLnQkv, 128, 1>
                           : qkv_kernel<kLnQkv, 64, 1>;
    case kProjMlp: return kernel_for<kProjMlp>(a.W);
    case kFullBlock: return kernel_for<kFullBlock>(a.W);
    default:
      return a.N <= 16 ? qkv_kernel<kLnQkvAttn, 64, 1>
                       : qkv_kernel<kLnQkvAttn, 64, 2>;
  }
}

bool plan_fits(int kind, const Params& a) {
  return kind == kLnQkv || kind == kLnQkvAttn ? plan_ok_qkv(a.p, kind, a)
                                              : plan_ok(a.p, kind, a);
}

cudaError_t launch(int kind, const Params& a, int* clusters_out,
                   cudaStream_t st) {
  void (*k)(Params) = tc_kernel_for(kind, a);
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, a.p.smem);
  if (e != cudaSuccess) return e;
  const int C = a.p.cluster;
  int dev = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = a.p.smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // clusters resident at once, per (device, kernel, cluster, smem)
  static std::mutex mu;
  static std::map<std::tuple<int, void*, int, int>, int> cache;
  const auto key = std::make_tuple(dev, (void*)k, C, a.p.smem);
  int fit = 0;
  {
    std::lock_guard<std::mutex> lock(mu);
    auto it = cache.find(key);
    if (it != cache.end()) {
      fit = it->second;
    } else {
      cfg.gridDim = dim3(C);
      e = cudaOccupancyMaxActiveClusters(&fit, k, &cfg);
      if (e != cudaSuccess) return e;
      cache[key] = fit;
    }
  }
  if (fit < 1) return cudaErrorInvalidConfiguration;
  if (clusters_out) {
    *clusters_out = fit;
    return cudaSuccess;
  }
  const int n_ct = (n_tiles(kind, a) + C - 1) / C;
  if (n_ct == 0) return cudaSuccess;
  cfg.gridDim = dim3(min(fit, n_ct) * C);
  e = cudaLaunchKernelEx(&cfg, k, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Checks the plan, builds the tensor maps and launches; clusters_out
// (if given) receives the clusters a wave holds instead of a launch.
int run(int kind, Params& a, const int* plan, int* clusters_out,
        cudaStream_t st, const void* wqkv, const void* wp, const void* w1,
        const void* w2) {
  std::memcpy(&a.p, plan, sizeof(Plan));
  if (!plan_fits(kind, a)) return (int)cudaErrorInvalidValue;
  const int W = a.W;
  if (kind == kLnQkv || kind == kLnQkvAttn) {
    // the weight in 64-row boxes; the block input, and 6a's output, in
    // boxes of 64 columns x 64 rows, zeros (or nothing) past their edges
    if (a.rows == 0 && !clusters_out) return 0;
    const int rows = a.rows > 0 ? a.rows : 1;
    if (!weight_map(&a.tm_qkv, wqkv, a.K, W, 64) ||
        !weight_map(&a.tm_x, a.x, rows, W, 64) ||
        (kind == kLnQkv && !weight_map(&a.tm_out, a.out, rows, a.K, 64)))
      return (int)cudaErrorInvalidValue;
    return (int)launch(kind, a, clusters_out, st);
  }
  if (!weight_map(&a.tm_p, wp, W, W, W / 2) ||
      !weight_map(&a.tm_1, w1, a.Hd, W, a.p.hc / 2) ||
      !weight_map(&a.tm_2, w2, W, a.Hd, W / 2) ||
      !weight_map(&a.tm_qkv, kind == kFullBlock ? wqkv : wp,
                  kind == kFullBlock ? 3 * W : W, W,
                  kind == kFullBlock ? a.p.gdp / 2 : W / 2))
    return (int)cudaErrorInvalidValue;
  return (int)launch(kind, a, clusters_out, st);
}

}  // namespace tc

}  // namespace

// The first design: dtype 0 (float32) only; bf16 takes the *_tc entries.
// Row tensors and weights float32, LayerNorm parameters and biases
// float32; all contiguous and 16-byte aligned.  Each returns
// cudaGetLastError() after its launch (or cudaErrorInvalidValue for a
// shape or dtype it does not take).
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

// The bf16 route of the four functions (namespace tc): bf16 rows and
// weights, float32 LayerNorm parameters and biases, all contiguous and
// 16-byte aligned; `plan` is block_kernel.py::wgmma_plan's (checked here,
// cudaErrorInvalidValue if it does not hold).
extern "C" int fused_ln_qkv_tc(const void* x, const float* g, const float* b,
                               const void* w, const float* bias, void* out,
                               int rows, int W, int K, const int* plan,
                               void* stream) {
  Args s = {};
  s.rows = rows; s.W = W; s.K = K;
  if (!shape_ok(kLnQkv, s)) return (int)cudaErrorInvalidValue;
  tc::Params a = {};
  a.x = static_cast<const bf16*>(x); a.g1 = g; a.b1 = b; a.bqkv = bias;
  a.out = static_cast<bf16*>(out);
  a.rows = rows; a.W = W; a.K = K; a.N = 1; a.H = 1; a.D = W;
  return tc::run(kLnQkv, a, plan, nullptr, static_cast<cudaStream_t>(stream),
                 w, nullptr, nullptr, nullptr);
}

extern "C" int fused_ln_qkv_attn_tc(const void* x, const float* g,
                                    const float* b, const void* w,
                                    const float* bias, void* out, int rows,
                                    int N, int H, int W, float scale,
                                    const int* plan, void* stream) {
  Args s = {};
  s.rows = rows; s.N = N; s.H = H; s.W = W; s.D = H > 0 ? W / H : 0;
  if (!shape_ok(kLnQkvAttn, s)) return (int)cudaErrorInvalidValue;
  tc::Params a = {};
  a.x = static_cast<const bf16*>(x); a.g1 = g; a.b1 = b; a.bqkv = bias;
  a.out = static_cast<bf16*>(out);
  a.rows = rows; a.W = W; a.K = 3 * W; a.N = N; a.H = H; a.D = s.D;
  a.scale = scale;
  return tc::run(kLnQkvAttn, a, plan, nullptr,
                 static_cast<cudaStream_t>(stream), w, nullptr, nullptr,
                 nullptr);
}

extern "C" int fused_proj_mlp_tc(const void* att, const void* x,
                                 const void* wp, const float* bp,
                                 const float* g2, const float* b2,
                                 const void* w1, const float* bm1,
                                 const void* w2, const float* bm2, void* out,
                                 int rows, int W, int Hd, const int* plan,
                                 void* stream) {
  Args s = {};
  s.rows = rows; s.W = W; s.Hd = Hd;
  if (!shape_ok(kProjMlp, s)) return (int)cudaErrorInvalidValue;
  tc::Params a = {};
  a.x = static_cast<const bf16*>(att); a.res = static_cast<const bf16*>(x);
  a.bp = bp; a.g2 = g2; a.b2 = b2; a.bm1 = bm1; a.bm2 = bm2;
  a.out = static_cast<bf16*>(out);
  a.rows = rows; a.W = W; a.Hd = Hd; a.N = 1; a.H = 1; a.D = W;
  return tc::run(kProjMlp, a, plan, nullptr,
                 static_cast<cudaStream_t>(stream), nullptr, wp, w1, w2);
}

extern "C" int fused_block_full_tc(const void* x, const float* g1,
                                   const float* b1, const void* wqkv,
                                   const float* bqkv, const void* wp,
                                   const float* bp, const float* g2,
                                   const float* b2, const void* w1,
                                   const float* bm1, const void* w2,
                                   const float* bm2, void* out, int rows,
                                   int N, int H, int W, int Hd, float scale,
                                   const int* plan, void* stream) {
  Args s = {};
  s.rows = rows; s.N = N; s.H = H; s.W = W; s.Hd = Hd;
  s.D = H > 0 ? W / H : 0;
  if (!shape_ok(kFullBlock, s)) return (int)cudaErrorInvalidValue;
  tc::Params a = {};
  a.x = static_cast<const bf16*>(x);
  a.g1 = g1; a.b1 = b1; a.bqkv = bqkv; a.bp = bp; a.g2 = g2; a.b2 = b2;
  a.bm1 = bm1; a.bm2 = bm2; a.out = static_cast<bf16*>(out);
  a.rows = rows; a.W = W; a.Hd = Hd; a.N = N; a.H = H; a.D = s.D;
  a.scale = scale;
  return tc::run(kFullBlock, a, plan, nullptr,
                 static_cast<cudaStream_t>(stream), wqkv, wp, w1, w2);
}

// The tc kernel of `kind` under `plan` at this shape (`Hd`: the MLP's
// hidden width; for fused_ln_qkv, K): out = {registers a thread, spill
// (local) bytes a thread, clusters a wave}.
extern "C" int fused_block_tc_info(int kind, const int* plan, int N, int H,
                                   int W, int Hd, int* out) {
  if (kind < 0 || kind > 3) return (int)cudaErrorInvalidValue;
  Args s = {};
  s.rows = N; s.N = N; s.H = H; s.W = W; s.Hd = Hd; s.K = Hd;
  s.D = H > 0 ? W / H : 0;
  if (!shape_ok(kind, s)) return (int)cudaErrorInvalidValue;
  tc::Params a = {};
  std::memcpy(&a.p, plan, sizeof(tc::Plan));
  a.rows = N; a.W = W; a.Hd = Hd; a.N = N; a.H = H; a.D = s.D;
  a.K = kind == kLnQkv ? Hd : 3 * W;
  if (!tc::plan_fits(kind, a)) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, tc::tc_kernel_for(kind, a));
  if (e != cudaSuccess) return (int)e;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  return (int)tc::launch(kind, a, &out[2], nullptr);
}

extern "C" int fused_block_tc_plan_fields() { return tc::kPlanFields; }

// The attention of images of more than 32 tokens (long_attention.cuh), the
// middle stage of kernels 5 and 7 past 32 tokens: qkv (rows, 3W) and out
// (rows, W) in bf16 (dtype 1, tensor cores) or float32 (dtype 0).
extern "C" int fused_block_long_attention(const void* qkv, void* out,
                                          int rows, int N, int H, int W,
                                          float scale, int dtype,
                                          void* stream) {
  return (int)long_attn::launch(qkv, out, rows, N, H, W, scale, dtype,
                                static_cast<cudaStream_t>(stream));
}

// Profile builds (-DFUSED_BLOCK_PROFILE) only: the cycles by phase of the
// last launch of each tc kernel, [kind][warpgroup][phase] (warpgroup 0
// the producer's); cudaErrorNotSupported otherwise.
extern "C" int fused_block_profile(unsigned long long* out) {
#ifdef FUSED_BLOCK_PROFILE
  return (int)cudaMemcpyFromSymbol(out, tc::g_profile,
                                   sizeof(tc::g_profile));
#else
  (void)out;
  return (int)cudaErrorNotSupported;
#endif
}

extern "C" const char* fused_block_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
