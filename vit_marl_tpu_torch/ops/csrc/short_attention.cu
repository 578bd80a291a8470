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
// type (bf16 or f32).  The plain PyTorch versions of the same functions
// are short_attention_reference / short_attention_bwd_reference in
// vit_marl_tpu_torch/ops/attention_kernel.py.
//
// Design.  The TPU kernel pairs tokens by sublane rolls, reduces heads
// through 0/1 selection matmuls and runs blocks of 64 images; none of
// that carries over.  Here one block owns one image and one warp owns one
// head at a time.  The warp stages its head's q, k and v tiles (N x D
// each; backward also g) in its own slice of shared memory with 16-byte
// loads: each token's D values of a head are contiguous in the row.  Its
// lanes then cover the N*N (i, j) pairs for the logits (a float32 dot
// over D), one lane per row runs the softmax (max, then exp-sum), and the
// lanes cover d for the products with v (backward: with k, q and g).  The
// per-head P and dS tiles (N x N float32) stay in shared memory.  Results
// go to a tile in shared memory and leave with 16-byte stores.  Tile rows
// are padded by 16 bytes to spread the shared-memory banks.  A block runs
// as many warps (up to 8, at most H) as its shared memory holds, so every
// N <= 32 and D (a multiple of 8 up to 128) fits, at any width W and any
// number of images B.
//
// Bound at the main path's shapes (ViT-Small, N = 11, W = 384, bf16),
// moving each input once and each output once at 3.35 TB/s:
//   forward, rollout (B = 1,024):     34.6 MB,  10.3 us
//   forward, PPO minibatch (32,768):  1,107.3 MB, 330.5 us
//   backward, PPO minibatch (32,768): 1,937.8 MB, 578.4 us
// The arithmetic, about 0.19 MFLOP per image per block, is far below the
// card's rate: both kernels are bound by bytes.  One PyTorch call computes
// the same function (torch.nn.functional.scaled_dot_product_attention on
// (B, H, N, D)); the port does not call it.  This first version is simple
// rather than fast: shared-memory bank conflicts on the dot over D and one
// image per block are left for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_body.cuh"

namespace {

constexpr int kMaxWarps = 8;
constexpr size_t kMaxSmem = 227 * 1024;

using attn_body::ld;
using attn_body::st;

__host__ __device__ __forceinline__ size_t align16(size_t n) {
  return (n + 15) & ~size_t(15);
}

// Shape of one warp's slice of shared memory: `n_tiles` (N, ldr) tiles of
// T with the row stride padded by 16 bytes, then `n_f32` (N, N+1) float
// tiles.
template <typename T>
struct Slice {
  int N, D, ldr;
  size_t tile;   // bytes of one T tile
  __host__ __device__ Slice(int n, int d)
      : N(n), D(d), ldr(d + int(16 / sizeof(T))),
        tile(align16(size_t(n) * (d + 16 / sizeof(T)) * sizeof(T))) {}
  __host__ __device__ size_t bytes(int n_tiles, int n_f32) const {
    return n_tiles * tile + align16(size_t(n_f32) * N * (N + 1) * 4);
  }
};

// Warp copy of N rows of D values: from global rows of `stride` values
// into a padded tile, or back.  D * sizeof(T) is a multiple of 16.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int stride,
                                          const Slice<T>& s, int lane) {
  const int vpr = s.D * sizeof(T) / 16;
  for (int v = lane; v < s.N * vpr; v += 32) {
    const int r = v / vpr, c = v - r * vpr;
    reinterpret_cast<int4*>(dst + r * s.ldr)[c] =
        reinterpret_cast<const int4*>(src + size_t(r) * stride)[c];
  }
}
template <typename T>
__device__ __forceinline__ void store_tile(T* dst, int stride, const T* src,
                                           const Slice<T>& s, int lane) {
  const int vpr = s.D * sizeof(T) / 16;
  for (int v = lane; v < s.N * vpr; v += 32) {
    const int r = v / vpr, c = v - r * vpr;
    reinterpret_cast<int4*>(dst + size_t(r) * stride)[c] =
        reinterpret_cast<const int4*>(src + r * s.ldr)[c];
  }
}

// P = softmax_j((q*scale) k^T) into the (N, N+1)-strided tile
// (attention_body.cuh).
template <typename T>
__device__ __forceinline__ void softmax_tile(const T* q, const T* k, float* P,
                                             const Slice<T>& s, float scale,
                                             int lane) {
  attn_body::head_softmax(q, k, s.ldr, s.ldr, s.N, s.D, scale, P, lane);
}

template <typename T>
__global__ void attn_fwd_kernel(const T* __restrict__ qkv,
                                T* __restrict__ out, int N, int H, int D,
                                float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Slice<T> s(N, D);
  const int W = H * D, W3 = 3 * W;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  unsigned char* mine = smem + warp * s.bytes(4, 1);
  T* q = reinterpret_cast<T*>(mine);
  T* k = reinterpret_cast<T*>(mine + s.tile);
  T* v = reinterpret_cast<T*>(mine + 2 * s.tile);
  T* o = reinterpret_cast<T*>(mine + 3 * s.tile);
  float* P = reinterpret_cast<float*>(mine + 4 * s.tile);
  const T* x = qkv + size_t(blockIdx.x) * N * W3;
  T* y = out + size_t(blockIdx.x) * N * W;

  for (int h = warp; h < H; h += blockDim.x / 32) {
    load_tile(q, x + h * D, W3, s, lane);
    load_tile(k, x + W + h * D, W3, s, lane);
    load_tile(v, x + 2 * W + h * D, W3, s, lane);
    __syncwarp();
    softmax_tile(q, k, P, s, scale, lane);
    attn_body::head_pv(P, v, s.ldr, N, D, o, s.ldr, lane);
    __syncwarp();
    store_tile(y + h * D, W, o, s, lane);
    __syncwarp();
  }
}

template <typename T>
__global__ void attn_bwd_kernel(const T* __restrict__ qkv,
                                const T* __restrict__ g,
                                T* __restrict__ dqkv, int N, int H, int D,
                                float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Slice<T> s(N, D);
  const int W = H * D, W3 = 3 * W;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ld_p = N + 1;
  unsigned char* mine = smem + warp * s.bytes(7, 2);
  T* q = reinterpret_cast<T*>(mine);
  T* k = reinterpret_cast<T*>(mine + s.tile);
  T* v = reinterpret_cast<T*>(mine + 2 * s.tile);
  T* gh = reinterpret_cast<T*>(mine + 3 * s.tile);
  T* dq = reinterpret_cast<T*>(mine + 4 * s.tile);
  T* dk = reinterpret_cast<T*>(mine + 5 * s.tile);
  T* dv = reinterpret_cast<T*>(mine + 6 * s.tile);
  float* P = reinterpret_cast<float*>(mine + 7 * s.tile);
  float* dS = P + N * ld_p;
  const T* x = qkv + size_t(blockIdx.x) * N * W3;
  const T* gx = g + size_t(blockIdx.x) * N * W;
  T* y = dqkv + size_t(blockIdx.x) * N * W3;

  for (int h = warp; h < H; h += blockDim.x / 32) {
    load_tile(q, x + h * D, W3, s, lane);
    load_tile(k, x + W + h * D, W3, s, lane);
    load_tile(v, x + 2 * W + h * D, W3, s, lane);
    load_tile(gh, gx + h * D, W, s, lane);
    __syncwarp();
    softmax_tile(q, k, P, s, scale, lane);
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

bool shape_ok(int N, int H, int D) {
  return N >= 1 && N <= 32 && H >= 1 && D >= 8 && D <= 128 && D % 8 == 0;
}

// Warps per block: one per head, at most kMaxWarps, and no more than the
// shared memory holds.
int warps_for(int H, size_t per_warp) {
  int w = H < kMaxWarps ? H : kMaxWarps;
  while (w > 1 && w * per_warp > kMaxSmem) --w;
  return w;
}

template <typename T>
int launch_fwd(const void* qkv, void* out, int B, int N, int H, int D,
               float scale, cudaStream_t st) {
  const size_t per_warp = Slice<T>(N, D).bytes(4, 1);
  const int warps = warps_for(H, per_warp);
  const size_t smem = warps * per_warp;
  cudaError_t e = cudaFuncSetAttribute(
      attn_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  attn_fwd_kernel<T><<<B, 32 * warps, smem, st>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), N, H, D, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* qkv, const void* g, void* dqkv, int B, int N,
               int H, int D, float scale, cudaStream_t st) {
  const size_t per_warp = Slice<T>(N, D).bytes(7, 2);
  const int warps = warps_for(H, per_warp);
  const size_t smem = warps * per_warp;
  cudaError_t e = cudaFuncSetAttribute(
      attn_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  attn_bwd_kernel<T><<<B, 32 * warps, smem, st>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(g),
      static_cast<T*>(dqkv), N, H, D, scale);
  return (int)cudaGetLastError();
}

}  // namespace
// dtype: 0 = float32, 1 = bfloat16.  Pointers must be 16-byte aligned and
// the tensors contiguous.  Returns cudaGetLastError() after the launch.
extern "C" int short_attention_fwd(const void* qkv, void* out, int B, int N,
                                   int H, int D, float scale, int dtype,
                                   void* stream) {
  if (B <= 0) return 0;
  if (!shape_ok(N, H, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fwd<float>(qkv, out, B, N, H, D, scale, st);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16>(qkv, out, B, N, H, D, scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int short_attention_bwd(const void* qkv, const void* g,
                                   void* dqkv, int B, int N, int H, int D,
                                   float scale, int dtype, void* stream) {
  if (B <= 0) return 0;
  if (!shape_ok(N, H, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(qkv, g, dqkv, B, N, H, D, scale, st);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(qkv, g, dqkv, B, N, H, D, scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* short_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
