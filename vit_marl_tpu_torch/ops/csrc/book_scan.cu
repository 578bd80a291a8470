// Book scan for NVIDIA Hopper (sm_90a), in aggregate and records modes.
//
// Replaces the TPU kernel body vit_marl_tpu/ops/book_kernel.py::
// _make_kernel (book_kernel.py:85-445) in its two uses:
// - aggregate mode, pallas_process_step_aggs (the training path): exact
//   int32 per-trader trade sums in tick units;
// - records mode, pallas_process_step (the debug_mode trade log): each
//   message's fills, rank-compacted in slot order, as (price, -side *
//   quant, passive oid, passive tid), at most rec_k per message, and each
//   message's uncapped fill count.
// Per env, the step's M messages run in order against the book: (type,
// side) dispatch, the cancel fallback chain, matching by prefix sum, the
// hole-arena insert and the forward-filled best ask/bid after every
// message.  The plain PyTorch versions of the same functions are
// vit_marl_tpu_torch/ops/book_kernel.py::process_step_aggs_reference and
// process_step_records_reference; kernel and plain version are bit-equal.
//
// Design.  The TPU kernel puts slots on sublanes and 128 envs on lanes.
// Here one warp owns one env: lane l holds slots [l*SPL, l*SPL + SPL) of
// all 12 book planes in registers for the whole scan (SPL = S / 32, 4 at
// the main path's S = 128).  A prefix sum over the slots is a local scan
// plus a __shfl_up_sync scan of the lane totals; "first/last slot where"
// is a local search plus __reduce_min_sync / __reduce_max_sync; the
// insert's one-slot shifts pass the boundary slot with one shuffle.
// Messages are read straight from global memory (every lane reads the
// same 32 bytes, one broadcast transaction).  In aggregate mode,
// per-trader sums accumulate per lane in shared memory and are reduced
// across the warp once, after the loop: int32 addition wraps, so the
// order does not change the result.  In records mode a warp prefix of the
// per-lane fill counts gives each fill its rank, and the lane holding it
// writes the record straight to global memory as one 16-byte store; the
// lanes then fill the rows past the message's fills with empty records.
// The TPU kernel's staging of records in VMEM groups with double-buffered
// DMA has no counterpart: it exists for VMEM, not for the function.  All
// int32 arithmetic that the reference lets wrap is done in uint32.
//
// Bound at the main-path shape (E = 4096, M = 112, S = 128, two traders):
// aggregate mode must read the messages (14.7 MB) and the book (25.2 MB)
// and write the book (25.2 MB), the best prices (7.3 MB) and the sums:
// about 72 MB, 22 us at 3.35 TB/s.  Records mode at rec_k = 16 writes
// 117.4 MB of records and 1.8 MB of counts instead of the sums: about
// 192 MB, 57 us.  The real limit is the serial chain of 112 dependent
// messages per env, each a few dozen warp reductions: the kernel is
// latency-bound on that chain, and 4096 envs give 4096 warps to hide it.
// No single PyTorch call computes either function.

#include <cuda_runtime.h>
#include <climits>
#include <cstddef>

namespace {

constexpr int kEmpty = -1;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;                 // envs (warps) per block
constexpr int kAggStats = 8;
constexpr int kAggTotals = 2;
enum { PRICE = 0, QUANT, OID, TID, TS, TNS, NF };

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}
__device__ __forceinline__ int wneg(int a) { return (int)(0u - (unsigned)a); }

// floor division for b > 0 (Python / JAX `//`)
__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && (a < 0)) --q;
  return q;
}

__device__ __forceinline__ int warp_min(int v) {
  return __reduce_min_sync(kFull, v);
}
__device__ __forceinline__ int warp_max(int v) {
  return __reduce_max_sync(kFull, v);
}
__device__ __forceinline__ int warp_sum(int v) {
  return (int)__reduce_add_sync(kFull, (unsigned)v);
}
// inclusive scan over lanes, wrapping
__device__ __forceinline__ int warp_scan(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int n = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v = wadd(v, n);
  }
  return v;
}

template <int SPL>
struct Side {
  int f[NF][SPL];
};

struct Msg {
  int type, side, quant, price, oid, tid, ts, tns;
};

struct Params {
  int cancel_mode, init_id, tick, n_agg, n_acc;
  const int* tids;
};

// Uniform pick among candidate slots, by order id (book_kernel.py:193-211).
// Returns the first live slot holding the picked id, or S.
template <int SPL>
__device__ __forceinline__ int cdf_pick(const bool (&cand)[SPL],
                                        const Side<SPL>& Y,
                                        const bool (&occ)[SPL], float u,
                                        int lane) {
  constexpr int S = SPL * 32;
  const int base = lane * SPL;
  int cnt = 0;
#pragma unroll
  for (int j = 0; j < SPL; ++j) cnt += cand[j] ? 1 : 0;
  const int total = warp_sum(cnt);
  if (total == 0) return S;
  const float uu = __fmul_rn(u, fmaxf((float)total, 1.0f));
  int run = warp_scan(cnt, lane) - cnt;
  int first_hit = S;
#pragma unroll
  for (int j = 0; j < SPL; ++j) {
    run += cand[j] ? 1 : 0;
    if (first_hit == S && (float)run > uu) first_hit = base + j;
  }
  int pick = warp_min(first_hit);
  if (pick == S) pick = 0;   // f32 corner: no hit -> slot 0 (book_kernel.py:199-206)
  int chosen = 0;
#pragma unroll
  for (int j = 0; j < SPL; ++j)
    if (base + j == pick && cand[j]) chosen = Y.f[OID][j];
  chosen = warp_sum(chosen);
  int loc = S;
#pragma unroll
  for (int j = SPL - 1; j >= 0; --j)
    if (Y.f[OID][j] == chosen && occ[j]) loc = base + j;
  return warp_min(loc);
}

// Records-mode outputs of one message: its rec_k rows and its fill count.
struct RecOut {
  int4* rows;
  int* count;
  int rec_k;
};

// One message in the (X, Y) frame: X is matched against, Y is the side the
// cancel targets and the remainder rests on.  BID: Y is the bid side.
// REC: records mode (writes `rec`); else aggregate mode (adds to `acc`).
template <int SPL, bool BID, bool REC>
__device__ __forceinline__ void step(Side<SPL>& X, Side<SPL>& Y,
                                     const Msg& msg, bool is_lim,
                                     bool is_cancel, float u,
                                     const Params& p, unsigned* acc,
                                     const RecOut& rec, int lane) {
  constexpr int S = SPL * 32;
  const int base = lane * SPL;

  // ---- cancel pass on Y (identity unless cancelling) ----
  const int c_quant = is_cancel ? msg.quant : 0;
  const int c_oid = is_cancel ? msg.oid : 0;
  bool occ_y0[SPL];
  int loc = S;
#pragma unroll
  for (int j = SPL - 1; j >= 0; --j) {
    occ_y0[j] = Y.f[PRICE][j] != kEmpty;
    if (Y.f[OID][j] == c_oid && occ_y0[j]) loc = base + j;
  }
  int cidx = warp_min(loc);
  if (p.cancel_mode >= 1 && cidx >= S) {
    loc = S;
#pragma unroll
    for (int j = SPL - 1; j >= 0; --j)
      if (Y.f[PRICE][j] == msg.price && Y.f[OID][j] <= p.init_id &&
          Y.f[QUANT][j] >= c_quant && occ_y0[j])
        loc = base + j;
    cidx = warp_min(loc);
  }
  if (p.cancel_mode >= 2 && cidx >= S) {
    bool cand[SPL];
#pragma unroll
    for (int j = 0; j < SPL; ++j)
      cand[j] = Y.f[PRICE][j] == msg.price && Y.f[QUANT][j] >= c_quant &&
                occ_y0[j] && Y.f[OID][j] != 0;
    cidx = cdf_pick<SPL>(cand, Y, occ_y0, u, lane);
  }
  if (p.cancel_mode >= 3 && cidx >= S) {
    bool cand[SPL];
#pragma unroll
    for (int j = 0; j < SPL; ++j)
      cand[j] = Y.f[PRICE][j] == msg.price && occ_y0[j] &&
                Y.f[OID][j] != 0;
    cidx = cdf_pick<SPL>(cand, Y, occ_y0, u, lane);
  }
  if (cidx < S) {
#pragma unroll
    for (int j = 0; j < SPL; ++j) {
      if (base + j == cidx) {
        const int nq = wsub(Y.f[QUANT][j], c_quant);
        Y.f[QUANT][j] = nq;
        if (nq <= 0) Y.f[PRICE][j] = kEmpty;
      }
    }
  }

  // ---- limit pass: match against X ----
  const int lim_quant = is_lim ? msg.quant : 0;
  bool cross[SPL];
  int q[SPL];
  int lsum = 0;
#pragma unroll
  for (int j = 0; j < SPL; ++j) {
    const int xp = X.f[PRICE][j];
    cross[j] = xp != kEmpty && (BID ? xp <= msg.price : xp >= msg.price);
    q[j] = cross[j] ? X.f[QUANT][j] : 0;
    lsum = wadd(lsum, q[j]);
  }
  int cum = wsub(warp_scan(lsum, lane), lsum);
  int matched[SPL];
  int tm = 0;
  bool any_local = false;
#pragma unroll
  for (int j = 0; j < SPL; ++j) {
    cum = wadd(cum, q[j]);
    int x = wsub(lim_quant, wsub(cum, q[j]));
    x = min(max(x, 0), q[j]);
    matched[j] = cross[j] ? x : 0;
    tm = wadd(tm, matched[j]);
    any_local |= matched[j] != 0;
  }
  const int total_matched = warp_sum(tm);

  if constexpr (REC) {
    // ---- records (book_kernel.py:241-285): rank = fills up to the slot
    int c = 0;
#pragma unroll
    for (int j = 0; j < SPL; ++j) c += matched[j] > 0 ? 1 : 0;
    const int incl = warp_scan(c, lane);
    const int n_fills = __shfl_sync(kFull, incl, 31);
    const int neg_s = wneg(msg.side);
    int r = incl - c;
#pragma unroll
    for (int j = 0; j < SPL; ++j) {
      if (matched[j] > 0) {
        ++r;
        if (r <= rec.rec_k)
          rec.rows[r - 1] = make_int4(X.f[PRICE][j], wmul(neg_s, matched[j]),
                                      X.f[OID][j], X.f[TID][j]);
      }
    }
    for (int k = n_fills + lane; k < rec.rec_k; k += 32)
      rec.rows[k] = make_int4(kEmpty, 0, 0, 0);
    if (lane == 0) *rec.count = n_fills;
  } else if (__any_sync(kFull, any_local)) {
    // ---- per-trader sums (book_kernel.py:287-326), per lane ----
    const bool s_pos = msg.side == 1;
    const int neg_s = wneg(msg.side);
    int mpt[SPL];
    unsigned tot_q = 0, tot_pq = 0;
#pragma unroll
    for (int j = 0; j < SPL; ++j) {
      mpt[j] = wmul(matched[j], floordiv(X.f[PRICE][j], p.tick));
      tot_q += (unsigned)matched[j];
      if (matched[j] > 0) tot_pq += (unsigned)mpt[j];
    }
    acc[(p.n_acc - 2) * 32] += tot_q;
    acc[(p.n_acc - 1) * 32] += tot_pq;
    for (int k = 0; k < p.n_agg; ++k) {
      const int tk = p.tids[k];
      const bool agr = msg.tid == tk;
      unsigned v[kAggStats] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
      for (int j = 0; j < SPL; ++j) {
        const bool was = matched[j] > 0;
        const bool pmask = was && X.f[TID][j] == tk;
        const bool agr_row = was && agr;
        const bool inv = pmask || agr_row;
        const bool buy = (s_pos && agr_row) || (!s_pos && pmask);
        const bool sell = (s_pos && pmask) || (!s_pos && agr_row);
        const unsigned mq = (unsigned)matched[j];
        const unsigned mp = (unsigned)mpt[j];
        if (buy) { v[0] += mq; v[2] += mp; }
        if (sell) { v[1] += mq; v[3] += mp; }
        if (inv) {
          v[4] += mq;
          v[5] += mp;
          v[6] += (unsigned)wmul(matched[j], X.f[TID][j]);
          v[7] += (unsigned)wmul(neg_s, matched[j]);
        }
      }
#pragma unroll
      for (int i = 0; i < kAggStats; ++i)
        acc[(kAggStats * k + i) * 32] += v[i];
    }
  }

#pragma unroll
  for (int j = 0; j < SPL; ++j) {
    X.f[QUANT][j] = wsub(X.f[QUANT][j], matched[j]);
    if (matched[j] > 0 && X.f[QUANT][j] <= 0) X.f[PRICE][j] = kEmpty;
  }

  // ---- insert the remainder into Y (book_kernel.py:332-374) ----
  const int add_q = max(0, wsub(lim_quant, total_matched));
  if (add_q <= 0) return;
  const int nk = BID ? wneg(msg.price) : msg.price;
  bool hole[SPL], before[SPL];
  int l_fw = S, l_lb = -1;
#pragma unroll
  for (int j = 0; j < SPL; ++j) {
    const int yp = Y.f[PRICE][j];
    const bool occ = yp != kEmpty;
    hole[j] = !occ;
    const int pk = BID ? wneg(yp) : yp;
    const int ys = Y.f[TS][j], yn = Y.f[TNS][j];
    before[j] = occ && (pk < nk || (pk == nk && (ys < msg.ts ||
                                                 (ys == msg.ts && yn <= msg.tns))));
    const bool worse = occ && !before[j];
    if (worse && l_fw == S) l_fw = base + j;
    if (before[j]) l_lb = base + j;
  }
  const int fw = warp_min(l_fw);
  const int lb = warp_max(l_lb);
  int l_pos_a = S, l_ha = S, l_hb = -1;
#pragma unroll
  for (int j = 0; j < SPL; ++j) {
    const int i = base + j;
    if (hole[j] && i > lb && i < fw && l_pos_a == S) l_pos_a = i;
    if (hole[j] && i >= fw && l_ha == S) l_ha = i;
    if (hole[j] && i <= lb) l_hb = i;
  }
  const int pos_a = warp_min(l_pos_a);
  const int first_ha = warp_min(l_ha);
  const int last_hb = warp_max(l_hb);
  const bool case_a = pos_a < S;
  const bool case_bh = first_ha < S;
  const bool case_c = last_hb >= 0;
  const int ha = case_bh ? first_ha : S - 1;
  const int hb = case_c ? last_hb : 0;
  const bool use_b = !case_a && (case_bh || !case_c);
  const int fw_b = case_bh ? fw : min(fw, S - 1);
  const int vals[NF] = {msg.price, add_q, msg.oid, msg.tid, msg.ts, msg.tns};

  if (case_a) {
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int j = 0; j < SPL; ++j)
        if (base + j == pos_a) Y.f[f][j] = vals[f];
  } else if (use_b) {
    // shift (fw_b, ha] right by one slot, new order at fw_b
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const int up = __shfl_up_sync(kFull, Y.f[f][SPL - 1], 1);
#pragma unroll
      for (int j = SPL - 1; j >= 0; --j) {
        const int i = base + j;
        const int left = j ? Y.f[f][j - 1] : up;
        if (i > fw_b && i <= ha) Y.f[f][j] = left;
        if (i == fw_b) Y.f[f][j] = vals[f];
      }
    }
  } else {
    // shift [hb, lb) left by one slot, new order at lb
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const int down = __shfl_down_sync(kFull, Y.f[f][0], 1);
#pragma unroll
      for (int j = 0; j < SPL; ++j) {
        const int i = base + j;
        const int right = (j < SPL - 1) ? Y.f[f][j + 1] : down;
        if (i >= hb && i < lb) Y.f[f][j] = right;
        if (i == lb) Y.f[f][j] = vals[f];
      }
    }
  }
}

// REC: records mode, writing `records` (E, M, rec_k) and `counts` (E, M);
// else aggregate mode, writing `aggs`.
template <int SPL, bool REC>
__global__ void __launch_bounds__(kWarps * 32)
book_scan_kernel(const int* __restrict__ msgs, const int* __restrict__ book_in,
                 const int* __restrict__ prev, const float* __restrict__ uniforms,
                 int* __restrict__ book_out, int* __restrict__ bidask,
                 int* __restrict__ aggs, int4* __restrict__ records,
                 int* __restrict__ counts, int rec_k, int E, int M, int maxint,
                 Params p) {
  constexpr int S = SPL * 32;
  extern __shared__ unsigned smem_acc[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int e = blockIdx.x * kWarps + warp;
  if (e >= E) return;   // whole warp; the kernel has no block barrier
  const int base = lane * SPL;
  unsigned* acc = smem_acc + (size_t)warp * p.n_acc * 32 + lane;
  for (int k = 0; k < p.n_acc; ++k) acc[k * 32] = 0u;

  Side<SPL> ask, bid;
  const int* bk = book_in + (size_t)e * 2 * NF * S;
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int j = 0; j < SPL; ++j) {
      ask.f[f][j] = bk[f * S + base + j];
      bid.f[f][j] = bk[(NF + f) * S + base + j];
    }
  int prev_a = prev[2 * e], prev_b = prev[2 * e + 1];

  for (int m = 0; m < M; ++m) {
    const int* mp = msgs + ((size_t)e * M + m) * 8;
    const Msg msg{mp[0], mp[1], mp[2], mp[3], mp[4], mp[5], mp[6], mp[7]};
    const float u = p.cancel_mode >= 2 ? uniforms[(size_t)m * E + e] : 0.0f;
    const int t = msg.type, s = msg.side;
    // (type, side) dispatch (book_kernel.py:141-150): unknown -> index 0
    int index = 0;
    if ((s == 1 && t == 1) || (s == -1 && t == 4)) index += 1;
    if ((s == -1 && t == 2) || (s == -1 && t == 3)) index += 2;
    if ((s == 1 && t == 2) || (s == 1 && t == 3)) index += 3;
    if (s == 0 && t == 0) index += 4;
    const bool is_lim = index == 0 || index == 1;
    const bool is_cancel = index == 2 || index == 3;
    const bool bid_frame = index == 1 || index == 3;
    const RecOut rec{REC ? records + ((size_t)e * M + m) * rec_k : nullptr,
                     REC ? counts + (size_t)e * M + m : nullptr, rec_k};
    if (bid_frame)
      step<SPL, true, REC>(ask, bid, msg, is_lim, is_cancel, u, p, acc, rec,
                           lane);
    else
      step<SPL, false, REC>(bid, ask, msg, is_lim, is_cancel, u, p, acc, rec,
                            lane);

    // ---- best ask/bid with quantities, forward-filled ----
    int la = INT_MAX, lbp = INT_MIN;
#pragma unroll
    for (int j = 0; j < SPL; ++j) {
      const int ap = ask.f[PRICE][j];
      la = min(la, ap == kEmpty ? maxint : ap);
      lbp = max(lbp, bid.f[PRICE][j]);
    }
    int best_a = warp_min(la);
    if (best_a == maxint) best_a = kEmpty;
    int best_b = warp_max(lbp);
    int aq = 0, bq = 0;
#pragma unroll
    for (int j = 0; j < SPL; ++j) {
      if (ask.f[PRICE][j] == best_a) aq = wadd(aq, ask.f[QUANT][j]);
      if (bid.f[PRICE][j] == best_b) bq = wadd(bq, bid.f[QUANT][j]);
    }
    aq = warp_sum(aq);
    bq = warp_sum(bq);
    if (best_a == kEmpty) { best_a = prev_a; aq = 0; }
    if (best_b == kEmpty) { best_b = prev_b; bq = 0; }
    if (lane == 0) {
      int* out = bidask + ((size_t)e * M + m) * 4;
      out[0] = best_a;
      out[1] = aq;
      out[2] = best_b;
      out[3] = bq;
    }
    prev_a = best_a;
    prev_b = best_b;
  }

  for (int k = 0; k < p.n_acc; ++k) {
    const unsigned v = __reduce_add_sync(kFull, acc[k * 32]);
    if (lane == 0) aggs[(size_t)e * p.n_acc + k] = (int)v;
  }
  // canonicalise: every plane of a hole reads EMPTY (book_kernel.py:435-442)
  int* ob = book_out + (size_t)e * 2 * NF * S;
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int j = 0; j < SPL; ++j) {
      const bool ha = ask.f[PRICE][j] == kEmpty;
      const bool hb = bid.f[PRICE][j] == kEmpty;
      ob[f * S + base + j] = ha ? kEmpty : ask.f[f][j];
      ob[(NF + f) * S + base + j] = hb ? kEmpty : bid.f[f][j];
    }
}

template <int SPL, bool REC>
cudaError_t launch(const int* msgs, const int* book_in, const int* prev,
                   const float* uniforms, int* book_out, int* bidask,
                   int* aggs, int4* records, int* counts, int rec_k, int E,
                   int M, int maxint, const Params& p, cudaStream_t stream) {
  const size_t smem = (size_t)kWarps * p.n_acc * 32 * sizeof(unsigned);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        book_scan_kernel<SPL, REC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((E + kWarps - 1) / kWarps), block(kWarps * 32);
  book_scan_kernel<SPL, REC><<<grid, block, smem, stream>>>(
      msgs, book_in, prev, uniforms, book_out, bidask, aggs, records, counts,
      rec_k, E, M, maxint, p);
  return cudaGetLastError();
}

template <bool REC>
int launch_s(int S, const int* msgs, const int* book_in, const int* prev,
             const float* uniforms, int* book_out, int* bidask, int* aggs,
             int4* records, int* counts, int rec_k, int E, int M, int maxint,
             const Params& p, cudaStream_t st) {
  switch (S) {
    case 32:
      return launch<1, REC>(msgs, book_in, prev, uniforms, book_out, bidask,
                            aggs, records, counts, rec_k, E, M, maxint, p, st);
    case 64:
      return launch<2, REC>(msgs, book_in, prev, uniforms, book_out, bidask,
                            aggs, records, counts, rec_k, E, M, maxint, p, st);
    case 128:
      return launch<4, REC>(msgs, book_in, prev, uniforms, book_out, bidask,
                            aggs, records, counts, rec_k, E, M, maxint, p, st);
    case 256:
      return launch<8, REC>(msgs, book_in, prev, uniforms, book_out, bidask,
                            aggs, records, counts, rec_k, E, M, maxint, p, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface (loaded with ctypes).  Layouts, all int32 unless noted:
// msgs (E, M, 8); book_in/book_out (E, 2, 6, S) [env, ask/bid, field, slot];
// prev (E, 2); tids (n_agg,); uniforms (M, E) float32, read only when
// cancel_mode >= 2; bidask (E, M, 4) [ask_p, ask_q, bid_p, bid_q];
// aggs (E, 8 * n_agg + 2).  Launches on `stream`, does not synchronise,
// returns the cudaError_t of the launch.
extern "C" int book_scan_aggs(const int* msgs, const int* book_in,
                              const int* prev, const int* tids,
                              const float* uniforms, int* book_out,
                              int* bidask, int* aggs, int E, int M, int S,
                              int n_agg, int cancel_mode, int init_id,
                              int tick, int maxint, void* stream) {
  if (E <= 0) return 0;
  const Params p{cancel_mode, init_id, tick, n_agg,
                 kAggStats * n_agg + kAggTotals, tids};
  return launch_s<false>(S, msgs, book_in, prev, uniforms, book_out, bidask,
                         aggs, nullptr, nullptr, 0, E, M, maxint, p,
                         static_cast<cudaStream_t>(stream));
}

// Records mode: as book_scan_aggs without trader ids and sums; records
// (E, M, rec_k, 4) [price, -side * quant, passive oid, passive tid], rows
// past a message's fills (EMPTY, 0, 0, 0), 16-byte aligned; fill_counts
// (E, M), uncapped.  1 <= rec_k <= S.
extern "C" int book_scan_records(const int* msgs, const int* book_in,
                                 const int* prev, const float* uniforms,
                                 int* book_out, int* bidask, int* records,
                                 int* fill_counts, int E, int M, int S,
                                 int rec_k, int cancel_mode, int init_id,
                                 int maxint, void* stream) {
  if (E <= 0) return 0;
  if (rec_k < 1 || rec_k > S) return (int)cudaErrorInvalidValue;
  const Params p{cancel_mode, init_id, 1, 0, 0, nullptr};
  return launch_s<true>(S, msgs, book_in, prev, uniforms, book_out, bidask,
                        nullptr, reinterpret_cast<int4*>(records),
                        fill_counts, rec_k, E, M, maxint, p,
                        static_cast<cudaStream_t>(stream));
}

extern "C" const char* book_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
