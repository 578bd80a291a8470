// Book scan for NVIDIA Hopper (sm_90a), in aggregate and records modes.
//
// Replaces the TPU kernel body vit_marl_tpu/ops/book_kernel.py::
// _make_kernel (book_kernel.py:85-445) in its two uses:
// - aggregate mode, pallas_process_step_aggs (book_kernel.py:580, the
//   training path): exact int32 per-trader trade sums in tick units;
// - records mode, pallas_process_step (book_kernel.py:479, the debug_mode
//   trade log): each message's fills, rank-compacted in slot order, as
//   (price, -side * quant, passive oid, passive tid), at most rec_k per
//   message, and each message's uncapped fill count.
// Per env, the step's M messages run in order against the book: (type,
// side) dispatch, the cancel fallback chain, matching by prefix sum, the
// hole-arena insert and the forward-filled best ask/bid after every
// message.  The plain PyTorch versions of the same functions are
// vit_marl_tpu_torch/ops/book_kernel.py::process_step_aggs_reference and
// process_step_records_reference; kernel and plain version are bit-equal.
//
// What bounds it.  At the main path's shape (E = 4096, M = 112, S = 128,
// two traders) aggregate mode must read the messages (14.7 MB) and the
// book (25.2 MB) and write the book, the best prices (7.3 MB) and the
// sums: about 72 MB, 22 us at 3.35 TB/s; records mode at rec_k = 16 about
// 192 MB, 57 us.  The real limit is the chain of 112 dependent messages
// per env.  The first version of this kernel (one warp per env, all 12
// book planes in registers, messages read from global memory inside the
// loop) measured on an H100 80GB HBM3 at 700 W: 99 registers, so 16 warps
// an SM and two waves at E = 4096; 218-964 SASS instructions on one pass
// through the message loop, with 36 warp reductions and 54 shuffles in
// it; 0.3747 ms at E = 4096, 0.1341 at 1024 and 0.1234 at 512; 0.25 ms
// at E = 4096 on a stream of padding alone, the global loads of each
// message on the chain.  This design measures 0.208 ms at E = 4096, 0.088
// at 1024 and 0.081 at 512 on the same card (PERF.md): 0.067 ms of it on
// padding alone (0.02 ms of set-up and book traffic, the rest each
// message's bare loop), and at E = 4096 some 460 issue cycles a
// warp-message, with eight warps to a scheduler.  Timed copies with one
// part cut out put half the time in the insert of a resting order, a
// sixth in its shift of the orders behind it (most inserts on the main
// path's streams shift a run of orders up to the next hole), and a
// seventh in the per-trader sums.
//
// Design.  One warp owns one env; lane l owns slots [l*SPL, l*SPL + SPL)
// (SPL = S / 32, 4 at S = 128), for S up to 1,024; past that a block of 256
// threads owns one env (the block route, after the warp route's kernels
// below: no upper limit but device memory).
// - Book capacities.  S in {32, 64, 128, 256} takes the exact kernels above.
//   Any other S from 1 to 1024 takes a masked kernel (template MASK): SPL is
//   the power of two of at least S / 32 slots a lane (100 -> 4, 200 -> 8,
//   384 -> 16, 1024 -> 32), the book's global layout keeps its S, and the
//   slots from S to 32 * SPL exist only in the warp: a price of EMPTY and a
//   quantity of 0 that no step writes.  So they are never live for a match,
//   a cancel or a record; the bid side's best price skips them (a hole
//   counts there as -1, they do not); the insert looks for holes, and drops
//   the last order of a full book, below S only.  Past SPL 8 (S over 256)
//   the kernels keep the planes in registers at fewer blocks an SM (SPL 16:
//   2, SPL 32: 1; the shared planes take 71 / 137 KB a block), and only the
//   general aggregate kernel and one records kernel are built.  The loop
//   carries no mask: a masked slot reads as a hole after every real one,
//   so the insert compares the first hole it finds with n, and the bid
//   side's best leaves masked slots out only when it comes out -1.  On
//   S = 128's data the masked aggregate kernel runs 6-7% slower than the
//   exact one, and S = 100 5-6% slower than S = 128 (PERF.md): the
//   capacity held at run time costs it 32 spill bytes against 16.  A copy
//   with the capacity a constant of the build runs S = 128 within 1% of
//   the exact kernel; 16-byte book traffic moves nothing
//   (tools/torch_ab_book.py --masks).
// - Registers hold the planes every message reads: PRICE and QUANT of both
//   sides.  OID, TID, TS and TNS live in shared memory, laid out so that a
//   lane reads its SPL slots of a plane with 16-byte loads; an insert that
//   shifts orders moves them there a slot a lane, and a __syncwarp opens
//   every message.  This keeps the registers to what one wave needs
//   (__launch_bounds__ asks for 8 blocks of 4 warps an SM at S <= 128, 64
//   registers; spills take 16 bytes of local memory a thread in
//   aggregate mode, 56 in records mode).
//   Records rows of more than 96 entries take a records kernel held to 4
//   blocks (96 registers, no spills, two waves at E = 4096): each message
//   then writes so many rows that the spills cost more than the wave.
// - No global memory on the chain: each warp stages its message stream
//   (and the uniforms of the random-cancel modes) through a two-stage ring
//   of 16-message chunks in shared memory with cp.async, one 16-byte copy
//   a lane; the next chunk loads while this one runs.  The lanes decode the
//   chunk's (type, side) dispatch together, one message a lane, before the
//   chain reads it.  Best quotes (and records mode's fill counts) are
//   staged per chunk and leave as one coalesced 16-byte store a message.
// - Fewer instructions and levels per message: a non-cancel message skips
//   the cancel pass when every live slot of the env's input book had a
//   positive quantity (a per-env flag taken at load; every step of the scan
//   keeps it true), and a non-limit message skips matching when, besides,
//   the matched side's live quantities sum below 2^31 (a saturating upper
//   bound that grows with every insert and every cancel of negative
//   quantity), so no crossing prefix sum can wrap; elsewhere they run in
//   full, the TPU kernel's branch-free semantics.  A limit order that
//   crosses nothing skips the prefix scan (one vote).  An insert finds its
//   place with two reductions (the last order before it and the first
//   after; a gap between them is a hole it takes) and two more only where
//   it shifts orders.  A side's best quote
//   follows a cancel or an insert by arithmetic where the result is sure
//   and is worked out anew (two reductions) otherwise.  Ranks of fills and
//   the random-cancel CDF count by ballot and popcount.
// - Sums in registers: the aggregate kernel is templated on n_agg for 1 and
//   2 traders (a general kernel takes any other n_agg, its sums in shared
//   memory).  Lane i keeps sum i.  A message with fills reduces what its
//   sums need across the warp: three reductions a trader its fills involve
//   (its eight sums follow from them), one vote a trader they do not.
//   int32 addition wraps, so the order does not change the result.  The
//   tick division is a multiply by a 32-bit reciprocal worked out on the
//   host.
// - Records mode writes its rows with streaming stores (written once,
//   never read here).
// All int32 arithmetic that the reference lets wrap is done in uint32.
// No single PyTorch call computes either function.

#include <cuda_runtime.h>
#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kEmpty = -1;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;                 // envs (warps) per block
constexpr int kChunk = 16;                // messages a ring stage holds
constexpr int kStages = 2;
constexpr int kAggStats = 8;
constexpr int kAggTotals = 2;
constexpr int kRecords = -1;              // KIND of the records mode
constexpr int kRecordsWide = -2;          // its kernel for wide rows
constexpr int kWideRows = 96;             // rec_k past which rows are wide
constexpr unsigned kWrap = 1u << 31;      // a quantity sum that may wrap
constexpr int kMaxSpl = 32;               // slots a lane; S <= 1024
enum { OID = 0, TID, TS, TNS, NPL };      // planes in shared memory
enum { F_BID = 1, F_LIM = 2, F_CANCEL = 4 };  // a decoded message's flags

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

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A lane's SPL consecutive ints, with the widest aligned accesses.
template <int SPL>
__device__ __forceinline__ void load_slots(const int* p, int (&v)[SPL]) {
  if constexpr (SPL % 4 == 0) {
#pragma unroll
    for (int j = 0; j < SPL; j += 4) {
      const int4 t = *reinterpret_cast<const int4*>(p + j);
      v[j] = t.x; v[j + 1] = t.y; v[j + 2] = t.z; v[j + 3] = t.w;
    }
  } else if constexpr (SPL == 2) {
    const int2 t = *reinterpret_cast<const int2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = p[0];
  }
}
template <int SPL>
__device__ __forceinline__ void store_slots(int* p, const int (&v)[SPL]) {
  if constexpr (SPL % 4 == 0) {
#pragma unroll
    for (int j = 0; j < SPL; j += 4)
      *reinterpret_cast<int4*>(p + j) =
          make_int4(v[j], v[j + 1], v[j + 2], v[j + 3]);
  } else if constexpr (SPL == 2) {
    *reinterpret_cast<int2*>(p) = make_int2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// A lane's slots of a plane of the book in global memory, whose capacity
// is n: aligned vector accesses in the exact kernels, one int a slot below
// n in the masked ones (slots from n on read `fill`, and are not written).
template <int SPL, bool MASK>
__device__ __forceinline__ void load_plane(const int* p, int base, int n,
                                           int fill, int (&v)[SPL]) {
  if constexpr (!MASK) {
    load_slots<SPL>(p + base, v);
  } else {
#pragma unroll
    for (int j = 0; j < SPL; ++j) v[j] = base + j < n ? p[base + j] : fill;
  }
}
template <int SPL, bool MASK>
__device__ __forceinline__ void store_plane(int* p, int base, int n,
                                            const int (&v)[SPL]) {
  if constexpr (!MASK) {
    store_slots<SPL>(p + base, v);
  } else {
#pragma unroll
    for (int j = 0; j < SPL; ++j)
      if (base + j < n) p[base + j] = v[j];
  }
}

// One warp's shared memory, in ints: the four planes of both sides
// [side][plane][slot], the message ring [stage][message][8], the uniforms'
// ring [stage][message], the staged best quotes [message][4] and fill
// counts [message]; the aggregate kernels append their trader ids (the
// general one its sums first).
template <int SPL>
struct Layout {
  static constexpr int S = SPL * 32;
  static constexpr int ring = 2 * NPL * S;
  static constexpr int uring = ring + kStages * kChunk * 8;
  static constexpr int quotes = uring + kStages * kChunk;
  static constexpr int counts = quotes + kChunk * 4;
  static constexpr int fixed = counts + kChunk;
  static_assert(fixed % 4 == 0, "warp regions stay 16-byte aligned");
};

struct Params {
  int cancel_mode, init_id, maxint, n_agg, n_acc;
  unsigned tick_m;   // floor division by tick: ceil(2^tick_sh / tick)
  int tick_sh;
};

struct Args {
  const int* msgs;
  const int* book_in;
  const int* prev;
  const int* tids;
  const float* uniforms;
  int* book_out;
  int* bidask;
  int* aggs;
  int4* records;
  int* counts;
  int rec_k, E, M, extra;  // extra: ints a warp adds to its Layout
  int n;                   // book capacity S (the masked kernels' bound)
  Params p;
};

// floor(a / tick) for tick > 0 (Python / JAX `//`): |a| maps to a value
// below 2^31 (~a for a < 0), whose quotient by tick is exact as a multiply
// by ceil(2^(31 + s) / tick), s = ceil(log2 tick), and a shift.
__device__ __forceinline__ int floordiv(int a, const Params& p) {
  const unsigned ua = a >= 0 ? (unsigned)a : ~(unsigned)a;
  const unsigned q =
      (unsigned)(((unsigned long long)ua * p.tick_m) >> p.tick_sh);
  return a >= 0 ? (int)q : (int)~q;
}

// A staged message: the fields every step reads, and where the rest (oid,
// tid, ts, tns) lie in shared memory, read where a step needs them.
struct Msg {
  int flags, side, quant, price;
  const int* rest;
};

// Uniform pick among candidate slots, by order id (book_kernel.py:193-211).
// Returns the first live slot holding the picked id, or S.
template <int SPL>
__device__ __forceinline__ int cdf_pick(const bool (&cand)[SPL],
                                        const int (&yo)[SPL],
                                        const bool (&occ)[SPL], float u,
                                        int lane) {
  constexpr int S = SPL * 32;
  const int base = lane * SPL;
  const unsigned lower = (1u << lane) - 1u;
  int total = 0, run = 0;
#pragma unroll
  for (int j = 0; j < SPL; ++j) {
    const unsigned b = __ballot_sync(kFull, cand[j]);
    total += __popc(b);
    run += __popc(b & lower);
  }
  if (total == 0) return S;
  const float uu = __fmul_rn(u, fmaxf((float)total, 1.0f));
  int first_hit = S;
#pragma unroll
  for (int j = 0; j < SPL; ++j) {
    run += cand[j] ? 1 : 0;
    first_hit = (first_hit == S) & ((float)run > uu) ? base + j : first_hit;
  }
  int pick = warp_min(first_hit);
  // f32 corner: no hit -> slot 0 (book_kernel.py:199-206)
  if (pick == S) pick = 0;
  int chosen = 0;
#pragma unroll
  for (int j = 0; j < SPL; ++j)
    chosen = (base + j == pick) & cand[j] ? yo[j] : chosen;
  chosen = __shfl_sync(kFull, chosen, pick / SPL);
  int loc = S;
#pragma unroll
  for (int j = SPL - 1; j >= 0; --j)
    loc = (yo[j] == chosen) & occ[j] ? base + j : loc;
  return warp_min(loc);
}

// The scan's warp-uniform state, the same in every lane: the forward-
// filled best quotes of the last message as its output row [ask_p, ask_q,
// bid_p, bid_q], each side's raw best price (EMPTY when it has none), and
// a saturating bound on each side's live quantities.
enum { ST_QUOTE = 0, ST_BEST = 4, ST_QSUM = 6 };

// Per-warp state the steps share.
template <int SPL>
struct Env {
  int P[2][SPL], Q[2][SPL];   // PRICE and QUANT of [ask, bid]
  int* planes;                // this warp's [side][plane][slot]
  int n;                      // the book's capacity (32 * SPL but masked)
  int st[8];                  // the scan's state (ST_*)
  bool pos;                   // every live quantity > 0
  // aggregate mode: lane i keeps sum i (KIND 1, 2); the general kernel
  // keeps them in shared memory (acc_s); trader ids in shared memory
  unsigned acc;
  int* acc_s;
  const int* tids_s;
};

// A message's fills into the per-trader sums (book_kernel.py:287-326).
// With `pm` a trader's resting orders that filled, its eight sums take
// three warp reductions: A = sum pm q, B = sum pm q (price // tick) and
// C = sum pm q tid.  Where it is the aggressor every fill involves it,
// and sums over all fills stand in (W = sum q, D = sum q tid, made once a
// message, and T = sum q (price // tick), the price-tick total):
//   buy_q = s_pos ? Wq : A,  sell_q = s_pos ? A : Wq    (Wq = agr ? W : 0)
//   buy_pqt = s_pos ? Wp : B, sell_pqt = s_pos ? B : Wp (Wp = agr ? T : 0)
//   a_q = agr ? W : A, a_pqt = agr ? T : B, dur = agr ? D : C,
//   signed = -side * a_q.
template <int SPL, int KIND>
__device__ __forceinline__ void add_sums(Env<SPL>& env, const int* Xpl,
                                         const int (&XP)[SPL],
                                         const int (&matched)[SPL],
                                         int total_matched, const Msg& msg,
                                         const Params& p, int lane) {
  const int n_agg = KIND > 0 ? KIND : p.n_agg;
  const int n_acc = KIND > 0 ? kAggStats * KIND + kAggTotals : p.n_acc;
  if (KIND == 0 && n_agg == 0) return;   // the reference keeps no sums
  constexpr int S = SPL * 32;
  const int base = lane * SPL;
  int xt[SPL];
  load_slots<SPL>(Xpl + TID * S + base, xt);
  int mp[SPL];
  int tpq = 0;
#pragma unroll
  for (int j = 0; j < SPL; ++j) {
    mp[j] = matched[j] > 0 ? wmul(matched[j], floordiv(XP[j], p)) : 0;
    tpq = wadd(tpq, mp[j]);
  }
  tpq = warp_sum(tpq);
  if constexpr (KIND > 0) {
    env.acc += lane == n_acc - 2 ? (unsigned)total_matched : 0u;
    env.acc += lane == n_acc - 1 ? (unsigned)tpq : 0u;
  } else if (lane == 0) {
    env.acc_s[n_acc - 2] = wadd(env.acc_s[n_acc - 2], total_matched);
    env.acc_s[n_acc - 1] = wadd(env.acc_s[n_acc - 1], tpq);
  }
  const bool s_pos = msg.side == 1;
  const int tid = msg.rest[1];
  int W = 0, D = 0;
  bool have_wd = false;
#pragma unroll
  for (int k = 0; k < (KIND > 0 ? KIND : 1); ++k) {
    for (int kk = k; kk < (KIND > 0 ? k + 1 : n_agg); ++kk) {
      const int tk = env.tids_s[kk];
      const bool agr = tid == tk;
      bool pm[SPL];
      bool inv_any = false;
#pragma unroll
      for (int j = 0; j < SPL; ++j) {
        const bool was = matched[j] > 0;
        pm[j] = was & (xt[j] == tk);
        inv_any |= pm[j] | (was & agr);
      }
      if (!__any_sync(kFull, inv_any)) continue;   // every sum adds 0
      int a = 0, b = 0, c = 0;
#pragma unroll
      for (int j = 0; j < SPL; ++j) {
        a = wadd(a, pm[j] ? matched[j] : 0);
        b = wadd(b, pm[j] ? mp[j] : 0);
        c = wadd(c, pm[j] ? wmul(matched[j], xt[j]) : 0);
      }
      a = warp_sum(a);
      b = warp_sum(b);
      if (agr) {
        if (!have_wd) {
          int w = 0, d = 0;
#pragma unroll
          for (int j = 0; j < SPL; ++j) {
            const bool was = matched[j] > 0;
            w = wadd(w, was ? matched[j] : 0);
            d = wadd(d, was ? wmul(matched[j], xt[j]) : 0);
          }
          W = warp_sum(w);
          D = warp_sum(d);
          have_wd = true;
        }
      } else {
        c = warp_sum(c);
      }
      const int wq = agr ? W : 0, wp = agr ? tpq : 0;
      const int iq = agr ? W : a;
      const int v[kAggStats] = {s_pos ? wq : a, s_pos ? a : wq,
                                s_pos ? wp : b, s_pos ? b : wp,
                                iq, agr ? tpq : b, agr ? D : c,
                                wmul(wneg(msg.side), iq)};
      if constexpr (KIND > 0) {
        // lane 8 kk + i keeps sum i of trader kk
        const int i = lane & 7;
        const int lo = (i & 1) ? v[1] : v[0], hi = (i & 1) ? v[3] : v[2];
        const int lo2 = (i & 1) ? v[5] : v[4], hi2 = (i & 1) ? v[7] : v[6];
        const int q4 = (i & 2) ? hi : lo, q8 = (i & 2) ? hi2 : lo2;
        env.acc += (lane >> 3) == kk ? (unsigned)((i & 4) ? q8 : q4) : 0u;
      } else if (lane == 0) {
#pragma unroll
        for (int i = 0; i < kAggStats; ++i)
          env.acc_s[kAggStats * kk + i] =
              wadd(env.acc_s[kAggStats * kk + i], v[i]);
      }
    }
  }
}

// A side's bound on its live quantities grows by `add` (at most 2^31),
// saturating at kWrap.
__device__ __forceinline__ void raise_qsum(int (&st)[8], int side,
                                           unsigned add) {
  const unsigned long long q =
      (unsigned long long)(unsigned)st[ST_QSUM + side] + add;
  st[ST_QSUM + side] = (int)(q < kWrap ? (unsigned)q : kWrap);
}

// A side's new raw best price and quantity into the state: the output
// row keeps the last price a side had (forward fill), quantity 0 while it
// has none.
__device__ __forceinline__ void set_best(int (&st)[8], int side, int b,
                                         int q) {
  st[ST_BEST + side] = b;
  if (b != kEmpty) st[ST_QUOTE + 2 * side] = b;
  st[ST_QUOTE + 2 * side + 1] = b == kEmpty ? 0 : q;
}

// Raw best price of a side and the quantity resting there: the ask's
// lowest price (EMPTY when none or when it is maxint), the bid's highest
// (EMPTY marks no bid; a hole counts as -1, a masked slot not at all: its
// EMPTY price can be the bid's highest only where that is -1, and then
// the masked slots are left out and the highest is worked out again);
// into the state.
template <int SPL, bool ASK, bool MASK>
__device__ __forceinline__ void best_quote(const int (&P)[SPL],
                                           const int (&Q)[SPL], int maxint,
                                           int base, int n, int (&st)[8]) {
  int l = ASK ? INT_MAX : INT_MIN;
#pragma unroll
  for (int j = 0; j < SPL; ++j)
    l = ASK ? min(l, P[j] == kEmpty ? maxint : P[j]) : max(l, P[j]);
  int b = ASK ? warp_min(l) : warp_max(l);
  if (MASK && !ASK && b == kEmpty) {
    l = INT_MIN;
#pragma unroll
    for (int j = 0; j < SPL; ++j) l = max(l, base + j < n ? P[j] : INT_MIN);
    b = warp_max(l);
  }
  if (ASK && b == maxint) b = kEmpty;
  int q = 0;
#pragma unroll
  for (int j = 0; j < SPL; ++j) q = wadd(q, P[j] == b ? Q[j] : 0);
  set_best(st, ASK ? 0 : 1, b, warp_sum(q));
}

// One message in the (X, Y) frame: X is matched against, Y is the side the
// cancel targets and the remainder rests on.  BID: Y is the bid side.
// Returns a bit per side whose best quote must be worked out anew (1 ask,
// 2 bid); in records mode writes the message's rec_k `rows` and its fill
// count to *n_fills.
template <int SPL, bool BID, int KIND, bool MASK>
__device__ __forceinline__ unsigned step(Env<SPL>& env, const Msg& msg,
                                         float u, const Params& p,
                                         int4* rows, int rec_k, int* n_fills,
                                         int lane) {
  constexpr int S = SPL * 32;
  const int n = MASK ? env.n : S;   // the book's capacity
  constexpr int YS = BID ? 1 : 0, XS = 1 - YS;
  const int base = lane * SPL;
  int (&YP)[SPL] = env.P[YS];
  int (&YQ)[SPL] = env.Q[YS];
  int (&XP)[SPL] = env.P[XS];
  int (&XQ)[SPL] = env.Q[XS];
  int* Ypl = env.planes + YS * NPL * S;
  const int* Xpl = env.planes + XS * NPL * S;
  const bool is_lim = msg.flags & F_LIM;
  const bool is_cancel = msg.flags & F_CANCEL;
  unsigned changed = 0;

  // ---- cancel pass on Y (identity for a non-cancel message while every
  // live quantity is positive: it can only reduce a quantity by 0) ----
  if (is_cancel || !env.pos) {
    const int c_quant = is_cancel ? msg.quant : 0;
    const int c_oid = is_cancel ? msg.rest[0] : 0;
    int yo[SPL];
    load_slots<SPL>(Ypl + OID * S + base, yo);
    bool occ[SPL];
    int loc = S;
#pragma unroll
    for (int j = SPL - 1; j >= 0; --j) {
      occ[j] = YP[j] != kEmpty;
      loc = (yo[j] == c_oid) & occ[j] ? base + j : loc;
    }
    int cidx = warp_min(loc);
    if (p.cancel_mode >= 1 && cidx >= S) {
      loc = S;
#pragma unroll
      for (int j = SPL - 1; j >= 0; --j)
        loc = (YP[j] == msg.price) & (yo[j] <= p.init_id) &
                      (YQ[j] >= c_quant) & occ[j]
                  ? base + j
                  : loc;
      cidx = warp_min(loc);
    }
    if (p.cancel_mode >= 2 && cidx >= S) {
      bool cand[SPL];
#pragma unroll
      for (int j = 0; j < SPL; ++j)
        cand[j] = (YP[j] == msg.price) & (YQ[j] >= c_quant) & occ[j] &
                  (yo[j] != 0);
      cidx = cdf_pick<SPL>(cand, yo, occ, u, lane);
    }
    if (p.cancel_mode >= 3 && cidx >= S) {
      bool cand[SPL];
#pragma unroll
      for (int j = 0; j < SPL; ++j)
        cand[j] = (YP[j] == msg.price) & occ[j] & (yo[j] != 0);
      cidx = cdf_pick<SPL>(cand, yo, occ, u, lane);
    }
    if (cidx < S) {
      int pold = 0;
      bool gone = false;
#pragma unroll
      for (int j = 0; j < SPL; ++j) {
        const bool at = base + j == cidx;
        const int nq = wsub(YQ[j], c_quant);
        pold = at ? YP[j] : pold;
        gone |= at & (nq <= 0);
        YQ[j] = at ? nq : YQ[j];
        YP[j] = at & (nq <= 0) ? kEmpty : YP[j];
      }
      // a cancel of negative quantity adds to the slot's
      if (c_quant < 0) raise_qsum(env.st, YS, 0u - (unsigned)c_quant);
      // Y's best quote: a slot off the best price leaves it as it is (a
      // bid side with no hole and only prices below -1 aside, where a
      // wiped slot's -1 becomes the highest); a slot at the best price
      // that stays only takes c_quant off its quantity; else anew.
      pold = __shfl_sync(kFull, pold, cidx / SPL);
      gone = __any_sync(kFull, gone);
      const int b = env.st[ST_BEST + YS];
      if (pold != b) {
        if (BID && b < kEmpty) changed |= 1u << YS;
      } else if (!gone) {
        set_best(env.st, YS, b,
                 wsub(env.st[ST_QUOTE + 2 * YS + 1], c_quant));
      } else {
        changed |= 1u << YS;
      }
    }
  }

  // ---- limit pass: match against X (identity for a non-limit message
  // while quantities are positive and sum below 2^31) ----
  const int lim_quant = is_lim ? msg.quant : 0;
  int total_matched = 0;
  int fills = 0;
  if (is_lim || !env.pos ||
      (unsigned)env.st[ST_QSUM + XS] >= kWrap) {
    bool cross[SPL];
    bool any_cross = false;
#pragma unroll
    for (int j = 0; j < SPL; ++j) {
      const int xp = XP[j];
      cross[j] = (xp != kEmpty) & (BID ? xp <= msg.price : xp >= msg.price);
      any_cross |= cross[j];
    }
    if (__any_sync(kFull, any_cross)) {
      int q[SPL];
      int lsum = 0;
#pragma unroll
      for (int j = 0; j < SPL; ++j) {
        q[j] = cross[j] ? XQ[j] : 0;
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
      total_matched = warp_sum(tm);
      if (__any_sync(kFull, any_local)) {
        if constexpr (KIND < 0) {
          // ---- records (book_kernel.py:241-285): rank = fills up to the
          // slot, counted by ballot
          const unsigned lower = (1u << lane) - 1u;
          int r = 0;
#pragma unroll
          for (int j = 0; j < SPL; ++j) {
            const unsigned b = __ballot_sync(kFull, matched[j] > 0);
            fills += __popc(b);
            r += __popc(b & lower);
          }
          const int neg_s = wneg(msg.side);
#pragma unroll
          for (int j = 0; j < SPL; ++j) {
            if (matched[j] > 0) {
              ++r;
              if (r <= rec_k)
                __stcs(rows + r - 1,
                       make_int4(XP[j], wmul(neg_s, matched[j]),
                                 Xpl[OID * S + base + j],
                                 Xpl[TID * S + base + j]));
            }
          }
        } else {
          add_sums<SPL, KIND>(env, Xpl, XP, matched, total_matched, msg, p,
                              lane);
        }
#pragma unroll
        for (int j = 0; j < SPL; ++j) {
          XQ[j] = wsub(XQ[j], matched[j]);
          XP[j] = (matched[j] > 0) & (XQ[j] <= 0) ? kEmpty : XP[j];
        }
        changed |= 1u << XS;
      }
    }
  }
  if constexpr (KIND < 0) {
    // records are written once and never read here: streaming stores
    for (int k = fills + lane; k < rec_k; k += 32)
      __stcs(rows + k, make_int4(kEmpty, 0, 0, 0));
    *n_fills = fills;
  }

  // ---- insert the remainder into Y (book_kernel.py:332-374) ----
  const int add_q = max(0, wsub(lim_quant, total_matched));
  if (add_q <= 0) return changed;
  const int4 rest = *reinterpret_cast<const int4*>(msg.rest);
  const int nk = BID ? wneg(msg.price) : msg.price;
  // an order rests before the new one if its price is better, or equal
  // and its time no later
  int l_fw = n, l_lb = -1;
  {
    int ys[SPL], yn[SPL];
    load_slots<SPL>(Ypl + TS * S + base, ys);
    load_slots<SPL>(Ypl + TNS * S + base, yn);
#pragma unroll
    for (int j = SPL - 1; j >= 0; --j) {
      const int yp = YP[j];
      const int pk = BID ? wneg(yp) : yp;
      const bool before =
          (pk < nk) | ((pk == nk) & ((ys[j] < rest.z) |
                                     ((ys[j] == rest.z) & (yn[j] <= rest.w))));
      l_fw = (yp != kEmpty) & !before ? base + j : l_fw;
      l_lb = (yp != kEmpty) & before & (l_lb < 0) ? base + j : l_lb;
    }
  }
  const int fw = warp_min(l_fw);
  const int lb = warp_max(l_lb);
  // A slot strictly between the last order before and the first order
  // after the new one is neither, so a hole: the first of them takes it.
  const bool case_a = lb + 1 < fw;
  const int pos_a = lb + 1;
  int first_ha = S, last_hb = -1;
  if (!case_a) {
    int l_ha = S, l_hb = -1;
#pragma unroll
    for (int j = SPL - 1; j >= 0; --j) {
      const bool hole = YP[j] == kEmpty;
      l_ha = hole & (base + j >= fw) ? base + j : l_ha;
      l_hb = hole & (base + j <= lb) & (l_hb < 0) ? base + j : l_hb;
    }
    first_ha = warp_min(l_ha);
    last_hb = warp_max(l_hb);
  }
  // a masked slot reads as a hole, but lies after every real one: the
  // first hole at or after fw is real below n
  const bool case_bh = first_ha < n;
  const bool case_c = last_hb >= 0;
  raise_qsum(env.st, YS, (unsigned)add_q);

  // The best quote of Y after the insert: while a hole takes the order,
  // Y's live (price, quantity) pairs are the old ones and the new order,
  // so the best moves only to (or adds to) the new price.  Worked out anew
  // where the cancel pass left Y's best to be worked out anew, where no
  // hole is left to take the order (the last slot drops out), and for a
  // bid side whose best is EMPTY (holes count as -1 there, and this
  // insert may take the last).
  const bool held = case_a | case_bh | case_c;
  const int b = env.st[ST_BEST + YS];
  if (held && !(changed & (1u << YS)) && (!BID || b != kEmpty)) {
    const int pr = msg.price;
    if (BID ? pr > b : (pr != kEmpty && pr != p.maxint &&
                        (b == kEmpty || pr < b)))
      set_best(env.st, YS, pr, add_q);
    else if (pr == b && pr != kEmpty)
      set_best(env.st, YS, b, wadd(env.st[ST_QUOTE + 2 * YS + 1], add_q));
  } else {
    changed |= 1u << YS;
  }

  if (case_a) {
#pragma unroll
    for (int j = 0; j < SPL; ++j) {
      const bool at = base + j == pos_a;
      YP[j] = at ? msg.price : YP[j];
      YQ[j] = at ? add_q : YQ[j];
    }
    if (lane == pos_a / SPL) {
      Ypl[OID * S + pos_a] = rest.x;
      Ypl[TID * S + pos_a] = rest.y;
      Ypl[TS * S + pos_a] = rest.z;
      Ypl[TNS * S + pos_a] = rest.w;
    }
    return changed;
  }
  // shift (fw_b, ha] right by one slot with the new order at fw_b, or
  // [hb, lb) left by one with the new order at lb; a full book drops its
  // last order (slot n - 1)
  const bool right = !case_c || case_bh;
  const int lo = right ? (case_bh ? fw : min(fw, n - 1)) : last_hb;
  const int hi = right ? (case_bh ? first_ha : n - 1) : lb;
  if (right) {
    // slot i in (lo, hi] takes slot i - 1; lane 0's first slot never moves
    auto shift = [&](int (&v)[SPL], int val) {
      int prev = __shfl_up_sync(kFull, v[SPL - 1], 1);
#pragma unroll
      for (int j = 0; j < SPL; ++j) {
        const int i = base + j, old = v[j];
        v[j] = i == lo ? val : (i > lo) & (i <= hi) ? prev : old;
        prev = old;
      }
    };
    shift(YP, msg.price);
    shift(YQ, add_q);
  } else {
    // slot i in [lo, hi) takes slot i + 1; lane 31's last slot never moves
    auto shift = [&](int (&v)[SPL], int val) {
      int next = __shfl_down_sync(kFull, v[0], 1);
#pragma unroll
      for (int j = SPL - 1; j >= 0; --j) {
        const int i = base + j, old = v[j];
        v[j] = i == hi ? val : (i >= lo) & (i < hi) ? next : old;
        next = old;
      }
    };
    shift(YP, msg.price);
    shift(YQ, add_q);
  }
  // The shared planes: lane t moves the four planes of one slot of a
  // group of 32 slots of the range (most ranges are shorter), a group's
  // reads before its writes, groups from the far end.
  if (right) {   // slots (lo, hi] take their left neighbour
    for (int top = hi; top > lo; top -= 32) {
      const int i = top - lane;
      int v[NPL];
#pragma unroll
      for (int f = 0; f < NPL; ++f) v[f] = i > lo ? Ypl[f * S + i - 1] : 0;
      __syncwarp();
#pragma unroll
      for (int f = 0; f < NPL; ++f)
        if (i > lo) Ypl[f * S + i] = v[f];
    }
  } else {       // slots [lo, hi) take their right neighbour
    for (int bot = lo; bot < hi; bot += 32) {
      const int i = bot + lane;
      int v[NPL];
#pragma unroll
      for (int f = 0; f < NPL; ++f) v[f] = i < hi ? Ypl[f * S + i + 1] : 0;
      __syncwarp();
#pragma unroll
      for (int f = 0; f < NPL; ++f)
        if (i < hi) Ypl[f * S + i] = v[f];
    }
  }
  if (lane < NPL)
    Ypl[lane * S + (right ? lo : hi)] = lane == OID ? rest.x
                                        : lane == TID ? rest.y
                                        : lane == TS ? rest.z : rest.w;
  return changed;
}

// KIND: kRecords or kRecordsWide (records mode: `records` (E, M, rec_k),
// `counts` (E, M)); else aggregate mode with n_agg = KIND traders, or any
// n_agg for KIND 0.  At S <= 128 the kernels keep 8 blocks an SM (one wave
// at E = 4096), but for rows of more than 96 records: held to 4 blocks,
// the records kernel keeps its state in registers where at 8 it spills,
// and past rec_k = 96 its spills cost more than a second wave (PERF.md).
constexpr int min_blocks(int spl, int kind) {
  return spl <= 4 && kind != kRecordsWide ? 8
         : spl <= 8 ? 4 : spl == 16 ? 2 : 1;
}

template <int SPL, int KIND, bool MASK>
__global__ void __launch_bounds__(kWarps * 32, min_blocks(SPL, KIND))
book_scan_kernel(const Args a) {
  constexpr int S = SPL * 32;
  const int n = MASK ? a.n : S;   // the book's capacity
  using L = Layout<SPL>;
  extern __shared__ int4 smem4[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int e = blockIdx.x * kWarps + warp;
  if (e >= a.E) return;   // whole warp; the kernel has no block barrier
  const Params& p = a.p;
  const int base = lane * SPL;
  int* w = reinterpret_cast<int*>(smem4) + warp * (L::fixed + a.extra);
  const int M = a.M;
  const int n_chunks = (M + kChunk - 1) / kChunk;
  const bool want_u = p.cancel_mode >= 2;

  auto issue = [&](int c) {
    const int m0 = c * kChunk, cnt = min(kChunk, M - m0);
    int* dst = w + L::ring + (c & 1) * kChunk * 8;
    if (lane < 2 * cnt)
      cp_async16(dst + lane * 4,
                 a.msgs + ((size_t)e * M + m0) * 8 + lane * 4);
    if (want_u && lane < cnt)
      cp_async4(w + L::uring + (c & 1) * kChunk + lane,
                a.uniforms + (size_t)(m0 + lane) * a.E + e);
  };

  // the four shared planes of both sides and the first chunk, one group
  // (the masked kernels: an int a slot; the masked slots read EMPTY)
  const int* bk = a.book_in + (size_t)e * 2 * 6 * n;
  if constexpr (!MASK) {
    for (int i = lane; i < 2 * NPL * S / 4; i += 32) {
      const int flat = 4 * i, sf = flat / S, slot = flat % S;
      cp_async16(w + flat, bk + ((sf / NPL) * 6 + 2 + sf % NPL) * S + slot);
    }
  } else {
    for (int i = lane; i < 2 * NPL * S; i += 32) {
      const int sf = i / S, slot = i % S;
      if (slot < n)
        cp_async4(w + i, bk + ((sf / NPL) * 6 + 2 + sf % NPL) * n + slot);
      else
        w[i] = kEmpty;
    }
  }
  issue(0);
  cp_commit();

  Env<SPL> env;
  env.planes = w;
  env.n = n;
  load_plane<SPL, MASK>(bk + 0 * n, base, n, kEmpty, env.P[0]);
  load_plane<SPL, MASK>(bk + 1 * n, base, n, 0, env.Q[0]);
  load_plane<SPL, MASK>(bk + 6 * n, base, n, kEmpty, env.P[1]);
  load_plane<SPL, MASK>(bk + 7 * n, base, n, 0, env.Q[1]);
  {
    bool ok = true;
    unsigned lo[2] = {0, 0}, hi[2] = {0, 0};
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int j = 0; j < SPL; ++j) {
        const bool live = env.P[s][j] != kEmpty;
        ok &= !live | (env.Q[s][j] > 0);
        lo[s] += live ? (unsigned)env.Q[s][j] & 0xffffu : 0u;
        hi[s] += live ? (unsigned)env.Q[s][j] >> 16 : 0u;
      }
    env.pos = __all_sync(kFull, ok);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const unsigned long long sum =
          ((unsigned long long)__reduce_add_sync(kFull, hi[s]) << 16) +
          __reduce_add_sync(kFull, lo[s]);
      env.st[ST_QSUM + s] = (int)(sum < kWrap ? (unsigned)sum : kWrap);
    }
  }
  env.acc = 0;
  env.acc_s = w + L::fixed;
  env.tids_s = w + L::fixed + (KIND == 0 ? p.n_acc : 0);
  if constexpr (KIND >= 0) {
    if (KIND == 0)
      for (int i = lane; i < p.n_acc; i += 32) env.acc_s[i] = 0;
    for (int k = lane; k < p.n_agg; k += 32)
      w[L::fixed + (KIND == 0 ? p.n_acc : 0) + k] = a.tids[k];
  }
  best_quote<SPL, true, MASK>(env.P[0], env.Q[0], p.maxint, base, n, env.st);
  best_quote<SPL, false, MASK>(env.P[1], env.Q[1], p.maxint, base, n, env.st);
  // the first message's forward fill starts from prev, not from the input
  // book's best (set after that message, below)
  env.st[ST_QUOTE + 0] = a.prev[2 * e];
  env.st[ST_QUOTE + 2] = a.prev[2 * e + 1];

  for (int c = 0; c < n_chunks; ++c) {
    const int m0 = c * kChunk, cnt = min(kChunk, M - m0);
    if (c + 1 < n_chunks) issue(c + 1);
    cp_commit();
    cp_wait<1>();
    __syncwarp();
    int* ring = w + L::ring + (c & 1) * kChunk * 8;
    if (lane < cnt) {
      // (type, side) dispatch (book_kernel.py:141-150): unknown -> index 0
      const int t = ring[lane * 8], s = ring[lane * 8 + 1];
      int index = 0;
      if ((s == 1 && t == 1) || (s == -1 && t == 4)) index = 1;
      if (s == -1 && (t == 2 || t == 3)) index = 2;
      if (s == 1 && (t == 2 || t == 3)) index = 3;
      if (s == 0 && t == 0) index = 4;
      ring[lane * 8] = (index == 1 || index == 3 ? F_BID : 0) |
                       (index <= 1 ? F_LIM : 0) |
                       (index == 2 || index == 3 ? F_CANCEL : 0);
    }
    __syncwarp();
    for (int k = 0; k < cnt; ++k) {
      // an insert's shift writes other lanes' slots of the shared planes
      __syncwarp();
      const int4 head = *reinterpret_cast<const int4*>(ring + k * 8);
      const Msg msg{head.x, head.y, head.z, head.w, ring + k * 8 + 4};
      const float u = want_u ? reinterpret_cast<const float*>(
                                   w + L::uring)[(c & 1) * kChunk + k]
                             : 0.0f;
      int4* rows = KIND < 0
                       ? a.records + ((size_t)e * M + m0 + k) * a.rec_k
                       : nullptr;
      int n_fills = 0;
      const unsigned anew =
          (msg.flags & F_BID)
              ? step<SPL, true, KIND, MASK>(env, msg, u, p, rows, a.rec_k,
                                            &n_fills, lane)
              : step<SPL, false, KIND, MASK>(env, msg, u, p, rows, a.rec_k,
                                             &n_fills, lane);
      if (anew & 1u)
        best_quote<SPL, true, MASK>(env.P[0], env.Q[0], p.maxint, base, n,
                                    env.st);
      if (anew & 2u)
        best_quote<SPL, false, MASK>(env.P[1], env.Q[1], p.maxint, base, n,
                                     env.st);
      if (m0 + k == 0) {
#pragma unroll
        for (int sd = 0; sd < 2; ++sd)
          if (env.st[ST_BEST + sd] != kEmpty)
            env.st[ST_QUOTE + 2 * sd] = env.st[ST_BEST + sd];
      }
      if (lane == 0) {
        reinterpret_cast<int4*>(w + L::quotes)[k] =
            make_int4(env.st[ST_QUOTE], env.st[ST_QUOTE + 1],
                      env.st[ST_QUOTE + 2], env.st[ST_QUOTE + 3]);
        if constexpr (KIND < 0) w[L::counts + k] = n_fills;
      }
    }
    __syncwarp();
    if (lane < cnt) {
      reinterpret_cast<int4*>(a.bidask)[(size_t)e * M + m0 + lane] =
          reinterpret_cast<const int4*>(w + L::quotes)[lane];
      if constexpr (KIND < 0)
        a.counts[(size_t)e * M + m0 + lane] = w[L::counts + lane];
    }
  }
  cp_wait<0>();

  if constexpr (KIND > 0) {
    if (lane < kAggStats * KIND + kAggTotals)
      a.aggs[(size_t)e * (kAggStats * KIND + kAggTotals) + lane] =
          (int)env.acc;
  } else if constexpr (KIND == 0) {
    __syncwarp();
    for (int i = lane; i < p.n_acc; i += 32)
      a.aggs[(size_t)e * p.n_acc + i] = env.acc_s[i];
  }
  // canonicalise: every plane of a hole reads EMPTY (book_kernel.py:435-442)
  int* ob = a.book_out + (size_t)e * 2 * 6 * n;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    bool hole[SPL];
    int v[SPL];
#pragma unroll
    for (int j = 0; j < SPL; ++j) {
      hole[j] = env.P[s][j] == kEmpty;
      v[j] = hole[j] ? kEmpty : env.Q[s][j];
    }
    store_plane<SPL, MASK>(ob + (s * 6 + 0) * n, base, n, env.P[s]);
    store_plane<SPL, MASK>(ob + (s * 6 + 1) * n, base, n, v);
#pragma unroll
    for (int f = 0; f < NPL; ++f) {
      load_slots<SPL>(w + (s * NPL + f) * S + base, v);
#pragma unroll
      for (int j = 0; j < SPL; ++j) v[j] = hole[j] ? kEmpty : v[j];
      store_plane<SPL, MASK>(ob + (s * 6 + 2 + f) * n, base, n, v);
    }
  }
}

// Ints a warp adds to its Layout: the aggregate kernels' trader ids, and
// the general one's sums before them.
constexpr int extra_ints(int kind, int n_agg, int n_acc) {
  return kind < 0 ? 0 : ((kind == 0 ? n_acc : 0) + n_agg + 3) / 4 * 4;
}

// The launch plan of one instantiation, made once per (S, mode, n_agg,
// device) by the wrapper before its first launch: out = {registers a
// thread, local bytes a thread (spills), dynamic shared bytes a block,
// blocks an SM, threads a block, 0}.  Allows the dynamic shared memory
// past 48 KB where it goes there (the general kernel with many traders, and
// SPL 16 and 32).
template <int SPL, int KIND, bool MASK>
cudaError_t plan(int n_agg, int* out) {
  const size_t smem =
      (size_t)kWarps *
      (Layout<SPL>::fixed +
       extra_ints(KIND, n_agg, kAggStats * n_agg + kAggTotals)) *
      sizeof(int);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    // every size a block may take: the general kernel's plans for other
    // trader counts share the kernel
    int dev = 0, optin = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(book_scan_kernel<SPL, KIND, MASK>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 optin);
  }
  cudaFuncAttributes attr{};
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, book_scan_kernel<SPL, KIND, MASK>);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, book_scan_kernel<SPL, KIND, MASK>, kWarps * 32, smem);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)smem;
  out[3] = blocks;
  out[4] = kWarps * 32;
  out[5] = 0;
  return err;
}

// A launch with the dynamic shared memory of its plan.
template <int SPL, int KIND, bool MASK>
cudaError_t launch(Args a, int smem, cudaStream_t stream) {
  a.extra = extra_ints(KIND, a.p.n_agg, a.p.n_acc);
  const dim3 grid((a.E + kWarps - 1) / kWarps), block(kWarps * 32);
  book_scan_kernel<SPL, KIND, MASK><<<grid, block, smem, stream>>>(a);
  return cudaGetLastError();
}

// kind: kRecords, kRecordsWide, or the aggregate kernel's KIND for n_agg
// (1, 2, else 0).  With `a` null, makes the plan for n_agg into out; else
// launches.  Past SPL 8 one records kernel and the general aggregate
// kernel take every kind (the launch bounds no longer differ).
template <int SPL, bool MASK>
int dispatch(int kind, const Args* a, int n_agg, int* out, int smem,
             cudaStream_t st) {
  if constexpr (SPL > 8) {
    if (kind < 0)
      return a ? launch<SPL, kRecords, MASK>(*a, smem, st)
               : plan<SPL, kRecords, MASK>(n_agg, out);
    return a ? launch<SPL, 0, MASK>(*a, smem, st)
             : plan<SPL, 0, MASK>(n_agg, out);
  } else {
    switch (kind) {
      case kRecords:
        return a ? launch<SPL, kRecords, MASK>(*a, smem, st)
                 : plan<SPL, kRecords, MASK>(n_agg, out);
      case kRecordsWide:
        return a ? launch<SPL, kRecordsWide, MASK>(*a, smem, st)
                 : plan<SPL, kRecordsWide, MASK>(n_agg, out);
      case 1:
        return a ? launch<SPL, 1, MASK>(*a, smem, st)
                 : plan<SPL, 1, MASK>(n_agg, out);
      case 2:
        return a ? launch<SPL, 2, MASK>(*a, smem, st)
                 : plan<SPL, 2, MASK>(n_agg, out);
      default:
        return a ? launch<SPL, 0, MASK>(*a, smem, st)
                 : plan<SPL, 0, MASK>(n_agg, out);
    }
  }
}

// ---------------------------------------------------------------------------
// The block route: any capacity S >= 1 (the wrappers' route past 1,024
// slots, where one warp cannot hold an env: 64 slots a lane would take 256
// registers for the price and quantity planes alone).
//
// One block of kBlock threads owns one env; thread t owns the consecutive
// slots [t c, t c + c) of every plane, c = ceil(S / kBlock), so the scan
// runs the plain version's semantics as written: every message takes the
// whole cancel chain, the prefix sum, the insert and both sides' best
// quotes anew, with none of the warp route's shortcuts.  A pass over a
// thread's slots is its own; what crosses threads goes through block
// reductions (a warp's __reduce_*_sync or shuffle scan, then one barrier
// and a read of every warp's value from shared memory, in two alternating
// buffers so that no second barrier is needed) and through the insert's
// shift, whose slots at a thread's edge are read before a barrier and
// written after it.  Control flow depends only on the message and on
// reduced values, so every thread takes every barrier.
//
// The book lives in shared memory where its 48 S bytes fit (S up to about
// 4,600), a word of padding every 32 slots so that threads reading slot
// t c + i fall in different banks, and otherwise in the output book in
// device memory, read through L1 and L2.  The kernel is built once per
// mode and place (4 kernels), not once per capacity.
// ---------------------------------------------------------------------------

constexpr int kBlock = 256;                    // threads an env
constexpr int kBlockWarps = kBlock / 32;
constexpr int kRedVals = 8;                    // values a reduction carries

// Ints of a block's shared memory before the book: the reduction buffers,
// then (aggregate mode) the sums and the trader ids.
constexpr int block_fixed_ints(bool rec, int n_agg, int n_acc) {
  return (2 * kBlockWarps * kRedVals + (rec ? 0 : n_acc + n_agg) + 3) / 4 *
         4;
}
// Ints of a plane of the book in shared memory (a word every 32 slots).
__host__ __device__ constexpr int padded_plane(int S) {
  return S + (S + 31) / 32;
}

// Block-wide reductions in two alternating buffers [2][warps][kRedVals].
struct Rounds {
  int* buf;
  int n, warp, lane;
  __device__ int* next() {
    int* b = buf + (n & 1) * kBlockWarps * kRedVals;
    ++n;
    return b;
  }
};

// Every thread's v[i] becomes the block's minimum (MIN) or wrapping sum.
template <bool MIN, int NV>
__device__ __forceinline__ void block_reduce(Rounds& r, int (&v)[NV]) {
  int* b = r.next();
#pragma unroll
  for (int i = 0; i < NV; ++i)
    v[i] = MIN ? warp_min(v[i]) : warp_sum(v[i]);
  if (r.lane == 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) b[r.warp * kRedVals + i] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    int x = b[i];
    for (int w = 1; w < kBlockWarps; ++w)
      x = MIN ? min(x, b[w * kRedVals + i]) : wadd(x, b[w * kRedVals + i]);
    v[i] = x;
  }
}

// Exclusive wrapping prefix sums of v[i] over the threads in order, and
// their totals.
template <int NV>
__device__ __forceinline__ void block_scan(Rounds& r, const int (&v)[NV],
                                           int (&excl)[NV],
                                           int (&total)[NV]) {
  int* b = r.next();
  int inc[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) inc[i] = warp_scan(v[i], r.lane);
  if (r.lane == 31) {
#pragma unroll
    for (int i = 0; i < NV; ++i) b[r.warp * kRedVals + i] = inc[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    int pre = 0, tot = 0;
    for (int w = 0; w < kBlockWarps; ++w) {
      const int x = b[w * kRedVals + i];
      pre = w < r.warp ? wadd(pre, x) : pre;
      tot = wadd(tot, x);
    }
    excl[i] = wadd(pre, wsub(inc[i], v[i]));
    total[i] = tot;
  }
}

// The block's view of the book: plane f of side s, slot j.
template <bool SHARED>
struct BlockBook {
  int* base;
  int stride;   // ints a plane
  __device__ int* plane(int s, int f) const {
    return base + (s * 6 + f) * stride;
  }
  __device__ static int at(int j) { return SHARED ? j + (j >> 5) : j; }
};

enum { BP = 0, BQ, BO, BT, BTS, BTN };   // the planes of the global layout

// Uniform pick among the candidates of `cand(j)`, by order id, as
// cdf_pick does in a warp (book_kernel.py:193-211).
template <bool SHARED, class Cand>
__device__ __forceinline__ int block_cdf_pick(Rounds& r, const int* Yp,
                                              const int* Yo, int lo, int hi,
                                              int S, float u, Cand cand) {
  using B = BlockBook<SHARED>;
  int cnt = 0;
  for (int j = lo; j < hi; ++j) cnt += cand(j) ? 1 : 0;
  int c1[1] = {cnt}, ex[1], tot[1];
  block_scan(r, c1, ex, tot);
  if (tot[0] == 0) return S;
  const float uu = __fmul_rn(u, fmaxf((float)tot[0], 1.0f));
  int run = ex[0], hit = S;
  for (int j = lo; j < hi; ++j) {
    run += cand(j) ? 1 : 0;
    if (hit == S && (float)run > uu) hit = j;
  }
  int v[1] = {hit};
  block_reduce<true>(r, v);
  const int pick = v[0] == S ? 0 : v[0];   // f32 corner: no hit -> slot 0
  int ch[1] = {pick >= lo && pick < hi && cand(pick) ? Yo[B::at(pick)] : 0};
  block_reduce<false>(r, ch);
  int loc = S;
  for (int j = lo; j < hi && loc == S; ++j)
    if (Yp[B::at(j)] != kEmpty && Yo[B::at(j)] == ch[0]) loc = j;
  v[0] = loc;
  block_reduce<true>(r, v);
  return v[0];
}

// Shift slots (lo, hi] of side `side` right by one (RIGHT) or [lo, hi)
// left by one, and put the new order at lo (RIGHT) or hi.  A thread reads
// the slot beyond its edge before the barrier and writes its own after.
template <bool SHARED, bool RIGHT>
__device__ __forceinline__ void block_shift(const BlockBook<SHARED>& bk,
                                            int side, int lo, int hi,
                                            int my_lo, int my_hi,
                                            const int (&nv)[6]) {
  using B = BlockBook<SHARED>;
  int edge[6];
  const int src = RIGHT ? my_lo - 1 : my_hi;
  const bool need = my_lo < my_hi &&
                    (RIGHT ? my_lo > lo && my_lo <= hi
                           : my_hi - 1 >= lo && my_hi - 1 < hi);
#pragma unroll
  for (int f = 0; f < 6; ++f)
    edge[f] = need ? bk.plane(side, f)[B::at(src)] : 0;
  __syncthreads();
#pragma unroll
  for (int f = 0; f < 6; ++f) {
    int* pl = bk.plane(side, f);
    if (RIGHT) {
      for (int j = min(hi, my_hi - 1); j >= max(lo + 1, my_lo); --j)
        pl[B::at(j)] = j > my_lo ? pl[B::at(j - 1)] : edge[f];
    } else {
      for (int j = max(lo, my_lo); j <= min(hi - 1, my_hi - 1); ++j)
        pl[B::at(j)] = j < my_hi - 1 ? pl[B::at(j + 1)] : edge[f];
    }
    const int at = RIGHT ? lo : hi;
    if (at >= my_lo && at < my_hi) pl[B::at(at)] = nv[f];
  }
}

// REC: records mode, else aggregate mode with any n_agg.  SHARED: the
// book in shared memory at int a.extra, else in a.book_out.
template <bool REC, bool SHARED>
__global__ void __launch_bounds__(kBlock, 2)
book_scan_kernel_block(const Args a) {
  using B = BlockBook<SHARED>;
  const int S = a.n, M = a.M, e = blockIdx.x;
  const int t = threadIdx.x;
  const Params& p = a.p;
  extern __shared__ int4 smem4[];
  int* sm = reinterpret_cast<int*>(smem4);
  Rounds rd{sm, 0, t >> 5, t & 31};
  int* acc = sm + 2 * kBlockWarps * kRedVals;
  int* tids_s = acc + p.n_acc;
  int* gbook = a.book_out + (size_t)e * 12 * S;
  const BlockBook<SHARED> bk{SHARED ? sm + a.extra : gbook,
                             SHARED ? padded_plane(S) : S};
  const int* src = a.book_in + (size_t)e * 12 * S;
  if constexpr (SHARED) {
    for (int i = t; i < 12 * S; i += kBlock)
      bk.base[(i / S) * bk.stride + B::at(i % S)] = src[i];
  } else {
    for (int i = t; i < 3 * S; i += kBlock)
      reinterpret_cast<int4*>(gbook)[i] =
          reinterpret_cast<const int4*>(src)[i];
  }
  if constexpr (!REC) {
    for (int i = t; i < p.n_acc; i += kBlock) acc[i] = 0;
    for (int k = t; k < p.n_agg; k += kBlock) tids_s[k] = a.tids[k];
  }
  __syncthreads();
  const int c = (S + kBlock - 1) / kBlock;
  const int my_lo = min(t * c, S), my_hi = min(my_lo + c, S);
  int prev_a = a.prev[2 * e], prev_b = a.prev[2 * e + 1];

  for (int m = 0; m < M; ++m) {
    const int* mp = a.msgs + ((size_t)e * M + m) * 8;
    const int4 head = *reinterpret_cast<const int4*>(mp);
    const int4 rest = *reinterpret_cast<const int4*>(mp + 4);
    const int ty = head.x, sd = head.y, quant = head.z, price = head.w;
    // (type, side) dispatch (book_kernel.py:141-150): unknown -> index 0
    int index = 0;
    if ((sd == 1 && ty == 1) || (sd == -1 && ty == 4)) index = 1;
    if (sd == -1 && (ty == 2 || ty == 3)) index = 2;
    if (sd == 1 && (ty == 2 || ty == 3)) index = 3;
    if (sd == 0 && ty == 0) index = 4;
    const bool is_lim = index <= 1, is_cancel = index == 2 || index == 3;
    const bool bid = index == 1 || index == 3;
    const int YS = bid ? 1 : 0, XS = 1 - YS;
    const float u = p.cancel_mode >= 2 ? a.uniforms[(size_t)m * a.E + e]
                                       : 0.0f;
    int* Yp = bk.plane(YS, BP);
    int* Yq = bk.plane(YS, BQ);
    const int* Yo = bk.plane(YS, BO);
    int* Xp = bk.plane(XS, BP);
    int* Xq = bk.plane(XS, BQ);

    // ---- cancel pass on Y ----
    const int c_quant = is_cancel ? quant : 0;
    const int c_oid = is_cancel ? rest.x : 0;
    int cv[2] = {S, S};
    for (int j = my_lo; j < my_hi; ++j) {
      const int yp = Yp[B::at(j)], yo = Yo[B::at(j)];
      if (yp == kEmpty) continue;
      if (cv[0] == S && yo == c_oid) cv[0] = j;
      if (cv[1] == S && yp == price && yo <= p.init_id &&
          Yq[B::at(j)] >= c_quant)
        cv[1] = j;
    }
    block_reduce<true>(rd, cv);
    int cidx = cv[0] < S ? cv[0] : p.cancel_mode >= 1 ? cv[1] : S;
    if (p.cancel_mode >= 2 && cidx >= S)
      cidx = block_cdf_pick<SHARED>(
          rd, Yp, Yo, my_lo, my_hi, S, u, [&](int j) {
            const int yp = Yp[B::at(j)];
            return yp != kEmpty && yp == price && Yq[B::at(j)] >= c_quant &&
                   Yo[B::at(j)] != 0;
          });
    if (p.cancel_mode >= 3 && cidx >= S)
      cidx = block_cdf_pick<SHARED>(
          rd, Yp, Yo, my_lo, my_hi, S, u, [&](int j) {
            const int yp = Yp[B::at(j)];
            return yp != kEmpty && yp == price && Yo[B::at(j)] != 0;
          });
    if (cidx >= my_lo && cidx < my_hi) {
      const int nq = wsub(Yq[B::at(cidx)], c_quant);
      Yq[B::at(cidx)] = nq;
      if (nq <= 0) Yp[B::at(cidx)] = kEmpty;
    }

    // ---- limit pass: match against X by prefix sum over crossing slots ----
    const int lim_quant = is_lim ? quant : 0;
    auto crosses = [&](int j) {
      const int xp = Xp[B::at(j)];
      return xp != kEmpty && (bid ? xp <= price : xp >= price);
    };
    int sv[2] = {0, 0}, base[2], tot[2];
    for (int j = my_lo; j < my_hi; ++j)
      if (crosses(j)) {
        sv[0] = wadd(sv[0], Xq[B::at(j)]);
        ++sv[1];
      }
    block_scan(rd, sv, base, tot);
    // f(j, matched) over this thread's crossing slots, in order
    auto each_match = [&](auto f) {
      int cum = base[0];
      for (int j = my_lo; j < my_hi; ++j) {
        if (!crosses(j)) continue;
        const int q = Xq[B::at(j)];
        cum = wadd(cum, q);
        f(j, min(max(wsub(lim_quant, wsub(cum, q)), 0), q));
      }
    };
    int total_matched = 0, fills = 0;
    if (tot[1] > 0) {
      // matched, fills, and the fills' quantity x (price // tick)
      int sums[3] = {0, 0, 0};
      each_match([&](int j, int x) {
        sums[0] = wadd(sums[0], x);
        if (x > 0) {
          ++sums[1];
          sums[2] = wadd(sums[2], wmul(x, floordiv(Xp[B::at(j)], p)));
        }
      });
      const int my_fills = sums[1];
      block_reduce<false>(rd, sums);
      total_matched = sums[0];
      fills = sums[1];
      if constexpr (REC) {
        // rank = fills up to the slot (book_kernel.py:241-285)
        int nf[1] = {my_fills}, ex[1], nt[1];
        block_scan(rd, nf, ex, nt);
        int4* rows = a.records + ((size_t)e * M + m) * a.rec_k;
        const int neg_s = wneg(sd);
        const int* Xo = bk.plane(XS, BO);
        const int* Xt = bk.plane(XS, BT);
        int r = ex[0];
        each_match([&](int j, int x) {
          if (x > 0 && ++r <= a.rec_k)
            __stcs(rows + r - 1, make_int4(Xp[B::at(j)], wmul(neg_s, x),
                                           Xo[B::at(j)], Xt[B::at(j)]));
        });
      } else if (p.n_agg > 0) {
        // the sums of book_kernel.py:287-326
        if (t == 0) {
          acc[p.n_acc - 2] = wadd(acc[p.n_acc - 2], total_matched);
          acc[p.n_acc - 1] = wadd(acc[p.n_acc - 1], sums[2]);
        }
        const int* Xt = bk.plane(XS, BT);
        const bool s_pos = sd == 1;
        for (int k = 0; k < p.n_agg && fills > 0; ++k) {
          const int tk = tids_s[k];
          const bool agr = rest.y == tk;
          // buy_q, sell_q, buy_pqt, sell_pqt, a_q, a_pqt, dur
          int v[7] = {0, 0, 0, 0, 0, 0, 0};
          each_match([&](int j, int x) {
            const int xt = Xt[B::at(j)];
            const bool pm = xt == tk;
            if (x <= 0 || !(pm || agr)) return;
            const int mpt = wmul(x, floordiv(Xp[B::at(j)], p));
            const bool buy = s_pos ? agr : pm, sell = s_pos ? pm : agr;
            v[0] = wadd(v[0], buy ? x : 0);
            v[1] = wadd(v[1], sell ? x : 0);
            v[2] = wadd(v[2], buy ? mpt : 0);
            v[3] = wadd(v[3], sell ? mpt : 0);
            v[4] = wadd(v[4], x);
            v[5] = wadd(v[5], mpt);
            v[6] = wadd(v[6], wmul(x, xt));
          });
          block_reduce<false>(rd, v);
          if (t == 0) {
            int* o = acc + kAggStats * k;
#pragma unroll
            for (int i = 0; i < 7; ++i) o[i] = wadd(o[i], v[i]);
            o[7] = wadd(o[7], wmul(wneg(sd), v[4]));
          }
        }
      }
      each_match([&](int j, int x) {
        const int nq = wsub(Xq[B::at(j)], x);
        Xq[B::at(j)] = nq;
        if (x > 0 && nq <= 0) Xp[B::at(j)] = kEmpty;
      });
    }
    if constexpr (REC) {
      int4* rows = a.records + ((size_t)e * M + m) * a.rec_k;
      for (int k = fills + t; k < a.rec_k; k += kBlock)
        __stcs(rows + k, make_int4(kEmpty, 0, 0, 0));
      if (t == 0) a.counts[(size_t)e * M + m] = fills;
    }

    // ---- insert the remainder into Y (book_kernel.py:332-374) ----
    const int add_q = max(0, wsub(lim_quant, total_matched));
    if (add_q > 0) {
      const int* Ys = bk.plane(YS, BTS);
      const int* Yn = bk.plane(YS, BTN);
      const int nk = bid ? wneg(price) : price;
      // the first order after the new one, ~ the last before it
      int fl[2] = {S, ~(-1)};
      for (int j = my_lo; j < my_hi; ++j) {
        const int yp = Yp[B::at(j)];
        if (yp == kEmpty) continue;
        const int pk = bid ? wneg(yp) : yp;
        const int ys = Ys[B::at(j)];
        const bool before =
            pk < nk ||
            (pk == nk &&
             (ys < rest.z || (ys == rest.z && Yn[B::at(j)] <= rest.w)));
        if (!before && fl[0] == S) fl[0] = j;
        if (before) fl[1] = ~j;
      }
      block_reduce<true>(rd, fl);
      const int fw = fl[0], lb = ~fl[1];
      const int nv[6] = {price, add_q, rest.x, rest.y, rest.z, rest.w};
      if (lb + 1 < fw) {
        // a slot strictly between them is a hole: the first takes it
        const int pos = lb + 1;
        if (pos >= my_lo && pos < my_hi)
#pragma unroll
          for (int f = 0; f < 6; ++f) bk.plane(YS, f)[B::at(pos)] = nv[f];
      } else {
        // the first hole at or after fw, ~ the last at or before lb
        int hl[2] = {S, ~(-1)};
        for (int j = my_lo; j < my_hi; ++j) {
          if (Yp[B::at(j)] != kEmpty) continue;
          if (j >= fw && hl[0] == S) hl[0] = j;
          if (j <= lb) hl[1] = ~j;
        }
        block_reduce<true>(rd, hl);
        const int ha = hl[0], hb = ~hl[1];
        // shift (fw_b, ha] right with the new order at fw_b, or [hb, lb)
        // left with it at lb; a full book drops its last order
        if (ha < S || hb < 0)
          block_shift<SHARED, true>(bk, YS, ha < S ? fw : min(fw, S - 1),
                                    ha < S ? ha : S - 1, my_lo, my_hi, nv);
        else
          block_shift<SHARED, false>(bk, YS, hb, lb, my_lo, my_hi, nv);
      }
    }

    // ---- best ask and bid, forward-filled from the previous message ----
    const int* Ap = bk.plane(0, BP);
    const int* Bp = bk.plane(1, BP);
    int best[2] = {INT_MAX, ~INT_MIN};
    for (int j = my_lo; j < my_hi; ++j) {
      const int ap = Ap[B::at(j)];
      best[0] = min(best[0], ap == kEmpty ? p.maxint : ap);
      best[1] = min(best[1], ~Bp[B::at(j)]);
    }
    block_reduce<true>(rd, best);
    const int ba = best[0] == p.maxint ? kEmpty : best[0], bb = ~best[1];
    int bq[2] = {0, 0};
    const int* Aq = bk.plane(0, BQ);
    const int* Bq = bk.plane(1, BQ);
    for (int j = my_lo; j < my_hi; ++j) {
      bq[0] = wadd(bq[0], Ap[B::at(j)] == ba ? Aq[B::at(j)] : 0);
      bq[1] = wadd(bq[1], Bp[B::at(j)] == bb ? Bq[B::at(j)] : 0);
    }
    block_reduce<false>(rd, bq);
    prev_a = ba == kEmpty ? prev_a : ba;
    prev_b = bb == kEmpty ? prev_b : bb;
    if (t == 0)
      reinterpret_cast<int4*>(a.bidask)[(size_t)e * M + m] =
          make_int4(prev_a, ba == kEmpty ? 0 : bq[0], prev_b,
                    bb == kEmpty ? 0 : bq[1]);
  }

  // canonicalise: every plane of a hole reads EMPTY (book_kernel.py:435-442)
  for (int s = 0; s < 2; ++s)
    for (int j = my_lo; j < my_hi; ++j)
      if (bk.plane(s, BP)[B::at(j)] == kEmpty)
        for (int f = 1; f < 6; ++f) bk.plane(s, f)[B::at(j)] = kEmpty;
  __syncthreads();
  if constexpr (SHARED) {
    for (int i = t; i < 12 * S; i += kBlock)
      gbook[i] = bk.base[(i / S) * bk.stride + B::at(i % S)];
  }
  if constexpr (!REC) {
    for (int i = t; i < p.n_acc; i += kBlock)
      a.aggs[(size_t)e * p.n_acc + i] = acc[i];
  }
}

// Dynamic shared bytes of the block route at capacity S on the current
// device (the book's too where it fits), and the most a block may take.
cudaError_t block_smem(int S, bool rec, int n_agg, size_t* fixed,
                       size_t* smem, int* optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  *fixed = (size_t)block_fixed_ints(rec, n_agg,
                                    kAggStats * n_agg + kAggTotals) *
           sizeof(int);
  const size_t book = (size_t)12 * padded_plane(S) * sizeof(int);
  *smem = *fixed + book <= (size_t)*optin ? *fixed + book : *fixed;
  return err;
}

// The kernel's attribute allows every size a block may take: plans of
// several capacities and trader counts share the kernel.
template <bool REC, bool SHARED>
cudaError_t block_plan(size_t smem, int optin, int* out) {
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(book_scan_kernel_block<REC, SHARED>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
  cudaFuncAttributes attr{};
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, book_scan_kernel_block<REC, SHARED>);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, book_scan_kernel_block<REC, SHARED>, kBlock, smem);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)smem;
  out[3] = blocks;
  out[4] = kBlock;
  out[5] = SHARED ? 0 : 1;
  return err;
}

// The block route: with `a` null makes the plan for S into out; else
// launches with the plan's shared bytes, which say where the book lives.
int dispatch_block(int S, bool rec, const Args* a, int n_agg, int* out,
                   int smem, cudaStream_t st) {
  if (!a) {
    size_t fixed = 0, want = 0;
    int optin = 0;
    cudaError_t err = block_smem(S, rec, n_agg, &fixed, &want, &optin);
    if (err != cudaSuccess) return (int)err;
    const bool shared = want > fixed;
    return rec ? (shared ? block_plan<true, true>(want, optin, out)
                         : block_plan<true, false>(want, optin, out))
               : (shared ? block_plan<false, true>(want, optin, out)
                         : block_plan<false, false>(want, optin, out));
  }
  Args b = *a;
  b.extra = block_fixed_ints(rec, b.p.n_agg, b.p.n_acc);
  const bool shared =
      (size_t)smem >= (size_t)(b.extra + 12 * padded_plane(S)) * sizeof(int);
  const dim3 grid(b.E), block(kBlock);
  if (rec) {
    if (shared)
      book_scan_kernel_block<true, true><<<grid, block, smem, st>>>(b);
    else
      book_scan_kernel_block<true, false><<<grid, block, smem, st>>>(b);
  } else {
    if (shared)
      book_scan_kernel_block<false, true><<<grid, block, smem, st>>>(b);
    else
      book_scan_kernel_block<false, false><<<grid, block, smem, st>>>(b);
  }
  return (int)cudaGetLastError();
}

// The slot map (spl slots a lane, masked or not; spl 0: the block route)
// is the caller's (ops/book_kernel.py::capacity_route); a map that does
// not hold S, or an exact map of another capacity, is refused.
int dispatch_s(int S, int spl, int masked, int kind, const Args* a,
               int n_agg, int* out, int smem, cudaStream_t st) {
  if (S < 1) return (int)cudaErrorInvalidValue;
  if (spl == 0)
    return dispatch_block(S, kind < 0, a, n_agg, out, smem, st);
  if (spl < 1 || spl > kMaxSpl || S > 32 * spl ||
      (!masked && S != 32 * spl))
    return (int)cudaErrorInvalidValue;
  if (!masked) {
    switch (spl) {
      case 1: return dispatch<1, false>(kind, a, n_agg, out, smem, st);
      case 2: return dispatch<2, false>(kind, a, n_agg, out, smem, st);
      case 4: return dispatch<4, false>(kind, a, n_agg, out, smem, st);
      case 8: return dispatch<8, false>(kind, a, n_agg, out, smem, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (spl) {
    case 1: return dispatch<1, true>(kind, a, n_agg, out, smem, st);
    case 2: return dispatch<2, true>(kind, a, n_agg, out, smem, st);
    case 4: return dispatch<4, true>(kind, a, n_agg, out, smem, st);
    case 8: return dispatch<8, true>(kind, a, n_agg, out, smem, st);
    case 16: return dispatch<16, true>(kind, a, n_agg, out, smem, st);
    case 32: return dispatch<32, true>(kind, a, n_agg, out, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int agg_kind(int n_agg) { return n_agg == 1 || n_agg == 2 ? n_agg : 0; }
int records_kind(int rec_k) {
  return rec_k > kWideRows ? kRecordsWide : kRecords;
}

Params make_params(int cancel_mode, int init_id, int maxint, int n_agg,
                   int tick) {
  int s = 0;
  while ((1ll << s) < (long long)tick) ++s;   // ceil(log2 tick)
  const unsigned long long num = 1ull << (31 + s);
  const unsigned m = (unsigned)((num + (unsigned)tick - 1) / (unsigned)tick);
  return Params{cancel_mode, init_id, maxint, n_agg,
                kAggStats * n_agg + kAggTotals, m, 31 + s};
}

}  // namespace

// Plain C interface (loaded with ctypes).  Layouts, all int32 unless noted:
// msgs (E, M, 8); book_in/book_out (E, 2, 6, S) [env, ask/bid, field, slot],
// the capacity S (any S >= 1) on the slot map (spl, masked; spl 0 the
// block route);
// prev (E, 2); tids (n_agg,); uniforms (M, E) float32, read only when
// cancel_mode >= 2; bidask (E, M, 4) [ask_p, ask_q, bid_p, bid_q];
// aggs (E, 8 * n_agg + 2).  msgs, book_in, book_out and bidask 16-byte
// aligned; tick > 0; smem the dynamic shared bytes of the kernel's plan
// (book_scan_plan, made first).  Launches on `stream`, does not
// synchronise, returns the cudaError_t of the launch.
extern "C" int book_scan_aggs(const int* msgs, const int* book_in,
                              const int* prev, const int* tids,
                              const float* uniforms, int* book_out,
                              int* bidask, int* aggs, int E, int M, int S,
                              int spl, int masked, int n_agg,
                              int cancel_mode, int init_id, int tick,
                              int maxint, int smem, void* stream) {
  if (E <= 0 || M <= 0) return 0;
  if (tick <= 0) return (int)cudaErrorInvalidValue;
  const Args a{msgs, book_in, prev, tids, uniforms, book_out, bidask, aggs,
               nullptr, nullptr, 0, E, M, 0, S,
               make_params(cancel_mode, init_id, maxint, n_agg, tick)};
  return dispatch_s(S, spl, masked, agg_kind(n_agg), &a, n_agg, nullptr,
                    smem, static_cast<cudaStream_t>(stream));
}

// Records mode: as book_scan_aggs without trader ids and sums; records
// (E, M, rec_k, 4) [price, -side * quant, passive oid, passive tid], rows
// past a message's fills (EMPTY, 0, 0, 0), 16-byte aligned; fill_counts
// (E, M), uncapped.  1 <= rec_k <= S.
extern "C" int book_scan_records(const int* msgs, const int* book_in,
                                 const int* prev, const float* uniforms,
                                 int* book_out, int* bidask, int* records,
                                 int* fill_counts, int E, int M, int S,
                                 int spl, int masked, int rec_k,
                                 int cancel_mode, int init_id, int maxint,
                                 int smem, void* stream) {
  if (E <= 0 || M <= 0) return 0;
  if (rec_k < 1 || rec_k > S) return (int)cudaErrorInvalidValue;
  const Args a{msgs, book_in, prev, nullptr, uniforms, book_out, bidask,
               nullptr, reinterpret_cast<int4*>(records), fill_counts,
               rec_k, E, M, 0, S,
               make_params(cancel_mode, init_id, maxint, 0, 1)};
  return dispatch_s(S, spl, masked, records_kind(rec_k), &a, 0, nullptr,
                    smem, static_cast<cudaStream_t>(stream));
}

// The launch plan of the kernel that book_scan_records (n_agg < 0, for
// rec_k) or book_scan_aggs (n_agg >= 0) launches at capacity S on the slot
// map (spl, masked), on the current device: out[6] = {registers a thread,
// spill bytes a thread, dynamic shared bytes a block, resident blocks an
// SM, threads a block (4 envs a block of 128 on the warp route, one env a
// block of 256 on the block route), 1 where the block route keeps the book
// in device memory, else 0}.  Made once before the kernel's first launch on
// the device.
extern "C" int book_scan_plan(int S, int spl, int masked, int n_agg,
                              int rec_k, int* out) {
  return dispatch_s(S, spl, masked,
                    n_agg < 0 ? records_kind(rec_k) : agg_kind(n_agg),
                    nullptr, n_agg < 0 ? 0 : n_agg, out, 0, nullptr);
}

extern "C" const char* book_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
