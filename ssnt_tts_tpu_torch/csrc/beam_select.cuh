// Beam-step pieces shared by the fused steps (fused_class_step.cu,
// fused_v1_step.cu) and the beam-only steps (beam_step.cu), so that they
// cannot drift:
//   - the v2 candidate (duration-class prunes, padding, on-diagonal flag),
//     the tone candidate (no prunes, padding with empty_tone_id) and the
//     v1 emit/shift candidate;
//   - the stable top-W selection with adjacent dedup, pad by repetition
//     and the v2 diagonal re-injection: by the whole block (select_beams,
//     the fused steps; block_select, the beam-only steps above 32
//     candidates) or by one warp without block barriers (warp_select,
//     C <= 32; the beam-only steps); above kMaxW slots or kMaxC
//     candidates, by the whole block through a bitonic network over
//     (score, generation) keys at up to kMaxP a thread (wide_select, every
//     step's wide instance; JAX's _select_bitonic orders its steps the
//     same way, beam_pallas.py:500-649).
//
// Candidates are in generation order c = w*D + d (beam-major, class-minor),
// one thread per candidate, with the semantics of ops/beam_v2.py,
// ops/tone_latent.py, ops/beam_v1.py and ops/beam_common.select_beams
// (not those of the TPU
// kernels' _select_bitonic: a valid score at or below its sentinel is
// kept, as the XLA path keeps it).
//
// Band and diagonal bounds are computed one float32 rounding at a time
// (no fused multiply-add), as the reference and the numpy oracle do: a
// contracted `diag - U*0.05` moves an exact-integer lower edge by a frame.
// Every file that includes this is built with -fmad=false, and the bounds
// use __f*_rn intrinsics besides.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ssnt_beam {

constexpr int kThreads = 256;
// The narrow instances (select_beams, block_select, warp_select and the
// kernels built on them): up to kMaxW slots, one thread per candidate.
constexpr int kMaxW = 16;
constexpr int kMaxC = kThreads;
// The wide instances (wide_select): up to kMaxBeams slots and kMaxCands
// candidates, kMaxP a thread (ops/beam_fused.MAX_BEAMS, MAX_CANDIDATES).
constexpr int kMaxBeams = 128;
constexpr int kMaxCands = 2048;
constexpr int kMaxP = kMaxCands / kThreads;
constexpr int kNone = 0x7fffffff;

// One candidate's fields. `tot` is 0 for tone candidates, so the
// field-by-field dedup below serves both kinds.
struct Cand {
  float lp;
  int pred, nt, nu, tot;
  bool fin, valid, diag;
};

struct V2Opts {
  int zero_id, allow_skip, test_mode, overrun_mult, feas_guard;
  float band_lower, band_upper, diag_lo, diag_hi;
};

// The v2 candidate for class d of a beam at (tw, uw) with cumulative
// duration tot0 and history hist, in an utterance of T tokens and U
// frames (src/v2.rs:119-166, 313-323; beam_pallas._v2_candidates).
__device__ __forceinline__ Cand v2_candidate(
    int d, int D, float hval, float hist, bool fin_in, int tot0, int tw,
    int uw, int T, int U, const int* dtab, const V2Opts& o) {
  const bool active = (tw < T) && !fin_in;
  const bool last = tw == T - 1;
  int tot = tot0 + dtab[d];
  const float Uf = (float)U, Tf = (float)T;
  const float ratio = __fdiv_rn(Uf, Tf);
  const float diag = __fmul_rn(ratio, (float)(tw + 1));
  const int lower = (int)fmaxf(__fsub_rn(diag, __fmul_rn(Uf, o.band_lower)), 0.0f);
  const int upper = (int)fminf(__fadd_rn(diag, __fmul_rn(Uf, o.band_upper)), Uf);
  const bool skip_ok = o.allow_skip || d != o.zero_id;
  bool valid = active && skip_ok;
  if (!o.test_mode) {
    const bool band_ok = tot >= lower && tot <= upper;
    const bool overrun = (T - (tw + 1)) * o.overrun_mult > U;
    const bool final_ok = !last || tot == U;
    valid = valid && band_ok && !overrun && final_ok;
    if (valid && o.feas_guard) {
      int dmin = kNone, dmax = dtab[0];
      for (int q = 0; q < D; ++q) {
        const int v = dtab[q];
        if ((o.allow_skip || q != o.zero_id) && v < dmin) dmin = v;
        if (v > dmax) dmax = v;
      }
      const int fut = max(T - 1 - tw, 0);
      const int rem = U - tot;
      valid = rem >= fut * dmin && rem <= fut * dmax;
    }
  }
  Cand c;
  c.pred = d;
  c.nt = last ? tw : tw + 1;
  c.nu = last ? uw : uw + 1;
  c.fin = last;
  c.lp = __fadd_rn(hist, hval);
  if (!active && d == 0) {  // padding candidate (src/v2.rs:313-323)
    c.pred = o.zero_id; c.lp = hist; c.nt = tw; c.nu = uw; c.fin = true;
    tot = tot0; valid = true;
  }
  c.tot = tot;
  c.valid = valid;
  c.diag = false;
  if (!o.test_mode) {  // on_diagonal uses the candidate's next_t
    const float diff = __fsub_rn((float)tot, __fmul_rn(ratio, (float)c.nt));
    c.diag = diff >= o.diag_lo && diff <= o.diag_hi;
  }
  return c;
}

// The tone candidate for class k (src/tone_latent.rs:75-93, 211-231):
// every class is admissible for an active beam and advances (t, u) to
// (t+1, u+1); an inactive beam's padding candidate sits in class slot 0
// and predicts empty_id.
__device__ __forceinline__ Cand tone_candidate(
    int k, float hval, float hist, bool fin_in, int tw, int uw, int T,
    int empty_id) {
  const bool active = (tw < T) && !fin_in;
  Cand c;
  c.pred = k; c.lp = __fadd_rn(hist, hval); c.nt = tw + 1; c.nu = uw + 1;
  c.fin = false; c.tot = 0; c.valid = active; c.diag = false;
  if (!active && k == 0) {
    c.pred = empty_id; c.lp = hist; c.nt = tw; c.nu = uw; c.fin = true;
    c.valid = true;
  }
  return c;
}

// The v1 candidate for class k (0 emit, 1 shift) of a beam at (tw, uw)
// with history hist, in an utterance of T source frames (src/lib.rs
// :149-230; ops/beam_v1.py): an emit keeps t and moves u on, and finishes
// at the last frame; a shift moves both on, and at the last frame becomes
// a finishing emit that keeps the log-prob; an inactive beam (t < 0,
// t >= T or finished) gives one padding emit (log-prob kept, finished)
// and no shift. D = 2, tot = 0.
__device__ __forceinline__ Cand v1_candidate(int k, float hval, float hist,
                                             bool fin_in, int tw, int uw,
                                             int T) {
  const bool active = tw >= 0 && tw < T && !fin_in;
  const bool last = tw == T - 1;
  const bool grow = active && !last;
  Cand c;
  c.tot = 0; c.diag = false;
  if (k == 0) {
    c.pred = 0; c.lp = active ? __fadd_rn(hist, hval) : hist;
    c.nt = tw; c.nu = grow ? uw + 1 : uw; c.fin = !grow; c.valid = true;
  } else {
    c.pred = last ? 0 : 1; c.lp = last ? hist : __fadd_rn(hist, hval);
    c.nt = last ? tw : tw + 1; c.nu = last ? uw : uw + 1; c.fin = last;
    c.valid = active;
  }
  return c;
}

// Candidate fields and selection scratch of one block (one utterance).
struct SelectSmem {
  float lp[kMaxC];
  int pred[kMaxC], nt[kMaxC], nu[kMaxC], tot[kMaxC], fin[kMaxC];
  int valid[kMaxC], diag[kMaxC];
  int rank[kMaxC];     // candidate -> sorted position
  int order[kMaxC];    // sorted position -> candidate
  int keep_at[kMaxC];  // sorted position -> kept?
  int surv[kMaxC];     // survivor rank -> candidate
  int src[kMaxW];      // output slot -> candidate
  int first_diag;
};

__device__ __forceinline__ void store_cand(SelectSmem& s, int c, const Cand& x) {
  s.lp[c] = x.lp; s.pred[c] = x.pred; s.nt[c] = x.nt; s.nu[c] = x.nu;
  s.tot[c] = x.tot; s.fin[c] = x.fin; s.valid[c] = x.valid; s.diag[c] = x.diag;
}

// Stable top-W selection over the C candidates stored in `s`. Every thread
// of the block calls it; `valid` is the calling thread's candidate's
// validity (false for threads >= C), stored before the call. Order: lp
// descending with IEEE compares (-0.0 ties +0.0), then generation
// ascending; a candidate equal on every field but the parent to its
// sorted predecessor is dropped; the W slots take the survivors, padded by
// repetition from the front, candidate 0 everywhere when none survives;
// with use_diag the first surviving on-diagonal candidate goes into the
// last slot. Leaves the slots' candidates in s.src and returns the
// survivor count; ends with a barrier.
__device__ __forceinline__ int select_beams(SelectSmem& s, int C, int W,
                                            bool valid, bool use_diag) {
  const int tid = threadIdx.x;
  if (tid == 0) s.first_diag = kNone;
  const int nvalid = __syncthreads_count(valid);
  if (valid) {  // stable rank among valid candidates
    const float li = s.lp[tid];
    int r = 0;
    for (int j = 0; j < C; ++j) {
      if (s.valid[j]) {
        const float lj = s.lp[j];
        r += (lj > li) || (lj == li && j < tid);
      }
    }
    s.rank[tid] = r;
    s.order[r] = tid;
  }
  __syncthreads();
  bool keep = false;
  if (valid) {  // adjacent dedup on every field but the parent
    const int r = s.rank[tid];
    bool dup = false;
    if (r > 0) {
      const int p = s.order[r - 1];
      dup = s.pred[p] == s.pred[tid] && s.lp[p] == s.lp[tid] &&
            s.nt[p] == s.nt[tid] && s.nu[p] == s.nu[tid] &&
            s.fin[p] == s.fin[tid] && s.tot[p] == s.tot[tid];
    }
    keep = !dup;
    s.keep_at[r] = keep;
  }
  const int n = __syncthreads_count(keep);
  if (tid < nvalid && s.keep_at[tid]) {  // rank among survivors
    int kr = 0;
    for (int q = 0; q < tid; ++q) kr += s.keep_at[q];
    s.surv[kr] = s.order[tid];
  }
  __syncthreads();
  if (use_diag && tid < n && s.diag[s.surv[tid]]) atomicMin(&s.first_diag, tid);
  __syncthreads();
  if (tid < W) {
    int src = 0;
    if (n > 0) src = s.surv[tid < n ? tid : (tid - n) % n];
    if (tid == W - 1 && s.first_diag != kNone) src = s.surv[s.first_diag];
    s.src[tid] = src;
  }
  __syncthreads();
  return n;
}

constexpr int kWarpC = 32;  // candidates warp_select takes

// One warp's scratch for warp_select.
struct WarpSmem {
  int order[kWarpC];  // sorted position -> candidate
  int surv[kWarpC];   // survivor rank -> candidate
};

// select_beams by one warp, for C <= kWarpC candidates: lane c holds
// candidate c (x.valid false for lanes >= C, which the ballots then skip). The same order, dedup, pad
// and re-injection, with shuffles, ballots and warp reductions in place of
// the block's barriers (sorted positions and survivor ranks as bits of one
// word). Several warps may run it on the same candidates, each with its
// own scratch. Returns the survivor count; *src is the candidate of output
// slot `lane` (lanes < Wo).
__device__ __forceinline__ int warp_select(WarpSmem& ws, const Cand& x,
                                           int Wo, bool use_diag, int* src) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const unsigned vmask = __ballot_sync(kAll, x.valid);
  int r = 0;  // stable rank among valid candidates (lanes >= C invalid)
#pragma unroll
  for (int j = 0; j < kWarpC; ++j) {
    const float lj = __shfl_sync(kAll, x.lp, j);
    r += ((vmask >> j) & 1u) && ((lj > x.lp) || (lj == x.lp && j < lane));
  }
  if (x.valid) ws.order[r] = lane;
  __syncwarp();
  // adjacent dedup on every field but the parent
  const int p = (x.valid && r > 0) ? ws.order[r - 1] : lane;
  const int p_pred = __shfl_sync(kAll, x.pred, p);
  const float p_lp = __shfl_sync(kAll, x.lp, p);
  const int p_nt = __shfl_sync(kAll, x.nt, p);
  const int p_nu = __shfl_sync(kAll, x.nu, p);
  const int p_fin = __shfl_sync(kAll, (int)x.fin, p);
  const int p_tot = __shfl_sync(kAll, x.tot, p);
  const bool dup = r > 0 && p_pred == x.pred && p_lp == x.lp &&
                   p_nt == x.nt && p_nu == x.nu && p_fin == (int)x.fin &&
                   p_tot == x.tot;
  const bool keep = x.valid && !dup;
  const unsigned keep_at = __reduce_or_sync(kAll, keep ? 1u << r : 0u);
  const unsigned diag_at =
      __reduce_or_sync(kAll, use_diag && keep && x.diag ? 1u << r : 0u);
  const int n = __popc(keep_at);
  if (keep) ws.surv[__popc(keep_at & ((1u << r) - 1u))] = lane;
  __syncwarp();
  int s = 0;
  if (lane < Wo) {
    if (n > 0) s = ws.surv[lane < n ? lane : (lane - n) % n];
    if (lane == Wo - 1 && diag_at) s = ws.order[__ffs(diag_at) - 1];
  }
  *src = s;
  return n;
}

// Candidate fields and scratch of block_select (one utterance).
struct BlockSmem {
  __align__(16) float lp[kMaxC];
  __align__(16) int valid[kMaxC];
  int pred[kMaxC], nt[kMaxC], nu[kMaxC], tot[kMaxC], fin[kMaxC];
  int diag[kMaxC];
  int order[kMaxC];  // sorted position -> candidate
  int surv[kMaxC];   // survivor rank -> candidate
  int wcount[kThreads / 32];
  int first_diag;    // sorted position of the first kept diagonal candidate
};

// select_beams over the C candidates of a block, with short loops and
// four barriers: the ranks read four candidates a load (C padded to a
// multiple of 4 with invalid slots); thread p then takes sorted position
// p for the dedup, and the survivor ranks are ballots within a warp plus
// the counts of the warps before it. Every thread of the block calls it
// with its own candidate x (x.valid false for threads >= C). Returns the
// survivor count; *src is the candidate of output slot `lane` (for lanes
// < Wo, in every warp).
__device__ __forceinline__ int block_select(BlockSmem& s, const Cand& x,
                                            int C, int Wo, bool use_diag,
                                            int* src) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C4 = (C + 3) & ~3;
  if (tid < C) {
    s.lp[tid] = x.lp; s.valid[tid] = x.valid; s.pred[tid] = x.pred;
    s.nt[tid] = x.nt; s.nu[tid] = x.nu; s.tot[tid] = x.tot;
    s.fin[tid] = x.fin; s.diag[tid] = x.diag;
  } else if (tid < C4) {
    s.lp[tid] = 0.0f;
    s.valid[tid] = 0;
  }
  if (tid == 0) s.first_diag = kNone;
  const int nvalid = __syncthreads_count(x.valid);
  if (x.valid) {  // stable rank among valid candidates
    const float li = x.lp;
    int r = 0;
#pragma unroll 4
    for (int j = 0; j < C4; j += 4) {
      const float4 l = *reinterpret_cast<const float4*>(s.lp + j);
      const int4 v = *reinterpret_cast<const int4*>(s.valid + j);
      r += v.x && (l.x > li || (l.x == li && j < tid));
      r += v.y && (l.y > li || (l.y == li && j + 1 < tid));
      r += v.z && (l.z > li || (l.z == li && j + 2 < tid));
      r += v.w && (l.w > li || (l.w == li && j + 3 < tid));
    }
    s.order[r] = tid;
  }
  __syncthreads();
  // Thread p at sorted position p: adjacent dedup on every field but the
  // parent.
  bool keep = false;
  int c = 0;
  if (tid < nvalid) {
    c = s.order[tid];
    keep = true;
    if (tid > 0) {
      const int q = s.order[tid - 1];
      keep = !(s.pred[q] == s.pred[c] && s.lp[q] == s.lp[c] &&
               s.nt[q] == s.nt[c] && s.nu[q] == s.nu[c] &&
               s.fin[q] == s.fin[c] && s.tot[q] == s.tot[c]);
    }
    if (use_diag && keep && s.diag[c]) atomicMin(&s.first_diag, tid);
  }
  const unsigned m = __ballot_sync(0xffffffffu, keep);
  if (lane == 0) s.wcount[warp] = __popc(m);
  __syncthreads();
  int before = 0, n = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    before += w < warp ? s.wcount[w] : 0;
    n += s.wcount[w];
  }
  if (keep) s.surv[before + __popc(m & ((1u << lane) - 1u))] = c;
  __syncthreads();
  int k = 0;
  if (lane < Wo) {
    if (n > 0) k = s.surv[lane < n ? lane : (lane - n) % n];
    if (lane == Wo - 1 && s.first_diag != kNone) k = s.order[s.first_diag];
  }
  *src = k;
  return n;
}

// Candidate fields and scratch of wide_select, carved from dynamic shared
// memory (wide_sel_bytes(C) at a 16-byte aligned base): C4 = C rounded up
// to a multiple of 4 entries each. `valid` and `order` are dead while the
// network sorts (the keys are in registers, `order` not yet written), so
// its shared-memory exchange overlays them, at 8 bytes a key of the
// wide_sort_len(C) it sorts; that is the 8 C4 bytes of the two for a C
// that is a power of two, and grows the region otherwise.
struct WideSel {
  float* lp;
  int* pred; int* nt; int* nu; int* tot; int* fin; int* diag;
  int* valid;
  int* order;       // sorted position -> candidate
  int* surv;        // survivor rank -> candidate (valid's place)
  uint64_t* keys;   // the network's exchange (valid's and order's place)
  int* wcount;      // (kMaxP, warps) kept candidates of each warp's positions
  int* src;         // output slot -> candidate (kMaxBeams)
  int* misc;        // [0] first kept diagonal position, [1] valid count
};

// The keys wide_select sorts: C rounded up to a power of two.
__host__ __device__ inline int wide_sort_len(int C) {
  int L = 1;
  while (L < C) L <<= 1;
  return L;
}

// Bytes of the region the keys share with `valid` and `order`.
__host__ __device__ inline size_t wide_key_bytes(int C) {
  const size_t c4 = (size_t)((C + 3) & ~3);
  const size_t keys = sizeof(uint64_t) * (size_t)wide_sort_len(C);
  return keys > 2 * sizeof(int) * c4 ? keys : 2 * sizeof(int) * c4;
}

__host__ __device__ inline size_t wide_sel_bytes(int C) {
  const size_t c4 = (size_t)((C + 3) & ~3);
  return sizeof(int) * (7 * c4 + kMaxP * (kThreads / 32) + kMaxBeams + 4) +
         wide_key_bytes(C);
}

__device__ __forceinline__ WideSel wide_sel_at(unsigned char* base, int C) {
  const int c4 = (C + 3) & ~3;
  int* p = reinterpret_cast<int*>(base);
  WideSel s;
  s.lp = reinterpret_cast<float*>(p);
  s.pred = p + c4; s.nt = p + 2 * c4; s.nu = p + 3 * c4;
  s.tot = p + 4 * c4; s.fin = p + 5 * c4; s.diag = p + 6 * c4;
  s.valid = p + 7 * c4; s.order = p + 8 * c4;
  s.surv = s.valid;
  s.keys = reinterpret_cast<uint64_t*>(s.valid);
  s.wcount = p + 7 * c4 + wide_key_bytes(C) / sizeof(int);
  s.src = s.wcount + kMaxP * (kThreads / 32);
  s.misc = s.src + kMaxBeams;
  return s;
}

__device__ __forceinline__ void store_wide(const WideSel& s, int c,
                                           const Cand& x) {
  s.lp[c] = x.lp; s.valid[c] = x.valid; s.pred[c] = x.pred; s.nt[c] = x.nt;
  s.nu[c] = x.nu; s.tot[c] = x.tot; s.fin[c] = x.fin; s.diag[c] = x.diag;
}

// A candidate's sort key: an ascending sort of the keys is the selection's
// order. The high word is lp mapped to a u32 that falls as lp rises (-0.0
// first made +0.0, so that the two tie as IEEE compares them; NaN is
// outside the contract), the low word the generation index, so that equal
// scores keep generation order and no two keys are equal. Invalid
// candidates and the pads up to wide_sort_len take kNoKey and sort last.
constexpr uint64_t kNoKey = ~0ull;

__device__ __forceinline__ uint64_t wide_key(float lp, int c) {
  const uint32_t u = __float_as_uint(lp == 0.0f ? 0.0f : lp);
  const uint32_t hi = (u & 0x80000000u) ? u : (~u & 0x7fffffffu);
  return ((uint64_t)hi << 32) | (uint32_t)c;
}

// The network's strides below P: both keys are the thread's own. Keys k
// and k | J of thread t (indices t P + k, t P + (k | J)) go ascending where
// index & K is 0: for K < P that is k & K, else `up`, the thread's own.
template <int P, int J>
__device__ __forceinline__ void sort_in_thread(uint64_t (&key)[P], int K,
                                               bool up) {
  if constexpr (J < P) {
#pragma unroll
    for (int k = 0; k < P; ++k) {
      if (k & J) continue;
      const uint64_t a = key[k], b = key[k | J];
      const bool swap = (b < a) == (K < P ? (k & K) == 0 : up);
      key[k] = swap ? b : a;
      key[k | J] = swap ? a : b;
    }
  }
}

// Sorts the L keys of the block ascending, P a thread: thread t holds
// indices t P + k (k < P) in key[]. L = 256 P for P > 1; for P = 1, L is
// any power of two up to 256 (threads at or past L hold kNoKey and sit
// out). A bitonic network (JAX's _bitonic_sort_desc): index i meets
// i ^ j in the phase that merges runs of K, ascending where i & K is 0.
// Strides below P run in registers, below 32 P by shuffles (lane ^ j / P),
// the rest through s.keys (key k of thread t at k kThreads + t: a warp's
// 32 keys are 256 contiguous bytes) behind two barriers a stride. From
// stride P up, a thread's keys all sit on one side of their pairs, so it
// keeps the smaller of each (`lo`) or the larger. Every thread of the
// block calls it. The first exchange's leading barrier also ends the reads
// of `valid` that built the keys (buf overlays it); it ends with a
// barrier.
template <int P>
__device__ __forceinline__ void wide_sort(uint64_t (&key)[P], uint64_t* buf,
                                          int L) {
  const int t = threadIdx.x, i0 = t * P;
  for (int K = 2; K <= L; K <<= 1) {
    const bool up = (i0 & K) == 0;
    for (int j = K >> 1; j > 0; j >>= 1) {
      if (j < P) {
        if (j == 1) sort_in_thread<P, 1>(key, K, up);
        else if (j == 2) sort_in_thread<P, 2>(key, K, up);
        else sort_in_thread<P, 4>(key, K, up);
        continue;
      }
      const bool lo = ((i0 & j) == 0) == up;
      if (j < 32 * P) {
        const int m = j / P;
#pragma unroll
        for (int k = 0; k < P; ++k) {
          const uint64_t o = __shfl_xor_sync(0xffffffffu, key[k], m);
          key[k] = (o < key[k]) == lo ? o : key[k];
        }
      } else {
        const int pt = t ^ (j / P);
        __syncthreads();  // the last readers of buf (or of valid) are done
        if (i0 < L) {
#pragma unroll
          for (int k = 0; k < P; ++k) buf[k * kThreads + t] = key[k];
        }
        __syncthreads();
        if (i0 < L) {
#pragma unroll
          for (int k = 0; k < P; ++k) {
            const uint64_t o = buf[k * kThreads + pt];
            key[k] = (o < key[k]) == lo ? o : key[k];
          }
        }
      }
    }
  }
  __syncthreads();
}

// The sorted order of the C candidates stored in `s`, P keys a thread
// (P = wide_sort_len(C) / kThreads, at least 1): s.order[p] for the nvalid
// valid candidates (and garbage up to L for P >= 4, where the keys' loads
// and the order's stores take 16 bytes a thread), which it counts into
// s.misc[1].
template <int P>
__device__ __forceinline__ void wide_order(const WideSel& s, int C) {
  const int t = threadIdx.x, i0 = t * P;
  uint64_t key[P];
  int nv = 0;
  if constexpr (P >= 4) {
#pragma unroll
    for (int k = 0; k < P; k += 4) {
      float4 l = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      int4 v = make_int4(0, 0, 0, 0);
      if (i0 + k < C) {  // a multiple of 4 below C: inside the C4 entries
        l = *reinterpret_cast<const float4*>(s.lp + i0 + k);
        v = *reinterpret_cast<const int4*>(s.valid + i0 + k);
      }
      const float lv[4] = {l.x, l.y, l.z, l.w};
      const int vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = i0 + k + q;
        const bool ok = c < C && vv[q];
        key[k + q] = ok ? wide_key(lv[q], c) : kNoKey;
        nv += ok;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int c = i0 + k;
      const bool ok = c < C && s.valid[c];
      key[k] = ok ? wide_key(s.lp[c], c) : kNoKey;
      nv += ok;
    }
  }
  nv = __reduce_add_sync(0xffffffffu, nv);
  if ((t & 31) == 0 && nv) atomicAdd(&s.misc[1], nv);
  wide_sort<P>(key, s.keys, wide_sort_len(C));
  if constexpr (P >= 4) {
#pragma unroll
    for (int k = 0; k < P; k += 4)
      *reinterpret_cast<int4*>(s.order + i0 + k) = make_int4(
          (int)(uint32_t)key[k], (int)(uint32_t)key[k + 1],
          (int)(uint32_t)key[k + 2], (int)(uint32_t)key[k + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < P; ++k)
      if (key[k] != kNoKey) s.order[i0 + k] = (int)(uint32_t)key[k];
  }
}

// select_beams for up to kMaxCands candidates and kMaxBeams slots, with
// the same order, dedup, pad and re-injection: the candidates' keys sorted
// by wide_sort (P = 1, 2, 4 or 8 a thread), then sorted positions
// p = k kThreads + t for thread t (k < ceil(C / kThreads)). The caller has
// stored the C candidates with store_wide; every thread of the block calls
// it. Survivor ranks are ballots within a warp plus a scan of the rows'
// counts. Leaves the slots' candidates in s.src[0 .. Wo) and returns the
// survivor count; begins and ends with a barrier.
__device__ __forceinline__ int wide_select(const WideSel& s, int C, int Wo,
                                           bool use_diag) {
  constexpr int kW = kThreads / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int P = (C + kThreads - 1) / kThreads;
  if (tid == 0) {
    s.misc[0] = kNone;
    s.misc[1] = 0;
  }
  __syncthreads();
  const int L = wide_sort_len(C);
  if (L <= kThreads) wide_order<1>(s, C);
  else if (L == 2 * kThreads) wide_order<2>(s, C);
  else if (L == 4 * kThreads) wide_order<4>(s, C);
  else wide_order<8>(s, C);
  __syncthreads();
  const int nvalid = s.misc[1];
  // Sorted position p: adjacent dedup on every field but the parent.
  unsigned m[kMaxP];
  int cand[kMaxP];
#pragma unroll
  for (int k = 0; k < kMaxP; ++k) {
    const int p = k * kThreads + tid;
    bool keep = false;
    cand[k] = 0;
    if (k < P && p < nvalid) {
      const int c = s.order[p];
      cand[k] = c;
      keep = true;
      if (p > 0) {
        const int q = s.order[p - 1];
        keep = !(s.pred[q] == s.pred[c] && s.lp[q] == s.lp[c] &&
                 s.nt[q] == s.nt[c] && s.nu[q] == s.nu[c] &&
                 s.fin[q] == s.fin[c] && s.tot[q] == s.tot[c]);
      }
      if (use_diag && keep && s.diag[c]) atomicMin(&s.misc[0], p);
    }
    m[k] = k < P ? __ballot_sync(0xffffffffu, keep) : 0u;
    if (k < P && lane == 0) s.wcount[k * kW + warp] = __popc(m[k]);
  }
  __syncthreads();
  // survivor ranks: the kept positions before p. Every warp scans the
  // P kW (<= 64) counts of the rows (k, warp), two a lane.
  constexpr unsigned kAll = 0xffffffffu;
  int c0 = lane < P * kW ? s.wcount[lane] : 0;
  int c1 = lane + 32 < P * kW ? s.wcount[lane + 32] : 0;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y0 = __shfl_up_sync(kAll, c0, d);
    const int y1 = __shfl_up_sync(kAll, c1, d);
    if (lane >= d) {
      c0 += y0;
      c1 += y1;
    }
  }
  c1 += __shfl_sync(kAll, c0, 31);
  const int n = __shfl_sync(kAll, c1, 31);
#pragma unroll
  for (int k = 0; k < kMaxP; ++k) {
    if (k >= P) break;
    const int row = k * kW + warp;  // kept positions up to this row's end
    const int upto = __shfl_sync(kAll, row < 32 ? c0 : c1, row & 31);
    if ((m[k] >> lane) & 1u)
      s.surv[upto - __popc(m[k] >> lane)] = cand[k];
  }
  __syncthreads();
  const int first_diag = s.misc[0];
  for (int j = tid; j < Wo; j += kThreads) {
    int k = 0;
    if (n > 0) k = s.surv[j < n ? j : (j - n) % n];
    if (j == Wo - 1 && first_diag != kNone) k = s.order[first_diag];
    s.src[j] = k;
  }
  __syncthreads();
  return n;
}

// Output rows (B, W) of a beam step; tot is null for tone.
struct BeamOut {
  int* pred; float* lp; int* nt; int* nu; uint8_t* fin; int* tot;
  int* branch;
};

// Writes utterance b's selected candidates (threads < W).
__device__ __forceinline__ void write_selected(const SelectSmem& s, int b,
                                               int W, int D,
                                               const BeamOut& o) {
  const int j = threadIdx.x;
  if (j >= W) return;
  const int src = s.src[j], i = b * W + j;
  o.pred[i] = s.pred[src];
  o.lp[i] = s.lp[src];
  o.nt[i] = s.nt[src];
  o.nu[i] = s.nu[src];
  o.fin[i] = (uint8_t)s.fin[src];
  if (o.tot) o.tot[i] = s.tot[src];
  o.branch[i] = src / D;
}

}  // namespace ssnt_beam
