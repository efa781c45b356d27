// Beam-step pieces shared by the fused steps (fused_class_step.cu,
// fused_v1_step.cu) and the beam-only steps (beam_step.cu), so that they
// cannot drift:
//   - the v2 candidate (duration-class prunes, padding, on-diagonal flag),
//     the tone candidate (no prunes, padding with empty_tone_id) and the
//     v1 emit/shift candidate;
//   - the stable top-W selection with adjacent dedup, pad by repetition
//     and the v2 diagonal re-injection;
//   - the parent-pointer reorder of per-beam state rows.
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
constexpr int kMaxW = 16;
constexpr int kMaxC = kThreads;  // one thread per candidate
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

// dst row j = src row (parent of slot j), for one utterance's (W, H) rows;
// src may be shared or global memory, but not dst.
__device__ __forceinline__ void reorder_rows(const float* src, float* dst,
                                             const SelectSmem& s, int W,
                                             int D, int H) {
  for (int i = threadIdx.x; i < W * H; i += blockDim.x) {
    const int j = i / H, k = i - j * H;
    dst[i] = src[(size_t)(s.src[j] / D) * H + k];
  }
}

}  // namespace ssnt_beam
