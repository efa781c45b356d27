// Beam-only decode steps for Hopper (sm_90a): h is given, then the
// candidate grid, the selection and the parent-pointer reorder of the
// per-beam state, in one launch.
//
// Replace the TPU kernels ssnt_tts_tpu/ops/beam_pallas.py:
//   - v2_beam_search_decode (pallas_call at :1055; kernel _make_v2_kernel
//     :862, candidates _v2_candidates :756) with state=;
//   - tone_beam_search_decode (pallas_call at :1202; kernel
//     _make_tone_kernel :1074) with state=;
//   - beam_search_step_reorder (pallas_call at :728; kernel
//     _v1_reorder_kernel :230), the v1 emit/shift step with the reorder of
//     (B, W, F) rows, and beam_search_step_batched (pallas_call at :674;
//     kernel _v1_kernel :211), the same with a null state (F = 0).
// Semantics: ops/beam_v2.beam_search_step, ops/tone_latent.
// beam_search_step and ops/beam_v1.beam_search_step followed by the state
// gather; candidates, selection and reorder come from beam_select.cuh,
// which the fused steps share. The TPU v1 kernels pick their outputs by
// one-hot sums (a selected -0.0 comes back +0.0); these copy.
// The TPU tone kernel lays candidates out class-major; here, as in the
// plain steps, generation order is beam-major (c = w*K + k), which is the
// order the TPU kernel's ties break by (gen = parent*K + k).
//
// What bounds it on an H100: latency. Per step it moves ~0.5 MB at B=32,
// W=8, H=256 (v1: ~0.86 MB of F = 418 rows; mostly the state rows, read
// once and written once) and does O(C^2) compares per utterance for the
// ranks; one block per utterance, one thread per candidate. What the
// design does about that: nothing yet; folding it into the step that
// produces h is what the fused steps do.
//
// Layouts (row-major, contiguous): h (B, W, D) f32 (v1: D = 2, [emit,
// shift]); log_prob (B, W) f32;
// is_finished (B, W) bool (1 byte); t/u (B, W) i32; input_length (B,)
// i32; state (B, W, H) f32 (v1: (B, W, F), or null). v2 only: total (B, W) i32, output length
// (B,) i32, duration table (D,) i32. Outputs: (B, W) rows as inputs,
// branch (B, W) i32, state (B, W, H) f32; v2 also total (B, W) and the
// survivor count (B,) i32.

#include <cuda_runtime.h>
#include <stdint.h>

#include "beam_select.cuh"

namespace {

using namespace ssnt_beam;

struct BeamArgs {
  int B, W, D, H;
  const float* h; const float* lp; const uint8_t* fin; const int* t;
  const int* u; const int* il; const float* state;
  // v2 only
  const int* tot; const int* ol; const int* dtab; int* o_nsurv;
  BeamOut out;
  float* o_state;
  V2Opts v2;
  int empty_id;  // tone only
};

enum Kind { kV2 = 0, kTone = 1, kV1 = 2 };

template <int KIND>
__global__ void __launch_bounds__(kThreads) beam_step_kernel(BeamArgs a) {
  const int b = blockIdx.x, tid = threadIdx.x;
  const int W = a.W, D = a.D, H = a.H, C = W * D;
  __shared__ SelectSmem sel;

  bool valid = false;
  if (tid < C) {
    const int w = tid / D, d = tid - w * D, o = b * W + w;
    const float hv = a.h[(size_t)b * C + tid];
    const Cand x =
        KIND == kV2
            ? v2_candidate(d, D, hv, a.lp[o], a.fin[o], a.tot[o], a.t[o],
                           a.u[o], a.il[b], a.ol[b], a.dtab, a.v2)
        : KIND == kTone
            ? tone_candidate(d, hv, a.lp[o], a.fin[o], a.t[o], a.u[o],
                             a.il[b], a.empty_id)
            : v1_candidate(d, hv, a.lp[o], a.fin[o], a.t[o], a.u[o],
                           a.il[b]);
    store_cand(sel, tid, x);
    valid = x.valid;
  }
  const int n = select_beams(sel, C, W, valid, KIND == kV2 && !a.v2.test_mode);
  write_selected(sel, b, W, D, a.out);
  if (KIND == kV2 && tid == 0) a.o_nsurv[b] = n;
  if (a.state) {
    const size_t row0 = (size_t)b * W * H;
    reorder_rows(a.state + row0, a.o_state + row0, sel, W, D, H);
  }
}

template <int KIND>
cudaError_t launch(const BeamArgs& a, cudaStream_t stream) {
  beam_step_kernel<KIND><<<a.B, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

bool bad_shape(int B, int W, int D, int H) {
  return B < 1 || W < 1 || W > kMaxW || D < 1 || W * D > kMaxC || H < 1;
}

void set_common(BeamArgs& a, int B, int W, int D, int H, const void* h,
                const void* lp, const void* fin, const void* t,
                const void* u, const void* il, const void* state,
                void* o_pred, void* o_lp, void* o_nt, void* o_nu,
                void* o_fin, void* o_branch, void* o_state) {
  a.B = B; a.W = W; a.D = D; a.H = H;
  a.h = (const float*)h; a.lp = (const float*)lp;
  a.fin = (const uint8_t*)fin; a.t = (const int*)t; a.u = (const int*)u;
  a.il = (const int*)il; a.state = (const float*)state;
  a.out.pred = (int*)o_pred; a.out.lp = (float*)o_lp;
  a.out.nt = (int*)o_nt; a.out.nu = (int*)o_nu;
  a.out.fin = (uint8_t*)o_fin; a.out.tot = nullptr;
  a.out.branch = (int*)o_branch;
  a.o_state = (float*)o_state;
}

}  // namespace

extern "C" int ssnt_beam_step_max_candidates() { return kMaxC; }
extern "C" int ssnt_beam_step_max_beams() { return kMaxW; }

// Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int ssnt_beam_v2_step(
    int B, int W, int D, int H, const void* h, const void* lp,
    const void* fin, const void* tot, const void* t, const void* u,
    const void* il, const void* ol, const void* dtab, const void* state,
    void* o_pred, void* o_lp, void* o_nt, void* o_nu, void* o_fin,
    void* o_tot, void* o_branch, void* o_nsurv, void* o_state, int zero_id,
    int allow_skip, int test_mode, int overrun_mult, int feas_guard,
    float band_lower, float band_upper, float diag_lo, float diag_hi,
    void* stream) {
  if (bad_shape(B, W, D, H)) return (int)cudaErrorInvalidValue;
  BeamArgs a;
  set_common(a, B, W, D, H, h, lp, fin, t, u, il, state, o_pred, o_lp,
             o_nt, o_nu, o_fin, o_branch, o_state);
  a.tot = (const int*)tot; a.ol = (const int*)ol; a.dtab = (const int*)dtab;
  a.out.tot = (int*)o_tot; a.o_nsurv = (int*)o_nsurv;
  a.v2 = V2Opts{zero_id, allow_skip, test_mode, overrun_mult, feas_guard,
                band_lower, band_upper, diag_lo, diag_hi};
  a.empty_id = 0;
  return (int)launch<kV2>(a, (cudaStream_t)stream);
}

// Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int ssnt_beam_tone_step(
    int B, int W, int K, int H, const void* h, const void* lp,
    const void* fin, const void* t, const void* u, const void* il,
    const void* state, void* o_pred, void* o_lp, void* o_nt, void* o_nu,
    void* o_fin, void* o_branch, void* o_state, int empty_id,
    void* stream) {
  if (bad_shape(B, W, K, H)) return (int)cudaErrorInvalidValue;
  BeamArgs a;
  set_common(a, B, W, K, H, h, lp, fin, t, u, il, state, o_pred, o_lp,
             o_nt, o_nu, o_fin, o_branch, o_state);
  a.tot = nullptr; a.ol = nullptr; a.dtab = nullptr; a.o_nsurv = nullptr;
  a.v2 = V2Opts{0, 0, 1, 0, 0, 0.0f, 0.0f, 0.0f, 0.0f};
  a.empty_id = empty_id;
  return (int)launch<kTone>(a, (cudaStream_t)stream);
}

// The v1 step; state/o_state null (and F = 0) for the step without rows.
// Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int ssnt_beam_v1_step(
    int B, int W, int F, const void* h, const void* lp, const void* fin,
    const void* t, const void* u, const void* il, const void* state,
    void* o_pred, void* o_lp, void* o_nt, void* o_nu, void* o_fin,
    void* o_branch, void* o_state, void* stream) {
  if (bad_shape(B, W, 2, state ? F : 1) ||
      (state == nullptr) != (o_state == nullptr))
    return (int)cudaErrorInvalidValue;
  BeamArgs a;
  set_common(a, B, W, 2, F, h, lp, fin, t, u, il, state, o_pred, o_lp, o_nt,
             o_nu, o_fin, o_branch, o_state);
  a.tot = nullptr; a.ol = nullptr; a.dtab = nullptr; a.o_nsurv = nullptr;
  a.v2 = V2Opts{0, 0, 1, 0, 0, 0.0f, 0.0f, 0.0f, 0.0f};
  a.empty_id = 0;
  return (int)launch<kV1>(a, (cudaStream_t)stream);
}
