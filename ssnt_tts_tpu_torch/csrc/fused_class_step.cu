// Fused class decode beam step (v2 duration or tone) for Hopper (sm_90a).
// The GRU cell comes from gru_step.cuh, shared with fused_v1_step.cu.
//
// Replaces the TPU kernel ssnt_tts_tpu/ops/beam_fused.py:
// fused_class_beam_step (pallas_call at :486, kernel body
// _make_fused_kernel at :197), kind="v2" and kind="tone" (the tone arm at
// :275-301), with the candidate and selection semantics of
// beam_select.cuh.
//
// One launch per source step s does, for every utterance and beam:
//   1. the AR class cell, in the rounding order of stepmath.gru_step for a
//      float32 or bfloat16 compute dtype:
//        x = rnd(embed[prev_class] + xin_path[s])
//        gi = rnd(rnd(x . wi) + bi), gh = rnd(rnd(state) . wh)
//        r, z = rnd(sigmoid(rnd(gi + gh))), n = rnd(tanh(rnd(gi_n +
//        rnd(r * rnd(gh_n + bhn))))), new_h = rnd(rnd(1-z) * n) + z*state
//        h = log_softmax(base_path[s] + new_h . out_k + out_b)   (float32)
//      (rnd = round to the compute dtype; dots accumulate in float32);
//   2. the W*D candidate grid: v2 with every prune (band, overrun, exact
//      final length, zero skip, optional final-feasibility guard) and the
//      on-diagonal flag, test_mode skipping every prune; tone with none
//      (every class of an active beam, (t, u) -> (t+1, u+1));
//   3. the stable top-W selection (v2: with the diagonal re-injection,
//      the survivor count and the emptied flag);
//   4. the parent-pointer reorder of the GRU state.
//
// What bounds it on an H100: latency. One block per utterance, so at the
// serving batch (B=32) 32 of 132 SMs are busy, and a step is a few MFLOP
// (2*W*H*6H for the GRU at W=8, H=256) over ~0.8 MB of bfloat16 weights
// that stay resident in the 50 MB L2 across blocks and steps. What the
// design does about that: nothing yet. It is the simple first version;
// splitting the gate columns over several blocks per utterance, tensor
// core products and a persistent multi-step launch are later work.
//
// Layouts (row-major, contiguous): xin_path (T, B, H) compute dtype;
// base_path (T, B, D) f32; embed (D, H), wi/wh (H, 3H), bi (3H), bhn (H)
// compute dtype; out_k (H, D), out_b (D) f32; prev_class/t/u (B, W) i32;
// log_prob (B, W) f32; is_finished (B, W) bool (1 byte); state (B, W, H)
// f32; input_length (B,) i32. v2 only: total (B, W) i32, output length
// (B,) i32, duration table (D,) i32, emptied (B,) bool. Optional debug
// outputs (null to skip): h (B, W, D) f32 and the pre-reorder new_h
// (B, W, H) f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "beam_select.cuh"
#include "gru_step.cuh"

namespace {

using namespace ssnt_beam;
using namespace ssnt_gru;

enum Kind { kV2 = 0, kTone = 1 };

struct StepArgs {
  int B, W, D, H, s;
  const void* xin_path; const float* base_path;
  const void* embed; const void* wi; const void* bi; const void* wh;
  const void* bhn; const float* out_k; const float* out_b;
  const int* prev_class; const float* state; const float* lp;
  const uint8_t* fin; const int* t; const int* u; const int* il;
  // v2 only
  const int* tot; const int* ol; const int* dtab; const uint8_t* emptied;
  int* o_nsurv; uint8_t* o_emptied;
  BeamOut out;
  float* o_state; float* dbg_h; float* dbg_newh;
  V2Opts v2;
  int empty_id;  // tone only
};

// One block per utterance, so one block per SM is all a launch needs:
// saying so (minBlocks 1) lets ptxas keep the 6*WMAX GRU accumulators in
// registers (without it the WMAX=16 variants were held to 128 registers
// and spilled, and the W=8 step ran 4% slower on an H100).
template <int KIND, typename CT, int WMAX>
__global__ void __launch_bounds__(kThreads, 1)
fused_class_step_kernel(StepArgs a) {
  const int b = blockIdx.x, tid = threadIdx.x;
  const int B = a.B, W = a.W, D = a.D, H = a.H, C = W * D;
  const CT* xin = static_cast<const CT*>(a.xin_path);
  const CT* embed = static_cast<const CT*>(a.embed);
  const CT* wi = static_cast<const CT*>(a.wi);
  const CT* bi = static_cast<const CT*>(a.bi);
  const CT* wh = static_cast<const CT*>(a.wh);
  const CT* bhn = static_cast<const CT*>(a.bhn);

  extern __shared__ float smem[];
  float* x_s = smem;               // (W, H) GRU input, compute-dtype values
  float* hb_s = x_s + W * H;       // (W, H) rnd(state)
  float* nh_s = hb_s + W * H;      // (W, H) new_h before the reorder
  float* h_s = nh_s + W * H;       // (W, D) logits, then log-probs
  __shared__ SelectSmem sel;

  // ---- 1. AR class cell ----
  for (int i = tid; i < W * H; i += kThreads) {
    const int w = i / H, k = i - w * H;
    const int pc = a.prev_class[b * W + w];
    const float e = ld(embed, (size_t)pc * H + k);
    const float xi = ld(xin, ((size_t)a.s * B + b) * H + k);
    x_s[i] = rnd<CT>(__fadd_rn(e, xi));
    hb_s[i] = rnd<CT>(a.state[((size_t)b * W + w) * H + k]);
  }
  __syncthreads();

  gru_columns<CT, WMAX>(x_s, hb_s, a.state + (size_t)b * W * H, wi, bi, wh,
                        bhn, W, H, nh_s,
                        a.dbg_newh ? a.dbg_newh + (size_t)b * W * H : nullptr);
  __syncthreads();

  // Correction head + per-position base logits (float32).
  for (int i = tid; i < W * D; i += kThreads) {
    const int w = i / D, d = i - w * D;
    float acc = 0.0f;
    for (int k = 0; k < H; ++k)
      acc = __fmaf_rn(nh_s[w * H + k], a.out_k[(size_t)k * D + d], acc);
    h_s[i] = __fadd_rn(a.base_path[((size_t)a.s * B + b) * D + d],
                       __fadd_rn(acc, a.out_b[d]));
  }
  __syncthreads();
  if (tid < W) {  // log_softmax: shifted - log(sum(exp(shifted)))
    float* row = h_s + tid * D;
    float m = row[0];
    for (int d = 1; d < D; ++d) m = fmaxf(m, row[d]);
    float sum = 0.0f;
    for (int d = 0; d < D; ++d) sum = __fadd_rn(sum, expf(__fsub_rn(row[d], m)));
    const float ls = logf(sum);
    for (int d = 0; d < D; ++d) {
      row[d] = __fsub_rn(__fsub_rn(row[d], m), ls);
      if (a.dbg_h) a.dbg_h[((size_t)b * W + tid) * D + d] = row[d];
    }
  }
  __syncthreads();

  // ---- 2. candidate grid, one thread per candidate c = w*D + d ----
  bool valid = false;
  if (tid < C) {
    const int w = tid / D, d = tid - w * D, o = b * W + w;
    const Cand x = KIND == kV2
        ? v2_candidate(d, D, h_s[tid], a.lp[o], a.fin[o], a.tot[o], a.t[o],
                       a.u[o], a.il[b], a.ol[b], a.dtab, a.v2)
        : tone_candidate(d, h_s[tid], a.lp[o], a.fin[o], a.t[o], a.u[o],
                         a.il[b], a.empty_id);
    store_cand(sel, tid, x);
    valid = x.valid;
  }

  // ---- 3. selection ----
  const int n = select_beams(sel, C, W, valid, KIND == kV2 && !a.v2.test_mode);
  write_selected(sel, b, W, D, a.out);
  if (KIND == kV2 && tid == 0) {
    a.o_nsurv[b] = n;
    a.o_emptied[b] = (uint8_t)(a.emptied[b] || n == 0);
  }

  // ---- 4. parent-pointer reorder of the GRU state ----
  reorder_rows(nh_s, a.o_state + (size_t)b * W * H, sel, W, D, H);
}

size_t smem_bytes(int W, int D, int H) {
  return sizeof(float) * (3 * (size_t)W * H + (size_t)W * D);
}

template <int KIND, typename CT, int WMAX>
cudaError_t launch(const StepArgs& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.W, a.D, a.H);
  auto kern = fused_class_step_kernel<KIND, CT, WMAX>;
  // The static SelectSmem counts against the 48 KB a launch may use
  // without opting in.
  if (smem + sizeof(SelectSmem) > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<a.B, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int KIND>
cudaError_t dispatch(int compute_bf16, const StepArgs& a, cudaStream_t st) {
  if (compute_bf16) {
    if (a.W <= 4) return launch<KIND, __nv_bfloat16, 4>(a, st);
    if (a.W <= 8) return launch<KIND, __nv_bfloat16, 8>(a, st);
    return launch<KIND, __nv_bfloat16, 16>(a, st);
  }
  if (a.W <= 4) return launch<KIND, float, 4>(a, st);
  if (a.W <= 8) return launch<KIND, float, 8>(a, st);
  return launch<KIND, float, 16>(a, st);
}

bool bad_shape(int B, int W, int D, int H) {
  return B < 1 || W < 1 || W > kMaxW || D < 1 || W * D > kMaxC || H < 1;
}

void set_common(StepArgs& a, int B, int W, int D, int H, int s,
                const void* xin_path, const void* base_path,
                const void* embed, const void* wi, const void* bi,
                const void* wh, const void* bhn, const void* out_k,
                const void* out_b, const void* prev_class, const void* state,
                const void* lp, const void* fin, const void* t,
                const void* u, const void* il, void* o_pred, void* o_lp,
                void* o_nt, void* o_nu, void* o_fin, void* o_branch,
                void* o_state, void* dbg_h, void* dbg_newh) {
  a.B = B; a.W = W; a.D = D; a.H = H; a.s = s;
  a.xin_path = xin_path; a.base_path = (const float*)base_path;
  a.embed = embed; a.wi = wi; a.bi = bi; a.wh = wh; a.bhn = bhn;
  a.out_k = (const float*)out_k; a.out_b = (const float*)out_b;
  a.prev_class = (const int*)prev_class; a.state = (const float*)state;
  a.lp = (const float*)lp; a.fin = (const uint8_t*)fin;
  a.t = (const int*)t; a.u = (const int*)u; a.il = (const int*)il;
  a.out.pred = (int*)o_pred; a.out.lp = (float*)o_lp;
  a.out.nt = (int*)o_nt; a.out.nu = (int*)o_nu;
  a.out.fin = (uint8_t*)o_fin; a.out.tot = nullptr;
  a.out.branch = (int*)o_branch;
  a.o_state = (float*)o_state;
  a.dbg_h = (float*)dbg_h; a.dbg_newh = (float*)dbg_newh;
}

}  // namespace

extern "C" int ssnt_fused_step_max_candidates() { return kMaxC; }
extern "C" int ssnt_fused_step_max_beams() { return kMaxW; }

// Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int ssnt_fused_v2_step(
    int compute_bf16, int B, int W, int D, int H, int s,
    const void* xin_path, const void* base_path, const void* embed,
    const void* wi, const void* bi, const void* wh, const void* bhn,
    const void* out_k, const void* out_b, const void* prev_class,
    const void* state, const void* lp, const void* fin, const void* tot,
    const void* t, const void* u, const void* il, const void* ol,
    const void* dtab, const void* emptied, void* o_pred, void* o_lp,
    void* o_nt, void* o_nu, void* o_fin, void* o_tot, void* o_branch,
    void* o_nsurv, void* o_emptied, void* o_state, void* dbg_h,
    void* dbg_newh, int zero_id, int allow_skip, int test_mode,
    int overrun_mult, int feas_guard, float band_lower, float band_upper,
    float diag_lo, float diag_hi, void* stream) {
  if (bad_shape(B, W, D, H)) return (int)cudaErrorInvalidValue;
  StepArgs a;
  set_common(a, B, W, D, H, s, xin_path, base_path, embed, wi, bi, wh, bhn,
             out_k, out_b, prev_class, state, lp, fin, t, u, il, o_pred,
             o_lp, o_nt, o_nu, o_fin, o_branch, o_state, dbg_h, dbg_newh);
  a.tot = (const int*)tot; a.ol = (const int*)ol; a.dtab = (const int*)dtab;
  a.emptied = (const uint8_t*)emptied;
  a.out.tot = (int*)o_tot;
  a.o_nsurv = (int*)o_nsurv; a.o_emptied = (uint8_t*)o_emptied;
  a.v2.zero_id = zero_id; a.v2.allow_skip = allow_skip;
  a.v2.test_mode = test_mode; a.v2.overrun_mult = overrun_mult;
  a.v2.feas_guard = feas_guard;
  a.v2.band_lower = band_lower; a.v2.band_upper = band_upper;
  a.v2.diag_lo = diag_lo; a.v2.diag_hi = diag_hi;
  a.empty_id = 0;
  return (int)dispatch<kV2>(compute_bf16, a, (cudaStream_t)stream);
}

// Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int ssnt_fused_tone_step(
    int compute_bf16, int B, int W, int K, int H, int s,
    const void* xin_path, const void* base_path, const void* embed,
    const void* wi, const void* bi, const void* wh, const void* bhn,
    const void* out_k, const void* out_b, const void* prev_class,
    const void* state, const void* lp, const void* fin, const void* t,
    const void* u, const void* il, void* o_pred, void* o_lp, void* o_nt,
    void* o_nu, void* o_fin, void* o_branch, void* o_state, void* dbg_h,
    void* dbg_newh, int empty_id, void* stream) {
  if (bad_shape(B, W, K, H)) return (int)cudaErrorInvalidValue;
  StepArgs a;
  set_common(a, B, W, K, H, s, xin_path, base_path, embed, wi, bi, wh, bhn,
             out_k, out_b, prev_class, state, lp, fin, t, u, il, o_pred,
             o_lp, o_nt, o_nu, o_fin, o_branch, o_state, dbg_h, dbg_newh);
  a.tot = nullptr; a.ol = nullptr; a.dtab = nullptr; a.emptied = nullptr;
  a.o_nsurv = nullptr; a.o_emptied = nullptr;
  a.v2 = V2Opts{0, 0, 1, 0, 0, 0.0f, 0.0f, 0.0f, 0.0f};
  a.empty_id = empty_id;
  return (int)dispatch<kTone>(compute_bf16, a, (cudaStream_t)stream);
}
