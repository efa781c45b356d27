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
// gather, with W_out = max_beam_width output slots (1 to kMaxBeams;
// survivors pad by repetition, v2's diagonal candidate goes to slot
// W_out - 1); W up to kMaxBeams and W*D up to kMaxCands candidates;
// candidates and selection come from beam_select.cuh, which the fused
// steps share. The TPU v1 kernels pick their outputs by one-hot sums (a
// selected -0.0 comes back +0.0); these copy.
// The TPU tone kernel lays candidates out class-major; here, as in the
// plain steps, generation order is beam-major (c = w*K + k), which is the
// order the TPU kernel's ties break by (gen = parent*K + k).
//
// What bounds it on an H100: latency, not bytes. Per step it moves ~0.5
// MB at B=32, W=8, H=256 (v1: ~0.87 MB of F = 418 rows, 13.4 KB an
// utterance), a 0.16-0.26 us byte bound, and does O(C^2) compares per
// utterance; one block per utterance (32 of 132 SMs at B=32) waits on a
// chain: its inputs' loads, the selection, then the rows, whose loads
// cannot start before the parents are known. What the design does about
// it:
//   - the rows are in flight from the first instruction: thread 0 issues
//     one TMA bulk copy of the utterance's contiguous (W, F) span into
//     shared memory (an mbarrier carries its byte count) while the block
//     loads the candidates' inputs and selects; the span's unaligned lead
//     and tail (up to 3 floats each, when W*F*4 is not a multiple of 16)
//     are read from global memory where the reorder needs them;
//   - the selection of C <= 32 candidates (the v1 arm up to W = 16, small
//     v2 and tone grids) runs in every warp at once (warp_select: shuffles,
//     ballots, no block barrier); larger grids (v2 80, tone 64 candidates
//     at W = 8) take block_select: four barriers, ranks read four
//     candidates a load, survivor ranks by ballots (select_beams, which
//     the fused steps keep, has six barriers and two serial loops over the
//     candidates);
//   - the reorder gives each output row to one warp, which reads the
//     parent's row from shared memory and stores it coalesced, 16 bytes a
//     lane where the row allows (F a multiple of 4: v2 and tone's H = 256;
//     the v1 rows' F = 418 start 16-byte aligned only every other row, so
//     they go a value at a time).
// One block barrier remains on the warp path: it publishes the mbarrier's
// initialisation. Those are the narrow instance's (W and W_out <= kMaxW,
// C <= kMaxC, the rows in shared memory); anything wider takes the wide
// instance (beam_step_wide_kernel): wide_select (a bitonic network over
// up to kMaxP keys a thread), the slots' parents in shared memory, and as
// much of the rows' span staged by the bulk copy as fits beside the
// selection's fields, the rest read from global memory by the reorder (at
// the decodes' widths all of it fits: v1 at W=128 stages 214 KB of F=418
// rows beside 10 KB of fields, v2 at W=128, D=16 131 KB beside 75 KB).
// Measured by bench_fused.py (device time under a CUDA graph, B=32, W=8;
// NVIDIA H100 80GB HBM3, 700 W): v1 with F = 418 rows 3.2 us, tone 3.4
// us, v2 3.9 us (the design before it: 6.8, 6.7, 7.8), against a 1.3 us
// launch floor; probe_beam.py's stamps put the v1 rows' landing at ~1.5
// us after the block's start, the selection done at ~1.3 and the
// reorder's end at ~2.3.
//
// Layouts (row-major, contiguous): h (B, W, D) f32 (v1: D = 2, [emit,
// shift]); log_prob (B, W) f32; is_finished (B, W) bool (1 byte); t/u
// (B, W) i32; input_length (B,) i32; state (B, W, H) f32 (v1: (B, W, F),
// or null). v2 only: total (B, W) i32, output length (B,) i32, duration
// table (D,) i32. Outputs: (B, W_out) rows as inputs, branch (B, W_out)
// i32, state (B, W_out, H) f32; v2 also total (B, W_out) and the survivor
// count (B,) i32.

#include <cuda_runtime.h>
#include <stdint.h>

#include "beam_select.cuh"
#include "tma.cuh"

namespace {

using namespace ssnt_beam;
using namespace ssnt_tma;

constexpr int kWarps = kThreads / 32;

struct BeamArgs {
  int B, W, Wo, D, H;
  const float* h; const float* lp; const uint8_t* fin; const int* t;
  const int* u; const int* il; const float* state;
  // v2 only
  const int* tot; const int* ol; const int* dtab; int* o_nsurv;
  BeamOut out;
  float* o_state;
  V2Opts v2;
  int empty_id;  // tone only
  int stage;     // wide instance: the most row values staged (a multiple of 4)
};

enum Kind { kV2 = 0, kTone = 1, kV1 = 2 };

template <int KIND>
__device__ __forceinline__ Cand candidate(const BeamArgs& a, int b, int c) {
  const int w = c / a.D, d = c - w * a.D, o = b * a.W + w;
  const float hv = a.h[(size_t)b * a.W * a.D + c];
  if (KIND == kV2)
    return v2_candidate(d, a.D, hv, a.lp[o], a.fin[o], a.tot[o], a.t[o],
                        a.u[o], a.il[b], a.ol[b], a.dtab, a.v2);
  if (KIND == kTone)
    return tone_candidate(d, hv, a.lp[o], a.fin[o], a.t[o], a.u[o], a.il[b],
                          a.empty_id);
  return v1_candidate(d, hv, a.lp[o], a.fin[o], a.t[o], a.u[o], a.il[b]);
}

// The utterance's (W, H) state span: element i of the span in global
// memory (g) is at s[lead + i] in shared memory; elements [i0, i0 + nb)
// arrive by the bulk copy, the others (fewer than 4 at each end) are read
// from global memory.
struct Span {
  const float* g;
  const float* s;
  int lead, i0, nb;
  __device__ __forceinline__ float at(int i) const {
    return (unsigned)(i - i0) < (unsigned)nb ? s[lead + i] : __ldg(g + i);
  }
};

// out (W_out, H) row j = the span row of slot j's parent, parent_of(j)
// (the same in every lane of the warp). Warp w copies rows w, w + kWarps,
// ...: each lane reads the row's values from shared memory at a stride of
// 32 and stores them, 16 bytes at a time where the row's width is a
// multiple of 4 and its source and destination are 16-byte aligned and
// staged, else one value at a time (coalesced either way).
template <typename ParentOf>
__device__ __forceinline__ void reorder_span(const Span& sp,
                                             ParentOf parent_of, int Wo,
                                             int H, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = warp; j < Wo; j += kWarps) {
    const int s0 = parent_of(j) * H;
    float* dst = out + (size_t)j * H;
    if ((H & 3) == 0 && ((sp.lead + s0) & 3) == 0 &&
        ((uintptr_t)dst & 15) == 0 && s0 >= sp.i0 &&
        s0 + H <= sp.i0 + sp.nb) {
      const float4* src = reinterpret_cast<const float4*>(sp.s + sp.lead + s0);
#pragma unroll 4
      for (int k = lane; k < H / 4; k += 32)
        reinterpret_cast<float4*>(dst)[k] = src[k];
    } else {
#pragma unroll 4
      for (int k = lane; k < H; k += 32) dst[k] = sp.at(s0 + k);
    }
  }
}

template <int KIND>
__global__ void __launch_bounds__(kThreads) beam_step_kernel(BeamArgs a) {
  extern __shared__ __align__(16) float rows[];
  __shared__ uint64_t bar;
  __shared__ BlockSmem bsm;
  __shared__ WarpSmem wsm[kWarps];
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31,
            warp = tid >> 5;
  const int W = a.W, Wo = a.Wo, D = a.D, H = a.H, C = W * D;
  const bool use_diag = KIND == kV2 && !a.v2.test_mode;

  // 1. The rows, in flight from the start.
  Span sp{nullptr, rows, 0, 0, 0};
  if (a.state) {
    const int n = W * H;
    sp.g = a.state + (size_t)b * n;
    sp.lead = (int)(((uintptr_t)sp.g >> 2) & 3);
    sp.i0 = min((4 - sp.lead) & 3, n);
    sp.nb = (n - sp.i0) & ~3;
    if (tid == 0) {
      mbar_init(&bar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      if (sp.nb)
        bulk_copy(rows + sp.lead + sp.i0, sp.g + sp.i0, 4u * sp.nb, &bar);
    }
  }

  // 2. Candidates, 3. selection.
  const bool by_warp = C <= kWarpC;
  Cand x{};
  const int c = by_warp ? lane : tid;
  if (c < C) x = candidate<KIND>(a, b, c);
  int n, src;
  if (by_warp) {
    // Publishes the mbarrier's initialisation (the block routine's first
    // barrier does that below).
    if (a.state) __syncthreads();
    n = warp_select(wsm[warp], x, Wo, use_diag, &src);
    if (warp == 0) {  // slot `lane`'s fields, from lane src
      constexpr unsigned kAll = 0xffffffffu;
      const int pred = __shfl_sync(kAll, x.pred, src);
      const float lp = __shfl_sync(kAll, x.lp, src);
      const int nt = __shfl_sync(kAll, x.nt, src);
      const int nu = __shfl_sync(kAll, x.nu, src);
      const int fin = __shfl_sync(kAll, (int)x.fin, src);
      const int tot = __shfl_sync(kAll, x.tot, src);
      if (lane < Wo) {
        const int i = b * Wo + lane;
        a.out.pred[i] = pred;
        a.out.lp[i] = lp;
        a.out.nt[i] = nt;
        a.out.nu[i] = nu;
        a.out.fin[i] = (uint8_t)fin;
        if (a.out.tot) a.out.tot[i] = tot;
        a.out.branch[i] = src / D;
      }
    }
  } else {
    n = block_select(bsm, x, C, Wo, use_diag, &src);
    if (warp == 0 && lane < Wo) {
      const int i = b * Wo + lane;
      a.out.pred[i] = bsm.pred[src];
      a.out.lp[i] = bsm.lp[src];
      a.out.nt[i] = bsm.nt[src];
      a.out.nu[i] = bsm.nu[src];
      a.out.fin[i] = (uint8_t)bsm.fin[src];
      if (a.out.tot) a.out.tot[i] = bsm.tot[src];
      a.out.branch[i] = src / D;
    }
  }
  if (KIND == kV2 && tid == 0) a.o_nsurv[b] = n;

  // 4. The reorder, from shared memory once the copy has landed.
  if (a.state) {
    if (sp.nb) mbar_wait(&bar, 0);
    const int parent = src / D;  // slot `lane`'s parent
    reorder_span(sp,
                 [&](int j) { return __shfl_sync(0xffffffffu, parent, j); },
                 Wo, H, a.o_state + (size_t)b * Wo * H);
  }
}

// The wide instance: W or W_out above kMaxW, more than kMaxC candidates,
// or rows past the narrow instance's shared memory. The candidates go
// through wide_select (up to kMaxP keys a thread, fields in dynamic shared
// memory); the first a.stage values of the rows' span are staged by the
// bulk copy behind them, the rest read from global memory by the reorder.
template <int KIND>
__global__ void __launch_bounds__(kThreads) beam_step_wide_kernel(BeamArgs a) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ uint64_t bar;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int W = a.W, Wo = a.Wo, D = a.D, H = a.H, C = W * D;
  const bool use_diag = KIND == kV2 && !a.v2.test_mode;
  const WideSel sel = wide_sel_at(dyn, C);
  float* rows = reinterpret_cast<float*>(dyn + wide_sel_bytes(C));

  // 1. The rows (their first a.stage values), in flight from the start.
  Span sp{nullptr, rows, 0, 0, 0};
  if (a.state) {
    const int n = W * H;
    sp.g = a.state + (size_t)b * n;
    sp.lead = (int)(((uintptr_t)sp.g >> 2) & 3);
    sp.i0 = min((4 - sp.lead) & 3, n);
    sp.nb = min((n - sp.i0) & ~3, a.stage);
    if (tid == 0) {
      mbar_init(&bar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      if (sp.nb)
        bulk_copy(rows + sp.lead + sp.i0, sp.g + sp.i0, 4u * sp.nb, &bar);
    }
  }

  // 2. Candidates, 3. selection (its first barrier publishes the
  // mbarrier's initialisation).
  for (int c = tid; c < C; c += kThreads)
    store_wide(sel, c, candidate<KIND>(a, b, c));
  const int n = wide_select(sel, C, Wo, use_diag);
  for (int j = tid; j < Wo; j += kThreads) {
    const int src = sel.src[j];
    const size_t i = (size_t)b * Wo + j;
    a.out.pred[i] = sel.pred[src];
    a.out.lp[i] = sel.lp[src];
    a.out.nt[i] = sel.nt[src];
    a.out.nu[i] = sel.nu[src];
    a.out.fin[i] = (uint8_t)sel.fin[src];
    if (a.out.tot) a.out.tot[i] = sel.tot[src];
    a.out.branch[i] = src / D;
  }
  if (KIND == kV2 && tid == 0) a.o_nsurv[b] = n;

  // 4. The reorder.
  if (a.state) {
    if (sp.nb) mbar_wait(&bar, 0);
    reorder_span(sp, [&](int j) { return sel.src[j] / D; }, Wo, H,
                 a.o_state + (size_t)b * Wo * H);
  }
}

// The most dynamic shared memory a block of `kern` may take: the device's
// opt-in limit less its static part (-1 on an error).
int max_dynamic_smem(const void* kern) {
  int dev = 0, optin = 0;
  cudaFuncAttributes at;
  if (cudaFuncGetAttributes(&at, kern) != cudaSuccess ||
      cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return optin - (int)at.sharedSizeBytes;
}

// Bytes of dynamic shared memory for (W, H) rows: the span and up to 3
// floats of lead (16-byte alignment of the bulk copy's destination).
size_t rows_smem(const BeamArgs& a) {
  return a.state ? sizeof(float) * ((size_t)a.W * a.H + 4) : 0;
}

// Opts `kern` in to its whole dynamic shared memory, once per instance
// (outside graph captures after the first call); returns that size.
template <typename Kern>
int opt_in(Kern kern, int& limit) {
  if (limit < 0) {
    const int m = max_dynamic_smem((const void*)kern);
    if (m < 0 ||
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             m) != cudaSuccess)
      return -1;
    limit = m;
  }
  return limit;
}

// The narrow instance where it takes the step (W, W_out <= kMaxW, C <=
// kMaxC, the rows in its shared memory), else the wide one.
template <int KIND>
cudaError_t launch(BeamArgs a, cudaStream_t stream) {
  static int narrow_limit = -1, wide_limit = -1;
  const size_t smem = rows_smem(a);
  const int nl = opt_in(beam_step_kernel<KIND>, narrow_limit);
  if (nl < 0) return cudaErrorInvalidValue;
  if (a.W <= kMaxW && a.Wo <= kMaxW && a.W * a.D <= kMaxC &&
      smem <= (size_t)nl) {
    beam_step_kernel<KIND><<<a.B, kThreads, smem, stream>>>(a);
    return cudaGetLastError();
  }
  const int wl = opt_in(beam_step_wide_kernel<KIND>, wide_limit);
  const size_t sel = wide_sel_bytes(a.W * a.D);
  if (wl < 0 || sel + 16 * sizeof(float) > (size_t)wl)
    return cudaErrorInvalidValue;
  // The rows' values that fit after the selection's fields and the lead.
  const size_t room = ((size_t)wl - sel) / sizeof(float) - 4;
  a.stage = a.state ? (int)(((size_t)a.W * a.H < room ? (size_t)a.W * a.H
                                                      : room) & ~(size_t)3)
                    : 0;
  const size_t dyn = sel + (a.state ? sizeof(float) * ((size_t)a.stage + 4)
                                    : 0);
  beam_step_wide_kernel<KIND><<<a.B, kThreads, dyn, stream>>>(a);
  return cudaGetLastError();
}

bool bad_shape(int B, int W, int Wo, int D, int H) {
  return B < 1 || W < 1 || W > kMaxBeams || Wo < 1 || Wo > kMaxBeams ||
         D < 1 || (long long)W * D > kMaxCands || H < 1 ||
         (long long)B * W * H >= (1ll << 31);
}

void set_common(BeamArgs& a, int B, int W, int Wo, int D, int H,
                const void* h, const void* lp, const void* fin, const void* t,
                const void* u, const void* il, const void* state,
                void* o_pred, void* o_lp, void* o_nt, void* o_nu,
                void* o_fin, void* o_branch, void* o_state) {
  a.B = B; a.W = W; a.Wo = Wo; a.D = D; a.H = H;
  a.h = (const float*)h; a.lp = (const float*)lp;
  a.fin = (const uint8_t*)fin; a.t = (const int*)t; a.u = (const int*)u;
  a.il = (const int*)il; a.state = (const float*)state;
  a.out.pred = (int*)o_pred; a.out.lp = (float*)o_lp;
  a.out.nt = (int*)o_nt; a.out.nu = (int*)o_nu;
  a.out.fin = (uint8_t*)o_fin; a.out.tot = nullptr;
  a.out.branch = (int*)o_branch;
  a.o_state = (float*)o_state;
  a.stage = 0;
}

}  // namespace

extern "C" int ssnt_beam_step_max_candidates() { return kMaxCands; }
extern "C" int ssnt_beam_step_max_beams() { return kMaxBeams; }

// Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int ssnt_beam_v2_step(
    int B, int W, int W_out, int D, int H, const void* h, const void* lp,
    const void* fin, const void* tot, const void* t, const void* u,
    const void* il, const void* ol, const void* dtab, const void* state,
    void* o_pred, void* o_lp, void* o_nt, void* o_nu, void* o_fin,
    void* o_tot, void* o_branch, void* o_nsurv, void* o_state, int zero_id,
    int allow_skip, int test_mode, int overrun_mult, int feas_guard,
    float band_lower, float band_upper, float diag_lo, float diag_hi,
    void* stream) {
  if (bad_shape(B, W, W_out, D, H)) return (int)cudaErrorInvalidValue;
  BeamArgs a;
  set_common(a, B, W, W_out, D, H, h, lp, fin, t, u, il, state, o_pred,
             o_lp, o_nt, o_nu, o_fin, o_branch, o_state);
  a.tot = (const int*)tot; a.ol = (const int*)ol; a.dtab = (const int*)dtab;
  a.out.tot = (int*)o_tot; a.o_nsurv = (int*)o_nsurv;
  a.v2 = V2Opts{zero_id, allow_skip, test_mode, overrun_mult, feas_guard,
                band_lower, band_upper, diag_lo, diag_hi};
  a.empty_id = 0;
  return (int)launch<kV2>(a, (cudaStream_t)stream);
}

// Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int ssnt_beam_tone_step(
    int B, int W, int W_out, int K, int H, const void* h, const void* lp,
    const void* fin, const void* t, const void* u, const void* il,
    const void* state, void* o_pred, void* o_lp, void* o_nt, void* o_nu,
    void* o_fin, void* o_branch, void* o_state, int empty_id,
    void* stream) {
  if (bad_shape(B, W, W_out, K, H)) return (int)cudaErrorInvalidValue;
  BeamArgs a;
  set_common(a, B, W, W_out, K, H, h, lp, fin, t, u, il, state, o_pred,
             o_lp, o_nt, o_nu, o_fin, o_branch, o_state);
  a.tot = nullptr; a.ol = nullptr; a.dtab = nullptr; a.o_nsurv = nullptr;
  a.v2 = V2Opts{0, 0, 1, 0, 0, 0.0f, 0.0f, 0.0f, 0.0f};
  a.empty_id = empty_id;
  return (int)launch<kTone>(a, (cudaStream_t)stream);
}

// The v1 step; state/o_state null (and F = 0) for the step without rows.
// Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int ssnt_beam_v1_step(
    int B, int W, int W_out, int F, const void* h, const void* lp,
    const void* fin, const void* t, const void* u, const void* il,
    const void* state, void* o_pred, void* o_lp, void* o_nt, void* o_nu,
    void* o_fin, void* o_branch, void* o_state, void* stream) {
  if (bad_shape(B, W, W_out, 2, state ? F : 1) ||
      (state == nullptr) != (o_state == nullptr))
    return (int)cudaErrorInvalidValue;
  BeamArgs a;
  set_common(a, B, W, W_out, 2, F, h, lp, fin, t, u, il, state, o_pred,
             o_lp, o_nt, o_nu, o_fin, o_branch, o_state);
  a.tot = nullptr; a.ol = nullptr; a.dtab = nullptr; a.o_nsurv = nullptr;
  a.v2 = V2Opts{0, 0, 1, 0, 0, 0.0f, 0.0f, 0.0f, 0.0f};
  a.empty_id = 0;
  return (int)launch<kV1>(a, (cudaStream_t)stream);
}
