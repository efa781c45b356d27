// Fused v2 duration-decode beam step for Hopper (sm_90a).
//
// Replaces the TPU kernel ssnt_tts_tpu/ops/beam_fused.py:
// fused_class_beam_step(kind="v2") (pallas_call at :486, kernel body
// _make_fused_kernel at :197), with the candidate semantics of
// beam_pallas._v2_candidates and the selection semantics of
// beam_common.select_beams (not those of _select_bitonic: a valid score at
// or below the TPU kernel's sentinel is kept, as the XLA path keeps it).
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
//   2. the W*D candidate grid with every v2 prune (band, overrun, exact
//      final length, zero skip, optional final-feasibility guard), the
//      padding candidate of finished/out-of-range beams and the
//      on-diagonal flag; test_mode skips every prune;
//   3. the stable top-W selection: order (lp desc, generation asc) among
//      valid candidates with IEEE compares (-0.0 ties +0.0), adjacent
//      dedup field by field, pad by repetition, candidate 0 everywhere
//      when nothing survives, first surviving on-diagonal candidate into
//      the last slot;
//   4. the parent-pointer reorder of the GRU state.
//
// Band and diagonal bounds are computed one float32 rounding at a time
// (no fused multiply-add), as the reference and the numpy oracle do: a
// contracted `diag - U*0.05` moves an exact-integer lower edge by a frame.
// The file is built with -fmad=false and the bounds use __f*_rn
// intrinsics besides; the dot products use explicit __fmaf_rn.
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
// compute dtype; out_k (H, D), out_b (D) f32; prev_class/t/u/total
// (B, W) i32; log_prob (B, W) f32; is_finished (B, W) bool (1 byte);
// state (B, W, H) f32; input/output length (B,) i32; duration table (D,)
// i32; emptied (B,) bool. Optional debug outputs (null to skip):
// h (B, W, D) f32 and the pre-reorder new_h (B, W, H) f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxW = 16;
constexpr int kMaxC = kThreads;  // one thread per candidate
constexpr int kNone = 0x7fffffff;

template <typename CT> __device__ __forceinline__ float ld(const CT* p, size_t i);
template <> __device__ __forceinline__ float ld<float>(const float* p, size_t i) {
  return p[i];
}
template <> __device__ __forceinline__ float ld<__nv_bfloat16>(
    const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

// Round a float32 value to the compute dtype (identity for float32).
template <typename CT> __device__ __forceinline__ float rnd(float x);
template <> __device__ __forceinline__ float rnd<float>(float x) { return x; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float sigmoid_f32(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

struct StepArgs {
  int B, W, D, H, s;
  const void* xin_path; const float* base_path;
  const void* embed; const void* wi; const void* bi; const void* wh;
  const void* bhn; const float* out_k; const float* out_b;
  const int* prev_class; const float* state; const float* lp;
  const uint8_t* fin; const int* tot; const int* t; const int* u;
  const int* il; const int* ol; const int* dtab; const uint8_t* emptied;
  int* o_pred; float* o_lp; int* o_nt; int* o_nu; uint8_t* o_fin;
  int* o_tot; int* o_branch; int* o_nsurv; uint8_t* o_emptied;
  float* o_state; float* dbg_h; float* dbg_newh;
  int zero_id, allow_skip, test_mode, overrun_mult, feas_guard;
  float band_lower, band_upper, diag_lo, diag_hi;
};

template <typename CT, int WMAX>
__global__ void __launch_bounds__(kThreads)
fused_v2_step_kernel(StepArgs a) {
  const int b = blockIdx.x, tid = threadIdx.x;
  const int B = a.B, W = a.W, D = a.D, H = a.H, C = W * D, H3 = 3 * H;
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
  float* c_lp = h_s + W * D;       // candidates, (C,) each
  int* c_pred = reinterpret_cast<int*>(c_lp + C);
  int* c_nt = c_pred + C;
  int* c_nu = c_nt + C;
  int* c_tot = c_nu + C;
  int* c_fin = c_tot + C;
  int* c_valid = c_fin + C;
  int* c_diag = c_valid + C;
  int* c_rank = c_diag + C;
  int* order = c_rank + C;         // sorted position -> candidate
  int* keep_at = order + C;        // sorted position -> kept?
  int* surv = keep_at + C;         // survivor rank -> candidate
  __shared__ int br_s[kMaxW];
  __shared__ int first_diag;

  // ---- 1. AR class cell ----
  for (int i = tid; i < W * H; i += kThreads) {
    const int w = i / H, k = i - w * H;
    const int pc = a.prev_class[b * W + w];
    const float e = ld(embed, (size_t)pc * H + k);
    const float xi = ld(xin, ((size_t)a.s * B + b) * H + k);
    x_s[i] = rnd<CT>(__fadd_rn(e, xi));
    hb_s[i] = rnd<CT>(a.state[((size_t)b * W + w) * H + k]);
  }
  if (tid == 0) first_diag = kNone;
  __syncthreads();

  for (int k = tid; k < H; k += kThreads) {
    float air[WMAX], aiz[WMAX], ain[WMAX], ahr[WMAX], ahz[WMAX], ahn[WMAX];
#pragma unroll
    for (int w = 0; w < WMAX; ++w) {
      air[w] = aiz[w] = ain[w] = ahr[w] = ahz[w] = ahn[w] = 0.0f;
    }
    for (int i = 0; i < H; ++i) {
      const size_t row = (size_t)i * H3 + k;
      const float wir = ld(wi, row), wiz = ld(wi, row + H),
                  win = ld(wi, row + 2 * H);
      const float whr = ld(wh, row), whz = ld(wh, row + H),
                  whn = ld(wh, row + 2 * H);
#pragma unroll
      for (int w = 0; w < WMAX; ++w) {
        if (w < W) {
          const float xv = x_s[w * H + i], hv = hb_s[w * H + i];
          air[w] = __fmaf_rn(xv, wir, air[w]);
          aiz[w] = __fmaf_rn(xv, wiz, aiz[w]);
          ain[w] = __fmaf_rn(xv, win, ain[w]);
          ahr[w] = __fmaf_rn(hv, whr, ahr[w]);
          ahz[w] = __fmaf_rn(hv, whz, ahz[w]);
          ahn[w] = __fmaf_rn(hv, whn, ahn[w]);
        }
      }
    }
    const float bir = ld(bi, k), biz = ld(bi, H + k), bin = ld(bi, 2 * H + k);
    const float bn = ld(bhn, k);
#pragma unroll
    for (int w = 0; w < WMAX; ++w) {
      if (w < W) {
        const float gir = rnd<CT>(__fadd_rn(rnd<CT>(air[w]), bir));
        const float giz = rnd<CT>(__fadd_rn(rnd<CT>(aiz[w]), biz));
        const float gin = rnd<CT>(__fadd_rn(rnd<CT>(ain[w]), bin));
        const float ghr = rnd<CT>(ahr[w]), ghz = rnd<CT>(ahz[w]),
                    ghn = rnd<CT>(ahn[w]);
        const float r = rnd<CT>(sigmoid_f32(rnd<CT>(__fadd_rn(gir, ghr))));
        const float z = rnd<CT>(sigmoid_f32(rnd<CT>(__fadd_rn(giz, ghz))));
        const float rn = rnd<CT>(__fmul_rn(r, rnd<CT>(__fadd_rn(ghn, bn))));
        const float n = rnd<CT>(tanhf(rnd<CT>(__fadd_rn(gin, rn))));
        const float st = a.state[((size_t)b * W + w) * H + k];
        const float keep_n = rnd<CT>(__fmul_rn(rnd<CT>(__fsub_rn(1.0f, z)), n));
        const float nh = __fadd_rn(keep_n, __fmul_rn(z, st));
        nh_s[w * H + k] = nh;
        if (a.dbg_newh) a.dbg_newh[((size_t)b * W + w) * H + k] = nh;
      }
    }
  }
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
    const int c = tid, w = c / D, d = c - w * D;
    const int T = a.il[b], U = a.ol[b];
    const int tw = a.t[b * W + w], uw = a.u[b * W + w];
    const int tot0 = a.tot[b * W + w];
    const float hist = a.lp[b * W + w];
    const bool active = (tw < T) && !a.fin[b * W + w];
    const bool last = tw == T - 1;
    int tot = tot0 + a.dtab[d];
    const float Uf = (float)U, Tf = (float)T;
    const float ratio = __fdiv_rn(Uf, Tf);
    const float diag = __fmul_rn(ratio, (float)(tw + 1));
    const int lower = (int)fmaxf(__fsub_rn(diag, __fmul_rn(Uf, a.band_lower)), 0.0f);
    const int upper = (int)fminf(__fadd_rn(diag, __fmul_rn(Uf, a.band_upper)), Uf);
    const bool skip_ok = a.allow_skip || d != a.zero_id;
    valid = active && skip_ok;
    if (!a.test_mode) {
      const bool band_ok = tot >= lower && tot <= upper;
      const bool overrun = (T - (tw + 1)) * a.overrun_mult > U;
      const bool final_ok = !last || tot == U;
      valid = valid && band_ok && !overrun && final_ok;
      if (valid && a.feas_guard) {
        int dmin = kNone, dmax = a.dtab[0];
        for (int q = 0; q < D; ++q) {
          const int v = a.dtab[q];
          if ((a.allow_skip || q != a.zero_id) && v < dmin) dmin = v;
          if (v > dmax) dmax = v;
        }
        const int fut = max(T - 1 - tw, 0);
        const int rem = U - tot;
        valid = rem >= fut * dmin && rem <= fut * dmax;
      }
    }
    int pred = d, nt = last ? tw : tw + 1, nu = last ? uw : uw + 1;
    bool cfin = last;
    float clp = __fadd_rn(hist, h_s[c]);
    if (!active && d == 0) {  // padding candidate (src/v2.rs:313-323)
      pred = a.zero_id; clp = hist; nt = tw; nu = uw; cfin = true;
      tot = tot0; valid = true;
    }
    bool on_diag = false;
    if (!a.test_mode) {
      const float diff = __fsub_rn((float)tot, __fmul_rn(ratio, (float)nt));
      on_diag = diff >= a.diag_lo && diff <= a.diag_hi;
    }
    c_lp[c] = clp; c_pred[c] = pred; c_nt[c] = nt; c_nu[c] = nu;
    c_tot[c] = tot; c_fin[c] = cfin; c_valid[c] = valid; c_diag[c] = on_diag;
  }
  const int nvalid = __syncthreads_count(valid);

  // ---- 3. selection ----
  if (valid) {  // stable rank among valid candidates
    const float li = c_lp[tid];
    int r = 0;
    for (int j = 0; j < C; ++j) {
      if (c_valid[j]) {
        const float lj = c_lp[j];
        r += (lj > li) || (lj == li && j < tid);
      }
    }
    c_rank[tid] = r;
    order[r] = tid;
  }
  __syncthreads();
  bool keep = false;
  if (valid) {  // adjacent dedup on every field but the parent
    const int r = c_rank[tid];
    bool dup = false;
    if (r > 0) {
      const int p = order[r - 1];
      dup = c_pred[p] == c_pred[tid] && c_lp[p] == c_lp[tid] &&
            c_nt[p] == c_nt[tid] && c_nu[p] == c_nu[tid] &&
            c_fin[p] == c_fin[tid] && c_tot[p] == c_tot[tid];
    }
    keep = !dup;
    keep_at[r] = keep;
  }
  const int n = __syncthreads_count(keep);
  if (tid < nvalid && keep_at[tid]) {  // rank among survivors
    int kr = 0;
    for (int q = 0; q < tid; ++q) kr += keep_at[q];
    surv[kr] = order[tid];
  }
  __syncthreads();
  if (!a.test_mode && tid < n && c_diag[surv[tid]]) atomicMin(&first_diag, tid);
  __syncthreads();
  if (tid < W) {
    const int j = tid;
    int src = 0;
    if (n > 0) src = surv[j < n ? j : (j - n) % n];
    if (j == W - 1 && first_diag != kNone) src = surv[first_diag];
    const int o = b * W + j;
    a.o_pred[o] = c_pred[src];
    a.o_lp[o] = c_lp[src];
    a.o_nt[o] = c_nt[src];
    a.o_nu[o] = c_nu[src];
    a.o_fin[o] = (uint8_t)c_fin[src];
    a.o_tot[o] = c_tot[src];
    a.o_branch[o] = src / D;
    br_s[j] = src / D;
  }
  if (tid == 0) {
    a.o_nsurv[b] = n;
    a.o_emptied[b] = (uint8_t)(a.emptied[b] || n == 0);
  }
  __syncthreads();

  // ---- 4. parent-pointer reorder of the GRU state ----
  for (int i = tid; i < W * H; i += kThreads) {
    const int j = i / H, k = i - j * H;
    a.o_state[((size_t)b * W + j) * H + k] = nh_s[br_s[j] * H + k];
  }
}

size_t smem_bytes(int W, int D, int H) {
  const int C = W * D;
  return sizeof(float) * (3 * (size_t)W * H + (size_t)W * D + C) +
         sizeof(int) * 11 * (size_t)C;
}

template <typename CT, int WMAX>
cudaError_t launch(const StepArgs& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.W, a.D, a.H);
  auto kern = fused_v2_step_kernel<CT, WMAX>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<a.B, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename CT>
cudaError_t dispatch_w(const StepArgs& a, cudaStream_t stream) {
  if (a.W <= 4) return launch<CT, 4>(a, stream);
  if (a.W <= 8) return launch<CT, 8>(a, stream);
  return launch<CT, 16>(a, stream);
}

}  // namespace

extern "C" int ssnt_fused_v2_step_max_candidates() { return kMaxC; }
extern "C" int ssnt_fused_v2_step_max_beams() { return kMaxW; }

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
  if (B < 1 || W < 1 || W > kMaxW || D < 1 || W * D > kMaxC || H < 1)
    return (int)cudaErrorInvalidValue;
  StepArgs a;
  a.B = B; a.W = W; a.D = D; a.H = H; a.s = s;
  a.xin_path = xin_path; a.base_path = (const float*)base_path;
  a.embed = embed; a.wi = wi; a.bi = bi; a.wh = wh; a.bhn = bhn;
  a.out_k = (const float*)out_k; a.out_b = (const float*)out_b;
  a.prev_class = (const int*)prev_class; a.state = (const float*)state;
  a.lp = (const float*)lp; a.fin = (const uint8_t*)fin;
  a.tot = (const int*)tot; a.t = (const int*)t; a.u = (const int*)u;
  a.il = (const int*)il; a.ol = (const int*)ol; a.dtab = (const int*)dtab;
  a.emptied = (const uint8_t*)emptied;
  a.o_pred = (int*)o_pred; a.o_lp = (float*)o_lp; a.o_nt = (int*)o_nt;
  a.o_nu = (int*)o_nu; a.o_fin = (uint8_t*)o_fin; a.o_tot = (int*)o_tot;
  a.o_branch = (int*)o_branch; a.o_nsurv = (int*)o_nsurv;
  a.o_emptied = (uint8_t*)o_emptied; a.o_state = (float*)o_state;
  a.dbg_h = (float*)dbg_h; a.dbg_newh = (float*)dbg_newh;
  a.zero_id = zero_id; a.allow_skip = allow_skip; a.test_mode = test_mode;
  a.overrun_mult = overrun_mult; a.feas_guard = feas_guard;
  a.band_lower = band_lower; a.band_upper = band_upper;
  a.diag_lo = diag_lo; a.diag_hi = diag_hi;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = compute_bf16 ? dispatch_w<__nv_bfloat16>(a, st)
                               : dispatch_w<float>(a, st);
  return (int)e;
}
