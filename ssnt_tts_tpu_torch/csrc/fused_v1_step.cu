// Fused v1 decode beam step for Hopper (sm_90a).
//
// Replaces the TPU kernel ssnt_tts_tpu/ops/beam_fused.py:
// fused_v1_beam_step (pallas_call at :695, kernel body
// _make_v1_fused_kernel at :543), with the candidate and selection
// semantics of beam_select.cuh (v1_candidate, select_beams).
//
// One launch per output frame does, for every utterance and beam:
//   0. the gather of the beam's enc_pack row at clip(t, 0, T-1) (the TPU
//      decode leaves it to a separate XLA gather; here the step is one
//      launch);
//   1. the v1 model step in the rounding order of stepmath.v1_step_math,
//      for a float32 or bfloat16 compute dtype CT (rnd = round to CT,
//      dots accumulate in float32):
//        x = relu(rnd(rnd(rnd(prev_mel) . w1) + b1)), twice (the prenet)
//        new_h = the GRU cell of gru_step.cuh
//        pre = rnd(tanh(rnd(rnd(rnd(new_h) . dec_pre_k) + dec_pre_b)))
//        q = rnd(rnd(pre . dec_proj_k) + dec_proj_b)
//        logit_k = sum_r rnd(rnd(p_kr) * q_kr) (float32, in order)
//                  + enc_bias_k + (new_h . dec_bias_k + dec_bias_b_k)
//        h = log_softmax(logits), as shifted - log(exp + exp)
//        mel = rnd(rnd(em) + rnd(rnd(rnd(new_h) . dec_mel_k) + dec_mel_b))
//      where [p | enc_bias | em] is the gathered row;
//   2. the 2W emit/shift candidates (generation order c = w*2 + k);
//   3. the stable top-W selection with dedup and pad;
//   4. t_history (the parent's t), the reorder of new_h and of the mel
//      frame by parent, and the finished-beam keep: a beam whose parent
//      was finished (so its candidate is the finished padding) keeps the
//      parent's previous mel frame instead of the new one.
//
// What bounds it on an H100: latency. One block of 256 threads per
// utterance, so at the serving batch (B=32) 32 of 132 SMs are busy; a
// frame is ~0.27 GFLOP at W=8 (prenet, GRU and joints, ~526k MAC per
// beam) over ~1.05 MB of bfloat16 weights that stay resident in the 50 MB
// L2 across blocks and frames. Each dot runs one thread per output column
// with one register accumulator per beam, walking its input serially, so
// the prenet's and the GRU's 256-long walks are the kernel's time. What
// the design does about that: nothing yet; it is the simple first version
// (tensor cores, several blocks per utterance and a persistent
// multi-frame launch are later work).
//
// Layouts (row-major, contiguous): enc_pack (B, T, 2R+2+M) f32; t/u (B, W)
// i32; log_prob (B, W) f32; is_finished (B, W) bool (1 byte);
// input_length (B,) i32; prev_mel (B, W, M) f32; state (B, W, H) f32;
// weights in CT: prenet w1 (M, H), b1 (H), w2 (H, H), b2 (H), wi/wh
// (H, 3H), bi (3H), bhn (H), dec_pre_k (H, R), dec_pre_b (R), dec_proj_k
// (R, 2R), dec_proj_b (2R), dec_mel_k (H, M), dec_mel_b (M); f32:
// dec_bias_k (H, 2), dec_bias_b (2). Outputs: (B, W) prediction,
// log_prob, next_t, next_u, is_finished, branch, t_history; mel (B, W, M)
// and state (B, W, H) f32, reordered. Optional debug outputs (null to
// skip): h (B, W, 2), new_h (B, W, H) and mel (B, W, M) before the
// reorder.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "beam_select.cuh"
#include "gru_step.cuh"

namespace {

using namespace ssnt_beam;
using namespace ssnt_gru;

struct V1Args {
  int B, W, T, H, M, R;
  const float* enc_pack; const int* t; const int* u; const float* lp;
  const uint8_t* fin; const int* il; const float* prev_mel;
  const float* state;
  const void* pw1; const void* pb1; const void* pw2; const void* pb2;
  const void* wi; const void* bi; const void* wh; const void* bhn;
  const void* dpre_k; const void* dpre_b; const void* dproj_k;
  const void* dproj_b; const float* dbias_k; const float* dbias_b;
  const void* dmel_k; const void* dmel_b;
  BeamOut out;
  int* o_thist; float* o_mel; float* o_state;
  float* dbg_h; float* dbg_newh; float* dbg_mel;
};

// Width of the buffer that holds the prenet's hidden layer, and later
// pre (W, R) and q (W, 2R).
__host__ __device__ __forceinline__ int hidden_width(int H, int R) {
  return H > 3 * R ? H : 3 * R;
}

// minBlocks 1 as in fused_class_step.cu: one block per utterance.
template <typename CT, int WMAX>
__global__ void __launch_bounds__(kThreads, 1)
fused_v1_step_kernel(V1Args a) {
  const int b = blockIdx.x, tid = threadIdx.x;
  const int W = a.W, T = a.T, H = a.H, M = a.M, R = a.R;
  const int R2 = 2 * R, P = R2 + 2 + M, C = 2 * W, L = hidden_width(H, R);
  const size_t bw = (size_t)b * W;
  auto cw = [](const void* p) { return static_cast<const CT*>(p); };

  extern __shared__ float smem[];
  float* x0_s = smem;           // (W, M) rnd(prev_mel)
  float* x1_s = x0_s + W * M;   // (W, L) prenet hidden; later pre, q
  float* x_s = x1_s + W * L;    // (W, H) GRU input
  float* hb_s = x_s + W * H;    // (W, H) rnd(state), later rnd(new_h)
  float* nh_s = hb_s + W * H;   // (W, H) new_h before the reorder
  float* g_s = nh_s + W * H;    // (W, P) gathered enc_pack rows
  float* mel_s = g_s + W * P;   // (W, M) mel before the reorder
  float* h_s = mel_s + W * M;   // (W, 2) logits, then log-probs
  float* pre_s = x1_s;          // (W, R)
  float* q_s = x1_s + W * R;    // (W, 2R)
  __shared__ SelectSmem sel;

  // ---- 0. loads ----
  for (int i = tid; i < W * P; i += kThreads) {
    const int w = i / P, j = i - w * P;
    const int row = min(max(a.t[bw + w], 0), T - 1);
    g_s[i] = a.enc_pack[((size_t)b * T + row) * P + j];
  }
  for (int i = tid; i < W * M; i += kThreads)
    x0_s[i] = rnd<CT>(a.prev_mel[bw * M + i]);
  for (int i = tid; i < W * H; i += kThreads)
    hb_s[i] = rnd<CT>(a.state[bw * H + i]);
  __syncthreads();

  // ---- 1. model step ----
  dense_columns<CT, WMAX, kRelu>(x0_s, M, cw(a.pw1), cw(a.pb1), H, W, x1_s,
                                 H);
  __syncthreads();
  dense_columns<CT, WMAX, kRelu>(x1_s, H, cw(a.pw2), cw(a.pb2), H, W, x_s, H);
  __syncthreads();
  gru_columns<CT, WMAX>(x_s, hb_s, a.state + bw * H, cw(a.wi), cw(a.bi),
                        cw(a.wh), cw(a.bhn), W, H, nh_s,
                        a.dbg_newh ? a.dbg_newh + bw * H : nullptr);
  __syncthreads();
  for (int i = tid; i < W * H; i += kThreads) hb_s[i] = rnd<CT>(nh_s[i]);
  __syncthreads();
  dense_columns<CT, WMAX, kTanh>(hb_s, H, cw(a.dpre_k), cw(a.dpre_b), R, W,
                                 pre_s, R);
  dense_columns<CT, WMAX, kLinear>(hb_s, H, cw(a.dmel_k), cw(a.dmel_b), M, W,
                                   mel_s, M);
  __syncthreads();
  dense_columns<CT, WMAX, kLinear>(pre_s, R, cw(a.dproj_k), cw(a.dproj_b),
                                   R2, W, q_s, R2);
  __syncthreads();
  if (tid < C) {  // logit of class c = tid % 2 for beam w = tid / 2
    const int w = tid >> 1, c = tid & 1;
    const float* g = g_s + w * P;
    const float* q = q_s + w * R2;
    float acc = 0.0f;
    for (int r = c * R; r < (c + 1) * R; ++r)
      acc = __fadd_rn(acc, rnd<CT>(__fmul_rn(rnd<CT>(g[r]), q[r])));
    float db = 0.0f;
    for (int k = 0; k < H; ++k)
      db = __fmaf_rn(nh_s[w * H + k], a.dbias_k[2 * k + c], db);
    db = __fadd_rn(db, a.dbias_b[c]);
    h_s[tid] = __fadd_rn(__fadd_rn(acc, g[R2 + c]), db);
  }
  __syncthreads();
  if (tid < W) {  // log_softmax: shifted - log(exp + exp)
    const float le = h_s[2 * tid], ls = h_s[2 * tid + 1];
    const float m = fmaxf(le, ls);
    const float she = __fsub_rn(le, m), shs = __fsub_rn(ls, m);
    const float lse = logf(__fadd_rn(expf(she), expf(shs)));
    h_s[2 * tid] = __fsub_rn(she, lse);
    h_s[2 * tid + 1] = __fsub_rn(shs, lse);
    if (a.dbg_h) {
      a.dbg_h[2 * (bw + tid)] = h_s[2 * tid];
      a.dbg_h[2 * (bw + tid) + 1] = h_s[2 * tid + 1];
    }
  }
  for (int i = tid; i < W * M; i += kThreads) {
    const int w = i / M, m = i - w * M;
    mel_s[i] = rnd<CT>(__fadd_rn(rnd<CT>(g_s[w * P + R2 + 2 + m]), mel_s[i]));
    if (a.dbg_mel) a.dbg_mel[bw * M + i] = mel_s[i];
  }
  __syncthreads();

  // ---- 2. candidates, 3. selection ----
  bool valid = false;
  if (tid < C) {
    const int w = tid >> 1, k = tid & 1;
    const size_t o = bw + w;
    const Cand x = v1_candidate(k, h_s[tid], a.lp[o], a.fin[o], a.t[o],
                                a.u[o], a.il[b]);
    store_cand(sel, tid, x);
    valid = x.valid;
  }
  select_beams(sel, C, W, valid, false);
  write_selected(sel, b, W, 2, a.out);

  // ---- 4. t_history, reorders, finished-beam keep ----
  if (tid < W) a.o_thist[bw + tid] = a.t[bw + sel.src[tid] / 2];
  reorder_rows(nh_s, a.o_state + bw * H, sel, W, 2, H);
  for (int i = tid; i < W * M; i += kThreads) {
    const int j = i / M, m = i - j * M;
    const int src = sel.src[j], parent = src / 2;
    const bool keep = sel.fin[src] && a.fin[bw + parent];
    a.o_mel[bw * M + i] = keep ? a.prev_mel[(bw + parent) * M + m]
                               : mel_s[parent * M + m];
  }
}

size_t smem_bytes(int W, int H, int M, int R) {
  const size_t P = 2 * (size_t)R + 2 + M;
  return sizeof(float) * (size_t)W *
         (2 * (size_t)M + hidden_width(H, R) + 3 * (size_t)H + P + 2);
}

template <typename CT, int WMAX>
cudaError_t launch(const V1Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.W, a.H, a.M, a.R);
  auto kern = fused_v1_step_kernel<CT, WMAX>;
  // The static SelectSmem counts against the 48 KB a launch may use
  // without opting in. Opt in once per size (not on every frame, and not
  // inside a CUDA graph capture after the first call).
  static size_t opted = 0;
  if (smem + sizeof(SelectSmem) > 48 * 1024 && smem > opted) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    opted = smem;
  }
  kern<<<a.B, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename CT>
cudaError_t dispatch(const V1Args& a, cudaStream_t st) {
  if (a.W <= 4) return launch<CT, 4>(a, st);
  if (a.W <= 8) return launch<CT, 8>(a, st);
  return launch<CT, 16>(a, st);
}

}  // namespace

extern "C" int ssnt_fused_v1_max_beams() { return kMaxW; }

// Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int ssnt_fused_v1_step(
    int compute_bf16, int B, int W, int T, int H, int M, int R,
    const void* enc_pack, const void* t, const void* u, const void* lp,
    const void* fin, const void* il, const void* prev_mel, const void* state,
    const void* pw1, const void* pb1, const void* pw2, const void* pb2,
    const void* wi, const void* bi, const void* wh, const void* bhn,
    const void* dpre_k, const void* dpre_b, const void* dproj_k,
    const void* dproj_b, const void* dbias_k, const void* dbias_b,
    const void* dmel_k, const void* dmel_b, void* o_pred, void* o_lp,
    void* o_nt, void* o_nu, void* o_fin, void* o_branch, void* o_thist,
    void* o_mel, void* o_state, void* dbg_h, void* dbg_newh, void* dbg_mel,
    void* stream) {
  if (B < 1 || W < 1 || W > kMaxW || T < 1 || H < 1 || M < 1 || R < 1)
    return (int)cudaErrorInvalidValue;
  V1Args a;
  a.B = B; a.W = W; a.T = T; a.H = H; a.M = M; a.R = R;
  a.enc_pack = (const float*)enc_pack; a.t = (const int*)t;
  a.u = (const int*)u; a.lp = (const float*)lp;
  a.fin = (const uint8_t*)fin; a.il = (const int*)il;
  a.prev_mel = (const float*)prev_mel; a.state = (const float*)state;
  a.pw1 = pw1; a.pb1 = pb1; a.pw2 = pw2; a.pb2 = pb2;
  a.wi = wi; a.bi = bi; a.wh = wh; a.bhn = bhn;
  a.dpre_k = dpre_k; a.dpre_b = dpre_b; a.dproj_k = dproj_k;
  a.dproj_b = dproj_b; a.dbias_k = (const float*)dbias_k;
  a.dbias_b = (const float*)dbias_b; a.dmel_k = dmel_k; a.dmel_b = dmel_b;
  a.out.pred = (int*)o_pred; a.out.lp = (float*)o_lp;
  a.out.nt = (int*)o_nt; a.out.nu = (int*)o_nu;
  a.out.fin = (uint8_t*)o_fin; a.out.tot = nullptr;
  a.out.branch = (int*)o_branch;
  a.o_thist = (int*)o_thist; a.o_mel = (float*)o_mel;
  a.o_state = (float*)o_state;
  a.dbg_h = (float*)dbg_h; a.dbg_newh = (float*)dbg_newh;
  a.dbg_mel = (float*)dbg_mel;
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(compute_bf16 ? dispatch<__nv_bfloat16>(a, st)
                            : dispatch<float>(a, st));
}
