// SSNT lattice forward-backward kernels for Hopper (sm_90a).
//
// Replace the TPU kernels of ssnt_tts_tpu/ops/lattice_pallas.py that the
// training loss runs, in the log domain:
//
//   lattice_bidir           fused_alphas_betas_pallas (pallas_call :817,
//                           _bidir_kernel :746) and its lane-packed twin
//                           fused_alphas_betas_pallas_packed (:993, :886),
//                           which is bit-exact with it: alphas and betas
//                           of a float32 lattice in one launch.
//   lattice_forward_alphas  forward_alphas_pallas (:165, _fwd_kernel :110):
//                           alphas from a float32 or bfloat16 lattice.
//   lattice_backward_grads  backward_grads_pallas (:596, _bwdgrad_kernel
//                           :508): the reverse beta walk that writes
//                           d_le/d_ls/d_lf in the lattice's dtype; betas
//                           never reach device memory.
//   lattice_backward_betas  backward_betas_pallas (:348, _bwd_kernel :306):
//                           lattice_bidir's beta walk alone.
//   lattice_forward_alphas_banded, lattice_backward_grads_banded
//                           forward_alphas_pallas_banded (:289) and
//                           backward_grads_pallas_banded (:726): the
//                           variant="bandedN" walks, K columns composed into
//                           one step of the chain (see "banded" below).
//
// and in the exp domain:
//
//   lattice_bidir_exp       fused_alphas_betas_pallas_exp (:480,
//                           _bidir_kernel_exp :386): variant="exp".
//   lattice_expin           fused_expin_pallas (:1459, _bidir_kernel_expin
//                           :1336): the exp-native pass of ssnt_loss_expin
//                           (lattice_domain="exp").
//
// The recursions (ops/lattice.py; per example, column u of T values):
//   alpha_0[t] = t == 0 ? lf_0[t] : NEG
//   alpha_u[t] = lf_u[t] + lae(alpha_{u-1}[t] + le_{u-1}[t],
//                              alpha_{u-1}[t-1] + ls_{u-1}[t-1])
//   cont[t]    = lf_{u+1}[t] + beta_{u+1}[t]
//   beta_u[t]  = u == U_b-1 ? (t == T_b-1 ? le_u[t] : NEG)
//                : lae(le_u[t] + cont[t], ls_u[t] + cont[t+1])
// with lae(a, b) = max(a, b) + log1p(exp(-|a - b|)) (expf/log1pf, never
// the fast intrinsics; the file is built with -fmad=false, so every add
// and multiply is rounded as in the JAX kernels' operation order). NEG is
// -1e30, not -inf: masked cells are finite sums of NEG, so no inf - inf
// ever forms. Out-of-range t (t >= T_b) are computed and stored like the
// TPU kernels do; the consumers mask them.
//
// The exp-domain kernels walk the same recursions on probabilities: each
// column is a few multiply-adds per cell and a neighbour exchange whose
// edge fills with 0 (not NEG), and a block-wide row max renormalizes the
// field (lattice_bidir_exp: every column, dividing, with the running log
// normalizer added to the stored logs, log 0 = -inf; lattice_expin: after
// forward column u when (u + 1) % 4 == 0 and at backward column u when
// u % 4 == 0, scaling by the correctly rounded reciprocal, and storing the
// fields qn, bn with their per-column log scalars M, N). lattice_expin
// renormalizes by global column, where the TPU kernel counts columns
// inside its U-chunk and never renormalizes at a chunk below 4.
//
// Layout: every lattice tensor is (U, B, T) row-major, so one column of
// one example is T contiguous values. Lengths, g and logz are (B,); M, N
// and mcol are (U, B).
//
// What bounds them on an H100: the dependency chain, not the card. The
// bytes bound (each input read once, each output written once, 3.35 TB/s)
// is 6.1 us for the bidirectional pass at B=32 T=80 U=400 and 39/68 us for
// forward/backward at B=256 (f32), but every column waits for the one
// before it: U dependent steps of a few adds, one exp and one log1p, and
// a neighbour exchange (the exp-domain walks: a multiply-add, and a row
// max with a second barrier). Design: one thread block per example (per
// example and direction for the bidirectional kernels: the alpha and beta
// walks run on different SMs at once), one thread per source position t,
// the t-1 / t+1 neighbour through a double-buffered shared-memory row with
// one barrier per column, the row max by warp shuffles and one more
// barrier over a shared word per warp, and the next kAhead columns' inputs
// loaded into registers while the current ones are computed, so
// global-memory latency is off the chain. At B=32 this occupies 64 of 132
// SMs with 3 warps each: it is latency-bound by construction, and a
// faster design (more columns per step, a packed or split walk) is later
// work. Measured by chip_smoke.py (device time, NVIDIA H100 80GB HBM3,
// 700 W power limit): lattice_bidir B=32 0.081 ms; forward alphas B=256
// 0.073 ms (bf16 0.070); backward gradients B=256 0.147 ms (bf16 0.174):
// 0.18-0.37 us per column. The exp-domain walks are slower per column
// than the log-domain ones, not faster as on the TPU: the block-wide row
// max (shuffles, a barrier, a serial read of one word per warp) sits on
// the chain where the log walk has only its neighbour exchange;
// lattice_expin B=32 0.116 ms, lattice_bidir_exp 0.305 ms (a max, a
// division and two logs every column), lattice_backward_betas 0.081 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr float kTiny = 1e-30f;  // floor of an exp-domain normalizer
constexpr int kRenorm = 4;       // lattice_expin renormalizes every 4th
constexpr int kMaxT = 1024;      // one thread per source position
constexpr int kAhead = 8;        // columns loaded ahead of the chain

// Inputs are prefetched in their storage type and converted where they are
// used: a conversion right after the load would wait for the load there.
template <typename S> __device__ __forceinline__ S ld(const S* p, size_t i) {
  return __ldg(p + i);
}
__device__ __forceinline__ float f32(float x) { return x; }
__device__ __forceinline__ float f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename S> __device__ __forceinline__ void st(S* p, size_t i, float v);
template <> __device__ __forceinline__ void st<float>(float* p, size_t i, float v) {
  p[i] = v;
}
template <> __device__ __forceinline__ void st<__nv_bfloat16>(
    __nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float lae(float a, float b) {
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

// Loads kAhead columns starting at u0 and stepping by `dir` (+1 forward,
// -1 backward) for this thread's t; columns outside [0, U) (never used)
// are left as they were.
template <typename S>
__device__ __forceinline__ void load_cols(const S* __restrict__ x, S* r,
                                          int u0, int dir, int U,
                                          size_t col, size_t off, bool live) {
#pragma unroll
  for (int k = 0; k < kAhead; ++k) {
    const int u = u0 + dir * k;
    if (live && u >= 0 && u < U) r[k] = ld(x, (size_t)u * col + off);
  }
}

// The alpha walk of one example (shared by lattice_bidir and
// lattice_forward_alphas). sh: 2 x (kMaxT + 1) floats, sh[.][0] = NEG.
template <typename S>
__device__ void alpha_walk(int B, int T, int U, const S* __restrict__ le,
                           const S* __restrict__ ls, const S* __restrict__ lf,
                           float* __restrict__ alphas,
                           float (*sh)[kMaxT + 1]) {
  const int b = blockIdx.x, t = threadIdx.x;
  const bool live = t < T;
  const size_t col = (size_t)B * T, off = (size_t)b * T + t;
  S cle[kAhead], cls[kAhead], clf[kAhead];
  S nle[kAhead], nls[kAhead], nlf[kAhead];
  load_cols(le, cle, 0, 1, U, col, off, live);
  load_cols(ls, cls, 0, 1, U, col, off, live);
  load_cols(lf, clf, 0, 1, U, col, off, live);
  float alpha = kNeg, le_prev = kNeg, ls_prev = kNeg;
  for (int u0 = 0; u0 < U; u0 += kAhead) {
    load_cols(le, nle, u0 + kAhead, 1, U, col, off, live);
    load_cols(ls, nls, u0 + kAhead, 1, U, col, off, live);
    load_cols(lf, nlf, u0 + kAhead, 1, U, col, off, live);
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int u = u0 + k;
      if (u >= U) continue;  // uniform across the block
      if (u == 0) {
        alpha = t == 0 ? f32(clf[0]) : kNeg;
      } else {
        const float stay = alpha + le_prev;
        float* s = sh[u & 1];
        if (live) s[t + 1] = alpha + ls_prev;
        __syncthreads();
        const float moved = s[t];  // s[0] = NEG: nothing shifts into t = 0
        alpha = f32(clf[k]) + lae(stay, moved);
      }
      if (live) alphas[(size_t)u * col + off] = alpha;
      le_prev = f32(cle[k]);
      ls_prev = f32(cls[k]);
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      cle[k] = nle[k];
      cls[k] = nls[k];
      clf[k] = nlf[k];
    }
  }
}

// The beta walk of one example for lattice_bidir, in _bidir_kernel's
// operation order. sh: 2 x (kMaxT + 1) floats, sh[.][T] = NEG.
__device__ void beta_walk(int B, int T, int U, const float* __restrict__ le,
                          const float* __restrict__ ls,
                          const float* __restrict__ lf, int in_len,
                          int out_len, float* __restrict__ betas,
                          float (*sh)[kMaxT + 1]) {
  const int b = blockIdx.x, t = threadIdx.x;
  const bool live = t < T;
  const bool is_last_t = t == in_len - 1;
  const size_t col = (size_t)B * T, off = (size_t)b * T + t;
  float cle[kAhead], cls[kAhead], clf[kAhead];
  float nle[kAhead], nls[kAhead], nlf[kAhead];
  load_cols(le, cle, U - 1, -1, U, col, off, live);
  load_cols(ls, cls, U - 1, -1, U, col, off, live);
  load_cols(lf, clf, U - 1, -1, U, col, off, live);
  float beta = kNeg, lf_next = kNeg;
  for (int u0 = U - 1; u0 >= 0; u0 -= kAhead) {
    load_cols(le, nle, u0 - kAhead, -1, U, col, off, live);
    load_cols(ls, nls, u0 - kAhead, -1, U, col, off, live);
    load_cols(lf, nlf, u0 - kAhead, -1, U, col, off, live);
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int u = u0 - k;
      if (u < 0) continue;  // uniform across the block
      const float cont = lf_next + beta;
      float* s = sh[u & 1];
      if (live) s[t] = cont;
      __syncthreads();
      const float up = s[t + 1];  // s[T] = NEG: nothing shifts into T-1
      const float rec = lae(cle[k] + cont, cls[k] + up);
      beta = u == out_len - 1 ? (is_last_t ? cle[k] : kNeg) : rec;
      if (live) betas[(size_t)u * col + off] = beta;
      lf_next = clf[k];
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      cle[k] = nle[k];
      cls[k] = nls[k];
      clf[k] = nlf[k];
    }
  }
}

// The max over the block of v >= 0 (threads past T pass 0): warp shuffles,
// one word per warp in red, one barrier. The max of non-negative values
// does not depend on the order. red may be reused after the caller's next
// barrier.
__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) m = fmaxf(m, red[w]);
  return m;
}

// lattice_bidir_exp's alpha walk, _bidir_kernel_exp's forward column:
//   q = p * exp(le_{u-1}) + shift0_down(p * exp(ls_{u-1}))
//   p_raw = (u == 0 ? [t == 0] : q) * exp(lf_u);  s = max(rowmax, TINY)
//   alpha_u = log(p_raw) + m;  p = p_raw / s;  m += log(s)
// sh: 2 x (kMaxT + 1) floats, sh[.][0] = 0.
__device__ void exp_alpha_walk(int B, int T, int U,
                               const float* __restrict__ le,
                               const float* __restrict__ ls,
                               const float* __restrict__ lf,
                               float* __restrict__ alphas,
                               float (*sh)[kMaxT + 1], float* red) {
  const int b = blockIdx.x, t = threadIdx.x;
  const bool live = t < T;
  const size_t col = (size_t)B * T, off = (size_t)b * T + t;
  float cle[kAhead], cls[kAhead], clf[kAhead];
  float nle[kAhead], nls[kAhead], nlf[kAhead];
  load_cols(le, cle, 0, 1, U, col, off, live);
  load_cols(ls, cls, 0, 1, U, col, off, live);
  load_cols(lf, clf, 0, 1, U, col, off, live);
  const float first_t = t == 0 ? 1.0f : 0.0f;
  float p = 0.0f, m = 0.0f, e_le_prev = 0.0f, e_ls_prev = 0.0f;
  for (int u0 = 0; u0 < U; u0 += kAhead) {
    load_cols(le, nle, u0 + kAhead, 1, U, col, off, live);
    load_cols(ls, nls, u0 + kAhead, 1, U, col, off, live);
    load_cols(lf, nlf, u0 + kAhead, 1, U, col, off, live);
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int u = u0 + k;
      if (u >= U) continue;  // uniform across the block
      float q = 0.0f;
      if (u > 0) {
        float* s = sh[u & 1];
        if (live) s[t + 1] = p * e_ls_prev;
        __syncthreads();
        q = p * e_le_prev + s[t];  // s[0] = 0: nothing shifts into t = 0
      }
      const float p_raw = (u == 0 ? first_t : q) * expf(clf[k]);
      const float norm = fmaxf(block_max(live ? p_raw : 0.0f, red), kTiny);
      if (live) alphas[(size_t)u * col + off] = logf(p_raw) + m;
      p = p_raw / norm;
      m = m + logf(norm);
      e_le_prev = expf(cle[k]);
      e_ls_prev = expf(cls[k]);
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      cle[k] = nle[k];
      cls[k] = nls[k];
      clf[k] = nlf[k];
    }
  }
}

// lattice_bidir_exp's beta walk, _bidir_kernel_exp's backward column:
//   c = b * exp(lf_{u+1});  b_raw = exp(le_u) * c + exp(ls_u) * shift0_up(c)
//   at u == U_b-1: b_raw = [t == T_b-1] exp(le_u), n = 0
//   beta_u = log(b_raw) + n;  b = b_raw / s;  n += log(s)
// sh: 2 x (kMaxT + 1) floats, sh[.][T] = 0.
__device__ void exp_beta_walk(int B, int T, int U,
                              const float* __restrict__ le,
                              const float* __restrict__ ls,
                              const float* __restrict__ lf, int in_len,
                              int out_len, float* __restrict__ betas,
                              float (*sh)[kMaxT + 1], float* red) {
  const int b = blockIdx.x, t = threadIdx.x;
  const bool live = t < T;
  const bool is_last_t = t == in_len - 1;
  const size_t col = (size_t)B * T, off = (size_t)b * T + t;
  float cle[kAhead], cls[kAhead], clf[kAhead];
  float nle[kAhead], nls[kAhead], nlf[kAhead];
  load_cols(le, cle, U - 1, -1, U, col, off, live);
  load_cols(ls, cls, U - 1, -1, U, col, off, live);
  load_cols(lf, clf, U - 1, -1, U, col, off, live);
  float field = 0.0f, n = 0.0f, e_lf_next = 0.0f;
  for (int u0 = U - 1; u0 >= 0; u0 -= kAhead) {
    load_cols(le, nle, u0 - kAhead, -1, U, col, off, live);
    load_cols(ls, nls, u0 - kAhead, -1, U, col, off, live);
    load_cols(lf, nlf, u0 - kAhead, -1, U, col, off, live);
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int u = u0 - k;
      if (u < 0) continue;  // uniform across the block
      const float e_le = expf(cle[k]);
      const float c = field * e_lf_next;
      float* s = sh[u & 1];
      if (live) s[t] = c;
      __syncthreads();
      // s[T] = 0: nothing shifts into T-1
      float b_raw = e_le * c + expf(cls[k]) * s[t + 1];
      if (u == out_len - 1) {  // uniform across the block
        b_raw = is_last_t ? e_le : 0.0f;
        n = 0.0f;
      }
      const float norm = fmaxf(block_max(live ? b_raw : 0.0f, red), kTiny);
      if (live) betas[(size_t)u * col + off] = logf(b_raw) + n;
      field = b_raw / norm;
      n = n + logf(norm);
      e_lf_next = expf(clf[k]);
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      cle[k] = nle[k];
      cls[k] = nls[k];
      clf[k] = nlf[k];
    }
  }
}

// lattice_expin's alpha walk, _bidir_kernel_expin's forward column, from
// p = [t == 0], E_prev = 1, S_prev = 0:
//   q = p * E_{u-1} + shift0_down(p * S_{u-1})
//   if (u + 1) % 4 == 0: s = max(rowmax(q), TINY); q *= 1/s; m += log(s)
//   qn_u = q;  m += mcol_u;  M_u = m;  p = q * F_u
__device__ void expin_alpha_walk(int B, int T, int U,
                                 const float* __restrict__ E,
                                 const float* __restrict__ S,
                                 const float* __restrict__ F,
                                 const float* __restrict__ mcol,
                                 float* __restrict__ qn,
                                 float* __restrict__ M,
                                 float (*sh)[kMaxT + 1], float* red) {
  const int b = blockIdx.x, t = threadIdx.x;
  const bool live = t < T;
  const size_t col = (size_t)B * T, off = (size_t)b * T + t;
  float cE[kAhead], cS[kAhead], cF[kAhead], cm[kAhead];
  float nE[kAhead], nS[kAhead], nF[kAhead], nm[kAhead];
  load_cols(E, cE, 0, 1, U, col, off, live);
  load_cols(S, cS, 0, 1, U, col, off, live);
  load_cols(F, cF, 0, 1, U, col, off, live);
  load_cols(mcol, cm, 0, 1, U, (size_t)B, (size_t)b, true);
  float p = t == 0 ? 1.0f : 0.0f, m = 0.0f, e_prev = 1.0f, s_prev = 0.0f;
  for (int u0 = 0; u0 < U; u0 += kAhead) {
    load_cols(E, nE, u0 + kAhead, 1, U, col, off, live);
    load_cols(S, nS, u0 + kAhead, 1, U, col, off, live);
    load_cols(F, nF, u0 + kAhead, 1, U, col, off, live);
    load_cols(mcol, nm, u0 + kAhead, 1, U, (size_t)B, (size_t)b, true);
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int u = u0 + k;
      if (u >= U) continue;  // uniform across the block
      float* s = sh[u & 1];
      if (live) s[t + 1] = p * s_prev;
      __syncthreads();
      float q = p * e_prev + s[t];  // s[0] = 0: nothing shifts into t = 0
      if ((u + 1) % kRenorm == 0) {  // uniform across the block
        const float norm = fmaxf(block_max(live ? q : 0.0f, red), kTiny);
        q = q * __frcp_rn(norm);
        m = m + logf(norm);
      }
      if (live) qn[(size_t)u * col + off] = q;
      m = m + cm[k];
      if (t == 0) M[(size_t)u * B + b] = m;
      p = q * cF[k];
      e_prev = cE[k];
      s_prev = cS[k];
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      cE[k] = nE[k];
      cS[k] = nS[k];
      cF[k] = nF[k];
      cm[k] = nm[k];
    }
  }
}

// lattice_expin's beta walk, _bidir_kernel_expin's backward column, from
// c = 0, n = 0:
//   b_raw = E_u * c + S_u * shift0_up(c)
//   at u == U_b-1: b_raw = [t == T_b-1] E_u, n = 0
//   if u % 4 == 0: s = max(rowmax(b_raw), TINY); b_raw *= 1/s; n += log(s)
//   bn_u = b_raw;  N_u = n;  c = F_u * bn_u;  n += mcol_u
__device__ void expin_beta_walk(int B, int T, int U,
                                const float* __restrict__ E,
                                const float* __restrict__ S,
                                const float* __restrict__ F,
                                const float* __restrict__ mcol, int in_len,
                                int out_len, float* __restrict__ bn,
                                float* __restrict__ N,
                                float (*sh)[kMaxT + 1], float* red) {
  const int b = blockIdx.x, t = threadIdx.x;
  const bool live = t < T;
  const bool is_last_t = t == in_len - 1;
  const size_t col = (size_t)B * T, off = (size_t)b * T + t;
  float cE[kAhead], cS[kAhead], cF[kAhead], cm[kAhead];
  float nE[kAhead], nS[kAhead], nF[kAhead], nm[kAhead];
  load_cols(E, cE, U - 1, -1, U, col, off, live);
  load_cols(S, cS, U - 1, -1, U, col, off, live);
  load_cols(F, cF, U - 1, -1, U, col, off, live);
  load_cols(mcol, cm, U - 1, -1, U, (size_t)B, (size_t)b, true);
  float c = 0.0f, n = 0.0f;
  for (int u0 = U - 1; u0 >= 0; u0 -= kAhead) {
    load_cols(E, nE, u0 - kAhead, -1, U, col, off, live);
    load_cols(S, nS, u0 - kAhead, -1, U, col, off, live);
    load_cols(F, nF, u0 - kAhead, -1, U, col, off, live);
    load_cols(mcol, nm, u0 - kAhead, -1, U, (size_t)B, (size_t)b, true);
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int u = u0 - k;
      if (u < 0) continue;  // uniform across the block
      float* s = sh[u & 1];
      if (live) s[t] = c;
      __syncthreads();
      // s[T] = 0: nothing shifts into T-1
      float b_raw = cE[k] * c + cS[k] * s[t + 1];
      if (u == out_len - 1) {  // uniform across the block
        b_raw = is_last_t ? cE[k] : 0.0f;
        n = 0.0f;
      }
      if (u % kRenorm == 0) {  // uniform across the block
        const float norm = fmaxf(block_max(live ? b_raw : 0.0f, red),
                                 kTiny);
        b_raw = b_raw * __frcp_rn(norm);
        n = n + logf(norm);
      }
      if (live) bn[(size_t)u * col + off] = b_raw;
      if (t == 0) N[(size_t)u * B + b] = n;
      c = cF[k] * b_raw;
      n = n + cm[k];
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      cE[k] = nE[k];
      cS[k] = nS[k];
      cF[k] = nF[k];
      cm[k] = nm[k];
    }
  }
}

__global__ void bidir_kernel(int B, int T, int U, const float* __restrict__ le,
                             const float* __restrict__ ls,
                             const float* __restrict__ lf,
                             const int* __restrict__ il,
                             const int* __restrict__ ol,
                             float* __restrict__ alphas,
                             float* __restrict__ betas) {
  __shared__ float sh[2][kMaxT + 1];
  if (threadIdx.x == 0) {
    sh[0][0] = sh[1][0] = kNeg;
    sh[0][T] = sh[1][T] = kNeg;
  }
  __syncthreads();
  if (blockIdx.y == 0) {
    alpha_walk<float>(B, T, U, le, ls, lf, alphas, sh);
  } else {
    const int b = blockIdx.x;
    beta_walk(B, T, U, le, ls, lf, il[b], ol[b], betas, sh);
  }
}

__global__ void backward_betas_kernel(int B, int T, int U,
                                      const float* __restrict__ le,
                                      const float* __restrict__ ls,
                                      const float* __restrict__ lf,
                                      const int* __restrict__ il,
                                      const int* __restrict__ ol,
                                      float* __restrict__ betas) {
  __shared__ float sh[2][kMaxT + 1];
  if (threadIdx.x == 0) sh[0][T] = sh[1][T] = kNeg;
  __syncthreads();
  const int b = blockIdx.x;
  beta_walk(B, T, U, le, ls, lf, il[b], ol[b], betas, sh);
}

// The exp-domain kernels' shared rows carry 0 at both edges: the shifts
// fill with 0, not NEG.
__global__ void bidir_exp_kernel(int B, int T, int U,
                                 const float* __restrict__ le,
                                 const float* __restrict__ ls,
                                 const float* __restrict__ lf,
                                 const int* __restrict__ il,
                                 const int* __restrict__ ol,
                                 float* __restrict__ alphas,
                                 float* __restrict__ betas) {
  __shared__ float sh[2][kMaxT + 1];
  __shared__ float red[32];
  if (threadIdx.x == 0) {
    sh[0][0] = sh[1][0] = 0.0f;
    sh[0][T] = sh[1][T] = 0.0f;
  }
  __syncthreads();
  if (blockIdx.y == 0) {
    exp_alpha_walk(B, T, U, le, ls, lf, alphas, sh, red);
  } else {
    const int b = blockIdx.x;
    exp_beta_walk(B, T, U, le, ls, lf, il[b], ol[b], betas, sh, red);
  }
}

__global__ void expin_kernel(int B, int T, int U, const float* __restrict__ E,
                             const float* __restrict__ S,
                             const float* __restrict__ F,
                             const float* __restrict__ mcol,
                             const int* __restrict__ il,
                             const int* __restrict__ ol,
                             float* __restrict__ qn, float* __restrict__ bn,
                             float* __restrict__ M, float* __restrict__ N) {
  __shared__ float sh[2][kMaxT + 1];
  __shared__ float red[32];
  if (threadIdx.x == 0) {
    sh[0][0] = sh[1][0] = 0.0f;
    sh[0][T] = sh[1][T] = 0.0f;
  }
  __syncthreads();
  if (blockIdx.y == 0) {
    expin_alpha_walk(B, T, U, E, S, F, mcol, qn, M, sh, red);
  } else {
    const int b = blockIdx.x;
    expin_beta_walk(B, T, U, E, S, F, mcol, il[b], ol[b], bn, N, sh, red);
  }
}

template <typename S>
__global__ void forward_alphas_kernel(int B, int T, int U,
                                      const S* __restrict__ le,
                                      const S* __restrict__ ls,
                                      const S* __restrict__ lf,
                                      float* __restrict__ alphas) {
  __shared__ float sh[2][kMaxT + 1];
  if (threadIdx.x == 0) sh[0][0] = sh[1][0] = kNeg;
  __syncthreads();
  alpha_walk<S>(B, T, U, le, ls, lf, alphas, sh);
}

// _bwdgrad_kernel's walk: per column u (descending), the emit/shift/frame
// posteriors exp(min(score - logz, 30)) on the valid region, times -g (0
// for an example with no valid path, logz <= NEG/2), then beta_u.
template <typename S>
__global__ void backward_grads_kernel(
    int B, int T, int U, const S* __restrict__ le, const S* __restrict__ ls,
    const S* __restrict__ lf, const float* __restrict__ alphas,
    const int* __restrict__ il, const int* __restrict__ ol,
    const float* __restrict__ g, const float* __restrict__ logz,
    S* __restrict__ d_le, S* __restrict__ d_ls, S* __restrict__ d_lf) {
  __shared__ float sh[2][kMaxT + 1];
  const int b = blockIdx.x, t = threadIdx.x;
  if (t == 0) sh[0][T] = sh[1][T] = kNeg;
  __syncthreads();
  const bool live = t < T;
  const int in_len = il[b], out_len = ol[b];
  const float lz = logz[b];
  const float neg_g = lz <= kNeg / 2 ? 0.0f : -g[b];
  const bool is_last_t = t == in_len - 1, t_valid = t < in_len;
  const size_t col = (size_t)B * T, off = (size_t)b * T + t;
  S cle[kAhead], cls[kAhead], clf[kAhead];
  S nle[kAhead], nls[kAhead], nlf[kAhead];
  float cal[kAhead], nal[kAhead];
  load_cols(le, cle, U - 1, -1, U, col, off, live);
  load_cols(ls, cls, U - 1, -1, U, col, off, live);
  load_cols(lf, clf, U - 1, -1, U, col, off, live);
  load_cols(alphas, cal, U - 1, -1, U, col, off, live);
  float beta = kNeg, lf_next = kNeg;
  for (int u0 = U - 1; u0 >= 0; u0 -= kAhead) {
    load_cols(le, nle, u0 - kAhead, -1, U, col, off, live);
    load_cols(ls, nls, u0 - kAhead, -1, U, col, off, live);
    load_cols(lf, nlf, u0 - kAhead, -1, U, col, off, live);
    load_cols(alphas, nal, u0 - kAhead, -1, U, col, off, live);
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int u = u0 - k;
      if (u < 0) continue;  // uniform across the block
      const bool is_last_u = u == out_len - 1;
      const bool valid = t_valid && u < out_len;
      const float cont = lf_next + beta;
      float* s = sh[u & 1];
      if (live) s[t] = cont;
      __syncthreads();
      const float cont_shift_raw = s[t + 1];
      const float cont_emit = is_last_u ? (is_last_t ? 0.0f : kNeg) : cont;
      const float cont_shift = is_last_u ? kNeg : cont_shift_raw;
      const float le_u = f32(cle[k]), ls_u = f32(cls[k]);
      const float anorm = cal[k] - lz;
      const float p_le =
          valid ? expf(fminf(anorm + le_u + cont_emit, 30.0f)) : 0.0f;
      const float p_ls =
          valid ? expf(fminf(anorm + ls_u + cont_shift, 30.0f)) : 0.0f;
      const float rec = lae(le_u + cont, ls_u + cont_shift_raw);
      beta = is_last_u ? (is_last_t ? le_u : kNeg) : rec;
      const float p_lf = valid ? expf(fminf(anorm + beta, 30.0f)) : 0.0f;
      if (live) {
        const size_t i = (size_t)u * col + off;
        st(d_le, i, neg_g * p_le);
        st(d_ls, i, neg_g * p_ls);
        st(d_lf, i, neg_g * p_lf);
      }
      lf_next = f32(clf[k]);
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      cle[k] = nle[k];
      cls[k] = nls[k];
      clf[k] = nlf[k];
      cal[k] = nal[k];
    }
  }
}

// ------------------------------------------------------------------ banded
//
// lattice_forward_alphas_banded and lattice_backward_grads_banded: the
// K-banded walks of forward_alphas_pallas_banded (pallas_call :289,
// _fwd_kernel_banded :236) and backward_grads_pallas_banded (:726,
// _bwdgrad_kernel_banded :626), K in {2, 4, 8, 16} a template parameter.
// Column u's step is a 2-band operator over the (logsumexp, +) semiring;
// the K columns of a group (global columns gK .. gK+K-1, U padded with NEG
// to a multiple of K, as JAX's chunk padding does) compose by a pairwise
// tree into one (K+1)-band operator, and the chain applies U/K of them.
// The interior columns are replayed from each group's start value.
// Everything follows the TPU kernel's operation order, so that the plain
// versions in ops/lattice_kernels.py equal the kernels bit for bit:
//   - lse of n terms (_lse :76): the max, then sum exp(x - max) left to
//     right, then max + log(sum); one term is itself;
//   - a composed entry k of A o B (B applied first) sums A[i] + B[k-i]
//     read at t - i (forward) or t + i (backward) over ascending i, NEG
//     where that leaves [0, T) (_compose_down/_compose_up :202-220);
//   - the tree composes ops[2p+1] o ops[2p] level by level (_tree_compose
//     :223); the backward's list is its columns from the top down.
// The forward starts from a virtual carry (alpha = [t == 0] as 0/NEG,
// le_prev = 0, ls_prev = NEG). The backward uniformizes its columns (le,
// lf -> 0 for u >= U_b, ls -> NEG for u >= U_b - 1) and starts from one
// virtual init at the padded top (beta = [t == T_b - 1] as 0/NEG, lf =
// 0), then writes the three posteriors per column as
// lattice_backward_grads does.
//
// Design of the forward: three passes in order on one stream, as the TPU
// kernel's own comments place its parts (lattice_pallas.py:262-271: the
// tree and the interior replay are off the chain, the banded apply is the
// only chain-dependent step):
//   1. compose (a block per group and example, one thread per t): the K
//      column operators from global memory (the t - 1 neighbour of ls
//      too), the tree through two alternating shared buffers of K rows of
//      T, one barrier a level; the (K+1)-band result P_g goes to a
//      workspace P[g][k][b][t], (K+1) G B T floats (6.1 MB at K=2, B=32,
//      T=80, U=400: it stays in L2; 49 MB at B=256);
//   2. chain (a block per example): U/K steps of next = lse(P_g[k] +
//      alpha(t - k)), one shared row and one barrier a step, P's next
//      groups loaded into registers ahead (chain_ahead); writes each
//      group's last column;
//   3. replay (a block per group and example): the K - 1 interior
//      columns from the group's start value (the previous group's last
//      column), one barrier a column.
// So the chain's depth falls from log2(K) + K - 1 barriers a group to one,
// and the rest runs on every SM at once. The backward is one block per
// example, one thread per t: a group's operators in registers, the tree as
// above, the chain's value in one of two alternating shared rows, and each
// interior column one more row and barrier, log2(K) + K barriers a group.
// What bounds them: not the bytes (forward bound 4.9 us at B=32, T=80,
// U=400; 8.6 us at K=2 with the workspace written and read). Measured by
// bench_fused.py (device time under a CUDA graph and, by pass,
// torch.profiler; NVIDIA H100 80GB HBM3, 700 W): the forward takes 0.053 /
// 0.037 / 0.036 / 0.051 ms at K = 2/4/8/16 and B=32 (the one-block design
// before it: 0.137-0.301 ms; the plain forward 0.060). Up to K=8 the chain
// sets it (200 steps of 0.21 us at K=2, 50 of 0.31 at K=8); at K=16 the
// compose pass (25 us: a 17-band tree, 218 accurate exp and log per cell
// and group), and at B=256 compose and replay (the lattice read twice, the
// workspace 49 MB at K=2): 0.14-0.27 ms against the plain forward's
// 0.066. The backward: 0.216 ms at K=2 and 0.351 ms at K=16 at B=32,
// 0.36-0.51 ms at B=256. Registers cap a block below kMaxT threads at the
// larger K, which the wrapper asks through ssnt_lattice_banded_max_t (the
// least of the three passes' limits for the forward).

// A band entry of row `row` read at t - i (kUp false) or t + i (kUp true);
// NEG where that leaves [0, T).
template <bool kUp>
__device__ __forceinline__ float shifted(const float* row, int t, int i,
                                         int T, bool live) {
  const int s = kUp ? t + i : t - i;
  return (live && s >= 0 && s < T) ? row[s] : kNeg;
}

// _lse of the first n of x, in order.
template <int NMAX>
__device__ __forceinline__ float lse_terms(const float (&x)[NMAX], int n) {
  if (n == 1) return x[0];
  float m = x[0];
#pragma unroll
  for (int i = 1; i < NMAX; ++i)
    if (i < n) m = fmaxf(m, x[i]);
  float acc = expf(x[0] - m);
#pragma unroll
  for (int i = 1; i < NMAX; ++i)
    if (i < n) acc = acc + expf(x[i] - m);
  return m + logf(acc);
}

// One level of the tree: out[p] = ops[2p+1] o ops[2p] for each of the N/2
// pairs (W-band operands, 2W-1-band results). buf: N/2 * W rows of T.
template <bool kUp, int N, int W>
__device__ __forceinline__ void compose_level(const float (&ops)[N][W],
                                              float (&out)[N / 2][2 * W - 1],
                                              float* buf, int T, int t,
                                              bool live) {
  if (live) {
#pragma unroll
    for (int p = 0; p < N / 2; ++p)
#pragma unroll
      for (int j = 0; j < W; ++j) buf[(p * W + j) * T + t] = ops[2 * p][j];
  }
  __syncthreads();
#pragma unroll
  for (int p = 0; p < N / 2; ++p) {
#pragma unroll
    for (int k = 0; k < 2 * W - 1; ++k) {
      const int lo = k > W - 1 ? k - (W - 1) : 0;
      const int hi = k < W - 1 ? k : W - 1;
      float x[W];
#pragma unroll
      for (int i = 0; i < W; ++i) {
        if (i >= lo && i <= hi)
          x[i - lo] = ops[2 * p + 1][i] +
                      shifted<kUp>(buf + (p * W + k - i) * T, t, i, T, live);
      }
      out[p][k] = lse_terms(x, hi - lo + 1);
    }
  }
}

// The whole tree: N W-band operators -> P, the (KB)-band composition.
// Level l uses the buffer tb + (l & 1) * (KB - 1) * T.
template <bool kUp, int KB, int N, int W>
__device__ __forceinline__ void compose_tree(const float (&ops)[N][W],
                                             float (&P)[KB], float* tb,
                                             int T, int t, bool live,
                                             int level) {
  if constexpr (N == 1) {
    static_assert(W == KB, "the tree ends in one (K+1)-band operator");
#pragma unroll
    for (int k = 0; k < KB; ++k) P[k] = ops[0][k];
  } else {
    float nxt[N / 2][2 * W - 1];
    compose_level<kUp, N, W>(ops, nxt, tb + (level & 1) * (KB - 1) * T, T,
                             t, live);
    compose_tree<kUp, KB, N / 2, 2 * W - 1>(nxt, P, tb, T, t, live,
                                            level + 1);
  }
}

// Column u = g*K + j's operator for this thread's t: [lf_u + le_{u-1},
// lf_u + ls_{u-1}(t-1)], NEG past U (le_{-1} = 0, ls_{-1} = NEG).
template <int K>
__device__ __forceinline__ void forward_column_ops(
    int g, int U, size_t col, size_t off, int t, bool live,
    const float* __restrict__ le, const float* __restrict__ ls,
    const float* __restrict__ lf, float (&M)[K][2]) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int u = g * K + j;
    float lf_u = kNeg, le_p = u == 0 ? 0.0f : kNeg, ls_p = kNeg;
    if (live) {
      if (u < U) lf_u = ld(lf, (size_t)u * col + off);
      if (u >= 1 && u <= U) {
        le_p = ld(le, (size_t)(u - 1) * col + off);
        if (t >= 1) ls_p = ld(ls, (size_t)(u - 1) * col + off - 1);
      }
    }
    M[j][0] = lf_u + le_p;
    M[j][1] = lf_u + ls_p;
  }
}

// The forward's three passes. The workspace P holds each group's composed
// (K+1)-band operator as P[g][k][b][t] ((G, K+1, B, T) f32, G = ceil(U/K)).
// Pass 1, off the chain (a block per group and example): the K column
// operators and their composition tree into P.
template <int K>
__global__ void banded_compose_kernel(int B, int T, int U, int G,
                                      const float* __restrict__ le,
                                      const float* __restrict__ ls,
                                      const float* __restrict__ lf,
                                      float* __restrict__ P) {
  extern __shared__ float smem[];  // tree operands: 2 x K rows of T
  const int g = blockIdx.x % G, b = blockIdx.x / G, t = threadIdx.x;
  const bool live = t < T;
  const size_t col = (size_t)B * T, off = (size_t)b * T + t;
  float M[K][2];
  forward_column_ops<K>(g, U, col, off, t, live, le, ls, lf, M);
  float Pg[K + 1];
  compose_tree<false, K + 1, K, 2>(M, Pg, smem, T, t, live, 0);
  if (live) {
#pragma unroll
    for (int k = 0; k <= K; ++k)
      P[((size_t)g * (K + 1) + k) * col + off] = Pg[k];
  }
}

// Groups of P a chain thread holds in registers ahead of the chain: about
// 24 values a buffer (two buffers), which keeps the chain's registers low
// enough for blocks of several hundred threads (ssnt_lattice_banded_max_t).
template <int K> __host__ __device__ constexpr int chain_ahead() {
  return 24 / (K + 1) > 2 ? 24 / (K + 1) : 2;
}

// P's groups g0 .. g0 + A - 1 at this thread's (b, t); NEG past G.
template <int K, int A>
__device__ __forceinline__ void load_groups(const float* __restrict__ P,
                                            float (&r)[A][K + 1], int g0,
                                            int G, size_t col, size_t off,
                                            bool live) {
#pragma unroll
  for (int a = 0; a < A; ++a)
#pragma unroll
    for (int k = 0; k <= K; ++k)
      r[a][k] = live && g0 + a < G
                    ? ld(P, ((size_t)(g0 + a) * (K + 1) + k) * col + off)
                    : kNeg;
}

// Pass 2, the chain (a block per example): alpha at g*K + K - 1 from alpha
// at g*K - 1 through P_g, one barrier a group, P's next groups loaded into
// registers while the current ones are applied. Writes each group's last
// column, which is the next group's start.
template <int K>
__global__ void banded_chain_kernel(int B, int T, int U, int G,
                                    const float* __restrict__ P,
                                    float* __restrict__ alphas) {
  constexpr int A = chain_ahead<K>();
  __shared__ float rows[2][kMaxT];
  const int b = blockIdx.x, t = threadIdx.x;
  const bool live = t < T;
  const size_t col = (size_t)B * T, off = (size_t)b * T + t;
  float cur[A][K + 1], nxt[A][K + 1];
  load_groups<K, A>(P, cur, 0, G, col, off, live);
  float alpha = t == 0 ? 0.0f : kNeg;  // the virtual alpha_{-1}
  for (int g0 = 0; g0 < G; g0 += A) {
    load_groups<K, A>(P, nxt, g0 + A, G, col, off, live);
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const int g = g0 + a;
      if (g >= G) break;  // uniform across the block
      float* s = rows[g & 1];
      if (live) s[t] = alpha;
      __syncthreads();
      float x[K + 1];
#pragma unroll
      for (int k = 0; k <= K; ++k)
        x[k] = cur[a][k] + shifted<false>(s, t, k, T, live);
      alpha = lse_terms(x, K + 1);
      const int u = g * K + K - 1;
      if (live && u < U) alphas[(size_t)u * col + off] = alpha;
    }
#pragma unroll
    for (int a = 0; a < A; ++a)
#pragma unroll
      for (int k = 0; k <= K; ++k) cur[a][k] = nxt[a][k];
  }
}

// Pass 3, off the chain (a block per group and example): the K - 1
// interior columns of group g from its start value (alpha at g*K - 1, the
// chain's, or the virtual carry for g = 0), one barrier a column.
template <int K>
__global__ void banded_replay_kernel(int B, int T, int U, int G,
                                     const float* __restrict__ le,
                                     const float* __restrict__ ls,
                                     const float* __restrict__ lf,
                                     float* __restrict__ alphas) {
  __shared__ float rows[2][kMaxT];
  const int g = blockIdx.x % G, b = blockIdx.x / G, t = threadIdx.x;
  const bool live = t < T;
  const size_t col = (size_t)B * T, off = (size_t)b * T + t;
  const int base = g * K;
  float M[K][2];
  forward_column_ops<K>(g, U, col, off, t, live, le, ls, lf, M);
  float a = t == 0 ? 0.0f : kNeg;
  if (g > 0 && live) a = alphas[(size_t)(base - 1) * col + off];
  float* s = rows[0];
  if (live) s[t] = a;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < K - 1; ++j) {
    const float y[2] = {M[j][0] + a,
                        M[j][1] + shifted<false>(s, t, 1, T, live)};
    a = lse_terms(y, 2);
    if (live && base + j < U) alphas[(size_t)(base + j) * col + off] = a;
    if (j < K - 2) {
      s = rows[(j + 1) & 1];
      if (live) s[t] = a;
      __syncthreads();
    }
  }
}

// grads_at of _bwdgrad_kernel_banded for column u, given beta at u + 1
// (bnext, and bnext_up at t + 1) and at u (bu).
__device__ __forceinline__ void banded_grads(
    int u, int U, int T, int t, bool live, int out_len, bool is_last_t,
    bool t_valid, float neg_g, float lz, float al, float leu, float ls_u,
    float lfa, float lfa_up, float bnext, float bnext_up, float bu,
    size_t i, float* __restrict__ d_le, float* __restrict__ d_ls,
    float* __restrict__ d_lf) {
  const bool is_last_u = u == out_len - 1;
  const float a = u < out_len ? al - lz : kNeg;
  const float cont = lfa + bnext;
  const float cont_emit = is_last_u ? (is_last_t ? 0.0f : kNeg) : cont;
  const float cont_up = t + 1 < T ? lfa_up + bnext_up : kNeg;
  const float cont_shift = is_last_u ? kNeg : cont_up;
  const float p_le = t_valid ? expf(fminf(a + leu + cont_emit, 30.0f)) : 0.0f;
  const float p_ls = t_valid ? expf(fminf(a + ls_u + cont_shift, 30.0f))
                             : 0.0f;
  const float p_lf = t_valid ? expf(fminf(a + bu, 30.0f)) : 0.0f;
  if (live && u < U) {
    d_le[i] = neg_g * p_le;
    d_ls[i] = neg_g * p_ls;
    d_lf[i] = neg_g * p_lf;
  }
}

template <int K>
__global__ void backward_grads_banded_kernel(
    int B, int T, int U, const float* __restrict__ le,
    const float* __restrict__ ls, const float* __restrict__ lf,
    const float* __restrict__ alphas, const int* __restrict__ il,
    const int* __restrict__ ol, const float* __restrict__ g,
    const float* __restrict__ logz, float* __restrict__ d_le,
    float* __restrict__ d_ls, float* __restrict__ d_lf) {
  extern __shared__ float smem[];
  float* tb = smem;                  // tree operands: 2 x K rows of T
  float* rows = smem + 2 * K * T;    // chain and replay: 2 rows of T
  const int b = blockIdx.x, t = threadIdx.x;
  const bool live = t < T;
  const int in_len = il[b], out_len = ol[b];
  const float lz = logz[b];
  const float neg_g = lz <= kNeg / 2 ? 0.0f : -g[b];
  const bool is_last_t = t == in_len - 1, t_valid = t < in_len;
  const size_t col = (size_t)B * T, off = (size_t)b * T + t;
  const int groups = (U + K - 1) / K, Up = groups * K;
  float beta = is_last_t ? 0.0f : kNeg;  // the virtual init at the top
  int r = 0;
  for (int gi = groups - 1; gi >= 0; --gi) {
    const int base = gi * K;
    // Uniformized column u (NEG past U, as JAX's padding): leu, ls, the
    // uniformized lf above it (lfa; lfa_up at t + 1, NEG at T - 1; 0 at the
    // padded top), alpha, and its operator [leu + lfa, lsu + lfa_up].
    float leu[K], lsr[K], lfa[K], lfa_up[K], al[K], N[K][2];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int u = base + j;
      float le_u = kNeg, ls_u = kNeg, al_u = kNeg, f = 0.0f, f_up = kNeg;
      if (live && u < U) {
        le_u = ld(le, (size_t)u * col + off);
        ls_u = ld(ls, (size_t)u * col + off);
        al_u = ld(alphas, (size_t)u * col + off);
      }
      if (u + 1 < Up && u + 1 < out_len) {
        f = kNeg;
        if (live && u + 1 < U) {
          f = ld(lf, (size_t)(u + 1) * col + off);
          if (t + 1 < T) f_up = ld(lf, (size_t)(u + 1) * col + off + 1);
        }
      } else if (t + 1 < T) {
        f_up = 0.0f;
      }
      leu[j] = u < out_len ? le_u : 0.0f;
      lsr[j] = ls_u;
      lfa[j] = f;
      lfa_up[j] = f_up;
      al[j] = al_u;
      N[j][0] = leu[j] + f;
      N[j][1] = (u < out_len - 1 ? ls_u : kNeg) + f_up;
    }
    // The tree composes the columns from the top down.
    float Nr[K][2];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      Nr[j][0] = N[K - 1 - j][0];
      Nr[j][1] = N[K - 1 - j][1];
    }
    float P[K + 1];
    compose_tree<true, K + 1, K, 2>(Nr, P, tb, T, t, live, 0);
    // The chain: beta at base from beta at base + K.
    float* s = rows + r * T;
    r ^= 1;
    if (live) s[t] = beta;
    __syncthreads();
    float x[K + 1];
#pragma unroll
    for (int k = 0; k <= K; ++k) x[k] = P[k] + shifted<true>(s, t, k, T, live);
    const float bottom = lse_terms(x, K + 1);
    // The interior: columns base + K - 1 .. base + 1, then the gradients of
    // each column (base with the chain's value).
    float bnext = beta;
#pragma unroll
    for (int j = K - 1; j >= 0; --j) {
      const float up = shifted<true>(s, t, 1, T, live);
      float bu = bottom;
      if (j > 0) {
        const float y[2] = {N[j][0] + bnext, N[j][1] + up};
        bu = lse_terms(y, 2);
      }
      banded_grads(base + j, U, T, t, live, out_len, is_last_t, t_valid,
                   neg_g, lz, al[j], leu[j], lsr[j], lfa[j], lfa_up[j],
                   bnext, up, bu, (size_t)(base + j) * col + off, d_le, d_ls,
                   d_lf);
      if (j > 0) {
        s = rows + r * T;
        r ^= 1;
        if (live) s[t] = bu;
        __syncthreads();
        bnext = bu;
      }
    }
    beta = bottom;
  }
}

size_t banded_smem(int K, int T) {
  return sizeof(float) * (2 * (size_t)K + 2) * T;
}

// Opts a kernel into `smem` bytes of dynamic shared memory past the 48 KB
// default, once per size (not inside a CUDA graph capture after the first
// call).
template <typename Kern>
cudaError_t opt_in(Kern kern, size_t smem, size_t* opted) {
  if (smem <= 48 * 1024 || smem <= *opted) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) *opted = smem;
  return e;
}

int threads_for(int T) { return ((T + 31) / 32) * 32; }

size_t tree_smem(int K, int T) { return sizeof(float) * 2 * (size_t)K * T; }

// The three passes of the banded forward, in order on one stream; P is the
// (G, K+1, B, T) workspace.
template <int K>
cudaError_t launch_forward_banded(int B, int T, int U, const float* le,
                                  const float* ls, const float* lf,
                                  float* alphas, float* P, cudaStream_t s) {
  static size_t opted = 0;
  const size_t smem = tree_smem(K, T);
  cudaError_t e = opt_in(banded_compose_kernel<K>, smem, &opted);
  if (e != cudaSuccess) return e;
  const int G = (U + K - 1) / K, n = threads_for(T);
  banded_compose_kernel<K><<<G * B, n, smem, s>>>(B, T, U, G, le, ls, lf, P);
  banded_chain_kernel<K><<<B, n, 0, s>>>(B, T, U, G, P, alphas);
  banded_replay_kernel<K><<<G * B, n, 0, s>>>(B, T, U, G, le, ls, lf,
                                               alphas);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_backward_banded(int B, int T, int U, const float* le,
                                   const float* ls, const float* lf,
                                   const float* alphas, const int* il,
                                   const int* ol, const float* g,
                                   const float* logz, float* d_le,
                                   float* d_ls, float* d_lf,
                                   cudaStream_t s) {
  static size_t opted = 0;
  const size_t smem = banded_smem(K, T);
  cudaError_t e = opt_in(backward_grads_banded_kernel<K>, smem, &opted);
  if (e != cudaSuccess) return e;
  backward_grads_banded_kernel<K><<<B, threads_for(T), smem, s>>>(
      B, T, U, le, ls, lf, alphas, il, ol, g, logz, d_le, d_ls, d_lf);
  return cudaGetLastError();
}

// The most threads a block of the K-banded kernel may have (its registers
// may allow fewer than kMaxT), rounded down to whole warps; 0 for a K
// without an instance.
template <typename Kern>
int max_threads(Kern kern) {
  cudaFuncAttributes a;
  if (cudaFuncGetAttributes(&a, kern) != cudaSuccess) return 0;
  const int n = a.maxThreadsPerBlock < kMaxT ? a.maxThreadsPerBlock : kMaxT;
  return n / 32 * 32;
}

template <int K>
int banded_max_t(int backward) {
  if (backward) return max_threads(backward_grads_banded_kernel<K>);
  const int a = max_threads(banded_compose_kernel<K>);
  const int b = max_threads(banded_chain_kernel<K>);
  const int c = max_threads(banded_replay_kernel<K>);
  return a < b ? (a < c ? a : c) : (b < c ? b : c);
}

bool bad_shape(int B, int T, int U) {
  return B < 0 || U < 0 || T < 1 || T > kMaxT;
}

}  // namespace

extern "C" {

int ssnt_lattice_max_t() { return kMaxT; }

int ssnt_lattice_bidir(int B, int T, int U, const void* le, const void* ls,
                       const void* lf, const void* il, const void* ol,
                       void* alphas, void* betas, void* stream) {
  if (bad_shape(B, T, U)) return (int)cudaErrorInvalidValue;
  if (B == 0 || U == 0) return 0;
  bidir_kernel<<<dim3(B, 2), threads_for(T), 0, (cudaStream_t)stream>>>(
      B, T, U, (const float*)le, (const float*)ls, (const float*)lf,
      (const int*)il, (const int*)ol, (float*)alphas, (float*)betas);
  return (int)cudaGetLastError();
}

int ssnt_lattice_forward_alphas(int bf16, int B, int T, int U, const void* le,
                                const void* ls, const void* lf, void* alphas,
                                void* stream) {
  if (bad_shape(B, T, U)) return (int)cudaErrorInvalidValue;
  if (B == 0 || U == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    using S = __nv_bfloat16;
    forward_alphas_kernel<S><<<B, threads_for(T), 0, s>>>(
        B, T, U, (const S*)le, (const S*)ls, (const S*)lf, (float*)alphas);
  } else {
    forward_alphas_kernel<float><<<B, threads_for(T), 0, s>>>(
        B, T, U, (const float*)le, (const float*)ls, (const float*)lf,
        (float*)alphas);
  }
  return (int)cudaGetLastError();
}

int ssnt_lattice_backward_grads(int bf16, int B, int T, int U, const void* le,
                                const void* ls, const void* lf,
                                const void* alphas, const void* il,
                                const void* ol, const void* g,
                                const void* logz, void* d_le, void* d_ls,
                                void* d_lf, void* stream) {
  if (bad_shape(B, T, U)) return (int)cudaErrorInvalidValue;
  if (B == 0 || U == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const float* al = (const float*)alphas;
  const int* in_len = (const int*)il;
  const int* out_len = (const int*)ol;
  const float* gg = (const float*)g;
  const float* lz = (const float*)logz;
  if (bf16) {
    using S = __nv_bfloat16;
    backward_grads_kernel<S><<<B, threads_for(T), 0, s>>>(
        B, T, U, (const S*)le, (const S*)ls, (const S*)lf, al, in_len,
        out_len, gg, lz, (S*)d_le, (S*)d_ls, (S*)d_lf);
  } else {
    backward_grads_kernel<float><<<B, threads_for(T), 0, s>>>(
        B, T, U, (const float*)le, (const float*)ls, (const float*)lf, al,
        in_len, out_len, gg, lz, (float*)d_le, (float*)d_ls, (float*)d_lf);
  }
  return (int)cudaGetLastError();
}

int ssnt_lattice_backward_betas(int B, int T, int U, const void* le,
                                const void* ls, const void* lf,
                                const void* il, const void* ol, void* betas,
                                void* stream) {
  if (bad_shape(B, T, U)) return (int)cudaErrorInvalidValue;
  if (B == 0 || U == 0) return 0;
  backward_betas_kernel<<<B, threads_for(T), 0, (cudaStream_t)stream>>>(
      B, T, U, (const float*)le, (const float*)ls, (const float*)lf,
      (const int*)il, (const int*)ol, (float*)betas);
  return (int)cudaGetLastError();
}

int ssnt_lattice_bidir_exp(int B, int T, int U, const void* le,
                           const void* ls, const void* lf, const void* il,
                           const void* ol, void* alphas, void* betas,
                           void* stream) {
  if (bad_shape(B, T, U)) return (int)cudaErrorInvalidValue;
  if (B == 0 || U == 0) return 0;
  bidir_exp_kernel<<<dim3(B, 2), threads_for(T), 0, (cudaStream_t)stream>>>(
      B, T, U, (const float*)le, (const float*)ls, (const float*)lf,
      (const int*)il, (const int*)ol, (float*)alphas, (float*)betas);
  return (int)cudaGetLastError();
}

int ssnt_lattice_expin(int B, int T, int U, const void* E, const void* S,
                       const void* F, const void* mcol, const void* il,
                       const void* ol, void* qn, void* bn, void* M, void* N,
                       void* stream) {
  if (bad_shape(B, T, U)) return (int)cudaErrorInvalidValue;
  if (B == 0 || U == 0) return 0;
  expin_kernel<<<dim3(B, 2), threads_for(T), 0, (cudaStream_t)stream>>>(
      B, T, U, (const float*)E, (const float*)S, (const float*)F,
      (const float*)mcol, (const int*)il, (const int*)ol, (float*)qn,
      (float*)bn, (float*)M, (float*)N);
  return (int)cudaGetLastError();
}

int ssnt_lattice_banded_max_t(int K, int backward) {
  switch (K) {
    case 2: return banded_max_t<2>(backward);
    case 4: return banded_max_t<4>(backward);
    case 8: return banded_max_t<8>(backward);
    case 16: return banded_max_t<16>(backward);
    default: return 0;
  }
}

// workspace: (ceil(U/K), K+1, B, T) f32, the groups' composed operators.
int ssnt_lattice_forward_alphas_banded(int K, int B, int T, int U,
                                       const void* le, const void* ls,
                                       const void* lf, void* alphas,
                                       void* workspace, void* stream) {
  if (bad_shape(B, T, U)) return (int)cudaErrorInvalidValue;
  if (B == 0 || U == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const float *e = (const float*)le, *h = (const float*)ls,
              *f = (const float*)lf;
  float *a = (float*)alphas, *P = (float*)workspace;
  switch (K) {
    case 2: return (int)launch_forward_banded<2>(B, T, U, e, h, f, a, P, s);
    case 4: return (int)launch_forward_banded<4>(B, T, U, e, h, f, a, P, s);
    case 8: return (int)launch_forward_banded<8>(B, T, U, e, h, f, a, P, s);
    case 16:
      return (int)launch_forward_banded<16>(B, T, U, e, h, f, a, P, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int ssnt_lattice_backward_grads_banded(int K, int B, int T, int U,
                                       const void* le, const void* ls,
                                       const void* lf, const void* alphas,
                                       const void* il, const void* ol,
                                       const void* g, const void* logz,
                                       void* d_le, void* d_ls, void* d_lf,
                                       void* stream) {
  if (bad_shape(B, T, U)) return (int)cudaErrorInvalidValue;
  if (B == 0 || U == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const float *e = (const float*)le, *h = (const float*)ls,
              *f = (const float*)lf, *a = (const float*)alphas,
              *gg = (const float*)g, *lz = (const float*)logz;
  const int *in_len = (const int*)il, *out_len = (const int*)ol;
  float *de = (float*)d_le, *dh = (float*)d_ls, *df = (float*)d_lf;
  switch (K) {
    case 2: return (int)launch_backward_banded<2>(
        B, T, U, e, h, f, a, in_len, out_len, gg, lz, de, dh, df, s);
    case 4: return (int)launch_backward_banded<4>(
        B, T, U, e, h, f, a, in_len, out_len, gg, lz, de, dh, df, s);
    case 8: return (int)launch_backward_banded<8>(
        B, T, U, e, h, f, a, in_len, out_len, gg, lz, de, dh, df, s);
    case 16: return (int)launch_backward_banded<16>(
        B, T, U, e, h, f, a, in_len, out_len, gg, lz, de, dh, df, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
