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
// lattice_bidir_exp 0.305 ms (a max, a division and two logs every
// column), lattice_backward_betas 0.081 ms; lattice_expin's block walk,
// kept for T > 128, took 0.116 ms at T=80. lattice_expin's warp walk
// ("exp-native warp walk" below) and the K-banded walks ("banded") are
// designed differently.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

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
// Design: both walks run as three passes in order on one stream, as the
// TPU kernel's own comments place its parts (lattice_pallas.py:262-271:
// the tree and the interior replay are off the chain, the banded apply is
// the only chain-dependent step):
//   1. compose (banded_compose_kernel, a block per group and example, one
//      thread per t): the K column operators from global memory (the
//      forward's with the t - 1 neighbour of ls, the backward's
//      uniformized by U_b with the t + 1 neighbour of lf, listed from the
//      top down), the tree through two alternating shared buffers of K rows
//      of T, one barrier a level; the (K+1)-band result P_g goes to a
//      workspace P[g][k][b][t], (K+1) G B T floats (6.1 MB at K=2, B=32,
//      T=80, U=400: it stays in L2; 49 MB at B=256);
//   2. chain (banded_chain_kernel, a block per example): G steps of next =
//      lse(P_g[k] + v(t -+ k)), groups ascending from the virtual carry
//      (forward) or descending from the virtual init (backward), one shared
//      row and one barrier a step, P's next groups loaded into registers
//      ahead (chain_ahead); the forward writes each group's last column
//      into alphas, the backward each group's bottom (beta at column gK)
//      into a (G, B, T) workspace (2.0 MB at K=2, B=32; 16.4 MB at B=256);
//   3. replay (a block per group and example): the forward's K - 1
//      interior columns from the group's start value (the previous group's
//      last column), one barrier a column; the backward's K - 1 interior
//      columns down from the group's top (the bottom of group g + 1, or the
//      virtual init for the top group), one barrier a column, and the three
//      posteriors of all K columns (column gK with the chain's bottom).
// So the chain's depth falls from log2(K) + K barriers a group (the
// one-block design before it) to one, and the rest runs on every SM at
// once. What bounds them: not the bytes (forward bound 4.9 us at B=32,
// T=80, U=400; 8.6 us at K=2 with the workspace written and read). Measured
// by bench_fused.py (device time under a CUDA graph and, by pass,
// torch.profiler; NVIDIA H100 80GB HBM3, 700 W): the forward takes 0.053 /
// 0.037 / 0.036 / 0.051 ms at K = 2/4/8/16 and B=32 (the one-block design
// before it: 0.137-0.301 ms; the plain forward 0.060). Up to K=8 the chain
// sets it (200 steps of 0.21 us at K=2, 50 of 0.31 at K=8); at K=16 the
// compose pass (25 us: a 17-band tree, 218 accurate exp and log per cell
// and group), and at B=256 compose and replay (the lattice read twice, the
// workspace 49 MB at K=2): 0.14-0.27 ms against the plain forward's
// 0.066. The backward takes 0.05-0.07 ms at B=32 (the chain up to K=8:
// 42 us at K=2; at K=16 compose and replay, 25 and 22 us) and 0.19-0.37 ms
// at B=256, where compose and replay take most of it (its passes move
// ~0.5 GB at K=2: the lattice and alphas read by compose and replay, the
// workspaces written and read, the three gradients written). Registers
// cap a block below kMaxT threads at the larger K, which the wrapper asks
// through ssnt_lattice_banded_max_t (the least of the three passes'
// limits of the walk).

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

// The backward's uniformized column u = g*K + j for this thread's t (NEG
// past U, as JAX's padding): leu (le, 0 at u >= U_b), ls, the uniformized
// lf above it (lfa; lfa_up at t + 1, NEG at T - 1; 0 at the padded top and
// at u + 1 >= U_b), and its operator N = [leu + lfa, lsu + lfa_up] (lsu:
// ls, NEG at u >= U_b - 1).
template <int K>
__device__ __forceinline__ void backward_column_ops(
    int g, int U, int out_len, size_t col, size_t off, int t, int T,
    bool live, const float* __restrict__ le, const float* __restrict__ ls,
    const float* __restrict__ lf, float (&leu)[K], float (&lsr)[K],
    float (&lfa)[K], float (&lfa_up)[K], float (&N)[K][2]) {
  const int Up = (U + K - 1) / K * K;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int u = g * K + j;
    float le_u = kNeg, ls_u = kNeg, f = 0.0f, f_up = kNeg;
    if (live && u < U) {
      le_u = ld(le, (size_t)u * col + off);
      ls_u = ld(ls, (size_t)u * col + off);
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
    N[j][0] = leu[j] + f;
    N[j][1] = (u < out_len - 1 ? ls_u : kNeg) + f_up;
  }
}

// Pass 1, off the chain (a block per group and example): the workspace P
// holds each group's composed (K+1)-band operator as P[g][k][b][t] ((G,
// K+1, B, T) f32, G = ceil(U/K)): the forward's K column operators (kUp
// false), or the backward's from the top down (kUp true; ol its lengths),
// and their composition tree.
template <int K, bool kUp>
__global__ void banded_compose_kernel(int B, int T, int U, int G,
                                      const float* __restrict__ le,
                                      const float* __restrict__ ls,
                                      const float* __restrict__ lf,
                                      const int* __restrict__ ol,
                                      float* __restrict__ P) {
  extern __shared__ float smem[];  // tree operands: 2 x K rows of T
  const int g = blockIdx.x % G, b = blockIdx.x / G, t = threadIdx.x;
  const bool live = t < T;
  const size_t col = (size_t)B * T, off = (size_t)b * T + t;
  float M[K][2];
  if constexpr (kUp) {
    float leu[K], lsr[K], lfa[K], lfa_up[K], N[K][2];
    backward_column_ops<K>(g, U, ol[b], col, off, t, T, live, le, ls, lf,
                           leu, lsr, lfa, lfa_up, N);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      M[j][0] = N[K - 1 - j][0];
      M[j][1] = N[K - 1 - j][1];
    }
  } else {
    forward_column_ops<K>(g, U, col, off, t, live, le, ls, lf, M);
  }
  float Pg[K + 1];
  compose_tree<kUp, K + 1, K, 2>(M, Pg, smem, T, t, live, 0);
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

// P's groups of chain steps i0 .. i0 + A - 1 at this thread's (b, t): step
// i applies group i (forward) or G - 1 - i (backward); NEG past G steps.
template <int K, int A, bool kUp>
__device__ __forceinline__ void load_groups(const float* __restrict__ P,
                                            float (&r)[A][K + 1], int i0,
                                            int G, size_t col, size_t off,
                                            bool live) {
#pragma unroll
  for (int a = 0; a < A; ++a) {
    const int i = i0 + a, g = kUp ? G - 1 - i : i;
#pragma unroll
    for (int k = 0; k <= K; ++k)
      r[a][k] = live && i < G
                    ? ld(P, ((size_t)g * (K + 1) + k) * col + off)
                    : kNeg;
  }
}

// Pass 2, the chain (a block per example), one barrier a group, P's next
// groups loaded into registers while the current ones are applied.
// Forward (kUp false): alpha at g*K + K - 1 from alpha at g*K - 1 through
// P_g, from the virtual alpha_{-1} = [t == 0]; writes each group's last
// column into out = alphas (the next group's start). Backward (kUp true):
// beta at g*K from beta at g*K + K, groups descending from the virtual init
// [t == T_b - 1] (il its lengths); writes each group's bottom into out =
// the (G, B, T) workspace (the next group's top).
template <int K, bool kUp>
__global__ void banded_chain_kernel(int B, int T, int U, int G,
                                    const float* __restrict__ P,
                                    const int* __restrict__ il,
                                    float* __restrict__ out) {
  constexpr int A = chain_ahead<K>();
  __shared__ float rows[2][kMaxT];
  const int b = blockIdx.x, t = threadIdx.x;
  const bool live = t < T;
  const size_t col = (size_t)B * T, off = (size_t)b * T + t;
  float cur[A][K + 1], nxt[A][K + 1];
  load_groups<K, A, kUp>(P, cur, 0, G, col, off, live);
  float v = t == (kUp ? il[b] - 1 : 0) ? 0.0f : kNeg;
  for (int i0 = 0; i0 < G; i0 += A) {
    load_groups<K, A, kUp>(P, nxt, i0 + A, G, col, off, live);
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const int i = i0 + a;
      if (i >= G) break;  // uniform across the block
      float* s = rows[i & 1];
      if (live) s[t] = v;
      __syncthreads();
      float x[K + 1];
#pragma unroll
      for (int k = 0; k <= K; ++k)
        x[k] = cur[a][k] + shifted<kUp>(s, t, k, T, live);
      v = lse_terms(x, K + 1);
      if constexpr (kUp) {
        if (live) out[(size_t)(G - 1 - i) * col + off] = v;
      } else {
        const int u = i * K + K - 1;
        if (live && u < U) out[(size_t)u * col + off] = v;
      }
    }
#pragma unroll
    for (int a = 0; a < A; ++a)
#pragma unroll
      for (int k = 0; k <= K; ++k) cur[a][k] = nxt[a][k];
  }
}

// The forward's pass 3, off the chain (a block per group and example): the
// K - 1 interior columns of group g from its start value (alpha at g*K - 1,
// the chain's, or the virtual carry for g = 0), one barrier a column.
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

// The backward's pass 3, off the chain (a block per group and example):
// from the group's top (the bottom of group g + 1 in the chain's workspace,
// or the virtual init for the top group) the K - 1 interior columns down,
// one barrier a column, and the posteriors of all K columns (column g*K
// with the chain's bottom).
template <int K>
__global__ void banded_grads_replay_kernel(
    int B, int T, int U, int G, const float* __restrict__ le,
    const float* __restrict__ ls, const float* __restrict__ lf,
    const float* __restrict__ alphas, const int* __restrict__ il,
    const int* __restrict__ ol, const float* __restrict__ g,
    const float* __restrict__ logz, const float* __restrict__ bottoms,
    float* __restrict__ d_le, float* __restrict__ d_ls,
    float* __restrict__ d_lf) {
  __shared__ float rows[2][kMaxT];
  const int gi = blockIdx.x % G, b = blockIdx.x / G, t = threadIdx.x;
  const bool live = t < T;
  const int in_len = il[b], out_len = ol[b];
  const float lz = logz[b];
  const float neg_g = lz <= kNeg / 2 ? 0.0f : -g[b];
  const bool is_last_t = t == in_len - 1, t_valid = t < in_len;
  const size_t col = (size_t)B * T, off = (size_t)b * T + t;
  const int base = gi * K;
  float leu[K], lsr[K], lfa[K], lfa_up[K], N[K][2], al[K];
  backward_column_ops<K>(gi, U, out_len, col, off, t, T, live, le, ls, lf,
                         leu, lsr, lfa, lfa_up, N);
#pragma unroll
  for (int j = 0; j < K; ++j)
    al[j] = live && base + j < U ? ld(alphas, (size_t)(base + j) * col + off)
                                 : kNeg;
  float top = is_last_t ? 0.0f : kNeg, bottom = kNeg;
  if (live) {
    if (gi + 1 < G) top = ld(bottoms, (size_t)(gi + 1) * col + off);
    bottom = ld(bottoms, (size_t)gi * col + off);
  }
  float* s = rows[0];
  if (live) s[t] = top;
  __syncthreads();
  float bnext = top;
#pragma unroll
  for (int j = K - 1; j >= 0; --j) {
    const float up = shifted<true>(s, t, 1, T, live);
    float bu = bottom;
    if (j > 0) {
      const float y[2] = {N[j][0] + bnext, N[j][1] + up};
      bu = lse_terms(y, 2);
    }
    banded_grads(base + j, U, T, t, live, out_len, is_last_t, t_valid,
                 neg_g, lz, al[j], leu[j], lsr[j], lfa[j], lfa_up[j], bnext,
                 up, bu, (size_t)(base + j) * col + off, d_le, d_ls, d_lf);
    if (j > 0) {
      s = rows[(K - j) & 1];
      if (live) s[t] = bu;
      __syncthreads();
      bnext = bu;
    }
  }
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
  cudaError_t e = opt_in(banded_compose_kernel<K, false>, smem, &opted);
  if (e != cudaSuccess) return e;
  const int G = (U + K - 1) / K, n = threads_for(T);
  banded_compose_kernel<K, false><<<G * B, n, smem, s>>>(B, T, U, G, le, ls,
                                                         lf, nullptr, P);
  banded_chain_kernel<K, false><<<B, n, 0, s>>>(B, T, U, G, P, nullptr,
                                                alphas);
  banded_replay_kernel<K><<<G * B, n, 0, s>>>(B, T, U, G, le, ls, lf,
                                               alphas);
  return cudaGetLastError();
}

// The three passes of the banded backward, in order on one stream; P is
// the (G, K+1, B, T) workspace of the composed operators, bottoms the
// (G, B, T) workspace of the chain's betas at the groups' bottoms.
template <int K>
cudaError_t launch_backward_banded(int B, int T, int U, const float* le,
                                   const float* ls, const float* lf,
                                   const float* alphas, const int* il,
                                   const int* ol, const float* g,
                                   const float* logz, float* d_le,
                                   float* d_ls, float* d_lf, float* P,
                                   float* bottoms, cudaStream_t s) {
  static size_t opted = 0;
  const size_t smem = tree_smem(K, T);
  cudaError_t e = opt_in(banded_compose_kernel<K, true>, smem, &opted);
  if (e != cudaSuccess) return e;
  const int G = (U + K - 1) / K, n = threads_for(T);
  banded_compose_kernel<K, true><<<G * B, n, smem, s>>>(B, T, U, G, le, ls,
                                                        lf, ol, P);
  banded_chain_kernel<K, true><<<B, n, 0, s>>>(B, T, U, G, P, il, bottoms);
  banded_grads_replay_kernel<K><<<G * B, n, 0, s>>>(
      B, T, U, G, le, ls, lf, alphas, il, ol, g, logz, bottoms, d_le, d_ls,
      d_lf);
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

int least(int a, int b, int c) {
  return a < b ? (a < c ? a : c) : (b < c ? b : c);
}

template <int K>
int banded_max_t(int backward) {
  if (backward)
    return least(max_threads(banded_compose_kernel<K, true>),
                 max_threads(banded_chain_kernel<K, true>),
                 max_threads(banded_grads_replay_kernel<K>));
  return least(max_threads(banded_compose_kernel<K, false>),
               max_threads(banded_chain_kernel<K, false>),
               max_threads(banded_replay_kernel<K>));
}

// ------------------------------------------------- exp-native warp walk
//
// lattice_expin for T <= kWarpMaxT (the main path's T = 80): each walk
// (example, direction) runs on one warp, lane l holding the V consecutive
// source positions t = l*V + j (V = 1/2/4 by T), so a column's neighbour
// exchange is one shuffle (__shfl_up_sync forward, the value at t - 1 of
// the lane below; __shfl_down_sync backward, t + 1 of the lane above; 0 at
// t = 0 and past T, as the block walk's shared row edges) and the
// renormalizing row max is the lane's max and one __reduce_max_sync on the
// values' bits (for floats >= 0 the bits order as the values, and a max
// does not depend on the order, so it equals the block walk's bit for
// bit). Per cell the operations and their order are expin_alpha_walk's and
// expin_beta_walk's.
//
// One warp issues its instructions in order, so the walk's time is about
// the instructions between two steps of its chain. The walk's block
// therefore has three warps on three of the SM's schedulers, each a loop
// of its own, passing rounds through shared memory and mbarriers (a full
// and an empty barrier a slot; no block barrier inside the loops):
//   - the loader stages the walk's E, S, F columns into a ring of
//     kInRounds rounds with cp.async (one copy of 4V bytes a row and lane
//     where T % V == 0 and the fields are aligned to it; else one of 4
//     bytes per value below T: a column of T % 4 != 0 floats starts
//     unaligned; zeros for a column past the walk), each lane's copies
//     completing on the round's barrier (cp.async.mbarrier.arrive);
//   - the chain warp takes the rounds of kRenorm columns (the
//     renormalization period; rounds aligned on u, so the renormalizing
//     column is each round's last in walk order), reads a round, walks it
//     in registers and shuffles, and writes the round's field and its
//     normalizer into a ring of kResRounds result slots;
//   - the storer reads a round's field into registers, frees its slot,
//     then writes the field to global memory, and keeps the log
//     normalizers M / N (mcol loaded once per 32 columns, a value a lane,
//     read by shuffle; each lane stores one column's M / N a block).
// A slot row is 32 V floats, so a lane past T reads inside the ring; its
// values (and a lane's values at t >= T) never reach a position below T
// (the backward's shift from t >= T and the row max read 0 there) and are
// never stored. Offsets are 32-bit: the launcher takes this walk for
// U * B * T < 2^31. Measured (probe_expin.py, NVIDIA H100 80GB HBM3,
// 700 W; T=80, U=400): 0.042 ms at B=32, of which the chain alone takes
// 0.034 (stores, copies and renormalization taken out); 0.090 ms at
// B=256, where the copies and stores of ~4 walks an SM set it (0.041
// without them); the block walk 0.116 / 0.140.

constexpr int kWarpMaxT = 128;  // 32 lanes x V = 4
constexpr int kInRounds = 6;    // input ring: rounds staged ahead
constexpr int kResRounds = 4;   // result ring

// The walk's shared memory: the input ring (kInRounds rounds of kRenorm
// columns of 3 rows of 32 V floats), the result ring (kResRounds rounds of
// kRenorm rows of 32 V floats), the results' normalizers, the barriers.
template <int V> struct ExpinSmem {
  float in[kInRounds][kRenorm][3][32 * V];
  float res[kResRounds][kRenorm][32 * V];
  float norm[kResRounds];
  uint64_t in_full[kInRounds], in_empty[kInRounds];
  uint64_t res_full[kResRounds], res_empty[kResRounds];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of N bytes, of which the first `src_bytes` are read and the
// rest filled with zeros.
template <int N>
__device__ __forceinline__ void cp_async_zfill(float* dst, const float* src,
                                               int src_bytes) {
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(N), "r"(src_bytes)
                 : "memory");
  }
}

// The barrier's arrive-on once this thread's cp.async copies so far have
// landed (counted in the barrier's expected arrivals).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// One walk at this lane: E, S, F and its fields' outputs at (example b,
// t0), mcol and M / N at b (column u at + u * col and + u * B).
struct ExpinWalk {
  int col, B, T, U, top, rounds, t0, lane;  // top: the backward's first round's u
  bool live;                                // t0 < T
};

// Round r's j-th column in walk order: forward r * 4 + j, backward top -
// r * 4 + 3 - j; in the walk if in [0, U).
template <bool kBack>
__device__ __forceinline__ int round_column(const ExpinWalk& w, int r,
                                            int j) {
  return kBack ? w.top - kRenorm * r + (kRenorm - 1 - j) : kRenorm * r + j;
}

// The loader: round r into input slot r % kInRounds once the chain warp
// has read the round kInRounds before.
template <int V, bool kVec, bool kBack>
__device__ void expin_loader(const ExpinWalk& w, ExpinSmem<V>& sm,
                             const float* __restrict__ E,
                             const float* __restrict__ S,
                             const float* __restrict__ F) {
  for (int r = 0; r < w.rounds; ++r) {
    const int slot = r % kInRounds;
    if (r >= kInRounds)
      ssnt_tma::mbar_wait(&sm.in_empty[slot], (r / kInRounds + 1) & 1);
#pragma unroll
    for (int j = 0; j < kRenorm; ++j) {
      const int u = round_column<kBack>(w, r, j);
      const bool in_walk = u < w.U;
      const int o = (in_walk ? u : w.U - 1) * w.col;
      float(&rows)[3][32 * V] = sm.in[slot][j];
      if constexpr (kVec) {
        if (w.live) {
          const int n = in_walk ? 4 * V : 0;
          cp_async_zfill<4 * V>(rows[0] + w.t0, E + o, n);
          cp_async_zfill<4 * V>(rows[1] + w.t0, S + o, n);
          cp_async_zfill<4 * V>(rows[2] + w.t0, F + o, n);
        }
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          if (w.t0 + k < w.T) {
            const int n = in_walk ? 4 : 0;
            cp_async_zfill<4>(rows[0] + w.t0 + k, E + o + k, n);
            cp_async_zfill<4>(rows[1] + w.t0 + k, S + o + k, n);
            cp_async_zfill<4>(rows[2] + w.t0 + k, F + o + k, n);
          }
        }
      }
    }
    cp_async_arrive(&sm.in_full[slot]);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int V>
__device__ __forceinline__ void load_lane(const float* p, float (&x)[V]) {
  if constexpr (V == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  } else if constexpr (V == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    x[0] = a.x, x[1] = a.y;
  } else {
    x[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store_lane(float* p, const float (&x)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    *p = x[0];
  }
}

// A round's E, S, F at this lane.
template <int V> struct ExpinRound {
  float e[kRenorm][V], s[kRenorm][V], f[kRenorm][V];
};

// The chain warp's side of the rings: waits for round r, reads it and
// frees its input slot.
template <int V>
__device__ __forceinline__ void take_round(const ExpinWalk& w,
                                           ExpinSmem<V>& sm, int r,
                                           ExpinRound<V>& d) {
  const int slot = r % kInRounds;
  ssnt_tma::mbar_wait(&sm.in_full[slot], (r / kInRounds) & 1);
#pragma unroll
  for (int j = 0; j < kRenorm; ++j) {
    load_lane<V>(sm.in[slot][j][0] + w.t0, d.e[j]);
    load_lane<V>(sm.in[slot][j][1] + w.t0, d.s[j]);
    load_lane<V>(sm.in[slot][j][2] + w.t0, d.f[j]);
  }
  mbar_arrive(&sm.in_empty[slot]);
}

// ... and hands the round's field and normalizer to the storer.
template <int V>
__device__ __forceinline__ void give_round(const ExpinWalk& w,
                                           ExpinSmem<V>& sm, int r,
                                           const float (&x)[kRenorm][V],
                                           float norm) {
  const int slot = r % kResRounds;
  if (r >= kResRounds)
    ssnt_tma::mbar_wait(&sm.res_empty[slot], (r / kResRounds + 1) & 1);
#pragma unroll
  for (int k = 0; k < kRenorm; ++k)
    store_lane<V>(sm.res[slot][k] + w.t0, x[k]);
  if (w.lane == 0) sm.norm[slot] = norm;
  mbar_arrive(&sm.res_full[slot]);
}

// Renormalizes the warp's field x (all values >= 0 below T): the max of
// each lane's values below T (0 for a lane past T), the warp's max of
// those, floored at kTiny; x times its correctly rounded reciprocal.
// Returns the normalizer.
template <int V, bool kVec>
__device__ __forceinline__ float warp_renorm(const ExpinWalk& w,
                                             float (&x)[V]) {
  float m = x[0];
#pragma unroll
  for (int j = 1; j < V; ++j)
    if (kVec || w.t0 + j < w.T) m = fmaxf(m, x[j]);
  m = w.live ? m : 0.0f;
  const unsigned top = __reduce_max_sync(0xffffffffu, __float_as_uint(m));
  const float norm = fmaxf(__uint_as_float(top), kTiny);
  const float rcp = __frcp_rn(norm);
#pragma unroll
  for (int j = 0; j < V; ++j) x[j] = x[j] * rcp;
  return norm;
}

// expin_alpha_walk's chain: per column u,
//   q = p * E_{u-1} + shift0_down(p * S_{u-1}); renormalize after u when
//   (u + 1) % 4 == 0 (a round's last column); qn_u = q; p = q * F_u.
template <int V, bool kVec>
__device__ void expin_alpha_chain(const ExpinWalk& w, ExpinSmem<V>& sm) {
  float p[V], e_prev[V], s_prev[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    p[j] = w.t0 + j == 0 ? 1.0f : 0.0f;
    e_prev[j] = 1.0f;
    s_prev[j] = 0.0f;
  }
  for (int r = 0; r < w.rounds; ++r) {
    ExpinRound<V> d;
    take_round<V>(w, sm, r, d);
    float q[kRenorm][V], norm;
#pragma unroll
    for (int k = 0; k < kRenorm; ++k) {
      float sp[V];
#pragma unroll
      for (int j = 0; j < V; ++j) sp[j] = p[j] * s_prev[j];
      // 0 into t = 0: nothing shifts down into the first position
      const float edge = __shfl_up_sync(0xffffffffu, sp[V - 1], 1);
      q[k][0] = p[0] * e_prev[0] + (w.lane == 0 ? 0.0f : edge);
#pragma unroll
      for (int j = 1; j < V; ++j) q[k][j] = p[j] * e_prev[j] + sp[j - 1];
      if (k == kRenorm - 1) norm = warp_renorm<V, kVec>(w, q[k]);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        p[j] = q[k][j] * d.f[k][j];
        e_prev[j] = d.e[k][j];
        s_prev[j] = d.s[k][j];
      }
    }
    give_round<V>(w, sm, r, q, norm);
  }
}

// expin_beta_walk's chain: per column u, descending,
//   b_raw = E_u * c + S_u * shift0_up(c); reset at u == U_b - 1;
//   renormalize at u % 4 == 0 (a round's last column); bn_u = b_raw;
//   c = F_u * b_raw. The first round's columns past U read zeros, which
//   leave c at 0.
template <int V, bool kVec>
__device__ void expin_beta_chain(const ExpinWalk& w, ExpinSmem<V>& sm,
                                 int in_len, int out_len) {
  float c[V];
#pragma unroll
  for (int j = 0; j < V; ++j) c[j] = 0.0f;
  for (int r = 0; r < w.rounds; ++r) {
    ExpinRound<V> d;
    take_round<V>(w, sm, r, d);
    float b[kRenorm][V], norm;
#pragma unroll
    for (int k = 0; k < kRenorm; ++k) {
      const bool reset = round_column<true>(w, r, k) == out_len - 1;
      // 0 past T - 1: nothing shifts up into the last position
      const float above = __shfl_down_sync(0xffffffffu, c[0], 1);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float nb = j + 1 < V ? c[j + 1] : above;
        if (kVec ? j + 1 == V && w.t0 + V >= w.T : w.t0 + j + 1 >= w.T)
          nb = 0.0f;
        const float x = d.e[k][j] * c[j] + d.s[k][j] * nb;
        b[k][j] = reset ? (w.t0 + j == in_len - 1 ? d.e[k][j] : 0.0f) : x;
      }
      if (k == kRenorm - 1) norm = warp_renorm<V, kVec>(w, b[k]);
#pragma unroll
      for (int j = 0; j < V; ++j) c[j] = d.f[k][j] * b[k][j];
    }
    give_round<V>(w, sm, r, b, norm);
  }
}

// mcol at this lane's column of the 32-column block q (rounds 8 q .. 8 q +
// 7); 0 past the walk.
template <bool kBack>
__device__ __forceinline__ float block_mcol(const ExpinWalk& w,
                                            const float* __restrict__ mcol,
                                            int q) {
  const int i = q * 32 + w.lane;
  const int u = round_column<kBack>(w, i / kRenorm, i % kRenorm);
  return u >= 0 && u < w.U ? __ldg(mcol + u * w.B) : 0.0f;
}

// The storer: round r's field (columns in the walk) and the log
// normalizers,
//   forward:  [m += log(norm)]; m += mcol_u; M_u = m
//   backward: n = 0 at u == U_b - 1; [n += log(norm)]; N_u = n;
//             n += mcol_u
// the normalizer at each round's last column. Lane l keeps the value of
// column slot 32 q + l of the 32-column block q and stores it at the
// block's end: one store a lane per 32 columns.
template <int V, bool kVec, bool kBack>
__device__ void expin_storer(const ExpinWalk& w, ExpinSmem<V>& sm,
                             const float* __restrict__ mcol, int out_len,
                             float* __restrict__ field,
                             float* __restrict__ logs) {
  float mblk = block_mcol<kBack>(w, mcol, 0);
  float mnext = block_mcol<kBack>(w, mcol, 1);
  float acc = 0.0f, keep = 0.0f;
  for (int r = 0; r < w.rounds; ++r) {
    // The round's field into registers, the slot freed, then the stores:
    // no store waits on its shared load.
    const int slot = r % kResRounds;
    ssnt_tma::mbar_wait(&sm.res_full[slot], (r / kResRounds) & 1);
    const float norm = sm.norm[slot];
    float x[kRenorm][V];
#pragma unroll
    for (int k = 0; k < kRenorm; ++k)
      load_lane<V>(sm.res[slot][k] + w.t0, x[k]);
    mbar_arrive(&sm.res_empty[slot]);
#pragma unroll
    for (int k = 0; k < kRenorm; ++k) {
      const int u = round_column<kBack>(w, r, k);
      const float mc = __shfl_sync(0xffffffffu, mblk, (r * kRenorm + k) & 31);
      if (u < w.U) {
        float* dst = field + u * w.col;
        if constexpr (kVec) {
          if (w.live) store_lane<V>(dst, x[k]);
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j)
            if (w.t0 + j < w.T) dst[j] = x[k][j];
        }
        if (kBack && u == out_len - 1) acc = 0.0f;
        if (k == kRenorm - 1) acc = acc + logf(norm);
        if (kBack) {
          if (w.lane == ((r * kRenorm + k) & 31)) keep = acc;
          acc = acc + mc;
        } else {
          acc = acc + mc;
          if (w.lane == ((r * kRenorm + k) & 31)) keep = acc;
        }
      }
    }
    if ((r & 7) == 7 || r == w.rounds - 1) {  // the block's last round
      const int i = (r & ~7) * kRenorm + w.lane;
      const int ul = round_column<kBack>(w, i / kRenorm, i % kRenorm);
      if (i / kRenorm <= r && ul >= 0 && ul < w.U) logs[ul * w.B] = keep;
      mblk = mnext;
      mnext = block_mcol<kBack>(w, mcol, r / 8 + 2);
    }
  }
}

// A block of three warps (loader, chain, storer) per example (blockIdx.x)
// and direction (blockIdx.y: 0 the alpha walk, 1 the beta walk); dynamic
// shared memory: ExpinSmem<V>.
template <int V, bool kVec>
__global__ void __launch_bounds__(96)
    expin_warp_kernel(int B, int T, int U, const float* __restrict__ E,
                      const float* __restrict__ S,
                      const float* __restrict__ F,
                      const float* __restrict__ mcol,
                      const int* __restrict__ il, const int* __restrict__ ol,
                      float* __restrict__ qn, float* __restrict__ bn,
                      float* __restrict__ M, float* __restrict__ N) {
  extern __shared__ float4 expin_smem[];
  ExpinSmem<V>& sm = *reinterpret_cast<ExpinSmem<V>*>(expin_smem);
  const int b = blockIdx.x, warp = threadIdx.x / 32;
  const bool back = blockIdx.y == 1;
  ExpinWalk w;
  w.lane = threadIdx.x % 32, w.t0 = w.lane * V, w.live = w.t0 < T;
  w.col = B * T, w.B = B, w.T = T, w.U = U;
  w.top = (U - 1) / kRenorm * kRenorm;
  w.rounds = (U + kRenorm - 1) / kRenorm;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kInRounds; ++i) {
      ssnt_tma::mbar_init(&sm.in_full[i], 32);
      ssnt_tma::mbar_init(&sm.in_empty[i], 32);
    }
    for (int i = 0; i < kResRounds; ++i) {
      ssnt_tma::mbar_init(&sm.res_full[i], 32);
      ssnt_tma::mbar_init(&sm.res_empty[i], 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int eb = b * T + w.t0;
  if (warp == 0) {
    if (back)
      expin_loader<V, kVec, true>(w, sm, E + eb, S + eb, F + eb);
    else
      expin_loader<V, kVec, false>(w, sm, E + eb, S + eb, F + eb);
  } else if (warp == 1) {
    if (back)
      expin_beta_chain<V, kVec>(w, sm, il[b], ol[b]);
    else
      expin_alpha_chain<V, kVec>(w, sm);
  } else {
    if (back)
      expin_storer<V, kVec, true>(w, sm, mcol + b, ol[b], bn + eb, N + b);
    else
      expin_storer<V, kVec, false>(w, sm, mcol + b, 0, qn + eb, M + b);
  }
}

template <int V, bool kVec>
cudaError_t launch_expin_warp(int B, int T, int U, const float* E,
                              const float* S, const float* F,
                              const float* mcol, const int* il,
                              const int* ol, float* qn, float* bn, float* M,
                              float* N, cudaStream_t s) {
  static size_t opted = 0;
  constexpr size_t smem = sizeof(ExpinSmem<V>);
  cudaError_t e = opt_in(expin_warp_kernel<V, kVec>, smem, &opted);
  if (e != cudaSuccess) return e;
  expin_warp_kernel<V, kVec><<<dim3(B, 2), 96, smem, s>>>(
      B, T, U, E, S, F, mcol, il, ol, qn, bn, M, N);
  return cudaGetLastError();
}

// The warp walk at V = ceil(T / 32) rounded up to 1, 2 or 4, with copies
// of 4V bytes a lane where T % V == 0 and every field is aligned to them.
cudaError_t launch_expin_warps(int B, int T, int U, const float* E,
                               const float* S, const float* F,
                               const float* mcol, const int* il,
                               const int* ol, float* qn, float* bn, float* M,
                               float* N, cudaStream_t s) {
  const uintptr_t bits = (uintptr_t)E | (uintptr_t)S | (uintptr_t)F |
                         (uintptr_t)qn | (uintptr_t)bn;
#define SSNT_EXPIN_ARGS B, T, U, E, S, F, mcol, il, ol, qn, bn, M, N, s
  if (T <= 32) return launch_expin_warp<1, true>(SSNT_EXPIN_ARGS);
  if (T <= 64)
    return bits % 8 == 0 && T % 2 == 0
               ? launch_expin_warp<2, true>(SSNT_EXPIN_ARGS)
               : launch_expin_warp<2, false>(SSNT_EXPIN_ARGS);
  return bits % 16 == 0 && T % 4 == 0
             ? launch_expin_warp<4, true>(SSNT_EXPIN_ARGS)
             : launch_expin_warp<4, false>(SSNT_EXPIN_ARGS);
#undef SSNT_EXPIN_ARGS
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
  cudaStream_t s = (cudaStream_t)stream;
  const float *e = (const float*)E, *h = (const float*)S,
              *f = (const float*)F, *m = (const float*)mcol;
  const int *in_len = (const int*)il, *out_len = (const int*)ol;
  float *q = (float*)qn, *r = (float*)bn, *mm = (float*)M, *nn = (float*)N;
  if (T <= kWarpMaxT && (size_t)U * B * T < (size_t{1} << 31))
    return (int)launch_expin_warps(B, T, U, e, h, f, m, in_len, out_len, q,
                                   r, mm, nn, s);
  expin_kernel<<<dim3(B, 2), threads_for(T), 0, s>>>(
      B, T, U, e, h, f, m, in_len, out_len, q, r, mm, nn);
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

// workspace: (ceil(U/K), K+1, B, T) f32, the groups' composed operators;
// bottoms: (ceil(U/K), B, T) f32, the chain's betas at the groups' bottoms.
int ssnt_lattice_backward_grads_banded(int K, int B, int T, int U,
                                       const void* le, const void* ls,
                                       const void* lf, const void* alphas,
                                       const void* il, const void* ol,
                                       const void* g, const void* logz,
                                       void* d_le, void* d_ls, void* d_lf,
                                       void* workspace, void* bottoms,
                                       void* stream) {
  if (bad_shape(B, T, U)) return (int)cudaErrorInvalidValue;
  if (B == 0 || U == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const float *e = (const float*)le, *h = (const float*)ls,
              *f = (const float*)lf, *a = (const float*)alphas,
              *gg = (const float*)g, *lz = (const float*)logz;
  const int *in_len = (const int*)il, *out_len = (const int*)ol;
  float *de = (float*)d_le, *dh = (float*)d_ls, *df = (float*)d_lf,
        *P = (float*)workspace, *bot = (float*)bottoms;
  switch (K) {
    case 2: return (int)launch_backward_banded<2>(
        B, T, U, e, h, f, a, in_len, out_len, gg, lz, de, dh, df, P, bot, s);
    case 4: return (int)launch_backward_banded<4>(
        B, T, U, e, h, f, a, in_len, out_len, gg, lz, de, dh, df, P, bot, s);
    case 8: return (int)launch_backward_banded<8>(
        B, T, U, e, h, f, a, in_len, out_len, gg, lz, de, dh, df, P, bot, s);
    case 16: return (int)launch_backward_banded<16>(
        B, T, U, e, h, f, a, in_len, out_len, gg, lz, de, dh, df, P, bot, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
