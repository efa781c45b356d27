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
// max). The block walks: one thread block per example (per example and
// direction for the bidirectional kernels: the alpha and beta walks run on
// different SMs at once), P = 1, 2, 4 or 8 source positions a thread (t =
// threadIdx.x + p * blockDim.x; P = 1 where the kernel's registers allow a
// block of T threads, ~400-900, else kernels bounded to 1024 threads: T up
// to kMaxT = 8192), the t-1 / t+1 neighbour through a double-buffered
// shared-memory row (dynamic shared memory, 2 (T + 1) floats and padding)
// with one barrier per column, the row max by each thread's max over its
// positions, warp shuffles and one more barrier over a shared word per
// warp, and the next kAhead / P columns' inputs loaded into registers
// while the current ones are computed, so global-memory latency is off
// the chain. Per cell the operations and their order do not depend on P.
// Every log- and exp-domain kernel is a block walk above T = 128 and a
// warp walk ("warp walks" below) up to it; the K-banded walks ("banded")
// are designed differently.
// Measured (device time under a CUDA graph, NVIDIA H100 80GB HBM3, 700 W
// power limit; T=80, U=400, f32):
//   - block walks (chip_smoke.py, bench_fused.py): forward alphas B=256
//     0.071 ms (bf16 0.071); backward gradients B=256 0.141 ms (bf16
//     0.160); backward betas B=32 0.089 ms: 0.14-0.40 us a column. Above T
//     = 128, lattice_bidir's and lattice_bidir_exp's (B=32 0.082 and 0.306
//     ms at T=80, where the warp walks replace them): the exp walk's row
//     max (a second barrier) and its division, whose fast path falls back
//     to a subroutine for the subnormal probabilities every column meets,
//     make it 3.7x slower per column than the log walk.
//   - warp walks (probe_bidir.py, probe_expin.py, probe_grads.py,
//     bench_fused.py): the log walks bound by their chain, one lae (expf +
//     log1pf) and a barrier exchange a column, ~125 ns: lattice_bidir B=32
//     0.0597 ms (B=64 0.0601; on the earlier one-way stream of exchange
//     words 0.0712 / 0.0715), lattice_forward_alphas, its forward walk
//     alone, B=32 0.0499 ms, B=256 0.0644, lattice_backward_betas, its
//     backward walk alone, B=32 0.052-0.059 ms, B=256 0.0653 (its block
//     walk 0.0819 / 0.1015); lattice_backward_grads B=32 0.080 ms, B=256
//     0.114 (bf16 0.118); lattice_bidir_exp B=32 0.085 ms, bound by its
//     chain (a row max and an exact division through a double reciprocal
//     a column, ~205 ns; the chain alone 0.083), B=256 0.144 ms, bound by
//     the exps and logs of ~4 walks an SM (0.095 without them);
//     lattice_expin B=32 0.042 ms, B=256 0.087 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr float kTiny = 1e-30f;  // floor of an exp-domain normalizer
constexpr int kRenorm = 4;       // lattice_expin renormalizes every 4th
constexpr int kMaxBlock = 1024;  // threads a block
constexpr int kMaxP = 8;         // positions a block-walk thread holds
constexpr int kMaxT = kMaxP * kMaxBlock;  // ssnt_lattice_max_t
constexpr int kAhead = 8;        // columns loaded ahead of the chain (P = 1)

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

// Loads A columns starting at u0 and stepping by `dir` (+1 forward, -1
// backward) at offset off; columns outside [0, U) (never used) are left as
// they were.
template <int A, typename S>
__device__ __forceinline__ void load_cols(const S* __restrict__ x, S* r,
                                          int u0, int dir, int U,
                                          size_t col, size_t off, bool live) {
#pragma unroll
  for (int k = 0; k < A; ++k) {
    const int u = u0 + dir * k;
    if (live && u >= 0 && u < U) r[k] = ld(x, (size_t)u * col + off);
  }
}

// The P source positions a block-walk thread holds, t = threadIdx.x + p *
// blockDim.x (P = 1: one thread a position), of example blockIdx.x, and
// their offsets b T + t in a column: 32-bit (bad_shape keeps B T below
// 2^31), since a 64-bit one cost two register moves a load and a store
// (#3's walk 11 % slower at B=32).
template <int P> struct Cells {
  int t[P];
  bool live[P];
  int off[P];
  __device__ __forceinline__ Cells(int T) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      t[p] = threadIdx.x + p * blockDim.x;
      live[p] = t[p] < T;
      off[p] = blockIdx.x * T + t[p];
    }
  }
};

// load_cols at each of the thread's positions.
template <int A, int P, typename S>
__device__ __forceinline__ void load_block(const S* __restrict__ x,
                                           S (&r)[P][A], int u0, int dir,
                                           int U, size_t col,
                                           const Cells<P>& c) {
#pragma unroll
  for (int p = 0; p < P; ++p)
    load_cols<A>(x, r[p], u0, dir, U, col, c.off[p], c.live[p]);
}

template <int A, int P, typename S>
__device__ __forceinline__ void take_cols(S (&d)[P][A], const S (&s)[P][A]) {
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int k = 0; k < A; ++k) d[p][k] = s[p][k];
}

// Row u & 1 of a block walk's double-buffered shared row: T + 1 floats at
// sh + (u & 1) * (T + 1) (launch_block_walk adds the padding that the
// positions past T read, and never use).
__device__ __forceinline__ float* walk_row(float* sh, int T, int u) {
  return sh + (u & 1) * (T + 1);
}

// The alpha walk of one example (shared by lattice_bidir and
// lattice_forward_alphas). sh: walk_row's rows, row[0] = NEG.
template <int P, typename S>
__device__ void alpha_walk(int B, int T, int U, const S* __restrict__ le,
                           const S* __restrict__ ls, const S* __restrict__ lf,
                           float* __restrict__ alphas, float* sh) {
  constexpr int A = kAhead / P;
  const Cells<P> c(T);
  const size_t col = (size_t)B * T;
  S cle[P][A], cls[P][A], clf[P][A];
  S nle[P][A], nls[P][A], nlf[P][A];
  load_block<A>(le, cle, 0, 1, U, col, c);
  load_block<A>(ls, cls, 0, 1, U, col, c);
  load_block<A>(lf, clf, 0, 1, U, col, c);
  float alpha[P], le_prev[P], ls_prev[P];
#pragma unroll
  for (int p = 0; p < P; ++p) alpha[p] = le_prev[p] = ls_prev[p] = kNeg;
  for (int u0 = 0; u0 < U; u0 += A) {
    load_block<A>(le, nle, u0 + A, 1, U, col, c);
    load_block<A>(ls, nls, u0 + A, 1, U, col, c);
    load_block<A>(lf, nlf, u0 + A, 1, U, col, c);
#pragma unroll
    for (int k = 0; k < A; ++k) {
      const int u = u0 + k;
      if (u >= U) continue;  // uniform across the block
      if (u == 0) {
#pragma unroll
        for (int p = 0; p < P; ++p)
          alpha[p] = c.t[p] == 0 ? f32(clf[p][0]) : kNeg;
      } else {
        float* s = walk_row(sh, T, u);
        float stay[P];
#pragma unroll
        for (int p = 0; p < P; ++p) {
          stay[p] = alpha[p] + le_prev[p];
          if (c.live[p]) s[c.t[p] + 1] = alpha[p] + ls_prev[p];
        }
        __syncthreads();
        // s[0] = NEG: nothing shifts into t = 0
#pragma unroll
        for (int p = 0; p < P; ++p)
          alpha[p] = f32(clf[p][k]) + lae(stay[p], s[c.t[p]]);
      }
#pragma unroll
      for (int p = 0; p < P; ++p) {
        if (c.live[p]) alphas[(size_t)u * col + c.off[p]] = alpha[p];
        le_prev[p] = f32(cle[p][k]);
        ls_prev[p] = f32(cls[p][k]);
      }
    }
    take_cols(cle, nle);
    take_cols(cls, nls);
    take_cols(clf, nlf);
  }
}

// The beta walk of one example for lattice_bidir, in _bidir_kernel's
// operation order. sh: walk_row's rows, row[T] = NEG.
template <int P>
__device__ void beta_walk(int B, int T, int U, const float* __restrict__ le,
                          const float* __restrict__ ls,
                          const float* __restrict__ lf, int in_len,
                          int out_len, float* __restrict__ betas, float* sh) {
  constexpr int A = kAhead / P;
  const Cells<P> c(T);
  const size_t col = (size_t)B * T;
  float cle[P][A], cls[P][A], clf[P][A];
  float nle[P][A], nls[P][A], nlf[P][A];
  load_block<A>(le, cle, U - 1, -1, U, col, c);
  load_block<A>(ls, cls, U - 1, -1, U, col, c);
  load_block<A>(lf, clf, U - 1, -1, U, col, c);
  float beta[P], lf_next[P];
#pragma unroll
  for (int p = 0; p < P; ++p) beta[p] = lf_next[p] = kNeg;
  for (int u0 = U - 1; u0 >= 0; u0 -= A) {
    load_block<A>(le, nle, u0 - A, -1, U, col, c);
    load_block<A>(ls, nls, u0 - A, -1, U, col, c);
    load_block<A>(lf, nlf, u0 - A, -1, U, col, c);
#pragma unroll
    for (int k = 0; k < A; ++k) {
      const int u = u0 - k;
      if (u < 0) continue;  // uniform across the block
      float* s = walk_row(sh, T, u);
      float cont[P];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        cont[p] = lf_next[p] + beta[p];
        if (c.live[p]) s[c.t[p]] = cont[p];
      }
      __syncthreads();
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float up = s[c.t[p] + 1];  // s[T] = NEG: nothing shifts into T-1
        const float rec = lae(cle[p][k] + cont[p], cls[p][k] + up);
        beta[p] = u == out_len - 1 ? (c.t[p] == in_len - 1 ? cle[p][k] : kNeg)
                                   : rec;
        if (c.live[p]) betas[(size_t)u * col + c.off[p]] = beta[p];
        lf_next[p] = clf[p][k];
      }
    }
    take_cols(cle, nle);
    take_cols(cls, nls);
    take_cols(clf, nlf);
  }
}

// The max over the block of v >= 0 (positions past T pass 0): each
// thread's max over its P values, warp shuffles, one word per warp in red,
// one barrier. The max of non-negative values does not depend on the
// order. red may be reused after the caller's next barrier.
template <int P>
__device__ __forceinline__ float block_max(const float (&x)[P], float* red) {
  float v = x[0];
#pragma unroll
  for (int p = 1; p < P; ++p) v = fmaxf(v, x[p]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) m = fmaxf(m, red[w]);
  return m;
}

// The thread's values for block_max: x where live, 0 past T.
template <int P>
__device__ __forceinline__ float live_max(const Cells<P>& c,
                                          const float (&x)[P], float* red) {
  float v[P];
#pragma unroll
  for (int p = 0; p < P; ++p) v[p] = c.live[p] ? x[p] : 0.0f;
  return block_max(v, red);
}

// lattice_bidir_exp's alpha walk, _bidir_kernel_exp's forward column:
//   q = p * exp(le_{u-1}) + shift0_down(p * exp(ls_{u-1}))
//   p_raw = (u == 0 ? [t == 0] : q) * exp(lf_u);  s = max(rowmax, TINY)
//   alpha_u = log(p_raw) + m;  p = p_raw / s;  m += log(s)
// sh: walk_row's rows, row[0] = 0.
template <int P>
__device__ void exp_alpha_walk(int B, int T, int U,
                               const float* __restrict__ le,
                               const float* __restrict__ ls,
                               const float* __restrict__ lf,
                               float* __restrict__ alphas, float* sh,
                               float* red) {
  constexpr int A = kAhead / P;
  const Cells<P> c(T);
  const size_t col = (size_t)B * T;
  float cle[P][A], cls[P][A], clf[P][A];
  float nle[P][A], nls[P][A], nlf[P][A];
  load_block<A>(le, cle, 0, 1, U, col, c);
  load_block<A>(ls, cls, 0, 1, U, col, c);
  load_block<A>(lf, clf, 0, 1, U, col, c);
  float first_t[P], pv[P], e_le_prev[P], e_ls_prev[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    first_t[p] = c.t[p] == 0 ? 1.0f : 0.0f;
    pv[p] = e_le_prev[p] = e_ls_prev[p] = 0.0f;
  }
  float m = 0.0f;
  for (int u0 = 0; u0 < U; u0 += A) {
    load_block<A>(le, nle, u0 + A, 1, U, col, c);
    load_block<A>(ls, nls, u0 + A, 1, U, col, c);
    load_block<A>(lf, nlf, u0 + A, 1, U, col, c);
#pragma unroll
    for (int k = 0; k < A; ++k) {
      const int u = u0 + k;
      if (u >= U) continue;  // uniform across the block
      float q[P];
#pragma unroll
      for (int p = 0; p < P; ++p) q[p] = 0.0f;
      if (u > 0) {
        float* s = walk_row(sh, T, u);
#pragma unroll
        for (int p = 0; p < P; ++p)
          if (c.live[p]) s[c.t[p] + 1] = pv[p] * e_ls_prev[p];
        __syncthreads();
        // s[0] = 0: nothing shifts into t = 0
#pragma unroll
        for (int p = 0; p < P; ++p) q[p] = pv[p] * e_le_prev[p] + s[c.t[p]];
      }
      float p_raw[P];
#pragma unroll
      for (int p = 0; p < P; ++p)
        p_raw[p] = (u == 0 ? first_t[p] : q[p]) * expf(clf[p][k]);
      const float norm = fmaxf(live_max(c, p_raw, red), kTiny);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        if (c.live[p])
          alphas[(size_t)u * col + c.off[p]] = logf(p_raw[p]) + m;
        pv[p] = p_raw[p] / norm;
      }
      m = m + logf(norm);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        e_le_prev[p] = expf(cle[p][k]);
        e_ls_prev[p] = expf(cls[p][k]);
      }
    }
    take_cols(cle, nle);
    take_cols(cls, nls);
    take_cols(clf, nlf);
  }
}

// lattice_bidir_exp's beta walk, _bidir_kernel_exp's backward column:
//   c = b * exp(lf_{u+1});  b_raw = exp(le_u) * c + exp(ls_u) * shift0_up(c)
//   at u == U_b-1: b_raw = [t == T_b-1] exp(le_u), n = 0
//   beta_u = log(b_raw) + n;  b = b_raw / s;  n += log(s)
// sh: walk_row's rows, row[T] = 0.
template <int P>
__device__ void exp_beta_walk(int B, int T, int U,
                              const float* __restrict__ le,
                              const float* __restrict__ ls,
                              const float* __restrict__ lf, int in_len,
                              int out_len, float* __restrict__ betas,
                              float* sh, float* red) {
  constexpr int A = kAhead / P;
  const Cells<P> c(T);
  const size_t col = (size_t)B * T;
  float cle[P][A], cls[P][A], clf[P][A];
  float nle[P][A], nls[P][A], nlf[P][A];
  load_block<A>(le, cle, U - 1, -1, U, col, c);
  load_block<A>(ls, cls, U - 1, -1, U, col, c);
  load_block<A>(lf, clf, U - 1, -1, U, col, c);
  float field[P], e_lf_next[P];
#pragma unroll
  for (int p = 0; p < P; ++p) field[p] = e_lf_next[p] = 0.0f;
  float n = 0.0f;
  for (int u0 = U - 1; u0 >= 0; u0 -= A) {
    load_block<A>(le, nle, u0 - A, -1, U, col, c);
    load_block<A>(ls, nls, u0 - A, -1, U, col, c);
    load_block<A>(lf, nlf, u0 - A, -1, U, col, c);
#pragma unroll
    for (int k = 0; k < A; ++k) {
      const int u = u0 - k;
      if (u < 0) continue;  // uniform across the block
      float e_le[P], cv[P], b_raw[P];
      float* s = walk_row(sh, T, u);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        e_le[p] = expf(cle[p][k]);
        cv[p] = field[p] * e_lf_next[p];
        if (c.live[p]) s[c.t[p]] = cv[p];
      }
      __syncthreads();
      // s[T] = 0: nothing shifts into T-1
#pragma unroll
      for (int p = 0; p < P; ++p)
        b_raw[p] = e_le[p] * cv[p] + expf(cls[p][k]) * s[c.t[p] + 1];
      if (u == out_len - 1) {  // uniform across the block
#pragma unroll
        for (int p = 0; p < P; ++p)
          b_raw[p] = c.t[p] == in_len - 1 ? e_le[p] : 0.0f;
        n = 0.0f;
      }
      const float norm = fmaxf(live_max(c, b_raw, red), kTiny);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        if (c.live[p]) betas[(size_t)u * col + c.off[p]] = logf(b_raw[p]) + n;
        field[p] = b_raw[p] / norm;
      }
      n = n + logf(norm);
#pragma unroll
      for (int p = 0; p < P; ++p) e_lf_next[p] = expf(clf[p][k]);
    }
    take_cols(cle, nle);
    take_cols(cls, nls);
    take_cols(clf, nlf);
  }
}

// lattice_expin's alpha walk, _bidir_kernel_expin's forward column, from
// p = [t == 0], E_prev = 1, S_prev = 0:
//   q = p * E_{u-1} + shift0_down(p * S_{u-1})
//   if (u + 1) % 4 == 0: s = max(rowmax(q), TINY); q *= 1/s; m += log(s)
//   qn_u = q;  m += mcol_u;  M_u = m;  p = q * F_u
template <int P>
__device__ void expin_alpha_walk(int B, int T, int U,
                                 const float* __restrict__ E,
                                 const float* __restrict__ S,
                                 const float* __restrict__ F,
                                 const float* __restrict__ mcol,
                                 float* __restrict__ qn,
                                 float* __restrict__ M, float* sh,
                                 float* red) {
  constexpr int A = kAhead / P;
  const int b = blockIdx.x;
  const Cells<P> c(T);
  const size_t col = (size_t)B * T;
  float cE[P][A], cS[P][A], cF[P][A], cm[A];
  float nE[P][A], nS[P][A], nF[P][A], nm[A];
  load_block<A>(E, cE, 0, 1, U, col, c);
  load_block<A>(S, cS, 0, 1, U, col, c);
  load_block<A>(F, cF, 0, 1, U, col, c);
  load_cols<A>(mcol, cm, 0, 1, U, (size_t)B, (size_t)b, true);
  float pv[P], e_prev[P], s_prev[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    pv[p] = c.t[p] == 0 ? 1.0f : 0.0f;
    e_prev[p] = 1.0f;
    s_prev[p] = 0.0f;
  }
  float m = 0.0f;
  for (int u0 = 0; u0 < U; u0 += A) {
    load_block<A>(E, nE, u0 + A, 1, U, col, c);
    load_block<A>(S, nS, u0 + A, 1, U, col, c);
    load_block<A>(F, nF, u0 + A, 1, U, col, c);
    load_cols<A>(mcol, nm, u0 + A, 1, U, (size_t)B, (size_t)b, true);
#pragma unroll
    for (int k = 0; k < A; ++k) {
      const int u = u0 + k;
      if (u >= U) continue;  // uniform across the block
      float* s = walk_row(sh, T, u);
#pragma unroll
      for (int p = 0; p < P; ++p)
        if (c.live[p]) s[c.t[p] + 1] = pv[p] * s_prev[p];
      __syncthreads();
      float q[P];
      // s[0] = 0: nothing shifts into t = 0
#pragma unroll
      for (int p = 0; p < P; ++p) q[p] = pv[p] * e_prev[p] + s[c.t[p]];
      if ((u + 1) % kRenorm == 0) {  // uniform across the block
        const float norm = fmaxf(live_max(c, q, red), kTiny);
        const float rcp = __frcp_rn(norm);
#pragma unroll
        for (int p = 0; p < P; ++p) q[p] = q[p] * rcp;
        m = m + logf(norm);
      }
#pragma unroll
      for (int p = 0; p < P; ++p)
        if (c.live[p]) qn[(size_t)u * col + c.off[p]] = q[p];
      m = m + cm[k];
      if (threadIdx.x == 0) M[(size_t)u * B + b] = m;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        pv[p] = q[p] * cF[p][k];
        e_prev[p] = cE[p][k];
        s_prev[p] = cS[p][k];
      }
    }
    take_cols(cE, nE);
    take_cols(cS, nS);
    take_cols(cF, nF);
#pragma unroll
    for (int k = 0; k < A; ++k) cm[k] = nm[k];
  }
}

// lattice_expin's beta walk, _bidir_kernel_expin's backward column, from
// c = 0, n = 0:
//   b_raw = E_u * c + S_u * shift0_up(c)
//   at u == U_b-1: b_raw = [t == T_b-1] E_u, n = 0
//   if u % 4 == 0: s = max(rowmax(b_raw), TINY); b_raw *= 1/s; n += log(s)
//   bn_u = b_raw;  N_u = n;  c = F_u * bn_u;  n += mcol_u
template <int P>
__device__ void expin_beta_walk(int B, int T, int U,
                                const float* __restrict__ E,
                                const float* __restrict__ S,
                                const float* __restrict__ F,
                                const float* __restrict__ mcol, int in_len,
                                int out_len, float* __restrict__ bn,
                                float* __restrict__ N, float* sh,
                                float* red) {
  constexpr int A = kAhead / P;
  const int b = blockIdx.x;
  const Cells<P> c(T);
  const size_t col = (size_t)B * T;
  float cE[P][A], cS[P][A], cF[P][A], cm[A];
  float nE[P][A], nS[P][A], nF[P][A], nm[A];
  load_block<A>(E, cE, U - 1, -1, U, col, c);
  load_block<A>(S, cS, U - 1, -1, U, col, c);
  load_block<A>(F, cF, U - 1, -1, U, col, c);
  load_cols<A>(mcol, cm, U - 1, -1, U, (size_t)B, (size_t)b, true);
  float cv[P];
#pragma unroll
  for (int p = 0; p < P; ++p) cv[p] = 0.0f;
  float n = 0.0f;
  for (int u0 = U - 1; u0 >= 0; u0 -= A) {
    load_block<A>(E, nE, u0 - A, -1, U, col, c);
    load_block<A>(S, nS, u0 - A, -1, U, col, c);
    load_block<A>(F, nF, u0 - A, -1, U, col, c);
    load_cols<A>(mcol, nm, u0 - A, -1, U, (size_t)B, (size_t)b, true);
#pragma unroll
    for (int k = 0; k < A; ++k) {
      const int u = u0 - k;
      if (u < 0) continue;  // uniform across the block
      float* s = walk_row(sh, T, u);
#pragma unroll
      for (int p = 0; p < P; ++p)
        if (c.live[p]) s[c.t[p]] = cv[p];
      __syncthreads();
      float b_raw[P];
      // s[T] = 0: nothing shifts into T-1
#pragma unroll
      for (int p = 0; p < P; ++p)
        b_raw[p] = cE[p][k] * cv[p] + cS[p][k] * s[c.t[p] + 1];
      if (u == out_len - 1) {  // uniform across the block
#pragma unroll
        for (int p = 0; p < P; ++p)
          b_raw[p] = c.t[p] == in_len - 1 ? cE[p][k] : 0.0f;
        n = 0.0f;
      }
      if (u % kRenorm == 0) {  // uniform across the block
        const float norm = fmaxf(live_max(c, b_raw, red), kTiny);
        const float rcp = __frcp_rn(norm);
#pragma unroll
        for (int p = 0; p < P; ++p) b_raw[p] = b_raw[p] * rcp;
        n = n + logf(norm);
      }
#pragma unroll
      for (int p = 0; p < P; ++p)
        if (c.live[p]) bn[(size_t)u * col + c.off[p]] = b_raw[p];
      if (threadIdx.x == 0) N[(size_t)u * B + b] = n;
#pragma unroll
      for (int p = 0; p < P; ++p) cv[p] = cF[p][k] * b_raw[p];
      n = n + cm[k];
    }
    take_cols(cE, nE);
    take_cols(cS, nS);
    take_cols(cF, nF);
#pragma unroll
    for (int k = 0; k < A; ++k) cm[k] = nm[k];
  }
}

// _bwdgrad_kernel's walk: per column u (descending), the emit/shift/frame
// posteriors exp(min(score - logz, 30)) on the valid region, times -g (0
// for an example with no valid path, logz <= NEG/2), then beta_u. sh:
// walk_row's rows, row[T] = NEG.
template <int P, typename S>
__device__ void grads_walk(int B, int T, int U, const S* __restrict__ le,
                           const S* __restrict__ ls, const S* __restrict__ lf,
                           const float* __restrict__ alphas,
                           const int* __restrict__ il,
                           const int* __restrict__ ol,
                           const float* __restrict__ g,
                           const float* __restrict__ logz,
                           S* __restrict__ d_le, S* __restrict__ d_ls,
                           S* __restrict__ d_lf, float* sh) {
  constexpr int A = kAhead / P;
  const int b = blockIdx.x;
  const Cells<P> c(T);
  const int in_len = il[b], out_len = ol[b];
  const float lz = logz[b];
  const float neg_g = lz <= kNeg / 2 ? 0.0f : -g[b];
  const size_t col = (size_t)B * T;
  S cle[P][A], cls[P][A], clf[P][A];
  S nle[P][A], nls[P][A], nlf[P][A];
  float cal[P][A], nal[P][A];
  load_block<A>(le, cle, U - 1, -1, U, col, c);
  load_block<A>(ls, cls, U - 1, -1, U, col, c);
  load_block<A>(lf, clf, U - 1, -1, U, col, c);
  load_block<A>(alphas, cal, U - 1, -1, U, col, c);
  float beta[P], lf_next[P];
#pragma unroll
  for (int p = 0; p < P; ++p) beta[p] = lf_next[p] = kNeg;
  for (int u0 = U - 1; u0 >= 0; u0 -= A) {
    load_block<A>(le, nle, u0 - A, -1, U, col, c);
    load_block<A>(ls, nls, u0 - A, -1, U, col, c);
    load_block<A>(lf, nlf, u0 - A, -1, U, col, c);
    load_block<A>(alphas, nal, u0 - A, -1, U, col, c);
#pragma unroll
    for (int k = 0; k < A; ++k) {
      const int u = u0 - k;
      if (u < 0) continue;  // uniform across the block
      const bool is_last_u = u == out_len - 1;
      float* s = walk_row(sh, T, u);
      float cont[P];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        cont[p] = lf_next[p] + beta[p];
        if (c.live[p]) s[c.t[p]] = cont[p];
      }
      __syncthreads();
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const bool is_last_t = c.t[p] == in_len - 1;
        const bool valid = c.t[p] < in_len && u < out_len;
        const float cont_shift_raw = s[c.t[p] + 1];
        const float cont_emit =
            is_last_u ? (is_last_t ? 0.0f : kNeg) : cont[p];
        const float cont_shift = is_last_u ? kNeg : cont_shift_raw;
        const float le_u = f32(cle[p][k]), ls_u = f32(cls[p][k]);
        const float anorm = cal[p][k] - lz;
        const float p_le =
            valid ? expf(fminf(anorm + le_u + cont_emit, 30.0f)) : 0.0f;
        const float p_ls =
            valid ? expf(fminf(anorm + ls_u + cont_shift, 30.0f)) : 0.0f;
        const float rec = lae(le_u + cont[p], ls_u + cont_shift_raw);
        beta[p] = is_last_u ? (is_last_t ? le_u : kNeg) : rec;
        const float p_lf = valid ? expf(fminf(anorm + beta[p], 30.0f)) : 0.0f;
        if (c.live[p]) {
          const size_t i = (size_t)u * col + c.off[p];
          st(d_le, i, neg_g * p_le);
          st(d_ls, i, neg_g * p_ls);
          st(d_lf, i, neg_g * p_lf);
        }
        lf_next[p] = f32(clf[p][k]);
      }
    }
    take_cols(cle, nle);
    take_cols(cls, nls);
    take_cols(clf, nlf);
    take_cols(cal, nal);
  }
}

// The block walks' kernels: a block per example (per example and direction
// for the bidirectional ones, blockIdx.y), P positions a thread, the
// shared rows (walk_row) in dynamic shared memory.
template <int P>
__device__ __forceinline__ void bidir_block(int B, int T, int U,
                                            const float* __restrict__ le,
                                            const float* __restrict__ ls,
                                            const float* __restrict__ lf,
                                            const int* __restrict__ il,
                                            const int* __restrict__ ol,
                                            float* __restrict__ alphas,
                                            float* __restrict__ betas) {
  extern __shared__ float walk_sh[];
  if (threadIdx.x == 0) {
    walk_sh[0] = walk_sh[T + 1] = kNeg;
    walk_sh[T] = walk_sh[2 * T + 1] = kNeg;
  }
  __syncthreads();
  if (blockIdx.y == 0) {
    alpha_walk<P, float>(B, T, U, le, ls, lf, alphas, walk_sh);
  } else {
    const int b = blockIdx.x;
    beta_walk<P>(B, T, U, le, ls, lf, il[b], ol[b], betas, walk_sh);
  }
}

template <int P>
__device__ __forceinline__ void backward_betas_block(
    int B, int T, int U, const float* __restrict__ le,
    const float* __restrict__ ls, const float* __restrict__ lf,
    const int* __restrict__ il, const int* __restrict__ ol,
    float* __restrict__ betas) {
  extern __shared__ float walk_sh[];
  if (threadIdx.x == 0) walk_sh[T] = walk_sh[2 * T + 1] = kNeg;
  __syncthreads();
  const int b = blockIdx.x;
  beta_walk<P>(B, T, U, le, ls, lf, il[b], ol[b], betas, walk_sh);
}

// The exp-domain kernels' shared rows carry 0 at both edges: the shifts
// fill with 0, not NEG.
template <int P>
__device__ __forceinline__ void bidir_exp_block(
    int B, int T, int U, const float* __restrict__ le,
    const float* __restrict__ ls, const float* __restrict__ lf,
    const int* __restrict__ il, const int* __restrict__ ol,
    float* __restrict__ alphas, float* __restrict__ betas) {
  extern __shared__ float walk_sh[];
  __shared__ float red[32];
  if (threadIdx.x == 0) {
    walk_sh[0] = walk_sh[T + 1] = 0.0f;
    walk_sh[T] = walk_sh[2 * T + 1] = 0.0f;
  }
  __syncthreads();
  if (blockIdx.y == 0) {
    exp_alpha_walk<P>(B, T, U, le, ls, lf, alphas, walk_sh, red);
  } else {
    const int b = blockIdx.x;
    exp_beta_walk<P>(B, T, U, le, ls, lf, il[b], ol[b], betas, walk_sh, red);
  }
}

template <int P>
__device__ __forceinline__ void expin_block(
    int B, int T, int U, const float* __restrict__ E,
    const float* __restrict__ S, const float* __restrict__ F,
    const float* __restrict__ mcol, const int* __restrict__ il,
    const int* __restrict__ ol, float* __restrict__ qn,
    float* __restrict__ bn, float* __restrict__ M, float* __restrict__ N) {
  extern __shared__ float walk_sh[];
  __shared__ float red[32];
  if (threadIdx.x == 0) {
    walk_sh[0] = walk_sh[T + 1] = 0.0f;
    walk_sh[T] = walk_sh[2 * T + 1] = 0.0f;
  }
  __syncthreads();
  if (blockIdx.y == 0) {
    expin_alpha_walk<P>(B, T, U, E, S, F, mcol, qn, M, walk_sh, red);
  } else {
    const int b = blockIdx.x;
    expin_beta_walk<P>(B, T, U, E, S, F, mcol, il[b], ol[b], bn, N, walk_sh,
                       red);
  }
}

template <int P, typename S>
__device__ __forceinline__ void forward_alphas_block(
    int B, int T, int U, const S* __restrict__ le, const S* __restrict__ ls,
    const S* __restrict__ lf, float* __restrict__ alphas) {
  extern __shared__ float walk_sh[];
  if (threadIdx.x == 0) walk_sh[0] = walk_sh[T + 1] = kNeg;
  __syncthreads();
  alpha_walk<P, S>(B, T, U, le, ls, lf, alphas, walk_sh);
}

template <int P, typename S>
__device__ __forceinline__ void backward_grads_block(
    int B, int T, int U, const S* __restrict__ le, const S* __restrict__ ls,
    const S* __restrict__ lf, const float* __restrict__ alphas,
    const int* __restrict__ il, const int* __restrict__ ol,
    const float* __restrict__ g, const float* __restrict__ logz,
    S* __restrict__ d_le, S* __restrict__ d_ls, S* __restrict__ d_lf) {
  extern __shared__ float walk_sh[];
  if (threadIdx.x == 0) walk_sh[T] = walk_sh[2 * T + 1] = kNeg;
  __syncthreads();
  grads_walk<P, S>(B, T, U, le, ls, lf, alphas, il, ol, g, logz, d_le, d_ls,
                   d_lf, walk_sh);
}

// Each comes as <name>_kernel, one thread a position with registers as the
// compiler picks them (~70-150, so blocks of ~400-900 threads at most),
// and <name>_kernel_p<P> for P in 2, 4, 8, bounded to kMaxBlock threads
// (at most 64 registers, spilling what does not fit), both over
// <name>_block<P> (the template argument after P, the storage type, passed
// on): launch_block_walk takes P = 1 where the registers allow
// threads_for(T) threads.
#define SSNT_BLOCK_KERNEL(name, params, args)                             \
  template <int P>                                                        \
  __global__ void __launch_bounds__(kMaxBlock) name##_kernel_p params {   \
    name##_block<P> args;                                                 \
  }                                                                       \
  __global__ void name##_kernel params { name##_block<1> args; }

#define SSNT_BLOCK_KERNEL_S(name, params, args)                           \
  template <int P, typename S>                                            \
  __global__ void __launch_bounds__(kMaxBlock) name##_kernel_p params {   \
    name##_block<P, S> args;                                              \
  }                                                                       \
  template <typename S>                                                   \
  __global__ void name##_kernel params { name##_block<1, S> args; }

SSNT_BLOCK_KERNEL(bidir,
                  (int B, int T, int U, const float* __restrict__ le,
                   const float* __restrict__ ls, const float* __restrict__ lf,
                   const int* __restrict__ il, const int* __restrict__ ol,
                   float* __restrict__ alphas, float* __restrict__ betas),
                  (B, T, U, le, ls, lf, il, ol, alphas, betas))
SSNT_BLOCK_KERNEL(backward_betas,
                  (int B, int T, int U, const float* __restrict__ le,
                   const float* __restrict__ ls, const float* __restrict__ lf,
                   const int* __restrict__ il, const int* __restrict__ ol,
                   float* __restrict__ betas),
                  (B, T, U, le, ls, lf, il, ol, betas))
SSNT_BLOCK_KERNEL(bidir_exp,
                  (int B, int T, int U, const float* __restrict__ le,
                   const float* __restrict__ ls, const float* __restrict__ lf,
                   const int* __restrict__ il, const int* __restrict__ ol,
                   float* __restrict__ alphas, float* __restrict__ betas),
                  (B, T, U, le, ls, lf, il, ol, alphas, betas))
SSNT_BLOCK_KERNEL(expin,
                  (int B, int T, int U, const float* __restrict__ E,
                   const float* __restrict__ S, const float* __restrict__ F,
                   const float* __restrict__ mcol, const int* __restrict__ il,
                   const int* __restrict__ ol, float* __restrict__ qn,
                   float* __restrict__ bn, float* __restrict__ M,
                   float* __restrict__ N),
                  (B, T, U, E, S, F, mcol, il, ol, qn, bn, M, N))
SSNT_BLOCK_KERNEL_S(forward_alphas,
                    (int B, int T, int U, const S* __restrict__ le,
                     const S* __restrict__ ls, const S* __restrict__ lf,
                     float* __restrict__ alphas),
                    (B, T, U, le, ls, lf, alphas))
SSNT_BLOCK_KERNEL_S(backward_grads,
                    (int B, int T, int U, const S* __restrict__ le,
                     const S* __restrict__ ls, const S* __restrict__ lf,
                     const float* __restrict__ alphas,
                     const int* __restrict__ il, const int* __restrict__ ol,
                     const float* __restrict__ g,
                     const float* __restrict__ logz, S* __restrict__ d_le,
                     S* __restrict__ d_ls, S* __restrict__ d_lf),
                    (B, T, U, le, ls, lf, alphas, il, ol, g, logz, d_le,
                     d_ls, d_lf))

#undef SSNT_BLOCK_KERNEL
#undef SSNT_BLOCK_KERNEL_S

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
// workspaces written and read, the three gradients written). The banded
// passes keep one thread a position, so registers cap T below kMaxT,
// which the wrapper asks through ssnt_lattice_banded_max_t (the least of
// the three passes' limits of the walk; chip_smoke.py phase 24 on an H100:
// forward / backward T <= 1024 / 896 at K=2, 512 / 1024 at K=4, 512 / 640
// at K=8, 512 / 384 at K=16; the compose tree's 2 K T floats of shared
// memory would allow ~1800 at K=16).

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
  __shared__ float rows[2][kMaxBlock];
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
  __shared__ float rows[2][kMaxBlock];
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
  __shared__ float rows[2][kMaxBlock];
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

// The most threads a block of kern may have (its registers may allow
// fewer than kMaxBlock), rounded down to whole warps; 0 for a banded K
// without an instance.
template <typename Kern>
int max_threads(Kern kern) {
  cudaFuncAttributes a;
  if (cudaFuncGetAttributes(&a, kern) != cudaSuccess) return 0;
  const int n = a.maxThreadsPerBlock < kMaxBlock ? a.maxThreadsPerBlock
                                               : kMaxBlock;
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

// ------------------------------------------------------------ warp walks
//
// For T <= kWarpMaxT (the main path's T = 80) lattice_expin and
// lattice_bidir_exp run each walk (example, direction) on one warp, lane l
// holding the V consecutive source positions t = l*V + j (V = 1/2/4 by T;
// lattice_bidir on several warps, "bidirectional warp walks" below), so a
// column's neighbour exchange is one shuffle (__shfl_up_sync forward, the
// value at t - 1 of the lane below; __shfl_down_sync backward, t + 1 of
// the lane above; the block walk's
// shared-row edge at t = 0 and past T: 0 in the exp domain, NEG in the
// log domain) and a row max is the lane's max and one __reduce_max_sync
// on the values' bits (for floats >= 0 the bits order as the values, and a
// max does not depend on the order, so it equals the block walk's bit for
// bit). Per cell the operations and their order are the block walks'.
//
// One warp issues its instructions in order, so a walk's time is about
// the instructions between two steps of its chain. A walk's block
// therefore has a loader, a chain and a storer warp on separate
// schedulers, each a loop of its own, passing rounds of R columns through
// shared memory and mbarriers (a full and an empty barrier a slot; no
// block barrier inside the loops), the WalkRing below:
//   - the loader stages the walk's three input rows a column into a ring
//     of NIn rounds with cp.async (one copy of 4V bytes a row and
//     lane where T % V == 0 and the fields are aligned to it; else one of
//     4 bytes per value below T: a column of T % 4 != 0 floats starts
//     unaligned; zeros for a column outside [0, U)), each lane's copies
//     completing on the round's barrier (cp.async.mbarrier.arrive);
//   - the chain warp reads a round, walks it in registers and shuffles,
//     and writes the round's R output rows (and its normalizers) into a
//     ring of NRes result slots;
//   - the storer reads a round's rows into registers, frees its slot, then
//     writes them to global memory (no store waits on its shared load).
// A slot row is 32 V floats, so a lane past T reads inside the ring; its
// values (and a lane's values at t >= T) never reach a position below T
// (the backward's shift from t >= T reads the edge value, the row max 0)
// and are never stored. Offsets are 32-bit: the launchers take the warp
// walks for U * B * T < 2^31.
//
// lattice_expin ("exp-native warp walk" below) renormalizes every 4th
// column, so its rounds are kRenorm columns aligned on u. The
// bidirectional walks ("bidirectional warp walks") take rounds from u = 0
// forward and from u = U - 1 backward.

constexpr int kWarpMaxT = 128;  // 32 lanes x V = 4
constexpr int kInRounds = 6;    // input ring: rounds staged ahead
constexpr int kResRounds = 4;   // result ring

// A warp walk's shared memory: the input ring (NIn rounds of R columns of
// 3 rows of 32 V values of the storage type In, float or bfloat16), the
// result ring (NRes rounds of R rows of 32 V floats), NNorm normalizers a
// result round, the barriers.
template <int V_, int R_, int NNorm_, int NIn_ = kInRounds,
          int NRes_ = kResRounds, typename In_ = float>
struct WalkRing {
  static constexpr int V = V_, R = R_, NNorm = NNorm_;
  static constexpr int NIn = NIn_, NRes = NRes_;
  using In = In_;
  In in[NIn][R][3][32 * V];
  float res[NRes][R][32 * V];
  float norm[NRes][NNorm];
  uint64_t in_full[NIn], in_empty[NIn];
  uint64_t res_full[NRes], res_empty[NRes];
};

// Initializes the ring's barriers (`loaders` warps fill each input slot,
// `chains` warps read it and fill each result slot, `storers` warps read
// each result slot, `readers` more warps read each input slot) before any
// warp takes its role.
template <class Ring>
__device__ __forceinline__ void init_ring(Ring& sm, int loaders,
                                          int chains = 1, int storers = 1,
                                          int readers = 0) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < Ring::NIn; ++i) {
      ssnt_tma::mbar_init(&sm.in_full[i], 32 * loaders);
      ssnt_tma::mbar_init(&sm.in_empty[i], 32 * (chains + readers));
    }
    for (int i = 0; i < Ring::NRes; ++i) {
      ssnt_tma::mbar_init(&sm.res_full[i], 32 * chains);
      ssnt_tma::mbar_init(&sm.res_empty[i], 32 * storers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of N bytes, of which the first `src_bytes` are read and the
// rest filled with zeros.
template <int N>
__device__ __forceinline__ void cp_async_zfill(void* dst, const void* src,
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

// One walk at this lane: its three input rows and its outputs at (example
// b, t0), column u at + u * col; lattice_expin's mcol and M / N at b,
// column u at + u * B.
struct WarpWalk {
  int col, B, T, U, top, rounds, t0, lane;  // top: see round_column
  bool live;                                // t0 < T
};

// A walk at this lane, which holds the V positions from t_base + lane * V,
// in rounds of R columns; top is the backward's first round's first
// column less R - 1.
__device__ __forceinline__ WarpWalk make_walk(int B, int T, int U, int V,
                                              int R, int top,
                                              int t_base = 0) {
  WarpWalk w;
  w.lane = threadIdx.x % 32, w.t0 = t_base + w.lane * V;
  w.live = w.t0 < T;
  w.col = B * T, w.B = B, w.T = T, w.U = U;
  w.top = top;
  w.rounds = (U + R - 1) / R;
  return w;
}

// Round r's j-th column in walk order: forward r * R + j, backward top -
// r * R + R - 1 - j; in the walk if in [0, U).
template <bool kBack, int R>
__device__ __forceinline__ int round_column(const WarpWalk& w, int r,
                                            int j) {
  return kBack ? w.top - R * r + (R - 1 - j) : R * r + j;
}

// Whether a ring round's rows are copied by cp.async (every float row; a
// bfloat16 row where a lane's values are one copy of 4 to 16 bytes), and
// not value by value by the lane itself (cp.async copies 4 bytes at least).
template <class Ring, bool kVec>
__host__ __device__ constexpr bool vec_copies() {
  return kVec && sizeof(typename Ring::In) * Ring::V >= 4;
}

template <class Ring, bool kVec>
__host__ __device__ constexpr bool async_rows() {
  return sizeof(typename Ring::In) == 4 || vec_copies<Ring, kVec>();
}

// Round r's columns j with j % L == j0 into its input slot, each lane its
// own live positions; zeros for a column outside [0, U). By cp.async (one
// copy of V values a row where kVec and they make 4 bytes or more, else
// float values one by one); other bfloat16 rows by loads and shared
// stores.
template <class Ring, bool kVec, bool kBack, int L = 1>
__device__ __forceinline__ void stage_round(
    const WarpWalk& w, Ring& sm, int r, int j0,
    const typename Ring::In* __restrict__ E,
    const typename Ring::In* __restrict__ S,
    const typename Ring::In* __restrict__ F) {
  using In = typename Ring::In;
  constexpr int V = Ring::V, N = (int)sizeof(In) * V;
  const int slot = r % Ring::NIn;
#pragma unroll
  for (int j = 0; j < Ring::R; ++j) {
    if (j % L != j0) continue;
    const int u = round_column<kBack, Ring::R>(w, r, j);
    const bool in_walk = (unsigned)u < (unsigned)w.U;
    const int o = (in_walk ? u : w.U - 1) * w.col;
    In(&rows)[3][32 * V] = sm.in[slot][j];
    if constexpr (vec_copies<Ring, kVec>()) {
      if (w.live) {
        const int n = in_walk ? N : 0;
        cp_async_zfill<N>(rows[0] + w.t0, E + o, n);
        cp_async_zfill<N>(rows[1] + w.t0, S + o, n);
        cp_async_zfill<N>(rows[2] + w.t0, F + o, n);
      }
    } else if constexpr (!async_rows<Ring, kVec>()) {
      const In zero = __float2bfloat16_rn(0.0f);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        if (w.t0 + k < w.T) {
          rows[0][w.t0 + k] = in_walk ? ld(E, o + k) : zero;
          rows[1][w.t0 + k] = in_walk ? ld(S, o + k) : zero;
          rows[2][w.t0 + k] = in_walk ? ld(F, o + k) : zero;
        }
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
}

// The loader of lattice_expin and the log walks: round r into input slot
// r % NIn once its readers have read the round NIn before; the slot's
// full barrier arrived on once the copies have landed (a bfloat16 row
// staged by the lane itself: after its shared stores).
template <class Ring, bool kVec, bool kBack>
__device__ void walk_loader(const WarpWalk& w, Ring& sm,
                            const typename Ring::In* __restrict__ E,
                            const typename Ring::In* __restrict__ S,
                            const typename Ring::In* __restrict__ F) {
  for (int r = 0; r < w.rounds; ++r) {
    const int slot = r % Ring::NIn;
    if (r >= Ring::NIn)
      ssnt_tma::mbar_wait(&sm.in_empty[slot], (r / Ring::NIn + 1) & 1);
    stage_round<Ring, kVec, kBack>(w, sm, r, 0, E, S, F);
    if constexpr (async_rows<Ring, kVec>())
      cp_async_arrive(&sm.in_full[slot]);
    else
      mbar_arrive(&sm.in_full[slot]);
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
__device__ __forceinline__ void load_lane(const __nv_bfloat16* p,
                                          float (&x)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) x[j] = __bfloat162float(p[j]);
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

// A storer's global stores of one column at this lane: its values below T.
template <int V, bool kVec>
__device__ __forceinline__ void store_cells(const WarpWalk& w, float* dst,
                                            const float (&x)[V]) {
  if constexpr (kVec) {
    if (w.live) store_lane<V>(dst, x);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (w.t0 + j < w.T) dst[j] = x[j];
  }
}

// A round's three input rows at this lane.
template <int V, int R> struct WalkRound {
  float e[R][V], s[R][V], f[R][V];
};

// A chain warp's side of the rings (its lanes' V positions of each row):
// waits for round r, reads it and frees its input slot.
template <class Ring, int V>
__device__ __forceinline__ void take_round(const WarpWalk& w, Ring& sm,
                                           int r,
                                           WalkRound<V, Ring::R>& d) {
  const int slot = r % Ring::NIn;
  ssnt_tma::mbar_wait(&sm.in_full[slot], (r / Ring::NIn) & 1);
#pragma unroll
  for (int j = 0; j < Ring::R; ++j) {
    load_lane<V>(sm.in[slot][j][0] + w.t0, d.e[j]);
    load_lane<V>(sm.in[slot][j][1] + w.t0, d.s[j]);
    load_lane<V>(sm.in[slot][j][2] + w.t0, d.f[j]);
  }
  mbar_arrive(&sm.in_empty[slot]);
}

// ... and hands the round's rows and normalizers to the storer.
template <class Ring, int V>
__device__ __forceinline__ void give_round(
    const WarpWalk& w, Ring& sm, int r, const float (&x)[Ring::R][V],
    const float (&norm)[Ring::NNorm]) {
  const int slot = r % Ring::NRes;
  if (r >= Ring::NRes)
    ssnt_tma::mbar_wait(&sm.res_empty[slot], (r / Ring::NRes + 1) & 1);
#pragma unroll
  for (int k = 0; k < Ring::R; ++k)
    store_lane<V>(sm.res[slot][k] + w.t0, x[k]);
  if (w.lane == 0) {
#pragma unroll
    for (int k = 0; k < Ring::NNorm; ++k) sm.norm[slot][k] = norm[k];
  }
  mbar_arrive(&sm.res_full[slot]);
}

// The storer's side: waits for round r's rows, reads them (and the
// normalizers) and frees the slot.
template <class Ring>
__device__ __forceinline__ void read_round(const WarpWalk& w, Ring& sm,
                                           int r,
                                           float (&x)[Ring::R][Ring::V],
                                           float (&norm)[Ring::NNorm]) {
  const int slot = r % Ring::NRes;
  ssnt_tma::mbar_wait(&sm.res_full[slot], (r / Ring::NRes) & 1);
#pragma unroll
  for (int k = 0; k < Ring::NNorm; ++k) norm[k] = sm.norm[slot][k];
#pragma unroll
  for (int k = 0; k < Ring::R; ++k)
    load_lane<Ring::V>(sm.res[slot][k] + w.t0, x[k]);
  mbar_arrive(&sm.res_empty[slot]);
}

// The warp's max of the field x (every value +0 or positive below T): the
// max of each lane's values below T (0 for a lane past T), the warp's max
// of those, floored at kTiny.
template <int V, bool kVec>
__device__ __forceinline__ float warp_max(const WarpWalk& w,
                                          const float (&x)[V]) {
  float m = x[0];
#pragma unroll
  for (int j = 1; j < V; ++j)
    if (kVec || w.t0 + j < w.T) m = fmaxf(m, x[j]);
  m = w.live ? m : 0.0f;
  const unsigned top = __reduce_max_sync(0xffffffffu, __float_as_uint(m));
  return fmaxf(__uint_as_float(top), kTiny);
}

// ------------------------------------------------- exp-native warp walk
//
// lattice_expin's warp walk: rounds of kRenorm columns aligned on u, so
// the renormalizing column is each round's last in walk order (the
// backward's top is (U - 1) / 4 * 4). The chain warp renormalizes by the
// warp's max and the correctly rounded reciprocal and hands the round's
// last normalizer to the storer, which writes the field and keeps the log
// normalizers M / N (mcol loaded once per 32 columns, a value a lane, read
// by shuffle; each lane stores one column's M / N a block). Columns past
// U in the backward's first round read zeros, which leave c at 0.
// Measured (probe_expin.py, NVIDIA H100 80GB HBM3, 700 W; T=80, U=400):
// 0.042 ms at B=32, of which the chain alone takes 0.034 (stores, copies
// and renormalization taken out); 0.090 ms at B=256, where the copies and
// stores of ~4 walks an SM set it (0.041 without them); the block walk
// 0.116 / 0.140.

template <int V> using ExpinRing = WalkRing<V, kRenorm, 1>;

// Renormalizes the warp's field x: x times the correctly rounded
// reciprocal of warp_max. Returns the normalizer.
template <int V, bool kVec>
__device__ __forceinline__ float warp_renorm(const WarpWalk& w,
                                             float (&x)[V]) {
  const float norm = warp_max<V, kVec>(w, x);
  const float rcp = __frcp_rn(norm);
#pragma unroll
  for (int j = 0; j < V; ++j) x[j] = x[j] * rcp;
  return norm;
}

// expin_alpha_walk's chain: per column u,
//   q = p * E_{u-1} + shift0_down(p * S_{u-1}); renormalize after u when
//   (u + 1) % 4 == 0 (a round's last column); qn_u = q; p = q * F_u.
template <int V, bool kVec>
__device__ void expin_alpha_chain(const WarpWalk& w, ExpinRing<V>& sm) {
  float p[V], e_prev[V], s_prev[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    p[j] = w.t0 + j == 0 ? 1.0f : 0.0f;
    e_prev[j] = 1.0f;
    s_prev[j] = 0.0f;
  }
  for (int r = 0; r < w.rounds; ++r) {
    WalkRound<V, kRenorm> d;
    take_round(w, sm, r, d);
    float q[kRenorm][V], norm[1];
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
      if (k == kRenorm - 1) norm[0] = warp_renorm<V, kVec>(w, q[k]);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        p[j] = q[k][j] * d.f[k][j];
        e_prev[j] = d.e[k][j];
        s_prev[j] = d.s[k][j];
      }
    }
    give_round(w, sm, r, q, norm);
  }
}

// expin_beta_walk's chain: per column u, descending,
//   b_raw = E_u * c + S_u * shift0_up(c); reset at u == U_b - 1;
//   renormalize at u % 4 == 0 (a round's last column); bn_u = b_raw;
//   c = F_u * b_raw. The first round's columns past U read zeros, which
//   leave c at 0.
template <int V, bool kVec>
__device__ void expin_beta_chain(const WarpWalk& w, ExpinRing<V>& sm,
                                 int in_len, int out_len) {
  float c[V];
#pragma unroll
  for (int j = 0; j < V; ++j) c[j] = 0.0f;
  for (int r = 0; r < w.rounds; ++r) {
    WalkRound<V, kRenorm> d;
    take_round(w, sm, r, d);
    float b[kRenorm][V], norm[1];
#pragma unroll
    for (int k = 0; k < kRenorm; ++k) {
      const bool reset = round_column<true, kRenorm>(w, r, k) == out_len - 1;
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
      if (k == kRenorm - 1) norm[0] = warp_renorm<V, kVec>(w, b[k]);
#pragma unroll
      for (int j = 0; j < V; ++j) c[j] = d.f[k][j] * b[k][j];
    }
    give_round(w, sm, r, b, norm);
  }
}

// mcol at this lane's column of the 32-column block q (rounds 8 q .. 8 q +
// 7); 0 past the walk.
template <bool kBack>
__device__ __forceinline__ float block_mcol(const WarpWalk& w,
                                            const float* __restrict__ mcol,
                                            int q) {
  const int i = q * 32 + w.lane;
  const int u = round_column<kBack, kRenorm>(w, i / kRenorm, i % kRenorm);
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
__device__ void expin_storer(const WarpWalk& w, ExpinRing<V>& sm,
                             const float* __restrict__ mcol, int out_len,
                             float* __restrict__ field,
                             float* __restrict__ logs) {
  float mblk = block_mcol<kBack>(w, mcol, 0);
  float mnext = block_mcol<kBack>(w, mcol, 1);
  float acc = 0.0f, keep = 0.0f;
  for (int r = 0; r < w.rounds; ++r) {
    float x[kRenorm][V], nrm[1];
    read_round(w, sm, r, x, nrm);
    const float norm = nrm[0];
#pragma unroll
    for (int k = 0; k < kRenorm; ++k) {
      const int u = round_column<kBack, kRenorm>(w, r, k);
      const float mc = __shfl_sync(0xffffffffu, mblk, (r * kRenorm + k) & 31);
      if (u < w.U) {
        store_cells<V, kVec>(w, field + u * w.col, x[k]);
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
      const int ul = round_column<kBack, kRenorm>(w, i / kRenorm,
                                                  i % kRenorm);
      if (i / kRenorm <= r && ul >= 0 && ul < w.U) logs[ul * w.B] = keep;
      mblk = mnext;
      mnext = block_mcol<kBack>(w, mcol, r / 8 + 2);
    }
  }
}

// A block of three warps (loader, chain, storer) per example (blockIdx.x)
// and direction (blockIdx.y: 0 the alpha walk, 1 the beta walk); dynamic
// shared memory: ExpinRing<V>.
template <int V, bool kVec>
__global__ void __launch_bounds__(96)
    expin_warp_kernel(int B, int T, int U, const float* __restrict__ E,
                      const float* __restrict__ S,
                      const float* __restrict__ F,
                      const float* __restrict__ mcol,
                      const int* __restrict__ il, const int* __restrict__ ol,
                      float* __restrict__ qn, float* __restrict__ bn,
                      float* __restrict__ M, float* __restrict__ N) {
  extern __shared__ float4 walk_smem[];
  ExpinRing<V>& sm = *reinterpret_cast<ExpinRing<V>*>(walk_smem);
  const int b = blockIdx.x, warp = threadIdx.x / 32;
  const bool back = blockIdx.y == 1;
  const WarpWalk w =
      make_walk(B, T, U, V, kRenorm, (U - 1) / kRenorm * kRenorm);
  init_ring(sm, 1);
  const int eb = b * T + w.t0;
  if (warp == 0) {
    if (back)
      walk_loader<ExpinRing<V>, kVec, true>(w, sm, E + eb, S + eb, F + eb);
    else
      walk_loader<ExpinRing<V>, kVec, false>(w, sm, E + eb, S + eb, F + eb);
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
  constexpr size_t smem = sizeof(ExpinRing<V>);
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

// --------------------------------------------- bidirectional warp walks
//
// lattice_bidir (log domain) and lattice_bidir_exp (exp domain) for T <=
// kWarpMaxT: a block per example (blockIdx.x) and direction (blockIdx.y)
// of loader, chain and storer warps, rounds of R columns (u = 0, 1, ...
// forward; u = U - 1, U - 2, ... backward: top = U - R; the last round's
// columns past the walk read zeros, and are walked but never stored), the
// chain reading round r + 1 before it walks round r.
//
// lattice_bidir: the loader is lattice_expin's (le, ls, lf raw). The
// chain warps walk alpha_walk's or beta_walk's cells (lae with expf and
// log1pf) with NEG at the edges, and hand each round's alphas or betas to
// the storer, which writes them. One lae a column is the chain's floor
// (~170 ns on an H100), and four cells a lane on one warp took longer
// (their instructions queue behind one another), so the positions are
// split over chain warps below. No normalizer, so the round length is
// free: rounds of kLogRound columns.
//
// lattice_bidir_exp: one chain warp walks only the recursion's multiplies
// and adds, the row max (warp_max) and the division of every column
// (div_rn: the float division's bits without its slow path), and hands the
// round's raw fields p_raw / b_raw and their normalizers to the storer, in
// rounds of kBidirRound columns. The exps and logs are off the chain: the
// loader (L warps, each the round's columns j with j % L equal to its
// index) copies kExpAhead rounds ahead by cp.async into the ring slot
// itself, and once a round's copies have landed (the thread's own,
// cp.async.wait_group) replaces each value by its expf in place and
// arrives on the slot's full barrier; the storer writes log(raw) plus the
// running log normalizer (forward m, backward n with its reset at u ==
// U_b - 1) and adds log(norm) after each column. The loader's and the
// storer's column loops are not unrolled (kExpUnroll): unrolled, the
// three warps' loops were each thousands of instructions, and at B=256,
// where ~4 blocks share an SM, the walk took 2.6x as long.

constexpr int kBidirRound = 4;    // columns a round
constexpr int kExpLoaders = 2;    // #4's loaders where a block has an SM
constexpr int kExpAhead = 3;      // rounds its copies run ahead of its exps
constexpr int kExpUnroll = 1;     // its loader's and storer's column loops

template <int V> using BidirExpRing = WalkRing<V, kBidirRound, kBidirRound>;

// A chain warp's rounds: walk(r, d) on round r's inputs d (its lanes' V
// positions), with round r + 1 read from the ring before round r is
// walked (kReadAhead), so that its wait and shared loads are off the
// chain; without kReadAhead, round r read just before it is walked (its
// input slot then holds one round less ahead of other readers).
template <int V, bool kReadAhead = true, class Ring, class Walk>
__device__ __forceinline__ void chain_rounds(const WarpWalk& w, Ring& sm,
                                             Walk walk) {
  WalkRound<V, Ring::R> cur, nxt;
  if constexpr (kReadAhead) {
    take_round(w, sm, 0, cur);
    for (int r = 0; r < w.rounds; ++r) {
      if (r + 1 < w.rounds) take_round(w, sm, r + 1, nxt);
      walk(r, cur);
      cur = nxt;
    }
  } else {
    for (int r = 0; r < w.rounds; ++r) {
      take_round(w, sm, r, cur);
      walk(r, cur);
    }
  }
}

// x / s correctly rounded (the bits of div.rn.f32) for finite x >= 0 and
// s >= kTiny, given r = 1 / s in double: the double product x * r is
// within 2^-52 of x / s relatively, and a quotient of two floats lies at
// least 2^-49 of itself (2^-174 where it is below 2^-126) from every
// midpoint between floats, so rounding the product to float rounds the
// quotient. The float division's fast path falls back to a subroutine for
// subnormal dividends and quotients, which the exp walks meet in every
// column; this has no slow path.
__device__ __forceinline__ float div_rn(float x, double r) {
  return __double2float_rn((double)x * r);
}

// The log walks are split over NC chain warps (kLogVC positions a lane,
// NC = ceil(T / (32 kLogVC))): chain warp c holds t = c * 32 VC + lane *
// VC + j. With one chain warp the neighbour comes from the next lane by a
// shuffle. With several, every column goes through the barrier exchange,
// the block walks' pattern on the chain warps alone: each position's
// value into a double-buffered shared row, named barrier 1 over the NC
// chain warps (the loader and the storer never wait on it), then the
// neighbours read back. A chain warp waits for the slowest one each
// column; on the card that costs less than the design before it, a
// one-way stream of (value, step) words between the warps, each read by
// a volatile load that spun until its step came (B=32 T=80 U=400: ~125 ns
// a column against the stream's ~170, see "the two-pass route's walks").
//
// The walk's rounds are long (kLogRound columns, in a ring of
// kLogInRounds input and kLogResRounds result rounds), so the chain warps
// wait on the ring's barriers once per kLogRound columns.
constexpr int kLogVC = 1;         // the log walks: positions a chain lane holds
constexpr int kLogRound = 16;     // their columns a round
constexpr int kLogInRounds = 3;   // their input ring
constexpr int kLogResRounds = 2;  // their result ring
constexpr int kMaxChains = 4;     // 128 / 32

template <int Vio, typename St = float>
using LogRing =
    WalkRing<Vio, kLogRound, 1, kLogInRounds, kLogResRounds, St>;

// The log walk's shared memory: the ring (input rows of 32 Vio values in
// the lattice's storage type St, the loader's and storer's lane layout;
// float result rows) and the barrier exchange's two rows.
template <int Vio, typename St = float> struct BidirLogSmem {
  LogRing<Vio, St> ring;
  float row[2][32 * kMaxChains + 1];
};

// Named barrier 1 over the NC chain warps: the barrier exchange.
template <int NC>
__device__ __forceinline__ void chain_bar() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * NC) : "memory");
}

// alpha_walk's chain on chain warp c of NC: alpha_0 = t == 0 ? lf_0 : NEG,
// then per column u
//   stay = alpha + le_{u-1};  moved = shift_down(alpha + ls_{u-1}), NEG
//   into t = 0;  alpha = lf_u + lae(stay, moved).
template <int V, int NC, int Vio, typename St>
__device__ void log_alpha_chain(const WarpWalk& w,
                                BidirLogSmem<Vio, St>& sm) {
  constexpr int R = kLogRound;
  float alpha[V], le_prev[V], ls_prev[V];
  const float none[1] = {0.0f};
#pragma unroll
  for (int j = 0; j < V; ++j) alpha[j] = le_prev[j] = ls_prev[j] = kNeg;
  chain_rounds<V>(w, sm.ring, [&](int r, const WalkRound<V, R>& d) {
    float a[R][V];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int s = r * R + k;
      float mv[V], moved[V];
#pragma unroll
      for (int j = 0; j < V; ++j) mv[j] = alpha[j] + ls_prev[j];
      if constexpr (NC > 1) {
        float* row = sm.row[s & 1];  // row[t + 1]: the value at t
#pragma unroll
        for (int j = 0; j < V; ++j) row[w.t0 + j + 1] = mv[j];
        chain_bar<NC>();
#pragma unroll
        for (int j = 0; j < V; ++j)
          moved[j] = w.t0 + j == 0 ? kNeg : row[w.t0 + j];
      } else {
        const float edge = __shfl_up_sync(0xffffffffu, mv[V - 1], 1);
#pragma unroll
        for (int j = 0; j < V; ++j)
          moved[j] = j == 0 ? (w.lane == 0 ? kNeg : edge) : mv[j - 1];
      }
      const bool first = k == 0 && r == 0;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float x = d.f[k][j] + lae(alpha[j] + le_prev[j], moved[j]);
        alpha[j] = first ? (w.t0 + j == 0 ? d.f[k][j] : kNeg) : x;
        a[k][j] = alpha[j];
        le_prev[j] = d.e[k][j];
        ls_prev[j] = d.s[k][j];
      }
    }
    give_round(w, sm.ring, r, a, none);
  });
}

// beta_walk's chain on chain warp c of NC, descending: per column u
//   cont = lf_{u+1} + beta;  up = shift_up(cont), NEG from t >= T;
//   beta = u == U_b - 1 ? (t == T_b - 1 ? le_u : NEG)
//                       : lae(le_u + cont, ls_u + up)
// from beta = lf_{U} = NEG (also lattice_backward_grads' beta recursion,
// cell for cell: there the posterior warps read the input slots too, so
// the chain reads no round ahead, kReadAhead false).
template <int V, int NC, int Vio, typename St, bool kReadAhead = true>
__device__ void log_beta_chain(const WarpWalk& w, BidirLogSmem<Vio, St>& sm,
                               int in_len, int out_len) {
  constexpr int R = kLogRound;
  float beta[V], lf_next[V];
  const float none[1] = {0.0f};
#pragma unroll
  for (int j = 0; j < V; ++j) beta[j] = lf_next[j] = kNeg;
  chain_rounds<V, kReadAhead>(w, sm.ring, [&](int r,
                                              const WalkRound<V, R>& d) {
    float b[R][V];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int s = r * R + k;
      const bool reset = round_column<true, R>(w, r, k) == out_len - 1;
      float cont[V], upv[V];
#pragma unroll
      for (int j = 0; j < V; ++j) cont[j] = lf_next[j] + beta[j];
      if constexpr (NC > 1) {
        float* row = sm.row[s & 1];  // row[t]: the value at t
#pragma unroll
        for (int j = 0; j < V; ++j) row[w.t0 + j] = cont[j];
        chain_bar<NC>();
#pragma unroll
        for (int j = 0; j < V; ++j) upv[j] = row[w.t0 + j + 1];
      } else {
        float above = __shfl_down_sync(0xffffffffu, cont[0], 1);
        if (w.lane == 31) above = kNeg;
#pragma unroll
        for (int j = 0; j < V; ++j) upv[j] = j + 1 < V ? cont[j + 1] : above;
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float up = upv[j];
        if (w.t0 + j + 1 >= w.T) up = kNeg;
        const float x = lae(d.e[k][j] + cont[j], d.s[k][j] + up);
        beta[j] = reset ? (w.t0 + j == in_len - 1 ? d.e[k][j] : kNeg) : x;
        b[k][j] = beta[j];
        lf_next[j] = d.f[k][j];
      }
    }
    give_round(w, sm.ring, r, b, none);
  });
}

// lattice_bidir's storer: round r's alphas or betas (columns in the walk).
template <class Ring, bool kVec, bool kBack>
__device__ void log_storer(const WarpWalk& w, Ring& sm,
                           float* __restrict__ out) {
  constexpr int V = Ring::V, R = Ring::R;
  for (int r = 0; r < w.rounds; ++r) {
    float x[R][V], none[1];
    read_round(w, sm, r, x, none);
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int u = round_column<kBack, R>(w, r, k);
      if ((unsigned)u < (unsigned)w.U)
        store_cells<V, kVec>(w, out + u * w.col, x[k]);
    }
  }
}

// A block of a loader, NC chain warps and a storer per example
// (blockIdx.x) and direction: backward where blockIdx.y + dir0 == 1
// (lattice_bidir: gridDim.y = 2, dir0 = 0; lattice_forward_alphas the
// forward walks alone, dir0 = 0, and a bfloat16 lattice St only those;
// lattice_backward_betas the backward walks alone, dir0 = 1); the loader
// and the storer hold Vio positions a lane, a chain lane VC; dynamic
// shared memory: BidirLogSmem<Vio, St>.
template <int VC, int NC, int Vio, bool kVec, typename St = float>
__global__ void __launch_bounds__(32 * (NC + 2))
    bidir_warp_kernel(int dir0, int B, int T, int U,
                      const St* __restrict__ le,
                      const St* __restrict__ ls, const St* __restrict__ lf,
                      const int* __restrict__ il, const int* __restrict__ ol,
                      float* __restrict__ alphas, float* __restrict__ betas) {
  using Smem = BidirLogSmem<Vio, St>;
  using Ring = LogRing<Vio, St>;
  extern __shared__ float4 walk_smem[];
  Smem& sm = *reinterpret_cast<Smem*>(walk_smem);
  const int b = blockIdx.x, warp = threadIdx.x / 32;
  const bool back = sizeof(St) == 4 && blockIdx.y + dir0 == 1;
  init_ring(sm.ring, 1, NC);
  const int top = U - kLogRound;
  if (warp == 0 || warp == NC + 1) {
    const WarpWalk w = make_walk(B, T, U, Vio, kLogRound, top);
    const int eb = b * T + w.t0;
    if (warp == 0) {
      if (back)
        walk_loader<Ring, kVec, true>(w, sm.ring, le + eb, ls + eb, lf + eb);
      else
        walk_loader<Ring, kVec, false>(w, sm.ring, le + eb, ls + eb,
                                       lf + eb);
    } else {
      if (back)
        log_storer<Ring, kVec, true>(w, sm.ring, betas + eb);
      else
        log_storer<Ring, kVec, false>(w, sm.ring, alphas + eb);
    }
  } else {
    const int c = warp - 1;
    const WarpWalk w = make_walk(B, T, U, VC, kLogRound, top, c * 32 * VC);
    if (back)
      log_beta_chain<VC, NC, Vio, St>(w, sm, il[b], ol[b]);
    else
      log_alpha_chain<VC, NC, Vio, St>(w, sm);
  }
}

template <int VC, int NC, int Vio, bool kVec, typename St>
cudaError_t launch_log_walk(int dir0, int dirs, int B, int T, int U,
                            const St* le, const St* ls, const St* lf,
                            const int* il, const int* ol, float* alphas,
                            float* betas, cudaStream_t s) {
  static size_t opted = 0;
  constexpr size_t smem = sizeof(BidirLogSmem<Vio, St>);
  const auto kern = bidir_warp_kernel<VC, NC, Vio, kVec, St>;
  cudaError_t e = opt_in(kern, smem, &opted);
  if (e != cudaSuccess) return e;
  kern<<<dim3(B, dirs), 32 * (NC + 2), smem, s>>>(
      dir0, B, T, U, le, ls, lf, il, ol, alphas, betas);
  return cudaGetLastError();
}

// The chain warps a log walk may take with rows of 32 Vio positions (T in
// (16 Vio, 32 Vio], or up to 32 at Vio = 1) at VC positions a lane: from
// Vio / (2 VC) + 1 to Vio / VC.
template <int NC, int VC, int Vio>
constexpr bool log_chains() {
  return NC >= Vio / (2 * VC) + 1 && NC <= Vio / VC;
}

// The log walks (dir0 0, dirs 2: lattice_bidir; dirs 1: one direction
// alone, forward at dir0 0 (lattice_forward_alphas), backward at dir0 1
// (lattice_backward_betas)) for rows of 32 Vio positions: kLogVC
// positions a chain lane (at most Vio), NC = ceil(T / (32 VC)) chain
// warps.
template <int Vio, bool kVec, typename St>
cudaError_t launch_log_walks(int dir0, int dirs, int B, int T, int U,
                             const St* le, const St* ls, const St* lf,
                             const int* il, const int* ol, float* alphas,
                             float* betas, cudaStream_t s) {
  constexpr int VC = kLogVC < Vio ? kLogVC : Vio;
#define SSNT_LOG_ARGS dir0, dirs, B, T, U, le, ls, lf, il, ol, alphas, betas, \
                      s
  switch ((T + 32 * VC - 1) / (32 * VC)) {
    case 1:
      if constexpr (log_chains<1, VC, Vio>())
        return launch_log_walk<VC, 1, Vio, kVec, St>(SSNT_LOG_ARGS);
      break;
    case 2:
      if constexpr (log_chains<2, VC, Vio>())
        return launch_log_walk<VC, 2, Vio, kVec, St>(SSNT_LOG_ARGS);
      break;
    case 3:
      if constexpr (log_chains<3, VC, Vio>())
        return launch_log_walk<VC, 3, Vio, kVec, St>(SSNT_LOG_ARGS);
      break;
    case 4:
      if constexpr (log_chains<4, VC, Vio>())
        return launch_log_walk<VC, 4, Vio, kVec, St>(SSNT_LOG_ARGS);
      break;
  }
#undef SSNT_LOG_ARGS
  return cudaErrorInvalidValue;
}

// lattice_bidir_exp's loader (warp j0 of L): rounds kExpAhead ahead by
// cp.async into their slots, then round r's values, once its copies have
// landed, replaced by their expf in place, and the slot's full barrier
// arrived on.
template <class Ring, bool kVec, bool kBack, int L>
__device__ void exp_loader(const WarpWalk& w, Ring& sm, int j0,
                           const float* __restrict__ le,
                           const float* __restrict__ ls,
                           const float* __restrict__ lf) {
  constexpr int V = Ring::V;
  auto issue = [&](int r) {
    if (r < w.rounds) {
      if (r >= Ring::NIn)
        ssnt_tma::mbar_wait(&sm.in_empty[r % Ring::NIn],
                            (r / Ring::NIn + 1) & 1);
      stage_round<Ring, kVec, kBack, L>(w, sm, r, j0, le, ls, lf);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  for (int r = 0; r < kExpAhead; ++r) issue(r);
  for (int r = 0; r < w.rounds; ++r) {
    issue(r + kExpAhead);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kExpAhead) : "memory");
    const int slot = r % Ring::NIn;
#pragma unroll(kExpUnroll)
    for (int j = 0; j < Ring::R; ++j) {
      if (j % L != j0) continue;
#pragma unroll
      for (int row = 0; row < 3; ++row) {
        float* p = sm.in[slot][j][row] + w.t0;
        if constexpr (kVec) {
          if (w.live) {
            float x[V];
            load_lane<V>(p, x);
#pragma unroll
            for (int i = 0; i < V; ++i) x[i] = expf(x[i]);
            store_lane<V>(p, x);
          }
        } else {
#pragma unroll
          for (int i = 0; i < V; ++i)
            if (w.t0 + i < w.T) p[i] = expf(p[i]);
        }
      }
    }
    mbar_arrive(&sm.in_full[slot]);
  }
}

// exp_alpha_walk's chain: per column u
//   q = p * e_le_{u-1} + shift0_down(p * e_ls_{u-1})
//   p_raw = (u == 0 ? [t == 0] : q) * e_lf_u;  s = max(rowmax, TINY)
//   p = p_raw / s
// p_raw and s to the storer.
template <int V, bool kVec>
__device__ void exp_alpha_chain(const WarpWalk& w, BidirExpRing<V>& sm) {
  constexpr int R = kBidirRound;
  float p[V], e_le_prev[V], e_ls_prev[V];
#pragma unroll
  for (int j = 0; j < V; ++j) p[j] = e_le_prev[j] = e_ls_prev[j] = 0.0f;
  chain_rounds<V>(w, sm, [&](int r, const WalkRound<V, R>& d) {
    float x[R][V], norm[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      float sp[V];
#pragma unroll
      for (int j = 0; j < V; ++j) sp[j] = p[j] * e_ls_prev[j];
      const float edge = __shfl_up_sync(0xffffffffu, sp[V - 1], 1);
      const bool first = k == 0 && r == 0;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float q = p[j] * e_le_prev[j] +
                        (j == 0 ? (w.lane == 0 ? 0.0f : edge) : sp[j - 1]);
        x[k][j] = (first ? (w.t0 + j == 0 ? 1.0f : 0.0f) : q) * d.f[k][j];
      }
      norm[k] = warp_max<V, kVec>(w, x[k]);
      const double rn = 1.0 / (double)norm[k];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        p[j] = div_rn(x[k][j], rn);
        e_le_prev[j] = d.e[k][j];
        e_ls_prev[j] = d.s[k][j];
      }
    }
    give_round(w, sm, r, x, norm);
  });
}

// exp_beta_walk's chain, descending: per column u
//   c = b * e_lf_{u+1};  b_raw = e_le_u * c + e_ls_u * shift0_up(c)
//   at u == U_b - 1: b_raw = [t == T_b - 1] e_le_u
//   s = max(rowmax, TINY);  b = b_raw / s
// b_raw and s to the storer.
template <int V, bool kVec>
__device__ void exp_beta_chain(const WarpWalk& w, BidirExpRing<V>& sm,
                               int in_len, int out_len) {
  constexpr int R = kBidirRound;
  float field[V], e_lf_next[V];
#pragma unroll
  for (int j = 0; j < V; ++j) field[j] = e_lf_next[j] = 0.0f;
  chain_rounds<V>(w, sm, [&](int r, const WalkRound<V, R>& d) {
    float x[R][V], norm[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const bool reset = round_column<true, R>(w, r, k) == out_len - 1;
      float c[V];
#pragma unroll
      for (int j = 0; j < V; ++j) c[j] = field[j] * e_lf_next[j];
      const float above = __shfl_down_sync(0xffffffffu, c[0], 1);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float nb = j + 1 < V ? c[j + 1] : above;
        if (kVec ? j + 1 == V && w.t0 + V >= w.T : w.t0 + j + 1 >= w.T)
          nb = 0.0f;
        const float y = d.e[k][j] * c[j] + d.s[k][j] * nb;
        x[k][j] = reset ? (w.t0 + j == in_len - 1 ? d.e[k][j] : 0.0f) : y;
      }
      norm[k] = warp_max<V, kVec>(w, x[k]);
      const double rn = 1.0 / (double)norm[k];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        field[j] = div_rn(x[k][j], rn);
        e_lf_next[j] = d.f[k][j];
      }
    }
    give_round(w, sm, r, x, norm);
  });
}

// lattice_bidir_exp's storer: per column in the walk, [backward: n = 0 at
// u == U_b - 1]; out_u = log(raw) + m;  m += log(s). It reads a column's
// row from the result slot as it stores it (a loop of kExpUnroll columns
// of code), and frees the slot after the round.
template <int V, bool kVec, bool kBack>
__device__ void exp_storer(const WarpWalk& w, BidirExpRing<V>& sm,
                           int out_len, float* __restrict__ out) {
  constexpr int NRes = BidirExpRing<V>::NRes;
  float acc = 0.0f;
  for (int r = 0; r < w.rounds; ++r) {
    const int slot = r % NRes;
    ssnt_tma::mbar_wait(&sm.res_full[slot], (r / NRes) & 1);
#pragma unroll(kExpUnroll)
    for (int k = 0; k < kBidirRound; ++k) {
      const int u = round_column<kBack, kBidirRound>(w, r, k);
      float x[V];
      load_lane<V>(sm.res[slot][k] + w.t0, x);
      const float nrm = sm.norm[slot][k];
      if ((unsigned)u < (unsigned)w.U) {
        if (kBack && u == out_len - 1) acc = 0.0f;
        float y[V];
#pragma unroll
        for (int j = 0; j < V; ++j) y[j] = logf(x[j]) + acc;
        store_cells<V, kVec>(w, out + u * w.col, y);
        acc = acc + logf(nrm);
      }
    }
    mbar_arrive(&sm.res_empty[slot]);
  }
}

// A block of L loader warps, a chain and a storer warp per example and
// direction; dynamic shared memory: BidirExpRing<V>.
template <int V, bool kVec, int L>
__global__ void __launch_bounds__(32 * (L + 2))
    bidir_exp_warp_kernel(int B, int T, int U, const float* __restrict__ le,
                          const float* __restrict__ ls,
                          const float* __restrict__ lf,
                          const int* __restrict__ il,
                          const int* __restrict__ ol,
                          float* __restrict__ alphas,
                          float* __restrict__ betas) {
  using Ring = BidirExpRing<V>;
  extern __shared__ float4 walk_smem[];
  Ring& sm = *reinterpret_cast<Ring*>(walk_smem);
  const int b = blockIdx.x, warp = threadIdx.x / 32;
  const bool back = blockIdx.y == 1;
  const WarpWalk w = make_walk(B, T, U, V, kBidirRound, U - kBidirRound);
  init_ring(sm, L);
  const int eb = b * T + w.t0;
  if (warp < L) {
    if (back)
      exp_loader<Ring, kVec, true, L>(w, sm, warp, le + eb, ls + eb,
                                      lf + eb);
    else
      exp_loader<Ring, kVec, false, L>(w, sm, warp, le + eb, ls + eb,
                                       lf + eb);
  } else if (warp == L) {
    if (back)
      exp_beta_chain<V, kVec>(w, sm, il[b], ol[b]);
    else
      exp_alpha_chain<V, kVec>(w, sm);
  } else {
    if (back)
      exp_storer<V, kVec, true>(w, sm, ol[b], betas + eb);
    else
      exp_storer<V, kVec, false>(w, sm, 0, alphas + eb);
  }
}

template <int V, bool kVec>
cudaError_t launch_bidir_warp(bool exp_domain, int B, int T, int U,
                              const float* le, const float* ls,
                              const float* lf, const int* il, const int* ol,
                              float* alphas, float* betas, cudaStream_t s) {
  if (exp_domain) {
    // kExpLoaders loader warps where every block has an SM of its own (the
    // exps set the pace); one where blocks share SMs (a second loader's
    // issue slots then slow the other blocks' warps).
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    constexpr size_t smem = sizeof(BidirExpRing<V>);
    if (2 * B <= sms && kExpLoaders > 1) {
      static size_t opted = 0;
      constexpr int L = kExpLoaders;
      e = opt_in(bidir_exp_warp_kernel<V, kVec, L>, smem, &opted);
      if (e != cudaSuccess) return e;
      bidir_exp_warp_kernel<V, kVec, L><<<dim3(B, 2), 32 * (L + 2), smem, s>>>(
          B, T, U, le, ls, lf, il, ol, alphas, betas);
    } else {
      static size_t opted = 0;
      e = opt_in(bidir_exp_warp_kernel<V, kVec, 1>, smem, &opted);
      if (e != cudaSuccess) return e;
      bidir_exp_warp_kernel<V, kVec, 1><<<dim3(B, 2), 96, smem, s>>>(
          B, T, U, le, ls, lf, il, ol, alphas, betas);
    }
    return cudaGetLastError();
  }
  return launch_log_walks<V, kVec, float>(0, 2, B, T, U, le, ls, lf, il, ol,
                                          alphas, betas, s);
}

// The bidirectional warp walks with rows of 32 V positions, V = ceil(T /
// 32) rounded up to 1, 2 or 4, with copies of 4V bytes a lane where T % V
// == 0 and every field is aligned to them.
cudaError_t launch_bidir_warps(bool exp_domain, int B, int T, int U,
                               const float* le, const float* ls,
                               const float* lf, const int* il,
                               const int* ol, float* alphas, float* betas,
                               cudaStream_t s) {
  const uintptr_t bits = (uintptr_t)le | (uintptr_t)ls | (uintptr_t)lf |
                         (uintptr_t)alphas | (uintptr_t)betas;
#define SSNT_BIDIR_ARGS exp_domain, B, T, U, le, ls, lf, il, ol, alphas, \
                        betas, s
  if (T <= 32) return launch_bidir_warp<1, true>(SSNT_BIDIR_ARGS);
  if (T <= 64)
    return bits % 8 == 0 && T % 2 == 0
               ? launch_bidir_warp<2, true>(SSNT_BIDIR_ARGS)
               : launch_bidir_warp<2, false>(SSNT_BIDIR_ARGS);
  return bits % 16 == 0 && T % 4 == 0
             ? launch_bidir_warp<4, true>(SSNT_BIDIR_ARGS)
             : launch_bidir_warp<4, false>(SSNT_BIDIR_ARGS);
#undef SSNT_BIDIR_ARGS
}

// ------------------------------------------- the two-pass route's walks
//
// lattice_forward_alphas (#1) and lattice_backward_grads (#5) for T <=
// kWarpMaxT, the route "plain" that grad_mode takes at B * pad128(T) >
// 8192 (the B=256 train step) and for every bfloat16-storage lattice:
//   - #1 is lattice_bidir's forward walk alone (bidir_warp_kernel with
//     gridDim.y = 1, dir0 = 0, rows in the lattice's storage type), so its
//     alphas are lattice_bidir's bit for bit (and #3, outside this route,
//     its backward walk alone, dir0 = 1);
//   - #5 is a block per example of a loader warp (lattice_bidir's, rows in
//     the storage type, rounds of kLogRound columns from u = U - 1 down),
//     ceil(T / 32) chain warps running log_beta_chain (lattice_bidir's beta
//     walk, cell for cell backward_grads_kernel's beta recursion) that hand
//     each column's betas to a result ring, and as many posterior warps
//     of one position a lane that form the three posteriors of each
//     column from beta_u, beta_{u+1}, lf_{u+1}, le_u, ls_u and alpha_u in
//     grads_walk's expressions and order, and store them.
// The chain stays one lae a column: the posteriors' three expf a cell and
// the stores run beside it on other warps. The posterior warps read each
// input slot after the chain, so the chain reads no round ahead and the
// ring holds one round for each of the loader, the chain and the
// posteriors; the alphas do not pass through the ring (with them its
// three rounds would not fit two blocks to an SM at B=256), a posterior
// lane loads its own one round ahead into registers.
//
// Both take the barrier exchange between their chain warps, as every log
// walk does. Measured (probe_grads.py, NVIDIA H100 80GB HBM3, 700 W; T=80,
// U=400, f32): #1 0.0499-0.0502 / 0.058-0.065 ms at B=32 / 256 (on the
// earlier stream of exchange words 0.0631 / 0.0777; the block walk 0.0566 /
// 0.063-0.070), ~125 ns a column at B=32, the stream's ~170; #5 0.074-0.080 /
// 0.114-0.117 ms (stream 0.079-0.086 / 0.124; block walk 0.132 / 0.140;
// bf16 B=256 0.118-0.123 against the block walk's 0.153-0.159), bit for
// bit. #5 without its posteriors' stores runs at its chain's pace (0.0505
// / 0.064 ms): the posteriors' ~75 instructions a column on three warps
// that share the SM's schedulers with the chain warps (and, at B=256, two
// blocks an SM) slow the chain. Posterior lanes of several positions set
// the pace instead (slower), rounds of 8 are no better.

// alpha_u at this posterior lane's position for round r's columns (0
// outside the walk).
__device__ __forceinline__ void load_alpha_round(const WarpWalk& w,
                                                 const float* __restrict__ al,
                                                 int r, float (&x)[kLogRound]) {
#pragma unroll
  for (int k = 0; k < kLogRound; ++k) {
    const int u = round_column<true, kLogRound>(w, r, k);
    const bool in_walk = (unsigned)u < (unsigned)w.U;
    x[k] = in_walk && w.t0 < w.T ? __ldg(al + u * w.col) : 0.0f;
  }
}

// #5's posterior warp at its position t = t0 (t_base + lane; lane 31 also
// holds the next warp's first position th, for the shift): per column u,
// descending,
//   cont = lf_{u+1} + beta_{u+1};  cont_shift_raw = cont at t + 1, NEG
//   from t + 1 >= T;  the emit and shift continuations reset at U_b - 1;
//   p_le, p_ls, p_lf = exp(min(alpha_u - logz + ..., 30)) on the valid
//   region, times neg_g, stored in St.
// beta_u from the chain's result slot, le_u, ls_u, lf_u from the input
// slot (both freed after the round), beta_{u+1} and lf_{u+1} carried.
template <int Vio, typename St>
__device__ void grads_posterior(const WarpWalk& w, LogRing<Vio, St>& sm,
                                int th, const float* __restrict__ al,
                                float lz, float neg_g, int in_len,
                                int out_len, St* __restrict__ d_le,
                                St* __restrict__ d_ls,
                                St* __restrict__ d_lf) {
  using Ring = LogRing<Vio, St>;
  constexpr int R = kLogRound;
  const int t = w.t0;
  const bool halo = w.lane == 31 && th < w.T;
  const bool is_last_t = t == in_len - 1;
  float beta_n = kNeg, lf_n = kNeg, hb = kNeg, hf = kNeg;
  float cal[R], nal[R];
  load_alpha_round(w, al, 0, cal);
  for (int r = 0; r < w.rounds; ++r) {
    const int si = r % Ring::NIn, sr = r % Ring::NRes;
    if (r + 1 < w.rounds) load_alpha_round(w, al, r + 1, nal);
    ssnt_tma::mbar_wait(&sm.in_full[si], (r / Ring::NIn) & 1);
    ssnt_tma::mbar_wait(&sm.res_full[sr], (r / Ring::NRes) & 1);
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int u = round_column<true, R>(w, r, k);
      const float be = sm.res[sr][k][t];
      const float e = f32(sm.in[si][k][0][t]);
      const float s = f32(sm.in[si][k][1][t]);
      const float f = f32(sm.in[si][k][2][t]);
      float hbu = kNeg, hfu = kNeg;
      if (halo) {
        hbu = sm.res[sr][k][th];
        hfu = f32(sm.in[si][k][2][th]);
      }
      const float cont = lf_n + beta_n;
      float cont_shift_raw = __shfl_down_sync(0xffffffffu, cont, 1);
      if (w.lane == 31) cont_shift_raw = hf + hb;
      if (t + 1 >= w.T) cont_shift_raw = kNeg;
      const bool is_last_u = u == out_len - 1;
      const bool valid = t < in_len && u < out_len;
      const float cont_emit = is_last_u ? (is_last_t ? 0.0f : kNeg) : cont;
      const float cont_shift = is_last_u ? kNeg : cont_shift_raw;
      const float anorm = cal[k] - lz;
      const float p_le =
          valid ? expf(fminf(anorm + e + cont_emit, 30.0f)) : 0.0f;
      const float p_ls =
          valid ? expf(fminf(anorm + s + cont_shift, 30.0f)) : 0.0f;
      const float p_lf = valid ? expf(fminf(anorm + be, 30.0f)) : 0.0f;
      if ((unsigned)u < (unsigned)w.U && t < w.T) {
        const int o = u * w.col;
        st(d_le, o, neg_g * p_le);
        st(d_ls, o, neg_g * p_ls);
        st(d_lf, o, neg_g * p_lf);
      }
      beta_n = be;
      lf_n = f;
      hb = hbu;
      hf = hfu;
    }
    mbar_arrive(&sm.in_empty[si]);
    mbar_arrive(&sm.res_empty[sr]);
#pragma unroll
    for (int k = 0; k < R; ++k) cal[k] = nal[k];
  }
}

// A block per example of a loader (warp 0), NC chain warps and NC
// posterior warps; dynamic shared memory: BidirLogSmem<Vio, St>.
template <typename St, int NC, int Vio, bool kVec>
__global__ void __launch_bounds__(32 * (1 + 2 * NC))
    grads_warp_kernel(int B, int T, int U, const St* __restrict__ le,
                      const St* __restrict__ ls, const St* __restrict__ lf,
                      const float* __restrict__ alphas,
                      const int* __restrict__ il, const int* __restrict__ ol,
                      const float* __restrict__ g,
                      const float* __restrict__ logz, St* __restrict__ d_le,
                      St* __restrict__ d_ls, St* __restrict__ d_lf) {
  using Smem = BidirLogSmem<Vio, St>;
  extern __shared__ float4 walk_smem[];
  Smem& sm = *reinterpret_cast<Smem*>(walk_smem);
  const int b = blockIdx.x, warp = threadIdx.x / 32;
  init_ring(sm.ring, 1, NC, NC, NC);
  const int top = U - kLogRound;
  if (warp == 0) {
    const WarpWalk w = make_walk(B, T, U, Vio, kLogRound, top);
    const int eb = b * T + w.t0;
    walk_loader<LogRing<Vio, St>, kVec, true>(w, sm.ring, le + eb, ls + eb,
                                              lf + eb);
  } else if (warp <= NC) {
    const int c = warp - 1;
    const WarpWalk w = make_walk(B, T, U, 1, kLogRound, top, c * 32);
    log_beta_chain<1, NC, Vio, St, false>(w, sm, il[b], ol[b]);
  } else {
    const int q = warp - 1 - NC;
    const WarpWalk w = make_walk(B, T, U, 1, kLogRound, top, q * 32);
    const int eb = b * T + w.t0;
    const float lz = logz[b];
    grads_posterior<Vio, St>(w, sm.ring, (q + 1) * 32, alphas + eb, lz,
                             lz <= kNeg / 2 ? 0.0f : -g[b], il[b], ol[b],
                             d_le + eb, d_ls + eb, d_lf + eb);
  }
}

template <typename St, int NC, int Vio, bool kVec>
cudaError_t launch_grads_walk(int B, int T, int U, const St* le,
                              const St* ls, const St* lf, const float* al,
                              const int* il, const int* ol, const float* g,
                              const float* lz, St* de, St* ds, St* df,
                              cudaStream_t s) {
  static size_t opted = 0;
  constexpr size_t smem = sizeof(BidirLogSmem<Vio, St>);
  const auto kern = grads_warp_kernel<St, NC, Vio, kVec>;
  cudaError_t e = opt_in(kern, smem, &opted);
  if (e != cudaSuccess) return e;
  kern<<<B, 32 * (1 + 2 * NC), smem, s>>>(B, T, U, le, ls, lf, al, il, ol, g,
                                          lz, de, ds, df);
  return cudaGetLastError();
}

// #5's warp walk for rows of 32 Vio positions: NC = ceil(T / 32) chain
// warps of one position a lane.
template <typename St, int Vio, bool kVec>
cudaError_t launch_grads_walks(int B, int T, int U, const St* le,
                               const St* ls, const St* lf, const float* al,
                               const int* il, const int* ol, const float* g,
                               const float* lz, St* de, St* ds, St* df,
                               cudaStream_t s) {
#define SSNT_GRADS_ARGS B, T, U, le, ls, lf, al, il, ol, g, lz, de, ds, df, s
  switch ((T + 31) / 32) {
    case 1:
      if constexpr (log_chains<1, 1, Vio>())
        return launch_grads_walk<St, 1, Vio, kVec>(SSNT_GRADS_ARGS);
      break;
    case 2:
      if constexpr (log_chains<2, 1, Vio>())
        return launch_grads_walk<St, 2, Vio, kVec>(SSNT_GRADS_ARGS);
      break;
    case 3:
      if constexpr (log_chains<3, 1, Vio>())
        return launch_grads_walk<St, 3, Vio, kVec>(SSNT_GRADS_ARGS);
      break;
    case 4:
      if constexpr (log_chains<4, 1, Vio>())
        return launch_grads_walk<St, 4, Vio, kVec>(SSNT_GRADS_ARGS);
      break;
  }
#undef SSNT_GRADS_ARGS
  return cudaErrorInvalidValue;
}

// Whether a warp walk's loader copies the V values of a row at a lane at
// once (cp.async of sizeof(St) V bytes where that is 4 bytes or more):
// T % V == 0 and the inputs (`in`, their addresses or'ed) aligned to them,
// and the float outputs (`out`, stored V at a time; 0 for none) to 4 V.
template <typename St, int V>
bool vec_rows(uintptr_t in, uintptr_t out, int T) {
  return in % (sizeof(St) * V) == 0 && out % (4 * V) == 0 && T % V == 0;
}

// One direction of the log walks alone, with rows of 32 V positions, V =
// ceil(T / 32) rounded up to 1, 2 or 4: the forward walks (back 0, #1:
// alphas to `out`; il / ol unused) or, float32 only, the backward walks
// (back 1, #3: betas to `out`).
template <typename St>
cudaError_t launch_one_way_warps(int back, int B, int T, int U, const St* le,
                                 const St* ls, const St* lf, const int* il,
                                 const int* ol, float* out, cudaStream_t s) {
  const uintptr_t in = (uintptr_t)le | (uintptr_t)ls | (uintptr_t)lf;
  float* alphas = back ? nullptr : out;
  float* betas = back ? out : nullptr;
#define SSNT_ONE_WAY_ARGS back, 1, B, T, U, le, ls, lf, il, ol, alphas, \
                          betas, s
  if (T <= 32)
    return vec_rows<St, 1>(in, (uintptr_t)out, T)
               ? launch_log_walks<1, true, St>(SSNT_ONE_WAY_ARGS)
               : launch_log_walks<1, false, St>(SSNT_ONE_WAY_ARGS);
  if (T <= 64)
    return vec_rows<St, 2>(in, (uintptr_t)out, T)
               ? launch_log_walks<2, true, St>(SSNT_ONE_WAY_ARGS)
               : launch_log_walks<2, false, St>(SSNT_ONE_WAY_ARGS);
  return vec_rows<St, 4>(in, (uintptr_t)out, T)
             ? launch_log_walks<4, true, St>(SSNT_ONE_WAY_ARGS)
             : launch_log_walks<4, false, St>(SSNT_ONE_WAY_ARGS);
#undef SSNT_ONE_WAY_ARGS
}

template <typename St>
cudaError_t launch_grads_warps(int B, int T, int U, const St* le,
                               const St* ls, const St* lf, const float* al,
                               const int* il, const int* ol, const float* g,
                               const float* lz, St* de, St* ds, St* df,
                               cudaStream_t s) {
  const uintptr_t in = (uintptr_t)le | (uintptr_t)ls | (uintptr_t)lf;
#define SSNT_GRADS_ARGS B, T, U, le, ls, lf, al, il, ol, g, lz, de, ds, df, s
  if (T <= 32)
    return vec_rows<St, 1>(in, 0, T)
               ? launch_grads_walks<St, 1, true>(SSNT_GRADS_ARGS)
               : launch_grads_walks<St, 1, false>(SSNT_GRADS_ARGS);
  if (T <= 64)
    return vec_rows<St, 2>(in, 0, T)
               ? launch_grads_walks<St, 2, true>(SSNT_GRADS_ARGS)
               : launch_grads_walks<St, 2, false>(SSNT_GRADS_ARGS);
  return vec_rows<St, 4>(in, 0, T)
             ? launch_grads_walks<St, 4, true>(SSNT_GRADS_ARGS)
             : launch_grads_walks<St, 4, false>(SSNT_GRADS_ARGS);
#undef SSNT_GRADS_ARGS
}

// ------------------------------------------------------- block launches

// A block walk's launch state: kernel<1>'s thread limit (asked once) and
// the dynamic shared memory each instance has opted into.
struct BlockLaunch {
  int p1_threads = -1;
  size_t opted[4] = {0, 0, 0, 0};
};

// Launches a block walk on `grid`: at one thread a position (k1) where its
// registers allow threads_for(T) threads, else at the least P of 2, 4, 8
// with ceil(T / P) <= kMaxBlock (k2, k4, k8); dynamic shared memory: the
// two rows of T + 1 floats and past them the cells that positions past T
// read (up to index T + 1 + threads * P).
template <class K1, class K2, class K4, class K8, class... Args>
cudaError_t launch_block_walk(BlockLaunch& st, K1 k1, K2 k2, K4 k4, K8 k8,
                              dim3 grid, int T, cudaStream_t s,
                              Args... args) {
  if (st.p1_threads < 0) st.p1_threads = max_threads(k1);
  int P = 1;
  if (threads_for(T) > st.p1_threads)
    P = T <= 2 * kMaxBlock ? 2 : T <= 4 * kMaxBlock ? 4 : 8;
  const int n = threads_for((T + P - 1) / P);
  const size_t smem = sizeof(float) * ((size_t)T + 2 + (size_t)n * P);
  cudaError_t e;
  switch (P) {
    case 1:
      e = opt_in(k1, smem, &st.opted[0]);
      if (e == cudaSuccess) k1<<<grid, n, smem, s>>>(args...);
      break;
    case 2:
      e = opt_in(k2, smem, &st.opted[1]);
      if (e == cudaSuccess) k2<<<grid, n, smem, s>>>(args...);
      break;
    case 4:
      e = opt_in(k4, smem, &st.opted[2]);
      if (e == cudaSuccess) k4<<<grid, n, smem, s>>>(args...);
      break;
    default:
      e = opt_in(k8, smem, &st.opted[3]);
      if (e == cudaSuccess) k8<<<grid, n, smem, s>>>(args...);
  }
  return e != cudaSuccess ? e : cudaGetLastError();
}

// The block walks of #1 and #5 (every T up to kMaxT; the warp walks take
// T <= kWarpMaxT on the main entries).
template <typename St>
cudaError_t forward_alphas_blocks(int B, int T, int U, const St* le,
                                  const St* ls, const St* lf, float* alphas,
                                  cudaStream_t s) {
  static BlockLaunch st;
  return launch_block_walk(
      st, forward_alphas_kernel<St>, forward_alphas_kernel_p<2, St>,
      forward_alphas_kernel_p<4, St>, forward_alphas_kernel_p<8, St>,
      dim3(B), T, s, B, T, U, le, ls, lf, alphas);
}

template <typename St>
cudaError_t backward_grads_blocks(int B, int T, int U, const St* le,
                                  const St* ls, const St* lf,
                                  const float* al, const int* il,
                                  const int* ol, const float* g,
                                  const float* lz, St* de, St* ds, St* df,
                                  cudaStream_t s) {
  static BlockLaunch st;
  return launch_block_walk(
      st, backward_grads_kernel<St>, backward_grads_kernel_p<2, St>,
      backward_grads_kernel_p<4, St>, backward_grads_kernel_p<8, St>,
      dim3(B), T, s, B, T, U, le, ls, lf, al, il, ol, g, lz, de, ds, df);
}

// The warp walks take 32-bit offsets.
bool warp_walk(int B, int T, int U) {
  return T <= kWarpMaxT && (size_t)U * B * T < (size_t{1} << 31);
}

bool bad_shape(int B, int T, int U) {
  return B < 0 || U < 0 || T < 1 || T > kMaxT ||
         (size_t)B * T > (size_t)INT_MAX;
}

// #1: the warp walk for T <= kWarpMaxT (block walk = 0), else (or with
// block walk = 1, which only chip_smoke.py and bench_fused.py ask for) the
// block walk.
int forward_alphas(int block_walk, int bf16, int B, int T, int U,
                   const void* le, const void* ls, const void* lf,
                   void* alphas, void* stream) {
  if (bad_shape(B, T, U)) return (int)cudaErrorInvalidValue;
  if (B == 0 || U == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  float* a = (float*)alphas;
  const bool warps = !block_walk && warp_walk(B, T, U);
  if (bf16) {
    using S = __nv_bfloat16;
    const S *e = (const S*)le, *h = (const S*)ls, *f = (const S*)lf;
    return (int)(warps ? launch_one_way_warps<S>(0, B, T, U, e, h, f,
                                                 nullptr, nullptr, a, s)
                       : forward_alphas_blocks<S>(B, T, U, e, h, f, a, s));
  }
  const float *e = (const float*)le, *h = (const float*)ls,
              *f = (const float*)lf;
  return (int)(warps ? launch_one_way_warps<float>(0, B, T, U, e, h, f,
                                                   nullptr, nullptr, a, s)
                     : forward_alphas_blocks<float>(B, T, U, e, h, f, a, s));
}

// #5, as forward_alphas.
int backward_grads(int block_walk, int bf16, int B, int T, int U,
                   const void* le, const void* ls, const void* lf,
                   const void* alphas, const void* il, const void* ol,
                   const void* g, const void* logz, void* d_le, void* d_ls,
                   void* d_lf, void* stream) {
  if (bad_shape(B, T, U)) return (int)cudaErrorInvalidValue;
  if (B == 0 || U == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const float* al = (const float*)alphas;
  const int* in_len = (const int*)il;
  const int* out_len = (const int*)ol;
  const float* gg = (const float*)g;
  const float* lz = (const float*)logz;
  const bool warps = !block_walk && warp_walk(B, T, U);
  if (bf16) {
    using S = __nv_bfloat16;
    const S *e = (const S*)le, *h = (const S*)ls, *f = (const S*)lf;
    S *de = (S*)d_le, *dh = (S*)d_ls, *df = (S*)d_lf;
    return (int)(warps ? launch_grads_warps<S>(B, T, U, e, h, f, al, in_len,
                                               out_len, gg, lz, de, dh, df, s)
                       : backward_grads_blocks<S>(B, T, U, e, h, f, al,
                                                  in_len, out_len, gg, lz, de,
                                                  dh, df, s));
  }
  const float *e = (const float*)le, *h = (const float*)ls,
              *f = (const float*)lf;
  float *de = (float*)d_le, *dh = (float*)d_ls, *df = (float*)d_lf;
  return (int)(warps ? launch_grads_warps<float>(B, T, U, e, h, f, al,
                                                 in_len, out_len, gg, lz, de,
                                                 dh, df, s)
                     : backward_grads_blocks<float>(B, T, U, e, h, f, al,
                                                    in_len, out_len, gg, lz,
                                                    de, dh, df, s));
}

// #3: the backward walks alone (lattice_bidir's beta direction, so its
// betas bit for bit) for T <= kWarpMaxT (block walk = 0), else (or with
// block walk = 1, for chip_smoke.py, bench_fused.py and the probes) the
// block walk.
int backward_betas(int block_walk, int B, int T, int U, const void* le,
                   const void* ls, const void* lf, const void* il,
                   const void* ol, void* betas, void* stream) {
  if (bad_shape(B, T, U)) return (int)cudaErrorInvalidValue;
  if (B == 0 || U == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const float *e = (const float*)le, *h = (const float*)ls,
              *f = (const float*)lf;
  const int *in_len = (const int*)il, *out_len = (const int*)ol;
  float* bt = (float*)betas;
  if (!block_walk && warp_walk(B, T, U))
    return (int)launch_one_way_warps<float>(1, B, T, U, e, h, f, in_len,
                                            out_len, bt, s);
  static BlockLaunch st;
  return (int)launch_block_walk(st, backward_betas_kernel,
                                backward_betas_kernel_p<2>,
                                backward_betas_kernel_p<4>,
                                backward_betas_kernel_p<8>, dim3(B), T, s, B,
                                T, U, e, h, f, in_len, out_len, bt);
}

}  // namespace

extern "C" {

int ssnt_lattice_max_t() { return kMaxT; }

int ssnt_lattice_bidir(int B, int T, int U, const void* le, const void* ls,
                       const void* lf, const void* il, const void* ol,
                       void* alphas, void* betas, void* stream) {
  if (bad_shape(B, T, U)) return (int)cudaErrorInvalidValue;
  if (B == 0 || U == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const float *e = (const float*)le, *h = (const float*)ls,
              *f = (const float*)lf;
  const int *in_len = (const int*)il, *out_len = (const int*)ol;
  float *a = (float*)alphas, *bt = (float*)betas;
  if (warp_walk(B, T, U))
    return (int)launch_bidir_warps(false, B, T, U, e, h, f, in_len, out_len,
                                   a, bt, s);
  static BlockLaunch st;
  return (int)launch_block_walk(st, bidir_kernel, bidir_kernel_p<2>,
                                bidir_kernel_p<4>, bidir_kernel_p<8>,
                                dim3(B, 2), T, s, B, T, U, e, h, f, in_len,
                                out_len, a, bt);
}

int ssnt_lattice_forward_alphas(int bf16, int B, int T, int U, const void* le,
                                const void* ls, const void* lf, void* alphas,
                                void* stream) {
  return forward_alphas(0, bf16, B, T, U, le, ls, lf, alphas, stream);
}

int ssnt_lattice_forward_alphas_block(int bf16, int B, int T, int U,
                                      const void* le, const void* ls,
                                      const void* lf, void* alphas,
                                      void* stream) {
  return forward_alphas(1, bf16, B, T, U, le, ls, lf, alphas, stream);
}

int ssnt_lattice_backward_grads(int bf16, int B, int T, int U, const void* le,
                                const void* ls, const void* lf,
                                const void* alphas, const void* il,
                                const void* ol, const void* g,
                                const void* logz, void* d_le, void* d_ls,
                                void* d_lf, void* stream) {
  return backward_grads(0, bf16, B, T, U, le, ls, lf, alphas, il, ol, g,
                        logz, d_le, d_ls, d_lf, stream);
}

int ssnt_lattice_backward_grads_block(int bf16, int B, int T, int U,
                                      const void* le, const void* ls,
                                      const void* lf, const void* alphas,
                                      const void* il, const void* ol,
                                      const void* g, const void* logz,
                                      void* d_le, void* d_ls, void* d_lf,
                                      void* stream) {
  return backward_grads(1, bf16, B, T, U, le, ls, lf, alphas, il, ol, g,
                        logz, d_le, d_ls, d_lf, stream);
}

int ssnt_lattice_backward_betas(int B, int T, int U, const void* le,
                                const void* ls, const void* lf,
                                const void* il, const void* ol, void* betas,
                                void* stream) {
  return backward_betas(0, B, T, U, le, ls, lf, il, ol, betas, stream);
}

int ssnt_lattice_backward_betas_block(int B, int T, int U, const void* le,
                                      const void* ls, const void* lf,
                                      const void* il, const void* ol,
                                      void* betas, void* stream) {
  return backward_betas(1, B, T, U, le, ls, lf, il, ol, betas, stream);
}

int ssnt_lattice_bidir_exp(int B, int T, int U, const void* le,
                           const void* ls, const void* lf, const void* il,
                           const void* ol, void* alphas, void* betas,
                           void* stream) {
  if (bad_shape(B, T, U)) return (int)cudaErrorInvalidValue;
  if (B == 0 || U == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const float *e = (const float*)le, *h = (const float*)ls,
              *f = (const float*)lf;
  const int *in_len = (const int*)il, *out_len = (const int*)ol;
  float *a = (float*)alphas, *bt = (float*)betas;
  if (warp_walk(B, T, U))
    return (int)launch_bidir_warps(true, B, T, U, e, h, f, in_len, out_len,
                                   a, bt, s);
  static BlockLaunch st;
  return (int)launch_block_walk(st, bidir_exp_kernel, bidir_exp_kernel_p<2>,
                                bidir_exp_kernel_p<4>, bidir_exp_kernel_p<8>,
                                dim3(B, 2), T, s, B, T, U, e, h, f, in_len,
                                out_len, a, bt);
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
  if (warp_walk(B, T, U))
    return (int)launch_expin_warps(B, T, U, e, h, f, m, in_len, out_len, q,
                                   r, mm, nn, s);
  static BlockLaunch st;
  return (int)launch_block_walk(st, expin_kernel, expin_kernel_p<2>,
                                expin_kernel_p<4>, expin_kernel_p<8>,
                                dim3(B, 2), T, s, B, T, U, e, h, f, m, in_len,
                                out_len, q, r, mm, nn);
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
