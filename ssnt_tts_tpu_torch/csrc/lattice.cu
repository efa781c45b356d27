// SSNT lattice forward-backward kernels for Hopper (sm_90a).
//
// Replace the TPU kernels of ssnt_tts_tpu/ops/lattice_pallas.py that the
// training loss runs (the log-domain path):
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
// Layout: every lattice tensor is (U, B, T) row-major, so one column of
// one example is T contiguous values. Lengths, g and logz are (B,).
//
// What bounds them on an H100: the dependency chain, not the card. The
// bytes bound (each input read once, each output written once, 3.35 TB/s)
// is 6.1 us for the bidirectional pass at B=32 T=80 U=400 and 39/68 us for
// forward/backward at B=256 (f32), but every column waits for the one
// before it: U dependent steps of a few adds, one exp and one log1p, and
// a neighbour exchange. Design: one thread block per example (per example
// and direction for lattice_bidir: the alpha and beta walks run on
// different SMs at once), one thread per source position t, the t-1 / t+1
// neighbour through a double-buffered shared-memory row with one barrier
// per column, and the next kAhead columns' inputs loaded into registers
// while the current ones are computed, so global-memory latency is off
// the chain. At B=32 this occupies 64 of 132 SMs with 3 warps each: it is
// latency-bound by construction, and a faster design (more columns per
// step, a packed or split walk) is later work. Measured by chip_smoke.py
// (device time, NVIDIA H100 80GB HBM3, 700 W power limit): lattice_bidir
// B=32 0.081 ms; forward alphas B=256 0.073 ms (bf16 0.070); backward
// gradients B=256 0.147 ms (bf16 0.174): 0.18-0.37 us per column.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kMaxT = 1024;  // one thread per source position
constexpr int kAhead = 8;    // columns loaded ahead of the chain

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

int threads_for(int T) { return ((T + 31) / 32) * 32; }

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

}  // extern "C"
