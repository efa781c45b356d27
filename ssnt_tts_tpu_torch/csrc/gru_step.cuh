// Model-step pieces shared by the fused decode steps (fused_class_step.cu,
// fused_v1_step.cu), so that their GRU cannot drift:
//   - loads and rounding to the compute dtype CT (float or bfloat16);
//   - the GRU cell over a block's W beams, in the rounding order of
//     models/stepmath.gru_step;
//   - a dense layer over the W beams in the rounding order of
//     layers.mm + bias (flax's low-precision Dense), with an optional
//     activation.
// Every dot accumulates in float32 with explicit fused multiply-adds, one
// thread per output column and WMAX register accumulators (one per beam);
// the beams' inputs are in shared memory, the weights stream from global
// memory (row-major (in, out), so neighbouring threads read neighbouring
// columns). Callers are built with -fmad=false: every other multiply and
// add rounds on its own.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ssnt_gru {

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

// GRU cell for W beams of one block: x_s (W, H) compute-dtype input
// values, hb_s (W, H) rnd(state), state (W, H) float32 rows (global);
// writes new_h (W, H) float32 into nh_s, and into dbg (global) unless it
// is null:
//   gi = rnd(rnd(x . wi) + bi), gh = rnd(rnd(state) . wh)
//   r, z = rnd(sigmoid(rnd(gi + gh))), n = rnd(tanh(rnd(gi_n +
//   rnd(r * rnd(gh_n + bhn))))), new_h = rnd(rnd(1-z) * n) + z*state.
// wi/wh are (H, 3H) packed [r|z|n], bi (3H), bhn (H), in CT.
template <typename CT, int WMAX>
__device__ __forceinline__ void gru_columns(
    const float* x_s, const float* hb_s, const float* state, const CT* wi,
    const CT* bi, const CT* wh, const CT* bhn, int W, int H, float* nh_s,
    float* dbg) {
  const int H3 = 3 * H;
  for (int k = threadIdx.x; k < H; k += blockDim.x) {
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
        const float st = state[(size_t)w * H + k];
        const float keep_n = rnd<CT>(__fmul_rn(rnd<CT>(__fsub_rn(1.0f, z)), n));
        const float nh = __fadd_rn(keep_n, __fmul_rn(z, st));
        nh_s[w * H + k] = nh;
        if (dbg) dbg[(size_t)w * H + k] = nh;
      }
    }
  }
}

enum Act { kLinear = 0, kRelu = 1, kTanh = 2 };

// out (W, N) = act(rnd(rnd(in . wt) + bias)) for W beams of one block:
// in_s (W, K) compute-dtype values in shared memory, wt (K, N) and bias
// (N) in CT. kRelu: max(x, 0) of the rounded sum; kTanh: rnd(tanh) at
// float32 (stepmath: tanh(x.float()).to(dtype)). out may be shared or
// global memory, with row stride ldo.
template <typename CT, int WMAX, int ACT>
__device__ __forceinline__ void dense_columns(
    const float* in_s, int K, const CT* wt, const CT* bias, int N, int W,
    float* out, int ldo) {
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float acc[WMAX];
#pragma unroll
    for (int w = 0; w < WMAX; ++w) acc[w] = 0.0f;
    for (int i = 0; i < K; ++i) {
      const float wv = ld(wt, (size_t)i * N + n);
#pragma unroll
      for (int w = 0; w < WMAX; ++w)
        if (w < W) acc[w] = __fmaf_rn(in_s[w * K + i], wv, acc[w]);
    }
    const float b = ld(bias, n);
#pragma unroll
    for (int w = 0; w < WMAX; ++w) {
      if (w < W) {
        float y = rnd<CT>(__fadd_rn(rnd<CT>(acc[w]), b));
        if (ACT == kRelu) y = y > 0.0f ? y : 0.0f;
        if (ACT == kTanh) y = rnd<CT>(tanhf(y));
        out[(size_t)w * ldo + n] = y;
      }
    }
  }
}

}  // namespace ssnt_gru
