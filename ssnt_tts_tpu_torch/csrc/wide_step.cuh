// The wide instances of the fused decode steps (fused_class_step.cu,
// fused_v1_step.cu) for a bfloat16 compute dtype: every beam of an
// utterance on the N side of one warpgroup product, one pass of the
// weights a step whatever the beam width.
//   - wgmma.mma_async m64nNk16 (bfloat16 in, float32 accumulators in the
//     warpgroup's registers): A = 64 output columns x 16 inputs of the
//     rank's weights, B = 16 inputs x N beams of activations, both read
//     from shared memory in wgmma's K-major canonical layout without
//     swizzle; N = the beams rounded up to a multiple of 8 (8 to 128), the
//     instruction shape Mma<N/8> picked at run time;
//   - the wide weight stream (WideStream), packed once per decode by
//     ops/beam_fused.pack_wide_dense / pack_wide_gru: for each cluster
//     rank, rounds of one or two 64-column m-tiles of a layer (warpgroup 0
//     takes the first, warpgroup 1 the second), a round's A tiles
//     input-tile-major with the two warpgroups' tiles of an input tile
//     side by side. A dense layer's m-tiles cover the rank's share of its
//     16-column tiles (gru_step.cuh's ownership), zero past the share and
//     past N; the GRU's rounds take, for each pair of 64-unit groups of the
//     rank's hidden units, the six gates in kGates' order;
//   - its ring (WideRing): slots of 16 or 32 KB filled by TMA bulk copies
//     on mbarriers as gru_step.cuh's Ring, a piece being as many of a
//     round's input tiles as a slot holds for its warpgroups;
//   - the GRU cell in registers: a warpgroup folds each gate round's
//     products into at most two held values a beam and unit (bfloat16
//     pairs: each is rounded to the compute dtype, so they are exact) in
//     stepmath.gru_step's rounding order, and ends with new_h in its
//     accumulators. Six gate tiles of 64 units x 128 beams would take 384
//     registers a thread, or 96 KB of shared memory a warpgroup.
// Callers are built with -fmad=false, as gru_step.cuh's.
//
// Layouts (bfloat16 values):
//   A tile (64 m x 16 k, 1024 values): (m, k) at ((m/8) 2 + k/8) 64 +
//     (m%8) 8 + k%8: core matrices of 8 rows x 16 bytes, the two k halves
//     128 bytes apart (the descriptor's leading byte offset), the 8-row
//     groups 256 bytes apart (its stride byte offset);
//   activations (N beams x Kp inputs, Kp = 16 KT; act_at): (n, k) at
//     ((n/8) Kp/8 + k/8) 64 + (n%8) 8 + k%8; input tile kt starts 256 kt
//     bytes in, leading offset 128, stride Kp * 16 bytes;
//   accumulators (m64nN; thread t of the warpgroup, warp w = t/32, lane
//     4g + q): d[4j + e] holds (row 16w + g + 8 (e/2), beam 8j + 2q + e%2).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "gru_step.cuh"

namespace ssnt_wide {

using ssnt_gru::cdiv;
using ssnt_gru::kCL;
using ssnt_gru::kMaxStages;
using ssnt_tma::bulk_copy;
using ssnt_tma::mbar_init;
using ssnt_tma::mbar_wait;
using ssnt_tma::smem_u32;
using bf16 = __nv_bfloat16;

constexpr int kWG = 128;         // threads of a warpgroup
constexpr int kAcc = 64;         // accumulators a thread at N = 128
constexpr int kTileA = 1024;     // values of an A tile (64 x 16)
constexpr int kMaxRounds = 24;   // rounds of a wide stream
// The GRU's gate rounds, by gru_step.cuh's gate index ([wi_r, wi_z, wi_n,
// wh_r, wh_z, wh_n]): r first, then n (which needs r), then z, so that a
// thread holds at most two values a beam and unit between rounds.
__host__ __device__ constexpr int gru_gate(int j) {
  return j == 0 ? 0 : j == 1 ? 3 : j == 2 ? 5 : j == 3 ? 2 : j == 4 ? 1 : 4;
}

// ------------------------------------------------------------ wgmma

__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving accumulator reads and writes across the
// asynchronous products.
__device__ __forceinline__ void acc_fence(float (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// A thread's generic-proxy writes of wgmma operands (activations, in this
// block or a peer) made visible to the async proxy; the barrier after it
// publishes them.
__device__ __forceinline__ void async_fence() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}

// d (64 x 8 N8) = A . B (scale 0) or d + A . B (scale 1).
template <int N8> struct Mma;

#define D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
template <> struct Mma<1> {
  static __device__ __forceinline__ void run(float (&d)[kAcc], uint64_t a,
                                             uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, "
        "%4, %5, p, 1, 1, 0, 0;\n}\n"
        : D4(0)
        : "l"(a), "l"(b), "r"(scale));
  }
};

template <> struct Mma<2> {
  static __device__ __forceinline__ void run(float (&d)[kAcc], uint64_t a,
                                             uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1, 0, 0;\n}\n"
        : D4(0), D4(4)
        : "l"(a), "l"(b), "r"(scale));
  }
};

template <> struct Mma<3> {
  static __device__ __forceinline__ void run(float (&d)[kAcc], uint64_t a,
                                             uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
        "%12, %13, p, 1, 1, 0, 0;\n}\n"
        : D4(0), D4(4), D4(8)
        : "l"(a), "l"(b), "r"(scale));
  }
};

template <> struct Mma<4> {
  static __device__ __forceinline__ void run(float (&d)[kAcc], uint64_t a,
                                             uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : D4(0), D4(4), D4(8), D4(12)
        : "l"(a), "l"(b), "r"(scale));
  }
};

template <> struct Mma<5> {
  static __device__ __forceinline__ void run(float (&d)[kAcc], uint64_t a,
                                             uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19}, "
        "%20, %21, p, 1, 1, 0, 0;\n}\n"
        : D4(0), D4(4), D4(8), D4(12), D4(16)
        : "l"(a), "l"(b), "r"(scale));
  }
};

template <> struct Mma<6> {
  static __device__ __forceinline__ void run(float (&d)[kAcc], uint64_t a,
                                             uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
        "%24, %25, p, 1, 1, 0, 0;\n}\n"
        : D4(0), D4(4), D4(8), D4(12), D4(16), D4(20)
        : "l"(a), "l"(b), "r"(scale));
  }
};

template <> struct Mma<7> {
  static __device__ __forceinline__ void run(float (&d)[kAcc], uint64_t a,
                                             uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %30, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n56k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
        "%27}, "
        "%28, %29, p, 1, 1, 0, 0;\n}\n"
        : D4(0), D4(4), D4(8), D4(12), D4(16), D4(20), D4(24)
        : "l"(a), "l"(b), "r"(scale));
  }
};

template <> struct Mma<8> {
  static __device__ __forceinline__ void run(float (&d)[kAcc], uint64_t a,
                                             uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
        "%27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : D4(0), D4(4), D4(8), D4(12), D4(16), D4(20), D4(24), D4(28)
        : "l"(a), "l"(b), "r"(scale));
  }
};

template <> struct Mma<9> {
  static __device__ __forceinline__ void run(float (&d)[kAcc], uint64_t a,
                                             uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
        "%27, %28, %29, %30, %31, %32, %33, %34, %35}, "
        "%36, %37, p, 1, 1, 0, 0;\n}\n"
        : D4(0), D4(4), D4(8), D4(12), D4(16), D4(20), D4(24), D4(28),
          D4(32)
        : "l"(a), "l"(b), "r"(scale));
  }
};

template <> struct Mma<10> {
  static __device__ __forceinline__ void run(float (&d)[kAcc], uint64_t a,
                                             uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
        "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
        "%40, %41, p, 1, 1, 0, 0;\n}\n"
        : D4(0), D4(4), D4(8), D4(12), D4(16), D4(20), D4(24), D4(28),
          D4(32), D4(36)
        : "l"(a), "l"(b), "r"(scale));
  }
};

template <> struct Mma<11> {
  static __device__ __forceinline__ void run(float (&d)[kAcc], uint64_t a,
                                             uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %46, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n88k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
        "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43}, "
        "%44, %45, p, 1, 1, 0, 0;\n}\n"
        : D4(0), D4(4), D4(8), D4(12), D4(16), D4(20), D4(24), D4(28),
          D4(32), D4(36), D4(40)
        : "l"(a), "l"(b), "r"(scale));
  }
};

template <> struct Mma<12> {
  static __device__ __forceinline__ void run(float (&d)[kAcc], uint64_t a,
                                             uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
        "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47}, "
        "%48, %49, p, 1, 1, 0, 0;\n}\n"
        : D4(0), D4(4), D4(8), D4(12), D4(16), D4(20), D4(24), D4(28),
          D4(32), D4(36), D4(40), D4(44)
        : "l"(a), "l"(b), "r"(scale));
  }
};

template <> struct Mma<13> {
  static __device__ __forceinline__ void run(float (&d)[kAcc], uint64_t a,
                                             uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %54, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n104k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
        "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51}, "
        "%52, %53, p, 1, 1, 0, 0;\n}\n"
        : D4(0), D4(4), D4(8), D4(12), D4(16), D4(20), D4(24), D4(28),
          D4(32), D4(36), D4(40), D4(44), D4(48)
        : "l"(a), "l"(b), "r"(scale));
  }
};

template <> struct Mma<14> {
  static __device__ __forceinline__ void run(float (&d)[kAcc], uint64_t a,
                                             uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %58, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
        "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
        "%53, %54, %55}, "
        "%56, %57, p, 1, 1, 0, 0;\n}\n"
        : D4(0), D4(4), D4(8), D4(12), D4(16), D4(20), D4(24), D4(28),
          D4(32), D4(36), D4(40), D4(44), D4(48), D4(52)
        : "l"(a), "l"(b), "r"(scale));
  }
};

template <> struct Mma<15> {
  static __device__ __forceinline__ void run(float (&d)[kAcc], uint64_t a,
                                             uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %62, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n120k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
        "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
        "%53, %54, %55, %56, %57, %58, %59}, "
        "%60, %61, p, 1, 1, 0, 0;\n}\n"
        : D4(0), D4(4), D4(8), D4(12), D4(16), D4(20), D4(24), D4(28),
          D4(32), D4(36), D4(40), D4(44), D4(48), D4(52), D4(56)
        : "l"(a), "l"(b), "r"(scale));
  }
};

template <> struct Mma<16> {
  static __device__ __forceinline__ void run(float (&d)[kAcc], uint64_t a,
                                             uint64_t b, int scale) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
        "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
        "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : D4(0), D4(4), D4(8), D4(12), D4(16), D4(20), D4(24), D4(28),
          D4(32), D4(36), D4(40), D4(44), D4(48), D4(52), D4(56), D4(60)
        : "l"(a), "l"(b), "r"(scale));
  }
};
#undef D4

// --------------------------------------------------------------- layout

__host__ __device__ __forceinline__ int act_at(int n, int k, int Kp) {
  return (((n >> 3) * (Kp >> 3) + (k >> 3)) << 6) + ((n & 7) << 3) + (k & 7);
}

// A rank's share of a layer of N outputs (its 16-column tiles,
// gru_step.cuh's ownership) and the 64-column m-tiles that cover it.
__host__ __device__ inline int share(int N) {
  return cdiv(cdiv(N, 16), kCL) * 16;
}
__host__ __device__ inline int mtiles(int N) { return cdiv(share(N), 64); }

// --------------------------------------------------------------- stream

// A rank's wide stream: round r has kt[r] input tiles for nwg[r] (1 or 2)
// warpgroups, its A tiles from tile0[r] on; cap A tiles a ring slot.
struct WideStream {
  int nr, cap, pieces, tiles;
  int tile0[kMaxRounds], kt[kMaxRounds], nwg[kMaxRounds];
};

inline void wide_round_add(WideStream& s, int K, int nwg) {
  const int r = s.nr++;
  s.kt[r] = cdiv(K, 16);
  s.nwg[r] = nwg;
  s.tile0[r] = s.tiles;
  s.tiles += s.kt[r] * nwg;
}

// Rounds over mt m-tiles of K inputs, two a round; false past kMaxRounds.
inline bool wide_dense(WideStream& s, int K, int mt) {
  for (int i = 0; i < mt; i += 2) {
    if (s.nr == kMaxRounds) return false;
    wide_round_add(s, K, mt - i < 2 ? mt - i : 2);
  }
  return true;
}

// The GRU of H units: for each pair of the rank's 64-unit groups, its six
// gate rounds (gru_gate's order).
inline bool wide_gru(WideStream& s, int H) {
  const int ug = mtiles(H);
  for (int p = 0; p < ug; p += 2)
    for (int j = 0; j < 6; ++j) {
      if (s.nr == kMaxRounds) return false;
      wide_round_add(s, H, ug - p < 2 ? ug - p : 2);
    }
  return true;
}

// Sets the slot size and the piece count that follows from it.
inline void wide_finish(WideStream& s, int chunk) {
  s.cap = chunk / (kTileA * (int)sizeof(bf16));
  s.pieces = 0;
  for (int r = 0; r < s.nr; ++r) s.pieces += cdiv(s.kt[r], s.cap / s.nwg[r]);
}

// The wide stream's ring: nst slots of st->cap A tiles, one mbarrier each;
// every thread walks the pieces in order, thread 0 issues the copies.
struct WideRing {
  bf16* slots;
  uint64_t* full;
  const bf16* src;  // this rank's stream in global memory
  const WideStream* st;
  int nst, piece;

  // Piece p's first A tile in the stream and its tile count.
  __device__ void locate(int p, int& tile, int& cnt) const {
    for (int r = 0; r < st->nr; ++r) {
      const int nw = st->nwg[r], kc = st->cap / nw, np = cdiv(st->kt[r], kc);
      if (p < np) {
        tile = st->tile0[r] + p * kc * nw;
        cnt = min(kc, st->kt[r] - p * kc) * nw;
        return;
      }
      p -= np;
    }
    tile = cnt = 0;
  }

  __device__ void issue(int p) {
    int tile, cnt;
    locate(p, tile, cnt);
    const int s = p % nst;
    bulk_copy(slots + (size_t)s * st->cap * kTileA,
              src + (size_t)tile * kTileA, cnt * kTileA * sizeof(bf16),
              &full[s]);
  }

  // Thread 0 sets up the barriers and puts the first nst pieces in
  // flight; ends with a barrier.
  __device__ void start() {
    if (threadIdx.x == 0) {
      for (int s = 0; s < nst; ++s) mbar_init(&full[s], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0)
      for (int p = 0; p < min(nst, st->pieces); ++p) issue(p);
  }

  __device__ const bf16* wait() {
    const int s = piece % nst;
    mbar_wait(&full[s], (piece / nst) & 1);
    return slots + (size_t)s * st->cap * kTileA;
  }

  // Every thread is done with the current piece (its products complete):
  // refill its slot with the piece nst ahead.
  __device__ void release() {
    __syncthreads();
    if (threadIdx.x == 0 && piece + nst < st->pieces) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(piece + nst);
    }
    ++piece;
  }
};

__device__ __forceinline__ int uniform(int v) {
  return __shfl_sync(0xffffffffu, v, 0);
}

template <int N8>
__device__ __forceinline__ void mma_tiles(float (&acc)[kAcc], const bf16* a,
                                          int astep, const bf16* b,
                                          uint32_t sbo, int k0, int n) {
  for (int i = 0; i < n; ++i)
    Mma<N8>::run(acc, smem_desc(a + (size_t)i * astep, 128, 256),
                 smem_desc(b + (size_t)i * 128, 128, sbo), k0 + i > 0);
}

// Round r of the stream: warpgroup wg < nwg[r] accumulates its m-tile's
// product with the activations act (act_at layout, Kp inputs) over the
// round's input tiles into acc, N = 8 N8 beams. In a round of one m-tile
// the other warpgroup runs the same product, which its caller ignores:
// ptxas serializes every product of a kernel that issues them under a
// branch (its C7520). Every thread of the block calls it; it returns with
// the round's pieces released and acc complete.
__device__ __forceinline__ void wide_round(WideRing& ring, int r,
                                           const bf16* act, int Kp, int N8,
                                           float (&acc)[kAcc]) {
  // Warp-uniform to the compiler too (a shuffle from lane 0, as CUTLASS
  // takes its warpgroup index): the products must not sit in code ptxas
  // takes to be divergent.
  const int nw = uniform(ring.st->nwg[r]), KT = uniform(ring.st->kt[r]);
  const int kc = uniform(ring.st->cap) / nw, wg = uniform(threadIdx.x / kWG);
  N8 = uniform(N8);
  const uint32_t sbo = (uint32_t)Kp * 16;
  for (int k0 = 0; k0 < KT; k0 += kc) {
    const bf16* slot = ring.wait();
    {
      const bf16* ap = slot + (wg < nw ? wg : 0) * kTileA;
      const bf16* bp = act + (size_t)k0 * 128;
      const int n = min(kc, KT - k0), as = nw * kTileA;
      acc_fence(acc);
      wg_fence();
      switch (N8) {
        case 1: mma_tiles<1>(acc, ap, as, bp, sbo, k0, n); break;
        case 2: mma_tiles<2>(acc, ap, as, bp, sbo, k0, n); break;
        case 3: mma_tiles<3>(acc, ap, as, bp, sbo, k0, n); break;
        case 4: mma_tiles<4>(acc, ap, as, bp, sbo, k0, n); break;
        case 5: mma_tiles<5>(acc, ap, as, bp, sbo, k0, n); break;
        case 6: mma_tiles<6>(acc, ap, as, bp, sbo, k0, n); break;
        case 7: mma_tiles<7>(acc, ap, as, bp, sbo, k0, n); break;
        case 8: mma_tiles<8>(acc, ap, as, bp, sbo, k0, n); break;
        case 9: mma_tiles<9>(acc, ap, as, bp, sbo, k0, n); break;
        case 10: mma_tiles<10>(acc, ap, as, bp, sbo, k0, n); break;
        case 11: mma_tiles<11>(acc, ap, as, bp, sbo, k0, n); break;
        case 12: mma_tiles<12>(acc, ap, as, bp, sbo, k0, n); break;
        case 13: mma_tiles<13>(acc, ap, as, bp, sbo, k0, n); break;
        case 14: mma_tiles<14>(acc, ap, as, bp, sbo, k0, n); break;
        case 15: mma_tiles<15>(acc, ap, as, bp, sbo, k0, n); break;
        default: mma_tiles<16>(acc, ap, as, bp, sbo, k0, n); break;
      }
      wg_commit();
      wg_wait();
      acc_fence(acc);
    }
    ring.release();
  }
}

// This thread's place in its warpgroup's accumulators: rows row0 and
// row0 + 8 of the m-tile, beams 8j + q2 and 8j + q2 + 1.
struct AccPos {
  int row0, q2;
};
__device__ __forceinline__ AccPos acc_pos() {
  const int t = threadIdx.x % kWG;
  return AccPos{16 * (t >> 5) + ((t & 31) >> 2), 2 * (t & 3)};
}

// -------------------------------------------------------------- the GRU

// A thread's two hidden units k = rank U + 64 ug + row (ug: its
// warpgroup's unit group), their biases (compute-dtype values in float)
// and whether they are real units (k < H, within the rank's share).
struct GruUnits {
  int k[2];
  bool ok[2];
  float bir[2], biz[2], bin[2], bhn[2];
};

__device__ __forceinline__ GruUnits gru_units(int rank, int H, int ug,
                                              const float* bi,
                                              const float* bhn) {
  const int U = share(H);
  const AccPos p = acc_pos();
  GruUnits u;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = 64 * ug + p.row0 + 8 * i, k = rank * U + c;
    u.ok[i] = c < U && k < H;
    u.k[i] = k;
    const int kk = u.ok[i] ? k : 0;
    u.bir[i] = bi[kk];
    u.biz[i] = bi[H + kk];
    u.bin[i] = bi[2 * H + kk];
    u.bhn[i] = bhn[kk];
  }
  return u;
}

// Values held between gate rounds, a bfloat16 pair (beams 8j + q2, +1) for
// each unit i and beam block j at [2j + i].
struct GruHeld {
  __nv_bfloat162 a[kAcc / 2], b[kAcc / 2];
};

__device__ __forceinline__ float rb(float x) {
  return ssnt_gru::rnd<bf16>(x);
}

// Gate round G's epilogue (gru_gate(G)'s products in acc), in the rounding
// order of stepmath.gru_step (gi = rnd(rnd(x . wi) + bi), gh = rnd(rnd(state)
// . wh), r, z = rnd(sigmoid(rnd(gi + gh))), n = rnd(tanh(rnd(gi_n +
// rnd(r * rnd(gh_n + bhn))))), new_h = rnd(rnd(1 - z) * n) + z * state):
//   0 (wi_r): a = gi_r;  1 (wh_r): a = r;  2 (wh_n): a = rnd(r * rnd(gh_n +
//   bhn));  3 (wi_n): a = n;  4 (wi_z): b = gi_z;  5 (wh_z): acc =
//   rnd(rnd(1 - z) * n), b = z
// (0 for units that are not real). new_h = acc + z * state is left to the
// caller, whose loads of the state rows are coalesced.
template <int G>
__device__ __forceinline__ void gru_fold(float (&acc)[kAcc], GruHeld& h,
                                         int N8, const GruUnits& u) {
#pragma unroll
  for (int j = 0; j < kAcc / 4; ++j) {
    if (j >= N8) break;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int x = 4 * j + 2 * i, y = 2 * j + i;
      const float v0 = rb(acc[x]), v1 = rb(acc[x + 1]);
      if constexpr (G == 0) {
        h.a[y] = __floats2bfloat162_rn(rb(__fadd_rn(v0, u.bir[i])),
                                       rb(__fadd_rn(v1, u.bir[i])));
      } else if constexpr (G == 1) {
        const float g0 = __low2float(h.a[y]), g1 = __high2float(h.a[y]);
        h.a[y] = __floats2bfloat162_rn(
            rb(ssnt_gru::sigmoid_f32(rb(__fadd_rn(g0, v0)))),
            rb(ssnt_gru::sigmoid_f32(rb(__fadd_rn(g1, v1)))));
      } else if constexpr (G == 2) {
        const float r0 = __low2float(h.a[y]), r1 = __high2float(h.a[y]);
        h.a[y] = __floats2bfloat162_rn(
            rb(__fmul_rn(r0, rb(__fadd_rn(v0, u.bhn[i])))),
            rb(__fmul_rn(r1, rb(__fadd_rn(v1, u.bhn[i])))));
      } else if constexpr (G == 3) {
        const float t0 = __low2float(h.a[y]), t1 = __high2float(h.a[y]);
        h.a[y] = __floats2bfloat162_rn(
            rb(tanhf(rb(__fadd_rn(rb(__fadd_rn(v0, u.bin[i])), t0)))),
            rb(tanhf(rb(__fadd_rn(rb(__fadd_rn(v1, u.bin[i])), t1)))));
      } else if constexpr (G == 4) {
        h.b[y] = __floats2bfloat162_rn(rb(__fadd_rn(v0, u.biz[i])),
                                       rb(__fadd_rn(v1, u.biz[i])));
      } else {
        const float gz[2] = {__low2float(h.b[y]), __high2float(h.b[y])};
        const float n[2] = {__low2float(h.a[y]), __high2float(h.a[y])};
        const float v[2] = {v0, v1};
        float z[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          z[e] = u.ok[i] ? rb(ssnt_gru::sigmoid_f32(rb(__fadd_rn(gz[e], v[e]))))
                         : 0.0f;
          acc[x + e] =
              u.ok[i] ? rb(__fmul_rn(rb(__fsub_rn(1.0f, z[e])), n[e])) : 0.0f;
        }
        h.b[y] = __floats2bfloat162_rn(z[0], z[1]);
      }
    }
  }
}

// The GRU of H units over the wide stream's rounds r0 .. r0 + 5 (one pair
// of unit groups: H <= 256): x (the input) and hb (rnd(state)) in the
// act_at layout. On return the rank's units c < share(H) of every beam w
// < 8 N8 hold keep = rnd(rnd(1 - z) * n) at keep[w ld + c] (float32) and
// z at z[w ld + c], both 0 for units past H; new_h = keep + z * state
// (gru_new_h). x and hb are read no more, so keep and z may take their
// place. Every thread of the block calls it.
__device__ __forceinline__ void gru_rounds(WideRing& ring, int r0,
                                           const bf16* x, const bf16* hb,
                                           int Kp, int N8, int rank, int H,
                                           const float* bi, const float* bhn,
                                           float* keep, bf16* z, int ld) {
  const int wg = threadIdx.x / kWG;
  const GruUnits u = gru_units(rank, H, wg, bi, bhn);
  GruHeld h;
  float acc[kAcc];
  for (int j = 0; j < 6; ++j) {
    wide_round(ring, r0 + j, gru_gate(j) >= 3 ? hb : x, Kp, N8, acc);
    if (wg >= ring.st->nwg[r0 + j]) continue;
    switch (j) {
      case 0: gru_fold<0>(acc, h, N8, u); break;
      case 1: gru_fold<1>(acc, h, N8, u); break;
      case 2: gru_fold<2>(acc, h, N8, u); break;
      case 3: gru_fold<3>(acc, h, N8, u); break;
      case 4: gru_fold<4>(acc, h, N8, u); break;
      default: gru_fold<5>(acc, h, N8, u); break;
    }
  }
  if (wg >= ring.st->nwg[r0 + 5]) return;
  const AccPos p = acc_pos();
  const int U = share(H);
#pragma unroll
  for (int j = 0; j < kAcc / 4; ++j) {
    if (j >= N8) break;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = 64 * wg + p.row0 + 8 * i, w = 8 * j + p.q2;
      if (c >= U) continue;
      keep[w * ld + c] = acc[4 * j + 2 * i];
      keep[(w + 1) * ld + c] = acc[4 * j + 2 * i + 1];
      z[w * ld + c] = h.b[2 * j + i].x;
      z[(w + 1) * ld + c] = h.b[2 * j + i].y;
    }
  }
}

// block_sums over W beams of `per` outputs each, a tile of kTileBeams beams
// at a time as the float32 wide kernels (and the tile loop before this
// design) sum them, so that the sums come out in the same order and the
// same bits: out[q] = f(q, i, .) folded over i in [0, n), q < W per.
template <typename F>
__device__ __forceinline__ void tile_sums(int W, int per, int n, float* scr,
                                          float* out, F f) {
  using ssnt_gru::kTileBeams;
  for (int w0 = 0; w0 < W; w0 += kTileBeams) {
    const int m = min(kTileBeams, W - w0) * per;
    for (int o0 = 0; o0 < m; o0 += ssnt_beam::kThreads)
      ssnt_gru::block_sums(min(ssnt_beam::kThreads, m - o0), n, scr,
                           out + w0 * per + o0, [&](int o, int i, float acc) {
                             return f(w0 * per + o0 + o, i, acc);
                           });
  }
}

// Calls f(std::true_type{}) where vec holds, else f(std::false_type{}):
// a loop in f tests it at compile time, so that nothing in its body stops
// the compiler from issuing several iterations' loads at once.
template <typename F>
__device__ __forceinline__ void with_vec(bool vec, F f) {
  if (vec)
    f(std::true_type{});
  else
    f(std::false_type{});
}

// new_h = keep + z * state in keep's place (gru_rounds' outputs), for the
// rank's units c < U (k = k0 + c) of beams w < N: state rows (W, H) of the
// utterance, read coalesced, four units a thread at a time where H % 4 ==
// 0; 0 past W and H. Begins and ends with a barrier.
__device__ __forceinline__ void gru_new_h(float* keep, const bf16* z, int ld,
                                          const float* state, int W, int N,
                                          int H, int U, int k0) {
  __syncthreads();
  with_vec((H & 3) == 0, [&](auto vec) {
    constexpr int V = decltype(vec)::value ? 4 : 1;
#pragma unroll 4
    for (int i = threadIdx.x; i < N * U / V; i += ssnt_beam::kThreads) {
      const int w = i / (U / V), c = (i - w * (U / V)) * V;
      const bool live = w < W && k0 + c < H;
      const float* sr =
          state + (size_t)(live ? w : 0) * H + (live ? k0 + c : 0);
      float s[V];
      if constexpr (V == 4) {
        const float4 a = *reinterpret_cast<const float4*>(sr);
        s[0] = a.x; s[1] = a.y; s[2] = a.z; s[3] = a.w;
      } else {
        s[0] = *sr;
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float* kp = keep + w * ld + c + e;
        const float zv = __bfloat162float(z[w * ld + c + e]);
        *kp = live ? __fadd_rn(*kp, __fmul_rn(zv, s[e])) : 0.0f;
      }
    }
  });
  __syncthreads();
}

// Eight bfloat16 values as one 16-byte word.
union Pack8 {
  uint4 u;
  __nv_bfloat162 h[4];
};

// Eight consecutive values of a float32 or compute-dtype row at k .. k + 7
// (k a multiple of 8), zero where live is false: with V, 16-byte loads
// (the row aligned for them, k + 8 within it), else one value at a time,
// zero at n and past it.
template <bool V>
__device__ __forceinline__ void row8(const float* p, int k, int n, bool live,
                                     float (&v)[8]) {
  if constexpr (V) {
    const float4 a = *reinterpret_cast<const float4*>(p + k);
    const float4 b = *reinterpret_cast<const float4*>(p + k + 4);
    const float u[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = live ? u[e] : 0.0f;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = live && k + e < n ? p[k + e] : 0.0f;
  }
}
template <bool V>
__device__ __forceinline__ void row8(const bf16* p, int k, int n, bool live,
                                     float (&v)[8]) {
  if constexpr (V) {
    Pack8 a;
    a.u = *reinterpret_cast<const uint4*>(p + k);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[2 * e] = live ? __low2float(a.h[e]) : 0.0f;
      v[2 * e + 1] = live ? __high2float(a.h[e]) : 0.0f;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = live && k + e < n ? __bfloat162float(p[k + e]) : 0.0f;
  }
}

// Eight values rounded to bfloat16 as one 16-byte word, which act_at(n,
// k .. k + 7) holds (k a multiple of 8).
__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  Pack8 a;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    a.h[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
  return a.u;
}
__device__ __forceinline__ void act8(bf16* act, int n, int k, int Kp,
                                     const float (&v)[8]) {
  *reinterpret_cast<uint4*>(act + act_at(n, k, Kp)) = pack8(v);
}

// Static shared memory of a wide bfloat16 step kernel besides its dynamic
// part.
constexpr size_t kStaticSmemWg =
    sizeof(WideStream) + sizeof(ssnt_gru::BeamInWide);

}  // namespace ssnt_wide
