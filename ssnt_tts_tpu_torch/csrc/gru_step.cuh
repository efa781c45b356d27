// Building blocks shared by the fused decode steps (fused_class_step.cu,
// fused_v1_step.cu), so that their dense layers and GRU cannot drift:
//   - loads and rounding to the compute dtype CT (float or bfloat16);
//   - the cluster: kCL blocks per utterance, block r of the cluster owning
//     the r-th contiguous share of every layer's output columns (16-column
//     tiles; the GRU's hidden units with their r, z and n gates on both
//     sides), exchanging activations through distributed shared memory;
//   - the weight stream: for each cluster rank, the layers' weight tiles
//     in the order the block consumes them, packed once per decode by
//     ops/beam_fused.py (pack_dense / pack_gru), copied into a ring of
//     16 or 32 KB shared-memory slots by TMA bulk copies (cp.async.bulk)
//     issued ahead of use, each completing on its slot's mbarrier;
//   - tile dots with the beams as the narrow side: bfloat16 on tensor
//     cores (mma.sync m16n8k16, A = a 16-column x 16-input tile of W^T,
//     B = 16 inputs x 8 beams of activations, float32 accumulators);
//     float32 as explicit fused multiply-adds over the same tiles (no
//     TF32);
//   - epilogues in the rounding order of models/stepmath: dense
//     (layers.mm + bias, then relu / tanh) and the GRU cell
//     (stepmath.gru_step).
// Callers are built with -fmad=false: every multiply and add outside the
// dots rounds on its own.
//
// Tile layout (both dtypes): a tile holds A[m][k] = W[16 kt + k][16 j + m]
// for output-column tile j and input tile kt, as 256 values in mma.sync
// fragment order: lane L = 4 g + t holds, at 8 L .. 8 L + 7, the values at
// (m, k) = (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1), (g, 2t+8),
// (g, 2t+9), (g+8, 2t+8), (g+8, 2t+9), so that one 16-byte load gives a
// lane its bfloat16 A fragment. A layer of K inputs and N outputs has
// KT = ceil(K/16) input tiles and MT = ceil(ceil(N/16)/kCL) column tiles
// per rank (rank r owns tiles j = r MT .. r MT + MT - 1, zero beyond N),
// streamed input-tile-major: (kt, mt) at kt MT + mt. The GRU's m-tiles are
// [wi_r, wi_z, wi_n, wh_r, wh_z, wh_n] for each of the rank's hidden-unit
// tiles in turn (MT = 6 ceil(ceil(H/16)/kCL)).

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "beam_select.cuh"
#include "tma.cuh"

namespace ssnt_gru {

namespace cg = cooperative_groups;
using ssnt_beam::kThreads;

constexpr int kCL = 2;                  // blocks per cluster (utterance)
constexpr int kWarps = kThreads / 32;   // 8
constexpr int kMaxSlots = 6;            // m-tiles a warp accumulates at once
constexpr int kMaxMT = kWarps * kMaxSlots;  // m-tiles of a layer per rank
// Bytes per ring slot: 32 KB where three fit, else 16 KB.
constexpr int kChunkBig = 32768, kChunkSmall = 16384;
constexpr int kMaxStages = 6;
constexpr int kTile = 256;              // values per tile
constexpr int kPad = 8;                 // activation row padding (values)
// The shared memory a block may use on an H100 (227 KB, opt-in).
constexpr size_t kSmemMax = 232448;

__host__ __device__ __forceinline__ int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

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

// A compute-dtype value as stored in an activation buffer (exact: the
// values are already rounded to CT).
template <typename CT> __device__ __forceinline__ CT st(float x);
template <> __device__ __forceinline__ float st<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 st<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float sigmoid_f32(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

// ------------------------------------------------------------- layers

// One layer of a rank's weight stream: K inputs, N outputs, KT input
// tiles, MT column tiles per rank, its first tile in the stream.
struct Layer {
  int K, N, KT, MT, gru, tile0;
};

__host__ __device__ inline Layer dense_layer(int K, int N, int tile0) {
  return Layer{K, N, cdiv(K, 16), cdiv(cdiv(N, 16), kCL), 0, tile0};
}

__host__ __device__ inline Layer gru_layer(int H, int tile0) {
  return Layer{H, H, cdiv(H, 16), 6 * cdiv(cdiv(H, 16), kCL), 1, tile0};
}

__host__ __device__ inline int layer_tiles(const Layer& l) {
  return l.MT * l.KT;
}

// Row stride of an activation buffer that feeds a layer of K inputs: the
// padding puts the 8 beams of a B fragment load in distinct banks.
__host__ __device__ inline int act_ld(int K) { return cdiv(K, 16) * 16 + kPad; }

// Split-k factor: a layer with fewer than 8 column tiles gives each tile
// S = 8 / MT warps, warp w taking input tiles kt = w / MT (mod S).
__host__ __device__ inline int ksplit(const Layer& l) {
  return l.MT >= kWarps ? 1 : kWarps / l.MT;
}

constexpr int kMaxLayers = 6;

// A rank's weight stream: the layers in the order the kernel runs them.
struct Stream {
  Layer l[kMaxLayers];
  int n;       // layers
  int tps;     // tiles per ring slot
  int pieces;  // ring pieces per launch (each layer's tiles cut into
               // slots of tps tiles; a piece never spans layers)
  int tiles;   // tiles per rank
};

// Sets the slot size (chunk bytes) and the counts that follow from it.
inline void finish_stream(Stream& s, int chunk, int csize) {
  s.tps = chunk / (kTile * csize);
  s.pieces = 0;
  s.tiles = 0;
  for (int i = 0; i < s.n; ++i) {
    s.pieces += cdiv(layer_tiles(s.l[i]), s.tps);
    s.tiles += layer_tiles(s.l[i]);
  }
}

// ------------------------------------------------------- PTX wrappers

using ssnt_tma::bulk_copy;
using ssnt_tma::mbar_init;
using ssnt_tma::mbar_wait;
using ssnt_tma::smem_u32;

// Cluster barrier halves: arrive releases this thread's writes (local and
// remote shared memory), wait acquires every other thread's.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// The same buffer in each block of the cluster.
template <typename T> struct Bcast {
  T* p[kCL];
  __device__ __forceinline__ void put(size_t i, T v) const {
#pragma unroll
    for (int r = 0; r < kCL; ++r) p[r][i] = v;
  }
};

template <typename T> __device__ __forceinline__ Bcast<T> bcast_of(T* local) {
  cg::cluster_group cl = cg::this_cluster();
  Bcast<T> b;
#pragma unroll
  for (int r = 0; r < kCL; ++r) b.p[r] = cl.map_shared_rank(local, r);
  return b;
}

// --------------------------------------------------------------- ring

// The weight ring: nst slots of st->tps tiles, one mbarrier each. Every
// thread walks the pieces in order (`piece`); thread 0 issues the copies.
// The stream runs `passes` times over (the wide steps' beam tiles).
template <typename CT> struct Ring {
  CT* slots;
  uint64_t* full;
  const CT* src;  // this rank's stream in global memory
  const Stream* st;
  int nst, piece;
  int passes = 1;

  // Piece p's first tile in the stream and its tile count.
  __device__ void locate(int p, int& tile, int& cnt) const {
    const int tps = st->tps;
    for (int i = 0; i < st->n; ++i) {
      const int nt = layer_tiles(st->l[i]), np = cdiv(nt, tps);
      if (p < np) {
        tile = st->l[i].tile0 + p * tps;
        cnt = min(tps, nt - p * tps);
        return;
      }
      p -= np;
    }
    tile = cnt = 0;
  }

  __device__ void issue(int p) {
    int tile, cnt;
    locate(passes > 1 ? p % st->pieces : p, tile, cnt);
    const int s = p % nst;
    bulk_copy(slots + (size_t)s * st->tps * kTile, src + (size_t)tile * kTile,
              cnt * kTile * sizeof(CT), &full[s]);
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
      for (int p = 0; p < min(nst, st->pieces * passes); ++p) issue(p);
  }

  // Wait for the current piece; returns its slot.
  __device__ const CT* wait() {
    const int s = piece % nst;
    mbar_wait(&full[s], (piece / nst) & 1);
    return slots + (size_t)s * st->tps * kTile;
  }

  // Every thread is done with the current piece: refill its slot with
  // the piece nst ahead.
  __device__ void release() {
    __syncthreads();
    if (threadIdx.x == 0 && piece + nst < st->pieces * passes) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(piece + nst);
    }
    ++piece;
  }
};

// ---------------------------------------------------------- tile dots

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint4& a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// acc[nt] (the m16n8 fragment of beams 8 nt .. 8 nt + 7) += tile (16
// columns x 16 inputs) . x[beam][16 kt .. 16 kt + 15]; x rows of stride
// lds. Fragment of lane 4g + t: rows g, g+8, beams 2t, 2t+1. load() reads
// a lane's share of the activations of input tile kt once (it serves
// every column tile of the step), run() one tile's product.
template <typename CT, int NTN> struct TileDot;

template <int NTN> struct TileDot<__nv_bfloat16, NTN> {
  struct B {
    uint32_t r[NTN][2];
  };
  static __device__ __forceinline__ B load(const __nv_bfloat16* x, int lds,
                                           int kt, int lane) {
    B b;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int nt = 0; nt < NTN; ++nt) {
      const __nv_bfloat16* xr = x + (size_t)(nt * 8 + g) * lds + kt * 16 + 2 * t;
      b.r[nt][0] = *reinterpret_cast<const uint32_t*>(xr);
      b.r[nt][1] = *reinterpret_cast<const uint32_t*>(xr + 8);
    }
    return b;
  }
  static __device__ __forceinline__ void run(float (&acc)[NTN][4],
                                             const __nv_bfloat16* tile,
                                             const B& b, int lane) {
    const uint4 a = *reinterpret_cast<const uint4*>(tile + lane * 8);
#pragma unroll
    for (int nt = 0; nt < NTN; ++nt) mma_bf16(acc[nt], a, b.r[nt][0], b.r[nt][1]);
  }
};

template <int NTN> struct TileDot<float, NTN> {
  struct B {
    const float* x;  // beam 2t's inputs of tile kt
    int lds;
  };
  static __device__ __forceinline__ B load(const float* x, int lds, int kt,
                                           int lane) {
    return B{x + (size_t)(2 * (lane & 3)) * lds + kt * 16, lds};
  }
  static __device__ __forceinline__ void run(float (&acc)[NTN][4],
                                             const float* tile, const B& b,
                                             int lane) {
    const int g = lane >> 2;
#pragma unroll
    for (int nt = 0; nt < NTN; ++nt) {
      const float* x0 = b.x + (size_t)nt * 8 * b.lds;
      const float* x1 = x0 + b.lds;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int i = (g * 4 + ((k & 7) >> 1)) * 8 + (k >> 3) * 4 + (k & 1);
        const float lo = tile[i], hi = tile[i + 2];  // rows g, g + 8
        acc[nt][0] = __fmaf_rn(lo, x0[k], acc[nt][0]);
        acc[nt][1] = __fmaf_rn(lo, x1[k], acc[nt][1]);
        acc[nt][2] = __fmaf_rn(hi, x0[k], acc[nt][2]);
        acc[nt][3] = __fmaf_rn(hi, x1[k], acc[nt][3]);
      }
    }
  }
};

// Staged dot products of a layer: stg[((ks MT + mt) 16 + row) WN + beam]
// holds split ks's partial for column row of the rank's tile mt.
template <int WN>
__device__ __forceinline__ float staged(const float* stg, const Layer& l,
                                        int mt, int row, int w) {
  const int S = ksplit(l);
  float v = stg[((size_t)mt * 16 + row) * WN + w];
  for (int ks = 1; ks < S; ++ks)
    v = __fadd_rn(v, stg[(((size_t)ks * l.MT + mt) * 16 + row) * WN + w]);
  return v;
}

// The rank's dot products of one layer over the beams' activations xa
// (the GRU's recurrent tiles read xb), rows of stride lds, from the weight
// ring, into the staging buffer. Warp w takes the m-tiles mt = w + 8 s
// (S = 1) or mt = w % MT for its share of the input tiles (S > 1). Ends
// with a barrier.
template <typename CT, int NTN>
__device__ void dot_layer(Ring<CT>& ring, const Layer& l, const CT* xa,
                          const CT* xb, int lds, float* stg) {
  using TD = TileDot<CT, NTN>;
  constexpr int WN = NTN * 8;
  const int tps = ring.st->tps;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int MT = l.MT, S = ksplit(l);
  const bool split = S > 1;
  const int my_mt = split ? warp % MT : warp, my_ks = split ? warp / MT : 0;
  const bool active = !split || warp < MT * S;
  float acc[kMaxSlots][NTN][4];
#pragma unroll
  for (int s = 0; s < kMaxSlots; ++s)
#pragma unroll
    for (int nt = 0; nt < NTN; ++nt)
      acc[s][nt][0] = acc[s][nt][1] = acc[s][nt][2] = acc[s][nt][3] = 0.0f;

  const int ntiles = layer_tiles(l);
  for (int first = 0; first < ntiles; first += tps) {
    const CT* slot = ring.wait();
    if (active) {  // this warp's tiles of the piece, directly
      const int last = min(first + tps, ntiles);
      for (int kt = first / MT; kt * MT < last; ++kt) {
        if (split && kt % S != my_ks) continue;
        const typename TD::B ba = TD::load(xa, lds, kt, lane);
        const typename TD::B bb = l.gru ? TD::load(xb, lds, kt, lane) : ba;
#pragma unroll
        for (int s = 0; s < kMaxSlots; ++s) {
          const int mt = split ? my_mt : warp + kWarps * s;
          const int i = kt * MT + mt;
          if ((split && s > 0) || mt >= MT || i < first || i >= last)
            continue;
          TD::run(acc[s], slot + (i - first) * kTile,
                  (l.gru && mt % 6 >= 3) ? bb : ba, lane);
        }
      }
    }
    ring.release();
  }

  if (active) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int s = 0; s < kMaxSlots; ++s) {
      const int mt = split ? my_mt : warp + kWarps * s;
      if ((split && s > 0) || mt >= MT) continue;
      float* o = stg + ((size_t)my_ks * MT + mt) * 16 * WN;
#pragma unroll
      for (int nt = 0; nt < NTN; ++nt) {
        const int w = nt * 8 + 2 * t;
        o[g * WN + w] = acc[s][nt][0];
        o[g * WN + w + 1] = acc[s][nt][1];
        o[(g + 8) * WN + w] = acc[s][nt][2];
        o[(g + 8) * WN + w + 1] = acc[s][nt][3];
      }
    }
  }
  __syncthreads();
}

// ----------------------------------------------------------- epilogues

enum Act { kLinear = 0, kRelu = 1, kTanh = 2 };

// y = act(rnd(rnd(x . w) + bias)) for the rank's columns n < N of a
// dense layer and beams w < W (kRelu: max(x, 0) of the rounded sum;
// kTanh: rnd(tanh) at float32, stepmath's tanh(x.float()).to(dtype));
// bias (N) compute-dtype values in shared memory; out(w, n, c, y) stores
// it (c: the column's index among the rank's).
template <typename CT, int WN, int ACT, typename Out>
__device__ __forceinline__ void dense_epilogue(const Layer& l,
                                               const float* stg, int rank,
                                               int W, const float* bias,
                                               Out out) {
  const int U = l.MT * 16;
  for (int i = threadIdx.x; i < W * U; i += kThreads) {
    const int w = i / U, c = i - w * U, n = rank * U + c;
    if (n >= l.N) continue;
    float y = rnd<CT>(
        __fadd_rn(rnd<CT>(staged<WN>(stg, l, c >> 4, c & 15, w)), bias[n]));
    if (ACT == kRelu) y = y > 0.0f ? y : 0.0f;
    if (ACT == kTanh) y = rnd<CT>(tanhf(y));
    out(w, n, c, y);
  }
}

// The GRU cell for the rank's hidden units k < H and beams w < W, in the
// rounding order of stepmath.gru_step:
//   gi = rnd(rnd(x . wi) + bi), gh = rnd(rnd(state) . wh)
//   r, z = rnd(sigmoid(rnd(gi + gh))), n = rnd(tanh(rnd(gi_n +
//   rnd(r * rnd(gh_n + bhn))))), new_h = rnd(rnd(1-z) * n) + z*state.
// bi (3H), bhn (H) compute-dtype values and state (W rows of stride lds)
// float32 in shared memory; new_h goes to nh_s[w U + c] (the rank's
// units, U = MT/6 * 16), to dbg (W, H) unless null, and to out(w, k,
// new_h).
template <typename CT, int WN, typename Out>
__device__ __forceinline__ void gru_epilogue(const Layer& l, const float* stg,
                                             int rank, int W, const float* bi,
                                             const float* bhn,
                                             const float* state, int lds,
                                             float* nh_s, float* dbg, Out out) {
  const int H = l.N, U = l.MT / 6 * 16;
  for (int i = threadIdx.x; i < W * U; i += kThreads) {
    const int w = i / U, c = i - w * U, k = rank * U + c;
    if (k >= H) continue;
    const int m0 = (c >> 4) * 6, row = c & 15;
    const float gir = rnd<CT>(
        __fadd_rn(rnd<CT>(staged<WN>(stg, l, m0, row, w)), bi[k]));
    const float giz = rnd<CT>(
        __fadd_rn(rnd<CT>(staged<WN>(stg, l, m0 + 1, row, w)), bi[H + k]));
    const float gin = rnd<CT>(__fadd_rn(
        rnd<CT>(staged<WN>(stg, l, m0 + 2, row, w)), bi[2 * H + k]));
    const float ghr = rnd<CT>(staged<WN>(stg, l, m0 + 3, row, w));
    const float ghz = rnd<CT>(staged<WN>(stg, l, m0 + 4, row, w));
    const float ghn = rnd<CT>(staged<WN>(stg, l, m0 + 5, row, w));
    const float r = rnd<CT>(sigmoid_f32(rnd<CT>(__fadd_rn(gir, ghr))));
    const float z = rnd<CT>(sigmoid_f32(rnd<CT>(__fadd_rn(giz, ghz))));
    const float rn =
        rnd<CT>(__fmul_rn(r, rnd<CT>(__fadd_rn(ghn, bhn[k]))));
    const float n = rnd<CT>(tanhf(rnd<CT>(__fadd_rn(gin, rn))));
    const float s = state[w * lds + k];
    const float keep_n = rnd<CT>(__fmul_rn(rnd<CT>(__fsub_rn(1.0f, z)), n));
    const float nh = __fadd_rn(keep_n, __fmul_rn(z, s));
    nh_s[w * U + c] = nh;
    if (dbg) dbg[(size_t)w * H + k] = nh;
    out(w, k, nh);
  }
}

// out[o] = f(o, i, .) folded over i in [0, n) for o < n_out (<= kThreads),
// over the whole block: thread t takes output t % n_out and the t / n_out-th
// of J = kThreads / n_out contiguous slices of i; the slices' partials
// (scratch, kThreads floats) are added in slice order. Ends with a barrier.
template <typename F>
__device__ __forceinline__ void block_sums(int n_out, int n, float* scratch,
                                           float* out, F f) {
  const int tid = threadIdx.x, J = max(1, kThreads / n_out);
  if (tid < J * n_out) {
    const int o = tid % n_out, j = tid / n_out;
    float acc = 0.0f;
    for (int i = j * n / J; i < (j + 1) * n / J; ++i) acc = f(o, i, acc);
    scratch[j * n_out + o] = acc;
  }
  __syncthreads();
  if (tid < n_out) {
    float s = scratch[tid];
    for (int j = 1; j < J; ++j) s = __fadd_rn(s, scratch[j * n_out + tid]);
    out[tid] = s;
  }
  __syncthreads();
}

// One utterance's beam carry, read into shared memory at the step's
// start (the candidates, the t history and the mel keep read it late):
// up to N beams (kMaxW for the narrow steps, kMaxBeams for the wide ones).
template <int N> struct BeamCarry {
  float lp[N];
  int t[N], u[N], tot[N], fin[N], pc[N];
  int il, ol;
};
using BeamIn = BeamCarry<ssnt_beam::kMaxW>;
using BeamInWide = BeamCarry<ssnt_beam::kMaxBeams>;
static_assert(ssnt_beam::kMaxBeams <= kThreads, "a thread a beam");

// Threads < W load utterance b's rows (tot, prev_class and ol may be null).
template <int N>
__device__ __forceinline__ void load_beams(BeamCarry<N>& s, int b, int W,
                                           const float* lp,
                                           const uint8_t* fin, const int* t,
                                           const int* u, const int* tot,
                                           const int* pc, const int* il,
                                           const int* ol) {
  const int w = threadIdx.x;
  if (w >= W) return;
  const size_t o = (size_t)b * W + w;
  s.lp[w] = lp[o];
  s.fin[w] = fin[o];
  s.t[w] = t[o];
  s.u[w] = u[o];
  s.tot[w] = tot ? tot[o] : 0;
  s.pc[w] = pc ? pc[o] : 0;
  if (w == 0) {
    s.il = il[b];
    s.ol = ol ? ol[b] : 0;
  }
}

// Small vectors (biases) copied into one float array in shared memory:
// segment j is n[j] values of src[j] (compute dtype, or float32 where
// f32[j]) at dst + off[j]. One loop over all of them, so that a thread's
// loads are in flight together.
template <typename CT, int NS> struct Segs {
  const void* src[NS];
  int n[NS], off[NS];
  bool f32[NS];
};

template <typename CT, int NS>
__device__ __forceinline__ void load_segs(float* dst, const Segs<CT, NS>& g) {
  int total = 0;
#pragma unroll
  for (int j = 0; j < NS; ++j) total += g.n[j];
#pragma unroll 4
  for (int i = threadIdx.x; i < total; i += kThreads) {
    int j = 0, k = i;
    while (k >= g.n[j]) k -= g.n[j++];
    dst[g.off[j] + k] = g.f32[j] ? static_cast<const float*>(g.src[j])[k]
                                 : ld(static_cast<const CT*>(g.src[j]), k);
  }
}

// Static shared memory of a fused step kernel besides its dynamic part
// (narrow; wide: the selection's fields are dynamic).
constexpr size_t kStaticSmem =
    sizeof(ssnt_beam::SelectSmem) + sizeof(Stream) + sizeof(BeamIn);
constexpr size_t kStaticSmemWide = sizeof(Stream) + sizeof(BeamInWide);

// The wide steps' beam tile: the beams of one pass over the weights.
constexpr int kTileBeams = 16;

// Shared-memory carving: 128-byte aligned pieces, offsets in bytes.
struct Carve {
  size_t at = 0;
  size_t take(size_t bytes) {
    const size_t o = at;
    at += (bytes + 127) / 128 * 128;
    return o;
  }
};

// The ring that fits after `used` bytes of dynamic shared memory beside
// the kernel's static shared memory: 32 KB slots where three fit, else
// 16 KB ones; at most kMaxStages (a launch needs two).
struct RingShape {
  int nst, chunk;
};
inline RingShape ring_shape(size_t used, size_t static_smem = kStaticSmem) {
  const size_t room = kSmemMax - 1024 - static_smem;
  const size_t free = room > used ? room - used : 0;
  const int chunk = free / kChunkBig >= 3 ? kChunkBig : kChunkSmall;
  const size_t n = free / chunk;
  return RingShape{n < (size_t)kMaxStages ? (int)n : kMaxStages, chunk};
}

}  // namespace ssnt_gru
