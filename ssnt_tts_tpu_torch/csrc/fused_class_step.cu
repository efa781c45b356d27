// Fused class decode beam step (v2 duration or tone) for Hopper (sm_90a).
// The GRU cell comes from gru_step.cuh, shared with fused_v1_step.cu.
//
// Replaces the TPU kernel ssnt_tts_tpu/ops/beam_fused.py:
// fused_class_beam_step (pallas_call at :486, kernel body
// _make_fused_kernel at :197), kind="v2" and kind="tone" (the tone arm at
// :275-301), with the candidate and selection semantics of
// beam_select.cuh.
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
//   2. the W*D candidate grid: v2 with every prune (band, overrun, exact
//      final length, zero skip, optional final-feasibility guard) and the
//      on-diagonal flag, test_mode skipping every prune; tone with none
//      (every class of an active beam, (t, u) -> (t+1, u+1));
//   3. the stable top-W selection (v2: with the diagonal re-injection,
//      the survivor count and the emptied flag);
//   4. the parent-pointer reorder of the GRU state.
//
// What bounds it on an H100: latency, not bytes or operations. A step is
// ~0.2 GFLOP at B=32, W=8, H=256 over ~0.8 MB of bfloat16 GRU weights that
// stay in the 50 MB L2 (bound 0.4 us). The first version ran one block per
// utterance (32 of 132 SMs at B=32), one thread per GRU column walking 256
// inputs serially with a global load each (0.151 ms). This design:
//   - a cluster of kCL = 2 blocks per utterance (64 blocks at B=32), block
//     r computing the GRU for hidden units [128 r, 128 r + 128) (its r, z
//     and n gate columns on both sides, so the gate math stays local).
//     Clusters of 4 ran in two waves on an H100 (32 clusters of 4
//     one-block-per-SM blocks do not all fit in its GPCs at once);
//   - the GRU's dots on tensor cores in bfloat16 (mma.sync m16n8k16, the
//     beams as the n = 8 side; float32 as FMAs over the same tiles), the
//     eight warps taking six 16-column tiles each;
//   - the rank's 384 KB of packed weight tiles streamed into a ring of
//     16 or 32 KB shared-memory slots by TMA bulk copies issued at the
//     step's start and refilled as each slot is consumed (by thread 0 after
//     the block's barrier that closes the slot: a producer warp would have
//     to join the cluster barrier while it waits on the ring);
//   - the correction head split into per-rank partial sums (each over the
//     rank's units, spread over the block's threads), exchanged through
//     distributed shared memory behind one cluster barrier and added in
//     rank order, so both blocks hold the same log-probs and run the same
//     selection; block 0 writes the beam outputs, each block reorders its
//     own state columns.
// Beams: the narrow instances take W <= kMaxW = 16 and W*D <= kMaxC in
// one beam tile (mma N tiles of 8 beams: 8 or 16); wider steps, up to
// kMaxBeams = 128 and kMaxCands = 2048 candidates, take a wide instance
// and wide_select. In bfloat16 that is fused_class_wgmma_kernel
// (wide_step.cuh): the beams as the N side of wgmma m64nNk16, the rank's
// wide stream crossing L2 into shared memory once a step whatever W,
// the gates folded in registers, new_h kept in shared memory up to the
// reorder (the tile loop it replaced ran a weight pass a tile of 16
// beams, 8 passes at W = 128). In float32 (TF32 is not float32) it is
// fused_class_wide_kernel, the narrow step's FMAs a tile of 16 beams at a
// time, a weight pass each.
// What holds it now (ssnt_tts_tpu_torch/probe_fused.py; numbers in
// PERF.md): the weight stream, at the rate one SM pulls from L2 into
// shared memory; the prologue's loads; the selection; and the code that
// runs once per launch, which fetches its instructions from L2 (the kernel
// is ~10k instructions; unrolling more made it slower).
//
// Layouts (row-major, contiguous): xin_path (T, B, H) compute dtype;
// base_path (T, B, D) f32; embed (D, H), bi (3H), bhn (H) compute dtype;
// wpack (kCL, tiles x 256) compute dtype: wi/wh (H, 3H) packed by
// ops/beam_fused.pack_gru (gru_step.cuh's tile layout, one stream per
// cluster rank; the bfloat16 wide instance: (kCL, tiles x 1024) packed by
// pack_wide_gru, wide_step.cuh's layout); out_k (H, D), out_b (D) f32;
// prev_class/t/u (B, W) i32;
// log_prob (B, W) f32; is_finished (B, W) bool (1 byte); state (B, W, H)
// f32; input_length (B,) i32. v2 only: total (B, W) i32, output length
// (B,) i32, duration table (D,) i32, emptied (B,) bool. Optional debug
// outputs (null to skip): h (B, W, D) f32 and the pre-reorder new_h
// (B, W, H) f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "beam_select.cuh"
#include "gru_step.cuh"
#include "wide_step.cuh"

namespace {

using namespace ssnt_beam;
using namespace ssnt_gru;
using ssnt_wide::WideRing;
using ssnt_wide::WideStream;

enum Kind { kV2 = 0, kTone = 1 };

// Dynamic shared memory of one block, byte offsets.
struct ClassSmem {
  size_t x, hb, stf, bias, nh, stg, hk, hp, scr, h, bar, ring, total;
  int nst, chunk;
};

ClassSmem class_smem(int WN, int D, int H, int csize) {
  const Layer g = gru_layer(H, 0);
  const int U = g.MT / 6 * 16;
  const size_t act = (size_t)WN * act_ld(H) * csize;
  Carve c;
  ClassSmem s;
  s.x = c.take(act);
  s.hb = c.take(act);
  // float32 state rows (stride act_ld(H)); in float32 compute, hb itself
  s.stf = csize == 4 ? s.hb : c.take((size_t)WN * act_ld(H) * sizeof(float));
  s.bias = c.take(sizeof(float) * (4 * H + D));  // bi, bhn, out_b
  s.nh = c.take(sizeof(float) * WN * U);
  s.stg = c.take(sizeof(float) * g.MT * 16 * WN);
  s.hk = c.take(sizeof(float) * U * D);
  s.hp = c.take(sizeof(float) * kCL * kMaxC);
  s.scr = c.take(sizeof(float) * kThreads);
  s.h = c.take(sizeof(float) * kMaxC);
  s.bar = c.take(sizeof(uint64_t) * kMaxStages);
  s.ring = c.at;
  const RingShape r = ring_shape(s.ring);
  s.nst = r.nst;
  s.chunk = r.chunk;
  s.total = s.ring + (size_t)s.nst * s.chunk;
  return s;
}

// The wide step's dynamic shared memory (W > kMaxW or W D > kMaxC), byte
// offsets: one beam tile's buffers, which the selection's fields take
// over after the last tile, then the whole utterance's class sums.
struct ClassWideSmem {
  size_t x, hb, stf, nh, stg, sel, bias, hk, hp, h, scr, bar, ring, total;
  int nst, chunk;
};

ClassWideSmem class_wide_smem(int W, int D, int H, int csize) {
  const Layer g = gru_layer(H, 0);
  const int U = g.MT / 6 * 16, WN = kTileBeams, C = W * D;
  const size_t act = (size_t)WN * act_ld(H) * csize;
  Carve c;
  ClassWideSmem s;
  s.x = c.take(act);
  s.hb = c.take(act);
  s.stf = csize == 4 ? s.hb : c.take((size_t)WN * act_ld(H) * sizeof(float));
  s.nh = c.take(sizeof(float) * WN * U);
  s.stg = c.take(sizeof(float) * g.MT * 16 * WN);
  s.sel = 0;
  const size_t sel = wide_sel_bytes(C);
  if (c.at < sel) c.take(sel - c.at);
  s.bias = c.take(sizeof(float) * (4 * H + D));  // bi, bhn, out_b
  s.hk = c.take(sizeof(float) * U * D);
  s.hp = c.take(sizeof(float) * kCL * C);
  s.h = c.take(sizeof(float) * C);
  s.scr = c.take(sizeof(float) * kThreads);
  s.bar = c.take(sizeof(uint64_t) * kMaxStages);
  s.ring = c.at;
  const RingShape r = ring_shape(s.ring, kStaticSmemWide);
  s.nst = r.nst;
  s.chunk = r.chunk;
  s.total = s.ring + (size_t)s.nst * s.chunk;
  return s;
}

struct StepArgs {
  int B, W, D, H, s;
  const void* xin_path; const float* base_path;
  const void* embed; const void* wpack; const void* bi;
  const void* bhn; const float* out_k; const float* out_b;
  const int* prev_class; const float* state; const float* lp;
  const uint8_t* fin; const int* t; const int* u; const int* il;
  // v2 only
  const int* tot; const int* ol; const int* dtab; const uint8_t* emptied;
  int* o_nsurv; uint8_t* o_emptied;
  BeamOut out;
  float* o_state; float* dbg_h; float* dbg_newh;
  V2Opts v2;
  int empty_id;  // tone only
  Stream st;
  ClassSmem sm;
  ClassWideSmem wsm;
};

// One block per SM (minBlocks 1): ptxas may keep the accumulators of six
// m-tiles x two n-tiles (W=16) in registers.
template <int KIND, typename CT, int NTN>
__global__ void __cluster_dims__(kCL, 1, 1) __launch_bounds__(kThreads, 1)
fused_class_step_kernel(const __grid_constant__ StepArgs a) {
  constexpr int WN = NTN * 8;
  const int rank = (int)cg::this_cluster().block_rank();
  const int b = blockIdx.x / kCL, tid = threadIdx.x;
  const int B = a.B, W = a.W, D = a.D, H = a.H, C = W * D;
  const int U = a.st.l[0].MT / 6 * 16, k0 = rank * U;
  const int nu = max(0, min(U, H - k0)), lds = act_ld(H);
  const CT* xin = static_cast<const CT*>(a.xin_path);
  const CT* embed = static_cast<const CT*>(a.embed);

  extern __shared__ __align__(128) unsigned char smem[];
  CT* x_s = reinterpret_cast<CT*>(smem + a.sm.x);    // (WN, lds) GRU input
  CT* hb_s = reinterpret_cast<CT*>(smem + a.sm.hb);  // (WN, lds) rnd(state)
  float* stf_s = reinterpret_cast<float*>(smem + a.sm.stf);  // (WN, lds) state
  float* bias_s = reinterpret_cast<float*>(smem + a.sm.bias);  // bi|bhn|out_b
  float* nh_s = reinterpret_cast<float*>(smem + a.sm.nh);  // (WN, U) new_h
  float* stg = reinterpret_cast<float*>(smem + a.sm.stg);
  float* hk_s = reinterpret_cast<float*>(smem + a.sm.hk);  // (U, D) out_k rows
  float* hp_s = reinterpret_cast<float*>(smem + a.sm.hp);  // (kCL, kMaxC)
  float* scr = reinterpret_cast<float*>(smem + a.sm.scr);
  float* h_s = reinterpret_cast<float*>(smem + a.sm.h);    // (W, D)
  __shared__ SelectSmem sel;
  __shared__ Stream st_s;  // the weight stream's layers
  __shared__ BeamIn bin;   // the beams' carry

  if (tid == 0) st_s = a.st;
  Ring<CT> ring{reinterpret_cast<CT*>(smem + a.sm.ring),
                reinterpret_cast<uint64_t*>(smem + a.sm.bar),
                static_cast<const CT*>(a.wpack) +
                    (size_t)rank * a.st.tiles * kTile,
                &st_s, a.sm.nst, 0};
  ring.start();
  load_beams(bin, b, W, a.lp, a.fin, a.t, a.u, a.tot, a.prev_class, a.il,
             a.ol);
  __syncthreads();

  // ---- 1. AR class cell: x = rnd(embed[prev_class] + xin_path[s]) and
  // the state for every beam (zero padding), the biases and the rank's
  // out_k rows ----
#pragma unroll 4
  for (int i = tid; i < WN * lds; i += kThreads) {
    const int w = i / lds, k = i - w * lds;
    float xv = 0.0f, sv = 0.0f;
    if (w < W && k < H) {
      xv = rnd<CT>(__fadd_rn(ld(embed, (size_t)bin.pc[w] * H + k),
                             ld(xin, ((size_t)a.s * B + b) * H + k)));
      sv = a.state[((size_t)b * W + w) * H + k];
    }
    x_s[i] = st<CT>(xv);
    stf_s[i] = sv;  // in float32 compute this is hb_s, rnd(state) itself
    hb_s[i] = st<CT>(rnd<CT>(sv));
  }
  load_segs(bias_s, Segs<CT, 3>{{a.bi, a.bhn, a.out_b},
                                {3 * H, H, D},
                                {0, 3 * H, 4 * H},
                                {false, false, true}});
  load_segs(hk_s, Segs<CT, 1>{{a.out_k + (size_t)k0 * D}, {nu * D}, {0},
                              {true}});
  cluster_arrive();  // this block's buffers are ready for its peers
  __syncthreads();

  const Layer& gl = st_s.l[0];
  dot_layer<CT, NTN>(ring, gl, x_s, hb_s, lds, stg);
  gru_epilogue<CT, WN>(gl, stg, rank, W, bias_s, bias_s + 3 * H, stf_s, lds,
                       nh_s,
                       a.dbg_newh ? a.dbg_newh + (size_t)b * W * H : nullptr,
                       [](int, int, float) {});
  __syncthreads();

  // Correction head: the rank's partial new_h . out_k (float32), to every
  // block; the partials are added in rank order, then base + (sum + out_b).
  block_sums(C, nu, scr, h_s, [&](int o, int i, float acc) {
    const int w = o / D, d = o - w * D;
    return __fmaf_rn(nh_s[w * U + i], hk_s[i * D + d], acc);
  });
  cluster_wait();
  {
    const Bcast<float> hp = bcast_of(hp_s);
    if (tid < C) hp.put((size_t)rank * kMaxC + tid, h_s[tid]);
  }
  cluster_sync();
  if (tid < C) {
    const int d = tid % D;
    float sum = hp_s[tid];
    for (int r = 1; r < kCL; ++r) sum = __fadd_rn(sum, hp_s[r * kMaxC + tid]);
    h_s[tid] = __fadd_rn(a.base_path[((size_t)a.s * B + b) * D + d],
                         __fadd_rn(sum, bias_s[4 * H + d]));
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
      if (a.dbg_h && rank == 0) a.dbg_h[((size_t)b * W + tid) * D + d] = row[d];
    }
  }
  __syncthreads();

  // ---- 2. candidate grid, one thread per candidate c = w*D + d ----
  bool valid = false;
  if (tid < C) {
    const int w = tid / D, d = tid - w * D;
    const Cand x = KIND == kV2
        ? v2_candidate(d, D, h_s[tid], bin.lp[w], bin.fin[w], bin.tot[w],
                       bin.t[w], bin.u[w], bin.il, bin.ol, a.dtab, a.v2)
        : tone_candidate(d, h_s[tid], bin.lp[w], bin.fin[w], bin.t[w],
                         bin.u[w], bin.il, a.empty_id);
    store_cand(sel, tid, x);
    valid = x.valid;
  }

  // ---- 3. selection (every block of the cluster, on the same h) ----
  const int n = select_beams(sel, C, W, valid, KIND == kV2 && !a.v2.test_mode);
  if (rank == 0) {
    write_selected(sel, b, W, D, a.out);
    if (KIND == kV2 && tid == 0) {
      a.o_nsurv[b] = n;
      a.o_emptied[b] = (uint8_t)(a.emptied[b] || n == 0);
    }
  }

  // ---- 4. parent-pointer reorder of the rank's state columns ----
  for (int i = tid; i < W * nu; i += kThreads) {
    const int j = i / nu, c = i - j * nu;
    a.o_state[((size_t)b * W + j) * H + k0 + c] = nh_s[(sel.src[j] / D) * U + c];
  }
}

// The wide step: the narrow kernel's stages over tiles of kTileBeams beams
// (the GRU's accumulators of 128 beams do not fit in registers). Each tile
// loads its beams' inputs, runs the GRU over one pass of the weight stream
// (the ring runs ceil(W / kTileBeams) passes), writes its new_h, before
// the reorder, to a.dbg_newh (a scratch the wrapper provides when the
// caller does not) and keeps the rank's partial class sums of its beams;
// then the partials are exchanged as in the narrow step, and the
// selection (wide_select) and the reorder (from a.dbg_newh, the block's
// own columns) cover every beam.
template <int KIND, typename CT>
__global__ void __cluster_dims__(kCL, 1, 1) __launch_bounds__(kThreads, 1)
fused_class_wide_kernel(const __grid_constant__ StepArgs a) {
  constexpr int NTN = kTileBeams / 8, WN = kTileBeams;
  const int rank = (int)cg::this_cluster().block_rank();
  const int b = blockIdx.x / kCL, tid = threadIdx.x;
  const int B = a.B, W = a.W, D = a.D, H = a.H, C = W * D;
  const int U = a.st.l[0].MT / 6 * 16, k0 = rank * U;
  const int nu = max(0, min(U, H - k0)), lds = act_ld(H);
  const CT* xin = static_cast<const CT*>(a.xin_path);
  const CT* embed = static_cast<const CT*>(a.embed);
  float* newh = a.dbg_newh + (size_t)b * W * H;  // (W, H) before the reorder

  extern __shared__ __align__(128) unsigned char smem[];
  CT* x_s = reinterpret_cast<CT*>(smem + a.wsm.x);    // (WN, lds) GRU input
  CT* hb_s = reinterpret_cast<CT*>(smem + a.wsm.hb);  // (WN, lds) rnd(state)
  float* stf_s = reinterpret_cast<float*>(smem + a.wsm.stf);  // (WN, lds)
  float* nh_s = reinterpret_cast<float*>(smem + a.wsm.nh);  // (WN, U) new_h
  float* stg = reinterpret_cast<float*>(smem + a.wsm.stg);
  float* bias_s = reinterpret_cast<float*>(smem + a.wsm.bias);  // bi|bhn|out_b
  float* hk_s = reinterpret_cast<float*>(smem + a.wsm.hk);  // (U, D) out_k rows
  float* hp_s = reinterpret_cast<float*>(smem + a.wsm.hp);  // (kCL, C)
  float* h_s = reinterpret_cast<float*>(smem + a.wsm.h);    // (W, D)
  float* scr = reinterpret_cast<float*>(smem + a.wsm.scr);
  __shared__ Stream st_s;     // the weight stream's layers
  __shared__ BeamInWide bin;  // the beams' carry

  if (tid == 0) st_s = a.st;
  Ring<CT> ring{reinterpret_cast<CT*>(smem + a.wsm.ring),
                reinterpret_cast<uint64_t*>(smem + a.wsm.bar),
                static_cast<const CT*>(a.wpack) +
                    (size_t)rank * a.st.tiles * kTile,
                &st_s, a.wsm.nst, 0};
  ring.passes = (W + WN - 1) / WN;
  ring.start();
  load_beams(bin, b, W, a.lp, a.fin, a.t, a.u, a.tot, a.prev_class, a.il,
             a.ol);
  load_segs(bias_s, Segs<CT, 3>{{a.bi, a.bhn, a.out_b},
                                {3 * H, H, D},
                                {0, 3 * H, 4 * H},
                                {false, false, true}});
  load_segs(hk_s, Segs<CT, 1>{{a.out_k + (size_t)k0 * D}, {nu * D}, {0},
                              {true}});
  cluster_arrive();  // this block's buffers are ready for its peers
  __syncthreads();

  // ---- 1. AR class cell, a tile of beams at a time ----
  const Layer& gl = st_s.l[0];
  for (int w0 = 0; w0 < W; w0 += WN) {
    const int Wt = min(WN, W - w0);
#pragma unroll 4
    for (int i = tid; i < WN * lds; i += kThreads) {
      const int w = i / lds, k = i - w * lds;
      float xv = 0.0f, sv = 0.0f;
      if (w < Wt && k < H) {
        xv = rnd<CT>(__fadd_rn(ld(embed, (size_t)bin.pc[w0 + w] * H + k),
                               ld(xin, ((size_t)a.s * B + b) * H + k)));
        sv = a.state[((size_t)b * W + w0 + w) * H + k];
      }
      x_s[i] = st<CT>(xv);
      stf_s[i] = sv;  // in float32 compute this is hb_s, rnd(state) itself
      hb_s[i] = st<CT>(rnd<CT>(sv));
    }
    __syncthreads();
    dot_layer<CT, NTN>(ring, gl, x_s, hb_s, lds, stg);
    gru_epilogue<CT, WN>(gl, stg, rank, Wt, bias_s, bias_s + 3 * H, stf_s,
                         lds, nh_s, newh + (size_t)w0 * H,
                         [](int, int, float) {});
    __syncthreads();
    // The rank's partial new_h . out_k (float32) of the tile's beams.
    for (int o0 = 0; o0 < Wt * D; o0 += kThreads)
      block_sums(min(kThreads, Wt * D - o0), nu, scr, h_s + w0 * D + o0,
                 [&](int o, int i, float acc) {
                   const int q = o0 + o, w = q / D, d = q - w * D;
                   return __fmaf_rn(nh_s[w * U + i], hk_s[i * D + d], acc);
                 });
  }

  // The partials to every block, added in rank order, then base + (sum +
  // out_b) and the log_softmax.
  cluster_wait();
  {
    const Bcast<float> hp = bcast_of(hp_s);
    for (int c = tid; c < C; c += kThreads)
      hp.put((size_t)rank * C + c, h_s[c]);
  }
  cluster_sync();
  for (int c = tid; c < C; c += kThreads) {
    const int d = c % D;
    float sum = hp_s[c];
    for (int r = 1; r < kCL; ++r) sum = __fadd_rn(sum, hp_s[r * C + c]);
    h_s[c] = __fadd_rn(a.base_path[((size_t)a.s * B + b) * D + d],
                       __fadd_rn(sum, bias_s[4 * H + d]));
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
      if (a.dbg_h && rank == 0) a.dbg_h[((size_t)b * W + tid) * D + d] = row[d];
    }
  }
  __syncthreads();

  // ---- 2. candidate grid, 3. selection (every block, on the same h) ----
  const WideSel sel = wide_sel_at(smem + a.wsm.sel, C);
  for (int c = tid; c < C; c += kThreads) {
    const int w = c / D, d = c - w * D;
    store_wide(sel, c, KIND == kV2
        ? v2_candidate(d, D, h_s[c], bin.lp[w], bin.fin[w], bin.tot[w],
                       bin.t[w], bin.u[w], bin.il, bin.ol, a.dtab, a.v2)
        : tone_candidate(d, h_s[c], bin.lp[w], bin.fin[w], bin.t[w],
                         bin.u[w], bin.il, a.empty_id));
  }
  const int n = wide_select(sel, C, W, KIND == kV2 && !a.v2.test_mode);
  if (rank == 0) {
    for (int j = tid; j < W; j += kThreads) {
      const int src = sel.src[j];
      const size_t i = (size_t)b * W + j;
      a.out.pred[i] = sel.pred[src];
      a.out.lp[i] = sel.lp[src];
      a.out.nt[i] = sel.nt[src];
      a.out.nu[i] = sel.nu[src];
      a.out.fin[i] = (uint8_t)sel.fin[src];
      if (a.out.tot) a.out.tot[i] = sel.tot[src];
      a.out.branch[i] = src / D;
    }
    if (KIND == kV2 && tid == 0) {
      a.o_nsurv[b] = n;
      a.o_emptied[b] = (uint8_t)(a.emptied[b] || n == 0);
    }
  }

  // ---- 4. parent-pointer reorder of the rank's state columns ----
  for (int i = tid; i < W * nu; i += kThreads) {
    const int j = i / nu, c = i - j * nu;
    a.o_state[((size_t)b * W + j) * H + k0 + c] =
        newh[(size_t)(sel.src[j] / D) * H + k0 + c];
  }
}

// The wide step for a bfloat16 compute dtype (wide_step.cuh): the GRU's
// six gate rounds over every beam of the utterance at once (N = W rounded
// up to a multiple of 8 on the N side of wgmma m64nNk16), the rank's wide
// stream (384 KB at H = 256) crossing L2 into shared memory once a step;
// the gates folded in registers; new_h kept in shared memory, in the GRU
// input's place, up to the reorder; the class sums, their exchange, the
// log_softmax, wide_select and the reorder as in fused_class_wide_kernel.
struct ClassWgSmem {
  size_t x, bias, hk, hp, h, scr, bar, hb, ring, sel, total;
  int nst, chunk, ldn;
};

ClassWgSmem class_wg_smem(int W, int D, int H) {
  const int N = cdiv(W, 8) * 8, Kp = cdiv(H, 16) * 16, C = W * D;
  const int U = ssnt_wide::share(H);
  const size_t act = (size_t)N * Kp * sizeof(__nv_bfloat16);
  ClassWgSmem s;
  s.ldn = U + 4;  // new_h rows: the four beams of a store in distinct banks
  Carve c;
  const size_t nh = sizeof(float) * N * s.ldn;
  s.x = c.take(act > nh ? act : nh);  // the GRU input, then new_h
  s.bias = c.take(sizeof(float) * (4 * H + D));  // bi, bhn, out_b
  s.hk = c.take(sizeof(float) * U * D);
  s.hp = c.take(sizeof(float) * kCL * C);
  s.h = c.take(sizeof(float) * C);
  s.scr = c.take(sizeof(float) * kThreads);
  s.bar = c.take(sizeof(uint64_t) * kMaxStages);
  // rnd(state), then z (bfloat16, ldn a beam), then the selection's fields
  const size_t z = sizeof(__nv_bfloat16) * N * s.ldn;
  s.hb = c.take(act > z ? act : z);
  s.ring = c.at;
  const RingShape r = ring_shape(s.ring, ssnt_wide::kStaticSmemWg);
  s.nst = r.nst;
  s.chunk = r.chunk;
  s.sel = s.hb;
  const size_t ring_end = s.ring + (size_t)s.nst * s.chunk;
  const size_t sel_end = s.sel + wide_sel_bytes(C);
  s.total = ring_end > sel_end ? ring_end : sel_end;
  return s;
}

struct ClassWgArgs : StepArgs {
  WideStream ws;
  ClassWgSmem gsm;
};

template <int KIND>
__global__ void __cluster_dims__(kCL, 1, 1) __launch_bounds__(kThreads, 1)
fused_class_wgmma_kernel(const __grid_constant__ ClassWgArgs a) {
  using bf16 = __nv_bfloat16;
  const int rank = (int)cg::this_cluster().block_rank();
  const int b = blockIdx.x / kCL, tid = threadIdx.x;
  const int B = a.B, W = a.W, D = a.D, H = a.H, C = W * D;
  const int N8 = cdiv(W, 8), N = 8 * N8, Kp = cdiv(H, 16) * 16;
  const int U = ssnt_wide::share(H), k0 = rank * U;
  const int nu = max(0, min(U, H - k0)), ldn = a.gsm.ldn;
  const bf16* xin = static_cast<const bf16*>(a.xin_path);
  const bf16* embed = static_cast<const bf16*>(a.embed);

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* x_s = reinterpret_cast<bf16*>(smem + a.gsm.x);     // (N, Kp) x
  float* nh_s = reinterpret_cast<float*>(smem + a.gsm.x);  // (N, ldn) new_h
  bf16* hb_s = reinterpret_cast<bf16*>(smem + a.gsm.hb);   // (N, Kp)
  float* bias_s = reinterpret_cast<float*>(smem + a.gsm.bias);  // bi|bhn|out_b
  float* hk_s = reinterpret_cast<float*>(smem + a.gsm.hk);  // (U, D) out_k rows
  float* hp_s = reinterpret_cast<float*>(smem + a.gsm.hp);  // (kCL, C)
  float* h_s = reinterpret_cast<float*>(smem + a.gsm.h);    // (W, D)
  float* scr = reinterpret_cast<float*>(smem + a.gsm.scr);
  __shared__ WideStream st_s;  // the wide stream's rounds
  __shared__ BeamInWide bin;   // the beams' carry

  if (tid == 0) st_s = a.ws;
  WideRing ring{reinterpret_cast<bf16*>(smem + a.gsm.ring),
                reinterpret_cast<uint64_t*>(smem + a.gsm.bar),
                static_cast<const bf16*>(a.wpack) +
                    (size_t)rank * a.ws.tiles * ssnt_wide::kTileA,
                &st_s, a.gsm.nst, 0};
  load_beams(bin, b, W, a.lp, a.fin, a.t, a.u, a.tot, a.prev_class, a.il,
             a.ol);
  load_segs(bias_s, Segs<bf16, 3>{{a.bi, a.bhn, a.out_b},
                                  {3 * H, H, D},
                                  {0, 3 * H, 4 * H},
                                  {false, false, true}});
  load_segs(hk_s, Segs<bf16, 1>{{a.out_k + (size_t)k0 * D}, {nu * D}, {0},
                                {true}});
  __syncthreads();  // bin.pc

  // ---- 1. AR class cell: x = rnd(embed[prev_class] + xin_path[s]) and
  // rnd(state) for every beam (zero past W and H), eight inputs a thread
  // at a time ----
  ssnt_wide::with_vec((H & 15) == 0, [&](auto vec) {
    constexpr bool V = decltype(vec)::value;
    const int K8 = Kp / 8;
    const bf16* xr = xin + ((size_t)a.s * B + b) * H;
#pragma unroll 4
    for (int i = tid; i < N * K8; i += kThreads) {
      const int w = i / K8, k = (i - w * K8) * 8, wr = w < W ? w : 0;
      float xv[8], ev[8], sv[8];
      ssnt_wide::row8<V>(embed + (size_t)bin.pc[wr] * H, k, H, w < W, ev);
      ssnt_wide::row8<V>(xr, k, H, w < W, xv);
      ssnt_wide::row8<V>(a.state + ((size_t)b * W + wr) * H, k, H, w < W, sv);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        xv[e] = rnd<bf16>(__fadd_rn(ev[e], xv[e]));
        sv[e] = rnd<bf16>(sv[e]);
      }
      ssnt_wide::act8(x_s, w, k, Kp, xv);
      ssnt_wide::act8(hb_s, w, k, Kp, sv);
    }
  });
  ssnt_wide::async_fence();
  // The weight stream starts after the loads above: its copies would
  // queue ahead of them.
  ring.start();
  cluster_arrive();  // this block's buffers are ready for its peers
  __syncthreads();

  // new_h into x's place, z in rnd(state)'s (the rounds read neither
  // again)
  ssnt_wide::gru_rounds(ring, 0, x_s, hb_s, Kp, N8, rank, H, bias_s,
                        bias_s + 3 * H, nh_s, hb_s, ldn);
  ssnt_wide::gru_new_h(nh_s, hb_s, ldn, a.state + (size_t)b * W * H, W, N, H,
                       U, k0);
  if (a.dbg_newh)
    for (int i = tid; i < W * nu; i += kThreads) {
      const int w = i / nu, c = i - w * nu;
      a.dbg_newh[((size_t)b * W + w) * H + k0 + c] = nh_s[w * ldn + c];
    }
  // The rank's partial new_h . out_k (float32) of every beam.
  ssnt_wide::tile_sums(W, D, nu, scr, h_s, [&](int q, int i, float acc) {
    const int w = q / D, d = q - w * D;
    return __fmaf_rn(nh_s[w * ldn + i], hk_s[i * D + d], acc);
  });

  // The partials to every block, added in rank order, then base + (sum +
  // out_b) and the log_softmax.
  cluster_wait();
  {
    const Bcast<float> hp = bcast_of(hp_s);
    for (int c = tid; c < C; c += kThreads)
      hp.put((size_t)rank * C + c, h_s[c]);
  }
  cluster_sync();
  for (int c = tid; c < C; c += kThreads) {
    const int d = c % D;
    float sum = hp_s[c];
    for (int r = 1; r < kCL; ++r) sum = __fadd_rn(sum, hp_s[r * C + c]);
    h_s[c] = __fadd_rn(a.base_path[((size_t)a.s * B + b) * D + d],
                       __fadd_rn(sum, bias_s[4 * H + d]));
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
      if (a.dbg_h && rank == 0) a.dbg_h[((size_t)b * W + tid) * D + d] = row[d];
    }
  }
  __syncthreads();

  // ---- 2. candidate grid, 3. selection (every block, on the same h) ----
  const WideSel sel = wide_sel_at(smem + a.gsm.sel, C);
  for (int c = tid; c < C; c += kThreads) {
    const int w = c / D, d = c - w * D;
    store_wide(sel, c, KIND == kV2
        ? v2_candidate(d, D, h_s[c], bin.lp[w], bin.fin[w], bin.tot[w],
                       bin.t[w], bin.u[w], bin.il, bin.ol, a.dtab, a.v2)
        : tone_candidate(d, h_s[c], bin.lp[w], bin.fin[w], bin.t[w],
                         bin.u[w], bin.il, a.empty_id));
  }
  const int n = wide_select(sel, C, W, KIND == kV2 && !a.v2.test_mode);
  if (rank == 0) {
    for (int j = tid; j < W; j += kThreads) {
      const int src = sel.src[j];
      const size_t i = (size_t)b * W + j;
      a.out.pred[i] = sel.pred[src];
      a.out.lp[i] = sel.lp[src];
      a.out.nt[i] = sel.nt[src];
      a.out.nu[i] = sel.nu[src];
      a.out.fin[i] = (uint8_t)sel.fin[src];
      if (a.out.tot) a.out.tot[i] = sel.tot[src];
      a.out.branch[i] = src / D;
    }
    if (KIND == kV2 && tid == 0) {
      a.o_nsurv[b] = n;
      a.o_emptied[b] = (uint8_t)(a.emptied[b] || n == 0);
    }
  }

  // ---- 4. parent-pointer reorder of the rank's state columns ----
  for (int i = tid; i < W * nu; i += kThreads) {
    const int j = i / nu, c = i - j * nu;
    a.o_state[((size_t)b * W + j) * H + k0 + c] =
        nh_s[(sel.src[j] / D) * ldn + c];
  }
}

template <int KIND>
cudaError_t launch_wgmma(const StepArgs& s, cudaStream_t stream) {
  ClassWgArgs a;
  static_cast<StepArgs&>(a) = s;
  a.gsm = class_wg_smem(a.W, a.D, a.H);
  a.ws = WideStream{};
  if (!ssnt_wide::wide_gru(a.ws, a.H)) return cudaErrorInvalidValue;
  ssnt_wide::wide_finish(a.ws, a.gsm.chunk);
  if (a.gsm.nst < 2 || a.ws.nr != 6 ||
      a.gsm.total + ssnt_wide::kStaticSmemWg + 1024 > kSmemMax)
    return cudaErrorInvalidValue;
  auto kern = fused_class_wgmma_kernel<KIND>;
  static size_t opted = 0;
  if (a.gsm.total > opted) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.gsm.total);
    if (e != cudaSuccess) return e;
    opted = a.gsm.total;
  }
  kern<<<a.B * kCL, kThreads, a.gsm.total, stream>>>(a);
  return cudaGetLastError();
}

template <int KIND, typename CT>
cudaError_t launch_wide(StepArgs a, cudaStream_t stream) {
  if (a.dbg_newh == nullptr) return cudaErrorInvalidValue;
  a.wsm = class_wide_smem(a.W, a.D, a.H, sizeof(CT));
  a.st.n = 1;
  a.st.l[0] = gru_layer(a.H, 0);
  finish_stream(a.st, a.wsm.chunk, sizeof(CT));
  if (a.wsm.nst < 2) return cudaErrorInvalidValue;
  auto kern = fused_class_wide_kernel<KIND, CT>;
  static size_t opted = 0;
  if (a.wsm.total > opted) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.wsm.total);
    if (e != cudaSuccess) return e;
    opted = a.wsm.total;
  }
  kern<<<a.B * kCL, kThreads, a.wsm.total, stream>>>(a);
  return cudaGetLastError();
}

// The wide step takes W > kMaxW or more than kMaxC candidates.
bool is_wide(int W, int D) { return W > kMaxW || W * D > kMaxC; }

template <int KIND, typename CT, int NTN>
cudaError_t launch(StepArgs a, cudaStream_t stream) {
  a.sm = class_smem(NTN * 8, a.D, a.H, sizeof(CT));
  a.st.n = 1;
  a.st.l[0] = gru_layer(a.H, 0);
  finish_stream(a.st, a.sm.chunk, sizeof(CT));
  if (a.sm.nst < 2) return cudaErrorInvalidValue;
  auto kern = fused_class_step_kernel<KIND, CT, NTN>;
  // Opt in to the dynamic shared memory once per size (not inside a CUDA
  // graph capture after the first call).
  static size_t opted = 0;
  if (a.sm.total > opted) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a.sm.total);
    if (e != cudaSuccess) return e;
    opted = a.sm.total;
  }
  kern<<<a.B * kCL, kThreads, a.sm.total, stream>>>(a);
  return cudaGetLastError();
}

template <int KIND>
cudaError_t dispatch(int compute_bf16, const StepArgs& a, cudaStream_t st) {
  if (is_wide(a.W, a.D))
    return compute_bf16 ? launch_wgmma<KIND>(a, st)
                        : launch_wide<KIND, float>(a, st);
  if (compute_bf16) {
    if (a.W <= 8) return launch<KIND, __nv_bfloat16, 1>(a, st);
    return launch<KIND, __nv_bfloat16, 2>(a, st);
  }
  if (a.W <= 8) return launch<KIND, float, 1>(a, st);
  return launch<KIND, float, 2>(a, st);
}

bool bad_shape(int B, int W, int D, int H) {
  return B < 1 || W < 1 || W > kMaxBeams || D < 1 ||
         (long long)W * D > kMaxCands || H < 1 ||
         gru_layer(H, 0).MT > kMaxMT || (long long)B * W * H >= (1ll << 31);
}

void set_common(StepArgs& a, int B, int W, int D, int H, int s,
                const void* xin_path, const void* base_path,
                const void* embed, const void* wpack,
                const void* bi, const void* bhn, const void* out_k,
                const void* out_b, const void* prev_class, const void* state,
                const void* lp, const void* fin, const void* t,
                const void* u, const void* il, void* o_pred, void* o_lp,
                void* o_nt, void* o_nu, void* o_fin, void* o_branch,
                void* o_state, void* dbg_h, void* dbg_newh) {
  a.B = B; a.W = W; a.D = D; a.H = H; a.s = s;
  a.xin_path = xin_path; a.base_path = (const float*)base_path;
  a.embed = embed; a.wpack = wpack; a.bi = bi; a.bhn = bhn;
  a.out_k = (const float*)out_k; a.out_b = (const float*)out_b;
  a.prev_class = (const int*)prev_class; a.state = (const float*)state;
  a.lp = (const float*)lp; a.fin = (const uint8_t*)fin;
  a.t = (const int*)t; a.u = (const int*)u; a.il = (const int*)il;
  a.out.pred = (int*)o_pred; a.out.lp = (float*)o_lp;
  a.out.nt = (int*)o_nt; a.out.nu = (int*)o_nu;
  a.out.fin = (uint8_t*)o_fin; a.out.tot = nullptr;
  a.out.branch = (int*)o_branch;
  a.o_state = (float*)o_state;
  a.dbg_h = (float*)dbg_h; a.dbg_newh = (float*)dbg_newh;
}

}  // namespace

extern "C" int ssnt_fused_step_max_candidates() { return kMaxCands; }
extern "C" int ssnt_fused_step_max_beams() { return kMaxBeams; }
extern "C" int ssnt_fused_cluster_blocks() { return kCL; }
// 1 where the step at (W, D) takes a wide instance. In float32 compute it
// writes new_h before the reorder to the debug output (the wrapper's
// scratch when the caller gives none).
extern "C" int ssnt_fused_class_is_wide(int W, int D) {
  return (int)is_wide(W, D);
}
// 1 where the step takes the bfloat16 wide instance, which reads the wide
// stream (ops/beam_fused.pack_wide_gru) and needs no scratch.
extern "C" int ssnt_fused_class_wide_stream(int compute_bf16, int W, int D) {
  return (int)(compute_bf16 && is_wide(W, D));
}

// Dynamic shared memory (bytes) of one block at these widths, the weight
// ring's 16 or 32 KB slots included.
extern "C" int ssnt_fused_class_smem_bytes(int compute_bf16, int W, int D,
                                           int H) {
  const int cs = compute_bf16 ? 2 : 4;
  if (is_wide(W, D))
    return (int)(compute_bf16 ? class_wg_smem(W, D, H).total
                              : class_wide_smem(W, D, H, cs).total);
  return (int)class_smem(W <= 8 ? 8 : 16, D, H, cs).total;
}

// Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int ssnt_fused_v2_step(
    int compute_bf16, int B, int W, int D, int H, int s,
    const void* xin_path, const void* base_path, const void* embed,
    const void* wpack, const void* bi, const void* bhn,
    const void* out_k, const void* out_b, const void* prev_class,
    const void* state, const void* lp, const void* fin, const void* tot,
    const void* t, const void* u, const void* il, const void* ol,
    const void* dtab, const void* emptied, void* o_pred, void* o_lp,
    void* o_nt, void* o_nu, void* o_fin, void* o_tot, void* o_branch,
    void* o_nsurv, void* o_emptied, void* o_state, void* dbg_h,
    void* dbg_newh, int zero_id, int allow_skip, int test_mode,
    int overrun_mult, int feas_guard, float band_lower, float band_upper,
    float diag_lo, float diag_hi, void* stream) {
  if (bad_shape(B, W, D, H)) return (int)cudaErrorInvalidValue;
  StepArgs a;
  set_common(a, B, W, D, H, s, xin_path, base_path, embed, wpack, bi, bhn,
             out_k, out_b, prev_class, state, lp, fin, t, u, il, o_pred,
             o_lp, o_nt, o_nu, o_fin, o_branch, o_state, dbg_h, dbg_newh);
  a.tot = (const int*)tot; a.ol = (const int*)ol; a.dtab = (const int*)dtab;
  a.emptied = (const uint8_t*)emptied;
  a.out.tot = (int*)o_tot;
  a.o_nsurv = (int*)o_nsurv; a.o_emptied = (uint8_t*)o_emptied;
  a.v2.zero_id = zero_id; a.v2.allow_skip = allow_skip;
  a.v2.test_mode = test_mode; a.v2.overrun_mult = overrun_mult;
  a.v2.feas_guard = feas_guard;
  a.v2.band_lower = band_lower; a.v2.band_upper = band_upper;
  a.v2.diag_lo = diag_lo; a.v2.diag_hi = diag_hi;
  a.empty_id = 0;
  return (int)dispatch<kV2>(compute_bf16, a, (cudaStream_t)stream);
}

// Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int ssnt_fused_tone_step(
    int compute_bf16, int B, int W, int K, int H, int s,
    const void* xin_path, const void* base_path, const void* embed,
    const void* wpack, const void* bi, const void* bhn,
    const void* out_k, const void* out_b, const void* prev_class,
    const void* state, const void* lp, const void* fin, const void* t,
    const void* u, const void* il, void* o_pred, void* o_lp, void* o_nt,
    void* o_nu, void* o_fin, void* o_branch, void* o_state, void* dbg_h,
    void* dbg_newh, int empty_id, void* stream) {
  if (bad_shape(B, W, K, H)) return (int)cudaErrorInvalidValue;
  StepArgs a;
  set_common(a, B, W, K, H, s, xin_path, base_path, embed, wpack, bi, bhn,
             out_k, out_b, prev_class, state, lp, fin, t, u, il, o_pred,
             o_lp, o_nt, o_nu, o_fin, o_branch, o_state, dbg_h, dbg_newh);
  a.tot = nullptr; a.ol = nullptr; a.dtab = nullptr; a.emptied = nullptr;
  a.o_nsurv = nullptr; a.o_emptied = nullptr;
  a.v2 = V2Opts{0, 0, 1, 0, 0, 0.0f, 0.0f, 0.0f, 0.0f};
  a.empty_id = empty_id;
  return (int)dispatch<kTone>(compute_bf16, a, (cudaStream_t)stream);
}
