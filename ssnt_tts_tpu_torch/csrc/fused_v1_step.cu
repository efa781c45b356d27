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
//        logit_k = sum_r rnd(rnd(p_kr) * q_kr) (float32)
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
// What bounds it on an H100: latency, not bytes or operations. A frame is
// ~0.27 GFLOP at B=32, W=8 (prenet, GRU and joints, ~526k MAC per beam)
// over ~1.05 MB of bfloat16 weights that stay in the 50 MB L2 (bound 0.6
// us). The first version ran one 256-thread block per utterance (32 of 132
// SMs at B=32), one thread per output column walking its inputs serially
// with a global load each: ~1,100 dependent L2 loads a frame (0.280 ms).
// This design:
//   - a cluster of kCL = 2 blocks per utterance (64 blocks at B=32), block
//     r owning half of every layer's output columns (prenet 128 of 256,
//     GRU hidden units [128 r, 128 r + 128) with their gates, dec_pre 32
//     of 64, mel 48-column shares, dec_proj 64 of 128); after each layer
//     a block writes its slice of the activations into both blocks of the
//     cluster through distributed shared memory, then a cluster barrier
//     (five a frame). Clusters of 4 ran in two waves on an H100;
//   - every dot on tensor cores in bfloat16 (mma.sync m16n8k16, the beams
//     as the n = 8 side; float32 as FMAs over the same tiles), layers of
//     fewer than eight column tiles split over the warps by input tile;
//   - the rank's ~520 KB of packed weight tiles (bfloat16) streamed in
//     the order the layers use them into a ring of 16 or 32 KB
//     shared-memory slots by TMA bulk copies, issued at the frame's start
//     and refilled as each slot is consumed (by thread 0 after the block's
//     barrier that closes the slot), so the loads overlap the gathers, the
//     cluster barriers and each other;
//   - the state, the biases and the beams' carry read into shared memory
//     at the start; the dec_bias dot as per-rank partial sums over the
//     rank's units (spread over the block), exchanged with the GRU's
//     output and added in rank order; the rank sums computed by both
//     blocks from the same q: both hold the same log-probs and run the same
//     selection. Block 0 writes the beam outputs; each block reorders its
//     own state and mel columns.
// Beams: W <= kMaxW = 16 in one beam tile (8 or 16); up to kMaxBeams =
// 128 a wide instance, then wide_select over the 2W candidates. In
// bfloat16 that is fused_v1_wgmma_kernel (wide_step.cuh): the frame's
// layers as rounds of wgmma m64nNk16 products with every beam on the N
// side, the rank's wide stream crossing L2 into shared memory once a
// frame whatever W (the tile loop it replaced ran the whole stream a tile
// of 16 beams: 0.82 ms at W = 128, B = 32 on an H100 SXM). In float32
// (TF32 is not float32) it is fused_v1_wide_kernel: the narrow step's FMAs
// a tile of 16 beams at a time, the whole weight stream a tile.
// What holds it now (ssnt_tts_tpu_torch/probe_fused.py; numbers in
// PERF.md): the GRU's weight stream, at the rate one SM pulls from L2
// into shared memory; the prologue; and the single-slot layers (prenet,
// dec_pre, mel, dec_proj), whose code runs once per launch and fetches its
// instructions from L2 (the kernel is ~16k instructions).
//
// Layouts (row-major, contiguous): enc_pack (B, T, 2R+2+M) f32; t/u (B, W)
// i32; log_prob (B, W) f32; is_finished (B, W) bool (1 byte);
// input_length (B,) i32; prev_mel (B, W, M) f32; state (B, W, H) f32;
// biases in CT: prenet b1 (H), b2 (H), bi (3H), bhn (H), dec_pre_b (R),
// dec_proj_b (2R), dec_mel_b (M); wpack (kCL, tiles x 256) in CT: the
// kernels prenet w1 (M, H), w2 (H, H), wi/wh (H, 3H), dec_pre_k (H, R),
// dec_mel_k (H, M), dec_proj_k (R, 2R) packed by ops/beam_fused (one
// stream per cluster rank, in that order, gru_step.cuh's tile layout;
// the bfloat16 wide instance: (kCL, tiles x 1024), wide_step.cuh's layout,
// packed by pack_wide_dense / pack_wide_gru);
// f32: dec_bias_k (H, 2), dec_bias_b (2). Outputs: (B, W) prediction,
// log_prob, next_t, next_u, is_finished, branch, t_history; mel (B, W, M)
// and state (B, W, H) f32, reordered. Optional debug outputs (null to
// skip): h (B, W, 2), new_h (B, W, H) and mel (B, W, M) before the
// reorder.

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

// The rank's weight stream, in the order the frame runs the layers.
enum { kPre1 = 0, kPre2, kGru, kDecPre, kMel, kProj, kNumLayers };

// Bias offsets in the block's float copy: b1, b2, bi, bhn, dec_pre_b,
// dec_proj_b, dec_mel_b, dec_bias_b.
struct V1Bias {
  int b1, b2, bi, bhn, pre, proj, mel, db, n;
};

__host__ __device__ inline V1Bias v1_bias(int H, int M, int R) {
  V1Bias o;
  o.b1 = 0; o.b2 = H; o.bi = 2 * H; o.bhn = 5 * H; o.pre = 6 * H;
  o.proj = o.pre + R; o.mel = o.proj + 2 * R; o.db = o.mel + M; o.n = o.db + 2;
  return o;
}

Stream v1_stream(int H, int M, int R) {
  Stream s;
  s.n = kNumLayers;
  const int dims[kNumLayers][2] = {{M, H}, {H, H}, {H, H},
                                   {H, R}, {H, M}, {R, 2 * R}};
  int t0 = 0;
  for (int i = 0; i < kNumLayers; ++i) {
    s.l[i] = i == kGru ? gru_layer(H, t0)
                       : dense_layer(dims[i][0], dims[i][1], t0);
    t0 += layer_tiles(s.l[i]);
  }
  return s;
}

// Dynamic shared memory of one block, byte offsets.
struct V1Smem {
  size_t x0, x1, x, hb, hn, stf, bias, pre, q, g, nh, mel, stg, dbk, dbp,
      scr, sums, part, h, bar, ring, total;
  int nst, chunk;
};

V1Smem v1_smem(int WN, int H, int M, int R, int csize) {
  const Stream st = v1_stream(H, M, R);
  const int U = st.l[kGru].MT / 6 * 16, P = 2 * R + 2 + M;
  size_t stg = 0;
  for (int i = 0; i < kNumLayers; ++i) {
    const size_t n = (size_t)ksplit(st.l[i]) * st.l[i].MT * 16 * WN;
    stg = n > stg ? n : stg;
  }
  const size_t ah = (size_t)WN * act_ld(H) * csize;
  Carve c;
  V1Smem s;
  s.x0 = c.take((size_t)WN * act_ld(M) * csize);
  s.x1 = c.take(ah);
  s.x = c.take(ah);
  s.hb = c.take(ah);
  // rnd(new_h) takes the prenet's hidden layer's place: every block of the
  // cluster is past the prenet when the GRU's outputs arrive.
  s.hn = s.x1;
  // float32 state rows (stride act_ld(H)); in float32 compute, hb itself
  s.stf = csize == 4 ? s.hb : c.take((size_t)WN * act_ld(H) * sizeof(float));
  s.bias = c.take(sizeof(float) * v1_bias(H, M, R).n);
  s.pre = c.take((size_t)WN * act_ld(R) * csize);
  s.q = c.take(sizeof(float) * WN * 2 * R);
  s.g = c.take(sizeof(float) * WN * P);
  s.nh = c.take(sizeof(float) * WN * U);
  s.mel = c.take(sizeof(float) * WN * st.l[kMel].MT * 16);
  s.stg = c.take(sizeof(float) * stg);
  s.dbk = c.take(sizeof(float) * U * 2);
  s.dbp = c.take(sizeof(float) * kCL * 2 * kMaxW);
  s.scr = c.take(sizeof(float) * kThreads);
  s.sums = c.take(sizeof(float) * 2 * kMaxW);
  s.part = c.take(sizeof(float) * 2 * kMaxW);
  s.h = c.take(sizeof(float) * 2 * kMaxW);
  s.bar = c.take(sizeof(uint64_t) * kMaxStages);
  s.ring = c.at;
  const RingShape r = ring_shape(s.ring);
  s.nst = r.nst;
  s.chunk = r.chunk;
  s.total = s.ring + (size_t)s.nst * s.chunk;
  return s;
}

// The wide step's dynamic shared memory (W > kMaxW), byte offsets: the
// narrow layout of one beam tile (kTileBeams beams), whose buffers the
// selection's fields take over after the last tile, and the log-probs of
// every beam.
struct V1WideSmem {
  V1Smem t;      // the tile's buffers (t.h unused)
  size_t sel, h, total;
};

V1WideSmem v1_wide_smem(int W, int H, int M, int R, int csize) {
  V1WideSmem s;
  s.t = v1_smem(kTileBeams, H, M, R, csize);
  Carve c;
  c.at = s.t.bar;  // the tile's buffers end at its barriers
  s.sel = 0;
  const size_t sel = wide_sel_bytes(2 * W);
  if (c.at < sel) c.take(sel - c.at);
  s.h = c.take(sizeof(float) * 2 * W);
  s.t.bar = c.take(sizeof(uint64_t) * kMaxStages);
  s.t.ring = c.at;
  const RingShape r = ring_shape(s.t.ring, kStaticSmemWide);
  s.t.nst = r.nst;
  s.t.chunk = r.chunk;
  s.t.total = s.total = s.t.ring + (size_t)s.t.nst * s.t.chunk;
  return s;
}

struct V1Args {
  int B, W, T, H, M, R;
  const float* enc_pack; const int* t; const int* u; const float* lp;
  const uint8_t* fin; const int* il; const float* prev_mel;
  const float* state; const void* wpack;
  const void* pb1; const void* pb2; const void* bi; const void* bhn;
  const void* dpre_b; const void* dproj_b; const float* dbias_k;
  const float* dbias_b; const void* dmel_b;
  BeamOut out;
  int* o_thist; float* o_mel; float* o_state;
  float* dbg_h; float* dbg_newh; float* dbg_mel;
  Stream st;
  V1Smem sm;
  V1WideSmem wsm;
};

// minBlocks 1 as in fused_class_step.cu: one block per SM.
template <typename CT, int NTN>
__global__ void __cluster_dims__(kCL, 1, 1) __launch_bounds__(kThreads, 1)
fused_v1_step_kernel(const __grid_constant__ V1Args a) {
  constexpr int WN = NTN * 8;
  const int rank = (int)cg::this_cluster().block_rank();
  const int b = blockIdx.x / kCL, tid = threadIdx.x;
  const int W = a.W, T = a.T, H = a.H, M = a.M, R = a.R;
  const int R2 = 2 * R, P = R2 + 2 + M, C = 2 * W;
  const size_t bw = (size_t)b * W;
  const Layer* L = a.st.l;  // scalars only; the ring reads st_s
  const int U = L[kGru].MT / 6 * 16, k0 = rank * U;
  const int nu = max(0, min(U, H - k0));
  const int UM = L[kMel].MT * 16, m0 = rank * UM;
  const int nm = max(0, min(UM, M - m0));
  const int ldm = act_ld(M), ldh = act_ld(H), ldr = act_ld(R);

  extern __shared__ __align__(128) unsigned char smem[];
  auto f32 = [&](size_t off) { return reinterpret_cast<float*>(smem + off); };
  auto act = [&](size_t off) { return reinterpret_cast<CT*>(smem + off); };
  CT* x0_s = act(a.sm.x0);    // (WN, ldm) rnd(prev_mel)
  CT* x1_s = act(a.sm.x1);    // (WN, ldh) prenet hidden
  CT* x_s = act(a.sm.x);      // (WN, ldh) GRU input
  CT* hb_s = act(a.sm.hb);    // (WN, ldh) rnd(state)
  CT* hn_s = act(a.sm.hn);    // (WN, ldh) rnd(new_h), in x1's place
  float* stf_s = f32(a.sm.stf);  // (WN, ldh) state
  float* bias_s = f32(a.sm.bias);
  const V1Bias bo = v1_bias(H, M, R);
  CT* pre_s = act(a.sm.pre);  // (WN, ldr) pre
  float* q_s = f32(a.sm.q);   // (WN, 2R) q
  float* g_s = f32(a.sm.g);   // (WN, P) gathered enc_pack rows
  float* nh_s = f32(a.sm.nh);    // (WN, U) the rank's new_h
  float* mel_s = f32(a.sm.mel);  // (WN, UM) the rank's mel, pre-reorder
  float* stg = f32(a.sm.stg);
  float* dbk_s = f32(a.sm.dbk);  // (U, 2) the rank's dec_bias_k rows
  float* dbp_s = f32(a.sm.dbp);  // (kCL, 2 kMaxW) dec_bias partials
  float* scr = f32(a.sm.scr);
  float* sums_s = f32(a.sm.sums);
  float* part_s = f32(a.sm.part);
  float* h_s = f32(a.sm.h);      // (W, 2) logits, then log-probs
  __shared__ SelectSmem sel;
  __shared__ Stream st_s;  // the weight stream's layers
  __shared__ BeamIn bin;   // the beams' carry

  if (tid == 0) st_s = a.st;
  Ring<CT> ring{act(a.sm.ring), reinterpret_cast<uint64_t*>(smem + a.sm.bar),
                static_cast<const CT*>(a.wpack) +
                    (size_t)rank * a.st.tiles * kTile,
                &st_s, a.sm.nst, 0};
  ring.start();
  load_beams(bin, b, W, a.lp, a.fin, a.t, a.u, nullptr, nullptr, a.il,
             nullptr);

  // ---- 0. loads (zero padding: beams >= W, inputs past the width) ----
#pragma unroll 4
  for (int i = tid; i < WN * ldm; i += kThreads) {
    const int w = i / ldm, k = i - w * ldm;
    x0_s[i] = st<CT>(w < W && k < M ? rnd<CT>(a.prev_mel[(bw + w) * M + k])
                                    : 0.0f);
  }
#pragma unroll 4
  for (int i = tid; i < WN * ldh; i += kThreads) {
    const int w = i / ldh, k = i - w * ldh;
    const float sv = w < W && k < H ? a.state[(bw + w) * H + k] : 0.0f;
    stf_s[i] = sv;  // in float32 compute this is hb_s, rnd(state) itself
    hb_s[i] = st<CT>(rnd<CT>(sv));
    x1_s[i] = x_s[i] = st<CT>(0.0f);
  }
  for (int i = tid; i < WN * ldr; i += kThreads) pre_s[i] = st<CT>(0.0f);
  load_segs(bias_s, Segs<CT, 8>{
      {a.pb1, a.pb2, a.bi, a.bhn, a.dpre_b, a.dproj_b, a.dmel_b, a.dbias_b},
      {H, H, 3 * H, H, R, 2 * R, M, 2},
      {bo.b1, bo.b2, bo.bi, bo.bhn, bo.pre, bo.proj, bo.mel, bo.db},
      {false, false, false, false, false, false, false, true}});
  load_segs(dbk_s, Segs<CT, 1>{{a.dbias_k + k0 * 2}, {nu * 2}, {0}, {true}});
  __syncthreads();  // bin.t
#pragma unroll 4
  for (int i = tid; i < W * P; i += kThreads) {
    const int w = i / P, j = i - w * P;
    const int row = min(max(bin.t[w], 0), T - 1);
    g_s[i] = a.enc_pack[((size_t)b * T + row) * P + j];
  }
  cluster_arrive();  // this block's buffers are ready for its peers
  __syncthreads();

  // ---- 1. model step ----
  // x = relu(rnd(rnd(prev_mel . w1) + b1)), twice (the prenet)
  dot_layer<CT, NTN>(ring, st_s.l[kPre1], x0_s, x0_s, ldm, stg);
  cluster_wait();
  {
    const Bcast<CT> o = bcast_of(x1_s);
    dense_epilogue<CT, WN, kRelu>(
        L[kPre1], stg, rank, W, bias_s + bo.b1, [&](int w, int n, int, float y) {
          o.put((size_t)w * ldh + n, st<CT>(y));
        });
  }
  cluster_sync();
  dot_layer<CT, NTN>(ring, st_s.l[kPre2], x1_s, x1_s, ldh, stg);
  {
    const Bcast<CT> o = bcast_of(x_s);
    dense_epilogue<CT, WN, kRelu>(
        L[kPre2], stg, rank, W, bias_s + bo.b2, [&](int w, int n, int, float y) {
          o.put((size_t)w * ldh + n, st<CT>(y));
        });
  }
  cluster_sync();
  // new_h = the GRU cell; rnd(new_h) to every block
  dot_layer<CT, NTN>(ring, st_s.l[kGru], x_s, hb_s, ldh, stg);
  {
    const Bcast<CT> o = bcast_of(hn_s);
    gru_epilogue<CT, WN>(L[kGru], stg, rank, W, bias_s + bo.bi,
                         bias_s + bo.bhn, stf_s, ldh, nh_s,
                         a.dbg_newh ? a.dbg_newh + bw * H : nullptr,
                         [&](int w, int k, float nh) {
                           o.put((size_t)w * ldh + k, st<CT>(rnd<CT>(nh)));
                         });
  }
  __syncthreads();
  // The rank's partial new_h . dec_bias_k (float32), to every block.
  block_sums(C, nu, scr, part_s, [&](int o, int i, float acc) {
    return __fmaf_rn(nh_s[(o >> 1) * U + i], dbk_s[i * 2 + (o & 1)], acc);
  });
  {
    const Bcast<float> o = bcast_of(dbp_s);
    if (tid < C) o.put((size_t)rank * 2 * kMaxW + tid, part_s[tid]);
  }
  cluster_sync();
  // pre = rnd(tanh(rnd(rnd(rnd(new_h) . dec_pre_k) + dec_pre_b)))
  dot_layer<CT, NTN>(ring, st_s.l[kDecPre], hn_s, hn_s, ldh, stg);
  {
    const Bcast<CT> o = bcast_of(pre_s);
    dense_epilogue<CT, WN, kTanh>(
        L[kDecPre], stg, rank, W, bias_s + bo.pre,
        [&](int w, int n, int, float y) {
          o.put((size_t)w * ldr + n, st<CT>(y));
        });
  }
  // mel = rnd(rnd(em) + rnd(rnd(rnd(new_h) . dec_mel_k) + dec_mel_b)) for
  // the rank's columns
  dot_layer<CT, NTN>(ring, st_s.l[kMel], hn_s, hn_s, ldh, stg);
  dense_epilogue<CT, WN, kLinear>(
      L[kMel], stg, rank, W, bias_s + bo.mel, [&](int w, int n, int c, float y) {
        const float m = rnd<CT>(__fadd_rn(rnd<CT>(g_s[w * P + R2 + 2 + n]), y));
        mel_s[w * UM + c] = m;
        if (a.dbg_mel) a.dbg_mel[(bw + w) * M + n] = m;
      });
  cluster_sync();
  // q = rnd(rnd(pre . dec_proj_k) + dec_proj_b), to every block
  dot_layer<CT, NTN>(ring, st_s.l[kProj], pre_s, pre_s, ldr, stg);
  {
    const Bcast<float> o = bcast_of(q_s);
    dense_epilogue<CT, WN, kLinear>(
        L[kProj], stg, rank, W, bias_s + bo.proj,
        [&](int w, int n, int, float y) { o.put((size_t)w * R2 + n, y); });
  }
  cluster_sync();

  // logit_k = sum_r rnd(rnd(p_kr) * q_kr) + enc_bias_k + (new_h .
  // dec_bias_k + dec_bias_b_k), the same in every block
  block_sums(C, R, scr, sums_s, [&](int o, int i, float acc) {
    const int w = o >> 1, r = (o & 1) * R + i;
    return __fadd_rn(acc, rnd<CT>(__fmul_rn(rnd<CT>(g_s[w * P + r]),
                                            q_s[w * R2 + r])));
  });
  if (tid < C) {
    const int w = tid >> 1, c = tid & 1;
    float db = dbp_s[tid];
    for (int r = 1; r < kCL; ++r) db = __fadd_rn(db, dbp_s[r * 2 * kMaxW + tid]);
    db = __fadd_rn(db, bias_s[bo.db + c]);
    h_s[tid] = __fadd_rn(__fadd_rn(sums_s[tid], g_s[w * P + R2 + c]), db);
  }
  __syncthreads();
  if (tid < W) {  // log_softmax: shifted - log(exp + exp)
    const float le = h_s[2 * tid], ls = h_s[2 * tid + 1];
    const float m = fmaxf(le, ls);
    const float she = __fsub_rn(le, m), shs = __fsub_rn(ls, m);
    const float lse = logf(__fadd_rn(expf(she), expf(shs)));
    h_s[2 * tid] = __fsub_rn(she, lse);
    h_s[2 * tid + 1] = __fsub_rn(shs, lse);
    if (a.dbg_h && rank == 0) {
      a.dbg_h[2 * (bw + tid)] = h_s[2 * tid];
      a.dbg_h[2 * (bw + tid) + 1] = h_s[2 * tid + 1];
    }
  }
  __syncthreads();

  // ---- 2. candidates, 3. selection (every block, on the same h) ----
  bool valid = false;
  if (tid < C) {
    const int w = tid >> 1, k = tid & 1;
    const Cand x = v1_candidate(k, h_s[tid], bin.lp[w], bin.fin[w], bin.t[w],
                                bin.u[w], bin.il);
    store_cand(sel, tid, x);
    valid = x.valid;
  }
  select_beams(sel, C, W, valid, false);
  if (rank == 0) {
    write_selected(sel, b, W, 2, a.out);
    if (tid < W) a.o_thist[bw + tid] = bin.t[sel.src[tid] / 2];
  }

  // ---- 4. reorders of the rank's columns, finished-beam keep ----
  for (int i = tid; i < W * nu; i += kThreads) {
    const int j = i / nu, c = i - j * nu;
    a.o_state[(bw + j) * H + k0 + c] = nh_s[(sel.src[j] / 2) * U + c];
  }
  for (int i = tid; i < W * nm; i += kThreads) {
    const int j = i / nm, c = i - j * nm;
    const int src = sel.src[j], parent = src / 2;
    const bool keep = sel.fin[src] && bin.fin[parent];
    a.o_mel[(bw + j) * M + m0 + c] =
        keep ? a.prev_mel[(bw + parent) * M + m0 + c] : mel_s[parent * UM + c];
  }
}

// The wide step: the narrow kernel's model step over tiles of kTileBeams
// beams, the weight stream run once a tile (the ring's passes). Each tile
// writes its new_h and mel, before the reorder, to a.dbg_newh and
// a.dbg_mel (scratch the wrapper provides when the caller does not) and
// its log-probs to h_s; then the candidates of every beam, wide_select,
// and the reorders from the scratch (the block's own columns).
template <typename CT>
__global__ void __cluster_dims__(kCL, 1, 1) __launch_bounds__(kThreads, 1)
fused_v1_wide_kernel(const __grid_constant__ V1Args a) {
  constexpr int NTN = kTileBeams / 8, WN = kTileBeams, kDbp = 2 * WN;
  const int rank = (int)cg::this_cluster().block_rank();
  const int b = blockIdx.x / kCL, tid = threadIdx.x;
  const int W = a.W, T = a.T, H = a.H, M = a.M, R = a.R;
  const int R2 = 2 * R, P = R2 + 2 + M, C = 2 * W;
  const size_t bw = (size_t)b * W;
  const Layer* L = a.st.l;  // scalars only; the ring reads st_s
  const int U = L[kGru].MT / 6 * 16, k0 = rank * U;
  const int nu = max(0, min(U, H - k0));
  const int UM = L[kMel].MT * 16, m0 = rank * UM;
  const int nm = max(0, min(UM, M - m0));
  const int ldm = act_ld(M), ldh = act_ld(H), ldr = act_ld(R);
  const V1Smem& sm = a.wsm.t;

  extern __shared__ __align__(128) unsigned char smem[];
  auto f32 = [&](size_t off) { return reinterpret_cast<float*>(smem + off); };
  auto act = [&](size_t off) { return reinterpret_cast<CT*>(smem + off); };
  CT* x0_s = act(sm.x0);    // (WN, ldm) rnd(prev_mel)
  CT* x1_s = act(sm.x1);    // (WN, ldh) prenet hidden
  CT* x_s = act(sm.x);      // (WN, ldh) GRU input
  CT* hb_s = act(sm.hb);    // (WN, ldh) rnd(state)
  CT* hn_s = act(sm.hn);    // (WN, ldh) rnd(new_h), in x1's place
  float* stf_s = f32(sm.stf);  // (WN, ldh) state
  float* bias_s = f32(sm.bias);
  const V1Bias bo = v1_bias(H, M, R);
  CT* pre_s = act(sm.pre);  // (WN, ldr) pre
  float* q_s = f32(sm.q);   // (WN, 2R) q
  float* g_s = f32(sm.g);   // (WN, P) gathered enc_pack rows
  float* nh_s = f32(sm.nh);    // (WN, U) the rank's new_h
  float* stg = f32(sm.stg);
  float* dbk_s = f32(sm.dbk);  // (U, 2) the rank's dec_bias_k rows
  float* dbp_s = f32(sm.dbp);  // (kCL, 2 WN) dec_bias partials
  float* scr = f32(sm.scr);
  float* sums_s = f32(sm.sums);
  float* part_s = f32(sm.part);
  float* h_s = f32(a.wsm.h);   // (W, 2) logits, then log-probs
  float* newh = a.dbg_newh + bw * H;  // (W, H) before the reorder
  float* melb = a.dbg_mel + bw * M;   // (W, M) before the reorder
  __shared__ Stream st_s;     // the weight stream's layers
  __shared__ BeamInWide bin;  // the beams' carry

  if (tid == 0) st_s = a.st;
  Ring<CT> ring{act(sm.ring), reinterpret_cast<uint64_t*>(smem + sm.bar),
                static_cast<const CT*>(a.wpack) +
                    (size_t)rank * a.st.tiles * kTile,
                &st_s, sm.nst, 0};
  ring.passes = (W + WN - 1) / WN;
  ring.start();
  load_beams(bin, b, W, a.lp, a.fin, a.t, a.u, nullptr, nullptr, a.il,
             nullptr);
  load_segs(bias_s, Segs<CT, 8>{
      {a.pb1, a.pb2, a.bi, a.bhn, a.dpre_b, a.dproj_b, a.dmel_b, a.dbias_b},
      {H, H, 3 * H, H, R, 2 * R, M, 2},
      {bo.b1, bo.b2, bo.bi, bo.bhn, bo.pre, bo.proj, bo.mel, bo.db},
      {false, false, false, false, false, false, false, true}});
  load_segs(dbk_s, Segs<CT, 1>{{a.dbias_k + k0 * 2}, {nu * 2}, {0}, {true}});

  for (int w0 = 0; w0 < W; w0 += WN) {
    const int Wt = min(WN, W - w0), Ct = 2 * Wt;
    const size_t tw = bw + w0;  // the tile's first beam row
    __syncthreads();  // bin; the previous tile's reads of g_s
    // ---- 0. the tile's loads (zero padding: beams >= Wt, inputs past
    // the width) ----
#pragma unroll 4
    for (int i = tid; i < WN * ldm; i += kThreads) {
      const int w = i / ldm, k = i - w * ldm;
      x0_s[i] = st<CT>(w < Wt && k < M
                           ? rnd<CT>(a.prev_mel[(tw + w) * M + k]) : 0.0f);
    }
#pragma unroll 4
    for (int i = tid; i < WN * ldh; i += kThreads) {
      const int w = i / ldh, k = i - w * ldh;
      const float sv = w < Wt && k < H ? a.state[(tw + w) * H + k] : 0.0f;
      stf_s[i] = sv;  // in float32 compute this is hb_s, rnd(state) itself
      hb_s[i] = st<CT>(rnd<CT>(sv));
      x1_s[i] = x_s[i] = st<CT>(0.0f);
    }
    for (int i = tid; i < WN * ldr; i += kThreads) pre_s[i] = st<CT>(0.0f);
#pragma unroll 4
    for (int i = tid; i < Wt * P; i += kThreads) {
      const int w = i / P, j = i - w * P;
      const int row = min(max(bin.t[w0 + w], 0), T - 1);
      g_s[i] = a.enc_pack[((size_t)b * T + row) * P + j];
    }
    cluster_arrive();  // this block's buffers are ready for its peers
    __syncthreads();

    // ---- 1. model step of the tile's beams ----
    dot_layer<CT, NTN>(ring, st_s.l[kPre1], x0_s, x0_s, ldm, stg);
    cluster_wait();
    {
      const Bcast<CT> o = bcast_of(x1_s);
      dense_epilogue<CT, WN, kRelu>(
          L[kPre1], stg, rank, Wt, bias_s + bo.b1,
          [&](int w, int n, int, float y) {
            o.put((size_t)w * ldh + n, st<CT>(y));
          });
    }
    cluster_sync();
    dot_layer<CT, NTN>(ring, st_s.l[kPre2], x1_s, x1_s, ldh, stg);
    {
      const Bcast<CT> o = bcast_of(x_s);
      dense_epilogue<CT, WN, kRelu>(
          L[kPre2], stg, rank, Wt, bias_s + bo.b2,
          [&](int w, int n, int, float y) {
            o.put((size_t)w * ldh + n, st<CT>(y));
          });
    }
    cluster_sync();
    dot_layer<CT, NTN>(ring, st_s.l[kGru], x_s, hb_s, ldh, stg);
    {
      const Bcast<CT> o = bcast_of(hn_s);
      gru_epilogue<CT, WN>(L[kGru], stg, rank, Wt, bias_s + bo.bi,
                           bias_s + bo.bhn, stf_s, ldh, nh_s,
                           newh + (size_t)w0 * H,
                           [&](int w, int k, float nh) {
                             o.put((size_t)w * ldh + k, st<CT>(rnd<CT>(nh)));
                           });
    }
    __syncthreads();
    block_sums(Ct, nu, scr, part_s, [&](int o, int i, float acc) {
      return __fmaf_rn(nh_s[(o >> 1) * U + i], dbk_s[i * 2 + (o & 1)], acc);
    });
    {
      const Bcast<float> o = bcast_of(dbp_s);
      if (tid < Ct) o.put((size_t)rank * kDbp + tid, part_s[tid]);
    }
    cluster_sync();
    dot_layer<CT, NTN>(ring, st_s.l[kDecPre], hn_s, hn_s, ldh, stg);
    {
      const Bcast<CT> o = bcast_of(pre_s);
      dense_epilogue<CT, WN, kTanh>(
          L[kDecPre], stg, rank, Wt, bias_s + bo.pre,
          [&](int w, int n, int, float y) {
            o.put((size_t)w * ldr + n, st<CT>(y));
          });
    }
    dot_layer<CT, NTN>(ring, st_s.l[kMel], hn_s, hn_s, ldh, stg);
    dense_epilogue<CT, WN, kLinear>(
        L[kMel], stg, rank, Wt, bias_s + bo.mel,
        [&](int w, int n, int, float y) {
          melb[(size_t)(w0 + w) * M + n] =
              rnd<CT>(__fadd_rn(rnd<CT>(g_s[w * P + R2 + 2 + n]), y));
        });
    cluster_sync();
    dot_layer<CT, NTN>(ring, st_s.l[kProj], pre_s, pre_s, ldr, stg);
    {
      const Bcast<float> o = bcast_of(q_s);
      dense_epilogue<CT, WN, kLinear>(
          L[kProj], stg, rank, Wt, bias_s + bo.proj,
          [&](int w, int n, int, float y) { o.put((size_t)w * R2 + n, y); });
    }
    cluster_sync();
    block_sums(Ct, R, scr, sums_s, [&](int o, int i, float acc) {
      const int w = o >> 1, r = (o & 1) * R + i;
      return __fadd_rn(acc, rnd<CT>(__fmul_rn(rnd<CT>(g_s[w * P + r]),
                                              q_s[w * R2 + r])));
    });
    if (tid < Ct) {
      const int w = tid >> 1, c = tid & 1;
      float db = dbp_s[tid];
      for (int r = 1; r < kCL; ++r) db = __fadd_rn(db, dbp_s[r * kDbp + tid]);
      db = __fadd_rn(db, bias_s[bo.db + c]);
      h_s[2 * w0 + tid] =
          __fadd_rn(__fadd_rn(sums_s[tid], g_s[w * P + R2 + c]), db);
    }
  }
  __syncthreads();
  if (tid < W) {  // log_softmax: shifted - log(exp + exp)
    const float le = h_s[2 * tid], ls = h_s[2 * tid + 1];
    const float m = fmaxf(le, ls);
    const float she = __fsub_rn(le, m), shs = __fsub_rn(ls, m);
    const float lse = logf(__fadd_rn(expf(she), expf(shs)));
    h_s[2 * tid] = __fsub_rn(she, lse);
    h_s[2 * tid + 1] = __fsub_rn(shs, lse);
    if (a.dbg_h && rank == 0) {
      a.dbg_h[2 * (bw + tid)] = h_s[2 * tid];
      a.dbg_h[2 * (bw + tid) + 1] = h_s[2 * tid + 1];
    }
  }
  __syncthreads();

  // ---- 2. candidates, 3. selection (every block, on the same h) ----
  const WideSel sel = wide_sel_at(smem + a.wsm.sel, C);
  for (int c = tid; c < C; c += kThreads) {
    const int w = c >> 1, k = c & 1;
    store_wide(sel, c, v1_candidate(k, h_s[c], bin.lp[w], bin.fin[w],
                                    bin.t[w], bin.u[w], bin.il));
  }
  wide_select(sel, C, W, false);
  if (rank == 0) {
    for (int j = tid; j < W; j += kThreads) {
      const int src = sel.src[j];
      const size_t i = bw + j;
      a.out.pred[i] = sel.pred[src];
      a.out.lp[i] = sel.lp[src];
      a.out.nt[i] = sel.nt[src];
      a.out.nu[i] = sel.nu[src];
      a.out.fin[i] = (uint8_t)sel.fin[src];
      a.out.branch[i] = src / 2;
      a.o_thist[i] = bin.t[src / 2];
    }
  }

  // ---- 4. reorders of the rank's columns, finished-beam keep ----
  for (int i = tid; i < W * nu; i += kThreads) {
    const int j = i / nu, c = i - j * nu;
    a.o_state[(bw + j) * H + k0 + c] =
        newh[(size_t)(sel.src[j] / 2) * H + k0 + c];
  }
  for (int i = tid; i < W * nm; i += kThreads) {
    const int j = i / nm, c = i - j * nm;
    const int src = sel.src[j], parent = src / 2;
    const bool keep = sel.fin[src] && bin.fin[parent];
    a.o_mel[(bw + j) * M + m0 + c] =
        keep ? a.prev_mel[(bw + parent) * M + m0 + c]
             : melb[(size_t)parent * M + m0 + c];
  }
}

// The wide step for a bfloat16 compute dtype (wide_step.cuh): every layer
// of the frame as rounds of warpgroup products over every beam at once (N
// = W rounded up to a multiple of 8 on the N side of wgmma m64nNk16), the
// rank's wide stream (~540 KB at H = 256, M = 80, R = 64) crossing L2
// into shared memory once a frame. Epilogues run on the accumulators:
// the prenet's and dec_pre's outputs go to both blocks' activations, the
// GRU's gates fold in registers, new_h (float32) and the mel frame
// (bfloat16: it is rounded to the compute dtype) stay in shared memory up
// to the reorder, and q goes to both blocks as bfloat16 rows. Three
// regions take the activations in turn: A holds x1, then rnd(state), then
// new_h; B rnd(prev_mel), then pre and mel; C x, then rnd(new_h), then q.
// A region receives a peer's writes only behind a cluster barrier that
// every block passes after its last read of the region's earlier tenant,
// so the frame has one cluster barrier more than the narrow step's five
// (before rnd(new_h) goes out). The selection's fields take the ring's
// place after the last round.
struct V1WgSmem {
  size_t a, bb, c, mel, bias, dbk, dbp, scr, sums, part, h, bar, ring, sel,
      total;
  int nst, chunk, ldn;
};

V1WgSmem v1_wg_smem(int W, int H, int M, int R) {
  using ssnt_wide::share;
  const int N = cdiv(W, 8) * 8, bs = sizeof(__nv_bfloat16);
  const int KpH = cdiv(H, 16) * 16, KpM = cdiv(M, 16) * 16;
  const int KpR = cdiv(R, 16) * 16, UH = share(H), UM = share(M);
  const auto mx = [](size_t x, size_t y) { return x > y ? x : y; };
  V1WgSmem s;
  s.ldn = UH + 4;  // new_h rows: the four beams of a store in distinct banks
  Carve c;
  s.a = c.take(mx((size_t)N * KpH * bs, sizeof(float) * N * s.ldn));
  // x, then z (ldn a beam), rnd(new_h), q
  s.c = c.take(mx(mx((size_t)N * KpH * bs, (size_t)N * s.ldn * bs),
                  (size_t)N * 2 * R * bs));
  const size_t pre = ((size_t)N * KpR * bs + 127) / 128 * 128;
  s.bb = c.take(mx((size_t)N * KpM * bs, pre + (size_t)N * UM * bs));
  s.mel = s.bb + pre;
  s.bias = c.take(sizeof(float) * v1_bias(H, M, R).n);
  s.dbk = c.take(sizeof(float) * UH * 2);
  s.dbp = c.take(sizeof(float) * kCL * 2 * N);
  s.scr = c.take(sizeof(float) * kThreads);
  s.sums = c.take(sizeof(float) * 2 * N);
  s.part = c.take(sizeof(float) * 2 * N);
  s.h = c.take(sizeof(float) * 2 * N);
  s.bar = c.take(sizeof(uint64_t) * kMaxStages);
  s.ring = c.at;
  const RingShape r = ring_shape(s.ring, ssnt_wide::kStaticSmemWg);
  s.nst = r.nst;
  s.chunk = r.chunk;
  // After the last round: p (rnd of the rows' first 2R values, bfloat16),
  // then the selection's fields.
  s.sel = s.ring;
  s.total = mx(s.ring + (size_t)s.nst * s.chunk,
               s.sel + mx(wide_sel_bytes(2 * W), (size_t)W * 2 * R * bs));
  return s;
}

// The rank's wide stream: prenet w1, w2, the GRU, dec_pre and dec_mel as
// one group of m-tiles (dec_pre's first), dec_proj.
bool v1_wide_stream(WideStream& s, int H, int M, int R) {
  using namespace ssnt_wide;
  s = WideStream{};
  return wide_dense(s, M, mtiles(H)) && wide_dense(s, H, mtiles(H)) &&
         wide_gru(s, H) && wide_dense(s, H, mtiles(R) + mtiles(M)) &&
         wide_dense(s, R, mtiles(2 * R));
}

struct V1WgArgs : V1Args {
  WideStream ws;
  V1WgSmem gsm;
};

// A warpgroup's m-tile mt of a dense layer of N outputs (the rank's share
// UN): f(beam, n, y) for beams < 8 N8 and the layer's columns n = rank UN
// + c, c < UN, with y = rnd(rnd(product) + bias[n]) for n < N.
template <typename F>
__device__ __forceinline__ void dense_tile(const float (&acc)[ssnt_wide::kAcc],
                                           int N8, int mt, int rank, int UN,
                                           int N, const float* bias, F f) {
  const ssnt_wide::AccPos p = ssnt_wide::acc_pos();
#pragma unroll
  for (int j = 0; j < ssnt_wide::kAcc / 4; ++j) {
    if (j >= N8) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 64 * mt + p.row0 + 8 * (e >> 1), n = rank * UN + c;
      if (c >= UN) continue;
      const float y = n < N ? rnd<__nv_bfloat16>(__fadd_rn(
                                  rnd<__nv_bfloat16>(acc[4 * j + e]), bias[n]))
                            : 0.0f;
      f(8 * j + p.q2 + (e & 1), n, y);
    }
  }
}

__global__ void __cluster_dims__(kCL, 1, 1) __launch_bounds__(kThreads, 1)
fused_v1_wgmma_kernel(const __grid_constant__ V1WgArgs a) {
  using bf16 = __nv_bfloat16;
  using ssnt_wide::act_at;
  using ssnt_wide::kAcc;
  const int rank = (int)cg::this_cluster().block_rank();
  const int b = blockIdx.x / kCL, tid = threadIdx.x, wg = tid / ssnt_wide::kWG;
  const int W = a.W, T = a.T, H = a.H, M = a.M, R = a.R;
  const int R2 = 2 * R, P = R2 + 2 + M, C = 2 * W;
  const int N8 = cdiv(W, 8), N = 8 * N8;
  const int KpH = cdiv(H, 16) * 16, KpM = cdiv(M, 16) * 16;
  const int KpR = cdiv(R, 16) * 16;
  const int UH = ssnt_wide::share(H), k0 = rank * UH;
  const int nu = max(0, min(UH, H - k0));
  const int UM = ssnt_wide::share(M), m0 = rank * UM;
  const int nm = max(0, min(UM, M - m0));
  const int UP = ssnt_wide::share(R), UQ = ssnt_wide::share(R2);
  const int mtH = ssnt_wide::mtiles(H), mtP = ssnt_wide::mtiles(R);
  const int mtM = ssnt_wide::mtiles(M), mtQ = ssnt_wide::mtiles(R2);
  const int ldn = a.gsm.ldn;
  const size_t bw = (size_t)b * W;
  const V1Bias bo = v1_bias(H, M, R);

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* x1_s = reinterpret_cast<bf16*>(smem + a.gsm.a);    // (N, KpH)
  bf16* hb_s = x1_s;                                       // (N, KpH)
  float* nh_s = reinterpret_cast<float*>(smem + a.gsm.a);  // (N, ldn)
  bf16* x0_s = reinterpret_cast<bf16*>(smem + a.gsm.bb);   // (N, KpM)
  bf16* pre_s = x0_s;                                      // (N, KpR)
  bf16* mel_s = reinterpret_cast<bf16*>(smem + a.gsm.mel);  // (N, UM)
  bf16* x_s = reinterpret_cast<bf16*>(smem + a.gsm.c);     // (N, KpH)
  bf16* hn_s = x_s;                                        // (N, KpH)
  bf16* q_s = x_s;                                         // (W, 2R) rows
  float* bias_s = reinterpret_cast<float*>(smem + a.gsm.bias);
  float* dbk_s = reinterpret_cast<float*>(smem + a.gsm.dbk);  // (U, 2)
  float* dbp_s = reinterpret_cast<float*>(smem + a.gsm.dbp);  // (kCL, 2W)
  float* scr = reinterpret_cast<float*>(smem + a.gsm.scr);
  float* sums_s = reinterpret_cast<float*>(smem + a.gsm.sums);
  float* part_s = reinterpret_cast<float*>(smem + a.gsm.part);
  float* h_s = reinterpret_cast<float*>(smem + a.gsm.h);  // (W, 2)
  __shared__ WideStream st_s;  // the wide stream's rounds
  __shared__ BeamInWide bin;   // the beams' carry

  if (tid == 0) st_s = a.ws;
  WideRing ring{reinterpret_cast<bf16*>(smem + a.gsm.ring),
                reinterpret_cast<uint64_t*>(smem + a.gsm.bar),
                static_cast<const bf16*>(a.wpack) +
                    (size_t)rank * a.ws.tiles * ssnt_wide::kTileA,
                &st_s, a.gsm.nst, 0};
  ring.start();
  load_beams(bin, b, W, a.lp, a.fin, a.t, a.u, nullptr, nullptr, a.il,
             nullptr);
  load_segs(bias_s, Segs<bf16, 8>{
      {a.pb1, a.pb2, a.bi, a.bhn, a.dpre_b, a.dproj_b, a.dmel_b, a.dbias_b},
      {H, H, 3 * H, H, R, 2 * R, M, 2},
      {bo.b1, bo.b2, bo.bi, bo.bhn, bo.pre, bo.proj, bo.mel, bo.db},
      {false, false, false, false, false, false, false, true}});
  load_segs(dbk_s, Segs<bf16, 1>{{a.dbias_k + k0 * 2}, {nu * 2}, {0}, {true}});
  // ---- 0. rnd(prev_mel), zero past W and M, eight values a thread at a
  // time ----
  ssnt_wide::with_vec((M & 15) == 0, [&](auto vec) {
#pragma unroll 4
    for (int i = tid; i < N * (KpM / 8); i += kThreads) {
      const int w = i / (KpM / 8), k = (i - w * (KpM / 8)) * 8;
      float v[8];
      ssnt_wide::row8<decltype(vec)::value>(
          a.prev_mel + (bw + (w < W ? w : 0)) * M, k, M, w < W, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = rnd<bf16>(v[e]);
      ssnt_wide::act8(x0_s, w, k, KpM, v);
    }
  });
  ssnt_wide::async_fence();
  cluster_arrive();  // this block's buffers are ready for its peers
  __syncthreads();

  // The enc_pack row of beam w (its source position clipped to the row).
  const auto row = [&](int w) {
    return a.enc_pack + ((size_t)b * T + min(max(bin.t[w], 0), T - 1)) * P;
  };
  float acc[kAcc];
  int r = 0;  // the stream's next round
  // ---- 1. model step ----
  // x1 = relu(rnd(rnd(prev_mel . w1) + b1)) to every block
  {
    const Bcast<bf16> o = bcast_of(x1_s);
    for (int m = 0; m < mtH; m += 2, ++r) {
      ssnt_wide::wide_round(ring, r, x0_s, KpM, N8, acc);
      if (m == 0) cluster_wait();
      if (wg < st_s.nwg[r])
        dense_tile(acc, N8, m + wg, rank, UH, H, bias_s + bo.b1,
                   [&](int w, int n, float y) {
                     if (n < KpH)
                       o.put(act_at(w, n, KpH), st<bf16>(y > 0.0f ? y : 0.0f));
                   });
    }
  }
  ssnt_wide::async_fence();
  cluster_sync();
  // x = relu(rnd(rnd(x1 . w2) + b2)) to every block
  {
    const Bcast<bf16> o = bcast_of(x_s);
    for (int m = 0; m < mtH; m += 2, ++r) {
      ssnt_wide::wide_round(ring, r, x1_s, KpH, N8, acc);
      if (wg < st_s.nwg[r])
        dense_tile(acc, N8, m + wg, rank, UH, H, bias_s + bo.b2,
                   [&](int w, int n, float y) {
                     if (n < KpH)
                       o.put(act_at(w, n, KpH), st<bf16>(y > 0.0f ? y : 0.0f));
                   });
    }
  }
  // rnd(state) in x1's place: this block is past its reads of x1, and no
  // peer writes this region again
  ssnt_wide::with_vec((H & 15) == 0, [&](auto vec) {
#pragma unroll 4
    for (int i = tid; i < N * (KpH / 8); i += kThreads) {
      const int w = i / (KpH / 8), k = (i - w * (KpH / 8)) * 8;
      float v[8];
      ssnt_wide::row8<decltype(vec)::value>(
          a.state + (bw + (w < W ? w : 0)) * H, k, H, w < W, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = rnd<bf16>(v[e]);
      ssnt_wide::act8(hb_s, w, k, KpH, v);
    }
  });
  ssnt_wide::async_fence();
  cluster_sync();
  // new_h = the GRU cell, in rnd(state)'s place (float32; z in x's place,
  // where no peer writes before the next cluster barrier)
  ssnt_wide::gru_rounds(ring, r, x_s, hb_s, KpH, N8, rank, H, bias_s + bo.bi,
                        bias_s + bo.bhn, nh_s, x_s, ldn);
  r += 6;
  ssnt_wide::gru_new_h(nh_s, x_s, ldn, a.state + bw * H, W, N, H, UH, k0);
  // every block is past its reads of x and rnd(state): rnd(new_h) to every
  // block
  cluster_sync();
  {  // eight units (one 16-byte word of the layout) a thread at a time
    const Bcast<uint4> o = bcast_of(reinterpret_cast<uint4*>(hn_s));
#pragma unroll 4
    for (int i = tid; i < N * UH / 8; i += kThreads) {
      const int w = i / (UH / 8), c = (i - w * (UH / 8)) * 8, k = k0 + c;
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = nh_s[w * ldn + c + e];
      if (k < KpH) o.put(act_at(w, k, KpH) / 8, ssnt_wide::pack8(v));
    }
  }
  __syncthreads();
  if (a.dbg_newh)
    for (int i = tid; i < W * nu; i += kThreads) {
      const int w = i / nu, c = i - w * nu;
      a.dbg_newh[(bw + w) * H + k0 + c] = nh_s[w * ldn + c];
    }
  // The rank's partial new_h . dec_bias_k (float32), to every block.
  ssnt_wide::tile_sums(W, 2, nu, scr, part_s, [&](int o, int i, float s) {
    return __fmaf_rn(nh_s[(o >> 1) * ldn + i], dbk_s[i * 2 + (o & 1)], s);
  });
  {
    const Bcast<float> o = bcast_of(dbp_s);
    if (tid < C) o.put((size_t)rank * C + tid, part_s[tid]);
  }
  ssnt_wide::async_fence();
  cluster_sync();
  // pre = rnd(tanh(rnd(rnd(rnd(new_h) . dec_pre_k) + dec_pre_b))) to every
  // block; mel = rnd(rnd(em) + rnd(rnd(rnd(new_h) . dec_mel_k) +
  // dec_mel_b)) for the rank's columns
  {
    const Bcast<bf16> o = bcast_of(pre_s);
    for (int m = 0; m < mtP + mtM; m += 2, ++r) {
      ssnt_wide::wide_round(ring, r, hn_s, KpH, N8, acc);
      const int t = m + wg;
      if (wg >= st_s.nwg[r]) continue;
      if (t < mtP) {
        dense_tile(acc, N8, t, rank, UP, R, bias_s + bo.pre,
                   [&](int w, int n, float y) {
                     if (n < KpR)
                       o.put(act_at(w, n, KpR),
                             st<bf16>(n < R ? rnd<bf16>(tanhf(y)) : 0.0f));
                   });
      } else {  // y = rnd(rnd(new_h . dec_mel_k) + dec_mel_b), for now
        dense_tile(acc, N8, t - mtP, rank, UM, M, bias_s + bo.mel,
                   [&](int w, int n, float y) {
                     if (w < W && n < M) mel_s[w * UM + n - m0] = st<bf16>(y);
                   });
      }
    }
  }
  ssnt_wide::async_fence();
  cluster_sync();
  // mel = rnd(rnd(em) + y), the rows' em read coalesced
#pragma unroll 8
  for (int i = tid; i < W * nm; i += kThreads) {
    const int w = i / nm, c = i - w * nm;
    const float mv = rnd<bf16>(__fadd_rn(rnd<bf16>(row(w)[R2 + 2 + m0 + c]),
                                         ld(mel_s, (size_t)w * UM + c)));
    mel_s[w * UM + c] = st<bf16>(mv);
    if (a.dbg_mel) a.dbg_mel[(bw + w) * M + m0 + c] = mv;
  }
  // q = rnd(rnd(pre . dec_proj_k) + dec_proj_b), to every block
  {
    const Bcast<bf16> o = bcast_of(q_s);
    for (int m = 0; m < mtQ; m += 2, ++r) {
      ssnt_wide::wide_round(ring, r, pre_s, KpR, N8, acc);
      if (wg < st_s.nwg[r])
        dense_tile(acc, N8, m + wg, rank, UQ, R2, bias_s + bo.proj,
                   [&](int w, int n, float y) {
                     if (w < W && n < R2)
                       o.put((size_t)w * R2 + n, st<bf16>(y));
                   });
    }
  }
  cluster_sync();

  // rnd(p): the rows' first 2R values, read coalesced into the ring's place
  bf16* p_s = reinterpret_cast<bf16*>(smem + a.gsm.sel);  // (W, 2R)
#pragma unroll 8
  for (int i = tid; i < W * R2; i += kThreads) {
    const int w = i / R2, k = i - w * R2;
    p_s[i] = st<bf16>(rnd<bf16>(row(w)[k]));
  }
  __syncthreads();
  // logit_k = sum_r rnd(rnd(p_kr) * q_kr) + enc_bias_k + (new_h .
  // dec_bias_k + dec_bias_b_k), the same in every block
  ssnt_wide::tile_sums(W, 2, R, scr, sums_s, [&](int o, int i, float s) {
    const size_t k = (size_t)(o >> 1) * R2 + (o & 1) * R + i;
    return __fadd_rn(s, rnd<bf16>(__fmul_rn(ld(p_s, k), ld(q_s, k))));
  });
  if (tid < C) {
    const int w = tid >> 1, c = tid & 1;
    float db = dbp_s[tid];
    for (int k = 1; k < kCL; ++k) db = __fadd_rn(db, dbp_s[k * C + tid]);
    db = __fadd_rn(db, bias_s[bo.db + c]);
    h_s[tid] = __fadd_rn(__fadd_rn(sums_s[tid], row(w)[R2 + c]), db);
  }
  __syncthreads();
  if (tid < W) {  // log_softmax: shifted - log(exp + exp)
    const float le = h_s[2 * tid], ls = h_s[2 * tid + 1];
    const float m = fmaxf(le, ls);
    const float she = __fsub_rn(le, m), shs = __fsub_rn(ls, m);
    const float lse = logf(__fadd_rn(expf(she), expf(shs)));
    h_s[2 * tid] = __fsub_rn(she, lse);
    h_s[2 * tid + 1] = __fsub_rn(shs, lse);
    if (a.dbg_h && rank == 0) {
      a.dbg_h[2 * (bw + tid)] = h_s[2 * tid];
      a.dbg_h[2 * (bw + tid) + 1] = h_s[2 * tid + 1];
    }
  }
  __syncthreads();

  // ---- 2. candidates, 3. selection (every block, on the same h) ----
  const WideSel sel = wide_sel_at(smem + a.gsm.sel, C);
  for (int c = tid; c < C; c += kThreads) {
    const int w = c >> 1, k = c & 1;
    store_wide(sel, c, v1_candidate(k, h_s[c], bin.lp[w], bin.fin[w],
                                    bin.t[w], bin.u[w], bin.il));
  }
  wide_select(sel, C, W, false);
  if (rank == 0) {
    for (int j = tid; j < W; j += kThreads) {
      const int src = sel.src[j];
      const size_t i = bw + j;
      a.out.pred[i] = sel.pred[src];
      a.out.lp[i] = sel.lp[src];
      a.out.nt[i] = sel.nt[src];
      a.out.nu[i] = sel.nu[src];
      a.out.fin[i] = (uint8_t)sel.fin[src];
      a.out.branch[i] = src / 2;
      a.o_thist[i] = bin.t[src / 2];
    }
  }

  // ---- 4. reorders of the rank's columns, finished-beam keep ----
  for (int i = tid; i < W * nu; i += kThreads) {
    const int j = i / nu, c = i - j * nu;
    a.o_state[(bw + j) * H + k0 + c] = nh_s[(sel.src[j] / 2) * ldn + c];
  }
  for (int i = tid; i < W * nm; i += kThreads) {
    const int j = i / nm, c = i - j * nm;
    const int src = sel.src[j], parent = src / 2;
    const bool keep = sel.fin[src] && bin.fin[parent];
    a.o_mel[(bw + j) * M + m0 + c] =
        keep ? a.prev_mel[(bw + parent) * M + m0 + c]
             : ld(mel_s, (size_t)parent * UM + c);
  }
}

cudaError_t launch_wgmma(const V1Args& s, cudaStream_t stream) {
  V1WgArgs a;
  static_cast<V1Args&>(a) = s;
  a.gsm = v1_wg_smem(a.W, a.H, a.M, a.R);
  if (!v1_wide_stream(a.ws, a.H, a.M, a.R)) return cudaErrorInvalidValue;
  ssnt_wide::wide_finish(a.ws, a.gsm.chunk);
  if (a.gsm.nst < 2 ||
      a.gsm.total + ssnt_wide::kStaticSmemWg + 1024 > kSmemMax)
    return cudaErrorInvalidValue;
  auto kern = fused_v1_wgmma_kernel;
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

template <typename CT>
cudaError_t launch_wide(V1Args a, cudaStream_t stream) {
  if (a.dbg_newh == nullptr || a.dbg_mel == nullptr)
    return cudaErrorInvalidValue;
  a.wsm = v1_wide_smem(a.W, a.H, a.M, a.R, sizeof(CT));
  a.st = v1_stream(a.H, a.M, a.R);
  finish_stream(a.st, a.wsm.t.chunk, sizeof(CT));
  if (a.wsm.t.nst < 2) return cudaErrorInvalidValue;
  auto kern = fused_v1_wide_kernel<CT>;
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

template <typename CT, int NTN>
cudaError_t launch(V1Args a, cudaStream_t stream) {
  a.sm = v1_smem(NTN * 8, a.H, a.M, a.R, sizeof(CT));
  a.st = v1_stream(a.H, a.M, a.R);
  finish_stream(a.st, a.sm.chunk, sizeof(CT));
  if (a.sm.nst < 2) return cudaErrorInvalidValue;
  auto kern = fused_v1_step_kernel<CT, NTN>;
  // Opt in to the dynamic shared memory once per size (not on every frame,
  // and not inside a CUDA graph capture after the first call).
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

template <typename CT>
cudaError_t dispatch(const V1Args& a, cudaStream_t st) {
  if (a.W > kMaxW) {
    if constexpr (sizeof(CT) == 2) return launch_wgmma(a, st);
    else return launch_wide<CT>(a, st);
  }
  if (a.W <= 8) return launch<CT, 1>(a, st);
  return launch<CT, 2>(a, st);
}

bool bad_shape(int B, int W, int T, int H, int M, int R) {
  if (B < 1 || W < 1 || W > kMaxBeams || T < 1 || H < 1 || M < 1 || R < 1 ||
      (long long)B * W * (H > M ? H : M) >= (1ll << 31))
    return true;
  const Stream s = v1_stream(H, M, R);
  for (int i = 0; i < s.n; ++i)
    if (s.l[i].MT > kMaxMT) return true;
  return false;
}

}  // namespace

extern "C" int ssnt_fused_v1_max_beams() { return kMaxBeams; }
// Candidates of the widest step (2 a beam).
extern "C" int ssnt_fused_v1_max_candidates() { return 2 * kMaxBeams; }
// 1 where the step at W takes a wide instance. In float32 compute it
// writes new_h and mel before the reorder to the debug outputs (the
// wrapper's scratch when the caller gives none).
extern "C" int ssnt_fused_v1_is_wide(int W) { return (int)(W > kMaxW); }
// 1 where the step takes the bfloat16 wide instance, which reads the wide
// stream (ops/beam_fused.pack_wide_dense / pack_wide_gru) and needs no
// scratch.
extern "C" int ssnt_fused_v1_wide_stream(int compute_bf16, int W) {
  return (int)(compute_bf16 && W > kMaxW);
}

// Dynamic shared memory (bytes) of one block at these widths, the weight
// ring's 16 or 32 KB slots included.
extern "C" int ssnt_fused_v1_smem_bytes(int compute_bf16, int W, int H, int M,
                                        int R) {
  const int cs = compute_bf16 ? 2 : 4;
  if (W > kMaxW)
    return (int)(compute_bf16 ? v1_wg_smem(W, H, M, R).total
                              : v1_wide_smem(W, H, M, R, cs).total);
  return (int)v1_smem(W <= 8 ? 8 : 16, H, M, R, cs).total;
}

// Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int ssnt_fused_v1_step(
    int compute_bf16, int B, int W, int T, int H, int M, int R,
    const void* enc_pack, const void* t, const void* u, const void* lp,
    const void* fin, const void* il, const void* prev_mel, const void* state,
    const void* wpack, const void* pb1, const void* pb2, const void* bi,
    const void* bhn, const void* dpre_b, const void* dproj_b,
    const void* dbias_k, const void* dbias_b, const void* dmel_b,
    void* o_pred, void* o_lp, void* o_nt, void* o_nu, void* o_fin,
    void* o_branch, void* o_thist, void* o_mel, void* o_state, void* dbg_h,
    void* dbg_newh, void* dbg_mel, void* stream) {
  if (bad_shape(B, W, T, H, M, R)) return (int)cudaErrorInvalidValue;
  V1Args a;
  a.B = B; a.W = W; a.T = T; a.H = H; a.M = M; a.R = R;
  a.enc_pack = (const float*)enc_pack; a.t = (const int*)t;
  a.u = (const int*)u; a.lp = (const float*)lp;
  a.fin = (const uint8_t*)fin; a.il = (const int*)il;
  a.prev_mel = (const float*)prev_mel; a.state = (const float*)state;
  a.wpack = wpack; a.pb1 = pb1; a.pb2 = pb2; a.bi = bi; a.bhn = bhn;
  a.dpre_b = dpre_b; a.dproj_b = dproj_b; a.dbias_k = (const float*)dbias_k;
  a.dbias_b = (const float*)dbias_b; a.dmel_b = dmel_b;
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
