"""PyTorch port, the v1 decode: v1_enc_pack, v1_step_math and
SSNTModel.decode_step held against the JAX package on the same weights
(carried across by convert.flax_to_torch) and inputs; the fused v1 step's
plain version against JAX's fused v1 kernel, interpreted; beam_decode on
its three routes and greedy_decode against the jitted JAX decode and the
interpreted fused JAX decode; the fused v1 wrapper's CPU dispatch.

On the CPU every port route runs plain PyTorch (each wrapper dispatches
on the tensor's device). Tiny config, B=4, T=12, 24 frames."""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ssnt_tts_tpu.ops.beam_pallas as jbeam_pallas
from ssnt_tts_tpu.models import SSNTModel as JaxModel
from ssnt_tts_tpu.models import stepmath as jstep
from ssnt_tts_tpu.ops import beam_fused as jbeam_fused
from ssnt_tts_tpu.parallel import decode as jdecode
from ssnt_tts_tpu.utils import config as jcfg
from ssnt_tts_tpu_torch import convert
from ssnt_tts_tpu_torch.models import stepmath
from ssnt_tts_tpu_torch.models.ssnt import SSNTModel
from ssnt_tts_tpu_torch.ops import beam_fused
from ssnt_tts_tpu_torch.parallel import decode
from ssnt_tts_tpu_torch.utils import config as tcfg

B, T, U = 4, 12, 24
IL = [12, 9, 12, 5]
OL = [20, 16, 24, 10]
W_STEP = 8
INT_KEYS = ("alignment", "beam_branch", "t_history", "prediction",
            "num_frames")
ROUTES = {"fused": {}, "beam_only": {"fuse_model": False},
          "plain": {"fuse_model": False, "use_pallas": False}}


def _models(dtype, seed=1, shift_bias=None):
    """JAX and port models on the same weights. shift_bias: a [emit,
    shift] bias of the transition joint's decoder side, to make beams
    shift to the end of their utterance and finish."""
    torch.set_num_threads(1)
    cfg = jcfg.tiny_model_config(dtype=dtype)
    jm = JaxModel(cfg)
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, (B, T)).astype(np.int32)
    mel = jnp.asarray(rng.normal(0, 1, (B, U, cfg.mel_dim)), jnp.float32)
    dd = jnp.zeros((B, T), jnp.int32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(toks), mel,
                     jnp.asarray(IL, jnp.int32), jnp.asarray(OL, jnp.int32),
                     dd, dd, method=jm.loss)
    if shift_bias is not None:
        params = jax.tree_util.tree_map(lambda a: a, flax.core.unfreeze(
            params))
        params["params"]["transition"]["dec_bias"]["bias"] = jnp.asarray(
            shift_bias, jnp.float32)
    tm = SSNTModel(tcfg.ModelConfig(**dataclasses.asdict(cfg)), device="cpu")
    tm.load_state_dict(convert.flax_to_torch(jax.device_get(params), cfg))
    enc = jm.apply(params, jnp.asarray(toks), jnp.asarray(IL, jnp.int32),
                   method=jm.encode)
    return cfg, jm, params, toks, tm.eval(), enc


@pytest.fixture(scope="module")
def f32():
    return _models("float32")


@pytest.fixture(scope="module")
def bf16():
    return _models("bfloat16")


@pytest.fixture(scope="module")
def f32_shift():
    return _models("float32", shift_bias=[-3.0, 1.0])


def _beams(cfg, seed=2, W=W_STEP):
    """Per-beam step inputs: t over [-1, T] (clipped rows, inactive
    beams), random state, previous mel, log-probs and finished flags."""
    rng = np.random.default_rng(seed)
    return dict(
        t=rng.integers(-1, T + 1, (B, W)).astype(np.int32),
        u=rng.integers(0, U, (B, W)).astype(np.int32),
        state=rng.normal(0, 1, (B, W, cfg.decoder_dim)).astype(np.float32),
        pm=rng.normal(0, 1, (B, W, cfg.mel_dim)).astype(np.float32),
        lp=(-rng.integers(0, 16, (B, W)) / 4.0).astype(np.float32),
        fin=rng.random((B, W)) < 0.25)


def _pack(models):
    cfg, jm, params, toks, tm, enc = models
    dt = jnp.dtype(cfg.dtype)
    jw = jstep.extract_v1_step_weights(params)
    return jw, jstep.v1_enc_pack(jw, enc, dt)


def test_v1_enc_pack_matches_jax(f32):
    cfg, jm, params, toks, tm, enc = f32
    _, want = _pack(f32)
    with torch.no_grad():
        got = stepmath.v1_enc_pack(tm.v1_step_weights(),
                                   torch.from_numpy(np.array(enc)),
                                   torch.float32)
    R, M = cfg.joint_rank, cfg.mel_dim
    assert got.shape == (B, T, 2 * R + 2 + M)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_v1_step_math_matches_jax(f32):
    cfg, jm, params, toks, tm, enc = f32
    jw, pack = _pack(f32)
    x = _beams(cfg)
    idx = np.clip(x["t"], 0, T - 1)
    gath = np.take_along_axis(np.asarray(pack), idx[..., None], axis=1)
    n = B * W_STEP
    he, hs, mel, ns = jstep.v1_step_math(
        jw, jnp.asarray(gath.reshape(n, -1)),
        jnp.asarray(x["state"].reshape(n, -1)),
        jnp.asarray(x["pm"].reshape(n, -1)), jnp.float32)
    with torch.no_grad():
        h, mel_t, ns_t = stepmath.v1_step_math(
            tm.v1_step_weights(), torch.from_numpy(gath),
            torch.from_numpy(x["state"]), torch.from_numpy(x["pm"]),
            torch.float32)
    want_h = np.concatenate([np.asarray(he), np.asarray(hs)], 1)
    for g, w in ((h, want_h), (mel_t, mel), (ns_t, ns)):
        np.testing.assert_allclose(g.numpy().reshape(n, -1), np.asarray(w),
                                   rtol=0, atol=1e-5)


def test_decode_step_matches_jax(f32):
    cfg, jm, params, toks, tm, enc = f32
    x = _beams(cfg, seed=3)
    want = jm.apply(params, enc, jnp.asarray(np.clip(x["t"], 0, T - 1)),
                    jnp.asarray(x["state"]), jnp.asarray(x["pm"]),
                    method=jm.decode_step)
    with torch.no_grad():
        got = tm.decode_step(torch.from_numpy(np.array(enc)),
                             torch.from_numpy(x["t"]),
                             torch.from_numpy(x["state"]),
                             torch.from_numpy(x["pm"]))
    assert got[0].shape == (B, W_STEP, 2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("models", ["f32", "bf16"])
def test_decode_step_and_fused_step_math_agree(models, request):
    """decode_step (the beam-only and plain routes) against v1_step_math
    (the fused route) on the same rows. float32: bit for bit, which pins
    TransitionJoint.step to flax's log_softmax association. bfloat16:
    state and mel bit for bit; h within a bf16 ulp of the logits, since
    decode_step rounds the rank sum to bfloat16 as flax does and the fused
    step sums it in float32."""
    cfg, jm, params, toks, tm, enc = request.getfixturevalue(models)
    x = _beams(cfg, seed=4)
    tenc = torch.from_numpy(np.array(enc))
    with torch.no_grad():
        w = tm.v1_step_weights()
        pack = stepmath.v1_enc_pack(w, tenc, tm.dtype)
        idx = torch.from_numpy(np.clip(x["t"], 0, T - 1)).long()
        gath = torch.gather(pack, 1, idx[..., None].expand(-1, -1,
                                                           pack.shape[2]))
        args = [torch.from_numpy(x[k]) for k in ("state", "pm")]
        h_f, mel_f, ns_f = stepmath.v1_step_math(w, gath, *args, tm.dtype)
        h_d, ns_d, mel_d = tm.decode_step(tenc, torch.from_numpy(x["t"]),
                                          *args)
    assert torch.equal(ns_f, ns_d) and torch.equal(mel_f, mel_d)
    if models == "f32":
        assert torch.equal(h_f, h_d)
    else:
        torch.testing.assert_close(h_f, h_d, rtol=0, atol=0.05)


def _fused_inputs(models, seed=5):
    """Beam rows for one fused step: some finished, some at their last
    frame, some past it; identical beams in utterance 0."""
    cfg = models[0]
    x = _beams(cfg, seed=seed)
    x["t"] = np.minimum(x["t"], np.asarray(IL)[:, None])
    x["t"][1, :3] = IL[1] - 1
    for k in ("t", "u", "state", "pm", "lp", "fin"):
        x[k][0] = x[k][0, :1]
    return x


def test_fused_v1_reference_matches_jax_kernel(f32, monkeypatch):
    """The plain fused v1 step against JAX's fused v1 kernel
    (interpreted) fed the same gathered rows: discrete outputs equal,
    log-probs, mel and state within 1e-6."""
    monkeypatch.setattr(jbeam_pallas, "_INTERPRET", True)
    cfg, jm, params, toks, tm, enc = f32
    jw, pack = _pack(f32)
    x = _fused_inputs(f32)
    idx = np.clip(x["t"], 0, T - 1)
    gath = np.take_along_axis(np.asarray(pack), idx[..., None], axis=1)
    row = lambda a, dt: jnp.asarray(a, dt)[:, None, :]
    want = jbeam_fused.fused_v1_beam_step(
        jnp.asarray(gath), jnp.asarray(x["pm"]), jnp.asarray(x["state"]),
        row(x["lp"], jnp.float32), row(x["fin"], jnp.int32),
        row(x["t"], jnp.int32), row(x["u"], jnp.int32),
        jnp.asarray(IL, jnp.int32).reshape(B, 1, 1),
        jbeam_fused.prepare_v1_fused_weights(jw, jnp.float32),
        dtype=jnp.float32)
    want = [np.asarray(a) for a in want]
    fw = beam_fused.prepare_v1_fused_weights(tm.v1_step_weights(),
                                             torch.float32)
    tx = {k: torch.from_numpy(v) for k, v in x.items()}
    dbg = (torch.empty(B, W_STEP, 2), torch.empty(B, W_STEP, cfg.decoder_dim),
           torch.empty(B, W_STEP, cfg.mel_dim))
    before = beam_fused.fused_v1_beam_step.launches
    with torch.no_grad():
        got = beam_fused.fused_v1_beam_step(
            torch.from_numpy(np.array(pack)), tx["t"], tx["u"], tx["lp"],
            tx["fin"], torch.tensor(IL, dtype=torch.int32), tx["pm"],
            tx["state"], fw, debug_out=dbg)
    assert beam_fused.fused_v1_beam_step.launches == before
    names = ("prediction", "log_prob", "next_t", "next_u", "is_finished",
             "branch", "t_history")
    for name, w in zip(names, want[:7]):
        g = getattr(got, name).numpy()
        if name == "log_prob":
            np.testing.assert_allclose(g, w[:, 0], rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(g, w[:, 0].astype(g.dtype),
                                          err_msg=name)
    for g, w in ((got.mel, want[7]), (got.state, want[8])):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-6)
    # Finished beams kept their last frame; the debug outputs are the
    # step's own.
    fin_prev = torch.gather(tx["fin"], 1, got.branch.long())
    keep = (got.is_finished & fin_prev)
    assert keep.any() and (~keep).any()
    pm_r = beam_fused.reorder_state(tx["pm"], got.branch)
    assert torch.equal(got.mel[keep], pm_r[keep])
    mel_r = beam_fused.reorder_state(dbg[2], got.branch)
    assert torch.equal(got.mel[~keep], mel_r[~keep])
    assert torch.equal(got.state, beam_fused.reorder_state(dbg[1],
                                                           got.branch))


def _jax_decode(models, W, fused=False, greedy=False):
    cfg, jm, params, toks, tm, enc = models
    if greedy:
        fn = lambda p, tk, il: jdecode.greedy_decode(jm, p, tk, il,
                                                     max_frames=U)
    else:
        kw = (dict(fuse_model=True) if fused
              else dict(fuse_model=False, use_pallas=False))
        fn = lambda p, tk, il: jdecode.beam_decode(
            jm, p, tk, il, max_frames=U, beam_width=W, **kw)
    out = jax.jit(fn)(params, jnp.asarray(toks), jnp.asarray(IL, jnp.int32))
    return {k: np.asarray(v) for k, v in out.items()}


def _port_decode(models, W, **route):
    tm, toks = models[4], models[3]
    out = decode.beam_decode(tm, torch.from_numpy(toks), torch.tensor(IL),
                             max_frames=U, beam_width=W, **route)
    return {k: v.numpy() for k, v in out.items()}


def _assert_decode(got, want, tol=1e-4):
    assert set(got) == set(want)
    for k in INT_KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("mel", "log_prob"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol,
                                   err_msg=k)


@pytest.mark.parametrize("W", [1, 4, 8])
@pytest.mark.parametrize("route", list(ROUTES))
def test_beam_decode_matches_jax_f32(f32, W, route):
    got = _port_decode(f32, W, **ROUTES[route])
    _assert_decode(got, _jax_decode(f32, W))
    assert got["mel"].shape == (B, U, f32[0].mel_dim)
    assert got["beam_branch"].shape == (B, U, W)
    # Alignment steps are 0 or 1 and stay inside each utterance.
    steps = np.diff(got["alignment"], axis=1)
    assert np.isin(steps, (0, 1)).all()
    assert (got["alignment"] < np.asarray(IL)[:, None]).all()


@pytest.mark.parametrize("W", [4, 8])
def test_beam_decode_fused_matches_jax_fused_kernel(f32, W, monkeypatch):
    """The port's fused route (plain on the CPU) against JAX's fused v1
    decode with the kernel interpreted."""
    monkeypatch.setattr(jbeam_pallas, "_INTERPRET", True)
    _assert_decode(_port_decode(f32, W), _jax_decode(f32, W, fused=True))


@pytest.mark.parametrize("route", list(ROUTES))
def test_beam_decode_finishing_beams_match_jax(f32_shift, route):
    """A model that prefers shifting: beams reach their last frame and
    finish at frames that differ by utterance; finished beams then carry
    padding candidates, and the best path repeats its last frame."""
    got = _port_decode(f32_shift, 4, **ROUTES[route])
    _assert_decode(got, _jax_decode(f32_shift, 4))
    n = got["num_frames"]
    assert len(set(n.tolist())) > 1 and (n < U - 1).all()
    for b in range(B):
        tail = got["mel"][b, n[b]:]
        assert (tail == tail[0]).all()
        assert not (got["mel"][b, n[b] - 1] == tail[0]).all()
    assert (got["alignment"][np.arange(B), n] == np.asarray(IL) - 1).all()


@pytest.mark.parametrize("route", list(ROUTES))
def test_greedy_decode_matches_jax(f32, route):
    """Beam width 1; on the non-fused routes the step without rows (#10's
    wrapper) serves, since every parent is beam 0."""
    got = decode.greedy_decode(f32[4], torch.from_numpy(f32[3]),
                               torch.tensor(IL), max_frames=U,
                               **ROUTES[route])
    got = {k: v.numpy() for k, v in got.items()}
    _assert_decode(got, _jax_decode(f32, 1, greedy=True))
    assert got["beam_branch"].shape == (B, U, 1)
    assert (got["beam_branch"] == 0).all()


def test_beam_decode_bf16(bf16):
    """bfloat16 compute: the beam-only and plain routes agree bit for bit
    (the same decode_step, the same selection); the fused route sums the
    rank product in float32 and differs by about one bf16 ulp in h, and
    flax rounds the bf16 model about one ulp apart from the port, so
    against those only the share of utterances whose alignment agrees is
    gated."""
    routes = {r: _port_decode(bf16, 8, **kw) for r, kw in ROUTES.items()}
    for k in routes["plain"]:
        np.testing.assert_array_equal(routes["beam_only"][k],
                                      routes["plain"][k], err_msg=k)
    want = _jax_decode(bf16, 8)
    same = lambda a, b: (a["alignment"] == b["alignment"]).all(1).mean()
    # On this seed every alignment agrees (4 of 4; other seeds: 3 of 4
    # fused vs plain); the log-probs differ from JAX by up to 0.04.
    assert same(routes["plain"], want) >= 0.75
    assert same(routes["fused"], routes["plain"]) >= 0.75
    np.testing.assert_allclose(routes["plain"]["log_prob"], want["log_prob"],
                               rtol=0, atol=0.1)
    for out in routes.values():
        assert np.isfinite(out["mel"]).all()
        steps = np.diff(out["alignment"], axis=1)
        assert np.isin(steps, (0, 1)).all()


def test_fused_v1_wrapper_runs_plain_step_on_cpu():
    """CPU tensors take the plain version; no kernel launch is counted;
    the debug outputs hold the step's h, new state and mel."""
    rng = np.random.default_rng(6)
    Bn, W, H, M, R, Tn = 3, 4, 16, 5, 3, 6
    g = lambda *s: torch.from_numpy(rng.normal(0, 0.3, s).astype(np.float32))
    shapes = dict(prenet_w1=(M, H), prenet_b1=(H,), prenet_w2=(H, H),
                  prenet_b2=(H,), wi=(H, 3 * H), bi=(3 * H,),
                  wh=(H, 3 * H), bhn=(H,), dec_pre_k=(H, R), dec_pre_b=(R,),
                  dec_proj_k=(R, 2 * R), dec_proj_b=(2 * R,),
                  dec_bias_k=(H, 2), dec_bias_b=(2,), dec_mel_k=(H, M),
                  dec_mel_b=(M,))
    fw = beam_fused.V1FusedWeights(**{k: g(*s) for k, s in shapes.items()})
    i32 = torch.int32
    t = torch.tensor([[0, 1, 5, 6]] * Bn, dtype=i32)
    args = (g(Bn, Tn, 2 * R + 2 + M), t, t + 2, g(Bn, W),
            torch.tensor([[True, False, False, False]] * Bn),
            torch.tensor([6, 2, 5], dtype=i32), g(Bn, W, M), g(Bn, W, H))
    dbg = (torch.empty(Bn, W, 2), torch.empty(Bn, W, H), torch.empty(Bn, W, M))
    before = beam_fused.fused_v1_beam_step.launches
    got = beam_fused.fused_v1_beam_step(*args, fw, debug_out=dbg)
    want = beam_fused.fused_v1_beam_step_reference(*args, fw)
    assert beam_fused.fused_v1_beam_step.launches == before
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    gath = torch.gather(args[0], 1, t.long().clamp(0, Tn - 1)[..., None]
                        .expand(-1, -1, 2 * R + 2 + M))
    h, mel, new_h = stepmath.v1_step_math(fw, gath, args[7], args[6],
                                          torch.float32)
    for d, x in zip(dbg, (h, new_h, mel)):
        torch.testing.assert_close(d, x, rtol=0, atol=0)
    # Utterance 1 has 2 tokens: beam 0 is finished, beam 1 sits on its
    # last frame (both its candidates finish), beams 2 and 3 are past it.
    assert got.is_finished[1].all()
