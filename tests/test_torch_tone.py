"""PyTorch port, the tone decode and its eval metric: tone paths and the
tone decode step, tone_decode on each route and v2_duration_decode on its
beam-only routes held against the JAX package on the same weights and
inputs; levenshtein_edit_distance against JAX, the numpy oracle and the
reference's vectors; the fused tone wrapper's CPU dispatch.

On the CPU every port route runs plain PyTorch (each wrapper dispatches
on the tensor's device). The JAX decodes run jitted on the XLA route
(fuse_model=False, use_pallas=False), or with the fused kernel
interpreted."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ssnt_tts_tpu.ops.beam_pallas as jbeam_pallas
from ssnt_tts_tpu.models import SSNTModel as JaxModel
from ssnt_tts_tpu.models import stepmath as jstep
from ssnt_tts_tpu.ops import edit_distance as jedit
from ssnt_tts_tpu.oracle import numpy_oracle as oracle
from ssnt_tts_tpu.parallel import decode as jdecode
from ssnt_tts_tpu.utils import config as jcfg
from ssnt_tts_tpu_torch import convert
from ssnt_tts_tpu_torch.models import stepmath
from ssnt_tts_tpu_torch.models.ssnt import SSNTModel
from ssnt_tts_tpu_torch.ops import beam_fused, edit_distance
from ssnt_tts_tpu_torch.parallel import decode
from ssnt_tts_tpu_torch.utils import config as tcfg

B, T, U = 4, 12, 24
IL = [12, 9, 12, 5]
OL = [20, 16, 24, 10]
LONG_OL = [44, 30, 40, 17]
TONE_KEYS = ("tones", "prediction", "beam_branch")
V2_INT_KEYS = ("prediction", "beam_branch", "ordered_beam_branch",
               "durations", "output_length", "source_indexes",
               "total_duration", "is_finished", "beam_emptied")
ROUTES = {"fused": {}, "beam_only": {"fuse_model": False},
          "plain": {"fuse_model": False, "use_pallas": False}}


def _models(dtype, seed=1):
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
    tm = SSNTModel(tcfg.ModelConfig(**dataclasses.asdict(cfg)), device="cpu")
    tm.load_state_dict(convert.flax_to_torch(jax.device_get(params), cfg))
    return cfg, jm, params, toks, tm.eval()


@pytest.fixture(scope="module")
def f32():
    return _models("float32")


def _enc(models):
    cfg, jm, params, toks, tm = models
    enc = jm.apply(params, jnp.asarray(toks), jnp.asarray(IL, jnp.int32),
                   method=jm.encode)
    return enc, torch.from_numpy(np.array(enc))


@pytest.mark.parametrize("kind,head", [("v2", "duration"), ("tone", "tone")])
def test_class_decode_paths_match_jax(f32, kind, head):
    """Row s sits at min(s, T_b - 1) for v2 and min(s, T_b) for tone."""
    cfg, jm, params, toks, tm = f32
    jenc, tenc = _enc(f32)
    jw = jstep.extract_class_step_weights(params, f"{head}_head",
                                          f"{head}_ar")
    want = jstep.class_decode_paths(jw, jenc, jnp.asarray(IL, jnp.int32),
                                    kind=kind, dtype=jnp.float32)
    w = getattr(tm, f"{head}_step_weights")()
    with torch.no_grad():
        got = stepmath.class_decode_paths(w, tenc, torch.tensor(IL),
                                          torch.float32, kind=kind)
    for g, x in zip(got, want):
        assert g.shape == x.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(x), rtol=0,
                                   atol=1e-5)
    # Utterance 3 (T_b = 5) at step 7: the last row for v2, the padding
    # row for tone; the two kinds differ there and agree at step 3.
    other = stepmath.class_decode_paths(
        w, tenc, torch.tensor(IL), torch.float32,
        kind="tone" if kind == "v2" else "v2")
    assert not torch.equal(got[0][7, 3], other[0][7, 3])
    assert torch.equal(got[0][3, 3], other[0][3, 3])


def test_tone_decode_step_matches_jax(f32):
    cfg, jm, params, toks, tm = f32
    rng = np.random.default_rng(2)
    W = 8
    jenc, tenc = _enc(f32)
    t = rng.integers(0, T + 1, (B, W)).astype(np.int32)  # T is clipped
    state = rng.normal(0, 1, (B, W, cfg.decoder_dim)).astype(np.float32)
    pc = rng.integers(0, cfg.tone_class_size, (B, W)).astype(np.int32)
    h_want, ns_want = jm.apply(params, jenc, jnp.asarray(t),
                               jnp.asarray(state), jnp.asarray(pc),
                               method=jm.tone_decode_step)
    with torch.no_grad():
        h_got, ns_got = tm.tone_decode_step(
            tenc, torch.from_numpy(t), torch.from_numpy(state),
            torch.from_numpy(pc))
    assert h_got.shape == (B, W, cfg.tone_class_size)
    np.testing.assert_allclose(h_got.numpy(), np.asarray(h_want), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(ns_got.numpy(), np.asarray(ns_want), rtol=0,
                               atol=1e-5)


def _tone_jax(models, W, empty_tone_id=0, fused=False):
    cfg, jm, params, toks, tm = models
    kw = (dict(fuse_model=True) if fused
          else dict(fuse_model=False, use_pallas=False))
    out = jax.jit(lambda p, tk, il: jdecode.tone_decode(
        jm, p, tk, il, beam_width=W, empty_tone_id=empty_tone_id, **kw))(
        params, jnp.asarray(toks), jnp.asarray(IL, jnp.int32))
    return {k: np.asarray(v) for k, v in out.items()}


def _tone_port(models, W, empty_tone_id=0, **route):
    tm, toks = models[4], models[3]
    out = decode.tone_decode(tm, torch.from_numpy(toks), torch.tensor(IL),
                             beam_width=W, empty_tone_id=empty_tone_id,
                             **route)
    return {k: v.numpy() for k, v in out.items()}


def _assert_tone(got, want, lp_atol):
    assert set(got) == set(want)
    for k in TONE_KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["log_prob"], want["log_prob"], rtol=0,
                               atol=lp_atol)


@pytest.mark.parametrize("W", [4, 8, 16])
@pytest.mark.parametrize("route", list(ROUTES))
def test_tone_decode_matches_jax_f32(f32, W, route):
    got = _tone_port(f32, W, **ROUTES[route])
    _assert_tone(got, _tone_jax(f32, W), 1e-4)
    assert got["tones"].shape == (B, W, T)
    assert (got["tones"][3, :, IL[3]:] == 0).all()


@pytest.mark.parametrize("route", list(ROUTES))
def test_tone_decode_empty_tone_id_matches_jax(f32, route):
    """empty_tone_id = 3 pads the tones past each length and predicts 3
    for the padding candidates, which still sit in class slot 0."""
    got = _tone_port(f32, 8, empty_tone_id=3, **ROUTES[route])
    _assert_tone(got, _tone_jax(f32, 8, empty_tone_id=3), 1e-4)
    assert (got["tones"][3, :, IL[3]:] == 3).all()
    assert (got["prediction"][3, IL[3]:] == 3).all()


def test_tone_decode_bf16_matches_jax():
    """bfloat16 compute on a fixed seed: the port's three routes agree bit
    for bit; against JAX the tones agree and the log-probs within 0.02.
    (The two frameworks round the bf16 encoder and class step differently
    by about one bf16 ulp, which flips near-ties among pruned beams: 4 of
    384 predictions differ on this seed, none on a surviving path.)"""
    models = _models("bfloat16")
    routes = [_tone_port(models, 8, **kw) for kw in ROUTES.values()]
    for other in routes[1:]:
        for k in routes[0]:
            np.testing.assert_array_equal(other[k], routes[0][k], err_msg=k)
    want = _tone_jax(models, 8)
    np.testing.assert_array_equal(routes[0]["tones"], want["tones"])
    np.testing.assert_allclose(routes[0]["log_prob"], want["log_prob"],
                               rtol=0, atol=0.02)


@pytest.mark.parametrize("W", [4, 8])
def test_tone_fused_route_matches_jax_fused_kernel(f32, W, monkeypatch):
    """The port's fused route (plain on the CPU) against JAX's fused tone
    kernel, interpreted."""
    monkeypatch.setattr(jbeam_pallas, "_INTERPRET", True)
    _assert_tone(_tone_port(f32, W), _tone_jax(f32, W, fused=True), 1e-4)


@pytest.mark.parametrize("W", [4, 8])
@pytest.mark.parametrize("use_pallas", [None, False])
@pytest.mark.parametrize("ol,test_mode,guard", [
    (OL, False, False), (OL, True, False), (LONG_OL, False, True),
])
def test_v2_beam_only_decode_matches_jax_f32(f32, W, use_pallas, ol,
                                             test_mode, guard):
    """v2_duration_decode(fuse_model=False) (beam-only wrapper, or the
    plain step with use_pallas=False) against JAX's XLA route."""
    cfg, jm, params, toks, tm = f32
    dtab = np.asarray(cfg.duration_table, np.int32)
    kw = dict(beam_width=W, max_frames=max(ol), test_mode=test_mode)
    want = jax.jit(lambda p, tk, il, o: jdecode.v2_duration_decode(
        jm, p, tk, il, o, jnp.asarray(dtab), fuse_model=False,
        use_pallas=False,
        config=jcfg.V2BeamConfig(final_feasible_guard=guard), **kw))(
        params, jnp.asarray(toks), jnp.asarray(IL, jnp.int32),
        jnp.asarray(ol, jnp.int32))
    got = decode.v2_duration_decode(
        tm, torch.from_numpy(toks), torch.tensor(IL), torch.tensor(ol),
        dtab, fuse_model=False, use_pallas=use_pallas,
        config=tcfg.V2BeamConfig(final_feasible_guard=guard), **kw)
    assert set(got) == set(want)
    for k in V2_INT_KEYS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_allclose(got["log_prob"].numpy(),
                               np.asarray(want["log_prob"]), rtol=0,
                               atol=1e-4)


def _edit_pair(a, b, L=8):
    pa = np.full((1, L), -99, np.int32)
    pb = np.full((1, L), -98, np.int32)
    pa[0, :len(a)], pb[0, :len(b)] = a, b
    return pa, pb, np.array([len(a)], np.int32), np.array([len(b)], np.int32)


@pytest.mark.parametrize("a,b,want", [
    ([], [], 0), ([1], [1], 0), ([1, 2], [1, 2], 0), ([1], [], 1),
    ([1], [1, 2], 1), ([1, 2, 3, 4], [1, 2, 4], 1),
    ([1, 2, 3, 4, 5], [1, 2, 4], 2), ([1, 2, 3, 4, 5], [1, 2, 4, 6], 2),
    ([1, 2, 3, 4, 5, 1], [1, 2, 4, 6, 1], 2),
    ([1, 2, 3, 4, 5, 1], [1, 2, 4, 6, 1, 10], 3),
])
def test_edit_distance_kaldi_vectors(a, b, want):
    """tests/test_edit_distance.py (the reference's Kaldi vectors)."""
    got = edit_distance.levenshtein_edit_distance(
        *(torch.from_numpy(x) for x in _edit_pair(a, b)))
    assert got.dtype == torch.int32 and got.tolist() == [want]


def test_edit_distance_batched_golden():
    """tests/test_edit_distance.py::test_batched_golden."""
    a = np.array([[-1, -2, -3, -4, -5, -6], [1, -1, -2, -3, -4, -5],
                  [1, 2, -1, -2, -3, -4], [1, -1, -2, -3, -4, -5],
                  [1, -1, -2, -3, -4, -5], [1, 2, 3, 4, -1, -2],
                  [1, 2, 3, 4, 5, -1], [1, 2, 3, 4, 5, -1],
                  [1, 2, 3, 4, 5, 1], [1, 2, 3, 4, 5, 1]], np.int32)
    b = np.array([[-1, -1, -1, -1, -1, -1], [1, -1, -1, -1, -1, -1],
                  [1, 2, -1, -1, -1, -1], [-6, -5, -4, -3, -2, -1],
                  [1, 2, -1, -1, -1, -1], [1, 2, 4, -3, -2, -1],
                  [1, 2, 4, -3, -2, -1], [1, 2, 4, 6, -2, -1],
                  [1, 2, 4, 6, 1, -1], [1, 2, 4, 6, 1, 10]], np.int32)
    a_len = np.array([0, 1, 2, 1, 1, 4, 5, 5, 6, 6], np.int32)
    b_len = np.array([0, 1, 2, 0, 2, 3, 3, 4, 5, 6], np.int32)
    got = edit_distance.levenshtein_edit_distance(
        *(torch.from_numpy(x) for x in (a, b, a_len, b_len)))
    assert got.tolist() == [0, 0, 0, 1, 1, 1, 2, 2, 2, 3]


@pytest.mark.parametrize("seed", [0, 1])
def test_edit_distance_matches_jax_and_oracle(seed):
    rng = np.random.default_rng(seed)
    Bn, L = 16, 10
    a = rng.integers(0, 4, (Bn, L)).astype(np.int32)
    b = rng.integers(0, 4, (Bn, L)).astype(np.int32)
    a_len = rng.integers(0, L + 1, Bn).astype(np.int32)
    b_len = rng.integers(0, L + 1, Bn).astype(np.int32)
    got = edit_distance.levenshtein_edit_distance(
        *(torch.from_numpy(x) for x in (a, b, a_len, b_len))).numpy()
    want = np.asarray(jax.jit(jedit.levenshtein_edit_distance)(
        a, b, a_len, b_len))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, oracle.levenshtein_edit_distance(a, b, a_len, b_len))


def test_fused_tone_wrapper_runs_plain_step_on_cpu():
    """CPU tensors take the plain version; no kernel launch is counted."""
    rng = np.random.default_rng(6)
    Bn, W, K, H, Tn = 3, 4, 5, 16, 6
    g = lambda *s: torch.from_numpy(rng.normal(0, 0.3, s).astype(np.float32))
    fw = beam_fused.FusedWeights(g(K, H), g(H, 3 * H), g(3 * H), g(H, 3 * H),
                                 g(H), g(H, K), g(K))
    i32 = torch.int32
    il = torch.tensor([6, 2, 5], dtype=i32)
    t = torch.full((Bn, W), 2, dtype=i32)
    args = (2, g(Tn, Bn, H), g(Tn, Bn, K), fw,
            torch.from_numpy(rng.integers(0, K, (Bn, W))).to(i32),
            g(Bn, W, H), g(Bn, W), torch.tensor([[True] + [False] * 3] * 3),
            t, t + 1, il)
    dbg = (torch.empty(Bn, W, K), torch.empty(Bn, W, H))
    before = beam_fused.fused_tone_step.launches
    got = beam_fused.fused_tone_step(*args, empty_tone_id=3, debug_out=dbg)
    want = beam_fused.fused_tone_step_reference(*args, empty_tone_id=3)
    assert beam_fused.fused_tone_step.launches == before
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    h, new_h = stepmath.class_step_from_paths(
        *fw, args[1][2][:, None], args[2][2][:, None], args[5], args[4])
    torch.testing.assert_close(dbg[0], h, rtol=0, atol=0)
    torch.testing.assert_close(dbg[1], new_h, rtol=0, atol=0)
    idx = got.branch.long()[..., None].expand(-1, -1, H)
    torch.testing.assert_close(got.state, torch.gather(new_h, 1, idx))
    # Utterance 1 is past its length (t = 2 = T_b): every beam pads with
    # the empty tone and keeps its position.
    assert got.prediction[1].tolist() == [3] * W
    assert got.is_finished[1].all() and (got.next_t[1] == 2).all()
