"""PyTorch port, beam widths above 16: v2_duration_decode, tone_decode and
beam_decode at W = 16, 17 and 32 on the port's three routes (on the CPU,
each wrapper's plain version) held against JAX's three routes on the same
weights (carried across by convert.flax_to_torch) and inputs: JAX's fused
and beam-only routes (Pallas, interpreted, as tests/test_beam_fused.py and
tests/test_beam_pallas.py run them) at W = 17 and 32, its XLA route
(fuse_model=False, use_pallas=False) at every width; the beam-only
wrappers at max_beam_width 17 and 40 against JAX's beam kernels; the wide
selection's range: the plain route against JAX's XLA route at W=128 with
16 duration and tone classes (2048 candidates a step; v1 256), and the
beam-only wrappers at W = max_beam_width = 128 against JAX's eager steps;
and check_beam_shape, the kernels' limits.

Integer outputs exactly equal; log-probs and mel frames within the
tolerances of tests/test_torch_decode.py, test_torch_tone.py and
test_torch_v1.py (1e-4, float32). Tiny config, B=3, T=6."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ssnt_tts_tpu.ops.beam_pallas as jbeam_pallas
from ssnt_tts_tpu.models import SSNTModel as JaxModel
from ssnt_tts_tpu.parallel import decode as jdecode
from ssnt_tts_tpu.utils import config as jcfg
from ssnt_tts_tpu_torch import convert
from ssnt_tts_tpu_torch.models.ssnt import SSNTModel
from ssnt_tts_tpu_torch.ops import beam_fused, beam_kernels
from ssnt_tts_tpu_torch.parallel import decode
from ssnt_tts_tpu_torch.utils import config as tcfg
from ssnt_tts_tpu.ops import beam_v1 as jbeam_v1
from ssnt_tts_tpu.ops import beam_v2 as jbeam_v2
from ssnt_tts_tpu.ops import tone_latent as jtone
from test_torch_beam_steps import (
    _TONE_ARGS, _V2_ARGS, _assert_same, _gathered, _other_width_case,
    _tone_inputs, _v1_inputs, _v2_inputs,
)

B, T, FRAMES = 3, 6, 12
IL = [6, 5, 4]
# Output lengths the duration classes (0-4 frames a token) can land
# without overrunning (U >= 3 (T - 1)), so that the prunes bind and some
# utterance keeps its beam.
OL = [18, 15, 11]
WIDTHS = (16, 17, 32)
JAX_INTERPRETED = (17, 32)  # JAX's Pallas routes, interpreted, are slow
# Each route of the port and the JAX route it is held to.
ROUTES = {
    "fused": ({}, dict(fuse_model=True)),
    "beam_only": ({"fuse_model": False},
                  dict(fuse_model=False, use_pallas=True)),
    "plain": ({"fuse_model": False, "use_pallas": False},
              dict(fuse_model=False, use_pallas=False)),
}
INT_KEYS = {
    "v2": ("prediction", "beam_branch", "ordered_beam_branch", "durations",
           "output_length", "source_indexes", "total_duration",
           "is_finished", "beam_emptied"),
    "tone": ("tones", "prediction", "beam_branch"),
    "v1": ("alignment", "beam_branch", "t_history", "prediction",
           "num_frames"),
}
FLOAT_KEYS = {"v2": ("log_prob",), "tone": ("log_prob",),
              "v1": ("log_prob", "mel")}
TOL = 1e-4


@pytest.fixture(scope="module")
def models():
    torch.set_num_threads(1)
    cfg = jcfg.tiny_model_config(dtype="float32")
    jm = JaxModel(cfg)
    rng = np.random.default_rng(3)
    toks = rng.integers(1, cfg.vocab_size, (B, T)).astype(np.int32)
    mel = jnp.asarray(rng.normal(0, 1, (B, max(OL), cfg.mel_dim)),
                      jnp.float32)
    dd = jnp.zeros((B, T), jnp.int32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(toks), mel,
                     jnp.asarray(IL, jnp.int32), jnp.asarray(OL, jnp.int32),
                     dd, dd, method=jm.loss)
    tm = SSNTModel(tcfg.ModelConfig(**dataclasses.asdict(cfg)), device="cpu")
    tm.load_state_dict(convert.flax_to_torch(jax.device_get(params), cfg))
    return cfg, jm, params, toks, tm.eval()


def _jax_fn(kind, jm, dtab, W, route):
    il = jnp.asarray(IL, jnp.int32)
    if kind == "v2":
        cfg = jcfg.V2BeamConfig(final_feasible_guard=True)
        return lambda p, tk: jdecode.v2_duration_decode(
            jm, p, tk, il, jnp.asarray(OL, jnp.int32), dtab, beam_width=W,
            max_frames=max(OL), config=cfg, **route)
    if kind == "tone":
        return lambda p, tk: jdecode.tone_decode(jm, p, tk, il,
                                                 beam_width=W, **route)
    return lambda p, tk: jdecode.beam_decode(jm, p, tk, il,
                                             max_frames=FRAMES,
                                             beam_width=W, **route)


@pytest.fixture(scope="module")
def jax_decodes(models):
    """JAX's decode by (kind, W, route), each run once for the module."""
    cfg, jm, params, toks, _ = models
    dtab = jnp.asarray(cfg.duration_table, jnp.int32)
    cache = {}

    def get(kind, W, route_name):
        key = (kind, W, route_name)
        if key not in cache:
            jbeam_pallas._INTERPRET = True
            try:
                fn = _jax_fn(kind, jm, dtab, W, ROUTES[route_name][1])
                out = jax.jit(fn)(params, jnp.asarray(toks))
                cache[key] = {k: np.asarray(v) for k, v in out.items()}
            finally:
                jbeam_pallas._INTERPRET = False
        return cache[key]
    return get


def _port_decode(models, kind, W, route):
    cfg, _, _, toks, tm = models
    tk, il = torch.from_numpy(toks), torch.tensor(IL)
    if kind == "v2":
        out = decode.v2_duration_decode(
            tm, tk, il, torch.tensor(OL), cfg.duration_table, beam_width=W,
            max_frames=max(OL),
            config=tcfg.V2BeamConfig(final_feasible_guard=True), **route)
    elif kind == "tone":
        out = decode.tone_decode(tm, tk, il, beam_width=W, **route)
    else:
        out = decode.beam_decode(tm, tk, il, max_frames=FRAMES,
                                 beam_width=W, **route)
    return {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("W", WIDTHS)
@pytest.mark.parametrize("kind", ["v2", "tone", "v1"])
def test_wide_decode_matches_jax(models, jax_decodes, kind, W, route):
    """The port's route at W against JAX's same route (its XLA route where
    JAX's interpreted Pallas route is not run). No route raises."""
    jax_route = route if route == "plain" or W in JAX_INTERPRETED else "plain"
    counters = (beam_fused.fused_class_beam_step, beam_fused.fused_tone_step,
                beam_fused.fused_v1_beam_step,
                beam_kernels.v2_beam_search_decode,
                beam_kernels.tone_beam_search_decode,
                beam_kernels.beam_search_step_reorder)
    before = [c.launches for c in counters]
    got = _port_decode(models, kind, W, ROUTES[route][0])
    want = jax_decodes(kind, W, jax_route)
    assert [c.launches for c in counters] == before  # CPU: no launch
    assert set(got) == set(want)
    for k in INT_KEYS[kind]:
        np.testing.assert_array_equal(got[k], want[k],
                                      err_msg=f"{kind} W={W} {route} {k}")
    for k in FLOAT_KEYS[kind]:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TOL,
                                   err_msg=f"{kind} W={W} {route} {k}")
    assert got["beam_branch"].shape[-1] == W
    if kind == "v2":  # the prunes bound and some utterance landed
        ok = ~got["beam_emptied"]
        assert ok.any()
        np.testing.assert_array_equal(
            got["output_length"][ok],
            np.asarray(OL)[ok, None].repeat(W, 1))


@pytest.mark.parametrize("W_out", [17, 40])
@pytest.mark.parametrize("kind", ["v1_batched", "v1_reorder", "v2",
                                  "v2_test_mode", "tone"])
def test_beam_only_wrappers_match_jax_at_wide_outputs(kind, W_out):
    """max_beam_width 17 and 40 from W = 4 (survivors padded by
    repetition): each beam-only wrapper (plain on CPU tensors) against
    JAX's beam kernel at the same max_beam_width, interpreted, and JAX's
    eager step, as test_beam_only_wrappers_match_jax_at_other_widths
    holds them at 3 and 9."""
    torch.set_num_threads(1)
    jbeam_pallas._INTERPRET = True
    try:
        compared = total = 0
        for seed in range(2):
            got, kern, xla = _other_width_case(kind, seed, 4, W_out)
            assert all(g.shape[1] == W_out for g in got if g.ndim >= 2)
            _assert_same(got, {f"field {i}": a for i, a in enumerate(xla)},
                         f"{kind} W_out={W_out} eager seed {seed}")
            same = np.ones(len(got[0]), bool)
            if kind == "v2":  # the interpreted diagonal window (Queue 3)
                for a, b in zip(kern, xla):
                    same &= (a == b).reshape(len(same), -1).all(axis=1)
            for i, (g, k) in enumerate(zip(got, kern)):
                np.testing.assert_array_equal(
                    g[same], k[same],
                    err_msg=f"{kind} W_out={W_out} kernel field {i}")
            compared += int(same.sum())
            total += len(same)
        assert compared >= 0.8 * total
    finally:
        jbeam_pallas._INTERPRET = False


# The wide selection's range: W = 128 beams of 16 classes, the kernels'
# MAX_BEAMS and MAX_CANDIDATES (2048).
W_MAX, CLASSES = 128, 16


@pytest.fixture(scope="module")
def models16():
    """JAX and port models with 16 duration classes (table 0..15 on both
    sides) and 16 tone classes, on the same weights."""
    torch.set_num_threads(1)
    cfg = jcfg.tiny_model_config(dtype="float32",
                                 duration_class_size=CLASSES,
                                 tone_class_size=CLASSES,
                                 duration_table=tuple(range(CLASSES)))
    jm = JaxModel(cfg)
    rng = np.random.default_rng(5)
    toks = rng.integers(1, cfg.vocab_size, (B, T)).astype(np.int32)
    mel = jnp.asarray(rng.normal(0, 1, (B, max(OL), cfg.mel_dim)),
                      jnp.float32)
    dd = jnp.zeros((B, T), jnp.int32)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(toks), mel,
                     jnp.asarray(IL, jnp.int32), jnp.asarray(OL, jnp.int32),
                     dd, dd, method=jm.loss)
    tm = SSNTModel(tcfg.ModelConfig(**dataclasses.asdict(cfg)), device="cpu")
    tm.load_state_dict(convert.flax_to_torch(jax.device_get(params), cfg))
    return cfg, jm, params, toks, tm.eval()


@pytest.mark.parametrize("kind", ["v2", "tone", "v1"])
def test_wide_selection_matches_jax_xla(models16, kind):
    """The port's plain route against JAX's XLA route at W = 128 with 16
    classes: 2048 candidates a step for v2 and tone (the top of
    wide_select's range on the card), 256 for v1. Integers exact,
    log-probs (and v1 mel) within 1e-4."""
    cfg, jm, params, toks, _ = models16
    assert cfg.duration_table == tuple(range(CLASSES))
    plain = ROUTES["plain"]
    dtab = jnp.asarray(cfg.duration_table, jnp.int32)
    want = jax.jit(_jax_fn(kind, jm, dtab, W_MAX, plain[1]))(
        params, jnp.asarray(toks))
    want = {k: np.asarray(v) for k, v in want.items()}
    got = _port_decode(models16, kind, W_MAX, plain[0])
    assert set(got) == set(want)
    for k in INT_KEYS[kind]:
        np.testing.assert_array_equal(got[k], want[k],
                                      err_msg=f"{kind} W={W_MAX} {k}")
    for k in FLOAT_KEYS[kind]:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TOL,
                                   err_msg=f"{kind} W={W_MAX} {k}")
    assert got["beam_branch"].shape[-1] == W_MAX
    # Every slot was selected: more than 256 distinct (branch, class)
    # candidates a step reach the selection.
    if kind != "v1":
        assert len(np.unique(got["prediction"])) > 1
    if kind == "v2":
        ok = ~got["beam_emptied"]
        assert ok.any()
        np.testing.assert_array_equal(
            got["output_length"][ok],
            np.asarray(OL)[ok, None].repeat(W_MAX, 1))


def _wide_case(kind, seed):
    """(port wrapper output, JAX eager step output with its rows gathered)
    of one beam-only step at W = max_beam_width = 128: v2 and tone over 16
    classes (2048 candidates), v1 over 256."""
    W = W_MAX
    if kind.startswith("v1"):
        x = _v1_inputs(seed, B=6, W=W)
        names = _TONE_ARGS
    elif kind == "tone":
        x = _tone_inputs(seed, B=6, W=W, K=CLASSES)
        names = _TONE_ARGS
    else:
        x = _v2_inputs(seed, B=6, W=W, D=CLASSES)
        x["dtab"] = np.array([0, 1, 2, 3, 5, 7, 4, 6, 8, 9, 11, 10, 12, 15,
                              13, 14], np.int32)
        names = _V2_ARGS
    tx = [torch.from_numpy(np.asarray(x[k])) for k in names]
    jx = [jnp.asarray(x[k]) for k in names]
    state = x["state"]
    np_ = lambda out: tuple(np.asarray(a) for a in out)
    if kind == "v1_batched":
        got = beam_kernels.beam_search_step_batched(*tx, max_beam_width=W)
        xla = jbeam_v1.beam_search_decode_batched(*jx, max_beam_width=W)
        return np_(got[:6]), np_(xla)
    if kind == "v1_reorder":
        got = beam_kernels.beam_search_step_reorder(
            *tx, torch.from_numpy(state), max_beam_width=W)
        xla = jbeam_v1.beam_search_decode_batched(*jx, max_beam_width=W)
        return np_(got), np_(xla) + (_gathered(state, xla[5]),)
    if kind == "tone":
        got = beam_kernels.tone_beam_search_decode(
            *tx, state=torch.from_numpy(state), empty_tone_id=1,
            max_beam_width=W)
        xla = jax.vmap(lambda *a: jtone.beam_search_step(
            *a, empty_tone_id=1, max_beam_width=W))(*jx)
        return np_(got), np_(xla) + (_gathered(state, xla[5]),)
    test_mode = kind == "v2_test_mode"
    kw = dict(zero_duration_id=0, allow_skip=False, test_mode=test_mode)
    got = beam_kernels.v2_beam_search_decode(
        *tx, state=torch.from_numpy(state), max_beam_width=W, **kw)
    with jax.disable_jit():
        h, lph, fin, tot, dtab, t, u, il, ol = jx
        if test_mode:
            ol = jnp.zeros_like(ol)
        xla = jax.vmap(
            lambda h_, lp_, f_, tt_, t_, u_, il_, ol_: jbeam_v2.
            beam_search_step(h_, lp_, f_, tt_, dtab, t_, u_, il_, ol_,
                             max_beam_width=W, return_num_survivors=True,
                             **kw))(h, lph, fin, tot, t, u, il, ol)
    return np_(got), np_(xla) + (_gathered(state, xla[6]),)


@pytest.mark.parametrize("kind", ["v1_batched", "v1_reorder", "v2",
                                  "v2_test_mode", "tone"])
def test_beam_only_wrappers_match_jax_at_max_width(kind):
    """Each beam-only wrapper's plain version (CPU tensors, no launch) at
    W = max_beam_width = 128 against JAX's eager step, bit for bit: ties
    among 2048 candidates (dyadic log-probs), duplicates, finished and
    past-the-end beams, and a first step whose copies collapse."""
    torch.set_num_threads(1)
    counters = (beam_kernels.v2_beam_search_decode,
                beam_kernels.tone_beam_search_decode,
                beam_kernels.beam_search_step_reorder,
                beam_kernels.beam_search_step_batched)
    before = [c.launches for c in counters]
    for seed in range(2):
        got, xla = _wide_case(kind, seed)
        assert all(g.shape[1] == W_MAX for g in got if g.ndim >= 2)
        _assert_same(got, {f"field {i}": a for i, a in enumerate(xla)},
                     f"{kind} W={W_MAX} seed {seed}")
    assert [c.launches for c in counters] == before


@pytest.mark.parametrize("W,W_out,C,ok", [
    (128, 128, 2048, True), (1, 1, 2, True), (8, 128, 80, True),
    (129, 8, 80, False), (8, 129, 80, False), (0, 1, 1, False),
    (8, 0, 80, False), (3, 3, 2049, False), (128, 128, 2049, False),
])
def test_check_beam_shape(W, W_out, C, ok):
    """The kernels' limits: W and W_out in 1..MAX_BEAMS (128), at most
    MAX_CANDIDATES (2048) candidates; ValueError naming the limit."""
    assert (beam_fused.MAX_BEAMS, beam_fused.MAX_CANDIDATES) == (128, 2048)
    if ok:
        beam_fused.check_beam_shape(W, W_out, C)
    else:
        with pytest.raises(ValueError, match="MAX_BEAMS|MAX_CANDIDATES"):
            beam_fused.check_beam_shape(W, W_out, C)


def test_kernel_wrappers_refuse_above_the_limits():
    """Off the CPU the wrappers check the limits before anything else:
    W = 129 and 2049 candidates raise ValueError naming the limit (on
    tensors of a device no kernel runs on, so nothing can launch), and at
    the limits the next check (the device) is reached. The plain versions
    take W = 129. JAX's D <= 64 stays."""
    meta = lambda *shape, dt=torch.float32: torch.zeros(*shape, dtype=dt,
                                                        device="meta")
    i32 = torch.int32

    def tone(W, K, dev="meta", **kw):
        z = (lambda *s, dt=torch.float32: torch.zeros(*s, dtype=dt)) \
            if dev == "cpu" else meta
        return beam_kernels.tone_beam_search_decode(
            z(2, W, K), z(2, W), z(2, W, dt=torch.bool), z(2, W, dt=i32),
            z(2, W, dt=i32), z(2, dt=i32) + 3, state=z(2, W, 4), **kw)

    with pytest.raises(ValueError, match="MAX_BEAMS"):
        tone(129, 2)
    with pytest.raises(ValueError, match="MAX_CANDIDATES"):
        tone(3, 683)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tone(128, 16)
    out = tone(129, 2, dev="cpu")
    assert out.prediction.shape == (2, 129) and out.state.shape == (2, 129, 4)
    with pytest.raises(ValueError, match="64"):
        beam_kernels.v2_beam_search_decode(
            meta(1, 2, 65), meta(1, 2), meta(1, 2, dt=torch.bool),
            meta(1, 2, dt=i32), meta(65, dt=i32), meta(1, 2, dt=i32),
            meta(1, 2, dt=i32), meta(1, dt=i32), meta(1, dt=i32),
            state=meta(1, 2, 4))
