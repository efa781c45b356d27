"""PyTorch port, scripts/profile_decode: its component steps held against
the same bodies built from the JAX package (scripts/profile_decode.py's
full_step, beam_step and gather_step: SSNTModel.decode_step, then JAX's
beam-only kernels #11 / #10 interpreted, as tests/test_torch_beam_v1.py
runs them, or its plain branch beam_v1.beam_search_decode_batched with
take_along_axis) on the same weights (convert.flax_to_torch), encoder
output and carry, over 4 chained frames on both routes; the full step
iterated over every frame bit for bit the port's beam_decode on the same
route, with beams that finish (the mel keep); the record; no CPU
fallback.

Integers exactly equal. The full step's floats (after decode_step) within
1e-4, test_torch_v1.py's tolerance for the decode's log-probs and mel;
the beam and gather steps, fed equal inputs, bit for bit (the kernels'
selected -0.0 compared by IEEE ==, as test_torch_beam_v1.py does).
Tiny config, float32, B=4, T=12, W=4."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ssnt_tts_tpu.ops.beam_pallas as jbeam_pallas
from ssnt_tts_tpu.models import SSNTModel as JaxModel
from ssnt_tts_tpu.ops import beam_v1 as jbeam_v1
from ssnt_tts_tpu.utils import config as jcfg
from ssnt_tts_tpu_torch import convert
from ssnt_tts_tpu_torch.models.ssnt import SSNTModel
from ssnt_tts_tpu_torch.ops import beam_kernels
from ssnt_tts_tpu_torch.parallel import decode
from ssnt_tts_tpu_torch.scripts import profile_decode as pd
from ssnt_tts_tpu_torch.utils import config as tcfg

B, T, W, FRAMES = 4, 12, 4, 4
IL = [12, 9, 12, 5]
TOL = 1e-4
CARRY = ("t", "u", "log_prob", "is_finished", "state", "mel")


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setattr(jbeam_pallas, "_INTERPRET", True)


@pytest.fixture(scope="module")
def models():
    cfg = jcfg.tiny_model_config(dtype="float32")
    jm = JaxModel(cfg)
    rng = np.random.default_rng(11)
    toks = rng.integers(1, cfg.vocab_size, (B, T)).astype(np.int32)
    mel = jnp.asarray(rng.normal(0, 1, (B, 24, cfg.mel_dim)), jnp.float32)
    dd = jnp.zeros((B, T), jnp.int32)
    il = jnp.asarray(IL, jnp.int32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(toks), mel, il,
                     jnp.full((B,), 24, jnp.int32), dd, dd, method=jm.loss)
    tm = SSNTModel(tcfg.ModelConfig(**dataclasses.asdict(cfg)), device="cpu")
    tm.load_state_dict(convert.flax_to_torch(jax.device_get(params), cfg))
    enc = jm.apply(params, jnp.asarray(toks), il, method=jm.encode)
    return cfg, jm, params, toks, tm.eval(), np.array(enc)


def _carry(cfg, seed):
    """A start carry (numpy): zeros (seed None), else beams spread over
    their utterance, some at its last position or finished, with state
    and previous mel drawn."""
    H, M = cfg.decoder_dim, cfg.mel_dim
    if seed is None:
        return [np.zeros((B, W), np.int32), np.zeros((B, W), np.int32),
                np.zeros((B, W), np.float32), np.zeros((B, W), bool),
                np.zeros((B, W, H), np.float32),
                np.zeros((B, W, M), np.float32)]
    rng = np.random.default_rng(seed)
    il = np.asarray(IL)[:, None]
    t = np.minimum(rng.integers(0, T, (B, W)), il - 1).astype(np.int32)
    t[:, 0] = il[:, 0] - 1
    return [t, (t + rng.integers(0, 4, (B, W))).astype(np.int32),
            (-rng.random((B, W)) * 3).astype(np.float32),
            rng.random((B, W)) < 0.3,
            rng.normal(0, 1, (B, W, H)).astype(np.float32),
            rng.normal(0, 1, (B, W, M)).astype(np.float32)]


def _jax_full_step(jm, params, enc, use_pallas):
    """scripts/profile_decode.py's full_step."""
    H, M = jm.config.decoder_dim, jm.config.mel_dim
    il = jnp.asarray(IL, jnp.int32)

    def full_step(carry):
        t, u, lp, fin, dec_state, prev_mel = carry
        h, new_state, mel = jm.apply(params, enc, jnp.clip(t, 0, T - 1),
                                     dec_state, prev_mel,
                                     method=jm.decode_step)
        if use_pallas:
            packed = jnp.concatenate(
                [new_state, mel, prev_mel, fin.astype(jnp.float32)[..., None],
                 t.astype(jnp.float32)[..., None]], axis=-1)
            pred, lp2, nt, nu, nfin, branch, packed = (
                jbeam_pallas.beam_search_step_reorder(h, lp, fin, t, u, il,
                                                      packed))
            new_state, mel, prev_mel_g = (
                packed[..., :H], packed[..., H:H + M],
                packed[..., H + M:-2])
            fin_prev = packed[..., -2] != 0
        else:
            pred, lp2, nt, nu, nfin, branch = (
                jbeam_v1.beam_search_decode_batched(h, lp, fin, t, u, il))
            branch_i = branch[..., None].astype(jnp.int32)
            packed = jnp.concatenate([new_state, mel, prev_mel], axis=-1)
            packed = jnp.take_along_axis(packed, branch_i, axis=1)
            new_state, mel, prev_mel_g = (packed[..., :H],
                                          packed[..., H:H + M],
                                          packed[..., H + M:])
            ints = jnp.stack([fin.astype(jnp.int32), t], axis=-1)
            fin_prev = jnp.take_along_axis(ints, branch_i, axis=1)[
                ..., 0].astype(bool)
        mel = jnp.where(nfin[..., None] & fin_prev[..., None], prev_mel_g,
                        mel)
        return (nt, nu, lp2, nfin, new_state, mel)
    return full_step


def _chain(step, carry, n):
    for _ in range(n):
        carry = step(carry)
    return [np.asarray(x) for x in carry]


def _port_chain(step, carry, n):
    with torch.no_grad():
        return _chain(step, tuple(torch.from_numpy(np.array(a))
                                  for a in carry), n)


@pytest.mark.parametrize("start", [None, 7], ids=["zero", "spread"])
@pytest.mark.parametrize("route", pd.ROUTES)
def test_full_step_matches_jax(models, route, start):
    """4 chained full frames from one carry: the port's (decode's own
    v1_beam_only_step) against JAX's script's body on the same route."""
    cfg, jm, params, _, tm, enc = models
    carry = _carry(cfg, start)
    jstep = _jax_full_step(jm, params, jnp.asarray(enc),
                           use_pallas=route == "beam-only")
    want = _chain(jstep, [jnp.asarray(a) for a in carry], FRAMES)
    got = _port_chain(pd.make_full_step(tm, torch.from_numpy(enc),
                                        torch.tensor(IL, dtype=torch.int32),
                                        route), carry, FRAMES)
    for name, g, w in zip(CARRY, got, want):
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=0, atol=TOL,
                                       err_msg=f"{route} {name}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{route} {name}")


@pytest.mark.parametrize("route", pd.ROUTES)
def test_beam_and_gather_steps_match_jax(models, route):
    """The beam component (#10 beam_search_step_batched interpreted, or
    JAX's plain step, on h0 + lp * 1e-20) and the gather component over 4
    chained frames, from equal inputs: equal to JAX's script's bodies."""
    cfg, *_ = models
    H, M = cfg.decoder_dim, cfg.mel_dim
    carry = _carry(cfg, 3)
    h0 = np.random.default_rng(4).normal(0, 1, (B, W, 2)).astype(np.float32)
    il = jnp.asarray(IL, jnp.int32)
    jfn = (jbeam_pallas.beam_search_step_batched if route == "beam-only"
           else jbeam_v1.beam_search_decode_batched)

    def jbeam(c):
        t, u, lp, fin = c
        out = jfn(jnp.asarray(h0) + lp[..., None] * 1e-20, lp, fin, t, u, il)
        return (out[2], out[3], out[1] * 1e-6, out[4])

    def jgather(c):
        s, pm = c
        branch = (jnp.zeros((B, W), jnp.int32)
                  + (s[:, :1, 0] * 0).astype(jnp.int32))
        packed = jnp.take_along_axis(
            jnp.concatenate([s, pm, pm], axis=-1), branch[..., None], axis=1)
        return (packed[..., :H], packed[..., H:H + M])

    cases = (
        ("beam", pd.make_beam_step(torch.from_numpy(h0),
                                   torch.tensor(IL, dtype=torch.int32),
                                   route), jbeam, carry[:4]),
        ("gather", pd.make_gather_step(H, M), jgather, carry[4:]))
    for name, step, jstep, c in cases:
        want = _chain(jstep, [jnp.asarray(a) for a in c], FRAMES)
        got = _port_chain(step, c, FRAMES)
        for i, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(g, w, err_msg=f"{route} {name} {i}")


@pytest.mark.parametrize("route", pd.ROUTES)
def test_full_step_decodes_as_beam_decode(models, route):
    """The full step run over every frame (decode_by_frames) bit for bit
    the port's beam_decode on the same route; short utterances finish, so
    the finished-beam mel keep is taken."""
    cfg, _, _, toks, tm, _ = models
    tokens = torch.from_numpy(toks)
    il = torch.tensor([3, 2, 12, 1], dtype=torch.int32)
    frames = 20
    kw = {"fuse_model": False}
    if route == "plain":
        kw["use_pallas"] = False
    before = beam_kernels.beam_search_step_reorder.launches
    got = pd.decode_by_frames(tm, tokens, il, frames, W, route)
    want = decode.beam_decode(tm, tokens, il, max_frames=frames,
                              beam_width=W, **kw)
    assert beam_kernels.beam_search_step_reorder.launches == before
    assert got.pop("kept") > 0
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_main_record(tmp_path):
    """main at a tiny size on the CPU: every component's us a step (the
    median of 2 rounds), the unattributed rest, the steps bench_step ran,
    and the trace's record (no device kernels on the CPU: not
    measured)."""
    out = tmp_path / "profile.json"
    got = {}
    rec = pd.main(["--cpu", "--tiny", "--batch", "2", "--beam", "2", "--seq",
                   "6", "12", "--max-iters", "40", "--rounds", "2",
                   "--trace", str(tmp_path / "trace"), "--json", str(out)],
                  outputs=got)
    assert set(pd.COMPONENTS) <= set(rec)
    assert rec["unattributed"] == pytest.approx(
        rec["full"] - rec["components_sum"], abs=2e-3)
    assert all(rec[k] > 0 for k in pd.COMPONENTS)
    assert rec["route"] == "beam-only" and rec["platform"] == "cpu"
    assert set(rec["steps"]) == set(pd.COMPONENTS) | {"traced"}
    assert all(n >= 80 for k, n in rec["steps"].items() if k != "traced")
    for k in pd.COMPONENTS:  # each the median of its two rounds
        assert rec[k] == pytest.approx(np.median(rec["rounds_us"][k]),
                                       abs=2e-3)
    assert rec["steps"]["traced"] == pd.TRACE_FRAMES + 1
    assert rec["trace"]["kernels"] == 0 and rec["trace"]["busy_share"] is None
    assert set(got["steps"]) == set(pd.COMPONENTS)
    assert out.exists()


def test_no_card_raises():
    """Without --cpu the tool runs on the card; with none it raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pd.main(["--tiny"])
