"""PyTorch port, the serving path end to end: v2_duration_decode and
synthesize_from_alignment held against the jitted JAX XLA decode
(fuse_model=False, use_pallas=False) on the same weights and inputs.

On the CPU the port's decode runs the plain version of the fused step
(ops/beam_fused.fused_class_beam_step dispatches on the tensor's device).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssnt_tts_tpu.models import SSNTModel as JaxModel
from ssnt_tts_tpu.parallel import decode as jdecode
from ssnt_tts_tpu.utils import config as jcfg
from ssnt_tts_tpu_torch import convert
from ssnt_tts_tpu_torch.models.ssnt import SSNTModel
from ssnt_tts_tpu_torch.parallel import decode
from ssnt_tts_tpu_torch.utils import config as tcfg

B, T, U = 4, 12, 24
IL = [12, 9, 12, 5]
# Reference lengths (tests/test_beam_fused.py): U < 3(T-1) overruns, so
# outside test_mode every beam empties. LONG keeps the prunes binding
# without emptying everything.
OL = [20, 16, 24, 10]
LONG_OL = [44, 30, 40, 17]
INT_KEYS = ("prediction", "beam_branch", "ordered_beam_branch", "durations",
            "output_length", "source_indexes", "total_duration",
            "is_finished", "beam_emptied")


def _models(dtype):
    torch.set_num_threads(1)
    cfg = jcfg.tiny_model_config(dtype=dtype)
    jm = JaxModel(cfg)
    rng = np.random.default_rng(1)
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


def _decode_both(models, ol, W, test_mode=False, guard=False):
    cfg, jm, params, toks, tm = models
    dtab = np.asarray(cfg.duration_table, np.int32)
    kw = dict(beam_width=W, max_frames=max(ol), test_mode=test_mode)
    jc = jcfg.V2BeamConfig(final_feasible_guard=guard)
    want = jax.jit(lambda p, tk, il, o: jdecode.v2_duration_decode(
        jm, p, tk, il, o, jnp.asarray(dtab), fuse_model=False,
        use_pallas=False, config=jc, **kw))(
        params, jnp.asarray(toks), jnp.asarray(IL, jnp.int32),
        jnp.asarray(ol, jnp.int32))
    got = decode.v2_duration_decode(
        tm, torch.from_numpy(toks), torch.tensor(IL), torch.tensor(ol),
        dtab, config=tcfg.V2BeamConfig(final_feasible_guard=guard), **kw)
    return ({k: np.asarray(v) for k, v in want.items()},
            {k: v.numpy() for k, v in got.items()})


@pytest.mark.parametrize("W", [4, 8])
@pytest.mark.parametrize("ol,test_mode,guard", [
    (OL, False, False), (OL, True, False), (LONG_OL, False, True),
])
def test_v2_decode_matches_jax_f32(f32, W, ol, test_mode, guard):
    want, got = _decode_both(f32, ol, W, test_mode, guard)
    assert set(got) == set(want)
    for k in INT_KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["log_prob"], want["log_prob"],
                               rtol=0, atol=1e-4)
    if guard:  # the path did real work: some utterance landed its length
        ok = ~got["beam_emptied"]
        assert ok.any()
        np.testing.assert_array_equal(
            got["output_length"][ok], np.asarray(ol)[ok, None]
            .repeat(W, 1))


def test_v2_decode_matches_jax_bf16():
    models = _models("bfloat16")
    want, got = _decode_both(models, LONG_OL, 8, guard=True)
    np.testing.assert_array_equal(got["output_length"],
                                  want["output_length"])
    np.testing.assert_allclose(got["log_prob"], want["log_prob"],
                               rtol=0, atol=0.02)


def test_synthesize_decoded_best_beam_matches_jax(f32):
    cfg, jm, params, toks, tm = f32
    _, got = _decode_both(f32, LONG_OL, 8, guard=True)
    src = got["source_indexes"][:, 0, :]  # best beam (B, max(LONG_OL))
    enc = jm.apply(params, jnp.asarray(toks), jnp.asarray(IL, jnp.int32),
                   method=jm.encode)
    want = np.asarray(jm.apply(params, enc, jnp.asarray(src),
                               method=jm.synthesize_from_alignment))
    with torch.no_grad():
        mel = tm.synthesize_from_alignment(
            tm.encode(torch.from_numpy(toks), torch.tensor(IL)),
            torch.from_numpy(src))
    assert mel.shape == (B, max(LONG_OL), cfg.mel_dim)
    np.testing.assert_allclose(mel.numpy(), want, rtol=0, atol=1e-4)
