"""PyTorch port, exp-domain training (ModelConfig.lattice_domain="exp"):
the joints emit the probability-domain quadruple (E, S, F, mcol) and the
loss runs the exp-native pass. Held against the JAX package on the same
converted weights and numpy-seeded batches (tiny_model_config, JAX on the
CPU, its exp-native Pallas kernel interpreted) on both routes:
lattice_impl="pallas" (the port's kernel wrappers, which take their plain
versions on the CPU) and "auto" (on the CPU both frameworks take logs
and run the plain log-domain loss); then against the port's own log
domain, the training loop, and bfloat16 lattice storage.

Tolerances: float32 as tests/test_torch_train.py (loss rtol 1e-5,
gradient leaves within 5e-5 of the leaf's largest entry plus 1e-6, three
AdamW steps atol 2e-6). bfloat16 compute is compared loosely (flax
differentiates in bf16, the port in float32; the losses differ by
2.4e-4 relative on this seed): loss rtol 1e-3, gradient cosine > 0.999.
Exp against log domain: loss rtol 1e-4 and gradient cosine > 0.999,
JAX's own tolerance (tests/test_model.py::test_exp_domain_lattice_training).
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ssnt_tts_tpu.data as jdata
from ssnt_tts_tpu.models import SSNTModel as JaxModel
from ssnt_tts_tpu.ops import lattice_pallas as jpal
from ssnt_tts_tpu.parallel import train as jtrain
from ssnt_tts_tpu.utils import config as jcfg
from ssnt_tts_tpu_torch import convert
from ssnt_tts_tpu_torch.models.ssnt import SSNTModel, lattice_loss
from ssnt_tts_tpu_torch.parallel import train as ttrain
from ssnt_tts_tpu_torch.train_loop import run_training
from ssnt_tts_tpu_torch.utils import config as tcfg

B, T, U = 4, 12, 40
# Rounding noise in both frameworks (tests/test_torch_train.py).
KEY_BIAS = "encoder.blocks.0.attn.key.bias"


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jpal, "_INTERPRET", True)
    torch.set_num_threads(1)


def _cfg(**kw):
    return jcfg.tiny_model_config(lattice_domain="exp", **kw)


def _batch(seed=0):
    """A synthetic batch with ragged lengths."""
    cfg = _cfg()
    ds = jdata.SyntheticTTSDataset(
        vocab_size=cfg.vocab_size, mel_dim=cfg.mel_dim, max_input_length=T,
        max_output_length=U, duration_class_size=cfg.duration_class_size,
        tone_class_size=cfg.tone_class_size, seed=seed)
    b = ds.batch(B)
    b.pop("alignment")
    return b


@functools.lru_cache(maxsize=None)
def _params(dtype, log_sigma=None):
    """Flax weights (the parameters are the same in both domains), with
    the frame joint's log_sigma set when given."""
    cfg = jcfg.tiny_model_config(dtype=dtype)
    jm = JaxModel(cfg)
    args = [jnp.asarray(v) for v in _batch().values()]
    init = jax.jit(lambda k, *a: jm.init(k, *a, method=jm.loss))
    params = jax.device_get(init(jax.random.PRNGKey(0), *args))
    if log_sigma is not None:
        params["params"]["frame"]["log_sigma"] = np.float32(log_sigma)
    return params


# JAX's exp-native backward clamps a scalar exponent that grows with the
# frame likelihoods' spread and cuts the posteriors once it passes 30
# (tests/test_torch_lattice_exp.py::test_jax_expin_clamp_cuts_posteriors).
# Its kernel route is compared on weights whose likelihoods spread less
# (sigma = e^1.5 where the initial weights have 1; at e^1.0 the clamp
# still binds on a few cells), where it is right.
JAX_LOG_SIGMA = 1.5


def _args(batch, lib):
    return [lib(batch[k]) for k in ttrain.BATCH_KEYS]


def _port_model(cfg, params):
    tm = SSNTModel(tcfg.ModelConfig(**dataclasses.asdict(cfg)), device="cpu")
    tm.load_state_dict(convert.flax_to_torch(params, cfg))
    return tm


def _jax_loss_and_grads(cfg, params, batch):
    jm = JaxModel(cfg)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jm.apply(p, *_args(batch, jnp.asarray), method=jm.loss),
        has_aux=True))(params)
    return float(loss), convert.flax_to_torch(jax.device_get(grads), cfg)


def _port_loss_and_grads(cfg, params, batch):
    tm = _port_model(cfg, params)
    loss, _ = tm.loss(*_args(batch, torch.from_numpy))
    loss.backward()
    return float(loss), {k: p.grad.clone() for k, p in tm.named_parameters()}


def _cosine(a, b):
    fa = torch.cat([a[k].float().ravel() for k in sorted(a)])
    fb = torch.cat([b[k].float().ravel() for k in sorted(a)])
    return float(fa @ fb / (fa.norm() * fb.norm()))


def _assert_dicts_close(got, want, rel=5e-5, atol=1e-6):
    """Each leaf within rel * (its largest entry) + atol."""
    assert set(got) == set(want)
    for k, w in want.items():
        scale = float(w.abs().max())
        np.testing.assert_allclose(got[k].float().numpy(), w.numpy(), rtol=0,
                                   atol=rel * scale + atol, err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["pallas", "auto"])
def test_exp_loss_and_grads_match_flax(impl, dtype):
    """Loss and every parameter gradient against flax's exp-domain model
    (jitted, as its train step runs)."""
    cfg = _cfg(dtype=dtype, lattice_impl=impl)
    params = _params(dtype, JAX_LOG_SIGMA)
    batch = _batch()
    want, wg = _jax_loss_and_grads(cfg, params, batch)
    got, gg = _port_loss_and_grads(cfg, params, batch)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5)
        _assert_dicts_close(gg, wg)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-3)
        assert _cosine(gg, wg) > 0.999


def test_three_exp_train_steps_match_jax():
    """Three train steps on the kernel route against JAX's jitted
    train_step with the interpreted exp-native kernel, to
    tests/test_torch_train.py::test_three_train_steps_match_jax's
    tolerances."""
    cfg = _cfg(lattice_impl="pallas")
    params = _params("float32", JAX_LOG_SIGMA)
    train_cfg = jcfg.TrainConfig(warmup_steps=2, batch_size=B,
                                 max_input_length=T, max_output_length=U)
    jtx = jtrain.make_optimizer(train_cfg)
    jstate = jtrain.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                               opt_state=jtx.init(params))
    jstep = jax.jit(functools.partial(jtrain.train_step, JaxModel(cfg), jtx))
    tt = tcfg.TrainConfig(**dataclasses.asdict(train_cfg))
    state = ttrain.init_train_state(
        tcfg.ModelConfig(**dataclasses.asdict(cfg)), tt, params=params,
        device="cpu")
    tx = ttrain.make_optimizer(tt)
    for i in range(3):
        batch = _batch(seed=5 + i)
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        state, met = ttrain.train_step(
            tx, state, {k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(met["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-4)
        want = convert.flax_to_torch(jax.device_get(jstate.params), cfg)
        got = state.model.state_dict()
        np.testing.assert_allclose(got.pop(KEY_BIAS).numpy(),
                                   want.pop(KEY_BIAS).numpy(), atol=1e-4)
        _assert_dicts_close(got, want, rel=0, atol=2e-6)


@pytest.mark.parametrize("impl", ["pallas", "auto"])
def test_exp_domain_matches_log_domain(impl):
    """The port's exp-domain loss and gradients against its log domain on
    the same weights and ragged batch."""
    params = _params("float32")
    batch = _batch()
    loss_e, g_e = _port_loss_and_grads(_cfg(lattice_impl=impl), params,
                                       batch)
    loss_l, g_l = _port_loss_and_grads(
        jcfg.tiny_model_config(lattice_impl=impl), params, batch)
    np.testing.assert_allclose(loss_e, loss_l, rtol=1e-4)
    assert _cosine(g_e, g_l) > 0.999


def test_run_training_exp_cpu(tmp_path):
    """A few steps with a falling loss, from given weights (the random
    tree with a wider frame sigma, as chip_smoke.py's phase 19 trains)."""
    path = tmp_path / "metrics.jsonl"
    cfg = tcfg.tiny_model_config(lattice_domain="exp")
    tree = convert.random_flax_tree(cfg, 0)
    tree["params"]["frame"]["log_sigma"] = np.float32(2.0)
    train_cfg = tcfg.TrainConfig(warmup_steps=2, batch_size=4,
                                 max_input_length=T, max_output_length=U)
    last = run_training(6, cfg, train_cfg, device="cpu",
                        metrics_path=str(path), log_every=1, params=tree)
    assert all(np.isfinite(v) for v in last.values())
    rows = [json.loads(x) for x in path.read_text().splitlines()]
    assert [r["step"] for r in rows] == list(range(1, 7))
    assert rows[-1]["nll_per_frame"] < rows[0]["nll_per_frame"]


def test_bf16_lattice_storage_exp():
    """lattice_dtype="bfloat16": E, S, F are stored in bfloat16 (mcol in
    float32), the loss upcasts them, and their gradients come back to the
    joints in bfloat16. Loss and gradients track float32 storage to a few
    percent, as the log domain's bf16 storage does
    (tests/test_torch_train.py::test_kernel_route_matches_plain_route)."""
    params = _params("float32")
    batch = _batch()
    toks, mel, il, ol = _args(batch, torch.from_numpy)[:4]
    out = {}
    for ldt in ("float32", "bfloat16"):
        cfg = _cfg(lattice_impl="pallas", lattice_dtype=ldt)
        tm = _port_model(cfg, params)
        q = tm.lattice_quantities(tm.encode(toks, il),
                                  tm.decoder_states(mel), mel, il)
        want = [getattr(torch, ldt)] * 3 + [torch.float32]
        assert [x.dtype for x in q] == want
        for x in q:
            x.retain_grad()
        lattice_loss("pallas", ldt, q, il, ol, "exp").sum().backward()
        assert [x.grad.dtype for x in q] == want
        out[ldt] = (q[0].grad.float(), {k: p.grad for k, p in
                                        tm.named_parameters()
                                        if p.grad is not None})
    assert torch.isfinite(out["bfloat16"][0]).all()
    for grads in (out["bfloat16"][1], out["float32"][1]):
        grads.pop(KEY_BIAS)  # rounding noise in both
    _assert_dicts_close(out["bfloat16"][1], out["float32"][1], rel=5e-2)
