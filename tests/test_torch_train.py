"""PyTorch port, training slice: the lattice joints, SSNTModel.forward /
loss and its gradients, the optimizer and three train steps held against
the JAX package on the same weights and numpy-seeded inputs
(tiny_model_config, float32, JAX on the CPU), plus the data generator,
the training loop and the device default.

Tolerances (float32): lattice quantities and losses rtol 1e-5 / atol 1e-5
(sums of a few hundred float32 terms in another order); gradient leaves
within 5e-5 of the leaf's largest entry plus 1e-6 (the encoder's
gradients gather every lattice cell's posterior through attention; the
largest differences seen are 1.8e-5 of the leaf's scale); parameters
after three AdamW steps atol 2e-6 (updates are lr * O(1); the largest
differences seen are 8e-7).
bfloat16 compute is compared loosely: the port rounds its products to
bf16 and differentiates in float32, flax differentiates in bf16.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ssnt_tts_tpu.data as jdata
from ssnt_tts_tpu.models import SSNTModel as JaxModel
from ssnt_tts_tpu.parallel import train as jtrain
from ssnt_tts_tpu.utils import config as jcfg
from ssnt_tts_tpu_torch import convert
from ssnt_tts_tpu_torch import data as tdata
from ssnt_tts_tpu_torch.models.ssnt import SSNTModel
from ssnt_tts_tpu_torch.parallel import train as ttrain
from ssnt_tts_tpu_torch.train_loop import run_training
from ssnt_tts_tpu_torch.utils import config as tcfg

B, T, U = 4, 12, 40


def _port_cfg(cfg):
    return tcfg.ModelConfig(**dataclasses.asdict(cfg))


def _batch(cfg, seed=0):
    ds = jdata.SyntheticTTSDataset(
        vocab_size=cfg.vocab_size, mel_dim=cfg.mel_dim, max_input_length=T,
        max_output_length=U, duration_class_size=cfg.duration_class_size,
        tone_class_size=cfg.tone_class_size, seed=seed)
    b = ds.batch(B)
    b.pop("alignment")
    return b


@functools.lru_cache(maxsize=None)
def _flax_init(dtype, duration_lattice):
    cfg = jcfg.tiny_model_config(dtype=dtype,
                                 use_duration_lattice=duration_lattice)
    jm = JaxModel(cfg)
    batch = _batch(cfg)
    params = jm.init(
        jax.random.PRNGKey(0), *(jnp.asarray(batch[k]) for k in (
            "tokens", "mel", "input_length", "output_length",
            "duration_target", "tone_target")), method=jm.loss)
    return cfg, jm, jax.device_get(params), batch


def _setup(dtype="float32", duration_lattice=False):
    """Flax model and weights (made once per configuration), and a fresh
    port model carrying the same weights."""
    torch.set_num_threads(1)
    cfg, jm, params, batch = _flax_init(dtype, duration_lattice)
    tm = SSNTModel(_port_cfg(cfg), device="cpu")
    tm.load_state_dict(convert.flax_to_torch(params, cfg))
    return cfg, jm, params, tm, batch


@pytest.fixture(scope="module")
def f32():
    return _setup()


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _args(batch, lib):
    return [lib(batch[k]) for k in ttrain.BATCH_KEYS]


# Its gradient is zero in exact arithmetic (softmax ignores a constant
# added to every score of a query), so both frameworks compute rounding
# noise there, ~1e-9, which Adam (eps 1e-8) turns into steps of up to
# ~lr/10 in no particular direction.
KEY_BIAS = "encoder.blocks.0.attn.key.bias"


def _assert_dicts_close(got, want, rel=5e-5, atol=1e-6):
    """Each leaf within rel * (its largest entry) + atol."""
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].detach().float()
        scale = float(w.abs().max())
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=rel * scale + atol, err_msg=k)


def _assert_tree_close(got, want_tree, cfg, **kw):
    _assert_dicts_close(got, convert.flax_to_torch(want_tree, cfg), **kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_joints_match_flax(dtype):
    cfg, jm, params, tm, batch = _setup(dtype)
    rng = np.random.default_rng(1)
    enc = rng.normal(0, 1, (B, T, cfg.encoder_dim)).astype(np.float32)
    dec = rng.normal(0, 1, (B, U, cfg.decoder_dim)).astype(np.float32)
    want = jm.apply(params, jnp.asarray(enc), jnp.asarray(dec),
                    jnp.asarray(batch["mel"]),
                    method=jm.lattice_quantities)
    with torch.no_grad():
        got = tm.lattice_quantities(torch.from_numpy(enc),
                                    torch.from_numpy(dec),
                                    torch.from_numpy(batch["mel"]))
    # bf16: operands rounded to bf16 in both, products summed in another
    # order, so the float32 outputs agree to a few bf16 ulps of the
    # logits (~1e-2 on values of magnitude ~1-10), log_frame relatively.
    for g, w, name in zip(got, want, ("emit", "shift", "frame")):
        w = np.asarray(w)
        assert g.shape == w.shape == (U, B, T) and g.is_contiguous()
        tol = 1e-5 if dtype == "float32" else 3e-2
        np.testing.assert_allclose(g.numpy(), w, rtol=tol, atol=tol,
                                   err_msg=name)


def test_transition_step_matches_flax(f32):
    cfg, jm, params, tm, _ = f32
    rng = np.random.default_rng(4)
    enc_t = rng.normal(0, 1, (B, 3, cfg.encoder_dim)).astype(np.float32)
    dec = rng.normal(0, 1, (B, 3, cfg.decoder_dim)).astype(np.float32)
    want = jm.apply(params, jnp.asarray(enc_t), jnp.asarray(dec),
                    method=lambda m, e, d: m.transition.step(e, d))
    with torch.no_grad():
        got = tm.transition.step(torch.from_numpy(enc_t),
                                 torch.from_numpy(dec))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_decoder_states_match_flax(f32):
    cfg, jm, params, tm, batch = f32
    want = jm.apply(params, jnp.asarray(batch["mel"]),
                    method=jm.decoder_states)
    with torch.no_grad():
        got = tm.decoder_states(torch.from_numpy(batch["mel"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("duration_lattice", [False, True])
def test_loss_and_grads_match_flax(duration_lattice):
    cfg, jm, params, tm, batch = _setup(duration_lattice=duration_lattice)

    def jloss(p):
        return jm.apply(p, *_args(batch, jnp.asarray), method=jm.loss)

    (want, wmet), wgrad = jax.value_and_grad(jloss, has_aux=True)(params)
    tm.train()
    loss, met = tm.loss(*_args(_tb(batch), lambda x: x))
    loss.backward()
    assert set(met) == set(wmet)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    for k in wmet:
        np.testing.assert_allclose(float(met[k]), float(wmet[k]),
                                   rtol=1e-5, err_msg=k)
    _assert_tree_close({k: p.grad for k, p in tm.named_parameters()},
                       jax.device_get(wgrad), cfg)
    with torch.no_grad():  # forward: per-example NLL
        nll = tm(*_args(_tb(batch), lambda x: x)[:4])
    want_nll = jm.apply(params, *_args(batch, jnp.asarray)[:4])
    np.testing.assert_allclose(nll.numpy(), np.asarray(want_nll), rtol=1e-5)


@pytest.mark.parametrize("lattice_dtype", ["float32", "bfloat16"])
def test_kernel_route_matches_plain_route(lattice_dtype):
    """lattice_impl="pallas" (the kernel wrappers, which take their plain
    versions on the CPU) against "xla" (ops/lattice) on one model.
    bfloat16 lattice storage: loss and gradients track float32 to a few
    percent."""
    cfg, _, params, _, batch = _setup()
    out = {}
    for impl in ("xla", "pallas"):
        c = _port_cfg(cfg)
        c = dataclasses.replace(c, lattice_impl=impl, lattice_dtype=(
            lattice_dtype if impl == "pallas" else "float32"))
        tm = SSNTModel(c, device="cpu")
        tm.load_state_dict(convert.flax_to_torch(params, cfg))
        loss, _ = tm.loss(*_args(_tb(batch), lambda x: x))
        loss.backward()
        out[impl] = (float(loss), {k: p.grad.clone()
                                   for k, p in tm.named_parameters()})
    # bf16 storage rounds every log-prob by up to 2^-9 relative, and the
    # error adds up along the 40-frame paths: up to ~2% of a leaf's scale.
    tol = 5e-5 if lattice_dtype == "float32" else 5e-2
    np.testing.assert_allclose(out["pallas"][0], out["xla"][0], rtol=tol)
    _assert_dicts_close(out["pallas"][1], out["xla"][1], rel=tol)


def test_schedule_matches_optax():
    for warmup in (2, 5):
        sched = optax.warmup_cosine_decay_schedule(
            0.0, 1e-3, warmup, max(10 * warmup, warmup + 1))
        tx = ttrain.make_optimizer(tcfg.TrainConfig(warmup_steps=warmup))
        for c in range(0, 12 * warmup):
            # optax evaluates the schedule in float32.
            np.testing.assert_allclose(tx.learning_rate(c), float(sched(c)),
                                       rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("clip", [1.0, 0.05])
def test_three_train_steps_match_jax(clip):
    """warmup_steps=2: lr is 0 on the first update, so three steps are
    needed. clip=0.05 makes the global-norm clip trigger."""
    cfg, jm, params, _, _ = _setup()
    train_cfg = jcfg.TrainConfig(warmup_steps=2, grad_clip_norm=clip,
                                 batch_size=B, max_input_length=T,
                                 max_output_length=U)
    jtx = jtrain.make_optimizer(train_cfg)
    jstate = jtrain.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                               opt_state=jtx.init(params))
    jstep = jax.jit(functools.partial(jtrain.train_step, jm, jtx))
    tt = tcfg.TrainConfig(**dataclasses.asdict(train_cfg))
    state = ttrain.init_train_state(_port_cfg(cfg), tt, params=params,
                                    device="cpu")
    tx = ttrain.make_optimizer(tt)
    ds = jdata.SyntheticTTSDataset(
        vocab_size=cfg.vocab_size, mel_dim=cfg.mel_dim, max_input_length=T,
        max_output_length=U, duration_class_size=cfg.duration_class_size,
        tone_class_size=cfg.tone_class_size, seed=5)
    for i in range(3):
        batch = ds.batch(B)
        batch.pop("alignment")
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        state, met = ttrain.train_step(tx, state, _tb(batch))
        assert set(met) == set(jmet)
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(met["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-4)
        if clip < 1.0:
            assert float(met["grad_norm"]) > clip
        want = convert.flax_to_torch(jax.device_get(jstate.params), cfg)
        got = state.model.state_dict()
        np.testing.assert_allclose(got.pop(KEY_BIAS).numpy(),
                                   want.pop(KEY_BIAS).numpy(), atol=1e-4)
        _assert_dicts_close(got, want, rel=0, atol=2e-6)
    assert state.step == 3 and state.opt_state.count == 3


@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_dataset_is_byte_identical(seed):
    kw = dict(vocab_size=32, mel_dim=8, max_input_length=T,
              max_output_length=U, duration_class_size=5, tone_class_size=4,
              seed=seed)
    a, b = jdata.SyntheticTTSDataset(**kw), tdata.SyntheticTTSDataset(**kw)
    for _ in range(2):
        x, y = a.batch(B), b.batch(B)
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype and x[k].tobytes() == \
                y[k].tobytes(), k


def test_prefetch_to_device_cpu():
    ds = tdata.SyntheticTTSDataset(vocab_size=32, mel_dim=8,
                                   max_input_length=T, max_output_length=U)
    it = tdata.prefetch_to_device(ds.batches(2), device="cpu")
    first = next(it)
    assert first["mel"].shape == (2, U, 8)
    assert first["tokens"].dtype == torch.int32
    it.close()  # stops the staging thread


def test_run_training_cpu(tmp_path):
    path = tmp_path / "metrics.jsonl"
    cfg = tcfg.tiny_model_config()
    train_cfg = tcfg.TrainConfig(warmup_steps=2, batch_size=2,
                                 max_input_length=T, max_output_length=U)
    last = run_training(3, cfg, train_cfg, seed=0, device="cpu",
                        metrics_path=str(path), log_every=2)
    assert set(last) == {"loss", "nll_per_frame", "duration_nll",
                         "tone_nll", "grad_norm"}
    assert all(np.isfinite(v) for v in last.values())
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert [r["step"] for r in lines] == [2, 3]


def test_converter_covers_every_leaf(f32):
    cfg, _, params, tm, _ = f32
    state = convert.flax_to_torch(params, cfg)
    assert set(state) == set(tm.state_dict())
    n_flax = sum(np.size(x) for x in jax.tree_util.tree_leaves(params))
    assert sum(v.numel() for v in state.values()) == n_flax
    tm.load_state_dict(state, strict=True)


def test_entry_points_default_to_the_card():
    """No silent CPU fallback: without a device argument the model, the
    train state, the loop and the prefetch go to CUDA, and raise on a
    machine without one."""
    cfg = tcfg.tiny_model_config()
    if torch.cuda.is_available():
        assert SSNTModel(cfg).encoder.embed.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SSNTModel(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.init_train_state(cfg, tcfg.TrainConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_training(1, cfg, tcfg.TrainConfig(batch_size=2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(tdata.prefetch_to_device(iter([])))


def test_unported_options_raise(f32):
    """lattice_tshard_min_cells was refused until the distribution slice
    was ported. The model now takes it; outside tshard_lattice (which
    make_sharded_train_step enters) the loss keeps its usual route, as in
    JAX: the same NLL as the config without it."""
    cfg, _, params, tm, batch = f32
    sharded_cfg = _port_cfg(dataclasses.replace(cfg,
                                                lattice_tshard_min_cells=10))
    tm_s = SSNTModel(sharded_cfg, device="cpu")
    tm_s.load_state_dict(convert.flax_to_torch(params, cfg))
    args = [torch.from_numpy(batch[k]) for k in ttrain.BATCH_KEYS[:4]]
    with torch.no_grad():
        assert torch.equal(tm_s(*args), tm(*args))
