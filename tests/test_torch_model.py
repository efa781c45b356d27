"""PyTorch port, model side: config mirror, converter, encoder, class
step and synthesis held against the JAX package on the same weights and
inputs (tiny f32 config, numpy-seeded inputs, JAX on the CPU)."""

import ast
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ssnt_tts_tpu.utils.config as jcfg
from ssnt_tts_tpu.models import SSNTModel as JaxModel
from ssnt_tts_tpu.models import stepmath as jstep
from ssnt_tts_tpu_torch import convert
from ssnt_tts_tpu_torch.models import stepmath as tstep
from ssnt_tts_tpu_torch.models.ssnt import SSNTModel
from ssnt_tts_tpu_torch.utils import config as tcfg

REPO = pathlib.Path(__file__).resolve().parent.parent
B, T, U = 4, 12, 24
IL = [12, 9, 12, 5]
OL = [20, 16, 24, 10]


def _flax_setup(dtype="float32", **over):
    cfg = jcfg.tiny_model_config(dtype=dtype, **over)
    model = JaxModel(cfg)
    rng = np.random.default_rng(1)
    toks = rng.integers(1, cfg.vocab_size, (B, T)).astype(np.int32)
    mel = rng.normal(0, 1, (B, U, cfg.mel_dim)).astype(np.float32)
    dd = jnp.zeros((B, T), jnp.int32)
    params = model.init(
        jax.random.PRNGKey(0), jnp.asarray(toks), jnp.asarray(mel),
        jnp.asarray(IL, jnp.int32), jnp.asarray(OL, jnp.int32), dd, dd,
        method=model.loss,
    )
    return cfg, model, params, toks


def _torch_model(cfg, params):
    tm = SSNTModel(tcfg.ModelConfig(**dataclasses.asdict(cfg)), device="cpu")
    tm.load_state_dict(convert.flax_to_torch(jax.device_get(params), cfg))
    return tm.eval()


@pytest.fixture(scope="module")
def setup():
    torch.set_num_threads(1)
    cfg, model, params, toks = _flax_setup()
    return cfg, model, params, toks, _torch_model(cfg, params)


@pytest.mark.parametrize("name", [
    "BeamConfig", "V2BeamConfig", "ToneBeamConfig", "ModelConfig",
    "TrainConfig", "MeshConfig",
])
def test_config_mirror(name):
    ref, port = getattr(jcfg, name), getattr(tcfg, name)
    pair = lambda c: [(f.name, f.default) for f in dataclasses.fields(c)]
    assert pair(port) == pair(ref)
    assert dataclasses.asdict(tcfg.tiny_model_config()) == (
        dataclasses.asdict(jcfg.tiny_model_config()))


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((REPO / "ssnt_tts_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    banned = ("jax", "flax", "ssnt_tts_tpu", "orbax", "optax")
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in banned, f"{f.relative_to(REPO)} imports {mod}"


def test_random_tree_has_flax_layout(setup):
    cfg, _, params, _, _ = setup
    flat = lambda tree: {
        "/".join(k.key for k in path): np.shape(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert flat(convert.random_flax_tree(cfg, 0)) == flat(params)


def test_random_tree_size_at_serving_width():
    cfg = tcfg.ModelConfig(vocab_size=128, mel_dim=80, encoder_dim=256,
                           encoder_layers=2, encoder_heads=4,
                           decoder_dim=256, joint_rank=64)
    tree = convert.random_flax_tree(cfg, 0)
    n = sum(a.size for a in convert._flatten(tree["params"]).values())
    assert n == 4_244_233  # the flax init's count at this config


def test_converter_rejects_unknown_leaf(setup):
    cfg, _, params, _, _ = setup
    tree = jax.device_get(params)
    tree["params"]["encoder"]["Extra_0"] = {"kernel": np.zeros((2, 2))}
    with pytest.raises(KeyError, match="Extra_0"):
        convert.flax_to_torch(tree, cfg)
    del tree["params"]["encoder"]["Extra_0"]
    del tree["params"]["frame"]["enc_mel"]
    with pytest.raises(KeyError, match="enc_mel"):
        convert.flax_to_torch(tree, cfg)


def test_encoder_matches_flax(setup):
    cfg, model, params, toks, tm = setup
    il = jnp.asarray(IL, jnp.int32)
    want = np.asarray(model.apply(params, jnp.asarray(toks), il,
                                  method=model.encode))
    got = tm.encode(torch.from_numpy(toks), torch.tensor(IL)).detach()
    assert np.isfinite(got.numpy()).all()  # padded rows: uniform, not NaN
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_class_step_matches_stepmath(setup):
    cfg, model, params, toks, tm = setup
    rng = np.random.default_rng(2)
    W = 8
    enc = np.array(model.apply(params, jnp.asarray(toks),
                               jnp.asarray(IL, jnp.int32),
                               method=model.encode))
    t = rng.integers(0, T, (B, W))
    enc_t = np.take_along_axis(enc, t[..., None], axis=1)
    state = rng.normal(0, 1, (B, W, cfg.decoder_dim)).astype(np.float32)
    pc = rng.integers(0, cfg.duration_class_size, (B, W)).astype(np.int32)
    jw = jstep.extract_class_step_weights(params, "duration_head",
                                          "duration_ar")
    h_want, ns_want = jstep.class_step_math(
        jw, jnp.asarray(enc_t), jnp.asarray(state), jnp.asarray(pc),
        jnp.float32)
    with torch.no_grad():
        h_got, ns_got = tstep.class_step_math(
            tm.duration_step_weights(), torch.from_numpy(enc_t),
            torch.from_numpy(state), torch.from_numpy(pc), torch.float32)
        # The model's entry (gather at each beam's t, then the step).
        h_mod, ns_mod = tm.duration_decode_step(
            torch.from_numpy(enc), torch.from_numpy(t),
            torch.from_numpy(state), torch.from_numpy(pc))
    for got in (h_got, h_mod):
        np.testing.assert_allclose(got.numpy(), np.asarray(h_want),
                                   rtol=0, atol=1e-5)
    for got in (ns_got, ns_mod):
        np.testing.assert_allclose(got.numpy(), np.asarray(ns_want),
                                   rtol=0, atol=1e-5)


def test_synthesize_matches_flax(setup):
    cfg, model, params, toks, tm = setup
    rng = np.random.default_rng(3)
    enc = model.apply(params, jnp.asarray(toks), jnp.asarray(IL, jnp.int32),
                      method=model.encode)
    src = rng.integers(-1, T + 1, (B, U)).astype(np.int32)  # clipped
    want = np.asarray(model.apply(params, enc, jnp.asarray(src),
                                  method=model.synthesize_from_alignment))
    with torch.no_grad():
        got = tm.synthesize_from_alignment(
            torch.from_numpy(np.array(enc)), torch.from_numpy(src))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
