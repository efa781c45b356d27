"""Weights carried across: the flax parameter tree -> the port's state dict.

`flax_to_torch(params, cfg)` takes the tree as nested dicts of numpy arrays
(what `jax.device_get(params)` gives; the top-level "params" collection may
be present or not) and returns a state dict for models.ssnt.SSNTModel. It
maps every leaf, and raises on a missing or unknown one. Every transform
in the mapping is linear, so a JAX gradient tree carries across the same
way (the tests compare gradients leaf by leaf through it).

`flax_train_state_to_torch(state, model_config, train_config, device)`
carries a whole JAX TrainState across (an orbax-restored checkpoint, say):
the step, the parameters, and optax's Adam moments mu and nu (through the
same mapping, in model.parameters() order) with their count.

`random_flax_tree(cfg, seed)` makes a numpy tree with exactly the flax
layout, from a seed: Dense/Conv/attention kernels ~ N(0, 1/fan_in),
embeddings ~ N(0, 1/features), zero biases, LayerNorm scale 1. It lets a
machine without JAX build a full-width model through the same converter.

Layout facts (flax 0.12):
  - Dense.kernel is (in, out), the transpose of a Linear weight;
  - Conv.kernel is (k, in, out) -> Conv1d weight (out, in, k);
  - attention query/key/value kernels are (dim, heads, head_dim) with
    (heads, head_dim) biases; out is (heads, head_dim, dim);
  - GRUCell has ir/iz/in with biases, hr/hz without, hn with one; they
    pack into stepmath's [r|z|n] (in, 3H) kernels.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ssnt_tts_tpu_torch.utils.config import ModelConfig

_GRU_IN = ("ir", "iz", "in")
_GRU_H = ("hr", "hz", "hn")


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, path + "/"))
        else:
            out[path] = np.asarray(v, np.float32)
    return out


def _mapping(cfg: ModelConfig):
    """Yields (state-dict key, flax leaf paths, numpy transform)."""
    ident = lambda a: a
    T = lambda a: a.T

    def dense(dst, src):
        yield f"{dst}.weight", [f"{src}/kernel"], T
        yield f"{dst}.bias", [f"{src}/bias"], ident

    def norm(dst, src):
        yield f"{dst}.weight", [f"{src}/scale"], ident
        yield f"{dst}.bias", [f"{src}/bias"], ident

    def gru(dst, src):
        cat = lambda *a: np.concatenate(a, axis=-1)
        yield f"{dst}.wi", [f"{src}/{g}/kernel" for g in _GRU_IN], cat
        yield f"{dst}.bi", [f"{src}/{g}/bias" for g in _GRU_IN], cat
        yield f"{dst}.wh", [f"{src}/{g}/kernel" for g in _GRU_H], cat
        yield f"{dst}.bhn", [f"{src}/hn/bias"], ident

    def class_head(dst, src):
        yield from dense(f"{dst}.h1", f"{src}/h1")
        yield from dense(f"{dst}.out", f"{src}/out")

    def ar_class(dst, src):
        yield f"{dst}.embed", [f"{src}/embed/embedding"], ident
        yield from dense(f"{dst}.enc_in", f"{src}/enc_in")
        yield from gru(f"{dst}.cell", f"{src}/cell")
        yield from dense(f"{dst}.out", f"{src}/out")

    e = "encoder"
    yield "encoder.embed", [f"{e}/Embed_0/embedding"], ident
    for i in range(3):
        src = f"{e}/ConvPrenet_0"
        yield (f"encoder.prenet.convs.{i}.weight", [f"{src}/Conv_{i}/kernel"],
               lambda a: a.transpose(2, 1, 0))
        yield (f"encoder.prenet.convs.{i}.bias", [f"{src}/Conv_{i}/bias"],
               ident)
        yield from norm(f"encoder.prenet.norms.{i}", f"{src}/LayerNorm_{i}")
    for layer in range(cfg.encoder_layers):
        src, dst = f"{e}/TransformerBlock_{layer}", f"encoder.blocks.{layer}"
        att = f"{src}/MultiHeadDotProductAttention_0"
        yield from norm(f"{dst}.norm1", f"{src}/LayerNorm_0")
        yield from norm(f"{dst}.norm2", f"{src}/LayerNorm_1")
        for name in ("query", "key", "value"):
            yield (f"{dst}.attn.{name}.weight", [f"{att}/{name}/kernel"],
                   lambda a: a.reshape(a.shape[0], -1).T)
            yield (f"{dst}.attn.{name}.bias", [f"{att}/{name}/bias"],
                   lambda a: a.reshape(-1))
        yield (f"{dst}.attn.out.weight", [f"{att}/out/kernel"],
               lambda a: a.reshape(-1, a.shape[-1]).T)
        yield f"{dst}.attn.out.bias", [f"{att}/out/bias"], ident
        yield from dense(f"{dst}.ff.fc1", f"{src}/FeedForward_0/Dense_0")
        yield from dense(f"{dst}.ff.fc2", f"{src}/FeedForward_0/Dense_1")
    yield from norm("encoder.norm", f"{e}/LayerNorm_0")
    yield from dense("ar_cell.prenet.fc1", "ar_cell/prenet/Dense_0")
    yield from dense("ar_cell.prenet.fc2", "ar_cell/prenet/Dense_1")
    yield from gru("ar_cell.cell", "ar_cell/cell")
    for name in ("enc_proj", "dec_pre", "dec_proj", "enc_bias", "dec_bias"):
        yield from dense(f"transition.{name}", f"transition/{name}")
    yield from dense("frame.enc_mel", "frame/enc_mel")
    yield from dense("frame.dec_mel", "frame/dec_mel")
    yield "frame.log_sigma", ["frame/log_sigma"], ident
    for kind in ("duration", "tone"):
        yield from class_head(f"{kind}_head", f"{kind}_head")
        yield from ar_class(f"{kind}_ar", f"{kind}_ar")


def flax_to_torch(params, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Flax tree (nested dicts of numpy arrays) -> SSNTModel state dict
    (float32 CPU tensors). Raises KeyError on a missing or unknown leaf."""
    if set(params) == {"params"}:
        params = params["params"]
    flat = _flatten(params)
    state, used = {}, set()
    for key, paths, fn in _mapping(cfg):
        missing = [p for p in paths if p not in flat]
        if missing:
            raise KeyError(f"flax tree lacks leaves {missing} for {key}")
        used.update(paths)
        arr = fn(*(flat[p] for p in paths))
        state[key] = torch.tensor(np.asarray(arr, np.float32))
    unknown = [p for p in flat if p not in used]
    if unknown:
        raise KeyError(f"unknown flax leaves: {unknown}")
    return state


def _adam_state(opt_state):
    """optax's ScaleByAdamState (count, mu, nu) inside a chain's state."""
    if all(hasattr(opt_state, k) for k in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for sub in opt_state:
            found = _adam_state(sub)
            if found is not None:
                return found
    return None


def flax_train_state_to_torch(state, model_config: ModelConfig,
                              train_config, device=None):
    """A JAX parallel/train.TrainState with numpy leaves (step, params, the
    optax chain's state) -> the port's parallel/train.TrainState on
    `device` (the card unless it names another): the parameters and Adam's
    mu and nu through flax_to_torch, mu and nu in model.parameters()
    order, Adam's count as OptState.count."""
    from ssnt_tts_tpu_torch.parallel import train as train_lib

    adam = _adam_state(state.opt_state)
    if adam is None:
        raise KeyError("opt_state holds no Adam state (count, mu, nu)")
    new = train_lib.init_train_state(model_config, train_config,
                                     params=state.params, device=device)
    names = [n for n, _ in new.model.named_parameters()]
    dev = next(new.model.parameters()).device
    moments = []
    for tree in (adam.mu, adam.nu):
        sd = flax_to_torch(tree, model_config)
        moments.append([sd[n].to(dev) for n in names])
    new.step = int(np.asarray(state.step))
    new.opt_state = train_lib.OptState(count=int(np.asarray(adam.count)),
                                       mu=moments[0], nu=moments[1])
    return new


def random_flax_tree(cfg: ModelConfig, seed: int) -> dict:
    """A seeded numpy tree with the flax SSNTModel layout
    ({"params": {...}}), for building a model without JAX."""
    rng = np.random.default_rng(seed)
    return _flax_tree(cfg, lambda shape, fan_in: rng.normal(
        0.0, fan_in ** -0.5, shape).astype(np.float32))


def flax_leaf_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """Every leaf's shape in the flax layout, by its "/"-joined path
    (without the "params" collection), without drawing the weights."""
    zero = np.float32(0)
    tree = _flax_tree(cfg, lambda shape, fan_in: np.broadcast_to(zero,
                                                                  shape))
    return {k: v.shape for k, v in _flatten(tree["params"]).items()}


def _flax_tree(cfg: ModelConfig, draw) -> dict:
    """The flax SSNTModel layout, its kernels and embeddings from
    draw(shape, fan_in), zero biases and unit LayerNorm scales."""
    f32 = np.float32

    def kernel(*shape, fan_in):
        return draw(shape, fan_in)

    def dense(i, o):
        return {"kernel": kernel(i, o, fan_in=i), "bias": np.zeros(o, f32)}

    def norm(d):
        return {"scale": np.ones(d, f32), "bias": np.zeros(d, f32)}

    def gru(i, h):
        g = {n: dense(i, h) for n in _GRU_IN}
        g.update({n: {"kernel": kernel(h, h, fan_in=h)} for n in _GRU_H})
        g["hn"]["bias"] = np.zeros(h, f32)
        return g

    def embed(n, d):
        return {"embedding": kernel(n, d, fan_in=d)}

    He, H, M, R = (cfg.encoder_dim, cfg.decoder_dim, cfg.mel_dim,
                   cfg.joint_rank)
    nh = cfg.encoder_heads
    hd = He // nh
    enc = {"Embed_0": embed(cfg.vocab_size, He), "LayerNorm_0": norm(He)}
    pre = {}
    for i in range(3):
        pre[f"Conv_{i}"] = {"kernel": kernel(5, He, He, fan_in=5 * He),
                            "bias": np.zeros(He, f32)}
        pre[f"LayerNorm_{i}"] = norm(He)
    enc["ConvPrenet_0"] = pre
    for layer in range(cfg.encoder_layers):
        att = {n: {"kernel": kernel(He, nh, hd, fan_in=He),
                   "bias": np.zeros((nh, hd), f32)}
               for n in ("query", "key", "value")}
        att["out"] = {"kernel": kernel(nh, hd, He, fan_in=He),
                      "bias": np.zeros(He, f32)}
        enc[f"TransformerBlock_{layer}"] = {
            "LayerNorm_0": norm(He), "LayerNorm_1": norm(He),
            "MultiHeadDotProductAttention_0": att,
            "FeedForward_0": {"Dense_0": dense(He, 4 * He),
                              "Dense_1": dense(4 * He, He)},
        }
    p = {
        "encoder": enc,
        "ar_cell": {"prenet": {"Dense_0": dense(M, H), "Dense_1": dense(H, H)},
                    "cell": gru(H, H)},
        "transition": {"enc_proj": dense(He, 2 * R), "dec_pre": dense(H, R),
                       "dec_proj": dense(R, 2 * R), "enc_bias": dense(He, 2),
                       "dec_bias": dense(H, 2)},
        "frame": {"enc_mel": dense(He, M), "dec_mel": dense(H, M),
                  "log_sigma": np.zeros((), f32)},
    }
    for kind, D in (("duration", cfg.duration_class_size),
                    ("tone", cfg.tone_class_size)):
        p[f"{kind}_head"] = {"h1": dense(He, He), "out": dense(He, D)}
        p[f"{kind}_ar"] = {"embed": embed(D, H), "enc_in": dense(He, H),
                           "cell": gru(H, H), "out": dense(H, D)}
    return {"params": p}
