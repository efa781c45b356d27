"""PyTorch port, the training loop: train_loop.run_training on synthetic
batches and from .npz shards, checkpoints and resume, a JAX checkpoint
carried across, and two ranks resuming over a mesh, held against the JAX
package's run_training on JAX's initial parameters (tiny_model_config,
float32, JAX on the CPU over a 1x1 mesh).

Tolerances: logged losses rtol 1e-5 (test_torch_train's three-step
tolerance); padding efficiencies exactly (the same shards, buckets and
shuffle); parameters after five steps within
test_torch_train._assert_dicts_close's bounds (5e-5 of each leaf's largest
entry plus 1e-6). The attention key bias, whose gradient is rounding noise
(0 in exact arithmetic), is held to 1e-3: Adam (eps 1e-8) turns noise of
~1e-9 into steps of up to ~lr/10 in no particular direction, and four of
the five steps have lr near 1e-3 (test_torch_train holds it to 1e-4
after three steps, two of them at lr > 0). Across eight (shard seed, run
seed) pairs of the resume fixtures ((3, 0), as here, and (0, 0), (1, 1),
(2, 2), (4, 3), (5, 4), (6, 5), (7, 6)), the leaf moved at most 2.1e-4
from its initial value in either package, and the two ended at most
3.1e-4 apart (at (3, 0); the median 1.1e-4); every other leaf stayed
within 0.53 of its bound. `PYTHONPATH=. JAX_PLATFORMS=cpu python
tests/test_torch_train_loop.py` reruns that sweep (_key_bias_sweep).
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import ssnt_tts_tpu.data as jdata
from ssnt_tts_tpu import data_files as jfiles
from ssnt_tts_tpu import train_loop as jloop
from ssnt_tts_tpu.models import SSNTModel as JaxModel
from ssnt_tts_tpu.parallel import train as jtrain
from ssnt_tts_tpu.utils import checkpoint as jckpt
from ssnt_tts_tpu.utils import config as jcfg
from ssnt_tts_tpu_torch import convert, dryrun
from ssnt_tts_tpu_torch import data as tdata
from ssnt_tts_tpu_torch import data_files as tfiles
from ssnt_tts_tpu_torch import train_loop
from ssnt_tts_tpu_torch.parallel import train as ttrain
from ssnt_tts_tpu_torch.utils import checkpoint as tckpt
from ssnt_tts_tpu_torch.utils import config as tcfg
from test_torch_train import KEY_BIAS, _assert_dicts_close

B, T, U = 4, 12, 40
LOSS_RTOL = 1e-5
LOSS_KEYS = ("loss", "nll_per_frame", "duration_nll", "tone_nll")
KEY_BIAS_ATOL = 1e-3


def _cfgs():
    cfg = jcfg.tiny_model_config()
    train_cfg = jcfg.TrainConfig(warmup_steps=2, batch_size=B,
                                 max_input_length=T, max_output_length=U)
    return cfg, train_cfg


def _port(c):
    """The port's copy of a JAX config object."""
    return getattr(tcfg, type(c).__name__)(**dataclasses.asdict(c))


def _jax_init(first):
    """JAX run_training's initial TrainState (PRNGKey(0) on `first`)."""
    cfg, train_cfg = _cfgs()
    return jax.device_get(jtrain.init_train_state(
        JaxModel(cfg), jax.random.PRNGKey(0), first, train_cfg))


def _rows(path):
    return [json.loads(x) for x in path.read_text().splitlines()]


def _assert_rows_match(got, want):
    assert [r["step"] for r in got] == [r["step"] for r in want]
    for g, w in zip(got, want):
        for k in LOSS_KEYS:
            np.testing.assert_allclose(g[k], w[k], rtol=LOSS_RTOL,
                                       err_msg=f"step {w['step']} {k}")
        for k in ("token_padding_efficiency", "frame_padding_efficiency"):
            assert (k in g) == (k in w)
            if k in w:
                assert g[k] == w[k], (w["step"], k, g[k], w[k])


def _assert_params_match(got, want_tree):
    cfg, _ = _cfgs()
    want = convert.flax_to_torch(want_tree, cfg)
    got = {k: v.detach().clone() for k, v in got.items()}
    np.testing.assert_allclose(got.pop(KEY_BIAS).numpy(),
                               want.pop(KEY_BIAS).numpy(),
                               atol=KEY_BIAS_ATOL)
    _assert_dicts_close(got, want)


@pytest.fixture(scope="module")
def shard_dir(tmp_path_factory):
    """tests/test_data_files.py's shards, written by the JAX package."""
    d = tmp_path_factory.mktemp("shards")
    ds = jdata.SyntheticTTSDataset(
        vocab_size=32, mel_dim=8, max_input_length=T, max_output_length=U,
        duration_class_size=5, tone_class_size=4, seed=3)
    jfiles.materialize_synthetic(ds, num_examples=57, out_dir=str(d),
                                 shard_size=16, batch_size=8)
    return str(d)


@pytest.fixture(scope="module")
def jax_files(shard_dir, tmp_path_factory):
    """JAX's run_training from the shards: 3 steps with a checkpoint, then
    resumed to 5; metrics logged every step."""
    d = tmp_path_factory.mktemp("jax_files")
    cfg, train_cfg = _cfgs()
    kw = dict(model_config=cfg, train_config=train_cfg,
              mesh_config=jcfg.MeshConfig(1, 1), data_dir=shard_dir,
              checkpoint_dir=str(d / "ckpt"), checkpoint_every=3,
              log_every=1)
    jloop.run_training(3, metrics_path=str(d / "a.jsonl"), **kw)
    jloop.run_training(5, metrics_path=str(d / "b.jsonl"), **kw)
    first = next(jfiles.NpzShardDataset(shard_dir).batches(
        B, shuffle_seed=0))
    init = _jax_init(first)
    return {"dir": d, "ckpt": str(d / "ckpt"), "init": init,
            "a": _rows(d / "a.jsonl"), "b": _rows(d / "b.jsonl")}


@pytest.fixture(scope="module")
def port_files(shard_dir, jax_files, tmp_path_factory):
    """The port's run_training from JAX's initial parameters on the same
    shards, the same way."""
    torch.set_num_threads(1)
    d = tmp_path_factory.mktemp("port_files")
    cfg, train_cfg = _cfgs()
    kw = dict(model_config=_port(cfg), train_config=_port(train_cfg),
              device="cpu", data_dir=shard_dir,
              params=jax_files["init"].params,
              checkpoint_dir=str(d / "ckpt"), checkpoint_every=3,
              log_every=1)
    train_loop.run_training(3, metrics_path=str(d / "a.jsonl"), **kw)
    assert tckpt.latest_step(str(d / "ckpt")) == 3
    train_loop.run_training(5, metrics_path=str(d / "b.jsonl"), **kw)
    return {"ckpt": str(d / "ckpt"), "a": _rows(d / "a.jsonl"),
            "b": _rows(d / "b.jsonl")}


def _restored_port(directory, step=None):
    cfg, train_cfg = _cfgs()
    like = ttrain.init_train_state(_port(cfg), _port(train_cfg),
                                   device="cpu")
    return tckpt.restore(directory, like, step)


def test_run_training_matches_jax(tmp_path):
    """Synthetic batches: JAX draws the generator's first batch to
    initialize and trains from the second on; the port draws and discards
    it, so every step sees JAX's batch."""
    torch.set_num_threads(1)
    cfg, train_cfg = _cfgs()
    jloop.run_training(3, cfg, train_cfg, mesh_config=jcfg.MeshConfig(1, 1),
                       log_every=1, seed=0,
                       metrics_path=str(tmp_path / "jax.jsonl"))
    first = jdata.SyntheticTTSDataset(
        vocab_size=cfg.vocab_size, mel_dim=cfg.mel_dim, max_input_length=T,
        max_output_length=U, duration_class_size=cfg.duration_class_size,
        tone_class_size=cfg.tone_class_size, seed=0).batch(B)
    first.pop("alignment")
    train_loop.run_training(3, _port(cfg), _port(train_cfg), seed=0,
                            device="cpu", log_every=1,
                            params=_jax_init(first).params,
                            metrics_path=str(tmp_path / "port.jsonl"))
    _assert_rows_match(_rows(tmp_path / "port.jsonl"),
                       _rows(tmp_path / "jax.jsonl"))


def test_run_training_from_files_matches_jax(jax_files, port_files):
    """Three steps from JAX-written shards: losses, and the padding
    efficiencies exactly, the initialization batch JAX pads included."""
    _assert_rows_match(port_files["a"], jax_files["a"])


def test_resume_matches_jax(jax_files, port_files):
    """Resumed at step 3 on a fresh data stream (steps 4-5 see the first
    two batches again, in JAX as here): the metrics and the step-5
    parameters."""
    _assert_rows_match(port_files["b"], jax_files["b"])
    cfg, train_cfg = _cfgs()
    want = jckpt.restore(jax_files["ckpt"], jax_files["init"], step=5)
    got = _restored_port(port_files["ckpt"])
    assert got.step == 5 and got.opt_state.count == 5
    _assert_params_match(got.model.state_dict(), want.params)


def test_jax_checkpoint_carries_across(jax_files, shard_dir, tmp_path):
    """JAX's step-3 orbax checkpoint, converted (flax_train_state_to_torch)
    and saved as the port's, resumed by the port to step 5: its parameters
    against JAX's step-5 checkpoint."""
    torch.set_num_threads(1)
    cfg, train_cfg = _cfgs()
    j3 = jax.device_get(jckpt.restore(jax_files["ckpt"], jax_files["init"],
                                      step=3))
    state = convert.flax_train_state_to_torch(j3, _port(cfg),
                                              _port(train_cfg), device="cpu")
    adam = convert._adam_state(j3.opt_state)
    assert state.step == 3 and state.opt_state.count == int(adam.count) == 3
    names = [n for n, _ in state.model.named_parameters()]
    for got, tree in ((state.opt_state.mu, adam.mu),
                      (state.opt_state.nu, adam.nu)):
        want = convert.flax_to_torch(tree, cfg)
        assert len(got) == len(names)
        for n, g in zip(names, got):
            assert torch.equal(g, want[n]), n
    params = convert.flax_to_torch(j3.params, cfg)
    for n, p in state.model.named_parameters():
        assert torch.equal(p.detach(), params[n]), n

    ckpt = str(tmp_path / "ckpt")
    tckpt.save(ckpt, 3, state)
    train_loop.run_training(5, _port(cfg), _port(train_cfg), device="cpu",
                            data_dir=shard_dir, checkpoint_dir=ckpt)
    want = jckpt.restore(jax_files["ckpt"], jax_files["init"], step=5)
    got = _restored_port(ckpt)
    assert got.step == 5 and got.opt_state.count == 5
    _assert_params_match(got.model.state_dict(), want.params)


def test_padding_stats_count_the_init_batch(shard_dir, monkeypatch):
    """run_training pads one batch of a second stream before training, as
    JAX does to initialize, and its logged efficiencies count it. Pinned
    with a prefetch that stages nothing ahead: after two steps the stats
    hold that batch (equal to the stream's first) and the two trained."""
    torch.set_num_threads(1)
    monkeypatch.setattr(
        train_loop.data_lib, "prefetch_to_device",
        lambda it, device=None: ({k: torch.from_numpy(v) for k, v in
                                  b.items()} for b in it))
    cfg, train_cfg = _cfgs()
    last = train_loop.run_training(2, _port(cfg), _port(train_cfg),
                                   device="cpu", data_dir=shard_dir)
    ds = tfiles.NpzShardDataset(shard_dir)
    it = ds.batches(B, shuffle_seed=0)
    b1, b2 = next(it), next(it)
    want = tfiles.PaddingStats()
    without = tfiles.PaddingStats()
    for b in (b1, b1, b2):
        want.update(b)
    for b in (b1, b2):
        without.update(b)
    assert last["token_padding_efficiency"] == want.token_efficiency
    assert last["frame_padding_efficiency"] == want.frame_efficiency
    assert (without.token_efficiency, without.frame_efficiency) != (
        want.token_efficiency, want.frame_efficiency)


def test_checkpoint_save_restore_and_prune(tmp_path):
    """Step-numbered directories written by rename, pruned to max_to_keep;
    restore of a TrainState (bit for bit, onto state_like's device) and of
    a nest of tensors; FileNotFoundError without a checkpoint."""
    torch.set_num_threads(1)
    cfg, train_cfg = _cfgs()
    d = str(tmp_path / "ckpt")
    assert tckpt.latest_step(d) is None
    like = ttrain.init_train_state(_port(cfg), _port(train_cfg), seed=1,
                                   device="cpu")
    with pytest.raises(FileNotFoundError):
        tckpt.restore(d, like)
    state = ttrain.init_train_state(_port(cfg), _port(train_cfg), seed=0,
                                    device="cpu")
    tx = ttrain.make_optimizer(_port(train_cfg))
    batch = tdata.SyntheticTTSDataset(
        vocab_size=cfg.vocab_size, mel_dim=cfg.mel_dim, max_input_length=T,
        max_output_length=U, duration_class_size=cfg.duration_class_size,
        tone_class_size=cfg.tone_class_size).batch(B)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()
             if k != "alignment"}
    for step in range(1, 6):
        state, _ = ttrain.train_step(tx, state, batch)
        tckpt.save(d, step, state, max_to_keep=3)
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "3", "4", "5"]
    assert tckpt.latest_step(d) == 5
    got = tckpt.restore(d, like)
    assert got.step == 5 and got.opt_state.count == 5
    for a, b in zip(got.model.parameters(), state.model.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(got.opt_state.mu + got.opt_state.nu,
                    state.opt_state.mu + state.opt_state.nu):
        assert torch.equal(a, b)
    assert tckpt.restore(d, like, step=3).step == 3
    with pytest.raises(FileNotFoundError):
        tckpt.restore(d, like, step=1)

    carry = {"lp": torch.randn(2, 3), "t": [torch.arange(3),
                                            torch.zeros(2, dtype=torch.bool)]}
    tckpt.save(str(tmp_path / "carry"), 7, carry)
    back = tckpt.restore(str(tmp_path / "carry"),
                         {"lp": torch.zeros(2, 3),
                          "t": [torch.zeros(3, dtype=torch.int64),
                                torch.ones(2, dtype=torch.bool)]})
    assert torch.equal(back["lp"], carry["lp"])
    assert all(torch.equal(a, b) for a, b in zip(back["t"], carry["t"]))
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore(str(tmp_path / "carry"),
                      {"lp": torch.zeros(3, 3), "t": carry["t"]})


def _flat_state(state) -> dict:
    flat = lambda ts: torch.cat([t.detach().reshape(-1) for t in ts]
                                ).cpu().numpy()
    opt = state.opt_state
    return {"step": state.step, "count": opt.count,
            "params": flat(state.model.parameters()), "mu": flat(opt.mu),
            "nu": flat(opt.nu)}


def _resume_rank(job, device) -> dict:
    """One rank of test_two_ranks_resume_from_one_writer (run by
    dryrun.launch): run_training over the mesh with checkpoint_dir, once
    per entry of job["runs"], recording the steps this rank saved, the
    state each restore gave it (_flat_state) and the last run's
    metrics."""
    from unittest import mock

    saves, restored = [], []
    save, restore = tckpt.save, tckpt.restore

    def recorded_save(directory, step, state, *a, **k):
        saves.append(step)
        return save(directory, step, state, *a, **k)

    def recorded_restore(*a, **k):
        state = restore(*a, **k)
        restored.append(_flat_state(state))
        return state

    with mock.patch.object(tckpt, "save", recorded_save), \
            mock.patch.object(tckpt, "restore", recorded_restore):
        for n in job["runs"]:
            last = train_loop.run_training(
                n, job["cfg"], job["tcfg"], seed=job["seed"], device=device,
                log_every=1, mesh_config=tcfg.MeshConfig(*job["mesh"]),
                checkpoint_dir=job["checkpoint_dir"])
    return {"saves": saves, "restored": restored, "metrics": last}


def test_two_ranks_resume_from_one_writer(tmp_path):
    """run_training(checkpoint_dir=, mesh_config=MeshConfig(2, 1)) on two
    gloo ranks: 3 steps, then resumed to 5. Only rank 0 saves; both ranks
    restore the same state, which equals the checkpoint on disk."""
    cfg, train_cfg = _cfgs()
    ckpt = tmp_path / "ckpt"
    job = {"mesh": (2, 1), "cfg": _port(cfg), "tcfg": _port(train_cfg),
           "seed": 0, "checkpoint_dir": str(ckpt), "runs": [3, 5]}
    ranks = dryrun.launch(_resume_rank, job, 2, tmp_path / "job",
                          device="cpu", timeout=300)
    assert ranks[0]["saves"] == [3, 5] and ranks[1]["saves"] == []
    assert tckpt.latest_step(str(ckpt)) == 5
    r0, r1 = ranks[0]["restored"], ranks[1]["restored"]
    assert len(r0) == len(r1) == 1
    assert r0[0]["step"] == r1[0]["step"] == 3
    for k in ("params", "mu", "nu"):
        np.testing.assert_array_equal(r0[0][k], r1[0][k], err_msg=k)
    disk = _restored_port(str(ckpt), step=3)
    np.testing.assert_array_equal(
        r0[0]["params"], torch.cat([p.detach().reshape(-1) for p in
                                    disk.model.parameters()]).numpy())
    for k in LOSS_KEYS:
        assert ranks[0]["metrics"][k] == ranks[1]["metrics"][k]


def _key_bias_sweep(pairs=((3, 0), (0, 0), (1, 1), (2, 2), (4, 3), (5, 4),
                           (6, 5), (7, 6))):
    """The resume fixtures' runs (3 steps, resumed to 5, both packages from
    JAX's init) at each (shard seed, run seed); prints the key-bias gap,
    each package's move of that leaf from its initial value, and the
    worst other leaf as a share of its bound."""
    import tempfile

    cfg, train_cfg = _cfgs()
    for shard_seed, seed in pairs:
        d = tempfile.mkdtemp()
        ds = jdata.SyntheticTTSDataset(
            vocab_size=32, mel_dim=8, max_input_length=T,
            max_output_length=U, duration_class_size=5, tone_class_size=4,
            seed=shard_seed)
        jfiles.materialize_synthetic(ds, num_examples=57, out_dir=d + "/s",
                                     shard_size=16, batch_size=8)
        kw = dict(data_dir=d + "/s", checkpoint_every=3, log_every=1,
                  seed=seed, metrics_path=d + "/m.jsonl")
        for n in (3, 5):
            jloop.run_training(n, cfg, train_cfg,
                               mesh_config=jcfg.MeshConfig(1, 1),
                               checkpoint_dir=d + "/j", **kw)
        first = next(jfiles.NpzShardDataset(d + "/s").batches(
            B, shuffle_seed=seed))
        init = jax.device_get(jtrain.init_train_state(
            JaxModel(cfg), jax.random.PRNGKey(seed), first, train_cfg))
        for n in (3, 5):
            train_loop.run_training(n, _port(cfg), _port(train_cfg),
                                    device="cpu", params=init.params,
                                    checkpoint_dir=d + "/p", **kw)
        want = convert.flax_to_torch(
            jckpt.restore(d + "/j", init, step=5).params, cfg)
        got = _restored_port(d + "/p").model.state_dict()
        i0 = convert.flax_to_torch(init.params, cfg)
        gap = lambda a, b: float((a - b).abs().max())
        share = max(gap(got[k], w) / (5e-5 * float(w.abs().max()) + 1e-6)
                    for k, w in want.items() if k != KEY_BIAS)
        print(json.dumps({
            "shard_seed": shard_seed, "seed": seed,
            "key_bias_gap": gap(got[KEY_BIAS], want[KEY_BIAS]),
            "jax_moved": gap(want[KEY_BIAS], i0[KEY_BIAS]),
            "port_moved": gap(got[KEY_BIAS], i0[KEY_BIAS]),
            "other_worst_share": share}), flush=True)


if __name__ == "__main__":
    torch.set_num_threads(2)
    _key_bias_sweep()
