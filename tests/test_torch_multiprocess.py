"""PyTorch port, distribution slice: training in several processes.

Two processes (gloo on the CPU, started by ssnt_tts_tpu_torch.dryrun.launch
with a file rendezvous under pytest's tmp directory, 300 s deadline) go
through the production path, multihost.initialize ->
global_data_mesh -> host_local_batch_to_global -> make_sharded_train_step,
each passing its own rows, and are held to one process of the port and to
JAX's train_step on the same global batch and flax weights: losses rtol
2e-5 and the ranks' parameters equal to 1e-6, as
tests/test_multiprocess.py. Also: train_loop.run_training over a 2x1 mesh
against one process, dryrun.py's __main__ as two separate processes, and
multihost.initialize refusing to fall back when the cluster is broken.
"""

import dataclasses
import logging
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from ssnt_tts_tpu.models import SSNTModel as JaxModel
from ssnt_tts_tpu.parallel import train as jtrain
from ssnt_tts_tpu.utils import config as jcfg
from ssnt_tts_tpu_torch import dryrun
from ssnt_tts_tpu_torch.parallel import multihost
from ssnt_tts_tpu_torch.parallel import train as ttrain
from ssnt_tts_tpu_torch.train_loop import run_training
from ssnt_tts_tpu_torch.utils import config as tcfg

REPO = pathlib.Path(__file__).resolve().parent.parent
PER_HOST, PROCS, T, U = 4, 2, 12, 30
LOSS_RTOL, RANK_RTOL = 2e-5, 1e-6


def _global_batch(cfg):
    """tests/mp_worker.py's global batch."""
    B = PER_HOST * PROCS
    rng = np.random.default_rng(0)
    return {
        "tokens": rng.integers(1, cfg.vocab_size, (B, T)).astype(np.int32),
        "mel": rng.normal(0, 1, (B, U, cfg.mel_dim)).astype(np.float32),
        "input_length": np.full((B,), T, np.int32),
        "output_length": np.full((B,), U, np.int32),
    }


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    cfg = jcfg.tiny_model_config()
    batch = _global_batch(cfg)
    train_cfg = jcfg.TrainConfig(warmup_steps=2, batch_size=len(batch["mel"]))
    jm = JaxModel(cfg)
    state = jtrain.init_train_state(jm, jax.random.PRNGKey(0), batch,
                                    train_cfg)
    params = jax.device_get(state.params)
    tx = jtrain.make_optimizer(train_cfg)
    step = jax.jit(lambda s, b: jtrain.train_step(jm, tx, s, b))
    jax_losses = []
    for _ in range(2):
        state, m = step(state, batch)
        jax_losses.append(float(m["loss"]))
    tc = tcfg.TrainConfig(**dataclasses.asdict(train_cfg))
    pc = tcfg.ModelConfig(**dataclasses.asdict(cfg))
    run = {"cfg": pc, "tcfg": tc, "params": params, "batches": [batch] * 2}
    ranks = dryrun.launch("steps", {"multihost": 1, "runs": [run]}, PROCS,
                          tmp_path_factory.mktemp("mp"), device="cpu",
                          timeout=300)
    torch.set_num_threads(1)
    st = ttrain.init_train_state(pc, tc, params=params, device="cpu")
    ttx = ttrain.make_optimizer(tc)
    one = []
    for _ in range(2):
        st, m = ttrain.train_step(ttx, st, {k: torch.from_numpy(v)
                                            for k, v in batch.items()})
        one.append(float(m["loss"]))
    return ranks, one, jax_losses


def _losses(rank):
    return [s["metrics"]["loss"] for s in rank["runs"][0]["steps"]]


def test_two_processes_form_the_mesh(setup):
    ranks = setup[0]
    assert [(r["rank"], r["data"], r["model"]) for r in ranks] == [
        (0, 0, 0), (1, 1, 0)]


@pytest.mark.parametrize("reference", ["port one process", "jax"])
def test_two_process_training_matches_single_process(setup, reference):
    ranks, one, jax_losses = setup
    want = one if reference == "port one process" else jax_losses
    for r in ranks:
        np.testing.assert_allclose(_losses(r), want, rtol=LOSS_RTOL)


def test_processes_agree(setup):
    """The gradient sum crossed the process boundary: equal losses and
    parameters on both ranks."""
    r0, r1 = setup[0]
    np.testing.assert_allclose(_losses(r0), _losses(r1), rtol=RANK_RTOL)
    for k, v in r0["runs"][0]["params"].items():
        np.testing.assert_allclose(r1["runs"][0]["params"][k], v,
                                   rtol=RANK_RTOL, err_msg=k)


def test_run_training_over_a_mesh(tmp_path):
    """train_loop.run_training(mesh_config=MeshConfig(2, 1)) on two ranks
    (each trains on its rows of the same synthetic batches) against one
    process on the whole batches."""
    cfg = tcfg.tiny_model_config()
    tc = tcfg.TrainConfig(warmup_steps=2, batch_size=4,
                          max_input_length=10, max_output_length=24)
    job = {"mesh": (2, 1), "cfg": cfg, "tcfg": tc, "steps": 2, "seed": 3}
    ranks = dryrun.launch("run_training", job, 2, tmp_path, device="cpu",
                          timeout=300)
    torch.set_num_threads(1)
    want = run_training(2, cfg, tc, seed=3, device="cpu", log_every=1,
                        metrics_path=str(tmp_path / "one.jsonl"))
    for got in ranks:
        assert set(got) == set(want)
        for k in ("loss", "nll_per_frame", "duration_nll", "tone_nll"):
            np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL,
                                       err_msg=k)


def test_dryrun_main_runs_one_rank_per_process(tmp_path):
    """python -m ssnt_tts_tpu_torch.dryrun in two processes, one rank
    each, meeting through a rendezvous file."""
    init = f"file://{tmp_path / 'rendezvous'}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "ssnt_tts_tpu_torch.dryrun", "--init", init,
         "--world", "2", "--rank", str(r), "--device", "cpu"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    assert "step ok" in outs[0] and "v1 beam_decode ok" in outs[0]
    assert "T-sharded lattice ok over 2 shards" in outs[0]
    assert "dryrun:" not in outs[1]  # only the primary prints


def test_initialize_raises_when_cluster_env_is_broken(monkeypatch):
    """A launcher's environment that does not wire a cluster raises, and
    does not fall back to one process."""
    for k in multihost.CLUSTER_ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    with pytest.raises(RuntimeError, match="refusing to fall back"):
        multihost.initialize(backend="gloo")
    assert not torch.distributed.is_initialized()


def test_initialize_raises_when_a_rank_never_comes(tmp_path):
    """Explicit arguments whose rendezvous does not complete (the other
    rank never joins) raise after the timeout."""
    with pytest.raises(RuntimeError, match="refusing to fall back"):
        multihost.initialize(f"file://{tmp_path / 'rendezvous'}", 2, 0,
                             backend="gloo", timeout_s=2)
    assert not torch.distributed.is_initialized()


def test_initialize_without_cluster_runs_single_process(monkeypatch,
                                                         caplog):
    for k in multihost.CLUSTER_ENV:
        monkeypatch.delenv(k, raising=False)
    with caplog.at_level(logging.WARNING):
        multihost.initialize()
    assert "running single-process" in caplog.text
    assert not torch.distributed.is_initialized()
    assert multihost.process_count() == 1 and multihost.is_primary()


def test_weak_scaling_harness_labels_shared_devices(tmp_path):
    """ssnt_tts_tpu_torch.weak_scaling at 1 and 2 ranks on the CPU: the
    ranks share the host, so the classic efficiency is reported as
    contended; partition efficiency is t(1 rank) / t(2 ranks) at the same
    total batch."""
    from ssnt_tts_tpu_torch import weak_scaling

    out = tmp_path / "weak.json"
    rec = weak_scaling.main(["--ranks", "1", "2", "--per-rank-batch", "2",
                             "--steps", "1", "--seq", "6", "12",
                             "--device", "cpu", "--json", str(out)])
    assert [r["ranks"] for r in rec["runs"]] == [1, 2]
    one, two = rec["runs"]
    assert one["weak_scaling_efficiency"] == 1.0
    assert not one["ranks_share_a_device"] and two["ranks_share_a_device"]
    assert "weak_scaling_efficiency" not in two
    assert two["weak_scaling_efficiency_contended"] > 0
    assert two["partition_efficiency"] > 0
    assert out.exists()
