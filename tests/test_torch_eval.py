"""PyTorch port, the v2 diagnostics arm, the reference-API tone wrapper and
the entry points:

  - beam_v2.beam_search_decode(return_diagnostics=True) and
    parallel/decode.v2_duration_decode(collect_diagnostics=True) on
    tests/test_decode_pipelines.py's feasible and infeasible cases,
    against JAX's, bit for bit (the prune counts, the first emptying step,
    the emptied flags and the beams);
  - ops/tone_latent.beam_search_decode against JAX's, bit for bit with its
    survivors, and its two ValueErrors;
  - python -m ssnt_tts_tpu_torch.scripts.train (--cpu --tiny, resumed) and
    scripts.eval_e2e (--cpu --tiny): JAX's record keys;
  - without a device argument and without a card, every new entry point
    raises, naming device='cpu'.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssnt_tts_tpu.models import SSNTModel as JaxModel
from ssnt_tts_tpu.ops import beam_v2 as jbeam_v2
from ssnt_tts_tpu.ops import tone_latent as jtone
from ssnt_tts_tpu.parallel import decode as jdecode
from ssnt_tts_tpu.parallel import train as jtrain
from ssnt_tts_tpu.utils import config as jcfg
from ssnt_tts_tpu_torch import convert, train_loop
from ssnt_tts_tpu_torch.models.ssnt import SSNTModel
from ssnt_tts_tpu_torch.ops import beam_v2, tone_latent
from ssnt_tts_tpu_torch.parallel import decode
from ssnt_tts_tpu_torch.scripts import eval_e2e
from ssnt_tts_tpu_torch.scripts import train as train_cli
from ssnt_tts_tpu_torch.utils import checkpoint as tckpt
from ssnt_tts_tpu_torch.utils import config as tcfg

REPO = pathlib.Path(__file__).resolve().parent.parent
B, T, U = 2, 6, 20
DUR_TABLE = np.array([0, 1, 2, 3, 4], np.int32)
DIAG_KEYS = ("first_empty_prune_counts", "first_empty_t", "beam_emptied",
             "prediction", "beam_branch", "durations", "is_finished")


@pytest.fixture(scope="module")
def models():
    """tests/test_decode_pipelines.py's model_and_params, and the port's
    model on the same weights."""
    torch.set_num_threads(1)
    cfg = jcfg.tiny_model_config()
    jm = JaxModel(cfg)
    rng = np.random.default_rng(0)
    batch = {
        "tokens": jnp.asarray(rng.integers(1, cfg.vocab_size, (B, T)),
                              jnp.int32),
        "mel": jnp.asarray(rng.normal(0, 1, (B, U, cfg.mel_dim)),
                           jnp.float32),
        "input_length": jnp.asarray([T, T - 2], jnp.int32),
        "output_length": jnp.asarray([U, U - 6], jnp.int32),
    }
    params = jax.device_get(jtrain.init_train_state(
        jm, jax.random.PRNGKey(0), batch,
        jcfg.TrainConfig(warmup_steps=2)).params)
    tm = SSNTModel(tcfg.ModelConfig(**dataclasses.asdict(cfg)), device="cpu")
    tm.load_state_dict(convert.flax_to_torch(params, cfg))
    return jm, params, tm.eval(), batch


@pytest.mark.parametrize("lengths", ["feasible", "infeasible"])
def test_collect_diagnostics_matches_jax(models, lengths):
    jm, params, tm, batch = models
    il = batch["input_length"]
    ol = 3 * il if lengths == "feasible" else jnp.full((B,), 500, jnp.int32)
    want = jax.jit(lambda p, tok, i, o: jdecode.v2_duration_decode(
        jm, p, tok, i, o, DUR_TABLE, beam_width=4, max_frames=512,
        test_mode=False, collect_diagnostics=True))(
        params, batch["tokens"], il, ol)
    toks, il_t, ol_t = (torch.from_numpy(np.array(x))
                        for x in (batch["tokens"], il, ol))
    got = decode.v2_duration_decode(
        tm, toks, il_t, ol_t, DUR_TABLE, beam_width=4, max_frames=512,
        collect_diagnostics=True)
    for k in DIAG_KEYS:
        w = np.asarray(want[k])
        assert got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k].numpy().astype(w.dtype), w,
                                      err_msg=k)
    emptied = got["beam_emptied"].numpy()
    if lengths == "feasible":
        assert not emptied.any()
        assert (got["first_empty_t"].numpy() == -1).all()
    else:
        assert emptied.all()
        counts = got["first_empty_prune_counts"].numpy()
        assert (counts[:, 0] > 0).all()  # the band is binding
    # The same beams as the plain route without diagnostics.
    plain = decode.v2_duration_decode(
        tm, toks, il_t, ol_t, DUR_TABLE, beam_width=4, max_frames=512,
        fuse_model=False, use_pallas=False)
    for k in ("prediction", "beam_branch", "beam_emptied"):
        assert torch.equal(plain[k], got[k]), k
    assert "first_empty_t" not in plain


@pytest.mark.parametrize("seed,test_mode,guard", [
    (0, False, False), (1, False, True), (2, True, False), (3, False, False)])
def test_beam_v2_diagnostics_match_jax(seed, test_mode, guard):
    """One batched step on random state, with every prune in play."""
    rng = np.random.default_rng(seed)
    Bn, W, D, Tn = 6, 4, 5, 9
    h = np.log(rng.dirichlet(np.ones(D), (Bn, W))).astype(np.float32)
    il = rng.integers(2, Tn + 1, Bn).astype(np.int32)
    ol = (il * rng.uniform(0.5, 4.0, Bn)).astype(np.int32)
    t = np.minimum(rng.integers(0, Tn, (Bn, W)), il[:, None]).astype(
        np.int32)
    tot = (t * rng.uniform(0.5, 3.0, (Bn, W))).astype(np.int32)
    args = (h, rng.normal(-3, 1, (Bn, W)).astype(np.float32),
            rng.random((Bn, W)) < 0.2, tot, DUR_TABLE, t, t.copy(), il, ol)
    kw = dict(zero_duration_id=0, allow_skip=bool(seed % 2),
              test_mode=test_mode)
    want = jbeam_v2.beam_search_decode(
        *(jnp.asarray(a) for a in args), return_num_survivors=True,
        return_diagnostics=True,
        config=jcfg.V2BeamConfig(final_feasible_guard=guard), **kw)
    got = beam_v2.beam_search_decode(
        *(torch.from_numpy(np.asarray(a)) for a in args),
        return_diagnostics=True,
        config=tcfg.V2BeamConfig(final_feasible_guard=guard), **kw)
    assert len(got) == len(want) == 9
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        np.testing.assert_array_equal(g.numpy().astype(w.dtype), w,
                                      err_msg=str(i))
    assert np.asarray(want[7]).sum() > 0 or test_mode


def _tone_inputs(seed):
    rng = np.random.default_rng(seed)
    Bn, W, K = 5, 4, 6
    il = rng.integers(1, 8, Bn).astype(np.int32)
    return (np.log(rng.dirichlet(np.ones(K), (Bn, W))).astype(np.float32),
            rng.normal(-2, 1, (Bn, W)).astype(np.float32),
            rng.random((Bn, W)) < 0.3,
            rng.integers(0, 9, (Bn, W)).astype(np.int32),
            rng.integers(0, 9, (Bn, W)).astype(np.int32), il)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("survivors", [False, True])
def test_tone_wrapper_matches_jax(seed, survivors):
    args = _tone_inputs(seed)
    W, K = args[0].shape[1:]
    want = jtone.beam_search_decode(
        *(jnp.asarray(a) for a in args), beam_width=W, tone_class_size=K,
        empty_tone_id=seed, return_num_survivors=survivors)
    got = tone_latent.beam_search_decode(
        *(torch.from_numpy(a) for a in args), beam_width=W,
        tone_class_size=K, empty_tone_id=seed,
        return_num_survivors=survivors)
    assert len(got) == len(want) == (7 if survivors else 6)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        np.testing.assert_array_equal(g.numpy().astype(w.dtype), w,
                                      err_msg=str(i))


def test_tone_wrapper_checks_widths():
    args = [torch.from_numpy(a) for a in _tone_inputs(0)]
    W, K = args[0].shape[1:]
    with pytest.raises(ValueError, match="beam_width"):
        tone_latent.beam_search_decode(*args, beam_width=W + 1)
    with pytest.raises(ValueError, match="tone_class_size"):
        tone_latent.beam_search_decode(*args, tone_class_size=K - 1)
    jargs = [jnp.asarray(np.asarray(a)) for a in args]
    with pytest.raises(ValueError, match="beam_width"):
        jtone.beam_search_decode(*jargs, beam_width=W + 1)


def test_train_cli_resumes(tmp_path):
    """scripts.train in a subprocess: 3 steps with a checkpoint, then
    resumed to 5."""
    ckpt = tmp_path / "ckpt"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for steps in (3, 5):
        metrics = tmp_path / f"m{steps}.jsonl"
        proc = subprocess.run(
            [sys.executable, "-m", "ssnt_tts_tpu_torch.scripts.train",
             "--cpu", "--tiny", "--steps", str(steps), "--batch-size", "4",
             "--input-length", "10", "--output-length", "30", "--ckpt",
             str(ckpt), "--metrics", str(metrics)],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert "final:" in proc.stdout
        rows = [json.loads(x) for x in metrics.read_text().splitlines()]
        assert rows[-1]["step"] == steps
        assert all(np.isfinite(v) for v in rows[-1].values())
        assert tckpt.latest_step(str(ckpt)) == steps


def test_eval_e2e_cpu_record_has_jax_keys(tmp_path):
    """The record carries JAX's keys (EVAL_r05.json, written by
    scripts/eval_e2e.py), less the train-step timing, which JAX's --cpu
    leaves out too."""
    torch.set_num_threads(1)
    out = tmp_path / "eval.json"
    record = eval_e2e.main(["--cpu", "--tiny", "--steps", "4",
                            "--data-dir", str(tmp_path / "shards"),
                            "--out", str(out)])
    want = set(json.loads((REPO / "EVAL_r05.json").read_text()))
    assert set(record) == want - {"train_step_ms", "train_examples_per_s"}
    assert json.loads(out.read_text()) == record
    assert record["padding_stats"]["batches"] == 4
    assert record["corpus_examples"] == 256
    for k, v in record.items():
        if isinstance(v, float):
            assert np.isfinite(v), k


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_new_entry_points_default_to_the_card(tmp_path):
    cfg, tc = tcfg.tiny_model_config(), tcfg.TrainConfig(batch_size=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(["--tiny", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        eval_e2e.main(["--tiny", "--steps", "1", "--data-dir",
                       str(tmp_path / "shards")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_loop.run_training(1, cfg, tc, data_dir=str(tmp_path))
    jstate = jtrain.TrainState(step=0, params=convert.random_flax_tree(
        cfg, 0), opt_state=())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.flax_train_state_to_torch(
            dataclasses.replace(jstate, opt_state=(_Adam(),)), cfg, tc)


@dataclasses.dataclass
class _Adam:
    count: int = 0
    mu: dict = None
    nu: dict = None
