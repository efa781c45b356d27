"""PyTorch port, the tools that drive the decode and the package's public
names: scripts/decode_scale (its record's keys, and the decode split over
two gloo CPU ranks bit for bit the one-process decode),
scripts/triage_empty_beam (its record's keys, and its per-checkpoint
reduction of a diagnostics decode equal to the same reduction of JAX's
v2_duration_decode(collect_diagnostics=True) on the same weights and
batch), and the ten names of ssnt_tts_tpu/__init__.py bound to the port's
functions without importing the JAX package. On the CPU."""

import dataclasses
import json
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ssnt_tts_tpu
from ssnt_tts_tpu import data as jdata
from ssnt_tts_tpu.models import SSNTModel as JaxModel
from ssnt_tts_tpu.ops import beam_v1 as jbeam_v1
from ssnt_tts_tpu.parallel import decode as jdecode
from ssnt_tts_tpu.utils import config as jcfg
import ssnt_tts_tpu_torch
from ssnt_tts_tpu_torch import convert
from ssnt_tts_tpu_torch.models.ssnt import SSNTModel
from ssnt_tts_tpu_torch.scripts import decode_scale, triage_empty_beam
from ssnt_tts_tpu_torch.utils import config as tcfg

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _keys(path):
    return json.loads((ROOT / path).read_text())


def test_decode_scale_record_and_ranks(tmp_path):
    """JAX's record keys; B=8 split over 2 gloo CPU ranks bit for bit the
    one-process decode of the same rows (beams rank-local)."""
    torch.set_num_threads(1)  # as the ranks: the same float32 reductions
    got = {}
    rec = decode_scale.main(
        ["--cpu", "--batch", "8", "--small-batch", "4", "--seq", "8", "16",
         "--reps", "1", "--ranks", "2", "--job-dir", str(tmp_path / "job"),
         "--json", str(tmp_path / "scale.json")], outputs=got)
    want = _keys("DECODE_SCALE_r05.json")
    assert list(rec) == list(want)
    assert set(rec["sharding"]) == set(want["sharding"])
    assert json.loads((tmp_path / "scale.json").read_text()) == rec
    run_keys = [set(r) for r in want["runs"]]
    assert all(set(r) in run_keys for r in rec["runs"])
    assert [(r["B"], r["sharded"]) for r in rec["runs"]] == [
        (4, False), (8, False), (8, True)]
    one = got["one"]
    assert set(got["sharded"]) == set(one)
    for k, v in got["sharded"].items():
        np.testing.assert_array_equal(v, one[k].numpy(), err_msg=k)
    assert one["durations"].shape == (8, 8, 8)
    assert [n["fused_class_beam_step"] for n in got["sharded_launches"]] \
        == [0, 0]  # the plain version on the CPU: no launch


def test_triage_record_keys(tmp_path):
    """JAX's record keys, every checkpoint and sweep, beam_x4 at 4x the
    beam (the record of TRIAGE_EMPTYBEAM_r04.json)."""
    out = tmp_path / "triage.json"
    got = {}
    rec = triage_empty_beam.main(
        ["--cpu", "--tiny", "--steps", "2", "4", "--batch", "4",
         "--eval-batch", "6", "--beam", "4", "--out", str(out)],
        outputs=got)
    want = _keys("TRIAGE_EMPTYBEAM_r04.json")
    assert list(rec) == list(want)
    assert json.loads(out.read_text()) == rec
    assert list(rec["checkpoints"]) == ["2", "4"]
    assert list(rec["sweeps_at_final"]) == list(want["sweeps_at_final"])
    ck = next(iter(want["checkpoints"].values()))
    sw = next(iter(want["sweeps_at_final"].values()))
    for e in rec["checkpoints"].values():
        assert list(e) == list(ck)
        assert list(e["rescued_by"]) == list(ck["rescued_by"])
    for e in rec["sweeps_at_final"].values():
        assert list(e) == list(sw)
    assert (rec["eval_batch"], rec["beam"], rec["train_batch"]) == (6, 4, 4)
    assert got["tokens"].shape[0] == 6 and got["max_frames"] == 40


def _jax_entry(jm, params, ev, dtab, beam, U, **kw):
    """JAX's run_decode (scripts/triage_empty_beam.py), written out: its
    diagnostics decode reduced the way its main reduces it."""
    tokens = jnp.asarray(ev["tokens"])
    il = jnp.asarray(ev["input_length"])
    ol = jnp.asarray(ev["output_length"])
    out = jax.jit(lambda p: jdecode.v2_duration_decode(
        jm, p, tokens, il, ol, dtab, beam_width=beam, max_frames=U,
        collect_diagnostics=True, **kw))(params)
    emptied = np.asarray(out["beam_emptied"])
    counts = np.asarray(out["first_empty_prune_counts"])
    ft = np.asarray(out["first_empty_t"])
    mae = float(np.abs(np.asarray(out["output_length"][:, 0])
                       - np.asarray(ol)).mean())
    e = emptied.astype(bool)
    names = ["band", "overrun", "exact_final", "zero_skip"]
    rel = ((ft[e] / np.maximum(np.asarray(il)[e] - 1, 1)).tolist()
           if e.any() else [])
    return {
        "emptied_rate": round(float(e.mean()), 4),
        "n_emptied": int(e.sum()),
        "rescued_by": {n: int((counts[e, i] > 0).sum())
                       for i, n in enumerate(names)},
        "first_empty_t_relative": [round(x, 3) for x in rel],
        "output_length_mae_frames": round(mae, 2),
    }


@pytest.mark.parametrize("beam,sweep", [
    (4, {}), (16, {}), (4, {"allow_skip": True}),
    (4, {"band": (0.2, 0.1)}),
])
def test_triage_entry_matches_jax(beam, sweep):
    """The port's per-checkpoint entry (decode_entry: emptied rate,
    rescued_by, first_empty_t_relative, output-length MAE) equals the same
    reduction of JAX's diagnostics decode, on JAX's weights and JAX's
    eval batch (tiny config, T=16, U=40)."""
    torch.set_num_threads(1)
    cfg = jcfg.tiny_model_config()
    T, U = 16, 40
    ds = jdata.SyntheticTTSDataset(
        vocab_size=cfg.vocab_size, mel_dim=cfg.mel_dim, max_input_length=T,
        max_output_length=U, duration_class_size=cfg.duration_class_size,
        tone_class_size=cfg.tone_class_size, seed=0)
    first = {k: v for k, v in ds.batch(4).items() if k != "alignment"}
    ev = ds.batch(8)
    jm = JaxModel(cfg)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(first["tokens"]),
                     jnp.asarray(first["mel"]),
                     jnp.asarray(first["input_length"]),
                     jnp.asarray(first["output_length"]),
                     jnp.asarray(first["duration_target"]),
                     jnp.asarray(first["tone_target"]), method=jm.loss)
    tm = SSNTModel(tcfg.ModelConfig(**dataclasses.asdict(cfg)), device="cpu")
    tm.load_state_dict(convert.flax_to_torch(jax.device_get(params), cfg))
    tm.eval()
    jkw, tkw = {}, {}
    if "allow_skip" in sweep:
        jkw["allow_skip"] = tkw["allow_skip"] = True
    if "band" in sweep:
        up, lo = sweep["band"]
        jkw["config"] = jcfg.V2BeamConfig(band_upper_frac=up,
                                          band_lower_frac=lo)
        tkw["config"] = tcfg.V2BeamConfig(band_upper_frac=up,
                                          band_lower_frac=lo)
    want = _jax_entry(jm, params, ev,
                      jnp.asarray(cfg.duration_table, jnp.int32), beam, U,
                      **jkw)
    t = lambda k: torch.from_numpy(ev[k])
    with torch.no_grad():
        got = triage_empty_beam.decode_entry(
            tm, t("tokens"), t("input_length"), t("output_length"),
            beam=beam, max_frames=U, **tkw)
    assert got == want
    assert got["n_emptied"] > 0  # the attribution did real work


PUBLIC = ("beam_search_decode", "beam_search_decode_batched",
          "ssnt_tts_v2_beam_search_decode", "tone_latent_beam_search_decode",
          "extract_best_beam_branch", "order_beam_branch",
          "upsample_source_indexes", "levenshtein_edit_distance",
          "ssnt_loss", "ssnt_duration_loss")


def test_public_names_are_the_ports():
    """ssnt_tts_tpu's ten public names, each the port's function (a module
    of ssnt_tts_tpu_torch), and __version__; importing the port's package
    imports neither jax nor ssnt_tts_tpu."""
    assert set(ssnt_tts_tpu.__all__) == set(PUBLIC)
    assert tuple(ssnt_tts_tpu_torch.__all__) == PUBLIC
    assert ssnt_tts_tpu_torch.__version__ == ssnt_tts_tpu.__version__
    for name in PUBLIC:
        fn = getattr(ssnt_tts_tpu_torch, name)
        assert fn.__module__.startswith("ssnt_tts_tpu_torch.ops."), name
        assert fn is getattr(sys.modules[fn.__module__], fn.__name__)
    code = ("import sys, ssnt_tts_tpu_torch as p; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'flax', 'ssnt_tts_tpu.')) or m == 'ssnt_tts_tpu']; "
            "assert not bad, bad; print(len(p.__all__))")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "10"


def test_batched_v1_step_matches_jax():
    """beam_search_decode_batched (JAX's name for the batched v1 step) on
    one batch, against JAX's, at max_beam_width 3."""
    rng = np.random.default_rng(0)
    B, W = 3, 2
    x = dict(h=-rng.integers(0, 8, (B, W, 2)) / 8.0,
             lp=-rng.integers(0, 12, (B, W)) / 4.0,
             fin=rng.random((B, W)) < 0.2,
             t=rng.integers(0, 4, (B, W)), u=rng.integers(0, 4, (B, W)),
             il=np.array([4, 3, 2]))
    x = {k: v.astype(np.float32) if v.dtype == np.float64 else
         (v.astype(np.int32) if v.dtype.kind == "i" else v)
         for k, v in x.items()}
    names = ("h", "lp", "fin", "t", "u", "il")
    got = ssnt_tts_tpu_torch.beam_search_decode_batched(
        *(torch.from_numpy(x[k]) for k in names), max_beam_width=3)
    want = jbeam_v1.beam_search_decode_batched(
        *(jnp.asarray(x[k]) for k in names), max_beam_width=3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
