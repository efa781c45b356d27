"""PyTorch port, the utilities held against the JAX package: the
throughput counters, the checked v2 step and upsampling (ops/checks: flags
as JAX's err.get() is not None, outputs bit for bit), the NaN guard and
report (utils/debug), the slope timers (utils/timing) and the profiler
trace (utils/profiling).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssnt_tts_tpu.ops import checks as jchecks
from ssnt_tts_tpu.ops import upsample as jupsample
from ssnt_tts_tpu.utils import config as jcfg
from ssnt_tts_tpu.utils import debug as jdebug
from ssnt_tts_tpu.utils import metrics as jmetrics
from ssnt_tts_tpu_torch import convert
from ssnt_tts_tpu_torch.models.ssnt import SSNTModel
from ssnt_tts_tpu_torch.ops import checks
from ssnt_tts_tpu_torch.utils import config as tcfg
from ssnt_tts_tpu_torch.utils import debug, metrics, profiling, timing


@pytest.mark.parametrize("shape", [(32, 80, 400), (256, 80, 400), (1, 7, 3)])
def test_throughput_counters_equal_jax(shape):
    for seconds in (1e-3, 0.25, 3.0):
        got = metrics.LatticeThroughput(*shape)
        want = jmetrics.LatticeThroughput(*shape)
        assert got.cells == want.cells
        assert got.mcells_per_s(seconds) == want.mcells_per_s(seconds)
        d_got = metrics.DecodeThroughput(shape[0], shape[2])
        d_want = jmetrics.DecodeThroughput(shape[0], shape[2])
        assert d_got.audio_seconds() == d_want.audio_seconds()
        assert d_got.audio_s_per_s(seconds) == d_want.audio_s_per_s(seconds)
    assert metrics.DecodeThroughput(2, 80, 0.01).audio_seconds() == \
        jmetrics.DecodeThroughput(2, 80, 0.01).audio_seconds()


# tests/test_checks_and_multihost.py's v2 cases, and two more: (W, D,
# class prob, duration table, t, T, U, test_mode).
V2_CASES = {
    "empty_beam": (2, 2, 0.5, [1, 2], 0, 1, 100, False),
    "valid_test_mode": (2, 3, 0.3, [0, 1, 2], 0, 5, 0, True),
    "valid_band": (3, 4, 0.25, [0, 1, 2, 3], 0, 4, 6, False),
    "overrun": (2, 3, 0.3, [0, 1, 2], 0, 10, 5, False),
}


@pytest.mark.parametrize("case", list(V2_CASES))
def test_v2_checked_step_flags_as_jax(case):
    W, D, p, dtab, t, T, U, test_mode = V2_CASES[case]
    h = np.log(np.full((W, D), p, np.float32))
    args = (h, np.zeros(W, np.float32), np.zeros(W, bool),
            np.zeros(W, np.int32), np.asarray(dtab, np.int32),
            np.full(W, t, np.int32), np.zeros(W, np.int32))
    kw = dict(zero_duration_id=0, allow_skip=False, test_mode=test_mode)
    jerr, jouts = jchecks.v2_beam_search_step_checked(
        *(jnp.asarray(a) for a in args), T, U, **kw)
    batched = [torch.from_numpy(a[None]) for a in args]
    batched[4] = torch.from_numpy(args[4])  # the duration table
    err, outs = checks.v2_beam_search_step_checked(
        *batched, torch.tensor([T]), torch.tensor([U]), **kw)
    assert (err.get() is not None) == (jerr.get() is not None)
    assert len(outs) == len(jouts) == 7
    for g, w in zip(outs, jouts):
        w = np.asarray(w)
        g = g[0].numpy()
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.astype(w.dtype), w)
    if err.get() is not None:
        with pytest.raises(debug.CheckFailed, match="src/v2.rs:292"):
            err.throw()
    else:
        err.throw()


@pytest.mark.parametrize("lengths", [[[3]], [[4]], [[3], [2]], [[9], [3]]])
def test_upsample_checked_flags_as_jax(lengths):
    dur = np.array([[[2, 1]]] * len(lengths), np.int32)
    ol = np.array(lengths, np.int32)
    jerr, jout = jchecks.upsample_source_indexes_checked(
        jnp.asarray(dur), jnp.asarray(ol), -1, max_u=4)
    err, out = checks.upsample_source_indexes_checked(
        torch.from_numpy(dur), torch.from_numpy(ol), -1, max_u=4)
    assert (err.get() is not None) == (jerr.get() is not None)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    # max_u defaults to the largest output length, as JAX's upsampling
    # does (its checked version needs max_u: checkify traces it).
    jdef = jupsample.upsample_source_indexes(jnp.asarray(dur),
                                             jnp.asarray(ol), -1)
    _, tdef = checks.upsample_source_indexes_checked(
        torch.from_numpy(dur), torch.from_numpy(ol), -1)
    np.testing.assert_array_equal(tdef.numpy(), np.asarray(jdef))


def test_guard_nans_flags_as_jax():
    cases = [(lambda m: (lambda x: m.log(x))), (lambda m: (lambda x: x * 2)),
             (lambda m: (lambda x: {"b": m.sqrt(x), "a": x + 1}))]
    for make in cases:
        for x in ([-1.0, 2.0], [1.0, 4.0]):
            jerr, jout = jdebug.guard_nans(make(jnp), "f")(jnp.asarray(x))
            err, out = debug.guard_nans(make(torch), "f")(torch.tensor(x))
            assert (err.get() is None) == (jerr.get() is None)
            if err.get() is None:
                err.throw()
            else:
                # checkify appends " (`check` failed)".
                assert jerr.get().startswith(err.get())
                with pytest.raises(debug.CheckFailed):
                    err.throw()


def test_tree_nan_report_counts_equal_jax():
    """A flax tree with non-finite entries in leaves that map one to one,
    and in one GRU gate that the converter packs with two others: JAX's
    counts by leaf path, the port's by state_dict name."""
    cfg = jcfg.tiny_model_config()
    tree = convert.random_flax_tree(tcfg.ModelConfig(**cfg.__dict__), 0)
    p = tree["params"]
    p["frame"]["log_sigma"] = np.float32(np.nan)
    p["transition"]["enc_proj"]["kernel"][:3, 1] = np.inf
    p["encoder"]["LayerNorm_0"]["bias"][[0, 5]] = -np.inf
    p["ar_cell"]["cell"]["iz"]["kernel"][0, :4] = np.nan
    want = jdebug.tree_nan_report(tree)
    model = SSNTModel(tcfg.ModelConfig(**cfg.__dict__), device="cpu")
    model.load_state_dict(convert.flax_to_torch(tree, cfg))
    got = debug.tree_nan_report(model)
    assert got == {"frame.log_sigma": 1, "transition.enc_proj.weight": 3,
                   "encoder.norm.bias": 2, "ar_cell.cell.wi": 4}
    assert sorted(got.values()) == sorted(want.values())
    assert debug.tree_nan_report(model.state_dict()) == got
    assert debug.tree_nan_report({"a": [torch.ones(3), torch.tensor(
        [1.0, float("nan")])]}) == {"a.1": 1}


def test_bench_step_and_bench_fn_give_positive_seconds():
    torch.set_num_threads(1)
    x = torch.randn(32, 32)
    s = timing.bench_fn(lambda a: a @ a, x, n_lo=2, n_hi=8, repeats=1)
    assert 0 < s < 1
    state = {"w": torch.zeros(8), "n": [torch.ones(2)]}

    def step(st):
        return {"w": st["w"] + 1, "n": [st["n"][0] * 1.0]}

    assert 0 < timing.bench_step(step, state, n_lo=2, n_hi=8, repeats=1,
                                 target_delta_s=1e-4) < 1
    assert timing._scalarize(state).dtype == torch.float32


def test_trace_writes_annotated_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("ssnt_region_under_test"):
            torch.randn(64, 64).matmul(torch.randn(64, 64)).sum()
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".json")
    text = (tmp_path / files[0]).read_text()
    assert "ssnt_region_under_test" in text
    assert isinstance(json.loads(text), dict)
    assert any(e.key == "ssnt_region_under_test"
               for e in prof.key_averages())
    with profiling.timer() as t:
        pass
    assert t.elapsed >= 0
