"""PyTorch port, beam side: the plain v2 step, selection, backtrace and
upsampling held bit for bit against the JAX package, the numpy oracle and
hand-traced goldens; the fused-step wrapper's CPU dispatch; the kernel
build guard.

The JAX v2 step runs eagerly (jax.disable_jit): compiled XLA on the CPU
contracts the band arithmetic into fused multiply-adds, which the
reference does not (see test_fma_band_edge_follows_oracle)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssnt_tts_tpu.oracle import numpy_oracle as oracle
from ssnt_tts_tpu.ops import backtrace as jbacktrace
from ssnt_tts_tpu.ops import beam_v2 as jbeam_v2
from ssnt_tts_tpu.ops import upsample as jupsample
from ssnt_tts_tpu.utils.config import V2BeamConfig as JaxV2BeamConfig
from ssnt_tts_tpu_torch.models import stepmath
from ssnt_tts_tpu_torch.ops import _build, backtrace, beam_fused, beam_v2
from ssnt_tts_tpu_torch.ops import upsample
from ssnt_tts_tpu_torch.utils.config import V2BeamConfig

FIELDS = ("prediction", "log_prob", "next_t", "next_u", "is_finished",
          "total_duration", "beam_branch", "num_survivors")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _step_inputs(seed, B, W, D):
    """Ragged utterances; beams on or off the diagonal, finished, at the
    last position or past it; dyadic log-probs so ties and exact
    duplicate candidates occur."""
    rng = np.random.default_rng(seed)
    T = rng.integers(3, 10, B)
    U = (T * rng.uniform(1.5, 5.0, B)).astype(np.int64)
    s = rng.integers(0, T + 1)[:, None]  # shared step, as in the decode
    t = np.where(rng.random((B, W)) < 0.8, s,
                 rng.integers(0, T[:, None] + 1, (B, W)))
    diag = np.round(U[:, None] / T[:, None] * t).astype(np.int64)
    tot = np.maximum(diag + rng.integers(-3, 4, (B, W)), 0)
    fin = rng.random((B, W)) < 0.2
    hist = -rng.integers(0, 12, (B, W)) / 4.0
    h = -rng.integers(0, 8, (B, W, D)) / 8.0
    # Exact duplicate beams in some utterances exercise the dedup.
    dup = rng.random(B) < 0.4
    for arr in (t, tot, fin, hist, h):
        arr[dup, 1] = arr[dup, 0]
    # Utterance 0 overruns at t=0: outside test_mode its beam empties.
    t[0], fin[0], U[0] = 0, False, T[0]
    dtab = np.array([0, 1, 2, 3, 5, 7, 4, 6][:D], np.int32)
    return dict(
        h=h.astype(np.float32), lph=hist.astype(np.float32), fin=fin,
        tot=tot.astype(np.int32), dtab=dtab, t=t.astype(np.int32),
        u=(t + rng.integers(0, 3, (B, W))).astype(np.int32),
        il=T.astype(np.int32), ol=U.astype(np.int32))


def _run_torch(x, **kw):
    out = beam_v2.beam_search_decode(
        *(torch.from_numpy(np.asarray(x[k])) for k in
          ("h", "lph", "fin", "tot", "dtab", "t", "u", "il", "ol")), **kw)
    return dict(zip(FIELDS, (o.numpy() for o in out)))


def _run_jax_eager(x, config=None, **kw):
    with jax.disable_jit():
        out = jbeam_v2.beam_search_decode(
            *(jnp.asarray(x[k]) for k in
              ("h", "lph", "fin", "tot", "dtab", "t", "u", "il", "ol")),
            return_num_survivors=True, config=config, **kw)
    return dict(zip(FIELDS, (np.asarray(o) for o in out)))


def _assert_same(got, want):
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        np.testing.assert_array_equal(g, w, err_msg=k)
        if g.dtype.kind == "f":  # bit-exact, including the sign of zero
            np.testing.assert_array_equal(np.signbit(g), np.signbit(w),
                                          err_msg=k)


@pytest.mark.parametrize("W", [4, 8])
@pytest.mark.parametrize("guard", [False, True])
@pytest.mark.parametrize("allow_skip,test_mode", [
    (False, False), (True, False), (False, True), (True, True),
])
def test_v2_step_matches_jax(W, guard, allow_skip, test_mode):
    for seed in range(3):
        x = _step_inputs(seed, B=16, W=W, D=6)
        kw = dict(zero_duration_id=0, allow_skip=allow_skip,
                  test_mode=test_mode)
        got = _run_torch(x, config=V2BeamConfig(final_feasible_guard=guard),
                         **kw)
        want = _run_jax_eager(
            x, config=JaxV2BeamConfig(final_feasible_guard=guard), **kw)
        _assert_same(got, want)


def test_fma_band_edge_follows_oracle():
    """U=400, T=80, t=u=4, total 2: the reference lower band edge is
    25 - 20 = 5, so only class 3 (total 5) survives. A contracted
    multiply-add gives 4.9999997 -> 4 and admits class 2 as well."""
    x = dict(h=np.array([[[-1.0, -0.5, -2.0, -3.0]]], np.float32),
             lph=np.zeros((1, 1), np.float32), fin=np.zeros((1, 1), bool),
             tot=np.array([[2]], np.int32), dtab=np.arange(4, dtype=np.int32),
             t=np.array([[4]], np.int32), u=np.array([[4]], np.int32),
             il=np.array([80], np.int32), ol=np.array([400], np.int32))
    got = _run_torch(x, zero_duration_id=0, allow_skip=False,
                     test_mode=False)
    want = oracle.candidates_to_arrays(oracle.v2_beam_search_kernel(
        x["h"][0], x["lph"][0], x["fin"][0], x["tot"][0], x["dtab"],
        x["t"][0], x["u"][0], 80, 400, 0, False, False, 1),
        with_duration=True)
    assert got["num_survivors"].tolist() == [1]
    for k in want:
        np.testing.assert_array_equal(got[k][0], want[k], err_msg=k)


def test_v2_hand_golden_cases_1_2_3():
    """Hand-traced from src/v2.rs (tests/test_golden_hand.py cases 1-3)."""
    x = dict(
        h=np.array([
            [[-0.25, -0.5, -0.75, -1.0], [-0.125, -0.25, -0.375, -0.5]],
            [[-0.5, -0.5, -0.25, -0.5], [-0.5, -0.125, -0.5, -0.5]],
            [[-9.0, -9.0, -9.0, -9.0], [-2.0, -1.0, -0.5, -0.25]],
        ], np.float32),
        lph=np.array([[-1.0, -1.5], [-2.0, -2.5], [-3.0, -1.0]], np.float32),
        fin=np.array([[False, False], [False, False], [True, False]]),
        tot=np.array([[2, 3], [6, 7], [8, 4]], np.int32),
        dtab=np.arange(4, dtype=np.int32),
        t=np.array([[1, 1], [3, 3], [3, 2]], np.int32),
        u=np.array([[1, 1], [3, 3], [4, 2]], np.int32),
        il=np.array([4, 4, 4], np.int32), ol=np.array([8, 8, 8], np.int32))
    got = _run_torch(x, zero_duration_id=0, allow_skip=False, test_mode=False)
    _assert_same(got, dict(
        prediction=[[1, 1], [2, 1], [2, 2]],
        log_prob=np.array([[-1.5, -1.5], [-2.25, -2.625], [-1.5, -1.5]],
                          np.float32),
        next_t=[[2, 2], [3, 3], [3, 3]], next_u=[[2, 2], [3, 3], [3, 3]],
        is_finished=[[False, False], [True, True], [False, False]],
        total_duration=[[3, 3], [8, 8], [6, 6]],
        beam_branch=[[0, 0], [0, 1], [1, 1]]))


def test_v2_hand_golden_case_4_pad_by_repetition():
    x = dict(
        h=np.array([[[-0.5, -0.5, -0.25, -0.5], [-0.5] * 4, [-0.5] * 4]],
                   np.float32),
        lph=np.array([[-1.0, -0.5, -0.5]], np.float32),
        fin=np.zeros((1, 3), bool), tot=np.array([[6, 1, 2]], np.int32),
        dtab=np.arange(4, dtype=np.int32), t=np.full((1, 3), 3, np.int32),
        u=np.full((1, 3), 3, np.int32), il=np.array([4], np.int32),
        ol=np.array([8], np.int32))
    got = _run_torch(x, zero_duration_id=0, allow_skip=False, test_mode=False)
    _assert_same(got, dict(
        prediction=[[2, 2, 2]], log_prob=np.full((1, 3), -1.25, np.float32),
        next_t=[[3, 3, 3]], next_u=[[3, 3, 3]], is_finished=[[True] * 3],
        total_duration=[[8, 8, 8]], beam_branch=[[0, 0, 0]],
        num_survivors=[1]))


def test_negative_zero_log_prob_tie_order():
    """-0.0 ties +0.0 (IEEE ==) and generation order decides: beam 0 is
    finished with history -0.0 (padding candidate, generation 0); beam 1
    lands a candidate on exactly +0.0 (generation 5)."""
    x = dict(
        h=np.array([[[0.0, 0.0, 0.0, 0.0], [-5.0, 1.5, -5.0, -5.0]]],
                   np.float32),
        lph=np.array([[-0.0, -1.5]], np.float32),
        fin=np.array([[True, False]]), tot=np.array([[20, 8]], np.int32),
        dtab=np.arange(4, dtype=np.int32), t=np.array([[9, 4]], np.int32),
        u=np.array([[20, 8]], np.int32), il=np.array([10], np.int32),
        ol=np.array([20], np.int32))
    assert np.signbit(x["lph"][0, 0])
    kw = dict(zero_duration_id=0, allow_skip=False, test_mode=False)
    got = _run_torch(x, **kw)
    _assert_same(got, _run_jax_eager(x, **kw))
    want = oracle.candidates_to_arrays(oracle.v2_beam_search_kernel(
        x["h"][0], x["lph"][0], x["fin"][0], x["tot"][0], x["dtab"],
        x["t"][0], x["u"][0], 10, 20, 0, False, False, 2),
        with_duration=True)
    for k in want:
        np.testing.assert_array_equal(got[k][0], want[k], err_msg=k)
    assert got["beam_branch"][0].tolist() == [0, 1]
    assert np.signbit(got["log_prob"][0, 0])
    assert not np.signbit(got["log_prob"][0, 1])


def test_order_beam_branch_matches_jax():
    rng = np.random.default_rng(4)
    B, T, W = 5, 11, 6
    branches = rng.integers(0, W, (B, T, W)).astype(np.int32)
    final = rng.integers(0, W, (B, W)).astype(np.int32)
    want = np.asarray(jbacktrace.order_beam_branch(jnp.asarray(final),
                                                   jnp.asarray(branches)))
    got = backtrace.order_beam_branch(torch.from_numpy(final),
                                      torch.from_numpy(branches))
    np.testing.assert_array_equal(got.numpy(), want)


def test_upsample_matches_jax_with_zero_durations():
    rng = np.random.default_rng(5)
    B, W, T = 4, 3, 9
    dur = rng.integers(0, 4, (B, W, T)).astype(np.int32)
    dur[:, :, ::3] = 0  # zero-duration positions are skipped
    out_len = dur.sum(-1).astype(np.int32)
    out_len[0, 0] -= 2  # a shorter output length fills the tail
    max_u = int(out_len.max()) + 3
    want = np.asarray(jupsample.upsample_source_indexes(
        jnp.asarray(dur), jnp.asarray(out_len), -1, max_u=max_u))
    got = upsample.upsample_source_indexes(
        torch.from_numpy(dur), torch.from_numpy(out_len), -1, max_u=max_u)
    np.testing.assert_array_equal(got.numpy(), want)


def test_fused_step_wrapper_runs_plain_step_on_cpu():
    """CPU tensors take the plain version; no kernel launch is counted."""
    rng = np.random.default_rng(6)
    B, W, D, H, T = 3, 4, 5, 16, 6
    g = lambda *s: torch.from_numpy(rng.normal(0, 0.3, s).astype(np.float32))
    fw = beam_fused.FusedWeights(g(D, H), g(H, 3 * H), g(3 * H), g(H, 3 * H),
                                 g(H), g(H, D), g(D))
    i32 = torch.int32
    il = torch.tensor([6, 4, 5], dtype=i32)
    args = (2, g(T, B, H), g(T, B, D), fw,
            torch.from_numpy(rng.integers(0, D, (B, W))).to(i32), g(B, W, H),
            torch.zeros(B, W), torch.zeros(B, W, dtype=torch.bool),
            torch.full((B, W), 4, dtype=i32), torch.full((B, W), 2, dtype=i32),
            torch.full((B, W), 2, dtype=i32), il, il * 3,
            torch.arange(D, dtype=i32), torch.zeros(B, dtype=torch.bool))
    dbg = (torch.empty(B, W, D), torch.empty(B, W, H))
    before = beam_fused.fused_class_beam_step.launches
    got = beam_fused.fused_class_beam_step(*args, debug_out=dbg)
    want = beam_fused.fused_class_beam_step_reference(*args)
    assert beam_fused.fused_class_beam_step.launches == before
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    h, new_h = stepmath.class_step_from_paths(
        *fw, args[1][2][:, None], args[2][2][:, None], args[5], args[4])
    torch.testing.assert_close(dbg[0], h, rtol=0, atol=0)
    torch.testing.assert_close(dbg[1], new_h, rtol=0, atol=0)
    # The state is new_h reordered by parent pointer.
    idx = got.branch.long()[..., None].expand(-1, -1, H)
    torch.testing.assert_close(got.state, torch.gather(new_h, 1, idx))


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path / "none"))
    _build.fused_class_library.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.fused_class_library()
    _build.fused_class_library.cache_clear()
