"""PyTorch port, the v1 emit/shift beam step and the best-path backtrace:
the plain step (ops/beam_v1) held bit for bit against the numpy oracle,
the reference's vectors (tests/test_beam_v1.py) and JAX's batched XLA
step; the beam-only v1 wrappers (ops/beam_kernels, plain on CPU tensors)
against JAX's #10 and #11 kernels, interpreted; extract_best_beam_branch
on the reference's 60x10 golden; the wrappers' guards.

JAX's v1 kernels pick their outputs by one-hot sums, so a selected -0.0
comes back +0.0; the port copies. Log-probs and state rows are compared
by IEEE == against those kernels and bit for bit against everything
else."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ssnt_tts_tpu.ops.beam_pallas as jbeam_pallas
from ssnt_tts_tpu.ops import backtrace as jbacktrace
from ssnt_tts_tpu.ops import beam_v1 as jbeam_v1
from ssnt_tts_tpu.oracle import numpy_oracle as oracle
from ssnt_tts_tpu_torch.ops import _build, backtrace, beam_kernels, beam_v1
from test_backtrace import GOLDEN_EXPECTED, GOLDEN_TABLE

FIELDS = ("prediction", "log_prob", "next_t", "next_u", "is_finished",
          "beam_branch")


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setattr(jbeam_pallas, "_INTERPRET", True)


def _step(h, lph, fin, t, u, T, max_beam_width=None):
    """The port's unbatched step (beam_search_decode) as numpy."""
    tt = lambda a, dt: torch.as_tensor(np.asarray(a, dt))
    out = beam_v1.beam_search_step(
        tt(h, np.float32)[None], tt(lph, np.float32)[None],
        tt(fin, bool)[None], tt(t, np.int32)[None], tt(u, np.int32)[None],
        torch.tensor([T], dtype=torch.int32), max_beam_width=max_beam_width)
    return {k: v[0].numpy() for k, v in zip(FIELDS, out)}


def _oracle(h, lph, fin, t, u, T, max_beam_width):
    return oracle.candidates_to_arrays(oracle.v1_beam_search_kernel(
        h, lph, fin, t, u, T, max_beam_width))


def _assert_bits(got, want, what=""):
    """Equal, and float fields equal in their sign bits too."""
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")
        if g.dtype.kind == "f":
            np.testing.assert_array_equal(np.signbit(g), np.signbit(w),
                                          err_msg=f"{what} {k}")


def _assert_matches_oracle(h, lph, fin, t, u, T, max_beam_width=None):
    W = max_beam_width or len(lph)
    got = _step(h, lph, fin, t, u, T, max_beam_width)
    _assert_bits(got, _oracle(h, lph, fin, t, u, T, W))
    return got


def test_reference_two_step_decode():
    """tests/test_decoding.rs:14-51 (T=4, W=3, rows [0.8, 0.2]), via the
    reference-parity unbatched wrapper."""
    T, W = 4, 3
    h = torch.log(torch.tensor([[0.8, 0.2]] * W))
    z = lambda dt: torch.zeros(W, dtype=dt)
    r1 = beam_v1.beam_search_decode(h, z(torch.float32), z(torch.bool),
                                    z(torch.int32), z(torch.int32), T,
                                    beam_width=W)
    r1 = dict(zip(FIELDS, (x.numpy() for x in r1)))
    np.testing.assert_allclose(r1["log_prob"],
                               np.log(np.array([0.8, 0.2, 0.8], np.float32)),
                               rtol=1e-6)
    assert r1["prediction"].tolist() == [0, 1, 0]
    assert r1["next_t"].tolist() == [0, 1, 0]
    assert r1["next_u"].tolist() == [1, 1, 1]
    assert r1["beam_branch"].tolist() == [0, 0, 0]
    assert not r1["is_finished"].any()
    hn = h.numpy()
    zeros = np.zeros(W, np.int32)
    r2 = _assert_matches_oracle(hn, r1["log_prob"], np.zeros(W, bool), zeros,
                                zeros, T)
    np.testing.assert_allclose(r2["log_prob"][0], np.log(np.float32(0.8)) * 2,
                               rtol=1e-6)
    with pytest.raises(ValueError, match="beam_width"):
        beam_v1.beam_search_decode(h, z(torch.float32), z(torch.bool),
                                   z(torch.int32), z(torch.int32), T,
                                   beam_width=W + 1)


def test_last_frame_semantics():
    """Emit at t = T-1 finishes; a shift there becomes a finishing emit
    with an unchanged log-prob (src/lib.rs:187-205)."""
    T = 3
    h = np.log(np.array([[0.6, 0.4], [0.7, 0.3]], np.float32))
    got = _assert_matches_oracle(h, np.array([-1.0, -2.0], np.float32),
                                 np.zeros(2, bool), np.full(2, T - 1),
                                 np.array([5, 6]), T)
    assert got["is_finished"].all() and (got["prediction"] == 0).all()
    assert got["log_prob"][0] == np.float32(-1.0)  # the converted shift


def test_finished_and_out_of_range_padding():
    """Finished, past-the-end and negative-t beams each give one padding
    candidate (src/lib.rs:174-184)."""
    T, W = 4, 4
    h = np.log(np.random.default_rng(1).uniform(0.1, 0.9, (W, 2))).astype(
        np.float32)
    got = _assert_matches_oracle(
        h, np.array([-0.5, -1.5, -2.5, -0.25], np.float32),
        np.array([True, False, False, False]), np.array([1, 7, 2, -1]),
        np.array([3, 4, 5, 0]), T)
    pads = got["beam_branch"][got["is_finished"]]
    assert {0, 1, 3} <= set(pads.tolist())


@pytest.mark.parametrize("seed", range(8))
def test_randomized_conformance(seed):
    """tests/test_beam_v1.py::test_randomized_conformance."""
    rng = np.random.default_rng(seed)
    W = int(rng.integers(1, 9))
    T = int(rng.integers(1, 6))
    h = np.log(rng.uniform(0.05, 1.0, (W, 2))).astype(np.float32)
    lph = rng.choice(np.array([-0.25, -0.5, -1.0], np.float32), W)
    fin = rng.uniform(size=W) < 0.2
    t = rng.integers(0, T + 2, W)
    u = rng.integers(0, 6, W)
    _assert_matches_oracle(h, lph, fin, t, u, T)


def test_dedup_ties_match_reference_order():
    T, W = 5, 4
    h = np.log(np.full((W, 2), [0.5, 0.5], np.float32))
    got = _assert_matches_oracle(h, np.zeros(W, np.float32),
                                 np.zeros(W, bool), np.zeros(W), np.zeros(W),
                                 T)
    # Emit and shift tie; their copies interleave, so none collapse.
    assert got["prediction"].tolist() == [0, 1, 0, 1]


def test_negative_zero_log_prob_tie_order():
    """-0.0 ties +0.0 and generation order decides: the finished beam's
    -0.0 padding candidate precedes the active +0.0 emit; the port keeps
    the -0.0 bits, as the oracle does."""
    h = np.array([[0.0, 0.0], [1.5, -5.0]], np.float32)
    lph = np.array([-0.0, -1.5], np.float32)
    got = _assert_matches_oracle(h, lph, np.array([True, False]),
                                 np.array([3, 4]), np.array([2, 2]), 10)
    assert got["beam_branch"].tolist() == [0, 1]
    assert np.signbit(got["log_prob"][0]) and got["is_finished"][0]


def test_widening_beam_loop():
    """tests/test_beam_v1.py::test_widening_beam_loop: the first step
    widens W=2 to 5 by pad-by-repetition and later steps run at 5, each
    step fed the previous outputs and checked against the oracle."""
    T, W_out = 6, 5
    rng = np.random.default_rng(7)
    lph, fin = np.zeros(2, np.float32), np.zeros(2, bool)
    t, u = np.zeros(2, np.int32), np.zeros(2, np.int32)
    for _ in range(7):
        h = np.log(rng.uniform(0.05, 1.0, (len(lph), 2))).astype(np.float32)
        got = _assert_matches_oracle(h, lph, fin, t, u, T, W_out)
        lph, fin = got["log_prob"], got["is_finished"]
        t, u = got["next_t"], got["next_u"]
    assert lph.shape == (W_out,)


def _batch(seed, B, W):
    """Ragged utterances (lengths 1-7); beams at the shared step, at their
    last frame, past it, at t = -1 or finished; dyadic log-probs, so ties
    and duplicate candidates occur; utterance 0 a first step (identical
    beams). State rows hold distinct values and a -0.0 lane."""
    rng = np.random.default_rng(seed)
    T = rng.integers(1, 8, B)
    s = rng.integers(0, T + 1)[:, None]
    t = np.where(rng.random((B, W)) < 0.7, s,
                 rng.integers(-1, T[:, None] + 1, (B, W)))
    u = t + rng.integers(0, 3, (B, W))
    fin = rng.random((B, W)) < 0.2
    hist = -rng.integers(0, 12, (B, W)) / 4.0
    h = -rng.integers(0, 8, (B, W, 2)) / 8.0
    dup = rng.random(B) < 0.4
    for a in (t, u, fin, hist, h):
        a[dup, 1 % W] = a[dup, 0]
    t[0], u[0], fin[0], hist[0], h[0] = 0, 0, False, 0.0, h[0, :1]
    state = rng.normal(0, 1, (B, W, 7)).astype(np.float32)
    state[:, :, 3] = -0.0
    return dict(h=h.astype(np.float32), lph=hist.astype(np.float32), fin=fin,
                t=t.astype(np.int32), u=u.astype(np.int32),
                il=T.astype(np.int32), state=state)


_ARGS = ("h", "lph", "fin", "t", "u", "il")


@pytest.mark.parametrize("W", [1, 2, 8, 16])
def test_batched_step_matches_jax_and_oracle(W):
    """The plain batched step against JAX's batched XLA step and the
    oracle, utterance by utterance, bit for bit."""
    for seed in range(3):
        x = _batch(seed, B=10, W=W)
        got = beam_v1.beam_search_step(
            *(torch.from_numpy(x[k]) for k in _ARGS))
        got = dict(zip(FIELDS, (g.numpy() for g in got)))
        xla = jax.jit(jbeam_v1.beam_search_decode_batched)(
            *(jnp.asarray(x[k]) for k in _ARGS))
        _assert_bits(got, dict(zip(FIELDS, map(np.asarray, xla))),
                     f"xla seed {seed}")
        for b in range(10):
            want = _oracle(x["h"][b], x["lph"][b], x["fin"][b], x["t"][b],
                           x["u"][b], int(x["il"][b]), W)
            _assert_bits({k: v[b] for k, v in got.items()}, want,
                         f"oracle seed {seed} b {b}")


@pytest.mark.parametrize("W", [1, 2, 8, 16])
def test_beam_only_v1_wrappers_match_jax_kernels(W):
    """beam_search_step_reorder / _batched (plain on CPU tensors, no
    launch) against JAX's #11 and #10, interpreted: integer outputs
    equal, log-prob and reordered rows equal under IEEE ==."""
    for seed in range(3):
        x = _batch(seed, B=10, W=W)
        tx = [torch.from_numpy(x[k]) for k in _ARGS]
        jx = [jnp.asarray(x[k]) for k in _ARGS]
        before = (beam_kernels.beam_search_step_reorder.launches,
                  beam_kernels.beam_search_step_batched.launches)
        got = beam_kernels.beam_search_step_reorder(
            *tx, torch.from_numpy(x["state"]))
        got_b = beam_kernels.beam_search_step_batched(*tx)
        assert (beam_kernels.beam_search_step_reorder.launches,
                beam_kernels.beam_search_step_batched.launches) == before
        assert got_b.state is None
        want = jbeam_pallas.beam_search_step_reorder(
            *jx, jnp.asarray(x["state"]))
        want_b = jbeam_pallas.beam_search_step_batched(*jx)
        for name, g, gb, w, wb in zip(FIELDS, got, got_b, want, want_b):
            for a in (g, gb):
                np.testing.assert_array_equal(a.numpy(), np.asarray(w),
                                              err_msg=f"seed {seed} {name}")
            np.testing.assert_array_equal(np.asarray(w), np.asarray(wb))
        np.testing.assert_array_equal(got.state.numpy(), np.asarray(want[6]))
        idx = got.branch.long()[..., None].expand(-1, -1, 7)
        _assert_bits({"state": got.state},
                     {"state": torch.gather(torch.from_numpy(x["state"]), 1,
                                            idx)})


def test_extract_best_beam_branch_golden():
    """tests/test_decoding.rs:54-131, unbatched and batched (the table is
    both the parent pointers and the t_history)."""
    table = torch.tensor(GOLDEN_TABLE, dtype=torch.int32)
    best, ts = backtrace.extract_best_beam_branch(9, table, table)
    assert best.dtype == torch.int32 and best.tolist() == GOLDEN_EXPECTED
    want_b, want_t = oracle.extract_best_beam_branch_kernel(
        9, GOLDEN_TABLE, GOLDEN_TABLE)
    assert best.tolist() == want_b and ts.tolist() == want_t
    stacked = torch.stack([table, table.flip(1)])
    best2, ts2 = backtrace.extract_best_beam_branch(
        torch.tensor([9, 0]), stacked, stacked)
    assert best2[0].tolist() == GOLDEN_EXPECTED and ts2[0].tolist() == want_t
    want_b, want_t = oracle.extract_best_beam_branch_kernel(
        0, stacked[1].tolist(), stacked[1].tolist())
    assert best2[1].tolist() == want_b and ts2[1].tolist() == want_t


def test_extract_best_beam_branch_matches_jax():
    rng = np.random.default_rng(0)
    B, U, W = 3, 12, 5
    bb = rng.integers(0, W, (B, U, W)).astype(np.int32)
    th = rng.integers(0, 20, (B, U, W)).astype(np.int32)
    finals = rng.integers(0, W, B).astype(np.int32)
    got = backtrace.extract_best_beam_branch(
        *(torch.from_numpy(a) for a in (finals, bb, th)))
    want = jax.jit(jbacktrace.extract_best_beam_branch)(finals, bb, th)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _wrapper_args(device="cpu"):
    x = _batch(0, B=3, W=2)
    return ([torch.from_numpy(x[k]).to(device) for k in _ARGS],
            torch.from_numpy(x["state"]).to(device))


def test_beam_only_v1_wrappers_bound_the_output_width():
    """max_beam_width from 1 to MAX_BEAMS (the kernel's slot limit): the
    kernel path (tensors off the CPU) raises ValueError outside it before
    anything else, and at 17 gets as far as the device check; the plain
    versions (CPU tensors) take 17. tests/test_torch_beam_steps.py and
    tests/test_torch_wide_beam.py compare the widths with JAX's kernels."""
    meta_args, meta_state = _wrapper_args("meta")
    for bad in (0, beam_kernels.MAX_BEAMS + 1):
        with pytest.raises(ValueError, match="MAX_BEAMS"):
            beam_kernels.beam_search_step_reorder(*meta_args, meta_state,
                                                  max_beam_width=bad)
        with pytest.raises(ValueError, match="MAX_BEAMS"):
            beam_kernels.beam_search_step_batched(*meta_args,
                                                  max_beam_width=bad)
    with pytest.raises(ValueError, match="cuda or cpu"):
        beam_kernels.beam_search_step_reorder(*meta_args, meta_state,
                                              max_beam_width=17)
    args, state = _wrapper_args()
    out = beam_kernels.beam_search_step_reorder(*args, state,
                                                max_beam_width=17)
    assert out.state.shape == (3, 17, state.shape[-1])
    out = beam_kernels.beam_search_step_batched(*args, max_beam_width=17)
    assert out.prediction.shape == (3, 17)


def test_beam_only_v1_wrappers_reject_other_devices():
    """Neither CPU nor CUDA tensors: raise, do not fall back."""
    args, state = _wrapper_args("meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        beam_kernels.beam_search_step_reorder(*args, state)
    with pytest.raises(ValueError, match="cuda or cpu"):
        beam_kernels.beam_search_step_batched(*args)


def test_fused_v1_build_needs_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path / "none"))
    _build.fused_v1_library.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.fused_v1_library()
    _build.fused_v1_library.cache_clear()
