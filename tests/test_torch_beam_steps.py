"""PyTorch port, beam-only steps: the plain tone step and the beam-only v2
and tone wrappers (ops/beam_kernels, which run their plain versions on
CPU tensors) held bit for bit against the JAX package's XLA steps and its
beam kernels (beam_pallas, interpreted), against hand-traced goldens, and
the wrappers' guards.

The JAX v2 step runs eagerly (jax.disable_jit), as in
tests/test_torch_beam.py: compiled XLA on the CPU contracts the band and
diagonal arithmetic into fused multiply-adds, which the reference does
not."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ssnt_tts_tpu.ops.beam_pallas as jbeam_pallas
from ssnt_tts_tpu.ops import beam_v1 as jbeam_v1
from ssnt_tts_tpu.ops import beam_v2 as jbeam_v2
from ssnt_tts_tpu.ops import tone_latent as jtone
from ssnt_tts_tpu.utils.config import V2BeamConfig as JaxV2BeamConfig
from ssnt_tts_tpu_torch.ops import _build, beam_kernels, tone_latent
from ssnt_tts_tpu_torch.utils.config import V2BeamConfig

TONE_FIELDS = ("prediction", "log_prob", "next_t", "next_u", "is_finished",
               "beam_branch")
V2_FIELDS = ("prediction", "log_prob", "next_t", "next_u", "is_finished",
             "total_duration", "beam_branch", "num_survivors")


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setattr(jbeam_pallas, "_INTERPRET", True)


def _assert_same(got, want, what=""):
    for k, g, w in zip(want, got, want.values()):
        g, w = np.asarray(g), np.asarray(w)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")
        if g.dtype.kind == "f":  # bit-exact, including the sign of zero
            np.testing.assert_array_equal(np.signbit(g), np.signbit(w),
                                          err_msg=f"{what} {k}")


def _tone_inputs(seed, B, W, K, F=5):
    """Ragged utterances; beams at the shared step, past their length or
    finished; dyadic log-probs so ties and duplicate candidates occur.
    Utterance 0 is a first step: every beam identical, so each class's W
    copies collapse into one and, for W > K, the slots pad by
    repetition."""
    rng = np.random.default_rng(seed)
    T = rng.integers(3, 10, B)
    s = rng.integers(0, T + 1)[:, None]
    t = np.where(rng.random((B, W)) < 0.8, s,
                 rng.integers(0, T[:, None] + 1, (B, W)))
    u = t + rng.integers(0, 3, (B, W))
    fin = rng.random((B, W)) < 0.2
    hist = -rng.integers(0, 12, (B, W)) / 4.0
    h = -rng.integers(0, 8, (B, W, K)) / 8.0
    dup = rng.random(B) < 0.4
    for arr in (t, u, fin, hist, h):
        arr[dup, 1] = arr[dup, 0]
    t[0], u[0], fin[0], hist[0] = 0, 0, False, 0.0
    h[0] = h[0, :1]
    return dict(h=h.astype(np.float32), lph=hist.astype(np.float32),
                fin=fin, t=t.astype(np.int32), u=u.astype(np.int32),
                il=T.astype(np.int32),
                state=rng.normal(0, 1, (B, W, F)).astype(np.float32))


_TONE_ARGS = ("h", "lph", "fin", "t", "u", "il")


@pytest.mark.parametrize("W", [2, 8, 16])
@pytest.mark.parametrize("empty_tone_id", [0, 3])
def test_tone_step_matches_jax(W, empty_tone_id):
    """The plain tone step against JAX's XLA step and its interpreted
    beam kernel; the beam-only wrapper (plain on CPU tensors, no launch)
    against that kernel's state= form."""
    for seed in range(3):
        x = _tone_inputs(seed, B=12, W=W, K=8)
        tx = [torch.from_numpy(np.asarray(x[k])) for k in _TONE_ARGS]
        jx = [jnp.asarray(x[k]) for k in _TONE_ARGS]
        got = tone_latent.beam_search_step(*tx, empty_tone_id=empty_tone_id)
        xla = jtone.beam_search_decode(*jx, empty_tone_id=empty_tone_id)
        _assert_same(got, dict(zip(TONE_FIELDS, xla)), f"xla seed {seed}")
        want = jbeam_pallas.tone_beam_search_decode(
            *jx, empty_tone_id=empty_tone_id, state=jnp.asarray(x["state"]))
        before = beam_kernels.tone_beam_search_decode.launches
        wrapped = beam_kernels.tone_beam_search_decode(
            *tx, state=torch.from_numpy(x["state"]),
            empty_tone_id=empty_tone_id)
        assert beam_kernels.tone_beam_search_decode.launches == before
        _assert_same(wrapped, dict(zip(TONE_FIELDS + ("state",), want)),
                     f"kernel seed {seed}")


def test_tone_first_step_dedup_pads_by_repetition():
    """W=16 identical beams, K=8 classes with distinct log-probs: the 16
    copies of each class are adjacent in sorted order and collapse into
    one, so 8 survive and slots 8-15 repeat slots 0-7; every branch is
    beam 0. (Two classes that tie interleave their copies in generation
    order, and the adjacent dedup keeps them all, as the reference does.)"""
    W, K = 16, 8
    h = np.array([-0.5, -0.25, -1.0, -0.375, -2.0, -0.125, -0.75, -0.625],
                 np.float32)
    x = dict(h=np.broadcast_to(h, (1, W, K)).copy(),
             lph=np.zeros((1, W), np.float32), fin=np.zeros((1, W), bool),
             t=np.zeros((1, W), np.int32), u=np.zeros((1, W), np.int32),
             il=np.array([5], np.int32))
    got = tone_latent.beam_search_step(
        *(torch.from_numpy(x[k]) for k in _TONE_ARGS), empty_tone_id=3)
    order = [5, 1, 3, 0, 7, 6, 2, 4]
    assert got[0][0].tolist() == order * 2
    assert got[1][0].tolist() == [float(h[k]) for k in order] * 2
    assert got[5][0].tolist() == [0] * W
    assert got[2][0].tolist() == [1] * W and not got[4].any()
    with jax.disable_jit():
        want = jbeam_pallas.tone_beam_search_decode(
            *(jnp.asarray(x[k]) for k in _TONE_ARGS), empty_tone_id=3)
    _assert_same(got, dict(zip(TONE_FIELDS, want)))


def _v2_inputs(seed, B, W, D, F=6):
    """Ragged utterances with beams on and off the diagonal, finished, at
    their last position or past it; utterance 0 overruns (it empties
    outside test_mode)."""
    rng = np.random.default_rng(seed)
    T = rng.integers(3, 10, B)
    U = (T * rng.uniform(1.5, 5.0, B)).astype(np.int64)
    s = rng.integers(0, T + 1)[:, None]
    t = np.where(rng.random((B, W)) < 0.8, s,
                 rng.integers(0, T[:, None] + 1, (B, W)))
    diag = np.round(U[:, None] / T[:, None] * t).astype(np.int64)
    tot = np.maximum(diag + rng.integers(-3, 4, (B, W)), 0)
    fin = rng.random((B, W)) < 0.2
    hist = -rng.integers(0, 12, (B, W)) / 4.0
    h = -rng.integers(0, 8, (B, W, D)) / 8.0
    dup = rng.random(B) < 0.4
    for arr in (t, tot, fin, hist, h):
        arr[dup, 1] = arr[dup, 0]
    t[0], fin[0], U[0] = 0, False, T[0]
    return dict(
        h=h.astype(np.float32), lph=hist.astype(np.float32), fin=fin,
        tot=tot.astype(np.int32),
        dtab=np.array([0, 1, 2, 3, 5, 7, 4, 6][:D], np.int32),
        t=t.astype(np.int32),
        u=(t + rng.integers(0, 3, (B, W))).astype(np.int32),
        il=T.astype(np.int32), ol=U.astype(np.int32),
        state=rng.normal(0, 1, (B, W, F)).astype(np.float32))


_V2_ARGS = ("h", "lph", "fin", "tot", "dtab", "t", "u", "il", "ol")


@pytest.mark.parametrize("W", [4, 8])
@pytest.mark.parametrize("opts", [
    {}, {"guard": True}, {"allow_skip": True}, {"test_mode": True},
], ids=["defaults", "guard", "allow_skip", "test_mode"])
def test_v2_beam_only_matches_jax(W, opts):
    """The beam-only v2 wrapper (plain on CPU tensors, no launch) against
    JAX's eager XLA step followed by the state gather, bit for bit, and
    against the JAX beam kernel's state= form (interpreted) on every
    utterance where that kernel agrees with the eager step. The
    interpreted kernel is compiled, and its diagonal window
    `tot - U/T*next_t` contracts into a fused multiply-add: where the
    exact value is 0 it moves off the window's edge, and the kernel
    re-injects another candidate than the reference (ROADMAP.md, Queue
    3)."""
    guard = opts.get("guard", False)
    kw = dict(zero_duration_id=0, allow_skip=opts.get("allow_skip", False),
              test_mode=opts.get("test_mode", False))
    compared = 0
    for seed in range(3):
        x = _v2_inputs(seed, B=12, W=W, D=6)
        jx = [jnp.asarray(x[k]) for k in _V2_ARGS]
        jcfg = JaxV2BeamConfig(final_feasible_guard=guard)
        with jax.disable_jit():
            xla = jbeam_v2.beam_search_decode(
                *jx, config=jcfg, return_num_survivors=True, **kw)
            kern = jbeam_pallas.v2_beam_search_decode(
                *jx, config=jcfg, return_num_survivors=True,
                state=jnp.asarray(x["state"]), **kw)
        branch = np.asarray(xla[6]).astype(np.int64)
        want = [np.asarray(a) for a in xla] + [
            np.take_along_axis(x["state"], branch[..., None], axis=1)]
        before = beam_kernels.v2_beam_search_decode.launches
        got = beam_kernels.v2_beam_search_decode(
            *(torch.from_numpy(np.asarray(x[k])) for k in _V2_ARGS),
            state=torch.from_numpy(x["state"]),
            config=V2BeamConfig(final_feasible_guard=guard), **kw)
        assert beam_kernels.v2_beam_search_decode.launches == before
        names = V2_FIELDS + ("state",)
        _assert_same(got, dict(zip(names, want)), f"seed {seed}")
        kern = [np.asarray(a) for a in kern]
        same = np.ones(len(branch), bool)
        for a, b in zip(kern, want):
            same &= (a == b).reshape(len(branch), -1).all(axis=1)
        _assert_same([np.asarray(g)[same] for g in got],
                     {k: a[same] for k, a in zip(names, kern)},
                     f"kernel seed {seed}")
        compared += int(same.sum())
        if not kw["test_mode"]:
            assert got.num_survivors[0] == 0  # the overrun utterance
    assert compared >= 30  # of 36 utterances


def _tone_golden():
    """tests/test_golden_hand.py cases 5-6 (tone), hand-traced from
    src/tone_latent.rs."""
    x = dict(
        h=np.array([[[-0.5, -0.25, -1.0], [-9.0, -9.0, -9.0]],
                    [[-0.5, -0.25, -1.0], [-0.5, -0.25, -1.0]]], np.float32),
        lph=np.array([[-0.5, -0.25], [-0.5, -0.5]], np.float32),
        fin=np.array([[False, True], [False, False]]),
        t=np.ones((2, 2), np.int32), u=np.ones((2, 2), np.int32),
        il=np.array([3, 3], np.int32))
    want = dict(
        prediction=[[0, 1], [1, 0]],
        log_prob=np.array([[-0.25, -0.75], [-0.75, -1.0]], np.float32),
        next_t=[[1, 2], [2, 2]], next_u=[[1, 2], [2, 2]],
        is_finished=[[True, False], [False, False]],
        beam_branch=[[1, 0], [0, 0]])
    return x, want, _TONE_ARGS, beam_kernels.tone_beam_search_decode


def _v2_golden():
    """tests/test_golden_hand.py cases 1-3 (v2), hand-traced from
    src/v2.rs."""
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
    want = dict(
        prediction=[[1, 1], [2, 1], [2, 2]],
        log_prob=np.array([[-1.5, -1.5], [-2.25, -2.625], [-1.5, -1.5]],
                          np.float32),
        next_t=[[2, 2], [3, 3], [3, 3]], next_u=[[2, 2], [3, 3], [3, 3]],
        is_finished=[[False, False], [True, True], [False, False]],
        total_duration=[[3, 3], [8, 8], [6, 6]],
        beam_branch=[[0, 0], [0, 1], [1, 1]])
    return x, want, _V2_ARGS, beam_kernels.v2_beam_search_decode


@pytest.mark.parametrize("golden", [_v2_golden, _tone_golden],
                         ids=["v2", "tone"])
def test_hand_goldens_through_beam_only_steps(golden):
    x, want, names, step = golden()
    B, W = x["lph"].shape
    state = torch.arange(B * W * 3, dtype=torch.float32).reshape(B, W, 3)
    got = step(*(torch.from_numpy(x[k]) for k in names), state=state)
    _assert_same(got, want)
    br = torch.tensor(want["beam_branch"])
    torch.testing.assert_close(
        got.state, torch.gather(state, 1, br[..., None].expand(-1, -1, 3)),
        rtol=0, atol=0)


def _v1_inputs(seed, B, W, F=7):
    """v1 beams at the shared step, on their last frame, past it, at t = -1
    or finished; dyadic log-probs (ties, duplicate candidates); utterance
    0 a first step; state rows with a -0.0 lane."""
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
        a[dup, 1] = a[dup, 0]
    t[0], u[0], fin[0], hist[0], h[0] = 0, 0, False, 0.0, h[0, :1]
    state = rng.normal(0, 1, (B, W, F)).astype(np.float32)
    state[:, :, 3] = -0.0
    return dict(h=h.astype(np.float32), lph=hist.astype(np.float32), fin=fin,
                t=t.astype(np.int32), u=u.astype(np.int32),
                il=T.astype(np.int32), state=state)


def _gathered(state, branch):
    """state[b, branch[b, j]]: the reorder every wrapper's rows must be."""
    idx = np.asarray(branch).astype(np.int64)[..., None]
    return np.take_along_axis(state, idx, axis=1)


def _other_width_case(kind, seed, W, W_out):
    """(port output, JAX kernel output, eager JAX step output) of one
    beam-only step at W_out output slots, all as numpy tuples with the
    reordered rows last (the eager step's rows gathered by its branch)."""
    v1 = kind.startswith("v1")
    if v1:
        x = _v1_inputs(seed, B=10, W=W)
        names = _TONE_ARGS
    elif kind == "tone":
        x = _tone_inputs(seed, B=12, W=W, K=4)
        names = _TONE_ARGS
    else:
        x = _v2_inputs(seed, B=12, W=W, D=6)
        names = _V2_ARGS
    tx = [torch.from_numpy(np.asarray(x[k])) for k in names]
    jx = [jnp.asarray(x[k]) for k in names]
    state = x["state"]
    np_ = lambda out: tuple(np.asarray(a) for a in out)
    if kind == "v1_batched":
        got = beam_kernels.beam_search_step_batched(
            *tx, max_beam_width=W_out)[:6]
        kern = jbeam_pallas.beam_search_step_batched(
            *jx, max_beam_width=W_out)
        xla = jbeam_v1.beam_search_decode_batched(*jx,
                                                  max_beam_width=W_out)
        return np_(got), np_(kern), np_(xla)
    if kind == "v1_reorder":
        got = beam_kernels.beam_search_step_reorder(
            *tx, torch.from_numpy(state), max_beam_width=W_out)
        kern = jbeam_pallas.beam_search_step_reorder(
            *jx, jnp.asarray(state), max_beam_width=W_out)
        xla = jbeam_v1.beam_search_decode_batched(*jx,
                                                  max_beam_width=W_out)
        return (np_(got), np_(kern),
                np_(xla) + (_gathered(state, xla[5]),))
    if kind == "tone":
        got = beam_kernels.tone_beam_search_decode(
            *tx, state=torch.from_numpy(state), empty_tone_id=1,
            max_beam_width=W_out)
        kern = jbeam_pallas.tone_beam_search_decode(
            *jx, empty_tone_id=1, max_beam_width=W_out,
            state=jnp.asarray(state))
        xla = jax.vmap(lambda *a: jtone.beam_search_step(
            *a, empty_tone_id=1, max_beam_width=W_out))(*jx)
        return (np_(got), np_(kern),
                np_(xla) + (_gathered(state, xla[5]),))
    test_mode = kind == "v2_test_mode"
    kw = dict(zero_duration_id=0, allow_skip=False, test_mode=test_mode)
    got = beam_kernels.v2_beam_search_decode(
        *tx, state=torch.from_numpy(state), max_beam_width=W_out, **kw)
    with jax.disable_jit():
        kern = jbeam_pallas.v2_beam_search_decode(
            *jx, return_num_survivors=True, state=jnp.asarray(state),
            max_beam_width=W_out, **kw)
        h, lph, fin, tot, dtab, t, u, il, ol = jx
        if test_mode:
            ol = jnp.zeros_like(ol)
        xla = jax.vmap(
            lambda h_, lp_, f_, tt_, t_, u_, il_, ol_: jbeam_v2.
            beam_search_step(h_, lp_, f_, tt_, dtab, t_, u_, il_, ol_,
                             max_beam_width=W_out,
                             return_num_survivors=True, **kw))(
            h, lph, fin, tot, t, u, il, ol)
    return (np_(got), np_(kern), np_(xla) + (_gathered(state, xla[6]),))


@pytest.mark.parametrize("dw", [-1, 5], ids=["narrower", "wider"])
@pytest.mark.parametrize("kind", ["v1_batched", "v1_reorder", "v2",
                                  "v2_test_mode", "tone"])
def test_beam_only_wrappers_match_jax_at_other_widths(kind, dw):
    """max_beam_width = W - 1 and W + 5 (survivors padded by repetition):
    each beam-only wrapper (plain on CPU tensors, no launch) against JAX's
    beam kernel at the same max_beam_width, interpreted, as
    tests/test_beam_pallas.py runs it, and against JAX's eager step with
    the rows gathered by its branch. Integers and selections exactly
    equal; log-probs and rows exactly equal (IEEE == against the JAX
    kernels, whose one-hot picks return a selected -0.0 as +0.0; bit for
    bit, sign included, against the eager step). The v2 kernel outside
    test_mode is held where it agrees with the eager step: its
    interpreted diagonal window contracts into a fused multiply-add
    (ROADMAP.md, Queue 3)."""
    W = 4
    W_out = W + dw
    counters = (beam_kernels.v2_beam_search_decode,
                beam_kernels.tone_beam_search_decode,
                beam_kernels.beam_search_step_reorder,
                beam_kernels.beam_search_step_batched)
    before = [c.launches for c in counters]
    compared = total = 0
    for seed in range(3):
        got, kern, xla = _other_width_case(kind, seed, W, W_out)
        assert all(g.shape[:2] == (g.shape[0], W_out) for g in got
                   if g.ndim >= 2)
        _assert_same(got, {f"field {i}": a for i, a in enumerate(xla)},
                     f"{kind} W_out={W_out} eager seed {seed}")
        same = np.ones(len(got[0]), bool)
        if kind == "v2":
            for a, b in zip(kern, xla):
                same &= (a == b).reshape(len(same), -1).all(axis=1)
        for i, (g, k) in enumerate(zip(got, kern)):
            np.testing.assert_array_equal(
                g[same], k[same],
                err_msg=f"{kind} W_out={W_out} kernel seed {seed} field {i}")
        compared += int(same.sum())
        total += len(same)
    assert [c.launches for c in counters] == before
    assert compared >= 0.8 * total


@pytest.mark.parametrize("golden", [_v2_golden, _tone_golden],
                         ids=["v2", "tone"])
def test_beam_only_wrappers_bound_the_output_width(golden):
    """1 <= max_beam_width <= MAX_BEAMS, the kernels' slot limit: outside
    it the kernel path (tensors off the CPU) raises ValueError before
    anything else; at 17 it gets as far as the device check. The plain
    versions (CPU tensors) take 17, as JAX's XLA step does."""
    x, _, names, step = golden()
    B, W = x["lph"].shape
    meta = lambda a: torch.from_numpy(np.asarray(a)).to("meta")
    for bad in (0, beam_kernels.MAX_BEAMS + 1):
        with pytest.raises(ValueError, match="MAX_BEAMS"):
            step(*(meta(x[k]) for k in names),
                 state=torch.zeros(B, W, 3, device="meta"),
                 max_beam_width=bad)
    with pytest.raises(ValueError, match="cuda or cpu"):
        step(*(meta(x[k]) for k in names),
             state=torch.zeros(B, W, 3, device="meta"), max_beam_width=17)
    out = step(*(torch.from_numpy(x[k]) for k in names),
               state=torch.zeros(B, W, 3), max_beam_width=17)
    assert out.state.shape == (B, 17, 3)
    assert all(a.shape[:2] == (B, 17) for a in out if a.ndim >= 2)


@pytest.mark.parametrize("golden", [_v2_golden, _tone_golden],
                         ids=["v2", "tone"])
def test_beam_only_wrappers_reject_other_devices(golden):
    """Neither CPU nor CUDA tensors: raise, do not fall back."""
    x, _, names, step = golden()
    B, W = x["lph"].shape
    meta = lambda a: torch.from_numpy(np.asarray(a)).to("meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        step(*(meta(x[k]) for k in names),
             state=torch.zeros(B, W, 3, device="meta"))


def test_beam_step_build_needs_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path / "none"))
    _build.beam_step_library.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.beam_step_library()
    _build.beam_step_library.cache_clear()
