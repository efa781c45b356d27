"""PyTorch port, distribution slice: the T-sharded lattice ring
(ssnt_tts_tpu_torch/ops/lattice_sharded.py) against JAX's
ssnt_loss_tsharded and lattice.ssnt_loss on the same numpy-seeded inputs.

The torch ranks run under gloo on the CPU, started by
ssnt_tts_tpu_torch.dryrun.launch (one launch of n ranks per ring size,
a file rendezvous under pytest's tmp directory, 300 s deadline); JAX runs
in this process on its 8 virtual CPU devices (tests/conftest.py).

Tolerances are tests/test_lattice_sharded.py's: losses rtol = atol =
1e-5, gradients rtol 1e-4, atol 1e-5.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh as JaxMesh

from ssnt_tts_tpu.models import ssnt as jssnt
from ssnt_tts_tpu.ops import lattice as jlattice
from ssnt_tts_tpu.ops import lattice_sharded as jsharded
from ssnt_tts_tpu_torch import dryrun
from ssnt_tts_tpu_torch.ops import lattice_sharded
from ssnt_tts_tpu_torch.parallel.mesh import Mesh

BLOCKS = (1, 2, 4, 8, 12, 24)
GRAD_BLOCKS = (1, 8, None)
RINGS = (2, 4)
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _inputs(rng, U, B, T):
    le = np.log(rng.uniform(0.1, 0.9, (U, B, T))).astype(np.float32)
    ls = np.log1p(-np.exp(le)).astype(np.float32)
    lf = rng.normal(0, 0.5, (U, B, T)).astype(np.float32)
    return le, ls, lf


def _case(seed, U, B, T, il, ol, blocks):
    le, ls, lf = _inputs(np.random.default_rng(seed), U, B, T)
    return dict(le=le, ls=ls, lf=lf, il=np.asarray(il, np.int32),
                ol=np.asarray(ol, np.int32), blocks=list(blocks))


# The inputs of tests/test_lattice_sharded.py: ragged lengths over every
# block size, ragged gradients, and U = 128.
CASES = {
    "ragged": _case(3, 24, 3, 16, [16, 11, 7], [24, 15, 9], BLOCKS),
    "grads": _case(4, 24, 2, 8, [8, 6], [24, 17], GRAD_BLOCKS),
    "u128": _case(2, 128, 2, 16, [16, 16], [128, 128], (None, 1)),
}


def _exp_case(il):
    """The exp domain's quadruple as the joints emit it: E, S a softmax
    pair, F = exp(lf - mcol) with mcol the column max over valid t, and
    F = 0 past the input length."""
    rng = np.random.default_rng(6)
    U, B, T = 16, 2, 8
    il, ol = np.asarray(il, np.int32), np.asarray([16, 11], np.int32)
    z = rng.normal(0, 1, (2, U, B, T))
    E = (np.exp(z[0]) / np.exp(z).sum(0)).astype(np.float32)
    S = (1 - E).astype(np.float32)
    lf = rng.normal(0, 1.5, (U, B, T))
    valid = np.arange(T)[None, None, :] < il[None, :, None]
    mcol = np.where(valid, lf, -np.inf).max(-1).astype(np.float32)
    F = np.where(valid, np.exp(lf - mcol[..., None]), 0).astype(np.float32)
    return dict(E=E, S=S, F=F, mcol=mcol, il=il, ol=ol)


EXP = {"full": _exp_case([8, 8]), "ragged": _exp_case([8, 5])}


@pytest.fixture(scope="module")
def rings(tmp_path_factory):
    """Every case on rings of 2 and 4 ranks (2x1 / 1x4 meshes' model
    axis), each rank's results."""
    out = {}
    for n in RINGS:
        job = {"mesh": (1, n), "cases": list(CASES.values()),
               "exp_cases": list(EXP.values())}
        out[n] = dryrun.launch("lattice", job, n,
                               tmp_path_factory.mktemp(f"ring{n}"),
                               device="cpu", timeout=300)
    return out


def _jmesh(n):
    return JaxMesh(np.asarray(jax.devices()[:n]), ("model",))


@functools.lru_cache(maxsize=None)
def _jax_ring(n, block, grad=False):
    """JAX's ssnt_loss_tsharded over n devices, jitted: (le, ls, lf, il,
    ol) -> loss, or its gradients in le, ls and lf."""
    loss = lambda le, ls, lf, il, ol: jsharded.ssnt_loss_tsharded(
        le, ls, lf, il, ol, _jmesh(n), block=block)
    if grad:
        return jax.jit(jax.grad(lambda *a: jnp.sum(loss(*a)),
                                argnums=(0, 1, 2)))
    return jax.jit(loss)


def _jax_sharded(case, n, block, grad=False):
    out = _jax_ring(n, block, grad)(
        *(jnp.asarray(case[k]) for k in ("le", "ls", "lf", "il", "ol")))
    return [np.asarray(g) for g in out] if grad else np.asarray(out)


def _jax_ref(case):
    return np.asarray(jlattice.ssnt_loss(
        *(jnp.asarray(case[k]) for k in ("le", "ls", "lf", "il", "ol")),
        layout="ubt"))


def _result(rings, n, name, block):
    rows = rings[n][0]["cases"][list(CASES).index(name)]
    return next(r for r in rows if r["block"] == block)


@pytest.mark.parametrize("n", RINGS)
@pytest.mark.parametrize("block", BLOCKS)
def test_ring_loss_matches_jax_ragged(rings, n, block):
    case = CASES["ragged"]
    got = _result(rings, n, "ragged", block)["loss"]
    np.testing.assert_allclose(got, _jax_sharded(case, n, block),
                               **LOSS_TOL, err_msg="vs JAX's ring")
    np.testing.assert_allclose(got, _jax_ref(case), **LOSS_TOL,
                               err_msg="vs lattice.ssnt_loss")


@pytest.mark.parametrize("n", RINGS)
@pytest.mark.parametrize("block", GRAD_BLOCKS)
def test_ring_gradients_match_jax(rings, n, block):
    """The beta ring's posteriors, all-gathered, against autodiff through
    lattice.ssnt_loss, and through JAX's ring at block 8 (as
    tests/test_lattice_sharded.py)."""
    c = CASES["grads"]
    il, ol = jnp.asarray(c["il"]), jnp.asarray(c["ol"])
    args = tuple(jnp.asarray(c[k]) for k in ("le", "ls", "lf"))
    wants = {"lattice.ssnt_loss": jax.grad(
        lambda a, b, f: jnp.sum(jlattice.ssnt_loss(
            a, b, f, il, ol, layout="ubt")), argnums=(0, 1, 2))(*args)}
    if block == 8:
        wants["JAX's ring"] = _jax_sharded(c, n, block, grad=True)
    got = _result(rings, n, "grads", block)
    np.testing.assert_allclose(got["loss"], _jax_ref(c), **LOSS_TOL)
    for what, want in wants.items():
        for g, w, name in zip(got["grads"], want, ("emit", "shift",
                                                  "frame")):
            np.testing.assert_allclose(g, np.asarray(w), **GRAD_TOL,
                                       err_msg=f"{name} vs {what}")


@pytest.mark.parametrize("n", RINGS)
@pytest.mark.parametrize("block", (None, 1))
def test_ring_u128(rings, n, block):
    """U = 128 columns (the default block is 32: 4 + n - 1 hops)."""
    case = CASES["u128"]
    got = _result(rings, n, "u128", block)["loss"]
    np.testing.assert_allclose(got, _jax_ref(case), **LOSS_TOL)
    if block is None:
        np.testing.assert_allclose(got, _jax_sharded(case, n, None),
                                   **LOSS_TOL)


@pytest.mark.parametrize("n", RINGS)
def test_ranks_agree(rings, n):
    """Every rank of the ring returns the same loss and whole-T
    gradients, bit for bit."""
    for rank in rings[n][1:]:
        for rows, rows0 in zip(rank["cases"], rings[n][0]["cases"]):
            for r, r0 in zip(rows, rows0):
                np.testing.assert_array_equal(r["loss"], r0["loss"])
                for g, g0 in zip(r["grads"], r0["grads"]):
                    np.testing.assert_array_equal(g, g0)


@pytest.mark.parametrize("n", RINGS)
@pytest.mark.parametrize("name", list(CASES))
def test_ring_is_the_plain_loss_bit_for_bit(rings, n, name):
    """The ring shares ops/lattice.py's column and posterior code
    (beta_column, gather_logz and posterior_grads on a slice): its loss
    and gradients equal the port's plain ssnt_loss bit for bit, every
    block."""
    import torch

    from ssnt_tts_tpu_torch.ops import lattice as tlattice

    case = CASES[name]
    xs = [torch.tensor(case[k], requires_grad=True)
          for k in ("le", "ls", "lf")]
    want = tlattice.ssnt_loss(*xs, torch.as_tensor(case["il"]),
                              torch.as_tensor(case["ol"]), layout="ubt")
    want.sum().backward()
    for r in rings[n][0]["cases"][list(CASES).index(name)]:
        np.testing.assert_array_equal(r["loss"], want.detach().numpy(),
                                      err_msg=f"block {r['block']}")
        for g, x in zip(r["grads"], xs):
            np.testing.assert_array_equal(g, x.grad.numpy(),
                                          err_msg=f"block {r['block']}")


@pytest.mark.parametrize("n", RINGS)
def test_hop_counts(rings, n):
    """U hops a walk per column (block 1), U/K + n - 1 for the wavefront;
    one group sum a forward, one all_gather a backward."""
    for name, case in CASES.items():
        U = case["le"].shape[0]
        for r in rings[n][0]["cases"][list(CASES).index(name)]:
            K = r["block"] or lattice_sharded._pick_block(U)
            hops = lattice_sharded.hops_per_walk(U, n, K)
            assert hops == (U if K == 1 else U // K + n - 1)
            assert r["counts"] == {"hops_forward": hops,
                                   "hops_backward": hops, "all_reduce": 1,
                                   "all_gather": 1}, (name, K)


@functools.lru_cache(maxsize=None)
def _jax_exp_fn(n):
    """JAX's dispatch_exp under tshard_lattice over n devices, jitted:
    (E, S, F, mcol, il, ol) -> (loss, gradients in E, S, F and mcol)."""
    fn = jssnt._lattice_loss_fn("xla", "float32", "exp")

    def total(E, S, F, mcol, il, ol):
        with jsharded.tshard_lattice(_jmesh(n), "model", 0):
            loss = fn(E, S, F, mcol, il, ol)
        return jnp.sum(loss), loss

    return jax.jit(jax.value_and_grad(total, argnums=(0, 1, 2, 3),
                                      has_aux=True))


def _jax_exp_hook(c, n):
    (_, loss), grads = _jax_exp_fn(n)(
        *(jnp.asarray(c[k]) for k in ("E", "S", "F", "mcol", "il", "ol")))
    return np.asarray(loss), [np.asarray(g) for g in grads]


def test_exp_domain_hook(rings):
    """models/ssnt.lattice_loss under tshard_lattice log-ifies the exp
    quadruple, log(max(x, 1e-38)) and lf + mcol, and takes the ring, as
    JAX's dispatch_exp does (full lengths: F > 0 everywhere)."""
    n = 2
    want, grads = _jax_exp_hook(EXP["full"], n)
    got = rings[n][0]["exp_cases"][0]
    assert got["counts"]["hops_forward"] == 16 // 16 + n - 1
    np.testing.assert_allclose(got["loss"], want, **LOSS_TOL)
    for g, w, name in zip(got["grads"], grads, ("E", "S", "F", "mcol")):
        np.testing.assert_allclose(g, w, **GRAD_TOL, err_msg=name)


def test_exp_domain_hook_keeps_log_of_tiny(rings):
    """F = 0 past an input length: float32 1e-38 is subnormal, and JAX on
    the CPU flushes max(F, 1e-38) to 0, so lf = -inf there and the whole
    example's gradients are NaN. The port keeps log(1e-38) = -87.5: its
    gradients are finite and equal to the unsharded plain route's. The
    losses agree, and so do the gradients of the example at full
    length."""
    import torch

    from ssnt_tts_tpu_torch.models.ssnt import lattice_loss

    c, n = EXP["ragged"], 2
    want, grads = _jax_exp_hook(c, n)
    got = rings[n][0]["exp_cases"][1]
    np.testing.assert_allclose(got["loss"], want, **LOSS_TOL)
    xs = [torch.tensor(c[k], requires_grad=True)
          for k in ("E", "S", "F", "mcol")]
    lattice_loss("xla", "float32", xs, torch.as_tensor(c["il"]),
                 torch.as_tensor(c["ol"]), "exp").sum().backward()
    for g, w, x, name in zip(got["grads"], grads, xs,
                             ("E", "S", "F", "mcol")):
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, x.grad.numpy(), **GRAD_TOL,
                                   err_msg=name)
        ok = np.isfinite(w)
        assert not ok[..., 1, :].all() if w.ndim == 3 else not ok.all()
        assert ok[..., 0, :].all() if w.ndim == 3 else ok[:, 0].all()
        np.testing.assert_allclose(g[ok], w[ok], **GRAD_TOL, err_msg=name)


def test_active_tshard_rules():
    """No context: None. Below the cell threshold (the global lattice,
    this rank's B times the data axis): None. T not divisible by the axis:
    None. Otherwise the mesh and its axis."""
    mesh = Mesh(shape={"data": 4, "model": 2}, rank=0, device=None,
                backend="gloo", groups={}, ranks={})
    assert lattice_sharded.active_tshard(4, 4, 4) is None
    with lattice_sharded.tshard_lattice(mesh, "model", min_cells=10**9):
        assert lattice_sharded.active_tshard(4, 4, 4) is None
    with lattice_sharded.tshard_lattice(mesh, "model", min_cells=0):
        assert lattice_sharded.active_tshard(4, 4, 8) == (mesh, "model")
        assert lattice_sharded.active_tshard(4, 4, 7) is None
    cells = 4 * 4 * 4 * 8  # U * B * data * T
    with lattice_sharded.tshard_lattice(mesh, "model", min_cells=cells):
        assert lattice_sharded.active_tshard(4, 4, 8) is not None
    with lattice_sharded.tshard_lattice(mesh, "model",
                                        min_cells=cells + 1):
        assert lattice_sharded.active_tshard(4, 4, 8) is None
    assert lattice_sharded.active_tshard(4, 4, 8) is None
    assert [lattice_sharded._pick_block(u) for u in (400, 24, 12, 7)] == [
        16, 8, 4, 1]
