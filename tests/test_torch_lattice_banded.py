"""PyTorch port, K-banded lattice loss (variant="banded"/"bandedN"): the
plain versions of the banded forward (lattice_forward_alphas_banded, #2)
and the banded backward-gradients walk (lattice_backward_grads_banded, #6)
held against the Pallas kernels they replace, run interpreted on the CPU,
and ssnt_loss_kernels(variant="bandedN") against ssnt_loss_pallas with the
same variant and against the port's plain route. Inputs are
numpy-seeded.

Tolerances: losses rtol 1e-5 and gradients rtol 1e-4 / atol 1e-5, those of
tests/test_lattice_pallas.py::test_banded_k_variants_match_xla. A plain
version repeats its kernel's operation order, so it is held tighter: the
alphas to rtol 1e-6 where the JAX kernel's value is finite (only the
exp/log implementations differ), and to a masked cell (<= NEG/2, a sum of
NEG whose exact value depends on the order of operations) where JAX's is;
the gradients to rtol 5e-6: each is exp(alpha + beta - logz) with |logz|
up to 24 here, so one float32 ulp of a log value of that size (1.9e-6)
is that much relative error in the gradient, and the composed beta chain
ends up to two ulps from JAX's (3.9e-6 at K=8; the plain backward walk
stays within one). The JAX runs are traced once per K and module.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssnt_tts_tpu.ops import lattice_pallas as jpal
from ssnt_tts_tpu_torch.ops import lattice as tlat
from ssnt_tts_tpu_torch.ops import lattice_kernels as tk

NEG = tlat.NEG
BANDS = [2, 4, 8, 16]
# tests/test_lattice_pallas.py::test_banded_k_variants_match_xla's setup.
B, T, U = 4, 6, 48
T_B = np.array([6, 5, 4, 6], np.int32)
U_B = np.array([48, 33, 29, 40], np.int32)
# Ragged lengths with il = ol = 1 and a degenerate example (ol < il).
IL = np.array([8, 5, 1, 6, 3, 8], np.int32)
OL = np.array([24, 13, 1, 4, 9, 17], np.int32)
DEGENERATE = 3


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jpal, "_INTERPRET", True)
    torch.set_num_threads(1)


def rand_inputs(rng, Bn, Tn, Un):
    le = np.log(rng.uniform(0.1, 0.9, (Bn, Tn, Un))).astype(np.float32)
    ls = np.log1p(-np.exp(le)).astype(np.float32)
    lf = rng.normal(0, 0.5, (Bn, Tn, Un)).astype(np.float32)
    return le, ls, lf


def setup_inputs():
    return rand_inputs(np.random.default_rng(11), B, T, U)


def ubt(x):
    return [np.ascontiguousarray(a.transpose(2, 0, 1)) for a in x]


@functools.lru_cache(maxsize=None)
def jax_loss_and_grads(K):
    """ssnt_loss_pallas(variant=f"banded{K}", chunk=16): per-example loss
    and the gradients of its sum (once per K)."""
    x = setup_inputs()

    def fn(a, b, c):
        return jpal.ssnt_loss_pallas(a, b, c, T_B, U_B, chunk=16,
                                     variant=f"banded{K}")

    loss = np.asarray(fn(*x))
    grads = jax.grad(lambda *a: jnp.sum(fn(*a)), argnums=(0, 1, 2))(*x)
    return loss, [np.asarray(g) for g in grads]


def torch_loss_and_grads(x, il, ol, **kw):
    xs = [torch.tensor(a, requires_grad=True) for a in x]
    loss = tk.ssnt_loss_kernels(*xs, torch.tensor(il), torch.tensor(ol),
                                **kw)
    loss.sum().backward()
    return loss.detach(), [a.grad for a in xs]


def assert_grads_close(got, want, rtol=1e-4, atol=1e-5):
    for g, w, name in zip(got, want, ("emit", "shift", "frame")):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=rtol,
                                   atol=atol, err_msg=name)


def assert_lattice_close(got, want, rtol=1e-6, atol=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    masked = want <= NEG / 2
    assert np.isfinite(got).all()
    assert (got[masked] <= NEG / 2).all()
    np.testing.assert_allclose(got[~masked], want[~masked], rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("K", BANDS)
def test_banded_loss_matches_jax(K):
    """ssnt_loss_kernels(variant=f"banded{K}") against ssnt_loss_pallas with
    the same variant, on ragged lengths."""
    want, wg = jax_loss_and_grads(K)
    got, gg = torch_loss_and_grads(setup_inputs(), T_B, U_B,
                                   variant=f"banded{K}")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    assert_grads_close(gg, wg)


@pytest.mark.parametrize("K", BANDS)
def test_forward_alphas_banded_reference_matches_pallas(K):
    x = ubt(setup_inputs())
    want = jpal.forward_alphas_pallas_banded(*map(jnp.asarray, x), chunk=16,
                                             kband=K)
    got = tk.lattice_forward_alphas_banded(*map(torch.tensor, x), K)
    assert got.dtype == torch.float32
    assert_lattice_close(got.numpy(), want)


@pytest.mark.parametrize("K", BANDS)
def test_backward_grads_banded_reference_matches_pallas(K):
    """#6's gradients given the same alphas, g and logz (the plain
    version's alphas), U = 48 a multiple of every K and of JAX's chunk."""
    x = [torch.tensor(a) for a in ubt(setup_inputs())]
    il, ol = torch.tensor(T_B), torch.tensor(U_B)
    alphas = tk.lattice_forward_alphas_banded(*x, K)
    logz = tlat.gather_logz(alphas, x[0], il, ol)
    g = torch.tensor(np.random.default_rng(K).uniform(0.5, 2.0, B)
                     .astype(np.float32))
    want = jpal.backward_grads_pallas_banded(
        *(jnp.asarray(a.numpy()) for a in (*x, alphas, il, ol, g, logz)),
        chunk=16, kband=K)
    got = tk.lattice_backward_grads_banded(*x, alphas, il, ol, g, logz, K)
    for a, w in zip(got, want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=5e-6,
                                   atol=1e-7)


def test_bare_banded_is_banded2():
    x = setup_inputs()
    got, gg = torch_loss_and_grads(x, T_B, U_B, variant="banded")
    want, wg = torch_loss_and_grads(x, T_B, U_B, variant="banded2")
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(gg, wg))
    assert tk.grad_mode("banded", B, T) == ("banded", 2)


@pytest.mark.parametrize("K", BANDS)
def test_banded_u_not_multiple_of_k(K):
    """U = 37 (padded to a multiple of K) against the plain route."""
    rng = np.random.default_rng(20 + K)
    x = rand_inputs(rng, 3, 7, 37)
    il, ol = np.array([7, 5, 4], np.int32), np.array([37, 22, 9], np.int32)
    got, gg = torch_loss_and_grads(x, il, ol, variant=f"banded{K}")
    xs = [torch.tensor(a, requires_grad=True) for a in x]
    want = tlat.ssnt_loss(*xs, torch.tensor(il), torch.tensor(ol))
    want.sum().backward()
    np.testing.assert_allclose(got.numpy(), want.detach().numpy(),
                               rtol=1e-5)
    assert_grads_close(gg, [a.grad for a in xs])


@pytest.mark.parametrize("K", BANDS)
def test_banded_degenerate_example_and_nograd(K):
    """With il = ol = 1 and a degenerate example (no path to t = il-1):
    the degenerate example's loss is the sentinel and its gradients are
    exactly 0, the rest agree with the plain route, and the no-grad forward
    (the banded forward alone) equals the forward under grad bit for bit."""
    rng = np.random.default_rng(30 + K)
    x = rand_inputs(rng, len(IL), 8, 24)
    got, gg = torch_loss_and_grads(x, IL, OL, variant=f"banded{K}")
    assert got[DEGENERATE] >= -NEG / 2
    assert not any(g[DEGENERATE].any() for g in gg)
    xs = [torch.tensor(a, requires_grad=True) for a in x]
    want = tlat.ssnt_loss(*xs, torch.tensor(IL), torch.tensor(OL))
    want.sum().backward()
    np.testing.assert_allclose(got.numpy(), want.detach().numpy(),
                               rtol=1e-5)
    assert_grads_close(gg, [a.grad for a in xs])
    with torch.no_grad():
        nograd = tk.ssnt_loss_kernels(*map(torch.tensor, (*x, IL, OL)),
                                      variant=f"banded{K}")
    assert torch.equal(nograd, got)
