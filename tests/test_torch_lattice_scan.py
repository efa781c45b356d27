"""PyTorch port, blocked parallel-scan lattice (ops/lattice_scan.py,
variant="scan"): tests/test_lattice_scan.py's cases run through JAX's
lattice_scan and the port's on the same numpy-seeded inputs, and
ssnt_loss_kernels(variant="scan") against ssnt_loss_pallas(variant="scan").

Tolerances are the JAX tests' own: losses rtol/atol 2e-4, alphas and betas
rtol/atol 1e-4 where valid, gradients rtol 2e-3 / atol 2e-5
(tests/test_lattice_scan.py); the dispatch test's loss rtol 1e-5 and
gradients rtol 1e-4 / atol 1e-5
(tests/test_lattice_pallas.py::test_scan_variant_dispatch_matches_xla).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssnt_tts_tpu.ops import lattice as jlat
from ssnt_tts_tpu.ops import lattice_pallas as jpal
from ssnt_tts_tpu.ops import lattice_scan as jscan
from ssnt_tts_tpu_torch.ops import lattice as tlat
from ssnt_tts_tpu_torch.ops import lattice_kernels as tk
from ssnt_tts_tpu_torch.ops import lattice_scan as tscan


@pytest.fixture(autouse=True)
def single_thread():
    torch.set_num_threads(1)


def rand_inputs(rng, B, T, U):
    le = np.log(rng.uniform(0.1, 0.9, (B, T, U))).astype(np.float32)
    ls = np.log1p(-np.exp(le)).astype(np.float32)
    lf = rng.normal(0, 0.5, (B, T, U)).astype(np.float32)
    return le, ls, lf


def torch_loss_and_grads(fn, x, *lens, **kw):
    xs = [torch.tensor(a, requires_grad=True) for a in x]
    loss = fn(*xs, *map(torch.tensor, lens), **kw)
    loss.sum().backward()
    return loss.detach().numpy(), [a.grad.numpy() for a in xs]


@pytest.mark.parametrize("K", [2, 4, 8])
@pytest.mark.parametrize("U", [7, 16, 33])
def test_loss_matches_jax_scan(K, U):
    rng = np.random.default_rng(K * 100 + U)
    x = rand_inputs(rng, 3, 6, U)
    want = np.asarray(jax.jit(
        lambda a, b, c: jscan.ssnt_loss_scan(a, b, c, K=K))(*x))
    got = tscan.ssnt_loss_scan(*map(torch.tensor, x), K=K).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    plain = tlat.ssnt_loss(*map(torch.tensor, x)).numpy()
    np.testing.assert_allclose(got, plain, rtol=2e-4, atol=2e-4)


def test_ragged_lengths_match_jax():
    rng = np.random.default_rng(0)
    x = rand_inputs(rng, 4, 7, 25)
    T_b = np.array([7, 5, 6, 4], np.int32)
    U_b = np.array([25, 12, 18, 9], np.int32)
    want = np.asarray(jax.jit(
        lambda a, b, c: jscan.ssnt_loss_scan(a, b, c, T_b, U_b, K=4))(*x))
    got = tscan.ssnt_loss_scan(*map(torch.tensor, (*x, T_b, U_b)), K=4)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_grads_match_jax():
    rng = np.random.default_rng(1)
    x = rand_inputs(rng, 3, 5, 17)
    T_b = np.array([5, 4, 3], np.int32)
    U_b = np.array([17, 10, 7], np.int32)
    want = jax.jit(jax.grad(
        lambda a, b, c: jnp.sum(jscan.ssnt_loss_scan(a, b, c, T_b, U_b,
                                                     K=4)),
        argnums=(0, 1, 2)))(*x)
    _, got = torch_loss_and_grads(tscan.ssnt_loss_scan, x, T_b, U_b, K=4)
    for g, w, name in zip(got, want, ("emit", "shift", "frame")):
        np.testing.assert_allclose(g, np.asarray(w), rtol=2e-3, atol=2e-5,
                                   err_msg=name)


def test_alphas_betas_directly():
    rng = np.random.default_rng(2)
    B, T, U = 2, 5, 16
    x = [np.ascontiguousarray(a.transpose(2, 0, 1))
         for a in rand_inputs(rng, B, T, U)]
    T_b = np.full((B,), T, np.int32)
    a_jax = np.asarray(jax.jit(
        lambda a, b, c: jscan.forward_alphas_scan(a, b, c, K=4))(*x))
    a_got = tscan.forward_alphas_scan(*map(torch.tensor, x), K=4).numpy()
    valid = a_jax > jlat.NEG / 2
    np.testing.assert_allclose(a_got[valid], a_jax[valid], rtol=1e-4,
                               atol=1e-4)
    b_jax = np.asarray(jax.jit(
        lambda a, b, c: jscan.backward_betas_scan(a, b, c, T_b, K=4))(*x))
    b_got = tscan.backward_betas_scan(*map(torch.tensor, x),
                                      torch.tensor(T_b), K=4).numpy()
    validb = b_jax > jlat.NEG / 2
    np.testing.assert_allclose(b_got[validb], b_jax[validb], rtol=1e-4,
                               atol=1e-4)
    # And against the port's sequential walks.
    tx = [torch.tensor(a) for a in x]
    b_seq = tlat._backward_betas(*tx, torch.tensor(T_b),
                                 torch.full((B,), U, dtype=torch.int32))
    np.testing.assert_allclose(b_got[validb], b_seq.numpy()[validb],
                               rtol=1e-4, atol=1e-4)


def test_scan_variant_dispatch_matches_jax():
    """ssnt_loss_kernels(variant="scan") against ssnt_loss_pallas(
    variant="scan") (both K = 16) on ragged lengths; no kernel launches."""
    rng = np.random.default_rng(13)
    x = rand_inputs(rng, 3, 6, 40)
    T_b = np.array([6, 5, 4], np.int32)
    U_b = np.array([40, 23, 31], np.int32)

    def jfn(a, b, c):
        return jpal.ssnt_loss_pallas(a, b, c, T_b, U_b, variant="scan")

    want = np.asarray(jax.jit(jfn)(*x))
    wg = jax.jit(jax.grad(lambda *a: jnp.sum(jfn(*a)),
                          argnums=(0, 1, 2)))(*x)
    before = [k.launches for k in tk.KERNELS]
    got, gg = torch_loss_and_grads(tk.ssnt_loss_kernels, x, T_b, U_b,
                                   variant="scan")
    assert [k.launches for k in tk.KERNELS] == before
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for g, w, name in zip(gg, wg, ("emit", "shift", "frame")):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_scan_needs_two_columns_and_a_power_of_two():
    x = [torch.zeros(2, 3, 1) for _ in range(3)]  # (B, T, U=1)
    with pytest.raises(ValueError, match="U >= 2"):
        tk.ssnt_loss_kernels(*x, variant="scan")
    with pytest.raises(ValueError, match="U >= 2"):
        tscan.backward_betas_scan(*(a.permute(2, 0, 1) for a in x),
                                  torch.full((2,), 3))
    y = [torch.zeros(2, 3, 8) for _ in range(3)]
    with pytest.raises(ValueError, match="power of two"):
        tscan.ssnt_loss_scan(*y, K=3)
