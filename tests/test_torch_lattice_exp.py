"""PyTorch port, exp-domain lattice: the plain versions of the exp-native
pass (lattice_expin, #9), the exp-domain bidirectional pass
(lattice_bidir_exp, #4) and the betas-only pass (lattice_backward_betas,
#3) held against the Pallas kernels they replace, run interpreted on the
CPU; the exp-native loss (ssnt_loss_expin_kernels) and variant="exp" of
ssnt_loss_kernels held against JAX and against the port's log path.
Inputs are numpy-seeded.

Tolerances: kernel fields rtol 1e-5 where finite, -inf positions equal,
with atol 1e-5 on log-domain values (alphas, betas, M, N), which pass near
0: XLA contracts the multiply-adds into fused ones, the port's kernels do
not, and its log is another implementation. Losses rtol 1e-5 and
gradients rtol 1e-4 / atol 1e-6 against JAX, as
tests/test_torch_lattice.py; against the log path the tolerances of
tests/test_lattice_pallas.py (expin: loss 1e-5, chain-ruled gradients
1e-4 / 1e-5; variant="exp": loss 5e-4, gradients 5e-3 / 5e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssnt_tts_tpu.ops import lattice_pallas as jpal
from ssnt_tts_tpu_torch.ops import lattice as tlat
from ssnt_tts_tpu_torch.ops import lattice_kernels as tk

NEG = tlat.NEG
# Ragged lengths with il = 1 / ol = 1 examples and one degenerate example
# (ol < il: no path reaches the last source position).
IL = np.array([8, 5, 1, 6, 3, 8], np.int32)
OL = np.array([24, 13, 1, 4, 9, 17], np.int32)
DEGENERATE = 3
U, T = 24, 8


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jpal, "_INTERPRET", True)
    torch.set_num_threads(1)


def log_lattice(seed, U=U, B=len(IL), T=T, lf_mean=0.0, lf_std=0.5):
    """(le, ls, lf) (U, B, T) float32: E + S = 1 per cell."""
    rng = np.random.default_rng(seed)
    le = np.log(rng.uniform(0.1, 0.9, (U, B, T))).astype(np.float32)
    ls = np.log1p(-np.exp(le)).astype(np.float32)
    lf = rng.normal(lf_mean, lf_std, (U, B, T)).astype(np.float32)
    return le, ls, lf


def exp_inputs(le, ls, lf):
    """The joints' exp-domain quadruple (E, S, F, mcol) of a log lattice."""
    mcol = lf.max(axis=2)
    F = np.exp(lf - mcol[:, :, None]).astype(np.float32)
    return np.exp(le), np.exp(ls), F, mcol


def assert_field_close(got, want, rtol=1e-5, atol=0.0):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    finite = np.isfinite(want)
    assert np.isfinite(got[finite]).all()
    np.testing.assert_allclose(got[finite], want[finite], rtol=rtol,
                               atol=atol)


def jax_value_and_grad(fn, x, *lens, **kw):
    argnums = tuple(range(len(x)))
    _, grads = jax.value_and_grad(
        lambda *a: jnp.sum(fn(*a, *lens, **kw)), argnums=argnums)(
        *map(jnp.asarray, x))
    per_ex = np.asarray(fn(*map(jnp.asarray, x), *lens, **kw))
    return per_ex, [np.asarray(g, np.float32) for g in grads]


def torch_value_and_grad(fn, x, *lens, **kw):
    xs = [torch.tensor(a, requires_grad=True) for a in x]
    loss = fn(*xs, *map(torch.tensor, lens), **kw)
    loss.sum().backward()
    return loss.detach().numpy(), [a.grad.numpy() for a in xs]


# -------------------------------------------- #9, the exp-native pass


@pytest.mark.parametrize("chunk", [8, 4])
def test_expin_reference_matches_pallas(chunk):
    """(a) qn, bn, M, N against fused_expin_pallas at a U that is a
    multiple of the chunk: the port's global-column renormalization is
    JAX's schedule at chunks 8 and 4."""
    E, S, F, mcol = exp_inputs(*log_lattice(0))
    want = jpal.fused_expin_pallas(*map(jnp.asarray, (E, S, F, mcol)),
                                   jnp.asarray(IL), jnp.asarray(OL),
                                   chunk=chunk)
    got = tk.lattice_expin(*map(torch.tensor, (E, S, F, mcol, IL, OL)))
    for g, w, atol in zip(got, want, (0.0, 0.0, 1e-5, 1e-5)):
        assert_field_close(g.numpy(), w, atol=atol)


def test_expin_loss_matches_jax():
    """(b) ssnt_loss_expin_kernels against ssnt_loss_expin: loss and the
    four gradients."""
    x = exp_inputs(*log_lattice(1))
    want, wg = jax_value_and_grad(jpal.ssnt_loss_expin, x, IL, OL, chunk=8)
    got, gg = torch_value_and_grad(tk.ssnt_loss_expin_kernels, x, IL, OL)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for g, w, name in zip(gg, wg, ("E", "S", "F", "mcol")):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6, err_msg=name)


def test_expin_loss_matches_log_path():
    """(c) Against the port's log path on the same lattice: the loss,
    the chain-ruled gradients (d_le = E dE, d_ls = S dS, d_lf = F dF),
    d_mcol = sum_t F dF, and finite differences on mcol."""
    le, ls, lf = log_lattice(3)
    il, ol = IL[[0, 1, 4]], OL[[0, 1, 4]]
    le, ls, lf = le[:, [0, 1, 4]], ls[:, [0, 1, 4]], lf[:, [0, 1, 4]]
    x = exp_inputs(le, ls, lf)
    got, (dE, dS, dF, dm) = torch_value_and_grad(tk.ssnt_loss_expin_kernels,
                                                  x, il, ol)
    want, (gle, gls, glf) = torch_value_and_grad(
        tlat.ssnt_loss, (le, ls, lf), il, ol, layout="ubt")
    np.testing.assert_allclose(got, want, rtol=1e-5)
    E, S, F, mcol = x
    for chain, w, name in ((E * dE, gle, "emit"), (S * dS, gls, "shift"),
                           (F * dF, glf, "frame")):
        np.testing.assert_allclose(chain, w, rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    np.testing.assert_allclose(dm, (F * dF).sum(2), rtol=1e-4, atol=1e-6)

    def loss_at(mc):
        return float(tk.ssnt_loss_expin_kernels(
            *map(torch.tensor, (E, S, F, mc, il, ol))).sum())

    eps = 1e-3
    for uu, bb in ((0, 0), (5, 1), (10, 2)):
        up, dn = mcol.copy(), mcol.copy()
        up[uu, bb] += eps
        dn[uu, bb] -= eps
        fd = (loss_at(up) - loss_at(dn)) / (2 * eps)
        assert abs(fd - dm[uu, bb]) < 5e-2, (uu, bb, fd, dm[uu, bb])


def test_expin_degenerate_example():
    """(d) An example whose emit probability is 0 everywhere has no valid
    path: the 1e30 sentinel and exactly zero gradients, while the other
    examples stay finite, as JAX's test_expin_degenerate_path_zero_grads."""
    E, S, F, mcol = exp_inputs(*log_lattice(29, U=16, B=2))
    E[:, 0], S[:, 0] = 0.0, 1.0
    il, ol = np.full(2, T, np.int32), np.full(2, 16, np.int32)
    got, gg = torch_value_and_grad(tk.ssnt_loss_expin_kernels,
                                   (E, S, F, mcol), il, ol)
    want, wg = jax_value_and_grad(jpal.ssnt_loss_expin, (E, S, F, mcol),
                                  il, ol, chunk=8)
    assert got[0] == -NEG and np.isfinite(got[1])
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for g, w in zip(gg, wg):
        assert not g[:, 0].any() and np.isfinite(g[:, 1]).all()
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)


def test_jax_expin_chunk_2_never_renormalizes():
    """(e) JAX renormalizes at chunk column (j + 1) % 4 == 0, so at chunk
    2 (what _auto_chunk picks once B * pad128(T) > 39321) it never does:
    over U=200 the fields underflow and every loss is the 1e30 sentinel.
    The port renormalizes by global column and stays on the log path."""
    le, ls, lf = log_lattice(5, U=200, B=2, T=16, lf_mean=-2.0, lf_std=1.0)
    il, ol = np.array([16, 12], np.int32), np.array([200, 150], np.int32)
    x = exp_inputs(le, ls, lf)
    jax_loss = np.asarray(jpal.ssnt_loss_expin(
        *map(jnp.asarray, x), jnp.asarray(il), jnp.asarray(ol), chunk=2))
    assert (jax_loss == -NEG).all()
    got = tk.ssnt_loss_expin_kernels(*map(torch.tensor, (*x, il, ol)))
    want = tlat.ssnt_loss(*map(torch.tensor, (le, ls, lf, il, ol)),
                          layout="ubt")
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5)


def test_jax_expin_clamp_cuts_posteriors():
    """JAX's _expin_bwd clamps the scalar exponent (M + N - logz etc.) at
    30, but between renormalizations qn and bn fall far below 1, so with
    frame log-likelihoods of spread 3 the exponent passes 30 and its
    chain-ruled gradients miss the log path's by up to 0.8 (on values in
    [-1, 0]). The port clamps the whole posterior exponent, as the log
    path does, and stays on it."""
    le, ls, lf = log_lattice(11, B=3, lf_std=3.0)
    il, ol = np.array([8, 6, 5], np.int32), np.array([24, 17, 11], np.int32)
    x = exp_inputs(le, ls, lf)
    _, jg = jax_value_and_grad(jpal.ssnt_loss_expin, x, il, ol, chunk=8)
    got, gg = torch_value_and_grad(tk.ssnt_loss_expin_kernels, x, il, ol)
    want, wg = torch_value_and_grad(tlat.ssnt_loss, (le, ls, lf), il, ol,
                                    layout="ubt")
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for p, j, g, w in zip(x, jg, gg, wg):
        assert np.abs(p * j - w).max() > 0.5
        np.testing.assert_allclose(p * g, w, rtol=1e-4, atol=1e-5)


def test_exp_domain_flushes_paths_far_below_the_column_best():
    """The exp domain's horizon, in JAX as in the port: with emit
    probability 1 and shift 1e-12 every path to the last source position
    lies ~400 nats below its columns' best cells, so it flushes to 0 and
    the loss is the 1e30 sentinel, where the log path stays finite. A
    saturated transition joint (one full-rate Adam step from random
    weights at full width) puts every utterance there."""
    Ul, Tl = 64, 16
    le = np.zeros((Ul, 1, Tl), np.float32)
    ls = np.full((Ul, 1, Tl), np.log(1e-12), np.float32)
    lf = np.random.default_rng(12).normal(0, 0.5, (Ul, 1, Tl)).astype(
        np.float32)
    il, ol = np.array([Tl], np.int32), np.array([Ul], np.int32)
    x = exp_inputs(le, ls, lf)
    got = tk.ssnt_loss_expin_kernels(*map(torch.tensor, (*x, il, ol)))
    want = np.asarray(jpal.ssnt_loss_expin(
        *map(jnp.asarray, x), jnp.asarray(il), jnp.asarray(ol), chunk=16))
    log_path = tlat.ssnt_loss(*map(torch.tensor, (le, ls, lf, il, ol)),
                              layout="ubt")
    assert float(got[0]) == want[0] == -NEG
    assert 87 < float(log_path[0]) < 1e4


# ------------------------------- #4, the exp-domain bidirectional pass


def test_bidir_exp_reference_matches_pallas():
    """(f) Alphas and betas against fused_alphas_betas_pallas_exp: -inf
    (a cell of probability 0, the degenerate example's) in the same
    places."""
    x = log_lattice(6)
    wa, wb = jpal.fused_alphas_betas_pallas_exp(
        *map(jnp.asarray, x), jnp.asarray(IL), jnp.asarray(OL), chunk=8)
    ga, gb = tk.lattice_bidir_exp(*map(torch.tensor, (*x, IL, OL)))
    assert np.isneginf(np.asarray(wb)[:, DEGENERATE]).any()
    assert_field_close(ga.numpy(), wa, atol=1e-5)
    assert_field_close(gb.numpy(), wb, atol=1e-5)


def test_exp_variant_matches_jax_and_log_path():
    """(g) ssnt_loss_kernels(variant="exp") against ssnt_loss_pallas(
    variant="exp") (+inf for the degenerate example in both), against the
    log path, and its no-grad value against the value under grad."""
    x = log_lattice(7)
    want, wg = jax_value_and_grad(jpal.ssnt_loss_pallas, x, IL, OL,
                                  variant="exp", layout="ubt", chunk=8)
    got, gg = torch_value_and_grad(tk.ssnt_loss_kernels, x, IL, OL,
                                   variant="exp", layout="ubt")
    assert got[DEGENERATE] == want[DEGENERATE] == np.inf
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for g, w, name in zip(gg, wg, ("emit", "shift", "frame")):
        assert not g[:, DEGENERATE].any()
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6, err_msg=name)
    log_loss, lg = torch_value_and_grad(tlat.ssnt_loss, x, IL, OL,
                                        layout="ubt")
    assert log_loss[DEGENERATE] == -NEG
    live = np.arange(len(IL)) != DEGENERATE
    np.testing.assert_allclose(got[live], log_loss[live], rtol=5e-4)
    for g, w, name in zip(gg, lg, ("emit", "shift", "frame")):
        np.testing.assert_allclose(g, w, rtol=5e-3, atol=5e-5, err_msg=name)
    with torch.no_grad():
        nograd = tk.ssnt_loss_kernels(*map(torch.tensor, (*x, IL, OL)),
                                      variant="exp", layout="ubt")
    np.testing.assert_array_equal(nograd.numpy(), got)


# ------------------------------------------- #3, the betas-only pass


def test_backward_betas_reference_matches_pallas():
    """(h) Betas against backward_betas_pallas, and bit for bit the
    bidirectional pass's betas."""
    x = log_lattice(8)
    want = jpal.backward_betas_pallas(*map(jnp.asarray, x), jnp.asarray(IL),
                                      jnp.asarray(OL), chunk=8)
    tx = [torch.tensor(a) for a in x]
    il, ol = torch.tensor(IL), torch.tensor(OL)
    got = tk.lattice_backward_betas(*tx, il, ol)
    masked = np.asarray(want) <= NEG / 2
    assert (got.numpy()[masked] <= NEG / 2).all()
    np.testing.assert_allclose(got.numpy()[~masked],
                               np.asarray(want)[~masked], rtol=1e-6,
                               atol=1e-5)
    _, bidir_betas = tk.lattice_bidir_reference(*tx, il, ol)
    assert torch.equal(got, bidir_betas)
