"""PyTorch port, lattices longer than 1024 source positions: the plain
versions of the lattice kernels (ops/lattice_kernels.py) held against the
Pallas kernels they replace, run interpreted on the CPU, at T = 1100 and
1500 (B = 2, U = 12, chunk 4), and the kernels' named source-length limit.

On the card every lattice kernel takes T up to lattice_kernels.MAX_T
(csrc/lattice.cu kMaxT: the block walks hold up to 8 positions a thread),
as JAX's Pallas walks take any T whose blocks fit VMEM. Tolerances are
those of tests/test_torch_lattice.py and tests/test_torch_lattice_exp.py:
lattice values rtol 1e-6 / atol 1e-5 (masked cells must stay masked), the
backward gradients rtol 1e-6 (float32) or one bf16 ulp (2^-7) with atol
1e-7, the exp-domain fields rtol 1e-5 (atol 1e-5 on logs and log
normalizers), -inf cells equal. Inputs are numpy-seeded. A path moves at
most one source position a column, so at U = 12 example 0 (il = T, ol =
U) has none: its alphas are finite below t = 12 and its betas above T -
13, the rest sums of NEG, and its gradients 0; example 1 (il = 10, ol =
U) has paths, a finite logZ and non-zero gradients."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssnt_tts_tpu.ops import lattice_pallas as jpal
from ssnt_tts_tpu_torch.ops import lattice as tlat
from ssnt_tts_tpu_torch.ops import lattice_kernels as tk

NEG = tlat.NEG
U, CHUNK = 12, 4
TS = (1100, 1500)


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jpal, "_INTERPRET", True)
    torch.set_num_threads(1)


def long_lattice(T, seed):
    """(le, ls, lf) (U, 2, T) float32 and lengths (il, ol) = (T, U) and
    (10, U)."""
    rng = np.random.default_rng(seed)
    le = np.log(rng.uniform(0.1, 0.9, (U, 2, T))).astype(np.float32)
    ls = np.log1p(-np.exp(le)).astype(np.float32)
    lf = rng.normal(0.0, 0.5, (U, 2, T)).astype(np.float32)
    il = np.array([T, 10], np.int32)
    ol = np.array([U, U], np.int32)
    return (le, ls, lf), il, ol


def assert_lattice_close(got, want, rtol=1e-6, atol=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    masked = want <= NEG / 2
    assert (got[masked] <= NEG / 2).all()
    np.testing.assert_allclose(got[~masked], want[~masked], rtol=rtol,
                               atol=atol)


def assert_field_close(got, want, rtol=1e-5, atol=0.0):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    finite = np.isfinite(want)
    assert np.isfinite(got[finite]).all()
    np.testing.assert_allclose(got[finite], want[finite], rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("T", TS)
def test_bidir_forward_and_betas_match_pallas_long(T):
    """#8 (lattice_bidir), #1 (forward alphas) and #3 (backward betas):
    against fused_alphas_betas_pallas, forward_alphas_pallas and
    backward_betas_pallas; #8's alphas and betas bit for bit #1's and
    #3's."""
    x, il, ol = long_lattice(T, T)
    jx = [jnp.asarray(a) for a in x]
    tx = [torch.tensor(a) for a in x]
    til, tol = torch.tensor(il), torch.tensor(ol)
    wa, wb = jpal.fused_alphas_betas_pallas(*jx, jnp.asarray(il),
                                            jnp.asarray(ol), chunk=CHUNK)
    ga, gb = tk.lattice_bidir(*tx, til, tol)
    assert_lattice_close(ga.numpy(), wa)
    assert_lattice_close(gb.numpy(), wb)
    fa = tk.lattice_forward_alphas(*tx)
    assert_lattice_close(fa.numpy(), jpal.forward_alphas_pallas(
        *jx, jnp.asarray(il), chunk=CHUNK))
    fb = tk.lattice_backward_betas(*tx, til, tol)
    assert_lattice_close(fb.numpy(), jpal.backward_betas_pallas(
        *jx, jnp.asarray(il), jnp.asarray(ol), chunk=CHUNK))
    assert torch.equal(ga, fa) and torch.equal(gb, fb)
    assert bool(ga[-1, 0, U - 1] > NEG / 2)
    assert bool(gb[0, 0, T - U] > NEG / 2)
    assert bool(ga[-1, 1, 9] > NEG / 2)  # example 1's last cell is reached


@pytest.mark.parametrize("T,dtype", [(t, d) for t in TS
                                     for d in ("float32", "bfloat16")])
def test_backward_grads_match_pallas_long(T, dtype):
    """#5 (lattice_backward_grads) against backward_grads_pallas, in the
    lattice's dtype."""
    x, il, ol = long_lattice(T, T + 1)
    tdt = getattr(torch, dtype)
    tx = [torch.tensor(a).to(tdt) for a in x]
    alphas = tk.lattice_forward_alphas(*tx)
    til, tol = torch.tensor(il), torch.tensor(ol)
    logz = tlat.gather_logz(alphas, tx[0], til, tol)
    g = torch.tensor([1.0, 0.75])
    want = jpal.backward_grads_pallas(
        *(jnp.asarray(a).astype(dtype) for a in x),
        *(jnp.asarray(a) for a in (alphas.numpy(), il, ol, g.numpy(),
                                   logz.numpy())), chunk=CHUNK)
    got = tk.lattice_backward_grads(*tx, alphas, til, tol, g, logz)
    tol_r = 1e-6 if dtype == "float32" else 2 ** -7
    for a, b in zip(got, want):
        assert a.dtype == tdt
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32), rtol=tol_r,
                                   atol=1e-7)
    assert float(got[2].float().abs().max()) > 0


@pytest.mark.parametrize("T", TS)
def test_exp_domain_passes_match_pallas_long(T):
    """#4 (lattice_bidir_exp) against fused_alphas_betas_pallas_exp and #9
    (lattice_expin) against fused_expin_pallas, at a U that is a multiple
    of the chunk (the port renormalizes #9 by global column)."""
    x, il, ol = long_lattice(T, T + 2)
    jil, jol = jnp.asarray(il), jnp.asarray(ol)
    wa, wb = jpal.fused_alphas_betas_pallas_exp(
        *map(jnp.asarray, x), jil, jol, chunk=CHUNK)
    ga, gb = tk.lattice_bidir_exp(*map(torch.tensor, (*x, il, ol)))
    assert_field_close(ga.numpy(), wa, atol=1e-5)
    assert_field_close(gb.numpy(), wb, atol=1e-5)
    le, ls, lf = x
    mcol = lf.max(axis=2)
    E, S = np.exp(le), np.exp(ls)
    F = np.exp(lf - mcol[:, :, None]).astype(np.float32)
    want = jpal.fused_expin_pallas(*map(jnp.asarray, (E, S, F, mcol)), jil,
                                   jol, chunk=CHUNK)
    got = tk.lattice_expin(*map(torch.tensor, (E, S, F, mcol, il, ol)))
    for g_, w_, atol in zip(got, want, (0.0, 0.0, 1e-5, 1e-5)):
        assert_field_close(g_.numpy(), w_, atol=atol)


def test_shape_check_names_the_limit():
    """The library-free check the wrappers make before a launch: it takes
    T = MAX_T (at least 8192) and refuses MAX_T + 1, T = 0 and U = 0 with a
    ValueError that names the limit and the shape; the same for a column
    of B * T past MAX_COLUMN (2^31 - 1: 32-bit offsets)."""
    assert tk.MAX_T >= 8192
    tk.check_shape(400, 2, tk.MAX_T)
    tk.check_shape(1, 1, 1)
    tk.check_shape(1, tk.MAX_COLUMN // tk.MAX_T, tk.MAX_T)
    for shape in ((400, 2, tk.MAX_T + 1), (400, 2, 0), (0, 2, 80)):
        with pytest.raises(ValueError, match=str(tk.MAX_T)) as err:
            tk.check_shape(*shape)
        assert f"T={shape[2]}" in str(err.value)
    B = tk.MAX_COLUMN // tk.MAX_T + 1
    with pytest.raises(ValueError, match=str(tk.MAX_COLUMN)) as err:
        tk.check_shape(1, B, tk.MAX_T)
    assert f"B={B}" in str(err.value)
    assert tk.MAX_COLUMN == 2**31 - 1
