"""PyTorch port, lattice loss: the plain route (ops/lattice.py) held
against JAX ops.lattice and the fp64 C++ oracle, and each lattice kernel's
plain version (ops/lattice_kernels.py) held against the Pallas kernel it
replaces, run interpreted on the CPU. Inputs are numpy-seeded.

Tolerances: loss rtol 1e-5 and gradients rtol 1e-4 / atol 1e-6 are the
ones tests/test_lattice_pallas.py holds the Pallas kernels to (float32,
sums in another order); the C++ oracle's are those of
tests/test_cpp_oracle.py (float32 against float64). A kernel's plain
version repeats the kernel's operation order, so it is held tighter:
rtol 1e-6 on lattice values. Alphas and betas are compared where they are
finite; where the reference is a masked cell (<= NEG/2, a sum of NEG whose
exact value depends on the order of operations) the other must be too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssnt_tts_tpu.ops import lattice as jlat
from ssnt_tts_tpu.ops import lattice_pallas as jpal
from ssnt_tts_tpu.oracle import build as cpp
from ssnt_tts_tpu_torch.ops import lattice as tlat
from ssnt_tts_tpu_torch.ops import lattice_kernels as tk

NEG = tlat.NEG
# Ragged lengths with il = 1 / ol = 1 examples and one degenerate example
# (ol < il: no path reaches the last source position).
IL = [8, 5, 1, 6, 3, 8]
OL = [24, 13, 1, 4, 9, 17]
DEGENERATE = 3


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jpal, "_INTERPRET", True)
    torch.set_num_threads(1)


def rand_lattice(rng, B, T, U, layout="btu"):
    le = np.log(rng.uniform(0.1, 0.9, (B, T, U))).astype(np.float32)
    ls = np.log1p(-np.exp(le)).astype(np.float32)
    lf = rng.normal(0, 0.5, (B, T, U)).astype(np.float32)
    if layout == "ubt":
        return tuple(np.ascontiguousarray(x.transpose(2, 0, 1))
                     for x in (le, ls, lf))
    return le, ls, lf


def lengths(B, T, U, rng=None):
    if B == len(IL):
        return np.array(IL, np.int32), np.array(OL, np.int32)
    il = rng.integers(1, T + 1, B).astype(np.int32)
    ol = np.maximum(il, rng.integers(1, U + 1, B)).astype(np.int32)
    il[0], ol[0] = T, U
    il[1], ol[1] = 1, 1
    il[2], ol[2] = T, T - 1  # degenerate
    return il, ol


def jax_value_and_grad(fn, x, il, ol, **kw):
    loss, grads = jax.value_and_grad(
        lambda a, b, c: jnp.sum(fn(a, b, c, il, ol, **kw)),
        argnums=(0, 1, 2))(*x)
    per_ex = np.asarray(fn(*x, il, ol, **kw))
    return per_ex, [np.asarray(g, np.float32) for g in grads]


def torch_value_and_grad(fn, x, il, ol, **kw):
    xs = [torch.tensor(a, requires_grad=True) for a in x]
    loss = fn(*xs, torch.tensor(il), torch.tensor(ol), **kw)
    loss.sum().backward()
    return loss.detach().numpy(), [a.grad.float().numpy() for a in xs]


def assert_grads_close(got, want, rtol=1e-4, atol=1e-6):
    for g, w, name in zip(got, want, ("emit", "shift", "frame")):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=name)


def assert_lattice_close(got, want, rtol=1e-6, atol=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    masked = want <= NEG / 2
    assert (got[masked] <= NEG / 2).all()
    np.testing.assert_allclose(got[~masked], want[~masked], rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("layout", ["btu", "ubt"])
def test_ssnt_loss_matches_jax(layout):
    rng = np.random.default_rng(0)
    x = rand_lattice(rng, len(IL), 8, 24, layout)
    il, ol = np.array(IL, np.int32), np.array(OL, np.int32)
    want, wg = jax_value_and_grad(jlat.ssnt_loss, x, il, ol, layout=layout)
    got, gg = torch_value_and_grad(tlat.ssnt_loss, x, il, ol, layout=layout)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert_grads_close(gg, wg)
    # The degenerate example: loss -NEG, every gradient exactly 0.
    assert got[DEGENERATE] == -NEG
    b_axis = 0 if layout == "btu" else 1
    for g in gg:
        assert not np.take(g, DEGENERATE, axis=b_axis).any()


def test_ssnt_loss_reference_matches_jax():
    """Autograd through the column loop, against JAX's autodiff through
    its scan (non-degenerate lengths: there the two differ by design)."""
    rng = np.random.default_rng(1)
    x = rand_lattice(rng, 3, 6, 16)
    il, ol = np.array([6, 4, 1], np.int32), np.array([16, 9, 1], np.int32)
    want, wg = jax_value_and_grad(jlat.ssnt_loss_reference, x, il, ol)
    got, gg = torch_value_and_grad(tlat.ssnt_loss_reference, x, il, ol)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert_grads_close(gg, wg)
    _, ag = torch_value_and_grad(tlat.ssnt_loss, x, il, ol)
    assert_grads_close(ag, gg)  # analytic backward == autograd


@pytest.mark.parametrize("B,T,U,seed", [(1, 20, 50, 0), (4, 12, 40, 1)])
def test_ssnt_loss_matches_cpp_oracle(B, T, U, seed):
    rng = np.random.default_rng(seed)
    x = rand_lattice(rng, B, T, U)
    if B == 1:
        il, ol = np.array([T], np.int32), np.array([U], np.int32)
    else:
        il = np.array([12, 9, 11, 7], np.int32)
        ol = np.array([40, 30, 25, 18], np.int32)
    c_loss, *c_grads = cpp.ssnt_loss_grad(*x, il, ol)
    got, gg = torch_value_and_grad(tlat.ssnt_loss, x, il, ol)
    np.testing.assert_allclose(got, c_loss, rtol=2e-4, atol=2e-4)
    assert_grads_close(gg, c_grads, rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("exclude", [None, 0])
def test_duration_loss_matches_jax(exclude):
    rng = np.random.default_rng(2)
    B, T, D = 3, 5, 4
    table = (0, 1, 2, 4)
    logits = rng.normal(0, 1, (B, T, D)).astype(np.float32)
    log_h = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    il = np.array([5, 3, 4], np.int32)
    ol = np.array([9, 6, 11], np.int32)

    def jfn(h):
        return jlat.ssnt_duration_loss(h, table, il, ol, exclude_class=exclude)

    want = np.asarray(jfn(log_h))
    wg = np.asarray(jax.grad(lambda h: jnp.sum(jfn(h)))(log_h))
    h = torch.tensor(log_h, requires_grad=True)
    got = tlat.ssnt_duration_loss(h, table, torch.tensor(il),
                                  torch.tensor(ol), exclude_class=exclude)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5)
    np.testing.assert_allclose(h.grad.numpy(), wg, rtol=1e-4, atol=1e-6)


# ------------------------------------------ kernel plain versions vs Pallas

def _ubt_case(seed, B=16, T=8, U=16):
    """B*T = 128: one packed row, so the lane-packed kernel accepts it."""
    rng = np.random.default_rng(seed)
    x = rand_lattice(rng, B, T, U, "ubt")
    il, ol = lengths(B, T, U, rng)
    return x, il, ol


@pytest.mark.parametrize("packed", [True, False])
def test_bidir_reference_matches_pallas(packed):
    x, il, ol = _ubt_case(3)
    fn = (jpal.fused_alphas_betas_pallas_packed if packed
          else jpal.fused_alphas_betas_pallas)
    wa, wb = fn(*map(jnp.asarray, x), jnp.asarray(il), jnp.asarray(ol),
                chunk=8)
    ga, gb = tk.lattice_bidir(*map(torch.tensor, x), torch.tensor(il),
                              torch.tensor(ol))
    assert_lattice_close(ga.numpy(), wa)
    assert_lattice_close(gb.numpy(), wb)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_alphas_reference_matches_pallas(dtype):
    x, il, _ = _ubt_case(4)
    jx = [jnp.asarray(a).astype(dtype) for a in x]
    want = jpal.forward_alphas_pallas(*jx, jnp.asarray(il), chunk=8)
    tx = [torch.tensor(a).to(getattr(torch, dtype)) for a in x]
    got = tk.lattice_forward_alphas(*tx)
    assert got.dtype == torch.float32
    assert_lattice_close(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_grads_reference_matches_pallas(dtype):
    x, il, ol = _ubt_case(5)
    rng = np.random.default_rng(6)
    tdt = getattr(torch, dtype)
    tx = [torch.tensor(a).to(tdt) for a in x]
    alphas = tk.lattice_forward_alphas(*tx)
    logz = tlat.gather_logz(alphas, tx[0], torch.tensor(il),
                            torch.tensor(ol))
    g = torch.tensor(rng.uniform(0.5, 2.0, len(il)).astype(np.float32))
    want = jpal.backward_grads_pallas(
        *(jnp.asarray(a).astype(dtype) for a in x),
        *(jnp.asarray(a) for a in (alphas.numpy(), il, ol, g.numpy(),
                                   logz.numpy())),
        chunk=8)
    got = tk.lattice_backward_grads(*tx, alphas, torch.tensor(il),
                                    torch.tensor(ol), g, logz)
    for a, b in zip(got, want):
        assert a.dtype == tdt
        # Same operations in the same order: equal, up to one ulp of the
        # exp/log1p implementations (one bfloat16 ulp after rounding).
        tol = 1e-6 if dtype == "float32" else 2 ** -7
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32),
                                   rtol=tol, atol=1e-7)
    assert not any(d[:, 2].float().any() for d in got)  # degenerate


@pytest.mark.parametrize("variant", ["fusedpack", "plain", "bf16"])
def test_ssnt_loss_kernels_matches_pallas(variant):
    x, il, ol = _ubt_case(7)
    want, wg = jax_value_and_grad(jpal.ssnt_loss_pallas, x, il, ol,
                                  variant=variant, layout="ubt", chunk=8)
    got, gg = torch_value_and_grad(tk.ssnt_loss_kernels, x, il, ol,
                                   variant=variant, layout="ubt")
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # bf16: gradients are stored in bfloat16 by both; one bf16 ulp
    # (2^-7 relative) apart at most.
    assert_grads_close(gg, wg, rtol=2 ** -7 if variant == "bf16" else 1e-4)
    assert all(not g[:, 2].any() for g in gg)  # degenerate: exactly 0


@pytest.mark.parametrize("variant", ["log", "plain"])
def test_kernel_route_matches_plain_route(variant):
    """Both kernel routes (bidirectional + posterior pass; forward +
    backward-gradients walk) against ops.lattice on the CPU."""
    rng = np.random.default_rng(8)
    x = rand_lattice(rng, len(IL), 8, 24)
    il, ol = np.array(IL, np.int32), np.array(OL, np.int32)
    want, wg = torch_value_and_grad(tlat.ssnt_loss, x, il, ol)
    got, gg = torch_value_and_grad(tk.ssnt_loss_kernels, x, il, ol,
                                   variant=variant)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert_grads_close(gg, wg)
    with torch.no_grad():  # the no-grad forward: forward alphas only
        nograd = tk.ssnt_loss_kernels(*map(torch.tensor, x),
                                      torch.tensor(il), torch.tensor(ol),
                                      variant=variant)
    np.testing.assert_array_equal(nograd.numpy(), got)


@pytest.mark.parametrize("variant,B,T", [
    ("log", 32, 80), ("log", 64, 128), ("log", 65, 128), ("log", 256, 80),
    ("log", 3, 7), ("plain", 32, 80), ("fused", 256, 80),
    ("fusedpack", 32, 80), ("bf16", 32, 80), ("exp", 32, 80),
    ("banded", 32, 80), ("banded4", 256, 80), ("banded16", 3, 7),
])
def test_grad_mode_routes_like_jax(variant, B, T):
    mode, K = jpal._grad_mode(variant, B, T)
    want = {"fused": "fused", "fusedpack": "fused", "exp": "exp",
            "banded": "banded"}.get(mode, "plain")
    assert tk.grad_mode(variant, B, T) == (want, K)


def test_queued_variants_raise():
    """No variant is queued any more: a K outside (2, 4, 8, 16) raises
    ValueError (JAX asserts a power of two, so it admits "banded32" but
    never names it), as does an unknown variant."""
    for v in ("banded3", "banded32", "bandedx", "nonsense"):
        with pytest.raises(ValueError):
            tk.grad_mode(v, 32, 80)


def test_wrappers_take_cpu_or_cuda_only():
    x = [torch.zeros(4, 2, 3, device="meta") for _ in range(3)]
    lens = [torch.ones(2, dtype=torch.int32, device="meta")] * 2
    before = [k.launches for k in tk.KERNELS]
    calls = {
        tk.lattice_forward_alphas: lambda *a: tk.lattice_forward_alphas(*a),
        tk.lattice_forward_alphas_banded:
            lambda *a: tk.lattice_forward_alphas_banded(*a, 2),
        tk.lattice_backward_grads_banded:
            lambda le, ls, lf: tk.lattice_backward_grads_banded(
                le, ls, lf, le, *lens, le[0, :, 0], le[0, :, 0], 4),
    }
    assert set(calls) <= set(tk.KERNELS)
    for call in calls.values():
        with pytest.raises(ValueError, match="cuda or cpu"):
            call(*x)
    tk.lattice_forward_alphas(*(torch.zeros(4, 2, 3) for _ in range(3)))
    tk.lattice_forward_alphas_banded(*(torch.zeros(4, 2, 3)
                                       for _ in range(3)), 4)
    with pytest.raises(ValueError, match="K=3"):
        tk.lattice_forward_alphas_banded(*(torch.zeros(4, 2, 3)
                                           for _ in range(3)), 3)
    # The plain versions on CPU tensors are not kernel launches.
    assert [k.launches for k in tk.KERNELS] == before
