"""PyTorch port, the scaling tools: scripts/tshard_bench (the T-sharded
ring on 2 gloo CPU ranks: its hop counts against JAX's formula, K * B * 4
bytes a hop, its loss and gradients against JAX's unsharded
lattice.ssnt_loss on the same numpy lattice), scripts/weak_scaling_triage
(its B, H and I arms against JAX's model.loss, its lattice gradient and
its lattice_quantities-sum gradient at tiny_model_config, its G arm
against two optax updates, and its record on 2 ranks) and
scripts/weak_scaling_proof (n = 1 and 2 at a fixed total batch: the
summed FLOPs equal, a rank's count halving with its batch). Each tool's
ranks are spawned once for the module. Records keep JAX's keys.

Tolerances: the ring against JAX 1e-4 (loss and gradients); losses rtol
1e-5 and gradients within 5e-5 of each leaf's largest entry (+1e-6), as
tests/test_torch_train.py; lattice gradients rtol 1e-4 / atol 1e-5, as
tests/test_torch_lattice_sharded.py; parameters after the updates atol
2e-6, as test_torch_train.py's three steps."""

import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ssnt_tts_tpu.models import SSNTModel as JaxModel
from ssnt_tts_tpu.ops import lattice as jlattice
from ssnt_tts_tpu.parallel import train as jtrain
from ssnt_tts_tpu.utils import config as jcfg
from ssnt_tts_tpu_torch import convert
from ssnt_tts_tpu_torch.models.ssnt import SSNTModel
from ssnt_tts_tpu_torch.parallel import train as ttrain
from ssnt_tts_tpu_torch.scripts import tshard_bench, weak_scaling_proof
from ssnt_tts_tpu_torch.scripts import weak_scaling_triage as triage
from ssnt_tts_tpu_torch.utils import config as tcfg

ROOT = pathlib.Path(__file__).resolve().parents[1]
U_R, B_R, T_R = 24, 2, 8  # the ring's lattice
BLOCKS = (1, 4, 6)
B, T, U = 4, 6, 12  # the triage's batch
KEY_BIAS = "encoder.blocks.0.attn.key.bias"


def _keys(path):
    return json.loads((ROOT / path).read_text())


def _assert_dicts_close(got, want, rel=5e-5, atol=1e-6):
    """Each leaf within rel * (its largest entry) + atol."""
    assert set(got) == set(want)
    for k, w in want.items():
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(w), rtol=0,
                                   atol=rel * scale + atol, err_msg=k)


# ------------------------------------------------------------ tshard_bench


@pytest.fixture(scope="module")
def tshard(tmp_path_factory):
    torch.set_num_threads(1)
    work = tmp_path_factory.mktemp("tshard")
    got = {}
    rec = tshard_bench.main(
        ["--cpu", "--devices", "2", "--shape", str(U_R), str(B_R), str(T_R),
         "--blocks", *map(str, BLOCKS), "5", "--steps", "1", "--job-dir",
         str(work / "job"), "--json", str(work / "tshard.json")],
        outputs=got)
    return rec, got, work


def test_tshard_record(tshard):
    """JAX's script's keys; blocks that do not divide U skipped; hops a
    walk U/K + n - 1 (U at K = 1, JAX's formula), one group sum a
    forward, K * B * 4 bytes a hop; the bare-hop arm beside them."""
    rec, _, work = tshard
    assert list(rec) == ["shape", "platform", "unsharded_xla_ms",
                         "comm_structure_note", "note", "runs"]
    assert json.loads((work / "tshard.json").read_text()) == rec
    want_run = set(_keys("TSHARD_r05.json")["runs"][0])
    assert [r["block"] for r in rec["runs"]] == list(BLOCKS)
    for r in rec["runs"]:
        assert want_run <= set(r)
        blk = r["block"]
        assert r["shards"] == 2
        assert r["ppermutes_per_fwd"] == (
            U_R // blk + (2 - 1 if blk > 1 else 0))
        assert r["psums_per_fwd"] == 1
        assert r["bytes_per_hop"] == blk * B_R * 4
        assert r["ms_per_grad"] > 0 and r["bare_hop_ms"] > 0
        assert r["hops_ms"] == pytest.approx(
            2 * r["ppermutes_per_fwd"] * r["bare_hop_ms"], rel=1e-2)


def test_tshard_ring_matches_jax(tshard):
    """Every block's ring loss and gradients, and the unsharded baseline,
    against JAX's unsharded lattice.ssnt_loss on the same lattice."""
    _, got, _ = tshard
    x = got["inputs"]
    il, ol = jnp.asarray(x["il"]), jnp.asarray(x["ol"])
    loss_fn = lambda a, b, c: jlattice.ssnt_loss(a, b, c, il, ol,
                                                 layout="ubt")
    xs = [jnp.asarray(x[k]) for k in ("le", "ls", "lf")]
    want = np.asarray(loss_fn(*xs))
    want_g = jax.grad(lambda *a: jnp.sum(loss_fn(*a)), argnums=(0, 1, 2))(
        *xs)
    loss, grads = got["unsharded"]
    cases = [(loss.numpy(), [g.numpy() for g in grads])] + [
        (r["loss"], r["grads"]) for r in got["runs"]]
    assert len(cases) == 1 + len(BLOCKS)
    for loss, grads in cases:
        np.testing.assert_allclose(loss, want, rtol=0, atol=1e-4)
        for g, w in zip(grads, want_g):
            np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-4)


# ---------------------------------------------------------------- triage


@pytest.fixture(scope="module")
def flax_model():
    """JAX's tiny model at JAX's init and a port model on its weights, and
    the triage's batch (JAX's _example_batch)."""
    torch.set_num_threads(1)
    cfg = jcfg.tiny_model_config()
    jm = JaxModel(cfg)
    batch = triage.example_batch(tcfg.ModelConfig(**dataclasses.asdict(cfg)),
                                 B, T, U)
    jb = [jnp.asarray(batch[k]) for k in triage.LOSS_KEYS]
    dd = jnp.zeros((B, T), jnp.int32)  # targets, so every head is made
    params = jax.device_get(jax.jit(lambda k, *a: jm.init(
        k, *a, method=jm.loss))(jax.random.PRNGKey(0), *jb, dd, dd))
    tm = SSNTModel(tcfg.ModelConfig(**dataclasses.asdict(cfg)), device="cpu")
    tm.load_state_dict(convert.flax_to_torch(params, cfg))
    return cfg, jm, params, tm, batch, jb


def _named(model, tensors):
    return {n: t.detach() for (n, _), t in zip(model.named_parameters(),
                                               tensors)}


def test_triage_forward_arm_matches_jax(flax_model):
    """Arm B: the loss of the batch, as JAX's model.loss without targets."""
    cfg, jm, params, tm, batch, jb = flax_model
    want, _ = jax.jit(lambda p, *a: jm.apply(p, *a, None, None,
                                             method=jm.loss))(params, *jb)
    with torch.no_grad():
        got = triage.forward_loss(tm, {k: torch.from_numpy(v)
                                       for k, v in batch.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_triage_lattice_arm_matches_jax():
    """Arm H: the lattice gradient (the model's lattice route, plain on the
    CPU) against jax.grad of JAX's lattice.ssnt_loss on JAX's columns."""
    cfg = tcfg.ModelConfig(**dataclasses.asdict(jcfg.tiny_model_config()))
    cols = triage.lattice_columns(U, B, T)
    want = jax.grad(lambda *a: jnp.sum(jlattice.ssnt_loss(*a, layout="ubt")),
                    argnums=(0, 1, 2))(*map(jnp.asarray, cols))
    got = triage.lattice_grads(cfg, *map(torch.from_numpy, cols))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)


def test_triage_quantity_arm_matches_jax(flax_model):
    """Arm I: the gradient of sum(le + ls + lf) from lattice_quantities
    (JAX's script's surrogate loss)."""
    cfg, jm, params, tm, batch, jb = flax_model

    def loss_fn(p):
        enc = jm.apply(p, jb[0], jb[2], method=jm.encode)
        dec = jm.apply(p, jb[1], method=jm.decoder_states)
        le, ls, lf = jm.apply(p, enc, dec, jb[1],
                              method=jm.lattice_quantities)
        return jnp.sum(le) + jnp.sum(ls) + jnp.sum(lf)

    want = convert.flax_to_torch(
        jax.device_get(jax.jit(jax.grad(loss_fn))(params)), cfg)
    got = _named(tm, triage.quantity_grads(tm, {
        k: torch.from_numpy(v) for k, v in batch.items()}))
    # Zero in exact arithmetic (softmax ignores a constant added to every
    # score of a query): both frameworks give rounding noise there, as
    # tests/test_torch_train.py's KEY_BIAS.
    for side in (got, want):
        assert float(side.pop(KEY_BIAS).abs().max()) < 1e-4
    _assert_dicts_close({k: v.numpy() for k, v in got.items()},
                        {k: v.numpy() for k, v in want.items()})


def test_triage_optimizer_arm_matches_optax(flax_model):
    """Arm G: two ClipAdamW updates on 1e-3 gradients (the second at a
    learning rate above 0) against JAX's optimizer and apply_updates."""
    cfg, _, params, _, _, _ = flax_model
    tc = jcfg.TrainConfig(warmup_steps=2)
    jtx = jtrain.make_optimizer(tc)
    jp, jos = params, jtx.init(params)
    grads = jax.tree_util.tree_map(lambda x: jnp.full_like(x, 1e-3), params)
    tm = SSNTModel(tcfg.ModelConfig(**dataclasses.asdict(cfg)), device="cpu")
    tm.load_state_dict(convert.flax_to_torch(params, cfg))
    tx = ttrain.make_optimizer(tcfg.TrainConfig(**dataclasses.asdict(tc)))
    ps = [p.detach() for p in tm.parameters()]
    os_ = tx.init(ps)
    @jax.jit
    def jupdate(p, o):
        upd, o = jtx.update(grads, o, p)
        return optax.apply_updates(p, upd), o

    for _ in range(2):
        jp, jos = jupdate(jp, jos)
        triage.optimizer_update(tx, [torch.full_like(p, 1e-3) for p in ps],
                                os_, ps)
    want = convert.flax_to_torch(jax.device_get(jp), cfg)
    init = convert.flax_to_torch(params, cfg)
    assert all(not torch.equal(want[k], init[k]) for k in want)
    _assert_dicts_close({k: v.numpy() for k, v in _named(tm, ps).items()},
                        {k: v.numpy() for k, v in want.items()}, rel=0,
                        atol=2e-6)


@pytest.fixture(scope="module")
def triage_run(tmp_path_factory):
    torch.set_num_threads(1)
    work = tmp_path_factory.mktemp("triage")
    got = {}
    rec = triage.main(
        ["--cpu", "--devices", "2", "--per-device-batch", "2", "--seq",
         str(T), str(U), "--steps", "1", "--job-dir", str(work / "job"),
         "--json", str(work / "triage.json")], outputs=got)
    return rec, got, work


def test_triage_record(triage_run):
    """JAX's keys (and the card line), every experiment's keys as JAX's;
    C's parameter count the tiny model's (JAX's record: 56303)."""
    rec, got, work = triage_run
    want = _keys("WEAKSCALE_TRIAGE_r04.json")
    assert list(rec) == ["devices", "seq", "per_device_batch", "platform",
                         "experiments"]
    assert set(rec) - {"platform"} == set(want)
    assert list(rec["experiments"]) == list(want["experiments"])
    for arm, keys in want["experiments"].items():
        assert list(rec["experiments"][arm]) == list(keys), arm
    assert rec["experiments"]["C_allreduce"]["param_count"] == \
        want["experiments"]["C_allreduce"]["param_count"]
    assert json.loads((work / "triage.json").read_text()) == rec
    assert len(got["sharded"]) == 2 and len(got["unsharded"]) == 1
    assert set(got["sharded"][0]) == set(triage.ARMS)
    assert set(got["unsharded"][0]) == set(triage.UNSHARDED_ARMS)


# ----------------------------------------------------------------- proof


@pytest.fixture(scope="module")
def proof_run(tmp_path_factory):
    torch.set_num_threads(1)
    work = tmp_path_factory.mktemp("proof")
    got = {}
    rec = weak_scaling_proof.main(
        ["--cpu", "--devices", "1", "2", "--per-device-batch", "2", "--seq",
         str(T), str(U), "--steps", "1", "--job-dir", str(work / "job")],
        outputs=got)
    return rec, got


def test_proof_total_flops_constant(proof_run):
    """The summed FLOPs at n = 2 within 1e-3 of n = 1's; a rank's count
    halves when its batch halves; 2 all_reduces a step; the same loss."""
    rec, got = proof_run
    one, two = rec["runs"]
    assert (one["devices"], two["devices"]) == (1, 2)
    assert abs(two["total_flops_vs_unsharded"] - 1) < 1e-3
    assert one["per_device_flops"] > 0
    assert one["per_device_flops"] == 2 * two["per_device_flops"]
    assert [r["flops"] for r in got[2]] == [two["per_device_flops"]] * 2
    assert one["allreduce_ops"] == two["allreduce_ops"] == 2
    np.testing.assert_allclose(got[2][0]["loss"], got[1][0]["loss"],
                               rtol=1e-5)


def test_proof_record(proof_run):
    """JAX's keys; each run's keys JAX's, its HLO count renamed to the
    port's allreduce_ops."""
    rec, _ = proof_run
    want = _keys("WEAKSCALE_PROOF_r05.json")
    assert list(rec) == list(want)
    run_keys = [k if k != "allreduce_ops_in_hlo" else "allreduce_ops"
                for k in want["runs"][0]]
    assert all(list(r) == run_keys for r in rec["runs"])
    assert rec["total_batch"] == 4 and "ctypes" in rec["method"]


@pytest.mark.parametrize("tool", [tshard_bench, triage, weak_scaling_proof])
def test_no_card_raises(tool):
    """Without --cpu each tool runs on the card; with none it raises before
    it spawns a rank."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main([])
