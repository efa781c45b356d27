"""PyTorch port, distribution slice: the sharded train step over a 2x2
(data, model) mesh against JAX's make_sharded_train_step on a 2x2 mesh
and against the port's one-process train_step, with the T-sharded lattice
on and off; the four decodes over data shards; the dry run at 4 ranks.

The torch ranks run under gloo on the CPU, started by
ssnt_tts_tpu_torch.dryrun.launch (a file rendezvous under pytest's tmp
directory, 300 s deadline); JAX runs in this process on its 8 virtual
CPU devices (tests/conftest.py). Same flax weights, same numpy-seeded
global batch, whose ragged lengths give the two data shards different
token counts (the loss's normalizers are global).

Tolerances: JAX's own for a sharded step against one device
(tests/test_parallel.py): loss rtol 2e-4, parameters rtol 2e-3 / atol
2e-5; the T-shard on against off, rtol 1e-4 (tests/test_lattice_sharded.py).
The attention key bias's gradient is rounding noise (exactly 0 in exact
arithmetic; tests/test_torch_train.py), which Adam turns into steps of up
to ~lr/10: that leaf is held to atol 1e-4.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from ssnt_tts_tpu.models import SSNTModel as JaxModel
from ssnt_tts_tpu.parallel import mesh as jmesh_lib
from ssnt_tts_tpu.parallel import train as jtrain
from ssnt_tts_tpu.utils import config as jcfg
from ssnt_tts_tpu_torch import convert, dryrun
from ssnt_tts_tpu_torch.models.ssnt import token_mask
from ssnt_tts_tpu_torch.parallel import train as ttrain
from ssnt_tts_tpu_torch.utils import config as tcfg

B, T, U = 8, 8, 16
MESH = (2, 2)
STEPS = 2
LOSS_RTOL, PARAM_RTOL, PARAM_ATOL = 2e-4, 2e-3, 2e-5
TSHARD_RTOL = 1e-4
KEY_BIAS_ATOL = 1e-4


def _port_cfg(cfg, **over):
    return tcfg.ModelConfig(**{**dataclasses.asdict(cfg), **over})


@pytest.fixture(scope="module")
def setup():
    cfg = jcfg.tiny_model_config()
    batches = [dryrun.example_batch(cfg, B, T, U, seed=s)
               for s in range(STEPS)]
    jm = JaxModel(cfg)
    train_cfg = jcfg.TrainConfig(warmup_steps=2, batch_size=B)
    state = jtrain.init_train_state(jm, jax.random.PRNGKey(0), batches[0],
                                    train_cfg)
    return cfg, jm, train_cfg, batches, jax.device_get(state)


@pytest.fixture(scope="module")
def jax_sharded(setup):
    """JAX's make_sharded_train_step on a 2x2 mesh: losses and params."""
    cfg, jm, train_cfg, batches, state = setup
    mesh = jmesh_lib.make_mesh(jcfg.MeshConfig(*MESH),
                               devices=jax.devices()[:4])
    tx = jtrain.make_optimizer(train_cfg)
    step_fn, st = jtrain.make_sharded_train_step(jm, tx, mesh, state)
    losses = []
    for b in batches:
        st, m = step_fn(st, jax.device_put(b, jmesh_lib.data_sharding(mesh)))
        losses.append(float(m["loss"]))
    return losses, convert.flax_to_torch(jax.device_get(st.params), cfg)


@pytest.fixture(scope="module")
def port_single(setup):
    """The port's train_step in this process on the whole global batch."""
    cfg, _, train_cfg, batches, state = setup
    torch.set_num_threads(1)
    tc = tcfg.TrainConfig(**dataclasses.asdict(train_cfg))
    st = ttrain.init_train_state(_port_cfg(cfg), tc, params=state.params,
                                 device="cpu")
    tx = ttrain.make_optimizer(tc)
    losses = []
    for b in batches:
        st, m = ttrain.train_step(tx, st, {k: torch.from_numpy(v)
                                           for k, v in b.items()})
        losses.append(float(m["loss"]))
    return losses, {k: v.detach() for k, v in
                    st.model.state_dict().items()}


def _port_halves(setup, ring):
    """dryrun.split_step over the global batches: the port's one-process
    step over the two data ranks' row halves (the lattice on a one-rank
    ring when `ring`). grad_norms and the final parameters."""
    cfg, _, train_cfg, batches, state = setup
    torch.set_num_threads(1)
    tc = tcfg.TrainConfig(**dataclasses.asdict(train_cfg))
    st = ttrain.init_train_state(_port_cfg(cfg), tc, params=state.params,
                                 device="cpu")
    tx = ttrain.make_optimizer(tc)
    norms = []
    for b in batches:
        st, m = dryrun.split_step(
            tx, st, {k: torch.from_numpy(v) for k, v in b.items()},
            ring=ring)
        norms.append(float(m["grad_norm"]))
    return norms, {k: v.detach() for k, v in st.model.state_dict().items()}


@pytest.fixture(scope="module")
def port_halves(setup):
    return _port_halves(setup, ring=False)


@pytest.fixture(scope="module")
def port_halves_ring(setup):
    return _port_halves(setup, ring=True)


@pytest.fixture(scope="module")
def port_sharded(setup, tmp_path_factory):
    """The port's sharded step on 4 ranks (2x2), T-shard off and on."""
    cfg, _, train_cfg, batches, state = setup
    tc = tcfg.TrainConfig(**dataclasses.asdict(train_cfg))
    runs = [{"cfg": _port_cfg(cfg, lattice_tshard_min_cells=mc), "tcfg": tc,
             "params": state.params, "batches": batches}
            for mc in (None, 0)]
    return dryrun.launch("steps", {"mesh": MESH, "runs": runs}, 4,
                         tmp_path_factory.mktemp("steps"), device="cpu",
                         timeout=300)


def _losses(rank, run):
    return [s["metrics"]["loss"] for s in rank["runs"][run]["steps"]]


def _assert_params(got, want):
    for k, w in want.items():
        atol = KEY_BIAS_ATOL if k.endswith("attn.key.bias") else PARAM_ATOL
        np.testing.assert_allclose(np.asarray(got[k]), w.numpy(),
                                   rtol=PARAM_RTOL, atol=atol, err_msg=k)


def test_batch_spreads_tokens_unevenly(setup):
    """The premise: the two data shards hold different token counts, so a
    mean of per-rank losses would differ from the global loss."""
    for b in setup[3]:
        counts = [int(token_mask(torch.from_numpy(b["tokens"][rows]),
                                 torch.from_numpy(b["input_length"][rows]))
                      .sum()) for rows in (slice(0, B // 2),
                                           slice(B // 2, B))]
        assert counts[0] > 1.5 * counts[1], counts


@pytest.mark.parametrize("reference", ["jax_sharded", "port_single"])
def test_sharded_step_matches(port_sharded, reference, request):
    """Every rank's losses and updated parameters (T-shard off) against
    JAX's 2x2 sharded step and against the port's one-process step on the
    same global batch."""
    losses, params = request.getfixturevalue(reference)
    for rank in port_sharded:
        np.testing.assert_allclose(_losses(rank, 0), losses,
                                   rtol=LOSS_RTOL)
        _assert_params(rank["runs"][0]["params"], params)


def _assert_data_groups_sum(port_sharded, run, halves):
    norms, params = halves
    for rank in port_sharded:
        got = rank["runs"][run]
        assert [s["metrics"]["grad_norm"] for s in got["steps"]] == norms
        for k, v in params.items():
            np.testing.assert_array_equal(got["params"][k], v.numpy(),
                                          err_msg=k)


def test_sharded_step_is_the_data_groups_sum(port_sharded, port_halves):
    """T-shard off: every rank's parameters and grad_norm equal, bit for
    bit, the one-process step over the same two row halves (the data
    group's all_reduce adds the two halves' gradients as autograd's
    buffers do)."""
    _assert_data_groups_sum(port_sharded, 0, port_halves)


def test_tshard_on_is_the_data_groups_sum(port_sharded, port_halves_ring):
    """T-shard on: every rank's parameters and grad_norm equal, bit for
    bit, the one-process step over the same two row halves with its
    lattices on a one-rank ring: the two-shard ring's hops, group sum and
    all_gather change no bit of the loss or of the gradients it sends
    back into the model."""
    _assert_data_groups_sum(port_sharded, 1, port_halves_ring)


def test_tshard_on_matches_off(port_sharded, jax_sharded):
    """lattice_tshard_min_cells=0 (every lattice over the model axis's
    ring: T=8 in two shards) against None, and against JAX's step."""
    for rank in port_sharded:
        on, off = _losses(rank, 1), _losses(rank, 0)
        np.testing.assert_allclose(on, off, rtol=TSHARD_RTOL)
        np.testing.assert_allclose(on, jax_sharded[0], rtol=TSHARD_RTOL)
        _assert_params(rank["runs"][1]["params"], {
            k: torch.from_numpy(v) for k, v in
            rank["runs"][0]["params"].items()})


def test_ranks_agree_and_collectives_counted(port_sharded):
    """The parameters are equal on every rank (the data groups' sums and
    the model groups' whole-T lattice gradients); two all_reduces a step
    over the data group; with the T-shard on, one ring of U/K + n - 1
    hops each way, one group sum and one all_gather a step."""
    rank0 = port_sharded[0]
    for rank in port_sharded[1:]:
        for run, run0 in zip(rank["runs"], rank0["runs"]):
            for k, v in run0["params"].items():
                np.testing.assert_array_equal(run["params"][k], v,
                                              err_msg=k)
    assert [(r["data"], r["model"]) for r in port_sharded] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    for rank in port_sharded:
        for run, ring in zip(rank["runs"], (False, True)):
            for s in run["steps"]:
                assert s["all_reduces"] == 2
                hops = U // 16 + 2 - 1 if ring else 0
                assert s["ring"] == {
                    "hops_forward": hops, "hops_backward": hops,
                    "all_reduce": int(ring), "all_gather": int(ring)}


@pytest.fixture(scope="module")
def decodes(setup, tmp_path_factory):
    cfg, _, _, batches, state = setup
    job = {"mesh": MESH, "cfg": _port_cfg(cfg), "params": state.params,
           "batch": batches[0], "beam_width": 4, "max_frames": U}
    return dryrun.launch("decode", job, 4, tmp_path_factory.mktemp("dec"),
                         device="cpu", timeout=300)


@pytest.mark.parametrize("name", ["v2", "v2_plain", "tone", "v1"])
def test_decodes_over_data_shards(setup, decodes, name):
    """Each data rank decodes its rows with its beams rank-local; the
    rows gathered equal a one-process decode of the whole batch on the
    same route (integers exactly, floats to 1e-5)."""
    cfg, _, _, batches, state = setup
    model = dryrun.make_model(_port_cfg(cfg), state.params, 0, "cpu")
    b = {k: torch.from_numpy(v) for k, v in batches[0].items()}
    toks, il, ol = b["tokens"], b["input_length"], b["output_length"]
    with torch.no_grad():
        want = dryrun.decode_routes(model, toks, il, ol, 4, U)[name]()
    parts = decodes[::2]  # the model-axis 0 rank of each data rank
    assert [p["rows"] for p in parts] == [slice(0, B // 2), slice(B // 2, B)]
    for k, w in want.items():
        got = np.concatenate([p[name][k] for p in parts])
        w = w.numpy()
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(got, w, rtol=1e-5, atol=1e-5,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got, w, err_msg=k)
    for r in decodes:  # the model axis's replicas decode the same rows
        twin = next(p for p in parts if p["rows"] == r["rows"])
        for k, v in twin[name].items():
            np.testing.assert_array_equal(r[name][k], v, err_msg=k)


def test_dryrun_at_four_ranks(tmp_path):
    """dryrun.py's task on a 2x2 mesh: one sharded step, the four decodes,
    the T-sharded lattice against ops/lattice.ssnt_loss (asserted
    inside); every rank reports the same loss."""
    out = dryrun.launch("dryrun", {}, 4, tmp_path, device="cpu",
                        timeout=300)
    assert out[0]["mesh"] == {"data": 2, "model": 2}
    assert all(np.isfinite(r["loss"]) and r["loss"] == out[0]["loss"]
               for r in out)
    assert all("tshard" in r and "v1" in r for r in out)
