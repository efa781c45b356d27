"""PyTorch port: parameter storage split over the mesh's "model" axis.

JAX's make_sharded_train_step places the parameters by
parallel/mesh.param_sharding: every flax leaf of ndim >= 2 whose last dim
the model-axis size m divides (and is >= m) splits that dim into m
contiguous blocks, block i on model index i; the rest is replicated. The
port stores its parameters the same way (parallel/mesh.param_sharding,
parallel/train.ParamShard), in the torch layout that convert.flax_to_torch
gives each leaf.

- Placement: for every leaf at m = 1, 2, 4 and two widths, the port's
  owner map equals the device placement JAX's NamedSharding gives
  (devices_indices_map on conftest's 8 virtual CPU devices, mapped
  through convert); the edge cases written out by hand.
- Stored elements: each rank's stored elements are exactly JAX's shard of
  each leaf on that model index (sorted values, per parameter), and their
  bytes the count (smoke and flagship widths: the numbers below).
- Sharded steps: 2x2 and 1x4 meshes on gloo (dryrun.launch), the
  T-sharded ring on and off, bit for bit the one-process step with whole
  parameters (dryrun.split_step over the data ranks' rows; train_step at
  1x4) and within tests/test_torch_parallel.py's tolerances of JAX's 2x2
  make_sharded_train_step; one all_gather and two all_reduces a step.
- Checkpoints: run_training over 1x2 saves whole tensors; they restore
  into one device and into a 2x2 rank's split storage bit for bit, and a
  resumed step runs on one device and on 2x2 (whose every rank joins the
  save's gather) equal to the one-process step.
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
from ssnt_tts_tpu_torch import data as data_lib
from ssnt_tts_tpu_torch.parallel import mesh as mesh_lib
from ssnt_tts_tpu_torch.parallel import train as ttrain
from ssnt_tts_tpu_torch.train_loop import run_training
from ssnt_tts_tpu_torch.utils import checkpoint as tckpt
from ssnt_tts_tpu_torch.utils import config as tcfg

WIDTHS = {"tiny": tcfg.tiny_model_config(), "smoke": dryrun.FULL_CONFIG,
          "flagship": tcfg.ModelConfig()}
# Bytes of float32 parameters a rank stores (every whole parameter and
# its block of each split one), by JAX's rule over the flax leaves.
STORED = {("smoke", 2): 8_514_596, ("smoke", 4): 4_301_860,
          ("flagship", 2): 11_749_412, ("flagship", 4): 5_929_508}
B, T, U = 8, 8, 16
STEPS = 2
# tests/test_torch_parallel.py's tolerances against JAX's 2x2 step.
LOSS_RTOL, PARAM_RTOL, PARAM_ATOL, KEY_BIAS_ATOL = 2e-4, 2e-3, 2e-5, 1e-4


def _fake_mesh(m: int, i: int) -> mesh_lib.Mesh:
    """Model index i of a 1 x m mesh, without a process group (ParamShard
    needs one only to gather)."""
    return mesh_lib.Mesh(shape={"data": 1, "model": m}, rank=i,
                         device=torch.device("cpu"), backend="none",
                         groups={"data": None, "model": None},
                         ranks={"data": (i,), "model": tuple(range(m))})


def _tree_items(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _tree_items(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _jax_layout(cfg, m):
    """JAX's param_sharding on a 1 x m mesh of the flax tree's leaves:
    {path: (leaf, NamedSharding)}, and the mesh's devices in model
    order."""
    mesh = jmesh_lib.make_mesh(jcfg.MeshConfig(1, m),
                               devices=jax.devices()[:m])
    params = convert.random_flax_tree(cfg, 0)["params"]
    specs = dict(_tree_items(jmesh_lib.param_sharding(mesh, params)))
    return ({p: (leaf, specs[p]) for p, leaf in _tree_items(params)},
            list(mesh.devices[0]))


def _jax_owners(cfg, m):
    """Each flax leaf's owner ids from JAX's placement: the model index
    whose device holds the element, -1 where every device holds it."""
    layout, devices = _jax_layout(cfg, m)
    out = {}
    for path, (leaf, sharding) in layout.items():
        owners = np.full(leaf.shape, -1, np.int16)
        if not sharding.is_fully_replicated:
            where = sharding.devices_indices_map(leaf.shape)
            for i, d in enumerate(devices):
                owners[where[d]] = i
        out[path] = owners
    return out


@pytest.mark.parametrize("m", [1, 2, 4])
@pytest.mark.parametrize("width", ["tiny", "smoke"])
def test_owner_map_is_jax_placement(width, m):
    cfg = WIDTHS[width]
    jax_owners = _jax_owners(cfg, m)
    port = mesh_lib.param_sharding(m, cfg)
    split = 0
    for key, paths, fn in convert._mapping(cfg):
        want = np.asarray(fn(*(jax_owners[p] for p in paths)))
        if port[key] is None:
            assert (want == -1).all(), key
        else:
            split += 1
            np.testing.assert_array_equal(port[key], want, err_msg=key)
    assert set(port) == {k for k, _, _ in convert._mapping(cfg)}
    assert split == 0 if m == 1 else split > 0


@pytest.mark.parametrize("m", [2, 4])
def test_owner_map_edge_cases(m):
    """The torch layouts written out at the smoke width (He = H = 256,
    4 heads of 64, 10 duration and 8 tone classes)."""
    owners = mesh_lib.param_sharding(m, WIDTHS["smoke"])
    blk = lambda n: np.arange(n) // (n // m)
    # (256, 2) and (256, 10) flax kernels: split at m=2 only.
    for key, rows in (("transition.enc_bias.weight", 2),
                      ("transition.dec_bias.weight", 2),
                      ("duration_head.out.weight", 10),
                      ("duration_ar.out.weight", 10)):
        if m == 2:
            np.testing.assert_array_equal(
                owners[key], np.repeat(blk(rows)[:, None], 256, 1), key)
        else:
            assert owners[key] is None, key
    np.testing.assert_array_equal(  # (256, 8): splits at 4 too
        owners["tone_head.out.weight"], np.repeat(blk(8)[:, None], 256, 1))
    # attention q/k/v: hd/m rows of every head; their (heads, hd) biases
    # too; the out kernel (heads, hd, E) on torch rows.
    per_head = np.tile(blk(64), 4)
    att = "encoder.blocks.0.attn"
    for name in ("query", "key", "value"):
        np.testing.assert_array_equal(
            owners[f"{att}.{name}.weight"],
            np.repeat(per_head[:, None], 256, 1))
        np.testing.assert_array_equal(owners[f"{att}.{name}.bias"],
                                      per_head)
    np.testing.assert_array_equal(owners[f"{att}.out.weight"],
                                  np.repeat(blk(256)[:, None], 256, 1))
    # GRU: one column block of each gate [r|z|n]; the embedding on dim 1;
    # Conv1d (out, in, k) on dim 0; Dense on torch dim 0.
    np.testing.assert_array_equal(owners["ar_cell.cell.wi"],
                                  np.broadcast_to(np.tile(blk(256), 3),
                                                  (256, 768)))
    np.testing.assert_array_equal(owners["ar_cell.cell.wh"],
                                  owners["ar_cell.cell.wi"])
    np.testing.assert_array_equal(owners["encoder.embed"],
                                  np.broadcast_to(blk(256), (128, 256)))
    np.testing.assert_array_equal(
        owners["encoder.prenet.convs.0.weight"],
        np.broadcast_to(blk(256)[:, None, None], (256, 256, 5)))
    np.testing.assert_array_equal(owners["encoder.blocks.0.ff.fc1.weight"],
                                  np.repeat(blk(1024)[:, None], 256, 1))
    for key in ("ar_cell.cell.bi", "ar_cell.cell.bhn", "frame.log_sigma",
                "encoder.norm.weight", "encoder.blocks.0.ff.fc1.bias",
                f"{att}.out.bias"):
        assert owners[key] is None, key


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("width", ["tiny", "smoke", "flagship"])
def test_each_rank_stores_its_jax_shard(width, m):
    cfg = WIDTHS[width]
    layout, devices = _jax_layout(cfg, m)
    mapping = {key: paths for key, paths, _ in convert._mapping(cfg)}
    tree = {"params": {}}
    shards = {}  # path -> the leaf's block on each model index
    for path, (leaf, sharding) in layout.items():
        arr = jax.device_put(leaf, sharding)
        by_dev = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
        shards[path] = [by_dev[d] for d in devices]
        node = tree["params"]
        *dirs, name = path.split("/")
        for d in dirs:
            node = node.setdefault(d, {})
        node[name] = leaf
    sd = convert.flax_to_torch(tree, cfg)
    for i in range(m):
        model = ttrain.SSNTModel(cfg, device="cpu")
        model.load_state_dict(sd)
        shard = ttrain.ParamShard(model, _fake_mesh(m, i))
        split = {n for n, _ in shard.params}
        want_bytes = sum(shards[p][i].nbytes for p in layout)
        got_bytes = sum(p.numel() * p.element_size()
                        for p in model.parameters())
        assert got_bytes == want_bytes
        if (width, m) in STORED:
            assert got_bytes == STORED[width, m]
        for n, p in model.named_parameters():
            want = np.concatenate([shards[q][i].ravel() for q in mapping[n]])
            if n in split:
                assert p.dim() == 1
                np.testing.assert_array_equal(np.sort(p.detach().numpy()),
                                              np.sort(want), err_msg=n)
            else:
                np.testing.assert_array_equal(p.detach().numpy(), sd[n],
                                              err_msg=n)
                assert want.size == p.numel(), n


# ------------------------------------------------------- sharded steps


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


MESHES = [((2, 2), None), ((2, 2), 0), ((1, 4), None), ((1, 4), 0)]


@pytest.fixture(scope="module")
def port_steps(setup, tmp_path_factory):
    """The port's sharded steps on 4 gloo ranks: 2x2 and 1x4, the
    T-sharded ring off (None) and on (0)."""
    cfg, _, train_cfg, batches, state = setup
    tc = tcfg.TrainConfig(**dataclasses.asdict(train_cfg))
    runs = [{"cfg": _port_cfg(cfg, lattice_tshard_min_cells=mc), "tcfg": tc,
             "params": state.params, "batches": batches, "mesh": mesh}
            for mesh, mc in MESHES]
    return dryrun.launch("steps", {"mesh": (2, 2), "runs": runs}, 4,
                         tmp_path_factory.mktemp("steps"), device="cpu",
                         timeout=300)


def _one_process(setup, step):
    cfg, _, train_cfg, batches, state = setup
    torch.set_num_threads(1)
    tc = tcfg.TrainConfig(**dataclasses.asdict(train_cfg))
    st = ttrain.init_train_state(_port_cfg(cfg), tc, params=state.params,
                                 device="cpu")
    tx = ttrain.make_optimizer(tc)
    norms = []
    for b in batches:
        st, m = step(tx, st, {k: torch.from_numpy(v) for k, v in b.items()})
        norms.append(float(m["grad_norm"]))
    return norms, {k: v.detach() for k, v in st.model.state_dict().items()}


REFERENCES = {
    ((2, 2), None): lambda tx, st, b: dryrun.split_step(tx, st, b),
    ((2, 2), 0): lambda tx, st, b: dryrun.split_step(tx, st, b, ring=True),
    ((1, 4), None): ttrain.train_step,
    ((1, 4), 0): lambda tx, st, b: dryrun.split_step(tx, st, b, ring=True,
                                                     parts=1),
}


@pytest.mark.parametrize("run", range(len(MESHES)),
                         ids=[f"{d}x{m}-ring-{'on' if r == 0 else 'off'}"
                              for (d, m), r in MESHES])
def test_split_storage_step_is_the_whole_step(setup, port_steps, run):
    """Every rank's grad_norms and final (gathered) parameters equal the
    one-process step with whole parameters, bit for bit; each rank stores
    its block only; one all_gather and two all_reduces a step."""
    norms, params = _one_process(setup, REFERENCES[MESHES[run]])
    (d, m), _ = MESHES[run]
    owners = mesh_lib.param_sharding(m, WIDTHS["tiny"])
    stored = sum(v.numel() * 4 // (1 if owners[k] is None else m)
                 for k, v in params.items())
    for rank in port_steps:
        got = rank["runs"][run]
        assert got["mesh"] == {"data": d, "model": m}
        assert [s["metrics"]["grad_norm"] for s in got["steps"]] == norms
        for k, v in params.items():
            np.testing.assert_array_equal(got["params"][k], v.numpy(),
                                          err_msg=k)
        assert all(s["all_gathers"] == 1 and s["all_reduces"] == 2
                   for s in got["steps"])
        assert got["stored_bytes"] == stored


def test_2x2_matches_jax_sharded_step(setup, port_steps):
    cfg, jm, train_cfg, batches, state = setup
    mesh = jmesh_lib.make_mesh(jcfg.MeshConfig(2, 2),
                               devices=jax.devices()[:4])
    step_fn, st = jtrain.make_sharded_train_step(
        jm, jtrain.make_optimizer(train_cfg), mesh, state)
    losses = []
    for b in batches:
        st, m = step_fn(st, jax.device_put(b, jmesh_lib.data_sharding(mesh)))
        losses.append(float(m["loss"]))
    want = convert.flax_to_torch(jax.device_get(st.params), cfg)
    for rank in port_steps:
        got = rank["runs"][0]
        np.testing.assert_allclose(
            [s["metrics"]["loss"] for s in got["steps"]], losses,
            rtol=LOSS_RTOL)
        for k, w in want.items():
            atol = KEY_BIAS_ATOL if k.endswith("attn.key.bias") else (
                PARAM_ATOL)
            np.testing.assert_allclose(got["params"][k], w.numpy(),
                                       rtol=PARAM_RTOL, atol=atol, err_msg=k)


# ---------------------------------------------------------- checkpoints


def _records(state):
    opt = state.opt_state
    return ([state.step, opt.count], list(state.model.state_dict().items()),
            list(opt.mu) + list(opt.nu))


def _assert_same_state(a, b):
    (sa, pa, oa), (sb, pb, ob) = _records(a), _records(b)
    assert sa == sb
    assert [k for k, _ in pa] == [k for k, _ in pb]
    for (k, x), (_, y) in zip(pa, pb):
        assert torch.equal(x, y), k
    assert all(torch.equal(x, y) for x, y in zip(oa, ob))


def test_checkpoint_moves_between_layouts(tmp_path):
    """run_training over 1x2 (split storage) saves step 2; it restores
    bit for bit into one device (equal to a one-process run's step 2) and
    into each 2x2 rank's split storage; resumed to step 3 on one device and
    over 2x2, both equal the one-process step from the restored state on
    the replayed first batch."""
    cfg = tcfg.tiny_model_config()
    tc = tcfg.TrainConfig(warmup_steps=2, batch_size=B, max_input_length=T,
                          max_output_length=U)
    torch.set_num_threads(1)
    ckpt, ref = tmp_path / "split", tmp_path / "one"
    job = {"mesh": (1, 2), "cfg": cfg, "tcfg": tc, "seed": 0, "steps": 2,
           "checkpoint_dir": str(ckpt)}
    dryrun.launch("run_training", job, 2, tmp_path / "a", device="cpu",
                  timeout=300)
    run_training(2, cfg, tc, seed=0, device="cpu", log_every=1,
                 checkpoint_dir=str(ref))
    like = lambda: ttrain.init_train_state(cfg, tc, seed=5, device="cpu")
    got = tckpt.restore(str(ckpt), like())
    _assert_same_state(got, tckpt.restore(str(ref), like()))

    for i in range(2):  # the model index of a 2x2 rank
        st = like()
        st.shard = ttrain.ParamShard(st.model, dataclasses.replace(
            _fake_mesh(2, i), shape={"data": 2, "model": 2}, rank=2 + i))
        st = tckpt.restore(str(ckpt), st)
        owners = mesh_lib.param_sharding(2, cfg)
        for n, p in st.model.named_parameters():
            whole = got.model.state_dict()[n]
            want = whole if owners[n] is None else whole.reshape(-1)[
                torch.from_numpy(owners[n].reshape(-1) == i)]
            assert torch.equal(p.detach(), want), n
        assert all(torch.equal(x, y) for x, y in zip(_records(st)[2],
                                                     _records(got)[2]))
        with pytest.raises(ValueError, match="split parameters"):
            tckpt.save(str(tmp_path / "refused"), 2, st)  # needs params=

    # the resumed step 3 sees the stream's first training batch again
    ds = data_lib.SyntheticTTSDataset(
        vocab_size=cfg.vocab_size, mel_dim=cfg.mel_dim,
        max_input_length=T, max_output_length=U,
        duration_class_size=cfg.duration_class_size,
        tone_class_size=cfg.tone_class_size, seed=0)
    ds.batch(B)
    batch = {k: torch.from_numpy(v) for k, v in ds.batch(B).items()
             if k != "alignment"}
    tx = ttrain.make_optimizer(tc)
    one = tckpt.restore(str(ckpt), like())
    ttrain.train_step(tx, one, batch)
    run_training(3, cfg, tc, seed=0, device="cpu", log_every=1,
                 checkpoint_dir=str(ckpt))
    _assert_same_state(tckpt.restore(str(ckpt), like()), one)

    job.update(mesh=(2, 2), steps=4)
    dryrun.launch("run_training", job, 4, tmp_path / "b", device="cpu",
                  timeout=300)
    assert tckpt.latest_step(str(ckpt)) == 4
    halves = tckpt.restore(str(ckpt), like(), step=3)
    dryrun.split_step(tx, halves, batch)
    _assert_same_state(tckpt.restore(str(ckpt), like()), halves)
