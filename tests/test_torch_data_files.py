"""PyTorch port, the file-backed dataset (ssnt_tts_tpu_torch/data_files.py)
held against the JAX package's copy: shards written by each are equal
array for array and each reads the other's; batches (shuffled, with and
without the remainder, two epochs) and PaddingStats equal bit for bit; and
tests/test_data_files.py's invariants run on both packages as
parametrised cases.
"""

import os

import numpy as np
import pytest

from ssnt_tts_tpu import data as jdata
from ssnt_tts_tpu import data_files as jfiles
from ssnt_tts_tpu_torch import data as tdata
from ssnt_tts_tpu_torch import data_files as tfiles

PACKAGES = {"jax": (jdata, jfiles), "port": (tdata, tfiles)}
DS_KW = dict(vocab_size=32, mel_dim=8, max_input_length=12,
             max_output_length=40, duration_class_size=5, tone_class_size=4,
             seed=3)


def _materialize(pkg, out_dir):
    data_lib, files = PACKAGES[pkg]
    ds = data_lib.SyntheticTTSDataset(**DS_KW)
    return files.materialize_synthetic(ds, num_examples=57,
                                       out_dir=str(out_dir), shard_size=16,
                                       batch_size=8)


@pytest.fixture(scope="module")
def shard_dirs(tmp_path_factory):
    dirs = {}
    for pkg in PACKAGES:
        d = tmp_path_factory.mktemp(f"shards_{pkg}")
        paths = _materialize(pkg, d)
        assert len(paths) == 4  # ceil(57/16)
        dirs[pkg] = str(d)
    return dirs


def _load(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_shards_equal_array_for_array(shard_dirs):
    names = sorted(os.listdir(shard_dirs["jax"]))
    assert names == sorted(os.listdir(shard_dirs["port"]))
    for name in names:
        a, b = (os.path.join(shard_dirs[p], name) for p in ("jax", "port"))
        if name.endswith(".json"):
            assert open(a).read() == open(b).read()
            continue
        za, zb = _load(a), _load(b)
        assert za.keys() == zb.keys()
        for k in za:
            assert za[k].dtype == zb[k].dtype, (name, k)
            np.testing.assert_array_equal(za[k], zb[k], err_msg=name + k)


def _assert_batch_equal(x, y, where):
    assert x.keys() == y.keys(), where
    for k in x:
        assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape, (
            where, k)
        assert x[k].tobytes() == y[k].tobytes(), (where, k)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("drop_remainder", [True, False])
@pytest.mark.parametrize("shuffle_seed", [0, 5, None])
def test_batches_and_stats_equal_jax(shard_dirs, writer, drop_remainder,
                                     shuffle_seed):
    """Each package reads `writer`'s shards: two epochs of batches equal
    bit for bit, then the padding statistics."""
    j = jfiles.NpzShardDataset(shard_dirs[writer])
    t = tfiles.NpzShardDataset(shard_dirs[writer])
    assert j.index == t.index
    assert [(b.t_pad, b.u_pad) for b in j.buckets] == [
        (b.t_pad, b.u_pad) for b in t.buckets]
    kw = dict(shuffle_seed=shuffle_seed, epochs=2,
              drop_remainder=drop_remainder)
    got = list(t.batches(4, **kw))
    want = list(j.batches(4, **kw))
    assert len(got) == len(want) > 0
    for i, (x, y) in enumerate(zip(got, want)):
        _assert_batch_equal(x, y, i)
    for k in ("token_slots", "tokens", "frame_slots", "frames", "batches",
              "per_bucket"):
        assert getattr(t.stats, k) == getattr(j.stats, k), k
    assert t.stats.summary() == j.stats.summary()


def test_default_buckets_equal_jax():
    for max_t, max_u, n in ((12, 40, 4), (80, 400, 4), (200, 1000, 6),
                            (7, 9, 3)):
        assert [(b.t_pad, b.u_pad) for b in tfiles.default_buckets(
            max_t, max_u, n)] == [(b.t_pad, b.u_pad) for b in
                                  jfiles.default_buckets(max_t, max_u, n)]


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_rejects_empty_examples_and_oversize_corpora(pkg, tmp_path):
    files = PACKAGES[pkg][1]
    ex = {"tokens": np.zeros(0, np.int32), "mel": np.zeros((3, 2),
                                                           np.float32)}
    with pytest.raises(ValueError, match="empty"):
        files.write_npz_shards([ex], str(tmp_path / "a"))
    ex = {"tokens": np.ones(9, np.int32), "mel": np.zeros((30, 2),
                                                          np.float32)}
    files.write_npz_shards([ex], str(tmp_path / "b"))
    with pytest.raises(ValueError, match="exceed"):
        files.NpzShardDataset(str(tmp_path / "b"),
                              buckets=[files.Bucket(8, 16)])
    with pytest.raises(FileNotFoundError):
        os.makedirs(tmp_path / "c")
        files.NpzShardDataset(str(tmp_path / "c"))


# ---- tests/test_data_files.py's invariants, on each package ----

@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_roundtrip_examples(shard_dirs, pkg):
    ds = PACKAGES[pkg][1].NpzShardDataset(shard_dirs[pkg])
    assert len(ds) == 57
    seen_lengths = set()
    for si, ei, Tb, Ub in ds.index[:20]:
        ex = ds._example(si, ei)
        assert ex["tokens"].shape == (Tb,)
        assert ex["mel"].shape[0] == Ub
        assert ex["tokens"].dtype == np.int32
        assert ex["mel"].dtype == np.float32
        assert ex["duration_target"].shape == (Tb,)
        assert ex["tone_target"].shape == (Tb,)
        assert ex["duration_target"].sum() <= Ub
        seen_lengths.add((Tb, Ub))
    assert len(seen_lengths) > 1


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_bucketed_batches_invariants(shard_dirs, pkg):
    ds = PACKAGES[pkg][1].NpzShardDataset(shard_dirs[pkg])
    bucket_shapes = {(b.t_pad, b.u_pad) for b in ds.buckets}
    n_seen = 0
    for batch in ds.batches(4, shuffle_seed=1, epochs=1,
                            drop_remainder=True):
        B, T = batch["tokens"].shape
        U = batch["mel"].shape[1]
        assert B == 4 and (T, U) in bucket_shapes
        assert (batch["input_length"] <= T).all()
        assert (batch["output_length"] <= U).all()
        assert (batch["input_length"] > 0).all()
        for i in range(B):
            Tb = batch["input_length"][i]
            Ub = batch["output_length"][i]
            assert (batch["tokens"][i, Tb:] == 0).all()
            assert (batch["mel"][i, Ub:] == 0).all()
        n_seen += B
    assert n_seen >= 4 * (57 // 4 - len(ds.buckets))
    eff = ds.stats.summary()
    assert 0.3 < eff["token_efficiency"] <= 1.0
    assert 0.3 < eff["frame_efficiency"] <= 1.0


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_epoch_coverage_without_remainder_drop(shard_dirs, pkg):
    ds = PACKAGES[pkg][1].NpzShardDataset(shard_dirs[pkg])
    total = 0
    for batch in ds.batches(8, shuffle_seed=0, epochs=1,
                            drop_remainder=False):
        assert batch["tokens"].shape[0] == 8
        total += 8
    assert total >= len(ds)


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_bucket_routing_is_minimal(shard_dirs, pkg):
    ds = PACKAGES[pkg][1].NpzShardDataset(shard_dirs[pkg])
    for si, ei, Tb, Ub in ds.index:
        b = ds._bucket_for(Tb, Ub)
        for other in ds.buckets:
            if (other.t_pad, other.u_pad) < (b.t_pad, b.u_pad):
                assert Tb > other.t_pad or Ub > other.u_pad


def test_shard_cache_stays_bounded(shard_dirs):
    """cache_shards=2 over 4 shards: batches equal the unbounded reader's
    while at most two shards stay loaded."""
    small = tfiles.NpzShardDataset(shard_dirs["port"], cache_shards=2)
    full = tfiles.NpzShardDataset(shard_dirs["port"])
    for x, y in zip(small.batches(4, shuffle_seed=2, epochs=1),
                    full.batches(4, shuffle_seed=2, epochs=1)):
        _assert_batch_equal(x, y, "cache")
        assert len(small._cache) <= 2
