"""The generator: one seed gives one stream of batches, another seed
another, and every batch the same set of lengths."""

import torch

from perfbench import traffic_gen as traffic

MIX = traffic.load("v2_b2048_w8")


def batches(seed, n=3, B=64):
    t = traffic.Traffic(dict(MIX, batch=B), 128, seed, "cpu")
    return [t.batch(i) for i in range(n)]


def test_same_seed_same_batches():
    for a, b in zip(batches(2 ** 31 + 17), batches(2 ** 31 + 17)):
        for k in a:
            assert torch.equal(a[k], b[k])


def test_other_seed_other_batches():
    a, b = batches(5)[0], batches(6)[0]
    assert not torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["input_length"], b["input_length"])


def test_batches_differ_and_share_lengths():
    bs = batches(7)
    assert not torch.equal(bs[0]["tokens"], bs[1]["tokens"])
    sets = [sorted(b["input_length"].tolist()) for b in bs]
    assert sets[0] == sets[1] == sets[2]
    assert min(sets[0]) == MIX["min_len"] and max(sets[0]) == MIX["max_len"]


def test_padding_and_targets():
    b = batches(8, n=1)[0]
    T = MIX["pad_to"]
    pos = torch.arange(T)[None]
    il = b["input_length"][:, None]
    assert bool((b["tokens"][pos.expand_as(b["tokens"]) >= il] == 0).all())
    assert torch.equal(b["output_length"],
                       b["input_length"] * MIX["frames_per_token"])
    assert int(b["output_length"].max()) <= MIX["max_frames"]
