"""The reference's parameters: each name with its shape and how the
benchmark draws it. Kernels and embeddings are normal with standard
deviation fan_in ** -0.5 (LeCun normal), biases and log_sigma zero,
LayerNorm scales one. Dense kernels are (out, in), convolutions
(out, in, width), the GRU's packed [r|z|n] kernels (in, 3H).

One bias is set: the transition joint's encoder bias, EMIT_BIAS for emit
and -EMIT_BIAS for shift. Random weights put the emit/shift preference
where chance puts it: under some seeds the best v1 beam shifts at every
frame and finishes after about one frame a token, under others it runs
to the frame limit, so the audio of a batch would swing with the seed.
With the bias every seed emits first (the v1 decode's frames per batch
stay B x max_frames); the v2 decode does not read the transition joint.

For the v2 traffic, the duration AR head's output bias is DURATION_BIAS
on the class that lasts the traffic's frames a token, zero elsewhere.
Random weights put the duration preference where chance puts it, the
same at every source position: a beam that keeps a class shorter or
longer than the target's rate drifts to the edge of the band and cannot
land on the target at the last position, so each seed emptied its own
share of utterances (0-100 % at B=16, eight seeds on the CPU). With the
bias every utterance of sixteen seeds lands at B=64, W=8 (a bias of 5
emptied 2 % of one seed's), and the class log-probs keep some entropy:
-0.01 to -0.33 nats a step on the best path.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

# name -> (shape, init): init is a fan-in for a normal draw, "zeros",
# "ones", or a list of the values.
Spec = Dict[str, Tuple[Tuple[int, ...], object]]
EMIT_BIAS = 4.0
DURATION_BIAS = 6.0


def param_shapes(cfg: dict, frames_per_token: Optional[int] = None) -> Spec:
    He, H, M, R = (cfg["encoder_dim"], cfg["decoder_dim"], cfg["mel_dim"],
                   cfg["joint_rank"])
    spec: Spec = {}

    def dense(name, i, o):
        spec[name + ".weight"] = ((o, i), i)
        spec[name + ".bias"] = ((o,), "zeros")

    def norm(name, d):
        spec[name + ".weight"] = ((d,), "ones")
        spec[name + ".bias"] = ((d,), "zeros")

    def gru(name, i, h):
        spec[name + ".wi"] = ((i, 3 * h), i)
        spec[name + ".bi"] = ((3 * h,), "zeros")
        spec[name + ".wh"] = ((h, 3 * h), h)
        spec[name + ".bhn"] = ((h,), "zeros")

    spec["encoder.embed"] = ((cfg["vocab_size"], He), He)
    for i in range(3):
        spec[f"encoder.prenet.convs.{i}.weight"] = ((He, He, 5), 5 * He)
        spec[f"encoder.prenet.convs.{i}.bias"] = ((He,), "zeros")
    for i in range(3):
        norm(f"encoder.prenet.norms.{i}", He)
    for i in range(cfg["encoder_layers"]):
        pre = f"encoder.blocks.{i}."
        norm(pre + "norm1", He)
        for n in ("query", "key", "value", "out"):
            dense(pre + "attn." + n, He, He)
        norm(pre + "norm2", He)
        dense(pre + "ff.fc1", He, 4 * He)
        dense(pre + "ff.fc2", 4 * He, He)
    norm("encoder.norm", He)
    dense("ar_cell.prenet.fc1", M, H)
    dense("ar_cell.prenet.fc2", H, H)
    gru("ar_cell.cell", H, H)
    dense("transition.enc_proj", He, 2 * R)
    dense("transition.dec_pre", H, R)
    dense("transition.dec_proj", R, 2 * R)
    dense("transition.enc_bias", He, 2)
    spec["transition.enc_bias.bias"] = ((2,), [EMIT_BIAS, -EMIT_BIAS])
    dense("transition.dec_bias", H, 2)
    spec["frame.log_sigma"] = ((), "zeros")
    dense("frame.enc_mel", He, M)
    dense("frame.dec_mel", H, M)
    for kind, D in (("duration", cfg["duration_class_size"]),
                    ("tone", cfg["tone_class_size"])):
        dense(f"{kind}_head.h1", He, He)
        dense(f"{kind}_head.out", He, D)
        spec[f"{kind}_ar.embed"] = ((D, H), H)
        dense(f"{kind}_ar.enc_in", He, H)
        gru(f"{kind}_ar.cell", H, H)
        dense(f"{kind}_ar.out", H, D)
    if frames_per_token is not None:
        bias = [0.0] * cfg["duration_class_size"]
        bias[cfg["duration_table"].index(frames_per_token)] = DURATION_BIAS
        spec["duration_ar.out.bias"] = ((len(bias),), bias)
    return spec
