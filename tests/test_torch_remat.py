"""PyTorch port: the chunked remat of SSNTModel.decoder_states.

decoder_states runs the teacher-forced GRU recurrence in chunks of 8
frames, each under a non-reentrant torch.utils.checkpoint, as JAX's
decoder_states runs its scan body under nn.remat (models/ssnt.py). Held
here to the un-chunked loop, written out below as the port ran it before:
values, the mel's gradient and every parameter's gradient bit for bit (the
same operations in the same dtypes, and the same autograd graph), at U = 16
(two whole chunks), 37 (a short last chunk) and 400 (the training length),
in float32 and bfloat16 compute. tests/test_torch_train.py holds the states
to flax's.

Memory: the bytes autograd keeps for the recurrence, counted with
torch.autograd.graph.saved_tensors_hooks (unique storages, parameters
excluded) plus the inputs each checkpoint holds (the gi tensor and the
chunk's carry), beyond what the prenet and the input projection keep (the
same in both). The plain loop keeps every frame's activations and, in
bfloat16, a float32 copy of the recurrent kernel a frame; the remat keeps
gi and one carry a chunk. Measured at B=4, U=400, H=32: float32 0.52 of
the plain loop's, bfloat16 0.051; held to 0.6 and 0.1.
"""

import numpy as np
import pytest
import torch
from unittest import mock

from ssnt_tts_tpu_torch import convert
from ssnt_tts_tpu_torch.models import ssnt as ssnt_mod
from ssnt_tts_tpu_torch.models import stepmath
from ssnt_tts_tpu_torch.utils.config import tiny_model_config

B = 3
SAVED_FRACTION = {"float32": 0.6, "bfloat16": 0.1}


def _model(dtype):
    cfg = tiny_model_config(dtype=dtype)
    model = ssnt_mod.SSNTModel(cfg, device="cpu")
    model.load_state_dict(convert.flax_to_torch(
        convert.random_flax_tree(cfg, 0), cfg))
    return model


def _gru_input(model, mel):
    shifted = torch.cat([torch.zeros_like(mel[:, :1]), mel[:, :-1]], dim=1)
    cell = model.ar_cell.cell
    return stepmath.gru_input(cell.wi, cell.bi,
                              model.ar_cell.prenet(shifted).to(model.dtype))


def unchunked_states(model, mel):
    """The loop without remat: every frame's activations kept."""
    gi = _gru_input(model, mel)
    cell = model.ar_cell.cell
    state = torch.zeros(mel.shape[0], model.config.decoder_dim)
    outs = []
    for gi_u in gi.unbind(1):
        state = stepmath.gru_update(gi_u, cell.wh, cell.bhn, state)
        outs.append(state)
    return torch.stack(outs, dim=1)


def _bits(t):
    return t.detach().contiguous().view(torch.int32)


def _run(fn, model, mel, weights):
    """fn's states and the gradients of sum(states * weights)."""
    model.zero_grad(set_to_none=True)
    mel = mel.clone().requires_grad_()
    states = fn(model, mel)
    (states * weights).sum().backward()
    return states.detach(), mel.grad, {
        n: p.grad.clone() for n, p in model.named_parameters()
        if p.grad is not None}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("U", [16, 37, 400])
def test_chunked_remat_is_the_loop_bit_for_bit(U, dtype):
    torch.set_num_threads(1)
    model = _model(dtype)
    rng = np.random.default_rng(U)
    mel = torch.from_numpy(rng.normal(
        size=(B, U, model.config.mel_dim)).astype(np.float32))
    weights = torch.from_numpy(rng.normal(
        size=(B, U, model.config.decoder_dim)).astype(np.float32))
    want = _run(unchunked_states, model, mel, weights)
    got = _run(lambda m, x: m.decoder_states(x), model, mel, weights)
    assert got[0].shape == (B, U, model.config.decoder_dim)
    assert torch.equal(_bits(got[0]), _bits(want[0]))
    assert torch.equal(_bits(got[1]), _bits(want[1]))
    assert sorted(got[2]) == sorted(want[2]) == [
        "ar_cell.cell.bhn", "ar_cell.cell.bi", "ar_cell.cell.wh",
        "ar_cell.cell.wi", "ar_cell.prenet.fc1.bias",
        "ar_cell.prenet.fc1.weight", "ar_cell.prenet.fc2.bias",
        "ar_cell.prenet.fc2.weight"]
    for n, g in want[2].items():
        assert torch.equal(_bits(got[2][n]), _bits(g)), n
    with torch.no_grad():  # no graph: the chunks run as plain calls
        assert torch.equal(model.decoder_states(mel), want[0])


def _kept_bytes(fn, model, mel):
    """Bytes of the unique non-parameter storages autograd keeps for fn
    (saved tensors) and that its checkpoints hold as inputs; and the
    number of checkpoints."""
    params = {p.untyped_storage().data_ptr() for p in model.parameters()}
    kept = {}

    def keep(t):
        s = t.untyped_storage()
        if s.data_ptr() not in params:
            kept[s.data_ptr()] = s.nbytes()

    def pack(t):
        keep(t)
        return t

    calls = []
    real = ssnt_mod.checkpoint

    def counted(f, *args, **kw):
        calls.append(1)
        for a in args:
            if torch.is_tensor(a):
                keep(a)
        return real(f, *args, **kw)

    with mock.patch.object(ssnt_mod, "checkpoint", counted), \
            torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn(model, mel.requires_grad_())
    return sum(kept.values()), len(calls)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_keeps_a_fraction_of_the_loops_activations(dtype):
    torch.set_num_threads(1)
    model = _model(dtype)
    U = 400
    mel = lambda: torch.from_numpy(np.random.default_rng(0).normal(
        size=(4, U, model.config.mel_dim)).astype(np.float32))
    base, _ = _kept_bytes(_gru_input, model, mel())
    plain, n_plain = _kept_bytes(unchunked_states, model, mel())
    remat, chunks = _kept_bytes(lambda m, x: m.decoder_states(x), model,
                                mel())
    assert (n_plain, chunks) == (0, U // 8)
    share = (remat - base) / (plain - base)
    assert share < SAVED_FRACTION[dtype], (remat, plain, base)
