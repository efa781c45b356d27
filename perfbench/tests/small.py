"""Small cells for the CPU tests: a bf16 model of tiny widths and short
utterances, driven through the harness as a benchmark run would."""

from perfbench import harness
from perfbench.arch import architecture

TINY = dict(vocab_size=32, mel_dim=8, encoder_dim=32, encoder_layers=1,
            encoder_heads=2, decoder_dim=32, joint_rank=8,
            duration_class_size=5, tone_class_size=4, dtype="bfloat16",
            duration_table=list(range(5)))


def spec(entry: str, *, cfg=None, batch=4, beam=3, frames=30, pad_to=12,
         limits=None, step=None):
    """A cell spec like harness.cell_spec's."""
    mix = dict(entry=entry, batch=batch, beam=beam, pad_to=pad_to,
               min_len=pad_to // 2, max_len=pad_to, max_frames=frames,
               hop_s=0.0125)
    if entry == "v2":
        # Below the band's overrun of 3 frames a token, every class would
        # be pruned at the first steps, and every utterance emptied.
        mix.update(frames_per_token=3, max_frames=3 * pad_to)
    if limits is None:
        limits = (dict(sel_rel=1e-3, lp_rel=1e-3, mel_err=1e-3)
                  if entry == "v1" else dict(sel_gap=1e-3, lp_err=1e-3))
        limits.update(invalid=0, mismatches=0)
    # Every row of every batch is kept and judged, so that a fault in any
    # row shows whatever the number of batches the window holds.
    w = dict(check_rows=10 ** 6,
             keep_per_batch=batch - 1, traced_batches=1, limits=limits)
    e2e = [{"name": n, "unit": "u"} for n in
           ("audio_s_per_s", "request_ms_p95", "setup_s")]
    cfg = dict(cfg or TINY)
    return dict(cell={"chips": 1}, workload=w, cfg=cfg, mix=mix,
                arch=architecture(cfg, entry),
                step=step or harness.DEFAULT_STEP[entry],
                end_to_end=e2e, per_layer=[])


def run(cell: dict, seconds=0.5, control=False):
    """One run of the small cell `cell` (spec's) on the CPU."""
    return harness.run_cell("small", 1234567890123, seconds, False, "cpu",
                            t0=0.0, spec=cell, control=control)
