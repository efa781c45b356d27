"""The whole batch's share of the card's peak: the model operations of
every batch completed in the window (the encoder, the hoisted encoder-side
projections and every step's matrix products, the architecture's counts)
over the window's seconds and the peak rate of the compute dtype, in
percent."""

from perfbench.counts import roofline

COUNTS = ("decode_flops",)


def read(run):
    peak = roofline.peak_flops(run["cfg"], run["kind"])
    if peak is None or run["window_s"] <= 0 or not run["batches"]:
        return None
    m = run["mix"]
    flops = run["arch"].counts.decode_flops(run["entry"], run["cfg"], m,
                                            m["batch"], m["beam"])
    return 100.0 * flops * len(run["batches"]) / run["window_s"] / peak
