"""The 95th percentile of batch latency over every batch of the window
(host clock, from the send until the outputs are on the host), linear
between order statistics."""

import numpy as np


def read(run):
    lat = [b["lat_s"] for b in run["batches"]]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
