"""Seconds of audio completed in the window over the window's seconds
(host clock): every batch that completed, at the mix's hop."""


def read(run):
    if run["window_s"] <= 0 or not run["batches"]:
        return None
    return sum(b["audio_s"] for b in run["batches"]) / run["window_s"]
