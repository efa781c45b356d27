"""The model's weights, made on the device from the run's seed in one draw
and handed alike to the program and to the reference."""

from __future__ import annotations

import math

import torch

from perfbench.traffic_gen import subseed


def make(spec: dict, seed: int, device) -> dict:
    """spec: name -> (shape, init) (an architecture's param_shapes,
    perfbench/arch.py). One
    standard normal draw of every drawn element, cut into the kernels and
    scaled by fan_in ** -0.5; zeros, ones or the values where the spec
    says."""
    g = torch.Generator(device=device)
    g.manual_seed(subseed(seed, "weights"))
    drawn = [(n, s, i) for n, (s, i) in spec.items()
             if isinstance(i, (int, float))]
    total = sum(math.prod(s) for _, s, _ in drawn)
    flat = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for name, shape, fan_in in drawn:
        n = math.prod(shape)
        out[name] = flat[at:at + n].view(shape) * fan_in ** -0.5
        at += n
    for name, (shape, init) in spec.items():
        if isinstance(init, str):
            fill = {"zeros": 0.0, "ones": 1.0}[init]
            out[name] = torch.full(shape, fill, device=device)
        elif isinstance(init, list):
            out[name] = torch.tensor(init, device=device).reshape(shape)
    return out
