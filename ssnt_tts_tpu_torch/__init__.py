"""ssnt_tts_tpu_torch: the PyTorch + CUDA port of ssnt_tts_tpu.

The JAX package (ssnt_tts_tpu/) is the reference; this package mirrors its
layout (models/, ops/, parallel/, utils/) and keeps its public array
layouts so the two can be compared like with like. Hand-written Hopper
kernels live in csrc/ and are built at first use by ops/_build.py.

This package imports torch and numpy only, never jax, flax or ssnt_tts_tpu.
"""
