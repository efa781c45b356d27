"""Decode pipelines of the PyTorch port."""
