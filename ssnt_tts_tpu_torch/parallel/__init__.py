"""Decode pipelines, the train steps, the mesh and multi-process
wiring of the PyTorch port."""
