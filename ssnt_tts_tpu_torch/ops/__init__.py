"""Beam-search, backtrace and upsampling ops of the PyTorch port."""
