"""Ops layer: FIR resampling, activation, pooling, and the CUDA kernels behind them."""
