"""Tensor ops and the kernels behind them."""
