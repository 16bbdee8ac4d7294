"""Quantized-weight formats and the hand-written CUDA kernels."""
