"""Kernels and signal ops of the port: STFT (K2), GroupNorm (K1), subband
convolution (K3), DFTs and the minimum-phase chain."""
