"""Tensor ops of the port: losses, KNN-SV, SCR's augmentation, and the CUDA
kernels with their plain versions."""
