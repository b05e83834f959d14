"""Tensor ops of the port: losses, KNN-SV, and the CUDA kernels with their
plain versions."""
