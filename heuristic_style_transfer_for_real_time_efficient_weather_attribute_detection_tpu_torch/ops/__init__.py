"""Tensor ops of the port: preprocess, layers, norms, Gram, attention, and
the hand-written CUDA kernels (``cuda_kernels``)."""
