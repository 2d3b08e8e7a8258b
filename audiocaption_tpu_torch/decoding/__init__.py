"""Decoding: the torch engine and the fused CUDA decode kernels
(counterpart of ``audiocaption_tpu.decoding``)."""
