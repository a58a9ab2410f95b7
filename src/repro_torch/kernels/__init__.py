"""Build and load the hand-written CUDA kernels of ``repro_torch/csrc``."""
