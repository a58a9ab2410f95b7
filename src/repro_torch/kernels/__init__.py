"""The hand-written CUDA kernels of ``repro_torch/csrc``: their build
(``build``), their plain PyTorch oracles (``ref``), the flash-attention
wrapper (``flash_attention``) and the public wrappers (``ops``)."""
