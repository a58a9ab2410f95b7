"""The hand-written CUDA kernels of ``repro_torch/csrc``: their build
(``build``), their plain PyTorch oracles (``ref``), the wrappers with
their plain versions (``flash_attention``, ``bucket_pack``, ``quant8``,
``ssd_scan``)
and the public entry points (``ops``)."""
