"""PyTorch/CUDA port of the partitioned-communication reproduction.

The package mirrors the JAX package ``repro`` module by module and
imports nothing of it: ``core`` holds the simulator's main path (plan
layer, topology, schedules, the four fabric engines), ``experiments``
the stencil sweep specs and the golden-baseline check, and
``python -m repro_torch.sweep`` its command line; ``models``,
``configs``, ``launch`` and ``python -m repro_torch.serve`` the model
serving path; ``core.bucketing``, ``core.earlybird``, ``optim``,
``data``, ``ckpt``, ``runtime`` and ``python -m
repro_torch.launch.train`` the training path with early-bird gradient
sync; ``compat``, ``core.chunked_collectives``, ``core.flash_decode``
and ``optim.grad_compress`` partitioned communication over
``torch.distributed``; ``kernels`` the build, wrappers and plain versions of the
hand-written CUDA kernels in ``csrc``.  Entry points run on the CUDA
device unless the caller passes ``device="cpu"``.
"""
