"""Run one cell of the port's benchmark once and print one JSON line.

    python3 perfbench/run.py --workload <name> --seed <n> \\
        --seconds <s> --trace <0|1>

Run from the root of a checkout: the port is ``src/repro_torch``.  The
kernels build into ``build/repro_torch/`` of the checkout (the port's
own rule) and every other compiler cache goes under ``build/perfbench/``
there, at fixed paths, so only a checkout's first run compiles.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(HERE)
CACHE = os.path.join(CHECKOUT, "build", "perfbench")
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = os.path.join(CACHE, sub)
sys.path[:] = [CHECKOUT, os.path.join(CHECKOUT, "src")] + \
    [p for p in sys.path if os.path.abspath(p or ".") != HERE]

from perfbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
