"""Public wrappers of the port's kernels.

Counterpart of the JAX package's ``kernels/ops.py``.  Each wrapper takes
its kernel's plain version for tensors on the CPU and launches the
hand-written kernel for tensors on a CUDA device; there it either runs
the kernel or raises, and never falls back.  Only flash attention is
ported so far (bucket pack/unpack and the int8 quantizers follow with
the training slice, ROADMAP queue 2).
"""

from __future__ import annotations

from typing import Optional

from . import flash_attention as _fa


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None):
    """q: (B, H, Sq, D); k, v: (B, Hkv, Sk, D) with Hkv | H ->
    (B, H, Sq, D) in q's dtype; ``scale`` defaults to ``D**-0.5``."""
    if q.device.type == "cpu":
        return _fa.flash_attention_plain(q, k, v, causal=causal,
                                         window=window, softcap=softcap,
                                         scale=scale)
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap, scale=scale)
