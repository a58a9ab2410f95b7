"""AdamW, as the JAX package writes it.

The port's counterpart of the JAX package's ``optim/adamw.py``.  The
update is the reference's formula, not ``torch.optim.AdamW`` (whose
decay and epsilon sit elsewhere): the gradient is scaled by the global
clip factor, ``u = (m / c1) / (sqrt(v / c2) + eps)`` and ``p <- p - lr *
(u + wd * p)``, in f32.  Parameters, moments and the step counter are
updated in place (the JAX package returns new arrays), which keeps one
copy of each on the card.  The ZeRO-1 sharding of the moments waits for
sharding (ROADMAP queue 1, item 9).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping, Tuple

import torch


@dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"


def init_opt_state(params: Mapping[str, torch.Tensor], cfg: AdamWConfig
                   ) -> Dict[str, Any]:
    """Zero moments shaped like ``params`` (name -> tensor) and a 0-d
    int32 step counter, on the parameters' device."""
    dt = getattr(torch, cfg.moment_dtype)
    dev = next(iter(params.values())).device
    return {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "m": {k: torch.zeros(p.shape, dtype=dt, device=p.device)
              for k, p in params.items()},
        "v": {k: torch.zeros(p.shape, dtype=dt, device=p.device)
              for k, p in params.items()},
    }


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, in f32."""
    sums = [x.float().square().sum() for x in tree.values()]
    return torch.stack(sums).sum().sqrt()


@torch.no_grad()
def adamw_update(params: Mapping[str, torch.Tensor],
                 grads: Mapping[str, torch.Tensor], state: Dict[str, Any],
                 lr, cfg: AdamWConfig) -> Tuple[Mapping, Dict[str, Any]]:
    """One AdamW step, in place.  ``grads`` must already be synchronized
    (equal on every rank); returns ``(params, state)``."""
    state["step"] += 1
    step = state["step"].to(torch.float32)
    if cfg.clip_norm > 0:
        gnorm = global_norm(grads)
        scale = torch.clamp(cfg.clip_norm / gnorm.clamp_min(1e-12), max=1.0)
    else:
        scale = torch.ones((), dtype=torch.float32, device=step.device)
    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=step.device)
    c1 = 1.0 - f32(cfg.b1) ** step
    c2 = 1.0 - f32(cfg.b2) ** step
    lr = f32(lr)
    for k, p in params.items():
        m, v = state["m"][k], state["v"][k]
        gf = grads[k].float() * scale
        m_new = cfg.b1 * m.float() + (1.0 - cfg.b1) * gf
        v_new = cfg.b2 * v.float() + (1.0 - cfg.b2) * gf.square()
        u = (m_new / c1) / ((v_new / c2).sqrt() + cfg.eps)
        pf = p.float()
        p.copy_(pf - lr * (u + cfg.weight_decay * pf))
        m.copy_(m_new)
        v.copy_(v_new)
    return params, state
