"""The plain reference's whole model: embedding, the family's layers,
the final norm and the head; a training step; the last-position logits
of a prefill.  The family's module (``granite_moe``, ``mamba2``) gives
``layer`` and ``head``.
"""

from __future__ import annotations

import importlib
from typing import Callable, Dict, List

import torch
import torch.utils.checkpoint

from .common import (adamw_step, cross_entropy, linear, lr_at, per_layer,
                     rms_norm, slice_samples)


def family(s):
    return importlib.import_module(f"{__package__}.{s.family}")


def hidden(s, W: Dict, tokens: torch.Tensor, precision: str = "f32",
           remat: bool = False) -> torch.Tensor:
    """The final-normed hidden (B, S, d), f32; with ``remat`` each layer
    recomputes its activations in backward."""
    fam = family(s)
    h = W["embed"][tokens.long()].float()
    for i in range(s.n_layers):
        if remat:
            h = torch.utils.checkpoint.checkpoint(
                fam.layer, s, W, i, h, precision, use_reentrant=False)
        else:
            h = fam.layer(s, W, i, h, precision)
    return rms_norm(h, W["final_norm"], s.eps)


@torch.no_grad()
def last_logits(s, W: Dict, tokens: torch.Tensor, precision: str = "f32"
                ) -> torch.Tensor:
    """The last position's logits (B, V) of a prompt batch, f32."""
    h = hidden(s, W, tokens, precision)[:, -1]
    return linear(h, family(s).head(s, W), precision)


def train(s, W: Dict, batches: List[Dict[str, torch.Tensor]], job: dict,
          initial: Callable[[str], torch.Tensor]) -> Dict[str, object]:
    """``len(batches)`` AdamW steps from the weights ``W`` (f32, each
    leaf made to require a gradient), the job's schedule and optimizer:
    each step's loss, each leaf's norm of the first step's clipped
    gradient (its first moment over ``1 - b1``) and of its change over
    all the steps, against ``initial(name)``, the leaf drawn again, and
    the first gradient's samples on every slice (``slice_samples``).
    ``W`` is updated in place."""
    opt = job["adamw"]
    for t in W.values():
        t.requires_grad_(True)
    m = {k: torch.zeros_like(t) for k, t in W.items()}
    v = {k: torch.zeros_like(t) for k, t in W.items()}
    losses, g1, g1_s = [], {}, {}
    for step, b in enumerate(batches):
        for t in W.values():
            t.grad = None
        h = hidden(s, W, b["tokens"], remat=job["remat"])
        logits = h @ family(s).head(s, W)
        loss = cross_entropy(logits, b["labels"])
        del h, logits
        loss.backward()
        losses.append(loss.item())
        adamw_step(W, {k: t.grad for k, t in W.items()}, m, v, step + 1,
                   lr_at(step, job["schedule"]), opt)
        if step == 0:
            g1 = {k: (m[k] / (1.0 - opt["b1"])).norm().item() for k in m}
            g1_s = slice_samples(per_layer(s, m), 1.0 / (1.0 - opt["b1"]))
    for t in W.values():
        t.grad = None
        t.requires_grad_(False)
    del m, v
    change = {k: (W[k] - initial(k).float()).norm().item() for k in W}
    return {"losses": losses, "grad1": g1, "change": change,
            "grad1_s": g1_s}
