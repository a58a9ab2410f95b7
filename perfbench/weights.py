"""Weights drawn from ``--seed``, on the device, one generator call a leaf.

A leaf is one parameter of the model with its per-layer copies stacked
on a leading layer axis (``layers.attn.wq`` is (L, d, H, hd)), over every
layer or over the layers its ``layers`` names (a dense layer before
sparse ones); each family lists its own (``families/<family>.py``).
Each leaf is drawn whole by one call of a ``torch.Generator`` seeded from
(seed, leaf name), so that one leaf can be drawn again alone: the port
is handed the draws (``port.build_model``), and the plain reference
draws them again after the window.  Widths are the configuration's;
initialisers are the published models' kind (fan-in normals, unit
norms, Mamba-2's ``A_log`` and ``dt_bias`` from mamba_ssm's ranges).
"""

from __future__ import annotations

import functools
import hashlib
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from .sizes import Sizes


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed from ``seed`` and ``tags``, for any whole ``seed``."""
    h = hashlib.sha256(repr((int(seed), *tags)).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


@dataclass(frozen=True)
class Leaf:
    name: str
    shape: Tuple[int, ...]
    init: str            # normal | ones | zeros | a_log | dt_bias
    fan_in: int = 1
    f32: bool = False    # kept in f32 whatever the served dtype
    # a per-layer leaf's layers, in order, one a row of its leading axis;
    # None: every layer
    layers: Optional[Tuple[int, ...]] = None

    @property
    def per_layer(self) -> bool:
        return self.name.startswith("layers.")

    def layer_ids(self, n_layers: int) -> Tuple[int, ...]:
        """The layers a per-layer leaf covers, by global index."""
        return tuple(range(n_layers)) if self.layers is None \
            else self.layers


def outer_leaves(s: Sizes) -> List[Leaf]:
    """The leaves outside the layers: the embedding, the final norm and
    an untied head, the first of every family's leaves."""
    d = s.d_model
    out = [Leaf("embed", (s.vocab, d), "normal", d),
           Leaf("final_norm", (d,), "ones")]
    if not s.tie:
        out.append(Leaf("head", (d, s.vocab), "normal", d))
    return out


def _fits(lf: Leaf, n_layers: int) -> bool:
    """A per-layer leaf's rows are its layers, ascending and each once;
    a leaf outside the layers names none."""
    if not lf.per_layer:
        return lf.layers is None
    ids = list(lf.layer_ids(n_layers))
    return 0 < len(ids) == lf.shape[0] and ids == sorted(set(ids)) \
        and 0 <= ids[0] and ids[-1] < n_layers


def leaves(s: Sizes) -> List[Leaf]:
    """Every leaf of the model of ``s``, in its family's fixed order."""
    from .families import family
    out = family(s.family).leaves(s)
    for lf in out:
        if not _fits(lf, s.n_layers):
            raise ValueError(f"leaf {lf.name} {lf.shape} of {s.name}:"
                             f" layers {lf.layers} of {s.n_layers}")
    return out


@functools.lru_cache(maxsize=64)
def layer_slots(s: Sizes) -> Dict[str, Dict[int, int]]:
    """Each per-layer leaf's row of its leading axis for each layer it
    covers: ``layer_slots(s)[name][i]`` holds layer ``i``."""
    return {lf.name: {i: j for j, i in enumerate(
        lf.layer_ids(s.n_layers))} for lf in leaves(s) if lf.per_layer}


def draw(leaf: Leaf, seed: int, device, dtype: torch.dtype) -> torch.Tensor:
    """Leaf ``leaf`` of seed ``seed``, in ``dtype`` (f32 for an f32
    leaf), drawn on ``device``; the same arguments give the same bits."""
    dt = torch.float32 if leaf.f32 else dtype
    if leaf.init == "ones":
        return torch.ones(leaf.shape, dtype=dt, device=device)
    if leaf.init == "zeros":
        return torch.zeros(leaf.shape, dtype=dt, device=device)
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, leaf.name))
    if leaf.init == "normal":
        w = torch.randn(leaf.shape, generator=g, dtype=dt, device=device)
        return w.mul_(1.0 / math.sqrt(leaf.fan_in))
    u = torch.rand(leaf.shape, generator=g, dtype=torch.float32,
                   device=device)
    if leaf.init == "a_log":          # A in [1, 16), as mamba_ssm's
        return torch.log(1.0 + 15.0 * u)
    if leaf.init == "dt_bias":        # dt log-uniform in [1e-3, 1e-1)
        lo, hi = math.log(1e-3), math.log(1e-1)
        dt_ = torch.exp(lo + (hi - lo) * u).clamp_min(1e-4)
        return dt_ + torch.log(-torch.expm1(-dt_))   # softplus^-1
    raise ValueError(leaf.init)


def all_leaves(s: Sizes, seed: int, device, dtype: torch.dtype
               ) -> Dict[str, torch.Tensor]:
    """Every leaf of seed ``seed`` (the plain reference's weights)."""
    return {lf.name: draw(lf, seed, device, dtype) for lf in leaves(s)}
