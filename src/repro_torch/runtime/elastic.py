"""Elastic scaling: re-plan the mesh for whatever devices survive.

The port's copy of ``ElasticPlan`` and ``plan_mesh`` from the JAX
package's ``runtime/elastic.py``.  The model-parallel degree is a
property of the checkpointed layout and stays fixed; the data-parallel
degree absorbs node loss or gain, and gradient accumulation keeps the
global batch.  ``plan_mesh`` is pure arithmetic: the simulator's
membership driver
(:func:`repro_torch.core.simulator.simulate_membership`) consumes it to
price CommPlan re-agreement.  Building a device mesh from a plan and
resharding onto it wait for the port's sharding layer (ROADMAP queue 1,
item 9).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ElasticPlan:
    data: int
    model: int
    dropped_devices: int
    grad_accum_factor: int   # microbatching factor to keep global batch

    @property
    def n_devices(self) -> int:
        return self.data * self.model


def plan_mesh(n_devices: int, model_parallel: int,
              target_data: Optional[int] = None) -> ElasticPlan:
    """Largest (data, model) grid fitting ``n_devices``; model fixed."""
    if n_devices < model_parallel:
        raise ValueError(
            f"cannot keep model parallelism {model_parallel} with only "
            f"{n_devices} devices — restore from a re-sharded checkpoint "
            f"with a smaller model degree instead")
    data = n_devices // model_parallel
    used = data * model_parallel
    accum = 1
    if target_data is not None and data < target_data:
        # keep the global batch: accumulate gradients over micro-steps
        accum = -(-target_data // data)
    return ElasticPlan(data=data, model=model_parallel,
                       dropped_devices=n_devices - used,
                       grad_accum_factor=accum)
