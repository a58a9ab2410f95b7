"""Elastic scaling: re-plan the mesh for whatever devices survive.

The port's copy of ``ElasticPlan`` and ``plan_mesh`` from the JAX
package's ``runtime/elastic.py``.  The model-parallel degree is a
property of the checkpointed layout and stays fixed; the data-parallel
degree absorbs node loss or gain, and gradient accumulation keeps the
global batch.  ``plan_mesh`` is pure arithmetic: the simulator's
membership driver
(:func:`repro_torch.core.simulator.simulate_membership`) consumes it to
price CommPlan re-agreement.  :func:`build_mesh` materialises a plan
as a ``DeviceMesh`` over the first ranks of the world, and
:func:`reshard` places a tree of tensors on a (possibly new) mesh as
DTensors, the restore-time path of elastic scaling.  Both are
collective calls: every rank of the world makes them, in the same
order, members of the mesh or not.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence

import numpy as np


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


def build_mesh(plan: ElasticPlan, ranks: Optional[Sequence[int]] = None,
               device="cuda"):
    """Materialise the plan as a ``(data, model)`` mesh over the first
    ``plan.n_devices`` of ``ranks`` (default: every rank of the world),
    on ``device``'s type.  Every rank of the world calls it."""
    import torch.distributed as dist
    from ..launch.mesh import make_mesh
    ranks = list(range(dist.get_world_size())) if ranks is None \
        else list(ranks)
    if plan.n_devices > len(ranks):
        raise ValueError(
            f"plan needs {plan.n_devices} devices "
            f"(data={plan.data} x model={plan.model}) but only "
            f"{len(ranks)} are available — re-plan with "
            f"plan_mesh({len(ranks)}, {plan.model})")
    return make_mesh((plan.data, plan.model), ("data", "model"), device,
                     ranks=ranks[:plan.n_devices])


def _is_leaf(x) -> bool:
    """A tensor, an array or an explicit ``None`` hole."""
    import torch
    return x is None or isinstance(x, (torch.Tensor, np.ndarray))


def _check_structure(tree, specs, path: str = "") -> None:
    if _is_leaf(tree):
        if not isinstance(specs, tuple):
            raise ValueError(f"{path or 'the root'} is a leaf, its spec"
                             f" {specs!r} is not a PartitionSpec")
        return
    if isinstance(tree, dict):
        if not isinstance(specs, dict) or set(tree) != set(specs):
            raise ValueError(
                f"{path or 'the root'}: keys {sorted(tree)} against"
                f" {sorted(specs) if isinstance(specs, dict) else specs!r}")
        for k in tree:
            _check_structure(tree[k], specs[k], f"{path}[{k!r}]")
        return
    if isinstance(tree, (list, tuple)):
        if type(specs) is not type(tree) or len(specs) != len(tree):
            raise ValueError(f"{path or 'the root'}: {len(tree)} entries"
                             f" against {specs!r}")
        for i, (t, s) in enumerate(zip(tree, specs)):
            _check_structure(t, s, f"{path}[{i}]")
        return
    raise ValueError(f"{path or 'the root'}: {type(tree).__name__} is"
                     f" neither a container nor an array")


def reshard(tree: Any, specs: Any, mesh) -> Any:
    """Place a tree onto a (possibly new) mesh — the restore-time path.

    ``None`` leaves pass through untouched (optimizer slots absent from
    a checkpoint); every other leaf (a tensor, a NumPy array or a
    DTensor of another mesh, gathered first) becomes a DTensor on
    ``mesh`` with the placements of its ``PartitionSpec``, each rank
    keeping its block.  A dim split over the ``model`` axis alone takes
    ``torch.chunk``'s blocks where it does not divide, as the
    tensor-parallel parameters' are (``launch.mesh.block``); any other
    split dim that does not divide evenly raises, as ``jax.device_put``
    does; a parameter/spec structure mismatch raises a ``ValueError``
    naming both structures.
    """
    import torch
    from torch.distributed.tensor import DTensor, distribute_tensor
    from ..launch.mesh import check_divisible, spec_axes, to_placements
    try:
        _check_structure(tree, specs)
    except ValueError as e:
        raise ValueError(
            f"reshard: parameter tree and sharding-spec tree have "
            f"mismatched structure — every array (or None) leaf of the "
            f"parameters needs exactly one PartitionSpec ({e})") from e
    dev = torch.device(mesh.device_type)

    def put(x, spec):
        if x is None:
            return None
        if isinstance(x, DTensor):
            x = x.full_tensor()
        elif isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        check_divisible(x.shape, [None if spec_axes(e) == ("model",)
                                  else e for e in tuple(spec)], mesh)
        return distribute_tensor(x.detach().to(dev), mesh,
                                 to_placements(spec, mesh, x.dim()),
                                 src_data_rank=None)

    def walk(t, s):
        if _is_leaf(t):
            return put(t, s)
        if isinstance(t, dict):
            return {k: walk(t[k], s[k]) for k in t}
        return type(t)(walk(a, b) for a, b in zip(t, s))
    return walk(tree, specs)
