"""The device mesh and the sharding specs of the port.

The port's counterpart of the JAX package's ``launch/mesh.py`` and of
``jax.sharding.PartitionSpec``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over ranks of the process
group, one device each, with named axes (``("data", "model")`` or
``("pod", "data", "model")``); ``NamedSharding(mesh, spec)`` becomes a
DTensor on that mesh whose placements :func:`to_placements` derives from
the spec.  A :class:`PartitionSpec` names, per tensor dim, the mesh axis
(or tuple of axes, major to minor) it is split over, or ``None``.

Collectives over a tuple of axes (the early-bird sync over the data
axes, the flash decode over the sequence axes) run on one flat process
group whose rank is the row-major index over those axes, as
``repro_torch.compat`` reads a tuple of mesh axes.  :func:`make_mesh`
creates these groups with the mesh, and **every rank of the world must
call it**, members or not: ``torch.distributed`` builds a subgroup only
when all ranks take part.  :func:`axis_group` returns this rank's group
over a tuple of axes (None on a rank outside the mesh).  The DTensor
modules are imported where they are used, so that importing this module
(the model's spec functions do) stays cheap.
"""

from __future__ import annotations

import itertools
import math
import weakref
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..core.fabric_torch import resolve_device

Axes = Union[str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """Per tensor dim: a mesh axis name, a tuple of names (the dim split
    over all of them, major to minor), or ``None`` (not split).  Trailing
    dims left out are not split.  A tuple of one name is that name, as
    JAX writes it, so a spec equals the JAX ``PartitionSpec`` of the
    same entries, compared as tuples."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return e[0] if len(e) == 1 else e
            return e
        return super().__new__(cls, (norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class NamedSharding:
    """A mesh and a spec: where a tensor's blocks live
    (``jax.sharding.NamedSharding``); ``runtime.elastic.reshard`` and
    ``ckpt.checkpoint.restore`` place tensors by it."""

    def __init__(self, mesh, spec: Sequence):
        self.mesh, self.spec = mesh, PartitionSpec(*spec)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh}, {self.spec})"

# this rank's flat group over each tuple of axes of each mesh
_GROUPS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _as_axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes one entry of a spec names (none for ``None``)."""
    return () if entry is None else _as_axes(entry)


def _flat_groups(mesh) -> Dict[Tuple[str, ...], object]:
    """One flat process group per non-empty tuple of axes (in mesh
    order) and per fixing of the other axes; every world rank creates
    every group, and keeps the one it belongs to (None outside)."""
    names, ranks = mesh.mesh_dim_names, mesh.mesh.numpy()
    out: Dict[Tuple[str, ...], object] = {}
    for k in range(1, len(names) + 1):
        for dims in itertools.combinations(range(len(names)), k):
            rest = [d for d in range(len(names)) if d not in dims]
            moved = np.transpose(ranks, rest + list(dims))
            lists = moved.reshape(-1, math.prod(ranks.shape[d]
                                                for d in dims)).tolist()
            mine, _ = dist.new_subgroups_by_enumeration(lists)
            out[tuple(names[d] for d in dims)] = mine
    return out


def make_mesh(shape: Sequence[int], axes: Sequence[str], device="cuda",
              ranks: Optional[Sequence[int]] = None):
    """A mesh of ``shape`` with axis names ``axes`` over ``ranks``
    (default: the first ``prod(shape)`` ranks of the world), row-major,
    on ``device``'s type.  A collective call: every rank of the world
    calls it with the same arguments."""
    from torch.distributed.device_mesh import DeviceMesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"make_mesh: shape {shape} and axes {axes} differ"
                         f" in length or repeat a name")
    dev = resolve_device(device)
    n, world = math.prod(shape), dist.get_world_size()
    ranks = list(range(n)) if ranks is None else [int(r) for r in ranks]
    if len(ranks) != n:
        raise ValueError(f"make_mesh: shape {shape} takes {n} ranks, got"
                         f" {len(ranks)}")
    if n > world or min(ranks) < 0 or max(ranks) >= world:
        raise ValueError(f"make_mesh: a mesh of {n} ranks {ranks} in a"
                         f" world of {world}")
    mesh = DeviceMesh(dev.type, torch.tensor(ranks).reshape(shape),
                      mesh_dim_names=axes)
    # a DeviceMesh equals another of the same layout: drop an earlier
    # one's entry, whose key would stay the earlier object and go with it
    _GROUPS.pop(mesh, None)
    _GROUPS[mesh] = _flat_groups(mesh)
    return mesh


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """16x16 single pod (256 ranks) or 2x16x16 two-pod (512 ranks), the
    JAX package's shapes; raises naming the rank count when the world
    is smaller."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need, world = math.prod(shape), dist.get_world_size()
    if world < need:
        raise ValueError(
            f"make_production_mesh: the {'x'.join(map(str, shape))} mesh"
            f" needs {need} ranks, the world has {world}")
    return make_mesh(shape, axes, device)


def axis_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size (``jax.sharding.Mesh.shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def dp_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel (gradient-sync) axes of a mesh."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def all_axes(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def model_size(mesh) -> int:
    return axis_sizes(mesh)["model"]


def size(mesh, axes: Axes) -> int:
    """Ranks along ``axes`` together."""
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in _as_axes(axes))


def dp_size(mesh) -> int:
    return size(mesh, dp_axes(mesh))


def axis_group(mesh, axes: Axes):
    """This rank's flat process group over ``axes`` (its rank there is
    the row-major index over them); None on a rank outside the mesh."""
    key = _as_axes(axes)
    groups = _GROUPS.get(mesh)
    if groups is None or key not in groups:
        raise ValueError(f"axis_group: {key} is not a tuple of axes of a"
                         f" mesh made by make_mesh ({mesh})")
    return groups[key]


def axis_index(mesh, axes: Axes) -> int:
    """This rank's row-major index over ``axes`` (``jax.lax.axis_index``
    of the tuple)."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not in {mesh}")
    sizes, where = axis_sizes(mesh), dict(zip(mesh.mesh_dim_names, coord))
    idx = 0
    for a in _as_axes(axes):
        idx = idx * sizes[a] + where[a]
    return idx


def in_mesh(mesh) -> bool:
    return mesh.get_coordinate() is not None


def to_placements(spec: Sequence, mesh, ndim: int) -> list:
    """The DTensor placements of ``NamedSharding(mesh, spec)`` for a
    tensor of ``ndim`` dims: ``Shard(d)`` on each mesh dim the spec
    names for tensor dim d, ``Replicate()`` on the others.  A dim split
    over a tuple of axes is split major to minor in the tuple's order,
    which must be the mesh's dim order (DTensor splits in mesh order);
    another order raises instead of splitting in a different one."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    spec = tuple(spec)
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the tensor's"
                         f" {ndim} dims")
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = _as_axes(entry)
        unknown = [a for a in axes if a not in names]
        if unknown:
            raise ValueError(f"spec {spec} names axes {unknown} not in the"
                             f" mesh's {names}")
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(
                f"spec {spec} splits dim {d} over {axes}, not in the mesh's"
                f" axis order {names}: DTensor would split it major to"
                f" minor in mesh order instead")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec} uses axis {names[i]} twice")
            out[i] = Shard(d)
    return out


def check_divisible(shape: Sequence[int], spec: Sequence,
                    mesh) -> None:
    """Raise ``ValueError`` unless every dim the spec splits divides
    evenly over its axes (``jax.device_put``'s rule; DTensor would split
    it unevenly without a word)."""
    for d, entry in enumerate(tuple(spec)):
        if entry is None:
            continue
        n = size(mesh, entry)
        if shape[d] % n:
            raise ValueError(
                f"sharding {PartitionSpec(*spec)} implies that dim {d} of a"
                f" {tuple(shape)} array splits over {n} ranks, but {shape[d]}"
                f" is not divisible by {n}")


def block(n: int, count: int, index: int, unit: int = 1) -> slice:
    """Block ``index`` of ``count`` of a dim of ``n`` elements in units
    of ``unit`` (a Mamba head's channels): ``torch.chunk``'s rule on the
    n / unit units, ceil(units / count) a block, the last blocks shorter
    (or empty); equal blocks where ``count`` divides the units."""
    if n % unit:
        raise ValueError(f"block: {n} is not a multiple of the unit {unit}")
    units = n // unit
    c = -(-units // count)
    lo = min(units, index * c)
    return slice(lo * unit, min(units, lo + c) * unit)


def local_slices(shape: Sequence[int], spec: Sequence, mesh,
                 units: Optional[Dict[int, int]] = None
                 ) -> Tuple[slice, ...]:
    """This rank's block of a ``shape`` array under ``spec`` (the
    slices of its DTensor local shard), the split dims checked.  With
    ``units`` (dim -> unit; dims not named have unit 1) a split dim need
    not divide: each takes :func:`block`'s rule, as the tensor-parallel
    parameters do (``lm.param_blocks``)."""
    if units is None:
        check_divisible(shape, spec, mesh)
    out = [slice(0, s) for s in shape]
    for d, entry in enumerate(tuple(spec)):
        if entry is None:
            continue
        out[d] = block(shape[d], size(mesh, entry), axis_index(mesh, entry),
                       (units or {}).get(d, 1))
    return tuple(out)


def zeros(shape: Sequence[int], spec: Sequence, mesh, dtype, device,
          units: Optional[Dict[int, int]] = None):
    """A zero DTensor of global ``shape`` on ``mesh`` under ``spec``,
    allocating only this rank's block (with ``units``, a split dim that
    does not divide takes :func:`block`'s rule, DTensor's own
    ``torch.chunk`` rule where the units are 1)."""
    from torch.distributed.tensor import DTensor
    local = [s.stop - s.start
             for s in local_slices(shape, spec, mesh, units)]
    return DTensor.from_local(
        torch.zeros(local, dtype=dtype, device=device), mesh,
        to_placements(spec, mesh, len(shape)), run_check=False,
        shape=torch.Size(shape), stride=contiguous_stride(shape))


def contiguous_stride(shape: Sequence[int]) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape``."""
    out, acc = [], 1
    for n in reversed(tuple(shape)):
        out.append(acc)
        acc *= n
    return tuple(reversed(out))


def gather_blocks(local: torch.Tensor, shape: Sequence[int], spec: Sequence,
                  mesh, units: Optional[Dict[int, int]] = None
                  ) -> torch.Tensor:
    """The whole ``shape`` array on every rank of ``mesh`` from each
    rank's block under ``spec`` (:func:`local_slices` with ``units``:
    uneven blocks too), one all-gather (``compat.all_gather_``) over the
    axes of each split dim of more than one rank, the blocks padded to
    the largest.  A collective call: every rank of the mesh makes it."""
    from ..compat import all_gather_
    out = local
    for d, entry in enumerate(tuple(spec)):
        n = size(mesh, spec_axes(entry))
        if n == 1:
            continue
        unit = (units or {}).get(d, 1)
        sizes = [block(shape[d], n, i, unit) for i in range(n)]
        sizes = [s.stop - s.start for s in sizes]
        c = max(sizes)
        pad = torch.zeros((*out.shape[:d], c, *out.shape[d + 1:]),
                          dtype=out.dtype, device=out.device)
        pad.narrow(d, 0, out.shape[d]).copy_(out)
        g = all_gather_(pad, d, axis_group(mesh, entry))
        out = torch.cat([g.narrow(d, i * c, k) for i, k in enumerate(sizes)],
                        dim=d)
    return out
