"""N-dimensional Cartesian rank topologies for stencil scenarios.

The paper's benchmark is a single sender/receiver pair; the regime where
partitioned communication is interesting in practice (Collom et al.,
"Persistent and Partitioned MPI for Stencil Communication") is a 2-D/3-D
stencil where every rank exchanges *faces* with up to ``2 * n_dims``
neighbors and the per-dimension face sizes differ by orders of magnitude
for anisotropic local blocks.  This module owns the rank-grid geometry:

  * :class:`CartTopology` — an ``MPI_Cart_create`` analogue: a grid of
    ranks with per-dimension periodicity, C-order rank <-> coordinate
    maps, and face-neighbor / flow enumeration;
  * :class:`HaloSpec` — the payload side: a rank-local cell block whose
    per-dimension face sizes (``halo_width`` cells deep, scaled by
    ``bytes_per_cell``) become one
    :class:`~repro_torch.core.commplan.CommPlan` per dimension via
    :meth:`HaloSpec.face_plan`.

``simulator.simulate_stencil`` consumes both: one flow per directed face,
partition plans per dimension, all merged on one multi-rank fabric.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

import numpy as np

from . import commplan


@dataclass(frozen=True)
class Neighbor:
    """A face neighbor: the rank across face ``(dim, direction)``."""
    rank: int
    dim: int
    direction: int  # -1 (low face) or +1 (high face)


@dataclass(frozen=True)
class Flow:
    """One directed face exchange ``src -> dst`` across dimension ``dim``."""
    src: int
    dst: int
    dim: int
    direction: int


@dataclass(frozen=True)
class CartTopology:
    """A Cartesian grid of ranks (``MPI_Cart_create`` analogue).

    ``dims[d]`` is the rank count along dimension d; ``periodic[d]``
    selects torus vs open-boundary behavior per dimension.  Ranks map to
    coordinates in C order (last dimension fastest), matching
    ``np.unravel_index``.  Use :meth:`create` for validated construction
    from user input.
    """
    dims: Tuple[int, ...]
    periodic: Tuple[bool, ...]

    @staticmethod
    def create(dims: Sequence[int],
               periodic: Union[bool, Sequence[bool]] = True) -> "CartTopology":
        dims_t = tuple(int(d) for d in dims)
        if not dims_t or any(d < 1 for d in dims_t):
            raise ValueError(f"dims must be positive, got {dims!r}")
        if isinstance(periodic, bool):
            per = (periodic,) * len(dims_t)
        else:
            per = tuple(bool(p) for p in periodic)
            if len(per) != len(dims_t):
                raise ValueError("periodic must match dims in length")
        return CartTopology(dims_t, per)

    @property
    def n_dims(self) -> int:
        return len(self.dims)

    @property
    def n_ranks(self) -> int:
        return math.prod(self.dims)

    def coords(self, rank: int) -> Tuple[int, ...]:
        """Rank -> grid coordinates (C order, last dimension fastest)."""
        if not 0 <= rank < self.n_ranks:
            raise ValueError(f"rank {rank} outside grid of {self.n_ranks}")
        out = []
        for d in reversed(self.dims):
            out.append(rank % d)
            rank //= d
        return tuple(reversed(out))

    def rank_of(self, coords: Sequence[int]) -> int:
        """Grid coordinates -> rank (inverse of :meth:`coords`)."""
        if len(coords) != self.n_dims:
            raise ValueError("need one coordinate per dimension")
        rank = 0
        for c, d in zip(coords, self.dims):
            if not 0 <= c < d:
                raise ValueError(f"coordinate {c} outside dimension of {d}")
            rank = rank * d + c
        return rank

    def shift(self, rank: int, dim: int, direction: int) -> Optional[int]:
        """The rank one step along ``dim``; None past an open boundary."""
        c = list(self.coords(rank))
        c[dim] += direction
        if not 0 <= c[dim] < self.dims[dim]:
            if not self.periodic[dim]:
                return None
            c[dim] %= self.dims[dim]
        return self.rank_of(c)

    def neighbors(self, rank: int) -> Tuple[Neighbor, ...]:
        """Face neighbors of ``rank``, ordered (dim, low-face, high-face).

        A periodic dimension of size 2 yields the *same* neighbor rank for
        both faces — two distinct face exchanges, as in a real stencil.
        Size-1 dimensions contribute no neighbors (a periodic wrap onto
        oneself is a local copy, not a message).
        """
        out = []
        for dim in range(self.n_dims):
            if self.dims[dim] == 1:
                continue
            for direction in (-1, +1):
                n = self.shift(rank, dim, direction)
                if n is not None and n != rank:
                    out.append(Neighbor(n, dim, direction))
        return tuple(out)

    def flows(self) -> Tuple[Flow, ...]:
        """Every directed face exchange, in (src, dim, direction) order."""
        return tuple(Flow(rank, nb.rank, nb.dim, nb.direction)
                     for rank in range(self.n_ranks)
                     for nb in self.neighbors(rank))

    def flow_arrays(self) -> Tuple["np.ndarray", "np.ndarray", "np.ndarray"]:
        """Bulk ``(src, dst, dim)`` arrays of every directed face exchange.

        Same flows in the same (src, dim, direction) order as
        :meth:`flows`, built with array arithmetic instead of per-rank
        Python objects — a 512-rank torus enumerates its 3072 flows in a
        handful of vector ops.
        """
        n, nd = self.n_ranks, self.n_dims
        ranks = np.arange(n, dtype=np.int64)
        coords = np.stack(np.unravel_index(ranks, self.dims), axis=1)
        dst = np.zeros((n, nd, 2), dtype=np.int64)
        valid = np.zeros((n, nd, 2), dtype=bool)
        for d in range(nd):
            if self.dims[d] == 1:
                continue  # a periodic wrap onto oneself is a local copy
            for i, direction in enumerate((-1, +1)):
                c = coords.copy()
                c[:, d] += direction
                in_bounds = (0 <= c[:, d]) & (c[:, d] < self.dims[d])
                c[:, d] %= self.dims[d]
                dst[:, d, i] = np.ravel_multi_index(tuple(c.T), self.dims)
                valid[:, d, i] = in_bounds | self.periodic[d]
        keep = valid.ravel()  # C-order ravel == (src, dim, direction) order
        src = np.broadcast_to(ranks[:, None, None], (n, nd, 2)).ravel()[keep]
        dim = np.broadcast_to(np.arange(nd, dtype=np.int64)[None, :, None],
                              (n, nd, 2)).ravel()[keep]
        return src, dst.ravel()[keep], dim


@dataclass(frozen=True)
class HaloSpec:
    """Per-dimension face payloads of a stencil over a Cartesian grid.

    ``local_shape[d]`` is the rank-local block's cell count along
    dimension d.  The face perpendicular to d is ``halo_width`` cells deep
    and spans the block in every other dimension, so its size is

        face_cells(d) = halo_width * prod(local_shape) / local_shape[d]

    Anisotropic blocks therefore give per-dimension surface sizes that
    differ by orders of magnitude — the regime the paper's single-pair
    benchmark cannot express.  :meth:`face_plan` turns one face into a
    :class:`~repro.core.commplan.CommPlan` (partition agreement,
    aggregation, channel assignment), one plan per dimension.
    """
    topo: CartTopology
    local_shape: Tuple[int, ...]
    bytes_per_cell: float = 8.0
    halo_width: int = 1

    @staticmethod
    def create(topo: CartTopology, local_shape: Sequence[int],
               bytes_per_cell: float = 8.0, halo_width: int = 1) -> "HaloSpec":
        shape = tuple(int(s) for s in local_shape)
        if len(shape) != topo.n_dims:
            raise ValueError("local_shape must match the grid dimensionality")
        if any(s < 1 for s in shape):
            raise ValueError(f"local_shape must be positive, got {shape!r}")
        if bytes_per_cell <= 0 or halo_width < 1:
            raise ValueError("bytes_per_cell must be > 0 and halo_width >= 1")
        return HaloSpec(topo, shape, float(bytes_per_cell), int(halo_width))

    def face_cells(self, dim: int) -> int:
        return self.halo_width * math.prod(self.local_shape) // \
            self.local_shape[dim]

    def face_bytes(self, dim: int) -> float:
        return self.face_cells(dim) * self.bytes_per_cell

    def all_face_bytes(self) -> Tuple[float, ...]:
        return tuple(self.face_bytes(d) for d in range(self.topo.n_dims))

    def face_plan(self, dim: int, *, n_parts: int, aggr_bytes: float = 0.0,
                  n_channels: int = 1) -> commplan.CommPlan:
        """The wire plan for one face split into ``n_parts`` partitions."""
        if n_parts < 1:
            raise ValueError("n_parts must be positive")
        return commplan.plan_uniform(
            n_parts, n_parts, self.face_bytes(dim) / n_parts,
            aggr_bytes=aggr_bytes, n_channels=n_channels)
