"""The op stream of one call of a step: collective bytes, FLOPs, HBM
traffic and live bytes.

The port's counterpart of the JAX package's ``launch/hlo_analysis.py``.
Torch makes no HLO: :class:`OpAnalysis` is a ``TorchDispatchMode`` over
the aten ops (and the kernels' custom ops, ``kernels.ops``) that one
eager call issues, with the step's tensors real or fake
(``torch._subclasses.fake_tensor``, as ``launch.dryrun`` traces them).
An eager call runs every loop iteration as its own ops, so no
trip-count heuristic is needed.  It fills an :class:`OpStats` whose
fields and ``to_dict()`` keys are ``HloStats``':

* ``counts`` / ``bytes_`` by collective type (``all-reduce``,
  ``all-gather``, ``reduce-scatter``, ``all-to-all``,
  ``collective-permute``): the call's ``compat.CALLS`` deltas, each
  collective by the bytes of its result on this rank (``ppermute`` is
  ``collective-permute``; the port issues no all-to-all).  Collectives
  that do not go through ``compat`` (DTensor's own redistribution,
  which ``steps._CacheLayout.gather_rows`` uses for the logits) are not
  counted.
* ``dot_flops``: every op's FLOPs under ``torch.utils.flop_counter``'s
  formulas, found as ``FlopCounterMode`` finds them (an op with no
  formula is decomposed where it can be): 2·m·n·k for ``mm``, ``bmm``,
  ``addmm``, ``baddbmm`` and the ops ``matmul`` and ``einsum`` lower
  to, and flash attention by the formula ``kernels.ops`` registers, so
  that a real call's ``FlopCounterMode`` total equals it.
* ``hbm_bytes``: each op's tensor operands plus its outputs, the upper
  bound; views and allocations move nothing and are left out.
* ``hbm_bytes_min``: twice each op's outputs, leaving out pure data
  movement (views, reshapes, transposes, expands, copies, dtype casts),
  the rules of ``hlo_analysis.py``'s lower bound.

It also tracks live bytes, as the CUDA caching allocator counts them
(each storage rounded up to 512 bytes): ``argument_bytes``, the
storages of the arguments given (state, batch, cache); ``peak_bytes``,
the most bytes of storages made during the call alive at once; and
``output_bytes``, those still alive when the mode exits (the
gradients, the loss, the logits).  A storage is followed from the op
that makes it to its release by a weak reference, without
``torch.distributed._tools.mem_tracker`` (a private API).
"""

from __future__ import annotations

import weakref
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          is_traceable_wrapper_subclass)
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from .. import compat

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# compat.CALLS key -> the collective type of hlo_analysis.py
_CALL_KINDS = {"all_reduce": "all-reduce", "all_gather": "all-gather",
               "reduce_scatter": "reduce-scatter",
               "ppermute": "collective-permute"}

# The CUDA caching allocator's smallest block: every allocation is
# rounded up to a multiple of it.
ALLOC_ROUND = 512

_aten = torch.ops.aten
# Ops that read and write no tensor data: metadata, allocation, aliases.
_NO_TRAFFIC = {
    _aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty,
    _aten.new_empty_strided, _aten.lift_fresh, _aten.detach, _aten.alias,
    _aten._unsafe_view, _aten.sym_size, _aten.sym_stride, _aten.sym_numel,
    _aten.sym_storage_offset, _aten.size, _aten.stride, _aten.numel,
    _aten.dim, _aten.is_contiguous, _aten.storage_offset,
    _aten.is_strides_like_format, _aten.is_non_overlapping_and_dense,
    _aten.sym_is_contiguous, torch.ops.prim.layout, torch.ops.prim.device,
}
# Pure data movement, left out of the lower bound: copies and casts.
_MOVEMENT = {_aten.copy_, _aten.copy, _aten.clone, _aten._to_copy,
             _aten.lift_fresh_copy, _aten.expand_copy, _aten.view_copy,
             _aten.permute_copy, _aten.transpose_copy, _aten.t_copy,
             _aten._reshape_copy}


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local block; another tensor as it is."""
    return t.to_local() if hasattr(t, "to_local") else t


def alloc_bytes(nbytes: int) -> int:
    """``nbytes`` as the caching allocator counts it."""
    return -(-nbytes // ALLOC_ROUND) * ALLOC_ROUND


def _storages(tensors: Iterable[torch.Tensor]):
    for t in tensors:
        if not is_traceable_wrapper_subclass(t):
            yield t.untyped_storage()


def argument_storages(args: Any) -> Dict[int, torch.UntypedStorage]:
    """The distinct storages of ``args`` (any tree of tensors, DTensors,
    whose local blocks count, and modules, whose parameters and buffers
    count), by id."""
    tensors = []
    for x in tree_flatten(args)[0]:
        if isinstance(x, torch.nn.Module):
            tensors += [*x.parameters(), *x.buffers()]
        elif isinstance(x, torch.Tensor):
            tensors.append(x)
    return {id(st): st for st in _storages(map(_local, tensors))}


def argument_bytes(args: Any) -> int:
    """The allocator bytes of :func:`argument_storages`."""
    return sum(alloc_bytes(st.nbytes())
               for st in argument_storages(args).values())


@dataclass
class OpStats:
    """Per-rank statistics of one call (``hlo_analysis.HloStats``'s
    fields), and its live bytes."""
    counts: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    bytes_: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    dot_flops: float = 0.0
    hbm_bytes: float = 0.0      # upper bound: operands + outputs
    hbm_bytes_min: float = 0.0  # 2 x outputs, data movement left out
    n_ops: int = 0
    argument_bytes: int = 0
    peak_bytes: int = 0         # most bytes made in the call live at once
    output_bytes: int = 0       # bytes made in the call live at the end

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_.values())

    @property
    def total_count(self) -> int:
        return sum(self.counts.values())

    def to_dict(self) -> Dict:
        return {"counts": dict(self.counts), "bytes": dict(self.bytes_),
                "total_bytes": self.total_bytes,
                "total_count": self.total_count,
                "dot_flops": self.dot_flops, "hbm_bytes": self.hbm_bytes,
                "hbm_bytes_min": self.hbm_bytes_min}


class OpAnalysis(TorchDispatchMode):
    """``with OpAnalysis(args) as a: step(*args)`` fills ``a.stats``.

    ``args`` (any tree of tensors, DTensors and modules) are the call's
    arguments, whose storages count as ``argument_bytes`` and not as
    storages the call makes."""

    def __init__(self, args: Any = ()):
        super().__init__()
        self.stats = OpStats()
        self._args = args
        self._known: Dict[int, Any] = {}   # id(storage) -> weakref
        self._live = 0
        self._depth = 0

    # -- live bytes --------------------------------------------------------

    def _released(self, key: int, nbytes: int):
        def cb(_):
            self._known.pop(key, None)
            self._live -= nbytes
        return cb

    def _made(self, out) -> None:
        for st in _storages(_tensors(out)):
            key = id(st)
            ref = self._known.get(key)
            if ref is not None and ref() is st:
                continue
            n = alloc_bytes(st.nbytes())
            self._known[key] = weakref.ref(st, self._released(key, n))
            self._live += n
            self.stats.peak_bytes = max(self.stats.peak_bytes, self._live)

    # -- the mode ----------------------------------------------------------

    def __enter__(self):
        # the mode re-enters itself to decompose an op: only the outer
        # entry and exit delimit the call
        self._depth += 1
        if self._depth == 1:
            args = argument_storages(self._args)
            self._known = {k: weakref.ref(st) for k, st in args.items()}
            self.stats.argument_bytes = sum(alloc_bytes(st.nbytes())
                                            for st in args.values())
            self._calls = dict(compat.CALLS)
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._depth -= 1
        if self._depth:
            return out
        s = self.stats
        for call, kind in _CALL_KINDS.items():
            n = compat.CALLS[call] - self._calls.get(call, 0)
            if n:
                s.counts[kind] += n
                s.bytes_[kind] += (compat.CALLS[f"{call}_bytes"]
                                   - self._calls.get(f"{call}_bytes", 0))
        s.output_bytes = self._live
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func._overloadpacket
        if packet in _NO_TRAFFIC or func.is_view:
            out = func(*args, **kwargs)
            if packet not in _NO_TRAFFIC:
                self.stats.n_ops += 1
            self._made(out)
            return out
        # FlopCounterMode's rule, so that the counts equal its: an op
        # not in the registry (keyed by packet: every overload) is
        # decomposed where it has a decomposition, and its parts counted
        if func not in flop_registry:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        s = self.stats
        s.n_ops += 1
        if packet in flop_registry:
            s.dot_flops += flop_registry[packet](*args, **kwargs, out_val=out)
        out_b = sum(map(_nbytes, _tensors(out)))
        s.hbm_bytes += out_b + sum(map(_nbytes, _tensors((args, kwargs))))
        if packet not in _MOVEMENT:
            s.hbm_bytes_min += 2 * out_b
        self._made(out)
        return out
