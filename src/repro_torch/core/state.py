"""State carried into and out of the port as plain data.

The simulator keeps no weights: what a run carries is its cost
configuration, a fabric's warm resource state (busy-until clocks, VCI
owners, message counters) and the message columns of a grid item.  These
functions move each of them as plain numbers, lists, dicts and NumPy
arrays, so two implementations of the fabric can start from the same
configuration and the same warm state.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np

from .fabric import NetConfig
from .fabric_torch import GridItem

_NETCONFIG_FIELDS = tuple(NetConfig.__dataclass_fields__)


def netconfig_from_dict(d: Mapping[str, Any]) -> NetConfig:
    """The port's :class:`NetConfig` from a mapping of its fields (such
    as ``dataclasses.asdict`` of an equal configuration).  Unknown or
    missing fields raise."""
    unknown = sorted(set(d) - set(_NETCONFIG_FIELDS))
    missing = sorted(set(_NETCONFIG_FIELDS) - set(d))
    if unknown or missing:
        raise ValueError(f"NetConfig fields: unknown {unknown},"
                         f" missing {missing}")
    return NetConfig(**dict(d))


def fabric_state(fab) -> Dict[str, Any]:
    """A fabric's warm resource state as plain data: per-rank VCI
    busy-until clocks and last owners (``-1`` for an idle VCI), NIC
    clocks, per-link wire clocks keyed by ``(src, dst)``, and the
    message counters."""
    return {
        "vci_free": np.array(fab.vci_free, dtype=np.float64),
        "vci_last_thread": np.array(
            [[-1 if t is None else int(t) for t in row]
             for row in fab.vci_last_thread], dtype=np.int64),
        "nic_free": np.array(fab.nic_free, dtype=np.float64),
        "wire_free": {(int(s), int(d)): float(v)
                      for (s, d), v in fab.wire_free.items()},
        "n_messages": int(fab.n_messages),
        "sent_per_rank": [int(c) for c in fab.sent_per_rank],
    }


def load_fabric_state(fab, state: Mapping[str, Any]) -> None:
    """Install warm state (as :func:`fabric_state` gives it) into a
    fabric of the same rank and VCI counts."""
    vci_free = np.asarray(state["vci_free"], dtype=np.float64)
    if vci_free.shape != (fab.n_ranks, fab.n_vcis):
        raise ValueError(f"state is for {vci_free.shape} (ranks, VCIs);"
                         f" fabric has ({fab.n_ranks}, {fab.n_vcis})")
    fab.vci_free = vci_free.tolist()
    fab.vci_last_thread = [[None if t < 0 else int(t) for t in row]
                           for row in np.asarray(state["vci_last_thread"])
                           .tolist()]
    fab.nic_free = np.asarray(state["nic_free"],
                              dtype=np.float64).tolist()
    fab.wire_free = {(int(s), int(d)): float(v)
                     for (s, d), v in state["wire_free"].items()}
    fab.n_messages = int(state["n_messages"])
    fab.sent_per_rank = [int(c) for c in state["sent_per_rank"]]


def grid_item_from_arrays(*, t_ready, nbytes, vci, thread, put, am_copy,
                          src, dst, cfg: NetConfig, n_vcis: int,
                          n_ranks: int, key: Optional[Any] = None
                          ) -> GridItem:
    """A :class:`GridItem` from NumPy columns (already in merge order),
    with the column dtypes the engines take."""
    return GridItem(
        t_ready=np.asarray(t_ready, dtype=np.float64),
        nbytes=np.asarray(nbytes, dtype=np.float64),
        vci=np.asarray(vci, dtype=np.int64),
        thread=np.asarray(thread, dtype=np.int64),
        put=np.asarray(put, dtype=bool),
        am_copy=np.asarray(am_copy, dtype=bool),
        src=np.asarray(src, dtype=np.int64),
        dst=np.asarray(dst, dtype=np.int64),
        cfg=cfg, n_vcis=int(n_vcis), n_ranks=int(n_ranks), key=key)
