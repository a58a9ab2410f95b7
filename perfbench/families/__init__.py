"""Model families, one module each, found by the configuration file's
``family`` key: ``families/<family>.py``.

A family module gives, from sizes alone and importing nothing of the
port at module level:

- ``sizes(conf) -> Sizes``: the configuration file's sizes.  A family
  with numbers of its own subclasses ``Sizes`` (a frozen dataclass whose
  new fields have defaults).
- ``leaves(s) -> List[Leaf]``: every leaf in a fixed order, a per-layer
  leaf over every layer or over the layers its ``layers`` names.
- ``port_config(s, param_dtype)``: the port's ``ModelConfig``; it
  imports ``repro_torch`` inside the function.
- ``proj_params(s, i)``: the weights a token multiplies by in layer
  ``i`` (experts at ``top_k``), and ``mixer_flops(s, i, batch, n)``:
  layer ``i``'s forward FLOPs of sequence mixing beyond its projections
  over ``batch`` sequences of ``n``.  The yardstick sums them over the
  layers.
- ``kernels_ahead(s, kind)``: the port's kernels a ``"train"`` or
  ``"prefill"`` run builds before set-up is timed.

and may give ``calibrate_train(s, seed, mix, device) -> {what: dict}``,
readings ``calibrate.py`` adds for each seed of a training cell.

A family adds files and edits none: this module, its plain reference
``reference/<family>.py`` (``layer`` and ``head``), a configuration
``configs/<name>.json`` naming the family, and ``traffic/`` and
``limits/`` files for its cells.
"""

from __future__ import annotations

import importlib


def family(name: str):
    """The module of family ``name``."""
    try:
        return importlib.import_module(f"{__name__}.{name}")
    except ModuleNotFoundError as e:
        if e.name != f"{__name__}.{name}":
            raise
        raise ValueError(f"unknown family {name!r}: no"
                         f" {__name__}.{name}") from None
