"""Experiments: the sweep specs, the golden-baseline check and the
chaos campaigns.

  engine  — SweepSpec grid expansion, deduplicated and cached runs
            (stencil grids through the whole-grid device path), gain
            metrics, baseline comparison
  specs   — the registry: Figs 4-8, ``halo1d``, ``steady_state``, the
            stencil and weak-scaling tiers, ``imbalance``, ``serving``,
            ``faults``, ``membership``, ``serving_faults`` and
            ``recovery``; and the Fig-5/Fig-6 ``contention_crossover``
  chaos   — seeded fault campaigns checked against hard invariants

``python -m repro_torch.sweep`` is the command line.
"""

from .engine import (BASELINE_VERSION, DEFAULT_ENGINE, SweepSpec,  # noqa: F401
                     compare_to_baseline, parse_key, record_key, run_records,
                     run_records_batched, run_spec)
from .specs import SPECS, contention_crossover  # noqa: F401
