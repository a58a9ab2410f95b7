"""Experiments: the sweep specs, the golden-baseline check and the
chaos campaigns.

  engine  — SweepSpec grid expansion, deduplicated and cached runs
            (stencil grids through the whole-grid device path, the rest
            optionally over spawned worker processes), the opt-in disk
            cache, gain metrics, baseline documents and comparison
  specs   — the registry: Figs 4-8, ``halo1d``, ``steady_state``, the
            stencil and weak-scaling tiers, ``imbalance``, ``serving``,
            ``autotune``, ``faults``, ``membership``, ``serving_faults``,
            ``ir_passes`` and ``recovery``; and the Fig-5/Fig-6
            ``contention_crossover``
  chaos   — seeded fault campaigns checked against hard invariants

``python -m repro_torch.sweep`` is the command line.
"""

from .engine import (BASELINE_VERSION, DEFAULT_ENGINE, SweepSpec,  # noqa: F401
                     compare_to_baseline, load_disk_cache, make_baseline,
                     parse_key, record_key, run_records, run_records_batched,
                     run_spec, run_specs, save_disk_cache)
from .specs import SPECS, contention_crossover  # noqa: F401
