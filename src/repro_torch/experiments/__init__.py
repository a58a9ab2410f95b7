"""Experiments: the stencil sweep specs and the golden-baseline check.

  engine  — SweepSpec grid expansion, deduplicated and cached runs
            through the device path, gain metrics, baseline comparison
  specs   — the stencil specs (``stencil3d`` and the weak-scaling tiers)

``python -m repro_torch.sweep`` is the command line.
"""

from .engine import (BASELINE_VERSION, DEFAULT_ENGINE, SweepSpec,  # noqa: F401
                     compare_to_baseline, record_key, run_records,
                     run_records_batched, run_spec)
from .specs import SPECS  # noqa: F401
