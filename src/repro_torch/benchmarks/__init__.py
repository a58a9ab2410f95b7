"""The paper's benchmark harness on the port: one module per paper
table or figure, plus the post-paper scenario drivers.

The counterpart of the JAX package's top-level ``benchmarks`` package,
module for module: ``tableA_delayrate``, ``fig4_latency`` ...
``fig8_earlybird``, ``scen_steady``, ``scen_halo``, ``scen_stencil``,
``scen_imbalance``, ``scen_serving``, ``scen_faults``, the early-bird
gradient-sync rows (``earlybird``, on gloo ranks) and the entry point
``run``:

    python -m repro_torch.benchmarks.run --fast --json out.json

Every module's ``rows(engine=..., device=...)`` calls the port's
``simulator`` with that fabric engine and device (``cuda`` and
``cuda`` by default) and returns ``(name, us_per_call, derived)`` rows
equal, name for name and value for value, to the JAX package's.
"""
