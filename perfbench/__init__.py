"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 perfbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything a cell is made of is found by name: its
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``, read by ``traffic/gen.py``), its limits
(``limits/<workload>.json``) and each per-layer metric's reader
(``metrics/<metric>.py``).  The plain references in ``reference/``
import nothing of the port.
"""
