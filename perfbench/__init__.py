"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 perfbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything a cell is made of is found by name: its
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``, read by ``traffic/gen.py``), its limits
(``limits/<workload>.json``) and each per-layer metric's reader
(``metrics/<metric>.py``); a configuration's ``family`` names its
module (``families/<family>.py``: sizes, leaves, the port's
configuration, the yardstick's terms by layer) and its plain reference
(``reference/<family>.py``), which imports nothing of the port.  A new
architecture adds these files and edits none.
"""
