"""Roofline report: the dry run's per-cell three-term table, as CSV
rows.  Reads the port's artifacts, ``artifacts/dryrun_torch/*.json``
(``python -m repro_torch.launch.dryrun``), with the H100's roofline
constants (989 TFLOP/s bf16, 3.35 TB/s HBM, an assumed 50 GB/s a GPU
across nodes; ``launch.dryrun``)."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

from .common import emit

ART = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"


def records(mesh: str = "single", include_variants: bool = False,
            art: Optional[Path] = None):
    """``(tag parts, record)`` of each artifact of ``mesh``, by name;
    perf-iteration variants (a fourth tag part) only when asked."""
    out = []
    for path in sorted(Path(art or ART).glob(f"*__{mesh}*.json")):
        parts = path.stem.split("__")
        if len(parts) > 3 and not include_variants:
            continue
        out.append((parts, json.loads(path.read_text())))
    return out


def rows(mesh: str = "single", include_variants: bool = False,
         art: Optional[Path] = None):
    out = []
    for parts, d in records(mesh, include_variants, art):
        r = d["roofline"]
        total = r["compute_s"] + r["memory_s"] + r["collective_s"]
        dom_frac = r[r["dominant"]] / total if total else 0.0
        name = f"roofline/{d['arch']}/{d['shape']}/{d['mesh']}"
        if len(parts) > 3:
            name += f"/{'__'.join(parts[3:])}"
        out.append((name, r[r["dominant"]] * 1e6,
                    f"dom={r['dominant'][:-2]},frac={dom_frac:.2f},"
                    f"useful={r['useful_compute_ratio']:.2f},"
                    f"mem_gib={d['memory']['total_per_device_gib']},"
                    f"fits={d['memory']['fits_80gb']}"))
    if not out:
        out.append(("roofline/NO_ARTIFACTS", 0.0,
                    "run: python -m repro_torch.launch.dryrun --all"))
    return out


def main():
    emit(rows())
    emit(rows("multi"))


if __name__ == "__main__":
    main()
