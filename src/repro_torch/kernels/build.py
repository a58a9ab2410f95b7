"""Build and load the port's hand-written CUDA kernels.

Each source ``csrc/<name>.cu`` exports plain C entry points and is
compiled by ``nvcc`` into a shared library, loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds).  Libraries go into
``build/repro_torch/`` at the root of the checkout, named by a hash of
the source and its own flags (:func:`nvcc_flags`): an edited source
builds anew at first use, an unchanged one is loaded as it is.
Nothing is built at import time, and the CPU path never calls this
module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

# The kernels on the port's paths, one source each.
KERNELS = ("fabric_scan", "flash_attention", "bucket_pack", "quant8",
           "ssd_scan")

# sm_90a (Hopper, for wgmma and setmaxnreg), no fast-math; ptxas prints
# each kernel's registers and spills into the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Kernels whose results are bitwise against their plain versions: exact
# IEEE arithmetic, no FMA contraction.
BITWISE = ("fabric_scan", "bucket_pack", "quant8")
EXACT_FLAGS = ("-fmad=false",)

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a"
                       " machine with the CUDA toolkit")


def nvcc_flags(name: str) -> tuple:
    """The compiler flags of ``csrc/<name>.cu``: the bitwise kernels add
    ``-fmad=false``; the flash kernels (within 2e-5 and 2e-2 of their
    plain versions) may contract multiply-adds."""
    return NVCC_FLAGS + (EXACT_FLAGS if name in BITWISE else ())


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives for its current
    source and flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(nvcc_flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def log_path(name: str) -> Path:
    """The compiler's output (``-Xptxas -v``: registers, spills) for
    the library of ``csrc/<name>.cu``."""
    return library_path(name).with_suffix(".log")


def build(names: Sequence[str] = KERNELS) -> Dict[str, Path]:
    """Compile every named source whose library is missing, one ``nvcc``
    process per source, all started together.  Raises with the
    compiler's output if any build fails."""
    paths = {name: library_path(name) for name in names}
    todo = [name for name, p in paths.items() if not p.exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    procs = []
    for name in todo:
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=f".{name}-",
                                   suffix=".so")
        os.close(fd)
        cmd = [compiler, *nvcc_flags(name), "-o", tmp,
               str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, tmp, proc in procs:
        out, _ = proc.communicate()
        log_path(name).write_text(out)
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"--- {name} (exit {proc.returncode}) ---\n{out}")
        else:
            os.replace(tmp, paths[name])  # atomic: readers see whole files
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built at first use."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _LOADED[name] = lib
    return lib
