"""Checkpointing: .npy leaves, atomic commit, async save, integrity.

The port's counterpart of the JAX package's ``ckpt/checkpoint.py``, with
the same on-disk layout, so either package restores the other's
checkpoints:

  <dir>/step_<N>/
     meta.json            # leaf paths, shapes, dtypes, sha256 per leaf
     leaf_00000.npy ...
  <dir>/LATEST            # atomic pointer (renamed into place)

A checkpoint holds a nested dict of NumPy arrays, flattened as JAX
flattens it (keys sorted at every level, paths written like
``jax.tree_util.keystr``: ``['params']['layers']['attn']['wq']``).  The
training state is carried to and from that tree by
``models.convert.state_to_jax`` / ``state_from_jax``, which stack the
layers on the L axis as the JAX package does.

Fault-tolerance properties:
  * a checkpoint directory becomes visible only after its meta.json and
    all leaves are fully written (tmp dir + os.replace);
  * every leaf carries a sha256; restore verifies before use;
  * AsyncCheckpointer overlaps serialization with training (the train
    loop only blocks on the *previous* save).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np


def _flatten(tree: Any, path: str = "") -> List[Tuple[str, Any]]:
    """(keystr path, leaf) pairs in JAX's flattening order."""
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out += _flatten(tree[key], f"{path}[{key!r}]")
        return out
    return [(path, tree)]


def _unflatten(template: Any, leaves: Dict[str, Any], path: str = "") -> Any:
    if isinstance(template, dict):
        return {k: _unflatten(v, leaves, f"{path}[{k!r}]")
                for k, v in template.items()}
    return leaves[path]


def save(directory: str | Path, step: int, tree: Any, *,
         extra_meta: Optional[Dict] = None, keep_last: int = 3) -> Path:
    """Write ``tree`` (nested dict of arrays) as ``step_<step>``."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:08d}"
    tmp = directory / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    meta = {"step": step, "extra": extra_meta or {}, "leaves": []}
    for i, (path, leaf) in enumerate(_flatten(tree)):
        arr = np.asarray(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(tmp / fname, arr)
        meta["leaves"].append({
            "path": path,
            "file": fname,
            "shape": list(arr.shape),
            "dtype": str(arr.dtype),
            "sha256": hashlib.sha256(arr.tobytes()).hexdigest(),
        })
    with open(tmp / "meta.json", "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)

    latest_tmp = directory / ".LATEST.tmp"
    latest_tmp.write_text(final.name)
    os.replace(latest_tmp, directory / "LATEST")

    _cleanup(directory, keep_last)
    return final


def _cleanup(directory: Path, keep_last: int):
    steps = sorted(p for p in directory.glob("step_*") if p.is_dir())
    for p in steps[:-keep_last] if keep_last > 0 else []:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(directory: str | Path) -> Optional[int]:
    directory = Path(directory)
    ptr = directory / "LATEST"
    if not ptr.exists():
        return None
    name = ptr.read_text().strip()
    if not (directory / name / "meta.json").exists():
        return None
    return int(name.split("_")[1])


def restore(directory: str | Path, template: Any, *,
            step: Optional[int] = None, shardings: Any = None,
            verify: bool = True) -> Tuple[int, Any]:
    """Restore into the structure of ``template`` (a nested dict whose
    leaves have ``shape``): returns (step, tree of NumPy arrays).

    ``shardings``: optional matching tree of
    ``launch.mesh.NamedSharding`` (``None`` leaves stay host arrays, a
    missing subtree too) -- each leaf is placed on its mesh with
    ``runtime.elastic.reshard`` as a DTensor, each rank keeping its
    block (reshard-on-restore for elastic scaling; the
    tensor-parallel blocks of ``launch.steps.param_shardings`` and
    ``opt_shardings``, across a change of the ``model`` axis too, where
    the shapes the new mesh pads to are the saved ones).  A collective call
    when any leaf is placed: every rank of the meshes restores."""
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    d = directory / f"step_{step:08d}"
    meta = json.loads((d / "meta.json").read_text())
    by_path = {m["path"]: m for m in meta["leaves"]}

    leaves = {}
    for path, tmpl in _flatten(template):
        m = by_path[path]
        arr = np.load(d / m["file"])
        if verify:
            h = hashlib.sha256(arr.tobytes()).hexdigest()
            if h != m["sha256"]:
                raise IOError(f"checksum mismatch for {path} in {d}")
        if list(arr.shape) != list(np.shape(tmpl)):
            raise ValueError(f"shape mismatch for {path}: "
                             f"{arr.shape} vs {np.shape(tmpl)}")
        leaves[path] = arr
    if shardings is not None:
        from ..runtime.elastic import reshard
        for path, sh in _flatten(shardings):
            if sh is not None:
                leaves[path] = reshard(leaves[path], sh.spec, sh.mesh)
    return meta["step"], _unflatten(template, leaves)


class AsyncCheckpointer:
    """Overlap checkpoint serialization with training.

    ``to_tree`` turns what the training loop saves into a nested dict of
    host arrays, synchronously, before the save returns (default: the
    value as it is; ``launch/train.py`` passes
    ``models.convert.state_to_jax``).  On several ranks each one calls
    :meth:`save_async` (``to_tree`` gathers sharded moments, a
    collective) and only the one with ``write`` set writes."""

    def __init__(self, directory: str | Path, keep_last: int = 3,
                 to_tree: Callable[[Any], Any] = lambda tree: tree,
                 write: bool = True):
        self.directory = Path(directory)
        self.keep_last = keep_last
        self.to_tree = to_tree
        self.write = write
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save_async(self, step: int, state: Any, extra_meta=None):
        self.wait()  # one in flight at a time
        # copy to the host synchronously, so the training loop can go on
        # updating its tensors in place
        host_tree = self.to_tree(state)
        if not self.write:
            return

        def run():
            try:
                save(self.directory, step, host_tree,
                     extra_meta=extra_meta, keep_last=self.keep_last)
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
