"""Process plumbing shared by the tests that run the port on ``gloo``
ranks and the JAX package under ``shard_map`` on host devices, each in
its own subprocess: a test file is also the program of its ranks and of
its JAX side."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def spawn(script, *args, devices: int = 0) -> subprocess.Popen:
    """``python script args...`` with ``src`` on the path; ``devices``
    > 0 gives JAX that many host devices."""
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{REPO / 'src'}{os.pathsep}" + env.get(
        "PYTHONPATH", "")
    if devices:
        env["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count="
                            f"{devices}")
    return subprocess.Popen([sys.executable, str(script), *map(str, args)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def finish(procs, timeout: float, while_running=None):
    """Wait for every process (each within ``timeout`` seconds), after
    calling ``while_running()`` if given, whose result is returned; kill
    any left running, then require every exit code to be 0."""
    logs, result = [], None
    try:
        if while_running is not None:
            result = while_running()
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return result


def gloo_rank(rank: int, n: int, store_path: str):
    """Join the ``n``-rank gloo group as ``rank``; returns
    ``torch.distributed`` (the caller destroys the group)."""
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(store_path, n),
                            rank=rank, world_size=n)
    return dist
