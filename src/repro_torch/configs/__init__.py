"""Architecture registry: ``--arch <id>`` -> ModelConfig.

The port's counterpart of the JAX package's ``configs``: each ported
architecture has its own module with the published config and a reduced
``smoke_config``.  Only the dense-GQA architectures run on the port so
far; asking for one of the others raises ``KeyError``.
"""

from __future__ import annotations

from importlib import import_module

from ..models.lm import ModelConfig

_MODULES = {
    "gemma2-9b": "gemma2_9b",
    "qwen2-7b": "qwen2_7b",
    "llama3.2-1b": "llama3_2_1b",
}

# Architectures of the JAX package whose blocks are not ported yet
# (MoE, Mamba, hybrid, MLA, M-RoPE, audio frontend): ROADMAP queue 1.
NOT_PORTED = ("hymba-1.5b", "granite-moe-3b-a800m", "moonshot-v1-16b-a3b",
              "minicpm3-4b", "musicgen-medium", "mamba2-780m", "qwen2-vl-7b")

ARCH_IDS = tuple(_MODULES)


def _mod(arch_id: str):
    if arch_id in NOT_PORTED:
        raise KeyError(f"arch {arch_id!r} is not ported yet (ROADMAP queue"
                       f" 1, item 7); ported: {ARCH_IDS}")
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; one of {ARCH_IDS}")
    return import_module(f"{__name__}.{_MODULES[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _mod(arch_id).config()


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _mod(arch_id).smoke_config()
