"""Architecture registry: ``--arch <id>`` -> ModelConfig.

The port's counterpart of the JAX package's ``configs``: each of the JAX
package's architectures has its own module with the published config
and a reduced ``smoke_config``: dense GQA,
M-RoPE with the vision stub (qwen2-vl), the audio stub (musicgen), MLA,
Mamba-2, MoE and the Hymba hybrid.
"""

from __future__ import annotations

from importlib import import_module

from ..models.lm import ModelConfig

_MODULES = {
    "hymba-1.5b": "hymba_1_5b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "gemma2-9b": "gemma2_9b",
    "qwen2-7b": "qwen2_7b",
    "llama3.2-1b": "llama3_2_1b",
    "minicpm3-4b": "minicpm3_4b",
    "musicgen-medium": "musicgen_medium",
    "mamba2-780m": "mamba2_780m",
    "qwen2-vl-7b": "qwen2_vl_7b",
}

ARCH_IDS = tuple(_MODULES)


def _mod(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; one of {ARCH_IDS}")
    return import_module(f"{__name__}.{_MODULES[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _mod(arch_id).config()


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _mod(arch_id).smoke_config()
