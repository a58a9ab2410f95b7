"""hymba-1.5b: 32L d=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.

Hybrid: parallel attention + mamba heads per layer [arXiv:2411.13676].
Sliding window (1024) everywhere except first/middle/last global layers.
"""
from ..models.lm import ModelConfig
from ..models.mamba import MambaConfig

ARCH_ID = "hymba-1.5b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, n_layers=32, d_model=1600, n_heads=25, n_kv=5,
        d_ff=5504, vocab=32001, mixer="hybrid",
        # head_dim=100 -> 32 SSM heads (divisible by TP=16; d_inner=3200)
        mamba=MambaConfig(d_state=16, head_dim=100, n_groups=1, expand=2,
                          chunk=256),
        window_pattern="hymba", window_size=1024)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", n_layers=3, d_model=64, n_heads=5, n_kv=1,
        head_dim=16, d_ff=96, vocab=128, mixer="hybrid",
        mamba=MambaConfig(d_state=8, head_dim=16, n_groups=1, expand=2,
                          chunk=16),
        window_pattern="hymba", window_size=8)
