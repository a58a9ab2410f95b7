"""moonshot-v1-16b-a3b (Moonlight-16B-A3B): 48L d=2048 16H (kv=16)
vocab=163840, MoE 64e top-6, d_expert=1408 [hf:moonshotai]."""
from ..models.lm import ModelConfig
from ..models.moe import MoEConfig

ARCH_ID = "moonshot-v1-16b-a3b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, n_layers=48, d_model=2048, n_heads=16, n_kv=16,
        d_ff=0, vocab=163840,
        moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408))


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=4,
        d_ff=0, vocab=128,
        moe=MoEConfig(n_experts=8, top_k=3, d_expert=48))
