"""granite-moe-3b-a800m: 32L d=1536 24H (GQA kv=8) vocab=49155, MoE 40e top-8,
d_expert=512 [hf:ibm-granite].  40 experts pad to 48 under EP=16."""
from ..models.lm import ModelConfig
from ..models.moe import MoEConfig

ARCH_ID = "granite-moe-3b-a800m"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, n_layers=32, d_model=1536, n_heads=24, n_kv=8,
        d_ff=0, vocab=49155,
        moe=MoEConfig(n_experts=40, top_k=8, d_expert=512))


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=2,
        d_ff=0, vocab=128,
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=32))
