"""llama3.2-1b: 16L d=2048 32H (GQA kv=8) d_ff=8192 vocab=128256, tied
embeddings [hf:meta-llama/Llama-3.2-1B]."""
from ..models.lm import ModelConfig

ARCH_ID = "llama3.2-1b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, n_layers=16, d_model=2048, n_heads=32, n_kv=8,
        d_ff=8192, vocab=128256, tie_embeddings=True, rope_theta=5e5)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=2,
        d_ff=128, vocab=128, tie_embeddings=True, rope_theta=5e5)
