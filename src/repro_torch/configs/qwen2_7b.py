"""qwen2-7b: 28L d=3584 28H (GQA kv=4) d_ff=18944 vocab=152064, QKV bias
[arXiv:2407.10671].  28 q heads pad to 32 under TP=16."""
from ..models.lm import ModelConfig

ARCH_ID = "qwen2-7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, n_layers=28, d_model=3584, n_heads=28, n_kv=4,
        d_ff=18944, vocab=152064, qkv_bias=True, rope_theta=1e6)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=7, n_kv=1,
        head_dim=16, d_ff=128, vocab=128, qkv_bias=True, rope_theta=1e6)
