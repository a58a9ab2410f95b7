"""qwen2-vl-7b: qwen2-7b backbone + M-RoPE (t/h/w sections 16/24/24 over
head_dim/2=64) and dynamic-resolution vision [arXiv:2409.12191].  The ViT
frontend is a STUB: precomputed patch embeddings are spliced into the
token stream."""
from ..models.lm import ModelConfig

ARCH_ID = "qwen2-vl-7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, n_layers=28, d_model=3584, n_heads=28, n_kv=4,
        d_ff=18944, vocab=152064, qkv_bias=True, rope_theta=1e6,
        mrope_sections=(16, 24, 24), frontend="vision_stub")


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=2,
        d_ff=128, vocab=128, qkv_bias=True, rope_theta=1e6,
        mrope_sections=(2, 3, 3), frontend="vision_stub")
