"""gemma2-9b: 42L d=3584 16H (GQA kv=8, head_dim=256) d_ff=14336
vocab=256000; local(4096)/global alternating, attn softcap 50, final
softcap 30, pre+post norms, tied embeddings [arXiv:2408.00118]."""
from ..models.lm import ModelConfig

ARCH_ID = "gemma2-9b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, n_layers=42, d_model=3584, n_heads=16, n_kv=8,
        head_dim=256, d_ff=14336, vocab=256000,
        attn_softcap=50.0, final_softcap=30.0,
        window_pattern="gemma_alt", window_size=4096,
        post_norm=True, tie_embeddings=True, zero_centered_norm=True,
        emb_scale=True)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", n_layers=4, d_model=64, n_heads=4, n_kv=2,
        head_dim=32, d_ff=128, vocab=128,
        attn_softcap=50.0, final_softcap=30.0,
        window_pattern="gemma_alt", window_size=8,
        post_norm=True, tie_embeddings=True, zero_centered_norm=True,
        emb_scale=True)
