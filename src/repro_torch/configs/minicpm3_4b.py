"""minicpm3-4b: 62L d=2560 40H d_ff=6400 vocab=73448, multi-head latent
attention (q_lora=768, kv_lora=256, qk_nope=64, qk_rope=32, v=64)
[hf:openbmb/MiniCPM3-4B].  40 heads pad to 48 under TP=16."""
from ..models.lm import MLAConfig, ModelConfig

ARCH_ID = "minicpm3-4b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, n_layers=62, d_model=2560, n_heads=40, n_kv=40,
        d_ff=6400, vocab=73448,
        mla=MLAConfig(q_lora=768, kv_lora=256, qk_nope=64, qk_rope=32,
                      v_dim=64))


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=4,
        d_ff=96, vocab=128,
        mla=MLAConfig(q_lora=32, kv_lora=16, qk_nope=16, qk_rope=8,
                      v_dim=16))
