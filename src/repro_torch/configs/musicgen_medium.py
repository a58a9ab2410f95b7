"""musicgen-medium: 48L d=1536 24H (kv=24) d_ff=6144 vocab=2048;
decoder-only over EnCodec tokens [arXiv:2306.05284].  The EnCodec modality
frontend is a STUB: precomputed frame embeddings come in."""
from ..models.lm import ModelConfig

ARCH_ID = "musicgen-medium"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, n_layers=48, d_model=1536, n_heads=24, n_kv=24,
        d_ff=6144, vocab=2048, frontend="audio_stub")


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=4,
        d_ff=128, vocab=64, frontend="audio_stub")
