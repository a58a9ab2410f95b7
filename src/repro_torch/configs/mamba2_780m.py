"""mamba2-780m: 48L d=1536 attention-free, vocab=50280, ssm_state=128;
SSD (state-space duality) [arXiv:2405.21060].  d_inner=3072, head_dim=64
-> 48 SSM heads."""
from ..models.lm import ModelConfig
from ..models.mamba import MambaConfig

ARCH_ID = "mamba2-780m"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, n_layers=48, d_model=1536, n_heads=0, n_kv=0,
        d_ff=0, vocab=50280, mixer="mamba",
        mamba=MambaConfig(d_state=128, head_dim=64, n_groups=1, expand=2,
                          chunk=256))


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", n_layers=3, d_model=64, n_heads=0, n_kv=0,
        d_ff=0, vocab=128, mixer="mamba",
        mamba=MambaConfig(d_state=16, head_dim=16, n_groups=1, expand=2,
                          chunk=16))
