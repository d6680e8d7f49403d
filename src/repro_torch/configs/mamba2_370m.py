"""mamba2-370m — SSD (state-space duality): 48L d_model=1024, attn-free,
vocab=50280, ssm_state=128 [arXiv:2405.21060]. Runs long_500k (O(1)-state
decode)."""
from repro_torch.models.config import ModelConfig

ARCH = "mamba2-370m"


def full_config(**overrides) -> ModelConfig:
    base = dict(
        arch=ARCH,
        family="ssm",
        n_layers=48,
        d_model=1024,
        n_heads=0,
        n_kv_heads=0,
        d_head=0,
        d_ff=0,
        vocab=50280,
        rope="none",
        ssm_state=128,
        ssm_headdim=64,
        ssm_expand=2,
        d_conv=4,
        ssm_chunk=128,
        tie_embeddings=True,
    )
    base.update(overrides)
    return ModelConfig(**base)
