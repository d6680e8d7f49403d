"""qwen3-32b — dense: 64L d_model=5120 64H (GQA kv=8) d_ff=25600
vocab=151936, qk_norm [hf:Qwen/Qwen3-8B family]."""
from repro_torch.models.config import ModelConfig

ARCH = "qwen3-32b"


def full_config(**overrides) -> ModelConfig:
    base = dict(
        arch=ARCH,
        family="dense",
        n_layers=64,
        d_model=5120,
        n_heads=64,
        n_kv_heads=8,
        d_head=128,
        d_ff=25600,
        vocab=151936,
        rope="neox",
        rope_theta=1e6,
        qk_norm=True,
    )
    base.update(overrides)
    return ModelConfig(**base)
