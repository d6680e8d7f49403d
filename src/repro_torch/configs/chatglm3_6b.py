"""chatglm3-6b — dense: 28L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=65024, 2d RoPE (rotary over half the head dims) [arXiv:2406.12793]."""
from repro_torch.models.config import ModelConfig

ARCH = "chatglm3-6b"


def full_config(**overrides) -> ModelConfig:
    base = dict(
        arch=ARCH,
        family="dense",
        n_layers=28,
        d_model=4096,
        n_heads=32,
        n_kv_heads=2,
        d_head=128,
        d_ff=13696,
        vocab=65024,
        rope="partial",
        rope_frac=0.5,
        rope_theta=1e4,
    )
    base.update(overrides)
    return ModelConfig(**base)
