"""glm4-9b — dense: 40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552,
partial (2d-style) RoPE over half the head dims [hf:THUDM/glm-4-9b]."""
from repro_torch.models.config import ModelConfig

ARCH = "glm4-9b"


def full_config(**overrides) -> ModelConfig:
    base = dict(
        arch=ARCH,
        family="dense",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=2,
        d_head=128,
        d_ff=13696,
        vocab=151552,
        rope="partial",
        rope_frac=0.5,
        rope_theta=1e4,
    )
    base.update(overrides)
    return ModelConfig(**base)
