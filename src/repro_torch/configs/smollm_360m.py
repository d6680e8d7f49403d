"""smollm-360m — llama-arch small: 32L d_model=960 15H (GQA kv=5) d_ff=2560
vocab=49152 [hf:HuggingFaceTB/SmolLM family]."""
from repro_torch.models.config import ModelConfig

ARCH = "smollm-360m"


def full_config(**overrides) -> ModelConfig:
    base = dict(
        arch=ARCH,
        family="dense",
        n_layers=32,
        d_model=960,
        n_heads=15,
        n_kv_heads=5,
        d_head=64,
        d_ff=2560,
        vocab=49152,
        rope="neox",
        rope_theta=1e4,
        tie_embeddings=True,
    )
    base.update(overrides)
    return ModelConfig(**base)
