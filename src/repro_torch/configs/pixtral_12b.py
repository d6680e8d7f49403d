"""pixtral-12b — VLM: 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072, pixtral-ViT frontend STUB (input_specs() provides 1024
precomputed patch embeddings merged into the sequence prefix)
[hf:mistralai/Pixtral-12B-2409]."""
from repro_torch.models.config import ModelConfig

ARCH = "pixtral-12b"


def full_config(**overrides) -> ModelConfig:
    base = dict(
        arch=ARCH,
        family="vlm",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        d_head=128,
        d_ff=14336,
        vocab=131072,
        rope="neox",
        rope_theta=1e6,
        n_patches=1024,
    )
    base.update(overrides)
    return ModelConfig(**base)
