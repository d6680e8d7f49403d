"""phi3.5-moe-42b-a6.6b — 32L d_model=4096 32H (GQA kv=8) moe_dff=6400
vocab=32064, 16 experts top-2 [hf:microsoft/Phi-3.5-MoE-instruct]."""
from repro_torch.models.config import ModelConfig

ARCH = "phi3.5-moe-42b-a6.6b"


def full_config(**overrides) -> ModelConfig:
    base = dict(
        arch=ARCH,
        family="moe",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_head=128,
        d_ff=0,
        moe_dff=6400,
        n_experts=16,
        top_k=2,
        n_shared=0,
        first_k_dense=0,
        vocab=32064,
        rope="neox",
        rope_theta=1e4,
        capacity_factor=1.25,
        router="topk",
    )
    base.update(overrides)
    return ModelConfig(**base)
