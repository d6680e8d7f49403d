"""moonshot-v1-16b-a3b — kimi/moonlight MoE: 48L d_model=2048 16H (kv=16)
moe_dff=1408 vocab=163840, 64 experts top-6 (+2 shared, first layer dense)
[hf:moonshotai/Moonlight-16B-A3B]."""
from repro_torch.models.config import ModelConfig

ARCH = "moonshot-v1-16b-a3b"


def full_config(**overrides) -> ModelConfig:
    base = dict(
        arch=ARCH,
        family="moe",
        n_layers=48,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_head=128,
        d_ff=11264,  # dense FFN width for the first_k_dense layer
        moe_dff=1408,
        n_experts=64,
        top_k=6,
        n_shared=2,
        first_k_dense=1,
        vocab=163840,
        rope="neox",
        rope_theta=5e4,
        capacity_factor=1.25,
        router="topk",
    )
    base.update(overrides)
    return ModelConfig(**base)
