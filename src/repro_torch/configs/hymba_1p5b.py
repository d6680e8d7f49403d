"""hymba-1.5b — hybrid: 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, parallel attn+mamba heads, ssm_state=16 [arXiv:2411.13676].
Attention is sliding-window (meta-token mechanism out of scope — DESIGN.md
§4), so with the SSM path the arch is sub-quadratic and runs long_500k."""
from repro_torch.models.config import ModelConfig

ARCH = "hymba-1.5b"


def full_config(**overrides) -> ModelConfig:
    base = dict(
        arch=ARCH,
        family="hybrid",
        n_layers=32,
        d_model=1600,
        n_heads=25,
        n_kv_heads=5,
        d_head=64,
        d_ff=5504,
        vocab=32001,
        rope="neox",
        rope_theta=1e4,
        attn_window=1024,
        ssm_state=16,
        ssm_headdim=64,
        ssm_expand=2,
        d_conv=4,
        ssm_chunk=128,
    )
    base.update(overrides)
    return ModelConfig(**base)
