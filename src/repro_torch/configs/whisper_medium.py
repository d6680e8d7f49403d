"""whisper-medium — enc-dec audio backbone: 24L enc + 24L dec, d_model=1024
16H d_ff=4096 vocab=51865 [arXiv:2212.04356]. The conv/mel frontend is a
STUB: input_specs() provides precomputed frame embeddings [B, 1500, d]."""
from repro_torch.models.config import ModelConfig

ARCH = "whisper-medium"


def full_config(**overrides) -> ModelConfig:
    base = dict(
        arch=ARCH,
        family="encdec",
        n_layers=24,  # decoder layers
        n_enc_layers=24,
        enc_len=1500,  # 30 s of audio after conv downsampling
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_head=64,
        d_ff=4096,
        vocab=51865,
        rope="none",
        act="gelu",
        norm="layernorm",
        tie_embeddings=True,
    )
    base.update(overrides)
    return ModelConfig(**base)
