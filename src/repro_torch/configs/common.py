"""Shapes of the architecture x shape grid and the reduced smoke config.

Four LM shapes:
  train_4k     seq 4096,   global_batch 256  -> train step
  prefill_32k  seq 32768,  global_batch 32   -> prefill (inference)
  decode_32k   seq 32768,  global_batch 128  -> serve step (1 token, KV cache)
  long_500k    seq 524288, global_batch 1    -> serve step; SSM/hybrid only
                                                (full-attention archs skip)

The dry-run's ``input_specs`` / ``cache_specs`` of the JAX package wait for
the port of ``launch/``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    step: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# families with an O(L^2) full-attention path -> long_500k is skipped
FULL_ATTENTION_FAMILIES = ("dense", "moe", "vlm", "encdec")


def shape_applicable(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    if shape == "long_500k" and cfg.family in FULL_ATTENTION_FAMILIES:
        return False, "skipped(full-attention O(L^2))"
    return True, ""


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Smoke-test config: same family/wiring, tiny dims, CPU-friendly."""
    small = dict(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 2,
        d_head=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab=256,
        dtype="float32",
        param_dtype="float32",
        remat="none",
        attn_chunk=64,
        loss_chunk=32,
        scan_layers=True,
    )
    if cfg.family == "moe":
        small.update(n_experts=4, top_k=2, moe_dff=64,
                     n_shared=min(cfg.n_shared, 1),
                     first_k_dense=min(cfg.first_k_dense, 1), d_ff=128)
    if cfg.family in ("ssm", "hybrid"):
        small.update(ssm_state=16, ssm_headdim=16, ssm_chunk=32)
    if cfg.family == "hybrid":
        small.update(attn_window=32)
    if cfg.family == "encdec":
        small.update(n_enc_layers=2, enc_len=32)
    if cfg.family == "vlm":
        small.update(n_patches=8)
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
