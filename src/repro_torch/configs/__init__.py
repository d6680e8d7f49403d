"""Architecture registry of the port, keyed by arch id.

The dense, ssm and hybrid families are ported; the other families'
configs raise ``NotImplementedError`` naming the ROADMAP item that ports
them.
"""
from __future__ import annotations

from repro_torch.configs import (chatglm3_6b, glm4_9b, hymba_1p5b, mamba2_370m,
                                 qwen3_32b, smollm_360m)
from repro_torch.configs.common import SHAPES, reduced, shape_applicable

REGISTRY = {m.ARCH: m.full_config for m in (glm4_9b, qwen3_32b, smollm_360m,
                                            chatglm3_6b, mamba2_370m, hymba_1p5b)}

#: arch -> (family, the ROADMAP item that ports it)
NOT_PORTED = {
    "moonshot-v1-16b-a3b": ("moe", "ROADMAP A, the MoE family"),
    "phi3.5-moe-42b-a6.6b": ("moe", "ROADMAP A, the MoE family"),
    "whisper-medium": ("encdec", "ROADMAP A, the encoder-decoder family"),
    "pixtral-12b": ("vlm", "ROADMAP A, the VLM family"),
}

ARCHS = tuple(REGISTRY)


def get_config(arch: str, **overrides):
    if arch in NOT_PORTED:
        family, item = NOT_PORTED[arch]
        raise NotImplementedError(f"{arch} ({family} family) is not ported yet: {item}")
    if arch not in REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; available: {ARCHS}")
    return REGISTRY[arch](**overrides)


__all__ = ["ARCHS", "NOT_PORTED", "REGISTRY", "SHAPES", "get_config", "reduced",
           "shape_applicable"]
