"""Architecture registry of the port, keyed by arch id: the reference's
ten architectures, in its order."""
from __future__ import annotations

from repro_torch.configs import (chatglm3_6b, glm4_9b, hymba_1p5b, mamba2_370m,
                                 moonshot_v1_16b_a3b, phi35_moe_42b_a66b, pixtral_12b,
                                 qwen3_32b, smollm_360m, whisper_medium)
from repro_torch.configs.common import SHAPES, reduced, shape_applicable

_MODULES = (moonshot_v1_16b_a3b, phi35_moe_42b_a66b, mamba2_370m, whisper_medium, glm4_9b,
            qwen3_32b, smollm_360m, chatglm3_6b, hymba_1p5b, pixtral_12b)

REGISTRY = {m.ARCH: m.full_config for m in _MODULES}
ARCHS = tuple(REGISTRY)


def get_config(arch: str, **overrides):
    if arch not in REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; available: {ARCHS}")
    return REGISTRY[arch](**overrides)


__all__ = ["ARCHS", "REGISTRY", "SHAPES", "get_config", "reduced", "shape_applicable"]
