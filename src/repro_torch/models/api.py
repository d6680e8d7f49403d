"""Model API of the port: the decoder-only dense family.

    init_params(cfg, seed, device)       -> model (nn.Module)
    init_cache(cfg, batch, max_len, device) -> cache
    prefill(cfg, model, batch)           -> logits at the last position
    decode_fn(cfg, model, batch, cache)  -> (logits, cache)

``device=None`` is the CUDA card and raises without one; pass
``device="cpu"`` to run on the CPU. ``loss_fn`` / ``chunked_xent`` wait
for the training slice, the encoder-decoder family for its own.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import lm as LM
from repro_torch.models.config import ModelConfig
from repro_torch.utils.device import resolve_device


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(f"the {cfg.family} family is not ported yet "
                                  f"(ROADMAP A)")


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> nn.Module:
    """Random parameters from ``seed`` (a ``torch.Generator`` on the
    device)."""
    _check_family(cfg)
    return LM.init_params(cfg, seed, resolve_device(device))


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    _check_family(cfg)
    return LM.init_cache(cfg, batch, max_len, resolve_device(device))


def _tokens(model: nn.Module, tokens) -> torch.Tensor:
    return torch.as_tensor(tokens, device=model.embed.device)


@torch.no_grad()
def decode_fn(cfg: ModelConfig, model: nn.Module, batch, cache):
    """One-token decode against a filled cache. batch: tokens [B, 1], pos
    (the current write position: a scalar, or i64[B] per row)."""
    return LM.decode_step(cfg, model, _tokens(model, batch["tokens"]), batch["pos"],
                          cache)


@torch.no_grad()
def prefill(cfg: ModelConfig, model: nn.Module, batch):
    """Forward over the prompt, returning the last position's logits
    [B, 1, V] (the inference prefill path: no loss, no cache)."""
    hidden = LM.forward(cfg, model, _tokens(model, batch["tokens"]))
    return LM.logits_head(cfg, model, hidden[:, -1:, :])
