"""Model API of the port: the decoder-only dense, ssm and hybrid families.

    init_params(cfg, seed, device)       -> model (nn.Module)
    init_cache(cfg, batch, max_len, device) -> cache
    prefill(cfg, model, batch)           -> logits at the last position
    decode_fn(cfg, model, batch, cache)  -> (logits, cache)
    plain_paths()                        context: no kernels on the card

``device=None`` is the CUDA card and raises without one; pass
``device="cpu"`` to run on the CPU. ``loss_fn`` / ``chunked_xent`` wait
for the training slice, the encoder-decoder family for its own.
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models import lm as LM
from repro_torch.models.config import ModelConfig
from repro_torch.utils.device import resolve_device


@contextlib.contextmanager
def plain_paths():
    """Inside the block the model takes its plain chunked paths
    (``layers.flash_attention_plain``, ``ssm.ssd_chunked``) on CUDA tensors
    too: the model that the kernels' model path is held against on the
    card."""
    saved, L.PLAIN_PATHS = L.PLAIN_PATHS, True
    try:
        yield
    finally:
        L.PLAIN_PATHS = saved


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in LM.FAMILIES:
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
