"""Model API of the port: every family of the reference's registry (the
decoder-only dense, moe, vlm, ssm and hybrid families in ``lm``, the
encoder-decoder family in ``encdec``).

    init_params(cfg, seed, device)       -> model (nn.Module)
    init_cache(cfg, batch, max_len, device) -> cache
    prefill(cfg, model, batch)           -> logits at the last position
    decode_fn(cfg, model, batch, cache)  -> (logits, cache)
    plain_paths()                        context: no kernels on the card

``device=None`` is the CUDA card and raises without one; pass
``device="cpu"`` to run on the CPU. ``loss_fn`` / ``chunked_xent`` wait
for the training slice (ROADMAP A9).
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn

from repro_torch.models import encdec as ED
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
    if cfg.family != "encdec" and cfg.family not in LM.FAMILIES:
        raise ValueError(f"unknown model family {cfg.family!r}")


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> nn.Module:
    """Random parameters from ``seed`` (a ``torch.Generator`` on the
    device)."""
    _check_family(cfg)
    mod = ED if cfg.family == "encdec" else LM
    return mod.init_params(cfg, seed, resolve_device(device))


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    _check_family(cfg)
    mod = ED if cfg.family == "encdec" else LM
    return mod.init_cache(cfg, batch, max_len, resolve_device(device))


def _on(model: nn.Module, a) -> torch.Tensor:
    return torch.as_tensor(a, device=model.embed.device)


@torch.no_grad()
def decode_fn(cfg: ModelConfig, model: nn.Module, batch, cache, *, per_row: bool = False):
    """One-token decode against a filled cache. batch: tokens [B, 1], pos
    (the current write position: a scalar, or i64[B] per row), and
    enc_out [B, enc_len, d] for the encdec family. per_row: route each row
    alone in the MoE layers, as the reference's engine does (its decode
    maps one sequence's step over the slots); without it the B rows share
    the experts' capacity, as ``decode_fn`` on B rows does in the
    reference."""
    tokens = _on(model, batch["tokens"])
    if cfg.family == "encdec":
        hidden, nc = ED.decode(cfg, model, tokens, _on(model, batch["enc_out"]), cache=cache,
                               pos0=batch["pos"])
        return ED.logits_head(cfg, model, hidden), nc
    return LM.decode_step(cfg, model, tokens, batch["pos"], cache, per_row=per_row)


@torch.no_grad()
def prefill(cfg: ModelConfig, model: nn.Module, batch):
    """Forward over the prompt, returning the last position's logits
    [B, 1, V] (the inference prefill path: no loss, no cache). batch:
    tokens [B, S], with ``patch_embeds`` [B, n_patches, d] (vlm) or
    ``frame_embeds`` [B, enc_len, d] (encdec)."""
    tokens = _on(model, batch["tokens"])
    if cfg.family == "encdec":
        enc_out = ED.encode(cfg, model, _on(model, batch["frame_embeds"]))
        hidden, _ = ED.decode(cfg, model, tokens, enc_out)
        return ED.logits_head(cfg, model, hidden[:, -1:, :])
    patches = batch.get("patch_embeds")
    hidden = LM.forward(cfg, model, tokens,
                        patch_embeds=None if patches is None else _on(model, patches))
    return LM.logits_head(cfg, model, hidden[:, -1:, :])
