"""Model API of the port: every family of the reference's registry (the
decoder-only dense, moe, vlm, ssm and hybrid families in ``lm``, the
encoder-decoder family in ``encdec``).

    init_params(cfg, seed, device)       -> model (nn.Module)
    trainable(model)                     parameters that take gradients
    loss_fn(cfg, model, batch, rng)      -> (loss, {"ce", "aux"})
    init_cache(cfg, batch, max_len, device) -> cache
    prefill(cfg, model, batch)           -> logits at the last position
    decode_fn(cfg, model, batch, cache)  -> (logits, cache)
    plain_paths()                        context: no kernels on the card

``device=None`` is the CUDA card and raises without one; pass
``device="cpu"`` to run on the CPU.
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

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


def trainable(model: nn.Module) -> nn.Module:
    """Switch every parameter of ``model`` to take gradients, in place;
    ``init_params`` makes them without (serving). Returns the model."""
    for p in model.parameters():
        p.requires_grad_(True)
    return model


def _chunk_loss(cfg, model, logits_fn, hc, yc, mc):
    logits = logits_fn(cfg, model, hc).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, yc.long()[..., None])[..., 0]
    return ((lse - gold) * mc).sum(), mc.sum()


def xent_sums(cfg: ModelConfig, model: nn.Module, hidden, labels, mask, logits_fn):
    """The masked cross-entropy's (sum, count), f32, without materialising
    [B, S, V]: the sequence in chunks of ``C = min(loss_chunk, S)`` (``C =
    S`` where that does not divide S), each chunk's logits recomputed in
    the backward (the reference's ``jax.checkpoint`` on its chunk), the
    chunks' sums added in order."""
    S = hidden.shape[1]
    C = min(cfg.loss_chunk, S)
    if S % C:
        C = S
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, S, C):
        args = (cfg, model, logits_fn, hidden[:, c0:c0 + C], labels[:, c0:c0 + C],
                mask[:, c0:c0 + C].float())
        if torch.is_grad_enabled():
            s, n = checkpoint(_chunk_loss, *args, use_reentrant=False)
        else:
            s, n = _chunk_loss(*args)
        tot, cnt = tot + s, cnt + n
    return tot, cnt


def chunked_xent(cfg: ModelConfig, model: nn.Module, hidden, labels, mask, logits_fn):
    """Cross-entropy averaged over the mask (``src/repro/models/api.py:27-55``)."""
    tot, cnt = xent_sums(cfg, model, hidden, labels, mask, logits_fn)
    return tot / cnt.clamp_min(1.0)


def loss_fn(cfg: ModelConfig, model: nn.Module, batch, rng=None, *, denom=None):
    """batch: tokens [B, S], labels [B, S], mask [B, S] (+ ``patch_embeds``
    (vlm) or ``frame_embeds`` (encdec)). rng: a host key for the ppot
    router. Returns (loss, {"ce", "aux"}): ce the masked mean token
    cross-entropy, loss = ce + 0.01 aux with aux the MoE layers' summed
    load-balance loss (0 for the other families). denom: divide the
    cross-entropy's sum by this count instead of the batch's own (a rank's
    share of a batch split over ranks, ``dist/steps.py``)."""
    tokens, labels, mask = (_on(model, batch[k]) for k in ("tokens", "labels", "mask"))
    if cfg.family == "encdec":
        enc_out = ED.encode(cfg, model, _on(model, batch["frame_embeds"]))
        hidden, _ = ED.decode(cfg, model, tokens, enc_out)
        aux = torch.zeros((), dtype=torch.float32, device=hidden.device)
        head = ED.logits_head
    else:
        patches = batch.get("patch_embeds")
        hidden, aux = LM.forward(cfg, model, tokens, rng=rng, with_aux=True,
                                 patch_embeds=None if patches is None else _on(model, patches))
        head = LM.logits_head
    tot, cnt = xent_sums(cfg, model, hidden, labels, mask, head)
    ce = tot / (cnt.clamp_min(1.0) if denom is None else denom)
    loss = ce if cfg.family == "encdec" else ce + 0.01 * aux
    return loss, {"ce": ce, "aux": aux}


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
