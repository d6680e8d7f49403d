"""Continuous-batching decode engine (the serving substrate behind the
router).

One replica is one batched decode step over a fixed pool of ``n_slots``
slots; each slot holds an independent sequence and its row of the cache
(the KV cache of attention layers, the conv and SSD state of SSM layers).
Requests are admitted into free slots between steps, finished slots free
their row, and every active slot advances one token per engine tick.

  * Per-row positions: each row decodes at its own depth. The JAX package
    vmaps the single-sequence decode over the slots with each row's cache
    length injected; here one batched step takes ``pos`` i64[n_slots],
    each row writes its k/v at its own index and attends over ``kpos <=
    pos_row``.
  * MoE rows are routed alone (``api.decode_fn(per_row=True)``): each
    row's token gets its own expert capacity, ppot counts and draws, as
    each slot's does under the reference's vmap. Routed jointly, the rows
    of a step would share one capacity (1 slot an expert for moonshot's
    64 experts top-6 at 4 slots) and drop each other's tokens.
  * A step computes every row; only the active rows are merged back
    (``_merge_rows``), so an idle row's cache and position stay as they
    were.
  * Admission zeroes the admitted slots' SSM rows (``conv_x``,
    ``conv_bc``, ``h``) beside resetting their position. The JAX engine
    resets only the position (``src/repro/serving/engine.py:141-151``):
    a stale attention row is masked by position, but an SSM state is read
    as it stands, so there a request admitted into a reused slot starts
    from the previous request's final state. Here it starts from zero, as
    it would in a fresh engine.
  * Admission replays the prompts through the same step, all admitted
    slots together, one token step at a time: a step whose tokens are all
    the sentinel -1 is skipped, and a step merges only the rows that had a
    token. The token steps are padded to a power-of-two bucket (from 8),
    or with ``prefill_chunk=C`` cut into [C, n_slots] pieces, of which
    all-sentinel pieces are skipped; both are the JAX package's replay
    shapes, and the decoded tokens are the same either way.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models import api
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class Slot:
    rid: int = -1
    remaining: int = 0
    produced: "list[int]" = dataclasses.field(default_factory=list)


class ContinuousBatchingEngine:
    """A slot pool over one model, on the model's device."""

    def __init__(self, cfg: ModelConfig, model, *, n_slots: int = 4,
                 max_len: int = 128, prefill_chunk: int | None = None):
        if cfg.family == "encdec":
            raise NotImplementedError("engine drives decoder-only families")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        self.cfg = cfg
        self.model = model
        self.device = model.embed.device
        self.n_slots = n_slots
        self.max_len = max_len
        self.prefill_chunk = prefill_chunk
        self.cache = api.init_cache(cfg, n_slots, max_len, self.device)
        self.pos = torch.zeros(n_slots, dtype=torch.long, device=self.device)
        self.last_tok = torch.zeros(n_slots, 1, dtype=torch.long, device=self.device)
        self.active = np.zeros(n_slots, bool)
        self.slots = [Slot() for _ in range(n_slots)]
        self.last_logits = None  # [n_slots, 1, V] of the last tick

    def _admit_replay_multi(self, model, toks, pos, last_tok, cache):
        """Replay token steps ``toks`` i64[T, n_slots] (time-major; -1 =
        no token for this slot at this step). Each step teacher-forces the
        rows that have a token and merges only those rows; all-sentinel
        steps are skipped. Returns (last_tok, pos, cache)."""
        for tok_row, mask in zip(toks, (toks >= 0).cpu().numpy()):
            if not mask.any():
                continue
            m = torch.from_numpy(mask).to(self.device)
            lt = torch.where(m[:, None], tok_row[:, None], last_tok)
            _, cache2, pos2 = _batched_decode(self.cfg, model, lt, pos, cache)
            cache = _merge_rows(cache2, cache, m)
            pos = torch.where(m, pos2, pos)
            last_tok = lt
        return last_tok, pos, cache

    # -- slot management -----------------------------------------------------
    def try_admit(self, rid: int, prompt: np.ndarray, n_new: int) -> bool:
        return self.try_admit_batch([(rid, prompt, n_new)])[0]

    def try_admit_batch(
        self, requests: "list[tuple[int, np.ndarray, int]]"
    ) -> "list[bool]":
        """Admit ``(rid, prompt, n_new)`` requests into free slots, in
        order, as many as there are free slots. All accepted prompts but
        their last token replay together (``max`` prompt length steps, not
        the sum); each slot's last prompt token is left in ``last_tok`` so
        that the next tick emits its first generated token. Returns one
        accept flag per request."""
        free = [i for i in range(self.n_slots) if not self.active[i]]
        accept: list[bool] = []
        admitted: list[tuple[int, np.ndarray]] = []
        for rid, prompt, n_new in requests:
            if not free:
                accept.append(False)
                continue
            i = free.pop(0)
            self.slots[i] = Slot(rid=rid, remaining=n_new)
            self.pos[i] = 0
            admitted.append((i, np.asarray(prompt)))
            accept.append(True)
        if not admitted:
            return accept
        _zero_ssm_rows(self.cache, [i for i, _ in admitted])
        P = max(len(p) - 1 for _, p in admitted)
        if P > 0:
            C = self.prefill_chunk
            if C is None:
                bucket = 8  # whole-prompt replay, padded to a power of two
                while bucket < P:
                    bucket <<= 1
            else:
                bucket = -(-P // C) * C  # fixed [C, n_slots] pieces
            toks = np.full((bucket, self.n_slots), -1, np.int64)
            for i, p in admitted:
                if len(p) > 1:
                    toks[: len(p) - 1, i] = p[:-1]
            step = bucket if C is None else C
            for s in range(0, bucket, step):
                piece = toks[s:s + step]
                if C is not None and not (piece >= 0).any():
                    continue
                self.last_tok, self.pos, self.cache = self._admit_replay_multi(
                    self.model, torch.from_numpy(piece).to(self.device), self.pos,
                    self.last_tok, self.cache)
        for i, p in admitted:
            self.last_tok[i, 0] = int(p[-1])
            self.active[i] = True
        return accept

    # -- the engine tick -----------------------------------------------------
    def step(self) -> "list[tuple[int, list[int]]]":
        """Advance every active slot one token; returns finished
        (rid, produced_tokens) pairs."""
        if not self.active.any():
            return []
        logits, cache, pos = _batched_decode(self.cfg, self.model, self.last_tok, self.pos,
                                             self.cache)
        act = torch.from_numpy(self.active).to(self.device)
        self.cache = _merge_rows(cache, self.cache, act)
        self.pos = torch.where(act, pos, self.pos)
        self.last_logits = logits
        nxt = torch.argmax(logits[:, -1], dim=-1)
        self.last_tok = torch.where(act[:, None], nxt[:, None], self.last_tok)

        done = []
        nxt_np = nxt.cpu().numpy()
        pos_np = self.pos.cpu().numpy()
        for i in range(self.n_slots):
            if not self.active[i]:
                continue
            s = self.slots[i]
            s.produced.append(int(nxt_np[i]))
            s.remaining -= 1
            if s.remaining <= 0 or int(pos_np[i]) >= self.max_len - 1:
                done.append((s.rid, s.produced))
                self.active[i] = False
                self.slots[i] = Slot()
        return done

    @property
    def utilization(self) -> float:
        return float(self.active.mean())


def _batched_decode(cfg: ModelConfig, model, tokens, pos, cache):
    """One decode step with per-row positions: row b writes at ``pos[b]``
    (its attention cache length) and attends over ``kpos <= pos[b]``.
    Returns (logits [B, 1, V], new_cache, pos + 1)."""
    rows = [{part: dict(c, len=pos) if part == "attn" else c for part, c in layer.items()}
            for layer in cache]
    logits, new = api.decode_fn(cfg, model, {"tokens": tokens, "pos": pos}, rows,
                                per_row=True)
    new = [{part: dict(c, len=old["attn"]["len"]) if part == "attn" else c
            for part, c in layer.items()} for layer, old in zip(new, cache)]
    return logits, new, pos + 1


def _merge_rows(new, old, mask):
    """Per layer and cache part, rows of ``new`` where ``mask``
    (bool[n_slots]) holds, of ``old`` elsewhere. The slot axis is 0 for
    every leaf; the ``len`` entries keep ``old`` (the step sets them from
    the positions)."""
    out = []
    for n_layer, o_layer in zip(new, old):
        merged = {}
        for part, n in n_layer.items():
            o = o_layer[part]
            merged[part] = {}
            for key, a in n.items():
                if key == "len":
                    merged[part][key] = o[key]
                else:
                    m = mask.reshape((-1,) + (1,) * (a.dim() - 1))
                    merged[part][key] = torch.where(m, a, o[key])
        out.append(merged)
    return out


def _zero_ssm_rows(cache, slots: "list[int]") -> None:
    """Zero the SSM state rows of ``slots``, in place: the engine owns its
    cache tensors (each tick's merge makes new ones)."""
    idx = torch.tensor(slots, dtype=torch.long)
    for layer in cache:
        for a in layer.get("ssm", {}).values():
            a[idx.to(a.device)] = 0
