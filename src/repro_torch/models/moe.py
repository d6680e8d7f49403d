"""Mixture-of-Experts layer with two routers:

* ``topk``: softmax top-k gating (moonshot 64 experts top-6, phi3.5 16
  top-2) with capacity-based dropping;
* ``ppot``: Rosella's two-choice rule applied to experts. Each routing
  slot draws two experts from the gate distribution (the gates play the
  part of μ̂) and keeps the one with the lower running load (SQ(2)); the
  loads update between slots, and all tokens of a slot see the same
  counts.

Expert computation is sort-based: tokens are bucketed by expert into an
[E, C, d] buffer (C the capacity), run through batched matrix products
(``torch.bmm``) and combined with their gate weights.

Groups. ``moe_apply(..., per_row=True)`` routes each batch row as a group
of its own: its own capacity, its own ppot counts, and the same draws in
every row. That is what the JAX package's engine computes, whose batched
decode maps a single-sequence decode over the slots
(``src/repro/serving/engine.py:225-251``), so there each slot's token is
routed alone. Without it the tokens of all rows share the capacity and
the counts, as ``decode_fn`` on B rows does in the reference.

Determinism. A token's output is its k contributions summed in a fixed
order, the reference's (the expert-sorted order of its scatter-add), in
the model dtype, so that the card gives the CPU's order and the same
result every run (no atomics). Only kept rows are written into the
buffer; the reference's overflow bin, which receives the dropped rows'
duplicate writes and is thrown away, is not needed.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.utils import prng


def init_moe(cfg: ModelConfig, gen: torch.Generator) -> nn.Module:
    d, E, f, pdt = cfg.d_model, cfg.n_experts, cfg.moe_dff, L._pdtype(cfg)
    p = nn.Module()
    p.router = L.dense_init(gen, (d, E), torch.float32, scale=0.02)
    p.wg = L.dense_init(gen, (E, d, f), pdt)
    p.wu = L.dense_init(gen, (E, d, f), pdt)
    p.wd = L.dense_init(gen, (E, f, d), pdt, scale=1.0 / math.sqrt(f))
    if cfg.n_shared:
        fs = cfg.n_shared * f
        p.shared = nn.Module()
        p.shared.wg = L.dense_init(gen, (d, fs), pdt)
        p.shared.wu = L.dense_init(gen, (d, fs), pdt)
        p.shared.wd = L.dense_init(gen, (fs, d), pdt, scale=1.0 / math.sqrt(fs))
    return p


def capacity(cfg: ModelConfig, n_tokens: int, n_experts: int) -> int:
    c = int(math.ceil(n_tokens * cfg.top_k / n_experts * cfg.capacity_factor))
    return max(c, 1)


def _normalized(w):
    """w / max(Σ w, 1e-9) over the last axis, summed left to right."""
    tot = w[..., 0]
    for j in range(1, w.shape[-1]):
        tot = tot + w[..., j]
    return w / tot.clamp_min(1e-9)[..., None]


def topk_route(cfg: ModelConfig, gates):
    """gates [..., E] -> (idx i32 [..., k], w [..., k]), the weights
    renormalized. Among equal gates the lower index comes first, as
    ``jax.lax.top_k`` orders them: a stable descending sort."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    k = cfg.top_k
    return idx[..., :k].to(torch.int32), _normalized(vals[..., :k])


def ppot_route(cfg: ModelConfig, gates, key):
    """Rosella routing. gates [T, E], or [G, T, E]: G groups, each routed
    alone (counts of its own) with the same draws. Per slot: two
    proportional samples (``categorical`` under ``split(fold_in(key,
    slot))``), keep the one with the lower running expert load; the loads
    update between slots. key: a host key (``prng.PRNGKey``)."""
    grouped = gates.dim() == 3
    g3 = gates if grouped else gates[None]
    G, T, E = g3.shape
    logits = torch.log(g3.clamp_min(1e-30))
    counts = torch.zeros(G, E, dtype=torch.float32, device=gates.device)
    idxs, ws = [], []
    for slot in range(cfg.top_k):
        k1, k2 = prng.split(prng.fold_in(key, slot))
        j1 = torch.argmax(prng.gumbel(k1, (T, E), gates.device) + logits, dim=-1)
        j2 = torch.argmax(prng.gumbel(k2, (T, E), gates.device) + logits, dim=-1)
        j = torch.where(counts.gather(1, j1) <= counts.gather(1, j2), j1, j2)
        idxs.append(j)
        ws.append(g3.gather(2, j[..., None])[..., 0])
        counts = counts.scatter_add(1, j, torch.ones_like(j, dtype=torch.float32))
    idx = torch.stack(idxs, -1).to(torch.int32)
    w = _normalized(torch.stack(ws, -1))
    return (idx, w) if grouped else (idx[0], w[0])


class RouteTape:
    """The top-k routes of every MoE layer a model runs, taped, to hold two
    paths of one model (the kernels' and the plain one) to each other on the
    same routes. In bf16 one token whose k-th and (k+1)-th gates two
    roundings part takes another expert, and where an expert overflows its
    capacity that moves which later tokens it drops.

    ``recording()``: each layer's routes (``topk_route`` of its gates) are
    kept in ``routes``, in order, with its ``expert_load_stats`` in
    ``stats``. ``replaying()``: each layer takes the next taped routes
    instead of its own, its weights its own gates there renormalized;
    ``flips`` counts the tokens whose own routes differed."""

    def __init__(self):
        self.routes, self.stats, self.flips, self._at = [], [], 0, None

    def route(self, cfg: ModelConfig, gates):
        idx, w = topk_route(cfg, gates)
        if self._at is None:
            self.routes.append(idx)
            self.stats.append(expert_load_stats(cfg, gates, idx))
            return idx, w
        taped = self.routes[self._at]
        self._at += 1
        self.flips += int((idx != taped).any(-1).sum())
        return taped, _normalized(gates.gather(-1, taped.long()))

    @contextlib.contextmanager
    def _in_use(self):
        global _TAPE
        _TAPE = self
        try:
            yield self
        finally:
            _TAPE = None

    def recording(self):
        self.routes, self.stats, self._at = [], [], None
        return self._in_use()

    def replaying(self):
        self.flips, self._at = 0, 0
        return self._in_use()


_TAPE: RouteTape | None = None  # the tape a top-k layer routes through, if any


def expert_compute(cfg: ModelConfig, pe, x, idx, w, cap: int, groups: int = 1):
    """Sort-based dispatch -> batched expert products -> weighted combine.

    x [B, S, d]; idx / w [B, S, k]; pe holds the experts' weights (wg, wu,
    wd [E, ...]). The B*S tokens form ``groups`` equal groups in order,
    each with ``cap`` slots an expert; within a group the assignments are
    stably sorted by expert and an expert keeps its first ``cap``. The
    buffer holds every group's slots of an expert together, [E, groups *
    cap, d], so one product covers all groups."""
    B, S, d = x.shape
    k = idx.shape[-1]
    E = pe.wg.shape[0]
    G = groups
    Tg = B * S // G
    dt = L._dtype(cfg)
    dev = x.device
    xf = x.reshape(B * S, d)
    idxf = idx.reshape(G, Tg * k).long()
    wf = w.reshape(G, Tg * k)

    se, order = torch.sort(idxf, dim=-1, stable=True)
    seg_start = torch.searchsorted(se, torch.arange(E, device=dev).expand(G, E).contiguous())
    pos = torch.arange(Tg * k, device=dev) - seg_start.gather(1, se)
    keep = pos < cap
    grp = torch.arange(G, device=dev)[:, None]
    slot = se * (G * cap) + grp * cap + pos
    tok = grp * Tg + order // k  # each sorted assignment's token, flat over the groups

    buf = torch.zeros(E * G * cap, d, dtype=dt, device=dev)
    buf[slot[keep]] = xf[tok[keep]].to(dt)
    hb = buf.view(E, G * cap, d)
    h = F.silu(torch.bmm(hb, pe.wg.to(dt))) * torch.bmm(hb, pe.wu.to(dt))
    ob = torch.bmm(h, pe.wd.to(dt)).reshape(E * G * cap, d)

    # back to each token's k assignments, kept slot or none
    slot_u = torch.empty_like(slot).scatter_(1, order, torch.where(keep, slot, -1))
    slot_u = slot_u.reshape(B * S, k)
    kept = slot_u >= 0
    contrib = ob[slot_u.clamp_min(0)] * wf.reshape(B * S, k, 1).to(dt)
    contrib = torch.where(kept[..., None], contrib, torch.zeros((), dtype=dt, device=dev))
    # the reference's scatter-add order: a token's assignments by (expert, slot)
    rank = torch.sort(idx.reshape(B * S, k), dim=-1, stable=True).indices
    contrib = contrib.gather(1, rank[..., None].expand(B * S, k, d))
    out = torch.zeros(B * S, d, dtype=dt, device=dev)
    for j in range(k):
        out = out + contrib[:, j]
    return out.reshape(B, S, d)


def _expert_counts(idx, n_experts: int):
    flat = idx.reshape(-1).long()
    return torch.zeros(n_experts, dtype=torch.float32, device=idx.device).scatter_add(
        0, flat, torch.ones_like(flat, dtype=torch.float32))


def load_balance_loss(gates, idx, n_experts: int):
    """Switch-style aux loss: E · Σ_e f_e · p_e. gates [T, E]; idx [T, k]."""
    T, k = gates.shape[0], idx.shape[-1]
    f = _expert_counts(idx, n_experts)
    f = f / torch.full_like(f, T * k)
    pmean = gates.mean(0)
    return n_experts * (f * pmean).sum()


def moe_apply(cfg: ModelConfig, p, x, *, rng=None, shard_ctx=None, per_row: bool = False):
    """Returns (out [B, S, d], aux_loss f32 scalar). rng: the ppot
    router's host key (None: ``PRNGKey(0)``); per_row: route each batch
    row as a group of its own (the module docstring)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    if shard_ctx is not None and shard_ctx.ep_size > 1:
        raise NotImplementedError("the expert-parallel branch of moe_apply is not ported: "
                                  "no entry point of the reference reaches it (ROADMAP, "
                                  "Departures, unreached)")
    G = B if per_row else 1
    gates = torch.softmax((x.float() @ p.router).reshape(B * S, E), dim=-1)
    if cfg.router == "ppot":
        key = rng if rng is not None else prng.PRNGKey(0)
        idx, w = ppot_route(cfg, gates.view(G, B * S // G, E), key)
    else:
        idx, w = (topk_route if _TAPE is None else _TAPE.route)(cfg, gates)
    aux = load_balance_loss(gates, idx.reshape(B * S, k), E)
    idx = idx.reshape(B, S, k)
    w = w.reshape(B, S, k).to(x.dtype)
    out = expert_compute(cfg, p, x, idx, w, capacity(cfg, B * S // G, E), groups=G)
    if cfg.n_shared:
        sp, dt = p.shared, L._dtype(cfg)
        g = F.silu(x @ sp.wg.to(dt)) * (x @ sp.wu.to(dt))
        out = out + g @ sp.wd.to(dt)
    return out, aux


def expert_load_stats(cfg: ModelConfig, gates, idx) -> dict:
    """Max / mean expert load and the overflow fraction at the configured
    capacity: the metric the ppot router improves (benchmarks/moe_balance).
    gates [T, E]; idx [T, k]."""
    T, k = gates.shape[0], idx.shape[-1]
    counts = _expert_counts(idx, cfg.n_experts)
    cap = capacity(cfg, T, cfg.n_experts)
    over = (counts - cap).clamp_min(0).sum()
    return {"max_load": counts.max(), "mean_load": counts.mean(),
            "overflow_frac": over / torch.full_like(over, T * k), "capacity": cap}
