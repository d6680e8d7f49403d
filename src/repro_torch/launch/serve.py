"""Serving entry point: N in-process replicas of a (reduced) model behind the
Rosella router, with real model decode steps as the work unit.

Replica heterogeneity on one host is emulated by giving replicas
different per-token work (paper §6.1 "controlling worker speed"): a
slowdown-s replica runs each decode s times (``--executor replica``) or
advances one engine tick every s-th loop turn (``--executor engine``,
continuous-batching ``ContinuousBatchingEngine`` slot pools fed by
multi-request admission). Requests arrive in batches of
``--arrival-batch``; the router places a batch in one dispatch call and
folds the batch's completions back in one call.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
      --replicas 4 --requests 200 --arrival-batch 8 [--executor engine] \\
      [--device cpu]

``--arch`` takes every decoder-only arch of the registry (the dense, moe,
vlm, ssm and hybrid families; the engine and the replicas drive no
encoder-decoder). ``--device`` defaults to ``cuda`` and raises without a
card.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import policies as pol
from repro_torch.models import api
from repro_torch.serving.engine import ContinuousBatchingEngine
from repro_torch.serving.router import Completion, RosellaRouter
from repro_torch.utils.device import resolve_device


class LocalReplica:
    """One model replica; ``slowdown`` k replays each decode k times."""

    def __init__(self, cfg, model, slowdown: int, max_len: int = 128):
        self.cfg = cfg
        self.model = model
        self.slowdown = slowdown
        self.max_len = max_len

    def serve(self, prompt: np.ndarray, n_new: int) -> np.ndarray:
        device = self.model.embed.device
        cache = api.init_cache(self.cfg, 1, self.max_len, device)
        toks = torch.as_tensor(np.asarray(prompt), dtype=torch.long, device=device)[None]
        out = []
        nxt = None
        for t in range(toks.shape[1] + n_new - 1):
            cur = toks[:, t:t + 1] if t < toks.shape[1] else nxt
            for _ in range(self.slowdown):
                logits, cache2 = api.decode_fn(self.cfg, self.model,
                                               {"tokens": cur, "pos": t}, cache)
            cache = cache2
            nxt = torch.argmax(logits[:, -1:], dim=-1)
            if t >= toks.shape[1] - 1:
                out.append(int(nxt[0, 0]))
        return np.asarray(out)


def _run_replica_executor(args, cfg, replicas, router, rng):
    """Sequential per-request replicas, batch-routed: one ``route(now, k)``
    places the whole batch; its completions fold back in one ``complete``
    call, stamped at their true wall times."""
    latencies = []
    t_wall = time.time()
    rid = 0
    while rid < args.requests:
        k = min(args.arrival_batch, args.requests - rid)
        now = time.time() - t_wall
        prompts = [rng.randint(1, cfg.vocab, size=4) for _ in range(k)]
        js = router.route(now, k)
        comps = []
        for prompt, j in zip(prompts, js):
            t0 = time.time()
            replicas[int(j)].serve(prompt, args.n_new)
            t1 = time.time()
            latencies.append(t1 - t0)
            comps.append(Completion(rid, int(j), t0 - t_wall, t1 - t_wall))
            rid += 1
        router.complete(comps)
    return np.asarray(latencies)


def _run_engine_executor(args, cfg, engines, slowdowns, router, rng):
    """Continuous-batching executor: each replica is a slot-pool engine;
    routed batches are admitted with ``try_admit_batch`` and replicas tick
    continuously, a slowdown-s replica every s-th loop turn. ``engines``
    arrive warmed (and rate-probed for μ̄) from ``main``."""
    pending: list[list] = [[] for _ in slowdowns]  # routed, not yet admitted
    t_arr: dict[int, float] = {}
    t_adm: dict[int, float] = {}
    latencies = []
    t_wall = time.time()
    rid = 0
    done = 0
    tick = 0
    while done < args.requests:
        if rid < args.requests:
            k = min(args.arrival_batch, args.requests - rid)
            now = time.time() - t_wall
            for j in router.route(now, k):
                pending[int(j)].append((rid, rng.randint(1, cfg.vocab, size=4)))
                t_arr[rid] = now
                rid += 1
        for r, eng in enumerate(engines):
            if tick % slowdowns[r]:
                continue  # heterogeneity: slow replicas tick less often
            if pending[r]:
                reqs = [(q, p, args.n_new) for q, p in pending[r]]
                accepted = eng.try_admit_batch(reqs)
                now = time.time() - t_wall
                pending[r] = [rp for rp, ok in zip(pending[r], accepted) if not ok]
                for (q, _p, _n), ok in zip(reqs, accepted):
                    if ok:
                        t_adm[q] = now
            comps = []
            for q, _toks in eng.step():
                now = time.time() - t_wall
                latencies.append(now - t_arr[q])
                comps.append(Completion(q, r, t_adm.get(q, t_arr[q]), now))
                done += 1
            if comps:
                router.complete(comps)
        tick += 1
    return np.asarray(latencies)


def engine_rates(engines, slowdowns, n_new: int) -> list[float]:
    """Warm each engine up (admit + step) and measure its request rate: a
    request costs about ``n_new`` decode steps, and a slowdown-s replica
    ticks every s-th loop turn. Leaves every engine idle."""
    rates = []
    for eng, s in zip(engines, slowdowns):
        eng.try_admit_batch([(-1, np.array([1, 2]), 2)])
        eng.step()
        t0 = time.time()
        eng.step()  # returns after its device-to-host copy of the tokens
        tick = max(time.time() - t0, 1e-4)
        while eng.active.any():
            eng.step()
        rates.append(1.0 / (n_new * s * tick))
    return rates


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--replicas", type=int, default=4)
    ap.add_argument("--requests", type=int, default=100)
    ap.add_argument("--n-new", type=int, default=8)
    ap.add_argument("--arrival-batch", type=int, default=1)
    ap.add_argument("--executor", default="replica", choices=("replica", "engine"))
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--policy", default=pol.PPOT_SQ2, choices=list(pol.ALL_POLICIES))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = configs.reduced(configs.get_config(args.arch))
    model = api.init_params(cfg, args.seed, device)
    slowdowns = [1 + 2 * (i % 3) for i in range(args.replicas)]  # 1x, 3x, 5x, ...

    # warm-up: run each executor's own decode path once and measure real
    # per-replica rates, so that μ̄ is in the units of the service times
    # the learner will see
    if args.executor == "engine":
        engines = [ContinuousBatchingEngine(cfg, model, n_slots=args.slots, max_len=64)
                   for _ in slowdowns]
        rates = engine_rates(engines, slowdowns, args.n_new)
    else:
        rng0 = np.random.RandomState(123)
        rates = []
        replicas = [LocalReplica(cfg, model, s) for s in slowdowns]
        for r in replicas:
            r.serve(rng0.randint(1, cfg.vocab, size=4), args.n_new)
            t0 = time.time()
            r.serve(rng0.randint(1, cfg.vocab, size=4), args.n_new)
            rates.append(1.0 / max(time.time() - t0, 1e-4))
    mu_bar = float(sum(rates))
    router = RosellaRouter(args.replicas, mu_bar=mu_bar, policy=args.policy,
                           seed=args.seed, device=device)

    rng = np.random.RandomState(args.seed)
    if args.executor == "engine":
        lat = _run_engine_executor(args, cfg, engines, slowdowns, router, rng)
    else:
        lat = _run_replica_executor(args, cfg, replicas, router, rng)
    out = {
        "policy": args.policy,
        "executor": args.executor,
        "arrival_batch": args.arrival_batch,
        "mean_ms": float(lat.mean() * 1e3),
        "p95_ms": float(np.percentile(lat, 95) * 1e3),
        "mu_hat": [round(float(x), 3) for x in router.mu_hat],
        "true_speeds": [round(1.0 / s, 3) for s in slowdowns],
    }
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
