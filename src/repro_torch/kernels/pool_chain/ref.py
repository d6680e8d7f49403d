"""Plain version of the pool-chain kernel: the replica pool's submission
recurrence of one serving turn, step by step, as the reference's inner
scan (``pstep``) and ``SequentialPool.submit_batch`` compute it:

  start = max(arrival, free_at[w]); done = start + cost / speed[w]

and ``free_at[w] = done`` where the submission is active. Each step is
one IEEE f64 max, division and addition on numpy float64 scalars, so it
rounds as the kernel does (a zero speed gives inf, as there). It is the CPU path of ``kernel.pool_chain`` and the
version the kernel is held against on the card; it walks on the host.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def pool_chain_ref(free_at, speeds, workers, arrivals, costs, active):
    """free_at f64[n], speeds f64[n], workers i32[M], arrivals f64[M],
    costs f64[M], active bool[M] -> (start f64[M], done f64[M],
    free_at' f64[n]), on the inputs' device."""
    dev = free_at.device
    fa = free_at.detach().to("cpu", torch.float64).numpy().copy()
    sp = speeds.detach().cpu().numpy()
    w = workers.detach().cpu().numpy()
    a = arrivals.detach().cpu().numpy()
    c = costs.detach().cpu().numpy()
    act = active.detach().cpu().numpy()
    M = len(w)
    start = [0.0] * M
    done = [0.0] * M
    with np.errstate(divide="ignore", invalid="ignore"):
        for i in range(M):
            ai, fi = a[i], fa[w[i]]
            s = ai if (ai > fi or math.isnan(ai)) else fi
            d = s + c[i] / sp[w[i]]
            start[i], done[i] = float(s), float(d)
            if act[i]:
                fa[w[i]] = d
    f64 = dict(dtype=torch.float64, device=dev)
    return (torch.tensor(start, **f64), torch.tensor(done, **f64),
            torch.from_numpy(fa).to(dev))
