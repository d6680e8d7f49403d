"""Plain versions of the pool-chain kernel: the replica pool's submission
recurrence of one serving turn, as the reference's inner scan (``pstep``)
and ``SequentialPool.submit_batch`` compute it:

  start = max(arrival, free_at[w]); done = start + cost / speed[w]

and ``free_at[w] = done`` where the submission is active. Each step is one
IEEE f64 max (NaN from either side wins), division and addition, so every
version here rounds as the kernel does (a zero speed gives inf, as there).

* ``pool_chain_ref`` walks the steps in order on the host: the CPU path of
  ``kernel.pool_chain`` and the version the kernel is held against.
* ``pool_chain_linked`` is the kernel's decomposition in torch: link each
  step to the next step on its replica (``chain_links``), then walk every
  replica's chain, all chains a step at a time.
* ``turn_submissions`` assembles a turn's steps from its three groups and
  an optional tail (the faulty turn's retries and speculative copies), and
  ``pool_turn_ref`` (the assembly, then ``pool_chain_ref``) is the CPU path
  of ``kernel.pool_turn``.
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


def chain_links(workers):
    """workers i32[M] -> (nxt i64[M], head bool[M]): the next step on the
    same replica in submission order (-1 for a replica's last step), and
    whether a step is its replica's first."""
    M = workers.shape[0]
    order = torch.sort(workers.long(), stable=True).indices
    same = workers[order[1:]] == workers[order[:-1]]
    nxt = torch.full((M,), -1, dtype=torch.long, device=workers.device)
    nxt[order[:-1]] = torch.where(same, order[1:], -1)
    head = torch.ones(M, dtype=torch.bool, device=workers.device)
    head[order[1:]] = ~same
    return nxt, head


def pool_chain_linked(free_at, speeds, workers, arrivals, costs, active):
    """``pool_chain_ref``'s function as the kernel computes it: the
    durations in parallel, the links, then every chain walked from its head
    with its replica's clock, each chain one step per round."""
    M = workers.shape[0]
    w = workers.long()
    dur = costs / speeds[w]
    nxt, head = chain_links(workers)
    start = torch.empty(M, dtype=torch.float64, device=free_at.device)
    done = torch.empty_like(start)
    free_out = free_at.clone()
    cur = torch.nonzero(head).flatten()  # one walker a chain
    rep = w[cur]
    clk = free_at[rep]
    while cur.numel():
        a = arrivals[cur]
        s = torch.where((a > clk) | torch.isnan(a), a, clk)
        d = s + dur[cur]
        start[cur], done[cur] = s, d
        clk = torch.where(active[cur], d, clk)
        cur = nxt[cur]
        end = cur < 0
        free_out[rep[end]] = clk[end]
        cur, rep, clk = cur[~end], rep[~end], clk[~end]
    return start, done, free_out


def turn_submissions(fake_js, burst, workers, times, costs, fake_cost, burst_cost,
                     tail_w=None, tail_cost=None, tail_gate=None):
    """A turn's steps in submit order, benchmark jobs, probe bursts, the
    batch, then the tail (the faulty turn's retry and speculative copies):
    (sub_w i32[M], arrivals f64[M], costs f64[M], act bool[M]). A benchmark
    job, burst or tail step arrives at the turn's time (the batch's last
    arrival), a benchmark job or burst at its fixed cost; a negative
    replica is inactive and submits to replica 0, and a tail step is
    active only where its gate is set."""
    mf, bc, k = fake_js.shape[0], burst.shape[0], workers.shape[0]
    dev = times.device
    f64 = dict(dtype=torch.float64, device=dev)
    if tail_w is None:
        tail_w = torch.zeros(0, dtype=torch.int32, device=dev)
        tail_cost = torch.zeros(0, **f64)
        tail_gate = torch.zeros(0, dtype=torch.bool, device=dev)
    R = tail_w.shape[0]
    act = torch.cat([fake_js >= 0, burst >= 0, torch.ones(k, dtype=torch.bool, device=dev),
                     tail_gate & (tail_w >= 0)])
    sub_w = torch.cat([fake_js.clamp(min=0), burst.clamp(min=0), workers,
                       tail_w.clamp(min=0)])
    sub_arr = torch.cat([times[-1].expand(mf + bc), times, times[-1].expand(R)])
    sub_cost = torch.cat([torch.full((mf,), fake_cost, **f64),
                          torch.full((bc,), burst_cost, **f64), costs, tail_cost])
    return sub_w, sub_arr, sub_cost, act


def pool_turn_ref(free_at, speeds, fake_js, burst, workers, times, costs, fake_cost,
                  burst_cost, tail_w=None, tail_cost=None, tail_gate=None):
    """-> (start f64[M], done f64[M], sub_w i32[M], act bool[M], free_at'
    f64[n], resp f64[k]): the assembly, then ``pool_chain_ref``; resp is
    the batch's done - arrival."""
    sub_w, sub_arr, sub_cost, act = turn_submissions(
        fake_js, burst, workers, times, costs, fake_cost, burst_cost, tail_w, tail_cost,
        tail_gate)
    start, done, free_out = pool_chain_ref(free_at, speeds, sub_w, sub_arr, sub_cost, act)
    b = fake_js.shape[0] + burst.shape[0]
    resp = done[b:b + workers.shape[0]] - times
    return start, done, sub_w, act, free_out, resp


def longest_chain(workers, n: int) -> int:
    """The most steps on one replica: the longest chain the kernel walks
    (inactive steps included, on the replica they submit to)."""
    if workers.numel() == 0:
        return 0
    return int(torch.bincount(workers.long(), minlength=n).max())


def planted_chains(n: int = 256, M: int = 136, seed: int = 0) -> dict:
    """Chains that test the kernel's link and walk, by name: numpy (free_at,
    speeds, workers i32, arrivals, costs, active) at n replicas and M steps
    (n >= M, M >= 128): no step; every step on its own replica; every step
    on one replica; a replica 30 times in a row; repeats that straddle the
    link's tile borders (steps 31/32, 63/64, 95-97) interleaved with another
    replica; inactive chain heads and a chain of inactive steps only;
    arrivals tied with a replica's clock on entry and with the done of the
    step before; NaN arrivals, active and inactive."""
    rng = np.random.RandomState(seed)
    fa, sp = rng.rand(n) * 3, rng.rand(n) + 0.05
    w = rng.randint(0, n, M).astype(np.int32)
    a, c = np.sort(rng.rand(M) * 3), rng.exponential(1.0, M)
    act = rng.rand(M) < 0.9

    def case(w=w, a=a, act=act, m=M):
        return fa, sp, w[:m].copy(), a[:m].copy(), c[:m].copy(), act[:m].copy()

    out = {"empty": case(m=0),
           "distinct": case(w=rng.permutation(n)[:M].astype(np.int32)),
           "one replica": case(w=np.full(M, 7, np.int32)),
           "a replica 30 times": case(w=np.where((np.arange(M) >= 10) & (np.arange(M) < 40),
                                                 5, w).astype(np.int32))}
    wt = w.copy()
    wt[[30, 33, 62, 65]] = 9
    wt[[31, 32, 63, 64]] = 3
    wt[95:98] = 11
    out["tile borders"] = case(w=wt)
    wi, ai = w.copy(), act.copy()
    wi[[0, 50, 80]] = 5
    ai[[0, 50, 80]] = False, True, True
    wi[(wi == 0) | (wi == 13)] = 1
    wi[[100, 101]] = 13
    ai[[100, 101]] = False
    wi[127] = 0
    ai[127] = False  # replica 0's only step, inactive
    out["inactive heads"] = case(w=wi, act=ai)
    wq, aq, acq = w.copy(), a.copy(), act.copy()
    heads = np.unique(wq, return_index=True)[1][:8]
    aq[heads] = fa[wq[heads]]
    wq[[70, 71]] = 21
    acq[[70, 71]] = True
    wq[:70][wq[:70] == 21] = 22
    aq[70] = fa[21] + 1.0
    aq[71] = aq[70] + c[70] / sp[21]  # the done of step 70, to the last bit
    out["ties"] = case(w=wq, a=aq, act=acq)
    wn, an, acn = w.copy(), a.copy(), act.copy()
    wn[[20, 60, 90]] = 17
    acn[[20, 60, 90]] = True
    an[20] = np.nan
    an[110] = np.nan
    acn[110] = False
    out["nan arrivals"] = case(w=wn, a=an, act=acn)
    return out
