"""The pool-chain kernel's plain versions on the CPU, against the
reference's inner scan step (``pstep``, ``src/repro/serving/scanloop.py``)
and the turn's submission assembly around it, bit for bit:

(i) the kernel's decomposition in torch (``ref.pool_chain_linked``: link
each step to the next on its replica, then walk every chain) and the host
walk (``ref.pool_chain_ref``) against ``pstep`` on planted chains
(``ref.planted_chains``) and on the submissions of real scan turns;
(ii) a numpy mirror of the kernel's link (``__match_any_sync`` groups in
tiles of 32, then the tiles stitched in order through a per-replica
``last``) against ``ref.chain_links``;
(iii) the turn interface's plain counterpart (``ref.pool_turn_ref``, the
CPU path of ``kernel.pool_turn``) against the reference's assembly plus
``pstep``, and the wrapper's in-place and running-max outputs.

NaN compares equal to NaN at the same place; everything else is exact.
"""
import torch_threads  # noqa: F401  (one torch thread a test worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels.pool_chain import kernel as CK
from repro_torch.kernels.pool_chain import ref as CR
from repro_torch.serving import router as tr
from repro_torch.serving import scanloop as tsl
from test_torch_scanloop import _jax_pstep_chain as _jax_pstep

PLANTED = CR.planted_chains()


def _jax_turn(fa, sp, fake_js, burst, workers, times, costs, fake_cost, burst_cost):
    """The reference's turn around ``pstep``: fakes, bursts, then the batch
    (serving/scanloop.py, the replica-pool chain), and the responses."""
    with jax.enable_x64(True):
        mf, bc, k = len(fake_js), len(burst), len(workers)
        fake_js, burst = jnp.asarray(fake_js), jnp.asarray(burst)
        times64 = jnp.asarray(times, jnp.float64)
        act = jnp.concatenate([fake_js >= 0, burst >= 0, jnp.ones((k,), bool)])
        sub_w = jnp.concatenate([jnp.maximum(fake_js, 0), jnp.maximum(burst, 0),
                                 jnp.asarray(workers)])
        sub_arr = jnp.concatenate([jnp.full((mf + bc,), times64[-1]), times64])
        sub_cost = jnp.concatenate([jnp.full((mf,), fake_cost), jnp.full((bc,), burst_cost),
                                    jnp.asarray(costs, jnp.float64)])
        s, d, f = _jax_pstep(fa, sp, sub_w, sub_arr, sub_cost, act)
        return s, d, np.asarray(sub_w), np.asarray(act), f, d[mf + bc:] - np.asarray(times)


def _same(got, want):
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        assert g.dtype == np.asarray(w).dtype and g.shape == np.shape(w)
        np.testing.assert_array_equal(g, w)  # NaN equals NaN at the same place


def _torch(case):
    return [torch.from_numpy(x) for x in case]


# ---------------------------------------------------------------------------
# (i) the chain: linked walk, host walk and pstep
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(PLANTED))
def test_linked_walk_equals_the_host_walk_and_pstep(name):
    case = PLANTED[name]
    want = _jax_pstep(*case)
    _same(CR.pool_chain_linked(*_torch(case)), want)
    _same(CR.pool_chain_ref(*_torch(case)), want)
    _same(CK.pool_chain(*_torch(case)), want)  # the wrapper's CPU path


def test_planted_chains_hold_what_they_name():
    p = PLANTED
    assert len(p["empty"][2]) == 0
    assert CR.longest_chain(torch.from_numpy(p["distinct"][2]), 256) == 1
    assert CR.longest_chain(torch.from_numpy(p["one replica"][2]), 256) == 136
    w = p["tile borders"][2]
    assert (w[[31, 32, 63, 64]] == 3).all() and (w[[30, 33, 62, 65]] == 9).all()
    fa, _, w, a, _, act = p["inactive heads"]
    assert not act[np.nonzero(w == 5)[0][0]] and not act[w == 13].any() and (w == 13).sum() == 2
    fa, sp, w, a, c, act = p["ties"]
    s, d, _ = _jax_pstep(fa, sp, w, a, c, act)
    assert a[71] == d[70] and s[71] == a[71]  # tied with the clock the step before left
    assert (a == fa[w]).sum() >= 8  # tied with a replica's clock on entry
    fa, sp, w, a, c, act = p["nan arrivals"]
    s, d, f = _jax_pstep(fa, sp, w, a, c, act)
    assert np.isnan(d[[20, 60, 90]]).all() and np.isnan(f[17]) and np.isnan(d[110])


def _recorded_turns(monkeypatch, churn: bool, n=64, k=32, turns=12, seed=0):
    """The pool_turn arguments of ``turns`` real scan turns at n, k on the
    CPU (alias probes; with churn, 3 probe-burst slots a turn)."""
    rec = []
    real = CK.pool_turn

    def spy(free_at, *args, **kw):
        rec.append((free_at.clone(), *(a.clone() if isinstance(a, torch.Tensor) else a
                                       for a in args)))
        return real(free_at, *args, **kw)

    monkeypatch.setattr(tsl.pool_kernel, "pool_turn", spy)
    rng = np.random.RandomState(seed)
    speeds = rng.rand(n) * 2 + 0.1
    rate = 0.7 * speeds.sum()
    router = tr.RosellaRouter(n, float(speeds.sum()), seed=seed, async_mu=False,
                              use_alias=True, device="cpu")
    times, costs, sp = tsl._precompute_workload(rate, turns * k / rate, 1.0, None, seed, k,
                                                speeds)
    kw = {}
    if churn:
        T = len(times)
        active = np.ones((T, n), bool)
        active[T // 2:, :5] = False
        burst = rng.randint(0, n, (T, 3)).astype(np.int32)
        burst[rng.rand(T, 3) < 0.5] = -1
        kw = dict(active_np=active, burst_np=burst)
    tsl.run_workload_scan(router, tr.SequentialPool(speeds), times, costs, sp, **kw)
    return rec


@pytest.mark.parametrize("churn", [False, True])
def test_real_scan_turns_linked_walk_and_turn_form(monkeypatch, churn):
    """Every turn of a real scan run at n=64, k=32: the assembled steps
    through the linked walk, the host walk and ``pstep``, and the turn form
    (assembly and chain) against the reference's."""
    rec = _recorded_turns(monkeypatch, churn)
    assert len(rec) >= 10
    longest = 0
    for free_at, speeds, fake_js, burst, workers, times, costs, fc, bcost in rec:
        assert len(burst) == (3 if churn else 0)
        sub = CR.turn_submissions(fake_js, burst, workers, times, costs, fc, bcost)
        steps = (free_at, speeds, *sub[:3], sub[3])
        want = _jax_pstep(*(t.numpy() for t in steps))
        _same(CR.pool_chain_linked(*steps), want)
        _same(CR.pool_chain_ref(*steps), want)
        args = (free_at, speeds, fake_js, burst, workers, times, costs, fc, bcost)
        _same(CR.pool_turn_ref(*args),
              _jax_turn(*(a.numpy() if isinstance(a, torch.Tensor) else a for a in args)))
        longest = max(longest, CR.longest_chain(sub[0], len(free_at)))
    assert longest >= 2  # some replica took several submissions in a turn


# ---------------------------------------------------------------------------
# (ii) the kernel's link, mirrored
# ---------------------------------------------------------------------------


def _warp_links(w):
    """The kernel's link in numpy. Inside each tile of 32 lanes (lanes past
    M hold distinct negative sentinels), a lane's ``__match_any_sync`` group
    links it to the group's next lane and marks its first and last lane;
    then one pass over the tiles in order links each group's first lane to
    ``last`` of its replica, which the group's last lane then becomes."""
    M = len(w)
    nxt, first, final = np.full(M, -1), np.zeros(M, bool), np.zeros(M, bool)
    for base in range(0, M, 32):
        wi = [int(w[base + l]) if base + l < M else -1 - l for l in range(32)]
        for lane in range(min(32, M - base)):
            same = [m for m in range(32) if wi[m] == wi[lane]]
            below = [m for m in same if m < lane]
            if below:
                nxt[base + max(below)] = base + lane
            first[base + lane] = not below
            final[base + lane] = max(same) == lane
    head, last = np.zeros(M, bool), {}
    for base in range(0, M, 32):
        tile = range(base, min(base + 32, M))
        prev = {i: last.get(int(w[i]), -1) for i in tile if first[i]}  # every read first
        for i in tile:
            if first[i] and prev[i] >= 0:
                nxt[prev[i]] = i
            head[i] = first[i] and prev[i] < 0
            if final[i]:
                last[int(w[i])] = i
    return nxt, head


@pytest.mark.parametrize("name", list(PLANTED) + ["random n=8 M=300"])
def test_warp_link_mirror_equals_chain_links(name):
    w = (PLANTED[name][2] if name in PLANTED
         else np.random.RandomState(4).randint(0, 8, 300).astype(np.int32))
    nxt, head = CR.chain_links(torch.from_numpy(w))
    got_nxt, got_head = _warp_links(w)
    np.testing.assert_array_equal(got_nxt, nxt.numpy())
    np.testing.assert_array_equal(got_head, head.numpy())
    assert head.sum() == len(np.unique(w))


# ---------------------------------------------------------------------------
# (iii) the turn interface on the CPU
# ---------------------------------------------------------------------------


def _turn_args(n=32, mf=8, bc=3, k=40, seed=5):
    rng = np.random.RandomState(seed)
    fa, sp = rng.rand(n) * 2, rng.rand(n) + 0.1
    fake = rng.randint(0, n, mf).astype(np.int32)
    fake[rng.rand(mf) < 0.4] = -1
    burst = rng.randint(0, n, bc).astype(np.int32)
    burst[:1] = -1
    workers = rng.randint(0, n, k).astype(np.int32)
    workers[:6] = fake[fake >= 0][0]  # the batch lands on a benchmarked replica
    times = np.sort(rng.rand(k) * 2 + 1)
    costs = rng.exponential(1.0, k)
    return [torch.from_numpy(x) for x in (fa, sp, fake, burst, workers, times, costs)]


@pytest.mark.parametrize("bc", [0, 3])
def test_pool_turn_equals_the_reference_assembly_and_pstep(bc):
    t = _turn_args(bc=bc)
    want = _jax_turn(*(x.numpy() for x in t), 0.25, 1.0)
    _same(CR.pool_turn_ref(*t, 0.25, 1.0), want)
    fa = t[0].clone()
    cm = torch.tensor(1, dtype=torch.int32)
    before = CK.launch_counts()["pool_chain"]
    out = CK.pool_turn(*t, 0.25, 1.0, free_out=t[0], chain_max=cm)
    assert CK.launch_counts()["pool_chain"] == before  # the CPU path launches nothing
    _same(out, want)
    assert out[4] is t[0]  # written in place
    assert not torch.equal(fa, t[0])
    assert int(cm) == CR.longest_chain(out[2], len(fa)) >= 7
    _same(CK.pool_turn(fa, *t[1:], 0.25, 1.0), want)  # a new free_at, chain_max untouched


def test_pool_turn_checks_its_inputs():
    t = _turn_args()
    with pytest.raises(ValueError, match="fake_js"):
        CK.pool_turn(t[0], t[1], t[2].long(), *t[3:], 0.25, 1.0)
    with pytest.raises(ValueError, match="times"):
        CK.pool_turn(*t[:5], t[5][:-1], t[6], 0.25, 1.0)
    with pytest.raises(ValueError, match="chain_max"):
        CK.pool_turn(*t, 0.25, 1.0, chain_max=torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="empty"):
        CK.pool_turn(*t[:4], t[4][:0], t[5][:0], t[6][:0], 0.25, 1.0)


# ---------------------------------------------------------------------------
# (iv) the faulty turn's tail: retries, then speculative copies
# ---------------------------------------------------------------------------


def _jax_faulty_turn(fa, sp, fake_js, burst, workers, times, costs, fake_cost, burst_cost,
                     rw, okR, r_cost, spec_w, okS, s_cost):
    """The reference's faulty turn around ``pstep`` (serving/scanloop.py,
    ``_build_scan_faulty`` step 13): fakes, bursts, the batch, retries
    (gated by okR and a placed worker), then speculative copies (okS)."""
    with jax.enable_x64(True):
        mf, bc, k = len(fake_js), len(burst), len(workers)
        R = len(rw) + len(spec_w)
        fake_js, burst, rw = jnp.asarray(fake_js), jnp.asarray(burst), jnp.asarray(rw)
        times64 = jnp.asarray(times, jnp.float64)
        act = jnp.concatenate([fake_js >= 0, burst >= 0, jnp.ones((k,), bool),
                               jnp.asarray(okR) & (rw >= 0), jnp.asarray(okS)])
        sub_w = jnp.concatenate([jnp.maximum(fake_js, 0), jnp.maximum(burst, 0),
                                 jnp.asarray(workers), jnp.maximum(rw, 0),
                                 jnp.asarray(spec_w)])
        sub_arr = jnp.concatenate([jnp.full((mf + bc,), times64[-1]), times64,
                                   jnp.full((R,), times64[-1])])
        sub_cost = jnp.concatenate([jnp.full((mf,), fake_cost), jnp.full((bc,), burst_cost),
                                    jnp.asarray(costs, jnp.float64),
                                    jnp.asarray(r_cost, jnp.float64),
                                    jnp.asarray(s_cost, jnp.float64)])
        s, d, f = _jax_pstep(fa, sp, sub_w, sub_arr, sub_cost, act)
        return (s, d, np.asarray(sub_w), np.asarray(act), f,
                d[mf + bc:mf + bc + k] - np.asarray(times))


def _tail(case, n=32, seed=9):
    """Retry slots (worker -1 where the engine placed nothing) and spec
    slots, each gated: ``gated`` some gates off and a -1 under an open
    gate; ``one replica`` every tail step on the batch's busiest replica;
    ``empty`` no slot."""
    rng = np.random.RandomState(seed)
    if case == "empty":
        return (np.zeros(0, np.int32), np.zeros(0, bool), np.zeros(0)) * 2
    rw = rng.randint(0, n, 4).astype(np.int32)
    okR = np.array([True, True, False, True])
    rw[1] = -1  # an open gate the engine placed nothing behind
    spec_w = rng.randint(0, n, 2).astype(np.int32)
    okS = np.array([True, False])
    if case == "one replica":
        rw[:], spec_w[:], okR[:], okS[:] = 4, 4, True, True
    return rw, okR, rng.exponential(1.0, 4), spec_w, okS, rng.exponential(1.0, 2)


@pytest.mark.parametrize("case", ["gated", "one replica", "empty"])
def test_pool_turn_tail_equals_the_reference_faulty_pstep(case):
    """``pool_turn_ref`` and the wrapper's CPU path with a tail (retries then
    specs as one group) against the reference's five-group pstep, bit for
    bit; an empty tail gives the plain turn's output."""
    t = _turn_args()
    t[4][:6] = 4  # replica 4 takes six of the batch
    rw, okR, rc, sw, okS, sc = _tail(case)
    want = _jax_faulty_turn(*(x.numpy() for x in t), 0.25, 1.0, rw, okR, rc, sw, okS, sc)
    tail = (torch.from_numpy(np.concatenate([rw, sw]).astype(np.int32)),
            torch.from_numpy(np.concatenate([rc, sc]).astype(np.float64)),
            torch.from_numpy(np.concatenate([okR, okS]).astype(bool)))
    _same(CR.pool_turn_ref(*t, 0.25, 1.0, *tail), want)
    cm = torch.tensor(0, dtype=torch.int32)
    fa = t[0].clone()
    out = CK.pool_turn(fa, *t[1:], 0.25, 1.0, tail_w=tail[0], tail_cost=tail[1],
                       tail_gate=tail[2], free_out=fa, chain_max=cm)
    _same(out, want)
    assert int(cm) == CR.longest_chain(out[2], len(fa))
    if case == "one replica":
        assert int(cm) >= 12
    if case == "empty":
        _same(CR.pool_turn_ref(*t, 0.25, 1.0), want)
    with pytest.raises(ValueError, match="together"):
        CK.pool_turn(*t, 0.25, 1.0, tail_w=tail[0])
    with pytest.raises(ValueError, match="tail_gate"):
        CK.pool_turn(*t, 0.25, 1.0, tail_w=tail[0], tail_cost=tail[1],
                     tail_gate=tail[2].to(torch.uint8))
