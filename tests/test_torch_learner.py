"""The port's learner, arrival estimator and benchmark-job draw against the
reference, with inputs made by numpy from a seed.

Exact: the ring writes (``record_completions``), the queue drain
(``absorb_completions``), the λ̂ EMA at power-of-two batch sizes and the
window parameters (f32 scalar arithmetic, one IEEE operation at a time on
both sides). Within a stated
tolerance: μ̂ from ``refresh_estimates``, whose per-worker sample mean is
a float reduction that XLA orders differently from torch."""
import torch_threads  # noqa: F401  (one torch thread a test worker)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import estimator as rest
from repro.core import learner as rlrn
from repro.core import scheduler as rsch
from repro_torch.core import estimator as test_
from repro_torch.core import learner as tlrn
from repro_torch.core import scheduler as tsch
from repro_torch.utils import prng

#: refresh_estimates' μ̂ = (1 - ε) / mean(ring): the mean's sum is ordered
#: differently by XLA and torch. Measured at most 6 ulps on these inputs.
MU_ULPS = 8


def ulps(a, b) -> int:
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max()) if ia.size else 0


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(jax_state, torch_state, fields):
    for f in fields:
        np.testing.assert_array_equal(getattr(torch_state, f).numpy(),
                                      np.asarray(getattr(jax_state, f)), err_msg=f)


@pytest.mark.parametrize("n,ring_cap,B", [(8, 8, 64), (32, 128, 64), (256, 128, 256)])
def test_record_refresh_sequence_matches_reference(n, ring_cap, B):
    """30 completion batches: rings bit-equal every step (including a
    worker that wraps its ring within one batch when ring_cap=8), μ̂
    within MU_ULPS, and the dead-worker cut-offs at the same workers."""
    rng = np.random.RandomState(n)
    mu_bar = 0.3 * n
    rc = rlrn.default_learner_config(mu_bar, ring_cap=ring_cap)
    tc = tlrn.default_learner_config(mu_bar, ring_cap=ring_cap)
    rs_, ts_ = rlrn.init_learner(n, rc), tlrn.init_learner(n, tc, device="cpu")
    now = 0.0
    worst = 0
    for _ in range(30):
        w = rng.randint(-1, n, B).astype(np.int32)
        w[:12] = 3  # one worker gets more samples than a small ring holds
        st = rng.exponential(1.0, B).astype(np.float32)
        now += float(rng.exponential(2.0))
        lam = np.float32(rng.rand() * mu_bar)
        rs_ = rlrn.record_completions(rs_, jnp.asarray(w), jnp.asarray(st), jnp.float32(now))
        ts_ = tlrn.record_completions(ts_, _t(w), _t(st), now)
        _eq(rs_, ts_, ("samples", "stamps", "widx", "count"))
        rs_ = rlrn.refresh_estimates(rs_, rc, jnp.float32(lam), jnp.float32(now))
        ts_ = tlrn.refresh_estimates(ts_, tc, lam, now)
        a, b = np.asarray(rs_.mu_hat), ts_.mu_hat.numpy()
        np.testing.assert_array_equal(a == 0, b == 0)
        worst = max(worst, ulps(a, b))
        ts_ = ts_.replace(mu_hat=_t(a))  # teacher-force μ̂ for the next step
    assert worst <= MU_ULPS, worst


def test_single_record_and_sync_match_reference():
    """record_completion one sample at a time equals the batched write;
    sync_estimates' mean is a float sum (MU_ULPS)."""
    rng = np.random.RandomState(4)
    n = 8
    rc = rlrn.default_learner_config(3.0, ring_cap=4)
    tc = tlrn.default_learner_config(3.0, ring_cap=4)
    rs_, ts_ = rlrn.init_learner(n, rc), tlrn.init_learner(n, tc, device="cpu")
    for i in range(20):
        w, st = int(rng.randint(n)), np.float32(rng.exponential())
        rs_ = rlrn.record_completion(rs_, jnp.int32(w), jnp.float32(st), jnp.float32(i))
        ts_ = tlrn.record_completion(ts_, w, st, i)
    _eq(rs_, ts_, ("samples", "stamps", "widx", "count"))
    mus = rng.rand(4, n).astype(np.float32)
    assert ulps(tlrn.sync_estimates(_t(mus)).numpy(),
                rlrn.sync_estimates(jnp.asarray(mus))) <= MU_ULPS


def test_absorb_completions_matches_reference():
    rng = np.random.RandomState(0)
    q = rng.randint(0, 4, 16).astype(np.int32)
    w = rng.randint(-1, 16, 100).astype(np.int32)
    np.testing.assert_array_equal(
        tsch.absorb_completions(_t(q), _t(w)).numpy(),
        np.asarray(rsch.absorb_completions(jnp.asarray(q), jnp.asarray(w))))


def test_reset_workers_matches_reference():
    rng = np.random.RandomState(1)
    n = 16
    rc = rlrn.default_learner_config(5.0)
    tc = tlrn.default_learner_config(5.0)
    rs_, ts_ = rlrn.init_learner(n, rc), tlrn.init_learner(n, tc, device="cpu")
    w = rng.randint(0, n, 200).astype(np.int32)
    st = rng.exponential(1.0, 200).astype(np.float32)
    rs_ = rlrn.refresh_estimates(rlrn.record_completions(
        rs_, jnp.asarray(w), jnp.asarray(st), jnp.float32(3.0)), rc, jnp.float32(2.0),
        jnp.float32(3.0))
    ts_ = ts_.replace(**{f: _t(np.asarray(getattr(rs_, f))) for f in
                         ("samples", "stamps", "widx", "count", "mu_hat")})
    reset = rng.rand(n) < 0.3
    active = ~(rng.rand(n) < 0.2) | reset
    r2 = rlrn.reset_workers(rs_, jnp.asarray(reset), jnp.float32(7.5), jnp.asarray(active))
    t2 = tlrn.reset_workers(ts_, _t(reset), 7.5, _t(active))
    _eq(r2, t2, ("samples", "stamps", "widx", "count", "epoch_start"))
    # the rejoin prior is a mean over the kept workers (a float sum)
    assert ulps(t2.mu_hat.numpy(), np.asarray(r2.mu_hat)) <= MU_ULPS


def test_window_params_and_rates_match_reference():
    for mode in ("practical", "theory"):
        rc = rlrn.default_learner_config(40.0, window_mode=mode)
        tc = tlrn.default_learner_config(40.0, window_mode=mode)
        for lam in np.linspace(0.0, 45.0, 31, dtype=np.float32):
            want = rlrn.window_params(rc, jnp.float32(lam), 64)
            got = tlrn.window_params(tc, lam, 64)
            for a, b in zip(want, got):
                assert np.float32(a) == np.float32(b), (mode, lam)
            assert np.float32(rlrn.fake_job_rate(rc, jnp.float32(lam))) == \
                tlrn.fake_job_rate(tc, lam)


#: The λ̂ EMA as the reference's compiled serving turn computes it: XLA
#: contracts ``r * mean_gap + (1 - r) * gap`` into one fused multiply-add,
#: which the port mirrors. For a batch size m that is not a power of two
#: XLA also folds ``(1 - r) * (d / m)`` into ``d * c`` with a rounded
#: constant c, so there the bar is 3 ulps (measured at most 2, and λ̂ =
#: 1 / mean_gap adds one rounding); powers of two (the router's batches
#: of 8 here and 128 on the card) are exact.
EMA_ULPS = {8: 0, 32: 0, 128: 0, 7: 3, 100: 3, 192: 3}


@pytest.mark.parametrize("m", sorted(EMA_ULPS))
def test_arrival_ema_matches_reference(m):
    observe = jax.jit(rest.observe_arrivals_ema, static_argnums=(2, 3))
    rng = np.random.RandomState(m)
    ra, ta = rest.init_ema_arrival(), test_.init_ema_arrival()
    t = 0.0
    for _ in range(200):
        t += float(rng.exponential(0.8))
        ra = observe(ra, jnp.float32(t), m, rest.EMA_ARR_WINDOW)
        ta = test_.observe_arrivals_ema(ta, t, m, test_.EMA_ARR_WINDOW)
        assert ulps(ra.mean_gap, ta.mean_gap) <= EMA_ULPS[m]
        assert np.float32(ra.last_time) == ta.last_time and int(ra.count) == ta.count
        assert ulps(rest.lam_hat_ema(ra), test_.lam_hat_ema(ta)) <= EMA_ULPS[m]
        ta = dataclasses.replace(ta, mean_gap=np.float32(ra.mean_gap))


#: fake_jobs_from's truncated-Poisson CDF goes through exp/log and a cumsum,
#: which XLA and torch round differently; the count k = #{cdf <= u} may
#: differ only where u lies within CDF_ATOL of a CDF term.
CDF_ATOL = 1e-6


def _poisson_cdf(lam: float, max_fake: int) -> np.ndarray:
    k = np.arange(max_fake + 1)
    logfact = np.concatenate([[0.0], np.cumsum(np.log(np.arange(1, max_fake + 1)))])
    return np.cumsum(np.exp(k * np.log(max(lam, 1e-30)) - lam - logfact))


@pytest.mark.parametrize("masked", [False, True])
def test_fake_jobs_match_reference_except_at_cdf_ties(masked):
    n = 32
    rc, tc = rlrn.default_learner_config(30.0), tlrn.default_learner_config(30.0)
    mask = np.random.RandomState(5).rand(n) < 0.6
    ties = 0
    for s in range(200):
        rng = np.random.RandomState(s)
        lam_hat, dt = np.float32(rng.rand() * 30), np.float32(rng.rand() * 3)
        want = np.asarray(rsch.fake_jobs_from(
            rc, jax.random.PRNGKey(s), jnp.float32(lam_hat), jnp.float32(dt), 8, n,
            jnp.asarray(mask) if masked else None))
        got = tsch.fake_jobs_from(
            tc, prng.PRNGKey(s), lam_hat, dt, 8, n,
            mask=_t(mask) if masked else None, device="cpu").numpy()
        if not np.array_equal(got, want):
            u1 = prng.uniform_pair(prng.PRNGKey(s), 8)[0][0].item()
            lam = float(tlrn.fake_job_rate(tc, lam_hat) * dt)
            assert np.abs(_poisson_cdf(lam, 8) - u1).min() <= CDF_ATOL, s
            ties += 1
        if masked:
            assert mask[got[got >= 0]].all()
    assert ties <= 2


# ---------------------------------------------------------------------------
# device forms (the device-resident turn's): equal to the host forms, bit
# for bit
# ---------------------------------------------------------------------------


def _f32_round(exact):
    """An exact rational rounded to the nearest float32, ties to even."""
    from fractions import Fraction

    r = np.float32(float(exact))
    cands = [r, np.nextafter(r, np.float32(np.inf)), np.nextafter(r, np.float32(-np.inf))]
    best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                     int(np.array(v).view(np.int32)) & 1))
    return best


def _planted_midpoints():
    """(a, b, c) whose a*b is exactly halfway between two floats and c a
    nudge below the double's resolution there, of either sign: the double
    sum lands on the midpoint, and only the nudge says which way to round.
    a = s(1 + i 2^-12), b = s(1 + j 2^-12) with i*j odd puts i*j 2^-24 in
    the product's half-ulp bit."""
    out = []
    for i in (1, 3, 5, 7):
        for j in (1, 3, 5, 7):
            for sgn in (1.0, -1.0):
                for scale in (1.0, 2.0**-10, 2.0**20):
                    a = np.float32(sgn * scale * (1.0 + i * 2.0**-12))
                    b = np.float32(1.0 + j * 2.0**-12)
                    for nudge in (2.0**-80, -2.0**-80, 2.0**-70, -2.0**-75):
                        out.append((a, b, np.float32(nudge * scale)))
    return out


def test_fma_device_form_rounds_once_like_the_host_form():
    """Planted exact midpoints (both signs of the nudge, both parities of
    the lower neighbour) and random triples: the tensor form equals the
    host form and the correctly rounded a*b + c."""
    from fractions import Fraction

    rng = np.random.RandomState(0)
    triples = _planted_midpoints()
    triples += [tuple(np.float32(v) for v in rng.randn(3) * 10.0 ** rng.randint(-3, 4, 3))
                for _ in range(300)]
    a, b, c = (torch.tensor([t[i] for t in triples]) for i in range(3))
    got = test_.fma_f32(a, b, c).numpy()
    naive_differs = 0
    for i, (x, y, z) in enumerate(triples):
        host = test_.fma_f32(x, y, z)
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        assert got[i] == host == _f32_round(exact), (x, y, z)
        naive_differs += np.float32(float(x) * float(y) + float(z)) != host
    assert naive_differs >= 100  # the planted cases do catch double rounding


@pytest.mark.parametrize("m", [8, 128, 7, 100])
def test_arrival_ema_device_form_equals_host_form(m):
    """300 batches: the device EMA (0-d f32 tensors, i32 count) equals the
    host one after every step, and so does λ̂."""
    rng = np.random.RandomState(100 + m)
    h, d = test_.init_ema_arrival(), test_.to_device(test_.init_ema_arrival(), "cpu")
    assert d.count.dtype == torch.int32 and d.mean_gap.dtype == torch.float32
    t = 0.0
    for _ in range(300):
        t += float(rng.exponential(0.8)) * (rng.rand() < 0.95)  # some zero gaps
        h = test_.observe_arrivals_ema(h, t, m, test_.EMA_ARR_WINDOW)
        d = test_.observe_arrivals_ema(d, torch.tensor(np.float32(t)), m,
                                       test_.EMA_ARR_WINDOW)
        assert test_.to_host(d) == h
        assert test_.lam_hat_ema(d).item() == test_.lam_hat_ema(h)


@pytest.mark.parametrize("mode", ["practical", "theory"])
@pytest.mark.parametrize("n", [64, 1000])
def test_window_params_device_form_equals_host_form(mode, n):
    """A λ̂ grid over both ends of the α clamp (λ̂ = 0 and λ̂ past μ̄)."""
    cfg = tlrn.default_learner_config(40.0, window_mode=mode)
    grid = np.concatenate([np.linspace(0.0, 45.0, 61), [39.96, 39.98, 40.0, 1e-7, 1e6]])
    for lam in grid.astype(np.float32):
        host = tlrn.window_params(cfg, lam, n)
        dev = tlrn.window_params(cfg, torch.tensor(lam), n)
        assert dev[3].dtype == torch.int32
        for a, b in zip(host, dev):
            assert np.float32(a) == np.float32(b.item()), (mode, lam)
        assert tlrn.avg_window(dev[3], 128).item() == tlrn.avg_window(host[3], 128)
        assert tlrn.fake_job_rate(cfg, torch.tensor(lam)).item() == \
            tlrn.fake_job_rate(cfg, lam)


@pytest.mark.parametrize("mode", ["practical", "theory"])
def test_refresh_and_record_device_forms_equal_host_forms(mode):
    """30 completion batches with λ̂ and ``now`` as 0-d tensors: rings and
    μ̂ (the dead-worker cut-offs included) equal the host forms'."""
    rng = np.random.RandomState(9)
    n = 24
    cfg = tlrn.default_learner_config(0.3 * n, window_mode=mode)
    h = d = tlrn.init_learner(n, cfg, device="cpu")
    now = 0.0
    for i in range(30):
        w = rng.randint(-1, n, 48).astype(np.int32)
        if i > 5:
            w[w == 0] = 1  # worker 0 goes quiet, so the cut-off takes it
        w = torch.from_numpy(w)
        st = torch.from_numpy(rng.exponential(1.0, 48).astype(np.float32))
        now += float(rng.exponential(100.0 if mode == "practical" else 600.0))
        lam = np.float32(rng.rand() * 0.1 * n)
        h = tlrn.refresh_estimates(tlrn.record_completions(h, w, st, now), cfg, lam, now)
        tnow = torch.tensor(np.float32(now))
        d = tlrn.refresh_estimates(tlrn.record_completions(d, w, st, tnow), cfg,
                                   torch.tensor(lam), tnow)
        _eq(h, d, ("samples", "stamps", "widx", "count", "epoch_start", "mu_hat"))
    assert (h.mu_hat == 0).any()  # the cut-off ran


@pytest.mark.parametrize("masked", [False, True])
def test_fake_jobs_device_form_equals_host_form(masked):
    n = 32
    tc = tlrn.default_learner_config(30.0)
    mask = _t(np.random.RandomState(5).rand(n) < 0.6) if masked else None
    for s in range(100):
        rng = np.random.RandomState(s)
        lam_hat, dt = np.float32(rng.rand() * 35), np.float32(rng.rand() * 3 - 0.5)
        key = prng.PRNGKey(s)
        host = tsch.fake_jobs_from(tc, key, lam_hat, dt, 8, n, mask=mask, device="cpu")
        dev = tsch.fake_jobs_from(tc, prng.device_key(key, "cpu"), torch.tensor(lam_hat),
                                  torch.tensor(dt), 8, n, mask=mask, device="cpu")
        assert torch.equal(host, dev), s
