"""The port's fault columns without recovery and the retries' rescue on the
CPU (from sections (ii) and (iii) of tests/test_torch_faults.py, in a file
of their own so that the suite's workers share the fault cases): crash_storm
and blackout without ``recovery`` (the inert config), the chunked scan
against one chunk and against the host loop; then crash_storm's scan
with recovery armed against the same scan without, which shares the first
test's run (``shared_runs``): retries rescue all but a task of the crash
losses, the ledger conserves.
"""
import torch_threads  # noqa: F401  (one torch thread a test worker)
import numpy as np
import pytest

from repro_torch import env as tenv
from repro_torch.core import metrics as tmet
from repro_torch.serving import router as tr
from repro_torch.serving import scanloop as tsl
from test_torch_faults import K, RECOVERY, _run, _same, shared_runs

_shared = shared_runs()


@pytest.mark.parametrize("name", ["crash_storm", "blackout"])
def test_faults_without_recovery_host_scan_parity(name):
    """The fault columns alone (no ``recovery``: the inert config), chunked
    scan against one chunk and against the host loop."""
    h = _run(name, use_scan=False)
    s = _shared(name, use_scan=True)
    _same(h, s)
    wl = tenv.make(name).compile_serving(seed=0, arrival_batch=K)
    sp = np.asarray(tenv.make(name).speeds)
    router = tr.RosellaRouter(5, mu_bar=float(sp.sum()), seed=0, async_mu=False, device="cpu")
    resp, mu, info = tsl.run_workload_scan(
        router, tr.SequentialPool(sp), wl.times, wl.costs, wl.speeds, active_np=wl.active,
        rejoin_np=wl.rejoin, burst_np=wl.burst, fake_cost=0.25, kill_np=wl.kill_at,
        stall_np=wl.stall_at, stall_dur_np=wl.stall_dur, chunk_turns=9)
    np.testing.assert_array_equal(resp, s["responses"])
    np.testing.assert_array_equal(mu, s["mu_trace"])
    assert info["ledger"] == s["info"]["ledger"]


def test_retry_rescues_crash_losses():
    bare = _shared("crash_storm", use_scan=True)
    armed = _run("crash_storm", use_scan=True, recovery=RECOVERY)
    lb, la = bare["info"]["ledger"], armed["info"]["ledger"]
    assert lb["lost_tasks"] > 0 and lb["copies_real_killed"] > 0
    assert np.isnan(bare["responses"]).sum() == lb["lost_tasks"]
    assert la["lost_tasks"] < lb["lost_tasks"]
    assert la["lost_tasks"] <= 1
    assert la["n_retries"] > 0
    rep = tmet.fault_report(armed["responses"], la, horizon=360.0)
    assert rep["conserved"]
    assert rep["retry_amplification"] > 1.0
    assert rep["throughput"] >= rep["goodput"]
