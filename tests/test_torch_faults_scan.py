"""The port's failure semantics on the CPU with recovery armed
(``RECOVERY``: timeout x8, budget 2, retry_cap 4, spec_cap 2, ratio 3), on
crash_storm, blackout and grey_failure, both probe streams, in one module so
that each port run is made once (``_shared``, module-scoped) and read by
every comparison that makes the same call:

(ii) the host recovery loop and the faulty scan agree float for float:
responses (NaN = lost), μ̂ trace, ``free_at``, the final learner and key,
every ledger entry; the ledger conserves and the capacities do not
overflow;
(iv) the port's host recovery loop against the reference's
``repro.serving.recovery.run_workload_recovery``, and the port's faulty scan
against the reference's (under the ``ref_scan`` alias of
``jax.experimental.enable_x64``, as in tests/test_torch_env.py): responses
and every ledger entry equal, μ̂ exact until the measured turn at which the
learner's float sum parts the two (``EXACT_MU_TURNS``) and within
``MU_ULPS`` after; ``fault_report`` and ``check_conservation`` equal on the
same inputs.
"""
import torch_threads  # noqa: F401  (one torch thread a test worker)
import jax
import jax.experimental
import numpy as np
import pytest

from repro import env as jenv
from repro.core import metrics as jmet
from repro_torch.core import metrics as tmet
from test_torch_faults import (FAULT_SCENARIOS, K, MU_ULPS, REF_RECOVERY, RECOVERY, _ref, _same,
                               shared_runs, ulps)

#: the turn at which the port parts from the reference in μ̂'s last bits
#: (learner float sums), measured at seed 0 on all three fault scenarios,
#: host against host and scan against scan; responses stay equal
EXACT_MU_TURNS = {"alias": 8, "icdf": 10}

_shared = shared_runs()


def _port(name, use_alias, use_scan):
    return _shared(name, use_scan=use_scan, recovery=RECOVERY, use_alias=use_alias)


@pytest.fixture
def ref_scan(monkeypatch):
    """The reference scan loop on jax 0.9, which has ``jax.enable_x64(True)``
    where the reference imports ``jax.experimental.enable_x64``."""
    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda: jax.enable_x64(True), raising=False)
    return jenv


# ---------------------------------------------------------------------------
# (ii) host against scan on every fault scenario, recovery armed
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_alias", [True, False], ids=["alias", "icdf"])
@pytest.mark.parametrize("name", FAULT_SCENARIOS)
def test_fault_host_scan_parity(name, use_alias):
    h = _port(name, use_alias, use_scan=False)
    s = _port(name, use_alias, use_scan=True)
    _same(h, s)
    ok, residuals = tmet.check_conservation(s["info"]["ledger"])
    assert ok, residuals
    assert s["info"]["flush_overflow"] == s["info"]["pend_overflow"] == 0
    led = s["info"]["ledger"]
    assert led["n_timeouts"] > 0 and led["n_retries"] > 0 and led["n_spec"] > 0
    assert np.isfinite(s["responses"]).sum() == led["completed_tasks"]
    if name == "crash_storm":
        assert led["copies_real_killed"] > 0
    if name == "blackout":
        assert led["n_stalled"] > 0


# ---------------------------------------------------------------------------
# (iv) against the reference
# ---------------------------------------------------------------------------


def _assert_reference_bars(ref, port, exact_turns):
    """Responses (NaN = lost) and every ledger entry equal; μ̂ equal for
    ``exact_turns`` turns, zero where the reference's is, within MU_ULPS."""
    np.testing.assert_array_equal(port["responses"], ref["responses"])
    assert port["info"]["ledger"] == ref["info"]["ledger"]
    mu_r, mu_t = np.asarray(ref["mu_trace"]), port["mu_trace"]
    assert mu_r.shape == mu_t.shape and len(mu_r) > exact_turns
    first = next((i for i in range(len(mu_r)) if not np.array_equal(mu_r[i], mu_t[i])),
                 len(mu_r))
    assert first == exact_turns
    np.testing.assert_array_equal(mu_r == 0, mu_t == 0)
    assert ulps(mu_r, mu_t) <= MU_ULPS
    np.testing.assert_array_equal(port["pool"].free_at, ref["pool"].free_at)
    rep_r = jmet.fault_report(ref["responses"], ref["info"]["ledger"], horizon=360.0)
    rep_t = tmet.fault_report(port["responses"], port["info"]["ledger"], horizon=360.0)
    assert rep_r.keys() == rep_t.keys()
    for key in rep_r:
        assert rep_r[key] == rep_t[key] or (np.isnan(rep_r[key]) and np.isnan(rep_t[key])), key
    assert (tmet.check_conservation(port["info"]["ledger"])
            == jmet.check_conservation(ref["info"]["ledger"]) == (True, {
                "tasks": 0, "real_copies": 0, "fakes": 0}))


@pytest.mark.parametrize("use_alias", [True, False], ids=["alias", "icdf"])
@pytest.mark.parametrize("name", FAULT_SCENARIOS)
def test_host_recovery_loop_matches_the_reference(name, use_alias):
    port = _port(name, use_alias, use_scan=False)
    ref = _ref(name, use_alias=use_alias)
    _assert_reference_bars(ref, port, EXACT_MU_TURNS["alias" if use_alias else "icdf"])


@pytest.mark.parametrize("use_alias", [True, False], ids=["alias", "icdf"])
@pytest.mark.parametrize("name", FAULT_SCENARIOS)
def test_faulty_scan_matches_the_reference_scan(ref_scan, name, use_alias):
    port = _port(name, use_alias, use_scan=True)
    ref = ref_scan.run_scenario(ref_scan.make(name), use_scan=True, sequential_pool=True,
                                arrival_batch=K, seed=0, recovery=REF_RECOVERY,
                                use_alias=use_alias)
    assert ref["info"]["pend_overflow"] == port["info"]["pend_overflow"] == 0
    _assert_reference_bars(ref, port, EXACT_MU_TURNS["alias" if use_alias else "icdf"])
