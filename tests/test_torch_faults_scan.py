"""The port's failure semantics on the CPU, host against scan (section (ii)
of tests/test_torch_faults.py, in a file of its own so that the suite's
workers share the fault cases): with recovery armed (``RECOVERY``: timeout
x8, budget 2, retry_cap 4, spec_cap 2, ratio 3) the host recovery loop and
the faulty scan agree float for float on crash_storm, blackout and
grey_failure, on both probe streams: responses (NaN = lost), μ̂ trace,
``free_at``, the final learner and key, every ledger entry; the ledger
conserves and the capacities do not overflow.
"""
import numpy as np
import pytest

from repro_torch.core import metrics as tmet
from test_torch_faults import FAULT_SCENARIOS, RECOVERY, _run, _same


# ---------------------------------------------------------------------------
# (ii) host against scan on every fault scenario, recovery armed
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_alias", [True, False], ids=["alias", "icdf"])
@pytest.mark.parametrize("name", FAULT_SCENARIOS)
def test_fault_host_scan_parity(name, use_alias):
    h = _run(name, use_scan=False, recovery=RECOVERY, use_alias=use_alias)
    s = _run(name, use_scan=True, recovery=RECOVERY, use_alias=use_alias)
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
