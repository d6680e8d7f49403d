"""Build ``csrc/sim_chain.cu`` with nvcc and load it with ctypes (through
``kernels/_nvcc.py``, shared by every kernel). It is compiled without FMA
contraction (``-fmad=false``): every float operation of the chain rounds
once, as its plain version's do. ``CLOCKED`` is the same source built with
``-DSIM_CHAIN_CLOCKS``: the per-phase cycle split (``kernel.clock_split``),
never the main path's library."""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels import _nvcc

SRC = Path(__file__).resolve().parent / "csrc" / "sim_chain.cu"

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # conf_i, conf_f, mu_sched, mu_hat0, dt, ev, u_svc, u_fake, j_fake, n_tasks,
    # pins, u, j, C, T, n, mt, J, K, S, cap, ring stride, tile rounds, trace_queues,
    # trace_mu,
    # trace columns (code, worker, n_tasks, task_workers, task_targets,
    # frontend, view_gap, sync_age, now, lam_hat, killed_fake, q_real, mu_hat),
    # final state (now, q_real, q_fake, s_real, busy_start, arr_times, arr_idx,
    # arr_count, lam_hat, samples, stamps, widx, count, epoch_start, mu_hat),
    # stream
    "sim_chain": (_P,) * 13 + (_I,) * 12 + (_P,) * 13 + (_P,) * 15 + (_P,),
}

LIBRARY = _nvcc.CudaLibrary(SRC, _SIGNATURES, "sim_chain_error_string",
                            extra_flags=("-fmad=false",))
#: sim_chain_clocks(out u64[chains, CK_SLOTS], chains): the records of the
#: clocked build's last launch
CLOCK_SIGNATURE = {"sim_chain_clocks": (_P, _I)}
CLOCKED = _nvcc.CudaLibrary(SRC, {**_SIGNATURES, **CLOCK_SIGNATURE}, "sim_chain_error_string",
                            extra_flags=("-fmad=false", "-DSIM_CHAIN_CLOCKS"))
library_path = LIBRARY.library_path
build = LIBRARY.build
load = LIBRARY.load
