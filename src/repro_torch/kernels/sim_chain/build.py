"""Build ``csrc/sim_chain.cu`` with nvcc and load it with ctypes (through
``kernels/_nvcc.py``, shared by every kernel). It is compiled without FMA
contraction (``-fmad=false``): every float operation of the chain rounds
once, as its plain version's do (the one fused multiply-add, the λ̂ EMA
step, is written out as ``__fmaf_rn``, as are the telemetry's queue mean in
the paper's mode and its detector's four steps). The one entry
``sim_chain`` runs the paper's own mode, or the environment and fleet
modes when given their inputs, each with the window telemetry when given
its inputs. ``CLOCKED`` is the same source built with ``-DSIM_CHAIN_CLOCKS``: the per-phase cycle split (``kernel.clock_split``),
never the main path's library."""
from __future__ import annotations

import ctypes
from pathlib import Path

from repro_torch.kernels import _nvcc

SRC = Path(__file__).resolve().parent / "csrc" / "sim_chain.cu"

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # conf_i, conf_f, mu_sched, mu_hat0, the draw columns dt, ev, u_svc,
    # u_fake, j_fake, n_tasks, pins, u, j, then u_thin, fe, u_pin, u_jfake,
    # uj, conf_x, conf_xf and the tracks (ref.EXT's order; all null in the
    # paper's mode), conf_o, conf_of, obs_thr (ref.OBS's order; all null
    # without telemetry); C, T, n, mt, J, K, S, cap, ring stride, tile
    # rounds, trace_queues, trace_mu, Ka, Kc, Km, Ks, Kr, F (the tracks'
    # lengths and the most frontends, 0 in the paper's mode), HB (the
    # telemetry's most bins, 0 without it);
    # trace columns (code, worker, n_tasks, task_workers, task_targets,
    # frontend, view_gap, sync_age, now, lam_hat, killed_fake, q_real,
    # mu_hat, killed, obs);
    # final state (now, q_real, q_fake, s_real, busy_start, arr_times,
    # arr_idx, arr_count, lam_hat, samples, stamps, widx, count, epoch_start,
    # mu_hat, then crash_i, q_snap, q_delta, mu_view, ema_last, ema_gap,
    # ema_count, t_sync, lam_global, alias_p, alias_a: null in the paper's
    # mode); stream
    "sim_chain": (_P,) * 33 + (_I,) * 19 + (_P,) * 15 + (_P,) * 26 + (_P,),
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
