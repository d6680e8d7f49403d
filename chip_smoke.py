#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of Rosella on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch`` (into ``build/``, one nvcc
per source, all at once) and holds each against its plain PyTorch version
on the card. Then it drives the port's two paths:

  * the scheduler: the serving turn (``RosellaRouter`` +
    ``run_simulation``) at a thousand-replica cell in three modes, through
    the PPoT dispatch kernels;
  * the one-program serving loop (``serving.scanloop``): every turn on the
    device, captured once as a CUDA graph and replayed, held bit for bit
    to the host loop at n=4 and n=1024, then run at the thousand-replica
    cell four ways (alias, inverse CDF, and 5% of the replicas offline
    mid-run under each) and at two thousand replicas with arrival batches
    of 2048 (alias), through the PPoT kernels, the alias-table build and
    the pool-chain kernel, whose result on a real turn of the alias cells
    is held bit for bit to its plain version;
  * the environment engine (``repro_torch.env``): the ten fault-free
    scenarios of the registry at the thousand-replica cell, each through
    the one-program loop beside the host loop (``run_workload``,
    ``run_workload_scan``), with the adaptation-time summary; four of them
    also through ``run_scenario`` on both loops with the exact pool chain,
    held equal bit for bit, two of those on the inverse-CDF stream too;
  * telemetry (``repro_torch.obs``): the windowed fold and the regime
    detector inside both loops at the thousand-replica cell (churn on the
    plain turn, crash_storm on the faulty turn), four modes each, held
    equal between the loops, to the runs without telemetry and across
    chunks, and the reference's detection pins on the card's scan;
  * the frontend fleet (``serving.router.FleetRouter``, the fleet turn of
    ``serving.scanloop``): four frontends over the thousand-replica cell,
    the host fleet loop and the one-program fleet held equal bit for bit
    on both probe streams and two sync cadences, the fleet at one frontend
    equal to the single-frontend scan, and three scenarios (frozen μ̂
    views, heavy churn, crash storms with the loss ledger) and telemetry
    through ``run_scenario(n_frontends=4)``;
  * the streaming load harness (``repro_torch.load``): about a million
    requests of an Azure-shaped generated trace streamed through the
    one-program loop at 64 workers (``ScenarioStream``,
    ``run_stream_scan``), a chunk at a time, with stream-only telemetry,
    decisions/s per chunk, RSS per chunk and the whole-horizon latency
    and λ̂ calibration; chunked held equal bit for bit to the monolithic
    loop on both probe streams, and on a crash_storm fault stream at the
    thousand-replica cell with its ledger;
  * the eight scheduling policies (``core.policies``): each one's engine
    call on the card held to the CPU's and timed at three shapes, and the
    scheduler cell under each through ``run_scenario`` on both loops, held
    equal bit for bit;
  * model serving: a full-width smollm-360m (published config, bf16,
    random weights from the seed) prefilled at B=4, S=4096 through
    ``models.api.prefill`` (one flash-attention launch per layer), then
    four such replicas as continuous-batching engines behind the router
    (``launch.serve._run_engine_executor``);
  * the SSM family: a full-width mamba2-370m prefilled at B=4, S=4096 (one
    SSD-scan launch per layer) and served by four engines behind the
    router, and a full-width hymba-1.5b prefilled at B=2, S=4096 (one
    flash-attention and one SSD-scan launch per layer);
  * the MoE, VLM and encoder-decoder families: moonshot-v1-16b-a3b at its
    published widths, 8 layers deep, prefilled at B=4, S=4096 (one
    flash-attention launch per layer at head dim 128) and served by four
    engines behind the router, each row's experts routed alone (held to a
    one-slot engine); the expert routers at benchmarks/moe_balance.py's
    settings; phi3.5-moe, pixtral-12b and whisper-medium prefilled and
    decoded at their published widths; one decode with the int8 cache;
  * training: K4 with its log-sum-exp and the flash-attention backward
    (K4b) held to their plain versions at the training shapes
    (``[train kernels]``); smollm-360m trained through
    ``launch.train.main`` at published widths and full depth (B=8,
    S=2048, two microbatches, remat full) for 6 steps with a checkpoint
    at step 3, a second ``main`` resumed from it (steps 4-6 equal bit for
    bit), two steps with int8 gradient sync against auto, one step
    profiled and split by source, and 2 layers held to the plain paths
    (``[train smollm-360m]``);

and times each kernel. Every phase is a hard failure: the script exits
non-zero and prints no result line. The last line of standard output is
the device record ``{"ok": true, "device": {...}}``; the line before it
lists the kernels.

It imports torch, numpy and the port, nothing of JAX or the JAX package,
and refuses to run without a CUDA card.

  python3 chip_smoke.py                  every phase, as above
  python3 chip_smoke.py --phase train    the kernels' build and
                                         [train smollm-360m] alone, in a
                                         fresh process (no result lines)
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# cuBLAS's workspace as deterministic algorithms need it ([train smollm-360m]
# turns them on); read when cuBLAS starts, so set before any CUDA work
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
BF16_OPS_PER_S = 989e12  # H100 SXM bf16 tensor cores, dense
TF32_OPS_PER_S = 495e12  # H100 SXM TF32 tensor cores, dense
# K4 and K5 before their redesign, at [times]'s shapes (main, small): the
# first ports' times on NVIDIA H100 80GB HBM3 at 700 W (PERF.md)
BEFORE_MS = {"flash_attention_fwd": {"main": 1.084800, "small": 0.111328},
             "ssd_scan": {"main": 3.182272, "small": 1.559024}}
# K2, K3 and the pairing walk before the alias table became one launch and
# the CDF probe a bisection, at [times]'s (n, B): their times on NVIDIA
# H100 80GB HBM3 at 700 W (PERF.md)
PPOT_BEFORE_MS = {
    "ppot_dispatch_fused": {1024: 0.017152, 2048: 0.031776},
    "ppot_dispatch": {1024: 0.016832, 2048: 0.030976},
    "alias_table": {1024: 0.081632, 2048: 0.158192},  # the pairing walk alone
    # K1 before it drew its own uniforms (the unkeyed kernel; in a graph
    # replay of [scan a] 0.002161 ms)
    "ppot_dispatch_fused_alias": {1024: 0.006176, 2048: 0.007296},
}
# The walk's serial chain, in cycles a step, each dependent instruction at
# least the 4-cycle issue-to-use latency of an f32 add. "sub": the floor that
# counts the subtraction r = pl - d alone. "step": the shortest chain a step
# can have, three deep: r_next = r < 1 ? n1 - (1 - r) : r - s1 needs the two
# subtractions 1 - r and n1 - (1 - r) in series, then the select (the compare
# r < 1 runs beside them).
CHAIN_CYCLES = {"sub": 4, "step": 12}
SOURCE = "src/repro_torch/kernels/ppot_dispatch/csrc/ppot_dispatch.cu"
POOL_SOURCE = "src/repro_torch/kernels/pool_chain/csrc/pool_chain.cu"
# not a Pallas kernel: the reference's inner lax.scan over a turn's
# submissions (pstep)
POOL_REPLACES = "src/repro/serving/scanloop.py:203-210"
# H100 SXM f64 outside the tensor cores (NVIDIA's data sheet)
F64_OPS_PER_S = 34e12
# the pool chain's serial floor in cycles a step of the longest per-replica
# chain of the inputs: its max and its f64 add, two dependent instructions,
# each at least 4 cycles before the next (chains on other replicas run
# beside it)
POOL_CHAIN_CYCLES = 8
# the pool chain's sized cases, (n, M, every step on one replica): the
# smallest, the scheduler cell's turn, an empty turn, the kernel's limit,
# and its worst case, one chain of M steps
POOL_CASES = ((4, 24, False), (1024, 136, False), (1024, 0, False), (16384, 4096, False),
              (16384, 4096, True))
FLASH_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention/kernel.py:105"
# each kernel line's name (its launch count's) -> the TPU kernel it replaces.
# ppot_dispatch_fused_alias is K1 as the engine launches it, keyed: it also
# replaces the reference's counter-hash draws (src/repro/core/dispatch.py:
# 268-285, _uniform_quad); the unkeyed entry runs the same kernel on given
# uniforms, as the Pallas kernel takes them
REPLACES = {
    "ppot_dispatch_fused_alias": "src/repro/kernels/ppot_dispatch/kernel.py:211",
    "ppot_dispatch_fused_alias_unkeyed": "src/repro/kernels/ppot_dispatch/kernel.py:211",
    "ppot_dispatch_fused": "src/repro/kernels/ppot_dispatch/kernel.py:242",
    "ppot_dispatch": "src/repro/kernels/ppot_dispatch/kernel.py:126",
    "alias_table": "src/repro/core/dispatch.py:108-195",
}
# the wrapper (in repro_torch.kernels.ppot_dispatch.kernel) that counts each
# kernel line's launches
WRAPPERS = {"ppot_dispatch_fused_alias": "ppot_dispatch_fused_alias_keyed",
            "ppot_dispatch_fused_alias_unkeyed": "ppot_dispatch_fused_alias",
            "ppot_dispatch_fused": "ppot_dispatch_fused", "ppot_dispatch": "ppot_dispatch",
            "alias_table": "alias_table"}
# [serve moonshot-v1-16b-a3b]'s router: its replicas and its batch (the
# engines and SERVE_BATCH below), the shape its K1 launches run at
MOE_ROUTER_SHAPE = (4, 4)
# the device key [times] times K1 under, and K1's operations a job: the
# counter hash's ~30 u32 operations, four conversions and scalings, the two
# probes and the select
K1_KEY = (0x9E3779B9, 0x7F4A7C15)
K1_OPS = 40
# the masks every PPoT kernel is held on: none, 10% of the workers off, a
# single worker on, all off

# the main-path cell: a thousand-replica cluster with the paper's §6.1
# k²/100 speeds, Poisson arrivals at 70% of capacity, batches of 128
N_REPLICAS, BATCH, LOAD, SEED = 1024, 128, 0.7, 0
TURNS = {"a": 2050, "b": 520, "c": 520}  # horizon, in expected turns
MIN_TURNS = {"a": 2000, "b": 500, "c": 500}
CHECK_EVERY = 10
# the scan at the same cell, against the host loop at async_mu=False with
# the same probe stream: (a) alias, (b) inverse CDF, (c) inverse CDF and
# (d) alias with 5% of the replicas offline from mid-run. Parity there is
# statistical (the host pool's closed-form chains are ~1e-12 from the
# scan's exact ones): p50 and p99 within SCAN_TOL of the host loop's, the
# bar of tests/test_scanloop.py
SCAN_MODES = {"a": (True, False), "b": (False, False), "c": (False, True),
              "d": (True, True), "e": (True, False)}  # (use_alias, churn)
# ~1550 turns a cell (2050 before the scenario phase came in, which keeps
# the whole script near 400 s)
SCAN_TURNS, SCAN_MIN_TURNS, SCAN_TOL = 1550, 1500, 0.15
SCAN_PROFILE_TURNS = 50
# replays a [scenario], [faults] or [obs] cell profiles for its busy time
# and idle share a turn (50, SCAN_PROFILE_TURNS, until the training phases
# came)
CELL_PROFILE_TURNS = 20
# [scan a]'s captured turn before K1 drew its own uniforms (its nodes on the
# H100): the keyed K1 takes out exactly the chain it replaced, bar K1
# itself (the counter hash's kernels and the copy of q; [times] captures and
# counts that chain)
SCAN_A_NODES_BEFORE = 816
# The profiler on the H100 now and then drops a graph kernel's record, at a
# random point of a session (one replay's K1, table and chain, or one
# kernel alone): a session whose per-turn counts miss the graph's nodes is
# run again, up to PROFILE_ATTEMPTS sessions, and the last must match
# exactly
PROFILE_ATTEMPTS = 3
# (e) the one-program loop at the paper's scale (§1: thousands of servers,
# millions of tasks a second): n = 2048 replicas, the largest n the
# reference's dispatch kernel is written for, with the same §6.1 speed grid
# and load and arrival batches of 2048; cut in turns only. The other cells
# run at (N_REPLICAS, BATCH, SCAN_TURNS, SCAN_MIN_TURNS)
SCAN_SHAPE = {"e": (2048, 2048, 300, 280)}  # (n, batch, turns, min turns)
# the cells whose real turn is held against the plain version and timed
REAL_TURN_MODES = ("a", "e")
# the environment engine (repro_torch.env) at the scheduler cell: n =
# N_REPLICAS with the same speeds, arrivals at LOAD·Σ speeds, batches of
# BATCH, async_mu=False, each scenario on its own clock (the registry's
# horizon of 360 s, its shifts at the registry's instants, its process
# parameters the registry's; only the cluster is scaled). churn,
# cotenant_shock and grey_failure touch the registry's fixed replicas 0-2,
# so at n = 1024 they move one or two replicas. Each runs through the
# one-program loop beside the host loop on a SimulatedPool (p50 and p99
# within SCAN_TOL); SCENARIO_EXACT also on a SequentialPool, where the two
# loops must be equal bit for bit, on the alias stream and, for
# SCENARIO_CDF, on the inverse-CDF stream (K2 unmasked, K3 under churn)
SCENARIOS = ("null", "reshuffle", "flash_crowd", "diurnal", "cotenant_shock", "speed_drift",
             "churn", "churn_heavy", "trace_replay", "grey_failure")
SCENARIO_EXACT = ("null", "flash_crowd", "churn", "churn_heavy")
SCENARIO_CDF = ("flash_crowd", "churn_heavy")
SCENARIO_FIXED_REPLICAS = {"churn": "replica 1", "cotenant_shock": "replicas 0-1",
                           "grey_failure": "replicas 0-1"}
SCENARIO_MIN_RHO = {"null": 0.9}
# the [scenario] runs' clock, and [obs]'s churn cell's, whose pend_cap and
# comp_cap the [scenario] churn cell sizes: 250 s of the registry's 360
# (every scenario's events up to its second at 240 s fall inside it; cut
# from 360 s to keep the script's total time when the [sim obs], [sim
# theory] and [sim coupling] cells came, and from 270 s when a run on a
# slow host passed 1000 s)
SCENARIO_HORIZON = 250.0
# [faults]: the failure semantics (serving.recovery, the faulty turn of
# serving.scanloop) at the scheduler cell, each fault scenario of the
# registry on its own clock as the [scenario] cells build theirs: the host
# recovery loop and the faulty one-program loop on a SequentialPool, equal
# bit for bit (responses with NaN for a lost task, μ̂ trace, free_at, every
# ledger entry) and conserved, recovery armed as tests/test_faults.py arms
# it; crash_storm also on the inverse-CDF stream (masked and slotted: K3).
# Then the null scenario with the inert config through the faulty turn,
# equal bit for bit to the plain turn. FAULT_HORIZON cuts depth only
FAULT_SCENARIOS = ("crash_storm", "blackout", "grey_failure")
FAULT_CDF = ("crash_storm",)
FAULT_RECOVERY = dict(timeout_mult=8.0, retry_budget=2, retry_cap=4, spec_cap=2,
                      spec_ratio=3.0)
FAULT_HORIZON = 360.0
# the capacities of the comparison run without recovery, which has no host
# loop to size them: the auto-sizing bound's cap, and a flush four times the
# armed cells' largest (every completion is clean there)
BARE_PEND_CAP, BARE_COMP_CAP = 65536, 1024
# [policies]: the eight policies of core.policies. (a) one engine call per
# policy on the card and on the CPU (same key, μ̂ on a 2^-8 grid so both
# devices build the same CDF), unmasked and with POLICY_OFFLINE of the
# replicas offline, workers and q_after equal, timed at POLICY_SHAPES (n,
# B): the reference throughput benchmark's headline shape, the scheduler
# cell's batch and [scan e]'s; the alias policies draw through a table
# built on each device outside the timed region, and PPoT-SQ(2) runs the
# CDF stream too (K2 unmasked, K3 masked). The sequential oracle
# (fold_chunks = B) is timed once per policy at the first shape. (b) the
# scheduler cell per policy: the null scenario at N_REPLICAS, LOAD and
# BATCH with async_mu=False, run_scenario's host loop and one-program loop
# on a SequentialPool, equal bit for bit; cut to POLICY_HORIZON seconds
# (~206 turns; 180 s until the training phases came) so the phase stays
# near 40 s
POLICY_SHAPES = ((64, 4096), (1024, 128), (2048, 2048))
POLICY_OFFLINE = 0.25
POLICY_HORIZON = 120.0
# [obs]: the windowed telemetry fold and the CUSUM regime detector
# (repro_torch.obs) inside both serving loops at the scheduler cell: churn
# through the plain turn, crash_storm (recovery as [faults]) through the
# faulty turn, on the [scenario]/[faults] clock, a SequentialPool and the
# capacities of those cells. Four modes a cell: off, windows, stream-only
# (no response or μ̂ rows) and windows + detector, each through the host
# loop and the one-program loop: off = on (responses, μ̂, ledger), host =
# scan (every record key), chunks of OBS_CHUNK = unchunked, stream-only =
# windows with a JsonlSink line a window, crash_storm's windows against its
# ledger. With observe=None the captured turns keep the node counts they had
# at these cells before the telemetry fold (OBS_NODES_BEFORE, measured on the
# H100: 866 and 1355 then, less the nodes the keyed K1 took out of the turn,
# 74 of the plain turn and 83 of the faulty one, counted by name against
# the turns before it by kernel_variants.py --parent). Then the reference's
# detection pins on
# the card's scan at the scenario's own size (n = 5, batches of 8, 360 s)
# OBS_HORIZON cuts depth only: crash_storm (crashes from the start) runs 180 s
# of its clock on the capacities of its 360 s [faults] cell; churn keeps
# [scenario]'s 250 s (at 180 s its replica would not rejoin, and its turn
# would capture one node fewer than the pinned OBS_NODES_BEFORE)
OBS_WINDOW = 16
OBS_CHUNK = 37
OBS_HORIZON = {"churn": SCENARIO_HORIZON, "crash_storm": 180.0}
OBS_NODES_BEFORE = {"churn": 792, "crash_storm": 1272}
OBS_PIN_BATCH = 8
# [fleet]: the frontend fleet (serving.router.FleetRouter, run_fleet_simulation,
# the one-program fleet turn) at the scheduler cell with the batch of BATCH
# split over FLEET_S frontends (the reference's benchmarks/fleet_scale.py
# setting), async_mu=False. (a) FLEET_TURNS turns through the host fleet loop
# and the fleet scan on a SequentialPool, equal bit for bit, for each
# (use_alias, sync_every) of FLEET_EXACT; (b) the same cell at S = 1 equal to
# the single-frontend scan; (c) run_scenario(n_frontends=FLEET_S) on the
# [scenario] clocks for FLEET_ENV (the reference benchmark's frozen-μ̂ setting
# on cotenant_shock; churn_heavy, no placement on an inactive replica;
# crash_storm without recovery, the ledger conserved); (d) churn with windows
# of FLEET_WINDOW turns, telemetry on = off. FLEET_TURNS cuts depth only
# (300 until the training phases came)
FLEET_S, FLEET_TURNS, FLEET_WINDOW = 4, 200, 16
# replays a fleet cell profiles: a 50-replay session of a ~3,000-node fleet
# graph is ~150,000 kernel records and 13-20 s of the profiler's own time,
# so the fleet profiles fewer replays than the single turn's cells
FLEET_PROFILE_TURNS = 10
FLEET_EXACT = ((True, 1), (True, 8), (False, 8))
FLEET_ENV = (("cotenant_shock", dict(sync_every=4, frozen_mu=True)), ("churn_heavy", {}),
             ("crash_storm", {}))
FLEET_PEND_CAP, FLEET_ENV_PEND_CAP = 16384, 32768
# [fleet mesh]: the collective fleet (fleet.sync.FrontendMesh, one process a
# rank over torch.distributed): a one-rank NCCL group made through a
# FileStore in a temporary directory (NCCL takes one rank a device, and the
# machine has one card), so D = 1 holds the S = FLEET_S frontends as local
# rows. [fleet]'s FLEET_EXACT cases through run_fleet_simulation_scan(mesh=),
# each equal bit for bit to [fleet]'s stacked scan of the same case
# (responses, μ̂, placements, epochs, sync gaps); the collectives are
# captured in the patterns' graphs. MESH_COLLECTIVE_REPS times one sync
# round's collectives at the turn's shapes, eagerly, in an event pair
MESH_COLLECTIVE_REPS = 200
# [load]: the streaming load harness (repro_torch.load) at the shape of the
# reference's benchmarks/loadtest.py:45-64, written out here: 64 workers (the
# speed tile x 8, capacity 76), base rate 40 under its Azure-shaped stream
# (diurnal x bursts, lognormal costs), batches of 128, chunks of 512 turns,
# the pending set and flush it sizes, stream-only windows of 64 turns,
# PPoT-SQ(2) on the alias stream, async_mu=False. (a) The full horizon, about
# a million requests, through run_stream_scan, timed a chunk at a time, then
# LOAD_PROFILE_TURNS replays of its graph under the profiler; (b) chunked =
# monolithic at LOAD_CHECK_HORIZON on the alias and CDF streams (and
# stream-only); (c) crash_storm at the [faults] cell's scaling cut to
# LOAD_FAULT_HORIZON, as a stream in chunks of LOAD_FAULT_CHUNK (coprime with
# windows of OBS_WINDOW), against the monolithic faulty scan
LOAD_SPEED_TILE, LOAD_TILES = (2.0, 2.0, 1.0, 1.0, 0.5, 1.5, 1.0, 0.5), 8
LOAD_RATE, LOAD_BATCH = 40.0, 128
LOAD_TRACE = dict(period=3600.0, depth=0.4, burst_factor=3.0, dwell=(120.0, 15.0),
                  cost_sigma=1.2)
LOAD_HORIZON, LOAD_CHECK_HORIZON, LOAD_MIN_REQUESTS = 20_600.0, 2_060.0, 1_000_000
LOAD_CHUNK, LOAD_PEND_CAP, LOAD_COMP_CAP, LOAD_WINDOW = 512, 8192, 512, 64
LOAD_PROFILE_TURNS = 20
LOAD_FAULT_HORIZON, LOAD_FAULT_CHUNK = 240.0, 37
# exact parity on the card: the reference test's shape (n=4) and n=1024 at
# a load where neither loop overflows a capacity
EXACT_N4 = dict(arrival_rate=3.0, horizon=150.0, seed=0, arrival_batch=16)
EXACT_LOAD, EXACT_TURNS, EXACT_PEND_CAP, EXACT_CHUNK = 0.5, 300, 8192, 7

# model serving: smollm-360m at its published widths (15 heads, 5 kv heads,
# d_head 64), prefilled at B=4, S=4096; four engine replicas of it at
# slowdowns 1, 3, 5, 1 with 4 slots of 256 positions each
PREFILL_B, PREFILL_S = 4, 4096
# last-position logits (|logit| < 4) of the kernel path against the plain
# chunked path, both bf16: they round attention's p and output to bf16 at
# other points in each of the 32 layers; 0.125 is 8 bf16 ulps at 2..4
PREFILL_TOL = 0.125
# the same model in f32 (the kernel's FMA variant against the plain chunked
# path), logits at every position: f32 rounding alone (1.5e-5 measured on
# an H100), far below the mean |logit| of 0.49, so a wrong tile or mask on
# any row shows
PREFILL_F32_TOL = 1e-4
SERVE_SLOWDOWNS = (1, 3, 5, 1)
SERVE_REQUESTS, SERVE_BATCH, SERVE_NEW = 64, 4, 8
# flash-attention against its plain version: elementwise as in
# tests/test_kernels.py, and each row's largest error over that row's
# largest |value| (ref.row_relative_error), which holds the late rows of a
# long causal sequence, whose values shrink below the elementwise atol.
# Rounding alone gives a row 1 bf16 ulp (2^-7) or ~1e-6 in f32; a kv tile
# dropped from the late rows gives ~0.2 (tests/test_torch_flash_attention.py)
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
FLASH_ROW_TOL = {"float32": 1e-4, "bfloat16": 2e-2}

SSD_SOURCE = "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu"
SSD_REPLACES = "src/repro/kernels/ssd_scan/kernel.py:90"
# the SSD scan against its plain version (the same chunked math in torch,
# f32 throughout, on the same inputs, bf16 x widened the same way): the
# two differ in summation order and in the last bits of the in-chunk
# cumulative log decay, whose rounding grows with |cum| (hundreds at the
# end of a 128-step chunk) and enters every decay factor. Elementwise
# |err| <= tol + tol * |want|, and each row's (last axis) largest error
# over that row's largest |value| (ref.row_relative_error); measured on an
# H100 at the mamba2 layer shape: 2.3e-4 abs at |value| <= 31, rows 3.7e-5.
# A key block or chunk left out moves a row by O(1) of its scale
SSD_TOL = 5e-4
SSD_ROW_TOL = 2e-4
# against the sequential oracle, the bars of tests/test_kernels.py
SSD_ORACLE_TOL = {"float32": 2e-3, "bfloat16": 5e-2}
# the SSM family's cells: mamba2-370m prefilled at B=4, S=4096 and served
# by four engines; hymba-1.5b prefilled at B=2, S=4096
MAMBA_B, MAMBA_S = 4, 4096
HYMBA_B, HYMBA_S = 2, 4096
# The SSM models take Mamba2's own decays (``with_mamba2_decays``), so that
# the state reaches across chunks. Last-position logits of the bf16 kernel
# path against the bf16 plain path: over 48 (32) layers the bf16 rounding
# of the residual stream parts any two roundings of the same function; the
# plain path against itself at chunk 64 instead of 128 parts by 0.133
# (mamba2) and 0.221 (hymba), the kernel path by 0.138 and 0.305 (measured
# on an H100; every run prints the floor), so this bar catches garbage and
# the carry-less fault of mamba2 (1.27), not hymba's (0.54). The argmax
# must agree wherever the plain path's own rechunking agrees. The f32
# twin's logits at every position against its plain path are the
# model-level check: measured 9.5e-5 / 8.2e-5 (floors 5.0e-5 / 6.6e-5, mean
# |logit| 0.51 / 0.80), while K5 without its chunk carry (``no_chunk_carry``,
# planted in every run, which fails unless the bar sees it) reads 4.4 / 3.9.
# The per-layer check is [ssd]'s, 2e-4 of each row's scale
SSM_PREFILL_TOL = 0.5
SSM_PREFILL_F32_TOL = 5e-4
SSM_SERVE_REQUESTS = 32
SSM_REUSE_CHECKS = 4
# the MoE family (ROADMAP A10a): moonshot-v1-16b-a3b at its published widths
# (d 2048, 16 heads of 128, 64 experts top-6, 2 shared, moe_dff 1408, vocab
# 163840), depth cut to MOE_LAYERS (its dense first layer and 7 MoE layers,
# ~9.7 GB of bf16 parameters), prefilled at B=4, S=4096 (one K4 launch a
# layer at D = 128), its f32 twin at MOE_F32_LAYERS; then served by four
# engines behind the router, MOE_SERVE_REQUESTS requests; the per-row check
# holds MOE_ROW_CHECKS requests to a one-slot engine
MOE_ARCH = "moonshot-v1-16b-a3b"
MOE_LAYERS, MOE_F32_LAYERS = 8, 2
MOE_B, MOE_S = 4, 4096
# last-position logits of the bf16 kernel path against the bf16 plain path on
# the kernel path's expert routes (moe.RouteTape), here and for [prefill zoo]:
# bf16 rounding at other points in every layer. Every run prints the floor
# (the plain path against itself at attention chunks of 256) beside it. Each
# arch has its own bar, twice the larger of its reading and its floor, both
# measured on an H100 and the same in every run: moonshot 0.2188 against a
# floor of 0.25 at |logit| up to 4.84 (16 bf16 ulps there), phi3.5-moe 0.0469
# against 0.0391, pixtral 0.0703 against 0.0781; whisper runs no K4 (1500
# frames, 448 positions: below the chunked path's 2048), so its two paths
# run the same operations and read 0 (bar: 4 bf16 ulps at |logit| 2..4).
# Free-running, one token whose gates the two roundings part takes another
# expert and an overflowing expert then drops other tokens: the plain path
# against itself at chunks of 256 read 3.39 on moonshot's last logits, so
# that difference is printed, not held. bf16 logits tie exactly (1/32 apart
# at 4..8, 163840 of them), so a last-position argmax of 4 rows is printed,
# not held. These bars catch a model-level fault; K4's bf16 body at each of
# these shapes is held elementwise by [flash] (its prefill-shape cases)
MOE_PREFILL_TOL = {MOE_ARCH: 0.5, "phi3.5-moe-42b-a6.6b": 0.1, "pixtral-12b": 0.16,
                   "whisper-medium": 0.0625}
# the f32 twin's logits at every position on the kernel path's routes
# (measured 3.5e-5 on an H100, mean |logit| 0.80), and the share of
# positions whose argmax agrees
MOE_F32_TOL = 2e-4
MOE_F32_AGREE = 0.999
MOE_SERVE_REQUESTS = 32
MOE_ROW_CHECKS = 4
# the per-row check in f32: a one-slot run's step whose two largest logits
# lie this close may pick either token once a 4-row step's rounding (f32,
# ~1e-5 of logits near 1) moves them
MOE_NEAR_TIE_F32 = 1e-3
# benchmarks/moe_balance.py's settings
MOE_BALANCE = dict(T=8192, E=64, k=6, seed=0)
# [prefill zoo]: (arch, layers (None: full depth), B, S) at published widths;
# pixtral's prefix holds its 1024 patch embeddings, whisper's encoder its
# 1500 frames (the decoder's 448 positions are whisper's own limit)
ZOO = (("phi3.5-moe-42b-a6.6b", 2, 4, 4096), ("pixtral-12b", 4, 2, 4096),
       ("whisper-medium", None, 4, 448))
ZOO_STEPS = 4
KVQ_TOKENS = 16


class SmokeFailure(Exception):
    pass


def need(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def spearman(x, y) -> float:
    """Rank correlation with average ranks for ties."""
    def ranks(a):
        a = np.asarray(a, np.float64)
        order = np.argsort(a, kind="stable")
        r = np.empty(len(a))
        r[order] = np.arange(len(a))
        _, inv, cnt = np.unique(a, return_inverse=True, return_counts=True)
        sums = np.bincount(inv, weights=r)
        return (sums / cnt)[inv]
    rx, ry = ranks(x), ranks(y)
    rx, ry = rx - rx.mean(), ry - ry.mean()
    return float((rx * ry).sum() / np.sqrt((rx * rx).sum() * (ry * ry).sum()))


def sustained_series(chunks: "list[dict]", *, warmup: int = 1) -> dict:
    """Sustained-throughput report from the chunk driver's per-chunk records
    (``info["chunks"]`` of a ``timing=True`` run, the reference's
    ``benchmarks/common.py:80``): decisions/s as a series, one point a chunk
    (the first ``warmup`` chunks, which pay the capture, kept in the series
    but left out of the sustained figure), and the RSS samples whose growth
    after the warm-up says whether the stream ran in bounded memory."""
    chunks = list(chunks)
    out: dict = {"n_chunks": len(chunks),
                 "warmup_chunks_excluded": min(warmup, max(len(chunks) - 1, 0))}
    if not chunks:
        return out
    body = chunks[out["warmup_chunks_excluded"]:]
    run_s = sum(c["run_s"] for c in body)
    reqs = sum(c["requests"] for c in body)
    decs = [c["requests"] / c["run_s"] for c in chunks if c["run_s"] > 0]
    rss = [c["rss_mb"] for c in chunks]
    out.update(
        requests_total=int(sum(c["requests"] for c in chunks)),
        turns_total=int(sum(c["turns"] for c in chunks)),
        decs_series=decs,
        decs_sustained=(reqs / run_s) if run_s > 0 else float("nan"),
        decs_min=min(decs) if decs else float("nan"),
        decs_max=max(decs) if decs else float("nan"),
        wall_s_total=sum(c["gen_s"] + c["run_s"] for c in chunks),
        gen_s_total=sum(c["gen_s"] for c in chunks),
        run_s_total=sum(c["run_s"] for c in chunks),
        rss_mb_series=rss,
        rss_mb_peak=max(rss),
        rss_mb_growth=(rss[-1] - rss[out["warmup_chunks_excluded"]] if len(rss) > 1 else 0.0))
    return out


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------


class KernelChecks:
    """Runs every kernel-vs-plain comparison and keeps the worst error."""

    def __init__(self, torch, K, R):
        self.torch, self.K, self.R = torch, K, R
        self.max_err = {name: 0.0 for name in REPLACES}
        self.checks = {name: 0 for name in REPLACES}

    def compare(self, name, got, want):
        torch = self.torch
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        if got[0].is_cuda:
            torch.cuda.synchronize()
        for g, w in zip(got, want):
            need(g.shape == w.shape and g.dtype == w.dtype,
                 f"{name}: {g.dtype}{list(g.shape)} vs plain {w.dtype}{list(w.shape)}")
            err = (g.double() - w.to(g.device).double()).abs().max().item() if g.numel() else 0.0
            self.max_err[name] = max(self.max_err[name], err)
            need(torch.equal(g, w.to(g.device)), f"{name}: differs from its plain "
                 f"version (max abs err {err})")
        self.checks[name] += 1

    def plain(self, name):
        R = self.R
        return {"ppot_dispatch_fused_alias": R.ppot_dispatch_fused_alias_keyed_ref,
                "ppot_dispatch_fused_alias_unkeyed": R.ppot_dispatch_fused_alias_ref,
                "ppot_dispatch_fused": R.ppot_dispatch_fused_ref,
                "ppot_dispatch": R.ppot_dispatch_ref,
                "alias_table": R.alias_table_ref}[name]

    def wrap(self, name, every: int):
        """A stand-in for the wrapper of kernel line ``name`` that runs the
        kernel and, on every ``every``-th call, its plain version on the
        same device tensors."""
        fn, plain, calls = getattr(self.K, WRAPPERS[name]), self.plain(name), [0]

        def checked(*args, **kw):
            out = fn(*args, **kw)
            calls[0] += 1
            if calls[0] % every == 1:
                self.compare(name, out, plain(*args, **kw))
            return out
        return checked

    @contextlib.contextmanager
    def checking(self, every: int):
        """Every wrapper replaced by its ``wrap`` for the block."""
        saved = {attr: getattr(self.K, attr) for attr in WRAPPERS.values()}
        for name, attr in WRAPPERS.items():
            setattr(self.K, attr, self.wrap(name, every))
        try:
            yield
        finally:
            for attr, fn in saved.items():
                setattr(self.K, attr, fn)


def hold_keyed(torch, chk, prob, alias, q, B: int, seed: int, dev) -> None:
    """The keyed K1 against its plain version on the same tables and queue:
    a host key and a device key with any bits set, without and with a
    slot mask (a fifth of the slots off)."""
    from repro_torch.utils import prng

    rng = np.random.RandomState(seed)
    act = torch.from_numpy(rng.rand(B) < 0.8).to(dev)
    hk = prng.split(prng.PRNGKey(seed))[1]
    for key in (hk, prng.device_key(hk, dev)):
        for a in (None, act):
            chk.compare("ppot_dispatch_fused_alias",
                        chk.K.ppot_dispatch_fused_alias_keyed(prob, alias, q, key, B, a),
                        chk.R.ppot_dispatch_fused_alias_keyed_ref(prob, alias, q, key, B, a))


def phase_kernels(torch, chk, D, dev):
    K, R = chk.K, chk.R
    shapes = [(n, B) for n in (1024, 2048) for B in (128, 300, 4096, 16384)]
    for n, B in shapes:
        for case in ("random", "zero", "single_hot"):
            for kind in R.MASKS:
                rng = np.random.RandomState(n + B)
                mu = rng.rand(n).astype(np.float32) * 5
                if case != "random":
                    mu[:] = 0
                if case == "single_hot":
                    mu[rng.randint(n)] = 3.0
                mu_t = torch.from_numpy(mu).to(dev)
                q = torch.from_numpy(rng.randint(0, 50, n).astype(np.int32)).to(dev)
                u1, u2, v1, v2 = (torch.from_numpy(rng.randint(0, 65536, B).astype(
                    np.float32) / 65536.0).to(dev) for _ in range(4))
                m = R.make_mask(kind, n, rng)
                act = None if m is None else torch.from_numpy(m).to(dev)
                cdf = R.make_cdf(mu_t) if act is None else D.masked_cdf(mu_t, act)
                p = D.scaled_weights(mu_t, act)
                prob, alias = K.alias_table(p, act)
                chk.compare("alias_table", (prob, alias), R.alias_table_ref(p, act))
                hold_keyed(torch, chk, prob, alias, q, B, n + B, dev)
                chk.compare("ppot_dispatch_fused_alias_unkeyed",
                            K.ppot_dispatch_fused_alias(prob, alias, q, u1, v1, u2, v2),
                            R.ppot_dispatch_fused_alias_ref(prob, alias, q, u1, v1, u2, v2))
                chk.compare("ppot_dispatch_fused", K.ppot_dispatch_fused(cdf, q, u1, u2),
                            R.ppot_dispatch_fused_ref(cdf, q, u1, u2))
                chk.compare("ppot_dispatch", K.ppot_dispatch(cdf, q, u1, u2),
                            R.ppot_dispatch_ref(cdf, q, u1, u2))
    print(f"[kernels] {len(shapes) * 3 * len(R.MASKS)} shape/μ̂/mask cases (masks {R.MASKS}): "
          f"every kernel equal to its plain version (workers, q_after, prob, alias); the "
          f"keyed K1 under a host key and a device key, with and without slots")


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------


def make_router_class(tr):
    class CheckedRouter(tr.RosellaRouter):
        """RosellaRouter that checks every turn's output, can take part of
        the cluster offline mid-run, and at turn ``flood_at`` adds a burst
        of completions (service times drawn from the true ``speeds``) ahead
        of the due ones, so that the flush overflows SERVE_COMP_CAP and
        takes the ``complete_arrays`` path on the card."""

        membership_at: tuple | None = None
        flood_at: int | None = None
        speeds: np.ndarray | None = None
        overflow_turns = 0
        turns = 0
        max_due = 0  # the largest completion flush of a turn
        in_flight = max_in_flight = 0  # submitted and not yet flushed

        def serve_turn(self, now, k, comp_workers=None, comp_times=None, comp_now=None):
            if self.membership_at is not None and now >= self.membership_at[0]:
                self.set_membership(self.membership_at[1], now)
                self.membership_at = None
            if self.turns == self.flood_at:
                rng = np.random.RandomState(self.turns)
                live = (np.arange(self.n) if self.active is None
                        else np.nonzero(self.active.cpu().numpy())[0])
                w = rng.choice(live, tr.SERVE_COMP_CAP + 40).astype(np.int32)
                ts = rng.exponential(1.0, len(w)) / self.speeds[w]
                comp_workers = w if comp_workers is None else np.concatenate([w, comp_workers])
                comp_times = ts if comp_times is None else np.concatenate([ts, comp_times])
                comp_now = now if comp_now is None else comp_now
            due = 0 if comp_workers is None else len(comp_workers)
            if due > tr.SERVE_COMP_CAP:
                self.overflow_turns += 1
            fake, workers = super().serve_turn(now, k, comp_workers, comp_times, comp_now)
            self.turns += 1
            self.max_due = max(self.max_due, due)
            self.in_flight += len(fake) + k - due
            self.max_in_flight = max(self.max_in_flight, self.in_flight)
            need(len(workers) == k, "wrong batch size")
            routed = np.concatenate([fake, workers])
            need(((routed >= 0) & (routed < self.n)).all(), "worker out of range")
            if self.active is not None:
                act = self.active.cpu().numpy()
                need(act[routed].all(), "routed to an inactive replica")
            need(int(self.q_view.min()) >= 0, "negative queue view")
            return fake, workers
    return CheckedRouter


def run_mode(torch, tr, K, chk, speeds, mode: str, dev):
    use_alias, async_mu = {"a": (True, True), "b": (False, False),
                           "c": (False, False)}[mode]
    Router = make_router_class(tr)
    rate = LOAD * float(speeds.sum())
    horizon = TURNS[mode] * BATCH / rate
    router = Router(N_REPLICAS, float(speeds.sum()), seed=SEED, use_alias=use_alias,
                    async_mu=async_mu, device=dev)
    router.speeds, router.flood_at = speeds, TURNS[mode] // 4
    if mode == "c":
        off = np.random.RandomState(SEED + 1).choice(N_REPLICAS, N_REPLICAS // 20,
                                                     replace=False)
        act = np.ones(N_REPLICAS, bool)
        act[off] = False
        router.membership_at = (horizon / 2, act)
    with chk.checking(CHECK_EVERY):
        K.reset_launches()
        t0 = time.perf_counter()
        resp, mu_trace = tr.run_simulation(
            router, tr.SimulatedPool(speeds), arrival_rate=rate, horizon=horizon,
            request_cost=1.0, seed=SEED, arrival_batch=BATCH)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = K.launch_counts()
    return router, resp, mu_trace, wall, counts


def phase_main_path(torch, tr, K, met, chk, speeds, dev):
    results = {}
    expect = {"a": ("ppot_dispatch_fused_alias", "alias_table"),
              "b": ("ppot_dispatch_fused",),
              "c": ("ppot_dispatch_fused", "ppot_dispatch")}
    for mode in ("a", "b", "c"):
        router, resp, mu_trace, wall, counts = run_mode(torch, tr, K, chk, speeds, mode, dev)
        turns = router.turns
        need(turns >= MIN_TURNS[mode], f"run ({mode}): only {turns} turns")
        for name in expect[mode]:
            need(counts[name] > 0, f"run ({mode}): {name} was never launched")
        need(router.overflow_turns > 0, f"run ({mode}): no flush overflowed "
             f"SERVE_COMP_CAP, so complete_arrays never ran")
        need(np.isfinite(resp).all() and (resp > 0).all(), f"run ({mode}): bad responses")
        s = met.serve_summary(resp)
        rho = spearman(router.mu_hat, speeds)
        results[mode] = dict(turns=turns, launches=counts, wall_s=wall, rho=rho,
                             overflow_turns=router.overflow_turns, **s)
        print(f"[main {mode}] turns={turns} requests={s['n_requests']} "
              f"p50={s['p50']:.6f} p99={s['p99']:.6f} mean={s['mean']:.6f} "
              f"turns/s={turns / wall:.2f} decisions/s={s['n_requests'] / wall:.1f} "
              f"spearman(mu_hat, speeds)={rho:.4f} overflow_turns={router.overflow_turns} "
              f"launches={counts}")
    need(results["a"]["rho"] >= 0.9,
         f"run (a): μ̂ ranks the replicas poorly (Spearman {results['a']['rho']:.3f})")
    print(f"[main] kernel-vs-plain checks during the runs: {chk.checks}")
    return results


def phase_turn_cost(torch, tr, speeds, timed_turns: int = 300, prof_turns: int = 60):
    """Where a turn of the default mode goes: wall clock of an unchecked,
    unprofiled run split into the router's turn and the rest of the loop
    (the numpy replica pool, arrivals, the μ̂ trace), then CUDA launches
    and device busy time per turn from torch.profiler."""
    class TimedRouter(tr.RosellaRouter):
        turn_s = 0.0

        def serve_turn(self, *args, **kw):
            t0 = time.perf_counter()
            out = super().serve_turn(*args, **kw)
            self.turn_s += time.perf_counter() - t0
            return out

    rate = LOAD * float(speeds.sum())
    router = TimedRouter(N_REPLICAS, float(speeds.sum()), seed=SEED)
    tr.run_simulation(router, tr.SimulatedPool(speeds), arrival_rate=rate,
                      horizon=20 * BATCH / rate, seed=SEED, arrival_batch=BATCH)
    router.turn_s = 0.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resp, mu = tr.run_simulation(router, tr.SimulatedPool(speeds), arrival_rate=rate,
                                 horizon=timed_turns * BATCH / rate, seed=SEED + 1,
                                 arrival_batch=BATCH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    turns = len(mu)
    print(f"[turn] {turns} unchecked turns of run (a): {turns / wall:.2f} turns/s, "
          f"{len(resp) / wall:.1f} decisions/s, {wall / turns * 1e3:.3f} ms/turn, "
          f"of which serve_turn {router.turn_s / turns * 1e3:.3f} ms "
          f"({router.turn_s / wall:.4f} of the wall clock)")

    mus = []
    prof = device_profile(torch, lambda: mus.append(tr.run_simulation(
        router, tr.SimulatedPool(speeds), arrival_rate=rate,
        horizon=prof_turns * BATCH / rate, seed=SEED + 2, arrival_batch=BATCH)[1]))
    pturns = len(mus[0])
    kernels, copies, idle = prof["launches"], prof["copies"], prof["idle"]
    top = sorted(prof["count"].items(), key=lambda kv: -kv[1])[:8]
    print(f"[profile] {pturns} turns of run (a): {kernels / pturns:.1f} kernel launches "
          f"and {copies / pturns:.1f} copies per turn; device busy "
          f"{prof['busy_us'] / 1e3:.3f} ms of {prof['wall'] * 1e3:.3f} ms wall (idle share {idle:.4f})")
    print(f"[profile] most launched: {[(n[:90], c) for n, c in top]}")
    return kernels / pturns, copies / pturns, idle


# ---------------------------------------------------------------------------
# the one-program serving loop: every turn on the device, as a CUDA graph
# ---------------------------------------------------------------------------

# the wrapper that launched a kernel, from the kernel's name as the profiler
# gives it (demangled, spaces dropped) or as the driver does (mangled)
PROFILE_NAMES = {"ppot_dispatch_fused_alias": ("ppot_kernel_alias<true>",
                                               "ppot_kernel_aliasILb1E"),
                 "ppot_dispatch_fused_alias_unkeyed": ("ppot_kernel_alias<false>",
                                                       "ppot_kernel_aliasILb0E"),
                 "ppot_dispatch_fused": ("ppot_kernel_cdf<true>", "ppot_kernel_cdfILb1E"),
                 "ppot_dispatch": ("ppot_kernel_cdf<false>", "ppot_kernel_cdfILb0E"),
                 "alias_table": ("alias_table_kernel",) * 2,
                 "pool_chain": ("pool_chain_kernel",) * 2}


# the wrappers the serving paths launch: every one but the unkeyed K1, which
# takes its uniforms as arguments and which no engine path calls
PATH_WRAPPERS = tuple(w for w in PROFILE_NAMES if w != "ppot_dispatch_fused_alias_unkeyed")


def wrapper_of(kernel_name: str):
    nm = kernel_name.replace(" ", "")
    return next((w for w, pats in PROFILE_NAMES.items() if any(p in nm for p in pats)),
                None)


def by_wrapper(counts: dict) -> dict:
    """Kernel counts by name -> counts by the wrapper that launched them."""
    out = {w: 0 for w in PROFILE_NAMES}
    for name, c in counts.items():
        w = wrapper_of(name)
        if w is not None:
            out[w] += c
    return out


def pool_chain_case(torch, dev, n, M, seed, one=False):
    """A turn's submissions at (n, M): random replicas, one replica repeated
    30 times, arrivals equal to a replica's free_at (ties) and inactive
    slots; with ``one``, every step on that replica."""
    rng = np.random.RandomState(seed)
    fa = rng.rand(n) * 3
    sp = rng.rand(n) + 0.05
    w = rng.randint(0, n, M).astype(np.int32)
    r = min(5, n - 1)
    w[10:40] = r
    if one:
        w[:] = r
    a = np.sort(rng.rand(M) * 3)
    if M > 50:
        a[12] = fa[r]
        a[50] = fa[w[50]]
    c = rng.exponential(1.0, M)
    act = rng.rand(M) < 0.9
    return tuple(torch.from_numpy(x).to(dev) for x in (fa, sp, w, a, c, act))


def pool_case_label(n, M, one) -> str:
    return f"n={n} M={M}" + (" one replica" if one else "")


def held_equal(torch, tag, parts, got, want) -> float:
    """need() every output of the kernel equal to the plain version's, NaN
    where it has NaN; returns the largest |difference| elsewhere."""
    err = 0.0
    for part, g, w in zip(parts, got, want):
        need(g.dtype == w.dtype and g.shape == w.shape,
             f"{tag} {part}: {g.dtype}{list(g.shape)} against {w.dtype}{list(w.shape)}")
        fl = w.is_floating_point()
        nan = torch.isnan(w) if fl else torch.zeros_like(w, dtype=torch.bool)
        same = torch.equal(torch.isnan(g) if fl else nan, nan) and torch.equal(g[~nan], w[~nan])
        if fl and bool((~nan).any()):
            err = max(err, torch.where(g == w, 0.0, (g - w).abs())[~nan].max().item())
        need(same, f"{tag} {part} differs from the plain version (max abs err {err})")
    return err


def phase_pool_chain(torch, CK, CR, dev):
    """The pool-chain kernel against its plain version (the host walk), bit
    for bit, at POOL_CASES's sizes and on the planted chains."""
    cases = {pool_case_label(n, M, one): pool_chain_case(torch, dev, n, M, n + M, one)
             for n, M, one in POOL_CASES}
    cases.update({name: tuple(torch.from_numpy(x).to(dev) for x in case)
                  for name, case in CR.planted_chains().items()})
    err = 0.0
    for name, args in cases.items():
        got, want = CK.pool_chain(*args), CR.pool_chain_ref(*args)
        torch.cuda.synchronize()
        err = max(err, held_equal(torch, f"[scan] pool_chain {name}",
                                  ("start", "done", "free_at"), got, want))
        print(f"[scan] pool_chain {name}: start, done and free_at bit-equal to the plain "
              f"version (f64); longest chain {CR.longest_chain(args[2], args[0].shape[0])}, "
              f"{int((~args[5]).sum())} inactive")
    return err


def scan_turn_args(torch, tr, tsl, speeds, dev, use_alias: bool, B: int, comp_cap: int,
                   pend_cap: int, turns: int = SCAN_PROFILE_TURNS):
    """The pool_turn arguments of a real turn of a cell (no churn): turn
    ``turns`` of a scan from a fresh router on the cell's workload draws, the
    turns before it replayed from the graph in chunks of at most
    SCAN_PROFILE_TURNS, this one run eagerly on a copy of the carry."""
    n = len(speeds)
    rate = LOAD * float(speeds.sum())
    times, costs, sp = tsl._precompute_workload(rate, (turns + 10) * B / rate, 1.0, None,
                                                SEED, B, speeds)
    need(len(times) > turns, f"only {len(times)} turns drawn for a real turn")
    router = tr.RosellaRouter(n, float(speeds.sum()), seed=SEED, use_alias=use_alias,
                              async_mu=False, device=dev)
    cfg = tsl.scan_config(router, B, fake_cost=0.25, pend_cap=pend_cap, comp_cap=comp_cap)
    run = tsl.runner(cfg, str(dev), SCAN_PROFILE_TURNS)
    run.load(router, tr.SimulatedPool(speeds))
    for s in range(0, turns, SCAN_PROFILE_TURNS):
        e = min(s + SCAN_PROFILE_TURNS, turns)
        run.run_chunk(dict(times=times[s:e], costs=costs[s:e], speeds=sp[s:e]))
    real, rec = tsl.pool_kernel.pool_turn, []

    def spy(*args, **kw):
        rec.append(tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args))
        return real(*args, **kw)

    carry = {name: t.clone() for name, t in run.carry.items()}
    x = {name: torch.from_numpy(np.ascontiguousarray(v[turns])).to(run.device)
         for name, v in (("times", times), ("costs", costs), ("speeds", sp))}
    tsl.pool_kernel.pool_turn = spy
    try:
        tsl._turn(run.cfg, carry, x)
    finally:
        tsl.pool_kernel.pool_turn = real
    need(len(rec) == 1, f"a turn called pool_turn {len(rec)} times")
    return rec[0]


def chain_by_turn(torch, tr, tsl, cfg, speeds, dev, use_alias: bool, cols: dict):
    """The longest per-replica chain of each turn of a cell (no churn) and
    the μ̂ entering each turn: the scan replayed a turn a chunk from a fresh
    router, the carry's ``chain_max`` zeroed before each turn and read after
    it. Returns (i64[T], f32[T, n])."""
    T = len(cols["times"])
    run = tsl.runner(cfg, str(dev), T)
    router = tr.RosellaRouter(len(speeds), float(speeds.sum()), seed=SEED,
                              use_alias=use_alias, async_mu=False, device=dev)
    run.load(router, tr.SimulatedPool(speeds))
    chains, mus = np.zeros(T, np.int64), []
    for t in range(T):
        run.carry["chain_max"].zero_()
        mus.append(run.run_chunk({name: v[t:t + 1] for name, v in cols.items()})[1][0])
        chains[t] = int(run.carry["chain_max"].item())
    need(int(run.carry["over_flush"].item()) == 0 and int(run.carry["over_pend"].item()) == 0,
         "the turn-by-turn scan overflowed a capacity")
    return chains, np.stack(mus)


def chain_cause(chains, mus, speeds, B: int) -> dict:
    """What set the longest chain of a run: its turn, the replica whose μ̂
    weighs most in the next turn's μ̂ (the μ̂ that turn's dispatch read,
    after the turn's own completions were folded in), that replica's share
    of μ̂ and of the true speeds, and the steps PPoT-SQ(2) sends it when both
    of an arrival's probes land on it (B·share²) and, at most, when one
    does (B·(1 - (1 - share)²): it then wins where its queue is shorter)."""
    t = int(np.argmax(chains))
    mu = mus[min(t + 1, len(mus) - 1)].astype(np.float64)
    j = int(np.argmax(mu))
    share = float(mu[j] / mu.sum())
    top = np.argsort(-chains, kind="stable")[:5]
    return dict(turn=t, chain=int(chains[t]), replica=j, mu_share=share,
                speed_share=float(speeds[j] / speeds.sum()),
                mu_over_speed=float(mu[j] / speeds[j]),
                mu_share_before=float(mus[t][j] / mus[t].sum()),
                both_probes=B * share ** 2, one_probe=B * (1 - (1 - share) ** 2),
                median_chain=float(np.median(chains)),
                turns_over_100=int((chains > 100).sum()),
                top_turns={int(i): int(chains[i]) for i in top})


def check_real_turn(torch, CK, CR, mode, turn, args) -> dict:
    """A real turn's pool_turn against its plain version, bit for bit."""
    n, k = args[0].shape[0], args[4].shape[0]
    got, want = CK.pool_turn(*args), CR.pool_turn_ref(*args)
    torch.cuda.synchronize()
    err = held_equal(torch, f"[scan {mode}] pool_chain on real turn {turn}",
                     ("start", "done", "sub_w", "act", "free_at", "resp"), got, want)
    M = want[0].shape[0]
    longest = CR.longest_chain(want[2], n)
    print(f"[scan {mode}] pool_chain on real turn {turn} (n={n}, M={M}, k={k}): start, "
          f"done, sub_w, act, free_at and resp bit-equal to the plain version; longest "
          f"chain {longest}, {int(torch.unique(want[2]).numel())} replicas touched")
    return dict(turn=turn, n=n, M=M, longest_chain=longest, err=err)


def real_turn_label(mode, turn, n, M) -> str:
    return f"real turn {turn} of [scan {mode}] n={n} M={M}"


def _same_run(tag, host, scan):
    """The scan's outputs and final state against the host loop's, bit for bit."""
    (ra, pa, rh, mh), (rb, pb, rs_, ms) = host, scan
    for part, ok in (("responses", np.array_equal(rh, rs_)),
                     ("mu trace", np.array_equal(mh, ms)),
                     ("free_at", np.array_equal(pa.free_at, pb.free_at)),
                     ("q_view", bool((ra.q_view == rb.q_view).all())),
                     ("learner mu_hat", bool((ra.learner.mu_hat == rb.learner.mu_hat).all())),
                     ("key", ra.key == rb.key)):
        need(ok, f"[scan] {tag}: the graph's {part} differ from the host loop's")


def phase_scan_exact(torch, tr, tsl, speeds, dev):
    """The scan (graph replays) against the host loop, both on the card, with
    SequentialPool and async_mu=False: equal at the reference test's shape
    and at n=1024, and in chunks of EXACT_CHUNK turns equal to one chunk."""
    s4 = np.array([0.25, 0.5, 1.0, 2.0])
    rate = EXACT_LOAD * float(speeds.sum())
    big = dict(arrival_rate=rate, horizon=EXACT_TURNS * BATCH / rate, seed=SEED,
               arrival_batch=BATCH)
    Router = make_router_class(tr)
    out = {}
    for label, n, sp, kw, pend_cap in (("n=4", 4, s4, EXACT_N4, tsl.PEND_CAP),
                                       (f"n={N_REPLICAS}", N_REPLICAS, speeds, big,
                                        EXACT_PEND_CAP)):
        for use_alias in (True, False):
            tag = f"{label} {'alias' if use_alias else 'icdf'}"
            mk = lambda: Router(n, float(sp.sum()), seed=SEED, async_mu=False,  # noqa: E731
                                use_alias=use_alias, device=dev)
            ra, pa = mk(), tr.SequentialPool(sp)
            rh, mh = tr.run_simulation(ra, pa, **kw)
            need(ra.overflow_turns == 0, f"[scan] {tag}: the host loop overflowed")
            runs = {}
            for chunk in (None, EXACT_CHUNK):
                rb, pb = mk(), tr.SequentialPool(sp)
                rs_, ms, info = tsl.run_simulation_scan(rb, pb, pend_cap=pend_cap,
                                                        chunk_turns=chunk, **kw)
                need(info["flush_overflow"] == 0 and info["pend_overflow"] == 0,
                     f"[scan] {tag}: {info}")
                need(info["graph_nodes"] is not None and info["replays"] == info["turns"],
                     f"[scan] {tag}: the turns were not graph replays ({info})")
                _same_run(f"{tag} chunk={chunk}", (ra, pa, rh, mh), (rb, pb, rs_, ms))
                runs[chunk] = info
            out[tag] = dict(turns=len(mh), nodes=runs[None]["graph_nodes"])
            print(f"[scan] exact {tag} (k={kw['arrival_batch']}, rate "
                  f"{kw['arrival_rate']:.3f}, pend_cap {pend_cap}): {len(mh)} turns, "
                  f"responses, mu trace, free_at, q_view, learner mu_hat and key equal to "
                  f"the host loop on the card, unchunked and in chunks of {EXACT_CHUNK}; "
                  f"overflows 0 (host overflow_turns 0); graph nodes "
                  f"{runs[None]['graph_nodes']}")
    return out


def _pow2_at_least(x: float) -> int:
    return 1 << max(int(math.ceil(math.log2(max(x, 1.0)))), 0)


def scan_cell(torch, tr, tsl, K, CK, CR, met, speed_set, dev, mode: str):
    """A scheduler cell through the scan, beside the host loop at
    async_mu=False with the same probe stream (and the same membership
    change), on the same workload draws. Returns its record and, for
    REAL_TURN_MODES, the pool_turn arguments of its real turns by index:
    turn SCAN_PROFILE_TURNS and the turn with the run's longest chain."""
    use_alias, churn = SCAN_MODES[mode]
    n, B, turns, min_turns = SCAN_SHAPE.get(mode, (N_REPLICAS, BATCH, SCAN_TURNS,
                                                   SCAN_MIN_TURNS))
    speeds = speed_set(n, SEED)
    rate = LOAD * float(speeds.sum())
    horizon = turns * B / rate
    off = np.random.RandomState(SEED + 1).choice(n, n // 20, replace=False)
    act = np.ones(n, bool)
    act[off] = False
    host = make_router_class(tr)(n, float(speeds.sum()), seed=SEED,
                                 use_alias=use_alias, async_mu=False, device=dev)
    host.speeds = speeds
    if churn:
        host.membership_at = (horizon / 2, act)
    t0 = time.perf_counter()
    resp_h, _ = tr.run_simulation(host, tr.SimulatedPool(speeds), arrival_rate=rate,
                                  horizon=horizon, seed=SEED, arrival_batch=B)
    torch.cuda.synchronize()
    wall_h = time.perf_counter() - t0
    comp_cap = _pow2_at_least(1.25 * host.max_due)
    pend_cap = _pow2_at_least(1.25 * host.max_in_flight)

    times, costs, sp = tsl._precompute_workload(rate, horizon, 1.0, None, SEED, B, speeds)
    T = len(times)
    cols_all = dict(times=times, costs=costs, speeds=sp)
    active = (np.where((times[:, -1] >= horizon / 2)[:, None], act[None], True)
              if churn else None)
    router = tr.RosellaRouter(n, float(speeds.sum()), seed=SEED,
                              use_alias=use_alias, async_mu=False, device=dev)
    K.reset_launches()
    CK.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resp, mu_trace, info = tsl.run_workload_scan(
        router, tr.SimulatedPool(speeds), times, costs, sp, active_np=active,
        fake_cost=0.25, pend_cap=pend_cap, comp_cap=comp_cap)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # launches of this run: the eager warm-up turns before the capture (the
    # wrappers' counts; nothing is counted under capture) and each replay's
    # kernel nodes, read from the captured graph, times the replays issued
    eager = {**K.launch_counts(), **CK.launch_counts()}
    per_replay = by_wrapper(info["graph_kernels"])
    launches = {w: eager[w] + info["replays"] * per_replay[w] for w in PROFILE_NAMES}
    need(info["graph_nodes"] is not None and info["replays"] == info["turns"],
         f"[scan {mode}] the turns were not graph replays ({info['replays']} replays "
         f"for {info['turns']} turns, {info['graph_nodes']} nodes)")
    need(info["turns"] >= min_turns, f"[scan {mode}] only {info['turns']} turns")
    need(info["flush_overflow"] == 0 and info["pend_overflow"] == 0, f"[scan {mode}] {info}")
    need(np.isfinite(resp).all() and (resp > 0).all() and resp.shape == (T * B,)
         and mu_trace.shape == (T, n), f"[scan {mode}] bad responses or trace")
    need(info["longest_chain"] >= 1, f"[scan {mode}] no chain was walked ({info})")
    if churn:
        need(bool((router.active.cpu().numpy() == act).all()),
             f"[scan {mode}] the final membership was not written back")
    s, sh = met.serve_summary(resp), met.serve_summary(resp_h)
    rho = spearman(router.mu_hat, speeds)
    for q in ("p50", "p99"):
        need(abs(s[q] - sh[q]) <= SCAN_TOL * sh[q], f"[scan {mode}] {q} {s[q]:.6f} is not "
             f"within {SCAN_TOL} of the host loop's {sh[q]:.6f}")
    need(rho >= 0.9, f"[scan {mode}] μ̂ ranks the replicas poorly (Spearman {rho:.4f})")

    # a window of replays, from a fresh router's state, under the profiler
    cfg = tsl.scan_config(router, B, churn=churn, fake_cost=0.25, pend_cap=pend_cap,
                          comp_cap=comp_cap)
    run = tsl.runner(cfg, str(dev), T)
    W = SCAN_PROFILE_TURNS
    cols = dict(times=times[:W], costs=costs[:W], speeds=sp[:W])
    if churn:
        cols.update(active=active[:W], rejoin=np.zeros((W, n), bool),
                    burst=np.zeros((W, 0), np.int32))
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        run.load(tr.RosellaRouter(n, float(speeds.sum()), seed=SEED, use_alias=use_alias,
                                  async_mu=False, device=dev), tr.SimulatedPool(speeds))
        prof = device_profile(torch, lambda: run.run_chunk(cols))
        per_turn = {w: c / W for w, c in by_wrapper(prof["count"]).items()}
        if per_turn == {w: float(c) for w, c in per_replay.items()}:
            break
        print(f"[scan {mode}] profiler session {attempt}: {per_turn} a turn, the graph "
              f"holds {per_replay}")
    need(per_turn == {w: float(c) for w, c in per_replay.items()},
         f"[scan {mode}] the profiled replays launched {per_turn} a turn, the graph "
         f"holds {per_replay} ({PROFILE_ATTEMPTS} profiler sessions)")
    # each kernel's device time inside a replay, by name
    in_replay = {w: us / 1e3 / W for w, us in by_wrapper(prof["us"]).items() if us > 0}
    turn_args = real = cause = None
    if mode in REAL_TURN_MODES:
        # which turn raised the run's longest chain, and why
        chains, mus = chain_by_turn(torch, tr, tsl, cfg, speeds, dev, use_alias, cols_all)
        need(int(chains.max()) == info["longest_chain"],
             f"[scan {mode}] turn by turn the longest chain is {int(chains.max())}, the "
             f"run's {info['longest_chain']}")
        cause = chain_cause(chains, mus, speeds, B)
        turn_args, real = {}, {}
        for t in sorted({SCAN_PROFILE_TURNS, cause["turn"]}):
            turn_args[t] = scan_turn_args(torch, tr, tsl, speeds, dev, use_alias, B,
                                          comp_cap, pend_cap, turns=t)
            real[t] = check_real_turn(torch, CK, CR, mode, t, turn_args[t])
            need(real[t]["longest_chain"] == chains[t], f"[scan {mode}] turn {t} recorded "
                 f"alone has a longest chain of {real[t]['longest_chain']}, {chains[t]} "
                 f"in the run")
        print(f"[scan {mode}] longest chain by turn: median {cause['median_chain']}, "
              f"{cause['turns_over_100']} turns over 100, the longest "
              f"{json.dumps(cause['top_turns'])}; turn {cause['turn']} ({cause['chain']} "
              f"steps): replica {cause['replica']} holds {cause['mu_share']:.6f} of the "
              f"μ̂ its dispatch read ({cause['mu_share_before']:.6f} entering the turn), "
              f"{cause['mu_over_speed']:.2f}x its speed, whose share is "
              f"{cause['speed_share']:.6f}; B·share² {cause['both_probes']:.1f}, "
              f"B·(1-(1-share)²) {cause['one_probe']:.1f}")
    run_s = wall - info["capture_s"]
    res = dict(n=n, batch=B, turns=info["turns"], p50=s["p50"], p99=s["p99"],
               host_p50=sh["p50"], host_p99=sh["p99"], rho=rho, wall_s=wall, capture_s=info["capture_s"],
               graph_nodes=info["graph_nodes"], turns_per_s=info["turns"] / run_s,
               decisions_per_s=len(resp) / run_s, host_turns_per_s=host.turns / wall_h,
               host_decisions_per_s=len(resp_h) / wall_h, comp_cap=comp_cap,
               pend_cap=pend_cap, host_max_due=host.max_due,
               host_max_in_flight=host.max_in_flight,
               host_overflow_turns=host.overflow_turns,
               launches_per_turn=prof["launches"] / W, copies_per_turn=prof["copies"] / W,
               kernel_per_turn=per_turn, launches=launches, replays=info["replays"],
               graph_kernels=per_replay, eager_launches=eager,
               idle=prof["idle"], busy_ms_per_turn=prof["busy_us"] / 1e3 / W,
               wall_ms_per_turn=prof["wall"] * 1e3 / W, in_replay_ms=in_replay,
               longest_chain=info["longest_chain"], real_turns=real, chain_cause=cause)
    print(f"[scan {mode}] n={n} batch={B} use_alias={use_alias} churn={churn}: "
          f"{info['turns']} turns, "
          f"p50={s['p50']:.6f} p99={s['p99']:.6f} (host loop {sh['p50']:.6f} / "
          f"{sh['p99']:.6f}), spearman(mu_hat, speeds)={rho:.4f}; "
          f"{res['turns_per_s']:.2f} turns/s, {res['decisions_per_s']:.1f} decisions/s "
          f"(host loop, checked: {res['host_turns_per_s']:.2f} turns/s, "
          f"{res['host_decisions_per_s']:.1f} decisions/s); capture "
          f"{info['capture_s']} s apart from the turns, graph nodes "
          f"{info['graph_nodes']}; comp_cap {comp_cap} pend_cap {pend_cap} (host loop: "
          f"largest flush {host.max_due}, most in flight {host.max_in_flight}, "
          f"overflow_turns {host.overflow_turns}); overflows 0; the longest per-replica "
          f"chain of a turn {info['longest_chain']}")
    print(f"[scan {mode}] {W} replays profiled: {res['launches_per_turn']:.2f} kernel "
          f"launches and {res['copies_per_turn']:.2f} copies per turn, device busy "
          f"{res['busy_ms_per_turn']:.4f} of {res['wall_ms_per_turn']:.4f} ms a turn (idle "
          f"share {prof['idle']:.4f}); per turn by name "
          f"{json.dumps({k: round(v, 3) for k, v in per_turn.items()})}, the graph's kernel "
          f"nodes {json.dumps(per_replay)}; launches of the scan run "
          f"{json.dumps(launches)} (eager warm-up {json.dumps(eager)} + "
          f"{info['replays']} replays x the graph's nodes)")
    print(f"[scan {mode}] device time per replay by kernel (ms, profiler): "
          f"{json.dumps({k: round(v, 6) for k, v in in_replay.items()})}")
    return res, turn_args


def phase_scan(torch, tr, tsl, K, CK, CR, met, speed_set, dev):
    pool_err = phase_pool_chain(torch, CK, CR, dev)
    exact = phase_scan_exact(torch, tr, tsl, speed_set(N_REPLICAS, SEED), dev)
    cells, real_turns = {}, {}
    for m in SCAN_MODES:
        cells[m], args = scan_cell(torch, tr, tsl, K, CK, CR, met, speed_set, dev, m)
        for t, a in (args or {}).items():
            real_turns[(m, t)] = a
            pool_err = max(pool_err, cells[m]["real_turns"][t]["err"])
    alias = ("ppot_dispatch_fused_alias", "alias_table", "pool_chain")
    expect = {"a": alias, "b": ("ppot_dispatch_fused", "pool_chain"),
              "c": ("ppot_dispatch", "pool_chain"), "d": alias, "e": alias}
    for mode, names in expect.items():
        for name in names:
            need(cells[mode]["launches"][name] > 0,
                 f"[scan {mode}] {name} was never launched by the graph's replays")
    return pool_err, exact, cells, real_turns


# ---------------------------------------------------------------------------
# the environment engine: scenarios through both serving loops
# ---------------------------------------------------------------------------


def scenario_router_class(tr):
    """CheckedRouter that also keeps the most work in flight when a turn
    starts: what its pool (``counting_pool``) took less what was flushed."""
    Checked = make_router_class(tr)

    class ScenarioRouter(Checked):
        pool = None
        flushed = most_pending = 0

        def serve_turn(self, now, k, comp_workers=None, comp_times=None, comp_now=None):
            self.most_pending = max(self.most_pending, self.pool.submitted - self.flushed)
            self.flushed += 0 if comp_workers is None else len(comp_workers)
            return super().serve_turn(now, k, comp_workers, comp_times, comp_now)
    return ScenarioRouter


def counting_pool(pool):
    """``pool``, counting the submissions it takes in ``pool.submitted``."""
    submit = pool.submit_batch
    pool.submitted = 0

    def counted(replicas, arrivals, costs):
        pool.submitted += len(replicas)
        return submit(replicas, arrivals, costs)
    pool.submit_batch = counted
    return pool


def scan_launches(K, CK, info) -> dict:
    """A scan run's launches by wrapper: the eager warm-up turns before a
    capture (the wrappers' counts; nothing is counted under capture) and
    each replay's kernel nodes, read from the captured graph, times the
    replays issued."""
    eager = {**K.launch_counts(), **CK.launch_counts()}
    per_replay = by_wrapper(info["graph_kernels"])
    return {w: eager.get(w, 0) + info["replays"] * per_replay[w] for w in PROFILE_NAMES}


def scenario_host(torch, tr, tenv, K, chk, scn, dev, *, use_alias, sequential, wl=None,
                  policy="ppot_sq2"):
    """The host loop over ``scn`` on the card, its kernels held to their
    plain versions every CHECK_EVERY calls: through ``run_scenario`` when
    ``wl`` is None, else ``run_workload`` on ``wl``. Returns the run, its
    wall clock, its launches and the capacities the scan needs (the largest
    flush and the most in flight, x1.25 to a power of two)."""
    speeds0 = np.asarray(scn.speeds, float)
    router = scenario_router_class(tr)(scn.n, float(speeds0.sum()), seed=SEED,
                                        policy=policy, use_alias=use_alias, async_mu=False,
                                        device=dev)
    router.speeds = speeds0
    pool = counting_pool((tr.SequentialPool if sequential else tr.SimulatedPool)(speeds0))
    router.pool = pool
    with chk.checking(CHECK_EVERY):
        K.reset_launches()
        t0 = time.perf_counter()
        if wl is None:
            out = tenv.run_scenario(scn, seed=SEED, arrival_batch=BATCH, use_alias=use_alias,
                                    router=router, pool=pool, device=dev)
        else:
            resp, mu, info = tenv.run_workload(router, pool, wl,
                                               fake_cost=scn.request_cost * 0.25)
            out = dict(responses=resp, mu_trace=mu, info=info, workload=wl, router=router,
                       pool=pool)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = K.launch_counts()
    most = max(router.most_pending, pool.submitted - router.flushed)
    caps = dict(comp_cap=_pow2_at_least(1.25 * max(router.max_due, 1)),
                pend_cap=_pow2_at_least(1.25 * max(most, 1)), max_due=router.max_due,
                most_in_flight=most)
    need(np.isfinite(out["responses"]).all() and (out["responses"] > 0).all(),
         f"[scenario {scn.name}] bad host responses")
    return out, wall, launches, caps


def scenario_exact(torch, tr, tenv, K, CK, chk, scn, dev, use_alias: bool) -> dict:
    """``run_scenario`` on the card, host loop and one-program loop, both on
    a SequentialPool: responses, μ̂ trace and free_at equal bit for bit,
    overflows 0 (``strict_overflow``)."""
    stream = "alias" if use_alias else "icdf"
    h, _, host_launches, caps = scenario_host(torch, tr, tenv, K, chk, scn, dev,
                                              use_alias=use_alias, sequential=True)
    router = tr.RosellaRouter(scn.n, float(np.sum(scn.speeds)), seed=SEED,
                              use_alias=use_alias, async_mu=False, device=dev)
    K.reset_launches()
    CK.reset_launches()
    s = tenv.run_scenario(scn, seed=SEED, arrival_batch=BATCH, use_alias=use_alias,
                          use_scan=True, sequential_pool=True, router=router,
                          pend_cap=caps["pend_cap"], comp_cap=caps["comp_cap"], device=dev)
    torch.cuda.synchronize()
    info = s["info"]
    launches = scan_launches(K, CK, info)
    need(info["replays"] == info["turns"] == s["workload"].turns,
         f"[scenario {scn.name} exact {stream}] the turns were not graph replays ({info})")
    need(info["flush_overflow"] == 0 and info["pend_overflow"] == 0,
         f"[scenario {scn.name} exact {stream}] {info}")
    for part, ok in (("responses", np.array_equal(h["responses"], s["responses"])),
                     ("mu trace", np.array_equal(h["mu_trace"], s["mu_trace"])),
                     ("free_at", np.array_equal(h["pool"].free_at, s["pool"].free_at))):
        need(ok, f"[scenario {scn.name} exact {stream}] the scan's {part} differ from the "
             f"host loop's")
    print(f"[scenario {scn.name}] exact {stream}: run_scenario host loop and one-program "
          f"loop on a SequentialPool, {info['turns']} turns: responses, mu trace and free_at "
          f"equal; overflows 0 at pend_cap {caps['pend_cap']} comp_cap {caps['comp_cap']} "
          f"(host loop: largest flush {caps['max_due']}, most in flight "
          f"{caps['most_in_flight']}); launches host {json.dumps(host_launches)}, scan "
          f"{json.dumps(launches)}")
    return dict(turns=info["turns"], host=host_launches, scan=launches, **caps)


def scenario_cell(torch, tr, tsl, tenv, K, CK, chk, met, scn, dev) -> dict:
    """One scenario on the alias stream: the host loop on a SimulatedPool,
    then the one-program loop on the same workload; p50/p99 within
    SCAN_TOL, μ̂ ranking over the active replicas, adaptation summary."""
    t0 = time.perf_counter()
    wl = scn.compile_serving(seed=SEED, arrival_batch=BATCH)
    compile_s = time.perf_counter() - t0
    h, wall_h, host_launches, caps = scenario_host(torch, tr, tenv, K, chk, scn, dev,
                                                   use_alias=True, sequential=False, wl=wl)
    speeds0 = np.asarray(scn.speeds, float)
    router = tr.RosellaRouter(scn.n, float(speeds0.sum()), seed=SEED, use_alias=True,
                              async_mu=False, device=dev)
    K.reset_launches()
    CK.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resp, mu_trace, info = tsl.run_workload_scan(
        router, tr.SimulatedPool(speeds0), wl.times, wl.costs, wl.speeds,
        active_np=wl.active, rejoin_np=wl.rejoin, burst_np=wl.burst,
        fake_cost=scn.request_cost * 0.25, pend_cap=caps["pend_cap"],
        comp_cap=caps["comp_cap"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = scan_launches(K, CK, info)
    T = wl.turns
    need(info["replays"] == info["turns"] == T and info["graph_nodes"] is not None,
         f"[scenario {scn.name}] the turns were not graph replays ({info})")
    need(info["flush_overflow"] == 0 and info["pend_overflow"] == 0,
         f"[scenario {scn.name}] {info}")
    need(np.isfinite(resp).all() and (resp > 0).all() and resp.shape == (T * BATCH,)
         and mu_trace.shape == (T, scn.n), f"[scenario {scn.name}] bad responses or trace")
    for name in ("ppot_dispatch_fused_alias", "alias_table"):
        need(host_launches[name] > 0, f"[scenario {scn.name}] the host loop never "
             f"launched {name}")
    for name in ("ppot_dispatch_fused_alias", "alias_table", "pool_chain"):
        need(launches[name] > 0, f"[scenario {scn.name}] the scan never launched {name}")
    s, sh = met.serve_summary(resp), met.serve_summary(h["responses"])
    for q in ("p50", "p99"):
        need(abs(s[q] - sh[q]) <= SCAN_TOL * sh[q], f"[scenario {scn.name}] {q} "
             f"{s[q]:.6f} is not within {SCAN_TOL} of the host loop's {sh[q]:.6f}")
    live = np.ones(scn.n, bool) if wl.active is None else wl.active[-1]
    rho = spearman(router.mu_hat[live], wl.speeds[-1][live])
    rho_h = spearman(h["router"].mu_hat[live], wl.speeds[-1][live])
    if scn.name in SCENARIO_MIN_RHO:
        need(min(rho, rho_h) >= SCENARIO_MIN_RHO[scn.name], f"[scenario {scn.name}] μ̂ "
             f"ranks the replicas poorly (Spearman {rho:.4f}, host loop {rho_h:.4f})")
    # the first CELL_PROFILE_TURNS replays again, from a fresh router's
    # state, under the profiler: device busy time and idle share a turn
    churn = wl.active is not None
    cfg = tsl.scan_config(router, BATCH, churn=churn,
                          burst_cap=wl.burst.shape[1] if churn else 0,
                          fake_cost=scn.request_cost * 0.25, pend_cap=caps["pend_cap"],
                          comp_cap=caps["comp_cap"])
    run = tsl.runner(cfg, str(dev), T)
    run.load(tr.RosellaRouter(scn.n, float(speeds0.sum()), seed=SEED, use_alias=True,
                              async_mu=False, device=dev), tr.SimulatedPool(speeds0))
    W = CELL_PROFILE_TURNS
    cols = dict(times=wl.times[:W], costs=wl.costs[:W], speeds=wl.speeds[:W])
    if churn:
        cols.update(active=wl.active[:W], rejoin=wl.rejoin[:W], burst=wl.burst[:W])
    prof = device_profile(torch, lambda: run.run_chunk(cols))
    adapt = met.adaptation_report(wl.times[:, -1], mu_trace, wl.speeds, wl.shift_times,
                                  active=wl.active)
    adapt_h = met.adaptation_report(wl.times[:, -1], h["mu_trace"], wl.speeds,
                                    wl.shift_times, active=wl.active)
    run_s = wall - info["capture_s"]
    res = dict(turns=T, requests=int(resp.size), trace_dropped=int(wl.trace_dropped),
               compile_s=compile_s, turns_per_s=T / run_s, decisions_per_s=resp.size / run_s,
               host_turns_per_s=T / wall_h, host_decisions_per_s=resp.size / wall_h,
               capture_s=info["capture_s"], graph_nodes=info["graph_nodes"],
               launches_per_replay=sum(info["graph_kernels"].values()),
               busy_ms_per_turn=prof["busy_us"] / 1e3 / W, idle=prof["idle"], p50=s["p50"],
               p99=s["p99"], host_p50=sh["p50"], host_p99=sh["p99"], rho=rho, rho_host=rho_h,
               active_final=int(live.sum()), longest_chain=info["longest_chain"],
               adaptation={k: adapt[k] for k in ("n_shifts", "n_unadapted", "mean", "max")},
               adaptation_host={k: adapt_h[k] for k in ("n_shifts", "n_unadapted", "mean",
                                                        "max")},
               host_launches=host_launches, launches=launches, **caps)
    fixed = SCENARIO_FIXED_REPLICAS.get(scn.name)
    print(f"[scenario {scn.name}] n={scn.n} batch={BATCH} alias"
          + (f" (moves {fixed} of {scn.n})" if fixed else "")
          + f": {T} turns, {resp.size} requests"
          + (f", trace_dropped {wl.trace_dropped}" if wl.trace_dropped else "")
          + f" (compiled in {compile_s:.3f} s); scan {res['turns_per_s']:.2f} turns/s "
          f"{res['decisions_per_s']:.1f} decisions/s, host loop (checked) "
          f"{res['host_turns_per_s']:.2f} turns/s {res['host_decisions_per_s']:.1f} "
          f"decisions/s; capture_s {info['capture_s']}, graph nodes {info['graph_nodes']}, "
          f"launches per replay {res['launches_per_replay']}, {W} replays profiled: busy "
          f"{res['busy_ms_per_turn']:.4f} ms a turn, idle share {prof['idle']:.4f}; p50 "
          f"{s['p50']:.6f} p99 "
          f"{s['p99']:.6f} (host loop {sh['p50']:.6f} / {sh['p99']:.6f}); "
          f"spearman(mu_hat, speeds) over the {res['active_final']} active replicas "
          f"{rho:.4f} (host loop {rho_h:.4f}); adaptation n_shifts {adapt['n_shifts']} "
          f"n_unadapted {adapt['n_unadapted']} mean {adapt['mean']:.3f} s max "
          f"{adapt['max']:.3f} s (host loop {adapt_h['n_unadapted']} / "
          f"{adapt_h['mean']:.3f} / {adapt_h['max']:.3f}); pend_cap {caps['pend_cap']} "
          f"comp_cap {caps['comp_cap']} (host loop: largest flush {caps['max_due']}, most "
          f"in flight {caps['most_in_flight']}); longest chain {info['longest_chain']}")
    return res


def phase_scenarios(torch, tr, tsl, tenv, K, CK, chk, met, speeds, dev, card):
    """Every fault-free scenario of the registry at the scheduler cell
    through both serving loops on the card; returns the records and the
    phase's launches by wrapper."""
    t0 = time.perf_counter()
    rate = LOAD * float(speeds.sum())
    print(f"[scenarios] {card}; n={N_REPLICAS} (tpch_speed_set, sum {speeds.sum():.2f}), "
          f"rate {rate:.3f}/s, batches of {BATCH}, async_mu=False, seed {SEED}; "
          f"{SCENARIO_HORIZON} s of each scenario's clock")
    cells, exact = {}, {}
    total = {w: 0 for w in PROFILE_NAMES}
    for name in SCENARIOS:
        scn = tenv.make(name, speeds=tuple(speeds), rate=rate, horizon=SCENARIO_HORIZON)
        cells[name] = scenario_cell(torch, tr, tsl, tenv, K, CK, chk, met, scn, dev)
        runs = [cells[name]]
        for use_alias in (True, False):
            if name in (SCENARIO_EXACT if use_alias else SCENARIO_CDF):
                rec = scenario_exact(torch, tr, tenv, K, CK, chk, scn, dev, use_alias)
                exact[f"{name} {'alias' if use_alias else 'icdf'}"] = rec
                runs.append(dict(host_launches=rec["host"], launches=rec["scan"]))
        for r in runs:
            for w in PROFILE_NAMES:
                total[w] += r["host_launches"].get(w, 0) + r["launches"][w]
    for key, names in (("flash_crowd icdf", ("ppot_dispatch_fused",)),
                       ("churn_heavy icdf", ("ppot_dispatch",))):
        for w in names:
            need(exact[key]["host"][w] > 0 and exact[key]["scan"][w] > 0,
                 f"[scenario {key}] {w} was not launched by both loops")
    for w in PATH_WRAPPERS:
        need(total[w] > 0, f"[scenarios] {w} was never launched")
    secs = time.perf_counter() - t0
    print(f"[scenarios] {len(cells)} scenarios, {len(exact)} exact pairs in {secs:.1f} s; "
          f"launches {json.dumps(total)}")
    return dict(cells=cells, exact=exact, seconds=secs), total


# ---------------------------------------------------------------------------
# failure semantics: the host recovery loop and the faulty one-program loop
# ---------------------------------------------------------------------------


def fault_host(torch, tenv, K, chk, scn, dev, router, recovery):
    """``run_scenario``'s host recovery loop over ``scn`` on the card, its
    kernels held to their plain versions every CHECK_EVERY calls. Returns
    the run, its wall clock and its launches by wrapper."""
    with chk.checking(CHECK_EVERY):
        K.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = tenv.run_scenario(scn, seed=SEED, arrival_batch=BATCH, sequential_pool=True,
                                router=router, recovery=recovery, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = K.launch_counts()
    return out, wall, launches


def fault_cell(torch, tr, tsl, tenv, K, CK, chk, met, scn, dev, use_alias: bool,
               recovery, inert) -> dict:
    """One fault scenario with recovery armed: the host recovery loop, then
    the faulty one-program loop with capacities from the host loop's peak
    pending set and largest clean flush (x1.25 to a power of two); equal bit
    for bit, conserved, overflows 0; CELL_PROFILE_TURNS replays profiled. Then the scan
    under the ``inert`` config (the faults alone, nothing recovered) for
    the same fault report without recovery."""
    stream = "alias" if use_alias else "icdf"
    tag = f"[faults {scn.name} {stream}]"

    def router():
        return tr.RosellaRouter(scn.n, float(np.sum(scn.speeds)), seed=SEED,
                                use_alias=use_alias, async_mu=False, device=dev)

    h, wall_h, host_launches = fault_host(torch, tenv, K, chk, scn, dev, router(), recovery)
    hi = h["info"]
    caps = dict(pend_cap=_pow2_at_least(1.25 * max(hi["most_in_flight"], 1)),
                comp_cap=_pow2_at_least(1.25 * max(hi["largest_flush"], 1)),
                most_in_flight=hi["most_in_flight"], largest_flush=hi["largest_flush"])
    K.reset_launches()
    CK.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = tenv.run_scenario(scn, seed=SEED, arrival_batch=BATCH, use_scan=True,
                          sequential_pool=True, router=router(), recovery=recovery,
                          pend_cap=caps["pend_cap"], comp_cap=caps["comp_cap"], device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    info, wl = s["info"], s["workload"]
    launches = scan_launches(K, CK, info)
    T = wl.turns
    need(info["replays"] == info["turns"] == T and info["graph_nodes"] is not None,
         f"{tag} the turns were not graph replays ({info})")
    need(info["flush_overflow"] == 0 and info["pend_overflow"] == 0, f"{tag} {info}")
    for part, ok in (
            ("responses", np.array_equal(h["responses"], s["responses"], equal_nan=True)),
            ("mu trace", np.array_equal(h["mu_trace"], s["mu_trace"])),
            ("free_at", np.array_equal(h["pool"].free_at, s["pool"].free_at)),
            ("ledger", hi["ledger"] == info["ledger"])):
        need(ok, f"{tag} the scan's {part} differ from the host recovery loop's")
    led = info["ledger"]
    ok, residuals = met.check_conservation(led)
    need(ok and led["conserved"], f"{tag} the ledger does not conserve: {residuals}")
    resp = s["responses"]
    need(resp.shape == (T * BATCH,) and s["mu_trace"].shape == (T, scn.n)
         and (resp[np.isfinite(resp)] > 0).all()
         and np.isfinite(resp).sum() == led["completed_tasks"],
         f"{tag} bad responses or trace")
    need(led["n_retries"] > 0 and led["n_spec"] > 0 and led["n_timeouts"] > 0,
         f"{tag} recovery never acted: {led}")
    rep = met.fault_report(resp, led, horizon=FAULT_HORIZON)
    # the first SCAN_PROFILE_TURNS turns again from a fresh router's state,
    # under the profiler: device busy time and idle share a replay
    cfg = tsl.scan_config(router(), BATCH, churn=wl.active is not None,
                          burst_cap=wl.burst.shape[1] if wl.active is not None else 0,
                          fake_cost=scn.request_cost * 0.25, pend_cap=caps["pend_cap"],
                          comp_cap=caps["comp_cap"], recovery=recovery, task_cap=T * BATCH)
    run = tsl.runner(cfg, str(dev), T)
    need(run.replays > 0, f"{tag} the profiled runner is not the run's")
    run.load(router(), tr.SequentialPool(np.asarray(scn.speeds, float)))
    W = CELL_PROFILE_TURNS
    cols = dict(times=wl.times[:W], costs=wl.costs[:W], speeds=wl.speeds[:W],
                kill=wl.kill_at[:W] if wl.kill_at is not None else np.full((W, scn.n), np.inf),
                stall=(wl.stall_at[:W] if wl.stall_at is not None
                       else np.full((W, scn.n), np.inf)),
                stall_dur=wl.stall_dur[:W] if wl.stall_dur is not None else np.zeros((W, scn.n)))
    if wl.active is not None:
        cols.update(active=wl.active[:W], rejoin=wl.rejoin[:W], burst=wl.burst[:W])
    prof = device_profile(torch, lambda: run.run_chunk(cols))
    in_replay = {w: 0.0 for w in PROFILE_NAMES}
    for name, us in prof["us"].items():
        if wrapper_of(name) is not None:
            in_replay[wrapper_of(name)] += us / 1e3 / W
    run_s = wall - info["capture_s"]
    K.reset_launches()
    CK.reset_launches()
    bare = tenv.run_scenario(scn, seed=SEED, arrival_batch=BATCH, use_scan=True,
                             sequential_pool=True, router=router(), recovery=inert,
                             pend_cap=BARE_PEND_CAP, comp_cap=BARE_COMP_CAP, device=dev)
    bare_launches = scan_launches(K, CK, bare["info"])
    need(met.check_conservation(bare["info"]["ledger"])[0], f"{tag} the bare run's ledger "
         f"does not conserve")
    rep_bare = met.fault_report(bare["responses"], bare["info"]["ledger"],
                                horizon=FAULT_HORIZON)
    res = dict(turns=T, requests=int(resp.size), turns_per_s=T / run_s,
               host_turns_per_s=T / wall_h, capture_s=info["capture_s"],
               graph_nodes=info["graph_nodes"],
               launches_per_replay=sum(info["graph_kernels"].values()),
               busy_ms_per_turn=prof["busy_us"] / 1e3 / W, idle=prof["idle"],
               in_replay_ms=in_replay, longest_chain=info["longest_chain"],
               report={k: rep[k] for k in ("completed", "lost", "loss_rate", "timeouts",
                                           "retries", "speculative", "killed_copies",
                                           "retry_amplification", "p50", "p99", "p999",
                                           "goodput", "throughput")},
               ledger=led, host_launches=host_launches, launches=launches,
               bare={k: rep_bare[k] for k in ("completed", "lost", "loss_rate",
                                              "killed_copies", "p50", "p99", "p999",
                                              "goodput")},
               bare_launches=bare_launches, **caps)
    print(f"{tag} n={scn.n} batch={BATCH}: {T} turns, {resp.size} tasks; host recovery loop "
          f"and faulty one-program loop on a SequentialPool equal (responses with NaN, mu "
          f"trace, free_at, ledger), conserved, overflows 0; completed {rep['completed']} "
          f"lost {rep['lost']} loss rate {rep['loss_rate']:.6f}, timeouts {rep['timeouts']} "
          f"retries {rep['retries']} speculative {rep['speculative']} killed copies "
          f"{rep['killed_copies']} stalled {led['n_stalled']}, retry amplification "
          f"{rep['retry_amplification']:.6f}; p50 {rep['p50']:.6f} p99 {rep['p99']:.6f} p999 "
          f"{rep['p999']:.6f} s, goodput {rep['goodput']:.3f}/s; scan {res['turns_per_s']:.2f} "
          f"turns/s, host loop (checked) {res['host_turns_per_s']:.2f} turns/s; capture_s "
          f"{info['capture_s']:.3f}, graph nodes {info['graph_nodes']}, launches per replay "
          f"{res['launches_per_replay']}, {W} replays profiled: busy "
          f"{res['busy_ms_per_turn']:.4f} ms a turn, idle share {prof['idle']:.4f}, device ms "
          f"a replay by kernel "
          + ", ".join(f"{w} {v:.6f}" for w, v in in_replay.items() if v)
          + f"; pend_cap "
          f"{caps['pend_cap']} comp_cap {caps['comp_cap']} (host loop: most in flight "
          f"{caps['most_in_flight']}, largest clean flush {caps['largest_flush']}); longest "
          f"chain {info['longest_chain']}; launches host {json.dumps(host_launches)}, scan "
          f"{json.dumps(launches)}")
    print(f"{tag} without recovery (the faults alone, scan): completed {rep_bare['completed']} "
          f"lost {rep_bare['lost']} loss rate {rep_bare['loss_rate']:.6f}, killed copies "
          f"{rep_bare['killed_copies']}; p50 {rep_bare['p50']:.6f} p99 {rep_bare['p99']:.6f} "
          f"p999 {rep_bare['p999']:.6f} s, goodput {rep_bare['goodput']:.3f}/s")
    return res


def fault_inert(torch, tr, tenv, K, CK, scn, dev, recovery) -> dict:
    """The null scenario through the plain turn and through the faulty turn
    with the inert config: responses, μ̂ trace and free_at equal bit for
    bit; nothing lost."""
    out = {}
    for label, rc in (("plain", None), ("inert", recovery)):
        router = tr.RosellaRouter(scn.n, float(np.sum(scn.speeds)), seed=SEED, use_alias=True,
                                  async_mu=False, device=dev)
        K.reset_launches()
        CK.reset_launches()
        t0 = time.perf_counter()
        out[label] = tenv.run_scenario(scn, seed=SEED, arrival_batch=BATCH, use_scan=True,
                                       sequential_pool=True, router=router, recovery=rc,
                                       device=dev)
        torch.cuda.synchronize()
        out[label]["wall"] = time.perf_counter() - t0
        out[label]["launches"] = scan_launches(K, CK, out[label]["info"])
    a, b = out["plain"], out["inert"]
    for part, ok in (("responses", np.array_equal(a["responses"], b["responses"])),
                     ("mu trace", np.array_equal(a["mu_trace"], b["mu_trace"])),
                     ("free_at", np.array_equal(a["pool"].free_at, b["pool"].free_at))):
        need(ok, f"[faults null inert] the faulty turn's {part} differ from the plain turn's")
    led = b["info"]["ledger"]
    need(led["lost_tasks"] == 0 and led["conserved"], f"[faults null inert] {led}")
    res = {label: dict(turns=r["info"]["turns"], graph_nodes=r["info"]["graph_nodes"],
                       launches_per_replay=sum(r["info"]["graph_kernels"].values()),
                       turns_per_s=r["info"]["turns"] / (r["wall"] - r["info"]["capture_s"]),
                       launches=r["launches"])
           for label, r in out.items()}
    print(f"[faults null inert] n={scn.n}: the faulty turn with INERT_RECOVERY equals the plain "
          f"turn bit for bit over {res['plain']['turns']} turns (responses, mu trace, "
          f"free_at), nothing lost; graph nodes {res['plain']['graph_nodes']} plain / "
          f"{res['inert']['graph_nodes']} inert, launches per replay "
          f"{res['plain']['launches_per_replay']} / {res['inert']['launches_per_replay']}, "
          f"{res['plain']['turns_per_s']:.2f} / {res['inert']['turns_per_s']:.2f} turns/s")
    return res


def phase_faults(torch, tr, tsl, tenv, trcv, K, CK, chk, met, speeds, dev, card):
    """The fault scenarios at the scheduler cell through both serving loops
    with recovery armed, and the inert config against the plain turn;
    returns the records and the phase's launches by wrapper."""
    t0 = time.perf_counter()
    rate = LOAD * float(speeds.sum())
    recovery = trcv.RecoveryConfig(**FAULT_RECOVERY)
    print(f"[faults] {card}; n={N_REPLICAS} (tpch_speed_set, sum {speeds.sum():.2f}), rate "
          f"{rate:.3f}/s, batches of {BATCH}, async_mu=False, seed {SEED}, horizon "
          f"{FAULT_HORIZON} s; recovery {json.dumps(FAULT_RECOVERY)}")
    cells, total = {}, {w: 0 for w in PROFILE_NAMES}
    for name in FAULT_SCENARIOS:
        scn = tenv.make(name, speeds=tuple(speeds), rate=rate, horizon=FAULT_HORIZON)
        for use_alias in (True, False):
            if use_alias or name in FAULT_CDF:
                key = f"{name} {'alias' if use_alias else 'icdf'}"
                cells[key] = fault_cell(torch, tr, tsl, tenv, K, CK, chk, met, scn, dev,
                                        use_alias, recovery, trcv.INERT_RECOVERY)
    scn = tenv.make("null", speeds=tuple(speeds), rate=rate, horizon=FAULT_HORIZON)
    inert = fault_inert(torch, tr, tenv, K, CK, scn, dev, trcv.INERT_RECOVERY)
    for rec in cells.values():
        for w in PROFILE_NAMES:
            total[w] += (rec["host_launches"].get(w, 0) + rec["launches"][w]
                         + rec["bare_launches"][w])
    for rec in inert.values():
        for w in PROFILE_NAMES:
            total[w] += rec["launches"][w]
    for key, names in (("crash_storm alias", ("ppot_dispatch_fused_alias", "alias_table")),
                       ("crash_storm icdf", ("ppot_dispatch",))):
        for w in names:
            need(cells[key]["host_launches"][w] > 0 and cells[key]["launches"][w] > 0,
                 f"[faults {key}] {w} was not launched by both loops")
    for key, rec in cells.items():
        need(rec["launches"]["pool_chain"] > 0, f"[faults {key}] the scan never launched "
             f"pool_chain")
    secs = time.perf_counter() - t0
    print(f"[faults] {len(cells)} fault cells and the inert pair in {secs:.1f} s; launches "
          f"{json.dumps(total)}")
    return dict(cells=cells, inert=inert, seconds=secs), total


# ---------------------------------------------------------------------------
# telemetry: the window fold and the regime detector inside both loops
# ---------------------------------------------------------------------------


def obs_records_equal(tag, wa, wb) -> None:
    """Two window streams equal in every key, NaN = NaN."""
    need(len(wa) == len(wb), f"{tag} {len(wa)} windows against {len(wb)}")
    for a, b in zip(wa, wb):
        need(set(a) == set(b), f"{tag} window {a.get('window')}: keys differ")
        for k in a:
            va, vb = a[k], b[k]
            if isinstance(va, float) and isinstance(vb, float) and va != va and vb != vb:
                continue
            need(va == vb, f"{tag} window {a['window']}: {k} {va!r} against {vb!r}")


def obs_mode_run(torch, tr, tsl, tenv, K, CK, scn, wl, dev, rc, caps, ocfg, mode) -> dict:
    """One telemetry mode of one [obs] cell: the host loop (unchecked: its
    turns/s) and the one-program loop on the same workload, then
    CELL_PROFILE_TURNS replays of the mode's graph under the profiler."""
    from repro_torch import obs

    speeds0 = np.asarray(scn.speeds, float)

    def router():
        return tr.RosellaRouter(scn.n, float(speeds0.sum()), seed=SEED, use_alias=True,
                                async_mu=False, device=dev)

    fake = scn.request_cost * 0.25
    K.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hr = router()
    h = tenv.run_workload(hr, tr.SequentialPool(speeds0), wl, fake_cost=fake, recovery=rc,
                          observe=ocfg)
    torch.cuda.synchronize()
    wall_h = time.perf_counter() - t0
    host_launches = K.launch_counts()
    faulty = rc is not None
    cols = dict(active_np=wl.active, rejoin_np=wl.rejoin, burst_np=wl.burst, fake_cost=fake,
                pend_cap=caps["pend_cap"], comp_cap=caps["comp_cap"], observe=ocfg)
    if faulty:
        cols.update(kill_np=wl.kill_at, stall_np=wl.stall_at, stall_dur_np=wl.stall_dur,
                    recovery=rc)
    K.reset_launches()
    CK.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pool = tr.SequentialPool(speeds0)
    resp, mu, info = tsl.run_workload_scan(router(), pool, wl.times, wl.costs, wl.speeds,
                                           **cols)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = scan_launches(K, CK, info)
    T = wl.turns
    need(info["replays"] == info["turns"] == T, f"[obs {scn.name} {mode}] the turns were not "
         f"graph replays ({info})")
    need(info["flush_overflow"] == 0 and info["pend_overflow"] == 0,
         f"[obs {scn.name} {mode}] {info}")
    cfg = tsl.scan_config(router(), BATCH, churn=wl.active is not None,
                          burst_cap=wl.burst.shape[1] if wl.active is not None else 0,
                          fake_cost=fake, pend_cap=caps["pend_cap"], comp_cap=caps["comp_cap"],
                          recovery=rc, task_cap=T * BATCH if faulty else 0, observe=ocfg)
    run = tsl.runner(cfg, str(dev), T)
    need(run.replays > 0, f"[obs {scn.name} {mode}] the profiled runner is not the run's")
    run.load(router(), tr.SequentialPool(speeds0))
    W = CELL_PROFILE_TURNS
    xs = dict(times=wl.times[:W], costs=wl.costs[:W], speeds=wl.speeds[:W])
    if wl.active is not None:
        xs.update(active=wl.active[:W], rejoin=wl.rejoin[:W], burst=wl.burst[:W])
    if faulty:
        n = scn.n
        xs.update(kill=wl.kill_at[:W] if wl.kill_at is not None else np.full((W, n), np.inf),
                  stall=wl.stall_at[:W] if wl.stall_at is not None else np.full((W, n), np.inf),
                  stall_dur=(wl.stall_dur[:W] if wl.stall_dur is not None
                             else np.zeros((W, n))))
    prof = device_profile(torch, lambda: run.run_chunk(xs))
    wins = info.get("windows", [])
    return dict(host=h, scan=(resp, mu, info), pool=pool, host_launches=host_launches,
                launches=launches, rec=dict(
                    graph_nodes=info["graph_nodes"],
                    launches_per_replay=sum(info["graph_kernels"].values()),
                    turns_per_s=T / (wall - info["capture_s"]), host_turns_per_s=T / wall_h,
                    busy_ms_per_turn=prof["busy_us"] / 1e3 / W, idle=prof["idle"],
                    windows=len(wins), detections=len(obs.detections_from_records(wins)),
                    capture_s=info["capture_s"]))


def obs_cell(torch, tr, tsl, tenv, K, CK, scn, dev, rc, caps) -> dict:
    """One [obs] cell: the four modes through both loops, and the checks."""
    from repro_torch import obs

    tag = f"[obs {scn.name}]"
    wl = scn.compile_serving(seed=SEED, arrival_batch=BATCH)
    modes = {"off": None, "windows": obs.ObserveConfig(window_turns=OBS_WINDOW),
             "stream-only": obs.ObserveConfig(window_turns=OBS_WINDOW, emit_responses=False),
             "windows + detect": obs.ObserveConfig(window_turns=OBS_WINDOW,
                                                   detect=obs.DetectConfig())}
    runs = {m: obs_mode_run(torch, tr, tsl, tenv, K, CK, scn, wl, dev, rc, caps, o, m)
            for m, o in modes.items()}
    off = runs["off"]
    need(off["rec"]["graph_nodes"] == OBS_NODES_BEFORE[scn.name],
         f"{tag} observe=None captured {off['rec']['graph_nodes']} nodes, not the "
         f"{OBS_NODES_BEFORE[scn.name]} of the turn before the telemetry fold")
    for m in ("windows", "windows + detect"):
        r = runs[m]
        for loop, a, b in (("host", r["host"], off["host"]), ("scan", r["scan"], off["scan"])):
            need(np.array_equal(a[0], b[0], equal_nan=True) and np.array_equal(a[1], b[1])
                 and a[2].get("ledger") == b[2].get("ledger"),
                 f"{tag} {m}: the {loop} loop's responses, mu trace or ledger moved")
        need(np.array_equal(r["pool"].free_at, off["pool"].free_at),
             f"{tag} {m}: the replica clocks moved")
        obs_records_equal(f"{tag} {m} host = scan", r["host"][2]["windows"],
                          r["scan"][2]["windows"])
        for name in ("ppot_dispatch_fused_alias", "alias_table"):
            need(r["host_launches"][name] > 0 and r["launches"][name] > 0,
                 f"{tag} {m}: {name} was not launched by both loops")
        need(r["launches"]["pool_chain"] > 0, f"{tag} {m}: the scan never launched pool_chain")
    det = runs["windows + detect"]
    wins = det["scan"][2]["windows"]
    need(len(wins) == -(-wl.turns // OBS_WINDOW), f"{tag} {len(wins)} windows for "
         f"{wl.turns} turns")
    # chunks, and stream-only through a JsonlSink
    speeds0 = np.asarray(scn.speeds, float)
    chunked = tenv.run_scenario(scn, seed=SEED, arrival_batch=BATCH, use_scan=True,
                                sequential_pool=True, recovery=rc, observe=modes["windows + detect"],
                                chunk_turns=OBS_CHUNK, pend_cap=caps["pend_cap"],
                                comp_cap=caps["comp_cap"], device=dev)
    obs_records_equal(f"{tag} chunks of {OBS_CHUNK}", chunked["info"]["windows"], wins)
    so = runs["stream-only"]
    obs_records_equal(f"{tag} stream-only", so["scan"][2]["windows"],
                      runs["windows"]["scan"][2]["windows"])
    need(so["scan"][1].shape == (0, scn.n) and (rc is not None or so["scan"][0].size == 0),
         f"{tag} stream-only returned response or mu rows")
    path = ROOT / "build" / f"obs_{scn.name}.jsonl"
    path.unlink(missing_ok=True)
    with obs.JsonlSink(str(path)) as sink:
        streamed = tenv.run_scenario(scn, seed=SEED, arrival_batch=BATCH, use_scan=True,
                                     sequential_pool=True, recovery=rc, observe=modes["stream-only"],
                                     chunk_turns=OBS_CHUNK, obs_sink=sink,
                                     pend_cap=caps["pend_cap"], comp_cap=caps["comp_cap"],
                                     device=dev)
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    path.unlink()
    need(len(lines) == len(streamed["info"]["windows"]) == len(wins)
         and [r["turn"] for r in lines] == [r["turn"] for r in wins],
         f"{tag} the JsonlSink got {len(lines)} lines for {len(wins)} windows")
    ledger = None
    if rc is not None:
        ledger = det["scan"][2]["ledger"]
        killed = sum(r["killed"] for r in wins)
        comp = sum(r["completed"] + r["dirty"] for r in wins)
        need(killed == ledger["copies_real_killed"] and 0 < comp
             <= ledger["copies_real_completed"], f"{tag} windows killed {killed}, completed "
             f"{comp} against the ledger {ledger}")
    recs = {m: r["rec"] for m, r in runs.items()}
    for m, r in recs.items():
        print(f"{tag} {m}: graph nodes {r['graph_nodes']}, kernels a replay "
              f"{r['launches_per_replay']}; scan {r['turns_per_s']:.2f} turns/s (host clock, "
              f"capture {r['capture_s']:.3f} s apart), {CELL_PROFILE_TURNS} replays "
              f"profiled: busy "
              f"{r['busy_ms_per_turn']:.4f} ms a replay, idle {r['idle']:.4f}; host loop "
              f"{r['host_turns_per_s']:.2f} turns/s; {r['windows']} windows, "
              f"{r['detections']} detections")
    dets = obs.detections_from_records(wins)
    print(f"{tag} n={scn.n} batch={BATCH}: {wl.turns} turns, {len(wins)} windows of "
          f"{OBS_WINDOW} turns; off = on (responses, mu trace, free_at"
          + (", ledger" if rc is not None else "") + ") on both loops, host = scan in every "
          f"key, chunks of {OBS_CHUNK} and stream-only (JsonlSink, {len(lines)} lines) equal"
          + (f", windows killed {sum(r['killed'] for r in wins)} = ledger, completed + dirty "
             f"{sum(r['completed'] + r['dirty'] for r in wins)} <= "
             f"{ledger['copies_real_completed']}" if ledger else "")
          + f"; detections {[(round(d['t'], 3), d['label']) for d in dets]}; p99 of the last "
          f"window {wins[-1]['p99']:.6f} s")
    total = {w: 0 for w in PROFILE_NAMES}
    for r in runs.values():
        for w in PROFILE_NAMES:
            total[w] += r["host_launches"].get(w, 0) + r["launches"][w]
    return dict(modes=recs, detections=[(d["t"], d["label"]) for d in dets]), total


def obs_pins(torch, tenv, dev) -> dict:
    """The reference's detection pins (tests/test_detect.py) on the card's
    scan at the scenario's own size: null never fires; churn's lost worker
    (t = 120) reads as a membership_shift within 15 s and the report joins
    it with no false alarm."""
    from repro_torch import obs

    out = {}
    for name, warm, wturns in (("null", 8, 2), ("churn", 12, 2)):
        scn = tenv.make(name, horizon=360.0)
        ocfg = obs.ObserveConfig(window_turns=wturns,
                                 detect=obs.DetectConfig(warmup_windows=warm))
        run = tenv.run_scenario(scn, use_scan=True, sequential_pool=True,
                                arrival_batch=OBS_PIN_BATCH, seed=SEED, observe=ocfg, device=dev)
        need(run["info"]["replays"] == run["info"]["turns"], f"[obs pin {name}] not replays")
        recs = run["info"]["windows"]
        dets = obs.detections_from_records(recs)
        rep = obs.detection_report(recs, shift_events=scn.shift_events(SEED),
                                   drifting=scn.drifting)
        if name == "null":
            need(not dets and recs[-1]["det_count"] == 0, f"[obs pin null] alarms {dets}")
        else:
            memb = [d["t"] for d in dets if d["label"] == "membership_shift" and d["t"] >= 120.0]
            need(memb and 120.0 <= min(memb) <= 135.0, f"[obs pin churn] detections {dets}")
            need(rep["false_alarms"] == 0 and rep["per_shift"]["120.000"]["kind_match"],
                 f"[obs pin churn] {rep}")
        out[name] = dict(windows=len(recs), detections=[(d["t"], d["label"]) for d in dets],
                         false_alarms=rep["false_alarms"])
        print(f"[obs pin {name}] n={scn.n} batch={OBS_PIN_BATCH}, {run['info']['turns']} "
              f"turns, windows of {wturns} turns, warm-up {warm} windows: {len(recs)} windows, "
              f"detections {[(round(t, 3), lb) for t, lb in out[name]['detections']]}, false "
              f"alarms {rep['false_alarms']}")
    return out


def phase_obs(torch, tr, tsl, tenv, trcv, K, CK, speeds, dev, card, scenarios, faults):
    """The [obs] cells and pins; returns the records and the phase's launches
    by wrapper."""
    t0 = time.perf_counter()
    rate = LOAD * float(speeds.sum())
    print(f"[obs] {card}; n={N_REPLICAS} (tpch_speed_set, sum {speeds.sum():.2f}), rate "
          f"{rate:.3f}/s, batches of {BATCH}, alias, async_mu=False, seed {SEED}, windows of "
          f"{OBS_WINDOW} turns, SequentialPool; churn over {OBS_HORIZON['churn']} s, "
          f"crash_storm over {OBS_HORIZON['crash_storm']} s with recovery "
          f"{json.dumps(FAULT_RECOVERY)}")
    cells, total = {}, {w: 0 for w in PROFILE_NAMES}
    for name, rc, src in (("churn", None, scenarios["cells"]["churn"]),
                          ("crash_storm", trcv.RecoveryConfig(**FAULT_RECOVERY),
                           faults["cells"]["crash_storm alias"])):
        scn = tenv.make(name, speeds=tuple(speeds), rate=rate, horizon=OBS_HORIZON[name])
        caps = dict(pend_cap=src["pend_cap"], comp_cap=src["comp_cap"])
        need(src["graph_nodes"] == OBS_NODES_BEFORE[name], f"[obs {name}] the "
             f"{'[faults]' if rc else '[scenario]'} cell captured {src['graph_nodes']} nodes, "
             f"not the {OBS_NODES_BEFORE[name]} of the turn before the telemetry fold")
        cells[name], launches = obs_cell(torch, tr, tsl, tenv, K, CK, scn, dev, rc, caps)
        for w in PROFILE_NAMES:
            total[w] += launches[w]
    pins = obs_pins(torch, tenv, dev)
    for w in ("ppot_dispatch_fused_alias", "alias_table", "pool_chain"):
        need(total[w] > 0, f"[obs] {w} was never launched")
    secs = time.perf_counter() - t0
    print(f"[obs] 2 cells x 4 modes and 2 pins in {secs:.1f} s; launches {json.dumps(total)}")
    return dict(cells=cells, pins=pins, seconds=secs), total


# ---------------------------------------------------------------------------
# the eight policies: the engine on the card, the scheduler cell per policy
# ---------------------------------------------------------------------------


def policy_case(n: int, B: int, masked: bool, seed: int = SEED):
    """μ̂ and μ on a 2^-8 grid (every prefix sum exact in f32, so the CPU and
    the card build the same CDF), a queue, and POLICY_OFFLINE of the
    replicas offline when ``masked``."""
    rng = np.random.RandomState(seed + n + B + masked)
    mu = (rng.randint(0, 1024, n) / 256.0).astype(np.float32)
    mu_true = (rng.randint(1, 1024, n) / 256.0).astype(np.float32)
    q = rng.randint(0, 20, n).astype(np.int32)
    mask = None
    if masked:
        mask = np.ones(n, bool)
        mask[rng.permutation(n)[:int(n * POLICY_OFFLINE)]] = False
    return mu, mu_true, q, mask


def policy_engine(torch, D, P, prng, K, dev) -> tuple[dict, dict]:
    """(a): every policy's engine call on the card against the CPU, then its
    time; returns the records and the launches of the checked calls."""
    cfg = P.default_policy_config()
    launches = {w: 0 for w in REPLACES}
    rows = [(p, p in D.ALIAS_POLICIES) for p in P.ALL_POLICIES] + [("ppot_sq2", False)]
    recs = {}
    for policy, use_table in rows:
        for masked in (False, True):
            for n, B in POLICY_SHAPES:
                mu, mu_true, q, mask = policy_case(n, B, masked)
                key = prng.PRNGKey(n + B)
                args = {}
                before = K.launch_counts()  # the card's table build and engine call
                for d in ("cpu", dev):
                    t = lambda a: None if a is None else torch.from_numpy(a).to(d)  # noqa: E731
                    tab = D.build_alias_table(t(mu), t(mask)) if use_table else None
                    args[str(d)] = (t(q), t(mu), t(mu_true), tab, t(mask))

                def call(d, fold_chunks=1):
                    q_, mu_, mt_, tab, m_ = args[str(d)]
                    return D.dispatch(policy, key, q_, mu_, mt_, cfg, B, table=tab, mask=m_,
                                      fold_chunks=fold_chunks)
                label = policy if use_table or policy not in D.ALIAS_POLICIES else f"{policy} icdf"
                tag = f"[policies] {label} (n={n}, B={B}{', 25% offline' if masked else ''})"
                want = call("cpu")
                got = call(dev)
                torch.cuda.synchronize()
                for w, c in K.launch_counts().items():
                    launches[w] += c - before[w]
                need(torch.equal(got.workers.cpu(), want.workers)
                     and torch.equal(got.q_after.cpu(), want.q_after),
                     f"{tag}: the card's placements differ from the CPU's")
                if mask is not None:
                    need(mask[want.workers.numpy()].all(), f"{tag}: placed on an offline replica")
                ms = graph_call_ms(torch, lambda: call(dev))
                host_ms = host_median_ms(torch, lambda: call(dev))
                rec = dict(graph_ms=ms, host_ms=host_ms, decisions_per_s=B / (host_ms / 1e3),
                           graph_decisions_per_s=B / (ms / 1e3))
                if (n, B) == POLICY_SHAPES[0] and not masked and policy != "sparrow":
                    want_s = call("cpu", fold_chunks=B)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    got_s = call(dev, fold_chunks=B)
                    torch.cuda.synchronize()
                    rec["sequential_ms"] = (time.perf_counter() - t0) * 1e3
                    need(torch.equal(got_s.workers.cpu(), want_s.workers)
                         and torch.equal(got_s.q_after.cpu(), want_s.q_after),
                         f"{tag}: the card's sequential oracle differs from the CPU's")
                    rec["batched_over_sequential"] = rec["sequential_ms"] / host_ms
                recs[f"{label} {n} {B}{' masked' if masked else ''}"] = rec
                print(f"{tag}: equal on the card and the CPU; {host_ms:.6f} ms a call on the "
                      f"host clock, {rec['decisions_per_s']:.1f} decisions/s; {ms:.6f} ms a "
                      f"call replayed as a graph (event pairs), "
                      f"{rec['graph_decisions_per_s']:.1f} decisions/s"
                      + (f"; sequential oracle {rec['sequential_ms']:.3f} ms "
                         f"({rec['batched_over_sequential']:.1f}x the batched call)"
                         if "sequential_ms" in rec else ""))
    return recs, launches


def policy_cell(torch, tr, tenv, K, CK, chk, met, scn, speeds, dev, policy) -> dict:
    """(b): the null scenario at the scheduler cell under ``policy``, host
    loop and one-program loop on a SequentialPool, equal bit for bit."""
    h, wall_h, host_launches, caps = scenario_host(torch, tr, tenv, K, chk, scn, dev,
                                                   use_alias=True, sequential=True,
                                                   policy=policy)
    router = tr.RosellaRouter(scn.n, float(speeds.sum()), policy=policy, seed=SEED,
                              use_alias=True, async_mu=False, device=dev)
    K.reset_launches()
    CK.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = tenv.run_scenario(scn, seed=SEED, arrival_batch=BATCH, use_scan=True,
                          sequential_pool=True, router=router, pend_cap=caps["pend_cap"],
                          comp_cap=caps["comp_cap"], device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    info = s["info"]
    launches = scan_launches(K, CK, info)
    tag = f"[policies] {policy} cell"
    T = s["workload"].turns
    need(info["replays"] == info["turns"] == T, f"{tag}: the turns were not graph replays")
    need(info["flush_overflow"] == 0 and info["pend_overflow"] == 0, f"{tag}: {info}")
    for part, ok in (("responses", np.array_equal(h["responses"], s["responses"])),
                     ("mu trace", np.array_equal(h["mu_trace"], s["mu_trace"])),
                     ("free_at", np.array_equal(h["pool"].free_at, s["pool"].free_at))):
        need(ok, f"{tag}: the scan's {part} differ from the host loop's")
    resp = s["responses"]
    need(np.isfinite(resp).all() and (resp > 0).all() and resp.shape == (T * BATCH,),
         f"{tag}: bad responses")
    summ = met.serve_summary(resp)
    run_s = wall - (info["capture_s"] or 0.0)
    rec = dict(turns=T, requests=int(resp.size), turns_per_s=T / run_s,
               decisions_per_s=resp.size / run_s, host_turns_per_s=T / wall_h,
               capture_s=info["capture_s"], graph_nodes=info["graph_nodes"],
               launches_per_replay=sum(info["graph_kernels"].values()),
               p50=summ["p50"], p99=summ["p99"], mean=summ["mean"],
               rho=spearman(router.mu_hat, speeds), use_alias=router.use_alias,
               longest_chain=info["longest_chain"], host_launches=host_launches,
               launches=launches, **caps)
    return rec


def phase_policies(torch, tr, tenv, D, P, prng, K, CK, chk, met, speeds, dev, card):
    """All eight policies on the card: (a) the engine, (b) the scheduler
    cell; returns the records and the phase's launches by wrapper."""
    t0 = time.perf_counter()
    print(f"[policies] {card}; engine at (n, B) in {list(POLICY_SHAPES)}, unmasked and "
          f"{POLICY_OFFLINE:.0%} offline; cell n={N_REPLICAS} batch={BATCH} load {LOAD} "
          f"horizon {POLICY_HORIZON} s, async_mu=False, seed {SEED}")
    engine, launches = policy_engine(torch, D, P, prng, K, dev)
    launches["pool_chain"] = 0
    rate = LOAD * float(speeds.sum())
    scn = tenv.make("null", speeds=tuple(speeds), rate=rate, horizon=POLICY_HORIZON)
    cells = {}
    for policy in P.ALL_POLICIES:
        rec = cells[policy] = policy_cell(torch, tr, tenv, K, CK, chk, met, scn, speeds,
                                          dev, policy)
        for w in launches:
            launches[w] += rec["host_launches"].get(w, 0) + rec["launches"].get(w, 0)
    sq2 = cells["ppot_sq2"]
    for policy, rec in cells.items():
        print(f"[policies] {policy} cell: {rec['turns']} turns, {rec['requests']} requests, "
              f"host loop and scan equal bit for bit, overflows 0 at pend_cap "
              f"{rec['pend_cap']} comp_cap {rec['comp_cap']}; scan {rec['turns_per_s']:.2f} "
              f"turns/s {rec['decisions_per_s']:.1f} decisions/s (host loop, checked, "
              f"{rec['host_turns_per_s']:.2f} turns/s), capture {rec['capture_s']} s, "
              f"graph nodes {rec['graph_nodes']} ({rec['launches_per_replay']} kernels); "
              f"p50 {rec['p50']:.6f} p99 {rec['p99']:.6f} (ppot_sq2 {sq2['p50']:.6f} / "
              f"{sq2['p99']:.6f}); spearman(mu_hat, speeds) {rec['rho']:.4f}; use_alias "
              f"{rec['use_alias']}; longest chain {rec['longest_chain']}")
    for w in ("ppot_dispatch_fused_alias", "ppot_dispatch_fused", "ppot_dispatch",
              "alias_table", "pool_chain"):
        need(launches[w] > 0, f"[policies] {w} was never launched")
    secs = time.perf_counter() - t0
    print(f"[policies] {len(engine)} engine cases, {len(cells)} cells in {secs:.1f} s; "
          f"launches {json.dumps(launches)}")
    return dict(engine=engine, cells=cells, seconds=secs), launches


# ---------------------------------------------------------------------------
# the frontend fleet: S frontends over one pool, host loop and one program
# ---------------------------------------------------------------------------


def fleet_router(tr, speeds, S, dev, use_alias=True, **kw):
    return tr.FleetRouter(S, len(speeds), float(speeds.sum()), seed=SEED, async_mu=False,
                          use_alias=use_alias, device=dev, **kw)


def fleet_launches(K, CK, info) -> dict:
    """A fleet scan run's launches by wrapper: the eager warm-up turns of its
    captures (the wrappers' counts) and each pattern's kernel nodes times
    the replays of that pattern."""
    eager = {**K.launch_counts(), **CK.launch_counts()}
    graphs = by_wrapper(info["graph_launches"])
    return {w: eager.get(w, 0) + graphs[w] for w in PROFILE_NAMES}


def fleet_profile(torch, tsl, cfg, rows: int, router, pool, cols: dict, dev,
                  mesh=None) -> dict:
    """Turns 1 to FLEET_PROFILE_TURNS of a fleet run again, from the fresh
    ``router`` and ``pool`` (turn 0 replayed before the profiler starts), on
    the runner (and graphs) the run captured: device busy ms and idle share
    a turn, launches a turn by wrapper, held to the graphs' kernel nodes for
    the patterns the window replays (a session that misses a record is run
    again)."""
    run = tsl.fleet_runner(cfg, str(dev), rows, mesh)
    W = FLEET_PROFILE_TURNS
    first = {name: a[:1] for name, a in cols.items()}
    window = {name: a[1:W + 1] for name, a in cols.items()}
    changed = window.get("changed", np.zeros(W, bool))
    want = {w: 0 for w in PROFILE_NAMES}
    for t in range(W):
        for w, c in by_wrapper(run.graph_kernels[run.pattern(1 + t, changed[t])]).items():
            want[w] += c
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        run.load(router(), pool())
        run.run_rows(first, 0)
        prof = device_profile(torch, lambda: run.run_rows(window, 1))
        seen = by_wrapper(prof["count"])
        if seen == want:
            break
        print(f"[fleet] profiler session {attempt}: {seen} in {W} replays, the graphs hold "
              f"{want}")
    need(seen == want, f"[fleet] {W} profiled replays launched {seen}, the graphs hold {want} "
         f"({PROFILE_ATTEMPTS} profiler sessions)")
    return dict(busy_ms=prof["busy_us"] / 1e3 / W, idle=prof["idle"],
                launches_per_turn=prof["launches"] / W, copies_per_turn=prof["copies"] / W,
                kernel_per_turn={w: c / W for w, c in seen.items()})


def fleet_summary_of(met, info, S: int, lam_true: float) -> dict:
    s = met.fleet_summary(info["frontends"], info["workers"], info["epochs"], n_frontends=S,
                          lam_hat_frontends=info["lam_hats"], lam_true=lam_true,
                          view_gaps=info["sync_gaps"], ledger=info.get("ledger"))
    return dict(collision_rate=s["collision_rate"], contested_cells=s["contested_cells"],
                gap_mean=s.get("staleness", {}).get("gap_mean", 0.0),
                gap_max=s.get("staleness", {}).get("gap_max", 0.0),
                lam_fleet_rel_err=s["lam_fleet_rel_err"])


def fleet_scan_record(tag, info, wall, T, requests, prof, launches, summ) -> dict:
    run_s = wall - info["capture_s"]
    nodes = {label: g["nodes"] for label, g in info["graphs"].items()}
    rec = dict(turns=T, turns_per_s=T / run_s, decisions_per_s=requests / run_s,
               capture_s=info["capture_s"], graph_nodes=nodes,
               graph_replays={label: g["replays"] for label, g in info["graphs"].items()},
               busy_ms_per_turn=prof["busy_ms"], idle=prof["idle"],
               launches_per_turn_profiled=prof["launches_per_turn"],
               kernel_per_turn=prof["kernel_per_turn"], launches=launches,
               longest_chain=info["longest_chain"], **summ)
    print(f"[fleet {tag}] {T} turns, {requests} requests: {rec['turns_per_s']:.2f} turns/s, "
          f"{rec['decisions_per_s']:.1f} decisions/s; capture {info['capture_s']:.3f} s, graph "
          f"nodes {json.dumps(nodes)} (replays {json.dumps(rec['graph_replays'])}); "
          f"{FLEET_PROFILE_TURNS} replays profiled: busy {prof['busy_ms']:.4f} ms a turn, idle "
          f"share {prof['idle']:.4f}, {prof['launches_per_turn']:.2f} launches a turn, by "
          f"kernel {json.dumps({k: round(v, 3) for k, v in prof['kernel_per_turn'].items()})}; "
          f"fleet_summary: collision rate {summ['collision_rate']:.6f}, view gaps mean "
          f"{summ['gap_mean']:.3f} max {summ['gap_max']:.0f}, λ̂ fleet error "
          f"{summ['lam_fleet_rel_err']:.6f}; launches of the run {json.dumps(launches)}")
    return rec


def fleet_exact(torch, tr, tsl, K, CK, met, speeds, dev, use_alias: bool,
                sync_every: int) -> tuple[dict, dict, tuple]:
    """(a) One cell through the host fleet loop and the fleet scan, both on
    the card, on a SequentialPool: equal bit for bit in responses, μ̂ trace,
    free_at, the agreed snapshot, each frontend's queue view and μ̂ (front
    and learner), the placement log and the sync gaps. Returns the record,
    the launches, and the scan's (responses, μ̂ trace, info) for [fleet
    mesh]."""
    S, rate = FLEET_S, LOAD * float(speeds.sum())
    kw = dict(arrival_rate=rate, horizon=FLEET_TURNS * BATCH / rate, seed=SEED,
              arrival_batch=BATCH, sync_every=sync_every)
    tag = f"{'alias' if use_alias else 'icdf'} sync_every={sync_every}"
    rh, ph = fleet_router(tr, speeds, S, dev, use_alias), tr.SequentialPool(speeds)
    K.reset_launches()
    t0 = time.perf_counter()
    resp_h, mu_h, ih = tr.run_fleet_simulation(rh, ph, **kw)
    torch.cuda.synchronize()
    wall_h = time.perf_counter() - t0
    host_launches = K.launch_counts()
    T = ih["turns"]
    rs, ps = fleet_router(tr, speeds, S, dev, use_alias), tr.SequentialPool(speeds)
    K.reset_launches()
    CK.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resp_s, mu_s, info = tsl.run_fleet_simulation_scan(rs, ps, pend_cap=FLEET_PEND_CAP,
                                                       chunk_turns=T, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fleet_launches(K, CK, info)
    need(info["replays"] == info["turns"] == T >= FLEET_TURNS - 20,
         f"[fleet {tag}] the turns were not graph replays ({info['replays']} of {T})")
    need(info["flush_overflow"] == info["pend_overflow"] == 0, f"[fleet {tag}] overflow")
    for part, ok in (
            ("responses", np.array_equal(resp_h, resp_s)),
            ("mu trace", np.array_equal(mu_h, mu_s)),
            ("free_at", np.array_equal(ph.free_at, ps.free_at)),
            ("snapshot", np.array_equal(rh._snap, rs._snap)),
            ("q_view", all(bool((a.q_view == b.q_view).all())
                           for a, b in zip(rh.frontends, rs.frontends))),
            ("mu_front", all(bool((a.mu_front == b.mu_front).all())
                             for a, b in zip(rh.frontends, rs.frontends))),
            ("learner mu_hat", all(bool((a.learner.mu_hat == b.learner.mu_hat).all())
                                   for a, b in zip(rh.frontends, rs.frontends))),
            ("placements", np.array_equal(ih["workers"], info["workers"])),
            ("sync gaps", np.array_equal(ih["sync_gaps"], info["sync_gaps"]))):
        need(ok, f"[fleet {tag}] the scan's {part} differ from the host fleet loop's")
    need(np.isfinite(resp_s).all() and (resp_s > 0).all(), f"[fleet {tag}] bad responses")
    cfg = tsl.fleet_scan_config(rs, BATCH, pend_cap=FLEET_PEND_CAP, sync_every=sync_every)
    cols = dict(zip(("times", "costs", "speeds"), tsl._precompute_workload(
        rate, kw["horizon"], 1.0, None, SEED, BATCH, speeds)))
    prof = fleet_profile(torch, tsl, cfg, T,
                         lambda: fleet_router(tr, speeds, S, dev, use_alias),
                         lambda: tr.SequentialPool(speeds), cols, dev)
    summ = fleet_summary_of(met, info, S, rate)
    print(f"[fleet exact {tag}] host fleet loop and fleet scan on the card, SequentialPool, "
          f"S={S}: responses, mu trace, free_at, snapshot, every frontend's q_view, mu_front "
          f"and learner mu_hat, placements and sync gaps equal over {T} turns; host fleet loop "
          f"{T / wall_h:.2f} turns/s ({len(resp_h) / wall_h:.1f} decisions/s), launches "
          f"{json.dumps(host_launches)}")
    rec = fleet_scan_record(f"exact {tag}", info, wall, T, len(resp_s), prof, launches, summ)
    rec.update(host_turns_per_s=T / wall_h, host_decisions_per_s=len(resp_h) / wall_h,
               host_launches=host_launches)
    return (rec, {w: launches[w] + host_launches.get(w, 0) for w in PROFILE_NAMES},
            (resp_s, mu_s, info))


def fleet_s1(torch, tr, tsl, K, CK, met, speeds, dev) -> dict:
    """(b) The (a) cell at S = 1 against the single-frontend scan, bit for
    bit (alias stream, sync every turn)."""
    rate = LOAD * float(speeds.sum())
    kw = dict(arrival_rate=rate, horizon=FLEET_TURNS * BATCH / rate, seed=SEED,
              arrival_batch=BATCH)
    cols = dict(zip(("times", "costs", "speeds"), tsl._precompute_workload(
        rate, kw["horizon"], 1.0, None, SEED, BATCH, speeds)))
    T = len(cols["times"])
    ra = tr.RosellaRouter(len(speeds), float(speeds.sum()), seed=SEED, async_mu=False,
                          device=dev)
    pa = tr.SequentialPool(speeds)
    K.reset_launches()
    CK.reset_launches()
    resp_a, mu_a, ia = tsl.run_simulation_scan(ra, pa, pend_cap=FLEET_PEND_CAP, **kw)
    single = scan_launches(K, CK, ia)
    rb, pb = fleet_router(tr, speeds, 1, dev), tr.SequentialPool(speeds)
    K.reset_launches()
    CK.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resp_b, mu_b, ib = tsl.run_fleet_simulation_scan(rb, pb, pend_cap=FLEET_PEND_CAP,
                                                     chunk_turns=T, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fleet = fleet_launches(K, CK, ib)
    fr = rb.frontends[0]
    for part, ok in (("responses", np.array_equal(resp_a, resp_b)),
                     ("mu trace", np.array_equal(mu_a, mu_b)),
                     ("free_at", np.array_equal(pa.free_at, pb.free_at)),
                     ("q_view", bool((ra.q_view == fr.q_view).all())),
                     ("learner mu_hat", bool((ra.learner.mu_hat == fr.learner.mu_hat).all())),
                     ("key", ra.key == fr.key)):
        need(ok, f"[fleet S=1] the fleet scan's {part} differ from the single scan's")
    print(f"[fleet S=1] {ib['turns']} turns at S=1: responses, mu trace, free_at, q_view, "
          f"learner mu_hat and key equal to the single-frontend scan ({ia['graph_nodes']} "
          f"nodes)")
    prof = fleet_profile(torch, tsl, tsl.fleet_scan_config(rb, BATCH, pend_cap=FLEET_PEND_CAP),
                         T, lambda: fleet_router(tr, speeds, 1, dev),
                         lambda: tr.SequentialPool(speeds), cols, dev)
    rec = fleet_scan_record("S=1", ib, wall, T, len(resp_b), prof, fleet,
                            fleet_summary_of(met, ib, 1, rate))
    rec.update(single_nodes=ia["graph_nodes"],
               launches={w: single[w] + fleet[w] for w in PROFILE_NAMES})
    return rec


def fleet_scenario_run(torch, tr, tsl, tenv, K, CK, met, speeds, dev, tag, scn, opts,
                       observe=None):
    """``run_scenario(n_frontends = S, use_scan=True)`` of ``scn`` at the
    scheduler cell in one chunk, timed, with its launches, and its first
    turns profiled. Returns (run, record)."""
    wl = scn.compile_serving(seed=SEED, arrival_batch=BATCH)
    T = wl.turns
    K.reset_launches()
    CK.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = tenv.run_scenario(scn, seed=SEED, arrival_batch=BATCH, use_scan=True,
                            n_frontends=FLEET_S, pend_cap=FLEET_ENV_PEND_CAP, chunk_turns=T,
                            observe=observe, device=dev, **opts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    info = out["info"]
    launches = fleet_launches(K, CK, info)
    need(info["replays"] == info["turns"] == T, f"[fleet {tag}] the turns were not replays")
    need(info["flush_overflow"] == info["pend_overflow"] == 0, f"[fleet {tag}] overflow")
    churn = wl.active is not None
    cfg = tsl.fleet_scan_config(
        out["router"], BATCH, churn=churn, burst_cap=wl.burst.shape[1] if churn else 0,
        fake_cost=scn.request_cost * 0.25, pend_cap=FLEET_ENV_PEND_CAP, faulty=wl.has_faults,
        task_cap=T * BATCH, sync_every=opts.get("sync_every", 1),
        frozen_mu=opts.get("frozen_mu", False), observe=observe)
    cols = dict(times=wl.times, costs=wl.costs, speeds=wl.speeds)
    if churn:
        changed = np.r_[True, (wl.active[1:] != wl.active[:-1]).any(1)]
        cols.update(active=wl.active, rejoin=wl.rejoin, changed=changed, burst=wl.burst)
    if wl.has_faults:
        cols.update(kill=wl.kill_at, stall=wl.stall_at, stall_dur=wl.stall_dur)
    prof = fleet_profile(torch, tsl, cfg, T, lambda: fleet_router(tr, speeds, FLEET_S, dev),
                         lambda: tr.SimulatedPool(np.asarray(scn.speeds)), cols, dev)
    rate = LOAD * float(speeds.sum())
    resp = out["responses"]
    rec = fleet_scan_record(tag, info, wall, T, int(resp.size), prof, launches,
                            fleet_summary_of(met, info, FLEET_S, rate))
    return out, rec


def fleet_env(torch, tr, tsl, tenv, K, CK, met, speeds, dev, name, opts) -> dict:
    """(c) A scenario at the scheduler cell through ``run_scenario(n_frontends
    = S, use_scan=True)``: churn never places on a replica inactive that
    turn; a fault scenario's ledger conserves."""
    scn = tenv.make(name, speeds=tuple(speeds), rate=LOAD * float(speeds.sum()))
    tag = f"{name} {' '.join(f'{k}={v}' for k, v in opts.items())}".strip()
    out, rec = fleet_scenario_run(torch, tr, tsl, tenv, K, CK, met, speeds, dev, tag, scn,
                                  opts)
    info, wl = out["info"], out["workload"]
    resp = out["responses"]
    if wl.has_faults:
        led = info["ledger"]
        need(met.check_conservation(led)[0] and led["conserved"],
             f"[fleet {tag}] the ledger does not conserve: {led}")
        need(led["copies_real_killed"] > 0, f"[fleet {tag}] no copy was killed")
        done = int(np.isfinite(resp).sum())
        need(done == led["completed_tasks"], f"[fleet {tag}] {done} finite responses, ledger "
             f"{led['completed_tasks']}")
        rec["ledger"] = {k: led[k] for k in ("lost_tasks", "copies_real_killed",
                                             "completed_tasks", "conserved")}
    else:
        need(np.isfinite(resp).all() and (resp > 0).all(), f"[fleet {tag}] bad responses")
    if wl.active is not None:
        placed = info["workers"].reshape(wl.turns, -1)
        bad = sum(int((~wl.active[t][placed[t]]).sum()) for t in range(wl.turns))
        need(bad == 0, f"[fleet {tag}] {bad} placements on replicas inactive that turn")
    s = met.serve_summary(resp[np.isfinite(resp)])
    rec.update(p50=s["p50"], p99=s["p99"])
    print(f"[fleet {tag}] p50 {s['p50']:.6f} p99 {s['p99']:.6f}"
          + (f"; ledger {json.dumps(rec['ledger'])}" if wl.has_faults else "")
          + ("; no placement on an inactive replica" if wl.active is not None else ""))
    return rec


def fleet_obs(torch, tr, tsl, tenv, obs, K, CK, met, speeds, dev) -> dict:
    """(d) Churn at S = 4 with windows of FLEET_WINDOW turns: telemetry on
    and off give equal responses and placements; the fleet-aggregate and
    per-frontend records."""
    scn = tenv.make("churn", speeds=tuple(speeds), rate=LOAD * float(speeds.sum()))
    off = tenv.run_scenario(scn, seed=SEED, arrival_batch=BATCH, use_scan=True,
                            n_frontends=FLEET_S, pend_cap=FLEET_ENV_PEND_CAP, device=dev)
    on, rec = fleet_scenario_run(torch, tr, tsl, tenv, K, CK, met, speeds, dev,
                                 f"obs churn windows={FLEET_WINDOW}", scn, {},
                                 observe=obs.ObserveConfig(window_turns=FLEET_WINDOW))
    info = on["info"]
    for part, ok in (("responses", np.array_equal(on["responses"], off["responses"])),
                     ("mu trace", np.array_equal(on["mu_trace"], off["mu_trace"])),
                     ("placements", np.array_equal(info["workers"], off["info"]["workers"]))):
        need(ok, f"[fleet obs] telemetry on changed the {part}")
    T = info["turns"]
    wins, per = info["windows"], info["windows_frontends"]
    need(len(wins) == len(per) == -(-T // FLEET_WINDOW) and all(len(w) == FLEET_S for w in per),
         f"[fleet obs] {len(wins)} windows for {T} turns")
    need(sum(w["n_resp"] for w in wins) == on["responses"].size, "[fleet obs] the windows "
         "do not hold every response")
    nodes_off = {label: g["nodes"] for label, g in off["info"]["graphs"].items()}
    mid = len(wins) // 2
    show = ("p50", "p99", "throughput", "lam_hat", "q_mean", "collisions", "collision_rate",
            "mu_rel_err", "n_active")
    print(f"[fleet obs] churn, S={FLEET_S}, windows of {FLEET_WINDOW}: {len(wins)} windows, "
          f"responses, mu trace and placements equal to telemetry off (graph nodes off "
          f"{json.dumps(nodes_off)}); window {mid} aggregate "
          f"{json.dumps({k: wins[mid][k] for k in show})}; per frontend "
          + "; ".join(json.dumps({"frontend": r["frontend"], **{k: r[k] for k in show}})
                      for r in per[mid]))
    rec.update(windows=len(wins), nodes_off=nodes_off)
    return rec


def phase_fleet(torch, tr, tsl, tenv, obs, K, CK, met, speeds, dev, card):
    """The [fleet] cells; returns the records, the phase's launches by
    wrapper and the FLEET_EXACT scans' results by case."""
    t0 = time.perf_counter()
    rate = LOAD * float(speeds.sum())
    print(f"[fleet] {card}; n={N_REPLICAS} (tpch_speed_set, sum {speeds.sum():.2f}), rate "
          f"{rate:.3f}/s, batches of {BATCH} over S={FLEET_S} frontends "
          f"({BATCH // FLEET_S} each), async_mu=False, seed {SEED}")
    total = {w: 0 for w in PROFILE_NAMES}
    exact, stacked = {}, {}
    for use_alias, sync_every in FLEET_EXACT:
        t1 = time.perf_counter()
        rec, launches, stacked[(use_alias, sync_every)] = fleet_exact(
            torch, tr, tsl, K, CK, met, speeds, dev, use_alias, sync_every)
        rec["seconds"] = time.perf_counter() - t1
        exact[f"{'alias' if use_alias else 'icdf'} sync_every={sync_every}"] = rec
        for w in PROFILE_NAMES:
            total[w] += launches[w]
    t1 = time.perf_counter()
    s1 = fleet_s1(torch, tr, tsl, K, CK, met, speeds, dev)
    s1["seconds"] = time.perf_counter() - t1
    env_cells = {}
    for name, opts in FLEET_ENV:
        t1 = time.perf_counter()
        env_cells[name] = fleet_env(torch, tr, tsl, tenv, K, CK, met, speeds, dev, name, opts)
        env_cells[name]["seconds"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    tele = fleet_obs(torch, tr, tsl, tenv, obs, K, CK, met, speeds, dev)
    tele["seconds"] = time.perf_counter() - t1
    for r in [s1, tele, *env_cells.values()]:
        for w in PROFILE_NAMES:
            total[w] += r["launches"][w]
    need(exact["icdf sync_every=8"]["launches"]["ppot_dispatch_fused"] > 0,
         "[fleet] the CDF cell never launched K2")
    for w in ("ppot_dispatch_fused_alias", "ppot_dispatch_fused", "alias_table", "pool_chain"):
        need(total[w] > 0, f"[fleet] {w} was never launched")
    secs = time.perf_counter() - t0
    cell_s = {**{f"exact {k}": r["seconds"] for k, r in exact.items()}, "S=1": s1["seconds"],
              **{k: r["seconds"] for k, r in env_cells.items()}, "obs": tele["seconds"]}
    cell_s = {k: round(v, 1) for k, v in cell_s.items()}
    print(f"[fleet] {len(exact)} exact cells, S=1, {len(env_cells)} scenario cells and "
          f"telemetry in {secs:.1f} s ({json.dumps(cell_s)}); launches {json.dumps(total)}")
    return dict(exact=exact, s1=s1, env=env_cells, obs=tele, seconds=secs), total, stacked


def mesh_collective_ms(torch, mesh, S: int, n: int, kf: int, mf: int, dev) -> dict:
    """One sync round's collectives at the fleet turn's shapes (the queue
    deltas' all-reduce, the μ̂ rows', λ̂ and gaps' gathers) and one turn's
    placements gather, each timed eagerly over MESH_COLLECTIVE_REPS calls in
    an event pair on the card."""
    from repro_torch.fleet import sync as fsync

    _, Sl = mesh.rows(S)
    q = torch.zeros((Sl, n), dtype=torch.int32, device=dev)
    mu = torch.ones((Sl, n), dtype=torch.float32, device=dev)
    lam = torch.ones(Sl, dtype=torch.float32, device=dev)
    snap = torch.zeros(n, dtype=torch.int32, device=dev)
    pw = torch.zeros((Sl, mf + kf), dtype=torch.int32, device=dev)
    sync = fsync.make_fleet_scan_sync(mesh)
    counts = mesh.counts.copy()
    out = {}
    for name, fn in (("sync round", lambda: sync(q, q, snap, mu, lam)),
                     ("placements", lambda: mesh.all_gather_rows(pw, "placements"))):
        for _ in range(10):
            fn()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        e0.record()
        for _ in range(MESH_COLLECTIVE_REPS):
            fn()
        e1.record()
        torch.cuda.synchronize()
        out[name] = e0.elapsed_time(e1) / MESH_COLLECTIVE_REPS
    mesh.counts.clear()
    mesh.counts.update(counts)
    return out


def phase_fleet_mesh(torch, tr, tsl, K, CK, met, speeds, dev, card, stacked):
    """[fleet mesh]: [fleet]'s FLEET_EXACT cases through the collective fleet
    on a one-rank NCCL mesh, each held bit for bit to [fleet]'s stacked scan
    of the case; returns the records and the launches by wrapper."""
    import tempfile

    from repro_torch.fleet import sync as fsync

    t0 = time.perf_counter()
    S, rate = FLEET_S, LOAD * float(speeds.sum())
    total = {w: 0 for w in PROFILE_NAMES}
    cells = {}
    with tempfile.TemporaryDirectory() as tmp, fsync.file_store_mesh(
            Path(tmp) / "store", 0, 1, dev, timeout_s=120) as mesh:
        print(f"[fleet mesh] {card}; a {mesh.size}-rank {torch.distributed.get_backend()} group "
              f"through a FileStore (NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}), "
              f"S={S} frontends as {mesh.rows(S)[1]} local rows, n={N_REPLICAS}, batches of "
              f"{BATCH}, async_mu=False, seed {SEED}")
        for use_alias, sync_every in FLEET_EXACT:
            tag = f"{'alias' if use_alias else 'icdf'} sync_every={sync_every}"
            kw = dict(arrival_rate=rate, horizon=FLEET_TURNS * BATCH / rate, seed=SEED,
                      arrival_batch=BATCH, sync_every=sync_every)
            resp_n, mu_n, info_n = stacked[(use_alias, sync_every)]
            T = info_n["turns"]
            rm, pm = fleet_router(tr, speeds, S, dev, use_alias), tr.SequentialPool(speeds)
            K.reset_launches()
            CK.reset_launches()
            mesh.counts.clear()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            resp_m, mu_m, info = tsl.run_fleet_simulation_scan(
                rm, pm, pend_cap=FLEET_PEND_CAP, chunk_turns=T, mesh=mesh, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            launches = fleet_launches(K, CK, info)
            need(info["replays"] == info["turns"] == T, f"[fleet mesh {tag}] the turns were not "
                 f"graph replays ({info['replays']} of {T})")
            for part, ok in (
                    ("responses", np.array_equal(resp_n, resp_m)),
                    ("mu trace", np.array_equal(mu_n, mu_m)),
                    ("placements", np.array_equal(info_n["workers"], info["workers"])),
                    ("epochs", np.array_equal(info_n["epochs"], info["epochs"])),
                    ("sync gaps", np.array_equal(info_n["sync_gaps"], info["sync_gaps"]))):
                need(ok, f"[fleet mesh {tag}] the mesh scan's {part} differ from [fleet]'s "
                     f"stacked scan")
            syncs = -(-T // sync_every)
            coll = info["collectives"]
            need(all(coll.get(k, 0) == syncs for k in fsync.SYNC_KINDS)
                 and coll.get("placements", 0) == T,
                 f"[fleet mesh {tag}] collectives {coll} for {syncs} sync turns of {T}")
            in_graph = {label: g["collectives"] for label, g in info["graphs"].items()}
            need(all(in_graph.values()), f"[fleet mesh {tag}] a pattern's graph holds no "
                 f"collective: {in_graph}")
            cfg = tsl.fleet_scan_config(rm, BATCH, pend_cap=FLEET_PEND_CAP, sync_every=sync_every)
            cols = dict(zip(("times", "costs", "speeds"), tsl._precompute_workload(
                rate, kw["horizon"], 1.0, None, SEED, BATCH, speeds)))
            prof = fleet_profile(torch, tsl, cfg, T,
                                 lambda: fleet_router(tr, speeds, S, dev, use_alias),
                                 lambda: tr.SequentialPool(speeds), cols, dev, mesh)
            summ = fleet_summary_of(met, info, S, rate)
            rec = fleet_scan_record(f"mesh {tag}", info, wall, T, len(resp_m), prof, launches,
                                    summ)
            rec.update(collectives=coll, graph_collectives=in_graph)
            print(f"[fleet mesh {tag}] responses, mu trace, placements, epochs and sync gaps "
                  f"equal to [fleet]'s stacked scan over {T} turns; collectives of the run "
                  f"{json.dumps(coll)}, inside the graphs by pattern {json.dumps(in_graph)}")
            cells[tag] = rec
            for w in PROFILE_NAMES:
                total[w] += launches[w]
        coll_ms = mesh_collective_ms(torch, mesh, S, N_REPLICAS, BATCH // S, tr.MAX_FAKE,
                                     dev)
        tsl.fleet_runner.cache_clear()  # the graphs with the group's collectives go first
    for w in ("ppot_dispatch_fused_alias", "ppot_dispatch_fused", "alias_table", "pool_chain"):
        need(total[w] > 0, f"[fleet mesh] {w} was never launched")
    secs = time.perf_counter() - t0
    print(f"[fleet mesh] {card}; collectives eagerly, {MESH_COLLECTIVE_REPS} calls each: one "
          f"sync round's four {coll_ms['sync round']:.6f} ms, one turn's placements gather "
          f"{coll_ms['placements']:.6f} ms; in the runs they ran inside the graphs; "
          f"{len(cells)} cells in {secs:.1f} s; launches {json.dumps(total)}")
    return dict(cells=cells, collective_ms=coll_ms, seconds=secs), total


# ---------------------------------------------------------------------------
# the streaming load harness: a million requests through the one-program loop
# ---------------------------------------------------------------------------


def load_scenario(Scenario, AzureLikeTrace, horizon: float):
    """The [load] cell's scenario, cut to ``horizon`` seconds."""
    return Scenario(name="azure_like_load",
                    speeds=tuple(np.tile(np.asarray(LOAD_SPEED_TILE, float), LOAD_TILES)),
                    rate=LOAD_RATE, horizon=horizon, arrivals=AzureLikeTrace(**LOAD_TRACE))


def load_router(tr, speeds, dev, use_alias=True):
    return tr.RosellaRouter(len(speeds), float(np.sum(speeds)), policy="ppot_sq2", seed=SEED,
                            async_mu=False, use_alias=use_alias, c_window=10.0, device=dev)


def graph_kernel_summary(graph_kernels: dict) -> dict:
    """A captured graph's kernel nodes: the hand-written kernels by their
    (mangled) names, and how many nodes and distinct kernels the rest
    (PyTorch's own) are."""
    rest = [c for name, c in graph_kernels.items() if wrapper_of(name) is None]
    return dict(hand_written={name: c for name, c in graph_kernels.items()
                              if wrapper_of(name) is not None},
                other_nodes=sum(rest), other_kernels=len(rest))


def same_final_state(torch, tag, ra, pa, rb, pb) -> None:
    """need() the router and the pool as two runs left them equal bit for bit."""
    def same(a, b):
        return (a is None and b is None) or (a is not None and b is not None
                                             and torch.equal(a, b))
    arr = [(float(r.arr.last_time), float(r.arr.mean_gap), int(r.arr.count)) for r in (ra, rb)]
    for part, ok in (("q_view", same(ra.q_view, rb.q_view)),
                     *((f"learner {f}", same(getattr(ra.learner, f), getattr(rb.learner, f)))
                       for f in ("samples", "stamps", "widx", "count", "epoch_start",
                                 "mu_hat")),
                     ("key", np.array_equal(np.asarray(ra.key), np.asarray(rb.key))),
                     ("last_fake_time", ra.last_fake_time == rb.last_fake_time),
                     ("arrival estimate", arr[0] == arr[1]), ("active", same(ra.active, rb.active)),
                     ("free_at", np.array_equal(pa.free_at, pb.free_at))):
        need(ok, f"{tag} the final {part} differs")


def load_kernels(torch, chk, CK, CR, D, dev, mu, n_fault: int, bc: int, R: int,
                 route: int) -> float:
    """The [load] path's kernels on the card at its shapes, against their
    plain versions: K1-K3 and the table at n = 64 on the full run's final μ̂
    (unmasked and 20% masked) with batches of LOAD_BATCH; the keyed K1 also
    at the fault stream's widened route (n = ``n_fault``, ``route`` slots,
    with and without a slot mask); the replica chain
    of a [load] turn (n = 64: 8 benchmark slots and the batch) and of the
    fault stream's turn (n = ``n_fault``, the stream's fixed burst width
    ``bc``, -1 but for three rejoins, and a tail of ``R``). Returns
    pool_chain's largest error."""
    K, Rf = chk.K, chk.R
    n = mu.shape[0]
    rng = np.random.RandomState(SEED)
    q = torch.from_numpy(rng.randint(0, 50, n).astype(np.int32)).to(dev)
    u1, u2, v1, v2 = (torch.from_numpy(rng.randint(0, 65536, LOAD_BATCH).astype(np.float32)
                                       / 65536.0).to(dev) for _ in range(4))
    for act in (None, torch.from_numpy(rng.rand(n) < 0.8).to(dev)):
        p = D.scaled_weights(mu, act)
        prob, alias = K.alias_table(p, act)
        chk.compare("alias_table", (prob, alias), Rf.alias_table_ref(p, act))
        hold_keyed(torch, chk, prob, alias, q, LOAD_BATCH, SEED + n, dev)
        chk.compare("ppot_dispatch_fused_alias_unkeyed",
                    K.ppot_dispatch_fused_alias(prob, alias, q, u1, v1, u2, v2),
                    Rf.ppot_dispatch_fused_alias_ref(prob, alias, q, u1, v1, u2, v2))
        cdf = Rf.make_cdf(mu) if act is None else D.masked_cdf(mu, act)
        chk.compare("ppot_dispatch_fused", K.ppot_dispatch_fused(cdf, q, u1, u2),
                    Rf.ppot_dispatch_fused_ref(cdf, q, u1, u2))
        chk.compare("ppot_dispatch", K.ppot_dispatch(cdf, q, u1, u2),
                    Rf.ppot_dispatch_ref(cdf, q, u1, u2))
    rk = np.random.RandomState(SEED + n_fault)  # apart from the chain cases' draws
    mu_f = torch.from_numpy(rk.rand(n_fault).astype(np.float32) * 5).to(dev)
    prob_f, alias_f = K.alias_table(D.scaled_weights(mu_f))
    q_f = torch.from_numpy(rk.randint(0, 50, n_fault).astype(np.int32)).to(dev)
    hold_keyed(torch, chk, prob_f, alias_f, q_f, route, SEED + n_fault, dev)
    err, shapes = 0.0, []
    for nn, b, r in ((n, 0, 0), (n_fault, bc, R)):
        fake = rng.randint(0, nn, 8).astype(np.int32)
        fake[::3] = -1
        burst = np.full(b, -1, np.int32)
        burst[:12] = np.repeat(rng.randint(0, nn, 3), 4)[:b]
        t = [torch.from_numpy(x).to(dev) for x in (
            rng.rand(nn) * 3, rng.rand(nn) + 0.05, fake, burst,
            rng.randint(0, nn, LOAD_BATCH).astype(np.int32), np.sort(rng.rand(LOAD_BATCH) * 3),
            rng.exponential(1.0, LOAD_BATCH))]
        tail = ([torch.from_numpy(x).to(dev) for x in (
            rng.randint(0, nn, r).astype(np.int32), rng.exponential(1.0, r), rng.rand(r) < 0.7)]
            if r else [None] * 3)
        got = CK.pool_turn(*t, 0.25, 1.0, tail_w=tail[0], tail_cost=tail[1], tail_gate=tail[2])
        want = CR.pool_turn_ref(*t, 0.25, 1.0, *[x for x in tail if x is not None])
        torch.cuda.synchronize()
        shapes.append(f"n={nn} M={8 + b + LOAD_BATCH + r}")
        err = max(err, held_equal(torch, f"[load] pool_turn {shapes[-1]}",
                                  ("start", "done", "sub_w", "act", "free_at", "resp"), got,
                                  want))
    print(f"[load] kernels at the path's shapes equal to their plain versions: K1 (keyed, "
          f"host and device keys, with and without slots; and unkeyed), K2, K3 and "
          f"alias_table at n={n} on the full run's final mu (unmasked and 20% masked), "
          f"the keyed K1 at the fault stream's route (n={n_fault}, {route} slots), "
          f"batches of {LOAD_BATCH}; pool_turn at {shapes[0]} and at {shapes[1]} (the fault "
          f"stream's burst width {bc} and tail {R}; one launch holds up to "
          f"{CK.max_steps(n_fault)} steps at n={n_fault})")
    return err


def load_full(torch, tr, tsl, tload, obs, K, CK, met, Scenario, dev, card) -> dict:
    """(a) The full [load] run: LOAD_HORIZON seconds of the Azure-shaped
    stream through ``run_stream_scan`` in stream-only telemetry, a timing
    record a chunk; then LOAD_PROFILE_TURNS replays of its graph under the
    profiler, from a fresh router on the stream's first turns."""
    scn = load_scenario(Scenario, tload.AzureLikeTrace, LOAD_HORIZON)
    speeds = np.asarray(scn.speeds, float)
    router, pool = load_router(tr, speeds, dev), tr.SimulatedPool(speeds)
    stream = tload.ScenarioStream(scn, seed=SEED, arrival_batch=LOAD_BATCH)
    ocfg = obs.ObserveConfig(window_turns=LOAD_WINDOW, emit_responses=False)
    sunk: list = []
    tag = "[load]"
    K.reset_launches()
    CK.reset_launches()
    t0 = time.perf_counter()
    resp, mu, info = tload.run_stream_scan(
        router, pool, stream, chunk_turns=LOAD_CHUNK, fake_cost=scn.request_cost * 0.25,
        pend_cap=LOAD_PEND_CAP, comp_cap=LOAD_COMP_CAP, observe=ocfg, obs_sink=sunk.extend,
        timing=True)
    wall = time.perf_counter() - t0
    launches = scan_launches(K, CK, info)
    T, w = info["turns"], info["windows"]
    sus = sustained_series(info["chunks"], warmup=1)
    cal = met.calibration_report(ocfg, w, warmup_windows=2)
    lam = cal.get("lam_calibration", {})
    need(resp.size == 0 and mu.shape == (0, scn.n), f"{tag} stream-only returned rows")
    need(info["replays"] == T and info["graph_nodes"], f"{tag} the turns were not replays")
    need(info["flush_overflow"] == 0 and info["pend_overflow"] == 0,
         f"{tag} overflow: flush {info['flush_overflow']} pend {info['pend_overflow']}")
    need(sus["requests_total"] == T * LOAD_BATCH >= LOAD_MIN_REQUESTS,
         f"{tag} {sus['requests_total']} requests streamed, fewer than {LOAD_MIN_REQUESTS}")
    need(len(info["chunks"]) == -(-T // LOAD_CHUNK) and stream.turns_emitted == T,
         f"{tag} {len(info['chunks'])} chunk records for {T} turns")
    need([r["window"] for r in w] == list(range(len(w))) and sum(r["turns"] for r in w) == T
         and all(not r["partial"] for r in w[:-1]) and sunk == w,
         f"{tag} the window stream has gaps, or the sink missed a window")
    need(cal["requests"] == T * LOAD_BATCH and 0 < cal["completed"] <= cal["requests"]
         and 0 < cal["p50"] <= cal["p99"] <= cal["p999"] < math.inf
         and math.isfinite(lam.get("mean", math.nan)), f"{tag} bad whole-horizon report {cal}")
    per_replay = by_wrapper(info["graph_kernels"])
    for name in ("ppot_dispatch_fused_alias", "alias_table", "pool_chain"):
        need(per_replay[name] > 0 and launches[name] > 0, f"{tag} no {name} in the graph")
    # the graph the run replayed, again from a fresh router on the first turns
    cfg = tsl.scan_config(router, LOAD_BATCH, fake_cost=scn.request_cost * 0.25,
                          pend_cap=LOAD_PEND_CAP, comp_cap=LOAD_COMP_CAP, observe=ocfg)
    run = tsl.runner(cfg, str(dev), LOAD_CHUNK)
    need(run.replays >= T, f"{tag} the profiled runner is not the run's")
    first = next(tload.ScenarioStream(scn, seed=SEED, arrival_batch=LOAD_BATCH)
                 .chunks(LOAD_PROFILE_TURNS))
    run.load(load_router(tr, speeds, dev), tr.SimulatedPool(speeds))
    W = LOAD_PROFILE_TURNS
    prof = device_profile(torch, lambda: run.run_rows(
        dict(times=first.times, costs=first.costs, speeds=first.speeds)))
    in_replay = {wr: 0.0 for wr in PROFILE_NAMES}
    for name, us in prof["us"].items():
        if wrapper_of(name) is not None:
            in_replay[wrapper_of(name)] += us / 1e3 / W
    rec = dict(requests=sus["requests_total"], turns=T, chunks=sus["n_chunks"],
               trace_dropped=info["trace_dropped"], wall_s=wall,
               decs_series=sus["decs_series"], decs_sustained=sus["decs_sustained"],
               decs_min=sus["decs_min"], decs_max=sus["decs_max"],
               turns_per_s=(T - info["chunks"][0]["turns"]) / (
                   sus["run_s_total"] - info["chunks"][0]["run_s"]),
               gen_s_total=sus["gen_s_total"], run_s_total=sus["run_s_total"],
               rss_mb_series=sus["rss_mb_series"], rss_mb_growth=sus["rss_mb_growth"],
               rss_mb_peak=sus["rss_mb_peak"], windows=len(w),
               p50=cal["p50"], p99=cal["p99"], p999=cal["p999"], mean_est=cal["mean_est"],
               completed=cal["completed"], lam_calibration=lam, capture_s=info["capture_s"],
               graph_nodes=info["graph_nodes"], graph_kernels=per_replay,
               flush_overflow=info["flush_overflow"], pend_overflow=info["pend_overflow"],
               busy_ms_per_turn=prof["busy_us"] / 1e3 / W, idle=prof["idle"],
               launches_per_turn_profiled=prof["launches"] / W, in_replay_ms=in_replay,
               launches=launches, longest_chain=info["longest_chain"])
    print(f"{tag} {card}; full run: {rec['requests']} requests in {T} turns ({rec['chunks']} "
          f"chunks of {LOAD_CHUNK}, partial tail batch of {rec['trace_dropped']} dropped), "
          f"n={scn.n}, overflows flush {info['flush_overflow']} pend {info['pend_overflow']}; "
          f"wall {wall:.3f} s, gen_s total {rec['gen_s_total']:.6f}, run_s total "
          f"{rec['run_s_total']:.6f}")
    print(f"{tag} decisions/s per chunk (chunk 0 first, out of the sustained figure): "
          f"{json.dumps([round(d, 1) for d in sus['decs_series']])}; sustained "
          f"{sus['decs_sustained']:.1f} decisions/s ({rec['turns_per_s']:.2f} turns/s), min "
          f"{sus['decs_min']:.1f} max {sus['decs_max']:.1f}")
    print(f"{tag} RSS MB per chunk {json.dumps([round(r, 2) for r in sus['rss_mb_series']])}: "
          f"growth after chunk 1 {sus['rss_mb_growth']:.3f} MB, peak {sus['rss_mb_peak']:.2f}")
    print(f"{tag} whole horizon from {len(w)} windows of {LOAD_WINDOW} turns: p50 "
          f"{cal['p50']:.6f} p99 {cal['p99']:.6f} p999 {cal['p999']:.6f} s, mean "
          f"{cal['mean_est']:.6f} s, completed {cal['completed']} of {cal['requests']}; lambda "
          f"calibration {json.dumps({k: round(v, 6) for k, v in lam.items()})}")
    print(f"{tag} capture {info['capture_s']:.3f} s, graph nodes {info['graph_nodes']}, kernel "
          f"nodes {json.dumps(graph_kernel_summary(info['graph_kernels']))} (by wrapper "
          f"{json.dumps(per_replay)}); longest chain {info['longest_chain']}; {W} replays "
          f"profiled: busy {rec['busy_ms_per_turn']:.4f} ms a turn, idle share "
          f"{prof['idle']:.4f}, {rec['launches_per_turn_profiled']:.2f} launches a turn, "
          f"device ms a replay by kernel "
          + ", ".join(f"{k} {v:.6f}" for k, v in in_replay.items() if v)
          + f"; launches of the run {json.dumps(launches)}")
    rec["mu_final"] = router.mu_front
    return rec


def load_parity(torch, tr, tsl, tload, obs, K, CK, Scenario, dev, use_alias: bool,
                emit: bool) -> tuple[dict, dict]:
    """(b) LOAD_CHECK_HORIZON seconds of the stream through run_stream_scan
    in chunks of LOAD_CHUNK, and through run_workload_scan on the same chunks
    concatenated (its own capture, one chunk): responses and μ̂ trace (when
    ``emit``), window records and the final router and pool state equal bit
    for bit."""
    tag = f"[load {'alias' if use_alias else 'icdf'}{'' if emit else ' stream-only'}]"
    scn = load_scenario(Scenario, tload.AzureLikeTrace, LOAD_CHECK_HORIZON)
    speeds = np.asarray(scn.speeds, float)
    ocfg = obs.ObserveConfig(window_turns=LOAD_WINDOW, emit_responses=emit)
    kw = dict(fake_cost=scn.request_cost * 0.25, pend_cap=LOAD_PEND_CAP,
              comp_cap=LOAD_COMP_CAP, observe=ocfg)
    K.reset_launches()
    CK.reset_launches()
    r1, p1 = load_router(tr, speeds, dev, use_alias), tr.SimulatedPool(speeds)
    got = tload.run_stream_scan(r1, p1, tload.ScenarioStream(scn, seed=SEED,
                                                             arrival_batch=LOAD_BATCH),
                                chunk_turns=LOAD_CHUNK, **kw)
    launches = scan_launches(K, CK, got[2])
    parts = list(tload.ScenarioStream(scn, seed=SEED, arrival_batch=LOAD_BATCH)
                 .chunks(LOAD_CHUNK))
    cols = {f: np.concatenate([getattr(c, f) for c in parts]) for f in ("times", "costs",
                                                                         "speeds")}
    K.reset_launches()
    CK.reset_launches()
    r0, p0 = load_router(tr, speeds, dev, use_alias), tr.SimulatedPool(speeds)
    want = tsl.run_workload_scan(r0, p0, cols["times"], cols["costs"], cols["speeds"], **kw)
    mono = scan_launches(K, CK, want[2])
    T = len(cols["times"])
    for part, ok in (("turns", got[2]["turns"] == want[2]["turns"] == T == got[2]["replays"]),
                     ("responses", np.array_equal(got[0], want[0])),
                     ("mu trace", np.array_equal(got[1], want[1])),
                     ("overflow", got[2]["flush_overflow"] == got[2]["pend_overflow"] == 0)):
        need(ok, f"{tag} chunked and monolithic differ: {part}")
    need(got[0].shape == ((T * LOAD_BATCH,) if emit else (0,)), f"{tag} responses "
         f"{got[0].shape}")
    obs_records_equal(tag, got[2]["windows"], want[2]["windows"])
    same_final_state(torch, tag, r1, p1, r0, p0)
    per_replay = by_wrapper(got[2]["graph_kernels"])
    k = "ppot_dispatch_fused_alias" if use_alias else "ppot_dispatch_fused"
    need(per_replay[k] > 0 and launches[k] > 0, f"{tag} no {k} in the graph")
    print(f"{tag} {T} turns, {T * LOAD_BATCH} requests in {len(parts)} chunks of {LOAD_CHUNK}: "
          f"run_stream_scan equal to run_workload_scan over the chunks concatenated (its own "
          f"capture of {T} rows){', responses and mu trace' if emit else ''}, "
          f"{len(got[2]['windows'])} windows and the final router and pool state bit for bit; "
          f"graph nodes {got[2]['graph_nodes']} / {want[2]['graph_nodes']}, kernels by wrapper "
          f"{json.dumps(per_replay)}")
    total = {wr: launches[wr] + mono[wr] for wr in PROFILE_NAMES}
    return dict(turns=T, graph_nodes=got[2]["graph_nodes"], graph_kernels=per_replay,
                launches=total), total


def load_faults(torch, tr, tsl, tenv, tload, obs, trcv, K, CK, met, speeds, dev,
                caps) -> tuple[dict, dict]:
    """(c) crash_storm at the [faults] cell's scaling and capacities, recovery
    as armed there, cut to LOAD_FAULT_HORIZON: a ScenarioStream in chunks of
    LOAD_FAULT_CHUNK with windows of OBS_WINDOW (coprime) and the stream's
    fixed burst width, against the monolithic faulty scan on the burst
    padded to that width: responses (NaN = lost), μ̂ trace, windows,
    ledger, free_at and the final state equal bit for bit; conserved."""
    tag = "[load crash_storm stream]"
    rate = LOAD * float(speeds.sum())
    scn = tenv.make("crash_storm", speeds=tuple(speeds), rate=rate, horizon=LOAD_FAULT_HORIZON)
    wl = scn.compile_serving(seed=SEED, arrival_batch=BATCH)
    rc = trcv.RecoveryConfig(**FAULT_RECOVERY)
    ocfg = obs.ObserveConfig(window_turns=OBS_WINDOW)
    need(math.gcd(LOAD_FAULT_CHUNK, OBS_WINDOW) == 1, f"{tag} chunk and window not coprime")
    kw = dict(fake_cost=scn.request_cost * 0.25, recovery=rc, observe=ocfg, **caps)
    stream = tload.ScenarioStream(scn, seed=SEED, arrival_batch=BATCH)

    def router():
        return tr.RosellaRouter(scn.n, float(np.sum(scn.speeds)), seed=SEED, use_alias=True,
                                async_mu=False, device=dev)
    K.reset_launches()
    CK.reset_launches()
    r1, p1 = router(), tr.SequentialPool(np.asarray(scn.speeds, float))
    t0 = time.perf_counter()
    got = tload.run_stream_scan(r1, p1, stream, chunk_turns=LOAD_FAULT_CHUNK,
                                task_cap=wl.turns * BATCH, **kw)
    wall = time.perf_counter() - t0
    launches = scan_launches(K, CK, got[2])
    burst = np.full((wl.turns, stream.burst_cap), -1, np.int32)
    burst[:, :wl.burst.shape[1]] = wl.burst
    K.reset_launches()
    CK.reset_launches()
    r0, p0 = router(), tr.SequentialPool(np.asarray(scn.speeds, float))
    want = tsl.run_workload_scan(r0, p0, wl.times, wl.costs, wl.speeds, active_np=wl.active,
                                 rejoin_np=wl.rejoin, burst_np=burst, kill_np=wl.kill_at,
                                 stall_np=wl.stall_at, stall_dur_np=wl.stall_dur, **kw)
    mono = scan_launches(K, CK, want[2])
    gi, led = got[2], got[2]["ledger"]
    for part, ok in (("turns", gi["turns"] == want[2]["turns"] == wl.turns == gi["replays"]),
                     ("responses", np.array_equal(got[0], want[0], equal_nan=True)),
                     ("mu trace", np.array_equal(got[1], want[1])),
                     ("ledger", led == want[2]["ledger"]),
                     ("overflow", gi["flush_overflow"] == gi["pend_overflow"] == 0)):
        need(ok, f"{tag} chunked and monolithic differ: {part}")
    obs_records_equal(tag, gi["windows"], want[2]["windows"])
    same_final_state(torch, tag, r1, p1, r0, p0)
    ok, residuals = met.check_conservation(led)
    need(ok and led["conserved"], f"{tag} the ledger does not conserve: {residuals}")
    need(led["lost_tasks"] > 0 and led["n_retries"] > 0, f"{tag} nothing lost or retried")
    per_replay = by_wrapper(gi["graph_kernels"])
    for k in ("ppot_dispatch_fused_alias", "alias_table", "pool_chain"):
        need(per_replay[k] > 0 and launches[k] > 0, f"{tag} no {k} in the graph")
    rep = met.fault_report(got[0], led, horizon=LOAD_FAULT_HORIZON)
    print(f"{tag} n={scn.n} batch={BATCH}, recovery {json.dumps(FAULT_RECOVERY)}, "
          f"{wl.turns} turns in chunks of {LOAD_FAULT_CHUNK}, windows of {OBS_WINDOW}, burst "
          f"width {stream.burst_cap} (the compile's {wl.burst.shape[1]}), task_cap "
          f"{wl.turns * BATCH}, pend_cap {caps['pend_cap']} comp_cap {caps['comp_cap']}: "
          f"equal to the monolithic faulty scan (responses with NaN, mu trace, "
          f"{len(gi['windows'])} windows, ledger, free_at, final state), conserved; lost "
          f"{led['lost_tasks']} (loss rate {rep['loss_rate']:.6f}), retries "
          f"{led['n_retries']}, p99 {rep['p99']:.6f} s; {wall:.3f} s, capture "
          f"{gi['capture_s']:.3f} s, graph nodes {gi['graph_nodes']}, kernel nodes "
          f"{json.dumps(graph_kernel_summary(gi['graph_kernels']))} (by wrapper "
          f"{json.dumps(per_replay)}), longest "
          f"chain {gi['longest_chain']}")
    total = {wr: launches[wr] + mono[wr] for wr in PROFILE_NAMES}
    return dict(turns=wl.turns, seconds=wall, graph_nodes=gi["graph_nodes"],
                graph_kernels=per_replay, burst_cap=stream.burst_cap, ledger=led,
                loss_rate=rep["loss_rate"], launches=total), total


def phase_load(torch, tr, tsl, tenv, tload, obs, trcv, chk, D, K, CK, CR, met, speeds, dev,
               card, faults) -> tuple[dict, dict, float]:
    """The [load] cells; returns the records, the phase's launches by wrapper
    and pool_chain's largest error at the path's shapes."""
    from repro_torch.env.scenario import Scenario

    t0 = time.perf_counter()
    print(f"[load] {card}; {LOAD_TILES} x {LOAD_SPEED_TILE} workers, base rate {LOAD_RATE}, "
          f"AzureLikeTrace({json.dumps(LOAD_TRACE)}), horizon {LOAD_HORIZON} s, batches of "
          f"{LOAD_BATCH}, chunk_turns {LOAD_CHUNK}, pend_cap {LOAD_PEND_CAP}, comp_cap "
          f"{LOAD_COMP_CAP}, stream-only windows of {LOAD_WINDOW} turns, PPoT-SQ(2) alias, "
          f"async_mu=False, seed {SEED}")
    full = load_full(torch, tr, tsl, tload, obs, K, CK, met, Scenario, dev, card)
    total = dict(full["launches"])
    parity = {}
    for use_alias, emit in ((True, True), (False, True), (True, False)):
        key = f"{'alias' if use_alias else 'icdf'}{'' if emit else ' stream-only'}"
        parity[key], launches = load_parity(torch, tr, tsl, tload, obs, K, CK, Scenario, dev,
                                            use_alias, emit)
        for w in PROFILE_NAMES:
            total[w] += launches[w]
    src = faults["cells"]["crash_storm alias"]
    fault, launches = load_faults(torch, tr, tsl, tenv, tload, obs, trcv, K, CK, met, speeds,
                                  dev, dict(pend_cap=src["pend_cap"], comp_cap=src["comp_cap"]))
    for w in PROFILE_NAMES:
        total[w] += launches[w]
    rc = trcv.RecoveryConfig(**FAULT_RECOVERY)
    err = load_kernels(torch, chk, CK, CR, D, dev, full.pop("mu_final"), len(speeds),
                       fault["burst_cap"], rc.retry_cap + rc.spec_cap,
                       LOAD_BATCH + rc.retry_cap)
    secs = time.perf_counter() - t0
    print(f"[load] the full run, {len(parity)} chunked = monolithic checks and the fault "
          f"stream in {secs:.1f} s; launches {json.dumps(total)}")
    return dict(full=full, parity=parity, faults=fault, seconds=secs), total, err


# ---------------------------------------------------------------------------
# the chain simulator: the paper's figures through sim_chain
# ---------------------------------------------------------------------------

SIM_SOURCE = "src/repro_torch/kernels/sim_chain/csrc/sim_chain.cu"
# not a Pallas kernel: the round function under the chain's lax.scan
SIM_REPLACES = "src/repro/core/simulator.py:553-743"
SIM_CHECK_ROUNDS = 4000
# the kernels line's fixed case: Fig. 8's static Rosella run cut to this
# many rounds, where the plain chain on the card is timed too
SIM_LINE_ROUNDS = 2000
SIM_LINE_REPS = 20
SIM_PLAIN_CARD_ROUNDS = 300
# the chain's serial floor in cycles a round: the f32 add of the clock,
# now += dt, the one dependence every round has on the one before
SIM_CHAIN_CYCLES = 4
FIG9_PROBS = [0.4, 0.3, 0.2, 0.1]


def sim_run(RS, dev, policy, speeds, load, rounds, *, learner, fake=None, phases=0,
            period=120.0, alias=True, bsc=True, mt=1, probs=None, pins=0.0, c_window=10.0,
            seed=SEED, key=None):
    """(cfg, params, key) of one chain: ``make_sim`` at the benchmarks'
    arguments; ``key`` the run's PRNG seed (the benchmarks use ``seed``)."""
    import dataclasses

    from repro_torch.utils import prng

    cfg, params = RS.make_sim(policy, speeds, load, rounds=rounds, use_learner=learner,
                              use_fake_jobs=learner if fake is None else fake,
                              volatile_phases=phases, phase_period=period, c_window=c_window,
                              max_tasks=mt, task_probs=probs, constrained_frac=pins,
                              seed=seed, device=dev)
    cfg = dataclasses.replace(cfg, use_alias=alias, batch_self_correct=bsc)
    return cfg, params, prng.PRNGKey(seed if key is None else key)


def sim_check_groups(RS, dev) -> dict:
    """The kernel = plain cases, SIM_CHECK_ROUNDS rounds each, by launch."""
    tpch, zipf = RS.tpch_speed_set(30, SEED), RS.zipf_speeds(15, seed=SEED)
    R = SIM_CHECK_ROUNDS
    return {
        "rosella (6.1 speeds, load 0.8)": [
            (f"{env} {'alias' if alias else 'cdf'}",
             sim_run(RS, dev, "ppot_sq2", tpch, 0.8, R, learner=True, phases=phases,
                     alias=alias))
            for env, phases in (("static", 0), ("volatile", 6)) for alias in (True, False)],
        "fig 9 jobs (1-4 tasks, 10% pinned)": [
            (f"{policy} bsc={bsc}",
             sim_run(RS, dev, policy, tpch, 0.8, R, learner=learner, mt=4, probs=FIG9_PROBS,
                     pins=0.1, bsc=bsc))
            for policy, learner in (("ppot_sq2", True), ("sparrow", False), ("bandit", True))
            for bsc in (True, False)],
        "known speeds (zipf 15, load 0.9)": [
            (policy, sim_run(RS, dev, policy, zipf, 0.9, R, learner=False))
            for policy in ("pot", "pss", "halo", "ppot_ll2")],
    }


def sim_figures(RS, dev) -> dict:
    """The figures at the settings of benchmarks/fig8_response_time.py ...
    fig13_sq2_ll2.py, written out again: label -> [(run label, run,
    warmup)], one launch each."""
    tpch, zipf = RS.tpch_speed_set(30, seed=SEED), RS.zipf_speeds(15, seed=SEED)
    s1, s2 = RS.synthetic_s1(), RS.synthetic_s2()
    figs = {}
    figs["fig8"] = [
        (f"{env}/{name}", sim_run(RS, dev, policy, tpch, 0.8, 120_000, learner=learner,
                                  phases=phases, period=120.0), 0.3)
        for env, phases in (("static", 0), ("volatile", 6))
        for name, policy, learner in (("rosella", "ppot_sq2", True),
                                      ("sparrow", "sparrow", False))]
    figs["fig9"] = [
        (f"{env}/{name}", sim_run(RS, dev, policy, tpch, 0.8, 100_000, learner=learner,
                                  fake=fake, phases=phases, period=120.0, mt=4,
                                  probs=FIG9_PROBS, pins=0.1), 0.3)
        for env, phases in (("static", 0), ("volatile", 6))
        for name, policy, learner, fake in (("sparrow", "sparrow", False, False),
                                            ("pot", "pot", False, False),
                                            ("bandit", "bandit", True, True),
                                            ("pss_learn", "pss", True, True),
                                            ("rosella", "ppot_sq2", True, True))]
    figs["fig10"] = [
        (f"10a/{name}", sim_run(RS, dev, policy, zipf, 0.9, 80_000, learner=False), 0.0)
        for name, policy in (("pot", "pot"), ("ppot", "ppot_sq2"), ("pss", "pss"))] + [
        (f"10b/{load}/{name}", sim_run(RS, dev, policy, zipf, load, 40_000, learner=False),
         0.3)
        for load in (0.5, 0.7, 0.9)
        for name, policy in (("ppot", "ppot_sq2"), ("pss", "pss"), ("halo", "halo"),
                             ("pot", "pot"))]
    figs["fig11"] = [
        (f"{sname}/{load}/{name}", sim_run(RS, dev, policy, sp, load, 90_000,
                                           learner=learner, fake=fake, phases=8,
                                           period=60.0), 0.3)
        for sname, sp in (("S1", s1), ("S2", s2)) for load in (0.6, 0.85)
        for name, policy, learner, fake in (("pot", "pot", False, False),
                                            ("bandit", "bandit", True, True),
                                            ("pss_learn", "pss", True, True),
                                            ("rosella", "ppot_sq2", True, True))]
    figs["fig12"] = [
        (f"{sname}/{name}", sim_run(RS, dev, "ppot_sq2", sp, 0.85, 90_000, learner=True,
                                    fake=fake, c_window=c, phases=8, period=60.0), 0.3)
        for sname, sp in (("S1", s1), ("S2", s2))
        for name, fake, c in [("fake", True, 10.0)] + [(f"w{c}", False, float(c))
                                                       for c in (10, 20, 30, 40)]]
    figs["fig13"] = [
        (name, sim_run(RS, dev, policy, s1, 0.85, 120_000, learner=False), 0.3)
        for name, policy in (("sq2", "ppot_sq2"), ("ll2", "ppot_ll2"))]
    return figs


def response_stats(m, censor_penalty=None) -> dict:
    """benchmarks/common.py's summary of an ``analyze`` record."""
    r = m.response_times
    out = {"n": int(m.num_jobs), "censored_frac": m.censored / max(m.num_jobs, 1)}
    if censor_penalty is not None and m.censored:
        r = np.concatenate([r, np.full(m.censored, censor_penalty)])
    if r.size:
        out.update(mean=float(np.mean(r)), p5=float(np.percentile(r, 5)),
                   p25=float(np.percentile(r, 25)), p50=float(np.percentile(r, 50)),
                   p75=float(np.percentile(r, 75)), p95=float(np.percentile(r, 95)))
    else:
        out.update(mean=float("inf"), p5=0, p25=0, p50=0, p75=0, p95=float("inf"))
    return out


def figure_claims(fig: str, runs: dict) -> list:
    """Each claim the benchmark prints, with its truth value and figures."""
    st = {k: r["stats"] for k, r in runs.items()}
    if fig == "fig8":
        return [("rosella_beats_sparrow static (mean < 0.5 x sparrow's)",
                 st["static/rosella"]["mean"] < 0.5 * st["static/sparrow"]["mean"]),
                ("rosella_beats_sparrow volatile",
                 st["volatile/rosella"]["mean"] < st["volatile/sparrow"]["mean"])]
    if fig == "fig9":
        best = min((k for k in st if "static" in k), key=lambda k: st[k]["mean"])
        return [(f"rosella_best_static (best={best})", best == "static/rosella")]
    if fig == "fig10":
        a = {k: runs[k]["extra"] for k in runs if k.startswith("10a/")}
        out = [("pot_nonstationary at 0.9 (pot growth > 2 or censored > 0.2, ppot growth < 2)",
                (a["10a/pot"]["growth"] > 2.0 or a["10a/pot"]["censored"] > 0.2)
                and a["10a/ppot"]["growth"] < 2.0)]
        for load in (0.5, 0.7, 0.9):
            eff = {}
            for name in ("ppot", "pss", "halo", "pot"):
                s = st[f"10b/{load}/{name}"]
                eff[name] = s["mean"] if s["censored_frac"] < 0.05 else s["mean"] * (
                    1 + 20 * s["censored_frac"])
            out.append((f"ppot_best_load{load}", min(eff, key=eff.get) == "ppot"))
        return out
    if fig == "fig11":
        out = []
        for sname in ("S1", "S2"):
            for load in (0.6, 0.85):
                eff = {name: st[f"{sname}/{load}/{name}"]["mean"]
                       * (1 + 20 * st[f"{sname}/{load}/{name}"]["censored_frac"])
                       for name in ("pot", "bandit", "pss_learn", "rosella")}
                out.append((f"rosella_best_{sname}_load{load}",
                            min(eff, key=eff.get) == "rosella"))
        return out
    if fig == "fig12":
        out = []
        for sname in ("S1", "S2"):
            fake = st[f"{sname}/fake"]["mean"]
            best = min(st[f"{sname}/w{w}"]["mean"] for w in (10, 20, 30, 40))
            out.append((f"fake_jobs_help_{sname} (fake {fake:.4f}, best window {best:.4f})",
                        fake <= best * 1.05))
        return out
    ratio = {k: runs[k]["extra"]["ratio"] for k in runs}
    return [(f"ll2_congests_fast_worker (sq2 ratio {ratio['sq2']:.4f}, ll2 ratio "
             f"{ratio['ll2']:.4f})", ratio["ll2"] > 2.0 * ratio["sq2"])]


def sim_kernel_equals_plain(torch, tsim, groups, dev, tag="[sim]") -> dict:
    """Each group's draws made once on the card, the kernel run on them and
    the plain chain on the same draws copied to the CPU: every trace column
    and every field of the final state equal (the fleet's and the crash
    track's too, where a run has them). Also how the card's draws differ
    from the CPU's for the same keys. A run is (cfg, params, key) or
    (cfg, params, key, env)."""
    out = {}
    for gname, cases in groups.items():
        runs = [tuple(run) + (None,) * (4 - len(run)) for _, run in cases]
        t0 = time.perf_counter()
        draws = [tsim.draw_rounds(cfg, p, key, dev, env) for cfg, p, key, env in runs]
        got = tsim.simulate_many(runs, dev, draws)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        cpu_runs = [(cfg, p.to("cpu"), key, None if env is None else env.to("cpu"))
                    for cfg, p, key, env in runs]
        cpu_draws = [{k: v.cpu() for k, v in d.items()} for d in draws]
        want = tsim.simulate_many(cpu_runs, "cpu", cpu_draws)
        t2 = time.perf_counter()
        own = [tsim.draw_rounds(cfg, p, key, "cpu", env) for cfg, p, key, env in cpu_runs]
        diff = {"ev": 0, "n_tasks": 0, "dt_max_ulps": 0}
        err = 0.0
        for (label, _), (gs, gt), (ws, wt), d_card, d_cpu in zip(cases, got, want,
                                                                 cpu_draws, own):
            for name in wt:
                g, w = gt[name].cpu(), wt[name]
                if g.numel():
                    err = max(err, (g.double() - w.double()).abs().max().item())
                need(torch.equal(g, w),
                     f"{tag} {gname} {label}: sim_chain's {name} differs from the plain chain")
            for f in ("now", "q_real", "q_fake", "s_real", "busy_start"):
                need(torch.equal(getattr(gs, f).cpu(), getattr(ws, f)),
                     f"{tag} {gname} {label}: final {f} differs from the plain chain")
            for f in ("samples", "stamps", "widx", "count", "epoch_start", "mu_hat"):
                need(torch.equal(getattr(gs.learner, f).cpu(), getattr(ws.learner, f)),
                     f"{tag} {gname} {label}: final learner.{f} differs")
            for f in ("times", "idx", "count", "lam_hat"):
                need(torch.equal(getattr(gs.arr, f).cpu(), getattr(ws.arr, f)),
                     f"{tag} {gname} {label}: final arr.{f} differs")
            need((gs.fleet is None) == (ws.fleet is None),
                 f"{tag} {gname} {label}: one side kept no fleet state")
            if ws.fleet is not None:
                need(torch.equal(gs.crash_i.cpu(), ws.crash_i),
                     f"{tag} {gname} {label}: final crash_i differs")
                for f in ("q_snap", "q_delta", "mu_view", "alias_p", "alias_a", "t_sync",
                          "lam_global"):
                    need(torch.equal(getattr(gs.fleet, f).cpu(), getattr(ws.fleet, f)),
                         f"{tag} {gname} {label}: final fleet.{f} differs")
                for f in ("last_time", "mean_gap", "count"):
                    need(torch.equal(getattr(gs.fleet.arr, f).cpu(), getattr(ws.fleet.arr, f)),
                         f"{tag} {gname} {label}: final fleet.arr.{f} differs")
            for k in ("u_svc", "u_fake", "u", "j_fake", "pins", "j", "u_thin", "u_pin",
                      "u_jfake", "uj"):
                if k in d_card:
                    need(torch.equal(d_card[k], d_cpu[k]),
                         f"{tag} {gname} {label}: the card's {k} draws differ from the CPU's")
            for k in ("ev", "n_tasks"):  # categorical: torch's log on each device
                diff[k] += int((d_card[k] != d_cpu[k]).sum())
            a, b = d_card["dt"].numpy().view(np.int32), d_cpu["dt"].numpy().view(np.int32)
            diff["dt_max_ulps"] = max(diff["dt_max_ulps"],
                                      int(np.abs(a.astype(np.int64) - b).max()))
        rounds = sum(cfg.rounds for cfg, _, _, _ in runs)
        out[gname] = dict(chains=len(runs), rounds=rounds, card_s=t1 - t0, plain_cpu_s=t2 - t1,
                          max_abs_err=err, draws_card_vs_cpu=diff,
                          labels=[label for label, _ in cases])
        lengths = sorted({cfg.rounds for cfg, _, _, _ in runs})
        print(f"{tag} kernel = plain chain: {gname}: {len(runs)} chains x "
              f"{'/'.join(map(str, lengths))} rounds ({', '.join(out[gname]['labels'])}) in one "
              f"launch, every trace column and the final state equal bit for bit (card "
              f"{t1 - t0:.2f} s with its draws, plain chain on the CPU {t2 - t1:.2f} s); card "
              f"draws vs the CPU's for the same keys: uniforms and integer draws equal, "
              f"categorical ev {diff['ev']} / n_tasks {diff['n_tasks']} rounds differ, dt within "
              f"{diff['dt_max_ulps']} ulp")
    return out


def sim_figure(torch, tsim, fig, runs, dev) -> dict:
    """One figure's runs through one sim_chain launch, each analysed."""
    from repro_torch.core import metrics as M

    t0 = time.perf_counter()
    draws = [tsim.draw_rounds(cfg, p, key, dev) for _, (cfg, p, key), _ in runs]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    outs = tsim.simulate_many([run for _, run, _ in runs], dev, draws)
    e1.record()
    torch.cuda.synchronize()
    launch_s = e0.elapsed_time(e1) / 1e3
    t2 = time.perf_counter()
    rec = {}
    for (label, (cfg, params, _), warm), (_, tr) in zip(runs, outs):
        for name in ("now", "lam_hat", "mu_hat"):
            need(bool(torch.isfinite(tr[name]).all()), f"[sim] {fig} {label}: {name} not finite")
        need(tuple(tr["q_real"].shape) == (cfg.rounds, cfg.n)
             and tuple(tr["task_workers"].shape) == (cfg.rounds, cfg.max_tasks),
             f"[sim] {fig} {label}: trace shapes")
        m = M.analyze(tr, n=cfg.n, warmup_frac=warm)
        st = response_stats(m)
        r = {"rounds": cfg.rounds, "stats": st, "extra": {}}
        if fig == "fig8":
            rt = m.response_times
            slow = float(np.mean(rt > 20.0)) if rt.size else 1.0
            r["extra"]["frac_gt20"] = (slow * rt.size + m.censored) / max(rt.size + m.censored, 1)
        if fig == "fig10" and label.startswith("10a/"):
            rt = m.response_times
            half = max(len(rt) // 2, 1)
            r["extra"]["growth"] = (float(np.mean(rt[half:]) / max(np.mean(rt[:half]), 1e-9))
                                    if len(rt) > 10 else float("inf"))
            r["extra"]["censored"] = m.censored / max(m.num_jobs, 1)
        if fig == "fig13":  # the fastest and slowest workers' mean queues
            speeds = params.mu_schedule[0].cpu().numpy()
            fast, slow_w = int(np.argmax(speeds)), int(np.argmin(speeds))
            means = {}
            for w in (fast, slow_w):
                hist = M.queue_length_histogram(tr, w)
                means[w] = float(np.sum(np.arange(len(hist)) * hist))
            r["extra"] = {"fast_mean_q": means[fast], "slow_mean_q": means[slow_w],
                          "ratio": means[fast] / max(means[slow_w], 1e-3)}
        rec[label] = r
    t3 = time.perf_counter()
    claims = figure_claims(fig, rec)
    chains = len(runs)
    rounds = sum(r["rounds"] for r in rec.values())
    print(f"[sim] {fig}: {chains} chains in one launch, {launch_s * 1e3:.3f} ms, their "
          f"{rounds} rounds at {rounds / launch_s:.1f} rounds/s over the launch "
          f"(draws {t1 - t0:.3f} s, analyze {t3 - t2:.3f} s)")
    for label, r in rec.items():
        s = r["stats"]
        extra = "".join(f", {k} {v:.6g}" for k, v in r["extra"].items())
        print(f"[sim] {fig} {label}: {r['rounds']} rounds; jobs {s['n']}, mean {s['mean']:.6g}, "
              f"p50 {s['p50']:.6g}, "
              f"p95 {s['p95']:.6g}, censored {s['censored_frac']:.6g}{extra}")
    for claim, ok in claims:
        print(f"[sim] {fig} claim {claim}: {bool(ok)}")
    return dict(chains=chains, launch_ms=launch_s * 1e3, rounds=rounds,
                rounds_per_s=rounds / launch_s, draws_s=t1 - t0, analyze_s=t3 - t2, runs=rec,
                claims={c: bool(ok) for c, ok in claims})


def sim_theory(torch, tsim, RS, TH, dev) -> dict:
    """tests/test_theory.py at its settings (20 equal workers, load 0.8,
    80,000 rounds, seed 4, known speeds, no benchmark jobs), one launch:
    Lemma 4's doubly exponential tail and the max-queue gap, the
    reference's own assertions, must hold."""
    from repro_torch.core import metrics as M

    runs = [sim_run(RS, dev, policy, np.ones(20), 0.8, 80_000, learner=False, key=4)
            for policy in ("ppot_sq2", "pss")]
    (_, tp), (_, ts) = tsim.simulate_many(runs, dev)
    tail_ppot, tail_pss = M.stationary_tail(tp), M.stationary_tail(ts)

    def at(t, k):
        return float(t[k]) if k < len(t) else 0.0

    q_ppot, q_pss = int(tp["q_real"].max()), int(ts["q_real"].max())
    bound = TH.max_queue_ppot(20, 0.8)
    checks = {
        "tail k=3: ppot < 0.6 x pss": at(tail_ppot, 3) < 0.6 * at(tail_pss, 3) + 1e-9,
        "tail k=5: ppot < 0.05": at(tail_ppot, 5) < 0.05,
        "tail k=5: pss > ppot": at(tail_pss, 5) > at(tail_ppot, 5),
        "max queue: ppot <= pss": q_ppot <= q_pss,
        "max queue: ppot <= max_queue_ppot(20, 0.8) + 3": q_ppot <= bound + 3,
    }
    print(f"[sim] theory (20 equal workers, load 0.8, 80000 rounds, seed 4, known speeds): "
          f"P[q >= k] ppot {[round(at(tail_ppot, k), 6) for k in range(6)]}, pss "
          f"{[round(at(tail_pss, k), 6) for k in range(6)]} (alpha^(2^k-1) "
          f"{[round(float(TH.ppot_tail(0.8, k)), 6) for k in range(6)]}); max queue ppot "
          f"{q_ppot}, pss {q_pss}, max_queue_ppot(20, 0.8) = {bound}")
    for name, ok in checks.items():
        print(f"[sim] theory {name}: {ok}")
        need(ok, f"[sim] theory: {name} does not hold")
    return dict(tail_ppot=[at(tail_ppot, k) for k in range(6)],
                tail_pss=[at(tail_pss, k) for k in range(6)], max_q_ppot=q_ppot,
                max_q_pss=q_pss, max_queue_ppot=bound)


def phase_sim(torch, RS, TH, dev, card) -> tuple[dict, dict]:
    """The [sim] cells; returns the records and the main path's launches."""
    from repro_torch.core import simulator as tsim
    from repro_torch.kernels.sim_chain import kernel as SK

    t0 = time.perf_counter()
    print(f"[sim] {card}; the paper's chain in its own mode (one frontend synced every "
          f"round), through sim_chain, seed {SEED}")
    checks = sim_kernel_equals_plain(torch, tsim, sim_check_groups(RS, dev), dev)
    figures = sim_figures(RS, dev)
    SK.reset_launches()
    figs = {fig: sim_figure(torch, tsim, fig, runs, dev) for fig, runs in figures.items()}
    theory = sim_theory(torch, tsim, RS, TH, dev)
    launches = SK.launch_counts()
    need(launches["sim_chain"] == len(figures) + 1,
         f"[sim] sim_chain launched {launches['sim_chain']} times on the main path, "
         f"expected one a figure and one for the theory checks")
    secs = time.perf_counter() - t0
    print(f"[sim] {len(checks)} kernel = plain launches, {len(figs)} figures "
          f"({sum(f['chains'] for f in figs.values())} chains) and the theory checks in "
          f"{secs:.1f} s; main-path launches {json.dumps(launches)}")
    return dict(checks=checks, figures=figs, theory=theory, seconds=secs), launches


# the environment, fault and fleet modes (ROADMAP A8b)
SIM_EXT_CHECK_ROUNDS = 2000
# benchmarks/fleet_scale.py's _staleness_sweep at its full settings
SIM_FLEET_ROUNDS = 60_000
SIM_FLEET_S = 4
SIM_FLEET_SYNCS = (1, 4, 16, 64, 256)
SIM_ENV_HORIZON = 360.0
# the rounds [sim env]'s hold runs past its chain's events (~25 s at R ~ 20)
SIM_ENV_HOLD_MARGIN = 500


def sim_ext_check_groups(RS, tenv, dev) -> dict:
    """The kernel = plain cases of the new modes, by launch: every
    environment scenario with a track of its own on the registry's cluster
    (n = 5; churn also at S = 4, sync 64, herd), and §6.1's 30 speeds at
    S = 4, sync 4 under the herd correction, the weighted and the sticky
    load balancer."""
    import dataclasses

    from repro_torch.utils import prng

    R = SIM_EXT_CHECK_ROUNDS
    env = []
    for i, name in enumerate(("flash_crowd", "reshuffle", "churn", "churn_heavy", "blackout",
                              "crash_storm", "grey_failure")):
        cfg, params, e = tenv.make(name).to_sim("ppot_sq2", rounds=R, device=dev)
        env.append((name, (cfg, params, prng.PRNGKey(SEED + i), e)))
    cfg, params, e = tenv.make("churn").to_sim("ppot_sq2", rounds=R, device=dev, n_frontends=4,
                                               fleet_sync_every=64, fleet_herd_correction=True)
    env.append(("churn S=4 sync 64 herd", (cfg, params, prng.PRNGKey(SEED), e)))
    tpch = RS.tpch_speed_set(30, SEED)
    fleet = []
    for label, herd, lb in (("herd", True, "uniform"), ("weighted", False, "weighted"),
                            ("sticky", False, "sticky")):
        cfg, params = RS.make_sim("ppot_sq2", tpch, 0.8, rounds=R, n_frontends=4,
                                  fleet_sync_every=4, fleet_herd_correction=herd, device=dev)
        if lb == "weighted":
            params = dataclasses.replace(params, lb_weights=params.lb_weights.new_tensor(
                [6.0, 1.0, 1.0, 1.0]))
        fleet.append((label, (dataclasses.replace(cfg, frontend_lb=lb), params,
                              prng.PRNGKey(SEED))))
    return {"environments (registry cluster, n = 5)": env,
            "fleet (6.1 speeds, S = 4, sync 4)": fleet}


SIM_FLEET_SETTINGS = [(se, False) for se in SIM_FLEET_SYNCS] + [(SIM_FLEET_SYNCS[-1], True)]


def sim_fleet_runs(RS, dev) -> list:
    """The staleness sweep's runs, one a (sync cadence, herd) setting."""
    from repro_torch.utils import prng

    speeds = RS.tpch_speed_set(30, seed=SEED)
    runs = []
    for se, herd in SIM_FLEET_SETTINGS:
        cfg, params = RS.make_sim("ppot_sq2", speeds, 0.8, rounds=SIM_FLEET_ROUNDS, seed=SEED,
                                  n_frontends=SIM_FLEET_S, fleet_sync_every=se,
                                  fleet_herd_correction=herd, device=dev)
        runs.append((cfg, params, prng.PRNGKey(SEED)))
    return runs


def sim_fleet_sweep(torch, tsim, RS, met, dev) -> tuple[dict, tuple]:
    """[sim fleet]: benchmarks/fleet_scale.py's _staleness_sweep at its full
    settings, six chains in one sim_chain launch; returns the record and
    the launch's (runs, draws, outputs)."""
    from repro_torch.fleet import fleet_lam_hats

    lam = 0.8 * float(RS.tpch_speed_set(30, seed=SEED).sum())
    settings = SIM_FLEET_SETTINGS
    runs = sim_fleet_runs(RS, dev)
    t0 = time.perf_counter()
    draws = [tsim.draw_rounds(c, p, k, dev) for c, p, k in runs]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    outs = tsim.simulate_many(runs, dev, draws)
    e1.record()
    torch.cuda.synchronize()
    launch_ms = e0.elapsed_time(e1)
    t2 = time.perf_counter()
    rec, base = {}, None
    for (se, herd), (cfg, _, _), (final, tr) in zip(settings, runs, outs):
        for name in ("now", "lam_hat", "mu_hat", "sync_age"):
            need(bool(torch.isfinite(tr[name]).all()), f"[sim fleet] sync {se}: {name} not finite")
        m = met.analyze(tr, n=cfg.n, warmup_frac=0.3)
        fs = met.fleet_summary_from_trace(
            tr, n_frontends=SIM_FLEET_S, sync_every=se,
            lam_hat_frontends=fleet_lam_hats(final.fleet).cpu().numpy(), lam_true=lam)
        need(m.response_times.size > 0, f"[sim fleet] sync {se}: no completed job")
        p50 = float(np.percentile(m.response_times, 50))
        p99 = float(np.percentile(m.response_times, 99))
        if se == 1 and not herd:
            base = (p50, p99)
        key = f"sync{se}" + ("_herd" if herd else "")
        rec[key] = dict(sync_every=se, herd=herd, p50=p50, p99=p99, p50_inflation=p50 / base[0],
                        p99_inflation=p99 / base[1], censored=m.censored, jobs=m.num_jobs,
                        collision_rate=fs["collision_rate"],
                        gap_mean=fs.get("staleness", {}).get("gap_mean"),
                        lam_cal_mean_rel_err=fs["lam_calibration_rel_err"]["mean"])
    t3 = time.perf_counter()
    rounds = sum(cfg.rounds for cfg, _, _ in runs)
    plain = [rec[f"sync{se}"]["p99"] for se in SIM_FLEET_SYNCS]
    claims = {"p99 rises with the sync cadence (sync 256 above sync 1)": plain[-1] > plain[0],
              "p99 rises at every step of the cadence": all(b >= a for a, b in zip(plain,
                                                                                   plain[1:]))}
    print(f"[sim fleet] benchmarks/fleet_scale.py's staleness sweep: 6.1's 30 speeds (seed "
          f"{SEED}), load 0.8, {SIM_FLEET_ROUNDS} rounds, S = {SIM_FLEET_S}, Rosella; "
          f"{len(runs)} chains in one launch {launch_ms:.6f} ms, their {rounds} rounds at "
          f"{rounds / (launch_ms / 1e3):.1f} rounds/s over the launch (draws {t1 - t0:.3f} s, "
          f"analyze + fleet_summary {t3 - t2:.3f} s)")
    for key, r in rec.items():
        print(f"[sim fleet] {key}: p50 {r['p50']:.6g} p99 {r['p99']:.6g} (inflation vs sync 1: "
              f"p50 {r['p50_inflation']:.4f}, p99 {r['p99_inflation']:.4f}), jobs {r['jobs']}, "
              f"censored {r['censored']}, collision rate {r['collision_rate']:.6f}, mean staleness "
              f"gap {r['gap_mean']:.6f}, lam_hat calibration mean rel err "
              f"{r['lam_cal_mean_rel_err']:.6f}")
    for claim, ok in claims.items():
        print(f"[sim fleet] claim {claim}: {ok}")
    return dict(launch_ms=launch_ms, rounds=rounds, rounds_per_s=rounds / (launch_ms / 1e3),
                draws_s=t1 - t0, analyze_s=t3 - t2, sweep=rec, claims=claims), \
        (runs, draws, outs)


def sim_env_runs(tsim, RS, tenv, dev, observe=None, null: bool = False) -> tuple[list, list]:
    """(names, runs) of the registry's scenarios through to_sim at the paper's
    cluster (6.1's 30 speeds, rate 0.8 x their sum) over the registry's 360 s,
    each chain long enough to pass the horizon (1.1·360·R + 1000 rounds),
    with ``observe``; the null scenario only if ``null``."""
    import dataclasses

    from repro_torch.utils import prng

    speeds = RS.tpch_speed_set(30, seed=SEED)
    rate = 0.8 * float(speeds.sum())
    runs, names = [], []
    for name in tenv.names():
        scn = tenv.make(name, speeds=tuple(speeds), rate=rate)
        if scn.is_null and not null:
            continue
        cfg, params, e = scn.to_sim("ppot_sq2", rounds=1, device=dev, observe=observe)
        R = float(tsim.rates_of(cfg, params, e)[0])
        cfg = dataclasses.replace(cfg, rounds=int(np.ceil(SIM_ENV_HORIZON * R * 1.1)) + 1000)
        runs.append((cfg, params, prng.PRNGKey(SEED), e))
        names.append(name)
    return names, runs


def sim_env_scenarios(torch, tsim, RS, tenv, met, dev) -> tuple[dict, tuple]:
    """[sim env]: every non-null registry scenario through to_sim at the
    paper's cluster (``sim_env_runs``), all in one sim_chain launch;
    crash_storm must kill jobs and churn none. Returns the record and the
    launch's (names, runs, draws, outputs), which [sim obs] holds."""
    speeds = RS.tpch_speed_set(30, seed=SEED)
    rate = 0.8 * float(speeds.sum())
    names, runs = sim_env_runs(tsim, RS, tenv, dev)
    t0 = time.perf_counter()
    draws = [tsim.draw_rounds(c, p, k, dev, e) for c, p, k, e in runs]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    outs = tsim.simulate_many(runs, dev, draws)
    e1.record()
    torch.cuda.synchronize()
    launch_ms = e0.elapsed_time(e1)
    t2 = time.perf_counter()
    rec = {}
    for name, (cfg, _, _, e), (final, tr) in zip(names, runs, outs):
        for col in ("now", "lam_hat", "mu_hat"):
            need(bool(torch.isfinite(tr[col]).all()), f"[sim env] {name}: {col} not finite")
        end = float(tr["now"][-1])
        need(end > SIM_ENV_HORIZON, f"[sim env] {name}: {cfg.rounds} rounds end at {end:.3f} s, "
             f"before the {SIM_ENV_HORIZON} s horizon")
        m = met.analyze(tr, n=cfg.n)
        need(m.response_times.size > 0, f"[sim env] {name}: no completed job")
        rt = m.response_times
        rec[name] = dict(rounds=cfg.rounds, end_s=end, jobs=m.num_jobs, censored=m.censored,
                         killed_jobs=m.killed_jobs, mean=float(np.mean(rt)),
                         p50=float(np.percentile(rt, 50)), p99=float(np.percentile(rt, 99)),
                         crashes=int(final.crash_i))
    t3 = time.perf_counter()
    rounds = sum(cfg.rounds for cfg, _, _, _ in runs)
    need(rec["crash_storm"]["killed_jobs"] > 0, "[sim env] crash_storm killed no job")
    need(rec["churn"]["killed_jobs"] == 0, "[sim env] churn killed a job: departures must drain")
    print(f"[sim env] {len(runs)} registry scenarios through to_sim at 6.1's 30 speeds, rate "
          f"{rate:.6g}, {SIM_ENV_HORIZON} s, Rosella; one launch {launch_ms:.6f} ms, their "
          f"{rounds} rounds at {rounds / (launch_ms / 1e3):.1f} rounds/s over the launch (draws "
          f"{t1 - t0:.3f} s, analyze {t3 - t2:.3f} s)")
    for name, r in rec.items():
        print(f"[sim env] {name}: {r['rounds']} rounds to {r['end_s']:.3f} s, jobs {r['jobs']}, "
              f"mean {r['mean']:.6g} p50 {r['p50']:.6g} p99 {r['p99']:.6g}, censored "
              f"{r['censored']}, killed jobs {r['killed_jobs']} ({r['crashes']} crashes)")
    print("[sim env] crash_storm kills jobs, churn drains: True")
    return dict(launch_ms=launch_ms, rounds=rounds, rounds_per_s=rounds / (launch_ms / 1e3),
                draws_s=t1 - t0, analyze_s=t3 - t2, scenarios=rec), (names, runs, draws, outs)


def sim_env_hold_rounds(e, now: np.ndarray, rounds: int) -> tuple[int, float]:
    """How many of a [sim env] chain's rounds its hold against the plain
    chain covers, and the time they must pass: the second change of each
    of its tracks (membership, stall, μ, λ: a worker leaves and rejoins, a
    stall begins and ends, ...) and its second crash, then
    SIM_ENV_HOLD_MARGIN rounds more; at least SIM_EXT_CHECK_ROUNDS, at most
    the chain's rounds."""
    times = []
    for bp, val in ((e.act_bp, e.act_val), (e.stall_bp, e.stall_val), (e.mu_bp, e.mu_val),
                    (e.lam_bp, e.lam_val)):
        if bp is None:
            continue
        bp, val = bp.cpu().numpy(), val.cpu().numpy()
        times += [float(bp[i]) for i in range(1, len(bp))
                  if not np.array_equal(val[i], val[i - 1])][:2]
    if e.crash_t is not None:
        times += [float(t) for t in e.crash_t.cpu().numpy()[:2]]
    t_hold = max([t for t in times if t < SIM_ENV_HORIZON], default=0.0)
    k = int(np.searchsorted(now, t_hold, side="right")) + SIM_ENV_HOLD_MARGIN
    return min(rounds, max(SIM_EXT_CHECK_ROUNDS, k)), t_hold


def sim_obs_hold(torch, tsim, names, runs, draws, obs_outs, off_outs) -> dict:
    """[sim obs]'s launch and the launches of the same chains with telemetry
    off ([sim env]'s, [sim fleet]'s, the null chain's) held against one run
    of the plain chain on the CPU with telemetry on: the chain is causal, so
    the plain chain fed each chain's first K draw rows must give [sim obs]'s
    first K rows of every trace column, window row and boundary flag, and
    the off launch's of every other column, bit for bit, at the shape the
    main path runs (n = 30, the scenario's own tracks). K
    (``sim_env_hold_rounds``) passes the second change of each track and
    the second crash; SIM_EXT_CHECK_ROUNDS for a chain without tracks."""
    import dataclasses

    t0 = time.perf_counter()
    cuts, cpu_runs, cpu_draws = [], [], []
    for (cfg, p, key, e), d, (_, tr) in zip(runs, draws, obs_outs):
        k, t_hold = ((min(cfg.rounds, SIM_EXT_CHECK_ROUNDS), 0.0) if e is None
                     else sim_env_hold_rounds(e, tr["now"].cpu().numpy(), cfg.rounds))
        cuts.append((k, t_hold))
        cpu_runs.append((dataclasses.replace(cfg, rounds=k), p.to("cpu"), key,
                         None if e is None else e.to("cpu")))
        cpu_draws.append({name: v[:k].cpu() for name, v in d.items()})
    want = tsim.simulate_many(cpu_runs, "cpu", cpu_draws)
    rec = {}
    for name, (k, t_hold), (_, got), (_, off), (_, wt) in zip(names, cuts, obs_outs, off_outs,
                                                               want):
        for col in wt:
            if col == "obs_row":
                for f, a, b in zip(wt[col]._fields, got[col], wt[col]):
                    need(torch.equal(a[:k].cpu(), b), f"[sim obs] {name}: the launch's window "
                         f"row field {f} differs from the plain chain in its first {k} rounds")
                continue
            need(torch.equal(got[col][:k].cpu(), wt[col]),
                 f"[sim obs] {name}: the launch's {col} differs from the plain chain in its "
                 f"first {k} rounds")
            if col != "obs_flag":
                need(torch.equal(off[col][:k].cpu(), wt[col]),
                     f"[sim obs] {name}: the launch without telemetry's {col} differs from "
                     f"the plain chain in its first {k} rounds")
        rec[name] = dict(rounds=k, past_s=t_hold)
    secs = time.perf_counter() - t0
    total = sum(k for k, _ in cuts)
    print(f"[sim obs] the launch and the launches without telemetry held against the plain "
          f"chain with telemetry on the CPU, fed their own draws: the first {total} rounds of "
          f"{len(names)} chains ("
          + ", ".join(f"{name} {r['rounds']} past {r['past_s']:.1f} s" for name, r in rec.items())
          + f"): every trace column, window row and flag equal bit for bit, in {secs:.2f} s")
    return dict(chains=rec, rounds=total, seconds=secs)


def phase_sim_ext(torch, RS, tenv, met, dev, card) -> tuple[dict, dict, dict]:
    """The chain's environment, fault and fleet modes: kernel = plain chain
    on a check chain of each, then the main path's two launches ([sim
    fleet], [sim env]), counted; returns the records, the launches and the
    two launches' runs and outputs, which [sim obs] holds against."""
    from repro_torch.core import simulator as tsim
    from repro_torch.kernels.sim_chain import kernel as SK

    t0 = time.perf_counter()
    print(f"[sim] {card}; the chain's environment, fault and fleet modes through sim_chain "
          f"(its environment and fleet instances), seed {SEED}")
    checks = sim_kernel_equals_plain(torch, tsim, sim_ext_check_groups(RS, tenv, dev), dev)
    SK.reset_launches()
    fleet, fleet_out = sim_fleet_sweep(torch, tsim, RS, met, dev)
    env, env_out = sim_env_scenarios(torch, tsim, RS, tenv, met, dev)
    launches = SK.launch_counts()
    need(launches["sim_chain"] == 2,
         f"[sim] sim_chain launched {launches['sim_chain']} times on the environment and fleet "
         f"path, expected one for [sim fleet] and one for [sim env]")
    secs = time.perf_counter() - t0
    print(f"[sim] the environment and fleet modes: {len(checks)} kernel = plain launches, [sim "
          f"fleet] and [sim env] in {secs:.1f} s; main-path launches {json.dumps(launches)}")
    return dict(checks=checks, fleet=fleet, env=env, seconds=secs), launches, \
        dict(fleet=fleet_out, env=env_out)


# [sim obs]: the chain's in-chain telemetry (ROADMAP A8c) on [sim env]'s
# chains, the null scenario's and [sim fleet]'s sync-16 chain: windows of
# 256 rounds (~6-13 s of the chain's clock at 20-46 rounds/s), the detector
# armed after 8 windows
SIM_OBS_WINDOW = 256
SIM_OBS_WARMUP = 8
SIM_OBS_FLEET_SYNC = 16


def sim_obs_runs(tsim, RS, tenv, obs, dev, kept) -> tuple:
    """(names, runs, draws, off outputs, scenarios) of [sim obs]: the
    registry's 12 scenarios (``sim_env_runs``, the null one too) and [sim
    fleet]'s sync-16 chain, with telemetry; the draws and the outputs
    without telemetry are [sim env]'s and [sim fleet]'s own (the null
    chain's draws are made here, its output without telemetry is None)."""
    import dataclasses

    ocfg = obs.ObserveConfig(window_turns=SIM_OBS_WINDOW,
                             detect=obs.DetectConfig(warmup_windows=SIM_OBS_WARMUP))
    names, runs = sim_env_runs(tsim, RS, tenv, dev, observe=ocfg, null=True)
    env_names, _, env_draws, env_outs = kept["env"]
    draws, offs = [], []
    for name, (cfg, p, k, e) in zip(names, runs):
        if name in env_names:
            i = env_names.index(name)
            draws.append(env_draws[i])
            offs.append(env_outs[i])
        else:
            draws.append(tsim.draw_rounds(cfg, p, k, dev, e))
            offs.append(None)
    f_runs, f_draws, f_outs = kept["fleet"]
    i = SIM_FLEET_SETTINGS.index((SIM_OBS_FLEET_SYNC, False))
    cfg, p, k = f_runs[i]
    names.append(f"fleet S={SIM_FLEET_S} sync {SIM_OBS_FLEET_SYNC}")
    runs.append((dataclasses.replace(cfg, observe=ocfg), p, k, None))
    draws.append(f_draws[i])
    offs.append(f_outs[i])
    speeds = RS.tpch_speed_set(30, seed=SEED)
    scns = {name: tenv.make(name, speeds=tuple(speeds), rate=0.8 * float(speeds.sum()))
            for name in names if name in tenv.names()}
    return names, runs, draws, offs, scns


def phase_sim_obs(torch, RS, tenv, obs, met, dev, card, kept) -> tuple[dict, dict]:
    """[sim obs]: the chain's in-chain telemetry in one counted launch of 13
    chains (``sim_obs_runs``): each chain's windows, detections and
    detection report against its scenario's shift events; n_resp and the
    histograms' counts summed over the records equal the trace's real
    completions. Held (a) card against card: every other column equals the
    launches without telemetry ([sim env]'s, [sim fleet]'s, and the null
    chain's, launched here); (b, c) against the plain chain with telemetry
    on the CPU over each chain's first K rounds (``sim_obs_hold``)."""
    import dataclasses

    from repro_torch.core import simulator as tsim
    from repro_torch.kernels.sim_chain import kernel as SK

    t0 = time.perf_counter()
    names, runs, draws, offs, scns = sim_obs_runs(tsim, RS, tenv, obs, dev, kept)
    ocfg = runs[0][0].observe
    print(f"[sim obs] {card}; the chain's in-chain telemetry through sim_chain's telemetry "
          f"instances: windows of {ocfg.window_turns} rounds, {ocfg.hist_bins} bins, the "
          f"detector armed after {ocfg.detect.warmup_windows} windows; {len(runs)} chains "
          f"(the registry's {len(scns)} scenarios at 6.1's 30 speeds, rate 0.8·Σμ, "
          f"{SIM_ENV_HORIZON} s, and [sim fleet]'s sync-{SIM_OBS_FLEET_SYNC} chain), seed {SEED}")
    torch.cuda.synchronize()
    SK.reset_launches()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t1 = time.perf_counter()
    e0.record()
    outs = tsim.simulate_many(runs, dev, draws)
    e1.record()
    torch.cuda.synchronize()
    launch_ms = e0.elapsed_time(e1)
    launches = SK.launch_counts()
    need(launches["sim_chain"] == 1, f"[sim obs] sim_chain launched {launches['sim_chain']} "
         "times, expected one")
    t2 = time.perf_counter()
    rec = {}
    for name, (cfg, _, _, _), (_, tr) in zip(names, runs, outs):
        recs = obs.windows.sim_records_from_trace(ocfg, tr)
        done = int((tr["code"] == tsim.EV_REAL_DONE).sum())
        resp = sum(r["n_resp"] for r in recs)
        counts = sum(sum(r["hist"]) for r in recs)
        need(resp == done == counts, f"[sim obs] {name}: n_resp {resp} and the histograms' "
             f"counts {counts} against {done} real completions")
        need(len(recs) == -(-cfg.rounds // ocfg.window_turns),
             f"[sim obs] {name}: {len(recs)} windows for {cfg.rounds} rounds")
        scn = scns.get(name)
        rep = obs.detect.detection_report(
            recs, shift_events=scn.shift_events(0) if scn is not None else (),
            drifting=bool(scn.drifting) if scn is not None else False)
        dets = [(d["label"], round(d["t"], 3)) for d in rep["detections"]]
        rec[name] = dict(rounds=cfg.rounds, windows=len(recs), completions=done,
                         detections=dets, n_shifts=rep["n_shifts"],
                         n_detected_shifts=rep["n_detected_shifts"],
                         false_alarms=rep["false_alarms"], repeats=rep["repeats"],
                         mean_latency=rep["mean_latency"], max_latency=rep["max_latency"],
                         kind_match_rate=rep["kind_match_rate"],
                         p99_last=recs[-1]["p99"], q_mean_last=recs[-1]["q_mean"])
    t3 = time.perf_counter()
    # (a) card against card: the null chain without telemetry, launched here
    i = names.index("null")
    cfg, p, k, e = runs[i]
    offs[i] = tsim.simulate_many([(dataclasses.replace(cfg, observe=None), p, k, e)], dev,
                                 [draws[i]])[0]
    for name, (_, got), (_, off) in zip(names, outs, offs):
        for col in off:
            need(torch.equal(got[col], off[col]), f"[sim obs] {name}: {col} differs from the "
                 "launch without telemetry")
    print(f"[sim obs] (a) every other trace column of the launch equals the launches without "
          f"telemetry ([sim env]'s 11 chains, [sim fleet]'s sync-{SIM_OBS_FLEET_SYNC} chain, "
          f"the null chain's), card against card, bit for bit")
    hold = sim_obs_hold(torch, tsim, names, runs, draws, outs, offs)
    rounds = sum(cfg.rounds for cfg, _, _, _ in runs)
    print(f"[sim obs] one launch {launch_ms:.6f} ms, {rounds} rounds at "
          f"{rounds / (launch_ms / 1e3):.1f} rounds/s over the launch (records and reports "
          f"{t3 - t2:.3f} s)")
    for name, r in rec.items():
        print(f"[sim obs] {name}: {r['rounds']} rounds, {r['windows']} windows, "
              f"{r['completions']} real completions (= n_resp = the histograms' counts); "
              f"detections {r['detections']}; shifts {r['n_shifts']}, detected "
              f"{r['n_detected_shifts']}, false alarms {r['false_alarms']}, repeats "
              f"{r['repeats']}, mean latency {r['mean_latency']}, max {r['max_latency']}, "
              f"kind match {r['kind_match_rate']}; last window p99 {r['p99_last']:.6g} "
              f"q_mean {r['q_mean_last']:.6g}")
    secs = time.perf_counter() - t0
    print(f"[sim obs] in {secs:.1f} s (launch + reports {t3 - t1:.2f} s); main-path launches "
          f"{json.dumps(launches)}")
    return dict(launch_ms=launch_ms, rounds=rounds, rounds_per_s=rounds / (launch_ms / 1e3),
                chains=rec, hold=hold, seconds=secs), launches


# [sim theory] and [sim coupling]: benchmarks/theory_validation.py's three
# checks and benchmarks/recovery_coupling.py's coupled pairs at their own
# settings (seed 0); one launch a worker count (a launch's chains share n)
SIM_R1_ROUNDS, SIM_R2_ROUNDS, SIM_R3_ROUNDS, SIM_COUPLING_ROUNDS = 150_000, 60_000, 80_000, \
    120_000


def sim_theory_runs(tsim, RS, dev) -> dict:
    """label -> (cfg, params, key) of the §4 checks: R1 (Lemma 4's tail, 20
    equal workers, load 0.8, PPoT and PSS, known speeds), R2 (learning
    time, Zipf n = 10 and 40 at load 0.5, n = 10 at 0.85), R3 (recovery
    from a cold μ̂, Zipf n = 10 and 40, load 0.8), and Proposition 1's
    coupled pairs (n = 10 and 40 equal workers at 0.7·n: chain B steady,
    chain A with a first phase of a quarter speed, 5% of the horizon, on
    the same key)."""
    from repro_torch.utils import prng

    key = prng.PRNGKey(SEED)
    out = {}
    for name, policy in (("ppot", "ppot_sq2"), ("pss", "pss")):
        out[f"r1 {name}"] = RS.make_sim(policy, np.ones(20), 0.8, rounds=SIM_R1_ROUNDS,
                                        use_learner=False, use_fake_jobs=False, seed=SEED,
                                        device=dev) + (key,)
    for tag, n, load in (("n10_a50", 10, 0.5), ("n40_a50", 40, 0.5), ("n10_a85", 10, 0.85)):
        out[f"r2 {tag}"] = RS.make_sim("ppot_sq2", RS.zipf_speeds(n, seed=SEED), load,
                                       rounds=SIM_R2_ROUNDS, seed=SEED, device=dev) + (key,)
    for n in (10, 40):
        out[f"r3 n{n}"] = RS.make_sim("ppot_sq2", RS.zipf_speeds(n, seed=SEED), 0.8,
                                      rounds=SIM_R3_ROUNDS, mu_hat0=np.ones(n), seed=SEED,
                                      device=dev) + (key,)
    for n in (10, 40):
        speeds = np.ones(n)
        lam = 0.7 * speeds.sum()
        cfg = tsim.SimConfig(n=n, policy="ppot_sq2", rounds=SIM_COUPLING_ROUNDS,
                             use_learner=False, use_fake_jobs=False)
        total_time = SIM_COUPLING_ROUNDS / (lam + speeds.sum())
        out[f"coupling n{n} B"] = (cfg, tsim.make_params(lam=lam, mu=speeds, device=dev), key)
        out[f"coupling n{n} A"] = (cfg, tsim.make_params(
            lam=lam, mu=speeds, mu_schedule=np.stack([speeds * 0.25] + [speeds] * 19),
            phase_period=total_time / 20.0, device=dev), key)
    return out


def phase_sim_theory(torch, RS, TH, met, dev, card) -> tuple[dict, dict]:
    """[sim theory] and [sim coupling]: the §4 checks and Proposition 1's
    coupled pairs (``sim_theory_runs``), one counted launch a worker count;
    every statistic from the card's launch, the claims printed, not
    asserted, as the figures' are."""
    from repro_torch.core import simulator as tsim
    from repro_torch.kernels.sim_chain import kernel as SK

    t0 = time.perf_counter()
    runs = sim_theory_runs(tsim, RS, dev)
    print(f"[sim theory] {card}; benchmarks/theory_validation.py's R1-R3 and "
          f"benchmarks/recovery_coupling.py's pairs at their settings, seed {SEED}, through "
          f"sim_chain, one launch a worker count")
    by_n = {}
    for label, run in runs.items():
        by_n.setdefault(run[0].n, []).append(label)
    torch.cuda.synchronize()
    SK.reset_launches()
    t1 = time.perf_counter()
    tr, launch_ms = {}, {}
    for n, labels in sorted(by_n.items()):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        outs = tsim.simulate_many([runs[lb] for lb in labels], dev)
        e1.record()
        torch.cuda.synchronize()
        launch_ms[n] = e0.elapsed_time(e1)
        tr.update({lb: o[1] for lb, o in zip(labels, outs)})
    launches = SK.launch_counts()
    need(launches["sim_chain"] == len(by_n), f"[sim theory] sim_chain launched "
         f"{launches['sim_chain']} times, expected one a worker count ({len(by_n)})")
    t2 = time.perf_counter()
    for label, t in tr.items():
        for col in ("now", "mu_hat"):
            need(bool(torch.isfinite(t[col]).all()), f"[sim theory] {label}: {col} not finite")
    # R1: the stationary tail against alpha^(2^k - 1) (PPoT) and alpha^k (PSS)
    r1, tails = {}, {}
    for name in ("ppot", "pss"):
        tail = met.stationary_tail(tr[f"r1 {name}"])
        tails[name] = tail
        pred = (TH.ppot_tail if name == "ppot" else TH.pss_tail)(0.8, np.arange(len(tail)))
        ks = list(range(1, min(len(tail), 5)))
        err = float(np.max(np.abs(np.log10(np.clip(tail[ks], 1e-6, 1))
                                  - np.log10(np.clip(pred[ks], 1e-6, 1)))))
        r1[name] = dict(emp=[float(v) for v in tail[:5]], pred=[float(v) for v in pred[:5]],
                        log10err=err)
    k = 3
    r1_claim = bool(tails["ppot"][min(k, len(tails["ppot"]) - 1)]
                    < tails["pss"][min(k, len(tails["pss"]) - 1)] * 0.5 + 1e-9)
    # R2: the first time the mean relative μ̂ error falls below 20%
    r2 = {}
    for tag, n in (("n10_a50", 10), ("n40_a50", 40), ("n10_a85", 10)):
        t = tr[f"r2 {tag}"]
        m = met.analyze(t, n=n, warmup_frac=0.0)
        err = met.estimate_error(t, RS.zipf_speeds(n, seed=SEED))
        idx = int(np.argmax(err < 0.2)) if (err < 0.2).any() else len(err) - 1
        r2[tag] = float(m.times[idx])
    r2_claims = {"flat in n (n=40 < 4 x n=10)": r2["n40_a50"] < 4.0 * r2["n10_a50"],
                 "grows with load (0.85 > 0.5)": r2["n10_a85"] > r2["n10_a50"]}
    # R3: from the mean queue's peak back to within 1.5x its final level
    r3 = {}
    for n in (10, 40):
        m = met.analyze(tr[f"r3 n{n}"], n=n, warmup_frac=0.0)
        mq, t = m.mean_queue, m.times
        final = np.mean(mq[-len(mq) // 10:])
        peak_i = int(np.argmax(mq[: len(mq) // 2]))
        after = np.nonzero(mq[peak_i:] <= final * 1.5 + 0.5)[0]
        r3[n] = float(t[peak_i + after[0]] - t[peak_i]) if after.size else float("inf")
    r3_claim = r3[40] < 5.0 * max(r3[10], 1.0)
    # Proposition 1: l0(t) = (1/n)·#{i : q_i != q'_i} of the coupled pair
    cp = {}
    for n in (10, 40):
        qa = tr[f"coupling n{n} A"]["q_real"].cpu().numpy()
        qb = tr[f"coupling n{n} B"]["q_real"].cpu().numpy()
        ta = tr[f"coupling n{n} A"]["now"].cpu().numpy().astype(np.float64)
        l0 = (qa != qb).mean(axis=1)
        shock_end = int(np.searchsorted(ta, ta[-1] / 20.0))
        tail = l0[shock_end:]
        idx = int(np.argmax(tail <= 0.2)) if (tail <= 0.2).any() else len(tail) - 1
        t_rec = float(ta[shock_end + idx] - ta[shock_end])
        marks = [shock_end + int(f * (len(l0) - 1 - shock_end)) for f in (0, 0.1, 0.2, 0.4,
                                                                          0.6, 0.8, 1.0)]
        cp[n] = dict(l0_peak=float(l0[:shock_end + idx + 1].max()),
                     l0_final=float(l0[-1000:].mean()), t_recover=t_rec,
                     c_peak=int(qa.max()), shock_end_s=float(ta[shock_end]),
                     decay=[(round(float(ta[i]), 3), float(l0[i])) for i in marks])
    cp_claim = cp[40]["t_recover"] < 5.0 * max(cp[10]["t_recover"], 0.5)
    t3 = time.perf_counter()
    rounds = {n: sum(runs[lb][0].rounds for lb in labels) for n, labels in by_n.items()}
    for n, labels in sorted(by_n.items()):
        print(f"[sim theory] n={n}: {', '.join(labels)} in one launch {launch_ms[n]:.6f} ms "
              f"({rounds[n]} rounds, {rounds[n] / (launch_ms[n] / 1e3):.1f} rounds/s over the "
              f"launch)")
    for name, r in r1.items():
        print(f"[sim theory] R1 tail {name} (20 equal workers, load 0.8, {SIM_R1_ROUNDS} "
              f"rounds, known speeds): P[q >= k] emp {[round(v, 6) for v in r['emp']]} pred "
              f"{[round(v, 6) for v in r['pred']]} log10err {r['log10err']:.4f}")
    print(f"[sim theory] R1 claim loglog vs log (ppot tail at k=3 < 0.5 x pss's): {r1_claim}")
    print(f"[sim theory] R2 learning time (mean μ̂ error < 20%, Zipf, {SIM_R2_ROUNDS} rounds): "
          + ", ".join(f"{tag} {v:.3f} s" for tag, v in r2.items()))
    for claim, ok in r2_claims.items():
        print(f"[sim theory] R2 claim {claim}: {ok}")
    print(f"[sim theory] R3 recovery from a cold μ̂ (Zipf, load 0.8, {SIM_R3_ROUNDS} rounds): "
          + ", ".join(f"n={n} {v:.3f} s" for n, v in r3.items()))
    print(f"[sim theory] R3 claim n-independent (n=40 < 5 x n=10): {r3_claim}")
    for n, r in cp.items():
        print(f"[sim coupling] n={n} (equal workers, load 0.7, {SIM_COUPLING_ROUNDS} rounds, "
              f"a quarter-speed first phase to {r['shock_end_s']:.3f} s): l0 peak "
              f"{r['l0_peak']:.4f}, final {r['l0_final']:.4f}, t_recover (l0 <= 0.2) "
              f"{r['t_recover']:.3f} s, c_peak {r['c_peak']}; l0 decay (t, l0) {r['decay']}")
    print(f"[sim coupling] claim n-independent recovery (t40 < 5 x t10): {cp_claim} (t10 "
          f"{cp[10]['t_recover']:.3f}, t40 {cp[40]['t_recover']:.3f})")
    secs = time.perf_counter() - t0
    print(f"[sim theory] in {secs:.1f} s (launches {t2 - t1:.2f} s, statistics {t3 - t2:.2f} s); "
          f"main-path launches {json.dumps(launches)}")
    return dict(launch_ms={str(n): v for n, v in launch_ms.items()}, r1=r1, r1_claim=r1_claim,
                r2=r2, r2_claims=r2_claims, r3={str(n): v for n, v in r3.items()},
                r3_claim=r3_claim, coupling={str(n): v for n, v in cp.items()},
                coupling_claim=cp_claim, seconds=secs), launches


def sim_line_bytes(args, T: int, n: int, mt: int, cap: int, S: int) -> int:
    """The bytes a sim_chain call must move: every input read once (the
    configs, the speeds, μ̂0 and the draw columns of its T rounds) and every
    output written once (the trace rows and the final state)."""
    conf_i, conf_f, sched, mu0, cols = args
    C = conf_i.shape[0]
    ins = sum(t.numel() * t.element_size() for t in (conf_i, conf_f, sched, mu0))
    ins += sum(v[:, :T].numel() * v.element_size() for v in cols.values())
    trace = C * T * 4 * (11 + 2 * mt + 2 * n)  # 11 scalar columns, 2 of mt, 2 of n
    final = C * 4 * (9 * n + 2 * n * cap + S + 4)
    return ins + trace + final


def sim_line_ops(trace: dict, n: int, refresh: int, cap: int) -> int:
    """The chain's float operations on these inputs: the clock's add a
    round, the estimator's two a arrival, the acceptance division and the
    sample's subtraction a service or benchmark event, and at each refresh
    at most ring_cap adds and ten scalar operations a worker."""
    code = trace["code"]
    T = code.shape[0]
    arrivals = int((code == 0).sum())
    refreshes = (T + refresh - 1) // refresh
    return T + 2 * arrivals + 2 * (T - arrivals) + refreshes * n * (cap + 10)


def sim_split_runs(figs: dict) -> dict:
    """The two runs of ``sim_figures``'s ``figs`` that the per-phase split is
    read on: Fig. 8's static Rosella run (n = 30, PPoT-SQ(2), learner and
    benchmark jobs, 120,000 rounds) and Fig. 10a's PPoT-SQ(2) run (n = 15,
    known speeds, 80,000 rounds)."""
    runs = {label: run for fig in ("fig8", "fig10") for label, run, _ in figs[fig]}
    return {"fig8 static/rosella": runs["static/rosella"], "fig10 10a/ppot": runs["10a/ppot"]}


def sim_split(rec: dict) -> dict:
    """A chain's clocked record (``kernel.read_clocks``) as cycles a round by
    phase, and cycles an event for the branches, the refresh, the rebuild
    and a tile."""
    cyc, cnt = rec["cycles"], rec["counts"]
    rounds = max(cnt["rounds"], 1)
    per = {"arrival": "arrivals", "service": "services", "fake": "fakes",
           "refresh": "refreshes", "rebuild": "rebuilds", "tile": "tiles"}
    return dict(cycles_per_round=sum(cyc.values()) / rounds,
                per_round={k: v / rounds for k, v in cyc.items()},
                per_event={k: cyc[k] / max(cnt[c], 1) for k, c in per.items()}, counts=cnt)


def sim_split_text(s: dict) -> str:
    return (f"{s['cycles_per_round']:.1f} cycles a round = "
            + ", ".join(f"{k} {v:.1f}" for k, v in s["per_round"].items())
            + "; an event: " + ", ".join(f"{k} {v:.1f}" for k, v in s["per_event"].items())
            + f"; counts {json.dumps(s['counts'])}")


def phase_sim_times(torch, dev, RS, mhz, floor_ms) -> dict:
    """sim_chain alone by event pairs: Fig. 8's static Rosella run at its
    120,000 rounds (one chain) with its bound at that size, Fig. 10a's
    known-speed run, Fig. 8's batch of four, and the kernels line's case
    (the Rosella run cut to SIM_LINE_ROUNDS), with its plain chain on the
    card and its bound; draw_rounds and analyze per run; the per-phase
    cycle split of both single runs (the clocked build)."""
    from repro_torch.core import metrics as M
    from repro_torch.core import simulator as tsim
    from repro_torch.kernels.sim_chain import kernel as SK
    from repro_torch.kernels.sim_chain import ref as SR

    def event_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize()
            ts.append(e0.elapsed_time(e1))
        return float(np.median(ts))

    def queued_ms(fn, reps):
        """The median of reps event pairs queued behind a sleep, so that no
        host work lies between a pair's two events (fn must not wait for the
        stream)."""
        fn()
        torch.cuda.synchronize()
        evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
               for _ in range(reps)]
        torch.cuda._sleep(200_000_000)
        for e0, e1 in evs:
            e0.record()
            fn()
            e1.record()
        torch.cuda.synchronize()
        return float(np.median([e0.elapsed_time(e1) for e0, e1 in evs]))

    figs = sim_figures(RS, dev)
    fig8 = [run for _, run, _ in figs["fig8"]]
    splits, single, inputs = {}, {}, {}
    for label, run in sim_split_runs(figs).items():
        c, p, k = run
        d = tsim.draw_rounds(c, p, k, dev)
        a, sh = tsim.chain_inputs([run], [d], dev)
        inputs[label] = (d, a, sh)
        ms_run = event_ms(lambda: SK.sim_chain(*a, **sh), 3)
        _, tr_run, rec = SK.clock_split(*a, **sh)
        splits[label] = sim_split(rec[0])
        nb = sim_line_bytes(a, c.rounds, c.n, c.max_tasks, c.ring_cap, c.arrival_window)
        nops = sim_line_ops({k2: v[0] for k2, v in tr_run.items()}, c.n, c.learner_refresh,
                            c.ring_cap)
        single[label] = dict(rounds=c.rounds, n=c.n, ms=ms_run, bytes=nb, ops=nops,
                             bytes_ms=nb / HBM_BYTES_PER_S * 1e3, ops_ms=nops / 67e12 * 1e3,
                             chain_ms=c.rounds * SIM_CHAIN_CYCLES / (mhz * 1e6) * 1e3)
    # Fig. 8's static Rosella run (fig8[0]): its one-chain time and draws
    # serve the batch, draw_rounds, analyze and the cut below
    cfg, params, key = fig8[0]
    draws, args, shape = inputs["fig8 static/rosella"]
    full_ms = single["fig8 static/rosella"]["ms"]
    batch_args, _ = tsim.chain_inputs(fig8, [draws] + [tsim.draw_rounds(c, p, k, dev)
                                                       for c, p, k in fig8[1:]], dev)
    batch_ms = event_ms(lambda: SK.sim_chain(*batch_args, **shape), 3)
    draw_ms = host_median_ms(torch, lambda: tsim.draw_rounds(cfg, params, key, dev), 3)
    _, trace = SK.sim_chain(*args, **shape)
    tr0 = {k: v[0] for k, v in trace.items()}
    analyze_ms = host_median_ms(torch, lambda: M.analyze(tr0, n=cfg.n, warmup_frac=0.3), 3)

    R = SIM_LINE_ROUNDS
    import dataclasses
    cut = (dataclasses.replace(cfg, rounds=R), params, key)
    cut_args, _ = tsim.chain_inputs([cut], [{k: v[:R] for k, v in draws.items()}], dev)
    # ms: the launch alone (the kernel and its outputs' zero fill), queued;
    # wrapper_ms: the wrapper in an event pair, with its host work and its
    # read of the configs (which waits for the stream) inside the pair
    _, cut_trace = SK.sim_chain(*cut_args, **shape)
    need(all(torch.equal(a, b) for a, b in zip(SK.launch_only(*cut_args, **shape)[1].values(),
                                               cut_trace.values())),
         "[times] sim_chain's launch alone differs from the wrapper's")
    ms = queued_ms(lambda: SK.launch_only(*cut_args, **shape), SIM_LINE_REPS)
    wrapper_ms = event_ms(lambda: SK.sim_chain(*cut_args, **shape), SIM_LINE_REPS)
    P = SIM_PLAIN_CARD_ROUNDS
    plain_cut = (dataclasses.replace(cfg, rounds=P), params, key)
    plain_args, _ = tsim.chain_inputs([plain_cut], [{k: v[:P] for k, v in draws.items()}], dev)
    plain_round_ms = host_median_ms(torch, lambda: SR.sim_chain_ref(*plain_args, **shape),
                                    3) / P
    plain_ms = host_median_ms(torch, lambda: SR.sim_chain_ref(*cut_args, **shape), 1)
    nbytes = sim_line_bytes(cut_args, R, cfg.n, cfg.max_tasks, cfg.ring_cap,
                            cfg.arrival_window)
    ops = sim_line_ops({k: v[0] for k, v in cut_trace.items()}, cfg.n, cfg.learner_refresh,
                       cfg.ring_cap)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / 67e12 * 1e3  # f32 outside the tensor cores
    chain_ms = R * SIM_CHAIN_CYCLES / (mhz * 1e6) * 1e3
    full_chain_ms = cfg.rounds * SIM_CHAIN_CYCLES / (mhz * 1e6) * 1e3
    # the environment and fleet program (the EXT instances): Fig. 8's run on it,
    # bit for bit the paper program's, and [sim fleet]'s six chains alone
    ext_args, _ = tsim.chain_inputs([fig8[0]], [draws], dev, ext=True)
    need(all(torch.equal(a, b) for a, b in zip(SK.sim_chain(*ext_args, **shape)[1].values(),
                                               SK.sim_chain(*args, **shape)[1].values())),
         "[times] the environment and fleet program on Fig. 8's run differs from the paper "
         "program")
    ext_ms = event_ms(lambda: SK.sim_chain(*ext_args, **shape), 3)
    fruns = sim_fleet_runs(RS, dev)
    fleet_args, fleet_shape = tsim.chain_inputs(
        fruns, [tsim.draw_rounds(c, p, k, dev) for c, p, k in fruns], dev)
    fleet_ms = event_ms(lambda: SK.sim_chain(*fleet_args, **fleet_shape), 3)
    # the telemetry instances: Fig. 8's run with [sim obs]'s telemetry, in
    # turns with the same run without (off, on, on, off; launches alone,
    # queued), the same trace bit for bit; its bound counts the rows written;
    # and its split by phase through the clocked build
    from repro_torch import obs

    ocfg = obs.ObserveConfig(window_turns=SIM_OBS_WINDOW,
                             detect=obs.DetectConfig(warmup_windows=SIM_OBS_WARMUP))
    obs_args, _ = tsim.chain_inputs([(dataclasses.replace(cfg, observe=ocfg), params, key)],
                                    [draws], dev)
    _, obs_trace = SK.sim_chain(*obs_args, **shape)
    need(all(torch.equal(obs_trace[k], v) for k, v in trace.items()),
         "[times] Fig. 8's run with telemetry differs from the run without it")
    turns = [queued_ms(fn, 3) for fn in (lambda: SK.launch_only(*args, **shape),
                                         lambda: SK.launch_only(*obs_args, **shape),
                                         lambda: SK.launch_only(*obs_args, **shape),
                                         lambda: SK.launch_only(*args, **shape))]
    obs_ms, off_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
    obs_bytes = sim_line_bytes(args, cfg.rounds, cfg.n, cfg.max_tasks, cfg.ring_cap,
                               cfg.arrival_window) + sum(
        t.numel() * t.element_size() for t in list(obs_args[6].values()) + [obs_trace["obs"]])
    obs_bound_ms = max(obs_bytes / HBM_BYTES_PER_S * 1e3, single["fig8 static/rosella"]["ops_ms"])
    *_, obs_rec = SK.clock_split(*obs_args, **shape)
    splits["fig8 static/rosella, telemetry on"] = sim_split(obs_rec[0])
    rec = dict(ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms, plain_round_ms=plain_round_ms,
               bound_ms=max(bytes_ms, ops_ms), ext_fig8_ms=ext_ms, fleet_sweep_ms=fleet_ms,
               obs_fig8_ms=obs_ms, obs_off_fig8_ms=off_ms, obs_fig8_bound_ms=obs_bound_ms,
               obs_fig8_bytes=obs_bytes,
               bound_by="bytes" if bytes_ms >= ops_ms else "operations", bytes=nbytes,
               ops=ops, chain_ms=chain_ms, rounds=R, full_rounds=cfg.rounds, full_ms=full_ms,
               full_chain_ms=full_chain_ms, batch_ms=batch_ms, batch_chains=len(fig8),
               draw_ms=draw_ms, analyze_ms=analyze_ms, floor_ms=floor_ms, library_ms=None,
               runs=single, splits=splits)
    print(f"[times] sim_chain, Fig. 8's static Rosella run (n=30, PPoT-SQ(2), learner and "
          f"benchmark jobs): {cfg.rounds} rounds, one chain {full_ms:.6f} ms "
          f"({cfg.rounds / full_ms * 1e3:.1f} rounds/s; chain floor {full_chain_ms:.6f} ms at "
          f"{SIM_CHAIN_CYCLES} cycles a round, {mhz:.0f} MHz); Fig. 8's {len(fig8)} chains in "
          f"one launch {batch_ms:.6f} ms; draw_rounds {draw_ms:.6f} ms, analyze "
          f"{analyze_ms:.6f} ms a run (host clock)")
    print(f"[times] sim_chain at {R} rounds of that run: kernel {ms:.6f} ms (the launch "
          f"alone, median of {SIM_LINE_REPS} queued event pairs; the wrapper with its host work "
          f"in the pair {wrapper_ms:.6f} ms), plain chain on "
          f"the card {plain_ms:.6f} ms ({plain_round_ms:.6f} ms a round over {P} rounds), "
          f"bound {rec['bound_ms']:.9f} ms ({rec['bound_by']}: {nbytes} B at 3.35 TB/s = "
          f"{bytes_ms:.9f} ms; {ops} f32 operations at 67 TFLOP/s = {ops_ms:.9f} ms), chain "
          f"floor {chain_ms:.6f} ms, launch floor {floor_ms:.6f} ms, library call: none")
    print(f"[times] sim_chain's environment and fleet program (its EXT instances) on that run: "
          f"{ext_ms:.6f} ms against the paper program's {full_ms:.6f} ms "
          f"({ext_ms / full_ms:.4f}x; the same trace bit for bit); [sim fleet]'s "
          f"{len(fruns)} chains of {SIM_FLEET_ROUNDS} rounds (S = {SIM_FLEET_S}) in one launch "
          f"{fleet_ms:.6f} ms")
    print(f"[times] sim_chain's telemetry instance on that run (windows of {SIM_OBS_WINDOW} "
          f"rounds, the detector): {obs_ms:.6f} ms against {off_ms:.6f} ms without telemetry "
          f"in the same turns ({obs_ms / off_ms:.4f}x; launches alone, queued; every other "
          f"column the same bit for bit); bound {obs_bound_ms:.9f} ms ({obs_bytes} B with the "
          f"rows written at 3.35 TB/s)")
    for label, r in single.items():
        print(f"[times] sim_chain, {label} (n={r['n']}): {r['rounds']} rounds {r['ms']:.6f} ms "
              f"({r['ms'] / r['rounds'] * 1e6:.3f} ns a round); bound "
              f"{max(r['bytes_ms'], r['ops_ms']):.9f} ms ({r['bytes']} B at 3.35 TB/s = "
              f"{r['bytes_ms']:.9f} ms; {r['ops']} f32 operations at 67 TFLOP/s = "
              f"{r['ops_ms']:.9f} ms); chain floor {r['chain_ms']:.6f} ms")
        print(f"[times] sim_chain split, {label} (clocked build, lane 0's clock64()): "
              f"{sim_split_text(splits[label])}")
    label = "fig8 static/rosella, telemetry on"
    print(f"[times] sim_chain split, {label} (clocked build, lane 0's clock64()): "
          f"{sim_split_text(splits[label])}")
    return rec


# ---------------------------------------------------------------------------
# model serving: flash attention, prefill, engines behind the router
# ---------------------------------------------------------------------------


def flash_plain_ops(FR, q, k, v, **kw):
    """The plain version of ``ops.flash_attention`` ([B, S, H, D])."""
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    o = FR.attention_ref(q.transpose(1, 2).reshape(B * H, Sq, D),
                         k.transpose(1, 2).reshape(B * Hkv, -1, D),
                         v.transpose(1, 2).reshape(B * Hkv, -1, D), **kw)
    return o.reshape(B, H, Sq, D).transpose(1, 2)


def phase_flash(torch, FK, FO, FR, dev):
    """K4 against its plain version on the card: the shapes of
    tests/test_kernels.py in f32 and bf16, the decode offset, a window
    whose late rows see no key, GQA through ``ops``, and the prefill
    shapes of smollm-360m, of hymba-1.5b (window 1024, 25/5 heads) and,
    at D = 128, of moonshot, phi3.5-moe and pixtral. Returns the largest
    error."""
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rand(*shape, dtype):
        return (torch.randn(shape, generator=gen, device=dev) * 0.5).to(dtype)

    cases = []
    for dt in (torch.float32, torch.bfloat16):
        for BH, Sq, Sk, D, causal, window, off in (
                (2, 128, 128, 64, True, 0, 0), (2, 256, 256, 64, True, 64, 0),
                (1, 128, 384, 128, False, 0, 0), (3, 384, 384, 32, True, 0, 0),
                (2, 128, 256, 64, True, 0, 128), (2, 128, 256, 64, True, 16, 200),
                (2, 2048, 2048, 64, True, 0, 0),
                # the tile plan's edges: Sq not a multiple of the 64-row q tile
                # nor Sk of the kv tile, windows whose first key falls inside
                # a tile, q_offset > 0 with ragged tiles, D = 32 and 128
                (1, 300, 300, 64, True, 0, 0), (2, 200, 333, 128, True, 0, 133),
                (1, 500, 500, 32, True, 100, 0), (2, 1000, 1000, 64, True, 200, 0),
                (1, 77, 1000, 64, False, 0, 0), (1, 256, 1024, 128, True, 300, 768),
                (3, 130, 190, 32, True, 0, 60)):
            cases.append((f"BH={BH} Sq={Sq} Sk={Sk} D={D} causal={causal} "
                          f"window={window} q_offset={off}", dt, "kernel",
                          (rand(BH, Sq, D, dtype=dt), rand(BH, Sk, D, dtype=dt),
                           rand(BH, Sk, D, dtype=dt)),
                          dict(causal=causal, window=window, q_offset=off)))
        cases.append((f"ops GQA B=2 S=300 H=6 Hkv=2 D=64", dt, "ops",
                      (rand(2, 300, 6, 64, dtype=dt), rand(2, 300, 2, 64, dtype=dt),
                       rand(2, 300, 2, 64, dtype=dt)), dict(causal=True, q_offset=0)))
        # q, k and v as strided views of one fused [B, S, H + 2 Hkv, D]
        # projection: the model-layout entry reads them in place
        qkv = rand(1, 333, 8 + 2 * 2, 32, dtype=dt)
        cases.append((f"ops strided views B=1 S=333 H=8 Hkv=2 D=32 window=50", dt, "ops",
                      (qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]),
                      dict(causal=True, window=50, q_offset=0)))
    # the prefill shapes in bf16, the body the served models run: smollm-360m's,
    # hymba-1.5b's windowed attention, and at D = 128 (the 64-key tile)
    # moonshot's, phi3.5-moe's and pixtral's (ZOO)
    zoo_b = {arch: B for arch, _layers, B, _S in ZOO}
    for label, B, S, H, Hkv, D, window in (
            ("prefill", PREFILL_B, PREFILL_S, 15, 5, 64, 0),
            ("prefill B=1", 1, 2048, 15, 5, 64, 0),
            ("hymba prefill", HYMBA_B, HYMBA_S, 25, 5, 64, 1024),
            (f"{MOE_ARCH} prefill", MOE_B, MOE_S, 16, 16, 128, 0),
            ("phi3.5-moe prefill", zoo_b["phi3.5-moe-42b-a6.6b"], 4096, 32, 8, 128, 0),
            ("pixtral prefill", zoo_b["pixtral-12b"], 4096, 32, 8, 128, 0)):
        bf = torch.bfloat16
        cases.append((f"ops {label} shape B={B} S={S} H={H} Hkv={Hkv} D={D} window={window}",
                      bf, "ops", (rand(B, S, H, D, dtype=bf), rand(B, S, Hkv, D, dtype=bf),
                                  rand(B, S, Hkv, D, dtype=bf)),
                      dict(causal=True, window=window, q_offset=0)))
    worst = worst_row = 0.0
    for name, dt, route, (q, k, v), kw in cases:
        if route == "kernel":
            got = FK.flash_attention_fwd(q, k, v, **kw)
            want = FR.attention_ref(q, k, v, **kw)
        else:
            got = FO.flash_attention(q, k, v, **kw)
            want = flash_plain_ops(FR, q, k, v, **kw)
        torch.cuda.synchronize()
        need(got.shape == want.shape and got.dtype == want.dtype == dt,
             f"[flash] {name}: {got.dtype}{list(got.shape)} vs {want.dtype}{list(want.shape)}")
        tol = FLASH_TOL[str(dt).split(".")[-1]]
        row_tol = FLASH_ROW_TOL[str(dt).split(".")[-1]]
        err = (got.float() - want.float()).abs()
        need(bool(torch.isfinite(got).all()), f"[flash] {name}: non-finite output")
        need(bool((err <= tol + tol * want.float().abs()).all()),
             f"[flash] {name} {dt}: max abs err {err.max().item()} above tol {tol}")
        row = FR.row_relative_error(got, want)
        need(bool((row <= row_tol).all()),
             f"[flash] {name} {dt}: {int((row > row_tol).sum())} rows with an error above "
             f"{row_tol} of the row's largest |value| (worst {row.max().item()})")
        if kw.get("window"):  # the query axis is 1 in both layouts
            rows = kw["q_offset"] + torch.arange(q.shape[1], device=dev)
            empty = rows >= k.shape[1] + kw["window"] - 1  # see no key at all
            need(bool((got[:, empty] == 0).all()),
                 f"[flash] {name}: rows with no valid key are not 0")
        worst = max(worst, err.max().item())
        worst_row = max(worst_row, row.max().item())
        print(f"[flash] {name} {str(dt).split('.')[-1]}: max abs err {err.max().item():.3e} "
              f"(tol {tol}), worst row error {row.max().item():.3e} of the row's "
              f"largest |value| (tol {row_tol})")
    print(f"[flash] all cases: max abs err {worst:.3e}, worst row error {worst_row:.3e}")
    return worst


def phase_prefill(torch, FK, dev):
    """The full-width prefill through ``api.prefill``: exactly one K4
    launch per layer; its last-position logits against the same model
    through the plain chunked path on the card; and the same model in f32,
    its logits at every position, against the plain chunked path."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import api
    from repro_torch.models import lm as LM

    cfg = configs.get_config("smollm-360m")
    model = api.init_params(cfg, SEED, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    toks = torch.randint(0, cfg.vocab, (PREFILL_B, PREFILL_S), generator=gen, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    FK.reset_launches()
    logits = api.prefill(cfg, model, {"tokens": toks})
    torch.cuda.synchronize()
    launches = FK.launch_counts()["flash_attention_fwd"]
    peak = torch.cuda.max_memory_allocated()
    need(launches == cfg.n_layers, f"[prefill] {launches} flash-attention launches, "
         f"expected one per layer ({cfg.n_layers})")
    need(logits.shape == (PREFILL_B, 1, cfg.vocab) and logits.dtype == torch.bfloat16,
         f"[prefill] logits {logits.dtype}{list(logits.shape)}")
    need(bool(torch.isfinite(logits).all()), "[prefill] non-finite logits")
    ms = host_median_ms(torch, lambda: api.prefill(cfg, model, {"tokens": toks}), reps=5)

    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    model32 = api.init_params(cfg32, SEED, dev)

    @torch.no_grad()
    def all_logits():
        return LM.logits_head(cfg32, model32, LM.forward(cfg32, model32, toks))

    FK.reset_launches()
    got32 = all_logits()
    torch.cuda.synchronize()
    need(FK.launch_counts()["flash_attention_fwd"] == cfg.n_layers,
         "[prefill] the f32 model did not go through the kernel in every layer")
    with api.plain_paths():
        plain = api.prefill(cfg, model, {"tokens": toks})
        want32 = all_logits()
        torch.cuda.synchronize()
    err = (logits.float() - plain.float()).abs().max().item()
    agree = (logits.argmax(-1) == plain.argmax(-1)).float().mean().item()
    need(err <= PREFILL_TOL, f"[prefill] logits differ from the plain chunked path by "
         f"{err} (tol {PREFILL_TOL})")
    need(bool(torch.isfinite(got32).all()), "[prefill] non-finite f32 logits")
    err32 = (got32 - want32).abs().max().item()
    mean32 = want32.abs().mean().item()
    need(err32 <= PREFILL_F32_TOL, f"[prefill] f32 logits differ from the plain chunked "
         f"path by {err32} (tol {PREFILL_F32_TOL})")
    del got32, want32, model32
    tok_s = PREFILL_B * PREFILL_S / (ms / 1e3)
    print(f"[prefill] smollm-360m full width (L={cfg.n_layers} d={cfg.d_model} "
          f"H={cfg.n_heads}/{cfg.n_kv_heads} V={cfg.vocab}, bf16) B={PREFILL_B} "
          f"S={PREFILL_S}: flash launches {launches}, {ms:.3f} ms per prefill "
          f"({tok_s:.1f} tokens/s), peak memory {peak / 2**30:.3f} GiB; last-position "
          f"logits vs the plain chunked path: max abs err {err:.4f} (tol {PREFILL_TOL}, "
          f"|logit| max {logits.float().abs().max().item():.3f}), argmax agreement {agree:.2f}; "
          f"f32 model, logits at all {PREFILL_B}x{PREFILL_S} positions vs the plain chunked "
          f"path: max abs err {err32:.3e} (tol {PREFILL_F32_TOL}, mean |logit| {mean32:.3f})")
    return cfg, model, dict(launches=launches, ms=ms, tok_s=tok_s, peak=peak, err=err,
                            agree=agree, err_f32=err32)


def phase_serve(torch, cfg, model, dev):
    """Four full-width engines behind the router, through the serving
    entry point's own executor loop."""
    import types

    from repro_torch.launch import serve as S
    from repro_torch.serving.engine import ContinuousBatchingEngine
    from repro_torch.serving.router import RosellaRouter

    engines = [ContinuousBatchingEngine(cfg, model, n_slots=4, max_len=256)
               for _ in SERVE_SLOWDOWNS]
    rates = S.engine_rates(engines, SERVE_SLOWDOWNS, SERVE_NEW)
    router = RosellaRouter(len(engines), float(sum(rates)), seed=SEED, device=dev)
    args = types.SimpleNamespace(requests=SERVE_REQUESTS, arrival_batch=SERVE_BATCH,
                                 n_new=SERVE_NEW)
    t0 = time.perf_counter()
    lat = S._run_engine_executor(args, cfg, engines, list(SERVE_SLOWDOWNS), router,
                                 np.random.RandomState(SEED))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    need(len(lat) == SERVE_REQUESTS, f"[serve] {len(lat)} of {SERVE_REQUESTS} completed")
    need(not any(e.active.any() for e in engines), "[serve] a slot is still active")
    mu = router.mu_hat
    speeds = [1.0 / s for s in SERVE_SLOWDOWNS]
    need(min(mu[0], mu[3]) > mu[2], f"[serve] μ̂ {mu} does not rank the 1x replicas "
         f"above the 5x one")
    tok_s = SERVE_REQUESTS * SERVE_NEW / wall
    print(f"[serve] {len(engines)} smollm-360m engines (slowdowns {list(SERVE_SLOWDOWNS)}, "
          f"4 slots, max_len 256) behind RosellaRouter (ppot_sq2): {len(lat)} requests "
          f"in {wall:.3f} s, latency mean {lat.mean() * 1e3:.3f} ms p95 "
          f"{np.percentile(lat, 95) * 1e3:.3f} ms, decode {tok_s:.1f} tokens/s; "
          f"μ̂ {[round(float(x), 3) for x in mu]} vs true speeds "
          f"{[round(x, 3) for x in speeds]}")
    return dict(n=len(lat), mean_ms=lat.mean() * 1e3, p95_ms=np.percentile(lat, 95) * 1e3,
                tok_s=tok_s, mu=mu.tolist())


def device_profile(torch, fn) -> dict:
    """Run ``fn`` under torch.profiler: its wall clock (s), device busy
    time (us), kernel launches and copies, and per kernel name its launch
    count and device time (us)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = dict(wall=wall, busy_us=0.0, launches=0, copies=0, count={}, us={})
    for e in prof.events():
        if e.device_type.name != "CUDA":
            continue
        us = e.time_range.elapsed_us()
        out["busy_us"] += us
        nm = e.name.lower()
        if "memcpy" in nm or "memset" in nm:
            out["copies"] += 1
            continue
        out["launches"] += 1
        out["count"][e.name] = out["count"].get(e.name, 0) + 1
        out["us"][e.name] = out["us"].get(e.name, 0.0) + us
    need(out["launches"] > 0, "profiler saw no CUDA kernel")
    out["idle"] = 1 - out["busy_us"] / 1e6 / wall
    return out


def phase_model_profile(torch, cfg, model, dev, steps: int = 10):
    """Where model serving's time goes: one full-width prefill, and
    ``steps`` engine ticks with all 4 slots decoding."""
    from repro_torch.models import api
    from repro_torch.serving.engine import ContinuousBatchingEngine

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    toks = torch.randint(0, cfg.vocab, (PREFILL_B, PREFILL_S), generator=gen, device=dev)
    prof = device_profile(torch, lambda: api.prefill(cfg, model, {"tokens": toks}))
    flash_us = sum(us for name, us in prof["us"].items() if "flash_fwd" in name)
    top = sorted(prof["us"].items(), key=lambda kv: -kv[1])[:5]
    print(f"[profile prefill] {prof['wall'] * 1e3:.3f} ms wall, device busy "
          f"{prof['busy_us'] / 1e3:.3f} ms (idle share {prof['idle']:.4f}), {prof['launches']} "
          f"kernel launches; flash attention {flash_us / 1e3:.3f} ms "
          f"({flash_us / prof['busy_us']:.4f} of device time); top by device time: "
          f"{[(nm[:60], round(us / 1e3, 3)) for nm, us in top]}")
    prefill = dict(wall_ms=prof["wall"] * 1e3, busy_ms=prof["busy_us"] / 1e3, idle=prof["idle"],
                   launches=prof["launches"], flash_share=flash_us / prof["busy_us"])

    eng = ContinuousBatchingEngine(cfg, model, n_slots=4, max_len=256)
    rng = np.random.RandomState(SEED)
    eng.try_admit_batch([(i, rng.randint(1, cfg.vocab, size=4), 10 * steps)
                         for i in range(4)])
    eng.step()

    def ticks():
        for _ in range(steps):
            eng.step()
    prof = device_profile(torch, ticks)
    top = sorted(prof["us"].items(), key=lambda kv: -kv[1])[:5]
    print(f"[profile decode] {steps} engine ticks, 4 slots: {prof['wall'] / steps * 1e3:.3f} ms "
          f"per tick, {prof['launches'] / steps:.1f} kernel launches per tick, device busy "
          f"{prof['busy_us'] / steps / 1e3:.3f} ms per tick (idle share {prof['idle']:.4f}); "
          f"top by device time: {[(nm[:60], round(us / 1e3, 3)) for nm, us in top]}")
    decode = dict(tick_ms=prof["wall"] / steps * 1e3, launches=prof["launches"] / steps,
                  busy_ms=prof["busy_us"] / steps / 1e3, idle=prof["idle"])
    return prefill, decode


# ---------------------------------------------------------------------------
# the SSM family: the SSD scan, mamba2 and hymba prefill, mamba2 serving
# ---------------------------------------------------------------------------


def with_mamba2_decays(torch, model, dev):
    """Every SSM layer's A_log and dt_bias drawn from the seed as Mamba2
    draws them (``ref.mamba2_decays``; the same values for the same model
    shape), so that the state reaches across chunks."""
    from repro_torch.kernels.ssd_scan import ref as SR

    gen = torch.Generator(device=dev).manual_seed(SEED)
    with torch.no_grad():
        for layer in model.layers:
            A_log, dt_bias = SR.mamba2_decays(layer.ssm.A_log.shape[0], gen)
            layer.ssm.A_log.copy_(A_log)
            layer.ssm.dt_bias.copy_(dt_bias)
    return model


def ssd_inputs(torch, gen, dev, B, S, H, P, N, *, xdtype, heads: bool, decay: str = "fast"):
    """Inputs shaped like the model's: x silu-sized (bf16 in the bf16
    model), B/C rounded to bf16 as the model's are. decay "fast": dt =
    softplus(N(0,1) - 1), A = -exp(N(0, 0.5²)), near the decays of
    tests/test_kernels.py, under which the carry reaches only the first
    rows of each chunk; "mamba2": A and dt = softplus(N(0,1) + dt_bias)
    from ``ref.mamba2_decays``, under which it reaches across chunks.
    heads: the model layout ([B, S, H, P], B/C [B, S, N]), else the
    reference layout ([BH, S, P], B/C [BH, S, N])."""
    from repro_torch.kernels.ssd_scan import ref as SR

    def r(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    xs = (B, S, H, P) if heads else (B * H, S, P)
    dts = (B, S, H) if heads else (B * H, S)
    x = (r(*xs) * 0.5).to(xdtype)
    if decay == "fast":
        dt = torch.nn.functional.softplus(r(*dts) - 1.0)
        A = -torch.exp(r(H if heads else B * H) * 0.5)
    else:
        A_log, dt_bias = SR.mamba2_decays(H if heads else B * H, gen)
        dt = torch.nn.functional.softplus(r(*dts) + (dt_bias if heads else dt_bias[:, None]))
        A = -torch.exp(A_log)
    G = B if heads else B * H
    Bm, Cm = ((r(G, S, N) * 0.5).bfloat16().float() for _ in range(2))
    return x, dt, A, Bm, Cm


def phase_ssd(torch, SK, SO, SR, dev):
    """K5 against its plain version on the card: the shapes of
    tests/test_kernels.py with x in f32 and bf16 (also against the
    sequential oracle), the mamba2 and hymba layer shapes through ``ops``,
    gcd chunks, and B/C read in place against the broadcast form; each
    with the fast decays of the JAX package's tests and, so that the chunk
    carry is held too, Mamba2's (``ssd_inputs``). Returns the largest abs
    error against the plain version."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    worst = worst_row = 0.0

    def hold(name, got, want, oracle=None):
        nonlocal worst, worst_row
        torch.cuda.synchronize()
        for part, g, w in (("y", got[0], want[0]), ("h", got[1], want[1])):
            need(g.shape == w.shape and g.dtype == w.dtype == torch.float32,
                 f"[ssd] {name} {part}: {g.dtype}{list(g.shape)} vs {w.dtype}{list(w.shape)}")
            need(bool(torch.isfinite(g).all()), f"[ssd] {name} {part}: non-finite output")
            err = (g - w).abs()
            need(bool((err <= SSD_TOL + SSD_TOL * w.abs()).all()),
                 f"[ssd] {name} {part}: max abs err {err.max().item()} above tol {SSD_TOL}")
            row = SR.row_relative_error(g, w)
            need(bool((row <= SSD_ROW_TOL).all()),
                 f"[ssd] {name} {part}: {int((row > SSD_ROW_TOL).sum())} rows above "
                 f"{SSD_ROW_TOL} of the row's largest |value| (worst {row.max().item()})")
            worst, worst_row = max(worst, err.max().item()), max(worst_row, row.max().item())
            msg = (f"[ssd] {name} {part}: max abs err {err.max().item():.3e} (|value| max "
                   f"{w.abs().max().item():.3f}), worst row error {row.max().item():.3e}")
            if oracle is not None:
                o = oracle[0 if part == "y" else 1]
                tol = SSD_ORACLE_TOL[oracle[2]]
                oerr = (g - o).abs()
                need(bool((oerr <= tol + tol * o.abs()).all()),
                     f"[ssd] {name} {part}: {oerr.max().item()} from the sequential oracle "
                     f"(tol {tol})")
                msg += f"; vs the sequential oracle {oerr.max().item():.3e} (tol {tol})"
            print(msg)

    for decay in ("fast", "mamba2"):
        for dt_name, xdt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            for BH, S, P, N, chunk in ((2, 128, 32, 16, 64), (1, 256, 64, 32, 128),
                                       (4, 192, 16, 8, 64)):
                x, dt, A, Bm, Cm = ssd_inputs(torch, gen, dev, BH, S, 1, P, N, xdtype=xdt,
                                              heads=False, decay=decay)
                got = SK.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
                want = SR.ssd_chunked_ref(x, dt, A, Bm, Cm, chunk=chunk)
                oracle = (*SR.ssd_ref(x, dt, A, Bm, Cm), dt_name)
                hold(f"BH={BH} S={S} P={P} N={N} chunk={chunk} x {dt_name} {decay} decays",
                     got, want, oracle)
    for label, B, S, H, P, N, chunk, xdt, decay in (
            ("mamba2 layer", MAMBA_B, MAMBA_S, 32, 64, 128, 128, torch.bfloat16, "fast"),
            ("mamba2 layer", MAMBA_B, MAMBA_S, 32, 64, 128, 128, torch.bfloat16, "mamba2"),
            ("hymba layer", HYMBA_B, HYMBA_S, 50, 64, 16, 128, torch.bfloat16, "fast"),
            ("hymba layer", HYMBA_B, HYMBA_S, 50, 64, 16, 128, torch.bfloat16, "mamba2"),
            # B = 1, S = 2048: the smallest grid of the chunk-parallel scan
            ("mamba2 layer B=1", 1, 2048, 32, 64, 128, 128, torch.bfloat16, "mamba2"),
            ("gcd chunk 4 (S=100, chunk 64)", 2, 100, 4, 64, 128, 64, torch.float32, "mamba2"),
            ("gcd chunk 4 (S=300, chunk 128)", 2, 300, 4, 64, 128, 128, torch.float32,
             "mamba2"),
            ("gcd chunk 32 (S=160, chunk 128)", 2, 160, 6, 64, 128, 128, torch.bfloat16,
             "mamba2"),
            # x rows of 40 bytes: read element by element, not 16 bytes at a time
            ("gcd chunk 32 (S=160, chunk 128), P=20 N=12", 1, 160, 5, 20, 12, 128,
             torch.bfloat16, "fast")):
        x, dt, A, Bm, Cm = ssd_inputs(torch, gen, dev, B, S, H, P, N, xdtype=xdt, heads=True,
                                      decay=decay)
        Q = SO.pick_chunk(S, chunk)
        got = SO.ssd(x, dt, A, Bm, Cm, chunk=chunk)
        want = SR.ssd_chunked_heads(x, dt, A, Bm, Cm, chunk=Q)
        name = (f"ops {label} B={B} S={S} H={H} P={P} N={N} (Q={Q}) "
                f"x {str(xdt).split('.')[-1]} {decay} decays")
        hold(name, got, want)
        if decay == "mamba2":  # the case holds the carry only if dropping it shows
            carry = SR.row_relative_error(SR.without_carry(SR.ssd_chunked_heads, x, dt, A,
                                                           Bm, Cm, chunk=Q)[0], want[0])
            print(f"[ssd] {name}: the plain version without the chunk carry, worst row "
                  f"error {carry.max().item():.3e}")
            need(carry.max().item() > 100 * SSD_ROW_TOL,
                 f"[ssd] {name}: the chunk carry adds too little to be held")
        if label == "mamba2 layer" and decay == "fast":  # the function rounded otherwise
            y64 = SR.ssd_chunked_heads(x, dt, A, Bm, Cm, chunk=64)[0]
            print(f"[ssd] the plain version at chunk 64 against it at chunk 128 (mamba2 "
                  f"layer, y): max abs err {(y64 - want[0]).abs().max().item():.3e}, worst "
                  f"row error {SR.row_relative_error(y64, want[0]).max().item():.3e}")
            del y64
    # B/C once per batch row (G=2) against the broadcast form (G=BH): the
    # kernel does the same arithmetic either way, so the two are equal
    B, H, S, P, N = 2, 8, 512, 64, 128
    x, dt, A, Bm, Cm = ssd_inputs(torch, gen, dev, B, S, H, P, N, xdtype=torch.bfloat16,
                                  heads=False)
    Bg, Cg = Bm[::H].contiguous(), Cm[::H].contiguous()
    got = SK.ssd_scan(x, dt, A, Bg, Cg, chunk=128)
    bcast = SK.ssd_scan(x, dt, A, Bg.repeat_interleave(H, 0), Cg.repeat_interleave(H, 0),
                        chunk=128)
    torch.cuda.synchronize()
    need(torch.equal(got[0], bcast[0]) and torch.equal(got[1], bcast[1]),
         "[ssd] B/C read in place differ from the broadcast form")
    hold(f"in place B/C (G={B}, BH={B * H}) S={S} P={P} N={N} x bfloat16", got,
         SR.ssd_chunked_ref(x, dt, A, Bg, Cg, chunk=128))
    print(f"[ssd] in place B/C equal to the broadcast form (y and h bit for bit)")
    print(f"[ssd] all cases: max abs err {worst:.3e}, worst row error {worst_row:.3e} "
          f"(tol {SSD_TOL}, row tol {SSD_ROW_TOL})")
    return worst


class no_chunk_carry:
    """A planted fault, to show what the model-level bars can see: inside
    the block the model's SSD scan is K5 with the chunk carry left out
    (every chunk starts from a zero state, as if ``h_in`` were 0)."""

    def __enter__(self):
        from repro_torch.kernels.ssd_scan import ops as SO
        from repro_torch.kernels.ssd_scan import ref as SR
        from repro_torch.models import ssm as SSM

        def faulty(cfg, x, dt, A, Bm, Cm):
            return SR.without_carry(SO.ssd, x, dt, A, Bm, Cm,
                                    chunk=SO.pick_chunk(x.shape[1], cfg.ssm_chunk))

        self.SSM, self.saved = SSM, SSM.ssd_prefill
        SSM.ssd_prefill = faulty

    def __exit__(self, *exc):
        self.SSM.ssd_prefill = self.saved


def phase_ssm_prefill(torch, SK, FK, dev, arch, B, S):
    """The full-width prefill of an SSM-family model (random weights from
    the seed, A_log and dt_bias as Mamba2 draws them) through
    ``api.prefill``: exactly one K5 launch per layer (and one K4 launch per
    layer for the hybrid); its last-position logits against the plain
    paths on the card; the same model in f32, logits at every position,
    against its plain paths, and a planted fault (no chunk carry) that the
    f32 bar must see."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import api
    from repro_torch.models import lm as LM

    cfg = configs.get_config(arch)
    model = with_mamba2_decays(torch, api.init_params(cfg, SEED, dev), dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    toks = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    SK.reset_launches()
    FK.reset_launches()
    logits = api.prefill(cfg, model, {"tokens": toks})
    torch.cuda.synchronize()
    ssd = SK.launch_counts()["ssd_scan"]
    grids = SK.launch_counts()["ssd_scan_grids"]
    flash = FK.launch_counts()["flash_attention_fwd"]
    peak = torch.cuda.max_memory_allocated()
    want_flash = cfg.n_layers if cfg.family == "hybrid" else 0
    need(ssd == cfg.n_layers, f"[prefill {arch}] {ssd} SSD-scan launches, expected one "
         f"per layer ({cfg.n_layers})")
    need(grids == SK.GRIDS * cfg.n_layers and grids > cfg.n_layers, f"[prefill {arch}] "
         f"{grids} SSD-scan grids, expected {SK.GRIDS} per layer")
    need(flash == want_flash, f"[prefill {arch}] {flash} flash-attention launches, "
         f"expected {want_flash}")
    need(logits.shape == (B, 1, cfg.vocab) and logits.dtype == torch.bfloat16,
         f"[prefill {arch}] logits {logits.dtype}{list(logits.shape)}")
    need(bool(torch.isfinite(logits).all()), f"[prefill {arch}] non-finite logits")
    ms = host_median_ms(torch, lambda: api.prefill(cfg, model, {"tokens": toks}), reps=5)
    with api.plain_paths():
        plain = api.prefill(cfg, model, {"tokens": toks})
        # the same function rounded otherwise: the floor of the bf16 check
        plain64 = api.prefill(dataclasses.replace(cfg, ssm_chunk=64), model, {"tokens": toks})
        torch.cuda.synchronize()
    with no_chunk_carry():
        faulty = api.prefill(cfg, model, {"tokens": toks})
        torch.cuda.synchronize()
    err = (logits.float() - plain.float()).abs().max().item()
    floor = (plain64.float() - plain.float()).abs().max().item()
    fault = (faulty.float() - plain.float()).abs().max().item()
    agree = (logits.argmax(-1) == plain.argmax(-1)).float().mean().item()
    agree_floor = (plain64.argmax(-1) == plain.argmax(-1)).float().mean().item()
    out = dict(ssd_launches=ssd, ssd_grids=grids, flash_launches=flash, ms=ms,
               tok_s=B * S / (ms / 1e3),
               peak=peak, err=err, floor=floor, fault=fault, agree=agree)
    print(f"[prefill {arch}] full width (L={cfg.n_layers} d={cfg.d_model} "
           f"H_ssm={cfg.n_ssm_heads} P={cfg.ssm_headdim} N={cfg.ssm_state} V={cfg.vocab}, "
           f"bf16) B={B} S={S}: SSD launches {ssd} ({grids} grids), flash launches "
           f"{flash}, {ms:.3f} ms per "
           f"prefill ({out['tok_s']:.1f} tokens/s), peak memory {peak / 2**30:.3f} GiB; "
           f"last-position logits vs the plain path: max abs err {err:.4f} (tol "
           f"{SSM_PREFILL_TOL}, |logit| max {logits.float().abs().max().item():.3f}; the "
           f"plain path against itself at chunk 64: {floor:.4f}; K5 without the chunk carry: "
           f"{fault:.4f}), argmax agreement {agree:.2f} (the plain path at chunk 64: "
           f"{agree_floor:.2f})")
    need(err <= SSM_PREFILL_TOL, f"[prefill {arch}] logits differ from the plain path by "
         f"{err} (tol {SSM_PREFILL_TOL})")
    need(agree >= agree_floor, f"[prefill {arch}] argmax agreement {agree} below the plain "
         f"path's own at chunk 64 ({agree_floor})")
    del logits, plain, plain64, faulty
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    model32 = with_mamba2_decays(torch, api.init_params(cfg32, SEED, dev), dev)

    @torch.no_grad()
    def all_logits():
        return LM.logits_head(cfg32, model32, LM.forward(cfg32, model32, toks))

    SK.reset_launches()
    got32 = all_logits()
    torch.cuda.synchronize()
    need(SK.launch_counts()["ssd_scan"] == cfg.n_layers,
         f"[prefill {arch}] the f32 model did not go through the kernel in every layer")
    with no_chunk_carry():
        fault32 = all_logits()
    with api.plain_paths():
        want32 = all_logits()
        err32 = (got32 - want32).abs().max().item()
        fault32 = (fault32 - want32).abs().max().item()
        del got32
        cfg32 = dataclasses.replace(cfg32, ssm_chunk=64)
        floor32 = (all_logits() - want32).abs().max().item()
        torch.cuda.synchronize()
    mean32 = want32.abs().mean().item()
    out.update(err_f32=err32, floor_f32=floor32, fault_f32=fault32)
    print(f"[prefill {arch}] f32 model, logits at all {B}x{S} positions vs the plain path: "
          f"max abs err {err32:.3e} (tol {SSM_PREFILL_F32_TOL}, mean |logit| {mean32:.3f}; "
          f"the plain path against itself at chunk 64: {floor32:.3e}; K5 without the chunk "
          f"carry: {fault32:.3e})")
    need(math.isfinite(err32) and err32 <= SSM_PREFILL_F32_TOL, f"[prefill {arch}] f32 "
         f"logits differ from the plain path by {err32} (tol {SSM_PREFILL_F32_TOL})")
    need(fault32 > SSM_PREFILL_F32_TOL, f"[prefill {arch}] the f32 bar {SSM_PREFILL_F32_TOL} "
         f"does not see K5 without its chunk carry ({fault32})")
    del want32, model32
    return cfg, model, out


def recording_engine_class(Engine):
    class RecordingEngine(Engine):
        """An engine that records, per request, its slot, whether the slot
        had held a request before, its prompt and its tokens."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.used = [False] * self.n_slots
            self.log = {}

        def try_admit_batch(self, requests):
            free = [i for i in range(self.n_slots) if not self.active[i]]
            accept = super().try_admit_batch(requests)
            slots = iter(free)
            for (rid, prompt, _n), ok in zip(requests, accept):
                if ok:
                    i = next(slots)
                    self.log[rid] = dict(slot=i, reused=self.used[i], prompt=np.asarray(prompt))
                    self.used[i] = True
            return accept

        def step(self):
            done = super().step()
            for rid, toks in done:
                self.log[rid]["tokens"] = list(toks)
            return done
    return RecordingEngine


def phase_ssm_serve(torch, cfg, model, dev):
    """Four full-width mamba2 engines behind the router (16 slots for 32
    requests, so slots are reused on the card); then requests served in a
    reused slot against a fresh run of the same prompt in the same slot of
    a new engine."""
    import types

    from repro_torch.launch import serve as S
    from repro_torch.serving.engine import ContinuousBatchingEngine
    from repro_torch.serving.router import RosellaRouter

    Engine = recording_engine_class(ContinuousBatchingEngine)
    engines = [Engine(cfg, model, n_slots=4, max_len=256) for _ in SERVE_SLOWDOWNS]
    rates = S.engine_rates(engines, SERVE_SLOWDOWNS, SERVE_NEW)
    router = RosellaRouter(len(engines), float(sum(rates)), seed=SEED, device=dev)
    args = types.SimpleNamespace(requests=SSM_SERVE_REQUESTS, arrival_batch=SERVE_BATCH,
                                 n_new=SERVE_NEW)
    t0 = time.perf_counter()
    lat = S._run_engine_executor(args, cfg, engines, list(SERVE_SLOWDOWNS), router,
                                 np.random.RandomState(SEED))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    need(len(lat) == SSM_SERVE_REQUESTS, f"[serve {cfg.arch}] {len(lat)} of "
         f"{SSM_SERVE_REQUESTS} completed")
    need(not any(e.active.any() for e in engines), f"[serve {cfg.arch}] a slot is still active")
    mu = router.mu_hat
    need(min(mu[0], mu[3]) > mu[2], f"[serve {cfg.arch}] μ̂ {mu} does not rank the 1x "
         f"replicas above the 5x one")
    reused = [(e, rid, rec) for e in engines for rid, rec in e.log.items()
              if rid >= 0 and rec["reused"]]
    need(len(reused) >= SSM_REUSE_CHECKS, f"[serve {cfg.arch}] only {len(reused)} requests "
         f"were served in a reused slot")
    for _e, rid, rec in reused[:SSM_REUSE_CHECKS]:
        fresh = ContinuousBatchingEngine(cfg, model, n_slots=4, max_len=256)
        filler = np.array([1, 2, 3, 4])
        reqs = [(-2 - k, filler, SERVE_NEW) for k in range(rec["slot"])]
        fresh.try_admit_batch(reqs + [(rid, rec["prompt"], SERVE_NEW)])
        toks = None
        while toks is None:
            toks = next((t for r, t in fresh.step() if r == rid), None)
        need(toks == rec["tokens"], f"[serve {cfg.arch}] request {rid} in reused slot "
             f"{rec['slot']} gave {rec['tokens']}, a fresh run {toks}")
    tok_s = SSM_SERVE_REQUESTS * SERVE_NEW / wall
    print(f"[serve {cfg.arch}] {len(engines)} engines (slowdowns {list(SERVE_SLOWDOWNS)}, 4 "
          f"slots, max_len 256) behind RosellaRouter (ppot_sq2): {len(lat)} requests in "
          f"{wall:.3f} s, latency mean {lat.mean() * 1e3:.3f} ms p95 "
          f"{np.percentile(lat, 95) * 1e3:.3f} ms, decode {tok_s:.1f} tokens/s; μ̂ "
          f"{[round(float(x), 3) for x in mu]} vs true speeds "
          f"{[round(1.0 / s, 3) for s in SERVE_SLOWDOWNS]}; {len(reused)} requests in reused "
          f"slots, {SSM_REUSE_CHECKS} of them equal to a fresh run of their prompt")
    return dict(n=len(lat), mean_ms=lat.mean() * 1e3, p95_ms=np.percentile(lat, 95) * 1e3,
                tok_s=tok_s, mu=mu.tolist(), reused=len(reused))


def prefill_profile(torch, cfg, model, dev, B, S) -> dict:
    """One full-width prefill of an SSM-family model under the profiler:
    device busy, launches, and the shares of K5's grids and K4."""
    from repro_torch.models import api

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    toks = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev)
    prof = device_profile(torch, lambda: api.prefill(cfg, model, {"tokens": toks}))
    ssd_us = sum(us for name, us in prof["us"].items() if "ssd_scan" in name)
    ssd_n = sum(n for name, n in prof["count"].items() if "ssd_scan" in name)
    flash_us = sum(us for name, us in prof["us"].items() if "flash_fwd" in name)
    flash_n = sum(n for name, n in prof["count"].items() if "flash_fwd" in name)
    top = sorted(prof["us"].items(), key=lambda kv: -kv[1])[:5]
    print(f"[profile prefill {cfg.arch}] B={B} S={S}: {prof['wall'] * 1e3:.3f} ms wall, device "
          f"busy {prof['busy_us'] / 1e3:.3f} ms (idle share {prof['idle']:.4f}), "
          f"{prof['launches']} kernel launches of which {ssd_n} SSD-scan grids and {flash_n} "
          f"flash attention; SSD scan {ssd_us / 1e3:.3f} ms ({ssd_us / prof['busy_us']:.4f} of "
          f"device time), flash attention {flash_us / 1e3:.3f} ms "
          f"({flash_us / prof['busy_us']:.4f}); top by device time: "
          f"{[(nm[:60], round(us / 1e3, 3)) for nm, us in top]}")
    return dict(wall_ms=prof["wall"] * 1e3, busy_ms=prof["busy_us"] / 1e3, idle=prof["idle"],
                launches=prof["launches"], ssd_grids=ssd_n, ssd_share=ssd_us / prof["busy_us"],
                flash_launches=flash_n, flash_share=flash_us / prof["busy_us"])


def phase_ssm_profile(torch, cfg, model, dev, steps: int = 10):
    """Where mamba2 serving's time goes: one full-width prefill, and
    ``steps`` engine ticks with all 4 slots decoding."""
    from repro_torch.serving.engine import ContinuousBatchingEngine

    prefill = prefill_profile(torch, cfg, model, dev, MAMBA_B, MAMBA_S)

    eng = ContinuousBatchingEngine(cfg, model, n_slots=4, max_len=256)
    rng = np.random.RandomState(SEED)
    eng.try_admit_batch([(i, rng.randint(1, cfg.vocab, size=4), 10 * steps)
                         for i in range(4)])
    eng.step()

    def ticks():
        for _ in range(steps):
            eng.step()
    prof = device_profile(torch, ticks)
    top = sorted(prof["us"].items(), key=lambda kv: -kv[1])[:5]
    print(f"[profile decode {cfg.arch}] {steps} engine ticks, 4 slots: "
          f"{prof['wall'] / steps * 1e3:.3f} ms per tick, {prof['launches'] / steps:.1f} kernel "
          f"launches per tick, device busy {prof['busy_us'] / steps / 1e3:.3f} ms per tick "
          f"(idle share {prof['idle']:.4f}); top by device time: "
          f"{[(nm[:60], round(us / 1e3, 3)) for nm, us in top]}")
    decode = dict(tick_ms=prof["wall"] / steps * 1e3, launches=prof["launches"] / steps,
                  busy_ms=prof["busy_us"] / steps / 1e3, idle=prof["idle"])
    return prefill, decode


# ---------------------------------------------------------------------------
# the model zoo's MoE, VLM and encoder-decoder families (ROADMAP A10a)
# ---------------------------------------------------------------------------


def load_summary(stats: "list[dict]") -> dict:
    """The MoE line's numbers over a prefill's layers (``RouteTape.stats``)."""
    stats = [{k: float(v) for k, v in s.items()} for s in stats]
    return dict(layers=len(stats), capacity=stats[0]["capacity"],
                max_load=max(s["max_load"] for s in stats),
                mean_load=float(np.mean([s["mean_load"] for s in stats])),
                overflow_frac=float(np.mean([s["overflow_frac"] for s in stats])),
                overflow_max=max(s["overflow_frac"] for s in stats))


def zoo_inputs(torch, cfg, B: int, S: int, dev, seed: int = SEED) -> dict:
    """A prefill batch from the seed: tokens, and the stub frontends'
    embeddings (pixtral's patches, whisper's frames) as N(0, 1) bf16."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    b = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev)}
    if cfg.family == "vlm":
        b["patch_embeds"] = torch.randn(B, cfg.n_patches, cfg.d_model, generator=gen,
                                        device=dev).to(torch.bfloat16)
    if cfg.family == "encdec":
        b["frame_embeds"] = torch.randn(B, cfg.enc_len, cfg.d_model, generator=gen,
                                        device=dev).to(torch.bfloat16)
    return b


def zoo_prefill(torch, FK, dev, cfg, model, batch, tag: str, want_flash: int) -> dict:
    """One prefill through ``api.prefill`` with the K4 launches counted (and
    an MoE model's routes taped, ``moe.RouteTape``), timed (host clock, 5
    calls), its last-position logits against the plain paths on the card
    on the same routes, and the floor of that check: the plain path against
    itself with attention chunks of 256 instead of 512 (the same function
    rounded otherwise). Also the plain path on its own routes (``free``)
    and how many tokens' routes it changed."""
    import dataclasses

    from repro_torch.models import api
    from repro_torch.models import moe as MOE

    B, S = batch["tokens"].shape
    tape = MOE.RouteTape()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    FK.reset_launches()
    with tape.recording():
        logits = api.prefill(cfg, model, batch)
        torch.cuda.synchronize()
    flash = FK.launch_counts()["flash_attention_fwd"]
    peak = torch.cuda.max_memory_allocated()
    need(flash == want_flash, f"{tag} {flash} flash-attention launches, expected {want_flash}")
    need(logits.shape == (B, 1, cfg.vocab) and logits.dtype == torch.bfloat16,
         f"{tag} logits {logits.dtype}{list(logits.shape)}")
    need(bool(torch.isfinite(logits).all()), f"{tag} non-finite logits")
    ms = host_median_ms(torch, lambda: api.prefill(cfg, model, batch), reps=5)
    with api.plain_paths():
        with tape.replaying():
            plain = api.prefill(cfg, model, batch)
        flips = tape.flips
        with tape.replaying():
            plain256 = api.prefill(dataclasses.replace(cfg, attn_chunk=256), model, batch)
        free = api.prefill(cfg, model, batch)
        torch.cuda.synchronize()
    err = (logits.float() - plain.float()).abs().max().item()
    floor = (plain256.float() - plain.float()).abs().max().item()
    agree = (logits.argmax(-1) == plain.argmax(-1)).float().mean().item()
    agree_floor = (plain256.argmax(-1) == plain.argmax(-1)).float().mean().item()
    out = dict(flash_launches=flash, ms=ms, tok_s=B * S / (ms / 1e3), peak=peak, err=err,
               floor=floor, agree=agree, agree_floor=agree_floor,
               logit_max=logits.float().abs().max().item())
    if tape.stats:
        out["moe"] = load_summary(tape.stats)
        out.update(route_flips=flips, free_err=(logits.float() - free.float()).abs().max().item(),
                   free_agree=(logits.argmax(-1) == free.argmax(-1)).float().mean().item())
    return out, logits


def zoo_greedy_steps(torch, cfg, model, batch, steps: int, enc_out=None) -> dict:
    """``steps`` greedy ``decode_fn`` steps from an empty cache, from the
    prompt's first token, each row routed alone (the engine's decode): ms a
    step (host clock) and finite logits."""
    from repro_torch.models import api

    B = batch["tokens"].shape[0]
    cache = api.init_cache(cfg, B, steps + 1, batch["tokens"].device)
    tok = batch["tokens"][:, :1]
    ts = []
    for t in range(steps):
        b = {"tokens": tok, "pos": t}
        if enc_out is not None:
            b["enc_out"] = enc_out
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = api.decode_fn(cfg, model, b, cache, per_row=True)
        tok = torch.argmax(logits[:, -1:], -1)
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
        need(bool(torch.isfinite(logits).all()), f"[decode {cfg.arch}] non-finite logits at "
             f"step {t}")
    return dict(steps=steps, step_ms=float(np.median(ts[1:] if steps > 1 else ts)))


def phase_moe_prefill(torch, FK, dev):
    """moonshot-v1-16b-a3b at its published widths, MOE_LAYERS deep: a
    prefill at B=4, S=4096 through ``api.prefill``, one K4 launch a layer
    at D = 128, held against the plain paths; the MoE line (expert loads of
    every MoE layer, the capacity, the overflow); then the same model in
    f32 at MOE_F32_LAYERS, its hidden states at every position and its
    last-position logits against the plain paths."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import api
    from repro_torch.models import lm as LM
    from repro_torch.models import moe as MOE

    cfg = configs.get_config(MOE_ARCH, n_layers=MOE_LAYERS)
    t0 = time.perf_counter()
    model = api.init_params(cfg, SEED, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    batch = zoo_inputs(torch, cfg, MOE_B, MOE_S, dev)
    tag = f"[prefill {MOE_ARCH}]"
    out, logits = zoo_prefill(torch, FK, dev, cfg, model, batch, tag, cfg.n_layers)
    m = out["moe"]
    need(m["layers"] == cfg.n_layers - cfg.first_k_dense, f"{tag} {m['layers']} MoE layers ran")
    print(f"{tag} published widths (d={cfg.d_model} H={cfg.n_heads}/{cfg.n_kv_heads} "
          f"D={cfg.d_head} experts {cfg.n_experts} top-{cfg.top_k} shared {cfg.n_shared} "
          f"moe_dff {cfg.moe_dff} V={cfg.vocab}, bf16), depth cut to {cfg.n_layers} "
          f"({cfg.first_k_dense} dense + {cfg.n_layers - cfg.first_k_dense} MoE), "
          f"{nbytes / 1e9:.3f} GB of parameters (init {init_s:.2f} s), B={MOE_B} S={MOE_S}: "
          f"flash launches {out['flash_launches']} (D={cfg.d_head}), {out['ms']:.3f} ms per "
          f"prefill ({out['tok_s']:.1f} tokens/s), peak memory {out['peak'] / 2**30:.3f} GiB; "
          f"last-position logits vs the plain path on the kernel path's expert routes: max "
          f"abs err {out['err']:.4f} (tol {MOE_PREFILL_TOL[MOE_ARCH]}, |logit| max "
          f"{out['logit_max']:.3f}; the plain path against itself at attention chunks of "
          f"256: {out['floor']:.4f}), argmax agreement {out['agree']:.2f} (the plain path at "
          f"chunks of 256: {out['agree_floor']:.2f}); the plain path on its own routes "
          f"(routes of {out['route_flips']} of {MOE_B * MOE_S} tokens differ in some layer): "
          f"max abs err {out['free_err']:.4f}, argmax agreement {out['free_agree']:.2f}")
    print(f"[moe {MOE_ARCH}] prefill's {m['layers']} MoE layers, {MOE_B * MOE_S} tokens, "
          f"top-{cfg.top_k} of {cfg.n_experts}: capacity {m['capacity']} a layer, max expert "
          f"load {m['max_load']:.0f}, mean {m['mean_load']:.1f}, overflow fraction "
          f"{m['overflow_frac']:.6f} (mean over the layers; largest {m['overflow_max']:.6f})")
    need(out["err"] <= MOE_PREFILL_TOL[MOE_ARCH], f"{tag} logits differ from the plain path "
         f"by {out['err']} (tol {MOE_PREFILL_TOL[MOE_ARCH]})")
    del logits

    cfg32 = dataclasses.replace(cfg, n_layers=MOE_F32_LAYERS, dtype="float32",
                                param_dtype="float32")
    model32 = api.init_params(cfg32, SEED, dev)
    toks = batch["tokens"]
    tape = MOE.RouteTape()

    @torch.no_grad()
    def hidden():
        return LM.forward(cfg32, model32, toks)

    FK.reset_launches()
    with tape.recording():
        got_h = hidden()
        torch.cuda.synchronize()
    need(FK.launch_counts()["flash_attention_fwd"] == cfg32.n_layers,
         f"{tag} the f32 model did not go through the kernel in every layer")
    with api.plain_paths(), tape.replaying():
        want_h = hidden()
        torch.cuda.synchronize()
    err_h = (got_h - want_h).abs().max().item()
    # logits at every position, a batch row at a time ([S, V] f32 is 2.7 GB)
    err_l, same, mean_l = 0.0, 0, 0.0
    with torch.no_grad():
        for b in range(MOE_B):
            gl = LM.logits_head(cfg32, model32, got_h[b])
            wl = LM.logits_head(cfg32, model32, want_h[b])
            err_l = max(err_l, (gl - wl).abs().max().item())
            same += int((gl.argmax(-1) == wl.argmax(-1)).sum())
            mean_l += wl.abs().mean().item() / MOE_B
            del gl, wl
    agree = same / (MOE_B * MOE_S)
    out.update(err_f32_hidden=err_h, err_f32_logits=err_l, agree_f32=agree,
               f32_route_flips=tape.flips, init_s=init_s, param_bytes=nbytes)
    print(f"{tag} f32 model at {cfg32.n_layers} layers vs the plain path on the kernel path's "
          f"routes: hidden states at all {MOE_B}x{MOE_S} positions max abs err {err_h:.3e}, "
          f"logits at all positions max abs err {err_l:.3e} (tol {MOE_F32_TOL}, mean |logit| "
          f"{mean_l:.3f}), argmax agreement {agree:.6f} (bar {MOE_F32_AGREE}); the plain "
          f"path's own routes differ in {tape.flips} tokens")
    need(math.isfinite(err_h) and err_l <= MOE_F32_TOL, f"{tag} f32 logits differ from the "
         f"plain path by {err_l} (tol {MOE_F32_TOL})")
    need(agree >= MOE_F32_AGREE, f"{tag} f32 argmax agreement {agree} (bar {MOE_F32_AGREE})")
    del got_h, want_h, model32
    torch.cuda.empty_cache()
    return cfg, model, out


def moe_recording_engine_class(Engine):
    base = recording_engine_class(Engine)

    class MoeRecordingEngine(base):
        """A recording engine that also keeps, per request, its logits at
        each generated token and the fewest other requests active beside
        it at any of its decode steps."""

        def step(self):
            act = [i for i in range(self.n_slots) if self.active[i]]
            rids = {i: self.slots[i].rid for i in act}
            done = super().step()
            if self.last_logits is not None:
                for i in act:
                    rec = self.log[rids[i]]
                    rec.setdefault("logits", []).append(self.last_logits[i, -1].float().cpu())
                    rec["company"] = min(rec.get("company", self.n_slots), len(act) - 1)
            return done
    return MoeRecordingEngine


def solo_tokens(torch, Engine, cfg, model, prompt, n_new: int) -> dict:
    """One request decoded alone in a one-slot engine: its record (tokens,
    logits at each generated token)."""
    alone = Engine(cfg, model, n_slots=1, max_len=256)
    alone.try_admit_batch([(0, prompt, n_new)])
    while alone.active.any():
        alone.step()
    return alone.log[0]


def rows_against_solo(torch, Engine, cfg, model, recs, n_new: int) -> dict:
    """Each (rid, record) of a request decoded beside others, against the
    same request alone in a one-slot engine: equal in every token, or the
    first step where the two part with the one-slot run's top-2 logit gap
    and the two runs' largest logit difference there; the largest logit
    difference over the steps both runs share."""
    equal, parted, diffs = [], [], []
    for rid, rec in recs:
        solo = solo_tokens(torch, Engine, cfg, model, rec["prompt"], n_new)
        for i, (g, w) in enumerate(zip(rec["tokens"], solo["tokens"])):
            d = float((rec["logits"][i] - solo["logits"][i]).abs().max())
            diffs.append(d)
            if g != w:
                gap = float(torch.topk(solo["logits"][i], 2).values.diff().abs())
                parted.append((rid, i, gap, d))
                break
        else:
            equal.append(rid)
    return dict(equal=equal, parted=parted, logit_diff_max=max(diffs))


def phase_moe_serve(torch, cfg, model, dev, chk):
    """Four moonshot engines behind the router (``_run_engine_executor``):
    every request completes, μ̂ ranks the replicas, and the router launched
    K1 and ``alias_table`` (counted from its construction); served requests
    against each alone in a one-slot engine (bf16: a 4-row step and a 1-row
    step round their products otherwise, so greedy tokens may part at a
    near-tie; reported). Then the per-row routing check in f32 (the model
    at MOE_F32_LAYERS, published widths): 2 x 4 requests decoded in a full
    4-slot engine, each against itself alone in a one-slot engine, equal
    token for token but where the one-slot run's two largest logits lie
    within MOE_NEAR_TIE_F32, at least MOE_ROW_CHECKS of them in every
    token; and one joint decode step (``decode_fn`` without ``per_row``:
    the rows share the experts' capacity) against the per-row step."""
    import dataclasses
    import types

    from repro_torch.launch import serve as S
    from repro_torch.models import api
    from repro_torch.serving.engine import ContinuousBatchingEngine
    from repro_torch.serving.router import RosellaRouter

    K = chk.K

    tag = f"[serve {cfg.arch}]"
    Engine = moe_recording_engine_class(ContinuousBatchingEngine)
    engines = [Engine(cfg, model, n_slots=4, max_len=256) for _ in SERVE_SLOWDOWNS]
    rates = S.engine_rates(engines, SERVE_SLOWDOWNS, SERVE_NEW)
    # the router's launches from its construction on: its alias table is
    # built there, and a refreshed μ̂ is adopted (the table rebuilt) only at
    # the next route; the executor routes all requests before the first
    # completes, so the run's own launches are its K1 routes
    torch.cuda.synchronize()
    K.reset_launches()
    router = RosellaRouter(len(engines), float(sum(rates)), seed=SEED, device=dev)
    args = types.SimpleNamespace(requests=MOE_SERVE_REQUESTS, arrival_batch=SERVE_BATCH,
                                 n_new=SERVE_NEW)
    t0 = time.perf_counter()
    lat = S._run_engine_executor(args, cfg, engines, list(SERVE_SLOWDOWNS), router,
                                 np.random.RandomState(SEED))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.launch_counts()
    for name in ("ppot_dispatch_fused_alias", "alias_table"):
        need(launches[name] > 0, f"{tag} the router launched {name} no time "
             f"(launches {launches})")
    # the keyed K1 at the router's shape, on its final table and queue view
    need((router.n, SERVE_BATCH) == MOE_ROUTER_SHAPE, f"{tag} the router's shape moved")
    hold_keyed(torch, chk, router.table_front.prob, router.table_front.alias, router.q_view,
               SERVE_BATCH, SEED, dev)
    need(len(lat) == MOE_SERVE_REQUESTS, f"{tag} {len(lat)} of {MOE_SERVE_REQUESTS} completed")
    need(not any(e.active.any() for e in engines), f"{tag} a slot is still active")
    mu = router.mu_hat
    need(min(mu[0], mu[3]) > mu[2], f"{tag} μ̂ {mu} does not rank the 1x replicas above the "
         f"5x one")
    served = sorted(((rec["company"], rid, rec) for e in engines for rid, rec in e.log.items()
                     if rid >= 0), key=lambda t: (-t[0], t[1]))
    shared = [(rid, rec) for comp, rid, rec in served if comp >= 1]
    bf16 = rows_against_solo(torch, Engine, cfg, model, shared[:2 * MOE_ROW_CHECKS], SERVE_NEW)
    tok_s = MOE_SERVE_REQUESTS * SERVE_NEW / wall
    out = dict(n=len(lat), mean_ms=lat.mean() * 1e3, p95_ms=np.percentile(lat, 95) * 1e3,
               tok_s=tok_s, mu=mu.tolist(), shared=len(shared), bf16_solo=bf16,
               launches=launches)
    print(f"{tag} {len(engines)} engines (slowdowns {list(SERVE_SLOWDOWNS)}, 4 slots, max_len "
          f"256, {cfg.n_layers} layers, bf16) behind RosellaRouter (ppot_sq2): {len(lat)} "
          f"requests in {wall:.3f} s, router launches {launches}, latency mean "
          f"{out['mean_ms']:.3f} ms p95 "
          f"{out['p95_ms']:.3f} ms, decode {tok_s:.1f} tokens/s; μ̂ "
          f"{[round(float(x), 3) for x in mu]} vs true speeds "
          f"{[round(1.0 / s, 3) for s in SERVE_SLOWDOWNS]}; {len(shared)} requests decoded "
          f"beside others at every step, {len(bf16['equal']) + len(bf16['parted'])} of them "
          f"against a one-slot engine: {len(bf16['equal'])} equal in all {SERVE_NEW} tokens, "
          f"parted (rid, step, one-slot top-2 gap, logit difference) {bf16['parted']}, logits "
          f"apart by at most {bf16['logit_diff_max']:.4f}")

    # the per-row check, in f32
    cfg32 = dataclasses.replace(cfg, n_layers=MOE_F32_LAYERS, dtype="float32",
                                param_dtype="float32")
    model32 = api.init_params(cfg32, SEED, dev)
    rng = np.random.RandomState(SEED + 1)
    recs = []
    for b in range(2):
        full = Engine(cfg32, model32, n_slots=4, max_len=256)
        reqs = [(4 * b + i, rng.randint(1, cfg.vocab, size=4 + i), SERVE_NEW) for i in range(4)]
        need(all(full.try_admit_batch(reqs)), f"{tag} the f32 engine refused a request")
        while full.active.any():
            full.step()
        recs += [(rid, full.log[rid]) for rid, _p, _n in reqs]
    need(all(rec["company"] == 3 for _rid, rec in recs), f"{tag} an f32 request was decoded "
         f"beside fewer than 3 others")
    f32 = rows_against_solo(torch, Engine, cfg32, model32, recs, SERVE_NEW)
    for rid, i, gap, d in f32["parted"]:
        need(gap < MOE_NEAR_TIE_F32, f"{tag} f32 request {rid} decoded beside 3 others parts "
             f"from its one-slot run at step {i}, top-2 gap {gap} (near-tie bar "
             f"{MOE_NEAR_TIE_F32}): its experts were not routed as alone")
    need(len(f32["equal"]) >= MOE_ROW_CHECKS, f"{tag} only {len(f32['equal'])} f32 requests "
         f"equal to their one-slot runs")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    toks = torch.randint(1, cfg.vocab, (4, 1), generator=gen, device=dev)
    cache = api.init_cache(cfg32, 4, 8, dev)
    per_row, _ = api.decode_fn(cfg32, model32, {"tokens": toks, "pos": 0}, cache, per_row=True)
    joint, _ = api.decode_fn(cfg32, model32, {"tokens": toks, "pos": 0}, cache)
    moved = (per_row - joint).abs().max().item()
    out.update(f32_rows=f32, joint_moved=moved)
    print(f"{tag} per-row routing, f32 at {cfg32.n_layers} layers: {len(recs)} requests decoded "
          f"in full 4-slot engines, each against itself alone in a one-slot engine: "
          f"{len(f32['equal'])} equal in all {SERVE_NEW} tokens, parted at near-ties "
          f"{f32['parted']} (bar {MOE_NEAR_TIE_F32}), logits apart by at most "
          f"{f32['logit_diff_max']:.3e}; a joint decode step (the 4 rows sharing the experts' "
          f"capacity) moves the logits by {moved:.4f}")
    need(moved > 1e-2 and moved > 100 * f32["logit_diff_max"], f"{tag} the joint decode moved "
         f"the f32 logits by {moved}, not far beyond a row's rounding "
         f"({f32['logit_diff_max']})")
    del model32
    torch.cuda.empty_cache()
    return out


def phase_moe_balance(torch, dev):
    """``benchmarks/moe_balance.py``'s settings on the card: T tokens, E
    experts, top-k, gates softmax(N(0, 1.5²) + linspace(2, 0, E)) from
    ``PRNGKey(seed)``; ``topk_route`` integer-equal to its CPU run on the
    same gates, ``ppot_route`` (key ``fold_in(PRNGKey(seed), 1)``), each
    one's ``expert_load_stats``, and the reference's claim: ppot's overflow
    below top-k's."""
    from repro_torch.models import moe as MOE
    from repro_torch.models.config import ModelConfig
    from repro_torch.utils import prng

    T, E, k, seed = (MOE_BALANCE[x] for x in ("T", "E", "k", "seed"))
    cfg = ModelConfig(arch="bench", family="moe", n_layers=1, d_model=64, n_heads=1,
                      n_kv_heads=1, d_head=64, d_ff=0, vocab=16, n_experts=E, top_k=k,
                      moe_dff=64, capacity_factor=1.25)
    key = prng.PRNGKey(seed)
    logits = prng.normal(key, (T, E), dev) * 1.5 + torch.linspace(2, 0, E, device=dev)[None]
    gates = torch.softmax(logits, -1)
    out = {}
    for name, route in (("topk", lambda g: MOE.topk_route(cfg, g)),
                        ("ppot", lambda g: MOE.ppot_route(cfg, g, prng.fold_in(key, 1)))):
        idx, w = route(gates)
        ms = event_median_ms(torch, lambda: route(gates), reps=20)
        cpu_idx, _ = route(gates.cpu())
        stats = {kk: float(v) for kk, v in MOE.expert_load_stats(cfg, gates, idx).items()}
        same = float((idx.cpu() == cpu_idx).all(-1).float().mean())
        out[name] = dict(stats, ms=ms, cpu_rows_equal=same)
        print(f"[moe balance] {name}: T={T} E={E} top-{k}: max load {stats['max_load']:.0f}, "
              f"mean {stats['mean_load']:.1f}, capacity {stats['capacity']:.0f}, overflow "
              f"fraction {stats['overflow_frac']:.6f}; {ms:.6f} ms on the card (event pairs); "
              f"rows equal to the CPU run on the same gates {same:.6f}")
    need(out["topk"]["cpu_rows_equal"] == 1.0, "[moe balance] topk_route on the card differs "
         "from its CPU run on the same gates")
    red = (out["topk"]["max_load"] - out["ppot"]["max_load"]) / max(out["topk"]["max_load"], 1)
    ok = out["ppot"]["overflow_frac"] < out["topk"]["overflow_frac"]
    out.update(claim=ok, max_load_reduction=red)
    print(f"[moe balance] claim (ppot overflow below top-k's): {ok}; max load reduction "
          f"{red:.2%}")
    need(ok, "[moe balance] ppot's overflow is not below top-k's")
    return out


def phase_zoo(torch, FK, dev):
    """phi3.5-moe, pixtral-12b and whisper-medium at their published
    widths, depth cut as ZOO lists: a prefill each (held against the plain
    paths as ``zoo_prefill`` does) and ZOO_STEPS greedy decode steps."""
    from repro_torch import configs
    from repro_torch.models import api
    from repro_torch.models import encdec as ED

    out = {}
    for arch, layers, B, S in ZOO:
        over = {} if layers is None else dict(n_layers=layers)
        cfg = configs.get_config(arch, **over)
        model = api.init_params(cfg, SEED, dev)
        batch = zoo_inputs(torch, cfg, B, S, dev)
        tag = f"[prefill {arch}]"
        attn = cfg.n_layers if max(S, cfg.enc_len) >= 2048 else 0
        rec, logits = zoo_prefill(torch, FK, dev, cfg, model, batch, tag, attn)
        enc = None
        if cfg.family == "encdec":
            enc = ED.encode(cfg, model, batch["frame_embeds"])
        rec.update(zoo_greedy_steps(torch, cfg, model, batch, ZOO_STEPS, enc))
        extra = ""
        if cfg.family == "vlm":
            extra = f", {cfg.n_patches} patch embeddings"
        if cfg.family == "encdec":
            extra = (f", frames [{B}, {cfg.enc_len}, {cfg.d_model}], {cfg.n_enc_layers} "
                     f"encoder layers")
        moe = rec.get("moe")
        if moe:
            extra += (f"; MoE capacity {moe['capacity']}, max load {moe['max_load']:.0f}, "
                      f"overflow fraction {moe['overflow_frac']:.6f}; the plain path on its "
                      f"own routes ({rec['route_flips']} tokens' routes differ): max abs err "
                      f"{rec['free_err']:.4f}, argmax agreement {rec['free_agree']:.2f}")
        print(f"{tag} published widths (d={cfg.d_model} H={cfg.n_heads}/{cfg.n_kv_heads} "
              f"D={cfg.d_head} V={cfg.vocab}, bf16), {cfg.n_layers} layers, B={B} S={S}{extra}: "
              f"flash launches {rec['flash_launches']}, {rec['ms']:.3f} ms per prefill "
              f"({rec['tok_s']:.1f} tokens/s), peak memory {rec['peak'] / 2**30:.3f} GiB; "
              f"last-position logits vs the plain path (an MoE model on the kernel path's routes): "
              f"max abs err {rec['err']:.4f} (tol "
              f"{MOE_PREFILL_TOL[arch]}, |logit| max {rec['logit_max']:.3f}; the plain path at "
              f"attention chunks of 256: {rec['floor']:.4f}), argmax agreement "
              f"{rec['agree']:.2f} (floor {rec['agree_floor']:.2f}); {ZOO_STEPS} greedy "
              f"decode steps, {rec['step_ms']:.3f} ms a step")
        need(rec["err"] <= MOE_PREFILL_TOL[arch], f"{tag} logits differ from the plain path "
             f"by {rec['err']} (tol {MOE_PREFILL_TOL[arch]})")
        out[arch] = rec
        del model, logits, enc
        torch.cuda.empty_cache()
    return out


def phase_kv_quant(torch, dev):
    """One int8 ``kv_quant`` decode: smollm-360m at its published widths in
    f32, KVQ_TOKENS tokens a row through ``decode_fn`` with the int8 cache,
    against the full-precision forward over the same tokens: within 5% of
    its largest |logit| (the bar of tests/test_arch_smoke.py)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import api
    from repro_torch.models import lm as LM

    cfg = dataclasses.replace(configs.get_config("smollm-360m"), dtype="float32",
                              param_dtype="float32")
    model = api.init_params(cfg, SEED, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    toks = torch.randint(0, cfg.vocab, (2, KVQ_TOKENS), generator=gen, device=dev)
    with torch.no_grad():
        full = LM.logits_head(cfg, model, LM.forward(cfg, model, toks))
    cfg_q = dataclasses.replace(cfg, kv_quant=True)
    cache = api.init_cache(cfg_q, 2, KVQ_TOKENS, dev)
    outs = []
    for t in range(KVQ_TOKENS):
        lg, cache = api.decode_fn(cfg_q, model, {"tokens": toks[:, t:t + 1], "pos": t}, cache)
        outs.append(lg[:, 0])
    dec = torch.stack(outs, 1)
    rel = ((full - dec).abs().max() / full.abs().max()).item()
    qbytes = sum(a.numel() * a.element_size() for c in cache for k, a in c["attn"].items()
                 if k != "len")
    fbytes = sum(2 * a.numel() * 2 for c in cache for k, a in c["attn"].items() if k == "k_q")
    print(f"[kv_quant] smollm-360m published widths, f32, int8 cache: {KVQ_TOKENS} decode steps "
          f"on 2 rows against the full-precision forward: max |err| / max |logit| {rel:.5f} "
          f"(bar 0.05); cache {qbytes} B against {fbytes} B in bf16")
    need(math.isfinite(rel) and rel < 0.05, f"[kv_quant] the int8-cache decode is {rel} of the "
         f"largest logit from the forward (bar 0.05)")
    del model
    torch.cuda.empty_cache()
    return dict(rel=rel, cache_bytes=qbytes, bf16_bytes=fbytes)


# ---------------------------------------------------------------------------
# times
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# the training side: K4 with its lse, K4b, and smollm-360m trained
# ---------------------------------------------------------------------------

FLASH_BWD_REPLACES = "src/repro/models/layers.py:232-298"
# [train kernels]: (label, B, Sq, Sk, Hq, Hkv, D, causal, window, q_offset,
# dtypes): smollm-360m's training shape, moonshot's heads of 128, hymba's
# window, whisper-medium's cross attention (448 decoder positions over 1500
# frames), and rows with no valid key (q_offset < 0)
TRAIN_KERNEL_CASES = (
    ("smollm-360m train", 4, 2048, 2048, 15, 5, 64, True, 0, 0, ("bfloat16", "float32")),
    ("moonshot D=128", 2, 2048, 2048, 16, 16, 128, True, 0, 0, ("bfloat16",)),
    ("hymba window", 1, 2048, 2048, 25, 5, 64, True, 1024, 0, ("bfloat16",)),
    ("whisper cross 448x1500", 4, 448, 1500, 16, 16, 64, False, 0, 0, ("bfloat16",)),
    ("empty rows", 2, 300, 300, 4, 2, 64, True, 0, -100, ("bfloat16", "float32")))
# bars: the lse within 1e-4 (bf16: ex2 and log2 in the kernel's log2
# domain, measured 1.9e-6) or 1e-5 (f32) of the plain version's; dq, dk, dv
# within this share of each output's largest |value| of the plain version
# on the same inputs (bf16: P and dS are rounded to bf16 before their
# products as in the plain version, the sums taken in another order)
TRAIN_LSE_TOL = {"bfloat16": 1e-4, "float32": 1e-5}
TRAIN_BWD_TOL = {"bfloat16": 2e-2, "float32": 2e-5}
# [train smollm-360m]: launch.train.main at published widths and full depth
# (32 layers, d 960, vocab 49152, bf16, remat full), a checkpoint at step 3
# and a second main resumed from it
TRAIN_FLAGS = ["--arch", "smollm-360m", "--steps", "6", "--seq-len", "2048",
               "--global-batch", "8", "--microbatches", "2", "--ckpt-every", "3",
               "--log-every", "1", "--seed", str(SEED)]
TRAIN_B, TRAIN_S, TRAIN_MB = 8, 2048, 2
# one step at 2 layers of full width on the kernels against the same step
# inside api.plain_paths() (bf16 model): the loss within 1e-4 relative (at
# random init it sits near ln V whatever attention gives, so the gradients
# carry the check), each parameter's gradient within 5e-2 of its leaf's
# largest |gradient|
TRAIN_PLAIN_LOSS_TOL, TRAIN_PLAIN_GRAD_TOL = 1e-4, 5e-2
# int8 sync against auto: step 1's loss comes before any compression and
# is bit-equal; its grad norm within the reference's bar
# (tests/test_dist.py); step 2's loss, after one int8 update, within
# INT8_STEP2_FRAC of auto's fall from step 1 to step 2
INT8_GNORM_TOL, INT8_STEP2_FRAC = 0.05, 0.5


def phase_train_kernels(torch, FK, FR, dev) -> float:
    """K4 with its lse and K4b against their plain versions at the training
    shapes; ``o`` with the lse bit-equal to ``o`` without. Returns the
    backward's largest abs error."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    worst = 0.0
    for label, B, Sq, Sk, H, Hkv, D, causal, window, off, dts in TRAIN_KERNEL_CASES:
        for dn in dts:
            dt = getattr(torch, dn)
            r = lambda *s: (torch.randn(s, generator=gen, device=dev)).to(dt)  # noqa: E731
            q, k, v, do = r(B, Sq, H, D), r(B, Sk, Hkv, D), r(B, Sk, Hkv, D), r(B, Sq, H, D)
            kw = dict(causal=causal, window=window, q_offset=off)
            o0 = FK.flash_attention_heads(q, k, v, **kw)
            o, lse = FK.flash_attention_heads(q, k, v, return_lse=True, **kw)
            dq, dk, dv = FK.flash_attention_bwd_heads(q, k, v, o, do, lse, **kw)
            torch.cuda.synchronize()
            need(torch.equal(o0, o), f"[train kernels] {label} {dn}: o with the lse is not "
                 f"bit-equal to o without it")
            _, lse_ref = FR.attention_heads_ref(q, k, v, return_lse=True, **kw)
            lse_err = (lse - lse_ref).abs().max().item()
            need(bool(torch.isfinite(lse).all()) and lse_err <= TRAIN_LSE_TOL[dn],
                 f"[train kernels] {label} {dn}: lse error {lse_err} above "
                 f"{TRAIN_LSE_TOL[dn]}")
            want = FR.attention_bwd_heads_ref(q, k, v, o, do, lse, **kw)
            errs = []
            for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
                need(g.shape == w.shape and g.dtype == w.dtype and bool(torch.isfinite(g).all()),
                     f"[train kernels] {label} {dn}: {name} {g.dtype}{list(g.shape)}")
                err = (g.float() - w.float()).abs().max().item()
                scale = w.float().abs().max().item()
                need(err <= TRAIN_BWD_TOL[dn] * max(scale, 1e-30),
                     f"[train kernels] {label} {dn}: {name} max abs err {err} above "
                     f"{TRAIN_BWD_TOL[dn]} of its largest |value| {scale}")
                errs.append((err, err / max(scale, 1e-30)))
                worst = max(worst, err)
            if off < 0:
                need(bool((dq[:, :-off] == 0).all()),
                     f"[train kernels] {label} {dn}: rows with no valid key have dq != 0")
            print(f"[train kernels] {label} (B={B} Sq={Sq} Sk={Sk} H={H}/{Hkv} D={D} "
                  f"causal={causal} window={window} q_offset={off}) {dn}: o bit-equal with "
                  f"and without the lse; lse max abs err {lse_err:.3e} (bar "
                  f"{TRAIN_LSE_TOL[dn]}); dq/dk/dv max abs err "
                  + "/".join(f"{e:.3e}" for e, _ in errs) + ", of the largest |value| "
                  + "/".join(f"{s:.3e}" for _, s in errs) + f" (bar {TRAIN_BWD_TOL[dn]})")
            del q, k, v, do, o0, o, lse, dq, dk, dv, want, lse_ref
    torch.cuda.empty_cache()
    print(f"[train kernels] all cases: the backward's largest abs error {worst:.3e}")
    return worst


def train_two_layers(torch, dev) -> dict:
    """One step's loss and gradients at 2 layers of smollm-360m's full width
    on the kernels, against the same inside api.plain_paths()."""
    from repro_torch import configs
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.models import api

    cfg = configs.get_config("smollm-360m", n_layers=2)
    model = api.trainable(api.init_params(cfg, SEED, dev))
    batch = SyntheticLM(cfg.vocab, TRAIN_S, TRAIN_B // TRAIN_MB, seed=SEED).batch_at(0)
    params = dict(model.named_parameters())
    out = {}
    for plain in (False, True):
        FK.reset_launches()
        with api.plain_paths() if plain else contextlib.nullcontext():
            loss, _ = api.loss_fn(cfg, model, batch)
            grads = torch.autograd.grad(loss, list(params.values()))
        torch.cuda.synchronize()
        out[plain] = (loss.item(), grads, FK.launch_counts())
    (lk, gk, ck), (lp, gp, cp) = out[False], out[True]
    need(ck == {"flash_attention_fwd": 4, "flash_attention_bwd": 2}
         and cp == {"flash_attention_fwd": 0, "flash_attention_bwd": 0},
         f"[train 2 layers] launches {ck} on the kernels, {cp} on the plain paths")
    loss_err = abs(lk - lp) / abs(lp)
    need(math.isfinite(lk) and loss_err <= TRAIN_PLAIN_LOSS_TOL,
         f"[train 2 layers] loss {lk} against the plain paths' {lp}")
    worst, worst_name = 0.0, ""
    for name, a, b in zip(params, gk, gp):
        scale = b.float().abs().max().item()
        err = (a.float() - b.float()).abs().max().item() / max(scale, 1e-30)
        need(math.isfinite(err) and err <= TRAIN_PLAIN_GRAD_TOL,
             f"[train 2 layers] {name}: gradient error {err} of its largest |value| above "
             f"{TRAIN_PLAIN_GRAD_TOL}")
        if err > worst:
            worst, worst_name = err, name
    print(f"[train 2 layers] smollm-360m at 2 layers of full width, B={TRAIN_B // TRAIN_MB} "
          f"S={TRAIN_S} bf16, one step's loss and gradients on the kernels (K4 {ck['flash_attention_fwd']}, "
          f"K4b {ck['flash_attention_bwd']} launches) against api.plain_paths(): loss {lk:.6f} "
          f"vs {lp:.6f} (rel {loss_err:.3e}, bar {TRAIN_PLAIN_LOSS_TOL}); worst gradient "
          f"error {worst:.3e} of its leaf's largest |value| ({worst_name}; bar "
          f"{TRAIN_PLAIN_GRAD_TOL})")
    del model, gk, gp
    return dict(loss=lk, plain_loss=lp, loss_rel_err=loss_err, grad_rel_err=worst,
                grad_worst=worst_name)


def phase_train(torch, FK, dev, card) -> dict:
    """[train smollm-360m]: ``launch.train.main`` at published widths and
    full depth for 6 steps with a checkpoint at step 3, a second ``main``
    resumed from it (steps 4-6 bit for bit), one step with int8 sync
    against auto, one step profiled, and 2 layers held to the plain
    paths. Deterministic algorithms for the phase."""
    import shutil

    from repro_torch.data import SyntheticLM
    from repro_torch.dist import sharding as SH
    from repro_torch.dist import steps as ST
    from repro_torch.launch import train
    from repro_torch.optim import adamw
    from repro_torch.utils import prng

    t_start = time.perf_counter()
    two = train_two_layers(torch, dev)
    torch.cuda.empty_cache()
    root = ROOT / "build" / "train_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        FK.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run = train.main(TRAIN_FLAGS + ["--ckpt-dir", str(root / "a")])
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        counts = FK.launch_counts()
        steps = len(run["losses"])
        need(counts == {"flash_attention_fwd": 128 * steps, "flash_attention_bwd": 64 * steps},
             f"[train smollm-360m] launches {counts} over {steps} steps, not 128 K4 (forward "
             f"and its remat) and 64 K4b a step")
        losses = run["losses"]
        need(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
             f"[train smollm-360m] losses {losses} not finite and falling")
        (root / "b").mkdir(parents=True)
        shutil.copytree(root / "a" / "step_00000003", root / "b" / "step_00000003")
        (root / "b" / "latest").write_text("step_00000003")
        resumed = train.main(TRAIN_FLAGS + ["--ckpt-dir", str(root / "b")])
        need(resumed["losses"] == losses[3:],
             f"[train smollm-360m] the resumed steps 4-6 {resumed['losses']} are not the "
             f"uninterrupted run's {losses[3:]} bit for bit")
        del resumed
        torch.cuda.empty_cache()
        # two steps: step 1's lr is the 6-step run's (warm-up ends at step 1)
        int8 = train.main(TRAIN_FLAGS[:2] + ["--steps", "2"] + TRAIN_FLAGS[4:]
                          + ["--grad-sync", "int8"])
        d_gn = abs(int8["grad_norms"][0] - run["grad_norms"][0]) / run["grad_norms"][0]
        fall = losses[0] - losses[1]
        d_loss2 = abs(int8["losses"][1] - losses[1])
        need(int8["losses"][0] == losses[0] and d_gn < INT8_GNORM_TOL
             and d_loss2 <= INT8_STEP2_FRAC * fall,
             f"[train smollm-360m] int8 sync: losses {int8['losses']} vs {losses[:2]} (step "
             f"1 bit-equal, step 2 within {INT8_STEP2_FRAC} of the fall {fall}), grad norm "
             f"{int8['grad_norms'][0]} vs {run['grad_norms'][0]}")
        del int8
        counts = FK.launch_counts()
        torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(det)
        shutil.rmtree(root, ignore_errors=True)
    ms = float(np.median(run["step_s"][1:])) * 1e3
    tokens_s = TRAIN_B * TRAIN_S / (ms / 1e3)
    # one more step of the trained model under the profiler
    from repro_torch import configs

    cfg = configs.get_config("smollm-360m")
    step = ST.make_train_step(cfg, SH.make_ctx(), adamw.AdamWConfig(
        lr=3e-4, total_steps=6, warmup_steps=1), microbatches=TRAIN_MB)
    batch = SyntheticLM(cfg.vocab, TRAIN_S, TRAIN_B, seed=SEED).batch_at(6)
    state = {"opt": run["opt_state"]}

    def one_step():
        state["opt"], m = step(run["model"], state["opt"], batch,
                               prng.fold_in(prng.PRNGKey(SEED + 1), 6))
        m["loss"].item()
    prof = device_profile(torch, one_step)
    bwd_us = sum(us for nm, us in prof["us"].items() if "flash_bwd" in nm)
    fwd_us = sum(us for nm, us in prof["us"].items() if "flash_fwd" in nm)
    top = sorted(prof["us"].items(), key=lambda kv: -kv[1])[:6]
    by_source = step_sources(torch, cfg, run["model"], state["opt"], batch, prof)
    del run["model"], run["opt_state"], state
    torch.cuda.empty_cache()
    rec = dict(steps=steps, losses=losses, grad_norms=run["grad_norms"], step_ms=ms,
               step_s=run["step_s"], tokens_per_s=tokens_s, peak_gib=peak,
               k4_per_step=128, k4b_per_step=64, launches=counts, int8_step2_loss_diff=d_loss2,
               int8_step2_fall=fall, int8_gnorm_rel=d_gn, wall_s=wall, profile_ms=prof["wall"] * 1e3,
               busy_ms=prof["busy_us"] / 1e3, idle=prof["idle"],
               k4b_share=bwd_us / prof["busy_us"], k4_share=fwd_us / prof["busy_us"],
               kernel_launches=prof["launches"], by_source=by_source, two_layers=two,
               seconds=time.perf_counter() - t_start)
    print(f"[train smollm-360m] {card}; published widths, 32 layers, bf16, remat full, "
          f"B={TRAIN_B} S={TRAIN_S} in {TRAIN_MB} microbatches, {steps} steps: losses "
          f"{[round(x, 6) for x in losses]} (finite, falling); {ms:.3f} ms a step (median of "
          f"steps 2-{steps}, host clock to the loss's sync), {tokens_s:.1f} tokens/s, peak "
          f"{peak:.3f} GiB; K4 128 and K4b 64 launches a step; resumed from step 3: steps "
          f"4-6 equal bit for bit; int8 sync: step 1's loss bit-equal, grad norm rel diff "
          f"{d_gn:.3e} (bar {INT8_GNORM_TOL}), step 2's loss {d_loss2:.6e} apart, "
          f"{d_loss2 / fall:.4e} of auto's fall {fall:.6f} (bar {INT8_STEP2_FRAC})")
    print(f"[train smollm-360m] one step profiled: {prof['wall'] * 1e3:.3f} ms wall, device "
          f"busy {prof['busy_us'] / 1e3:.3f} ms (idle share {prof['idle']:.4f}), "
          f"{prof['launches']} kernel launches; K4b {bwd_us / 1e3:.3f} ms "
          f"({rec['k4b_share']:.4f} of device time), K4 {fwd_us / 1e3:.3f} ms "
          f"({rec['k4_share']:.4f}); top by device time: "
          f"{[(nm[:60], round(us / 1e3, 3)) for nm, us in top]}; phase {rec['seconds']:.1f} s")
    print("[train smollm-360m] the profiled step by source: "
          + "; ".join(f"{src} {r['launches']} launches, {r['busy_ms']:.3f} ms device"
                      + (f", {r['host_ms']:.3f} ms host clock alone" if "host_ms" in r else "")
                      for src, r in by_source.items()))
    return rec


def step_sources(torch, cfg, model, opt_state, batch, prof) -> dict:
    """Split the profiled train step's launches and device time by source:
    ``optim/adamw.update`` alone (on gradients of the step's shapes, f32)
    and one microbatch's loss forward alone (no autograd), each run once
    under the profiler and once more on the host clock to a sync; the rest
    of the step (the backward with its remat recompute, the gradients'
    accumulation, the parameters' copy) is the profiled step less the
    optimizer and TRAIN_MB forwards."""
    from repro_torch import convert
    from repro_torch.models import api
    from repro_torch.models.layers import DTYPES
    from repro_torch.optim import adamw

    params = dict(model.named_parameters())
    leaves = [names for _, names in convert.reference_leaves(cfg, model)]
    gen = torch.Generator(device=model.embed.device).manual_seed(SEED)
    grads = {k: torch.randn(p.shape, generator=gen, device=p.device) * 1e-3
             for k, p in params.items()}
    opt_cfg = adamw.AdamWConfig(lr=3e-4, total_steps=6, warmup_steps=1)
    dev = model.embed.device
    per = TRAIN_B // TRAIN_MB
    mb = {k: torch.as_tensor(v[:per], device=dev) for k, v in batch.items()}

    def opt():
        out = adamw.update(opt_cfg, opt_state, grads, DTYPES[cfg.param_dtype], leaves)
        out[2]["grad_norm"].item()

    def fwd():
        with torch.no_grad():
            api.loss_fn(cfg, model, mb)[0].item()

    out = {}
    for src, fn in (("adamw.update", opt), ("forward (one microbatch)", fwd)):
        p = device_profile(torch, fn)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        out[src] = dict(launches=p["launches"], busy_ms=p["busy_us"] / 1e3,
                        host_ms=(time.perf_counter() - t0) * 1e3)
    a, f = out["adamw.update"], out["forward (one microbatch)"]
    out["the rest (backward with remat, accumulation, copy)"] = dict(
        launches=prof["launches"] - a["launches"] - TRAIN_MB * f["launches"],
        busy_ms=prof["busy_us"] / 1e3 - a["busy_ms"] - TRAIN_MB * f["busy_ms"])
    del grads
    return out


def phase_train_times(torch, FK, FR, dev) -> dict:
    """K4b alone at smollm's training shape (bf16, causal), its plain
    version, its bound (five products of 2 B H Sq Sk D on the valid pairs at
    the bf16 peak, or the bytes of q, k, v, o, dO, lse read and dq, dk, dv
    written) and the library's: the backward of scaled_dot_product_attention
    (causal, GQA) on the same tensors."""
    B, S, H, Hkv, D = 4, TRAIN_S, 15, 5, 64
    gen = torch.Generator(device=dev).manual_seed(SEED)
    r = lambda *s: torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)  # noqa: E731
    q, k, v, do = r(B, S, H, D), r(B, S, Hkv, D), r(B, S, Hkv, D), r(B, S, H, D)
    o, lse = FK.flash_attention_heads(q, k, v, return_lse=True)
    ms = event_median_ms(torch, lambda: FK.flash_attention_bwd_heads(q, k, v, o, do, lse),
                         reps=50)
    lse_ms = event_median_ms(torch, lambda: FK.flash_attention_heads(q, k, v, return_lse=True),
                             reps=50)
    fwd_ms = event_median_ms(torch, lambda: FK.flash_attention_heads(q, k, v), reps=50)
    plain_ms = event_median_ms(torch, lambda: FR.attention_bwd_heads_ref(q, k, v, o, do, lse),
                               reps=5)
    qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                                           enable_gqa=True)
    g = do.transpose(1, 2)
    lib_ms = event_median_ms(torch, lambda: torch.autograd.grad(out, (qs, ks, vs), g,
                                                                retain_graph=True), reps=50)
    pairs = B * H * S * (S + 1) // 2
    flops = 5 * 2 * D * pairs
    # q, o, dO and dq; k and dk; v and dv in bf16, the lse in f32
    nbytes = 2 * (4 * q.numel() + 2 * k.numel() + 2 * v.numel()) + 4 * lse.numel()
    ops_ms, bytes_ms = flops / BF16_OPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    rec = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=max(ops_ms, bytes_ms),
               bound_by="operations" if ops_ms >= bytes_ms else "bytes", flops=flops,
               bytes=nbytes, fwd_lse_ms=lse_ms, fwd_ms=fwd_ms)
    print(f"[times] flash_attention_bwd (K4b; B={B} S={S} H={H}/{Hkv} D={D} bf16 causal): "
          f"kernel {ms:.6f} ms, plain {plain_ms:.6f} ms, bound {rec['bound_ms']:.6f} ms "
          f"({rec['bound_by']}: {flops} FLOPs at 989 TFLOP/s = {ops_ms:.6f} ms, {nbytes} B "
          f"at 3.35 TB/s = {bytes_ms:.6f} ms), library (scaled_dot_product_attention's "
          f"backward) {lib_ms:.6f} ms, {rec['bound_ms'] / ms:.4f} of the bound; K4 at this "
          f"shape {fwd_ms:.6f} ms, with its lse {lse_ms:.6f} ms")
    return rec


def event_median_ms(torch, launch, reps: int = 200) -> float:
    """Median device time of one call, from an event pair around each call.
    A long spin queued first lets the host enqueue every call before the
    device reaches them, so host launch latency stays out of the pairs."""
    for _ in range(3):
        launch()
    torch.cuda.synchronize()
    evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
           for _ in range(reps)]
    torch.cuda._sleep(200_000_000)
    for e0, e1 in evs:
        e0.record()
        launch()
        e1.record()
    torch.cuda.synchronize()
    return float(np.median([e0.elapsed_time(e1) for e0, e1 in evs]))


def captured(torch, launch):
    """``launch`` warmed up on a side stream, then captured once as a CUDA
    graph, kept so that its nodes can be read (``scanloop._graph_nodes``)."""
    cur = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        for _ in range(2):
            launch()
    cur.wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        launch()
    graph.instantiate()
    return graph


def graph_call_ms(torch, launch, reps: int = 50) -> float:
    """Median device time of one call of many small launches, as the
    one-program loop runs it: the call captured once as a CUDA graph, then
    an event pair around each of ``reps`` replays queued behind a spin, so
    that the pairs time the device and not the host. (Queued as separate
    launches, a call of hundreds of kernels fills the stream's launch queue
    and the pairs would time the host.)"""
    return event_median_ms(torch, captured(torch, launch).replay, reps)


def host_median_ms(torch, fn, reps: int = 20) -> float:
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def sm_clock_mhz(torch) -> float:
    """The SM clock nvidia-smi reads while a spin kernel keeps the card busy.
    It reads twice and keeps the second reading only if the spin was still
    running after it; else it spins twice as long and reads again."""
    cycles = 3_000_000_000
    for _ in range(4):
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        for _ in range(2):
            out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                                  "--format=csv,noheader,nounits"],
                                 capture_output=True, text=True, timeout=60).stdout
        busy = not torch.cuda.current_stream().query()
        torch.cuda.synchronize()
        if busy:
            return float(out.split()[0])
        cycles *= 2
    raise RuntimeError("nvidia-smi never read the SM clock while the spin kernel ran")


def phase_times(torch, K, R, D, build, dev):
    """Each kernel alone (its C entry point on preallocated buffers), its
    plain version, and its bound, at the main path's shape and a large one,
    beside its time before this redesign. The alias table's build also gets
    its chain bounds: n serial steps at CHAIN_CYCLES at the SM clock of this
    run."""
    lib = build.load()
    stream = torch.cuda.current_stream().cuda_stream
    floor_t = torch.zeros(1, device=dev)
    floor_ms = event_median_ms(torch, floor_t.zero_)
    print(f"[times] launch floor (one 1-element fill kernel, event pair): {floor_ms:.6f} ms")
    mhz = sm_clock_mhz(torch)
    print(f"[times] SM clock under load (nvidia-smi clocks.sm): {mhz:.0f} MHz")
    out = {}
    for n, B in ((1024, BATCH), (2048, 16384)):
        rng = np.random.RandomState(n + B)
        mu = torch.from_numpy(rng.rand(n).astype(np.float32) * 5).to(dev)
        q = torch.from_numpy(rng.randint(0, 50, n).astype(np.int32)).to(dev)
        u1, u2, v1, v2 = (torch.from_numpy(rng.randint(0, 65536, B).astype(np.float32)
                                           / 65536.0).to(dev) for _ in range(4))
        act = torch.from_numpy(R.make_mask("tenth_off", n, rng)).to(dev)
        cdf = R.make_cdf(mu)
        p = D.scaled_weights(mu)
        prob, alias = K.alias_table(p)
        w = torch.empty(B, dtype=torch.int32, device=dev)
        qa = q.clone()
        pp, pa = torch.empty_like(prob), torch.empty_like(alias)
        P = lambda t: t.data_ptr()  # noqa: E731
        logn = int(np.ceil(np.log2(n)))
        key = torch.tensor(K1_KEY, dtype=torch.int64, device=dev)
        cases = {
            "ppot_dispatch_fused_alias": (
                lambda: lib.ppot_fused_alias_keyed(P(prob), P(alias), P(q), P(key), 0, 0, None,
                                                   n, B, P(w), P(qa), stream),
                lambda: R.ppot_dispatch_fused_alias_keyed_ref(prob, alias, q, key, B),
                k1_bytes(n, B), K1_OPS * B),
            "ppot_dispatch_fused_alias_unkeyed": (
                lambda: lib.ppot_fused_alias(P(prob), P(alias), P(q), P(u1), P(v1), P(u2),
                                             P(v2), n, B, P(w), P(qa), stream),
                lambda: R.ppot_dispatch_fused_alias_ref(prob, alias, q, u1, v1, u2, v2),
                16 * n + 20 * B, 3 * B),
            "ppot_dispatch_fused": (
                lambda: lib.ppot_fused_cdf(P(cdf), P(q), P(u1), P(u2), n, B, P(w), P(qa),
                                           stream),
                lambda: R.ppot_dispatch_fused_ref(cdf, q, u1, u2),
                12 * n + 12 * B, B * (2 * logn + 1)),
            "ppot_dispatch": (
                lambda: lib.ppot_select_cdf(P(cdf), P(q), P(u1), P(u2), n, B, P(w), stream),
                lambda: R.ppot_dispatch_ref(cdf, q, u1, u2),
                8 * n + 12 * B, B * (2 * logn + 1)),
            "alias_table": (
                lambda: lib.alias_table(P(p), None, n, P(pp), P(pa), stream),
                lambda: R.alias_table_ref(p),
                12 * n, 3 * n),
            "alias_table masked": (
                lambda: lib.alias_table(P(p), P(act), n, P(pp), P(pa), stream),
                lambda: R.alias_table_ref(p, act),
                13 * n, 3 * n),
        }
        for name, (kern, plain, nbytes, nops) in cases.items():
            ms = event_median_ms(torch, kern)
            if name.startswith("alias_table"):  # the plain walk runs on the host
                plain_ms = host_median_ms(torch, plain)
            else:
                plain_ms = event_median_ms(torch, plain)
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = nops / F32_OPS_PER_S * 1e3
            rec = dict(ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
                       bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                       bytes=nbytes, library_ms=None)
            out[(name, n, B)] = rec
            shape = f"n={n}" + ("" if name.startswith("alias_table") else f" B={B}")
            extra = ""
            if name.startswith("alias_table"):
                for k, c in CHAIN_CYCLES.items():
                    rec[f"chain_{k}_ms"] = n * c / (mhz * 1e6) * 1e3
                extra = (f", chain bound {rec['chain_step_ms']:.6f} ms ({n} steps x "
                         f"{CHAIN_CYCLES['step']} cycles: sub, sub, select; the subtraction "
                         f"alone {CHAIN_CYCLES['sub']} cycles, {rec['chain_sub_ms']:.6f} ms; "
                         f"at {mhz:.0f} MHz)")
            before = PPOT_BEFORE_MS.get(name, {}).get(n)
            print(f"[times] {name} {shape}: kernel {ms:.6f} ms"
                  + ("" if before is None else f" (before {before:.6f} ms)")
                  + f", plain {plain_ms:.6f} ms, bound {rec['bound_ms']:.9f} ms "
                  f"({rec['bound_by']}, {nbytes} B){extra}, launch floor {floor_ms:.6f} ms, "
                  f"library call: none")
    print("[times] library_ms: no single PyTorch call computes these functions")
    return out, floor_ms, mhz


def k1_bytes(n: int, B: int) -> int:
    """The keyed K1's bytes: prob, alias and q read (12n), the key (16),
    workers and q_after written (4B + 4n); its uniforms never touch device
    memory."""
    return 16 * n + 4 * B + 16


def phase_k1_times(torch, K, R, D, build, tsl, prng, dev, floor_ms) -> dict:
    """The keyed K1 against the chain it replaced on the engine's path
    (``prng.uniform_quad`` of the device key, ``q.clone()`` as the seed of
    q_after, the unkeyed K1), each captured as one graph and replayed in
    turns (chain, keyed, keyed, chain), at K1's [times] shapes and at
    [serve moonshot-v1-16b-a3b]'s router shape, where the keyed kernel is
    also timed alone; the graphs' nodes and their results equal."""
    lib = build.load()
    out = {}
    for n, B in ((1024, BATCH), (2048, 16384), MOE_ROUTER_SHAPE):
        rng = np.random.RandomState(n + B)
        mu = torch.from_numpy(rng.rand(n).astype(np.float32) * 5).to(dev)
        q = torch.from_numpy(rng.randint(0, 50, n).astype(np.int32)).to(dev)
        prob, alias = K.alias_table(D.scaled_weights(mu))
        key = torch.tensor(K1_KEY, dtype=torch.int64, device=dev)

        def keyed():
            return K.ppot_dispatch_fused_alias_keyed(prob, alias, q, key, B)

        def chain():
            u1, u2, v1, v2 = prng.uniform_quad(key, B, dev)
            w, qa = torch.empty(B, dtype=torch.int32, device=dev), q.clone()
            lib.ppot_fused_alias(*(t.data_ptr() for t in (prob, alias, q, u1, v1, u2, v2)), n,
                                 B, w.data_ptr(), qa.data_ptr(),
                                 torch.cuda.current_stream().cuda_stream)
            return w, qa

        gk, gc = captured(torch, keyed), captured(torch, chain)
        nodes = {"keyed": tsl._graph_nodes(gk)[0], "chain": tsl._graph_nodes(gc)[0]}
        got, want = keyed(), chain()
        torch.cuda.synchronize()
        need(all(torch.equal(a, b) for a, b in zip(got, want)),
             f"[times] K1 at n={n} B={B}: the keyed kernel differs from the chain it replaced")
        turns = [event_median_ms(torch, g.replay, 100) for g in (gc, gk, gk, gc)]
        rec = dict(graph_ms=(turns[1] + turns[2]) / 2, chain_graph_ms=(turns[0] + turns[3]) / 2,
                   graph_nodes=nodes["keyed"], chain_graph_nodes=nodes["chain"])
        if (n, B) == MOE_ROUTER_SHAPE:
            w, qa = torch.empty(B, dtype=torch.int32, device=dev), torch.empty_like(q)
            rec["ms"] = event_median_ms(torch, lambda: lib.ppot_fused_alias_keyed(
                prob.data_ptr(), alias.data_ptr(), q.data_ptr(), key.data_ptr(), 0, 0, None, n,
                B, w.data_ptr(), qa.data_ptr(), torch.cuda.current_stream().cuda_stream))
            rec["plain_ms"] = event_median_ms(
                torch, lambda: R.ppot_dispatch_fused_alias_keyed_ref(prob, alias, q, key, B))
            rec["bound_ms"] = max(k1_bytes(n, B) / HBM_BYTES_PER_S,
                                  K1_OPS * B / F32_OPS_PER_S) * 1e3
        out[(n, B)] = rec
        print(f"[times] K1 keyed n={n} B={B} in a graph: {rec['graph_ms']:.6f} ms a replay "
              f"({rec['graph_nodes']} node) against the chain it replaced (uniform_quad + "
              f"clone + unkeyed K1) {rec['chain_graph_ms']:.6f} ms "
              f"({rec['chain_graph_nodes']} nodes), in turns; equal results"
              + (f"; alone {rec['ms']:.6f} ms, plain {rec['plain_ms']:.6f} ms, bound "
                 f"{rec['bound_ms']:.9f} ms (bytes), launch floor {floor_ms:.6f} ms"
                 if "ms" in rec else ""))
    return out


def phase_pool_chain_times(torch, CK, CR, cbuild, dev, mhz, floor_ms, real_turns):
    """The pool-chain kernel alone (its C entry points on preallocated
    buffers): the array form at POOL_CASES's sizes, and the turn form on the
    real turns of REAL_TURN_MODES, in place as the scan runs it; its plain
    version (a host walk), its bound and its serial-chain floor (the longest
    per-replica chain of the inputs, POOL_CHAIN_CYCLES a step at this run's
    SM clock)."""
    lib = cbuild.load()
    stream = torch.cuda.current_stream().cuda_stream
    P = lambda t: t.data_ptr()  # noqa: E731
    out = {}

    def record(label, ms, plain_ms, nbytes, M, longest):
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = 3 * M / F64_OPS_PER_S * 1e3  # a division, a max and an add a step
        chain_ms = longest * POOL_CHAIN_CYCLES / (mhz * 1e6) * 1e3
        rec = out[label] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations", bytes=nbytes,
            longest_chain=longest, chain_ms=chain_ms, floor_ms=floor_ms, library_ms=None)
        print(f"[times] pool_chain {label}: kernel {ms:.6f} ms, plain {plain_ms:.6f} ms "
              f"(host walk), bound {rec['bound_ms']:.9f} ms "
              f"({rec['bound_by']}, {nbytes} B), chain bound {chain_ms:.6f} ms (longest chain "
              f"{longest} x {POOL_CHAIN_CYCLES} cycles at {mhz:.0f} MHz), launch floor "
              f"{floor_ms:.6f} ms, library call: none")

    for n, M, one in POOL_CASES:
        args = pool_chain_case(torch, dev, n, M, n + M, one)
        start, done, free = (torch.empty_like(args[i]) for i in (3, 3, 0))
        ptrs = [P(t) for t in args]

        def kern():
            lib.pool_chain(*ptrs, n, M, P(start), P(done), P(free), stream)

        ms = event_median_ms(torch, kern)
        plain_ms = host_median_ms(torch, lambda: CR.pool_chain_ref(*args))
        # free_at in and out, the steps' w, arrival, cost, active, start and
        # done, and the speed of each distinct replica the steps submit to
        distinct = int(torch.unique(args[2]).numel())
        record(pool_case_label(n, M, one), ms, plain_ms, 16 * n + 37 * M + 8 * distinct, M,
               CR.longest_chain(args[2], n))
    for (mode, turn), args in real_turns.items():
        free_at, speeds, fake_js, burst, workers, times, costs, fc, bcost = args
        n, mf, bc, k = free_at.shape[0], fake_js.shape[0], burst.shape[0], workers.shape[0]
        M = mf + bc + k
        f64 = dict(dtype=torch.float64, device=dev)
        start, done, resp = torch.empty(M, **f64), torch.empty(M, **f64), torch.empty(k, **f64)
        sub_w = torch.empty(M, dtype=torch.int32, device=dev)
        act = torch.empty(M, dtype=torch.bool, device=dev)
        free = free_at.clone()  # in place, as the scan runs it
        ins = [P(t) for t in (free, speeds, fake_js, burst, workers, times, costs)]
        outs = [P(t) for t in (start, done, sub_w, act, free, resp)]

        def kern():
            lib.pool_turn(*ins, fc, bcost, n, mf, bc, k, *outs, None, stream)

        ms = event_median_ms(torch, kern)
        plain_ms = host_median_ms(torch, lambda: CR.pool_turn_ref(*args))
        w = CR.turn_submissions(fake_js, burst, workers, times, costs, fc, bcost)[0]
        distinct = int(torch.unique(w).numel())
        # in place: each touched replica's clock in and out and its speed; a
        # step's replica in and start, done, sub_w and act out; a batch
        # step's arrival and cost in and response out
        record(real_turn_label(mode, turn, n, M), ms, plain_ms,
               24 * distinct + 25 * M + 24 * k, M, CR.longest_chain(w, n))
    return out


def composed_table(K, R, D, mu, active):
    """The launches of the alias-table build as it was composed before
    ``kernel.alias_table``: the scaling, the stack order as tensor ops, the
    walk (one launch, stood in here by the table kernel on the unmasked
    weights) and the mask pass as tensor ops. Only its launch count is read:
    ``kernel_variants.py --parent`` times the earlier build itself."""
    p = D.scaled_weights(mu, active)
    R.stack_order(p)
    prob, alias = K.alias_table(p)
    return (prob, alias) if active is None else R.mask_pass(prob, alias, active)


def phase_table_build(torch, K, R, D, dev, calls: int = 20):
    """Launches and host time (synchronised) per build_alias_table call at
    n = 1024, unmasked and with 10% of the workers off, and the launches of
    the composition it replaced."""
    rng = np.random.RandomState(5)
    mu = torch.from_numpy(rng.rand(N_REPLICAS).astype(np.float32) * 5).to(dev)
    act = torch.from_numpy(R.make_mask("tenth_off", N_REPLICAS, rng)).to(dev)
    out = {}
    for label, a in (("unmasked", None), ("masked", act)):
        for how, fn in (("before", lambda: composed_table(K, R, D, mu, a)),
                        ("now", lambda: D.build_alias_table(mu, a))):
            fn()
            prof = device_profile(torch, lambda: [fn() for _ in range(calls)])
            out[(label, how)] = dict(launches=prof["launches"] / calls,
                                     copies=prof["copies"] / calls)
        b, c = out[(label, "before")], out[(label, "now")]
        c["host_ms"] = host_median_ms(torch, lambda: D.build_alias_table(mu, a), reps=50)
        print(f"[table build] n={N_REPLICAS} {label}: {c['launches']:.1f} launches and "
              f"{c['copies']:.1f} copies per build_alias_table call, {c['host_ms']:.6f} ms "
              f"host clock with sync; composed as before (tensor ops around a one-launch "
              f"walk): {b['launches']:.1f} launches, {b['copies']:.1f} copies")
    return out


def phase_flash_times(torch, FK, FR, dev):
    """K4 alone at smollm's prefill shape, at a smaller one (B=1, S=2048)
    and at moonshot's prefill shape (16 heads of 128: the 64-key tile),
    with its plain version, its bound and the library's fused attention
    (``scaled_dot_product_attention``, causal, GQA) on the same tensors."""
    out = {}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for label, B, S, H, Hkv, D in (("main", PREFILL_B, PREFILL_S, 15, 5, 64),
                                   ("small", 1, 2048, 15, 5, 64),
                                   ("d128", MOE_B, MOE_S, 16, 16, 128)):
        q = torch.randn(B * H, S, D, generator=gen, device=dev).to(torch.bfloat16)
        k, v = (torch.randn(B * Hkv, S, D, generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
        ms = event_median_ms(torch, lambda: FK.flash_attention_fwd(q, k, v, causal=True),
                             reps=50)
        plain_ms = event_median_ms(torch, lambda: FR.attention_ref(q, k, v, causal=True),
                                   reps=10)
        qq, kk, vv = q.view(B, H, S, D), k.view(B, Hkv, S, D), v.view(B, Hkv, S, D)
        lib_ms = event_median_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
            qq, kk, vv, is_causal=True, enable_gqa=True), reps=50)
        pairs = B * H * S * (S + 1) // 2  # the valid (query, key) pairs, causal
        flops = 2 * 2 * D * pairs
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        ops_ms = flops / BF16_OPS_PER_S * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        rec = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=max(ops_ms, bytes_ms),
                   bound_by="operations" if ops_ms >= bytes_ms else "bytes", flops=flops,
                   bytes=nbytes, before_ms=BEFORE_MS["flash_attention_fwd"].get(label))
        out[label] = rec
        before = ("" if rec["before_ms"] is None
                  else f" (before the redesign {rec['before_ms']:.6f} ms)")
        print(f"[times] flash_attention_fwd {label} (B={B} S={S} H={H}/{Hkv} D={D} bf16 causal): "
              f"kernel {ms:.6f} ms{before}, plain "
              f"{plain_ms:.6f} ms, bound {rec['bound_ms']:.6f} ms "
              f"({rec['bound_by']}: {flops} FLOPs at 989 TFLOP/s = {ops_ms:.6f} ms, "
              f"{nbytes} B at 3.35 TB/s = {bytes_ms:.6f} ms), library "
              f"(scaled_dot_product_attention) {lib_ms:.6f} ms, "
              f"{rec['bound_ms'] / ms:.4f} of the bound")
    return out


def ssd_work(B, S, H, P, N, Q, x_bytes) -> tuple[int, int, int, int]:
    """(bytes, FLOPs, FLOPs of the products with x, FLOPs of C·Bᵀ) the SSD
    scan must move and do: x, dt, B, C (once per batch row), A read once, y
    and h written once; the products of the chunked form with C·Bᵀ once per
    (batch row, chunk) on the causal triangle, the intra-chunk product on
    the triangle, the inter-chunk output and the state update, 2 FLOPs per
    multiply-add. The intra-chunk product and the state update multiply x."""
    nbytes = (B * S * H * P * x_bytes + 4 * (B * S * H + H + 2 * B * S * N)
              + 4 * (B * S * H * P + B * H * N * P))
    tri = Q * (Q + 1) // 2
    nc = S // Q
    flops_x = 2 * nc * B * H * (tri * P + Q * N * P)
    flops_cb = 2 * nc * B * tri * N
    flops = flops_cb + 2 * nc * B * H * Q * N * P + flops_x  # C·Bᵀ, inter-chunk, with x
    return nbytes, flops, flops_x, flops_cb


def ssd_units_ms(flops, flops_x, flops_cb, x_exact) -> float:
    """The operations' least time on the units K5 runs them on: C·Bᵀ on the
    FMA units (67 TFLOP/s), the rest on the TF32 tensor cores with each
    f32 operand split in two ("3xTF32": 3 products, 495 / 3 TFLOP/s of f32
    work), 2 products (495 / 2) where x is bf16 and so exact in TF32."""
    rate_x = TF32_OPS_PER_S / (2 if x_exact else 3)
    return (flops_cb / F32_OPS_PER_S + (flops - flops_x - flops_cb) / (TF32_OPS_PER_S / 3)
            + flops_x / rate_x) * 1e3


def phase_ssd_times(torch, SK, SO, SR, dev):
    """K5 alone at the mamba2 prefill's layer shape and at a smaller one
    (B=1, S=2048), with its plain version and its bound; no single PyTorch
    call computes the scan, so there is no library time."""
    out = {}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for label, B, S in (("main", MAMBA_B, MAMBA_S), ("small", 1, 2048)):
        H, P, N, Q = 32, 64, 128, 128
        x, dt, A, Bm, Cm = ssd_inputs(torch, gen, dev, B, S, H, P, N, xdtype=torch.bfloat16,
                                      heads=True)
        ms = event_median_ms(torch, lambda: SK.ssd_scan_heads(x, dt, A, Bm, Cm, chunk=Q),
                             reps=20)
        plain_ms = event_median_ms(
            torch, lambda: SR.ssd_chunked_heads(x, dt, A, Bm, Cm, chunk=Q), reps=5)
        nbytes, flops, flops_x, flops_cb = ssd_work(B, S, H, P, N, Q, x.element_size())
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        fma_ms = flops / F32_OPS_PER_S * 1e3  # the bound while K5 ran on the FMA units
        ops_ms = ssd_units_ms(flops, flops_x, flops_cb, x.dtype == torch.bfloat16)
        rec = dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=max(ops_ms, bytes_ms),
                   bound_by="operations" if ops_ms >= bytes_ms else "bytes", flops=flops,
                   bytes=nbytes, fma_bound_ms=max(fma_ms, bytes_ms),
                   before_ms=BEFORE_MS["ssd_scan"][label])
        out[label] = rec
        print(f"[times] ssd_scan {label} (B={B} S={S} H={H} P={P} N={N} Q={Q}, x bf16): "
              f"kernel {ms:.6f} ms (before the redesign {rec['before_ms']:.6f} ms), plain "
              f"{plain_ms:.6f} ms, bound {rec['bound_ms']:.6f} ms ({rec['bound_by']}: {flops} "
              f"FLOPs, C·Bᵀ's {flops_cb} at 67 TFLOP/s, the rest on the TF32 tensor cores, "
              f"3xTF32 ({flops_x} of them, the products with bf16 x, 2xTF32) = {ops_ms:.6f} ms; "
              f"{nbytes} B at 3.35 TB/s = {bytes_ms:.6f} ms), "
              f"{rec['bound_ms'] / ms:.4f} of the bound; on the FMA units (67 TFLOP/s) the "
              f"bound was {rec['fma_bound_ms']:.6f} ms, {rec['fma_bound_ms'] / ms:.4f} of it; "
              f"library call: none")
    return out


# ---------------------------------------------------------------------------


def _timed(name: str, fn):
    def run(*args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        print(f"[phase] {name[len('phase_'):]} {time.perf_counter() - t0:.1f} s", flush=True)
        return out
    return run


def time_phases() -> None:
    """Print each phase's wall time as it ends (``[phase] <name> <s>``)."""
    g = globals()
    for name, fn in list(g.items()):
        if name.startswith("phase_") and callable(fn):
            g[name] = _timed(name, fn)


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="smoke run of the port on one CUDA card")
    ap.add_argument("--phase", choices=["train"], default=None,
                    help="run the build and this phase alone (no result lines)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device")
    try:
        from repro_torch.configs import rosella_sim as RS
        from repro_torch.configs.rosella_sim import tpch_speed_set
        from repro_torch.core import dispatch as D
        from repro_torch.core import theory as TH
        from repro_torch.core import policies as P
        from repro_torch import env as tenv
        from repro_torch import load as tload
        from repro_torch import obs
        from repro_torch.core import metrics as met
        from repro_torch.kernels import _nvcc
        from repro_torch.kernels.flash_attention import build as flash_build
        from repro_torch.kernels.flash_attention import kernel as FK
        from repro_torch.kernels.flash_attention import ops as FO
        from repro_torch.kernels.flash_attention import ref as FR
        from repro_torch.kernels.ppot_dispatch import build
        from repro_torch.kernels.ppot_dispatch import kernel as K
        from repro_torch.kernels.ppot_dispatch import ref as R
        from repro_torch.kernels.pool_chain import build as pool_build
        from repro_torch.kernels.pool_chain import kernel as CK
        from repro_torch.kernels.pool_chain import ref as CR
        from repro_torch.kernels.sim_chain import build as sim_build
        from repro_torch.kernels.ssd_scan import build as ssd_build
        from repro_torch.kernels.ssd_scan import kernel as SK
        from repro_torch.kernels.ssd_scan import ops as SO
        from repro_torch.kernels.ssd_scan import ref as SR
        from repro_torch.serving import recovery as trcv
        from repro_torch.serving import router as tr
        from repro_torch.serving import scanloop as tsl
        from repro_torch.utils import prng
    except ImportError as e:
        raise SmokeFailure(f"the port is not next to this script ({e})") from e
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    print(f"[device] {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}; {card}")

    time_phases()
    t0 = t_start = time.perf_counter()
    libs = (build.LIBRARY, flash_build.LIBRARY, ssd_build.LIBRARY, pool_build.LIBRARY,
            sim_build.LIBRARY, sim_build.CLOCKED)
    _nvcc.build_all(*libs)
    print(f"[build] {', '.join(lib.library_path().name for lib in libs)} "
          f"in {time.perf_counter() - t0:.2f} s (one nvcc each, at once)")
    for log in (lib.build_log for lib in libs):
        for line in log.splitlines():
            if "registers" in line or "Compiling entry" in line or "spill" in line:
                print(f"[build] {line.strip()}")

    if args.phase == "train":
        phase_train(torch, FK, dev, card)
        print(f"[total] {time.perf_counter() - t_start:.1f} s from the build, [train "
              f"smollm-360m] alone")
        return 0
    chk = KernelChecks(torch, K, R)
    phase_kernels(torch, chk, D, dev)
    flash_err = phase_flash(torch, FK, FO, FR, dev)
    train_err = phase_train_kernels(torch, FK, FR, dev)
    ssd_err = phase_ssd(torch, SK, SO, SR, dev)
    speeds = tpch_speed_set(N_REPLICAS, SEED)
    main_runs = phase_main_path(torch, tr, K, met, chk, speeds, dev)
    pool_err, scan_exact, scan_cells, real_turns = phase_scan(torch, tr, tsl, K, CK, CR, met,
                                                              tpch_speed_set, dev)
    scenarios, scenario_launches = phase_scenarios(torch, tr, tsl, tenv, K, CK, chk, met,
                                                   speeds, dev, card)
    faults, fault_launches = phase_faults(torch, tr, tsl, tenv, trcv, K, CK, chk, met,
                                          speeds, dev, card)
    obs_res, obs_launches = phase_obs(torch, tr, tsl, tenv, trcv, K, CK, speeds, dev, card,
                                      scenarios, faults)
    policies, policy_launches = phase_policies(torch, tr, tenv, D, P, prng, K, CK, chk, met,
                                               speeds, dev, card)
    fleet, fleet_launches_, fleet_stacked = phase_fleet(torch, tr, tsl, tenv, obs, K, CK, met,
                                                        speeds, dev, card)
    fleet_mesh, mesh_launches = phase_fleet_mesh(torch, tr, tsl, K, CK, met, speeds, dev, card,
                                                 fleet_stacked)
    del fleet_stacked
    fleet_launches_ = {w: fleet_launches_[w] + mesh_launches[w] for w in PROFILE_NAMES}
    load, load_launches, load_pool_err = phase_load(torch, tr, tsl, tenv, tload, obs, trcv, chk,
                                                    D, K, CK, CR, met, speeds, dev, card, faults)
    sim, sim_launches = phase_sim(torch, RS, TH, dev, card)
    sim_ext, sim_ext_launches, sim_kept = phase_sim_ext(torch, RS, tenv, met, dev, card)
    sim_obs, sim_obs_launches = phase_sim_obs(torch, RS, tenv, obs, met, dev, card, sim_kept)
    del sim_kept
    sim_th, sim_th_launches = phase_sim_theory(torch, RS, TH, met, dev, card)
    cfg, model, prefill = phase_prefill(torch, FK, dev)
    serve = phase_serve(torch, cfg, model, dev)
    prof_prefill, prof_decode = phase_model_profile(torch, cfg, model, dev)
    del model
    mcfg, mmodel, mamba_prefill = phase_ssm_prefill(torch, SK, FK, dev, "mamba2-370m",
                                                    MAMBA_B, MAMBA_S)
    mamba_serve = phase_ssm_serve(torch, mcfg, mmodel, dev)
    mprof_prefill, mprof_decode = phase_ssm_profile(torch, mcfg, mmodel, dev)
    del mmodel
    hcfg, hmodel, hymba_prefill = phase_ssm_prefill(torch, SK, FK, dev, "hymba-1.5b",
                                                    HYMBA_B, HYMBA_S)
    hprof_prefill = prefill_profile(torch, hcfg, hmodel, dev, HYMBA_B, HYMBA_S)
    del hmodel
    torch.cuda.empty_cache()
    t_zoo = time.perf_counter()
    moe_cfg, moe_model, moe_prefill = phase_moe_prefill(torch, FK, dev)
    moe_serve = phase_moe_serve(torch, moe_cfg, moe_model, dev, chk)
    del moe_model
    torch.cuda.empty_cache()
    moe_balance = phase_moe_balance(torch, dev)
    zoo = phase_zoo(torch, FK, dev)
    kvq = phase_kv_quant(torch, dev)
    print(f"[zoo] the MoE, VLM and encoder-decoder phases in "
          f"{time.perf_counter() - t_zoo:.1f} s")
    torch.cuda.empty_cache()
    train = phase_train(torch, FK, dev, card)
    per_turn, copies, idle = phase_turn_cost(torch, tr, speeds)
    times, floor_ms, mhz = phase_times(torch, K, R, D, build, dev)
    k1_times = phase_k1_times(torch, K, R, D, build, tsl, prng, dev, floor_ms)
    chain = k1_times[(N_REPLICAS, BATCH)]["chain_graph_nodes"] - 1
    a = scan_cells["a"]
    need(a["graph_nodes"] == SCAN_A_NODES_BEFORE - chain
         and a["graph_kernels"]["ppot_dispatch_fused_alias"] == 1
         and a["graph_kernels"]["ppot_dispatch_fused_alias_unkeyed"] == 0,
         f"[scan a] the turn captured {a['graph_nodes']} nodes ({a['graph_kernels']}), not the "
         f"{SCAN_A_NODES_BEFORE} before the keyed K1 less the {chain} nodes of the chain it "
         f"replaced, with one keyed K1 node")
    print(f"[scan a] the turn's graph: {a['graph_nodes']} nodes = {SCAN_A_NODES_BEFORE} before "
          f"the keyed K1 less the {chain} other nodes of the chain it replaced; one keyed K1 "
          f"node")
    pool_times = phase_pool_chain_times(torch, CK, CR, pool_build, dev, mhz, floor_ms,
                                        real_turns)
    sim_times = phase_sim_times(torch, dev, RS, mhz, floor_ms)
    pool_turn_times = {(m, t): pool_times[real_turn_label(m, t, r["n"], r["M"])]
                       for m in REAL_TURN_MODES
                       for t, r in scan_cells[m]["real_turns"].items()}
    W = SCAN_PROFILE_TURNS
    alone = {"ppot_dispatch_fused_alias": times[("ppot_dispatch_fused_alias", 1024, BATCH)],
             "alias_table": times[("alias_table", 1024, BATCH)],
             "pool_chain": pool_turn_times[("a", W)]}
    for m in REAL_TURN_MODES:
        cell = scan_cells[m]
        print(f"[replay] [scan {m}] n={cell['n']} batch={cell['batch']}: device time per "
              f"replay (profiler, {W} replays) against an event pair "
              f"around the kernel alone: "
              + "; ".join(f"{w} {cell['in_replay_ms'].get(w, 0.0):.6f} ms"
                          + (f" against {alone[w]['ms']:.6f} ms" if m == "a" else "")
                          for w in alone)
              + f" (pool_chain on this cell's real turn {W} alone "
              f"{pool_turn_times[(m, W)]['ms']:.6f} ms; launch floor {floor_ms:.6f} ms)")
        c = cell["chain_cause"]
        if c["turn"] != W:
            worst, typical = pool_turn_times[(m, c["turn"])], pool_turn_times[(m, W)]
            print(f"[worst turn] [scan {m}] pool_chain on turn {c['turn']} (longest chain "
                  f"{worst['longest_chain']}) {worst['ms']:.6f} ms, chain bound "
                  f"{worst['chain_ms']:.6f} ms; on turn {W} (longest chain "
                  f"{typical['longest_chain']}) {typical['ms']:.6f} ms")
    table_build = phase_table_build(torch, K, R, D, dev)
    flash_times = phase_flash_times(torch, FK, FR, dev)
    train_times = phase_train_times(torch, FK, FR, dev)
    ssd_times = phase_ssd_times(torch, SK, SO, SR, dev)

    total = {name: sum(r["launches"][name] for r in main_runs.values())
             + scenario_launches[name] + fault_launches[name] + policy_launches[name]
             + obs_launches[name] + fleet_launches_[name] + load_launches[name]
             + moe_serve["launches"][name]
             for name in REPLACES}
    # moe_serve_launches: [serve moonshot-v1-16b-a3b]'s router's launches
    kernels = []
    for name in REPLACES:
        t = times[(name, 1024, BATCH)]
        # the keyed K1's large_*: (2048, 16384); by_shape: each shape's
        # replay of one graph of the kernel against one of the chain it
        # replaced (uniform_quad + clone + unkeyed K1), and the kernel alone
        # at [serve moonshot]'s router shape; before_ms: the unkeyed kernel
        # that the engine launched before (PPOT_BEFORE_MS)
        k1 = {} if name != "ppot_dispatch_fused_alias" else dict(
            large_ms=times[(name, 2048, 16384)]["ms"],
            large_bound_ms=times[(name, 2048, 16384)]["bound_ms"],
            before_ms=PPOT_BEFORE_MS[name][1024],
            by_shape={f"{n}x{B}": rec for (n, B), rec in k1_times.items()})
        if name == "ppot_dispatch_fused_alias_unkeyed":
            k1 = dict(note="K1 on given uniforms, the Pallas kernel's contract: held to its "
                      "plain version here; no serving path calls it")
        kernels.append(dict(
            name=name, route="cuda", source=SOURCE, replaces=REPLACES[name],
            launches=total[name], max_abs_err=chk.max_err[name], ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=None, moe_serve_launches=moe_serve["launches"][name], **k1))
    # the array form at (1024, 136), the scheduler cell's turn size with a
    # planted 30-step chain: a fixed case, so the line compares from run to
    # run; real_turn_ms: the turn form in place on real turn 50 of [scan a]
    t = pool_times[pool_case_label(*POOL_CASES[1])]
    kernels.append(dict(
        name="pool_chain", route="cuda", source=POOL_SOURCE, replaces=POOL_REPLACES,
        launches=sum(c["launches"]["pool_chain"] for c in scan_cells.values())
        + scenario_launches["pool_chain"] + fault_launches["pool_chain"]
        + policy_launches["pool_chain"] + obs_launches["pool_chain"]
        + fleet_launches_["pool_chain"] + load_launches["pool_chain"],
        max_abs_err=max(pool_err, load_pool_err), ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
        bound_by=t["bound_by"], library_ms=None,
        real_turn_ms=pool_turn_times[("a", W)]["ms"]))
    # Fig. 8's static Rosella run cut to SIM_LINE_ROUNDS rounds, where the
    # plain chain on the card is timed too; full_ms: its 120,000 rounds,
    # full_bound_ms: their bound; fig10_ms: Fig. 10a's known-speed run;
    # fleet_sweep_ms: [sim fleet]'s launch (six chains of 60,000 rounds);
    # obs_*: the telemetry instance on the 120,000 rounds, its bound with the
    # rows written, and [sim obs]'s launch
    kernels.append(dict(
        name="sim_chain", route="cuda", source=SIM_SOURCE, replaces=SIM_REPLACES,
        launches=sim_launches["sim_chain"] + sim_ext_launches["sim_chain"]
        + sim_obs_launches["sim_chain"] + sim_th_launches["sim_chain"],
        max_abs_err=max(c["max_abs_err"] for checks in (sim["checks"], sim_ext["checks"])
                        for c in checks.values()), ms=sim_times["ms"],
        plain_ms=sim_times["plain_ms"], bound_ms=sim_times["bound_ms"],
        bound_by=sim_times["bound_by"], library_ms=None, rounds=sim_times["rounds"],
        chain_ms=sim_times["chain_ms"], full_rounds=sim_times["full_rounds"],
        full_ms=sim_times["full_ms"],
        full_bound_ms=max(sim_times["runs"]["fig8 static/rosella"][k]
                          for k in ("bytes_ms", "ops_ms")),
        fig10_ms=sim_times["runs"]["fig10 10a/ppot"]["ms"],
        fleet_sweep_ms=sim_ext["fleet"]["launch_ms"], env_launch_ms=sim_ext["env"]["launch_ms"],
        obs_full_ms=sim_times["obs_fig8_ms"], obs_off_full_ms=sim_times["obs_off_fig8_ms"],
        obs_full_bound_ms=sim_times["obs_fig8_bound_ms"], obs_launch_ms=sim_obs["launch_ms"]))
    # launches: every prefill phase's (smollm, hymba, moonshot, the zoo); the
    # d128_* keys: moonshot's prefill shape (16 heads of 128) and its count
    t, t128 = flash_times["main"], flash_times["d128"]
    flash_launches = {"smollm-360m": prefill["launches"],
                      "hymba-1.5b": hymba_prefill["flash_launches"],
                      MOE_ARCH: moe_prefill["flash_launches"],
                      **{arch: r["flash_launches"] for arch, r in zoo.items()},
                      "train smollm-360m": train["launches"]["flash_attention_fwd"]}
    kernels.append(dict(
        name="flash_attention_fwd", route="cuda", source=FLASH_SOURCE,
        replaces=FLASH_REPLACES, launches=sum(flash_launches.values()),
        max_abs_err=flash_err, ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
        bound_by=t["bound_by"], library_ms=t["library_ms"], launches_by_phase=flash_launches,
        d128_launches=moe_prefill["flash_launches"], d128_ms=t128["ms"],
        d128_plain_ms=t128["plain_ms"], d128_bound_ms=t128["bound_ms"],
        d128_bound_by=t128["bound_by"], d128_library_ms=t128["library_ms"]))
    # K4b: [train smollm-360m]'s launches (the 6-step run, the run resumed
    # from step 3 and the two int8 steps); its times at smollm's training shape
    t = train_times
    kernels.append(dict(
        name="flash_attention_bwd", route="cuda", source=FLASH_SOURCE,
        replaces=FLASH_BWD_REPLACES, launches=train["launches"]["flash_attention_bwd"],
        max_abs_err=train_err, ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
        bound_by=t["bound_by"], library_ms=t["library_ms"],
        launches_per_step=train["k4b_per_step"], step_share=train["k4b_share"]))
    t = ssd_times["main"]
    kernels.append(dict(
        name="ssd_scan", route="cuda", source=SSD_SOURCE, replaces=SSD_REPLACES,
        launches=mamba_prefill["ssd_launches"], max_abs_err=ssd_err, ms=t["ms"],
        plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
        library_ms=None))
    summary = {m: {k: r[k] for k in ("turns", "p50", "p99", "rho", "wall_s",
                                     "overflow_turns", "launches")}
               for m, r in main_runs.items()}
    print(f"[summary] {json.dumps(summary)}")
    print(f"[summary] scan exact {json.dumps(scan_exact)}")
    print(f"[summary] scan {json.dumps(scan_cells)}")
    print(f"[summary] scenarios {json.dumps(scenarios)}")
    print(f"[summary] faults {json.dumps(faults)}")
    print(f"[summary] obs {json.dumps(obs_res)}")
    print(f"[summary] policies {json.dumps(policies)}")
    print(f"[summary] fleet {json.dumps(fleet)}")
    print(f"[summary] fleet mesh {json.dumps(fleet_mesh)}")
    print(f"[summary] load {json.dumps(load)}")
    print(f"[summary] sim {json.dumps(sim)}")
    print(f"[summary] sim environments and fleet {json.dumps(sim_ext)}")
    print(f"[summary] sim obs {json.dumps(sim_obs)}")
    print(f"[summary] sim theory and coupling {json.dumps(sim_th)}")
    print(f"[summary] sim_chain times {json.dumps(sim_times)}")
    print(f"[summary] prefill {json.dumps(prefill)}")
    print(f"[summary] serve {json.dumps(serve)}")
    print(f"[summary] profile prefill {json.dumps(prof_prefill)} decode "
          f"{json.dumps(prof_decode)}")
    print(f"[summary] prefill mamba2-370m {json.dumps(mamba_prefill)}")
    print(f"[summary] serve mamba2-370m {json.dumps(mamba_serve)}")
    print(f"[summary] profile mamba2-370m prefill {json.dumps(mprof_prefill)} decode "
          f"{json.dumps(mprof_decode)}")
    print(f"[summary] prefill hymba-1.5b {json.dumps(hymba_prefill)}")
    print(f"[summary] profile hymba-1.5b prefill {json.dumps(hprof_prefill)}")
    print(f"[summary] prefill {MOE_ARCH} {json.dumps(moe_prefill)}")
    print(f"[summary] serve {MOE_ARCH} {json.dumps(moe_serve)}")
    print(f"[summary] moe balance {json.dumps(moe_balance)}")
    print(f"[summary] prefill zoo {json.dumps(zoo)}")
    print(f"[summary] kv_quant {json.dumps(kvq)}")
    print(f"[summary] train smollm-360m {json.dumps(train)}")
    print(f"[summary] launches/turn {per_turn:.1f}, copies/turn {copies:.1f}, "
          f"idle share {idle:.4f}, launch floor {floor_ms:.6f} ms")
    print(f"[summary] build_alias_table per call "
          f"{json.dumps({f'{k[0]} {k[1]}': v for k, v in table_build.items()})}")
    print(f"[total] {time.perf_counter() - t_start:.1f} s from the build to the result lines")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
