"""PyTorch/CUDA port of the Rosella scheduler.

Mirrors the JAX package ``repro`` module for module; so far it holds the
dispatch engine with all eight scheduling policies (``core``), the serving
turn (``serving.router.RosellaRouter`` and ``run_simulation``) and the
one-program serving loop (``serving.scanloop``), the environment engine
(``env``) and the dense, SSM and hybrid model families, with the PPoT
dispatch, flash-attention, SSD-scan and pool-chain kernels written in CUDA
for Hopper (``kernels/``). Imports torch and numpy only.
"""
