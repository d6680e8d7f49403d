"""PyTorch/CUDA port of the Rosella scheduler.

Mirrors the JAX package ``repro`` module for module; so far it holds the
PPoT-SQ(2) serving turn (``serving.router.RosellaRouter`` and
``run_simulation``) with its dispatch kernels written in CUDA for Hopper
(``kernels/ppot_dispatch``). Imports torch and numpy only.
"""
