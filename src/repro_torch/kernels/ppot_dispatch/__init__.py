"""Batched PPoT-SQ(2) dispatch: CUDA kernels (``kernel``), their plain
versions (``ref``), the build (``build``) and standalone entry points
(``ops``)."""
