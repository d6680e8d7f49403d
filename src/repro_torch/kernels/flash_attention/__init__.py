"""Flash-attention forward: the CUDA kernel (``kernel``), its plain
version (``ref``), the build (``build``) and the [B, S, H, D] entry point
(``ops``)."""
