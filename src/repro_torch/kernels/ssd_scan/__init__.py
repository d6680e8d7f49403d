"""Mamba2 SSD chunked scan: the CUDA kernel (``kernel``), its plain
version and the sequential oracle (``ref``), the build (``build``) and the
model-layout entry point (``ops``)."""
