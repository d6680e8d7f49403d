"""The replica pool's submission chain of one serving turn: the CUDA kernel
(``kernel``), its plain version (``ref``) and the build (``build``)."""
