"""Wrapper of the hand-written SSD chunked-scan kernel (``csrc/ssd_scan.cu``),
which replaces ``ssd_scan`` of ``src/repro/kernels/ssd_scan/kernel.py``.

Two layouts reach the one kernel:

  ssd_scan        the reference's: x [BH, S, P], dt [BH, S], A [BH],
                  B/C [G, S, N] with G dividing BH (row bh reads B/C row
                  bh // (BH / G); G = BH is the reference's broadcast form)
                  -> y [BH, S, P], h [BH, N, P]
  ssd_scan_heads  the model's: x [B, S, H, P], dt [B, S, H], A [H],
                  B/C [B, S, N] shared by the heads
                  -> y [B, S, H, P], h [B, H, N, P]

x is f32 or bf16; dt, A, B and C are f32; y and h are f32. The chunk
length must divide S (``ops.ssd`` picks it as ``ssd_chunked`` does); P <=
64, N <= 128, chunk <= 128. The wrapper checks device, dtype, shape and contiguity and
raises on anything else. Given CPU tensors it runs the kernel's plain
version (``ref.ssd_chunked_ref``, ``ref.ssd_chunked_heads`` for the model
layout); given CUDA tensors it launches the kernel's grids on the current
stream or raises. Besides y and h it allocates the kernel's scratch with
``torch.empty``: the chunk states [BH, S / Q, N, P] (134 MB at mamba2's
prefill layer), the in-chunk cumulative decays [BH, S] and C·Bᵀ per
(group, chunk) [G, S / Q, Qp, Qp] (Qp: Q rounded up to 32), all f32.

``launches["ssd_scan"]`` rises by one per call that launches the kernel
(one per SSM layer on the model path), ``launches["ssd_scan_grids"]`` by
the grids that call launched (``GRIDS``); neither rises anywhere else.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan import build, ref

DEFAULT_Q = 128
MAX_Q, MAX_N, MAX_P = 128, 128, 64
X_DTYPES = (torch.float32, torch.bfloat16)

# the grids one call launches (csrc/ssd_scan.cu: cb, intra, carry, inter)
GRIDS = 4

launches = {"ssd_scan": 0, "ssd_scan_grids": 0}


def _check(x, dt, A, Bm, Cm, chunk, heads: bool) -> int:
    """The chunk length Q = min(chunk, S) after checking the inputs; raises
    on what the kernel does not take."""
    ts = {"x": x, "dt": dt, "A": A, "Bm": Bm, "Cm": Cm}
    for name, t in ts.items():
        if not isinstance(t, torch.Tensor):
            raise ValueError(f"{name}: expected a tensor")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
        if name == "x":
            if t.dtype not in X_DTYPES:
                raise ValueError(f"x: dtype {t.dtype} not in {X_DTYPES}")
        elif t.dtype != torch.float32:
            raise ValueError(f"{name}: dtype {t.dtype}, expected torch.float32")
    devs = {t.device for t in ts.values()}
    if len(devs) != 1 or next(iter(devs)).type not in ("cpu", "cuda"):
        raise ValueError(f"inputs must share one cpu or cuda device, got "
                         f"{sorted(map(str, devs))}")
    if heads:
        if x.dim() != 4:
            raise ValueError(f"x {list(x.shape)}: expected [B, S, H, P]")
        Bsz, S, H, P = x.shape
        want = {"dt": (Bsz, S, H), "A": (H,), "Bm": (Bsz, S, Bm.shape[-1]),
                "Cm": (Bsz, S, Bm.shape[-1])}
    else:
        if x.dim() != 3:
            raise ValueError(f"x {list(x.shape)}: expected [BH, S, P]")
        BH, S, P = x.shape
        if Bm.dim() != 3 or Bm.shape[0] < 1 or BH % Bm.shape[0]:
            raise ValueError(f"Bm {list(Bm.shape)}: expected [G, S, N] with G dividing {BH}")
        want = {"dt": (BH, S), "A": (BH,), "Bm": (Bm.shape[0], S, Bm.shape[-1]),
                "Cm": (Bm.shape[0], S, Bm.shape[-1])}
    for name, shape in want.items():
        if tuple(ts[name].shape) != shape:
            raise ValueError(f"{name} {list(ts[name].shape)}: expected {list(shape)}")
    N = Bm.shape[-1]
    if not (1 <= P <= MAX_P and 1 <= N <= MAX_N and S >= 1):
        raise ValueError(f"P={P}, N={N}, S={S}: need 1 <= P <= {MAX_P}, 1 <= N <= {MAX_N}")
    Q = min(chunk, S) if isinstance(chunk, int) else chunk
    if not (isinstance(Q, int) and 1 <= Q <= MAX_Q and S % Q == 0):
        raise ValueError(f"chunk {chunk!r}: min(chunk, S) must be an int in [1, {MAX_Q}] "
                         f"dividing S={S}")
    return Q


def _launch(x, dt, A, Bm, Cm, y, h, *, BH, heads, S, P, chunk) -> None:
    G, N = Bm.shape[0], Bm.shape[-1]
    nc, Qp = S // chunk, -(-chunk // 32) * 32
    states = torch.empty(BH, nc, N, P, dtype=torch.float32, device=x.device)
    cum = torch.empty(BH, S, dtype=torch.float32, device=x.device)
    cb = torch.empty(G, nc, Qp, Qp, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = build.load().ssd_scan(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            y.data_ptr(), h.data_ptr(), states.data_ptr(), cum.data_ptr(), cb.data_ptr(), BH,
            heads, G, A.shape[0], S, P, N, chunk, int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream)
    build.LIBRARY.raise_on(err, "ssd_scan")
    launches["ssd_scan"] += 1
    launches["ssd_scan_grids"] += GRIDS


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int = DEFAULT_Q):
    """Reference layout (see the module docstring) -> (y [BH, S, P] f32,
    h [BH, N, P] f32). Q = min(chunk, S) must divide S."""
    Q = _check(x, dt, A, Bm, Cm, chunk, heads=False)
    if x.device.type == "cpu":
        return ref.ssd_chunked_ref(x, dt, A, Bm, Cm, chunk=Q)
    BH, S, P = x.shape
    y = torch.empty(BH, S, P, dtype=torch.float32, device=x.device)
    h = torch.empty(BH, Bm.shape[-1], P, dtype=torch.float32, device=x.device)
    _launch(x, dt, A, Bm, Cm, y, h, BH=BH, heads=1, S=S, P=P, chunk=Q)
    return y, h


def ssd_scan_heads(x, dt, A, Bm, Cm, *, chunk: int = DEFAULT_Q):
    """Model layout (see the module docstring) -> (y [B, S, H, P] f32,
    h [B, H, N, P] f32), B/C read in place for every head. Q = min(chunk,
    S) must divide S."""
    Q = _check(x, dt, A, Bm, Cm, chunk, heads=True)
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    if x.device.type == "cpu":
        return ref.ssd_chunked_heads(x, dt, A, Bm, Cm, chunk=Q)
    y = torch.empty(Bsz, S, H, P, dtype=torch.float32, device=x.device)
    h = torch.empty(Bsz, H, N, P, dtype=torch.float32, device=x.device)
    _launch(x, dt, A, Bm, Cm, y, h, BH=Bsz * H, heads=H, S=S, P=P, chunk=Q)
    return y, h


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def launch_counts() -> dict[str, int]:
    return dict(launches)
