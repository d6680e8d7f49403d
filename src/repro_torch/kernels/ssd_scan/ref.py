"""Plain versions of the SSD chunked scan. The reference layout is x [BH,
S, P], dt [BH, S], A [BH], B/C [G, S, N] with row bh reading row
bh // (BH / G):

  ``ssd_chunked_ref``  the kernel's function: the chunked math of the TPU
                       kernel (``src/repro/kernels/ssd_scan/kernel.py``)
                       per row, chunk length Q, f32 throughout;
  ``ssd_chunked_heads`` the same in the model layout (x [B, S, H, P],
                       dt [B, S, H], A [H], B/C [B, S, N]): the plain
                       version of ``kernel.ssd_scan_heads`` and the math of
                       ``models.ssm.ssd_chunked``;
  ``ssd_chunk_parallel`` the same function in the kernel's decomposition:
                       C·Bᵀ once per (group, chunk), the intra-chunk pass,
                       the carry pass and the inter-chunk output;
  ``without_carry``    a planted fault: a scan with the chunk carry left out;
  ``mamba2_decays``    decay parameters under which the carry matters;
  ``ssd_ref``          the sequential recurrence, the oracle (a port of
                       ``src/repro/kernels/ssd_scan/ref.py``);
  ``row_relative_error`` the error measure of the checks on the card.
"""
from __future__ import annotations

import math

import torch


def _rows(Bm, BH: int):
    """B or C as one row per bh (the broadcast form)."""
    return Bm.float().repeat_interleave(BH // Bm.shape[0], dim=0)


def ssd_chunked_ref(x, dt, A, Bm, Cm, *, chunk: int):
    """Per chunk of ``chunk`` steps (it must divide S):
      y  = (C·Bᵀ ⊙ exp(cum_q − cum_k)[q ≥ k]) · (dt·x) + (C ⊙ exp(cum)) · h_in
      h' = exp(cum_end) · h_in + Σ_k exp(cum_end − cum_k) B_k ⊗ (dt_k x_k)
    with cum the in-chunk cumulative sum of dt·A. Returns (y [BH, S, P],
    h [BH, N, P]), both f32."""
    BH, S, P = x.shape
    N = Bm.shape[-1]
    Q = chunk
    nc = S // Q
    xc = x.float().reshape(BH, nc, Q, P)
    dtc = dt.float().reshape(BH, nc, Q)
    bc = _rows(Bm, BH).reshape(BH, nc, Q, N)
    cc = _rows(Cm, BH).reshape(BH, nc, Q, N)
    cum = torch.cumsum(dtc * A.float()[:, None, None], dim=2)  # [BH, nc, Q]

    tri = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    dec = torch.where(tri, torch.exp(cum[..., :, None] - cum[..., None, :]), 0.0)
    scores = torch.einsum("zcqn,zckn->zcqk", cc, bc) * dec
    xdt = xc * dtc[..., None]
    y_intra = torch.einsum("zcqk,zckp->zcqp", scores, xdt)

    decay_to_end = torch.exp(cum[..., -1:] - cum)  # [BH, nc, Q]
    chunk_state = torch.einsum("zckn,zckp->zcnp", bc * decay_to_end[..., None], xdt)
    chunk_decay = torch.exp(cum[..., -1])  # [BH, nc]
    h = torch.zeros(BH, N, P, dtype=torch.float32, device=x.device)
    h_in = []
    for c in range(nc):  # the state entering each chunk
        h_in.append(h)
        h = h * chunk_decay[:, c, None, None] + chunk_state[:, c]
    h_in = torch.stack(h_in, dim=1)  # [BH, nc, N, P]
    y_inter = torch.einsum("zcqn,zcnp->zcqp", cc * torch.exp(cum)[..., None], h_in)
    return (y_intra + y_inter).reshape(BH, S, P), h


def ssd_chunk_parallel(x, dt, A, Bm, Cm, *, chunk: int):
    """``ssd_chunked_ref`` (reference layout, B/C [G, S, N]) computed as the
    kernel's grids compute it (``csrc/ssd_scan.cu``):

      0. per (group g, chunk c): CB = C·Bᵀ on the causal triangle, [Q, Q],
         shared by the BH / G rows of the group;
      1. per (row, chunk), independently: cum, the in-chunk cumulative sum
         of dt·A; y = (CB ⊙ exp(cum_q − cum_k) dt_k) x; the chunk's own
         state s_c = Σ_k exp(cum_end − cum_k) dt_k B_k ⊗ x_k;
      2. per row, in chunk order: h_in,c = h; h = exp(cum_end,c) h + s_c;
      3. per (row, chunk): y += exp(cum_q) (C_q · h_in,c).

    Returns (y [BH, S, P], h [BH, N, P]), f32."""
    BH, S, P = x.shape
    G, N = Bm.shape[0], Bm.shape[-1]
    Q = chunk
    nc = S // Q
    tri = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    bc = Bm.float().reshape(G, nc, Q, N)
    cc = Cm.float().reshape(G, nc, Q, N)
    cb = torch.where(tri, torch.einsum("gcqn,gckn->gcqk", cc, bc), 0.0)  # 0.
    rows = torch.arange(BH, device=x.device) // (BH // G)  # each row's group
    xc = x.float().reshape(BH, nc, Q, P)
    dtc = dt.float().reshape(BH, nc, Q)
    cum = torch.cumsum(dtc * A.float()[:, None, None], dim=2)  # 1.
    dec = torch.where(tri, torch.exp(cum[..., :, None] - cum[..., None, :]), 0.0)
    y = torch.einsum("zcqk,zck,zckp->zcqp", cb[rows] * dec, dtc, xc)
    w = torch.exp(cum[..., -1:] - cum) * dtc
    states = torch.einsum("zckn,zck,zckp->zcnp", bc[rows], w, xc)
    h = torch.zeros(BH, N, P, dtype=torch.float32, device=x.device)
    h_in = torch.empty_like(states)
    for c in range(nc):  # 2.
        h_in[:, c] = h
        h = torch.exp(cum[:, c, -1])[:, None, None] * h + states[:, c]
    y = y + torch.exp(cum)[..., None] * torch.einsum("zcqn,zcnp->zcqp", cc[rows], h_in)  # 3.
    return y.reshape(BH, S, P), h


def ssd_chunked_heads(x, dt, A, Bm, Cm, *, chunk: int):
    """``ssd_chunked_ref`` in the model layout (``kernel.ssd_scan_heads``).

    x [B, S, H, P]; dt [B, S, H] positive steps; A [H] negative decay rates;
    Bm, Cm [B, S, N] shared across heads; ``chunk`` must divide S. Returns
    (y [B, S, H, P], final state [B, H, N, P]), f32."""
    Bsz, S, H, Pd = x.shape
    N = Bm.shape[-1]
    Q = chunk
    nc = S // Q

    xc = x.reshape(Bsz, nc, Q, H, Pd)
    dtc = dt.reshape(Bsz, nc, Q, H)
    bc = Bm.reshape(Bsz, nc, Q, N)
    cc = Cm.reshape(Bsz, nc, Q, N)

    cum = torch.cumsum(dtc * A, dim=2)  # [B, nc, Q, H] in-chunk log decay (<= 0)

    # intra-chunk: decay(q <- k) = exp(cum_q - cum_k) for q >= k
    dmask = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [B, nc, Q, Q, H]
    tri = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    dec = torch.where(tri[None, None, :, :, None], torch.exp(dmask), 0.0)
    cb = torch.einsum("bcqn,bckn->bcqk", cc, bc)
    scores = cb[..., None] * dec
    xdt = (xc * dtc[..., None]).float()
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", scores, xdt)

    # each chunk's contribution to its end state, and its total decay
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)  # [B, nc, Q, H]
    chunk_state = torch.einsum("bckn,bckh,bckhp->bchnp", bc, decay_to_end, xdt)
    chunk_decay = torch.exp(cum[:, :, -1, :])  # [B, nc, H]

    # inter-chunk carry: the state entering each chunk
    h = torch.zeros(Bsz, H, N, Pd, dtype=torch.float32, device=x.device)
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = h * chunk_decay[:, c, :, None, None] + chunk_state[:, c]
    h_in = torch.stack(h_in, dim=1)  # [B, nc, H, N, P]

    y_inter = torch.einsum("bcqn,bcqh,bchnp->bcqhp", cc, torch.exp(cum), h_in)
    return (y_intra + y_inter).reshape(Bsz, S, H, Pd), h


def without_carry(scan, x, dt, A, Bm, Cm, *, chunk: int):
    """``scan`` (``ops.ssd`` or ``ssd_chunked_heads``, model layout) with
    every chunk started from a zero state, as if ``h_in`` were left out: a
    planted fault, which shows how much the carry adds on given inputs.
    Returns (y [B, S, H, P], the last chunk's own state [B, H, N, P])."""
    B, S, H, P = x.shape
    N, nc = Bm.shape[-1], S // chunk
    y, h = scan(x.reshape(B * nc, chunk, H, P), dt.reshape(B * nc, chunk, H), A,
                Bm.reshape(B * nc, chunk, N), Cm.reshape(B * nc, chunk, N), chunk=chunk)
    return y.reshape(B, S, H, P), h.reshape(B, nc, H, N, P)[:, -1]


def mamba2_decays(n: int, generator: torch.Generator):
    """(A_log [n], dt_bias [n]) for the checks, drawn as Mamba2's own
    initialisation draws them: A ~ U(1, 16), dt log-uniform in [0.001,
    0.1] and dt_bias its inverse softplus. A head's state then decays by
    e^-0.001 to e^-1.6 per step and reaches across many chunks; under the
    JAX package's init (A_log = dt_bias = 0: A = -1, dt ~ softplus(N(0,
    1))) it halves at every step and reaches only the first rows of the
    next chunk, so a wrong carry across several chunks would not show."""
    dev = generator.device
    A = 1.0 + 15.0 * torch.rand(n, generator=generator, device=dev)
    lo, hi = math.log(1e-3), math.log(0.1)
    dt = torch.exp(lo + (hi - lo) * torch.rand(n, generator=generator, device=dev))
    return torch.log(A), dt + torch.log(-torch.expm1(-dt))


def ssd_ref(x, dt, A, Bm, Cm):
    """The recurrence h_t = exp(dt_t·A)·h_{t-1} + dt_t·B_t ⊗ x_t, y_t =
    C_t·h_t, step by step. Returns (y [BH, S, P], h [BH, N, P]), f32."""
    BH, S, P = x.shape
    Bm, Cm = _rows(Bm, BH), _rows(Cm, BH)
    x, dt, A = x.float(), dt.float(), A.float()
    h = torch.zeros(BH, Bm.shape[-1], P, dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        a = torch.exp(dt[:, t] * A)
        h = h * a[:, None, None] + torch.einsum("bn,b,bp->bnp", Bm[:, t], dt[:, t], x[:, t])
        ys.append(torch.einsum("bn,bnp->bp", Cm[:, t], h))
    return torch.stack(ys, dim=1), h


def row_relative_error(got, want) -> torch.Tensor:
    """f32[...]: each row's (last axis) largest abs error over the largest
    abs value of that row of ``want``; 0 where both rows are all zero, inf
    where only ``want``'s is. An elementwise atol is blind to rows whose
    values are small (a state that has decayed, an output late in a
    strongly decaying chunk); this scale follows each row."""
    err = (got.float() - want.float()).abs().amax(dim=-1)
    scale = want.float().abs().amax(dim=-1)
    return torch.where(scale > 0, err / scale.clamp_min(1e-30),
                       torch.where(err > 0, torch.inf, 0.0))
