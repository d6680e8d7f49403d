"""The port's SSD chunked scan (K5): its plain version on the CPU, the
model-layout entry point ``ops.ssd`` and the wrapper's checks, against the
JAX package's Pallas kernel in interpret mode, its sequential oracle
``ssd_ref`` and the model's ``ssd_chunked``.

Inputs come from numpy with a seed and are the same values in both
packages (bf16 cases round x, dt, B and C to bf16 first; the port takes dt,
B and C as the f32 values of those bf16 numbers, as the Pallas kernel
widens them). Tolerances are those of ``tests/test_kernels.py``: 2e-3 in
float32 and 5e-2 in bfloat16 against the oracle and the Pallas kernel,
1e-3 against ``ssd_chunked``; measured up to 6e-6 on values of size ~8.

``repro.models`` imports only on jax 0.9 with the shim of
``tests/test_torch_model.py``, applied inside the ``ref`` fixture."""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_model import reference_shim

from repro.kernels.ssd_scan import ref as jref
from repro.kernels.ssd_scan.kernel import ssd_scan as jssd
from repro_torch.kernels.ssd_scan import kernel as tk
from repro_torch.kernels.ssd_scan import ops as tops
from repro_torch.kernels.ssd_scan import ref as tref
from repro_torch.models import ssm as TS

TOL = {"float32": 2e-3, "bfloat16": 5e-2}
CHUNKED_TOL = 1e-3


@pytest.fixture(scope="module")
def ref():
    """``repro.models.ssm`` under the jax-0.9 shim (see
    tests/test_torch_model.py), undone after the module's tests."""
    with reference_shim():
        from repro.models import ssm

        yield types.SimpleNamespace(ssm=ssm)


def _inputs(BH, S, P, N, seed, G=None):
    """x, dt, A, B, C as f32 numpy arrays (dt positive, A negative)."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(BH, S, P) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(BH, S))).astype(np.float32)
    A = (-np.exp(rng.randn(BH) * 0.3)).astype(np.float32)
    Bm = (rng.randn(G or BH, S, N) * 0.5).astype(np.float32)
    Cm = (rng.randn(G or BH, S, N) * 0.5).astype(np.float32)
    return x, dt, A, Bm, Cm


def _bf16(a):
    return np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("BH,S,P,N,chunk",
                         [(2, 128, 32, 16, 64), (1, 256, 64, 32, 128), (4, 192, 16, 8, 64)])
def test_plain_version_matches_pallas_kernel_and_oracle(BH, S, P, N, chunk, dtype):
    x, dt, A, Bm, Cm = _inputs(BH, S, P, N, S + P)
    if dtype == "bfloat16":
        x, dt, Bm, Cm = map(_bf16, (x, dt, Bm, Cm))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tk.reset_launches()
    y, h = tk.ssd_scan(tx, *map(torch.from_numpy, (dt, A, Bm, Cm)), chunk=chunk)
    assert tk.launch_counts()["ssd_scan"] == 0  # CPU: no launch
    assert y.dtype == h.dtype == torch.float32
    assert y.shape == (BH, S, P) and h.shape == (BH, N, P)
    jdt = getattr(jnp, dtype)
    jx, jdt_, jB, jC = (jnp.asarray(a).astype(jdt) for a in (x, dt, Bm, Cm))
    ky, kh = jssd(jx, jdt_, jnp.asarray(A), jB, jC, chunk=chunk, interpret=True)
    oy, oh = jref.ssd_ref(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)))
    tol = TOL[dtype]
    for got, want in ((y, ky), (y, oy), (h, kh), (h, oh)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=tol)
    # the port's own oracle is the reference's
    sy, sh = tref.ssd_ref(*map(torch.from_numpy, (x, dt, A, Bm, Cm)))
    np.testing.assert_allclose(sy.numpy(), np.asarray(oy), atol=tol, rtol=tol)
    np.testing.assert_allclose(sh.numpy(), np.asarray(oh), atol=tol, rtol=tol)


def _mamba2_inputs(BH, S, P, N, seed):
    """``_inputs`` with A and dt = softplus(N(0, 1) + dt_bias) of each row
    drawn as Mamba2 draws them (``ref.mamba2_decays``): a row's state then
    reaches across many chunks, where under ``_inputs``' decays (those of
    tests/test_kernels.py) it reaches only the first rows of the next."""
    x, _, _, Bm, Cm = _inputs(BH, S, P, N, seed)
    gen = torch.Generator().manual_seed(seed)
    A_log, dt_bias = (t.numpy() for t in tref.mamba2_decays(BH, gen))
    z = np.random.RandomState(seed + 1).randn(BH, S).astype(np.float32)
    dt = np.log1p(np.exp(z + dt_bias[:, None])).astype(np.float32)
    return x, dt, (-np.exp(A_log)).astype(np.float32), Bm, Cm


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("BH,S,P,N,chunk",
                         [(8, 256, 32, 16, 64), (16, 512, 16, 8, 128), (4, 1024, 16, 8, 64)])
def test_plain_version_holds_the_carry_under_mamba2_decays(BH, S, P, N, chunk, dtype):
    """Under Mamba2's decays the plain version matches the Pallas kernel
    (interpret) and the oracle at the tolerances of tests/test_kernels.py;
    the same scan with each chunk started from a zero state (the carry
    left out) misses the oracle by more than twice those tolerances."""
    x, dt, A, Bm, Cm = _mamba2_inputs(BH, S, P, N, S + P)
    if dtype == "bfloat16":
        x, dt, Bm, Cm = map(_bf16, (x, dt, Bm, Cm))
    t = torch.from_numpy
    y, h = tk.ssd_scan(t(x).to(getattr(torch, dtype)), *map(t, (dt, A, Bm, Cm)), chunk=chunk)
    jdt = getattr(jnp, dtype)
    jx, jdt_, jB, jC = (jnp.asarray(a).astype(jdt) for a in (x, dt, Bm, Cm))
    ky, kh = jssd(jx, jdt_, jnp.asarray(A), jB, jC, chunk=chunk, interpret=True)
    oy, oh = jref.ssd_ref(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)))
    tol = TOL[dtype]
    for got, want in ((y, ky), (y, oy), (h, kh), (h, oh)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=tol)
    nc = S // chunk  # every chunk its own row: no carry
    split = lambda a: a.reshape(BH * nc, chunk, *a.shape[2:])  # noqa: E731
    y_nc, _ = tk.ssd_scan(t(split(x)).to(getattr(torch, dtype)), t(split(dt)),
                          t(np.repeat(A, nc)), t(split(Bm)), t(split(Cm)), chunk=chunk)
    miss = np.abs(y_nc.numpy().reshape(BH, S, P) - np.asarray(oy))
    assert (miss / (tol + tol * np.abs(np.asarray(oy)))).max() > 2


def _model_inputs(B, S, H, P, N, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, S, H, P).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(B, S, H))).astype(np.float32)
    A = (-np.exp(rng.randn(H) * 0.3)).astype(np.float32)
    Bm = rng.randn(B, S, N).astype(np.float32)
    Cm = rng.randn(B, S, N).astype(np.float32)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("S,chunk", [(128, 64), (100, 64), (96, 64), (100, 128)])
def test_ops_matches_model_ssd_chunked(ref, S, chunk):
    """``ops.ssd`` (the [B, S, H, P] entry point, B/C read in place) and the
    port's ``models.ssm.ssd_chunked`` against the reference's
    ``ssd_chunked``; S=100 and S=96 at chunk 64 take gcd(S, chunk) as the
    chunk (4 and 32), S=100 at chunk 128 takes all of S as one chunk."""
    arrs = _model_inputs(2, S, 3, 16, 8, 11 + S)
    want_y, want_h = ref.ssm.ssd_chunked(*map(jnp.asarray, arrs), chunk=chunk)
    tx, tdt, tA, tB, tC = map(torch.from_numpy, arrs)
    for y, h in (tops.ssd(tx, tdt, tA, tB, tC, chunk=chunk),
                 TS.ssd_chunked(tx, tdt, tA, tB, tC, chunk)):
        assert y.shape == (2, S, 3, 16) and h.shape == (2, 3, 8, 16)
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=CHUNKED_TOL,
                                   rtol=CHUNKED_TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(want_h), atol=CHUNKED_TOL,
                                   rtol=CHUNKED_TOL)
    assert tops.pick_chunk(S, chunk) == {(128, 64): 64, (100, 64): 4, (96, 64): 32,
                                         (100, 128): 100}[S, chunk]


def test_in_place_bc_matches_the_broadcast_form():
    """B/C given once per batch row (G < BH) equal the reference wrapper's
    broadcast to [BH, S, N]; the model layout equals the reference layout
    on transposed inputs."""
    B, H, S, P, N = 2, 3, 64, 16, 8
    x, dt, A, Bm, Cm = _inputs(B * H, S, P, N, 5, G=B)
    t = torch.from_numpy
    y_g, h_g = tk.ssd_scan(*map(t, (x, dt, A, Bm, Cm)), chunk=32)
    rep = lambda a: np.repeat(a, H, axis=0)  # noqa: E731
    y_b, h_b = tk.ssd_scan(*map(t, (x, dt, A, rep(Bm), rep(Cm))), chunk=32)
    assert torch.equal(y_g, y_b) and torch.equal(h_g, h_b)
    A_h = A[:H]  # the model layout has one A per head
    y_bh, h_bh = tk.ssd_scan(*map(t, (x, dt, np.tile(A_h, B), Bm, Cm)), chunk=32)
    y_m, h_m = tk.ssd_scan_heads(
        t(x.reshape(B, H, S, P).transpose(0, 2, 1, 3).copy()),
        t(dt.reshape(B, H, S).transpose(0, 2, 1).copy()), t(A_h), t(Bm), t(Cm), chunk=32)
    np.testing.assert_allclose(y_m.permute(0, 2, 1, 3).reshape(B * H, S, P).numpy(),
                               y_bh.numpy(), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(h_m.reshape(B * H, N, P).numpy(), h_bh.numpy(),
                               atol=1e-6, rtol=1e-6)


def test_row_relative_error():
    want = torch.tensor([[1.0, -4.0], [0.0, 0.0], [0.0, 0.0]])
    got = torch.tensor([[1.5, -4.0], [0.0, 0.0], [0.0, 1e-3]])
    assert tref.row_relative_error(got, want).tolist() == [0.125, 0.0, float("inf")]


@pytest.mark.parametrize("case", ["x_f16", "dt_bf16", "noncontiguous", "chunk", "wide_p",
                                  "wide_n", "groups", "shape"])
def test_wrapper_refuses_bad_inputs(case):
    x, dt, A, Bm, Cm = map(torch.from_numpy, _inputs(4, 64, 16, 8, 0))
    kw = {"chunk": 32}
    if case == "x_f16":
        x = x.half()
    elif case == "dt_bf16":
        dt = dt.bfloat16()
    elif case == "noncontiguous":
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "chunk":
        kw["chunk"] = 24  # does not divide 64
    elif case == "wide_p":
        x = torch.zeros(4, 64, 80)
    elif case == "wide_n":
        Bm, Cm = torch.zeros(4, 64, 160), torch.zeros(4, 64, 160)
    elif case == "groups":
        Bm, Cm = Bm[:3].contiguous(), Cm[:3].contiguous()  # 3 does not divide 4
    else:
        dt = dt[:, :32].contiguous()
    tk.reset_launches()
    with pytest.raises(ValueError):
        tk.ssd_scan(x, dt, A, Bm, Cm, **kw)
    assert tk.launch_counts()["ssd_scan"] == 0


# the kernel's decomposition (ref.ssd_chunk_parallel: C·Bᵀ per (group,
# chunk), the intra-chunk pass, the carry pass, the inter-chunk output)


def _chunk_parallel_heads(x, dt, A, Bm, Cm, *, chunk):
    """``ref.ssd_chunk_parallel`` in the model layout (x [B, S, H, P], B/C
    [B, S, N] as G = B groups), so that ``ref.without_carry`` can take it."""
    B, S, H, P = x.shape
    y, h = tref.ssd_chunk_parallel(x.permute(0, 2, 1, 3).reshape(B * H, S, P),
                                   dt.permute(0, 2, 1).reshape(B * H, S), A.repeat(B), Bm, Cm,
                                   chunk=chunk)
    return y.reshape(B, H, S, P).permute(0, 2, 1, 3), h.reshape(B, H, *h.shape[1:])


@pytest.mark.parametrize("decays", ["fast", "mamba2"])
@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("BH,G,S,P,N,chunk", [
    (2, 2, 128, 32, 16, 64), (8, 2, 256, 16, 8, 64), (4, 1, 192, 20, 12, 32),
    (4, 4, 100, 16, 8, 4),
])
def test_chunk_parallel_matches_pallas_kernel_oracle_and_chunked(BH, G, S, P, N, chunk, dtype,
                                                                 decays):
    """The chunk-parallel form against the Pallas kernel (interpret, B/C
    broadcast to [BH, S, N]) and the sequential oracle at the tolerances of
    tests/test_kernels.py, and against the port's chunked form; under the
    fast decays of tests/test_kernels.py and under Mamba2's own."""
    make = _mamba2_inputs if decays == "mamba2" else _inputs
    x, dt, A, Bm, Cm = make(BH, S, P, N, S + P + G)
    Bm, Cm = Bm[::BH // G].copy(), Cm[::BH // G].copy()  # one row per group
    if dtype == "bfloat16":
        x, dt, Bm, Cm = map(_bf16, (x, dt, Bm, Cm))
    t = torch.from_numpy
    y, h = tref.ssd_chunk_parallel(t(x).to(getattr(torch, dtype)), *map(t, (dt, A, Bm, Cm)),
                                   chunk=chunk)
    assert y.dtype == h.dtype == torch.float32
    assert y.shape == (BH, S, P) and h.shape == (BH, N, P)
    rep = lambda a: np.repeat(a, BH // G, axis=0)  # noqa: E731
    jdt = getattr(jnp, dtype)
    jx, jdt_, jB, jC = (jnp.asarray(a).astype(jdt) for a in (x, dt, rep(Bm), rep(Cm)))
    ky, kh = jssd(jx, jdt_, jnp.asarray(A), jB, jC, chunk=chunk, interpret=True)
    oy, oh = jref.ssd_ref(*(jnp.asarray(a) for a in (x, dt, A, rep(Bm), rep(Cm))))
    tol = TOL[dtype]
    for got, want in ((y, ky), (y, oy), (h, kh), (h, oh)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=tol)
    cy, ch = tref.ssd_chunked_ref(t(x).to(getattr(torch, dtype)), *map(t, (dt, A, Bm, Cm)),
                                  chunk=chunk)
    np.testing.assert_allclose(y.numpy(), cy.numpy(), atol=CHUNKED_TOL, rtol=CHUNKED_TOL)
    np.testing.assert_allclose(h.numpy(), ch.numpy(), atol=CHUNKED_TOL, rtol=CHUNKED_TOL)


@pytest.mark.parametrize("S,chunk", [(128, 64), (100, 64), (160, 128), (512, 128)])
def test_chunk_parallel_matches_model_ssd_chunked_and_misses_without_carry(ref, S, chunk):
    """In the model layout, under Mamba2's decays: the chunk-parallel form
    against the reference's ``ssd_chunked`` and the port's
    ``ssd_chunked_heads`` at 1e-3; the same form with each chunk started
    from a zero state (``ref.without_carry``) misses by more than twice
    that wherever the sequence has more than one chunk."""
    B, H, P, N = 2, 3, 16, 8
    x, _, _, Bm, Cm = _model_inputs(B, S, H, P, N, 7 + S)
    gen = torch.Generator().manual_seed(S)
    A_log, dt_bias = (a.numpy() for a in tref.mamba2_decays(H, gen))
    z = np.random.RandomState(S).randn(B, S, H).astype(np.float32)
    dt = np.log1p(np.exp(z + dt_bias)).astype(np.float32)
    A = (-np.exp(A_log)).astype(np.float32)
    arrs = (x, dt, A, Bm, Cm)
    Q = tops.pick_chunk(S, chunk)
    t = [torch.from_numpy(a) for a in arrs]
    y, h = _chunk_parallel_heads(*t, chunk=Q)
    want_y, want_h = ref.ssm.ssd_chunked(*map(jnp.asarray, arrs), chunk=chunk)
    hy, hh = tref.ssd_chunked_heads(*t, chunk=Q)
    for got, want in ((y, want_y), (h, want_h), (y, hy), (h, hh)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=CHUNKED_TOL,
                                   rtol=CHUNKED_TOL)
    y_nc, _ = tref.without_carry(_chunk_parallel_heads, *t, chunk=Q)
    miss = np.abs(y_nc.numpy() - np.asarray(want_y))
    assert (miss / (CHUNKED_TOL + CHUNKED_TOL * np.abs(np.asarray(want_y)))).max() > 2
