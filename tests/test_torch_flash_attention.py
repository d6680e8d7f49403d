"""The port's flash-attention forward (plain version on the CPU, and the
[B, S, H, D] entry point ``ops.flash_attention``) against the JAX package's
Pallas kernel in interpret mode and its materialised oracle ``ref``.

Inputs come from numpy with a seed. Tolerances are those of
``tests/test_kernels.py``: 2e-5 in float32 (reduction order and exp
differ between XLA and torch), 2e-2 in bfloat16 (p and the output are
rounded to bf16 at other points: the kernel's p is unnormalised, the
oracle's normalised)."""
import torch_threads  # noqa: F401  (one torch thread a test worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jops
from repro.kernels.flash_attention import ref as jref
from repro.kernels.flash_attention.kernel import flash_attention_fwd as jfa
from repro_torch.kernels.flash_attention import kernel as tk
from repro_torch.kernels.flash_attention import ops as tops
from repro_torch.kernels.flash_attention import ref as tref
from repro_torch.models import layers as L

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(shapes, dtype, seed):
    rng = np.random.RandomState(seed)
    arrs = [(rng.randn(*s) * 0.5).astype(np.float32) for s in shapes]
    jdt, tdt, tol = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs], tol)


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize(
    "BH,Sq,Sk,D,causal,window",
    [
        (2, 128, 128, 64, True, 0),
        (2, 256, 256, 64, True, 64),
        (1, 128, 384, 128, False, 0),
        (3, 384, 384, 32, True, 0),
    ],
)
def test_plain_version_matches_pallas_kernel_and_oracle(BH, Sq, Sk, D, causal, window,
                                                        dtype):
    (jq, jk, jv), (q, k, v), tol = _inputs(
        [(BH, Sq, D), (BH, Sk, D), (BH, Sk, D)], dtype, Sq + Sk + D)
    tk.reset_launches()
    got = tk.flash_attention_fwd(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype and got.shape == (BH, Sq, D)
    assert tk.launch_counts()["flash_attention_fwd"] == 0  # CPU: no launch
    kern = jfa(jq, jk, jv, causal=causal, window=window, bq=128, bk=128,
               interpret=True)
    oracle = jref.attention_ref(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(_np(got), _np(kern), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(got), _np(oracle), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_offset(dtype):
    """q_offset: 128 query rows at positions 128..255 over 256 keys."""
    (jq, jk, jv), (q, k, v), tol = _inputs(
        [(2, 128, 64), (2, 256, 64), (2, 256, 64)], dtype, 9)
    got = tk.flash_attention_fwd(q, k, v, causal=True, q_offset=128)
    kern = jfa(jq, jk, jv, causal=True, q_offset=128, interpret=True)
    oracle = jref.attention_ref(jq, jk, jv, causal=True, q_offset=128)
    np.testing.assert_allclose(_np(got), _np(kern), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(got), _np(oracle), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_window_rows_with_no_valid_key_are_zero(dtype):
    """Window 16 at offset 200 over 256 keys: rows at positions >= 271 see
    no key and must be exactly 0, the others match the reference."""
    (jq, jk, jv), (q, k, v), tol = _inputs(
        [(2, 128, 64), (2, 256, 64), (2, 256, 64)], dtype, 11)
    got = tk.flash_attention_fwd(q, k, v, causal=True, window=16, q_offset=200)
    kern = jfa(jq, jk, jv, causal=True, window=16, q_offset=200, interpret=True)
    oracle = jref.attention_ref(jq, jk, jv, causal=True, window=16, q_offset=200)
    empty = 200 + np.arange(128) >= 256 + 16 - 1
    assert empty.sum() == 57
    assert (_np(got)[:, empty] == 0).all()
    np.testing.assert_allclose(_np(got), _np(kern), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(got), _np(oracle), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("q_offset", [0, 64])
def test_ops_gqa_matches_reference_on_repeated_heads(dtype, q_offset):
    """``ops.flash_attention`` with 2 kv heads for 6 q heads equals the JAX
    wrapper given the kv heads repeated (q head h reads kv head h // 3)."""
    B, Sq, Sk, H, Hkv, D = 2, 64, 128, 6, 2, 32
    (jq, jk, jv), (q, k, v), tol = _inputs(
        [(B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D)], dtype, 5 + q_offset)
    got = tops.flash_attention(q, k, v, q_offset=q_offset, causal=True)
    rep = lambda x: jnp.repeat(x, H // Hkv, axis=2)  # noqa: E731
    want = jops.flash_attention(jq, rep(jk), rep(jv),
                                q_pos=jnp.arange(Sq) + q_offset, causal=True,
                                interpret=True)
    assert got.shape == (B, Sq, H, D)
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def test_plain_version_reads_kv_row_bh_over_group():
    """k/v with BH / g rows give what the repeated rows give."""
    rng = np.random.RandomState(3)
    q = torch.from_numpy(rng.randn(6, 40, 32).astype(np.float32))
    k, v = (torch.from_numpy(rng.randn(2, 40, 32).astype(np.float32)) for _ in range(2))
    got = tk.flash_attention_fwd(q, k, v, causal=True)
    want = tref.attention_ref(q, k.repeat_interleave(3, 0), v.repeat_interleave(3, 0))
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", ["dtype", "mixed_dtype", "noncontiguous", "head_dim",
                                  "head_dim_16", "group", "offset_type", "window"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    q = torch.zeros(4, 16, 64)
    k = torch.zeros(4, 16, 64)
    v = torch.zeros(4, 16, 64)
    kw = {}
    if case == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif case == "mixed_dtype":
        k = k.bfloat16()
    elif case == "noncontiguous":
        q = torch.zeros(4, 64, 16).transpose(1, 2)
    elif case == "head_dim":
        q, k, v = (torch.zeros(4, 16, 48) for _ in range(3))
    elif case == "head_dim_16":  # not a head dim of the reference kernel
        q, k, v = (torch.zeros(4, 16, 16) for _ in range(3))
    elif case == "group":
        k, v = torch.zeros(3, 16, 64), torch.zeros(3, 16, 64)
    elif case == "offset_type":
        kw["q_offset"] = torch.tensor(3)
    elif case == "window":
        kw["window"] = -1
    with pytest.raises(ValueError):
        tk.flash_attention_fwd(q, k, v, **kw)


@pytest.mark.parametrize("case", ["rounding", "dropped_tile", "empty_rows"])
def test_row_relative_error_holds_the_late_rows(case):
    """The per-row bound the card's checks add to the elementwise one: at
    the prefill's sequence length (S=4096, bf16, causal) the late rows'
    outputs are ~0.01, below test_kernels.py's atol of 2e-2. Rounding in
    the kernel's order (online softmax over 64-key tiles) stays near one
    bf16 ulp of each row; a kv tile wrongly skipped for the last 600 rows
    passes the elementwise tolerance but not the row bound."""
    if case == "empty_rows":
        want = torch.zeros(2, 3, 8)
        got = want.clone()
        assert (tref.row_relative_error(got, want) == 0).all()
        got[1, 2, 5] = 1e-6
        row = tref.row_relative_error(got, want)
        assert row[1, 2] == float("inf") and (row.flatten()[:-1] == 0).all()
        return
    BH, S, D, tile, late = 2, 4096, 64, 64, 600
    (_, (q, k, v), tol) = _inputs([(BH, S, D)] * 3, "bfloat16", 11)
    want = tref.attention_ref(q, k, v, causal=True)
    if case == "rounding":
        got = L.flash_attention_plain(q[None].transpose(1, 2), k[None].transpose(1, 2),
                                      v[None].transpose(1, 2), causal=True, chunk=tile)
        got = got[0].transpose(0, 1)
    else:  # the first kv tile left out for rows S - late ...
        R = S - late
        got = want.clone()
        got[:, R:] = tref.attention_ref(q[:, R:].contiguous(), k[:, tile:].contiguous(),
                                        v[:, tile:].contiguous(), causal=True,
                                        q_offset=R - tile)
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
    row = tref.row_relative_error(got, want)
    if case == "rounding":
        assert row.max().item() <= 2 ** -7  # one bf16 ulp of the row's largest value
    else:
        assert row[:, S - late:].min().item() > 2e-2  # the card's bf16 row bound
        assert (row[:, :S - late] == 0).all()


# the kernel's tile plan (ref.tile_plan, the rule of csrc/flash_attention.cu)
TILE_CASES = [
    (300, 300, True, 0, 0), (128, 256, True, 0, 128), (128, 256, True, 16, 200),
    (1000, 1000, True, 200, 0), (77, 1000, False, 0, 0), (256, 1024, True, 300, 768),
    (130, 190, True, 0, 60), (500, 500, False, 100, 0), (4096, 4096, True, 1024, 0),
    (64, 64, True, 0, 0), (50, 40, True, 0, 100),
]


@pytest.mark.parametrize("BK", sorted(set(tk.BLOCK_K.values())))
@pytest.mark.parametrize("Sq,Sk,causal,window,q_offset", TILE_CASES)
def test_tile_plan_visits_every_valid_pair_and_masks_only_edge_tiles(Sq, Sk, causal, window,
                                                                     q_offset, BK):
    """Against the dense mask: every valid (q, k) pair lies in a visited
    tile, no skipped tile holds one, and a tile without the mask is wholly
    valid (so the kernel's interior tiles need no position test)."""
    BQ = tk.BLOCK_Q
    ok = tref.valid_mask(Sq, Sk, causal=causal, window=window, q_offset=q_offset)
    plan = tref.tile_plan(Sq, Sk, BQ, BK, causal=causal, window=window, q_offset=q_offset)
    assert len(plan) == -(-Sq // BQ)
    n_kt = -(-Sk // BK)
    for i, tiles in enumerate(plan):
        rows = slice(i * BQ, min(i * BQ + BQ, Sq))
        visited = [kt for kt, _ in tiles]
        assert visited == list(range(visited[0], visited[0] + len(visited))) if tiles else True
        for kt in range(n_kt):
            block = ok[rows, kt * BK:min(kt * BK + BK, Sk)]
            if kt not in visited:
                assert not block.any(), f"q tile {i}: skipped kv tile {kt} holds a valid pair"
        for kt, mask in tiles:
            assert 0 <= kt < n_kt
            if not mask:
                assert kt * BK + BK <= Sk and ok[rows, kt * BK:kt * BK + BK].all(), \
                    f"q tile {i}: kv tile {kt} has no mask but holds an invalid pair"
    # the edge tiles exist where they should: a causal plan masks its diagonal
    if causal and q_offset == 0 and Sq == Sk:
        assert all(tiles[-1][1] for tiles in plan)


def _heads_inputs(B, Sq, Sk, H, Hkv, D, dtype, seed, strided):
    """q [B, Sq, H, D], k/v [B, Sk, Hkv, D]; with ``strided`` q, k and v are
    views of one fused [B, S, H + 2 Hkv, D] tensor (Sq = Sk)."""
    rng = np.random.RandomState(seed)
    jdt, tdt, tol = DTYPES[dtype]
    if strided:
        fused = torch.from_numpy((rng.randn(B, Sq, H + 2 * Hkv, D) * 0.5).astype(np.float32))
        fused = fused.to(tdt)
        q, k, v = fused[:, :, :H], fused[:, :, H:H + Hkv], fused[:, :, H + Hkv:]
    else:
        q, k, v = (torch.from_numpy((rng.randn(*s) * 0.5).astype(np.float32)).to(tdt)
                   for s in ((B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D)))
    return q, k, v, jdt, tol


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,window,q_offset,strided", [
    (2, 128, 128, 6, 2, 64, 0, 0, False),
    (1, 200, 333, 4, 4, 128, 0, 133, False),
    (2, 130, 190, 3, 1, 32, 50, 60, False),
    (1, 300, 300, 8, 2, 32, 50, 0, True),
])
def test_heads_entry_matches_transposing_path_and_pallas_kernel(B, Sq, Sk, H, Hkv, D, window,
                                                                q_offset, strided, dtype):
    """``flash_attention_heads`` (what ``ops.flash_attention`` now calls)
    on [B, S, H, D] equals the transposing path the model took before (q,
    k, v copied to [BH, S, D], the reference-layout entry, o transposed
    back) and the JAX Pallas kernel in interpret mode on the kv heads
    repeated."""
    q, k, v, jdt, tol = _heads_inputs(B, Sq, Sk, H, Hkv, D, dtype, Sq + D, strided)
    kw = dict(causal=True, window=window, q_offset=q_offset)
    tk.reset_launches()
    got = tk.flash_attention_heads(q, k, v, **kw)
    assert tk.launch_counts()["flash_attention_fwd"] == 0  # CPU: no launch
    assert got.shape == (B, Sq, H, D) and got.dtype == q.dtype
    assert torch.equal(tops.flash_attention(q, k, v, **kw), got)
    flat = lambda t: t.transpose(1, 2).reshape(-1, t.shape[1], D).contiguous()  # noqa: E731
    before = tk.flash_attention_fwd(flat(q), flat(k), flat(v), **kw)
    assert torch.equal(before.reshape(B, H, Sq, D).transpose(1, 2), got)
    to_j = lambda t: jnp.asarray(_np(flat(t))).astype(jdt)  # noqa: E731
    rep = lambda t: to_j(t.repeat_interleave(H // Hkv, dim=2))  # noqa: E731
    kern = jfa(to_j(q), rep(k), rep(v), bq=64, bk=64, interpret=True, **kw)
    np.testing.assert_allclose(_np(flat(got)), _np(kern), atol=tol, rtol=tol)


@pytest.mark.parametrize("case", ["rank", "last_stride", "stride_8", "heads", "batch", "dtype"])
def test_heads_entry_refuses_what_the_kernel_does_not_take(case):
    q = torch.zeros(2, 16, 6, 32)
    k = torch.zeros(2, 16, 2, 32)
    v = torch.zeros(2, 16, 2, 32)
    if case == "rank":
        q = q[0]
    elif case == "last_stride":
        q = torch.zeros(2, 16, 32, 6).transpose(2, 3)
    elif case == "stride_8":  # rows 36 elements apart: not a TMA stride
        k = torch.zeros(2, 16, 2, 36)[..., :32]
    elif case == "heads":
        k, v = torch.zeros(2, 16, 4, 32), torch.zeros(2, 16, 4, 32)
    elif case == "batch":
        k, v = torch.zeros(1, 16, 2, 32), torch.zeros(1, 16, 2, 32)
    elif case == "dtype":
        q = q.half()
    with pytest.raises(ValueError):
        tk.flash_attention_heads(q, k, v)
