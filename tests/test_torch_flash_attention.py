"""The port's flash-attention forward (plain version on the CPU, and the
[B, S, H, D] entry point ``ops.flash_attention``) against the JAX package's
Pallas kernel in interpret mode and its materialised oracle ``ref``.

Inputs come from numpy with a seed. Tolerances are those of
``tests/test_kernels.py``: 2e-5 in float32 (reduction order and exp
differ between XLA and torch), 2e-2 in bfloat16 (p and the output are
rounded to bf16 at other points: the kernel's p is unnormalised, the
oracle's normalised)."""
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
