"""The attention gradient of the port against the JAX package's custom VJP
(``flash_attention_xla``, ``_flash_bwd``) through ``jax.vjp``, in f32 at
the reference's bar 2e-5 (atol = rtol): the plain pair that the CPU runs
(``layers.FlashAttention``: ``flash_attention_plain`` with its lse,
``flash_attention_plain_bwd``) and the kernels' plain versions (K4 with
its lse, K4b: ``kernels/flash_attention/ref.py``), over causal, windowed,
GQA, non-causal cross (Sq != Sk) with ragged chunks, and rows with no
valid key (dq 0 there, nothing added to dk / dv, no NaN). The reference
repeats kv heads outside its VJP, so its dk / dv are summed over each
group; so are the port's."""
import torch_threads  # noqa: F401  (one torch thread a test worker)
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.models import layers as TL
from test_torch_model import reference_shim

TOL = 2e-5
#: (B, Sq, Sk, Hq, Hkv, D, causal, window, chunk, q_offset)
CASES = {
    "causal gqa": (2, 64, 64, 4, 2, 32, True, 0, 16, 0),
    "window": (1, 96, 96, 3, 1, 32, True, 20, 32, 0),
    "cross ragged": (1, 48, 80, 2, 2, 64, False, 0, 32, 0),
    "empty rows": (1, 64, 64, 2, 1, 32, True, 0, 16, -16),
    "d128 mha": (1, 32, 32, 2, 2, 128, True, 0, 32, 0),
}


@pytest.fixture(scope="module")
def ref():
    with reference_shim():
        import jax
        import jax.numpy as jnp

        from repro.models import layers

        yield types.SimpleNamespace(jax=jax, jnp=jnp, layers=layers)


def _inputs(case, seed=0):
    B, Sq, Sk, H, Hkv, D = case[:6]
    rs = np.random.RandomState(seed)
    f = lambda *s: rs.randn(*s).astype(np.float32)  # noqa: E731
    return f(B, Sq, H, D), f(B, Sk, Hkv, D), f(B, Sk, Hkv, D), f(B, Sq, H, D)


def _reference(ref, case, q, k, v, do):
    B, Sq, Sk, H, Hkv, D, causal, window, chunk, qoff = case
    L, jnp = ref.layers, ref.jnp

    def f(q, k, v):
        return L.flash_attention_xla(q, L._repeat_kv(k, H // Hkv), L._repeat_kv(v, H // Hkv),
                                     qoff + jnp.arange(Sq), jnp.arange(Sk), causal, window,
                                     chunk)

    o, vjp = ref.jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(a) for a in (o, *vjp(jnp.asarray(do)))]


@pytest.mark.parametrize("name", list(CASES))
def test_plain_pair_against_the_reference_vjp(ref, name):
    case = CASES[name]
    q, k, v, do = _inputs(case)
    want = _reference(ref, case, q, k, v, do)
    _, _, _, _, _, _, causal, window, chunk, qoff = case
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = TL.FlashAttention.apply(tq, tk, tv, qoff, causal, window, chunk)
    o.backward(torch.from_numpy(do))
    for got, w in zip((o, tq.grad, tk.grad, tv.grad), want):
        got = got.detach().numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, w, rtol=TOL, atol=TOL)
    if qoff < 0:  # rows before position 0 see no key: dq 0 there
        assert (tq.grad[:, :-qoff] == 0).all()


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_plain_versions_against_the_reference_vjp(ref, name):
    """K4's plain version with its lse and K4b's plain version, the
    functions the kernels are held to on the card."""
    case = CASES[name]
    q, k, v, do = _inputs(case, seed=1)
    want = _reference(ref, case, q, k, v, do)
    _, _, _, _, _, _, causal, window, _, qoff = case
    kw = dict(causal=causal, window=window, q_offset=qoff)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = FK.flash_attention_heads(tq, tk, tv, return_lse=True, **kw)
    assert torch.equal(o, FK.flash_attention_heads(tq, tk, tv, **kw))
    o_plain, lse_plain = TL.flash_attention_plain(tq, tk, tv, chunk=case[8], return_lse=True,
                                                  **kw)
    np.testing.assert_allclose(lse.numpy(), lse_plain.numpy(), rtol=TOL, atol=TOL)
    assert torch.isfinite(lse).all()
    grads = FK.flash_attention_bwd_heads(tq, tk, tv, o, tdo, lse, **kw)
    for got, w in zip((o, *grads), want):
        np.testing.assert_allclose(got.numpy(), w, rtol=TOL, atol=TOL)


def test_chunked_attention_takes_the_vjp_only_for_gradients():
    cfg = types.SimpleNamespace(attn_chunk=16)
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(CASES["causal gqa"]))
    with torch.no_grad():
        plain = TL.chunked_attention(cfg, q, k, v)
    assert plain.grad_fn is None
    qg = q.clone().requires_grad_()
    out = TL.chunked_attention(cfg, qg, k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    assert torch.equal(out.detach(), plain)
