"""Flash attention in the model's [B, S, H, D] layout.

``q_offset`` is an explicit int: query positions are ``q_offset +
arange(Sq)`` and key positions ``arange(Sk)``. (The JAX wrapper derived it
from ``q_pos[0]`` and silently used 0 when ``q_pos`` was traced.) k and v
may have fewer heads than q (GQA): the kernel reads kv head ``h // (Hq /
Hkv)`` without repeating it in memory.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd


def flash_attention(q, k, v, *, q_offset: int = 0, causal: bool = True,
                    window: int = 0):
    """q [B, Sq, Hq, D]; k, v [B, Sk, Hkv, D] with Hkv dividing Hq ->
    [B, Sq, Hq, D]."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D or H % Hkv:
        raise ValueError(f"q {list(q.shape)}, k {list(k.shape)}, v {list(v.shape)}: "
                         f"expected k = v = [B, Sk, Hkv, D] with Hkv dividing Hq")
    qr = q.transpose(1, 2).reshape(B * H, Sq, D).contiguous()
    kr = k.transpose(1, 2).reshape(B * Hkv, Sk, D).contiguous()
    vr = v.transpose(1, 2).reshape(B * Hkv, Sk, D).contiguous()
    o = flash_attention_fwd(qr, kr, vr, causal=causal, window=window,
                            q_offset=q_offset)
    return o.reshape(B, H, Sq, D).transpose(1, 2)
