"""Flash attention in the model's [B, S, H, D] layout.

``q_offset`` is an explicit int: query positions are ``q_offset +
arange(Sq)`` and key positions ``arange(Sk)``. (The JAX wrapper derived it
from ``q_pos[0]`` and silently used 0 when ``q_pos`` was traced.) k and v
may have fewer heads than q (GQA): the kernel reads kv head ``h // (Hq /
Hkv)`` without repeating it in memory, and reads q, k and v and writes o
in this layout in place (``kernel.flash_attention_heads``): no transposes.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention.kernel import (flash_attention_bwd_heads,
                                                       flash_attention_heads)


def flash_attention(q, k, v, *, q_offset: int = 0, causal: bool = True,
                    window: int = 0, return_lse: bool = False):
    """q [B, Sq, Hq, D]; k, v [B, Sk, Hkv, D] with Hkv dividing Hq ->
    [B, Sq, Hq, D] (and the lse f32 [B, Hq, Sq] with ``return_lse``)."""
    return flash_attention_heads(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset, return_lse=return_lse)


def flash_attention_bwd(q, k, v, o, dout, lse, *, q_offset: int = 0, causal: bool = True,
                        window: int = 0):
    """The backward (K4b) in the same layout: (dq, dk, dv), dk and dv summed
    over each kv head's group."""
    return flash_attention_bwd_heads(q, k, v, o, dout, lse, causal=causal, window=window,
                                     q_offset=q_offset)
