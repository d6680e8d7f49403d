"""Unified model configuration for all assigned architecture families."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    # positional / attention details
    rope: str = "neox"  # neox | partial | none | sincos_learned
    rope_theta: float = 1e4
    rope_frac: float = 1.0  # fraction of head dims rotated (chatglm: 0.5)
    qk_norm: bool = False  # qwen3-style per-head RMSNorm on q,k
    attn_window: int = 0  # >0 → sliding-window attention (hymba)
    # mlp
    act: str = "swiglu"  # swiglu | gelu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_dff: int = 0
    n_shared: int = 0  # shared (always-on) experts, moonlight-style
    first_k_dense: int = 0  # leading dense layers before MoE layers
    capacity_factor: float = 1.25
    router: str = "topk"  # topk | ppot  (ppot = Rosella two-choice routing)
    router_noise: float = 0.0
    # SSM (mamba2 SSD)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    d_conv: int = 4
    ssm_chunk: int = 128
    # enc-dec (whisper)
    n_enc_layers: int = 0
    enc_len: int = 0  # encoder frames provided by the (stub) frontend
    # vlm (pixtral)
    n_patches: int = 0  # stub patch embeddings occupying the seq prefix
    # numerics / runtime
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    remat: str = "full"  # none | full | dots
    scan_layers: bool = True
    use_pallas: bool = False
    attn_chunk: int = 512  # q/kv chunking for memory-bounded attention
    loss_chunk: int = 512  # sequence chunking for the CE loss
    max_cache_len: int = 0  # decode KV-cache capacity (0 → seq dependent)
    kv_quant: bool = False  # int8 KV cache (per-position-per-head scales)

    @property
    def d_qkv(self) -> int:
        return self.n_heads * self.d_head

    @property
    def d_kv(self) -> int:
        return self.n_kv_heads * self.d_head

    @property
    def d_inner(self) -> int:  # SSM inner width
        return self.ssm_expand * self.d_model

    def num_params(self) -> int:
        """Approximate parameter count (used for MODEL_FLOPS = 6·N·D)."""
        d, L, V = self.d_model, self.n_layers, self.vocab
        emb = V * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family in ("dense", "moe", "vlm", "hybrid"):
            attn = d * self.d_qkv + 2 * d * self.d_kv + self.d_qkv * d
            per_layer += attn + 2 * d  # norms
        if self.family in ("dense", "vlm"):
            per_layer += 3 * d * self.d_ff
        if self.family == "moe":
            moe = self.n_experts * 3 * d * self.moe_dff + d * self.n_experts
            moe += self.n_shared * 3 * d * self.moe_dff
            dense_ff = 3 * d * self.d_ff if self.d_ff else 3 * d * self.moe_dff
            per_layer += moe
            # first_k_dense layers replace MoE with a dense FF
            total = (L - self.first_k_dense) * (per_layer) + self.first_k_dense * (
                attn + 2 * d + dense_ff
            )
            return emb + total + 2 * d
        if self.family in ("ssm",):
            di, N, H = self.d_inner, self.ssm_state, self.n_ssm_heads
            per_layer += d * (2 * di + 2 * N + H) + di * d + 2 * d
        if self.family == "hybrid":
            di, N, H = self.d_inner, self.ssm_state, self.n_ssm_heads
            per_layer += d * (2 * di + 2 * N + H) + di * d
            per_layer += 3 * d * self.d_ff
        if self.family == "encdec":
            attn = d * self.d_qkv + 2 * d * self.d_kv + self.d_qkv * d
            ff = 2 * d * self.d_ff
            enc = self.n_enc_layers * (attn + ff + 4 * d)
            dec = L * (2 * attn + ff + 6 * d)
            return emb + enc + dec + 2 * d
        return emb + L * per_layer + 2 * d

    @property
    def n_ssm_heads(self) -> int:
        if self.ssm_heads:
            return self.ssm_heads
        return max(self.d_inner // self.ssm_headdim, 1)

    def active_params(self) -> int:
        """Active parameters per token (MoE: only top-k + shared experts)."""
        if self.family != "moe":
            return self.num_params()
        d, L = self.d_model, self.n_layers
        full = self.num_params()
        routed_all = (L - self.first_k_dense) * self.n_experts * 3 * d * self.moe_dff
        routed_active = (L - self.first_k_dense) * self.top_k * 3 * d * self.moe_dff
        return full - routed_all + routed_active
