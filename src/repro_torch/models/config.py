"""Unified model configuration for the 10 assigned architectures."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    vocab: int

    # -- attention ------------------------------------------------------
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    rope_theta: float = 10_000.0
    qk_norm: bool = False  # gemma3
    attn_logit_softcap: Optional[float] = None  # gemma2
    final_logit_softcap: Optional[float] = None  # gemma2
    # sliding window: layers with (i % local_period) < local_count are local.
    sliding_window: Optional[int] = None
    local_period: int = 1
    local_count: int = 0  # 0 => all layers global (full attention)
    post_norm: bool = False  # gemma sandwich norms

    # -- mlp --------------------------------------------------------------
    d_ff: int = 0
    mlp_gated: bool = True
    activation: str = "silu"  # silu | gelu

    # -- MoE ---------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    n_shared_experts: int = 0  # llama4 shared expert
    moe_group_size: int = 4096  # dispatch group size (memory knob)

    # -- SSM (Mamba-2) ------------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    # hybrid (zamba2): a shared attention block every `hybrid_period` layers.
    hybrid_period: int = 0

    # -- enc-dec -------------------------------------------------------------
    n_enc_layers: int = 0  # 0 => decoder-only
    enc_len: int = 0  # stub frontend memory length for decode shapes

    # -- misc -----------------------------------------------------------------
    tie_embeddings: bool = True
    emb_scale_by_sqrt_dim: bool = False  # gemma
    dtype: str = "bfloat16"
    # attention impl: "auto" picks chunked for long seq, naive for short.
    attn_impl: str = "auto"
    # Activation sharding policy: "none" (single-device tests) | "tp" |
    # "fsdp" — see models/sharding.py.  Set by the launcher/dry-run.
    sharding_policy: str = "none"
    attn_q_chunk: int = 256
    loss_seq_chunks: int = 8  # chunked-vocab loss (memory knob)

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode: SSM/hybrid by construction; sliding-window
        archs have bounded local KV reads + O(S) global reads."""
        return self.family in ("ssm", "hybrid") or self.local_count > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def is_local_layer(self, i: int) -> bool:
        if self.local_count == 0 or self.sliding_window is None:
            return False
        return (i % self.local_period) < self.local_count

    def local_flags(self) -> Tuple[bool, ...]:
        return tuple(self.is_local_layer(i) for i in range(self.n_layers))

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # -- parameter counting (for roofline MODEL_FLOPS = 6*N*D) -------------
    def param_count(self, active_only: bool = False) -> int:
        D, F, H, K, hd = self.d_model, self.d_ff, self.n_heads, self.n_kv_heads, self.head_dim
        emb = self.vocab * D * (1 if self.tie_embeddings else 2)

        def attn_params() -> int:
            return D * H * hd + 2 * D * K * hd + H * hd * D

        def mlp_params(dff: int) -> int:
            return (3 if self.mlp_gated else 2) * D * dff

        def moe_params() -> int:
            e = self.top_k if active_only else self.n_experts
            shared = self.n_shared_experts
            return D * self.n_experts + (e + shared) * mlp_params(F) // 1

        def ssm_params() -> int:
            di, N, nh = self.d_inner, self.ssm_state, self.n_ssm_heads
            in_proj = D * (2 * di + 2 * N + nh)
            conv = self.ssm_conv_width * (di + 2 * N)
            out = di * D
            return in_proj + conv + out + 2 * nh + di

        total = emb
        if self.family == "ssm":
            total += self.n_layers * ssm_params()
        elif self.family == "hybrid":
            total += self.n_layers * ssm_params()
            n_shared_blocks = 1  # zamba2: ONE shared attention+MLP block
            total += n_shared_blocks * (attn_params() + mlp_params(F))
        elif self.family == "moe":
            total += self.n_layers * (attn_params() + moe_params())
        elif self.family == "encdec":
            enc = self.n_enc_layers * (attn_params() + mlp_params(F))
            dec = self.n_layers * (2 * attn_params() + mlp_params(F))
            total += enc + dec
        else:  # dense / vlm backbone
            total += self.n_layers * (attn_params() + mlp_params(F))
        return total
