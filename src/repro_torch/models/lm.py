"""Decoder-only language model, dense and VLM families.

The port of ``repro.models.lm.LM``.  ``LM`` is an ``nn.Module`` whose
parameter names follow the JAX tree paths (``embed``, ``unembed``,
``final_norm``, ``blocks.ln1``, ``blocks.attn.wq``, ``blocks.mlp.w_in``, ...)
with the block weights stacked ``(L, ...)`` as in JAX, so weights bridge
key for key.  The layer loop is a Python ``for``, so whether a layer is
local (sliding window) is a static bool, which the kernels need.

The module is built on the meta device; ``init`` (random weights with the
reference's shapes and scales) materializes it on a device.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from .. import resolve_device, torch_dtype
from .config import ModelConfig
from .layers import (
    attn_apply,
    attn_decode_apply,
    attn_init,
    mlp_apply,
    mlp_init,
    rms_norm,
    softcap,
)

Tensor = torch.Tensor


def _params(shapes: Dict[str, tuple], dtype) -> nn.ParameterDict:
    return nn.ParameterDict(
        {k: nn.Parameter(torch.empty(s, dtype=dtype, device="meta"), requires_grad=False)
         for k, s in shapes.items()}
    )


class _Blocks(nn.Module):
    """The stacked (L, ...) weights of the attention blocks."""

    def __init__(self, cfg: ModelConfig, dtype):
        super().__init__()
        L, D, H, K, hd, Fd = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                              cfg.head_dim, cfg.d_ff)
        norms = {"ln1": (L, D), "ln2": (L, D)}
        if cfg.post_norm:
            norms.update(ln1_post=(L, D), ln2_post=(L, D))
        for name, p in _params(norms, dtype).items():
            self.register_parameter(name, p)
        attn = {"wq": (L, D, H, hd), "wk": (L, D, K, hd), "wv": (L, D, K, hd),
                "wo": (L, H, hd, D)}
        if cfg.qk_norm:
            attn.update(q_norm=(L, hd), k_norm=(L, hd))
        self.attn = _params(attn, dtype)
        mlp = {"w_in": (L, D, Fd), "w_out": (L, Fd, D)}
        if cfg.mlp_gated:
            mlp["w_gate"] = (L, D, Fd)
        self.mlp = _params(mlp, dtype)

    def layer(self, i: int) -> Dict[str, Any]:
        """Layer i's weights as the nested dict the layer functions take."""
        p: Dict[str, Any] = {n: w[i] for n, w in self.named_parameters(recurse=False)}
        p["attn"] = {n: w[i] for n, w in self.attn.items()}
        p["mlp"] = {n: w[i] for n, w in self.mlp.items()}
        return p


class LM(nn.Module):
    """Dense / VLM decoder for one config."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.family not in ("dense", "vlm"):
            raise ValueError(f"LM ports the dense and vlm families, not {cfg.family!r}")
        self.cfg = cfg
        dt = torch_dtype(cfg.dtype)
        shapes = {"embed": (cfg.vocab, cfg.d_model), "final_norm": (cfg.d_model,)}
        if not cfg.tie_embeddings:
            shapes["unembed"] = (cfg.d_model, cfg.vocab)
        for name, p in _params(shapes, dt).items():
            self.register_parameter(name, p)
        self.blocks = _Blocks(cfg, dt)

    # ------------------------------------------------------------------
    # Init
    # ------------------------------------------------------------------
    @torch.no_grad()
    def init(self, generator: torch.Generator, device="cuda", dtype=None) -> "LM":
        """Materializes the weights on ``device`` with the reference's shapes
        and scales: embed/unembed N(0,1)*0.02, attention N*D^-0.5, w_out
        N*F^-0.5, norms zeros.  The generator must live on ``device``."""
        dev = resolve_device(device)
        cfg = self.cfg
        dt = dtype or torch_dtype(cfg.dtype)
        self.to_empty(device=dev)
        if dt != self.embed.dtype:
            self.to(dt)
        for p in self.parameters():
            p.zero_()
        self.embed.copy_(torch.randn(self.embed.shape, generator=generator, device=dev) * 0.02)
        if not cfg.tie_embeddings:
            self.unembed.copy_(
                torch.randn(self.unembed.shape, generator=generator, device=dev) * 0.02
            )
        for i in range(cfg.n_layers):
            for group, fresh in (("attn", attn_init(cfg, generator, dt, dev)),
                                 ("mlp", mlp_init(cfg, generator, dt, dev))):
                stacked = getattr(self.blocks, group)
                for name, w in fresh.items():
                    stacked[name][i].copy_(w)
        return self

    # ------------------------------------------------------------------
    # Layer body
    # ------------------------------------------------------------------
    def _block_tail(self, p, x: Tensor, h: Tensor) -> Tensor:
        """Residual around attention output h, then the MLP half."""
        cfg = self.cfg
        if cfg.post_norm:
            h = rms_norm(h, p["ln1_post"])
        x = x + h
        h2 = mlp_apply(cfg, p["mlp"], rms_norm(x, p["ln2"]))
        if cfg.post_norm:
            h2 = rms_norm(h2, p["ln2_post"])
        return x + h2

    def _embed(self, tokens: Tensor) -> Tensor:
        x = self.embed[tokens]
        if self.cfg.emb_scale_by_sqrt_dim:
            x = x * torch.tensor(self.cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
        return x

    # ------------------------------------------------------------------
    # Forward: final hidden states
    # ------------------------------------------------------------------
    def hidden_states(self, tokens: Tensor) -> Tensor:
        cfg = self.cfg
        x = self._embed(tokens)
        for i in range(cfg.n_layers):
            p = self.blocks.layer(i)
            h = attn_apply(cfg, p["attn"], rms_norm(x, p["ln1"]), is_local=cfg.is_local_layer(i))
            x = self._block_tail(p, x, h)
        return rms_norm(x, self.final_norm)

    def logits(self, hidden: Tensor) -> Tensor:
        """Einsum in the param dtype, then f32 (and the final softcap)."""
        w = self.unembed if not self.cfg.tie_embeddings else self.embed.T
        out = torch.matmul(hidden, w).float()
        return softcap(out, self.cfg.final_logit_softcap)

    def apply(self, tokens: Tensor) -> Tensor:
        return self.logits(self.hidden_states(tokens))

    # ------------------------------------------------------------------
    # Prefill: full forward that also fills the decode caches
    # ------------------------------------------------------------------
    @torch.no_grad()
    def prefill(self, tokens: Tensor, max_len: Optional[int] = None):
        """Returns (last-position logits (B, 1, V), decode state); the KV
        caches are (L, B, max_len, K, hd), zero past the prompt."""
        cfg = self.cfg
        B, S = tokens.shape
        state = self.decode_init(B, max_len or S)
        ks, vs = state["kv"]
        x = self._embed(tokens)
        for i in range(cfg.n_layers):
            p = self.blocks.layer(i)
            h, (k, v) = attn_apply(
                cfg, p["attn"], rms_norm(x, p["ln1"]), is_local=cfg.is_local_layer(i),
                return_kv=True,
            )
            ks[i, :, :S] = k
            vs[i, :, :S] = v
            x = self._block_tail(p, x, h)
        state["pos"].fill_(S)
        hidden = rms_norm(x[:, -1:], self.final_norm)
        return self.logits(hidden), state

    # ------------------------------------------------------------------
    # Decode (one token, persistent cache)
    # ------------------------------------------------------------------
    def decode_init(self, batch: int, max_len: int) -> Dict[str, Any]:
        cfg = self.cfg
        dev, dt = self.embed.device, self.embed.dtype
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        return {
            "pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
            "kv": (torch.zeros(shape, dtype=dt, device=dev),
                   torch.zeros(shape, dtype=dt, device=dev)),
        }

    @torch.no_grad()
    def decode_step(self, state: Dict[str, Any], tokens: Tensor):
        """tokens: (B, 1) -> (logits (B, 1, V), new state).  The caches in
        ``state`` are updated in place; the returned state shares them."""
        cfg = self.cfg
        pos = state["pos"]
        ks, vs = state["kv"]
        x = self._embed(tokens)
        for i in range(cfg.n_layers):
            p = self.blocks.layer(i)
            h, _ = attn_decode_apply(
                cfg, p["attn"], rms_norm(x, p["ln1"]), (ks[i], vs[i]), pos,
                is_local=cfg.is_local_layer(i),
            )
            x = self._block_tail(p, x, h)
        hidden = rms_norm(x, self.final_norm)
        return self.logits(hidden), {**state, "pos": pos + 1}
