"""Encoder-decoder backbone (seamless-m4t-large-v2).

The port of ``repro.models.encdec.EncDecLM``.  As in the reference, the
speech frontend is a stub: the encoder takes precomputed frame embeddings
``enc_emb`` (B, S_enc, D).  A bidirectional encoder over them, then a
causal decoder with cross-attention to the encoder's output (``memory``);
the embedding is tied to the output projection and there is no softcap.

Parameter names follow the JAX tree (``embed``, ``enc_norm``,
``final_norm``, ``enc_blocks.{ln1,ln2,attn.*,mlp.*}``,
``dec_blocks.{ln1,ln_x,ln2,attn.*,xattn.*,mlp.*}``), each block's weights
stacked (L, ...), so ``weights.load_jax_params`` takes a JAX tree as it is.
On CUDA the encoder, the decoder's self-attention and the prefill's
cross-attention run the prefill kernel, the decode step's self-attention
the decode kernel; the decode step's cross-attention against the K/V
precomputed in ``decode_init`` is plain PyTorch, as the reference computes
it outside any kernel.

On a mesh (serving under tp, ``sharding.set_mesh``) the decode state is
laid out by ``decode_state_specs`` (the cross K/V ``xk`` and ``xv`` with
their KV heads over 'model' where they divide it), and the decode step's
cross-attention runs on each rank's rows and KV heads.  Every matmul
contracts on its weight's 'model' shard (``layers``); the prefill gathers
the encoder's output along its sequence once, for every cross-attention's
K/V projections.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from .. import resolve_device, torch_dtype
from . import sharding
from .config import ModelConfig
from .layers import (
    _project,
    attn_apply,
    attn_decode_apply,
    attn_init,
    cross_attn_apply,
    embed_rows,
    kept_shards,
    mapped,
    mlp_apply,
    mlp_init,
    rms_norm,
    set_layer,
    write_cache,
)
from .lm import _attn_shapes, _cast, _fill, _mlp_shapes, _params, _Stacked, checkpointed
from .sharding import constrain_residual

Tensor = torch.Tensor


class _Stack(_Stacked):
    """A stack of n blocks: the named norms (n, D), attention groups and
    one MLP, each weight stacked (n, ...)."""

    def __init__(self, cfg: ModelConfig, dtype, n: int, norms: Sequence[str],
                 attns: Sequence[str]):
        super().__init__()
        L = (n,)
        for name, p in _params({k: L + (cfg.d_model,) for k in norms}, dtype).items():
            self.register_parameter(name, p)
        self.attns = tuple(attns)
        for name in attns:
            setattr(self, name, _params(_attn_shapes(cfg, L), dtype))
        self.mlp = _params(_mlp_shapes(cfg, L), dtype)
        self.n = n


class EncDecLM(nn.Module):
    """The encoder-decoder for one ``encdec`` config.  Built on the meta
    device; ``init`` materializes it."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.family != "encdec":
            raise ValueError(f"EncDecLM ports the encdec family, not {cfg.family!r}")
        self.cfg = cfg
        dt = torch_dtype(cfg.dtype)
        D = cfg.d_model
        for name, p in _params({"embed": (cfg.vocab, D), "enc_norm": (D,),
                                "final_norm": (D,)}, dt).items():
            self.register_parameter(name, p)
        self.enc_blocks = _Stack(cfg, dt, cfg.n_enc_layers, ("ln1", "ln2"), ("attn",))
        self.dec_blocks = _Stack(cfg, dt, cfg.n_layers, ("ln1", "ln_x", "ln2"),
                                 ("attn", "xattn"))

    @torch.no_grad()
    def init(self, generator: torch.Generator, device="cuda") -> "EncDecLM":
        """Random weights with the reference's shapes and scales: embed
        N(0,1)*0.02, attention N*D^-0.5, w_out N*F^-0.5, norms zeros.  The
        generator must live on ``device``."""
        dev = resolve_device(device)
        cfg = self.cfg
        dt = torch_dtype(cfg.dtype)
        self.to_empty(device=dev)
        for p in self.parameters():
            p.zero_()
        self.embed.copy_(torch.randn(self.embed.shape, generator=generator, device=dev) * 0.02)
        for stack in (self.enc_blocks, self.dec_blocks):
            for i in range(stack.n):
                for name in stack.attns:
                    _fill(getattr(stack, name), i, attn_init(cfg, generator, dt, dev))
                _fill(stack.mlp, i, mlp_init(cfg, generator, dt, dev))
        return self

    # ------------------------------------------------------------------
    # Forward
    # ------------------------------------------------------------------
    def encode(self, enc_emb: Tensor, *, remat: bool = False) -> Tensor:
        """enc_emb (B, S_enc, D) frame embeddings -> memory (B, S_enc, D):
        non-causal self-attention blocks in enc_emb's type, then the
        encoder's final norm.  With ``remat`` each layer runs
        ``checkpointed``."""
        x = enc_emb
        for p in self.enc_blocks.layers():
            x = checkpointed(self._enc_layer, x, p) if remat else self._enc_layer(x, p)
        return rms_norm(x, self.enc_norm)

    def _enc_layer(self, x: Tensor, p) -> Tensor:
        cfg = self.cfg
        p = _cast(p, x.dtype)
        x = x + attn_apply(cfg, p["attn"], rms_norm(x, p["ln1"]), causal=False)
        x = x + mlp_apply(cfg, p["mlp"], rms_norm(x, p["ln2"]))
        return constrain_residual(cfg, x)

    def decode_seq(self, tokens: Tensor, memory: Tensor, *, remat: bool = False) -> Tensor:
        """Teacher-forced decoder pass; returns the final hidden states.
        The embedding rows are not cast, as in the reference: with f32
        masters the decoder computes in f32 whatever the config's type."""
        x = embed_rows(self.embed, tokens)
        for p in self.dec_blocks.layers():
            x = (checkpointed(self._dec_layer, x, p, memory) if remat
                 else self._dec_layer(x, p, memory))
        return rms_norm(x, self.final_norm)

    def _dec_layer(self, x: Tensor, p, memory: Tensor) -> Tensor:
        cfg = self.cfg
        p = _cast(p, x.dtype)
        x = x + attn_apply(cfg, p["attn"], rms_norm(x, p["ln1"]), causal=True)
        x = x + cross_attn_apply(cfg, p["xattn"], rms_norm(x, p["ln_x"]), memory)
        x = x + mlp_apply(cfg, p["mlp"], rms_norm(x, p["ln2"]))
        return constrain_residual(cfg, x)

    def hidden_states(self, batch: Dict[str, Tensor], *, with_aux: bool = False,
                      remat: bool = False):
        """batch {"tokens", "enc_emb"} -> hidden states; with ``with_aux``,
        also the (empty) aux metrics, as ``LM.hidden_states``."""
        memory = self.encode(batch["enc_emb"], remat=remat)
        hidden = self.decode_seq(batch["tokens"], memory, remat=remat)
        return (hidden, {}) if with_aux else hidden

    def logits(self, hidden: Tensor) -> Tensor:
        """Tied embedding, in the param type, then f32."""
        if isinstance(hidden, DTensor):
            return _project(hidden, self.embed.T).float()
        return torch.matmul(hidden, self.embed.T).float()

    def apply(self, batch: Dict[str, Tensor]) -> Tensor:
        return self.logits(self.hidden_states(batch))

    # ------------------------------------------------------------------
    # Prefill and decode
    # ------------------------------------------------------------------
    @torch.no_grad()
    def prefill(self, tokens: Tensor, memory: Tensor, max_len: Optional[int] = None):
        """Teacher-forced decoder pass that fills the self-attention caches.
        Returns (last-position logits (B, 1, V), decode state) with the
        caches (L, B, max_len, K, hd), zero past the prompt."""
        cfg = self.cfg
        B, S = tokens.shape
        if isinstance(memory, DTensor):
            # The encoder's output whole along its sequence on every rank,
            # gathered once for every cross-attention's K/V projections.
            memory = memory.redistribute(memory.device_mesh, kept_shards(memory, (0,)))
        state = self.decode_init(B, max_len or S, memory)
        ks, vs = state["kv"]
        x = embed_rows(self.embed, tokens)
        for i, p in enumerate(self.dec_blocks.layers()):
            h, (k, v) = attn_apply(cfg, p["attn"], rms_norm(x, p["ln1"]), causal=True,
                                   return_kv=True)
            write_cache(ks[i], k, 0)
            write_cache(vs[i], v, 0)
            x = x + h
            x = x + cross_attn_apply(cfg, p["xattn"], rms_norm(x, p["ln_x"]), memory)
            x = x + mlp_apply(cfg, p["mlp"], rms_norm(x, p["ln2"]))
        state["pos"].fill_(S)
        return self.logits(rms_norm(x[:, -1:], self.final_norm)), state

    @torch.no_grad()
    def decode_init(self, batch: int, max_len: int, memory: Tensor) -> Dict[str, Any]:
        """Zero self-attention caches (L, B, max_len, K, hd), and the
        cross-attention K/V of ``memory`` computed once a request, (L, B,
        S_enc, K, hd) each.  Under ``set_mesh``, each laid out by
        ``decode_state_specs``."""
        cfg = self.cfg
        dev, dt = self.embed.device, self.embed.dtype
        L, K, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
        meshed = sharding.current_mesh() is not None
        at = "meta" if meshed else dev
        shape = (L, batch, max_len, K, hd)
        xk = torch.empty((L, *memory.shape[:2], K, hd), dtype=memory.dtype, device=at)
        state = {"pos": torch.zeros((batch,), dtype=torch.int32, device=at),
                 "kv": (torch.zeros(shape, dtype=dt, device=at),
                        torch.zeros(shape, dtype=dt, device=at)),
                 "xk": xk, "xv": torch.empty_like(xk)}
        if meshed:
            state = sharding.laid_out_zeros(cfg, state, dev)
        wk, wv = self.dec_blocks.xattn["wk"], self.dec_blocks.xattn["wv"]
        for i in range(L):
            set_layer(state["xk"], i, _project(memory, wk[i]))
            set_layer(state["xv"], i, _project(memory, wv[i]))
        return state

    def _cross_decode(self, p, x: Tensor, xk: Tensor, xv: Tensor) -> Tensor:
        """The reference's decode cross-attention, inline: logits in the
        input type, then f32, scaled; the f32 softmax weights cast to the
        cache's type before their product with V.  On a mesh each rank
        attends its rows and the KV heads of its shard of ``xk``/``xv``."""
        q = _project(x, p["wq"])
        if isinstance(q, DTensor):
            kv_p = list(xk.placements)
            q_p = [pl if isinstance(pl, Shard) and pl.dim in (0, 2) else Replicate()
                   for pl in kv_p]
            o = mapped(self._cross_attend, q_p, (q_p, kv_p, kv_p), None, q, xk, xv)
        else:
            o = self._cross_attend(q, xk, xv)
        return _project(o, p["wo"], 2, like=x)

    def _cross_attend(self, q: Tensor, xk: Tensor, xv: Tensor) -> Tensor:
        B, _, H, hd = q.shape
        K = xk.shape[2]
        qh = q.reshape(B, K, H // K, hd)
        logits = torch.einsum("bkrd,bskd->bkrs", qh, xk).float() * self.cfg.head_dim ** -0.5
        w = torch.softmax(logits, dim=-1).to(xv.dtype)
        return torch.einsum("bkrs,bskd->bkrd", w, xv).reshape(B, 1, H, hd)

    @torch.no_grad()
    def decode_step(self, state: Dict[str, Any], tokens: Tensor):
        """tokens (B, 1) -> (logits (B, 1, V), new state).  The caches in
        ``state`` are updated in place; the returned state shares them."""
        cfg = self.cfg
        pos = state["pos"]
        ks, vs = state["kv"]
        x = embed_rows(self.embed, tokens)
        for i, p in enumerate(self.dec_blocks.layers()):
            h, _ = attn_decode_apply(cfg, p["attn"], rms_norm(x, p["ln1"]), (ks[i], vs[i]), pos)
            x = x + h
            x = x + self._cross_decode(p["xattn"], rms_norm(x, p["ln_x"]),
                                       state["xk"][i], state["xv"][i])
            x = x + mlp_apply(cfg, p["mlp"], rms_norm(x, p["ln2"]))
        logits = self.logits(rms_norm(x, self.final_norm))
        return logits, {**state, "pos": pos + 1}
