"""Decoder-only language model: dense, VLM, MoE, SSM and hybrid families.

The port of ``repro.models.lm.LM``.  ``LM`` is an ``nn.Module`` whose
parameter names follow the JAX tree paths (``embed``, ``unembed``,
``final_norm``, ``blocks.ln1``, ``blocks.attn.wq``, ``blocks.mlp.w_in``,
``blocks.moe.router``, ``blocks.moe.shared.w_in``, ``blocks.mamba.in_proj``,
``shared.attn.wq``, ...) with the block weights stacked ``(L, ...)`` as in
JAX, so weights bridge key for key.  The layer loop is a Python ``for``, so
whether a layer is local (sliding window), and whether zamba2's shared
attention block follows it, are static bools.

The hybrid (zamba2): ONE shared attention+MLP block (``shared``) is applied
after every ``hybrid_period``-th Mamba layer; each application has its own
KV cache in decode.

The module is built on the meta device; ``init`` (random weights with the
reference's shapes and scales) materializes it on a device.

Serving on a mesh: with the weights placed by ``param_specs(..., "tp")``
and under ``sharding.set_mesh``, ``prefill`` and ``decode_step`` run on
DTensors and keep the decode state laid out by ``decode_state_specs``
(born so in ``decode_init``); each cache write lands on each rank's shard.
Every matmul contracts on its weight's 'model' shard (``layers``), and the
logits come out split over the vocabulary, which ``Engine`` gathers whole.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from .. import resolve_device, torch_dtype
from .config import ModelConfig
from . import sharding
from .layers import (
    _project,
    attn_apply,
    attn_decode_apply,
    attn_init,
    embed_rows,
    mlp_apply,
    mlp_init,
    rms_norm,
    set_layer,
    softcap,
    write_cache,
)
from .mamba2 import (
    check_prompt_len,
    mamba_apply,
    mamba_decode_step,
    mamba_init,
    mamba_state_init,
)
from .moe import moe_apply, moe_init, moe_shapes
from .sharding import constrain_residual

Tensor = torch.Tensor


def _params(shapes: Dict[str, tuple], dtype) -> nn.ParameterDict:
    return nn.ParameterDict(
        {k: nn.Parameter(torch.empty(s, dtype=dtype, device="meta"), requires_grad=False)
         for k, s in shapes.items()}
    )


def _attn_shapes(cfg: ModelConfig, lead: tuple = ()) -> Dict[str, tuple]:
    D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    shapes = {"wq": (D, H, hd), "wk": (D, K, hd), "wv": (D, K, hd), "wo": (H, hd, D)}
    if cfg.qk_norm:
        shapes.update(q_norm=(hd,), k_norm=(hd,))
    return {k: lead + v for k, v in shapes.items()}


def _mlp_shapes(cfg: ModelConfig, lead: tuple = ()) -> Dict[str, tuple]:
    D, Fd = cfg.d_model, cfg.d_ff
    shapes = {"w_in": (D, Fd), "w_out": (Fd, D)}
    if cfg.mlp_gated:
        shapes["w_gate"] = (D, Fd)
    return {k: lead + v for k, v in shapes.items()}


def _norm_shapes(cfg: ModelConfig, lead: tuple = ()) -> Dict[str, tuple]:
    names = ["ln1", "ln2"] + (["ln1_post", "ln2_post"] if cfg.post_norm else [])
    return {n: lead + (cfg.d_model,) for n in names}


def _cast(p, dtype):
    """Every floating tensor of a (nested) param dict in ``dtype``: JAX's
    ``_cast_block``, which the forward pass of the SSM stack applies."""
    if isinstance(p, dict):
        return {k: _cast(v, dtype) for k, v in p.items()}
    return p.to(dtype) if p.is_floating_point() else p


def _fill(stacked: nn.ParameterDict, i: int, fresh: Dict[str, Tensor]) -> None:
    for name, w in fresh.items():
        stacked[name][i].copy_(w)


def _layers(m: nn.Module) -> List[Dict[str, Any]]:
    per = {n: torch.unbind(w) for n, w in m.named_parameters(recurse=False)}
    per.update((n, _layers(child)) for n, child in m.named_children())
    return [{n: ws[i] for n, ws in per.items()} for i in range(len(next(iter(per.values()))))]


def checkpointed(fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` while autograd
    records: its activations are recomputed in the backward, as under the
    reference's ``jax.checkpoint``."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False)


class _Stacked(nn.Module):
    """A module of stacked (L, ...) weights."""

    def layers(self) -> List[Dict[str, Any]]:
        """Every layer's weights as the nested dict the layer functions
        take, keyed as the module names its parameters, from one
        ``torch.unbind`` of each stack: its backward stacks the layers'
        gradients once, where reading ``w[i]`` per layer would write a
        zero-filled gradient of the whole stack for each layer."""
        return _layers(self)


class _MoE(_Stacked):
    """The stacked MoE weights: the router (L, D, E) in f32, as in the
    reference, beside the experts and the shared expert in the model type."""

    def __init__(self, cfg: ModelConfig, dtype):
        super().__init__()
        L = (cfg.n_layers,)
        params = {**_params({"router": L + (cfg.d_model, cfg.n_experts)}, torch.float32),
                  **_params({k: L + s for k, s in moe_shapes(cfg).items()}, dtype)}
        for name, p in params.items():
            self.register_parameter(name, p)
        if cfg.n_shared_experts:
            shared = cfg.replace(d_ff=cfg.d_ff * cfg.n_shared_experts)
            self.shared = _params(_mlp_shapes(shared, L), dtype)


class _Blocks(_Stacked):
    """The stacked (L, ...) weights of the attention blocks: an MLP, or for
    the MoE family the experts."""

    def __init__(self, cfg: ModelConfig, dtype):
        super().__init__()
        L = (cfg.n_layers,)
        for name, p in _params(_norm_shapes(cfg, L), dtype).items():
            self.register_parameter(name, p)
        self.attn = _params(_attn_shapes(cfg, L), dtype)
        if cfg.family == "moe":
            self.moe = _MoE(cfg, dtype)
        else:
            self.mlp = _params(_mlp_shapes(cfg, L), dtype)


class _SSMBlocks(_Stacked):
    """The stacked (L, ...) weights of the Mamba-2 blocks; A_log, D and
    dt_bias stay f32 in any model type, as in the reference."""

    def __init__(self, cfg: ModelConfig, dtype):
        super().__init__()
        L, D, di, N, nh, W = (cfg.n_layers, cfg.d_model, cfg.d_inner, cfg.ssm_state,
                              cfg.n_ssm_heads, cfg.ssm_conv_width)
        self.ln1 = _params({"ln1": (L, D)}, dtype)["ln1"]
        self.mamba = _params({
            "in_proj": (L, D, 2 * di + 2 * N + nh), "conv_w": (L, W, di + 2 * N),
            "conv_b": (L, di + 2 * N), "norm": (L, di), "out_proj": (L, di, D)}, dtype)
        self.mamba.update(_params({"A_log": (L, nh), "D": (L, nh), "dt_bias": (L, nh)},
                                  torch.float32))


class _SharedBlock(nn.Module):
    """zamba2's one shared attention+MLP block (unstacked)."""

    def __init__(self, cfg: ModelConfig, dtype):
        super().__init__()
        for name, p in _params(_norm_shapes(cfg), dtype).items():
            self.register_parameter(name, p)
        self.attn = _params(_attn_shapes(cfg), dtype)
        self.mlp = _params(_mlp_shapes(cfg), dtype)

    def weights(self) -> Dict[str, Any]:
        p: Dict[str, Any] = dict(self.named_parameters(recurse=False))
        p["attn"] = dict(self.attn.items())
        p["mlp"] = dict(self.mlp.items())
        return p


class LM(nn.Module):
    """Dense / VLM / MoE / SSM / hybrid decoder for one config."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.family not in ("dense", "vlm", "moe", "ssm", "hybrid"):
            raise ValueError(f"LM ports the dense, vlm, moe, ssm and hybrid families, "
                             f"not {cfg.family!r}")
        self.cfg = cfg
        self.is_ssm = cfg.family in ("ssm", "hybrid")
        dt = torch_dtype(cfg.dtype)
        shapes = {"embed": (cfg.vocab, cfg.d_model), "final_norm": (cfg.d_model,)}
        if not cfg.tie_embeddings:
            shapes["unembed"] = (cfg.d_model, cfg.vocab)
        for name, p in _params(shapes, dt).items():
            self.register_parameter(name, p)
        self.blocks = _SSMBlocks(cfg, dt) if self.is_ssm else _Blocks(cfg, dt)
        if cfg.family == "hybrid":
            self.shared = _SharedBlock(cfg, dt)

    def _shared_after(self, i: int) -> bool:
        """Whether the hybrid's shared block follows layer i."""
        period = self.cfg.hybrid_period
        return self.cfg.family == "hybrid" and bool(period) and i % period == period - 1

    # ------------------------------------------------------------------
    # Init
    # ------------------------------------------------------------------
    @torch.no_grad()
    def init(self, generator: torch.Generator, device="cuda") -> "LM":
        """Materializes the weights on ``device`` with the reference's shapes
        and scales: embed/unembed N(0,1)*0.02, attention N*D^-0.5, w_out
        N*F^-0.5, Mamba's as ``mamba_init``, the experts' as ``moe_init``,
        norms zeros.  The generator must live on ``device``."""
        dev = resolve_device(device)
        cfg = self.cfg
        dt = torch_dtype(cfg.dtype)
        self.to_empty(device=dev)
        for p in self.parameters():
            p.zero_()
        self.embed.copy_(torch.randn(self.embed.shape, generator=generator, device=dev) * 0.02)
        if not cfg.tie_embeddings:
            self.unembed.copy_(
                torch.randn(self.unembed.shape, generator=generator, device=dev) * 0.02
            )
        moe = self.blocks.moe.layers() if cfg.family == "moe" else None
        for i in range(cfg.n_layers):
            if self.is_ssm:
                _fill(self.blocks.mamba, i, mamba_init(cfg, generator, dt, dev))
            else:
                _fill(self.blocks.attn, i, attn_init(cfg, generator, dt, dev))
                if cfg.family == "moe":
                    moe_init(cfg, generator, dt, dev, out=moe[i])
                else:
                    _fill(self.blocks.mlp, i, mlp_init(cfg, generator, dt, dev))
        if cfg.family == "hybrid":
            for group, fresh in (("attn", attn_init(cfg, generator, dt, dev)),
                                 ("mlp", mlp_init(cfg, generator, dt, dev))):
                for name, w in fresh.items():
                    getattr(self.shared, group)[name].copy_(w)
        return self

    # ------------------------------------------------------------------
    # Layer body
    # ------------------------------------------------------------------
    def _block_tail(self, p, x: Tensor, h: Tensor, *, dropless: bool = False,
                    auxs: Optional[list] = None) -> Tensor:
        """Residual around attention output h, then the MLP half: the MLP,
        or the experts (``dropless`` in decode), whose aux metrics are
        appended to ``auxs``."""
        cfg = self.cfg
        if cfg.post_norm:
            h = rms_norm(h, p["ln1_post"])
        x = x + h
        if "moe" in p:
            h2, aux = moe_apply(cfg, p["moe"], rms_norm(x, p["ln2"]), dropless=dropless)
            if auxs is not None:
                auxs.append(aux)
        else:
            h2 = mlp_apply(cfg, p["mlp"], rms_norm(x, p["ln2"]))
        if cfg.post_norm:
            h2 = rms_norm(h2, p["ln2_post"])
        return x + h2

    def _embed(self, tokens: Tensor, dtype: Optional[torch.dtype] = None) -> Tensor:
        """The token rows, cast to ``dtype`` when given (the forward pass
        casts to the config type; prefill and decode, as the reference's,
        take the rows in the weights' type)."""
        x = embed_rows(self.embed, tokens)
        if dtype is not None:
            x = x.to(dtype)
        if self.cfg.emb_scale_by_sqrt_dim:
            # The scale rounded to x's type on the host, as the reference's
            # jnp.asarray(sqrt(d), x.dtype): no host-to-device copy, which a
            # captured decode step could not hold.
            x = x * torch.tensor(self.cfg.d_model ** 0.5, dtype=x.dtype).item()
        return x

    # ------------------------------------------------------------------
    # Forward: final hidden states
    # ------------------------------------------------------------------
    def hidden_states(self, tokens: Tensor, *, with_aux: bool = False, remat: bool = False):
        """The final hidden states; with ``with_aux``, also the MoE aux
        metrics' means over the layers (``{}`` for other families).  With
        ``remat`` each layer runs ``checkpointed``, as training calls it.

        As JAX's ``hidden_states``, the embedding rows and every floating
        block param are cast to the config type first (so f32 masters run
        the forward in bf16 under a bf16 config): in bf16 that rounds the
        MoE router, which ``prefill`` and ``decode_step`` use in f32, and
        Mamba's A_log, D and dt_bias."""
        cfg = self.cfg
        x = self._embed(tokens, torch_dtype(cfg.dtype))
        layer = self._ssm_layer if self.is_ssm else self._attn_layer
        auxs: list = []
        for i, p in enumerate(self.blocks.layers()):
            x, aux = checkpointed(layer, x, p, i) if remat else layer(x, p, i)
            if aux:
                auxs.append(aux)
        hidden = rms_norm(x, self.final_norm.to(x.dtype))
        if not with_aux:
            return hidden
        aux = {k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]} if auxs else {}
        return hidden, aux

    def _attn_layer(self, x: Tensor, p, i: int):
        """Layer i of an attention stack: (x, its MoE aux metrics or {})."""
        p = _cast(p, x.dtype)
        auxs: list = []
        h = attn_apply(self.cfg, p["attn"], rms_norm(x, p["ln1"]),
                       is_local=self.cfg.is_local_layer(i))
        y = constrain_residual(self.cfg, self._block_tail(p, x, h, auxs=auxs))
        return y, (auxs[0] if auxs else {})

    def _ssm_layer(self, x: Tensor, p, i: int):
        """Mamba-2 layer i, and the hybrid's shared block where it follows
        it: (x, {})."""
        cfg = self.cfg
        p = _cast(p, x.dtype)
        h, _ = mamba_apply(cfg, p["mamba"], rms_norm(x, p["ln1"]))
        x = constrain_residual(cfg, x + h)
        if self._shared_after(i):
            sp = _cast(self.shared.weights(), x.dtype)
            h = attn_apply(cfg, sp["attn"], rms_norm(x, sp["ln1"]))
            x = self._block_tail(sp, x, h)
        return x, {}

    def logits(self, hidden: Tensor) -> Tensor:
        """Einsum in the param dtype, then f32 (and the final softcap).  On a
        mesh each rank computes its shard of the vocabulary where the tp
        specs split the unembedding (the tied table's rows) over 'model'."""
        w = self.unembed if not self.cfg.tie_embeddings else self.embed.T
        out = _project(hidden, w) if isinstance(hidden, DTensor) else torch.matmul(hidden, w)
        out = out.float()
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
        if self.is_ssm:
            x = self._ssm_prefill(state, self._embed(tokens))
            return self.logits(rms_norm(x[:, -1:], self.final_norm)), state
        ks, vs = state["kv"]
        x = self._embed(tokens)
        for i, p in enumerate(self.blocks.layers()):
            h, (k, v) = attn_apply(
                cfg, p["attn"], rms_norm(x, p["ln1"]), is_local=cfg.is_local_layer(i),
                return_kv=True,
            )
            write_cache(ks[i], k, 0)
            write_cache(vs[i], v, 0)
            x = self._block_tail(p, x, h)
        state["pos"].fill_(S)
        hidden = rms_norm(x[:, -1:], self.final_norm)
        return self.logits(hidden), state

    def _ssm_prefill(self, state: Dict[str, Any], x: Tensor) -> Tensor:
        """JAX's ``_ssm_prefill`` into ``state``: per layer the final SSM
        state and the conv tail; per shared-block call its K/V, zero past
        the prompt.  The block params are used uncast (A_log, D and dt_bias
        in f32), as in JAX."""
        cfg = self.cfg
        S = x.shape[1]
        check_prompt_len(cfg, S)
        hs, convs = state["ssm"]["h"], state["ssm"]["conv"]
        inv = 0
        for i, p in enumerate(self.blocks.layers()):
            h, hstate, tail = mamba_apply(cfg, p["mamba"], rms_norm(x, p["ln1"]),
                                          return_conv_tail=True)
            x = x + h
            set_layer(hs, i, hstate)
            set_layer(convs, i, tail)
            if self._shared_after(i):
                sp = self.shared.weights()
                h, (k, v) = attn_apply(cfg, sp["attn"], rms_norm(x, sp["ln1"]), return_kv=True)
                x = x + h
                x = x + mlp_apply(cfg, sp["mlp"], rms_norm(x, sp["ln2"]))
                write_cache(state["shared_kv"][0][inv], k, 0)
                write_cache(state["shared_kv"][1][inv], v, 0)
                inv += 1
        state["pos"].fill_(S)
        return x

    # ------------------------------------------------------------------
    # Decode (one token, persistent cache)
    # ------------------------------------------------------------------
    def decode_init(self, batch: int, max_len: int) -> Dict[str, Any]:
        """Zero decode state: dense KV caches (L, B, max_len, K, hd); for the
        SSM families the per-layer SSM state (L, B, nh, hd, N) in f32 and conv
        window (L, B, W-1, C), and the hybrid's shared-block caches
        (n_calls, B, max_len, K, hd).  Under ``set_mesh``, each laid out by
        ``decode_state_specs``."""
        dev = self.embed.device
        if sharding.current_mesh() is not None:
            return sharding.laid_out_zeros(self.cfg, self._zero_state(batch, max_len, "meta"),
                                           dev)
        return self._zero_state(batch, max_len, dev)

    def _zero_state(self, batch: int, max_len: int, dev) -> Dict[str, Any]:
        cfg = self.cfg
        dt = self.embed.dtype
        state: Dict[str, Any] = {"pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}
        kv_shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        if not self.is_ssm:
            shape = (cfg.n_layers, *kv_shape)
            state["kv"] = (torch.zeros(shape, dtype=dt, device=dev),
                           torch.zeros(shape, dtype=dt, device=dev))
            return state
        one = mamba_state_init(cfg, batch, dt, dev)
        state["ssm"] = {k: v[None].repeat(cfg.n_layers, *([1] * v.dim()))
                        for k, v in one.items()}
        n_calls = sum(self._shared_after(i) for i in range(cfg.n_layers))
        if n_calls:
            shape = (n_calls, *kv_shape)
            state["shared_kv"] = (torch.zeros(shape, dtype=dt, device=dev),
                                  torch.zeros(shape, dtype=dt, device=dev))
        return state

    @torch.no_grad()
    def decode_step(self, state: Dict[str, Any], tokens: Tensor):
        """tokens: (B, 1) -> (logits (B, 1, V), new state).  The caches in
        ``state`` are updated in place; the returned state shares them."""
        cfg = self.cfg
        pos = state["pos"]
        x = self._embed(tokens)
        if self.is_ssm:
            x = self._ssm_decode(state, x, pos)
            return self.logits(rms_norm(x, self.final_norm)), {**state, "pos": pos + 1}
        ks, vs = state["kv"]
        for i, p in enumerate(self.blocks.layers()):
            h, _ = attn_decode_apply(
                cfg, p["attn"], rms_norm(x, p["ln1"]), (ks[i], vs[i]), pos,
                is_local=cfg.is_local_layer(i),
            )
            x = self._block_tail(p, x, h, dropless=True)
        hidden = rms_norm(x, self.final_norm)
        return self.logits(hidden), {**state, "pos": pos + 1}

    def _ssm_decode(self, state: Dict[str, Any], x: Tensor, pos: Tensor) -> Tensor:
        """JAX's ``_ssm_decode``, writing each layer's new SSM state and conv
        window, and each shared-block call's new K/V, into ``state`` in place."""
        cfg = self.cfg
        hs, convs = state["ssm"]["h"], state["ssm"]["conv"]
        shared_kv = state.get("shared_kv")
        inv = 0
        for i, p in enumerate(self.blocks.layers()):
            h, new = mamba_decode_step(cfg, p["mamba"], rms_norm(x, p["ln1"]),
                                       {"h": hs[i], "conv": convs[i]})
            set_layer(hs, i, new["h"])
            set_layer(convs, i, new["conv"])
            x = x + h
            if shared_kv is not None and self._shared_after(i):
                sp = self.shared.weights()
                h, _ = attn_decode_apply(cfg, sp["attn"], rms_norm(x, sp["ln1"]),
                                         (shared_kv[0][inv], shared_kv[1][inv]), pos)
                x = x + h
                x = x + mlp_apply(cfg, sp["mlp"], rms_norm(x, sp["ln2"]))
                inv += 1
        return x
