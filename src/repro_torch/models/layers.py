"""Shared neural building blocks: plain functions on tensors.

The port of ``repro.models.layers``.  Attention has three plain paths and a
kernel path, chosen by ``cfg.attn_impl``:

  * ``naive``   - materialized (B, H, Sq, Sk) logits; tests and references.
  * ``chunked`` - a loop over query chunks; peak memory O(Cq x Sk).
  * ``pallas``  - the hand-written CUDA kernels (the field keeps the JAX
    package's name); raises for CPU tensors, and while autograd records
    (the kernels have no backward).
  * ``auto``    - the kernels on CUDA; on the CPU, and on CUDA while
    autograd records, JAX's rule: chunked when ``Sq > 2 * attn_q_chunk``,
    else naive (JAX's "auto" never picks a kernel).

The decode step follows the same rule between ``attention_decode`` and the
decode kernel; ``use_kernel`` states it once.

Under ``sharding_policy="fsdp"`` attention is ``attention_fsdp_seqshard``
whatever ``attn_impl`` says, as in the reference: on a mesh with a 'model'
axis each rank attends its query shard against the full K/V
(``local_map``), and otherwise it is ``attention_chunked``.

The functions take DTensors as well as tensors (a model on a mesh).  The
ops that contract (projections, attention, the embedding gather) run on
each rank's local shard through ``local_map``; elementwise ops and norms
run as DTensor ops, and a plain tensor they make for a DTensor input
(positions, masks) joins it replicated.  A weight laid out by the tp specs
(``sharding.param_specs(..., "tp")``: one dim over 'model', another over
'data') contracts on its 'model' shard, the reference's tensor
parallelism: a column-parallel weight (its output dim over 'model': wq,
wk, wv, w_in, w_gate, the unembedding) gives each rank its shard of the
output, the input gathered over 'model' where it arrives split there (the
sequence-parallel all-gather); a row-parallel one (its input dim over
'model': wo, w_out) gives each rank a partial sum, reduced over 'model'
into the residual's layout (an all-reduce, or a reduce-scatter where the
residual's sequence rides 'model').  The weight is gathered over its other
axes only ('data': the reference's FSDP of the input dim).  The embedding
looks its rows up on each rank's vocab shard and sums them over 'model'.
A weight that 'model' does not split (the spec's fallback where a dim does
not divide it), or splits together with the other axes (the fsdp policy's
flat ZeRO-3 layout), is gathered whole at use.

The decode step on a mesh (serving, the tp policy) runs on a decode state
laid out by ``sharding.decode_state_specs``: each rank writes the new
token's K/V into its shard of the cache (``write_cache``) and attends on
it.  Where the cache's KV heads split, each rank attends its heads (the
kernel, or the plain version off CUDA); where its sequence splits, each
rank attends its shard's keys with their global offset and returns its
partial output and log-sum-exp, and the ranks merge them over the mesh
dims that split the sequence with two all-reduces (the max of the
log-sum-exps, then the rescaled outputs and sums in one tensor), as XLA
partitions the reference's ``attention_decode``.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..kernels import ops as kops
from . import sharding
from .config import ModelConfig

Tensor = torch.Tensor
NEG_INF = -2.0e38  # large-negative fill that survives bf16/fp32 softmax


# --------------------------------------------------------------------------
# Elementary ops
# --------------------------------------------------------------------------
def replicated_like(t: Tensor, x: Tensor) -> Tensor:
    """``t`` (the same on every rank) as a replicated DTensor on ``x``'s
    mesh where ``x`` is a DTensor; else ``t``."""
    if not isinstance(x, DTensor) or isinstance(t, DTensor):
        return t
    mesh = x.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def replicated_value(t: Tensor) -> Tensor:
    """A replicated DTensor's value as a plain tensor (each rank holds it
    whole); a tensor itself."""
    return t.to_local() if isinstance(t, DTensor) else t


def kept_shards(x: DTensor, dims) -> list:
    """``x``'s placements with a shard kept where it splits one of ``dims``
    and ``Replicate`` elsewhere (a ``Partial`` is reduced)."""
    return [p if isinstance(p, Shard) and p.dim in dims else Replicate() for p in x.placements]


def partial_where_sharded(placements) -> list:
    """The gradient's placements of a tensor that each rank used whole
    against inputs laid out by ``placements``: a partial sum over each mesh
    dim that splits them."""
    return [Partial() if isinstance(p, Shard) else Replicate() for p in placements]


def on_mesh(mesh, base=None, **dims) -> list:
    """Placements over ``mesh``: ``dims`` maps a mesh dim's name to its
    placement, the others are ``base``'s (``Replicate`` where None)."""
    base = base or [Replicate()] * mesh.ndim
    return [dims.get(name, pl) for name, pl in zip(mesh.mesh_dim_names, base)]


def mapped(fn, out_placements, in_placements, in_grad_placements, *args):
    """``local_map`` of ``fn`` over ``args`` (the first a DTensor, whose mesh
    it runs on), the inputs redistributed to ``in_placements``
    (``in_grad_placements`` None where no gradient flows: serving)."""
    return local_map(fn, out_placements=out_placements, in_placements=in_placements,
                     in_grad_placements=in_grad_placements, device_mesh=args[0].device_mesh,
                     redistribute_inputs=True)(*args)


def local_with_replicated(fn, x: DTensor, x_placements, *replicated: Tensor,
                          out_placements=None):
    """``fn(x_local, *replicated_local)`` on each rank: ``x`` laid out by
    ``x_placements``, every other input gathered whole (its gradient the
    partial sum of the ranks' that ``x_placements`` splits), the output
    laid out as ``x`` unless ``out_placements`` says otherwise: for
    inputs that no tp spec splits over 'model' (the MoE's router, a weight
    under the fsdp policy's ZeRO-3 layout, which is gathered whole at use).
    A weight that the tp specs split over 'model' goes through
    ``_project`` or ``embed_rows``."""
    mesh = x.device_mesh
    rep = [Replicate()] * mesh.ndim
    grad = partial_where_sharded(x_placements)
    return local_map(
        fn, out_placements=x_placements if out_placements is None else out_placements,
        in_placements=(x_placements,) + (rep,) * len(replicated),
        in_grad_placements=(x_placements,) + (grad,) * len(replicated),
        device_mesh=mesh, redistribute_inputs=True,
    )(x, *(replicated_like(t, x) for t in replicated))


def model_dim(mesh) -> Optional[int]:
    """The index of the mesh's 'model' dim, None where it has none."""
    names = tuple(mesh.mesh_dim_names or ())
    return names.index("model") if "model" in names else None


def tp_dim(w: Tensor) -> Optional[int]:
    """The dim of weight ``w`` that the mesh's 'model' dim splits on its
    own, as the tp specs lay a weight out; None for a plain tensor, a
    weight that 'model' does not split, or one it splits together with
    other mesh dims (the fsdp policy's flat ZeRO-3 split)."""
    if not isinstance(w, DTensor):
        return None
    mi = model_dim(w.device_mesh)
    if mi is None or not isinstance(w.placements[mi], Shard):
        return None
    d = w.placements[mi].dim
    if any(isinstance(p, Shard) and p.dim == d
           for j, p in enumerate(w.placements) if j != mi):
        return None
    return d


def rms_norm(x: Tensor, scale: Tensor, eps: float = 1e-6) -> Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dtype)


def softcap(x: Tensor, cap: Optional[float]) -> Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def _gelu_tanh(x: Tensor) -> Tensor:
    return F.gelu(x, approximate="tanh")


def activation_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu_tanh}[name]


# --------------------------------------------------------------------------
# Rotary position embeddings
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _rope_freq(half: int, theta: float, device: torch.device) -> Tensor:
    exponent = -torch.arange(0, half, dtype=torch.float32, device=device) / half
    return torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), exponent)


def rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    freq = _rope_freq(half, theta, x.device)
    angles = positions[..., None].float() * freq  # (..., S, half)
    sin = replicated_like(torch.sin(angles)[..., None, :], x)  # (..., S, 1, half)
    cos = replicated_like(torch.cos(angles)[..., None, :], x)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Attention
# --------------------------------------------------------------------------
def _mask_bias(
    q_pos: Tensor, k_pos: Tensor, *, causal: bool, window: Optional[int], is_local: bool
) -> Tensor:
    """Additive bias (Sq, Sk): 0 where attendable, NEG_INF elsewhere."""
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool, device=q_pos.device)
    if causal:
        ok &= q_pos[:, None] >= k_pos[None, :]
    if window is not None and is_local:
        ok &= (q_pos[:, None] - k_pos[None, :]) < window
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, NEG_INF)


def _qk_scale(cfg: ModelConfig) -> float:
    return cfg.head_dim ** -0.5


def _attend(qh: Tensor, k: Tensor, v: Tensor, bias: Tensor, cfg: ModelConfig) -> Tensor:
    """qh (B, Sq, K, rep, hd) against k, v (B, Sk, K, hd); JAX's rounding:
    logits in the input type, then f32; weights cast to v's type."""
    logits = torch.einsum("bqkrd,bskd->bkrqs", qh, k).float()
    logits = logits * _qk_scale(cfg)
    logits = softcap(logits, cfg.attn_logit_softcap)
    logits = logits + replicated_like(bias, logits)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bkrqs,bskd->bqkrd", w, v)


def attention_naive(
    q: Tensor,  # (B, Sq, H, hd)
    k: Tensor,  # (B, Sk, K, hd)
    v: Tensor,  # (B, Sk, K, hd)
    *,
    cfg: ModelConfig,
    q_offset: int = 0,
    causal: bool = True,
    is_local: bool = False,
) -> Tensor:
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    qh = q.reshape(B, Sq, K, H // K, hd)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Sk, device=q.device)
    bias = _mask_bias(q_pos, k_pos, causal=causal, window=cfg.sliding_window, is_local=is_local)
    return _attend(qh, k, v, bias, cfg).reshape(B, Sq, H, hd)


def attention_chunked(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    *,
    cfg: ModelConfig,
    q_offset: int = 0,
    causal: bool = True,
    is_local: bool = False,
) -> Tensor:
    """Loop over query chunks; full keys per chunk (exact, memory-bounded)."""
    B, Sq, H, hd = q.shape
    Cq = min(cfg.attn_q_chunk, Sq)
    if Sq % Cq != 0:
        return attention_naive(
            q, k, v, cfg=cfg, q_offset=q_offset, causal=causal, is_local=is_local
        )
    K = k.shape[2]
    k_pos = torch.arange(k.shape[1], device=q.device)
    outs = []
    for start in range(0, Sq, Cq):
        qh = q[:, start : start + Cq].reshape(B, Cq, K, H // K, hd)
        q_pos = q_offset + start + torch.arange(Cq, device=q.device)
        bias = _mask_bias(
            q_pos, k_pos, causal=causal, window=cfg.sliding_window, is_local=is_local
        )
        outs.append(_attend(qh, k, v, bias, cfg).reshape(B, Cq, H, hd))
    return torch.cat(outs, dim=1)


def attention_decode(
    q: Tensor,  # (B, 1, H, hd)
    k_cache: Tensor,  # (B, S, K, hd)
    v_cache: Tensor,  # (B, S, K, hd)
    pos: Tensor,  # (B,) number of valid entries
    *,
    cfg: ModelConfig,
    is_local: bool = False,
    key_offset: int = 0,
    return_lse: bool = False,
):
    """One-token attention over the cache; local layers mask the entries
    outside the sliding window.  A shard of a cache split along its
    sequence holds keys [key_offset, key_offset + S) (``pos`` and the window
    in global positions); with ``return_lse`` the output is normalised over
    the shard's valid keys (0 where it has none) and comes with their f32
    (B, H) log-sum-exp (-inf where none), which ``decode_merge`` merges."""
    B, _, H, hd = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    qh = q.reshape(B, K, H // K, hd)
    logits = torch.einsum("bkrd,bskd->bkrs", qh, k_cache).float()
    logits = logits * _qk_scale(cfg)
    logits = softcap(logits, cfg.attn_logit_softcap)
    k_pos = torch.arange(S, device=q.device) + key_offset
    valid = k_pos[None, :] < pos[:, None]  # (B, S)
    if cfg.sliding_window is not None and is_local:
        valid &= k_pos[None, :] >= (pos[:, None] - cfg.sliding_window)
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    logits = logits + torch.where(valid, zero, NEG_INF)[:, None, None, :]
    w = torch.softmax(logits, dim=-1)
    if return_lse:
        valid = valid[:, None, None, :]
        w = torch.where(valid, w, 0.0)
    out = torch.einsum("bkrs,bskd->bkrd", w.to(v_cache.dtype), v_cache).reshape(B, 1, H, hd)
    if not return_lse:
        return out
    lse = torch.logsumexp(torch.where(valid, logits, -torch.inf), dim=-1)
    return out, lse.reshape(B, H)


def decode_merge(out: Tensor, lse: Tensor, mesh, dims) -> Tensor:
    """The ranks' partial decode attentions (``out`` (B, 1, H, hd), ``lse``
    (B, H), each over the keys of its shard of the cache) merged over the
    mesh dims ``dims`` that split the cache's sequence, on each rank's
    local tensors: ``kops.merge_partials`` with an all-reduce of the max
    log-sum-exp, then one of the rescaled outputs beside their weights."""

    def over_ranks(t, op):
        for d in dims:
            t = funcol.all_reduce(t, op, (mesh, d))
        return t

    return kops.merge_partials(out, lse.reshape(out.shape[:-1]), over_ranks)


def use_kernel(impl: str, on_cuda: bool, grad: bool) -> bool:
    """Whether attention (and the SSD) run the CUDA kernels under
    ``attn_impl`` ``impl``, on a CUDA tensor or not, with autograd
    recording or not."""
    if impl == "pallas":
        if not on_cuda:
            raise RuntimeError("attn_impl='pallas' runs the CUDA kernels; got a CPU tensor")
        if grad:
            raise RuntimeError("attn_impl='pallas': the CUDA kernels have no backward; under "
                               "autograd use attn_impl='auto', 'chunked' or 'naive' (the "
                               "plain path)")
        return True
    return impl == "auto" and on_cuda and not grad


def _kernel_impl(cfg: ModelConfig, *tensors: Tensor) -> bool:
    """``use_kernel`` for the op's inputs (the first decides the device)."""
    return use_kernel(cfg.attn_impl, tensors[0].is_cuda, kops.records_grad(*tensors))


def _kernel_window(cfg: ModelConfig, is_local: bool) -> Optional[int]:
    return cfg.sliding_window if (cfg.sliding_window and is_local) else None


def attention_fsdp_seqshard(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    *,
    cfg: ModelConfig,
    causal: bool = True,
    is_local: bool = False,
    q_offset: int = 0,
) -> Tensor:
    """Sequence-parallel attention under the fsdp policy: queries stay
    sharded over 'model' along the sequence; each rank runs the local
    chunked attention against the (replicated) full K/V with its shard's
    position offset.  Expressed with ``local_map`` (the reference's
    ``shard_map``) so the q-chunk loop runs on *local* shapes.  Without a
    mesh, on plain tensors, or where the mesh has no 'model' axis, 'model'
    does not divide Sq or ('pod','data') does not divide B, it is
    ``attention_chunked``."""
    chunked = functools.partial(attention_chunked, cfg=cfg, causal=causal, is_local=is_local)
    if not isinstance(q, DTensor):
        return chunked(q, k, v, q_offset=q_offset)
    mesh = sharding.current_mesh()
    sizes = sharding._mesh_sizes() or {}
    dp = sharding._dp(sizes)
    B, Sq = q.shape[0], q.shape[1]
    if (
        not sizes
        or "model" not in sizes
        or Sq % sizes["model"] != 0
        or (dp and B % sharding._size(sizes, dp) != 0)
    ):
        return _attention_local(q, k, v, functools.partial(chunked, q_offset=q_offset))
    b_ax = dp if dp else None
    qp = sharding.to_placements(sharding._pad((b_ax, "model", None, None), 4), mesh, q.shape)
    kvp = sharding.to_placements(sharding._pad((b_ax, None, None, None), 4), mesh, k.shape)
    # Each rank's K/V gradient covers its own queries only: a partial sum
    # over 'model' (the transpose of shard_map's replicated input).
    kv_grad = [Partial() if name == "model" else p
               for name, p in zip(mesh.mesh_dim_names, kvp)]

    def local_fn(ql, kl, vl):
        return chunked(ql, kl, vl, q_offset=mesh["model"].get_local_rank() * ql.shape[1])

    return local_map(local_fn, out_placements=qp, in_placements=(qp, kvp, kvp),
                     in_grad_placements=(qp, kv_grad, kv_grad), device_mesh=mesh,
                     redistribute_inputs=True)(q, k, v)


def _attention_local(q: DTensor, k: DTensor, v: DTensor, fn) -> DTensor:
    """``fn`` (a plain attention) on each rank's rows and heads: a mesh dim
    stays split where it splits q, k and v alike by batch (dim 0) or by
    heads (dim 2: GQA's groups stay whole, as H and K split alike); every
    other split is gathered first."""
    k, v = replicated_like(k, q), replicated_like(v, q)
    placements = [p if (isinstance(p, Shard) and p.dim in (0, 2)
                        and k.placements[i] == p and v.placements[i] == p) else Replicate()
                  for i, p in enumerate(q.placements)]
    return local_map(fn, out_placements=placements, in_placements=(placements,) * 3,
                     device_mesh=q.device_mesh, redistribute_inputs=True)(q, k, v)


def attention(q, k, v, *, cfg: ModelConfig, causal: bool = True, is_local: bool = False) -> Tensor:
    if cfg.sharding_policy == "fsdp":
        return attention_fsdp_seqshard(q, k, v, cfg=cfg, causal=causal, is_local=is_local)
    if isinstance(q, DTensor):
        return _attention_local(q, k, v, functools.partial(
            attention, cfg=cfg, causal=causal, is_local=is_local))
    if _kernel_impl(cfg, q, k, v):
        return kops.flash_attention(
            q, k, v, scale=_qk_scale(cfg), causal=causal,
            window=_kernel_window(cfg, is_local), softcap=cfg.attn_logit_softcap,
        )
    impl = cfg.attn_impl
    if impl == "auto":
        impl = "chunked" if q.shape[1] > 2 * cfg.attn_q_chunk else "naive"
    if impl == "chunked":
        return attention_chunked(q, k, v, cfg=cfg, causal=causal, is_local=is_local)
    return attention_naive(q, k, v, cfg=cfg, causal=causal, is_local=is_local)


# --------------------------------------------------------------------------
# Attention block (init + apply + decode)
# --------------------------------------------------------------------------
def _normal(shape, std: float, generator: torch.Generator, dtype, device) -> Tensor:
    return (torch.randn(shape, generator=generator, device=device) * std).to(dtype)


def attn_init(cfg: ModelConfig, generator: torch.Generator, dtype, device) -> Dict[str, Tensor]:
    D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = D ** -0.5
    p = {
        "wq": _normal((D, H, hd), s, generator, dtype, device),
        "wk": _normal((D, K, hd), s, generator, dtype, device),
        "wv": _normal((D, K, hd), s, generator, dtype, device),
        "wo": _normal((H, hd, D), s, generator, dtype, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.zeros((hd,), dtype=dtype, device=device)
    return p


def embed_rows(table: Tensor, tokens: Tensor) -> Tensor:
    """``table[tokens]``.  On a mesh, where the table's vocab rides 'model'
    (the tp specs) each rank looks its tokens up in its vocab shard (rows
    of other shards zero) and the rows are summed over 'model', the table
    gathered over its other axes only; otherwise each rank gathers its
    tokens' rows of the table gathered whole."""
    if not (isinstance(table, DTensor) or isinstance(tokens, DTensor)):
        return table[tokens]
    tokens = replicated_like(tokens, table)
    table = replicated_like(table, tokens)
    rows = kept_shards(tokens, range(tokens.dim()))
    if tp_dim(table) != 0:
        return local_with_replicated(lambda t, w: w[t], tokens, rows, table)
    mesh = table.device_mesh
    mi = model_dim(mesh)
    rows[mi] = Replicate()
    table_p = on_mesh(mesh, model=Shard(0))

    def local(t, w):
        v0 = mesh.get_local_rank(mi) * w.shape[0]
        at = t - v0
        mine = (at >= 0) & (at < w.shape[0])
        return torch.where(mine[..., None], w[at.clamp(0, w.shape[0] - 1)], 0)

    out_p = list(rows)
    out_p[mi] = Partial()
    out = mapped(local, out_p, (rows, table_p),
                 (rows, on_mesh(mesh, partial_where_sharded(rows), model=Shard(0))),
                 tokens, table)
    return out.redistribute(mesh, rows)


def _project(x: Tensor, w: Tensor, n_in: int = 1, like: Optional[Tensor] = None) -> Tensor:
    """Contracts x's last ``n_in`` dims with w's first ``n_in`` dims (the
    einsums "bsd,dhe->bshe", "bshe,hed->bsd", "bsd,df->bsf") as one matmul
    over flattened dims: the same sums with far less host work per call.
    On a mesh each rank contracts its rows of x (the contracted dims
    gathered) with w as the module's docstring says: on its 'model' shard
    where the tp specs split w there, the partial sums of a row-parallel w
    reduced into ``like``'s layout (by default replicated over 'model');
    else with w gathered whole."""
    if isinstance(x, DTensor) or isinstance(w, DTensor):
        return _project_mesh(replicated_like(x, w), replicated_like(w, x), n_in, like)
    lead, k_dims = x.shape[: x.dim() - n_in], w.shape[:n_in]
    out = x.reshape(*lead, -1) @ w.reshape(k_dims.numel(), -1)
    return out.reshape(*lead, *w.shape[n_in:])


def _project_mesh(x: DTensor, w: DTensor, n_in: int, like: Optional[Tensor]) -> DTensor:
    mesh = x.device_mesh
    lead = x.dim() - n_in
    mi, d = model_dim(mesh), tp_dim(w)
    x_p = kept_shards(x, range(lead))
    w_p = [Replicate()] * mesh.ndim
    out_p, x_grad = list(x_p), list(x_p)
    row = d is not None and d < n_in
    if d is not None:
        w_p[mi] = Shard(d)
        if row:  # each rank contracts its slice of the input dim: partial sums
            x_p[mi] = x_grad[mi] = Shard(lead + d)
            out_p[mi] = Partial()
        else:  # each rank computes its shard of the output dim
            x_p[mi], x_grad[mi] = Replicate(), Partial()
            out_p[mi] = Shard(lead + d - n_in)
    # A weight's gradient keeps its 'model' shard; it is a partial sum over
    # the mesh dims that split x's rows.
    w_grad = [wp if isinstance(wp, Shard) else Partial() if isinstance(xp, Shard)
              else Replicate() for xp, wp in zip(x_p, w_p)]
    out = local_map(functools.partial(_project, n_in=n_in), out_placements=out_p,
                    in_placements=(x_p, w_p), in_grad_placements=(x_grad, w_grad),
                    device_mesh=mesh, redistribute_inputs=True)(x, w)
    if not row:
        return out
    target = (list(like.placements) if isinstance(like, DTensor)
              else [Replicate() if isinstance(p, Partial) else p for p in out_p])
    return out.redistribute(mesh, target)


def attn_qkv(cfg: ModelConfig, p, x: Tensor, positions: Tensor):
    q = _project(x, p["wq"])
    k = _project(x, p["wk"])
    v = _project(x, p["wv"])
    if cfg.sharding_policy != "none":
        # Attention boundary resharding (policy-dependent): under tp the
        # heads ride 'model' and the sequence gathers (Megatron SP);
        # under fsdp the queries stay sequence-sharded and K/V gather.
        q, k, v = sharding.constrain_attn_qkv(cfg, q, k, v)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_apply(
    cfg: ModelConfig,
    p,
    x: Tensor,
    *,
    is_local: bool = False,
    causal: bool = True,
    positions: Optional[Tensor] = None,
    return_kv: bool = False,
):
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device, dtype=torch.int32).expand(B, S)
    q, k, v = attn_qkv(cfg, p, x, positions)
    out = attention(q, k, v, cfg=cfg, causal=causal, is_local=is_local)
    y = _project(out, p["wo"], 2, like=x)
    if return_kv:
        return y, (k, v)
    return y


def cross_attn_apply(cfg: ModelConfig, p, x: Tensor, memory: Tensor) -> Tensor:
    """Decoder cross-attention: queries from x, keys and values from
    ``memory`` (B, S_enc, D); no RoPE, no mask.  On CUDA the prefill
    kernel's non-causal mode with Sq != Sk.  A memory narrower than x (a
    bf16 encoder under an f32 decoder, as the encoder-decoder trains on
    f32 masters) is widened first, as JAX's einsum promotes it."""
    memory = memory.to(torch.promote_types(memory.dtype, x.dtype))
    q = _project(x, p["wq"])
    k = _project(memory, p["wk"])
    v = _project(memory, p["wv"])
    out = attention(q, k, v, cfg=cfg, causal=False)
    return _project(out, p["wo"], 2, like=x)


def attn_decode_apply(
    cfg: ModelConfig,
    p,
    x: Tensor,  # (B, 1, D)
    kv: Tuple[Tensor, Tensor],  # caches (B, S, K, hd)
    pos: Tensor,  # (B,)
    *,
    is_local: bool = False,
):
    """Writes the new token's K/V into the caches at ``pos`` IN PLACE (the
    JAX version returns updated copies) and attends over ``pos + 1``
    entries.  Returns (y, kv) with kv the same, now updated, tensors.  On a
    mesh, as the module's docstring says."""
    pos = replicated_value(pos)
    q, k_new, v_new = attn_qkv(cfg, p, x, pos[:, None])
    k_cache, v_cache = kv
    write_cache(k_cache, k_new, pos)
    write_cache(v_cache, v_new, pos)
    if isinstance(q, DTensor):
        out = _decode_attention_mesh(cfg, q, k_cache, v_cache, pos + 1, is_local)
    else:
        out = _decode_attention(cfg, q, k_cache, v_cache, pos + 1, is_local)
    y = _project(out, p["wo"], 2, like=x)
    return y, (k_cache, v_cache)


def _decode_attention(cfg: ModelConfig, q, k_cache, v_cache, lengths, is_local: bool,
                      **shard):
    """The decode attention on tensors: the kernel, or the plain version;
    ``shard`` (key_offset, return_lse) for a shard of a sequence-split
    cache."""
    if _kernel_impl(cfg, q, k_cache, v_cache):
        return kops.decode_attention(
            q, k_cache, v_cache, lengths, scale=_qk_scale(cfg),
            window=_kernel_window(cfg, is_local), softcap=cfg.attn_logit_softcap, **shard)
    return attention_decode(q, k_cache, v_cache, lengths, cfg=cfg, is_local=is_local, **shard)


def _decode_attention_mesh(cfg: ModelConfig, q: DTensor, k_cache: DTensor, v_cache: DTensor,
                           lengths: Tensor, is_local: bool) -> DTensor:
    """The decode attention on each rank's shard of the cache: q laid out
    as the cache's rows and KV heads (whole where the cache's sequence
    splits), the partials merged over the mesh dims that split the
    sequence (``decode_merge``)."""
    mesh = q.device_mesh
    cache_p = list(k_cache.placements)
    q_p = [p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate() for p in cache_p]
    seq_dims = [i for i, p in enumerate(cache_p) if isinstance(p, Shard) and p.dim == 1]
    b0, s0 = sharding.local_offsets(k_cache)[:2]

    def local(ql, kl, vl):
        lens = lengths[b0:b0 + ql.shape[0]]
        if not seq_dims:
            return _decode_attention(cfg, ql, kl, vl, lens, is_local)
        out, lse = _decode_attention(cfg, ql, kl, vl, lens, is_local, key_offset=s0,
                                     return_lse=True)
        return decode_merge(out, lse, mesh, seq_dims)

    return mapped(local, q_p, (q_p, cache_p, cache_p), None, q, k_cache, v_cache)


def write_cache(cache: Tensor, new: Tensor, start) -> Tensor:
    """Writes ``new`` (B, T, K, hd) into ``cache`` (B, S, K, hd) IN PLACE at
    positions ``start`` + t of each row: ``start`` an int (prefill: the
    prompt from 0) or a (B,) tensor (decode: one token at each row's
    position).  On a mesh each rank writes its shard of the cache: its rows
    and heads and, where the cache's sequence splits, the positions its
    shard holds; ``new`` comes to it laid out as the cache but for the
    sequence, which each rank holds whole.  Returns ``cache``."""
    if not isinstance(cache, DTensor):
        if isinstance(start, int):
            cache[:, start:start + new.shape[1]] = new.to(cache.dtype)
        else:
            rows = torch.arange(cache.shape[0], device=cache.device)
            cache[rows, start] = new[:, 0].to(cache.dtype)
        return cache
    cache_p = list(cache.placements)
    new_p = [Replicate() if isinstance(p, Shard) and p.dim == 1 else p for p in cache_p]
    split = new_p != cache_p
    b0, s0 = sharding.local_offsets(cache)[:2]

    def local(c, n):
        S = c.shape[1]
        if isinstance(start, int):
            lo, hi = max(start, s0), min(start + n.shape[1], s0 + S)
            if lo < hi:
                c[:, lo - s0:hi - s0] = n[:, lo - start:hi - start].to(c.dtype)
            return c
        rows = torch.arange(c.shape[0], device=c.device)
        at = start[b0:b0 + c.shape[0]] - s0
        if not split:
            c[rows, at] = n[:, 0].to(c.dtype)
            return c
        # Only the rank whose shard holds a row's position writes it; the
        # others write the row's entry at a clamped position back as it was.
        inside = ((at >= 0) & (at < S))[:, None, None]
        at = at.clamp(0, S - 1)
        c[rows, at] = torch.where(inside, n[:, 0].to(c.dtype), c[rows, at])
        return c

    return mapped(local, cache_p, (cache_p, new_p), None, cache, replicated_like(new, cache))


def set_layer(stack: Tensor, i: int, value: Tensor) -> None:
    """``stack[i] = value`` IN PLACE; on a mesh ``value`` is laid out as the
    stack's layer i (``stack``'s dim 0 is never split) and each rank copies
    its shard."""
    if not isinstance(stack, DTensor):
        stack[i] = value
        return
    layer_p = [Shard(p.dim - 1) if isinstance(p, Shard) else p for p in stack.placements]
    value = replicated_like(value, stack).redistribute(stack.device_mesh, layer_p)
    stack.to_local()[i].copy_(value.to_local())


# --------------------------------------------------------------------------
# MLP block
# --------------------------------------------------------------------------
def mlp_init(cfg: ModelConfig, generator: torch.Generator, dtype, device,
             d_ff: Optional[int] = None) -> Dict[str, Tensor]:
    D, Fd = cfg.d_model, d_ff or cfg.d_ff
    s_in, s_out = D ** -0.5, Fd ** -0.5
    p = {
        "w_in": _normal((D, Fd), s_in, generator, dtype, device),
        "w_out": _normal((Fd, D), s_out, generator, dtype, device),
    }
    if cfg.mlp_gated:
        p["w_gate"] = _normal((D, Fd), s_in, generator, dtype, device)
    return p


def mlp_apply(cfg: ModelConfig, p, x: Tensor) -> Tensor:
    act = activation_fn(cfg.activation)
    h = _project(x, p["w_in"])
    if cfg.mlp_gated:
        h = act(_project(x, p["w_gate"])) * h
    else:
        h = act(h)
    return _project(h, p["w_out"], like=x)
