"""Mamba-2 (SSD, state-space duality) block: plain functions on tensors.

The port of ``repro.models.mamba2``.  Prefill runs the chunked SSD
algorithm: a quadratic intra-chunk block plus a linear inter-chunk
recurrence over the f32 (B, heads, head_dim, state) tensor.  Which of two
paths runs it follows ``cfg.attn_impl``, as attention does
(``layers.use_kernel``):

  * the kernel (``pallas``, or ``auto`` on a CUDA tensor while autograd does
    not record): ``kernels.ops.ssd``, whose intra-chunk block is the
    hand-written CUDA kernel;
  * otherwise ``ssd_chunked`` below, the plain version (the reference's
    ``mamba_apply`` always calls it).

Decode is the O(1)-per-token recurrent form over that state plus a rolling
window of the last W-1 conv inputs.

On a mesh (x a DTensor: the tp training policy of the SSM and hybrid
families) x keeps its split of the batch over ('pod','data') and its
sequence is gathered (the SSD scan runs over the whole sequence, and the
causal conv reaches across a sequence shard's edge), and the heads ride
'model': in_proj's output dim concatenates z, x, B, C and dt, so its
'model' slice would mix pieces, and instead each rank takes its heads'
columns of z, x and dt (and B and C whole: one group) from the weight
gathered at use (``_heads``), and runs the conv, the SSD and the gate on
them.  The gated norm's mean over the whole d_inner is reduced over
'model'; out_proj takes each rank's rows of d_inner, a partial sum over
'model'.  Its collectives a layer: the all-gather of x's sequence over
'model' and of each mixer weight over the axes its spec splits; the norm's
all-reduce; the output's reduce-scatter back into x's sequence shards; in
the backward the gradients' reductions to the weights' layouts and to x's.
Where the heads do not divide 'model', the mixer runs whole on each rank's
rows.  Prefill's conv tail (the last W-1 pre-conv activations) is the
projection of the last W-1 positions onto in_proj's x, B and C columns,
on each rank's rows.

The decode step on a mesh (serving) splits the heads over 'model' in the
same way: each rank projects its token onto its heads' z and dt columns and
onto all of x, B and C, updates its heads' SSM state (its shard of the
state, laid out by ``decode_state_specs``), and the gated norm and
out_proj run as in prefill.  The conv window's spec splits its channels
evenly over 'model', which does not follow the heads: each rank gathers
the window at use, convolves its heads' channels and B and C, and keeps
its spec's columns of the new window.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..kernels import ops as kops
from . import sharding
from .config import ModelConfig
from .layers import (_kernel_impl, _normal, _project, kept_shards, local_with_replicated, mapped,
                     on_mesh, partial_where_sharded, rms_norm)

Tensor = torch.Tensor


def check_prompt_len(cfg: ModelConfig, S: int) -> None:
    """Raises unless the chunked SSD takes a prompt of S tokens: at most one
    chunk, or a whole number of chunks (``kernels.ops.chunk_len``)."""
    kops.chunk_len(S, cfg.ssm_chunk)


# --------------------------------------------------------------------------
# Init
# --------------------------------------------------------------------------
def mamba_init(cfg: ModelConfig, generator: torch.Generator, dtype, device) -> Dict[str, Tensor]:
    """The reference's shapes and scales; A_log, D and dt_bias are f32 in
    any model type."""
    D, di, N, nh, W = (cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads,
                       cfg.ssm_conv_width)
    f32 = dict(dtype=torch.float32, device=device)
    # in_proj emits [z (di), x (di), B (N), C (N), dt (nh)]
    return {
        "in_proj": _normal((D, 2 * di + 2 * N + nh), D ** -0.5, generator, dtype, device),
        "conv_w": _normal((W, di + 2 * N), W ** -0.5, generator, dtype, device),
        "conv_b": torch.zeros((di + 2 * N,), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, **f32)),
        "D": torch.ones((nh,), **f32),
        "dt_bias": torch.log(torch.expm1(torch.full((nh,), 1e-2, **f32))),
        "norm": torch.zeros((di,), dtype=dtype, device=device),
        "out_proj": _normal((di, D), di ** -0.5, generator, dtype, device),
    }


def _split_proj(cfg: ModelConfig, zxbcdt: Tensor):
    di, N, nh = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    return torch.split(zxbcdt, [di, di + 2 * N, nh], dim=-1)


# --------------------------------------------------------------------------
# Chunked SSD forward (the plain version)
# --------------------------------------------------------------------------
def _segsum(a: Tensor) -> Tensor:
    """a: (..., T) log decays -> (..., T, T) lower-triangular segment sums."""
    T = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    i = torch.arange(T, device=a.device)
    return torch.where(i[:, None] >= i[None, :], diff, -torch.inf)


def ssd_chunked(
    x: Tensor,  # (B, S, nh, hd), already multiplied by dt
    a: Tensor,  # (B, S, nh) log decay dt * A (negative)
    Bm: Tensor,  # (B, S, N)
    Cm: Tensor,  # (B, S, N)
    chunk: int,
    h0: Optional[Tensor] = None,  # (B, nh, hd, N)
) -> Tuple[Tensor, Tensor]:
    """Returns (y (B, S, nh, hd) in x's type, final state (B, nh, hd, N) f32).
    The products take their operands in f32, as JAX's einsums promote the
    bf16 inputs against the f32 decays."""
    B_, S, nh, hd = x.shape
    N = Bm.shape[-1]
    Q = kops.chunk_len(S, chunk)
    nC = S // Q
    xc = x.float().reshape(B_, nC, Q, nh, hd)
    ac = a.float().reshape(B_, nC, Q, nh).permute(0, 3, 1, 2)  # (B, nh, nC, Q)
    Bc = Bm.float().reshape(B_, nC, Q, N)
    Cc = Cm.float().reshape(B_, nC, Q, N)
    a_cumsum = torch.cumsum(ac, dim=-1)

    # 1. intra-chunk (diagonal blocks): quadratic within the chunk.
    L = torch.exp(_segsum(ac))  # (B, nh, nC, Q, Q)
    scores = torch.einsum("bcln,bcsn->bcls", Cc, Bc)
    y_diag = torch.einsum("bcls,bhcls,bcshp->bclhp", scores, L, xc)

    # 2. per-chunk input -> end-of-chunk state contribution.
    decay_states = torch.exp(a_cumsum[..., -1:] - a_cumsum)  # (B, nh, nC, Q)
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", Bc, decay_states, xc)

    # 3. inter-chunk recurrence, in f32 whatever the compute type.
    chunk_decay = torch.exp(a_cumsum[..., -1])  # (B, nh, nC)
    h = (torch.zeros((B_, nh, hd, N), dtype=torch.float32, device=x.device) if h0 is None
         else h0.float())
    h_ins = []
    for c in range(nC):
        h_ins.append(h)  # the state entering chunk c
        h = h * chunk_decay[:, :, c, None, None] + states[:, c]

    # 4. state -> output within each chunk.
    state_decay_out = torch.exp(a_cumsum)  # (B, nh, nC, Q)
    y_off = torch.einsum("bcln,bchpn,bhcl->bclhp", Cc, torch.stack(h_ins, dim=1),
                         state_decay_out)
    y = (y_diag + y_off).reshape(B_, S, nh, hd).to(x.dtype)
    return y, h


def _conv1d(xBC: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """Depthwise causal conv of width W: (B, S, C) with (W, C) filters.  The
    taps are added one after another in the input type, as JAX adds them."""
    W, S = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, W - 1, 0))
    out = pad[:, 0:S, :] * w[0]
    for i in range(1, W):
        out = out + pad[:, i : i + S, :] * w[i]
    return out + b


def _mixer(cfg: ModelConfig, p, x: Tensor, h0: Optional[Tensor], nh: int):
    """in_proj, the causal conv, the SSD and the gate over ``nh`` heads
    (``p`` holds their columns): (y * silu(z) (B, S, nh * hd) in x's type,
    the final state, the pre-conv x, B, C)."""
    B, S, D = x.shape
    N, hd = cfg.ssm_state, cfg.ssm_head_dim
    di = nh * hd
    z, xBC_pre, dt = torch.split(_project(x, p["in_proj"]), [di, di + 2 * N, nh], dim=-1)
    xBC = F.silu(_conv1d(xBC_pre, p["conv_w"], p["conv_b"]))
    xs, Bm, Cm = torch.split(xBC, [di, N, N], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])  # (B, S, nh)
    A = -torch.exp(p["A_log"])  # (nh,)
    xh = xs.reshape(B, S, nh, hd)
    xdt, a = xh * dt[..., None].to(xh.dtype), dt * A
    ssd = kops.ssd if _kernel_impl(cfg, xdt, a, Bm, Cm) else ssd_chunked
    y, h = ssd(xdt, a, Bm, Cm, cfg.ssm_chunk, h0)
    y = y + xh * p["D"][None, None, :, None].to(xh.dtype)
    y = y.reshape(B, S, di).to(x.dtype)
    return y * F.silu(z), h, xBC_pre


def _heads(cfg: ModelConfig, p, m: int, k: int, *, whole_xbc: bool = False):
    """The mixer's weights of heads [m k, (m + 1) k): their columns of z, x
    and dt in in_proj, of x in the conv, and B and C whole (one group).
    With ``whole_xbc`` in_proj's columns of x, B and C are all of them (the
    decode step keeps every channel's conv window)."""
    di, N, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    dev = p["in_proj"].device

    def span(start, n):
        return torch.arange(start, start + n, device=dev)

    dl = k * hd
    xs = ([span(di, di + 2 * N)] if whole_xbc
          else [span(di + m * dl, dl), span(2 * di, 2 * N)])
    cols = torch.cat([span(m * dl, dl), *xs, span(2 * di + 2 * N + m * k, k)])
    conv = torch.cat([span(m * dl, dl), span(di, 2 * N)])
    heads = slice(m * k, (m + 1) * k)
    return {"in_proj": p["in_proj"][:, cols], "conv_w": p["conv_w"][:, conv],
            "conv_b": p["conv_b"][conv], "A_log": p["A_log"][heads], "D": p["D"][heads],
            "dt_bias": p["dt_bias"][heads]}


_MIXER = ("in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias")


def mamba_apply(
    cfg: ModelConfig,
    p,
    x: Tensor,
    h0: Optional[Tensor] = None,
    *,
    return_conv_tail: bool = False,
):
    """Full-sequence forward.  x: (B, S, D) -> (B, S, D), final ssm state;
    with ``return_conv_tail`` also the last W-1 pre-conv activations, which
    seed the decode's rolling conv window.  On a mesh, as the module's
    docstring says."""
    if isinstance(x, DTensor):
        return _mamba_apply_mesh(cfg, p, x, h0, return_conv_tail)
    S = x.shape[1]
    g, h, xBC_pre = _mixer(cfg, p, x, h0, cfg.n_ssm_heads)
    y = rms_norm(g, p["norm"])
    out = _project(y, p["out_proj"]).to(x.dtype)
    if return_conv_tail:
        W = cfg.ssm_conv_width
        return out, h, xBC_pre[:, S - (W - 1) :, :]
    return out, h


def _mamba_apply_mesh(cfg: ModelConfig, p, x: DTensor, h0, return_conv_tail: bool):
    mesh = x.device_mesh
    rows = kept_shards(x, (0,))  # the batch's split kept, the sequence gathered
    M = sharding.axis_sizes(mesh).get("model", 1)
    nh = cfg.n_ssm_heads
    if M == 1 or nh % M or h0 is not None:
        # The mixer whole on each rank's rows.
        names = list(p)

        def whole(xl, *ws):
            return mamba_apply(cfg, dict(zip(names, ws)), xl, h0,
                               return_conv_tail=return_conv_tail)

        return local_with_replicated(whole, x, rows, *(p[n] for n in names),
                                     out_placements=(rows,) * (3 if return_conv_tail else 2))
    # The heads over 'model': each rank runs its nh / M heads.  A rank's
    # heads use all of x and of B and C: their gradients are partial sums
    # over 'model' (and the weights' over the batch's axes).
    k = nh // M
    weights_grad = on_mesh(mesh, partial_where_sharded(rows), model=Partial())

    def heads(xl, *ws):
        sl = _heads(cfg, dict(zip(_MIXER, ws)), mesh["model"].get_local_rank(), k)
        g, h, _ = _mixer(cfg, sl, xl, None, k)
        return g, h

    g, h = mapped(heads, (on_mesh(mesh, rows, model=Shard(2)), on_mesh(mesh, rows, model=Shard(1))),
                  (rows,) + (on_mesh(mesh),) * len(_MIXER),
                  (on_mesh(mesh, rows, model=Partial()),) + (weights_grad,) * len(_MIXER),
                  x, *(p[n] for n in _MIXER))
    out = _gated_out(p, g, x, rows)
    if not return_conv_tail:
        return out, h
    S, W, di, N = x.shape[1], cfg.ssm_conv_width, cfg.d_inner, cfg.ssm_state
    tail = local_with_replicated(
        lambda xl, w: _project(xl[:, S - (W - 1):], w[:, di:2 * di + 2 * N]), x, rows,
        p["in_proj"])
    return out, h, tail


def _gated_out(p, g: DTensor, x: DTensor, rows) -> DTensor:
    """The gated norm of the heads' outputs ``g`` (their d_inner over
    'model') over the whole d_inner (its mean reduced over 'model'), then
    out_proj on each rank's rows of it: a partial sum over 'model', reduced
    into x's layout."""
    mesh = x.device_mesh
    y = rms_norm(g, p["norm"])
    y_p = on_mesh(mesh, rows, model=Shard(2))
    out = mapped(_project, on_mesh(mesh, rows, model=Partial()),
                 (y_p, on_mesh(mesh, model=Shard(0))),
                 (y_p, on_mesh(mesh, partial_where_sharded(rows), model=Shard(0))),
                 y, p["out_proj"])
    return out.to(x.dtype).redistribute(mesh, x.placements)


# --------------------------------------------------------------------------
# Recurrent decode (O(1) per token)
# --------------------------------------------------------------------------
def mamba_state_init(cfg: ModelConfig, batch: int, dtype, device) -> Dict[str, Tensor]:
    di, N, nh, hd, W = (cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_head_dim,
                        cfg.ssm_conv_width)
    return {
        "h": torch.zeros((batch, nh, hd, N), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, W - 1, di + 2 * N), dtype=dtype, device=device),
    }


def mamba_decode_step(
    cfg: ModelConfig, p, x: Tensor, state: Dict[str, Tensor]
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """x: (B, 1, D) -> (B, 1, D) and the new state (fresh tensors; ``state``
    is only read).  On a mesh, as the module's docstring says: the new
    state comes laid out as ``state``."""
    if isinstance(x, DTensor):
        return _mamba_decode_mesh(cfg, p, x, state)
    B = x.shape[0]
    di, N, nh, hd = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_head_dim
    zxbcdt = _project(x, p["in_proj"])[:, 0]  # (B, E)
    z, xBC, dt = _split_proj(cfg, zxbcdt)
    window = torch.cat([state["conv"], xBC[:, None, :]], dim=1)  # (B, W, C)
    conv_out = torch.einsum("bwc,wc->bc", window, p["conv_w"]) + p["conv_b"]
    xBC = F.silu(conv_out)
    xs, Bm, Cm = torch.split(xBC, [di, N, N], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])  # (B, nh)
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt * A)  # (B, nh)
    xh = xs.reshape(B, nh, hd)
    # the outer product dt*x (x) B in the input type, then f32, as in JAX
    dBx = ((dt[..., None].to(xh.dtype) * xh)[..., None] * Bm[:, None, None, :]).float()
    h = state["h"].float() * dA[..., None, None] + dBx
    y = torch.matmul(h, Cm.float()[:, None, :, None])[..., 0]  # (B, nh, hd)
    y = y.to(x.dtype) + xh * p["D"][None, :, None].to(xh.dtype)
    y = rms_norm(y.reshape(B, di) * F.silu(z), p["norm"])
    out = _project(y, p["out_proj"]).to(x.dtype)[:, None, :]
    return out, {"h": h, "conv": window[:, 1:, :]}


def _mamba_decode_mesh(cfg: ModelConfig, p, x: DTensor, state: Dict[str, Tensor]):
    mesh = x.device_mesh
    rows = kept_shards(x, (0,))
    M = sharding.axis_sizes(mesh).get("model", 1)
    nh, hd, di, N = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.d_inner, cfg.ssm_state
    h, conv = state["h"], state["conv"]
    conv_p = list(conv.placements)
    whole_conv = [Replicate() if isinstance(pl, Shard) and pl.dim == 2 else pl for pl in conv_p]
    if M == 1 or nh % M:
        # The step whole on each rank's rows; the new state is then laid
        # out as ``state`` (each rank keeps its shard).
        names = list(p)
        h_rows, conv_rows = kept_shards(h, (0,)), kept_shards(conv, (0,))

        def whole(xl, hl, cl, *ws):
            out, new = mamba_decode_step(cfg, dict(zip(names, ws)), xl, {"h": hl, "conv": cl})
            return out, new["h"], new["conv"]

        out, h_new, conv_new = mapped(
            whole, (rows, h_rows, conv_rows),
            (rows, h_rows, conv_rows) + (on_mesh(mesh),) * len(names), None,
            x, h, conv, *(p[n] for n in names))
        return out, {"h": h_new.redistribute(mesh, h.placements),
                     "conv": conv_new.redistribute(mesh, conv_p)}
    k = nh // M
    C = di + 2 * N
    conv_cols = conv.to_local().shape[-1]

    def heads(xl, hl, cl, *ws):
        m = mesh["model"].get_local_rank()
        dl = k * hd
        # z and dt of this rank's heads, and all of x, B and C (the window
        # keeps every channel); the conv of its heads' x and of B and C.
        sl = _heads(cfg, dict(zip(_MIXER, ws)), m, k, whole_xbc=True)
        z, xBC, dt = torch.split(_project(xl, sl["in_proj"])[:, 0], [dl, C, k], dim=-1)
        window = torch.cat([cl, xBC[:, None, :]], dim=1)  # (B, W, C)
        mine = torch.cat([torch.arange(m * dl, (m + 1) * dl, device=xl.device),
                          torch.arange(di, C, device=xl.device)])
        conv_out = torch.einsum("bwc,wc->bc", window[:, :, mine], sl["conv_w"]) + sl["conv_b"]
        xs, Bm, Cm = torch.split(F.silu(conv_out), [dl, N, N], dim=-1)
        dt = F.softplus(dt.float() + sl["dt_bias"])  # (B, k)
        dA = torch.exp(dt * -torch.exp(sl["A_log"]))
        xh = xs.reshape(-1, k, hd)
        dBx = ((dt[..., None].to(xh.dtype) * xh)[..., None] * Bm[:, None, None, :]).float()
        h_new = hl.float() * dA[..., None, None] + dBx
        y = torch.matmul(h_new, Cm.float()[:, None, :, None])[..., 0]  # (B, k, hd)
        y = y.to(xl.dtype) + xh * sl["D"][None, :, None].to(xh.dtype)
        g = (y.reshape(-1, dl) * F.silu(z))[:, None, :]
        c0 = m * conv_cols if conv_cols < C else 0
        return g, h_new, window[:, 1:, c0:c0 + conv_cols]

    h_p = list(h.placements)
    g, h_new, conv_new = mapped(
        heads, (on_mesh(mesh, rows, model=Shard(2)), h_p, conv_p),
        (rows, h_p, whole_conv) + (on_mesh(mesh),) * len(_MIXER), None,
        x, h, conv, *(p[n] for n in _MIXER))
    return _gated_out(p, g, x, rows), {"h": h_new, "conv": conv_new}
