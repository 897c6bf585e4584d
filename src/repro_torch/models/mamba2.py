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

On a mesh (x a DTensor: prefill and decode when serving, and the tp
training policy of the SSM and hybrid families) x keeps its split of the
batch over ('pod','data') and its sequence is gathered (the SSD scan runs
over the whole sequence, and the causal conv reaches across a sequence
shard's edge), and the heads ride 'model'.  in_proj's output dim
concatenates z, x, B, C and dt; its tp spec splits it evenly over 'model',
which does not follow the heads.  So each rank projects its token rows
onto its shard of in_proj's columns (column-parallel: the weight is never
gathered over 'model'), and one all-to-all over 'model' (``_Columns``)
hands each rank its heads' z and dt and its slice of the conv channels
[x, B, C] as the conv weight's spec splits them evenly; each rank runs the
depthwise conv on its channels with its shard of the conv weight, and a
second all-to-all hands it its heads' x and B and C whole (one group).  It
runs the SSD and the gate on its heads.  The gated norm's mean over the
whole d_inner is reduced over 'model'; out_proj takes each rank's rows of
d_inner (row-parallel), a partial sum over 'model' reduced into x's
layout.  The two all-to-alls move activations (tokens x in_proj's
columns), not weights; in the backward they carry the gradients back.
Prefill's conv tail (the last W-1 pre-conv activations) is each rank's
channels of the conv's input, laid out as the decode state's conv window.

The decode step on a mesh (serving) runs the same way on one token: the
conv window's spec splits its channels as the conv weight does, so each
rank keeps its shard of the window and never gathers it, and updates its
heads' SSM state (its shard, laid out by ``decode_state_specs``).

Where 'model' has one rank, or does not divide the heads, the mixer runs
whole on each rank's rows, its weights gathered at use (over 'data'; a
'model' of one rank moves nothing), which the tp specs allow only where
they do not split in_proj and the conv weight over a 'model' of several
ranks; else it raises.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..kernels import ops as kops
from .config import ModelConfig
from .layers import (_kernel_impl, _normal, _project, kept_shards, local_with_replicated, mapped,
                     model_dim, on_mesh, partial_where_sharded, rms_norm, tp_dim)

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


def _mixer(cfg: ModelConfig, p, x: Tensor, h0: Optional[Tensor], nh: int,
           cols: Optional["_Columns"] = None):
    """in_proj, the causal conv, the SSD and the gate over ``nh`` heads:
    (y * silu(z) (B, S, nh * hd) in x's type, the final state, the pre-conv
    x, B, C).  With ``cols`` (on a mesh) ``p`` holds this rank's shards and
    ``cols`` moves the projection's columns between the ranks' layouts."""
    B, S, D = x.shape
    N, hd = cfg.ssm_state, cfg.ssm_head_dim
    di = nh * hd
    zxbcdt = _project(x, p["in_proj"])
    if cols is None:
        z, xBC_pre, dt = torch.split(zxbcdt, [di, di + 2 * N, nh], dim=-1)
    else:
        z, xBC_pre, dt = cols.to_mixer(zxbcdt)
    xBC = F.silu(_conv1d(xBC_pre, p["conv_w"], p["conv_b"]))
    if cols is None:
        xs, Bm, Cm = torch.split(xBC, [di, N, N], dim=-1)
    else:
        xs, Bm, Cm = cols.to_heads(xBC)
    dt = F.softplus(dt.float() + p["dt_bias"])  # (B, S, nh)
    A = -torch.exp(p["A_log"])  # (nh,)
    xh = xs.reshape(B, S, nh, hd)
    xdt, a = xh * dt[..., None].to(xh.dtype), dt * A
    ssd = kops.ssd if _kernel_impl(cfg, xdt, a, Bm, Cm) else ssd_chunked
    y, h = ssd(xdt, a, Bm, Cm, cfg.ssm_chunk, h0)
    y = y + xh * p["D"][None, None, :, None].to(xh.dtype)
    y = y.reshape(B, S, di).to(x.dtype)
    return y * F.silu(z), h, xBC_pre


def _pieces(have, want) -> list:
    """The (start, stop) ranges of ``want`` (sorted, disjoint) inside the
    one range ``have``, adjacent ones joined."""
    out = []
    for a, b in want:
        lo, hi = max(a, have[0]), min(b, have[1])
        if lo < hi and out and out[-1][1] == lo:
            out[-1] = (out[-1][0], hi)
        elif lo < hi:
            out.append((lo, hi))
    return out


def _regroup(t: Tensor, src, dst, me: int, group) -> Tensor:
    """The columns ``dst[me]`` (sorted, disjoint (start, stop) ranges) of a
    column axis, in order, from ``t``, whose last dim holds this rank's
    columns ``src[me]``: rank r holds the one range ``src[r]``, each rank's
    after the last rank's.  One all-to-all over ``group`` (a (mesh, dim)
    pair) where a rank needs columns of another (the result contiguous: the
    SSD kernel takes unit-stride rows); else local slices."""
    lo0 = src[me][0]

    def local(ranges):
        return [t[..., a - lo0:b - lo0] for a, b in ranges]

    mine = _pieces(src[me], dst[me])
    if sum(b - a for a, b in mine) == sum(b - a for a, b in dst[me]):
        parts = local(mine)
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
    send = [_pieces(src[me], want) for want in dst]
    recv = [_pieces(have, dst[me]) for have in src]
    lead = t.dim() - 1
    flat = torch.cat([p for ranges in send for p in local(ranges)], dim=-1)
    flat = flat.movedim(lead, 0).contiguous()
    a2a = (funcol.all_to_all_single_autograd if torch.is_grad_enabled() and t.requires_grad
           else funcol.all_to_all_single)
    out = a2a(flat, [sum(b - a for a, b in r) for r in recv],
              [sum(b - a for a, b in r) for r in send], group)
    return funcol.wait_tensor(out).movedim(0, lead).contiguous()


class _Columns:
    """The layouts of in_proj's output columns [z (di), x (di), B (N), C
    (N), dt (nh)] on the M ranks of 'model' (this one ``me``): in_proj's
    shard (its E columns split evenly, or whole where its spec keeps them
    whole), the mixer's (rank r's heads' z and dt, and its slice of the
    conv channels [x, B, C] as the conv weight's spec splits them: evenly,
    or whole), and the heads' (rank r's heads' x, and B and C whole)."""

    def __init__(self, cfg: ModelConfig, M: int, me: int, e_split: bool, c_split: bool,
                 group):
        di, N, nh, hd = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_head_dim
        E, C, k = 2 * di + 2 * N + nh, di + 2 * N, nh // M
        dl = k * hd
        self.me, self.group, self.k, self.dl, self.N = me, group, k, dl, N
        self.proj = [(r * E // M, (r + 1) * E // M) if e_split else (0, E) for r in range(M)]
        self.conv = [(r * C // M, (r + 1) * C // M) if c_split else (0, C) for r in range(M)]
        self.mixer = [[(r * dl, (r + 1) * dl), (di + self.conv[r][0], di + self.conv[r][1]),
                       (2 * di + 2 * N + r * k, 2 * di + 2 * N + (r + 1) * k)] for r in range(M)]
        self.heads = [[(r * dl, (r + 1) * dl), (di, C)] for r in range(M)]

    def conv_channels(self) -> slice:
        """This rank's conv channels: the slice of the conv weight's and
        bias's last dim."""
        return slice(*self.conv[self.me])

    def to_mixer(self, zx: Tensor):
        """in_proj's output (this rank's columns) -> (z, x B C, dt) of the
        mixer's layout."""
        got = _regroup(zx, self.proj, self.mixer, self.me, self.group)
        n = self.conv[self.me][1] - self.conv[self.me][0]
        return torch.split(got, [self.dl, n, self.k], dim=-1)

    def to_heads(self, xbc: Tensor):
        """The conv's output (this rank's channels) -> (x, B, C) of its
        heads."""
        got = _regroup(xbc, self.conv, self.heads, self.me, self.group)
        return torch.split(got, [self.dl, self.N, self.N], dim=-1)


_MIXER = ("in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias")


class _MeshMixer:
    """The mixer's layout on a mesh for x's ``rows`` (its batch split): the
    weights' placements as each rank uses them (in_proj and the conv weight
    on their 'model' shards, the others whole), their gradients', and each
    rank's ``_Columns`` and slices of the replicated weights."""

    def __init__(self, cfg: ModelConfig, p, mesh, rows):
        self.cfg, self.mesh = cfg, mesh
        self.mi = model_dim(mesh)
        self.M = 1 if self.mi is None else mesh.size(self.mi)
        split = {n: tp_dim(p[n]) == 1 for n in ("in_proj", "conv_w")}
        nh = cfg.n_ssm_heads
        self.place = None  # the mixer whole on each rank
        if nh % self.M and any(split.values()):
            raise NotImplementedError(
                f"Mamba-2 on a mesh: 'model' ({self.M}) does not divide the {nh} heads, and "
                "the tp specs split in_proj or the conv weight over it")
        if nh % self.M or self.M == 1:
            return
        self.split = split
        grads = partial_where_sharded(rows)
        self.place = tuple(on_mesh(mesh, model=Shard(1)) if split.get(n) else on_mesh(mesh)
                           for n in _MIXER)
        self.grads = tuple(on_mesh(mesh, grads, model=Shard(1) if split.get(n) else Partial())
                           for n in _MIXER)

    def local(self, ws):
        """(this rank's ``_Columns``, its mixer weights by name: its shards
        of in_proj and the conv weight, its heads' and channels' slices of
        the others)."""
        me = 0 if self.mi is None else self.mesh.get_local_rank(self.mi)
        cols = _Columns(self.cfg, self.M, me, self.split["in_proj"], self.split["conv_w"],
                        (self.mesh, self.mi))
        w = dict(zip(_MIXER, ws))
        heads = slice(me * cols.k, (me + 1) * cols.k)
        w.update(conv_b=w["conv_b"][cols.conv_channels()], A_log=w["A_log"][heads],
                 D=w["D"][heads], dt_bias=w["dt_bias"][heads])
        return cols, w


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
    if h0 is not None:
        raise NotImplementedError("mamba_apply on a mesh starts from a zero state (h0=None)")
    mesh = x.device_mesh
    rows = kept_shards(x, (0,))  # the batch's split kept, the sequence gathered
    mm = _MeshMixer(cfg, p, mesh, rows)
    if mm.place is None:
        # The mixer whole on each rank's rows (nothing split over 'model').
        names = list(p)

        def whole(xl, *ws):
            return mamba_apply(cfg, dict(zip(names, ws)), xl,
                               return_conv_tail=return_conv_tail)

        return local_with_replicated(whole, x, rows, *(p[n] for n in names),
                                     out_placements=(rows,) * (3 if return_conv_tail else 2))
    # The heads over 'model': each rank runs its nh / M heads.  A rank's
    # heads use all of x and of B and C: x's gradient is a partial sum over
    # 'model'.
    W, S = cfg.ssm_conv_width, x.shape[1]

    def heads(xl, *ws):
        cols, w = mm.local(ws)
        g, h, xbc_pre = _mixer(cfg, w, xl, None, cols.k, cols)
        return g, h, xbc_pre[:, S - (W - 1):]

    tail_p = on_mesh(mesh, rows, model=Shard(2) if mm.split["conv_w"] else Replicate())
    g, h, tail = mapped(heads, (on_mesh(mesh, rows, model=Shard(2)),
                                on_mesh(mesh, rows, model=Shard(1)), tail_p),
                        (rows,) + mm.place,
                        (on_mesh(mesh, rows, model=Partial()),) + mm.grads,
                        x, *(p[n] for n in _MIXER))
    out = _gated_out(p, g, x)
    return (out, h, tail) if return_conv_tail else (out, h)


def _gated_out(p, g: DTensor, x: DTensor) -> DTensor:
    """The gated norm of the heads' outputs ``g`` (their d_inner over
    'model') over the whole d_inner (its mean reduced over 'model'), then
    out_proj on each rank's rows of it: a partial sum over 'model', reduced
    into x's layout."""
    return _project(rms_norm(g, p["norm"]), p["out_proj"], like=x).to(x.dtype)


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
    h, conv = state["h"], state["conv"]
    h_p, conv_p = list(h.placements), list(conv.placements)
    mm = _MeshMixer(cfg, p, mesh, rows)
    if mm.place is None:
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
        return out, {"h": h_new.redistribute(mesh, h_p),
                     "conv": conv_new.redistribute(mesh, conv_p)}
    hd = cfg.ssm_head_dim

    def heads(xl, hl, cl, *ws):
        cols, w = mm.local(ws)
        k, dl = cols.k, cols.dl
        # z and dt of this rank's heads and its channels of x, B and C; the
        # conv of those channels over its shard of the window; then its
        # heads' x, and B and C whole.
        z, xbc, dt = cols.to_mixer(_project(xl, w["in_proj"])[:, 0])
        window = torch.cat([cl, xbc[:, None, :]], dim=1)  # (B, W, channels)
        conv_out = torch.einsum("bwc,wc->bc", window, w["conv_w"]) + w["conv_b"]
        xs, Bm, Cm = cols.to_heads(F.silu(conv_out))
        dt = F.softplus(dt.float() + w["dt_bias"])  # (B, k)
        dA = torch.exp(dt * -torch.exp(w["A_log"]))
        xh = xs.reshape(-1, k, hd)
        dBx = ((dt[..., None].to(xh.dtype) * xh)[..., None] * Bm[:, None, None, :]).float()
        h_new = hl.float() * dA[..., None, None] + dBx
        y = torch.matmul(h_new, Cm.float()[:, None, :, None])[..., 0]  # (B, k, hd)
        y = y.to(xl.dtype) + xh * w["D"][None, :, None].to(xh.dtype)
        g = (y.reshape(-1, dl) * F.silu(z))[:, None, :]
        return g, h_new, window[:, 1:]

    g, h_new, conv_new = mapped(
        heads, (on_mesh(mesh, rows, model=Shard(2)), h_p, conv_p),
        (rows, h_p, conv_p) + mm.place, None,
        x, h, conv, *(p[n] for n in _MIXER))
    return _gated_out(p, g, x), {"h": h_new, "conv": conv_new}
