"""Plain f32 forward of Mamba-2 (SSD) as the port runs mamba2-2.7b.

Per layer: RMSNorm; the input projection to [z, x, B, C, dt]; a causal
depthwise conv of width W with bias over [x, B, C], then SiLU;
dt = softplus(dt + dt_bias), A = -exp(A_log); the state-space recurrence
h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T, y_t = h_t C_t, computed in
its chunked (SSD) form in f32 (``ssd``, after the Mamba-2 paper's
``ssd_minimal``), plus D x; RMSNorm of y * silu(z); the output projection
and the residual.  A final RMSNorm and the tied unembedding.  Leaves are
named as the port names its parameters.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from perfbench.reference.common import Tensor, Weights, mm, rms_norm, silu

CHUNK = 64  # the reference's own chunk: any length gives the same sums


def _segsum(a: Tensor) -> Tensor:
    """a (..., T) -> (..., T, T): the sum of a[j+1..i] on and below the
    diagonal (i >= j), -inf above; summed term by term, not as a difference
    of cumulative sums."""
    T = a.shape[-1]
    below = torch.ones(T, T, dtype=torch.bool, device=a.device).tril(-1)
    out = torch.cumsum(a[..., None].expand(*a.shape, T).masked_fill(~below, 0.0), dim=-2)
    return out.masked_fill(~below.logical_or(torch.eye(T, dtype=torch.bool, device=a.device)),
                           float("-inf"))


def ssd(x: Tensor, a: Tensor, B: Tensor, C: Tensor, chunk: int = CHUNK) -> Tensor:
    """y (R, T, nh, hd) of h_t = exp(a_t) h_{t-1} + x_t B_t^T, y_t = h_t C_t,
    from h = 0; x (R, T, nh, hd) already times dt, a (R, T, nh) = dt A,
    B and C (R, T, N) shared by the heads."""
    R, T, nh, hd = x.shape
    pad = (-T) % chunk
    if pad:  # trailing zeros change nothing before them
        x, a = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(a, (0, 0, 0, pad))
        B, C = F.pad(B, (0, 0, 0, pad)), F.pad(C, (0, 0, 0, pad))
    n = (T + pad) // chunk
    x = x.reshape(R, n, chunk, nh, hd)
    B, C = B.reshape(R, n, chunk, -1), C.reshape(R, n, chunk, -1)
    a = a.reshape(R, n, chunk, nh).permute(0, 3, 1, 2)  # (R, nh, n, chunk)
    a_cum = torch.cumsum(a, dim=-1)
    L = torch.exp(_segsum(a))  # (R, nh, n, chunk, chunk)
    y = torch.einsum("rcln,rcsn,rhcls,rcshp->rclhp", C, B, L, x)
    decay = torch.exp(a_cum[..., -1:] - a_cum)  # (R, nh, n, chunk)
    states = torch.einsum("rcln,rhcl,rclhp->rchpn", B, decay, x)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    across = torch.exp(_segsum(F.pad(a_cum[..., -1], (1, 0))))  # (R, nh, n+1, n+1)
    states = torch.einsum("rhzc,rchpn->rzhpn", across, states)[:, :-1]  # entering each chunk
    y = y + torch.einsum("rcln,rchpn,rhcl->rclhp", C, states, torch.exp(a_cum))
    return y.reshape(R, n * chunk, nh, hd)[:, :T]


def _conv(u: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """Causal depthwise conv: u (R, T, Ch), w (W, Ch), b (Ch)."""
    W, T = w.shape[0], u.shape[1]
    p = F.pad(u, (0, 0, W - 1, 0))
    return sum(p[:, j:j + T] * w[j] for j in range(W)) + b


def layer(m: Dict, W: Weights, i: int, x: Tensor, quant: Optional[str] = None) -> Tensor:
    D, N, hd, eps = m["d_model"], m["ssm_state"], m["ssm_head_dim"], m["norm_eps"]
    di = m["ssm_expand"] * D
    nh = di // hd
    R, T, _ = x.shape
    h = rms_norm(x, W("blocks.ln1", i), eps)
    z, xbc, dt = torch.split(mm(h, W("blocks.mamba.in_proj", i), quant), [di, di + 2 * N, nh], -1)
    xbc = silu(_conv(xbc, W("blocks.mamba.conv_w", i), W("blocks.mamba.conv_b", i)))
    xs, B, C = torch.split(xbc, [di, N, N], -1)
    dt = F.softplus(dt + W("blocks.mamba.dt_bias", i))  # (R, T, nh)
    A = -torch.exp(W("blocks.mamba.A_log", i))
    xs = xs.reshape(R, T, nh, hd)
    y = ssd(xs * dt[..., None], dt * A, B, C) + xs * W("blocks.mamba.D", i)[:, None]
    y = rms_norm(y.reshape(R, T, di) * silu(z), W("blocks.mamba.norm", i), eps)
    return x + mm(y, W("blocks.mamba.out_proj", i), quant)


def logits(m: Dict, W: Weights, tokens: Tensor, start: int, quant: Optional[str] = None) -> Tensor:
    """The f32 logits (R, T - start, V) at positions start..T-1 of
    ``tokens`` (R, T)."""
    x = W("embed", None)[tokens]
    for i in range(m["n_layers"]):
        x = layer(m, W, i, x, quant)
    x = rms_norm(x[:, start:], W("final_norm", None), m["norm_eps"])
    return mm(x, W("embed", None).T, quant)
