"""Peaks of one NVIDIA H100 and the work of each step and kernel, from shapes.

The peaks are NVIDIA's data sheet's (H100 SXM5, dense, at its 700 W limit),
as ``repro_torch.launch.mesh`` states them.  Operations and bytes are the
least that the step or kernel needs: each input read once, each output
written once, whatever the program reads again.  They are worked out here
from the configuration's shapes and frozen, so that a later change that
fuses or replaces a kernel is read against the same work.
"""

from __future__ import annotations

from typing import Tuple

PEAK_FLOPS = 989e12  # bf16 on the tensor cores, FLOP/s
HBM_BW = 3.35e12  # B/s
BF16, F32 = 2, 4  # bytes


def least_s(flops: float, nbytes: float) -> Tuple[float, str]:
    """The least time of work of ``flops`` and ``nbytes`` on one H100, and
    which bound binds ("operations" or "bytes")."""
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / HBM_BW
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- kernels (the counts of PERF.md's kernel table, from chip_smoke.py) -----
def flash_decode_work(B: int, H: int, K: int, hd: int, lengths) -> Tuple[float, float]:
    """(FLOPs, bytes) of one ``flash_decode`` call in bf16 over a cache of
    ``lengths`` valid keys a row: q read and the output written (B H hd
    each), the valid keys and values read, the lengths (int32)."""
    valid = sum(lengths)
    nbytes = (2 * B * H * hd + 2 * K * hd * valid) * BF16 + 4 * B
    return 4.0 * hd * H * valid, float(nbytes)


def ssd_intra_chunk_work(B: int, S: int, nh: int, hd: int, N: int, Q: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one ``ssd_intra_chunk`` call with bf16 x, B and C
    and f32 decays: x, B, C (once a row, not a head) and the decays read,
    the f32 outputs (y, the chunks' states, the decays' cumulative sums)
    written; the causal products' lower triangles and the state product."""
    nC = S // Q
    nbytes = (B * S * nh * hd + 2 * B * S * N) * BF16 + F32 * B * S * nh \
        + F32 * (B * S * nh * hd + B * nC * nh * hd * N + B * S * nh)
    flops = B * nh * nC * (Q * (Q + 1) * N + Q * (Q + 1) * hd + 2 * Q * N * hd)
    return float(flops), float(nbytes)


# -- whole steps ----------------------------------------------------------------
def _attn_params(c) -> int:
    D, H, K, hd = c.d_model, c.n_heads, c.n_kv_heads, c.head_dim
    return D * H * hd + 2 * D * K * hd + H * hd * D


def _mlp_params(c) -> int:
    return (3 if c.mlp_gated else 2) * c.d_model * c.d_ff


def _ssm_params(c) -> Tuple[int, int]:
    """(matmul weights, other weights) of one Mamba-2 layer: in_proj and
    out_proj; the conv's weight and bias, the gate norm, ln1 (bf16), and
    A_log, D, dt_bias (f32, counted as two bf16 each)."""
    D, di, N, nh, W = c.d_model, c.d_inner, c.ssm_state, c.n_ssm_heads, c.ssm_conv_width
    mat = D * (2 * di + 2 * N + nh) + di * D
    other = (W + 1) * (di + 2 * N) + di + D + 2 * 3 * nh
    return mat, other


def _unembed_params(c) -> int:
    return c.d_model * c.vocab


def weight_bytes(c) -> int:
    """Every weight a step reads once (bf16): the layers', the final norm,
    the unembedding (the tied table's, for a tied model); the embedding's
    rows are the tokens' (counted with them)."""
    if c.family == "ssm":
        mat, other = _ssm_params(c)
        per_layer = mat + other
    else:
        per_layer = _attn_params(c) + _mlp_params(c) + 2 * c.d_model
    return BF16 * (c.n_layers * per_layer + c.d_model + _unembed_params(c))


def decode_step_work(c, B: int, pos: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one decode step of B rows at position ``pos`` (the
    keys already cached): the weights read, each row's embedding row read and
    its f32 logits written; for attention the cached keys and values read
    and the new ones written; for Mamba-2 the f32 SSM state and the conv
    window read and written."""
    D, L, V = c.d_model, c.n_layers, c.vocab
    nbytes = weight_bytes(c) + B * (D * BF16 + V * F32)
    if c.family == "ssm":
        mat, _ = _ssm_params(c)
        di, N, nh, hd, W = c.d_inner, c.ssm_state, c.n_ssm_heads, c.ssm_head_dim, c.ssm_conv_width
        state = nh * hd * N
        nbytes += L * B * 2 * (state * F32 + (W - 1) * (di + 2 * N) * BF16)
        # the projections; the conv; the state's decay, update and read-out
        flops = 2 * B * (L * mat + D * V) + L * B * (2 * W * (di + 2 * N) + 5 * state)
        return float(flops), float(nbytes)
    K, H, hd = c.n_kv_heads, c.n_heads, c.head_dim
    nbytes += L * B * 2 * K * hd * BF16 * (pos + 1)
    flops = (2 * B * (L * (_attn_params(c) + _mlp_params(c)) + D * V)
             + L * B * 4 * H * hd * (pos + 1))
    return float(flops), float(nbytes)


def prefill_work(c, B: int, S: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of the prefill of B prompts of S tokens: the weights
    read, the tokens' embedding rows read, the decode state written (the
    keys and values; the f32 SSM state and the conv tail), the last
    position's f32 logits written; the projections of every token, causal
    attention's pairs, or the chunked SSD's products (their causal lower
    triangles)."""
    D, L, V, T = c.d_model, c.n_layers, c.vocab, B * S
    nbytes = weight_bytes(c) + T * D * BF16 + B * V * F32
    if c.family == "ssm":
        mat, _ = _ssm_params(c)
        di, N, nh, hd, W, Q = (c.d_inner, c.ssm_state, c.n_ssm_heads, c.ssm_head_dim,
                               c.ssm_conv_width, min(c.ssm_chunk, S))
        nbytes += L * B * (nh * hd * N * F32 + (W - 1) * (di + 2 * N) * BF16)
        ssd = (S // Q) * (Q * (Q + 1) * N + nh * (Q * (Q + 1) * hd + 4 * Q * N * hd))
        flops = 2 * T * L * mat + 2 * B * D * V + L * (T * 2 * W * (di + 2 * N) + B * ssd)
        return float(flops), float(nbytes)
    K, H, hd = c.n_kv_heads, c.n_heads, c.head_dim
    nbytes += L * T * 2 * K * hd * BF16
    flops = (2 * T * L * (_attn_params(c) + _mlp_params(c)) + 2 * B * D * V
             + L * B * 4 * H * hd * S * (S + 1) // 2)
    return float(flops), float(nbytes)


def train_flops(c, B: int, S: int) -> float:
    """Model FLOPs of one train step of B rows of S tokens (chip_smoke.py's
    ``train_flops``): 3 x the forward's, the forward 2 a token a matmul
    weight (the layers' and the unembedding's; not the embedding's lookup)
    plus causal attention, 4 H hd a (query, key) pair; recomputation is not
    counted."""
    matmul = c.n_layers * (_attn_params(c) + _mlp_params(c)) + _unembed_params(c)
    attention = c.n_layers * B * 4 * c.n_heads * c.head_dim * S * (S + 1) // 2
    return 3.0 * (2 * matmul * B * S + attention)
