#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run on any fault:

1. Device and toolchain: the card's name and power limit, the torch, CUDA
   and nvcc versions; builds the CUDA kernels from ``src/repro_torch/csrc``
   and prints each ``flash_prefill``, ``flash_decode`` and
   ``ssd_intra_chunk`` kernel's registers, spills (from ptxas's report) and
   shared memory; fails if the bf16 SSD kernel spills at the served
   models' sizes.
2. Kernels: holds each hand-written kernel against its plain PyTorch version
   on the card at the main paths' shapes (and at a window + softcap case, a
   ragged-S case, other head sizes, prompts shorter than an SSD chunk and
   the smoke configs' SSD sizes), and times both, the bound and one library
   call where there is one (decode cold, each call on the next of enough
   copies of the cache to exceed twice the L2, and warm); holds ``ops.ssd`` (the SSD kernel plus its
   recurrence glue) against the model's plain ``ssd_chunked``.  The
   ``{"kernels": [...]}`` line, printed after phase 3, has one row per
   kernel: the check, times, bound and launches at the first (path, shape)
   that ran it, and the same for each other (path, shape) under
   ``other_paths``.
3. Slices: serves stablelm-12b, mamba2-2.7b, zamba2-1.2b,
   seamless-m4t-large-v2 (encoder-decoder), grok-1 and llama4-scout (MoE,
   at a stated cut of their depth) at their published widths (random
   weights from a seed, bf16) through ``Engine.generate``, each with every
   launch count set to 0 just before and read just after, checks that
   every attention and SSD call of prefill and decode launched its kernel
   (and at which shapes), and holds the logits against a run of the same
   weights on the plain versions, teacher-forced on the same tokens (for
   MoE also the share of routing choices on which the two runs differ);
   then repeats that comparison with the same draws in f32.
4. Rates: prefill ms, decode ms per step and generated tokens per second,
   and a profile of each model's prefill and decode, read by
   ``launch.trace_analysis.read_profile``: the device's busy share, the
   kernels that take the most, and each wrapper's launches as the host
   counts them and as the device trace shows them.
5. Training (``repro_torch.train``, plain PyTorch with autograd, as the
   reference trains): (a) each family's smoke config trained in f32 on the
   card against the same steps on the CPU; (b) stablelm-12b at its
   published widths, 2 layers, one bf16 step against the f32 step on the
   same masters; (c) the same at 8 of 40 layers, ten steps and one with
   ``microbatches=2``: the first loss near its reckoning, every step a
   descent on its batch, the last loss below the first; ms a step, tokens
   per second, model FLOP/s against the bf16 peak, peak memory, the
   optimizer's share and the device's busy share from a profiled step;
   (d) no kernel launches during any of it.
6. Elasticity (``repro_torch.coord``): the 8-layer stablelm of phase 5
   trained by ``ElasticTrainer`` under the Matchmaker-MultiPaxos control
   plane through a scale-up, a scale-down, a failover and a restore of the
   consensus-committed checkpoint; gates: the ledger's safety, no stall,
   the epochs and pod sets of the schedule, each activation under 5
   simulated ms, one durable checkpoint at step 10 restored bit for bit
   (per-tensor f64 sums), the replayed step's loss, falling losses, no
   kernel launch; readings: ms/step by epoch and right after each change,
   the control plane's host ms per step, each change's wall ms, the
   checkpoint's GB, seconds and GB/s.
7. Launch tooling (``repro_torch.launch``): (a) in every profiled window of
   phase 4 the device trace shows each wrapper's kernels launched as often
   as the host counted and ``SLICES`` says (stablelm: 40 ``flash_prefill``
   a prefill and 40 ``flash_decode`` a decode step; mamba2: 64
   ``ssd_intra_chunk`` a prefill); (b) the dry-run's bytes at one device,
   reckoned on meta, equal the live tensors of phases 3 and 5 (each
   slice's parameters and decode state, the 8-layer training state),
   printed beside the allocator's readings; (c) the roofline of stablelm's
   decode step from ``trace_analysis.count``, beside its measured ms/step.
   The H100's constants (bounds, peaks, L2) are ``launch.mesh``'s.
8. Testbed (``repro_torch.core``): (a) the 8-layer stablelm of phase 5
   trained by ``ElasticTrainer`` with the heartbeat failure detector and a
   nemesis schedule on the control plane: a partition of the detector from
   pod1's acceptors shorter than the confirmation window, a heal, then a
   kill -9 of pod1's acceptors; gates: no failover or epoch before the
   crash, exactly one failover (pod1 to the spare pod3) in the step the
   reckoning beside ``FAILOVER`` gives, the trainer's pods those of the
   ledger, no stall, safety and no nemesis violation, the activation,
   falling losses, no kernel launch, and the failover's step and the next
   within ``STEP_RATIO_MAX`` of their epoch's median; readings: ms/step by
   epoch, the detection delay in simulated ms and in steps, the control
   plane's host ms a step, the nemesis event log.  (b) Every catalog
   scenario on the simulator, one over TCP sockets and one over OS
   processes (each worker's command line names ``repro_torch``), and the
   model checker: single-decree with a crash budget of 2 complete and safe,
   the mutant's violation found; wall seconds, slots chosen, states.

The last line is ``{"ok": true, "device": {...}}``.  The script exits with
a non-zero code, and prints no result, when no CUDA device is present.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.launch.mesh import HBM_BW, L2_BYTES, PEAK_FLOPS  # noqa: E402  the H100's

TOL = {"float32": 2e-4, "bfloat16": 3e-2}  # as tests/kernels/test_kernels.py
# The SSD kernel's outputs are f32 in either input type, and with bf16
# inputs its products are exact (C B^T on the tensor cores with f32
# accumulation, the rest on the CUDA cores in f32), so it differs from the
# plain version only in the order of f32 sums: 1.2e-4 max abs at mamba2's
# shape on an H100.  bf16 is held at 1e-3 * (1 + |want|), about 8x that
# reading; rounding the decayed scores to bf16 before their product with X
# would add ~2^-9 relative to every term, and fails it.
SSD_TOL = {"float32": 2e-4, "bfloat16": 1e-3}
BF16_STEP = 2.0 ** -7  # one bf16 rounding step, relative to the value


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time per call.  A spin kernel holds the device while the host
    queues the timed calls, so host launch overhead is not counted.  ``fn``
    may be a list of calls on copies of the inputs, taken in turn (cold
    timing): the warm-up then makes one full turn, so every timed call finds
    its copy last touched a whole turn earlier."""
    import torch

    calls = fn if isinstance(fn, list) else [fn]
    if len(calls) > 1:
        warmup = len(calls)
    for i in range(warmup):
        calls[i % len(calls)]()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)  # ~0.1 s at the H100's clock
    start.record()
    for i in range(iters):
        calls[i % len(calls)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def close(out, want, dtype, tol=None, step=0.0) -> float:
    """Max abs error; raises unless |out - want| <= tol * (1 + |want|) +
    step * |want| (tol by default that of TOL for the dtype; step the
    relative size of a rounding step both sides took after their sums)."""
    import torch

    tol = TOL[dtype_name(dtype)] if tol is None else tol
    diff = (out.float() - want.float()).abs()
    if not torch.isfinite(out.float()).all():
        raise AssertionError("kernel output is not finite")
    bad = diff > tol * (1 + want.float().abs()) + step * want.float().abs()
    if bad.any():
        raise AssertionError(f"max abs err {diff.max().item():.3e} exceeds tol {tol}")
    return diff.max().item()


def bound_ms(bytes_moved: float, flops: float, dtype) -> tuple:
    t_bytes = bytes_moved / HBM_BW * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name(dtype)] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def prefill_case(gen, B, Sq, H, K, hd, dtype, *, Sk=None, causal=True, window=None,
                 softcap=None, measure=False):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref

    Sk = Sk or Sq
    dev = "cuda"
    q, k, v = (torch.randn(*shape, hd, generator=gen, device=dev).to(dtype)
               for shape in [(B, Sq, H), (B, Sk, K), (B, Sk, K)])
    scale = hd ** -0.5
    kw = dict(scale=scale, causal=causal, window=window, softcap=softcap)

    def kernel():
        return ops.flash_attention(q, k, v, **kw)

    def plain():
        return ref.flash_attention_ref(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), **kw
        ).transpose(1, 2)

    err = close(kernel(), plain(), dtype)
    torch.cuda.synchronize()
    row = dict(shape=f"B={B} Sq={Sq} Sk={Sk} H={H} K={K} hd={hd}", dtype=dtype_name(dtype),
               causal=causal, window=window, softcap=softcap, max_abs_err=err,
               tol=TOL[dtype_name(dtype)], key=("flash_prefill", (B, Sq, Sk, H, K, hd, causal)))
    if not measure:
        return row
    qp = torch.arange(Sq, device=dev)[:, None]
    kp = torch.arange(Sk, device=dev)[None, :]
    ok = torch.ones(Sq, Sk, dtype=torch.bool, device=dev)
    if causal:
        ok &= qp >= kp
    if window is not None:
        ok &= (qp - kp) < window
    pairs = int(ok.sum().item()) * B * H
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    b_ms, b_by = bound_ms(nbytes, 4 * hd * pairs, dtype)

    def library():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=causal, scale=scale, enable_gqa=True,
        )

    lib_ms = time_ms(library) if window is None and softcap is None else None
    row.update(ms=time_ms(kernel), plain_ms=time_ms(plain), bound_ms=b_ms, bound_by=b_by,
               library_ms=lib_ms)
    return row


def cold_copies(nbytes: int) -> int:
    """Copies of inputs of ``nbytes`` that together exceed twice the L2, so
    that a call taking them in turn finds its copy out of L2, as a decode
    step finds each layer's cache (the whole model's weights have streamed
    through L2 since that layer's last step)."""
    return math.ceil(2 * L2_BYTES / nbytes) + 1


def decode_case(gen, B, S, H, K, hd, dtype, lengths, *, window=None, softcap=None,
                measure=False):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.decode_attention import device_plan

    dev = "cuda"
    q = torch.randn(B, 1, H, hd, generator=gen, device=dev).to(dtype)
    kc = torch.randn(B, S, K, hd, generator=gen, device=dev).to(dtype)
    vc = torch.randn(B, S, K, hd, generator=gen, device=dev).to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    scale = hd ** -0.5
    kw = dict(scale=scale, window=window, softcap=softcap)

    def kernel(kc=kc, vc=vc):
        return ops.decode_attention(q, kc, vc, lens, **kw)

    def plain(kc=kc, vc=vc):
        return ref.decode_attention_ref(
            q[:, 0], kc.transpose(1, 2), vc.transpose(1, 2), lens, **kw
        )[:, None]

    err = close(kernel(), plain(), dtype)
    torch.cuda.synchronize()
    row = dict(shape=f"B={B} S={S} H={H} K={K} hd={hd} lengths={list(lengths)}",
               dtype=dtype_name(dtype), window=window, softcap=softcap, max_abs_err=err,
               tol=TOL[dtype_name(dtype)], key=("flash_decode", (B, S, H, K, hd)))
    if not measure:
        return row
    valid = sum(min(n, window) if window else n for n in lengths)
    nbytes = (2 * q.numel() + 2 * K * hd * valid) * q.element_size() + 4 * B
    b_ms, b_by = bound_ms(nbytes, 4 * hd * (H // K) * K * valid, dtype)
    pos = torch.arange(S, device=dev)[None, :]
    mask = (pos < lens[:, None])
    if window:
        mask &= pos >= lens[:, None] - window
    mask = mask[:, None, None, :]

    def library(kc=kc, vc=vc):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2),
            attn_mask=mask, scale=scale, enable_gqa=True,
        )

    # Cold: each call takes the next of n copies of the cache (n * the
    # cache > 2 * L2), so it reads the cache from HBM as the bound assumes;
    # warm: the same cache every call, from L2.
    n = cold_copies(2 * kc.numel() * kc.element_size())
    copies = [(kc, vc)] + [(kc.clone(), vc.clone()) for _ in range(n - 1)]

    def turns(fn):
        return [lambda c=c: fn(*c) for c in copies]

    row.update(plan=device_plan(q.device, dtype, B, K, H // K, S, hd, window)._asdict())
    row.update(ms=time_ms(turns(kernel)), plain_ms=time_ms(turns(plain)), bound_ms=b_ms,
               bound_by=b_by, library_ms=time_ms(turns(library)) if softcap is None else None,
               ms_warm=time_ms(kernel), plain_ms_warm=time_ms(plain),
               library_ms_warm=time_ms(library) if softcap is None else None, cold_copies=n)
    del copies
    return row


def ssd_inputs(gen, B, S, nh, hd, N, dtype):
    """x (B,S,nh,hd); log decays a (B,S,nh) f32 as the model makes them
    (softplus'd dt times -exp(A_log), A in [1, 16]); B and C as the strided
    column slices of an xBC tensor (B, S, nh*hd + 2N), as the model hands
    them to the kernel."""
    import torch
    import torch.nn.functional as F

    dev = "cuda"
    x = torch.randn(B, S, nh, hd, generator=gen, device=dev).to(dtype)
    dt = F.softplus(torch.randn(B, S, nh, generator=gen, device=dev) - 4.0)
    a = dt * -torch.linspace(1.0, 16.0, nh, device=dev)
    xbc = (torch.randn(B, S, nh * hd + 2 * N, generator=gen, device=dev) * 0.3).to(dtype)
    return x, a, xbc[..., nh * hd : nh * hd + N], xbc[..., nh * hd + N :]


def ssd_case(gen, B, S, nh, hd, N, Q, dtype, measure=False):
    import torch
    from repro_torch.kernels import ops, ref

    x, a, Bm, Cm = ssd_inputs(gen, B, S, nh, hd, N, dtype)
    nC = S // Q

    def kernel():
        return ops.ssd_intra_chunk(x, a, Bm, Cm, chunk=Q)

    def plain():
        return ref.ssd_intra_chunk_ref(
            x.reshape(B, nC, Q, nh, hd).permute(0, 3, 1, 2, 4),
            a.reshape(B, nC, Q, nh).permute(0, 3, 1, 2),
            Bm.reshape(B, 1, nC, Q, N).expand(B, nh, nC, Q, N),
            Cm.reshape(B, 1, nC, Q, N).expand(B, nh, nC, Q, N))

    tol = SSD_TOL[dtype_name(dtype)]
    err = max(close(g, w, dtype, tol) for g, w in zip(kernel(), plain()))
    torch.cuda.synchronize()
    row = dict(shape=f"B={B} S={S} nh={nh} hd={hd} N={N} Q={Q}", dtype=dtype_name(dtype),
               max_abs_err=err, tol=tol, key=("ssd_intra_chunk", (B, S, nh, hd, N)))
    if not measure:
        return row
    # Each input read once (B and C once per batch row, not per head), each
    # f32 output written once; operations of the causal products, the lower
    # triangle i >= j of C B^T and of its product with X (Q(Q+1)/2 pairs
    # each), and the state product.
    nbytes = (x.numel() + 2 * B * S * N) * x.element_size() + 4 * a.numel() \
        + 4 * (B * S * nh * hd + B * nC * nh * hd * N + B * S * nh)
    flops = B * nh * nC * (Q * (Q + 1) * N + Q * (Q + 1) * hd + 2 * Q * N * hd)
    b_ms, b_by = bound_ms(nbytes, flops, dtype)
    # No single PyTorch call computes this function: library_ms is null.
    row.update(ms=time_ms(kernel), plain_ms=time_ms(plain), bound_ms=b_ms, bound_by=b_by,
               library_ms=None, bytes=nbytes, flops=flops)
    return row


def ssd_ops_case(gen, B, S, nh, hd, N, Q, dtype):
    """ops.ssd (kernel + recurrence glue) against the model's plain
    ssd_chunked, from a nonzero initial state."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models.mamba2 import ssd_chunked

    x, a, Bm, Cm = ssd_inputs(gen, B, S, nh, hd, N, dtype)
    h0 = torch.randn(B, nh, hd, N, generator=gen, device="cuda") * 0.5
    y, h = ops.ssd(x, a, Bm, Cm, Q, h0)
    wy, wh = ssd_chunked(x, a, Bm, Cm, Q, h0)
    if y.dtype != x.dtype or h.dtype != torch.float32:
        raise AssertionError(f"ops.ssd returned {y.dtype} {h.dtype}")
    # y is cast to x's type after the f32 sums, so in bf16 the two sides may
    # round one step apart; the f32 state is held at the kernel's tolerance.
    tol, step = SSD_TOL[dtype_name(dtype)], BF16_STEP if dtype == torch.bfloat16 else 0.0
    row = dict(op="ops.ssd vs ssd_chunked",
               shape=f"B={B} S={S} nh={nh} hd={hd} N={N} chunk={Q}",
               dtype=dtype_name(dtype), h0="nonzero",
               max_abs_err_y=close(y, wy, dtype, tol, step),
               max_abs_err_state=close(h, wh, dtype, tol), tol=tol, y_rounding_step=step)
    torch.cuda.synchronize()
    return row


def ssd_phase():
    """Checks the SSD kernel at mamba2-2.7b's main-path shape (B=4, S=1024,
    80 heads of 64, N=128, Q=256) in bf16 and f32, zamba2-1.2b's (64 heads,
    N=64), prompts shorter than a chunk and the smoke configs' sizes;
    returns the bf16 rows of the two paths' shapes, a list per (kernel,
    path)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1)
    bf16, f32 = torch.bfloat16, torch.float32
    main = {"mamba2_2p7b": ssd_case(gen, 4, 1024, 80, 64, 128, 256, bf16, measure=True),
            "zamba2_1p2b": ssd_case(gen, 4, 1024, 64, 64, 64, 256, bf16, measure=True)}
    extra = [
        ssd_case(gen, 4, 1024, 80, 64, 128, 256, f32, measure=True),
        ssd_case(gen, 4, 1024, 64, 64, 64, 256, f32),
        ssd_case(gen, 2, 100, 8, 64, 128, 100, bf16),  # a 100-token prompt: Q = 100
        ssd_case(gen, 2, 200, 8, 64, 64, 100, f32),
        ssd_case(gen, 2, 3, 4, 64, 128, 1, bf16),  # Q = 1
        ssd_case(gen, 2, 64, 8, 16, 16, 16, bf16),  # the smoke configs
        ssd_case(gen, 2, 64, 8, 16, 16, 16, f32),
        ssd_case(gen, 1, 96, 4, 16, 128, 32, f32),
        ssd_case(gen, 1, 128, 4, 64, 16, 64, bf16),
        ssd_ops_case(gen, 4, 1024, 80, 64, 128, 256, bf16),
        ssd_ops_case(gen, 2, 1024, 64, 64, 64, 256, f32),
        ssd_ops_case(gen, 4, 100, 80, 64, 128, 256, bf16),  # shorter than the chunk
    ]
    for row in [*main.values(), *extra]:
        log("kernel check:", json.dumps(row))
    return {("ssd_intra_chunk", arch): [row] for arch, row in main.items()}


def kernel_phase(B=4, S=512, H=32, K=8, hd=160, gen_steps=32):
    """Checks both attention kernels; returns the bf16 rows of the paths'
    shapes, a list per (kernel, path): seamless runs the prefill kernel at
    three shapes (its encoder, its decoder's self- and cross-attention)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    S_cache = S + gen_steps + 1
    lengths = [S_cache, S + 1, S + gen_steps // 2, S + 8]
    main = {("flash_prefill", "stablelm_12b"): [prefill_case(gen, B, S, H, K, hd, bf16,
                                                             measure=True)],
            ("flash_decode", "stablelm_12b"): [decode_case(gen, B, S_cache, H, K, hd, bf16,
                                                           lengths, measure=True)]}
    extra = [
        prefill_case(gen, B, S, H, K, hd, f32, measure=True),
        decode_case(gen, B, S_cache, H, K, hd, f32, lengths, measure=True),
        prefill_case(gen, 1, 384, 8, 4, 256, f32, window=128, softcap=50.0),
        prefill_case(gen, 1, 384, 8, 4, 256, bf16, window=128, softcap=50.0),
        decode_case(gen, 2, 400, 8, 4, 256, f32, [400, 150], window=128, softcap=50.0),
        prefill_case(gen, 2, 333, 8, 2, 160, f32),  # ragged S
        prefill_case(gen, 2, 333, 8, 2, 160, bf16),
        prefill_case(gen, 1, 100, 4, 2, 160, f32, Sk=333, causal=False),  # Sq != Sk
        prefill_case(gen, 1, 100, 4, 2, 160, bf16, Sk=333, causal=False),
        prefill_case(gen, 2, 300, 10, 2, 128, bf16),  # q_per_kv 5, llama4-scout's grouping
        prefill_case(gen, 2, 300, 24, 2, 128, bf16),  # q_per_kv 12, starcoder2-15b's
        prefill_case(gen, 2, 300, 24, 2, 128, f32),
        decode_case(gen, 3, 77, 4, 4, 160, f32, [77, 1, 40]),
        decode_case(gen, 64, 100, 8, 8, 64, bf16, [100, 1, 64, 65] * 16),  # no split
    ]
    # zamba2-1.2b's shared attention: MHA, 32 heads of 64, prompt 1024.
    zamba_cache = 1024 + gen_steps + 1
    main[("flash_prefill", "zamba2_1p2b")] = [prefill_case(gen, B, 1024, 32, 32, 64, bf16,
                                                           measure=True)]
    main[("flash_decode", "zamba2_1p2b")] = [decode_case(
        gen, B, zamba_cache, 32, 32, 64, bf16,
        [zamba_cache, 1025, 1024 + gen_steps // 2, 1032], measure=True)]
    # seamless-m4t-large-v2: MHA, 16 heads of 64; the encoder over the
    # 4096-frame stub memory (non-causal), the decoder's self-attention over
    # the 512-token prompt, its cross-attention from the prompt to the memory.
    enc = SLICES["seamless_m4t_large_v2"]["widths"]["enc_len"]
    main[("flash_prefill", "seamless_m4t_large_v2")] = [
        prefill_case(gen, B, enc, 16, 16, 64, bf16, causal=False, measure=True),
        prefill_case(gen, B, S, 16, 16, 64, bf16, measure=True),
        prefill_case(gen, B, S, 16, 16, 64, bf16, Sk=enc, causal=False, measure=True)]
    # grok-1 (48 heads / 8 KV, q_per_kv 6) and llama4-scout (40 / 8, q_per_kv
    # 5), hd 128: prompt 512, cache 545.
    for arch, heads in (("grok_1_314b", 48), ("llama4_scout_17b_a16e", 40)):
        main[("flash_prefill", arch)] = [prefill_case(gen, B, S, heads, 8, 128, bf16,
                                                      measure=True)]
    for arch, heads, kv, hd_x in (("seamless_m4t_large_v2", 16, 16, 64),
                                  ("grok_1_314b", 48, 8, 128),
                                  ("llama4_scout_17b_a16e", 40, 8, 128)):
        main[("flash_decode", arch)] = [decode_case(gen, B, S_cache, heads, kv, hd_x, bf16,
                                                    lengths, measure=True)]
    for hd_x in (16, 32, 64, 128, 256):
        for dtype in (f32, bf16):
            extra.append(prefill_case(gen, 2, 200, 4, 2, hd_x, dtype))
            extra.append(decode_case(gen, 2, 300, 4, 2, hd_x, dtype, [300, 123]))
    for row in [*(r for rows in main.values() for r in rows), *extra]:
        log("kernel check:", json.dumps(row))
    return main


def kernel_resources():
    """Registers, spills and static shared memory (ptxas's report of the
    build) and dynamic shared memory (the library's own count) of every
    ``flash_prefill``, ``flash_decode`` and ``ssd_intra_chunk`` kernel; the
    decode kernels' at the most heads a block serves.  Raises if the bf16
    SSD kernel at the served models' sizes, (hd, N) = (64, 128) and
    (64, 64), spills."""
    import re
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import MAX_HEADS

    lib = _build.library()
    rows = []
    for entry in _build.resources():
        m = re.search(r"((flash_prefill|flash_decode|ssd_intra_chunk)_[a-z0-9]+_kernel)",
                      entry["name"])
        if not m:
            continue
        args = _build.template_args(entry["name"])
        dtype = 0 if m.group(1).endswith("_f32_kernel") else 1
        row = dict(kernel=m.group(1), family=m.group(2), hd=args[0],
                   registers=entry["registers"], spill_store_bytes=entry["spill_stores"],
                   spill_load_bytes=entry["spill_loads"], static_smem_bytes=entry["smem"])
        if m.group(2) == "flash_prefill":
            row.update(softcap=bool(args[1]) if len(args) > 1 else None,
                       dynamic_smem_bytes=lib.repro_flash_prefill_smem(dtype, args[0]))
        elif m.group(2) == "flash_decode":
            smem = lib.repro_flash_decode_smem(dtype, args[0], MAX_HEADS)
            row.update(heads=MAX_HEADS, dynamic_smem_bytes=smem)
        else:
            row.update(n_state=args[1],
                       dynamic_smem_bytes=lib.repro_ssd_intra_chunk_smem(dtype, *args))
        rows.append(row)
    for name in ("flash_prefill", "flash_decode", "ssd_intra_chunk"):
        if not any(r["family"] == name for r in rows):
            raise AssertionError(f"ptxas reported no {name} kernel")
    for sizes in ((64, 128), (64, 64)):
        ssd = [r for r in rows if r["kernel"] == "ssd_intra_chunk_bf16_kernel"
               and (r["hd"], r["n_state"]) == sizes]
        if not ssd or ssd[0]["spill_store_bytes"] or ssd[0]["spill_load_bytes"]:
            raise AssertionError(f"bf16 ssd_intra_chunk at (hd, N) = {sizes}: {ssd}")
    return rows


# ---------------------------------------------------------------------------
# Phase 3: the slices at full width
# ---------------------------------------------------------------------------
# The models served, at their published widths (asserted), each with its
# prompt length and its kernel launches: flash_prefill per prefill,
# flash_decode per decode step, ssd_intra_chunk per prefill.  A model too
# large for one card is served at a stated ``cut`` of its depth (every width,
# the expert count, top-k, capacity factor and group size as published),
# and its f32 pass at the smaller ``f32_cut``, with the launches of that
# depth: the f32 draws of 6 grok-1 layers would take 120 GB.
SLICES = {
    "stablelm_12b": dict(
        prompt=512, launches=(40, 40, 0),
        widths=dict(n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=160,
                    d_ff=13824, vocab=100352, dtype="bfloat16")),
    "mamba2_2p7b": dict(
        prompt=1024, launches=(0, 0, 64),
        widths=dict(n_layers=64, d_model=2560, d_inner=5120, n_ssm_heads=80, ssm_head_dim=64,
                    ssm_state=128, ssm_chunk=256, ssm_conv_width=4, vocab=50280,
                    dtype="bfloat16")),
    "zamba2_1p2b": dict(
        prompt=1024, launches=(6, 6, 38),
        widths=dict(n_layers=38, d_model=2048, d_inner=4096, n_ssm_heads=64, ssm_head_dim=64,
                    ssm_state=64, ssm_chunk=256, hybrid_period=6, n_heads=32, n_kv_heads=32,
                    head_dim=64, d_ff=8192, vocab=32000, dtype="bfloat16")),
    # 24 encoder calls over the 4096-frame stub memory, 24 self- and 24
    # cross-attention calls a prefill; 24 self-attention calls a decode step
    # (its cross-attention against the precomputed K/V is plain PyTorch).
    "seamless_m4t_large_v2": dict(
        prompt=512, launches=(72, 24, 0),
        widths=dict(n_layers=24, n_enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
                    head_dim=64, d_ff=8192, mlp_gated=False, activation="gelu",
                    vocab=256206, enc_len=4096, dtype="bfloat16")),
    # 4.92 B params (9.84 GB) a layer: 6 of 64 layers and the embedding fill
    # ~61 GB; the f32 pass at 2 layers ~43 GB.
    "grok_1_314b": dict(
        prompt=512, launches=(6, 6, 0), cut=dict(n_layers=6),
        f32_cut=dict(n_layers=2), f32_launches=(2, 2, 0),
        widths=dict(n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
                    d_ff=32768, mlp_gated=True, activation="gelu", vocab=131072, n_experts=8,
                    top_k=2, n_shared_experts=0, capacity_factor=1.25, moe_group_size=4096,
                    dtype="bfloat16")),
    # 2.20 B params (4.41 GB) a layer: 12 of 48 layers ~55 GB; f32 at 4 ~39 GB.
    "llama4_scout_17b_a16e": dict(
        prompt=512, launches=(12, 12, 0), cut=dict(n_layers=12),
        f32_cut=dict(n_layers=4), f32_launches=(4, 4, 0),
        widths=dict(n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
                    d_ff=8192, mlp_gated=True, activation="silu", vocab=202048, n_experts=16,
                    top_k=1, n_shared_experts=1, capacity_factor=1.25, moe_group_size=4096,
                    rope_theta=500_000.0, dtype="bfloat16")),
}

# The bf16 logit gates against the plain-version run: (max abs, error RMS
# over the logits' RMS).  The plain path rounds the attention logits and
# the softmax weights to bf16 (as the JAX model does); the kernels keep both
# in f32.  That moves each kernel call's output by about one bf16 step
# (2^-8 relative), and independent steps add roughly in quadrature.
# - stablelm-12b: 40 layers, sqrt(40) * 2^-8 ~ 2.5% of the logits' RMS (std
#   ~1.4).  Bounded at twice that, and by an absolute 0.25 (a few bf16
#   steps at |logit| ~ 8).
# - seamless-m4t-large-v2 (reckoned before its first run): a row's logits
#   depend on 72 kernel calls, the 24 of the encoder (through the memory
#   every cross-attention reads) and the prefill's 24 self- and 24
#   cross-attention calls; sqrt(72) * 2^-8 ~ 3.3% of the logits' RMS (std
#   0.02 * sqrt(1024) ~ 0.64).  Bounded at twice that, 7%, and by 0.25,
#   twice the ~5.7 sigma (0.12) that 4 x 33 x 256206 such errors reach.
# - the MoE models (reckoned before their first run): grok 6 layers
#   sqrt(6) * 2^-8 ~ 1.0%, scout 12 layers ~1.4%.  Bounded at 5% and by
#   0.25 (logit std 0.02 * sqrt(d_model) ~ 1.4-1.6, as stablelm's).  Held,
#   since the first reading, on a kernel run pinned to the plain run's
#   routing (below).
LOGIT_GATES = {"stablelm_12b": (0.25, 5e-2), "seamless_m4t_large_v2": (0.25, 7e-2),
               "grok_1_314b": (0.25, 5e-2), "llama4_scout_17b_a16e": (0.25, 5e-2)}
# MoE routing is discrete.  Reckoned before the first run: a one-step bf16
# difference between the runs moves the router's input by ~2^-8, ~0.4% of
# router logits of std ~1; that flips a top-k choice whose gap to the next
# expert is smaller, and such gaps between the k-th and (k+1)-th of 8
# (grok) or 16 (scout) normal logits have a density of ~2-2.5 at 0: ~1% of
# the (token, layer) choices, held at 4%, about 3x that (a kernel off by a
# few % would flip a quarter of them).  The first reading (grok on an
# NVIDIA H100 80GB HBM3, 700.00 W) bore that out at the first layer (0.7%)
# and not below it (4.6% of all choices; the logits of the tokens whose
# routing agreed 0.40 max abs): a flipped token goes through another
# expert, its hidden state moves by tens of %, and attention, which with
# random weights nearly averages its keys' values, carries that to every
# later row of its sequence, which flips more choices deeper.  So the gate
# now reads the first layer's share, where only the kernels' rounding acts;
# every layer's share is printed; and the logits are held on a kernel run
# pinned to the plain run's routing, where only rounding remains.
MAX_FLIP_SHARE = 0.04
# The SSM models' bf16 gate is set by the model itself.  A bf16 rounding
# that lands one step apart (the kernel and the plain SSD sum in different
# orders in f32, so the bf16 rounding of a layer's output flips now and
# then) is carried by the SSM state to every later position and grows
# through the layers: with random weights a one-step flip rate of a few
# per mille reaches an error RMS of several % of the logits.  So both bf16
# runs are held against the same bf16 weights evaluated in f32 on the plain
# path, and the kernel run may be no further from it than the plain run
# is, within half again (the two runs' rounding noise is of one size; a
# kernel that rounded what the plain path keeps in f32 would add to it).
FLOOR_RATIO = 1.5
# In f32 the two paths differ only in summation order: the model-level
# tolerance of tests/models/test_smoke.py.
LOGIT_ATOL_F32 = 2e-3


def compare_logits(label, got, ref, atol, rel_rms_tol=None):
    """Logs and checks the teacher-forced logits of a kernel run."""
    import torch

    if not torch.isfinite(got).all():
        raise AssertionError(f"{label}: kernel-run logits are not finite")
    diff = (got - ref).abs()
    stats = dict(max_abs=diff.max().item(),
                 rel_rms=((got - ref).pow(2).mean().sqrt() / ref.pow(2).mean().sqrt()).item(),
                 greedy_agreement=(got.argmax(-1) == ref.argmax(-1)).float().mean().item())
    log(f"slice: {label} logits vs plain run, {got.shape[1]} positions: max abs "
        f"{stats['max_abs']:.3e} (tol {atol}), rel RMS {stats['rel_rms']:.2e} "
        f"(tol {rel_rms_tol}), logit std {ref.std().item():.3f}, greedy agreement "
        f"{stats['greedy_agreement']:.4f} (information only)")
    log(f"slice: {label} max abs per position:",
        json.dumps([round(x, 6) for x in diff.amax(dim=(0, 2)).tolist()]))
    if stats["max_abs"] > atol or (rel_rms_tol is not None and stats["rel_rms"] > rel_rms_tol):
        raise AssertionError(f"{label}: kernel run disagrees with the plain-version run")
    return stats


def compare_to_floor(label, got, plain, exact):
    """Logs and checks a bf16 kernel run against the bf16 plain run, both
    measured from the f32 evaluation of the same weights."""
    import torch

    def rel_rms(a, b):
        return ((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt()).item()

    if not torch.isfinite(got).all():
        raise AssertionError(f"{label}: kernel-run logits are not finite")
    stats = dict(kernel_vs_f32=rel_rms(got, exact), plain_vs_f32=rel_rms(plain, exact),
                 kernel_vs_plain=rel_rms(got, plain), max_abs=(got - plain).abs().max().item(),
                 greedy_agreement=(got.argmax(-1) == plain.argmax(-1)).float().mean().item())
    log(f"slice: {label} logits, {got.shape[1]} positions, error RMS over the logits' RMS "
        f"against the f32 evaluation of the same weights: kernel run "
        f"{stats['kernel_vs_f32']:.2e}, plain run {stats['plain_vs_f32']:.2e} (kernel may be "
        f"at most {FLOOR_RATIO}x); kernel vs plain {stats['kernel_vs_plain']:.2e}, max abs "
        f"{stats['max_abs']:.3e}, greedy agreement {stats['greedy_agreement']:.4f} "
        f"(information only)")
    if stats["kernel_vs_f32"] > FLOOR_RATIO * stats["plain_vs_f32"]:
        raise AssertionError(f"{label}: kernel run is further from f32 than the plain run")
    return stats


class RoutingLog:
    """While open, records every MoE routing of the model (``moe.route``):
    each token's chosen experts, the chosen and kept ones as (B, S, E)
    masks, and the call's drop share.  With ``pin`` (the calls of an
    earlier log), each call takes that call's choices in place of its own
    top-k."""

    def __init__(self, pin=None):
        self.pin = pin

    def __enter__(self):
        from repro_torch.models import moe

        self.calls, self._moe, route = [], moe, moe.route

        def logged(cfg, router, x, *, dropless=False, experts=None):
            if self.pin is not None:
                experts = self.pin[len(self.calls)]["experts"]
            r = route(cfg, router, x, dropless=dropless, experts=experts)
            shape = (*x.shape[:2], cfg.n_experts)
            self.calls.append(dict(
                experts=r.experts, chosen=r.onehot.sum(2).reshape(shape) > 0,
                kept=(r.onehot * r.keep[..., None]).sum(2).reshape(shape) > 0,
                drop_frac=1.0 - r.keep.float().mean().item()))
            return r

        self._route, moe.route = route, logged
        return self

    def __exit__(self, *exc):
        self._moe.route = self._route
        return False


def routing_gate(label, got, want, n_layers):
    """Compares the routing of two teacher-forced runs (``RoutingLog``
    calls: the prefill's layers, then each decode step's).  Per layer, the
    (token, layer) choices whose experts differ between the runs, and the
    first flips among them (the token's kept experts agreed at every
    earlier layer).  Fails if more than ``MAX_FLIP_SHARE`` of the first
    layer's choices differ."""
    if len(got) != len(want) or len(got) % n_layers:
        raise AssertionError(f"{label}: {len(got)} and {len(want)} MoE calls")
    flips, firsts, per_layer = [0] * n_layers, [0] * n_layers, [0] * n_layers
    for i in range(0, len(got), n_layers):
        diverged = None
        for layer in range(n_layers):
            g, w = got[i + layer], want[i + layer]
            flip = (g["chosen"] != w["chosen"]).any(-1)  # (B, S)
            first = flip if diverged is None else flip & ~diverged
            differ = (g["kept"] != w["kept"]).any(-1)
            diverged = differ if diverged is None else diverged | differ
            flips[layer] += int(flip.sum().item())
            firsts[layer] += int(first.sum().item())
            per_layer[layer] += flip.numel()
    stats = dict(first_layer_flip_share=flips[0] / per_layer[0],
                 flip_share=sum(flips) / sum(per_layer),
                 first_flip_share=sum(firsts) / sum(per_layer), choices=sum(per_layer),
                 flips_per_layer=flips, first_flips_per_layer=firsts,
                 prefill_drop_frac=[c["drop_frac"] for c in got[:n_layers]],
                 prefill_drop_frac_plain=[c["drop_frac"] for c in want[:n_layers]])
    log(f"slice: {label} routing, kernel run vs plain run, of {per_layer[0]} choices a "
        f"layer: the first layer's differ on {flips[0]}, share "
        f"{stats['first_layer_flip_share']:.3e} (gate {MAX_FLIP_SHARE}); all layers' "
        f"{sum(flips)} of {sum(per_layer)}, share {stats['flip_share']:.3e}, per layer {flips}, "
        f"first flips per layer {firsts}; moe_drop_frac at prefill per layer "
        f"{json.dumps([round(x, 5) for x in stats['prefill_drop_frac']])}, plain run "
        f"{json.dumps([round(x, 5) for x in stats['prefill_drop_frac_plain']])}")
    if stats["first_layer_flip_share"] > MAX_FLIP_SHARE:
        raise AssertionError(f"{label}: the kernel run routes unlike the plain-version run")
    return stats


def teacher_forced_logits(model, batch, generated, max_len, pin=None):
    """The prefill step's logits, then each decode step's logits fed the
    given tokens; returns them (B, 1 + steps, V) with the MoE routing
    (``RoutingLog``, pinned to ``pin``'s choices when given)."""
    import torch
    from repro_torch.serve import make_prefill_step

    with RoutingLog(pin) as routing:
        logits, state = make_prefill_step(model, max_len)(batch)
        out = [logits]
        for t in range(generated.shape[1]):
            logits, state = model.decode_step(state, generated[:, t : t + 1])
            out.append(logits)
    return torch.stack([x[:, -1] for x in out], dim=1), routing.calls


def gate_logits(label, arch, cfg, model, run, got, want, atol=None, rel_rms_tol=None):
    """Holds the teacher-forced logits of a kernel run ``got`` against the
    plain run ``want``: at ``LOGIT_GATES[arch]`` unless ``atol`` is given.
    For MoE, the routing of the two runs first (``routing_gate``), and the
    logits of a kernel run pinned to the plain run's routing (``run``
    re-runs ``model`` teacher-forced)."""
    if atol is None:
        atol, rel_rms_tol = LOGIT_GATES[arch]
    if cfg.family != "moe":
        return compare_logits(label, got[0], want[0], atol, rel_rms_tol)
    routing = routing_gate(label, got[1], want[1], cfg.n_layers)
    d = got[0] - want[0]
    free = dict(max_abs=d.abs().max().item(),
                rel_rms=(d.pow(2).mean().sqrt() / want[0].pow(2).mean().sqrt()).item(),
                greedy_agreement=(got[0].argmax(-1) == want[0].argmax(-1)).float().mean().item())
    log(f"slice: {label} logits of the free-running kernel run vs plain run (information "
        f"only): {json.dumps(free)}")
    pinned = run(model, pin=want[1])
    if any(not (p["experts"] == w["experts"]).all() for p, w in zip(pinned[1], want[1])):
        raise AssertionError(f"{label}: the pinned run did not take the plain run's routing")
    stats = compare_logits(f"{label} (routing pinned)", pinned[0], want[0], atol, rel_rms_tol)
    return dict(stats, routing=routing, free_running=free)


def expected_launches(launches, decode_steps):
    prefill, per_step, ssd = launches
    return {"flash_prefill": prefill, "flash_decode": per_step * decode_steps,
            "ssd_intra_chunk": ssd}


def make_inputs(cfg, gen, batch, prompt):
    """Prompt tokens from ``gen``; for the encoder-decoder also the stub
    frame embeddings (batch, enc_len, d_model) in the config's type."""
    import torch
    from repro_torch import torch_dtype

    inputs = {"tokens": torch.randint(0, cfg.vocab, (batch, prompt), generator=gen,
                                      device="cuda")}
    if cfg.family == "encdec":
        inputs["enc_emb"] = torch.randn((batch, cfg.enc_len, cfg.d_model), generator=gen,
                                        device="cuda").to(torch_dtype(cfg.dtype))
    return inputs


def slice_phase(card, arch, spec, batch=4, gen_steps=32, seed=0):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import get_model
    from repro_torch.serve import Engine, make_prefill_step

    published = get_config(arch)
    widths = {k: getattr(published, k) for k in spec["widths"]}
    if widths != spec["widths"]:
        raise AssertionError(f"{arch} is not at its published widths: {widths}")
    cut = spec.get("cut", {})
    cfg = published.replace(**cut)
    log(f"slice: {arch} at its published widths {json.dumps(widths)}; "
        + (f"cut {json.dumps(cut)}" if cut else "no cut"))
    prompt = spec["prompt"]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = get_model(cfg).init(gen, device="cuda")
    torch.cuda.synchronize()
    allocated_after_init = torch.cuda.memory_allocated()
    n_params = sum(p.numel() for p in model.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"slice: {arch} {n_params / 1e9:.2f} B params in {cfg.n_layers} layers "
        f"({n_bytes / 1e9:.1f} GB) initialized in {time.perf_counter() - t0:.1f} s")
    inputs = make_inputs(cfg, gen, batch, prompt)
    max_len = prompt + gen_steps + 1
    engine = Engine(model, max_len=max_len)
    engine.generate(inputs, 2)  # warm-up: library handles, allocator

    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = engine.generate(inputs, gen_steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, shapes = dict(ops.LAUNCHES), dict(ops.LAUNCH_SHAPES)
    log(f"slice: {arch} Engine.generate batch={batch} prompt={prompt} steps={out.steps} "
        f"wall={wall * 1e3:.1f} ms launches={launches} by shape "
        f"{json.dumps([[k, n] for k, n in shapes.items()])}")
    if out.tokens.shape != (batch, gen_steps) or not ((out.tokens >= 0) &
                                                      (out.tokens < cfg.vocab)).all():
        raise AssertionError(f"bad tokens: shape {out.tokens.shape}")
    want = expected_launches(spec["launches"], gen_steps)
    if launches != want:
        raise AssertionError(f"{arch} kernel launches {launches}, expected {want}")

    # The same weights on the plain versions, teacher-forced on the tokens
    # the kernel run produced.
    plain = get_model(cfg.replace(attn_impl="naive"))
    plain.load_state_dict(model.state_dict(), assign=True)
    generated = torch.from_numpy(out.tokens).to("cuda")

    def run(m, pin=None):
        return teacher_forced_logits(m, inputs, generated, max_len, pin)

    got, want = run(model), run(plain)
    if arch in LOGIT_GATES:
        bf16 = gate_logits(f"{arch} bf16", arch, cfg, model, run, got, want)
    else:
        exact = get_model(cfg.replace(dtype="float32", attn_impl="naive"))
        exact.load_state_dict({k: v.float() for k, v in model.state_dict().items()},
                              assign=True)
        bf16 = compare_to_floor(f"{arch} bf16", got[0], want[0],
                                teacher_forced_logits(exact, inputs, generated, max_len)[0])
        del exact
    del got, want

    # Rates: the prefill step alone (for the encoder-decoder the encoder
    # and the decoder's prefill, as the Engine runs them); decode per step
    # from Engine.generate itself, as the difference between this run and
    # runs that decode once.
    prefill_step = make_prefill_step(model, max_len)
    prefill_ms, one_step_ms = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill_step(inputs)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        engine.generate(inputs, 1)
        torch.cuda.synchronize()
        one_step_ms.append((time.perf_counter() - t0) * 1e3)
    decode_ms = (wall * 1e3 - sorted(one_step_ms)[1]) / (gen_steps - 1)
    windows = profile_slice(arch, model, inputs, max_len)
    # The live tensors, for phase 7's bytes against the dry-run's reckoning.
    live = dict(params=tree_bytes(dict(model.named_parameters())),
                decode_state=tree_bytes(windows.pop("decode_state")), max_len=max_len,
                allocated_after_init=allocated_after_init,
                peak_allocated=torch.cuda.max_memory_allocated())
    rates = dict(arch=arch, card=card, prefill_ms=sorted(prefill_ms)[1],
                 decode_ms_per_step=decode_ms, generate_wall_ms=wall * 1e3,
                 tok_per_s=batch * out.steps / wall, batch=batch, prompt=prompt,
                 steps=out.steps, n_layers=cfg.n_layers, launches=launches, logits_bf16=bf16,
                 profile=windows, live_bytes=live)

    # The same draws in f32, where the kernel and plain paths differ only in
    # the order of f32 sums: a tight check of the kernels' wiring at full
    # width (at ``f32_cut`` depth where the f32 weights would not fit).
    del model, plain, engine, prefill_step, run
    torch.cuda.empty_cache()
    cfg32 = cfg.replace(dtype="float32", **spec.get("f32_cut", {}))
    inputs32 = {k: (v.float() if v.is_floating_point() else v) for k, v in inputs.items()}
    model = get_model(cfg32).init(torch.Generator(device="cuda").manual_seed(seed), "cuda")
    plain = get_model(cfg32.replace(attn_impl="naive"))
    plain.load_state_dict(model.state_dict(), assign=True)
    f32_steps = 8

    def run32(m, pin=None):
        return teacher_forced_logits(m, inputs32, generated[:, :f32_steps], max_len, pin)

    ops.reset_launches()
    got = run32(model)
    want = expected_launches(spec.get("f32_launches", spec["launches"]), f32_steps)
    if dict(ops.LAUNCHES) != want:
        raise AssertionError(f"{arch} f32 kernel launches {dict(ops.LAUNCHES)}, "
                             f"expected {want}")
    rates["logits_f32"] = gate_logits(f"{arch} f32 ({cfg32.n_layers} layers)", arch, cfg32,
                                      model, run32, got, run32(plain), atol=LOGIT_ATOL_F32)
    del model, plain
    torch.cuda.empty_cache()
    return launches, shapes, rates


# The device kernel (its symbol in ``csrc/``) that one call of each wrapper
# of ``ops`` launches on the served bf16 paths: head sizes 64-160 take the
# wgmma prefill.
DEVICE_KERNELS = {"flash_prefill": "flash_prefill_wgmma_kernel",
                  "flash_decode": "flash_decode_bf16_kernel",
                  "ssd_intra_chunk": "ssd_intra_chunk_bf16_kernel"}


def profile_slice(arch, model, inputs, max_len, decode_steps=8, top=8):
    """torch.profiler over one prefill step and a few decode steps: wall
    time, the device's busy and idle share, the kernels that take the most,
    and each wrapper's launches as the host counts them (``ops.LAUNCHES``)
    and as the device trace shows them; raises unless the two agree.
    Returns per window the launches, the busy share and the decode state
    the prefill built."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    from repro_torch.launch.trace_analysis import check_launches, read_profile
    from repro_torch.serve import make_prefill_step

    prefill_step = make_prefill_step(model, max_len)
    windows = {}
    for label in ("prefill", "decode"):
        logits, state = prefill_step(inputs)
        torch.cuda.synchronize()
        ops.reset_launches()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if label == "prefill":
                prefill_step(inputs)
            else:
                for _ in range(decode_steps):
                    nxt = torch.argmax(logits[:, -1], dim=-1)
                    nxt.cpu()
                    logits, state = model.decode_step(state, nxt[:, None])
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        reading = read_profile(prof, wall_ms=wall_ms)
        by_symbol = check_launches(reading, {DEVICE_KERNELS[name]: n
                                             for name, n in ops.LAUNCHES.items()})
        device = {name: by_symbol[sym] for name, sym in DEVICE_KERNELS.items()}
        windows[label] = dict(host_launches=dict(ops.LAUNCHES), device_launches=device,
                              busy_share=reading.busy_share, wall_ms=wall_ms,
                              steps=decode_steps if label == "decode" else 1)
        log(f"profile {arch} {label}: wall {wall_ms:.2f} ms, device busy {reading.busy_ms:.2f} "
            f"ms ({reading.busy_share:.1%}), idle {reading.idle_share:.1%}"
            + (f", {decode_steps} steps" if label == "decode" else "")
            + f"; launches on the host {json.dumps(dict(ops.LAUNCHES))}, in the device trace "
            f"{json.dumps(device)}")
        for name, k in reading.top(top):
            log(f"  {k.device_ms:9.3f} ms {k.launches:6d}x  {name[:100]}")
        host = sorted((e for e in prof.key_averages() if e.device_type.name == "CPU"),
                      key=lambda e: -e.self_cpu_time_total)
        log(f"profile {arch} {label}: host ops by self CPU time (profiler overhead included)")
        for e in host[:top]:
            log(f"  {e.self_cpu_time_total / 1e3:9.3f} ms {e.count:6d}x  {e.key[:100]}")
    windows["decode_state"] = state
    return windows


def tree_bytes(tree) -> int:
    """Bytes of the tensors of a tree (dicts, tuples, named tuples)."""
    import torch
    from torch.utils._pytree import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


# ---------------------------------------------------------------------------
# Phase 5: training (the port's train/, plain PyTorch with autograd, as the
# reference trains: no kernel has a backward, so none may launch)
# ---------------------------------------------------------------------------
# stablelm-12b at its published widths, cut to 8 of 40 layers.  Reckoning:
# the embedding and unembedding are 2 x 100352 x 5120 = 1.028 B params and
# a layer 0.2779 B (attention 65.5 M, MLP 212.3 M), so 8 layers make 3.25 B.
# At 16 B a param (f32 masters 13.0 GB, f32 m and v 26.0 GB, the f32
# gradients 13.0 GB) plus 6.5 GB of bf16 gradients and one recomputed
# layer's activations that is ~60 GB of the card's 80; the whole 12.14 B
# model would need ~194 GB.
TRAIN = dict(arch="stablelm_12b", cut=dict(n_layers=8), pair_cut=dict(n_layers=2),
             seq_len=512, global_batch=4, steps=10,
             widths=dict(d_model=5120, n_heads=32, n_kv_heads=8, head_dim=160, d_ff=13824,
                         vocab=100352, dtype="bfloat16"))
# OptConfig's defaults (f32 m and v, weight decay 0.1, clipping at 1) but
# lr 3e-6 from the first step (a warm-up of 1).  Adam's first steps move
# every weight by ~lr, coherently across a 5120-wide matrix: at lr 1e-5 that
# changes a layer's outputs by ~5%, compounding over 8 layers, and from
# this init the default lr 3e-4 with a warm-up of 2 to 20 steps sends the
# loss up, while steps at 1e-5 and above may raise the loss of their own
# batch.  tools/train_lr_probe.py reads each setting (PERF.md §6).
TRAIN_OPT = dict(lr=3e-6, warmup_steps=1)
# The smoke config of each family, trained in f32 on the card and on the CPU
# from the same masters and batches: (arch, OptConfig overrides).
# Two steps each; int8 moments one: the second step reads the first's
# dequantized v, in which an element below 1/254 of its block's largest is
# 0, and an int8 level that the two sides' rounding sets differently there
# moves that element's step by many lr (a first reading: 0.236 at lr 1e-2).
TRAIN_PARITY = [("stablelm_12b", {}, 2), ("gemma2_2b", {}, 2), ("grok_1_314b", {}, 2),
                ("mamba2_2p7b", {}, 2), ("zamba2_1p2b", {}, 2),
                ("seamless_m4t_large_v2", {}, 2),
                ("stablelm_12b", dict(int8_state=True, int8_block=16), 1)]
PARITY_LR = 1e-2
# Gate (a), f32 on the card against the port on the CPU (TF32 off on the
# card).  tests/test_torch_train_step.py holds the port against JAX on the
# CPU by the same constants.  Both sides are f32 and sum in other orders:
# ~1e-6 relative a reduction, carried through a few layers and a step (the
# CPU readings against JAX: at most 6e-6), so the loss, grad norm and
# metrics within 5e-5 relative.
PARITY_METRIC_RTOL = 5e-5
# The first Adam steps are close to lr * sign(g): an element whose gradient
# is within a few eps of zero, or whose sign the two sides' sums set
# differently, moves by up to lr the other way.  So every master is held
# within 2 lr, and at most one element in a thousand may be off by more
# than lr / 16 (f32 gradients ~1e-6 apart leave few such elements; a wrong
# update formula moves them all).
PARITY_PARAM_ATOL, PARITY_PARAM_SHARE, PARITY_PARAM_FAR = 2 * PARITY_LR, 1e-3, PARITY_LR / 16
# The moments are sums of (1 - b1) * g and (1 - b2) * g^2 from the bf16
# gradients: one bf16 step of a gradient (2^-7) moves m by as much and v
# by twice that, relative; where the addends (two microbatches' gradients,
# or m and the next step's gradient) cancel, by one bf16 step of the
# addends, which the tensor's largest moment bounds (the readings: at most
# 1.3e-3 of it).  int8 moments are held as dequantized, within one
# quantization step (the block's scale) more.
PARITY_MOMENT_RTOL, PARITY_MOMENT_ATOL_FRAC = 2.0 ** -6, 2.0 ** -7
# Gate (b), one bf16 step against the f32 step on the same masters at full
# width and 2 layers.  bf16 rounds every activation (2^-9 relative RMS a
# rounding); through 2 layers the hidden states carry ~0.5% RMS of it, the
# logits (std ~1.43) ~0.007 of noise, random across the 100352 entries and
# 2048 positions, so the mean loss moves by ~1e-3 (its second-order part,
# var / 2, by ~3e-5): held at 0.02, below one bf16 step of the loss (12.5 x
# 2^-8 = 0.049).  The grad norm is dominated by the unembedding's and the
# embedding's gradients, whose elements carry ~1% of rounding noise that
# the sum of squares over 1.6 B elements averages out: held at 2% relative.
BF16_LOSS_ATOL, BF16_GNORM_RTOL = 0.02, 0.02
# Gate (c): final hidden states of unit RMS (final_norm at zero) and
# unembedding weights N(0, 0.02^2) over d_model 5120 give logits of std
# 0.02 * sqrt(5120) = 1.431, so the first loss is ln(100352) + 1.431^2 / 2
# = 11.516 + 1.024 = 12.540 (lse of V Gaussian logits ~ ln V + sigma^2 / 2;
# the target's logit averages 0).  Its mean over 2048 targets, which repeat
# (Zipfian data), moves by ~1.43 / sqrt(100) ~ 0.14: held within 0.5.  Then
# every loss and grad norm is finite, each step lowers the loss of the batch
# it took its gradient from (descent), and the last step's loss is below
# the first's (each step reads another batch, and batches differ).
FIRST_LOSS_ATOL = 0.5


def first_loss_reckoned(cfg) -> float:
    return math.log(cfg.vocab) + (0.02 * math.sqrt(cfg.d_model)) ** 2 / 2


def train_flops(cfg, batch: int, seq: int) -> float:
    """Model FLOPs of one train step: 3 x the forward's (the backward twice
    the forward), the forward 2 per token per weight of a matmul (the
    layers' attention and MLP weights, the unembedding; not the embedding
    lookup) plus causal attention, 4 H hd per (query, key) pair of
    S (S + 1) / 2 a sequence.  Recomputation under remat is not counted."""
    D, H, K, hd, F = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    per_layer = D * H * hd + 2 * D * K * hd + H * hd * D + (3 if cfg.mlp_gated else 2) * D * F
    matmul = cfg.n_layers * per_layer + D * cfg.vocab
    attention = cfg.n_layers * batch * 4 * H * hd * seq * (seq + 1) // 2
    return 3.0 * (2 * matmul * batch * seq + attention)


def train_batch(cfg, pipe, step, device, rng_seed=0):
    """The pipeline's batch for ``step`` on ``device``; for the
    encoder-decoder also stub frame embeddings (B, enc_len, D) in f32."""
    import numpy as np
    import torch

    b = {k: torch.from_numpy(v.copy()).to(device) for k, v in pipe.batch_at(step).items()}
    if cfg.family == "encdec":
        rng = np.random.default_rng((rng_seed, step))
        emb = rng.standard_normal((b["tokens"].shape[0], cfg.enc_len, cfg.d_model))
        b["enc_emb"] = torch.from_numpy(emb.astype(np.float32)).to(device)
    return b


def moved_state(state, cfg, ocfg, device, directory):
    """``state`` on ``device``, through a checkpoint: saved, then restored
    into a fresh state there."""
    import torch
    from repro_torch.train import checkpoint, init_state

    man = checkpoint.save(directory, int(state.step), state)
    like = init_state(cfg, ocfg, torch.Generator(device=device).manual_seed(99), device=device)
    return checkpoint.restore(directory, man, like)


def parity_case(arch, overrides, device, steps=2, seed=0):
    """The smoke config of ``arch`` in f32, trained ``steps`` steps on the
    CPU and on ``device`` from the same masters (moved by a checkpoint) and
    batches; raises unless gate (a) holds.  Returns the largest errors."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.train import OptConfig, init_state, make_train_step
    from repro_torch.train.data import DataConfig, TokenPipeline
    from repro_torch.train.optimizer import _dq8

    cfg = get_smoke_config(arch).replace(dtype="float32")
    ocfg = OptConfig(lr=PARITY_LR, warmup_steps=1, **overrides)
    cpu = init_state(cfg, ocfg, torch.Generator().manual_seed(seed), device="cpu")
    with tempfile.TemporaryDirectory() as tmp:
        dev = moved_state(cpu, cfg, ocfg, device, tmp)
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4, seed=seed))
    step = make_train_step(cfg, ocfg)
    worst = dict(metric_rel=0.0, param_abs=0.0, params_far=0, moment_excess=0.0)
    for i in range(steps):
        cpu, want = step(cpu, train_batch(cfg, pipe, i, "cpu"))
        dev, got = step(dev, train_batch(cfg, pipe, i, device))
        for k in want:
            a, b = float(got[k]), float(want[k])
            if not math.isfinite(a) or abs(a - b) > PARITY_METRIC_RTOL * abs(b) + 1e-6:
                raise AssertionError(f"train parity {arch} step {i}: {k} {a} vs CPU {b}")
            worst["metric_rel"] = max(worst["metric_rel"], abs(a - b) / max(abs(b), 1e-30))
    far = total = 0
    dev_params = dict(dev.params.named_parameters())
    for name, p in cpu.params.named_parameters():
        d = (dev_params[name].detach().cpu() - p.detach()).abs()
        if d.max().item() > PARITY_PARAM_ATOL:
            raise AssertionError(f"train parity {arch}: {name} off by {d.max().item():.3e}")
        worst["param_abs"] = max(worst["param_abs"], d.max().item())
        far += int((d > PARITY_PARAM_FAR).sum())
        total += d.numel()
        for which in ("m", "v"):
            got, want = getattr(dev.opt, which)[name], getattr(cpu.opt, which)[name]
            if ocfg.int8_state:
                atol = 1.01 * want["s"].max().item()
                got, want = (_dq8(t["q"], t["s"], p.shape).cpu() for t in (got, want))
            else:
                got, want = got.cpu(), want
                atol = PARITY_MOMENT_ATOL_FRAC * want.abs().max().item()
            excess = ((got - want).abs() - PARITY_MOMENT_RTOL * want.abs()).max().item()
            if excess > atol:
                raise AssertionError(f"train parity {arch}: {which}/{name} off by {excess:.3e} "
                                     f"beyond {PARITY_MOMENT_RTOL} relative (atol {atol:.3e})")
            worst["moment_excess"] = max(worst["moment_excess"], excess / max(atol, 1e-30))
    if far > PARITY_PARAM_SHARE * total:
        raise AssertionError(f"train parity {arch}: {far} of {total} masters beyond lr / 16")
    worst["params_far"] = far
    return dict(arch=arch, **overrides, steps=steps, **worst)


def bf16_pair(cfg, ocfg, batch, seed=0, device="cuda"):
    """Gate (b): one step of ``cfg`` (bf16) and the same step of its f32
    twin on a copy of the same masters."""
    import torch
    from repro_torch.models import get_model
    from repro_torch.train import TrainState, init_state, make_train_step, optimizer

    state = init_state(cfg, ocfg, torch.Generator(device=device).manual_seed(seed), device)
    cfg32 = cfg.replace(dtype="float32")
    model32 = get_model(cfg32).float().to_empty(device=device)
    model32.load_state_dict(state.params.state_dict())
    model32.requires_grad_(True)
    # (with autograd recording, as in training: no kernel runs)
    if state.params.hidden_states(batch["tokens"][:1, :8]).dtype != torch.bfloat16:
        raise AssertionError("the bf16 config's forward on f32 masters is not bf16")
    state32 = TrainState(model32, optimizer.init(ocfg, dict(model32.named_parameters())),
                         torch.zeros((), dtype=torch.int32, device=device))
    _, m32 = make_train_step(cfg32, ocfg)(state32, batch)
    del state32, model32
    _, m16 = make_train_step(cfg, ocfg)(state, batch)
    del state
    out = dict(loss_bf16=float(m16["loss"]), loss_f32=float(m32["loss"]),
               grad_norm_bf16=float(m16["grad_norm"]), grad_norm_f32=float(m32["grad_norm"]))
    out["loss_abs_diff"] = abs(out["loss_bf16"] - out["loss_f32"])
    out["grad_norm_rel_diff"] = abs(out["grad_norm_bf16"] / out["grad_norm_f32"] - 1)
    log(f"train: (b) {cfg.n_layers} layers at full width, one bf16 step vs the f32 step on "
        f"the same masters: {json.dumps(out)} (gates: loss {BF16_LOSS_ATOL}, grad norm "
        f"{BF16_GNORM_RTOL} relative)")
    if not (out["loss_abs_diff"] <= BF16_LOSS_ATOL and out["grad_norm_rel_diff"] <= BF16_GNORM_RTOL):
        raise AssertionError("train: the bf16 step strays from the f32 step")
    return out


def timed_step(step_fn, state, batch):
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, metrics = step_fn(state, batch)
    loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])  # waits for the step
    ms = (time.perf_counter() - t0) * 1e3
    if not (math.isfinite(loss) and math.isfinite(gnorm)):
        raise AssertionError(f"train: loss {loss} grad norm {gnorm}")
    return state, dict(loss=loss, grad_norm=gnorm, lr=float(metrics["lr"]), ms=ms,
                       peak_gb=torch.cuda.max_memory_allocated() / 1e9)


def profile_train_step(step_fn, state, batch, top=8):
    """One train step under torch.profiler: wall, the device's busy share,
    the kernels that take the most."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.trace_analysis import read_profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    reading = read_profile(prof, wall_ms=wall_ms)
    log(f"profile train step: wall {wall_ms:.2f} ms, device busy {reading.busy_ms:.2f} ms "
        f"({reading.busy_share:.1%}), idle {reading.idle_share:.1%}")
    for name, k in reading.top(top):
        log(f"  {k.device_ms:9.3f} ms {k.launches:6d}x  {name[:100]}")
    return state, dict(wall_ms=wall_ms, busy_ms=reading.busy_ms, busy_share=reading.busy_share)


def train_phase(card, spec=TRAIN, device="cuda"):
    """Gates (a) to (d) and the rates of the 8-layer run; returns the rates."""
    import statistics
    from collections import Counter
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.train import OptConfig, init_state, make_train_step
    from repro_torch.train.data import DataConfig, TokenPipeline
    from repro_torch.train.optimizer import update
    from repro_torch.train.train_loop import make_grad_fn, make_loss_fn

    launches, shapes = dict(ops.LAUNCHES), Counter(ops.LAUNCH_SHAPES)

    def no_launches(where):  # gate (d)
        if dict(ops.LAUNCHES) != launches or Counter(ops.LAUNCH_SHAPES) != shapes:
            raise AssertionError(f"train: kernels launched during {where}: "
                                 f"{dict(ops.LAUNCHES)} vs {launches}")

    for arch, overrides, n in TRAIN_PARITY:  # gate (a)
        row = parity_case(arch, overrides, device, steps=n)
        log(f"train: (a) f32 smoke {arch} on the card vs the port on the CPU:", json.dumps(row))
    no_launches("the f32 parity steps")

    published = get_config(spec["arch"]).replace(**spec.get("shrink", {}))
    widths = {k: getattr(published, k) for k in spec["widths"]}
    if widths != spec["widths"]:
        raise AssertionError(f"{spec['arch']} is not at its published widths: {widths}")
    ocfg = OptConfig(**TRAIN_OPT)
    B, S, n_steps = spec["global_batch"], spec["seq_len"], spec["steps"]
    pipe = TokenPipeline(DataConfig(vocab=published.vocab, seq_len=S, global_batch=B))
    batches = [pipe.torch_batch_at(i, device=device) for i in range(n_steps + 1)]

    pair = bf16_pair(published.replace(**spec["pair_cut"]), ocfg, batches[0],
                     device=device)  # gate (b)
    no_launches("the bf16 / f32 pair")
    torch.cuda.empty_cache()

    cfg = published.replace(**spec["cut"])
    gen = torch.Generator(device=device).manual_seed(0)
    t0 = time.perf_counter()
    state = init_state(cfg, ocfg, gen, device)
    torch.cuda.synchronize()
    live = dict(params=tree_bytes(dict(state.params.named_parameters())),
                optimizer=tree_bytes((state.opt, state.step)),
                allocated_after_init=torch.cuda.memory_allocated())
    n_params = sum(p.numel() for p in state.params.parameters())
    log(f"train: {spec['arch']} at its published widths {json.dumps(widths)}, cut "
        f"{json.dumps(spec['cut'])}: {n_params / 1e9:.3f} B params, f32 masters and moments "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB, initialized in "
        f"{time.perf_counter() - t0:.1f} s")
    step_fn, loss_fn = make_train_step(cfg, ocfg), make_loss_fn(cfg)
    steps = []
    for i in range(n_steps + 1):
        mb = 1 if i < n_steps else 2
        state, row = timed_step(step_fn if mb == 1 else make_train_step(
            cfg, ocfg, microbatches=2), state, batches[i])
        # the same batch's loss after the step, with autograd recording (as
        # in training: the plain path)
        row.update(microbatches=mb, loss_after=loss_fn(state.params, batches[i])[0].item())
        steps.append(row)
        log(f"train: step {i + 1} [{card}]:", json.dumps(row))
    no_launches("the 8-layer steps")
    losses, after = [r["loss"] for r in steps], [r["loss_after"] for r in steps]
    want = first_loss_reckoned(cfg)  # gate (c)
    log(f"train: (c) first loss {losses[0]:.4f} (reckoned {want:.4f}, within "
        f"{FIRST_LOSS_ATOL}); each step's loss on its batch before and after it: "
        f"{json.dumps([[round(a, 4), round(b, 4)] for a, b in zip(losses, after)])}")
    if abs(losses[0] - want) > FIRST_LOSS_ATOL or not losses[-1] < losses[0] or not all(
            math.isfinite(b) and b < a for a, b in zip(losses, after)):
        raise AssertionError(f"train: losses {losses}, after each step {after}")

    # The optimizer's share: a step's two halves, each synchronised.
    grad_fn = make_grad_fn(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, grads = grad_fn(state.params, batches[0])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    _, opt_state, _ = update(ocfg, dict(state.params.named_parameters()), grads, state.opt)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    state = state._replace(opt=opt_state, step=state.step + 1)
    del grads
    split = dict(grad_ms=(t1 - t0) * 1e3, optimizer_ms=(t2 - t1) * 1e3)
    split["optimizer_share"] = split["optimizer_ms"] / (split["grad_ms"] + split["optimizer_ms"])
    state, prof = profile_train_step(step_fn, state, batches[1])
    no_launches("the profiled and measured steps")

    ms = statistics.median(r["ms"] for r in steps[2:n_steps])
    flops = train_flops(cfg, B, S)
    rates = dict(arch=spec["arch"], card=card, n_layers=cfg.n_layers, n_params=n_params,
                 batch=B, seq_len=S, ms_per_step=ms, tok_per_s=B * S / (ms / 1e3),
                 model_flops_per_step=flops, mfu_bf16=flops / (ms / 1e3) / PEAK_FLOPS["bfloat16"],
                 peak_gb=max(r["peak_gb"] for r in steps), card_gb=80, losses=losses,
                 losses_after=after,
                 grad_norms=[r["grad_norm"] for r in steps], **split,
                 busy_share=prof["busy_share"], profiled_wall_ms=prof["wall_ms"],
                 bf16_pair=pair, live_bytes=live)
    del state
    torch.cuda.empty_cache()
    return rates


# ---------------------------------------------------------------------------
# Phase 6: the elastic trainer (the port's coord/: Matchmaker MultiPaxos on
# the simulator as the control plane of the training loop of phase 5)
# ---------------------------------------------------------------------------
# stablelm-12b as phase 5 trains it (published widths, TRAIN["cut"], batch 4
# x 512, TRAIN_OPT), through the schedule of benchmarks/bench_elastic.py:
# pods pod0..pod2; 6 steps, scale to 4 pods; 4 steps, back to 3; 4 steps,
# pod2 fails and pod4 replaces it; 4 steps, restore the committed
# checkpoint; 2 steps.  A StepRecord every 5 steps and a checkpoint every
# 10: exactly one, at step 10, which the restore (after step 18) goes back
# to.  Each entry: (steps to run, then the operation and its arguments).
ELASTIC = dict(pods=("pod0", "pod1", "pod2"), commit_every=5, checkpoint_every=10,
               schedule=((6, "scale_to", ("pod0", "pod1", "pod2", "pod3")),
                         (4, "scale_to", ("pod0", "pod1", "pod2")),
                         (4, "fail_and_replace", ("pod2", "pod4")),
                         (4, "restore_latest", ()),
                         (2, None, ())))
# tests/coord/test_elastic.py's bound on a membership change's activation,
# in simulated ms (the JAX controller through this schedule reads 1.0 each).
ACTIVATION_MS_MAX = 5.0
# A checkpoint holds the f32 masters, m and v: 12 B a param, 3.2512 B params
# at 8 layers (TRAIN's reckoning) = 39.01 GB on disk.  checkpoint.save keeps
# every leaf on the host while np.savez writes the shard, then reads the
# file back whole to hash it; restore reads it whole to hash it, then
# np.load's it: two copies on the host either way, 78.0 GB.  The H100
# machine has 105.9 GB of memory (MemTotal) and 75 GB free on its root file
# system, 9p, which keeps no page cache in the guest (`df`, `free` and
# /proc/meminfo read there): 78.0 GB + the process's own few GB fit, so the
# checkpoint runs at the 8-layer cut.  The
# phase checks disk and memory before any work and raises when either is
# short: the shard plus 5%, and two copies plus HOST_HEADROOM_BYTES.
CKPT_BYTES_PER_PARAM, CKPT_HOST_COPIES, HOST_HEADROOM_BYTES = 12, 2, 8e9
# The first step after the restore reruns step 11 on the same masters (the
# sums gate: bit for bit) and the same batch (a function of the step): its
# forward has no atomics (GEMMs, elementwise passes, reductions in a fixed
# order), so the loss comes back bit-equal; 1e-6 relative is ~8 f32 steps
# of a loss of 12, room for a GEMM algorithm chosen anew, far below a step's
# change of the loss (~0.1).  The second replayed step follows an update
# whose gradients sum by atomics (the embedding's backward): printed only.
REPLAY_LOSS_RTOL = 1e-6


def checkpoint_bytes(cfg) -> int:
    """A TrainState checkpoint's size reckoned from the config: f32 masters,
    m and v (``param_count`` leaves out the norms, ~0.01% at full width)."""
    return CKPT_BYTES_PER_PARAM * cfg.param_count()


def mem_available_bytes() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def elastic_preflight(nbytes: int, directory: str) -> dict:
    """Raises unless the disk under ``directory`` takes one checkpoint of
    ``nbytes`` and the host's memory two copies of it."""
    import shutil

    disk, mem = shutil.disk_usage(directory).free, mem_available_bytes()
    need_disk, need_mem = 1.05 * nbytes, CKPT_HOST_COPIES * nbytes + HOST_HEADROOM_BYTES
    row = dict(checkpoint_gb=nbytes / 1e9, disk_free_gb=disk / 1e9, need_disk_gb=need_disk / 1e9,
               mem_available_gb=mem / 1e9, need_mem_gb=need_mem / 1e9)
    if disk < need_disk or mem < need_mem:
        raise AssertionError(f"elastic: no room for the checkpoint round-trip: {json.dumps(row)}")
    return row


def elastic_expected(spec=ELASTIC):
    """From the schedule: the pod set of each epoch, the steps run before the
    restore, the checkpoint steps among them and the step restored to."""
    pods, epochs, step = list(spec["pods"]), [tuple(spec["pods"])], 0
    for n, op, args in spec["schedule"]:
        step += n
        if op == "scale_to":
            pods = list(args)
        elif op == "fail_and_replace":
            pods = [args[1] if p == args[0] else p for p in pods]
        elif op == "restore_latest":
            before = step
            continue
        else:
            continue
        epochs.append(tuple(pods))
    saved = [s for s in range(1, before + 1) if s % spec["checkpoint_every"] == 0]
    return dict(epochs=epochs, steps_before_restore=before, checkpoints=saved,
                restored_to=saved[-1])


class HostClock:
    """Host ms in the wrapped methods of one object, outermost calls only
    (``commit`` runs ``sim.run_for`` within it)."""

    def __init__(self):
        self.ms, self._depth = 0.0, 0

    def wrap(self, obj, name):
        fn = getattr(obj, name)

        def timed(*args, **kw):
            self._depth += 1
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self._depth -= 1
                if self._depth == 0:
                    self.ms += (time.perf_counter() - t0) * 1e3

        setattr(obj, name, timed)


def state_sums(state):
    """Per tensor of a TrainState, its f64 sum and abs-sum on its device."""
    import torch
    from repro_torch.train import checkpoint

    names, leaves = checkpoint._leaf_paths(state)
    with torch.no_grad():
        sums = torch.stack([torch.stack([t.sum(dtype=torch.float64),
                                         t.abs().sum(dtype=torch.float64)]) for t in leaves])
    return dict(zip(names, sums.tolist()))


def train_cut(phase):
    """``TRAIN``'s model at its published widths, cut in depth as phase 5
    cuts it; raises (naming ``phase``) where the widths are not published."""
    from repro_torch.configs import get_config

    cfg = get_config(TRAIN["arch"]).replace(**TRAIN["cut"])
    if {k: getattr(cfg, k) for k in TRAIN["widths"]} != TRAIN["widths"]:
        raise AssertionError(f"{phase}: {cfg.arch_id} is not at its published widths")
    return cfg


def elastic_phase(card, spec=ELASTIC, device="cuda", cfg=None, seq_len=TRAIN["seq_len"],
                  global_batch=TRAIN["global_batch"], opt=TRAIN_OPT):
    """Trains ``cfg`` (by default stablelm-12b at its published widths, cut
    as phase 5 cuts it) under the control plane through ``spec``'s schedule;
    raises unless every elastic gate holds.  Returns the readings."""
    import resource
    import statistics
    import tempfile
    from collections import Counter
    import torch
    from repro_torch.coord import ElasticConfig, ElasticTrainer
    from repro_torch.kernels import ops
    from repro_torch.train import OptConfig
    from repro_torch.train.data import DataConfig

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    if cfg is None:
        cfg = train_cut("elastic")
    want = elastic_expected(spec)
    launches, shapes = dict(ops.LAUNCHES), Counter(ops.LAUNCH_SHAPES)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        room = elastic_preflight(checkpoint_bytes(cfg), ckpt_dir)
        log(f"elastic: checkpoint room [{card}]:", json.dumps(room))
        t0 = time.perf_counter()
        tr = ElasticTrainer(
            cfg, OptConfig(**opt),
            DataConfig(vocab=cfg.vocab, seq_len=seq_len, global_batch=global_batch),
            pods=list(spec["pods"]), device=device,
            ecfg=ElasticConfig(checkpoint_dir=ckpt_dir, commit_every=spec["commit_every"],
                               checkpoint_every=spec["checkpoint_every"]))
        sync()
        n_params = sum(p.numel() for p in tr.state.params.parameters())
        log(f"elastic: {cfg.arch_id} {cfg.n_layers} layers, {n_params / 1e9:.4f} B params, "
            f"trainer built in {time.perf_counter() - t0:.1f} s; pods {list(spec['pods'])}")

        clock = HostClock()
        clock.wrap(tr.controller.sim, "run_for")
        clock.wrap(tr.controller, "commit")
        saves = []
        save = tr.save_checkpoint

        def timed_save():
            t_sums = time.perf_counter()
            sums = state_sums(tr.state)
            sync()
            t0 = time.perf_counter()
            save()
            t1 = time.perf_counter()
            path = os.path.join(ckpt_dir, f"step{tr.step:08d}_shard0.npz")
            saves.append(dict(step=tr.step, s=t1 - t0, with_sums_s=t1 - t_sums, sums=sums,
                              bytes=os.path.getsize(path),
                              durable_step=tr.controller.durable_step()))

        tr.save_checkpoint = timed_save
        rows, changes, restore = [], [], None
        for n, op, args in spec["schedule"]:
            for _ in range(n):
                epoch, clock.ms, n_saves = tr.controller.epoch, 0.0, len(saves)
                t0 = time.perf_counter()
                tr.run(1)
                wall = (time.perf_counter() - t0) * 1e3
                save_ms = sum(s["with_sums_s"] for s in saves[n_saves:]) * 1e3
                rows.append(dict(step=tr.step, epoch=epoch, loss=tr.losses[-1],
                                 ms=wall - save_ms, control_ms=clock.ms, save_ms=save_ms))
            if op == "restore_latest":
                sync()
                t0 = time.perf_counter()
                ok = tr.restore_latest()
                sync()
                restore = dict(ok=ok, step=tr.step, s=time.perf_counter() - t0,
                               sums=state_sums(tr.state))
            elif op is not None:
                t0 = time.perf_counter()
                tel = (tr.scale_to(list(args)) if op == "scale_to"
                       else tr.fail_and_replace(*args))
                changes.append(dict(op=op, args=list(args), after_step=tr.step,
                                    wall_ms=(time.perf_counter() - t0) * 1e3,
                                    activation_ms=tel["activation_ms"]))

        if dict(ops.LAUNCHES) != launches or Counter(ops.LAUNCH_SHAPES) != shapes:
            raise AssertionError(f"elastic: kernels launched: {dict(ops.LAUNCHES)}")
        tr.controller.check_safety()
        ctrl, ledger = tr.controller, tr.controller.ledger()
        remeshed = [tuple(e["pods"]) for e in tr.events if e["t"] == "remesh"]
        losses = [r["loss"] for r in rows]
        before = want["steps_before_restore"]
        first, replay = losses[restore["step"]], losses[before]
        replay_rel = abs(replay - first) / abs(first)
        second_rel = abs(losses[before + 1] - losses[restore["step"] + 1]) / abs(
            losses[restore["step"] + 1])
        out = dict(arch=cfg.arch_id, n_layers=cfg.n_layers, n_params=n_params, card=card,
                   stall_count=ctrl.dep.leader.stall_count, epoch=ctrl.membership()[0],
                   pods=list(ctrl.membership()[1]), durable_step=ctrl.durable_step(),
                   ledger_entries=len(ledger.history), retired_configs=ctrl.retired_config_count(),
                   changes=changes, replay_loss_rel=replay_rel, replay2_loss_rel=second_rel,
                   losses=losses)

        # the gates
        faults = []
        if out["stall_count"] != 0:
            faults.append(f"stall_count {out['stall_count']}")
        if remeshed != want["epochs"] or out["epoch"] != len(want["epochs"]) - 1 or tuple(
                out["pods"]) != want["epochs"][-1]:
            faults.append(f"epochs {remeshed}, ledger epoch {out['epoch']} {out['pods']}")
        if not all(c["activation_ms"] < ACTIVATION_MS_MAX for c in changes):
            faults.append(f"activation {[c['activation_ms'] for c in changes]}")
        if [s["step"] for s in saves] != want["checkpoints"] or any(
                s["durable_step"] != s["step"] for s in saves):
            faults.append(f"checkpoints {[(s['step'], s['durable_step']) for s in saves]}")
        if out["durable_step"] != want["restored_to"]:
            faults.append(f"durable step {out['durable_step']}")
        if not restore["ok"] or restore["step"] != want["restored_to"]:
            faults.append(f"restore {restore['ok']} to step {restore['step']}")
        elif restore["sums"] != saves[-1]["sums"]:
            bad = [k for k in restore["sums"] if restore["sums"][k] != saves[-1]["sums"][k]]
            faults.append(f"restored tensors differ from the saved ones: {bad[:8]}")
        if replay_rel > REPLAY_LOSS_RTOL:
            faults.append(f"replayed step {restore['step'] + 1}: loss {replay} vs {first}")
        if not all(math.isfinite(x) for x in losses) or not losses[before - 1] < losses[0]:
            faults.append(f"losses {losses}")

        # the readings
        by_epoch = {}
        for r in rows:
            by_epoch.setdefault(r["epoch"], []).append(r["ms"])
        medians = {e: statistics.median(ms) for e, ms in by_epoch.items()}
        # rows[i] ran step i + 1: a change after step k is followed by rows[k],
        # the restore by rows[before] (step 11 again)
        after = [rows[c["after_step"]] for c in changes] + [rows[before]]
        out.update(
            ms_per_step_by_epoch=medians,
            steps_after_change=[dict(step=r["step"], epoch=r["epoch"], ms=r["ms"],
                                     epoch_median_ms=medians[r["epoch"]],
                                     ratio=r["ms"] / medians[r["epoch"]]) for r in after],
            control_ms_per_step=statistics.median(r["control_ms"] for r in rows),
            control_ms_max=max(r["control_ms"] for r in rows),
            control_share=sum(r["control_ms"] for r in rows) / sum(r["ms"] for r in rows),
            checkpoint_gb=saves[-1]["bytes"] / 1e9 if saves else None,
            save_s=saves[-1]["s"] if saves else None, restore_s=restore["s"],
            replay_loss=[first, replay],
            host_peak_rss_gb=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9,
            steps=rows)
        if saves:
            out["save_gb_per_s"] = out["checkpoint_gb"] / out["save_s"]
            out["restore_gb_per_s"] = out["checkpoint_gb"] / out["restore_s"]
        log(f"elastic: ms/step by epoch [{card}]:",
            json.dumps({e: round(m, 2) for e, m in medians.items()}),
            "; steps after a change vs their epoch's median:",
            json.dumps([[s["step"], round(s["ms"], 2), round(s["ratio"], 3)]
                        for s in out["steps_after_change"]]))
        log(f"elastic: ms of each step [{card}] (a checkpoint's save taken out):",
            json.dumps([round(r["ms"], 2) for r in rows]))
        log(f"elastic: control plane host ms per step [{card}]: median "
            f"{out['control_ms_per_step']:.3f}, max {out['control_ms_max']:.3f}, "
            f"{out['control_share']:.3%} of the steps' wall")
        for c in changes:
            log(f"elastic: {c['op']}{tuple(c['args'])} after step {c['after_step']} [{card}]: "
                f"wall {c['wall_ms']:.3f} ms, active after {c['activation_ms']:.3f} simulated ms")
        if saves:
            log(f"elastic: checkpoint at step {saves[-1]['step']} [{card}]: "
                f"{out['checkpoint_gb']:.3f} GB, save {out['save_s']:.2f} s "
                f"({out['save_gb_per_s']:.3f} GB/s, commit included), restore "
                f"{out['restore_s']:.2f} s ({out['restore_gb_per_s']:.3f} GB/s); restored "
                f"tensors equal to the saved ones: {restore['sums'] == saves[-1]['sums']}; "
                f"the process's peak RSS {out['host_peak_rss_gb']:.1f} GB")
        log(f"elastic: replayed step {restore['step'] + 1} [{card}]: loss {replay!r} vs "
            f"{first!r} the first time, {replay_rel:.3e} relative (gate "
            f"{REPLAY_LOSS_RTOL}); the second replayed step {second_rel:.3e} (not gated)")
        log(f"elastic: ledger [{card}]: {out['ledger_entries']} entries, epoch {out['epoch']} "
            f"pods {out['pods']}, durable step {out['durable_step']}, "
            f"{out['retired_configs']} retired acceptor configs, stall_count "
            f"{out['stall_count']}, no kernel launch")
        log(f"elastic: losses [{card}]:", json.dumps([round(x, 4) for x in losses]))
        del tr
    if faults:
        raise AssertionError("elastic: " + "; ".join(faults))
    return out


# ---------------------------------------------------------------------------
# Phase 7: the launch tooling (the port's launch/: trace analysis, the
# dry-run's byte reckoning, the roofline) read against phases 3 to 5
# ---------------------------------------------------------------------------
def window_launches(spec, label, steps):
    """Each wrapper's launches in a profiled window of ``SLICES`` spec: one
    prefill, or ``steps`` decode steps."""
    prefill, per_step, ssd = spec["launches"]
    if label == "prefill":
        return {"flash_prefill": prefill, "flash_decode": 0, "ssd_intra_chunk": ssd}
    return {"flash_prefill": 0, "flash_decode": per_step * steps, "ssd_intra_chunk": 0}


def tooling_phase(card, paths, train, spec=TRAIN):
    """(a) In each slice's profiled prefill and decode windows (phase 4) the
    device trace shows each wrapper's kernels launched as often as the host
    counted and ``SLICES`` says (stablelm: 40 ``flash_prefill`` a prefill, 40
    ``flash_decode`` a decode step; mamba2: 64 ``ssd_intra_chunk`` a
    prefill).  (b) The dry-run's bytes at one device, reckoned on meta,
    equal the live tensors: each slice's parameters and decode state (phase
    3) and the 8-layer f32 training state (phase 5).  (c) The roofline of
    stablelm's decode step from ``count`` on meta, beside its measured
    ms/step.  Raises unless (a) and (b) hold; returns the readings."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.trace_analysis import count
    from repro_torch.models.sharding import policy_for
    from repro_torch.train import OptConfig

    t0 = time.perf_counter()
    out = dict(card=card, launches={}, bytes={})
    for arch, (_, _, rates) in paths.items():  # (a)
        for label, w in rates["profile"].items():
            want = window_launches(SLICES[arch], label, w["steps"])
            log(f"tooling: (a) {arch} {label} ({w['steps']} step(s)) [{card}]: device trace "
                f"{json.dumps(w['device_launches'])}, host {json.dumps(w['host_launches'])}, "
                f"expected {json.dumps(want)}")
            if w["device_launches"] != want or w["host_launches"] != want:
                raise AssertionError(f"tooling: {arch} {label} launches: device "
                                     f"{w['device_launches']}, host {w['host_launches']}, "
                                     f"expected {want}")
            out["launches"][f"{arch} {label}"] = w["device_launches"]

    for arch, (_, _, rates) in paths.items():  # (b), served
        live = rates["live_bytes"]
        cfg = get_config(arch).replace(**SLICES[arch].get("cut", {}))
        _, _, trees, specs_for = dryrun.serving_trees(cfg, rates["batch"], live["max_len"])
        reckoned = dryrun.one_device_bytes(trees, specs_for)
        row = dict(arch=arch, batch=rates["batch"], max_len=live["max_len"],
                   live_params=live["params"], reckoned_params=reckoned["params"],
                   live_decode_state=live["decode_state"],
                   reckoned_decode_state=reckoned["decode_state"],
                   allocated_after_init=live["allocated_after_init"],
                   peak_allocated=live["peak_allocated"])
        log(f"tooling: (b) {arch} [{card}]:", json.dumps(row))
        if (live["params"], live["decode_state"]) != (reckoned["params"],
                                                      reckoned["decode_state"]):
            raise AssertionError(f"tooling: {arch} live bytes differ from the dry-run's: {row}")
        out["bytes"][arch] = row
    cfg = get_config(spec["arch"]).replace(**spec["cut"])  # (b), trained
    _, trees, specs_for = dryrun.train_trees(cfg, OptConfig(**TRAIN_OPT),
                                             policy_for(cfg, "train"))
    reckoned = dryrun.one_device_bytes(trees, specs_for)
    live = train["live_bytes"]
    row = dict(arch=f"{spec['arch']} train ({cfg.n_layers} layers)",
               live_params=live["params"], reckoned_params=reckoned["params"],
               live_optimizer=live["optimizer"], reckoned_optimizer=reckoned["optimizer"],
               allocated_after_init=live["allocated_after_init"],
               peak_allocated=train["peak_gb"] * 1e9)
    log(f"tooling: (b) {row['arch']} [{card}]:", json.dumps(row))
    if (live["params"], live["optimizer"]) != (reckoned["params"], reckoned["optimizer"]):
        raise AssertionError(f"tooling: the training state's live bytes differ: {row}")
    out["bytes"]["train"] = row

    arch = "stablelm_12b"  # (c)
    rates = paths[arch][2]
    model, state, _, _ = dryrun.serving_trees(get_config(arch), rates["batch"],
                                              rates["live_bytes"]["max_len"])
    step = count(model.decode_step, state,
                 torch.zeros((rates["batch"], 1), dtype=torch.int32, device="meta"))
    terms = roofline.roofline_terms(flops_per_device=step.flops, bytes_per_device=step.bytes,
                                    traffic=dryrun.NO_TRAFFIC)
    bound_ms = max(terms["compute_s"], terms["memory_s"]) * 1e3
    out["decode_roofline"] = dict(
        arch=arch, flops=step.flops, bytes=step.bytes, compute_ms=terms["compute_s"] * 1e3,
        memory_ms=terms["memory_s"] * 1e3, dominant=terms["dominant"],
        measured_ms_per_step=rates["decode_ms_per_step"],
        bound_share=bound_ms / rates["decode_ms_per_step"],
        top_ops=step.top_ops(5))
    log(f"tooling: (c) {arch} decode step (B={rates['batch']}, cache "
        f"{rates['live_bytes']['max_len']}) [{card}]: {step.flops / 1e9:.2f} GFLOP, "
        f"{step.bytes / 1e9:.3f} GB (eager ops on meta, plain attention in the kernel's place)"
        f"; compute {terms['compute_s'] * 1e3:.4f} ms, memory {terms['memory_s'] * 1e3:.3f} ms "
        f"on the H100's peaks; measured {rates['decode_ms_per_step']:.2f} ms/step, "
        f"{bound_ms / rates['decode_ms_per_step']:.1%} of it")
    out["seconds"] = time.perf_counter() - t0
    log(f"tooling: phase 7 took {out['seconds']:.1f} s [{card}]")
    return out


# ---------------------------------------------------------------------------
# Phase 8: the consensus testbed (the port's core/: the nemesis, the
# heartbeat detector's failover into training, the scenarios over the
# simulator, TCP sockets and OS processes, the model checker)
# ---------------------------------------------------------------------------
# (a) stablelm-12b as phases 5 and 6 train it, under ElasticTrainer with the
# heartbeat detector at the reference's default timings (a probe every
# 0.02 s, silence past 0.08 s a miss, 2 misses a suspicion; pod3 the spare)
# and a nemesis schedule on the control plane's simulated clock: the
# detector cut off from pod1's acceptors from 0.0805 s to 0.1605 s, then
# pod1's acceptors killed (kill -9) at 0.1805 s.  No checkpoint: phase 6
# measures one, and a second 39 GB save would cost ~140 s.
#
# The reckoning, on the simulated clock (seeded, so both packages and every
# machine run it alike).  The controller's clock stands at 0.051 s when the
# trainer is built, and the detector, attached then, probes at 0.051 +
# 0.02 k.  A step runs the clock 0.002 s, each fifth step's StepRecord
# commit ~0.001 s more, so step k ends near 0.051 + 0.0022 k.  The
# partition: the last pong before it answers the probe of 0.071; those of
# 0.091 to 0.151 are cut, and the probe of 0.171 (after the heal, in step
# 55) finds 0.0999 s of silence: one miss, the partition guard.  Its pong
# resets the count before a second miss, so nothing is suspected.  The
# crash lands in step 60 (0.180 to 0.183); the last pong answers the probe
# of 0.171, the probes of 0.271 and 0.291 find 0.0999 and 0.1199 s of
# silence: two misses, pod1 suspected at 0.291, pod3 in its place, the new
# configuration active at 0.292 (1 simulated ms, under ACTIVATION_MS_MAX).
# By the clock alone the steps reach 0.291 at step ~109 (with
# Options(thrifty=False) the failover lands in step 110); but a StepRecord
# whose thrifty Phase-2 quorum (2 of the 3 acceptors, drawn from the seeded
# RNG) holds a dead acceptor waits for the failover.  Step 60's and 65's
# quorums miss pod1's acceptor and step 70's holds it, so step 70's commit
# runs the clock from 0.202 to 0.293: the failover and the ledger's epoch 1
# land in step 70, 110.5 simulated ms and 10 steps after the crash.  Twenty
# steps follow in epoch 1.
FAILOVER = dict(pods=("pod0", "pod1", "pod2"), spare="pod3", victim="pod1", commit_every=5,
                partition=(0.0805, 0.1605), crash_at=0.1805, steps=90,
                crash_step=60, failover_step=70, partition_guard_hits=1)
# The wall of the failover's step against its epoch's median, and of the step
# after it against the new epoch's.  Phase 6 on the H100 read the steps right
# after a change at 0.994 to 1.011 of their epoch's median over its runs,
# and one step of twenty at 1.016; the failover step adds the control
# plane's work for ~91 simulated ms (1.6 to 2.2 host ms on a CPU core,
# 0.6% of a 365 ms step).  5% is three times the farthest step seen.
STEP_RATIO_MAX = 1.05


def failover_schedule(nemesis, controller, spec=FAILOVER):
    """``spec``'s schedule, from the classes of ``nemesis`` (the port's
    ``core.nemesis`` or, in the tests, the reference's)."""
    victims = tuple(controller.pods[spec["victim"]].acceptor_addrs)
    t0, t1 = spec["partition"]
    return nemesis.Schedule("elastic_failover", 0, (
        nemesis.Event(t0, nemesis.Partition(("detector",), victims)),
        nemesis.Event(t1, nemesis.Heal()),
        *(nemesis.Event(spec["crash_at"], nemesis.Crash(a, clean=False)) for a in victims)))


def failover_gates(out, spec=FAILOVER, timed=True):
    """The gates of phase 8 (a) over its readings; returns the faults."""
    faults, rows = [], out["steps"]
    before_crash = [r for r in rows if r["sim_now"] < spec["crash_at"]]
    if any(r["failovers"] or r["ledger_epoch"] for r in before_crash):
        faults.append("a failover or an epoch before the crash")
    if before_crash[-1]["guard_hits"] != spec["partition_guard_hits"]:
        faults.append(f"partition guard hits {before_crash[-1]['guard_hits']}")
    if [(e["suspected"], e["replacement"]) for e in out["failover_log"]] != [
            (spec["victim"], spec["spare"])]:
        faults.append(f"failovers {out['failover_log']}")
    decided = next((r["step"] for r in rows if r["ledger_epoch"] == 1), None)
    want = [dict(step=0, pods=list(spec["pods"])),
            dict(step=decided, pods=list(out["membership"][1]))]
    if (out["remesh"] != want or out["pods"] != list(out["membership"][1])
            or out["membership"][0] != 1 or decided != spec["failover_step"]
            or out["crash_step"] != spec["crash_step"]):
        faults.append(f"remesh {out['remesh']}, ledger {out['membership']} decided at step "
                      f"{decided}, crash in step {out['crash_step']}")
    if out["stall_count"] != 0:
        faults.append(f"stall_count {out['stall_count']}")
    if out["violations"]:
        faults.append(f"nemesis violations {out['violations']}")
    if not out["failover_log"] or not all(
            e["activation_ms"] < ACTIVATION_MS_MAX for e in out["failover_log"]):
        faults.append(f"activation {[e.get('activation_ms') for e in out['failover_log']]}")
    losses = [r["loss"] for r in rows]
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        faults.append(f"losses {losses}")
    if out["launched"]:
        faults.append(f"kernels launched: {out['launched']}")
    if timed:
        for s in out["around_failover"]:
            if s["ratio"] > STEP_RATIO_MAX:
                faults.append(f"step {s['step']}: {s['ms']:.2f} ms, {s['ratio']:.3f} of its "
                              f"epoch's median (gate {STEP_RATIO_MAX})")
    return faults


def failover_phase(card, spec=FAILOVER, device="cuda", cfg=None, seq_len=TRAIN["seq_len"],
                   global_batch=TRAIN["global_batch"], opt=TRAIN_OPT):
    """Trains ``cfg`` (by default stablelm-12b at its published widths, cut
    as phase 5 cuts it) under the control plane with the failure detector
    and ``spec``'s nemesis schedule; raises unless every gate of
    ``failover_gates`` holds (the step times on CUDA only).  Returns the
    readings."""
    import gc
    import statistics
    import tempfile
    from collections import Counter
    import torch
    from repro_torch.coord import ElasticConfig, ElasticTrainer
    from repro_torch.core import nemesis
    from repro_torch.kernels import ops
    from repro_torch.train import OptConfig
    from repro_torch.train.data import DataConfig

    cuda = torch.device(device).type == "cuda"
    if cuda:  # phase 6's trainer (its step peaks at 61 GB) lives in a cycle
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        log(f"failover: {torch.cuda.memory_allocated() / 1e9:.3f} GB allocated before the "
            f"trainer [{card}]")
    if cfg is None:
        cfg = train_cut("failover")
    launches, shapes = dict(ops.LAUNCHES), Counter(ops.LAUNCH_SHAPES)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        t0 = time.perf_counter()
        tr = ElasticTrainer(
            cfg, OptConfig(**opt),
            DataConfig(vocab=cfg.vocab, seq_len=seq_len, global_batch=global_batch),
            pods=list(spec["pods"]), device=device,
            ecfg=ElasticConfig(checkpoint_dir=ckpt_dir, commit_every=spec["commit_every"],
                               checkpoint_every=spec["steps"] + 1))
        ctrl = tr.controller
        det = ctrl.attach_detector(spares=[spec["spare"]])
        nem = ctrl.dep.attach_nemesis(failover_schedule(nemesis, ctrl, spec))
        log(f"failover: {cfg.arch_id} {cfg.n_layers} layers, trainer built in "
            f"{time.perf_counter() - t0:.1f} s [{card}]; detector ping {det.ping_interval} s, "
            f"suspect after {det.suspect_after} s, {det.confirm_misses} misses; schedule "
            f"{nem.schedule!r}")
        clock = HostClock()
        clock.wrap(ctrl.sim, "run_for")
        clock.wrap(ctrl, "commit")
        rows = []
        for _ in range(spec["steps"]):
            epoch, clock.ms = tr.epoch, 0.0
            t0 = time.perf_counter()
            tr.run(1)
            rows.append(dict(step=tr.step, epoch=epoch, loss=tr.losses[-1],
                             ms=(time.perf_counter() - t0) * 1e3, control_ms=clock.ms,
                             sim_now=ctrl.sim.now, ledger_epoch=ctrl.membership()[0],
                             failovers=len(ctrl.failover_log),
                             guard_hits=det.false_positive_guard_hits))
        ctrl.check_safety()
        out = dict(arch=cfg.arch_id, n_layers=cfg.n_layers, card=card,
                   failover_log=list(ctrl.failover_log), event_log=list(nem.event_log),
                   violations=nem.final_check(), membership=ctrl.membership(),
                   pods=list(tr.pods), stall_count=ctrl.dep.leader.stall_count,
                   remesh=[dict(step=e["step"], pods=e["pods"]) for e in tr.events
                           if e["t"] == "remesh"],
                   crash_step=next(r["step"] for r in rows if r["sim_now"] >= spec["crash_at"]),
                   launched={k: v - launches.get(k, 0) for k, v in ops.LAUNCHES.items()
                             if v != launches.get(k, 0)}, steps=rows)
        if Counter(ops.LAUNCH_SHAPES) != shapes:
            out["launched"]["shapes"] = True
        by_epoch = {}
        for r in rows:
            by_epoch.setdefault(r["epoch"], []).append(r["ms"])
        medians = {e: statistics.median(ms) for e, ms in by_epoch.items()}
        fo = out["remesh"][-1]["step"]  # rows[i] ran step i + 1
        out.update(
            ms_per_step_by_epoch=medians,
            around_failover=[dict(step=r["step"], epoch=r["epoch"], ms=r["ms"],
                                  control_ms=r["control_ms"],
                                  epoch_median_ms=medians[r["epoch"]],
                                  ratio=r["ms"] / medians[r["epoch"]])
                             for r in rows[fo - 1:fo + 1]],
            control_ms_per_step=statistics.median(r["control_ms"] for r in rows),
            control_ms_max=max(r["control_ms"] for r in rows),
            detection_sim_ms=(out["failover_log"][0]["reconfig_started"] - spec["crash_at"]) * 1e3
            if out["failover_log"] else None,
            detection_steps=fo - out["crash_step"])
        if cuda:
            out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        faults = failover_gates(out, spec, timed=cuda)
        log(f"failover: ms/step by epoch [{card}]:",
            json.dumps({e: round(m, 2) for e, m in medians.items()}),
            "; the failover's step and the next vs their epoch's median:",
            json.dumps([[s["step"], round(s["ms"], 2), round(s["ratio"], 4)]
                        for s in out["around_failover"]]), f"(gate {STEP_RATIO_MAX})")
        log(f"failover: ms of each step [{card}]:", json.dumps([round(r["ms"], 2) for r in rows]))
        log(f"failover: detection [{card}]: crash in step {out['crash_step']} at "
            f"{spec['crash_at']} simulated s, {spec['victim']} suspected after "
            f"{out['detection_sim_ms']:.3f} simulated ms, the ledger's epoch 1 in step {fo} "
            f"({out['detection_steps']} steps later); partition guard hits "
            f"{[r['guard_hits'] for r in rows if r['sim_now'] < spec['crash_at']][-1]}")
        log(f"failover: control plane host ms per step [{card}]: median "
            f"{out['control_ms_per_step']:.3f}, max {out['control_ms_max']:.3f} (step "
            f"{max(rows, key=lambda r: r['control_ms'])['step']}), the failover's step "
            f"{out['around_failover'][0]['control_ms']:.3f}")
        log(f"failover: ledger [{card}]: membership {out['membership']}, trainer pods "
            f"{out['pods']}, failover_log {json.dumps(out['failover_log'])}, stall_count "
            f"{out['stall_count']}, violations {out['violations']}, remesh "
            f"{json.dumps(out['remesh'])}, kernel launches {out['launched'] or 'none'}")
        log(f"failover: nemesis event log [{card}]:", json.dumps(out["event_log"]))
        log(f"failover: losses [{card}]:", json.dumps([round(r["loss"], 4) for r in rows]))
        del tr, ctrl, det, nem
    if faults:
        raise AssertionError("failover: " + "; ".join(faults))
    return out


# (b) The testbed on the card's host.
TESTBED_SCENARIO = "leader_kill9_mid_phase2"  # over TCP sockets and over OS processes
TESTBED_TRANSPORTS = ("tcp", "proc")
TESTBED_MC = dict(max_depth=30, fault_budget=2, faults=("crash", "restart"))


def proc_cmdlines(proc):
    """Wraps ``proc.Supervisor`` so that each live worker's command line is
    read from ``/proc`` once the cluster is ready and again as it is shut
    down (a respawned worker too); returns {pid: (addr, line)} and the undo.
    A line read right after the spawn may still be empty."""
    seen, ready, shutdown = {}, proc.Supervisor.wait_ready, proc.Supervisor.shutdown

    def read(sup):
        for addr, p in sup.procs.items():
            if p.poll() is None:
                with open(f"/proc/{p.pid}/cmdline", "rb") as f:
                    seen[p.pid] = (addr, f.read().replace(b"\0", b" ").decode())

    def reading_ready(self, *args, **kw):
        ready(self, *args, **kw)
        read(self)

    def reading_shutdown(self, *args, **kw):
        read(self)
        return shutdown(self, *args, **kw)

    proc.Supervisor.wait_ready, proc.Supervisor.shutdown = reading_ready, reading_shutdown

    def undo():
        proc.Supervisor.wait_ready, proc.Supervisor.shutdown = ready, shutdown

    return seen, undo


def testbed_phase(card):
    """Every catalog scenario on the simulator, ``TESTBED_SCENARIO`` over
    each of ``TESTBED_TRANSPORTS`` (over "proc" each worker's command line
    must name ``repro_torch``), the model checker on single-decree with a crash
    budget of 2 (complete and safe) and on the mutant (found).  Raises on
    any fault; returns the readings."""
    import repro_torch.core as rc
    from repro_torch.core import mc, proc

    out, faults = dict(card=card, scenarios=[]), []
    for name in rc.SCENARIO_NAMES:
        t0 = time.perf_counter()
        r = rc.run_scenario(name, 0, transport="sim")
        out["scenarios"].append(dict(name=name, transport="sim", s=time.perf_counter() - t0,
                                     chosen=r.chosen_slots, completed=r.completed_commands,
                                     safe=r.safe))
        r.raise_if_unsafe(shrink=False)
    cmdlines, undo = proc_cmdlines(proc)
    try:
        for transport in TESTBED_TRANSPORTS:
            t0 = time.perf_counter()
            r = rc.run_scenario(TESTBED_SCENARIO, 0, transport=transport)
            out["scenarios"].append(dict(
                name=TESTBED_SCENARIO, transport=transport, s=time.perf_counter() - t0,
                chosen=r.chosen_slots, completed=r.completed_commands, safe=r.safe,
                events=len(r.event_log)))
            r.raise_if_unsafe(shrink=False)
            if not r.completed_commands:
                faults.append(f"{TESTBED_SCENARIO} over {transport}: no command completed")
    finally:
        undo()
    out["workers"] = len(cmdlines)
    wrong = [(a, c) for a, c in cmdlines.values()
             if "from repro_torch.core.proc import" not in c or "repro.co" in c]
    if ("proc" in TESTBED_TRANSPORTS and not cmdlines) or wrong:
        faults.append(f"proc workers' command lines: {wrong or 'none read'}")
    for family, bounds, expect in [("single_decree", TESTBED_MC, False),
                                   ("single_decree_mutated", dict(max_depth=30), True)]:
        res = mc.explore(family, mc.MCConfig(**bounds))
        out.setdefault("mc", []).append(dict(
            family=family, bounds=bounds, states=res.states, transitions=res.transitions,
            terminals=res.terminals, complete=res.complete, found=res.violation is not None,
            s=res.wall))
        if (res.violation is not None) != expect or (not expect and not res.complete):
            faults.append(f"mc {family}: complete {res.complete}, violation {res.violation}")
    for s in out["scenarios"]:
        log(f"testbed: {s['name']} over {s['transport']} [{card}]: {s['s']:.2f} s, "
            f"{s['chosen']} slots chosen, {s['completed']} commands completed, safe {s['safe']}")
    log(f"testbed: {out['workers']} proc workers read, each command line "
        f"{next(iter(cmdlines.values()))[1] if cmdlines else None!r}")
    for m in out["mc"]:
        log(f"testbed: mc {m['family']} {json.dumps(m['bounds'])} [{card}]: {m['s']:.2f} s, "
            f"{m['states']} states, {m['transitions']} transitions, {m['terminals']} "
            f"terminals, complete {m['complete']}, violation found {m['found']}")
    if faults:
        raise AssertionError("testbed: " + "; ".join(faults))
    return out


KERNELS = {
    "flash_prefill": dict(
        route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:97"),
    "flash_decode": dict(
        route="cuda", source="src/repro_torch/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:93"),
    "ssd_intra_chunk": dict(
        route="cuda", source="src/repro_torch/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan.py:76"),
}


def kernel_rows(checked, paths):
    """The ``kernels`` line's rows: one per kernel, from the checks of
    phase 2 (``checked``: a list of rows per (kernel, path)) and the
    launches of phase 3 (``paths``: per path its launches, launches by
    shape and rates)."""
    rows = []
    for name, meta in KERNELS.items():
        # One entry per (path, shape) at which the kernel ran, each with the
        # launches at that shape in the path's run and the check, times and
        # bound at that shape; the row is the first entry, the others follow
        # in other_paths.  Every shape a path ran must have been checked,
        # and every shape checked for a path must have run there.
        entries = []
        for arch, (launches, shapes, _) in paths.items():
            ran = {key[1]: n for key, n in shapes.items() if key[0] == name}
            if sum(ran.values()) != launches[name]:
                raise AssertionError(f"{name} on {arch}: launches by shape {ran} do not sum "
                                     f"to {launches[name]}")
            by_shape = {row["key"][1]: row for row in checked.get((name, arch), [])}
            if set(ran) != set(by_shape):
                raise AssertionError(f"{name} on {arch} ran at {sorted(ran)}, checked at "
                                     f"{sorted(by_shape)}")
            for shape, n in ran.items():
                row = by_shape[shape]
                entries.append(dict(
                    path=arch, launches=n, max_abs_err=row["max_abs_err"],
                    tol=row["tol"], ms=row["ms"], plain_ms=row["plain_ms"],
                    bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                    library_ms=row["library_ms"], shape=row["shape"], dtype=row["dtype"],
                    **{k: row[k] for k in ("causal", "ms_warm", "plain_ms_warm",
                                           "library_ms_warm", "cold_copies") if k in row}))
        if not entries:
            raise AssertionError(f"{name} was launched on no path")
        rows.append(dict(name=name, **meta, **entries[0], other_paths=entries[1:]))
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(subprocess.run([_build.nvcc_path(), "--version"], check=True, capture_output=True,
                       text=True).stdout.strip().splitlines()[-1])
    log(f"build: kernels built in {_build.timed_build():.1f} s")
    for row in kernel_resources():
        log(f"ptxas {row['family']}:", json.dumps(row))

    checked = {**kernel_phase(), **ssd_phase()}
    paths = {arch: slice_phase(card, arch, spec) for arch, spec in SLICES.items()}
    log(json.dumps({"kernels": kernel_rows(checked, paths)}))
    train = train_phase(card)
    elastic = elastic_phase(card)
    tooling = tooling_phase(card, paths, train)
    t0 = time.perf_counter()
    failover = failover_phase(card)
    testbed = testbed_phase(card)
    testbed_s = time.perf_counter() - t0
    log(card)
    for arch, (_, _, rates) in paths.items():
        log(f"rates {arch} [{card}]: prefill {rates['prefill_ms']:.2f} ms "
            f"(B={rates['batch']}, S={rates['prompt']}), decode "
            f"{rates['decode_ms_per_step']:.2f} ms/step, {rates['tok_per_s']:.1f} generated "
            f"tok/s through Engine.generate")
        log("rates:", json.dumps(rates))
    log(f"train rates {train['arch']} ({train['n_layers']} layers) [{card}]: "
        f"{train['ms_per_step']:.2f} ms/step (B={train['batch']}, S={train['seq_len']}), "
        f"{train['tok_per_s']:.0f} tok/s, {train['model_flops_per_step'] / 1e12:.2f} model TFLOP "
        f"a step, {train['mfu_bf16']:.1%} of 989 TFLOP/s bf16, peak memory "
        f"{train['peak_gb']:.1f} of 80 GB, optimizer {train['optimizer_share']:.1%} of a step, "
        f"device busy {train['busy_share']:.1%} of a profiled step")
    log("train rates:", json.dumps(train))
    log(f"elastic rates {elastic['arch']} ({elastic['n_layers']} layers) [{card}]: ms/step by "
        f"epoch {json.dumps({e: round(m, 2) for e, m in elastic['ms_per_step_by_epoch'].items()})}"
        f", control plane {elastic['control_ms_per_step']:.3f} ms a step, checkpoint "
        f"{elastic['checkpoint_gb']:.2f} GB saved in {elastic['save_s']:.1f} s and restored in "
        f"{elastic['restore_s']:.1f} s, stall_count {elastic['stall_count']}")
    log("elastic rates:", json.dumps(elastic))
    log("tooling:", json.dumps(tooling))
    log(f"failover rates {failover['arch']} ({failover['n_layers']} layers) [{card}]: ms/step "
        f"by epoch {json.dumps({e: round(m, 2) for e, m in failover['ms_per_step_by_epoch'].items()})}"
        f", the failover's step and the next at "
        f"{json.dumps([round(s['ratio'], 4) for s in failover['around_failover']])} of their "
        f"epoch's median, detection {failover['detection_sim_ms']:.3f} simulated ms "
        f"({failover['detection_steps']} steps), control plane "
        f"{failover['control_ms_per_step']:.3f} ms a step; phase 8 took {testbed_s:.1f} s")
    log("failover rates:", json.dumps(failover))
    log("testbed:", json.dumps(testbed))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
