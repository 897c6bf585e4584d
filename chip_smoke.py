#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run on any fault:

1. Device and toolchain: the card's name and power limit, the torch, CUDA
   and nvcc versions; builds the CUDA kernels from ``src/repro_torch/csrc``.
2. Kernels: holds each hand-written kernel against its plain PyTorch version
   on the card at the main path's shapes (and at a window + softcap case, a
   ragged-S case and other head sizes), and times both, the bound and one
   library call; the ``{"kernels": [...]}`` line, printed after phase 3,
   adds the launch counts of the main path.
3. Slice: serves stablelm-12b at its published width (random weights from a
   seed, bf16) through ``Engine.generate``, checks that every attention
   call of prefill and decode launched the kernels, and holds the logits
   against a run of the same weights on the plain versions, teacher-forced
   on the same tokens; then repeats that comparison with the same draws in
   f32, where the two paths round alike.
4. Rates: prefill ms, decode ms per step and generated tokens per second.

The last line is ``{"ok": true, "device": {...}}``.  The script exits with
a non-zero code, and prints no result, when no CUDA device is present.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense tensor-core bf16; f32 without
TOL = {"float32": 2e-4, "bfloat16": 3e-2}  # as tests/kernels/test_kernels.py


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time per call.  A spin kernel holds the device while the host
    queues the timed calls, so host launch overhead is not counted."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)  # ~0.1 s at the H100's clock
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def close(out, want, dtype) -> float:
    """Max abs error; raises unless |out - want| <= tol * (1 + |want|)."""
    import torch

    tol = TOL[dtype_name(dtype)]
    diff = (out.float() - want.float()).abs()
    if not torch.isfinite(out.float()).all():
        raise AssertionError("kernel output is not finite")
    bad = diff > tol * (1 + want.float().abs())
    if bad.any():
        raise AssertionError(f"max abs err {diff.max().item():.3e} exceeds tol {tol}")
    return diff.max().item()


def bound_ms(bytes_moved: float, flops: float, dtype) -> tuple:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
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
               tol=TOL[dtype_name(dtype)])
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


def decode_case(gen, B, S, H, K, hd, dtype, lengths, *, window=None, softcap=None,
                measure=False):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref

    dev = "cuda"
    q = torch.randn(B, 1, H, hd, generator=gen, device=dev).to(dtype)
    kc = torch.randn(B, S, K, hd, generator=gen, device=dev).to(dtype)
    vc = torch.randn(B, S, K, hd, generator=gen, device=dev).to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    scale = hd ** -0.5
    kw = dict(scale=scale, window=window, softcap=softcap)

    def kernel():
        return ops.decode_attention(q, kc, vc, lens, **kw)

    def plain():
        return ref.decode_attention_ref(
            q[:, 0], kc.transpose(1, 2), vc.transpose(1, 2), lens, **kw
        )[:, None]

    err = close(kernel(), plain(), dtype)
    torch.cuda.synchronize()
    row = dict(shape=f"B={B} S={S} H={H} K={K} hd={hd} lengths={list(lengths)}",
               dtype=dtype_name(dtype), window=window, softcap=softcap, max_abs_err=err,
               tol=TOL[dtype_name(dtype)])
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

    def library():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2),
            attn_mask=mask, scale=scale, enable_gqa=True,
        )

    lib_ms = time_ms(library) if softcap is None else None
    row.update(ms=time_ms(kernel), plain_ms=time_ms(plain), bound_ms=b_ms, bound_by=b_by,
               library_ms=lib_ms)
    return row


def kernel_phase(B=4, S=512, H=32, K=8, hd=160, gen_steps=32):
    """Checks both kernels; returns their rows for the kernels line."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    S_cache = S + gen_steps + 1
    lengths = [S_cache, S + 1, S + gen_steps // 2, S + 8]
    main = {}
    for dtype in (bf16, f32):
        main[("flash_prefill", dtype)] = prefill_case(gen, B, S, H, K, hd, dtype, measure=True)
        main[("flash_decode", dtype)] = decode_case(
            gen, B, S_cache, H, K, hd, dtype, lengths, measure=True)
    extra = [
        prefill_case(gen, 1, 384, 8, 4, 256, f32, window=128, softcap=50.0),
        prefill_case(gen, 1, 384, 8, 4, 256, bf16, window=128, softcap=50.0),
        decode_case(gen, 2, 400, 8, 4, 256, f32, [400, 150], window=128, softcap=50.0),
        prefill_case(gen, 2, 333, 8, 2, 160, f32),  # ragged S
        prefill_case(gen, 2, 333, 8, 2, 160, bf16),
        prefill_case(gen, 1, 100, 4, 2, 160, f32, Sk=333, causal=False),  # Sq != Sk
        decode_case(gen, 3, 77, 4, 4, 160, f32, [77, 1, 40]),
        decode_case(gen, 64, 100, 8, 8, 64, bf16, [100, 1, 64, 65] * 16),  # no split
    ]
    for hd_x in (16, 32, 64, 128, 256):
        for dtype in (f32, bf16):
            extra.append(prefill_case(gen, 2, 200, 4, 2, hd_x, dtype))
            extra.append(decode_case(gen, 2, 300, 4, 2, hd_x, dtype, [300, 123]))
    for row in [*main.values(), *extra]:
        log("kernel check:", json.dumps(row))
    return main


# ---------------------------------------------------------------------------
# Phase 3: the slice at full width
# ---------------------------------------------------------------------------
# Logit tolerance of the kernel run against the plain-version run, bf16.  The
# plain path rounds the attention logits and the softmax weights to bf16
# (as the JAX model does); the kernels keep both in f32.  That moves each
# layer's attention output by about one bf16 step (2^-8 relative); over 40
# independent layers such steps add roughly in quadrature, sqrt(40) * 2^-8
# ~ 2.5% of the logits' RMS (std ~1.4).  Bounded at twice that, and by an
# absolute 0.25 (a few bf16 steps at |logit| ~ 8).
LOGIT_ATOL = 0.25
LOGIT_REL_RMS = 5e-2
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


def teacher_forced_logits(model, tokens, generated, max_len):
    """Prefill logits, then each decode step's logits fed the given tokens."""
    import torch

    logits, state = model.prefill(tokens, max_len=max_len)
    out = [logits]
    for t in range(generated.shape[1]):
        logits, state = model.decode_step(state, generated[:, t : t + 1])
        out.append(logits)
    return torch.stack([x[:, -1] for x in out], dim=1)  # (B, 1 + steps, V)


def slice_phase(card, batch=4, prompt=512, gen_steps=32, seed=0):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import LM, get_model
    from repro_torch.serve import Engine

    cfg = get_config("stablelm_12b")
    widths = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
              cfg.d_ff, cfg.vocab, cfg.dtype)
    if widths != (40, 5120, 32, 8, 160, 13824, 100352, "bfloat16"):
        raise AssertionError(f"stablelm_12b is not at its published widths: {widths}")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    model = get_model(cfg).init(gen, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"slice: {cfg.arch_id} {n_params / 1e9:.2f} B params "
        f"({n_params * 2 / 1e9:.1f} GB bf16) initialized in {time.perf_counter() - t0:.1f} s")
    tokens = torch.randint(0, cfg.vocab, (batch, prompt), generator=gen, device="cuda")
    max_len = prompt + gen_steps + 1
    engine = Engine(model, max_len=max_len)
    engine.generate({"tokens": tokens}, 2)  # warm-up: library handles, allocator

    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = engine.generate({"tokens": tokens}, gen_steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    log(f"slice: Engine.generate batch={batch} prompt={prompt} steps={out.steps} "
        f"wall={wall * 1e3:.1f} ms launches={launches}")
    if out.tokens.shape != (batch, gen_steps) or not ((out.tokens >= 0) &
                                                      (out.tokens < cfg.vocab)).all():
        raise AssertionError(f"bad tokens: shape {out.tokens.shape}")
    want = {"flash_prefill": cfg.n_layers, "flash_decode": cfg.n_layers * gen_steps}
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, expected {want}")

    # The same weights on the plain versions, teacher-forced on the tokens
    # the kernel run produced.
    plain = LM(cfg.replace(attn_impl="naive"))
    plain.load_state_dict(model.state_dict(), assign=True)
    generated = torch.from_numpy(out.tokens).to("cuda")
    bf16 = compare_logits(
        "bf16", teacher_forced_logits(model, tokens, generated, max_len),
        teacher_forced_logits(plain, tokens, generated, max_len), LOGIT_ATOL, LOGIT_REL_RMS)

    # Rates: prefill alone; decode per step from Engine.generate itself, as
    # the difference between this run and runs that decode once.
    prefill_ms, one_step_ms = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(tokens, max_len=max_len)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        engine.generate({"tokens": tokens}, 1)
        torch.cuda.synchronize()
        one_step_ms.append((time.perf_counter() - t0) * 1e3)
    decode_ms = (wall * 1e3 - sorted(one_step_ms)[1]) / (gen_steps - 1)
    profile_slice(model, tokens, max_len)
    rates = dict(card=card, prefill_ms=sorted(prefill_ms)[1], decode_ms_per_step=decode_ms,
                 generate_wall_ms=wall * 1e3, tok_per_s=batch * out.steps / wall,
                 batch=batch, prompt=prompt, steps=out.steps, logits_bf16=bf16)

    # The same draws in f32 (48.6 GB), where the kernel and plain paths
    # round alike: a tight check of the kernels' wiring at full width.
    del model, plain, engine
    torch.cuda.empty_cache()
    cfg32 = cfg.replace(dtype="float32")
    model = get_model(cfg32).init(torch.Generator(device="cuda").manual_seed(seed), "cuda")
    plain = LM(cfg32.replace(attn_impl="naive"))
    plain.load_state_dict(model.state_dict(), assign=True)
    f32_steps = 8
    ops.reset_launches()
    got = teacher_forced_logits(model, tokens, generated[:, :f32_steps], max_len)
    want = {"flash_prefill": cfg.n_layers, "flash_decode": cfg.n_layers * f32_steps}
    if dict(ops.LAUNCHES) != want:
        raise AssertionError(f"f32 kernel launches {dict(ops.LAUNCHES)}, expected {want}")
    rates["logits_f32"] = compare_logits(
        "f32", got, teacher_forced_logits(plain, tokens, generated[:, :f32_steps], max_len),
        LOGIT_ATOL_F32)
    del model, plain
    torch.cuda.empty_cache()
    return launches, rates


def profile_slice(model, tokens, max_len, decode_steps=8, top=8):
    """torch.profiler over one prefill and a few decode steps: wall time,
    the device's busy and idle share, and the kernels that take the most."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for label in ("prefill", "decode"):
        logits, state = model.prefill(tokens, max_len=max_len)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if label == "prefill":
                model.prefill(tokens, max_len=max_len)
            else:
                for _ in range(decode_steps):
                    nxt = torch.argmax(logits[:, -1], dim=-1)
                    nxt.cpu()
                    logits, state = model.decode_step(state, nxt[:, None])
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = prof.key_averages()
        kernels = [e for e in events if e.device_type.name == "CUDA"]
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        kernels.sort(key=lambda e: -e.self_device_time_total)
        log(f"profile {label}: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
            f"({busy_ms / wall_ms:.1%}), idle {1 - busy_ms / wall_ms:.1%}"
            + (f", {decode_steps} steps" if label == "decode" else ""))
        for e in kernels[:top]:
            log(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x  {e.key[:100]}")
        host = sorted((e for e in events if e.device_type.name == "CPU"),
                      key=lambda e: -e.self_cpu_time_total)
        log(f"profile {label}: host ops by self CPU time (profiler overhead included)")
        for e in host[:top]:
            log(f"  {e.self_cpu_time_total / 1e3:9.3f} ms {e.count:6d}x  {e.key[:100]}")


KERNELS = {
    "flash_prefill": dict(
        route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:97"),
    "flash_decode": dict(
        route="cuda", source="src/repro_torch/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:93"),
}


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

    checked = kernel_phase()
    launches, rates = slice_phase(card)
    steps = rates["steps"]
    rows = []
    for name, meta in KERNELS.items():
        row = checked[(name, torch.bfloat16)]
        per_request = launches[name]
        rows.append(dict(
            name=name, **meta, launches=launches[name], max_abs_err=row["max_abs_err"],
            tol=row["tol"], ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            launches_per_request=per_request,
            launches_per_decode_step=per_request // steps if name == "flash_decode" else None,
            shape=row["shape"], dtype=row["dtype"],
        ))
    log(json.dumps({"kernels": rows}))
    log(card)
    log(f"rates [{card}]: prefill {rates['prefill_ms']:.2f} ms (B={rates['batch']}, "
        f"S={rates['prompt']}), decode {rates['decode_ms_per_step']:.2f} ms/step, "
        f"{rates['tok_per_s']:.1f} generated tok/s through Engine.generate")
    log("rates:", json.dumps(rates))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
