"""Serving launcher: batched prefill + decode with the Engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm_12b \
      --batch 4 --prompt-len 512 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2_2p7b \
      --batch 4 --prompt-len 1024 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2_1p2b \
      --batch 4 --prompt-len 1024 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch seamless_m4t_large_v2 \
      --batch 4 --prompt-len 512 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2_2b \
      --batch 4 --prompt-len 4608 --gen 32    # past its 4096 window
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3_4b \
      --batch 4 --prompt-len 2048 --gen 32    # past its 1024 window
  PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2_15b \
      --batch 4 --prompt-len 512 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch chameleon_34b \
      --batch 4 --prompt-len 512 --gen 32     # 67.5 GB of bf16 weights
  PYTHONPATH=src python -m repro_torch.launch.serve --arch grok_1_314b --smoke \
      --device cpu    # also llama4_scout_17b_a16e; neither fits one card whole

The SSM and hybrid families take a prompt of at most ``ssm_chunk`` tokens
or a multiple of it.  The encoder-decoder's encoder reads a stub input,
frame embeddings (batch, ``enc_len``, d_model) drawn from the seed in the
config's type, in place of a speech frontend.

Runs on the CUDA device unless ``--device cpu`` is given; random weights
from ``--seed``.

``--trace`` records the call's spans (``repro_torch.tracing``) and prints,
after it, each span name's count and median host and device milliseconds
(``-`` off the card), then every counter::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2_2p7b --smoke \
      --device cpu --trace
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device, torch_dtype, tracing
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import get_model
from repro_torch.models.mamba2 import check_prompt_len
from repro_torch.serve import Engine


def device_label(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "CPU"


def print_spans(spans) -> None:
    """Each span name's count and median host and device milliseconds."""
    print("spans: name count host_ms device_ms (medians)")
    for name, (n, host, dev) in tracing.summary(spans).items():
        dev_ms = "-" if dev is None else f"{1e3 * dev:.3f}"
        print(f"  {name} {n} {1e3 * host:.3f} {dev_ms}")


def print_counters(counters) -> None:
    print("counters:")
    for name, value in counters.items():
        print(f"  {name} {value:.6g}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", action="store_true",
                    help="print the call's spans and the counters after it")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    if args.smoke:
        cfg = cfg.replace(dtype="float32")
    if cfg.family in ("ssm", "hybrid"):
        try:
            check_prompt_len(cfg, args.prompt_len)
        except ValueError as e:
            ap.error(str(e))
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = get_model(cfg).init(gen, device=device)
    tokens = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len), generator=gen,
                           device=device)
    batch = {"tokens": tokens}
    if cfg.family == "encdec":
        batch["enc_emb"] = torch.randn((args.batch, cfg.enc_len, cfg.d_model), generator=gen,
                                       device=device).to(torch_dtype(cfg.dtype))

    eng = Engine(model, max_len=args.prompt_len + args.gen + 1, device=device)
    if args.trace:
        tracing.enable()
    t0 = time.perf_counter()
    out = eng.generate(
        batch, args.gen, temperature=args.temperature,
        generator=gen if args.temperature > 0 else None,
    )
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    tracing.disable()
    print(f"arch={cfg.arch_id} batch={args.batch} prompt={args.prompt_len} "
          f"generated={out.steps} tokens/request")
    print(f"wall {dt:.2f}s -> {args.batch * out.steps / dt:.1f} tok/s "
          f"({device_label(device)}, first call, incl. kernel build)")
    for i in range(min(args.batch, 2)):
        print(f"  request {i}: {out.tokens[i].tolist()}")
    if args.trace:
        print_spans(tracing.drain())
        print_counters(tracing.counters())


if __name__ == "__main__":
    main()
