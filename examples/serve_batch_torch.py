"""Batched serving demo of the PyTorch port: prefill a batch of prompts,
decode with greedy and temperature sampling, across five families (dense
sliding-window, SSM, hybrid, encoder-decoder, MoE), on the f32 smoke
configs.

  PYTHONPATH=src python examples/serve_batch_torch.py               # the CUDA card
  PYTHONPATH=src python examples/serve_batch_torch.py --device cpu

The counterpart of examples/serve_batch.py, which serves the JAX package.
"""

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_smoke_config
from repro_torch.models import get_model
from repro_torch.serve import Engine

ARCHS = ["gemma2_2b", "mamba2_2p7b", "zamba2_1p2b", "seamless_m4t_large_v2", "grok_1_314b"]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    for arch in ARCHS:
        cfg = get_smoke_config(arch).replace(dtype="float32")
        gen = torch.Generator(device=device).manual_seed(0)
        model = get_model(cfg).init(gen, device=device)
        B, P, G = 4, 12, 16
        batch = {"tokens": torch.randint(0, cfg.vocab, (B, P), generator=gen, device=device)}
        if cfg.family == "encdec":
            batch["enc_emb"] = torch.randn((B, cfg.enc_len, cfg.d_model), generator=gen,
                                           device=device)

        eng = Engine(model, max_len=P + G + 1, device=device)
        t0 = time.perf_counter()
        greedy = eng.generate(batch, G)
        t1 = time.perf_counter()
        sampled = eng.generate(batch, G, temperature=0.8,
                               generator=torch.Generator(device=device).manual_seed(7))
        print(f"{cfg.arch_id:22s} ({cfg.family:6s}) prefill+decode {G} tokens x{B} reqs "
              f"in {t1 - t0:.2f}s on {device.type} (first call)")
        print(f"  greedy : {greedy.tokens[0].tolist()}")
        print(f"  sampled: {sampled.tokens[0].tolist()}")
        # greedy decoding is deterministic
        again = eng.generate(batch, G)
        assert (again.tokens == greedy.tokens).all()
    print("all engines deterministic under greedy decoding")


if __name__ == "__main__":
    main()
