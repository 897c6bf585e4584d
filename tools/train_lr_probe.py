#!/usr/bin/env python3
"""Which learning rate lets the train phase of ``chip_smoke.py`` descend.

    python3 tools/train_lr_probe.py [--out FILE]

Trains ``chip_smoke.TRAIN``'s model (stablelm-12b at its published widths,
cut to 8 layers, bf16 forward on f32 masters) from the same init and
batches as the train phase, once per optimizer setting: ten steps and one
with ``microbatches=2``, each on the next pipeline batch.  For every step
it prints the loss before the step, the loss of the same batch after it
(with autograd recording, as in training) and the grad norm; the settings
are the default warm-up, shorter warm-ups at the default lr, and constant
small learning rates.  Prints one JSON line per setting and writes them to
``--out`` (``build/train_lr_probe.json`` by default).  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

SETTINGS = [dict(), dict(warmup_steps=20), dict(warmup_steps=10), dict(warmup_steps=2),
            dict(lr=1e-5, warmup_steps=1), dict(lr=5e-6, warmup_steps=1),
            dict(lr=3e-6, warmup_steps=1)]


def main() -> int:
    import torch
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.train import OptConfig, init_state, make_train_step
    from repro_torch.train.data import DataConfig, TokenPipeline
    from repro_torch.train.train_loop import make_loss_fn

    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=os.path.join(ROOT, "build", "train_lr_probe.json"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("train_lr_probe: no CUDA device", file=sys.stderr)
        return 1
    spec = chip_smoke.TRAIN
    cfg = get_config(spec["arch"]).replace(**spec["cut"])
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=spec["seq_len"],
                                    global_batch=spec["global_batch"]))
    n = spec["steps"]
    batches = [pipe.torch_batch_at(i) for i in range(n + 1)]
    loss_fn = make_loss_fn(cfg)
    card = chip_smoke.card_line()
    rows = []
    for kw in SETTINGS:
        ocfg = OptConfig(**kw)
        state = init_state(cfg, ocfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        steps = []
        for i in range(n + 1):
            step = make_train_step(cfg, ocfg, microbatches=1 if i < n else 2)
            state, m = step(state, batches[i])
            steps.append(dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                              lr=float(m["lr"]),
                              loss_after=loss_fn(state.params, batches[i])[0].item()))
        row = dict(card=card, opt=kw, steps=steps,
                   descends=all(s["loss_after"] < s["loss"] for s in steps))
        rows.append(row)
        print(json.dumps(row), flush=True)
        del state
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
