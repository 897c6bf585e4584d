#!/usr/bin/env python3
"""Stacked layer weights read by ``w[i]`` against one ``unbind``, in a train step.

    python3 tools/train_stack_ab.py [--out FILE]

The model reads its stacked (L, ...) weights through ``_Stacked.layers``,
one ``torch.unbind`` of each stack a forward, whose backward stacks the
layers' gradients once.  Reading ``w[i]`` per layer instead makes each
layer's backward write a zero-filled gradient of the whole stack and add
it in.  This trains ``chip_smoke.TRAIN``'s model (stablelm-12b at its
published widths, 8 of 40 layers, bf16 forward on f32 masters, batch
4 x 512, ``chip_smoke.TRAIN_OPT``) with each reading in turns (unbind,
select, select, unbind) after two warm-up steps, and
prints each step's ms and peak memory, with the card's name and power
limit.  Writes the JSON line to ``--out`` (``build/train_stack_ab.json``
by default).  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


def select_layers(self):
    """Each layer's weights as ``layers()`` gives them, read by ``w[i]``."""
    def one(m, i):
        p = {n: w[i] for n, w in m.named_parameters(recurse=False)}
        p.update((n, one(child, i)) for n, child in m.named_children())
        return p

    return [one(self, i) for i in range(next(self.parameters()).shape[0])]


def main() -> int:
    import torch
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.train import OptConfig, init_state, make_train_step
    from repro_torch.train.data import DataConfig, TokenPipeline

    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=os.path.join(ROOT, "build", "train_stack_ab.json"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("train_stack_ab: no CUDA device", file=sys.stderr)
        return 1
    spec = chip_smoke.TRAIN
    cfg = get_config(spec["arch"]).replace(**spec["cut"])
    ocfg = OptConfig(**chip_smoke.TRAIN_OPT)
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=spec["seq_len"],
                                    global_batch=spec["global_batch"]))
    batches = [pipe.torch_batch_at(i) for i in range(3)]
    state = init_state(cfg, ocfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    step = make_train_step(cfg, ocfg)
    for b in batches[:2]:
        state, _ = chip_smoke.timed_step(step, state, b)
    reads = {"unbind": lm._Stacked.layers, "select": select_layers}
    rows = {k: [] for k in reads}
    try:
        for name in ("unbind", "select", "select", "unbind"):
            lm._Stacked.layers = reads[name]
            state, row = chip_smoke.timed_step(step, state, batches[2])
            rows[name].append(dict(ms=row["ms"], peak_gb=row["peak_gb"]))
    finally:
        lm._Stacked.layers = reads["unbind"]
    out = dict(card=chip_smoke.card_line(), arch=spec["arch"], n_layers=cfg.n_layers,
               batch=spec["global_batch"], seq_len=spec["seq_len"], reads=rows,
               median_ms={k: statistics.median(r["ms"] for r in v) for k, v in rows.items()},
               peak_gb={k: max(r["peak_gb"] for r in v) for k, v in rows.items()})
    print(json.dumps(out), flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(json.dumps(out) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
