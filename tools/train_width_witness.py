#!/usr/bin/env python3
"""Whether the JAX reference's loss rises at full width as the port's does.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/train_width_witness.py \
        [--layers 1] [--lrs 3e-6 3e-5 3e-4] [--out FILE]

On the CPU: ``stablelm_12b`` at its published layer widths (d_model 5120,
32 / 8 heads of 160, d_ff 13824, bf16 forward on f32 masters), cut to
``--layers`` layers and a vocabulary of 8192 so that both packages'
train states fit a host's memory, trained from the same masters (the port's
``init_state``, bridged to JAX with ``weights.train_state_to_jax``) on the
same three ``TokenPipeline`` batches (4 x 128) by the port's ``make_train_step``
and the reference's, once per learning rate of ``--lrs`` (OptConfig's
defaults, a warm-up of 1).  For every step it records the loss before the step, the
loss of the same batch after it and the grad norm, on each side.

The two sides are alike when at every step they agree on whether the step
raised or lowered its batch's loss, and their losses lie within 2% of each
other (both forwards round to bf16 at the same places but sum in other
orders; the first Adam steps are ~lr * sign(g), so an element whose
gradient the two sides' sums set to other signs moves 2 lr apart).

Prints one JSON line per learning rate and writes them to ``--out``
(``build/train_width_witness.json`` by default).  Imports both packages,
as the CPU tests do; each side's state lives alone in memory (~11 GB at
one layer).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

BATCH, SEQ, VOCAB, STEPS = 4, 128, 8192, 3
LOSS_RTOL = 0.02


def port_run(cfg, ocfg_kw, init, batches):
    import torch
    from repro_torch import train
    from repro_torch.train.train_loop import make_loss_fn
    from repro_torch.weights import train_state_from_jax

    state = train_state_from_jax(init, cfg, device="cpu")
    step, loss_fn = train.make_train_step(cfg, train.OptConfig(**ocfg_kw)), make_loss_fn(cfg)
    rows = []
    for b in batches:
        tb = {k: torch.from_numpy(v) for k, v in b.items()}
        state, m = step(state, tb)
        with torch.no_grad():
            after = float(loss_fn(state.params, tb)[0])
        rows.append(dict(loss=float(m["loss"]), loss_after=after, grad_norm=float(m["grad_norm"])))
    return rows


def jax_run(cfg, ocfg_kw, init, batches):
    import jax
    import jax.numpy as jnp
    from repro import train
    from repro.train import optimizer
    from repro.train.train_loop import make_loss_fn

    state = train.TrainState(
        params=jax.tree.map(jnp.asarray, init.params),
        opt=optimizer.AdamState(m=jax.tree.map(jnp.asarray, init.opt.m),
                                v=jax.tree.map(jnp.asarray, init.opt.v),
                                step=jnp.asarray(init.opt.step)),
        step=jnp.asarray(init.step))
    step = jax.jit(train.make_train_step(cfg, train.OptConfig(**ocfg_kw)), donate_argnums=0)
    loss_fn = jax.jit(lambda p, b: make_loss_fn(cfg)(p, b)[0])
    rows = []
    for b in batches:
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        state, m = step(state, jb)
        rows.append(dict(loss=float(m["loss"]), loss_after=float(loss_fn(state.params, jb)),
                         grad_norm=float(m["grad_norm"])))
    return rows


def alike(port, ref) -> bool:
    return all((p["loss_after"] > p["loss"]) == (r["loss_after"] > r["loss"])
               and abs(p["loss"] - r["loss"]) <= LOSS_RTOL * abs(r["loss"])
               and abs(p["loss_after"] - r["loss_after"]) <= LOSS_RTOL * abs(r["loss_after"])
               for p, r in zip(port, ref))


def main() -> int:
    import torch
    from repro.configs import get_config as jax_config
    from repro_torch import train
    from repro_torch.configs import get_config
    from repro_torch.train.data import DataConfig, TokenPipeline
    from repro_torch.weights import train_state_to_jax

    parser = argparse.ArgumentParser()
    parser.add_argument("--layers", type=int, default=1)
    parser.add_argument("--lrs", type=float, nargs="+", default=[3e-6, 3e-5, 3e-4])
    parser.add_argument("--out", default=os.path.join(ROOT, "build", "train_width_witness.json"))
    args = parser.parse_args()
    cut = dict(n_layers=args.layers, vocab=VOCAB)
    cfg, jcfg = get_config("stablelm_12b").replace(**cut), jax_config("stablelm_12b").replace(**cut)
    state = train.init_state(cfg, train.OptConfig(), torch.Generator().manual_seed(0), "cpu")
    init = train_state_to_jax(state)
    del state
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH))
    batches = [pipe.batch_at(i) for i in range(STEPS)]
    rows = []
    for lr in args.lrs:
        ocfg_kw = dict(lr=lr, warmup_steps=1)
        port = port_run(cfg, ocfg_kw, init, batches)
        gc.collect()
        ref = jax_run(jcfg, ocfg_kw, init, batches)
        gc.collect()
        row = dict(arch="stablelm_12b", cut=cut, batch=BATCH, seq_len=SEQ, opt=ocfg_kw,
                   port=port, jax=ref, alike=alike(port, ref),
                   port_rises=[p["loss_after"] > p["loss"] for p in port],
                   jax_rises=[r["loss_after"] > r["loss"] for r in ref])
        rows.append(row)
        print(json.dumps(row), flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    return 0 if all(r["alike"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
