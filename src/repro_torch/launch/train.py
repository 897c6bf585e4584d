"""Training launcher: consensus-governed elastic training.

  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm_12b --steps 60 \
      --smoke --device cpu --pods pod0,pod1 [--scale-at 20=pod0,pod1,pod2] \
      [--fail-at 40=pod1:podX]

--smoke uses the reduced config in f32; without it the full config is
instantiated in its own type on f32 masters, which does not fit one card:
stablelm-12b's masters and Adam moments alone are 12.14 B params x 12 B
(~146 GB), ~194 GB with the step's gradients (``chip_smoke.py`` trains 8
of its 40 layers).  The control plane (Matchmaker MultiPaxos) commits step
records, checkpoint manifests and membership changes to the replicated
ledger throughout.  Runs on the CUDA device unless ``--device cpu`` is
given.

On several devices, one process each, under ``torchrun``:

  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
      --arch stablelm_12b --smoke --pods pod0,pod1,pod2,pod3 ...

With ``WORLD_SIZE`` above 1 in the environment each process joins the
default group (NCCL on CUDA, gloo on the CPU), trains on the card of its
``LOCAL_RANK``, and the trainer meshes the group's ranks; only rank 0
prints.  Without it the launcher runs in one process, pods logical on its
device.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import tempfile

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.coord import ElasticConfig, ElasticTrainer
from repro_torch.train import OptConfig
from repro_torch.train.data import DataConfig

# The ranks wait in a collective while rank 0 writes a checkpoint (stablelm's
# 8 layers: 39 GB, 80-200 s on an H100 machine), so the group's timeout is
# longer than a save.
GROUP_TIMEOUT = datetime.timedelta(minutes=30)


def join_group(device: str):
    """Under ``torchrun`` (``WORLD_SIZE`` > 1): joins the default group and
    returns this rank's device, the card of its ``LOCAL_RANK`` on CUDA;
    else returns ``device`` and joins nothing."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return device
    import torch
    import torch.distributed as dist

    from repro_torch import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", timeout=GROUP_TIMEOUT, device_id=dev)
    else:
        dist.init_process_group("gloo", timeout=GROUP_TIMEOUT)
    return dev


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--pods", default="pod0")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--checkpoint-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--scale-at", action="append", default=[], metavar="STEP=pods")
    ap.add_argument("--fail-at", action="append", default=[], metavar="STEP=dead:replacement")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = join_group(args.device)
    try:
        run(args, device)
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def run(args, device) -> None:
    import torch.distributed as dist

    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    cfg = cfg.replace(dtype="float32" if args.smoke else cfg.dtype)
    dcfg = DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch, seed=0
    )
    ocfg = OptConfig(lr=args.lr, warmup_steps=10, total_steps=max(args.steps, 100))
    trainer = ElasticTrainer(
        cfg,
        ocfg,
        dcfg,
        pods=args.pods.split(","),
        ecfg=ElasticConfig(checkpoint_dir=args.checkpoint_dir),
        device=device,
    )

    scale_at = {int(k): v.split(",") for k, v in (x.split("=") for x in args.scale_at)}
    fail_at = {}
    for x in args.fail_at:
        step, spec = x.split("=")
        dead, repl = spec.split(":")
        fail_at[int(step)] = (dead, repl)

    while trainer.step < args.steps:
        nxt = min(
            [s for s in list(scale_at) + list(fail_at) if s > trainer.step]
            + [args.steps]
        )
        trainer.run(nxt - trainer.step)
        if trainer.step in scale_at:
            tel = trainer.scale_to(scale_at.pop(trainer.step))
            if rank0:
                print(f"[step {trainer.step}] scaled -> {trainer.pods} "
                      f"(active in {tel['activation_ms']:.2f} simulated ms)")
        if trainer.step in fail_at:
            dead, repl = fail_at.pop(trainer.step)
            tel = trainer.fail_and_replace(dead, repl)
            if rank0:
                print(f"[step {trainer.step}] failover {dead}->{repl} "
                      f"(active in {tel['activation_ms']:.2f} simulated ms)")
        if rank0 and trainer.losses:
            print(f"[step {trainer.step}] loss={trainer.losses[-1]:.4f} "
                  f"epoch={trainer.epoch} pods={trainer.pods}")

    trainer.controller.check_safety()
    if not rank0:
        return
    ledger = trainer.controller.ledger()
    print(json.dumps({
        "final_loss": trainer.losses[-1],
        "ledger_last_step": ledger.last_step,
        "ledger_durable_step": ledger.durable_step,
        "membership_epoch": ledger.epoch,
        "ledger_entries": len(ledger.history),
        "events": trainer.events,
    }, indent=1, default=str))


if __name__ == "__main__":
    main()
