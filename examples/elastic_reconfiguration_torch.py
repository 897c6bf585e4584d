"""End-to-end run of the PyTorch port: train a small LM while the
Matchmaker-MultiPaxos control plane scales the cluster up, down, survives
a pod failure, and certifies checkpoint durability (GC Scenario 3).

This is the paper -> framework bridge in action: membership epochs are
consensus rounds; the 'zero-stall reconfiguration' claim becomes 'no
training step waits on the control plane'.

  PYTHONPATH=src python examples/elastic_reconfiguration_torch.py               # the CUDA card
  PYTHONPATH=src python examples/elastic_reconfiguration_torch.py --device cpu --steps 5

The counterpart of examples/elastic_reconfiguration.py, which trains the
JAX package; ``--steps`` is the steps of each of the four phases.
"""

import argparse
import tempfile

import numpy as np

from repro_torch.configs import get_smoke_config
from repro_torch.coord import ElasticConfig, ElasticTrainer
from repro_torch.train import OptConfig
from repro_torch.train.data import DataConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=50)
    args = ap.parse_args(argv)
    n = args.steps

    cfg = get_smoke_config("gemma2_2b").replace(dtype="float32")
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=8, seed=0)
    ocfg = OptConfig(lr=3e-3, warmup_steps=10, total_steps=400)

    with tempfile.TemporaryDirectory() as ckpt:
        trainer = ElasticTrainer(
            cfg, ocfg, dcfg, pods=["pod0"],
            ecfg=ElasticConfig(checkpoint_dir=ckpt, checkpoint_every=25, commit_every=5),
            device=args.device,
        )

        print("phase 1: single pod")
        trainer.run(n)
        print(f"  loss {np.mean(trainer.losses[:5]):.3f} -> {np.mean(trainer.losses[-5:]):.3f}")

        print("phase 2: scale up to 3 pods (proactive reconfiguration)")
        tel = trainer.scale_to(["pod0", "pod1", "pod2"])
        print(f"  new membership active after {tel['activation_ms']:.2f} simulated ms")
        trainer.run(n)

        print("phase 3: pod1 dies; control plane reconfigures around it")
        tel = trainer.fail_and_replace("pod1", "pod3")
        print(f"  replacement active after {tel['activation_ms']:.2f} simulated ms")
        trainer.run(n)

        print("phase 4: scale back down to 1 pod")
        trainer.scale_to(["pod0"])
        trainer.run(n)

    trainer.controller.check_safety()
    ledger = trainer.controller.ledger()
    print(f"\nfinal loss:      {trainer.losses[-1]:.3f} "
          f"(started {trainer.losses[0]:.3f}; finite: {all(np.isfinite(trainer.losses))})")
    print(f"ledger:          {len(ledger.history)} entries, last step {ledger.last_step}, "
          f"durable step {ledger.durable_step} (checkpoint certified on f+1 replicas)")
    print(f"membership epoch {ledger.epoch}; ledger stalls: "
          f"{trainer.controller.dep.leader.stall_count} (zero-stall reconfiguration)")
    print(f"retired acceptor configs: {trainer.controller.retired_config_count()} "
          f"(released pods are safe to shut down)")
    print("safety: OK")


if __name__ == "__main__":
    main()
