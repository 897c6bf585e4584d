#!/usr/bin/env python3
"""Where a checkpoint's save and restore spend their time, piece by piece.

    python3 tools/checkpoint_probe.py [--out FILE]

Draws ``chip_smoke.TRAIN``'s state (stablelm-12b at its published widths,
8 of 40 layers: f32 masters, m and v, ~39 GB) on the card and runs the
operations of ``repro_torch.train.checkpoint.save`` and ``restore`` in
their order, through the module's own pieces, summing each piece's time
over the leaves: the save's device-to-host copy of a leaf and the write of
its npz member (hashed as it goes to the file, zip's CRC included); the
restore's sha256 of the file in chunks, the read of each member and the
host-to-device copy into the state.  Prints each piece's seconds and GB/s
with the card's name and power limit, and writes the JSON line to
``--out`` (``build/checkpoint_probe.json`` by default).  The shard goes to
a temporary directory, removed at the end.  Needs one CUDA card, the host
memory of a leaf (2.3 GB) and ~41 GB of disk.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import zipfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


def main() -> int:
    import numpy as np
    import torch
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.train import OptConfig, checkpoint, init_state

    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=os.path.join(ROOT, "build", "checkpoint_probe.json"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("checkpoint_probe: no CUDA device", file=sys.stderr)
        return 1
    card = chip_smoke.card_line()
    spec = chip_smoke.TRAIN
    cfg = get_config(spec["arch"]).replace(**spec["cut"])
    state = init_state(cfg, OptConfig(**chip_smoke.TRAIN_OPT),
                       torch.Generator(device="cuda").manual_seed(0), "cuda")
    names, leaves = checkpoint._leaf_paths(state)
    torch.cuda.synchronize()
    times = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        times[name] = times.get(name, 0.0) + time.perf_counter() - t0
        return out

    with tempfile.TemporaryDirectory() as tmp:
        chip_smoke.elastic_preflight(chip_smoke.checkpoint_bytes(cfg),
                                     chip_smoke.largest_leaf_bytes(cfg), tmp)
        path = os.path.join(tmp, "step00000000_shard0.npz")
        entries = []
        with open(path, "wb") as f:
            writer = checkpoint._HashingWriter(f)
            with zipfile.ZipFile(writer, mode="w") as zf:
                for i, (name, leaf) in enumerate(zip(names, leaves)):
                    arr, dtype = timed("save_device_to_host", lambda: checkpoint._to_numpy(leaf))

                    def write():
                        with zf.open(checkpoint._member(f"leaf{i}"), "w",
                                     force_zip64=True) as member:
                            np.lib.format.write_array(member, arr, allow_pickle=False)

                    timed("save_write_hashed", write)
                    entries.append(dict(name=name, key=f"leaf{i}", shape=list(arr.shape),
                                        dtype=dtype))
                    del arr
        nbytes = os.path.getsize(path)
        timed("restore_sha256", lambda: checkpoint._digest(path))

        @torch.no_grad()
        def to_device(leaf, src):
            leaf.copy_(src.to(leaf.dtype))
            torch.cuda.synchronize()

        with np.load(path) as z:
            for leaf, e in zip(leaves, entries):
                src = timed("restore_read_member", lambda: checkpoint._stored_tensor(z, e))
                timed("restore_host_to_device", lambda: to_device(leaf, src))
                del src
    gb = nbytes / 1e9
    row = dict(card=card, arch=cfg.arch_id, n_layers=cfg.n_layers, leaves=len(names),
               checkpoint_gb=gb, seconds=times,
               gb_per_s={k: gb / v for k, v in times.items()},
               save_s=sum(v for k, v in times.items() if k.startswith("save")),
               restore_s=sum(v for k, v in times.items() if k.startswith("restore")))
    for k, v in times.items():
        print(f"checkpoint probe [{card}]: {k} {v:.2f} s ({gb / v:.3f} GB/s)")
    print(f"checkpoint probe [{card}]: {gb:.3f} GB, save pieces {row['save_s']:.2f} s, "
          f"restore pieces {row['restore_s']:.2f} s")
    line = json.dumps(row)
    print(line)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
