#!/usr/bin/env python3
"""The elastic trainer on several cards, one pod a card, against one card.

    python3 tools/elastic_cards.py [--world 4] [--out build/elastic_cards.json]
    PYTHONPATH=src python3 tools/elastic_cards.py --device cpu --smoke   # gloo, f32 smoke

One process a card, joined by NCCL (gloo on the CPU) through
``tcp://localhost`` on a free port.  stablelm-12b at its published widths
and ``chip_smoke.TRAIN``'s cut (8 layers; with ``--smoke`` its f32 smoke
config), batch 4 x 512, ``TRAIN_OPT``, under ``ElasticTrainer`` with
``devices_per_pod=1`` through phase 6's schedule (``chip_smoke.ELASTIC``):
pods pod0-pod2 on cards 0-2, card 3 outside the mesh; after 6 steps a
fourth pod (card 3 joins and receives its shards from card 0); after 4
more, back to three; after 4 more, pod2 fails and pod4 takes its row (card
2); after 4 more, the step-10 checkpoint is restored; 2 steps more.  Then
card 0 alone runs the same schedule from the same seed, as phase 6 does
(``chip_smoke.elastic_phase``, pods logical on one device), and a control:
the first 12 steps again with one master element moved by one f32 rounding
step.  Checks:

(a) the control plane is the one-card run's: the events (but the mesh's
    device counts), the ledger's entries, epoch, pods and durable step, no
    stall, safety, each change active within ``ACTIVATION_MS_MAX``;
(b) each re-mesh moves the state exactly: every leaf, gathered whole, has
    the same digest (an exact integer fingerprint of its bits and their
    places) after the move as before;
(c) each step's loss is within ``LOSS_RTOL`` of the one-card run's
    (the control's distance from the one-card run printed beside it);
(d) the checkpoint on the mesh: the restored state has the digests of the
    state saved at step 10, the replayed step 11 is within
    ``REPLAY_LOSS_RTOL`` of the first step 11, and each rank's peak host
    RSS during the save and during the restore is within
    ``rss_bound``: its RSS before, plus the largest leaf, plus
    ``RSS_SLACK_BYTES``.

It prints ms a step by epoch on the cards and on one card, the step after
each change, each re-mesh's ms (its ``DeviceMesh``'s too) and the bytes it
placed, the NCCL kernels' ms a step from a profile of 2 more steps, the
kernels of the port launched (none: the train step runs the plain
attention), peak GB a card, the save's and the restore's s and GB/s, and
each rank's peak host RSS.  Exits 1 if a check fails; every process it
starts has ended by then.
"""
import argparse
import json
import math
import os
import shutil
import statistics
import sys
import tempfile
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from tp_serve import free_port  # noqa: E402

SMOKE = dict(seq_len=32, global_batch=4, opt=dict(lr=3e-3, warmup_steps=5))
CONTROL_STEPS = 12  # the steps the schedule runs, the two replayed ones included
# (c)'s gate, written before the first run on four cards.  The four-card run
# trains on the one-card run's batches from the same seed; it differs in
# rounding only where the batch is split over the pods (at 4 pods, a row a
# card: the gradients' all-reduce and GEMMs of another M), and that carries
# into the later steps.  A step moves the loss by ~1e-2 of itself at
# TRAIN_OPT's lr; a step lost, doubled or run on another batch differs by
# that much.  The gate is a tenth of it.
LOSS_RTOL = 1e-3
# (d): the save holds a leaf's host copy (the largest f32 master: at
# stablelm's widths and 8 layers a stacked MLP weight, 8 x 5,120 x 13,824 x
# 4 B = 2.265 GB; the embedding 100,352 x 5,120 x 4 B = 2.055 GB) and
# zipfile's 16 MiB writes; the restore the 64 MiB hash chunk and a leaf
# read from the file.  The slack covers those buffers, CUDA's
# staging of pageable copies and the Python heap.
RSS_SLACK_BYTES = 0.5e9
DIGEST_CHUNK = 1 << 26  # elements a pass of leaf_digest


def setup(smoke):
    """(config, seq_len, global_batch, opt kwargs)."""
    import chip_smoke
    from repro_torch.configs import get_smoke_config

    if smoke:
        cfg = get_smoke_config(chip_smoke.TRAIN["arch"]).replace(dtype="float32")
        return cfg, SMOKE["seq_len"], SMOKE["global_batch"], SMOKE["opt"]
    return (chip_smoke.train_cut("elastic cards"), chip_smoke.TRAIN["seq_len"],
            chip_smoke.TRAIN["global_batch"], chip_smoke.TRAIN_OPT)


def leaf_digest(t: torch.Tensor) -> str:
    """An exact fingerprint of a whole tensor: its bits as integers, each
    times an odd number of its place, summed modulo 2**64 (a change of any
    element, or two elements trading places, changes it), with its shape
    and type."""
    flat = t.detach().contiguous().view(-1)
    ints = flat.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                      8: torch.int64}[flat.element_size()])
    total = torch.zeros((), dtype=torch.int64, device=flat.device)
    for start in range(0, ints.numel(), DIGEST_CHUNK):
        part = ints[start:start + DIGEST_CHUNK].to(torch.int64)
        place = torch.arange(start, start + part.numel(), dtype=torch.int64, device=flat.device)
        total += (part * (2 * place + 1)).sum()
    return f"{tuple(t.shape)} {t.dtype} {int(total) & (2 ** 64 - 1):016x}"


def state_digests(state):
    """Every leaf's digest, gathered whole (the gathers are collective:
    every rank calls this); on rank 0, else None."""
    from repro_torch.models.sharding import whole
    from repro_torch.train import checkpoint

    names, leaves = checkpoint._leaf_paths(state)
    out = {}
    for name, leaf in zip(names, leaves):
        full = whole(leaf)
        if dist.get_rank() == 0:
            out[name] = leaf_digest(full)
        del full
    return out if dist.get_rank() == 0 else None


def local_bytes(state) -> int:
    """Bytes of this rank's shards of the state."""
    from torch.distributed.tensor import DTensor
    from repro_torch.train import checkpoint

    total = 0
    for leaf in checkpoint._leaf_paths(state)[1]:
        t = leaf.to_local() if isinstance(leaf, DTensor) else leaf
        total += t.numel() * t.element_size()
    return total


def rss_bound(before: int, largest_leaf: int) -> int:
    return before + largest_leaf + int(RSS_SLACK_BYTES)


def rank_main(rank, world, port, device, smoke, ckpt_dir, tmp):
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke
    import repro_torch.coord.elastic as elastic
    from repro_torch.coord import ElasticConfig, ElasticTrainer
    from repro_torch.kernels import ops
    from repro_torch.launch.train import GROUP_TIMEOUT
    from repro_torch.launch.trace_analysis import read_profile
    from repro_torch.train import OptConfig
    from repro_torch.train.data import DataConfig

    cuda = device == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    dev = torch.device(device, rank) if cuda else torch.device("cpu")
    dist.init_process_group("nccl" if cuda else "gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world, timeout=GROUP_TIMEOUT,
                            **({"device_id": dev} if cuda else {}))

    def sync():
        if cuda:
            torch.cuda.synchronize()

    try:
        cfg, seq_len, batch, opt = setup(smoke)
        spec = chip_smoke.ELASTIC
        launches = dict(ops.LAUNCHES)
        t0 = time.perf_counter()
        tr = ElasticTrainer(
            cfg, OptConfig(**opt), DataConfig(vocab=cfg.vocab, seq_len=seq_len,
                                              global_batch=batch),
            pods=list(spec["pods"]), device=dev,
            ecfg=ElasticConfig(checkpoint_dir=ckpt_dir, commit_every=spec["commit_every"],
                               checkpoint_every=spec["checkpoint_every"], devices_per_pod=1))
        sync()
        built_s = time.perf_counter() - t0
        largest = max(t.numel() * t.element_size() for t in tr.state.params.parameters())

        # (b): every later re-mesh timed, its DeviceMesh too, and the state's
        # digests taken before and after it (not counted in the step's ms)
        remeshes, aside = [], [0.0]
        real_mesh, real_remesh = elastic.DeviceMesh, tr._remesh

        def timed_mesh(*args, **kw):
            t = time.perf_counter()
            mesh = real_mesh(*args, **kw)
            remeshes[-1]["device_mesh_ms"] = (time.perf_counter() - t) * 1e3
            return mesh

        def remesh(pods):
            t_in = time.perf_counter()
            before = state_digests(tr.state)
            remeshes.append(dict(step=tr.step, pods=list(pods)))
            sync()
            t = time.perf_counter()
            real_remesh(pods)
            sync()
            ms = (time.perf_counter() - t) * 1e3
            placed = [None] * world
            dist.all_gather_object(placed, local_bytes(tr.state))
            after = state_digests(tr.state)
            remeshes[-1].update(ms=ms, devices=tr.events[-1]["devices"], placed_bytes=placed,
                                exact=None if before is None else before == after)
            aside[0] += (time.perf_counter() - t_in) * 1e3 - ms

        elastic.DeviceMesh, tr._remesh = timed_mesh, remesh

        # (d): the save at step 10 and the restore, timed, with the state's
        # digests and each rank's host RSS sampled
        saves, save = [], tr.save_checkpoint

        def timed_save():
            t_in = time.perf_counter()
            digests = state_digests(tr.state)
            sync()
            with chip_smoke.RssPeak() as rss:
                t = time.perf_counter()
                save()
                s = time.perf_counter() - t
            saves.append(dict(step=tr.step, s=s, digests=digests, rss_before=rss.before,
                              rss_peak=rss.peak, durable_step=tr.controller.durable_step()))
            aside[0] += (time.perf_counter() - t_in) * 1e3

        tr.save_checkpoint = timed_save
        rows, changes, restore = [], [], None
        for n, op, args in spec["schedule"]:
            for _ in range(n):
                epoch, aside[0], trained = tr.controller.epoch, 0.0, len(tr.losses)
                t = time.perf_counter()
                tr.run(1)
                sync()
                wall = (time.perf_counter() - t) * 1e3
                rows.append(dict(step=tr.step, epoch=epoch, ms=wall - aside[0],
                                 loss=tr.losses[-1] if len(tr.losses) > trained else None))
            if op == "restore_latest":
                sync()
                with chip_smoke.RssPeak() as rss:
                    t = time.perf_counter()
                    ok = tr.restore_latest()
                    sync()
                    s = time.perf_counter() - t
                restore = dict(ok=ok, step=tr.step, s=s, rss_before=rss.before,
                               rss_peak=rss.peak, digests=state_digests(tr.state))
            elif op is not None:
                t = time.perf_counter()
                tel = tr.scale_to(list(args)) if op == "scale_to" else tr.fail_and_replace(*args)
                changes.append(dict(op=op, args=list(args), after_step=tr.step,
                                    wall_ms=(time.perf_counter() - t) * 1e3,
                                    activation_ms=tel["activation_ms"]))
        tr.controller.check_safety()
        ctrl, ledger = tr.controller, tr.controller.ledger()
        control = dict(stall_count=ctrl.dep.leader.stall_count, epoch=ctrl.membership()[0],
                       pods=list(ctrl.membership()[1]), durable_step=ctrl.durable_step(),
                       ledger_entries=len(ledger.history),
                       retired_configs=ctrl.retired_config_count())
        peak_gb = torch.cuda.max_memory_allocated() / 1e9 if cuda else None

        # NCCL's share of a step: a profile of 2 more steps on every rank
        nccl = None
        if cuda:
            sync()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                tr.run(2)
                sync()
                wall = (time.perf_counter() - t) * 1e3
            reading = read_profile(prof, wall_ms=wall)
            kernels = [k for name, k in reading.kernels.items() if "nccl" in name.lower()]
            nccl = dict(steps=2, wall_ms_per_step=wall / 2, busy_share=reading.busy_share,
                        device_ms_per_step=reading.busy_ms / 2,
                        nccl_ms_per_step=sum(k.device_ms for k in kernels) / 2,
                        nccl_launches_per_step=sum(k.launches for k in kernels) / 2,
                        port_kernels_in_trace={
                            name: reading.launches_of(sym)
                            for name, sym in chip_smoke.DEVICE_KERNELS.items()},
                        top=[[name[:70], k.launches, k.device_ms]
                             for name, k in reading.top(6)])
        mine = dict(rank=rank, built_s=built_s, peak_gb=peak_gb, nccl=nccl,
                    launched={k: v - launches.get(k, 0) for k, v in ops.LAUNCHES.items()
                              if v != launches.get(k, 0)},
                    saves=[{k: v for k, v in s.items() if k != "digests"} for s in saves],
                    restore={k: v for k, v in restore.items() if k != "digests"},
                    largest_leaf_bytes=largest)
        by_rank = [None] * world
        dist.all_gather_object(by_rank, mine)
        if rank == 0:
            out = dict(rows=rows, changes=changes, remeshes=remeshes, control=control,
                       events=tr.events, by_rank=by_rank,
                       saved_digests=saves[-1]["digests"] if saves else None,
                       restored_digests=restore["digests"],
                       checkpoint_bytes=sum(os.path.getsize(os.path.join(ckpt_dir, f))
                                            for f in os.listdir(ckpt_dir)
                                            if f.endswith(".npz")))
            with open(os.path.join(tmp, "ranks.json"), "w") as f:
                json.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def control_losses(cfg, seq_len, batch, opt, device, steps=CONTROL_STEPS):
    """The one-card run's first ``steps`` steps with the first master's
    first element moved by one f32 rounding step: (losses, how far it moved)."""
    import chip_smoke
    from repro_torch.coord import ElasticConfig, ElasticTrainer
    from repro_torch.train import OptConfig
    from repro_torch.train.data import DataConfig

    spec = chip_smoke.ELASTIC
    with tempfile.TemporaryDirectory() as ckpt_dir:
        tr = ElasticTrainer(cfg, OptConfig(**opt),
                            DataConfig(vocab=cfg.vocab, seq_len=seq_len, global_batch=batch),
                            pods=list(spec["pods"]), device=device,
                            ecfg=ElasticConfig(checkpoint_dir=ckpt_dir,
                                               checkpoint_every=steps + 1))
        w = next(tr.state.params.parameters())
        with torch.no_grad():
            old = w.view(-1)[0].clone()
            w.view(-1)[0] = torch.nextafter(old, torch.full_like(old, math.inf))
            moved = (w.view(-1)[0] - old).abs().item()
        tr.run(steps)
        losses = list(tr.losses)
        del tr
    return losses, moved


def one_card_main(_, what, card, device, smoke, tmp):
    """On card 0 alone: phase 6 (``what`` "one_card") or the control."""
    import chip_smoke

    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        device = "cuda:0"
    cfg, seq_len, batch, opt = setup(smoke)
    if what == "one_card":
        out = chip_smoke.elastic_phase(card, device=device, cfg=cfg, seq_len=seq_len,
                                       global_batch=batch, opt=opt)
    else:
        out = control_losses(cfg, seq_len, batch, opt, device)
    with open(os.path.join(tmp, f"{what}.json"), "w") as f:
        json.dump(out, f, default=str)


def rel(a, b):
    return abs(a - b) / abs(b)


def checks(four, one, control, moved, want):
    """(a)-(d) against the one-card run ``one`` (``chip_smoke.elastic_phase``'s
    readings); returns (readings, faults)."""
    import chip_smoke

    faults = []
    # (a) the control plane
    c = four["control"]
    for k in ("stall_count", "epoch", "pods", "durable_step", "ledger_entries",
              "retired_configs"):
        if c[k] != one[k]:
            faults.append(f"(a) {k} {c[k]} on the cards, {one[k]} on one card")
    if c["stall_count"] != 0:
        faults.append(f"(a) stall_count {c['stall_count']}")

    def bare(events):
        return [{k: v for k, v in e.items() if k != "devices"} for e in events]

    if bare(four["events"]) != bare(one["events"]):
        faults.append("(a) the events differ from the one-card run's")
    devices = [e["devices"] for e in four["events"] if e["t"] == "remesh"]
    world = len(four["by_rank"])  # fewer ranks than pods: one rank, pods logical
    if devices != [len(p) if world >= len(p) else 1 for p in want["epochs"]]:
        faults.append(f"(a) re-meshed onto {devices} cards, epochs {want['epochs']}")
    activation = [ch["activation_ms"] for ch in four["changes"]]
    if not all(a < chip_smoke.ACTIVATION_MS_MAX for a in activation):
        faults.append(f"(a) activation {activation} simulated ms")
    # (b) each re-mesh moves the state exactly
    for r in four["remeshes"]:
        if r["exact"] is not True:
            faults.append(f"(b) the re-mesh after step {r['step']} changed the state")
    # (c) each step's loss against the one-card run's
    losses = [r["loss"] for r in four["rows"]]
    diffs = [rel(a, b) for a, b in zip(losses, one["losses"])]
    before = want["steps_before_restore"]
    to = want["restored_to"]
    # the control's distance at the same step (the replayed steps at theirs)
    ctrl_steps = [r["step"] for r in four["rows"]]
    ctrl = [rel(control[s - 1], one["losses"][i]) if s <= len(control) else None
            for i, s in enumerate(ctrl_steps)]
    if len(losses) != len(one["losses"]) or not all(
            x is not None and math.isfinite(x) for x in losses):
        faults.append(f"(c) losses {losses}")
    elif max(diffs) > LOSS_RTOL:
        faults.append(f"(c) losses {max(diffs):.3e} from the one-card run's (gate {LOSS_RTOL})")
    # (d) the checkpoint round trip on the ranks
    replay = rel(losses[before], losses[to])
    if four["saved_digests"] is None or four["restored_digests"] != four["saved_digests"]:
        faults.append("(d) the restored state differs from the state saved")
    if replay > chip_smoke.REPLAY_LOSS_RTOL:
        faults.append(f"(d) replayed step {to + 1}: loss {losses[before]} vs {losses[to]}")
    rss = []
    for r in four["by_rank"]:
        for what, reading in [("save", s) for s in r["saves"]] + [("restore", r["restore"])]:
            bound = rss_bound(reading["rss_before"], r["largest_leaf_bytes"])
            rss.append(dict(rank=r["rank"], what=what, before_gb=reading["rss_before"] / 1e9,
                            peak_gb=reading["rss_peak"] / 1e9, bound_gb=bound / 1e9))
            if reading["rss_peak"] > bound:
                faults.append(f"(d) rank {r['rank']}'s {what}: peak RSS "
                              f"{reading['rss_peak'] / 1e9:.3f} GB over {bound / 1e9:.3f}")
        if r["launched"]:
            faults.append(f"rank {r['rank']} launched {r['launched']}")
        nccl = r["nccl"]
        if nccl and any(nccl["port_kernels_in_trace"].values()):
            faults.append(f"rank {r['rank']}: the port's kernels in the trace "
                          f"{nccl['port_kernels_in_trace']}")
    return dict(loss_rel=diffs, control_loss_rel=ctrl, control_moved_by=moved,
                loss_gate=LOSS_RTOL, replay_loss_rel=replay, rss=rss,
                devices=devices), faults


def figures(four, one, card, want):
    rows = four["rows"]
    by_epoch = {}
    for r in rows:
        by_epoch.setdefault(r["epoch"], []).append(r["ms"])
    medians = {e: statistics.median(ms) for e, ms in by_epoch.items()}
    r0 = four["by_rank"][0]
    save, restore = r0["saves"][-1], r0["restore"]
    gb = four["checkpoint_bytes"] / 1e9
    # rows[i] ran step i + 1: a change after step k is followed by rows[k],
    # the restore by rows[before] (step 11 again)
    after = ([rows[c["after_step"]] for c in four["changes"]]
             + [rows[want["steps_before_restore"]]])
    return dict(
        card=card, ms_per_step_by_epoch=medians,
        one_card_ms_per_step_by_epoch=one["ms_per_step_by_epoch"],
        steps_after_change=[dict(step=r["step"], epoch=r["epoch"], ms=r["ms"],
                                 ratio=r["ms"] / medians[r["epoch"]]) for r in after],
        remesh=[dict(after_step=r["step"], pods=r["pods"], devices=r["devices"], ms=r["ms"],
                     device_mesh_ms=r.get("device_mesh_ms"),
                     placed_gb=sum(r["placed_bytes"]) / 1e9,
                     placed_gb_by_rank=[b / 1e9 for b in r["placed_bytes"]])
                for r in four["remeshes"]],
        nccl=[r["nccl"] for r in four["by_rank"]],
        peak_gb_by_card=[r["peak_gb"] for r in four["by_rank"]],
        checkpoint_gb=gb, save_s=save["s"], save_gb_per_s=gb / save["s"],
        restore_s=restore["s"], restore_gb_per_s=gb / restore["s"],
        one_card_save_s=one["save_s"], one_card_restore_s=one["restore_s"],
        one_card_host_peak_rss_gb=one["host_peak_rss_gb"],
        built_s=[r["built_s"] for r in four["by_rank"]])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--smoke", action="store_true", help="the f32 smoke config")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "elastic_cards.json"))
    args = ap.parse_args(argv)
    cuda = args.device == "cuda"
    if cuda and torch.cuda.device_count() < args.world:
        print(f"elastic_cards: {args.world} CUDA devices needed, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 1
    import chip_smoke

    t_run = time.perf_counter()
    card = chip_smoke.card_line() if cuda else "cpu"
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    cfg, seq_len, batch, opt = setup(args.smoke)
    want = chip_smoke.elastic_expected()
    tmp = tempfile.mkdtemp(prefix="elastic_cards_")
    try:
        ckpt_dir = os.path.join(tmp, "ckpt")
        os.makedirs(ckpt_dir)
        room = chip_smoke.elastic_preflight(chip_smoke.checkpoint_bytes(cfg),
                                            chip_smoke.largest_leaf_bytes(cfg), ckpt_dir)
        print("elastic cards: checkpoint room:", json.dumps(room), flush=True)
        ranks = mp.start_processes(rank_main, args=(args.world, free_port(), args.device,
                                                    args.smoke, ckpt_dir, tmp),
                                   nprocs=args.world, join=False, start_method="spawn")
        while not ranks.join():  # raises, and ends the other ranks, if one fails
            pass
        with open(os.path.join(tmp, "ranks.json")) as f:
            four = json.load(f)
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:  # kept should the one-card runs fail
            json.dump(dict(four_cards=four), f, indent=1, default=str)
        shutil.rmtree(ckpt_dir)  # room for the one-card run's checkpoint
        # each one-card run in a process of its own, so that each finds card 0 empty
        for what in ("one_card", "control"):
            mp.start_processes(one_card_main, args=(what, card, args.device, args.smoke, tmp),
                               nprocs=1, start_method="spawn")
        with open(os.path.join(tmp, "one_card.json")) as f:
            one = json.load(f)
        with open(os.path.join(tmp, "control.json")) as f:
            control, moved = json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    readings, faults = checks(four, one, control, moved, want)
    summary = dict(arch=cfg.arch_id, n_layers=cfg.n_layers, dtype=cfg.dtype, world=args.world,
                   **figures(four, one, card, want), **readings, faults=faults,
                   seconds=time.perf_counter() - t_run)
    print("elastic cards: (a) control plane " + ("held" if not any(
        f.startswith("(a)") for f in faults) else "FAILED") + f": devices {summary['devices']}, "
        f"ledger {four['control']}", flush=True)
    for r in summary["remesh"]:
        print(f"elastic cards: (b) re-mesh after step {r['after_step']} onto {r['devices']} "
              f"cards {r['pods']}: {r['ms']:.2f} ms (DeviceMesh {r['device_mesh_ms']:.2f} ms), "
              f"{r['placed_gb']:.3f} GB placed [{card}]", flush=True)
    print("elastic cards: (c) loss rel to one card by step:",
          json.dumps([f"{x:.2e}" for x in summary["loss_rel"]]), "control:",
          json.dumps([None if x is None else f"{x:.2e}" for x in summary["control_loss_rel"]]),
          f"(moved by {moved:.3e}; gate {LOSS_RTOL})", flush=True)
    print(f"elastic cards: (d) save {summary['save_s']:.2f} s ({summary['save_gb_per_s']:.3f} "
          f"GB/s), restore {summary['restore_s']:.2f} s ({summary['restore_gb_per_s']:.3f} "
          f"GB/s) of {summary['checkpoint_gb']:.3f} GB; one card {one['save_s']:.2f} / "
          f"{one['restore_s']:.2f} s; replayed loss rel {summary['replay_loss_rel']:.3e}; "
          f"RSS {json.dumps(summary['rss'])} [{card}]", flush=True)
    print("elastic cards: ms/step by epoch", json.dumps(summary["ms_per_step_by_epoch"]),
          "one card", json.dumps(summary["one_card_ms_per_step_by_epoch"]),
          f"peak GB by card {summary['peak_gb_by_card']} [{card}]", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(summary, four_cards=four, one_card=one), f, indent=1, default=str)
    print(json.dumps(summary, default=str), flush=True)
    return 1 if faults else 0


if __name__ == "__main__":
    sys.exit(main())
