#!/usr/bin/env python3
"""The Engine's captured prefill, and both its steps on a mesh, on shallow models.

    python3 tools/step_graph_probe.py [--out chiprun_out/step_graph_probe.json]

On one CUDA card, at published widths and a cut of depth (batch 4):

* with no mesh, the ten served configurations: an Engine on its captured
  steps and one with ``cuda_graph=False``; the captured prefill's logits
  and whole decode state against the eager prefill's (bit-equal, max abs
  difference), the same replay with a new prompt left out of the static
  buffer against the eager prefill of that prompt (the difference a stale
  replay makes), prefill ms both ways (median of 3), and a profiled
  captured prefill: each wrapper's launches on the host and in the device
  trace;
* on a (1, 1, 1) mesh of one NCCL rank, stablelm, mamba2, seamless, zamba2,
  grok and gemma2: the weights placed by ``param_specs(..., "tp")``, an
  Engine on its captured steps and one eager, both under ``set_mesh``:
  greedy tokens of 16 steps both ways, the teacher-forced logits through
  the captured steps against the eager steps', the captured prefill's
  outputs against the eager prefill's, decode ms/step both ways (a 16-token
  generate less a 1-token one, over 15) and 4 profiled replays;
* a capture on the mesh that syncs with the host raises, and one of an
  explicit all-reduce captures and replays.

Prints one JSON line per case and writes them all to ``--out``.  A quick
check of both captures before a full ``chip_smoke.py`` run.
"""
import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402
from torch.utils._pytree import tree_leaves  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.launch.trace_analysis import read_profile  # noqa: E402
from repro_torch.models import get_model, sharding  # noqa: E402
from repro_torch.serve import Engine  # noqa: E402
from repro_torch.serve.graph import CapturedStep, CudaGraph  # noqa: E402

CASES = [("stablelm_12b", dict(n_layers=4), 512), ("gemma2_2b", dict(n_layers=4), 4608),
         ("gemma3_4b", dict(n_layers=6), 2048), ("mamba2_2p7b", dict(n_layers=4), 1024),
         ("zamba2_1p2b", dict(n_layers=12), 1024),
         ("seamless_m4t_large_v2", dict(n_layers=4, n_enc_layers=2), 512),
         ("grok_1_314b", dict(n_layers=1), 512), ("llama4_scout_17b_a16e", dict(n_layers=2), 512),
         ("starcoder2_15b", dict(n_layers=4), 512), ("chameleon_34b", dict(n_layers=4), 512)]
MESH_CASES = ("stablelm_12b", "mamba2_2p7b", "seamless_m4t_large_v2", "zamba2_1p2b",
              "grok_1_314b", "gemma2_2b")


def inputs_for(cfg, gen, B, S):
    d = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen, device="cuda")}
    if cfg.family == "encdec":
        d["enc_emb"] = torch.randn((B, cfg.enc_len, cfg.d_model), generator=gen,
                                   device="cuda").bfloat16()
    return d


def whole_tree(out):
    return [sharding.whole(t).clone() for t in tree_leaves(out)]


def diff(a, b):
    """(bit-equal, max abs difference) of two lists of tensors."""
    eq = all(torch.equal(x, y) for x, y in zip(a, b))
    return eq, max((x.float() - y.float()).abs().max().item() for x, y in zip(a, b))


def ms(fn, n=3):
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def profiled(fn):
    """fn under the profiler: host and device launches of each wrapper."""
    torch.cuda.synchronize()
    ops.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    r = read_profile(prof, wall_ms=wall)
    dev = {k: v.launches for k, v in r.kernels.items() if "flash" in k or "ssd" in k}
    return dict(host=dict(ops.LAUNCHES), device=dev, busy=r.busy_share, wall_ms=wall)


def prefill_case(arch, cut, prompt):
    cfg = get_config(arch).replace(**cut)
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = get_model(cfg).init(gen, device="cuda")
    inp, other = inputs_for(cfg, gen, 4, prompt), inputs_for(cfg, gen, 4, prompt)
    g = Engine(model, max_len=prompt + 17)
    e = Engine(model, max_len=prompt + 17, cuda_graph=False)
    row = dict(arch=arch, cut=cut, prompt=prompt)
    g.generate(inp, 2)
    e.generate(inp, 2)
    got, want = whole_tree(g._prefill(inp)), whole_tree(e._prefill(inp))
    row["prefill_bit_equal"], row["prefill_max_diff"] = diff(got, want)
    step = g.captured_prefill(inp)
    row["captured"], row["replays"] = step.captured, step.replays
    want_other = whole_tree(e._prefill(other))
    row["stale_bit_equal"], row["stale_max_diff"] = diff(whole_tree(step.run()), want_other)
    row["prefill_ms_graph"] = ms(lambda: g._prefill(inp))
    row["prefill_ms_eager"] = ms(lambda: e._prefill(inp))
    row["profile_prefill_graph"] = profiled(lambda: g._prefill(inp))
    row["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return row


def teacher_forced(engine, inputs, tokens):
    logits, state = engine._prefill({k: engine._laid_out(v) for k, v in inputs.items()})
    out = [sharding.whole(logits)[:, -1].clone()]
    for t in range(tokens.shape[1]):
        logits, state = engine._decode(state, engine._laid_out(tokens[:, t:t + 1]))
        out.append(sharding.whole(logits)[:, -1].clone())
    return torch.stack(out, 1)


def per_step_ms(engine, inp, steps=16):
    def run(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.generate(inp, n)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3
    return (run(steps) - run(1)) / (steps - 1)


def mesh_case(arch, cut, prompt, mesh):
    cfg = get_config(arch).replace(sharding_policy="tp", **cut)
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = get_model(cfg).init(gen, device="cuda")
    inp = inputs_for(cfg, gen, 4, prompt)
    sharding.place_module(model, mesh, sharding.param_specs(
        cfg, dict(model.named_parameters()), sharding.axis_sizes(mesh), "tp"))
    g = Engine(model, max_len=prompt + 17)
    e = Engine(model, max_len=prompt + 17, cuda_graph=False)
    row = dict(arch=arch, cut=cut, prompt=prompt, mesh=[1, 1, 1])
    with sharding.set_mesh(mesh):
        g.generate(inp, 2)
        e.generate(inp, 2)
        og, oe = g.generate(inp, 16), e.generate(inp, 16)
        row["tokens_equal"] = bool((og.tokens == oe.tokens).all())
        forced = torch.from_numpy(oe.tokens).cuda()
        row["tf_bit_equal"], row["tf_max_diff"] = diff(
            [teacher_forced(g, inp, forced)], [teacher_forced(e, inp, forced)])
        batch = {k: g._laid_out(v) for k, v in inp.items()}
        got, want = whole_tree(g._prefill(batch)), whole_tree(e._prefill(batch))
        row["prefill_bit_equal"], row["prefill_max_diff"] = diff(got, want)
        (step,) = g._steps.values()
        row["decode_captured"], row["decode_replays"] = step.captured, step.replays
        row["dtensor_buffers"] = all(isinstance(t, sharding.DTensor)
                                     for t in tree_leaves(step.inputs))
        row["decode_ms_graph"] = per_step_ms(g, inp)
        row["decode_ms_eager"] = per_step_ms(e, inp)

        def replays():
            logits, state = g._prefill(batch)
            torch.cuda.synchronize()
            ops.reset_launches()
            for _ in range(4):
                nxt = torch.argmax(sharding.whole(logits)[:, -1], -1)
                nxt.cpu()
                logits, state = g._decode(state, g._laid_out(nxt[:, None]))

        row["profile_decode_graph"] = profiled(replays)
    row["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return row


def capture_checks(mesh):
    """A host sync inside a capture on the mesh raises; an explicit
    all-reduce captures and replays."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Replicate

    row = {}
    x = sharding.DTensor.from_local(torch.ones(4, device="cuda"), mesh, [Replicate()] * 3)

    def syncs(inputs):
        y = inputs * 2
        if y.to_local().sum().item() > 1e9:
            y = -y
        return y

    step = CapturedStep(syncs, x, CudaGraph)
    try:
        step(x)
        row["sync_capture"] = "no raise"
    except Exception as ex:
        row["sync_capture"] = "raised: " + repr(ex)[:200]
    t = torch.arange(4.0, device="cuda")

    def reduce(inputs):
        return funcol.all_reduce(inputs * 2, "sum", (mesh, 2)).wait()

    step = CapturedStep(reduce, t, CudaGraph)
    try:
        first = step(t).clone()
        again = step(t + 1).clone()
        row["all_reduce_capture"] = dict(captured=step.captured, first=first.tolist(),
                                         replay=again.tolist())
    except Exception as ex:
        row["all_reduce_capture"] = "raised: " + repr(ex)[:300]
    y = torch.ones(3, device="cuda") * 2
    torch.cuda.synchronize()
    row["cuda_usable_after"] = y.tolist()
    return row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/step_graph_probe.json")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []

    def emit(row):
        print(json.dumps(row), flush=True)
        rows.append(row)

    emit(dict(build_s=_build.timed_build()))
    for arch, cut, prompt in CASES:
        try:
            emit(prefill_case(arch, cut, prompt))
        except Exception as ex:  # one model's fault is printed; the others run
            import traceback
            traceback.print_exc()
            emit(dict(arch=arch, error=repr(ex)[:500]))
        torch.cuda.empty_cache()
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = DeviceMesh("cuda", torch.zeros((1, 1, 1), dtype=torch.int64),
                          mesh_dim_names=("pod", "data", "model"))
        cases = {a: (c, p) for a, c, p in CASES}
        for arch in MESH_CASES:
            try:
                emit(mesh_case(arch, *cases[arch], mesh))
            except Exception as ex:
                import traceback
                traceback.print_exc()
                emit(dict(arch=arch, mesh=[1, 1, 1], error=repr(ex)[:500]))
            torch.cuda.empty_cache()
        emit(capture_checks(mesh))
    finally:
        dist.destroy_process_group()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("step_graph_probe: needs a CUDA device")
    main()
