#!/usr/bin/env python3
"""The Engine's captured decode step on shallow models at published widths.

    python3 tools/decode_graph_probe.py

On one CUDA card: for nine of the served configurations at a cut of their
depth (stablelm 4 layers, gemma2 4 at prompt 4608, gemma3 6 at 2048,
mamba2 4 at 1024, zamba2 12 at 1024, seamless 4 + 2, grok 1, scout 2,
chameleon 4; batch 4, 32 tokens), an Engine on the captured step and one
with ``cuda_graph=False``.  Prints one JSON line per model: the walls of a
32-token ``generate`` both ways and their launch counts, whether the
greedy tokens agree, the teacher-forced logits through the captured step
against the eager step (bit-equal, max abs difference), the difference a
stale-state replay makes, and three profiled windows of 8 decode steps
(the graph captured before the profiler started, the graph captured inside
it, eager): each wrapper's launches on the host and the device trace, the
busy share and the kernel count; then whether a capture that syncs with
the host raises and leaves the card usable.  A quick check of the capture
before a full ``chip_smoke.py`` run.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.launch.trace_analysis import read_profile  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.serve import Engine  # noqa: E402
from repro_torch.serve.graph import CapturedDecode, CudaGraph  # noqa: E402

CASES = [("stablelm_12b", dict(n_layers=4), 512), ("gemma2_2b", dict(n_layers=4), 4608),
         ("gemma3_4b", dict(n_layers=6), 2048), ("mamba2_2p7b", dict(n_layers=4), 1024),
         ("zamba2_1p2b", dict(n_layers=12), 1024),
         ("seamless_m4t_large_v2", dict(n_layers=4, n_enc_layers=2), 512),
         ("grok_1_314b", dict(n_layers=1), 512), ("llama4_scout_17b_a16e", dict(n_layers=2), 512),
         ("chameleon_34b", dict(n_layers=4), 512)]


def inputs_for(cfg, gen, B, S):
    d = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen, device="cuda")}
    if cfg.family == "encdec":
        d["enc_emb"] = torch.randn((B, cfg.enc_len, cfg.d_model), generator=gen,
                                   device="cuda").bfloat16()
    return d


def teacher_forced(engine, inputs, tokens, eager, stale=False, steps=None):
    logits, state = engine._prefill(inputs)
    out = [logits[:, -1].clone()]
    for t in range(tokens.shape[1] if steps is None else steps):
        if eager:
            logits, state = engine.model.decode_step(state, tokens[:, t:t + 1])
        else:
            if stale and t == 0:
                state = engine.captured_step(state).state
            logits, state = engine._decode(state, tokens[:, t:t + 1])
        out.append(logits[:, -1].clone())
    return torch.stack(out, 1)


def window(engine, inputs, decode):
    """8 greedy decode steps under the profiler: host and device launches,
    busy share, kernel count, wall ms."""
    logits, state = engine._prefill(inputs)
    torch.cuda.synchronize()
    ops.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(8):
            nxt = torch.argmax(logits[:, -1], -1)
            nxt.cpu()
            logits, state = decode(state, nxt[:, None])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    r = read_profile(prof, wall_ms=wall)
    return dict(host=dict(ops.LAUNCHES),
                dev={k: v.launches for k, v in r.kernels.items() if "flash" in k or "ssd" in k},
                busy=r.busy_share, n_kernels=sum(v.launches for v in r.kernels.values()),
                wall=wall)


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    print("build", _build.timed_build(), flush=True)
    for arch, cut, prompt in CASES:
        cfg = get_config(arch).replace(**cut)
        gen = torch.Generator(device="cuda").manual_seed(0)
        model = get_model(cfg).init(gen, device="cuda")
        inp = inputs_for(cfg, gen, 4, prompt)
        max_len = prompt + 33
        g = Engine(model, max_len=max_len)
        e = Engine(model, max_len=max_len, cuda_graph=False)
        row = dict(arch=arch)
        try:
            g.generate(inp, 2)
            e.generate(inp, 2)
            ops.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            og = g.generate(inp, 32)
            torch.cuda.synchronize()
            row["graph_s"] = time.perf_counter() - t0
            row["graph_launches"] = dict(ops.LAUNCHES)
            ops.reset_launches()
            t0 = time.perf_counter()
            oe = e.generate(inp, 32)
            torch.cuda.synchronize()
            row["eager_s"] = time.perf_counter() - t0
            row["eager_launches"] = dict(ops.LAUNCHES)
            row["tokens_equal"] = bool((og.tokens == oe.tokens).all())
            gt = torch.from_numpy(oe.tokens).cuda()
            a, b = teacher_forced(g, inp, gt, False), teacher_forced(e, inp, gt, True)
            row["tf_bit_equal"] = bool(torch.equal(a, b))
            row["tf_max_diff"] = (a - b).abs().max().item()
            row["per_step_diff"] = (a - b).abs().amax(dim=(0, 2)).tolist()[:6]
            st = teacher_forced(g, inp, gt, False, stale=True, steps=1)
            row["stale_diff"] = (st - b[:, :2]).abs().max().item()
            row["prof_pre"] = window(g, inp, g._decode)
            g2 = Engine(model, max_len=max_len)  # captures inside the window
            row["prof_in"] = window(g2, inp, g2._decode)
            row["prof_eager"] = window(e, inp, e._decode)
            row["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            del g2
        except Exception as ex:  # one model's fault is printed; the others run
            import traceback
            traceback.print_exc()
            row["error"] = repr(ex)[:500]
        print(json.dumps(row), flush=True)
        del model, g, e
        torch.cuda.empty_cache()

    state = {"pos": torch.zeros(2, dtype=torch.int32, device="cuda")}

    def syncs(state, tok):
        x = tok.float() * 2
        if x.sum().item() > 1e9:
            pass
        return x[:, None], {**state, "pos": state["pos"] + 1}

    step = CapturedDecode(syncs, state, CudaGraph)
    try:
        step(state, torch.ones(2, 1, dtype=torch.long, device="cuda"))
        print("failing capture: no raise")
    except Exception as ex:
        print("failing capture raised:", repr(ex)[:300])
    try:
        y = torch.ones(3, device="cuda") * 2
        torch.cuda.synchronize()
        print("cuda usable after:", y.tolist())
    except Exception as ex:
        print("cuda broken after:", repr(ex)[:300])


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("decode_graph_probe: needs a CUDA device")
    main()
