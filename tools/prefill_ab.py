#!/usr/bin/env python3
"""Times versions of a bf16 kernel (``flash_prefill``, ``flash_decode`` or
``ssd_intra_chunk``) against each other in one process on one card, in
turns, beside ``scaled_dot_product_attention`` for the attention kernels.

    python3 tools/prefill_ab.py --tree old=<csrc dir> --tree new=src/repro_torch/csrc \\
        --order old,new,new,old [--kernel flash_decode | ssd_intra_chunk]

Each ``--tree NAME=DIR`` names a directory of CUDA sources (``csrc/`` of this
checkout, or of an older commit unpacked with ``git archive`` into a
directory that ``.gitignore`` lists).  Each is built into its own library
with ``kernels/_build.py``; each version's output at every shape is held
against the plain version (``ref.flash_attention_ref``,
``ref.decode_attention_ref`` or ``ref.ssd_intra_chunk_ref``, the SSD at
``chip_smoke.SSD_TOL``) before any timing; a version that disagrees or
fails to launch is reported and not timed.  Then the versions are timed in
the order given, at the main paths' shapes (attention: stablelm-12b and
zamba2-1.2b, bf16, prefill causal, decode at ``chip_smoke.py``'s cache
lengths; the SSD: mamba2-2.7b and zamba2-1.2b, bf16, as
``chip_smoke.ssd_phase``), with CUDA events as ``chip_smoke.time_ms`` does;
the library call, where there is one, is timed first and last.  Prefill
is timed warm; decode warm (the same cache every call) and cold (each call
on the next of enough copies of the cache to exceed twice the L2,
``chip_smoke.cold_copies``).  The SSD is timed "warm", on the same inputs
every call, but its inputs and f32 outputs come to ~173 MB at mamba2's
shape and ~121 MB at zamba2's, over twice the 50 MB L2, so each call reads
and writes device memory and the warm figure is the cold one.  Each decode
version is launched with the split plan it shipped with
(``DecodeVersion``).
Prints one JSON line per timing and writes all of them, with the card's
name and power limit and ptxas's report of each version's kernels, to
``--out`` (``build/<kernel>_ab.json`` by default).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# name: (B, S, H, K, hd), causal, no window, no softcap
PREFILL_SHAPES = {
    "stablelm_12b": (4, 512, 32, 8, 160),
    "zamba2_1p2b": (4, 1024, 32, 32, 64),
}
# name: (B, S, H, K, hd, lengths), as chip_smoke.kernel_phase's decode rows
DECODE_SHAPES = {
    "stablelm_12b": (4, 545, 32, 8, 160, [545, 513, 528, 520]),
    "zamba2_1p2b": (4, 1057, 32, 32, 64, [1057, 1025, 1040, 1032]),
}
# name: (B, S, nh, hd, N, Q, dtype), as chip_smoke.ssd_phase's measured rows
SSD_SHAPES = {
    "mamba2_2p7b": (4, 1024, 80, 64, 128, 256, "bfloat16"),
    "zamba2_1p2b": (4, 1024, 64, 64, 64, 256, "bfloat16"),
    "mamba2_2p7b_f32": (4, 1024, 80, 64, 128, 256, "float32"),
}


def prefill_launch(lib, q, k, v, out, scale):
    """One bf16 causal launch through a given library's C entry point."""
    import torch
    from repro_torch.kernels import _build

    B, Sq, H, hd = q.shape
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    err = lib.repro_flash_prefill(
        1, hd, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, k.shape[2],
        Sq, k.shape[1], *strides, float(scale), 1, 0, 0.0,
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "flash_prefill")


_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# The first version's entry point: an f32 scratch `part` and (nsplit, chunk).
SPLIT_SIGNATURE = [_I, _I, _P, _P, _P, _P, _P, _P] + [_I] * 6 + [_L] * 10 + [_F, _I, _F, _P]
# The cluster versions' whole-cache entry before ``repro_flash_decode_shard``.
CLUSTER_SIGNATURE = [_I, _I, _P, _P, _P, _P, _P] + [_I] * 8 + [_L] * 10 + [_F, _I, _F, _P]


def split_plan(B, K, S, sm_count):
    """The first version's (nsplit, chunk): about two waves of blocks, chunks
    a multiple of its 64-key tile."""
    tiles = max(1, math.ceil(S / 64))
    nsplit = max(1, min(tiles, math.ceil(2 * sm_count / (B * K))))
    chunk = 64 * math.ceil(tiles / nsplit)
    return math.ceil(S / chunk), chunk


class DecodeVersion:
    """Launches one tree's bf16 decode kernel through its C entry point, with
    the split plan that version shipped with: the first version's
    ``split_plan`` and ``part`` scratch; this checkout's ``plan`` with the
    tree's own occupancy query where it exports one; else ``plan`` with
    clusters sized for about two blocks an SM (the cluster versions before
    the query)."""

    def __init__(self, lib, csrc: Path):
        import torch

        self.lib = lib
        self.split = "float* part" in (csrc / "decode_attention.cu").read_text()
        self.shard = hasattr(lib, "repro_flash_decode_shard")
        if not self.shard:
            lib.repro_flash_decode.argtypes = SPLIT_SIGNATURE if self.split else CLUSTER_SIGNATURE
            lib.repro_flash_decode.restype = ctypes.c_int
        self.sm = torch.cuda.get_device_properties(0).multi_processor_count
        self.query = hasattr(lib, "repro_flash_decode_clusters")
        self.part = None

    def resident(self, hd, cluster, heads):
        if self.query:
            return self.lib.repro_flash_decode_clusters(1, hd, heads, cluster)
        return 2 * self.sm // cluster

    def __call__(self, q, kc, vc, lens, out, scale):
        import torch
        from repro_torch.kernels import _build
        from repro_torch.kernels.decode_attention import plan

        B, H, hd = q.shape
        S, K = kc.shape[1], kc.shape[2]
        strides = [*q.stride()[:2], *kc.stride()[:3], *vc.stride()[:3], *out.stride()[:2]]
        ptrs = [q.data_ptr(), kc.data_ptr(), vc.data_ptr(), lens.data_ptr(), out.data_ptr()]
        stream = torch.cuda.current_stream().cuda_stream
        if self.split:
            nsplit, chunk = split_plan(B, K, S, self.sm)
            size = B * H * nsplit * (hd + 2)
            if self.part is None or self.part.numel() < size:
                self.part = torch.empty(size, dtype=torch.float32, device=q.device)
            err = self.lib.repro_flash_decode(
                1, hd, *ptrs, self.part.data_ptr() if nsplit > 1 else None, B, H, K, S,
                nsplit, chunk, *strides, float(scale), 0, 0.0, stream)
        else:
            p = plan(B, K, H // K, S, hd, None, lambda c, h: self.resident(hd, c, h))
            geometry = [B, H, K, S, p.cluster, p.chunk, p.tile, p.heads]
            if self.shard:  # the whole cache: no key offset, no log-sum-exp
                err = self.lib.repro_flash_decode_shard(
                    1, hd, *ptrs, None, 0, None, *geometry, *strides, 0, 0, float(scale), 0,
                    0.0, stream)
            else:
                err = self.lib.repro_flash_decode(1, hd, *ptrs, *geometry, *strides,
                                                  float(scale), 0, 0.0, stream)
        _build.check(err, "flash_decode")


def prefill_cases(gen, libs, trees):
    """(shape name, inputs, check, launch, library) for each prefill shape:
    inputs maps a timing mode to a list of argument tuples (here one, timed
    warm only); check(out) returns the max abs error against the plain
    version or raises."""
    import torch
    import torch.nn.functional as F
    from chip_smoke import close
    from repro_torch.kernels import ref

    for name, (B, S, H, K, hd) in PREFILL_SHAPES.items():
        q, k, v = (torch.randn(B, S, n, hd, generator=gen, device="cuda").to(torch.bfloat16)
                   for n in (H, K, K))
        scale = hd ** -0.5
        want = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                       scale=scale, causal=True).transpose(1, 2)
        outs = {t: torch.empty_like(q) for t in libs}

        def launch(tree, q, k, v, outs=outs, scale=scale):
            prefill_launch(libs[tree], q, k, v, outs[tree], scale)
            return outs[tree]

        def library(q, k, v, scale=scale):
            return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                                  v.transpose(1, 2), is_causal=True,
                                                  scale=scale, enable_gqa=True)

        yield (name, {"warm": [(q, k, v)]},
               lambda out, want=want: close(out, want, torch.bfloat16), launch, library)


def decode_cases(gen, libs, trees):
    """As prefill_cases for each decode shape, timed warm on one cache and
    cold on ``cold_copies`` copies of it taken in turn."""
    import torch
    import torch.nn.functional as F
    from chip_smoke import close, cold_copies
    from repro_torch.kernels import ref

    versions = {t: DecodeVersion(lib, Path(trees[t]).resolve()) for t, lib in libs.items()}
    for name, (B, S, H, K, hd, lengths) in DECODE_SHAPES.items():
        q = torch.randn(B, 1, H, hd, generator=gen, device="cuda").to(torch.bfloat16)
        kc, vc = (torch.randn(B, S, K, hd, generator=gen, device="cuda").to(torch.bfloat16)
                  for _ in range(2))
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        mask = (torch.arange(S, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
        scale = hd ** -0.5
        want = ref.decode_attention_ref(q[:, 0], kc.transpose(1, 2), vc.transpose(1, 2), lens,
                                        scale=scale)[:, None]
        outs = {t: torch.empty(B, H, hd, dtype=q.dtype, device="cuda") for t in libs}
        n = cold_copies(2 * kc.numel() * kc.element_size())
        copies = [(kc, vc)] + [(kc.clone(), vc.clone()) for _ in range(n - 1)]

        def launch(tree, kc, vc, q=q, lens=lens, outs=outs, scale=scale):
            versions[tree](q[:, 0], kc, vc, lens, outs[tree], scale)
            return outs[tree][:, None]

        def library(kc, vc, q=q, mask=mask, scale=scale):
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2), attn_mask=mask,
                scale=scale, enable_gqa=True)

        yield (name, {"warm": copies[:1], "cold": copies},
               lambda out, want=want: close(out, want, torch.bfloat16), launch, library)


def ssd_launch(lib, x, a, Bm, Cm, y, st, cum, Q):
    """One launch of a library's SSD kernel through its C entry point, in
    x's type, into the given f32 outputs."""
    import torch
    from repro_torch.kernels import _build

    err = lib.repro_ssd_intra_chunk(
        int(x.dtype == torch.bfloat16), x.shape[-1], Bm.shape[-1], x.data_ptr(), a.data_ptr(),
        Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(), st.data_ptr(), cum.data_ptr(),
        *x.shape[:3], Q, *x.stride()[:3], *a.stride(), *Bm.stride()[:2], *Cm.stride()[:2],
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "ssd_intra_chunk")


def ssd_cases(gen, libs, trees):
    """As prefill_cases for each SSD shape (bf16 at both paths' shapes, and
    f32 at mamba2's), with no library call: the inputs as
    ``chip_smoke.ssd_inputs`` makes them (B and C strided column slices of
    an xBC tensor), each tree's three f32 outputs held against
    ``ref.ssd_intra_chunk_ref`` at ``chip_smoke.SSD_TOL``."""
    import torch
    from chip_smoke import SSD_TOL, close, ssd_inputs
    from repro_torch.kernels import ref

    for name, (B, S, nh, hd, N, Q, dtype) in SSD_SHAPES.items():
        nC = S // Q
        dtype = getattr(torch, dtype)
        x, a, Bm, Cm = ssd_inputs(gen, B, S, nh, hd, N, dtype)
        want = ref.ssd_intra_chunk_ref(
            x.reshape(B, nC, Q, nh, hd).permute(0, 3, 1, 2, 4),
            a.reshape(B, nC, Q, nh).permute(0, 3, 1, 2),
            Bm.reshape(B, 1, nC, Q, N).expand(B, nh, nC, Q, N),
            Cm.reshape(B, 1, nC, Q, N).expand(B, nh, nC, Q, N))
        f32 = dict(dtype=torch.float32, device="cuda")
        outs = {t: (torch.empty(B, S, nh, hd, **f32), torch.empty(B, nC, nh, hd, N, **f32),
                    torch.empty(B, S, nh, **f32)) for t in libs}

        def launch(tree, x, a, Bm, Cm, outs=outs, Q=Q):
            ssd_launch(libs[tree], x, a, Bm, Cm, *outs[tree], Q)
            return outs[tree]

        def check(out, want=want, B=B, S=S, nh=nh, hd=hd, Q=Q, dtype=dtype):
            y, st, cum = out
            got = (y.reshape(B, S // Q, Q, nh, hd).permute(0, 3, 1, 2, 4),
                   st.permute(0, 2, 1, 4, 3), cum.reshape(B, S // Q, Q, nh).permute(0, 3, 1, 2))
            tol = SSD_TOL[str(dtype).replace("torch.", "")]
            return max(close(g, w, dtype, tol) for g, w in zip(got, want))

        yield name, {"warm": [(x, a, Bm, Cm)]}, check, launch, None


CASES = {"flash_prefill": prefill_cases, "flash_decode": decode_cases,
         "ssd_intra_chunk": ssd_cases}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", choices=list(CASES), default="flash_prefill")
    ap.add_argument("--tree", action="append", required=True, help="NAME=DIR of CUDA sources")
    ap.add_argument("--order", required=True, help="comma-separated tree names, in turn")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--out", default=None, help="default build/<kernel>_ab.json")
    args = ap.parse_args(argv)
    args.trees = dict(t.split("=", 1) for t in args.tree)
    args.order = args.order.split(",")
    unknown = set(args.order) - set(args.trees)
    if unknown:
        ap.error(f"--order names trees not given by --tree: {sorted(unknown)}")
    return args


def main() -> int:
    import torch
    from chip_smoke import card_line, time_ms
    from repro_torch.kernels import _build

    args = parse_args()
    if not torch.cuda.is_available():
        print("prefill_ab: no CUDA device", file=sys.stderr)
        return 1
    trees, order = args.trees, args.order
    card = card_line()
    libs, report = {}, {}
    for name, path in trees.items():
        csrc = Path(path).resolve()
        libs[name] = _build.bind(_build.build(csrc))
        report[name] = [dict(e, args=_build.template_args(e["name"]))
                        for e in _build.resources(csrc) if args.kernel in e["name"]]
        print(f"ptxas {name}:", json.dumps(report[name]), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for shape_name, inputs, check, launch, library in CASES[args.kernel](gen, libs, trees):
        wrong, first = set(), None
        for name in libs:
            row = dict(shape=shape_name, tree=name)
            try:
                out = launch(name, *inputs["warm"][0])
                row["max_abs_err"] = check(out)
                out = [t.float() for t in (out if isinstance(out, tuple) else (out,))]
                if first is None:
                    first = [t.clone() for t in out]
                else:  # against the first tree's output: 0 where the arithmetic is the same
                    row["max_abs_diff_first_tree"] = max(
                        (t - f).abs().max().item() for t, f in zip(out, first))
            except (AssertionError, RuntimeError) as exc:  # reported; not timed
                wrong.add(name)
                row["max_abs_err"] = str(exc)
            rows.append(row)
            print(json.dumps(rows[-1]), flush=True)
        del first
        lib_turn = ["library"] if library is not None else []
        sequence = [*lib_turn, *(n for n in order if n not in wrong), *lib_turn]
        for mode, sets in inputs.items():
            for turn, name in enumerate(sequence):
                fn = library if name == "library" else (lambda *a, t=name: launch(t, *a))
                calls = [lambda s=s, fn=fn: fn(*s) for s in sets]
                ms = time_ms(calls if len(calls) > 1 else calls[0], iters=args.iters)
                rows.append(dict(shape=shape_name, mode=mode, turn=turn, tree=name, ms=ms,
                                 copies=len(sets)))
                print(json.dumps(rows[-1]), flush=True)
    out = Path(args.out or ROOT / "build" / f"{args.kernel}_ab.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(
        dict(card=card, kernel=args.kernel, trees=trees, order=order, ptxas=report, rows=rows),
        indent=1))
    print(card, flush=True)
    return 1 if any(isinstance(r.get("max_abs_err"), str) for r in rows) else 0


if __name__ == "__main__":
    sys.exit(main())
