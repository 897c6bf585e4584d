#!/usr/bin/env python3
"""Where the time of the wgmma ``flash_prefill`` kernel goes, block by block.

    python3 tools/prefill_probe.py [--out FILE]

Copies ``src/repro_torch/csrc`` to ``build/prefill_probe/csrc``, inserts
clock reads into that copy of the wgmma kernel (at anchor lines this script
asserts are present), builds it, and runs it once at the main paths'
shapes (stablelm-12b and zamba2-1.2b prefill, bf16, causal), with a check
against the plain version.  The first thread of each warpgroup records its
block's start and end (``%globaltimer``), its SM, and cycles
(``clock64``) spent in the prologue (barrier set-up, the Q tile, the first
K/V loads), the key loop and the epilogue (output stores issued), and within the
loop, per computed key tile: waiting for the tile's K/V (acquire),
releasing the tile's stage (and, for the last warp done with it, issuing
the stage's next loads), waiting for S = Q K^T, the softmax, and waiting
for O += P V.  Prints per shape: the kernel's span, the share of
SM-time covered by blocks, and the mean cycles of each phase, and writes
them to ``--out`` (``build/prefill_probe.json`` by default).  The kernel
in ``src/`` is not changed.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

FIELDS = ["t0_ns", "t1_ns", "smid", "prologue", "loop", "acquire", "release", "qk_wait",
          "softmax", "pv_wait", "tiles", "epilogue"]

# (anchor, text inserted before it, text inserted after it); each anchor
# must occur exactly once.
PATCHES = [
    ("  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, wg = threadIdx.x >> 7;\n", "",
     "  const long long pr_t0 = clock64(); unsigned long long pr_g0, pr_g1;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(pr_g0));\n"
     "  long long pr_acc[6] = {0, 0, 0, 0, 0, 0}, pr_c = 0;\n"),
    ("  if (maps.q_load) mbar_wait(q_full, 0);\n", "",
     "  const long long pr_t1 = clock64();\n"),
    ("  auto acquire = [&](int i) { mbar_wait(&full[i % NST], (i / NST) & 1); };\n",
     "", "  auto acquire_timed = [&](int i) { const long long c = clock64(); acquire(i);"
     " pr_acc[0] += clock64() - c; };\n"),
    ("  // S = Q K^T for tile i: 16 columns of hd per product; the first\n",
     "  auto release = [&](int i) { const long long c = clock64(); release_untimed(i);"
     " pr_acc[1] += clock64() - c; };\n", ""),
    ("      wgmma_wait<1>();  // S of tile i + 1 (committed first) is complete\n",
     "      pr_c = clock64();\n", "      pr_acc[2] += clock64() - pr_c;\n"),
    ("      softmax(i + 1, s, al0, al1);\n",
     "      pr_c = clock64();\n", "      pr_acc[3] += clock64() - pr_c;\n"),
    ("      wgmma_wait<0>();\n      wgmma_fence_operand(o);\n      release(i);\n",
     "      pr_c = clock64();\n", "      pr_acc[4] += clock64() - pr_c; pr_acc[5] += 1;\n"),
]
LOOP_END = ("  for (int i = it_hi; i < n_tiles; ++i) {\n"
            "    acquire(i);\n    release(i);\n  }\n")
KERNEL_END = ("          *reinterpret_cast<const uint4*>(Qs + swizzled_offset(r, c, R));\n"
              "  }\n}\n")
# Both ways out of the kernel (the TMA store and the per-thread copy) record.
EXITS = ["    return;\n  }\n  asm volatile(\"bar.sync", KERNEL_END[-2:]]
EPILOGUE = "  if (maps.o_store) {\n"
RECORD = """  auto pr_record = [&]() {
  if (g_probe != nullptr && (threadIdx.x & 127) == 0) {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(pr_g1));
    unsigned smid;
    asm("mov.u32 %0, %%smid;" : "=r"(smid));
    long long* r = g_probe + (blockIdx.x * 2 + wg) * 12;
    const long long t_end = clock64();
    r[0] = pr_g0; r[1] = pr_g1; r[2] = smid; r[3] = pr_t1 - pr_t0; r[4] = pr_loop - pr_t1;
    for (int i = 0; i < 6; ++i) r[5 + i] = pr_acc[i];
    r[11] = t_end - pr_loop;
  }
  };
"""
HEADER = """
namespace repro {
__device__ long long* g_probe = nullptr;
}
extern "C" int repro_probe_set(void* p) {
  return static_cast<int>(cudaMemcpyToSymbol(repro::g_probe, &p, sizeof(p)));
}
"""


def patched_source(text: str) -> str:
    loop_body = text[text.index("  if (it_lo < it_hi) {"):text.index(LOOP_END)]
    timed = loop_body.replace("acquire(", "acquire_timed(")
    text = text.replace(loop_body, timed)
    if text.count("  auto release = [&](int i) {\n") != 1:
        raise SystemExit("release not found exactly once")
    text = text.replace("  auto release = [&](int i) {\n", "  auto release_untimed = [&](int i) {\n")
    for anchor, before, after in PATCHES + [(LOOP_END, "", "  const long long pr_loop = clock64();\n")]:
        if text.count(anchor) != 1:
            raise SystemExit(f"anchor not found exactly once: {anchor!r}")
        text = text.replace(anchor, before + anchor + after)
    if text.count(KERNEL_END) != 1 or text.count(EPILOGUE) != 1 or text.count(EXITS[0]) != 1:
        raise SystemExit("kernel exits not found exactly once")
    text = text.replace(EPILOGUE, RECORD + EPILOGUE)
    text = text.replace(EXITS[0], "    pr_record();\n" + EXITS[0])
    text = text.replace(KERNEL_END, KERNEL_END[:-2] + "  pr_record();\n}\n")
    marker = '#include "wgmma.cuh"\n'
    return text.replace(marker, marker + HEADER, 1)


def main() -> int:
    import ctypes

    import torch
    from chip_smoke import card_line, close
    from prefill_ab import PREFILL_SHAPES as SHAPES
    from prefill_ab import prefill_launch as launch
    from repro_torch.kernels import _build, ref

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "build" / "prefill_probe.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("prefill_probe: no CUDA device", file=sys.stderr)
        return 1
    csrc = ROOT / "build" / "prefill_probe" / "csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch" / "csrc", csrc)
    fa = csrc / "flash_attention.cu"
    fa.write_text(patched_source(fa.read_text()))
    lib = _build.bind(_build.build(csrc))
    lib.repro_probe_set.argtypes = [ctypes.c_void_p]
    clock_hz = torch.cuda.get_device_properties(0).clock_rate * 1e3 \
        if hasattr(torch.cuda.get_device_properties(0), "clock_rate") else None
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for name, (B, S, H, K, hd) in SHAPES.items():
        q, k, v = (torch.randn(B, S, n, hd, generator=gen, device="cuda").to(torch.bfloat16)
                   for n in (H, K, K))
        o = torch.empty_like(q)
        rows = 128 // min(H // K, 128)
        blocks = -(-S // rows) * K * B
        buf = torch.zeros(blocks * 2 * 12, dtype=torch.int64, device="cuda")
        for _ in range(3):
            launch(lib, q, k, v, o, hd ** -0.5)
        torch.cuda.synchronize()
        _build.check(lib.repro_probe_set(buf.data_ptr()), "probe")
        launch(lib, q, k, v, o, hd ** -0.5)
        torch.cuda.synchronize()
        _build.check(lib.repro_probe_set(None), "probe")
        want = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                       scale=hd ** -0.5, causal=True).transpose(1, 2)
        err = close(o, want, torch.bfloat16)
        rec = buf.view(blocks * 2, 12).cpu()
        t0, t1 = rec[:, 0], rec[:, 1]
        span_ns = int(t1.max() - t0.min())
        per_sm = {}
        for blk in range(blocks):
            r = rec[2 * blk]
            per_sm.setdefault(int(r[2]), []).append(int(r[1] - r[0]))
        covered = sum(sum(v) for v in per_sm.values()) / (len(per_sm) * span_ns)
        tiles = rec[:, 10].sum().item()
        summary = dict(
            shape=name, blocks=blocks, sms=len(per_sm), max_abs_err=err, span_us=span_ns / 1e3,
            block_us_mean=float((t1 - t0)[::2].double().mean()) / 1e3,
            sm_time_covered_by_blocks=covered,
            prologue_cycles_mean=float(rec[:, 3].double().mean()),
            loop_cycles_mean=float(rec[:, 4].double().mean()),
            epilogue_cycles_mean=float(rec[:, 11].double().mean()),
            tiles_computed_per_warpgroup_mean=tiles / (2 * blocks),
            cycles_per_computed_tile={f: float(rec[:, i].sum()) / max(tiles, 1)
                                      for i, f in ((5, "acquire"), (6, "release"),
                                                   (7, "qk_wait"), (8, "softmax"),
                                                   (9, "pv_wait"))},
            clock_hz=clock_hz)
        out[name] = summary
        print(json.dumps(summary), flush=True)
    path = Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(dict(card=card_line(), **out), indent=1))
    print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
