#!/usr/bin/env python3
"""Where the time of the bf16 ``flash_decode`` kernel goes, block by block.

    python3 tools/decode_probe.py [--out FILE]

Copies ``src/repro_torch/csrc`` to ``build/decode_probe/csrc``, inserts
clock reads into that copy of the bf16 decode kernel and of its cluster
merge (at anchor lines this script asserts are present), builds it, and
runs it once at the main paths' decode shapes (stablelm-12b and
zamba2-1.2b, bf16, ``chip_smoke.py``'s cache lengths), with a check against
the plain version.  Thread 0 of each block records its start and end
(``%globaltimer``), its SM, and cycles (``clock64``) spent in the set-up
(the row's length read, the first loads issued), the key loop and, inside
it, waiting at the ring's stage (the tile's loads and the block barrier),
and within each tile issuing the next tile's loads, the scores, the
softmax and PV; the warps' merge, and in the cluster merge: storing the partial sums into
the owners' memory, waiting at the cluster barrier, and merging and writing
the block's slice.  Prints per shape: the kernel's span (first block start
to last block end), the device time per call of the same launch repeated
(``chip_smoke.time_ms``, warm), how late the blocks start after the first,
and the mean cycles of each phase; writes them to ``--out``
(``build/decode_probe.json`` by default).  The kernel in ``src/`` is not
changed.
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

FIELDS = ["t0_ns", "t1_ns", "smid", "setup", "prologue", "loop", "stage_wait", "issue", "scores",
          "softmax", "pv", "tiles", "warp_merge", "push", "cluster_wait", "merge_out", "total"]

HEADER = """
namespace repro {
__device__ long long* g_probe = nullptr;
}
extern "C" int repro_probe_set(void* p) {
  return static_cast<int>(cudaMemcpyToSymbol(repro::g_probe, &p, sizeof(p)));
}
"""
SETUP = ("  cluster_arrive_relaxed();\n"
         "  const Work wk = block_work(a, static_cast<int>(cg::this_cluster().block_rank()));\n"
         "  const int nh = wk.nh;\n")
RECORD = """  if (g_probe != nullptr && threadIdx.x == 0) {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(pr_g1));
    unsigned smid;
    asm("mov.u32 %0, %%smid;" : "=r"(smid));
    long long* r = g_probe + ((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) * 17;
    r[0] = pr_g0; r[1] = pr_g1; r[2] = smid; r[3] = pr_c1 - pr_c0; r[4] = pr_cl - pr_c1;
    r[5] = pr_c2 - pr_cl;
    for (int i = 0; i < 5; ++i) r[6 + i] = pr_t[i];
    r[11] = pr_tiles; r[12] = pr_c3 - pr_c2; r[13] = pr_mg[1] - pr_mg[0];
    r[14] = pr_mg[2] - pr_mg[1]; r[15] = pr_mg[3] - pr_mg[2]; r[16] = clock64() - pr_c0;
  }
"""
# (anchor, replacement); each anchor must occur exactly once.
PATCHES = [
    # the bf16 kernel: its start, the end of its set-up, the stage wait, the
    # end of the key loop and its call of the cluster merge
    (SETUP, "  unsigned long long pr_g0, pr_g1;\n"
            "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(pr_g0));\n"
            "  const long long pr_c0 = clock64();\n"
            "  long long pr_t[5] = {0, 0, 0, 0, 0}, pr_tiles = 0, pr_c;\n" + SETUP
            + "  const long long pr_c1 = clock64();\n"),
    ("  for (int it = 0, stage = 0; it < n_tiles;",
     "  const long long pr_cl = clock64();\n  for (int it = 0, stage = 0; it < n_tiles;"),
    ("    cp_async_wait<kStages - 2>();  // tile `it` has landed\n"
     "    __syncthreads();               // ... for every thread; and tile it - 1 is consumed\n",
     "    pr_c = clock64();\n"
     "    cp_async_wait<kStages - 2>();  // tile `it` has landed\n"
     "    __syncthreads();               // ... for every thread; and tile it - 1 is consumed\n"
     "    pr_t[0] += clock64() - pr_c;\n    ++pr_tiles;\n    pr_c = clock64();\n"),
    ("      cp_async_commit();\n    }\n    const int kw0 =",
     "      cp_async_commit();\n    }\n    pr_t[1] += clock64() - pr_c;\n    pr_c = clock64();\n"
     "    const int kw0 ="),
    ("    // Online softmax of head g",
     "    pr_t[2] += clock64() - pr_c;\n    pr_c = clock64();\n    // Online softmax of head g"),
    ("    // O = alpha O + P V.\n",
     "    pr_t[3] += clock64() - pr_c;\n    pr_c = clock64();\n    // O = alpha O + P V.\n"),
    ("    }\n  }\n  cp_async_wait<0>();\n  __syncthreads();  // the ring is free",
     "    }\n    pr_t[4] += clock64() - pr_c;\n  }\n  const long long pr_c2 = clock64();\n"
     "  cp_async_wait<0>();\n  __syncthreads();  // the ring is free"),
    ("  cluster_merge<bf16, HD>(\n      a, wk,",
     "  const long long pr_c3 = clock64();\n  long long pr_mg[4];\n"
     "  cluster_merge<bf16, HD>(\n      pr_mg, a, wk,"),
    ("      rx);\n}\n", "      rx);\n" + RECORD + "}\n"),
    # the cluster merge: a probe argument, its entry, its barrier and its end
    ("__device__ void cluster_merge(const DecodeArgs& a,",
     "__device__ void cluster_merge(long long* pr_m, const DecodeArgs& a,"),
    ("cluster_merge<float, HD>(a, wk,",
     "long long pr_unused[4];\n  cluster_merge<float, HD>(pr_unused, a, wk,"),
    ("  const int n = wk.nh * HD, slice = (n + cs - 1) / cs;\n",
     "  const int n = wk.nh * HD, slice = (n + cs - 1) / cs;\n"
     "  if (threadIdx.x == 0) pr_m[0] = clock64();\n"),
    ("  cluster.sync();  // every split's partial sums are in their owners' memory\n",
     "  if (threadIdx.x == 0) pr_m[1] = clock64();\n"
     "  cluster.sync();  // every split's partial sums are in their owners' memory\n"
     "  if (threadIdx.x == 0) pr_m[2] = clock64();\n"),
    ("    ob[r * a.osh + d] = from_f32<T>(sum > 0.f ? o / sum : 0.f);\n  }\n}\n",
     "    ob[r * a.osh + d] = from_f32<T>(sum > 0.f ? o / sum : 0.f);\n  }\n"
     "  if (threadIdx.x == 0) pr_m[3] = clock64();\n}\n"),
    ('#include "common.cuh"\n', '#include "common.cuh"\n' + HEADER),
]


def patched_source(text: str) -> str:
    for anchor, replacement in PATCHES:
        if text.count(anchor) != 1:
            raise SystemExit(f"anchor not found exactly once: {anchor!r}")
        text = text.replace(anchor, replacement)
    return text


def main() -> int:
    import ctypes

    import torch
    from chip_smoke import card_line, close, time_ms
    from prefill_ab import DECODE_SHAPES, DecodeVersion
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.decode_attention import plan

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "build" / "decode_probe.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_probe: no CUDA device", file=sys.stderr)
        return 1
    csrc = ROOT / "build" / "decode_probe" / "csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch" / "csrc", csrc)
    da = csrc / "decode_attention.cu"
    da.write_text(patched_source(da.read_text()))
    lib = _build.bind(_build.build(csrc))
    lib.repro_probe_set.argtypes = [ctypes.c_void_p]
    version = DecodeVersion(lib, csrc)
    shipped = DecodeVersion(_build.library(), _build.CSRC)  # the kernel without clock reads
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for name, (B, S, H, K, hd, lengths) in DECODE_SHAPES.items():
        q = torch.randn(B, H, hd, generator=gen, device="cuda").to(torch.bfloat16)
        kc, vc = (torch.randn(B, S, K, hd, generator=gen, device="cuda").to(torch.bfloat16)
                  for _ in range(2))
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        o = torch.empty_like(q)
        p = plan(B, K, H // K, S, hd, None, lambda c, h: version.resident(hd, c, h))
        blocks = p.cluster * K * p.groups * B
        buf = torch.zeros(blocks * len(FIELDS), dtype=torch.int64, device="cuda")
        scale = hd ** -0.5
        event_ms = time_ms(lambda: version(q, kc, vc, lens, o, scale), iters=100)
        plain_ms = time_ms(lambda: shipped(q, kc, vc, lens, o, scale), iters=100)
        torch.cuda.synchronize()
        _build.check(lib.repro_probe_set(buf.data_ptr()), "probe")
        version(q, kc, vc, lens, o, scale)
        torch.cuda.synchronize()
        _build.check(lib.repro_probe_set(None), "probe")
        want = ref.decode_attention_ref(q, kc.transpose(1, 2), vc.transpose(1, 2), lens,
                                        scale=scale)
        err = close(o, want, torch.bfloat16)
        rec = buf.view(blocks, len(FIELDS)).cpu().double()
        t0, t1 = rec[:, 0], rec[:, 1]
        summary = dict(
            shape=name, plan=p._asdict(), blocks=blocks, sms=len(set(rec[:, 2].tolist())),
            max_abs_err=err, event_us_per_call=event_ms * 1e3,
            event_us_per_call_without_probe=plain_ms * 1e3,
            span_us=float(t1.max() - t0.min()) / 1e3,
            block_us_mean=float((t1 - t0).mean()) / 1e3,
            start_after_first_us_mean=float((t0 - t0.min()).mean()) / 1e3,
            start_after_first_us_max=float((t0 - t0.min()).max()) / 1e3,
            cycles_mean={f: float(rec[:, i].mean()) for i, f in enumerate(FIELDS) if i >= 3},
            sm_clock_mhz=float((rec[:, -1] / (t1 - t0)).mean()) * 1e3)
        out[name] = summary
        print(json.dumps(summary), flush=True)
    path = Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(dict(card=card_line(), **out), indent=1))
    print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
