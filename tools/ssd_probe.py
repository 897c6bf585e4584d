#!/usr/bin/env python3
"""Where the time of the bf16 ``ssd_intra_chunk`` kernel goes, block by block.

    python3 tools/ssd_probe.py [--out FILE]

Copies ``src/repro_torch/csrc`` to ``build/ssd_probe/csrc``, inserts clock
reads into that copy of the bf16 SSD kernel (at anchor lines this script
asserts are present), builds it, and runs it once at the main paths' SSD
shapes (mamba2-2.7b and zamba2-1.2b, bf16, ``chip_smoke.ssd_inputs``), with
a check against the plain version.  Thread 0 of each block (warp 0, whose
rows are never past the chunk) records its start and end
(``%globaltimer``), its SM, and cycles (``clock64``) spent in: the decays'
scan; the y pass's C strip loads (with the barrier before them); per key
strip, waiting at the barrier before its loads (the slowest warp's
products), the B and X loads with the barrier after them, the scores, the
mask and decay, and the PV product; the y stores; the state pass's loads
and split (with its barriers) and its products.  Prints per shape: the
kernel's span (first block start to last block end), the device time per
call of the same launch repeated with and without the clock reads
(``chip_smoke.time_ms``), the mean blocks resident on an SM over the span,
and the mean cycles of each phase; writes them to ``--out``
(``build/ssd_probe.json`` by default).  The kernel in ``src/`` is not
changed.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

PHASES = ["cum", "c_load", "kv_barrier", "kv_load", "scores", "decay", "pv", "y_store",
          "st_load", "st_mma"]
FIELDS = ["t0_ns", "t1_ns", "smid", *PHASES, "total"]

HEADER = """
namespace repro {
__device__ long long* g_probe = nullptr;
}
extern "C" int repro_probe_set(void* p) {
  return static_cast<int>(cudaMemcpyToSymbol(repro::g_probe, &p, sizeof(p)));
}
"""
RECORD = f"""  if (g_probe != nullptr && threadIdx.x == 0) {{
    unsigned long long pr_g1;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(pr_g1));
    unsigned smid;
    asm("mov.u32 %0, %%smid;" : "=r"(smid));
    long long* r = g_probe + ((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) *
                             {len(FIELDS)};
    r[0] = pr_g0; r[1] = pr_g1; r[2] = smid;
    for (int i = 0; i < {len(PHASES)}; ++i) r[3 + i] = pr_t[i];
    r[{len(FIELDS) - 1}] = clock64() - pr_c0;
  }}
"""


def tick(i):
    return f"pr_t[{i}] += clock64() - pr_c;\n"


# (anchor, replacement); each anchor must occur exactly once.
PATCHES = [
    ('#include "common.cuh"\n', '#include "common.cuh"\n' + HEADER),
    ("  bf16* Xl = Cs;  // ... and low part\n",
     "  bf16* Xl = Cs;  // ... and low part\n"
     "  unsigned long long pr_g0;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(pr_g0));\n"
     "  const long long pr_c0 = clock64();\n"
     f"  long long pr_t[{len(PHASES)}] = {{}}, pr_c = pr_c0;\n"),
    ("  chunk_cumsum(a, ab, row0, h, cum);\n\n  auto store_to",
     "  chunk_cumsum(a, ab, row0, h, cum);\n  " + tick(0) + "\n  auto store_to"),
    ("    __syncthreads();  // every warp is done with the previous C strip\n"
     "    load_strip<bf16, N>(cb, a.css, i0, Q, store_to(Cs, LDN));\n",
     "    pr_c = clock64();\n"
     "    __syncthreads();  // every warp is done with the previous C strip\n"
     "    load_strip<bf16, N>(cb, a.css, i0, Q, store_to(Cs, LDN));\n    " + tick(1)),
    ("      __syncthreads();  // every warp is done with the previous B and X strips\n"
     "      load_strip<bf16, N>(bb, a.bss, j0, Q, store_to(Bs, LDN));\n"
     "      load_strip<bf16, HD>(xb, a.xss, j0, Q, store_to(Xs, LDX));\n"
     "      __syncthreads();\n",
     "      pr_c = clock64();\n"
     "      __syncthreads();  // every warp is done with the previous B and X strips\n"
     "      " + tick(2) + "      pr_c = clock64();\n"
     "      load_strip<bf16, N>(bb, a.bss, j0, Q, store_to(Bs, LDN));\n"
     "      load_strip<bf16, HD>(xb, a.xss, j0, Q, store_to(Xs, LDX));\n"
     "      __syncthreads();\n      " + tick(3) + "      pr_c = clock64();\n"),
    ("      // Masked and decayed, in place,",
     "      " + tick(4) + "      pr_c = clock64();\n      // Masked and decayed, in place,"),
    ("      // o += P X: k-step kk's",
     "      " + tick(5) + "      pr_c = clock64();\n      // o += P X: k-step kk's"),
    ("          mma_bf16(o[n + 1], al, xf[2], xf[3]);\n        }\n      }\n    }\n",
     "          mma_bf16(o[n + 1], al, xf[2], xf[3]);\n        }\n      }\n      " + tick(6)
     + "    }\n    pr_c = clock64();\n"),
    ("        *reinterpret_cast<float2*>(yr + n * 8) = make_float2(o[n][2 * half], "
     "o[n][2 * half + 1]);\n    }\n  }\n",
     "        *reinterpret_cast<float2*>(yr + n * 8) = make_float2(o[n][2 * half], "
     "o[n][2 * half + 1]);\n    }\n    " + tick(7) + "  }\n"),
    ("      __syncthreads();  // the decays are written; the strips of the previous pass are "
     "consumed\n      load_strip<bf16, N>(bb",
     "      pr_c = clock64();\n"
     "      __syncthreads();  // the decays are written; the strips of the previous pass are "
     "consumed\n      load_strip<bf16, N>(bb"),
    ("        *reinterpret_cast<uint4*>(Xl + r * LDX + c) = lo;\n      });\n"
     "      __syncthreads();\n",
     "        *reinterpret_cast<uint4*>(Xl + r * LDX + c) = lo;\n      });\n"
     "      __syncthreads();\n      " + tick(8) + "      pr_c = clock64();\n"),
    ("          mma_bf16(st[2 * pp + 1], al, bf[2], bf[3]);\n        }\n      }\n    }\n",
     "          mma_bf16(st[2 * pp + 1], al, bf[2], bf[3]);\n        }\n      }\n      "
     + tick(9) + "    }\n"),
    ("              make_float2(st[2 * pp + q][2 * half], st[2 * pp + q][2 * half + 1]);\n"
     "    }\n  }\n}\n",
     "              make_float2(st[2 * pp + q][2 * half], st[2 * pp + q][2 * half + 1]);\n"
     "    }\n  }\n" + RECORD + "}\n"),
]


def patched_source(text: str) -> str:
    for anchor, replacement in PATCHES:
        if text.count(anchor) != 1:
            raise SystemExit(f"anchor not found exactly once: {anchor!r}")
        text = text.replace(anchor, replacement)
    return text


def main() -> int:
    import torch
    from chip_smoke import card_line, time_ms
    from prefill_ab import SSD_SHAPES, ssd_cases
    from repro_torch.kernels import _build

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "build" / "ssd_probe.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ssd_probe: no CUDA device", file=sys.stderr)
        return 1
    csrc = ROOT / "build" / "ssd_probe" / "csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch" / "csrc", csrc)
    src = csrc / "ssd_scan.cu"
    src.write_text(patched_source(src.read_text()))
    lib = _build.bind(_build.build(csrc))
    lib.repro_probe_set.argtypes = [ctypes.c_void_p]
    libs = {"probe": lib, "shipped": _build.library()}  # shipped: without clock reads
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for name, inputs, check, launch, _ in ssd_cases(gen, libs, None):
        B, S, nh, hd, N, Q, dtype = SSD_SHAPES[name]
        if dtype != "bfloat16":
            continue
        operands = inputs["warm"][0]
        blocks = S // Q * nh * B
        buf = torch.zeros(blocks * len(FIELDS), dtype=torch.int64, device="cuda")
        event_ms = time_ms(lambda: launch("probe", *operands), iters=50)
        plain_ms = time_ms(lambda: launch("shipped", *operands), iters=50)
        torch.cuda.synchronize()
        _build.check(lib.repro_probe_set(buf.data_ptr()), "probe")
        got = launch("probe", *operands)
        torch.cuda.synchronize()
        _build.check(lib.repro_probe_set(None), "probe")
        err = check(got)
        rec = buf.view(blocks, len(FIELDS)).cpu().double()
        t0, t1 = rec[:, 0], rec[:, 1]
        span = float(t1.max() - t0.min())
        sms = len(set(rec[:, 2].tolist()))
        cycles = {f: float(rec[:, i].mean()) for i, f in enumerate(FIELDS) if i >= 3}
        cycles["other"] = cycles["total"] - sum(cycles[p] for p in PHASES)
        summary = dict(
            shape=name, blocks=blocks, sms=sms, max_abs_err=err,
            event_us_per_call=event_ms * 1e3, event_us_per_call_without_probe=plain_ms * 1e3,
            span_us=span / 1e3, block_us_mean=float((t1 - t0).mean()) / 1e3,
            resident_blocks_per_sm_mean=float((t1 - t0).sum()) / (span * sms),
            cycles_mean=cycles, sm_clock_mhz=float((rec[:, -1] / (t1 - t0)).mean()) * 1e3)
        out[name] = summary
        print(json.dumps(summary), flush=True)
    path = Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(dict(card=card_line(), **out), indent=1))
    print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
