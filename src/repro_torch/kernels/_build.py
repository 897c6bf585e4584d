"""Builds the CUDA sources under ``repro_torch/csrc`` and binds them.

Each ``csrc/*.cu`` is compiled by its own ``nvcc`` (all started together)
for ``sm_90a`` into an object file, and the objects are linked into one
shared library with a plain C interface, loaded with ctypes.  The build
happens at first use, into ``build/repro_torch/<hash of the sources>/`` at
the root of the checkout, so an edit to any source rebuilds.  A failed
build raises with nvcc's error output.  ptxas reports every kernel's
registers, spills and static shared memory (``-Xptxas -v``); the report is
kept beside the library as ``nvcc.log`` and read by ``resources``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# argtypes of every exported function; pointers and the stream as c_void_p.
SIGNATURES = {
    "repro_flash_prefill": [_I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I]
    + [_L] * 12
    + [_F, _I, _I, _F, _P],
    "repro_flash_decode_shard": [_I, _I, _P, _P, _P, _P, _P, _P, _I, _P] + [_I] * 8
    + [_L] * 12
    + [_F, _I, _F, _P],
    "repro_flash_decode_smem": [_I, _I, _I],
    "repro_flash_decode_clusters": [_I, _I, _I, _I],
    "repro_ssd_intra_chunk": [_I, _I, _I] + [_P] * 7 + [_I] * 4 + [_L] * 10 + [_P],
    "repro_flash_prefill_smem": [_I, _I],
    "repro_ssd_intra_chunk_smem": [_I, _I, _I],
}


def _sources(csrc: Path = CSRC):
    return sorted(csrc.glob("*.cu")), sorted(csrc.glob("*.cuh"))


def source_hash(csrc: Path = CSRC) -> str:
    h = hashlib.sha256()
    for path in sum(_sources(csrc), []):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(ARCH_FLAGS + CFLAGS).encode())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _run_all(cmds) -> str:
    """Runs the commands in parallel; returns their joined output, or raises
    with it if any failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    logs, failed = [], False
    for cmd, p in zip(cmds, procs):
        out, err = p.communicate()
        logs.append(f"$ {' '.join(cmd)}\n{out}{err}")
        failed |= p.returncode != 0
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(logs))
    return "\n".join(logs)


def build(csrc: Path = CSRC) -> Path:
    """Compiles the sources under ``csrc`` if their hash has not been built;
    returns the .so."""
    out_dir = BUILD_ROOT / source_hash(csrc)
    lib = out_dir / "librepro_torch.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    cu, _ = _sources(csrc)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in cu]
        report = _run_all([[nvcc, *ARCH_FLAGS, *CFLAGS, "-c", str(src), "-o", str(obj)]
                           for src, obj in zip(cu, objs)])
        tmp_lib = Path(tmp) / lib.name
        _run_all([[nvcc, *ARCH_FLAGS, "-shared", *map(str, objs), "-o", str(tmp_lib)]])
        (out_dir / "nvcc.log").write_text(report)
        os.replace(tmp_lib, lib)  # atomic: a concurrent builder sees all or nothing
    return lib


def bind(path: Path) -> ctypes.CDLL:
    """Loads a built library and declares the functions of ``SIGNATURES`` it
    exports."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    return bind(build())


def timed_build() -> float:
    """Builds (or finds) the library and returns the seconds it took."""
    t0 = time.perf_counter()
    build()
    return time.perf_counter() - t0


def parse_ptxas(text: str) -> list:
    """Each kernel entry of a ``-Xptxas -v`` report: its mangled name,
    registers, spill stores and loads and static shared memory, in bytes."""
    entries, cur = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = dict(name=m.group(1), registers=0, spill_stores=0, spill_loads=0, smem=0)
            entries.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(s.group(1)) if s else 0
    return entries


def template_args(mangled: str) -> list:
    """The integer and bool template arguments of a mangled kernel name, in
    order (``..._kernelILi160ELb1EEEv...`` gives [160, 1])."""
    m = re.search(r"_kernelI(.*?)EE", mangled)
    return [int(x) for x in re.findall(r"L[ib](\d+)E", m.group(1) + "E")] if m else []


def resources(csrc: Path = CSRC) -> list:
    """ptxas's report of the built kernels under ``csrc`` (see parse_ptxas)."""
    return parse_ptxas((build(csrc).parent / "nvcc.log").read_text())


def check(err: int, name: str) -> None:
    """Raises if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name} failed to launch: cudaError_t {err}")
