"""The port's consensus core is the reference's, byte for byte.

* Each module of ``repro_torch/core`` but ``proc`` equals its source in
  ``repro/core``, ``__init__`` included, and the two packages hold the
  same modules.
* ``repro_torch/core/proc.py``, ``repro_torch/mc.py`` and
  ``repro_torch/coord/{control_plane,failure}.py`` equal their sources with
  ``repro.core`` / ``repro.coord`` / ``repro.mc`` read as
  ``repro_torch.core`` / ``repro_torch.coord`` / ``repro_torch.mc``, and
  differ in nothing else.
* Each transport backend builds the port's own class.
"""

import re
from pathlib import Path

import pytest

import repro_torch.core as core
from repro_torch.core import deploy

ROOT = Path(__file__).resolve().parents[1]
CORE = ["messages", "quorums", "rounds", "runtime", "sim", "acceptor", "oracle", "proposer",
        "log", "replica", "client", "matchmaker", "mm_reconfig", "deploy", "wire",
        "nemesis", "single", "fast_paxos", "horizontal", "net", "tcp", "scenarios", "mc",
        "__init__"]


@pytest.mark.parametrize("name", CORE)
def test_core_module_is_a_byte_copy(name):
    mine = (ROOT / "src/repro_torch/core" / f"{name}.py").read_bytes()
    theirs = (ROOT / "src/repro/core" / f"{name}.py").read_bytes()
    assert mine == theirs


def test_core_holds_only_the_copies():
    def names(pkg):
        return {p.stem for p in (ROOT / "src" / pkg / "core").glob("*.py")}

    assert names("repro_torch") == names("repro") == set(CORE) | {"proc"}


def check_renamed_copy(path):
    mine = (ROOT / "src/repro_torch" / f"{path}.py").read_text()
    theirs = (ROOT / "src/repro" / f"{path}.py").read_text()
    renamed = re.sub(r"\brepro\.(core|coord|mc)\b", r"repro_torch.\1", theirs)
    assert renamed != theirs  # the source does name the package
    assert mine == renamed
    assert not re.search(r"\brepro\.", mine)


@pytest.mark.parametrize("name", ["control_plane", "failure"])
def test_coord_module_is_a_renamed_copy(name):
    check_renamed_copy(f"coord/{name}")


@pytest.mark.parametrize("path", ["core/proc", "mc"])
def test_module_is_a_renamed_copy(path):
    check_renamed_copy(path)


@pytest.mark.parametrize("backend,cls", [("async", "AsyncTransport"), ("tcp", "TcpTransport"),
                                         ("proc", "ProcTransport")])
def test_transports_are_the_ports(backend, cls):
    t = deploy.make_transport(backend)
    assert type(t) is getattr(core, cls)
    assert type(t).__module__.startswith("repro_torch.core.")
    if backend == "proc":
        assert t.workdir.exists()
    assert deploy.make_transport("sim").now == 0.0
