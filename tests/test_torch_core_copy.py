"""The port's consensus core is the reference's, byte for byte.

* Each of the 15 modules of ``repro_torch/core`` equals its source in
  ``repro/core``.
* ``repro_torch/coord/{control_plane,failure}.py`` equal their sources with
  ``repro.core`` / ``repro.coord`` read as ``repro_torch.core`` /
  ``repro_torch.coord``, and differ in nothing else.
* The transports that are not copied raise when asked for.
"""

import re
from pathlib import Path

import pytest

from repro_torch.core import deploy

ROOT = Path(__file__).resolve().parents[1]
CORE = ["messages", "quorums", "rounds", "runtime", "sim", "acceptor", "oracle", "proposer",
        "log", "replica", "client", "matchmaker", "mm_reconfig", "deploy", "wire"]


@pytest.mark.parametrize("name", CORE)
def test_core_module_is_a_byte_copy(name):
    mine = (ROOT / "src/repro_torch/core" / f"{name}.py").read_bytes()
    theirs = (ROOT / "src/repro/core" / f"{name}.py").read_bytes()
    assert mine == theirs


def test_core_holds_only_the_copies():
    names = {p.stem for p in (ROOT / "src/repro_torch/core").glob("*.py")}
    assert names == set(CORE) | {"__init__"}


@pytest.mark.parametrize("name", ["control_plane", "failure"])
def test_coord_module_is_a_renamed_copy(name):
    mine = (ROOT / "src/repro_torch/coord" / f"{name}.py").read_text()
    theirs = (ROOT / "src/repro/coord" / f"{name}.py").read_text()
    renamed = re.sub(r"\brepro\.(core|coord)\b", r"repro_torch.\1", theirs)
    assert renamed != theirs  # the source does import the core
    assert mine == renamed
    assert not re.search(r"\brepro\.", mine)


@pytest.mark.parametrize("backend", ["async", "tcp", "proc"])
def test_uncopied_transports_raise(backend):
    with pytest.raises(ModuleNotFoundError):
        deploy.make_transport(backend)
    assert deploy.make_transport("sim").now == 0.0
