"""``BENCHMARK.json`` and the files it names, found by name under ``perfbench/``."""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

ROOT = Path(__file__).resolve().parents[1]


@dataclass
class Cell:
    """One cell of the benchmark with everything it names, read from files."""

    name: str
    chips: int
    config: Dict[str, Any]  # configs/<name>.json, with its BENCHMARK.json entry
    traffic: Dict[str, Any]  # traffic/<name>.json
    limits: Dict[str, Any]  # workloads/<cell>.json
    end_to_end: List[Dict[str, Any]]  # the metrics this cell reports with --trace 0
    per_layer: List[Dict[str, Any]]  # ... and with --trace 1


class Bench:
    """The benchmark under ``root`` (a checkout, or a copy holding another
    ``BENCHMARK.json``)."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def file(self, *parts: str) -> Path:
        path = self.root.joinpath("perfbench", *parts)
        if not path.is_file():
            raise FileNotFoundError(f"the benchmark has no {path.relative_to(self.root)}")
        return path

    def json(self, folder: str, name: str) -> Dict[str, Any]:
        return json.loads(self.file(folder, f"{name}.json").read_text())

    def module(self, folder: str, name: str) -> ModuleType:
        """``perfbench/<folder>/<name>.py``, loaded by its path (a name may
        hold dots), once per process."""
        key = f"perfbench._{folder}.{name}@{self.root}"
        if key in sys.modules:
            return sys.modules[key]
        path = self.file(folder, f"{name}.py")
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
        return mod

    def _entry(self, key: str, name: str) -> Dict[str, Any]:
        for entry in self.data[key]:
            if entry["name"] == name:
                return entry
        raise KeyError(f"BENCHMARK.json has no {key} entry {name!r}")

    @staticmethod
    def _reports(metric: Dict[str, Any], cell: str) -> bool:
        """A metric with no ``workloads`` is every cell's."""
        return cell in metric.get("workloads", [cell])

    def cell(self, name: str) -> Cell:
        w = self._entry("workloads", name)
        entry = self._entry("configs", w["config"])
        config = {**json.loads((self.root / entry["file"]).read_text()), "entry": entry}
        e2e = [m for m in self.data["end_to_end"] if self._reports(m, name)]
        per_layer = [m for m in self.data["per_layer"] if self._reports(m, name)]
        return Cell(name=name, chips=w["chips"], config=config,
                    traffic=self.json("traffic", w["traffic"]),
                    limits=self.json("workloads", name), end_to_end=e2e, per_layer=per_layer)
