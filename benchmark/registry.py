"""Find a cell's parts by name.

``BENCHMARK.json`` names the cells, configurations and metrics; each part
lives in a file of its own under the benchmark's directory, found by its
name: ``configs/<config>.json`` (the file that ``BENCHMARK.json`` gives),
``traffic/<mix>.json`` and ``metrics/<metric>.py``.
A new cell is a new entry and, at most, new files: nothing here names a
cell, a configuration, a mix or a metric."""

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, NamedTuple

HERE = Path(__file__).resolve().parent


def load_module(path: Path) -> ModuleType:
    """The Python file at ``path`` as a module of its own (names with dots,
    such as ``pose_graph.stage_s``, are not importable by name)."""
    spec = importlib.util.spec_from_file_location(f"benchmark_part_{path.stem.replace('.', '_')}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Plan(NamedTuple):
    cell: dict  # the workloads entry
    config: dict  # configs/<config>.json
    mix: dict  # traffic/<mix>.json
    end_to_end: List[dict]  # the end-to-end metrics the cell reports
    per_layer: List[dict]  # the per-layer metrics the cell reports


class Registry:
    def __init__(self, spec_path: Path, root: Path = HERE):
        self.spec_path = Path(spec_path)
        self.base = self.spec_path.parent  # paths in BENCHMARK.json are relative to it
        self.root = Path(root)
        self.spec = json.loads(self.spec_path.read_text())

    def _entry(self, key: str, name: str) -> dict:
        found = [e for e in self.spec[key] if e["name"] == name]
        if len(found) != 1:
            raise KeyError(f"{key} has {len(found)} entries named {name!r}")
        return found[0]

    def config(self, name: str) -> dict:
        cfg = json.loads((self.base / self._entry("configs", name)["file"]).read_text())
        if cfg.get("name") != name:
            raise ValueError(f"configuration file of {name!r} names {cfg.get('name')!r}")
        return cfg

    def mix(self, name: str) -> dict:
        return json.loads((self.root / "traffic" / f"{name}.json").read_text())

    def reader(self, metric: str) -> ModuleType:
        return load_module(self.root / "metrics" / f"{metric}.py")

    def end_to_end(self, cell: str) -> List[dict]:
        return [m for m in self.spec["end_to_end"] if "workloads" not in m or cell in m["workloads"]]

    def per_layer(self, cell: str) -> List[dict]:
        moved = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.spec["per_layer"]
                if (cell in m["workloads"] if "workloads" in m else m["moves"] in moved)]

    def plan(self, cell: str) -> Plan:
        entry = self._entry("workloads", cell)
        return Plan(entry, self.config(entry["config"]), self.mix(entry["traffic"]),
                    self.end_to_end(cell), self.per_layer(cell))

    def readers(self, plan: Plan) -> Dict[str, ModuleType]:
        return {m["name"]: self.reader(m["name"]) for m in plan.per_layer}
