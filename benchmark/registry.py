"""Find a cell's parts by name.

``BENCHMARK.json`` names the cells, configurations and metrics; each part
lives in a file of its own under the benchmark's directory, found by its
name: ``configs/<config>.json`` (the file that ``BENCHMARK.json`` gives),
``traffic/<mix>.json``, ``metrics/<metric>.py`` and the configuration's
plain reference, ``<reference>.py``.  A new cell is a new entry and, at
most, new files: nothing here or in the harness names a cell, a
configuration, a mix, a metric, a reference, a pipeline profile or a check
number.

A configuration file holds the survey's sizes (``survey``), the survey the
benchmark's own CPU tests run instead (``tiny_survey``), the program's
pipeline profile (``pipeline``), the reference's module (``reference``),
the limits of the numbers compared (``check``) and the warm-up passes.

``pipeline`` is ``{"profile": NAME}`` or ``{"profile": NAME, "args":
{...}}``: the function ``NAME_config`` of the program's ``config`` module
called with ``args`` (``automatic``: ``automatic_config(drift_budget=...)``),
or, where the module has no such function, its constant ``NAME`` in
capitals, which takes no arguments (``default``: ``config.DEFAULT``,
``PipelineConfig()``); :func:`benchmark.slampass.pipeline_config`.

The reference module provides:

* ``PROFILE``: the ``pipeline`` entry whose answers it computes; a
  configuration that names another profile is refused;
* ``NUMBERS``: the names of the numbers it forms; a limit on any other is
  refused;
* ``run(survey, control=False)``: its answers for a survey (``control``:
  in the precision below the configuration's, :mod:`benchmark.control`);
* ``outputs(record)``: the program's answers of one pass (a
  :class:`benchmark.slampass.PassRecord`) in the reference's layout;
* ``numbers(passes, ref)``: ``{name: value}`` from the outputs of every
  checked pass, in order, and the reference's answers; a value is a number,
  or a list with one number per pass where each pass is held to it alone.
  :mod:`benchmark.check` holds them to their limits.

A per-layer metric's reader, ``read(ctx)``, gets a
:class:`benchmark.harness.Context`: ``stages`` (each unprofiled window
pass's stage seconds), ``trace`` (the profiled stretch's
:class:`benchmark.devtrace.TraceSummary`, whose ``ops`` has every device
operation's seconds and count by name), ``spans`` (each unprofiled window
pass's program spans, ``SpanRecord``\\ s of ``diasss_tpu_torch.trace``) and
``stretch_spans`` (those of the profiled stretch); the last three only in
a ``--trace 1`` run."""

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, NamedTuple, Tuple

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


def profile_of(entry) -> Tuple[str, dict]:
    """``(name, args)`` of a ``pipeline`` entry; raises on any other shape."""
    args = entry.get("args", {}) if isinstance(entry, dict) else None
    if not isinstance(args, dict) or not isinstance(entry.get("profile"), str) or set(entry) - {"profile", "args"}:
        raise ValueError(f"a pipeline entry is {{'profile': NAME, 'args': {{...}}}}, not {entry!r}")
    return entry["profile"], dict(args)


class Plan(NamedTuple):
    cell: dict  # the workloads entry
    config: dict  # configs/<config>.json
    mix: dict  # traffic/<mix>.json
    end_to_end: List[dict]  # the end-to-end metrics the cell reports
    per_layer: List[dict]  # the per-layer metrics the cell reports
    reference: ModuleType  # the configuration's plain reference


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

    def reference(self, config: dict) -> ModuleType:
        """The plain reference that ``config`` names, once it is shown to
        state the configuration's pipeline profile and to form every number
        that the configuration limits."""
        if not str(config.get("reference")).isidentifier():
            raise ValueError(f"configuration {config['name']!r} names no reference module: {config.get('reference')!r}")
        ref = load_module(self.root / f"{config['reference']}.py")
        if profile_of(config["pipeline"]) != profile_of(ref.PROFILE):
            raise ValueError(f"configuration {config['name']!r} runs the pipeline {config['pipeline']!r}; its "
                             f"reference {config['reference']!r} states {ref.PROFILE!r}")
        unknown = set(config["check"]) - set(ref.NUMBERS)
        if unknown:
            raise ValueError(f"configuration {config['name']!r} limits {sorted(unknown)}, which its reference "
                             f"{config['reference']!r} does not form (it forms {list(ref.NUMBERS)})")
        return ref

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
        config = self.config(entry["config"])
        return Plan(entry, config, self.mix(entry["traffic"]), self.end_to_end(cell), self.per_layer(cell),
                    self.reference(config))

    def readers(self, plan: Plan) -> Dict[str, ModuleType]:
        return {m["name"]: self.reader(m["name"]) for m in plan.per_layer}
