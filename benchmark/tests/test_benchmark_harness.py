"""The harness's parts, found by name, and its arithmetic, on the CPU."""

import json
import re
import shutil
import sys
import types

import pytest

from benchmark import devtrace, harness, nojax, registry as reg, traffic

from .conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_every_cell_finds_its_parts(registry, spec):
    """Every cell's configuration, mix and metric readers are found by name
    and parse."""
    for cell in spec["workloads"]:
        plan = registry.plan(cell["name"])
        assert plan.config["name"] == cell["config"]
        traffic.check_mix(plan.mix)
        assert {"survey", "tiny_survey", "pipeline", "reference", "check", "precision", "reduced", "assumed",
                "warmup_passes"} <= set(plan.config)
        assert set(plan.config["check"]) <= set(plan.reference.NUMBERS)
        readers = registry.readers(plan)
        assert set(readers) == {m["name"] for m in plan.per_layer}
        assert all(callable(r.read) for r in readers.values())
        assert {m["name"] for m in plan.end_to_end} >= {"setup_s", "pings_per_s"}
        assert plan.per_layer


def test_spec_keeps_to_its_contract(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"] and spec["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= spec["run_seconds"] <= 51
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for e in spec[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    cells = {w["name"] for w in spec["workloads"]}
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
    for m in spec["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in spec["end_to_end"])
    e2e = {m["name"] for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["moves"] in e2e and set(m["workloads"]) <= cells
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
    assert len(json.dumps(spec)) <= 64 * 1024


def test_new_cell_is_new_files_and_entries(tmp_path, spec):
    """A configuration, a mix and a per-layer metric added as new files and
    entries are taken up with no edit to a file that is there."""
    root = tmp_path / "benchmark"
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(ROOT / "benchmark" / sub, root / sub)
    shutil.copy(ROOT / "benchmark" / "plainref.py", root)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    cfg = json.loads((root / "configs" / "anno20.json").read_text())
    cfg.update(name="anno5", survey=dict(cfg["survey"], n_lines=5))
    (root / "configs" / "anno5.json").write_text(json.dumps(cfg))
    (root / "traffic" / "batch2.json").write_text(json.dumps({"name": "batch2", "loop": "closed", "survey_seeds": [9]}))
    (root / "metrics" / "keyframes_s.py").write_text("def read(ctx):\n    return ctx.stage_seconds(('keyframes',))\n")
    new = json.loads(json.dumps(spec))
    new["configs"].append({"name": "anno5", "source": "test", "file": "benchmark/configs/anno5.json",
                           "reduced": [], "why": "test"})
    new["workloads"].append({"name": "anno5.batch2", "config": "anno5", "traffic": "batch2", "chips": 1,
                             "why": "test"})
    new["per_layer"].append({"name": "keyframes_s", "unit": "s", "better": "lower", "source": "program_span",
                             "layer": "entry", "moves": "pings_per_s", "workloads": ["anno5.batch2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))
    r = reg.Registry(tmp_path / "BENCHMARK.json", root=root)
    plan = r.plan("anno5.batch2")
    assert plan.config["survey"]["n_lines"] == 5 and plan.mix["survey_seeds"] == [9]
    assert [m["name"] for m in plan.per_layer] == ["keyframes_s"]
    ctx = harness.Context([{"keyframes": 0.5}, {"keyframes": 1.5}], None)
    assert r.readers(plan)["keyframes_s"].read(ctx) == 1.0
    assert r.plan("anno20.batch").config["name"] == "anno20"
    assert all(p.read_bytes() == b for p, b in before.items())


def test_window_rate_counts_every_pass_and_the_overrun():
    """Passes start while the clock is under the window; the rate is every
    ping of every pass over the time to the last pass's end."""
    now = [0.0]
    mix = {"loop": "closed", "survey_seeds": [1, 2]}

    def clock():
        return now[0]

    def one_pass(k):
        now[0] += 4.0
        return k

    w = traffic.run_window(one_pass, 10.0, mix, clock=clock)
    assert w.passes == [0, 1, 2] and (w.start, w.end) == (0.0, 12.0)
    assert traffic.rate([1000] * 3, w) == pytest.approx(3000 / 12.0)
    one = traffic.run_window(one_pass, 0.0, mix, clock=clock)
    assert len(one.passes) == 1
    with pytest.raises(ValueError):
        traffic.check_mix({"loop": "open", "survey_seeds": [1]})
    with pytest.raises(ValueError):
        traffic.check_mix({"loop": "closed"})


def test_every_seed_visits_the_same_surveys():
    """The seed draws the order of the mix's surveys, never the set."""
    big = 2 ** 31 + 12345
    assert traffic.order(big, 4) == traffic.order(big, 4)
    orders = {tuple(traffic.order(s, 4)) for s in (0, 1, 7, big, 10 ** 12)}
    assert all(sorted(o) == [0, 1, 2, 3] for o in orders) and len(orders) > 1


def test_idle_share_is_a_union_of_overlapping_kernels():
    E = devtrace.Event
    device = [E("k1", 10, 30), E("k2", 20, 40), E("k3", 35, 45), E("k4", 70, 80), E("k5", 95, 130)]
    host = [E("aten::item", 45, 70), E("aten::mm", 0, 12), E("aten::add", 80, 99)]
    spans = [E("pose_graph.trial", 0, 100)]
    s = devtrace.summarize(device, host, spans, 0, 100)
    assert s.busy_s == pytest.approx(50e-9)  # [10, 45) + [70, 80) + [95, 100)
    assert s.window_s == pytest.approx(100e-9)
    assert s.n_device_events == 5
    ctx = harness.Context([], s)
    idle = reg.load_module(ROOT / "benchmark" / "metrics" / "device.idle_pct.batch.py").read(ctx)
    assert idle == pytest.approx(50.0)
    gaps = dict(s.idle_gaps)
    assert gaps["pose_graph.trial > aten::item"] == pytest.approx(25e-9)
    assert gaps["pose_graph.trial > aten::mm"] == pytest.approx(10e-9)
    assert gaps["pose_graph.trial > aten::add"] == pytest.approx(15e-9)
    assert s.device_ops[0] == ("k5", pytest.approx(35e-9))
    assert s.ops["k5"] == (pytest.approx(35e-9), 1) and len(s.ops) == 5
    assert devtrace.union_seconds([], 0, 10) == (0, [(0, 10)])


def test_no_jax_check_compares_whole_top_level_names():
    assert nojax.forbidden_modules(["diasss_tpu_torch", "diasss_tpu_torch.x", "jaxtyping", "numpy"]) == []
    assert nojax.forbidden_modules(["diasss_tpu.x", "jax", "jaxlib.xla", "flax", "torch"]) == [
        "diasss_tpu.x", "flax", "jax", "jaxlib.xla"]


def _fake_run(correct=True):
    return {"correct": correct, "attempted": 4, "failed": 0, "peak": 123,
            "metrics": {"pings_per_s": {"value": 5000.0, "unit": "pings/s"}, "setup_s": {"value": 12.0, "unit": "s"}},
            "device_extra": {}, "breakdown": None, "numbers": {"pose_gap_m": (0.0, 0.01)}}


def _as_if_on_card(monkeypatch, out):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(harness, "card_line", lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: out)


def test_last_line_has_the_contract_keys(monkeypatch, capsys):
    _as_if_on_card(monkeypatch, _fake_run())
    assert harness.main(["--workload", "anno20.batch", "--seed", "4294967311", "--seconds", "1"], 0.0) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["device"] == {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1, "memory_peak_bytes": 123}
    assert line["checks"] == {"pose_gap_m": {"value": 0.0, "limit": 0.01}}
    assert err.strip().splitlines()[-1] == "[check] pose_gap_m 0.0 limit 0.01"
    traced = dict(_fake_run(), device_extra={"busy_s": 1.0, "window_s": 4.0},
                  breakdown={"device_ops": [["k", 1.0]], "idle_gaps": [["a > b", 3.0]]})
    line = json.loads(json.dumps(harness.result_line(traced, "NVIDIA H100 80GB HBM3", 1)))
    assert list(line)[-2:] == ["breakdown", "checks"] and line["device"]["busy_s"] == 1.0


def test_no_result_when_jax_is_loaded(monkeypatch, capsys):
    _as_if_on_card(monkeypatch, _fake_run())
    monkeypatch.setitem(sys.modules, "diasss_tpu", types.ModuleType("diasss_tpu"))
    assert harness.main(["--workload", "anno20.batch", "--seed", "1", "--seconds", "1"], 0.0) == harness.JAX_LOADED
    out, err = capsys.readouterr()
    assert out == "" and "diasss_tpu" in err


def test_no_result_without_the_card(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert harness.main(["--workload", "anno20.batch", "--seed", "1", "--seconds", "1"], 0.0) == harness.NO_CARD
    assert capsys.readouterr().out == ""


def test_no_result_beside_the_benchmark_alone(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    folder, the command exits with an error and prints no result."""
    import subprocess

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    run = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "anno20.batch", "--seed", "3",
                          "--seconds", "1"], cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert run.returncode != 0 and run.stdout == ""


def test_stage_readers_average_over_the_passes(registry):
    stages = [{"keyframes": 0.1, "overlap_gate": 0.01, "loop_closures": 1.0, "lc_gate": 0.1, "pose_graph": 0.5},
              {"keyframes": 0.3, "overlap_gate": 0.03, "loop_closures": 2.0, "lc_gate": 0.3, "pose_graph": 0.7}]
    ctx = harness.Context(stages, None)
    assert registry.reader("lc.stage_s").read(ctx) == pytest.approx(1.7)
    assert registry.reader("pose_graph.stage_s").read(ctx) == pytest.approx(0.6)
    assert registry.reader("pipeline.glue_s").read(ctx) == pytest.approx(0.22)
    assert registry.reader("device.idle_pct.batch").read(ctx) is None
    assert harness.Context([{"keyframes": 0.1}], None).stage_seconds(("full_ba",)) is None
