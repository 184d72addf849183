"""One run of one cell: set-up, the measured window, the traced stretch,
the comparison with the plain reference, and the result line.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

The cell, its configuration, its traffic mix, its per-layer metrics and
its configuration's plain reference are found by name (:mod:`.registry`).
The run:

1. exits with 2, printing no result, unless the card is there with as many
   devices as the cell asks for;
2. set-up: imports, the mix's surveys at the configuration's sizes (the
   benchmark's frozen ``make_survey``), the order in which the passes
   visit them, drawn from ``--seed``, the pipeline profile that the
   configuration names, and the configuration's warm-up passes, which
   build and load the cell's kernels and visit every shape the window will
   use;
   ``setup_s`` runs from the process's start to the first timed pass;
3. the window: the mix's passes (:mod:`.traffic`) for ``--seconds``;
   ``pings_per_s`` is every ping of every pass over the window's whole time;
4. with ``--trace 1``: the per-layer metrics, from the window's stage
   seconds and program spans (each pass inside the program's
   ``trace.recording()``; the ``--trace 0`` run records none) and from one
   more pass after it under ``torch.profiler`` (the profiled stretch),
   whose idle gaps are named by the program's innermost open span;
5. the device's peak memory is read, the program's answers of every pass
   of the checked survey (the one the first timed pass ran) are taken in
   the reference's layout, the program's state is freed, and the
   configuration's plain reference (numpy and scipy on the host) works out
   that survey's answers; :mod:`.check` holds the numbers that the
   reference forms from both to their limits;
6. exits with 3, printing no result, if a module of JAX or of the JAX
   package is loaded (:mod:`.nojax`);
7. prints the compared numbers beside their limits as the last lines of
   standard error, and the result as the last line of standard output.
"""

import argparse
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Sequence

from . import check, nojax, registry, slampass, traffic

ROOT = Path(__file__).resolve().parents[1]
SPEC = ROOT / "BENCHMARK.json"
NO_CARD = 2
JAX_LOADED = 3


def log(*parts):
    print(*parts, file=sys.stderr, flush=True)


class Context(NamedTuple):
    """What a per-layer metric's reader reads."""

    stages: List[Dict[str, float]]  # each unprofiled window pass's stage seconds
    trace: object  # devtrace.TraceSummary of the profiled stretch, or None
    spans: Sequence[list] = ()  # each unprofiled window pass's program spans (SpanRecords)
    stretch_spans: Sequence = ()  # the profiled stretch's program spans

    def stage_seconds(self, names) -> Optional[float]:
        """The named stages' seconds summed over the passes, per pass; None
        where no pass ran any of them."""
        if not self.stages or not any(n in s for s in self.stages for n in names):
            return None
        return sum(s.get(n, 0.0) for s in self.stages for n in names) / len(self.stages)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=False)
    return (out.stdout.strip().splitlines() or ["nvidia-smi gave nothing"])[0]


def program():
    """The system under test, with the submodules a pass reaches."""
    import diasss_tpu_torch as pkg
    from diasss_tpu_torch import config, frame, pipeline  # noqa: F401

    return pkg


def recorded(pkg, fn):
    """``(fn(), spans)``: ``fn`` run inside the program's span recording
    (``pkg.trace.recording()``); no spans where the program has none."""
    trace = getattr(pkg, "trace", None)
    if trace is None:
        return fn(), []
    with trace.recording() as rec:
        out = fn()
    return out, rec.spans


def profiled_stretch(pkg, fn, device):
    """``fn()`` under ``torch.profiler`` (host and device activity) and the
    program's span recording, inside the :data:`devtrace.STRETCH_SPAN` span:
    ``(fn's result, its spans, the profiler)``.  Under an active profiler
    every program span is also a ``record_function`` span."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from . import devtrace

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    pkg.pipeline._sync(device)
    with profile(activities=activities) as prof:
        with record_function(devtrace.STRETCH_SPAN):
            out, spans = recorded(pkg, fn)
            pkg.pipeline._sync(device)
    return out, spans, prof


class Summary(NamedTuple):
    """What the window keeps of a timed pass."""

    start: float
    end: float
    stages: Dict[str, float]
    pings: int
    record: object  # its slampass.PassRecord, where the pass ran the checked survey
    spans: list  # the program's spans, where the pass was recorded


def run_cell(plan: registry.Plan, reg: registry.Registry, seed: int, seconds: float, trace: bool,
             device, process_start: float) -> dict:
    """The run of one cell on ``device`` (the card; the CPU in the
    benchmark's own tests).  Returns the result line's fields and the
    compared numbers.

    The passes visit the mix's surveys in the order drawn from ``seed``;
    the survey of the first timed pass is the checked one: every pass of
    it, in the window and in the profiled stretch, is held to the
    configuration's reference."""
    import torch

    from . import devtrace, synthetic

    cfg_spec = plan.config
    cuda = device.type == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    pkg = program()
    mix = traffic.check_mix(plan.mix)
    surveys = [synthetic.make_survey(**cfg_spec["survey"], seed=int(s)) for s in mix["survey_seeds"]]
    visit = traffic.order(seed, len(surveys))
    checked = visit[0]
    cfg = slampass.pipeline_config(pkg.config, cfg_spec["pipeline"])
    passes = [slampass.make_pass(pkg, *slampass.survey_items(s), cfg, device) for s in surveys]

    def one_pass(k: int, record: bool = False) -> Summary:
        i = visit[k % len(visit)]
        r, spans = recorded(pkg, passes[i]) if record else (passes[i](), [])
        return Summary(r.start, r.end, r.stages, r.pings, r if i == checked else None, spans)

    traffic.warm_up(one_pass, int(cfg_spec["warmup_passes"]))
    setup_s = time.perf_counter() - process_start
    window = traffic.run_window(lambda k: one_pass(k, trace), seconds, mix)
    log(f"[window] {len(window.passes)} passes in {window.end - window.start:.4f} s; surveys in the order "
        f"{visit} of seeds {mix['survey_seeds']}; walls "
        + " ".join(f"{p.end - p.start:.4f}" for p in window.passes))
    records = [p.record for p in window.passes if p.record is not None]
    last = records[-1].result
    log(f"[window] checked survey (seed {mix['survey_seeds'][checked]}): ATE DR -> EST {last.ate_dr:.4f} "
        f"-> {last.ate_est:.4f} m; loop closures {last.n_lc_accepted}; counters "
        f"{json.dumps(last.counters, sort_keys=True)}")
    metrics = {}
    if trace:
        t0 = time.perf_counter()
        stretch, stretch_spans, prof = profiled_stretch(pkg, lambda: one_pass(0), device)
        t1 = time.perf_counter()
        summary = devtrace.summarize(*devtrace.events_of(prof))
        del prof
        log(f"[trace] stretch {t1 - t0:.3f} s on the host's clock, {summary.window_s:.6f} s on the profiler's; "
            f"{summary.n_device_events} device events; busy {summary.busy_s:.6f} s; {len(stretch_spans)} program "
            f"spans; reduced in {time.perf_counter() - t1:.1f} s")
        records.append(stretch.record)
        del stretch
        ctx = Context([p.stages for p in window.passes], summary, [p.spans for p in window.passes], stretch_spans)
        readers = reg.readers(plan)
        for m in plan.per_layer:
            value = readers[m["name"]].read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev_info = {"busy_s": summary.busy_s, "window_s": summary.window_s}
        breakdown = {"device_ops": [[n, s] for n, s in summary.device_ops],
                     "idle_gaps": [[n, s] for n, s in summary.idle_gaps]}
    else:
        values = {"pings_per_s": traffic.rate([p.pings for p in window.passes], window), "setup_s": setup_s}
        for m in plan.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        dev_info, breakdown = {}, None
    stage_means = {k: sum(p.stages.get(k, 0.0) for p in window.passes) / len(window.passes)
                   for k in window.passes[0].stages}
    log("[window] stage seconds per pass " + json.dumps(stage_means, sort_keys=True))
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    attempted = len(window.passes)
    outs = [plan.reference.outputs(r) for r in records]
    del window, one_pass, passes, records, last
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref_out = plan.reference.run(surveys[checked])
    numbers, failed = check.compare(plan.reference.numbers(outs, ref_out), cfg_spec["check"])
    log(f"[reference] one pass in {time.perf_counter() - t_ref:.1f} s; {len(outs)} passes of the checked survey "
        f"compared")
    return {"correct": check.passed(numbers, failed), "attempted": attempted, "failed": failed,
            "metrics": metrics, "peak": peak, "device_extra": dev_info, "breakdown": breakdown,
            "numbers": numbers}


def result_line(out: dict, kind: str, count: int) -> dict:
    device = {"platform": "gpu", "kind": kind, "count": count, "memory_peak_bytes": int(out["peak"])}
    device.update(out["device_extra"])
    line = {"correct": bool(out["correct"]), "attempted": out["attempted"], "failed": out["failed"],
            "metrics": out["metrics"], "device": device}
    if out["breakdown"] is not None:
        line["breakdown"] = out["breakdown"]
    line["checks"] = {name: {"value": _num(v), "limit": lim} for name, (v, lim) in out["numbers"].items()}
    return line


def _num(v: float):
    return v if math.isfinite(v) else str(v)


def parse(argv):
    ap = argparse.ArgumentParser(prog="benchmark/run.py", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, process_start: float) -> int:
    args = parse(argv)
    reg = registry.Registry(SPEC)
    plan = reg.plan(args.workload)
    chips = int(plan.cell["chips"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA device(s); torch.cuda.is_available() is "
            f"{torch.cuda.is_available()}, device_count() {torch.cuda.device_count()}: no result")
        return NO_CARD
    if chips != 1:
        raise NotImplementedError("the harness drives one-chip cells")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    log(f"[card] {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"[cell] {args.workload} seed {args.seed} seconds {args.seconds} trace {args.trace}")
    out = run_cell(plan, reg, args.seed, args.seconds, bool(args.trace), device, process_start)
    found = nojax.forbidden_modules(list(sys.modules))
    if found:
        log(f"[nojax] the process loaded {found}: no result")
        return JAX_LOADED
    line = result_line(out, torch.cuda.get_device_name(device), chips)
    for name, check_ in line["checks"].items():
        log(f"[check] {name} {check_['value']} limit {check_['limit']}")
    print(json.dumps(line), flush=True)
    return 0
