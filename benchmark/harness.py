"""One run of one cell: set-up, the measured window, the traced stretch,
the comparison with the plain reference, and the result line.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

The cell, its configuration, its traffic mix and its per-layer metrics are
found by name (:mod:`.registry`).  The run:

1. exits with 2, printing no result, unless the card is there with as many
   devices as the cell asks for;
2. set-up: imports, the mix's surveys at the configuration's sizes (the
   benchmark's frozen ``make_survey``), the order in which the passes
   visit them, drawn from ``--seed``, the program's configuration, and the
   configuration's warm-up passes, which build and load the cell's kernels
   and visit every shape the window will use;
   ``setup_s`` runs from the process's start to the first timed pass;
3. the window: the mix's passes (:mod:`.traffic`) for ``--seconds``;
   ``pings_per_s`` is every ping of every pass over the window's whole time;
4. with ``--trace 1``: the per-layer metrics, from the window's stage
   seconds and from one more pass after it under ``torch.profiler`` (the
   profiled stretch);
5. the device's peak memory is read, the program's state freed, and the
   plain reference (:mod:`.plainref`, numpy and scipy on the host) works
   out the answers for the survey that the first timed pass ran;
   :mod:`.check` holds the poses of every pass of that survey, and the loop
   closures of its last pass, to them;
6. exits with 3, printing no result, if a module of JAX or of the JAX
   package is loaded (:mod:`.nojax`);
7. prints the compared numbers beside their limits as the last lines of
   standard error, and the result as the last line of standard output.
"""

import argparse
import gc
import importlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional

from . import check, nojax, registry, slampass, traffic

ROOT = Path(__file__).resolve().parents[1]
SPEC = ROOT / "BENCHMARK.json"
NO_CARD = 2
JAX_LOADED = 3

# run_slam's stage entries, each wrapped in a record_function span in the
# profiled stretch, so that idle gaps read by what the host was running
STAGE_SPANS = {"frame": ("build_keyframes_batch",),
               "pipeline": ("_overlap_pairs", "_assemble_pairs", "_solve_two_stage", "_evaluate_pairs"),
               "solvers.lc": ("loop_closing_tfs_stacked",),
               "solvers.pose_graph": ("build_chain_graph", "solve_pose_graph")}


def log(*parts):
    print(*parts, file=sys.stderr, flush=True)


class Context(NamedTuple):
    """What a per-layer metric's reader reads."""

    stages: List[Dict[str, float]]  # each unprofiled window pass's stage seconds
    trace: object  # devtrace.TraceSummary of the profiled stretch, or None

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


def profiled_stretch(pkg, one_pass, device):
    """One pass under ``torch.profiler`` (host and device activity), with a
    ``record_function`` span around each stage entry of :data:`STAGE_SPANS`.
    Returns its :class:`devtrace.TraceSummary`."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from . import devtrace

    def spanned(name):
        def make(entry):
            def run(*args, **kwargs):
                with record_function(f"benchmark.{name}"):
                    return entry(*args, **kwargs)
            return run
        return make

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with slampass.Patches() as w:
        for sub, names in STAGE_SPANS.items():
            for name in names:
                w.wrap(importlib.import_module(f"{pkg.__name__}.{sub}"), name, spanned(name))
        pkg.pipeline._sync(device)
        t0 = time.perf_counter()
        with profile(activities=activities) as prof:
            with record_function(devtrace.STRETCH_SPAN):
                one_pass()
                pkg.pipeline._sync(device)
        t1 = time.perf_counter()
    summary = devtrace.summarize(*devtrace.events_of(prof))
    log(f"[trace] stretch {t1 - t0:.3f} s on the host's clock, {summary.window_s:.6f} s on the profiler's; "
        f"{summary.n_device_events} device events; busy {summary.busy_s:.6f} s; reduced in "
        f"{time.perf_counter() - t1:.1f} s")
    return summary


class Summary(NamedTuple):
    """What the window keeps of a timed pass."""

    start: float
    end: float
    stages: Dict[str, float]
    pings: int
    survey: int  # index into the mix's surveys
    poses_t: object  # the estimated positions, where the pass ran the checked survey


def run_cell(plan: registry.Plan, reg: registry.Registry, seed: int, seconds: float, trace: bool,
             device, process_start: float) -> dict:
    """The run of one cell on ``device`` (the card; the CPU in the
    benchmark's own tests).  Returns the result line's fields and the
    compared numbers.

    The passes visit the mix's surveys in the order drawn from ``seed``;
    the survey of the first timed pass is the checked one: every pass of
    it in the window is held to the reference, and the last such pass's
    intermediate outputs too."""
    import torch

    from . import plainref, synthetic

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
    kept = {}  # the latest full record of the checked survey

    def one_pass(k: int) -> Summary:
        i = visit[k % len(visit)]
        r = passes[i]()
        if i == checked:
            kept["last"] = r
        return Summary(r.start, r.end, r.stages, r.pings, i, r.result.poses.t if i == checked else None)

    traffic.warm_up(one_pass, int(cfg_spec["warmup_passes"]))
    kept.clear()
    setup_s = time.perf_counter() - process_start
    window = traffic.run_window(one_pass, seconds, mix)
    log(f"[window] {len(window.passes)} passes in {window.end - window.start:.4f} s; surveys in the order "
        f"{visit} of seeds {mix['survey_seeds']}; walls "
        + " ".join(f"{p.end - p.start:.4f}" for p in window.passes))
    last = kept["last"]
    log(f"[window] checked survey (seed {mix['survey_seeds'][checked]}): ATE DR -> EST {last.result.ate_dr:.4f} "
        f"-> {last.result.ate_est:.4f} m; loop closures {last.result.n_lc_accepted}; counters "
        f"{json.dumps(last.result.counters, sort_keys=True)}")
    metrics = {}
    if trace:
        summary = profiled_stretch(pkg, lambda: one_pass(0), device)
        ctx = Context([p.stages for p in window.passes], summary)
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
    checked_out = [{"poses_t": p.poses_t.double().cpu().numpy()} for p in window.passes if p.survey == checked]
    last_out = slampass.outputs(kept.pop("last"))
    del window, one_pass, passes, last
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref_out = plainref.run(surveys[checked])
    numbers, failed = check.compare(checked_out + [last_out], last_out, ref_out, cfg_spec["check"])
    log(f"[reference] one pass in {time.perf_counter() - t_ref:.1f} s; {len(checked_out)} passes of the checked "
        f"survey compared")
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
