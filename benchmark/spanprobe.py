"""What the program's spans read on a cell's survey, and what recording
them costs: a measurement script beside the benchmark, not a cell.

    python3 -m benchmark.spanprobe --workload anno20.batch --seed N [--pairs 10] [--out FILE]

from the root of a checkout, on the card.  In one process, on the cell's
survey that ``--seed`` visits first, after the configuration's warm-up:

1. ``--pairs`` pairs of passes with ``diasss_tpu_torch.trace.recording()``
   off and on, in the order off, on, on, off, ...: each pass's wall, and
   from the recorded passes the span readers of :mod:`.spans` (seconds,
   counts, the solvers' attributes);
2. one more pass under ``torch.profiler`` (host and CUDA activity) and
   ``recording()``: the offset between each recorded span and its own
   ``record_function`` event, the device operations launched per LM
   iteration of the LC stage, the mirrors of the program's spans on the
   device's timeline, and the idle gaps by the program span open at their
   middle (:func:`.devtrace.summarize`).

Prints one JSON line; ``--out`` also writes it to a file."""

import argparse
import contextlib
import json
import statistics
import sys
import time
from pathlib import Path

from . import devtrace, harness, registry, slampass, spans, synthetic, traffic


def quartile_spread(values):
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def stage_readings(passes, records):
    """The span readers over the recorded passes, beside the stages' clocks."""
    pg = [s for r in records for s in r if s.name == "pose_graph.solve"]
    lc = [s for r in records for s in r if s.name == "loop_closures"]
    n = len(records)
    out = {
        "lc.jacobian_s": spans.lc_jacobian_s(records),
        "lc.lm_iters": spans.lc_lm_iters(records),
        "pose_graph.trial_s": spans.pose_graph_trial_s(records),
        "pose_graph.read_wait_s": spans.pose_graph_read_wait_s(records),
        "lc.stage_s": sum(p.stages.get("loop_closures", 0.0) + p.stages.get("lc_gate", 0.0) for p in passes) / n,
        "pose_graph.stage_s": sum(p.stages.get("pose_graph", 0.0) for p in passes) / n,
        "pose_graph.build_s": spans.seconds_per_pass(records, "pose_graph.build"),
        "trials": [s.attrs.get("trials") for s in pg],
        "cg_iters": [s.attrs.get("cg_iters") for s in pg],
        "lm_iters_active": [s.attrs.get("lm_iters_active") for s in lc],
        "unfrozen": [s.attrs.get("unfrozen") for s in lc],
        "lc_batch": [s.attrs.get("batch") for s in lc],
        "spans_per_pass": sum(len(r) for r in records) / n,
    }
    for name, ancestor in (("lc.mini_solve", None), ("lc.triangulate", None),
                           ("lm.linearize", "lc.mini_solve"), ("lm.step", "lc.mini_solve"),
                           ("lm.linearize", "lc.triangulate"), ("lm.step", "lc.triangulate"),
                           ("pose_graph.linearize", None), ("pose_graph.step", None), ("pose_graph.read", None)):
        out[f"{name} in {ancestor}" if ancestor else name] = spans.seconds_per_pass(records, name, ancestor)
    return out


def clock_offsets(records, raw):
    """Per recorded span, its start minus its ``record_function`` event's
    start, and that event's end minus its end (ns): the k-th record of a
    name against the k-th host annotation of that name."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    marks = {}
    for e in raw:
        if e.is_user_annotation() and e.device_type() != cuda:
            marks.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    starts, ends, unmatched = [], [], 0
    by_name = {}
    for s in records:
        by_name.setdefault(s.name, []).append(s)
    for name, recs in by_name.items():
        found = sorted(marks.get(name, []))
        if len(found) != len(recs):
            unmatched += len(recs)
            continue
        for s, (e0, e1) in zip(recs, found):
            starts.append(s.start_ns - e0)
            ends.append(e1 - s.end_ns)
    if not starts:
        return {"matched": 0, "unmatched": unmatched}
    skew = [(a - b) / 2 for a, b in zip(starts, ends)]
    return {"matched": len(starts), "unmatched": unmatched,
            "start_median_us": statistics.median(starts) / 1e3, "start_max_abs_us": max(map(abs, starts)) / 1e3,
            "end_median_us": statistics.median(ends) / 1e3, "end_max_abs_us": max(map(abs, ends)) / 1e3,
            "skew_median_us": statistics.median(skew) / 1e3, "skew_max_abs_us": max(map(abs, skew)) / 1e3}


def mirrors(records, raw):
    """The device-side events named after a program span: how many, their
    activity types (where this torch names them), and whether the
    harness's exclusion (``is_user_annotation()``) catches every one."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    names = {s.name for s in records}
    found = [e for e in raw if e.device_type() == cuda and e.name() in names]
    types = {e.activity_type() for e in found} if found and hasattr(found[0], "activity_type") else set()
    return {"n": len(found), "types": sorted(types), "all_user_annotation": all(e.is_user_annotation() for e in found)}


def lc_idle(records, lo, hi, device_events):
    """Idle seconds inside the LC stage, by the innermost program span at
    each gap's middle."""
    _, gaps = devtrace.union_seconds([(e.start_ns, e.end_ns) for e in device_events], lo, hi)
    mids = [(a + b) // 2 for a, b in gaps]
    lc = spans.under(records, "loop_closures")
    inside = set()
    for i in range(len(records)):
        j = i
        while j >= 0 and j not in lc:
            j = records[j].parent
        if j >= 0:
            inside.add(i)
    out = {}
    for (a, b), i in zip(gaps, spans.innermost(records, mids)):
        if i in inside:
            out[records[i].name] = out.get(records[i].name, 0.0) + (b - a) / 1e9
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def profiled(pkg, one_pass, device):
    import torch

    _, records, prof = harness.profiled_stretch(pkg, one_pass, device)
    raw = prof.profiler.kineto_results.events()
    dev_ev, host_ev, span_ev, lo, hi = devtrace.events_of(prof)
    summary = devtrace.summarize(dev_ev, host_ev, span_ev, lo, hi)
    launches = spans.launch_times(raw)
    ops_lc, n_lc = spans.launches_per_span(records, launches, "lm.iteration", "loop_closures")
    ops_pg, n_pg = spans.launches_per_span(records, launches, "pose_graph.trial")
    ops_jac, n_jac = spans.launches_per_span(records, launches, "lm.linearize", "loop_closures")
    return {
        "window_s": summary.window_s, "busy_s": summary.busy_s,
        "idle_pct": 100.0 * (1.0 - summary.busy_s / summary.window_s) if summary.window_s > 0 else None,
        "device_events": summary.n_device_events, "launches_joined": len(launches),
        "lc.launches_per_iter": spans.lc_launches_per_iter(records, launches),
        "lc_iteration_spans": n_lc, "lc_iteration_launches": ops_lc,
        "pg_launches_per_trial": ops_pg / n_pg if n_pg else None,
        "lc_launches_per_linearize": ops_jac / n_jac if n_jac else None,
        "clock": clock_offsets(records, raw), "mirrors": mirrors(records, raw),
        "idle_gaps": summary.idle_gaps, "lc_idle_by_span": lc_idle(records, lo, hi, dev_ev),
        "device_ops": summary.device_ops, "torch": torch.__version__,
    }


def span_cost_ns(trace, recorded: bool) -> float:
    """Nanoseconds of one span without ``timings``, as the program opens
    it, outside a recording or inside one (no profiler): the least of
    three loops of 100,000."""
    cost = []
    for _ in range(3):
        with (trace.recording() if recorded else contextlib.nullcontext()):
            t0 = time.perf_counter_ns()
            for _ in range(100000):
                with trace.span("lm.iteration"):
                    pass
            cost.append((time.perf_counter_ns() - t0) / 100000)
    return min(cost)


def measure(pkg, one_pass, device, pairs: int) -> dict:
    """Walls and stage seconds of ``pairs`` pairs of passes off / on (off,
    on, on, off, ...), the readings of the recorded ones, the cost of a
    span, and a profiled recorded pass."""
    walls = {"off": [], "on": []}
    stages = {"off": [], "on": []}
    recorded, on_passes = [], []
    for k in range(2 * pairs):
        side = "on" if (k % 4) in (1, 2) else "off"
        if side == "on":
            r, spans_of_pass = harness.recorded(pkg, one_pass)
            recorded.append(spans_of_pass)
            on_passes.append(r._replace(result=None))
        else:
            r = one_pass()
        walls[side].append(r.end - r.start)
        stages[side].append({k: r.stages[k] for k in ("loop_closures", "pose_graph")})
        del r
    out = {"walls": walls, "stages": stages, "median_off_s": statistics.median(walls["off"]),
           "median_on_s": statistics.median(walls["on"]),
           "spread_off": quartile_spread(walls["off"]) if pairs >= 2 else None,
           "spread_on": quartile_spread(walls["on"]) if pairs >= 2 else None,
           "span_off_ns": span_cost_ns(pkg.trace, False), "span_on_ns": span_cost_ns(pkg.trace, True)}
    out["readings"] = stage_readings(on_passes, recorded)
    n = out["readings"]["spans_per_pass"]
    out["off_cost_per_pass_s"] = n * out["span_off_ns"] / 1e9
    out["on_cost_per_pass_s"] = n * out["span_on_ns"] / 1e9
    out["profiled"] = profiled(pkg, one_pass, device)
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/spanprobe.py", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        harness.log("the span probe measures on the card; torch.cuda.is_available() is False")
        return harness.NO_CARD
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    reg = registry.Registry(harness.SPEC)
    plan = reg.plan(args.workload)
    pkg = harness.program()

    mix = traffic.check_mix(plan.mix)
    surveys = [synthetic.make_survey(**plan.config["survey"], seed=int(s)) for s in mix["survey_seeds"]]
    visit = traffic.order(args.seed, len(surveys))
    cfg = slampass.pipeline_config(pkg.config, plan.config["pipeline"])
    passes = [slampass.make_pass(pkg, *slampass.survey_items(s), cfg, device) for s in surveys]
    traffic.warm_up(lambda k: passes[visit[k % len(visit)]](), int(plan.config["warmup_passes"]))
    out = {"card": harness.card_line(), "workload": args.workload, "seed": args.seed,
           "survey_seed": mix["survey_seeds"][visit[0]]}
    out.update(measure(pkg, passes[visit[0]], device, args.pairs))
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
