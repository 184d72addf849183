"""What the program's own spans say: seconds and counts of a span name per
pass, and the device operations launched inside a span.

A pass's spans are the records of ``diasss_tpu_torch.trace.recording()``
(each with ``name``, ``parent`` (an index, -1 for a root), ``start_ns``,
``end_ns`` on the profiler's clock and ``attrs``).  A program without that
module records none, and every reader here then returns None.

A device operation is attributed to the spans open on the host when it was
launched: its ``correlation_id()`` joins it to the host runtime call that
launched it (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...), whose start
is the launch time."""

from typing import Dict, List, Optional, Sequence, Tuple

from . import devtrace


def under(spans: Sequence, name: str, ancestor: Optional[str] = None) -> List[int]:
    """Indices of the spans named ``name`` that lie inside a span named
    ``ancestor`` (any span named ``name`` where ``ancestor`` is None)."""
    def inside(i: int) -> bool:
        while i >= 0:
            if spans[i].name == ancestor:
                return True
            i = spans[i].parent
        return False

    return [i for i, s in enumerate(spans) if s.name == name and (ancestor is None or inside(s.parent))]


def seconds_per_pass(passes: List[Sequence], name: str, ancestor: Optional[str] = None) -> Optional[float]:
    """Seconds in spans ``name`` (inside ``ancestor``) summed per pass,
    averaged over the passes; None where no pass has one."""
    per = [sum(s[i].end_ns - s[i].start_ns for i in under(s, name, ancestor)) / 1e9 for s in passes]
    return sum(per) / len(per) if any(under(s, name, ancestor) for s in passes) else None


def count_per_pass(passes: List[Sequence], name: str, ancestor: Optional[str] = None) -> Optional[float]:
    counts = [len(under(s, name, ancestor)) for s in passes]
    return sum(counts) / len(counts) if passes and any(counts) else None


def mean_seconds(passes: List[Sequence], name: str) -> Optional[float]:
    """The mean length of a span ``name`` over every pass's spans."""
    lengths = [(s[i].end_ns - s[i].start_ns) / 1e9 for s in passes for i in under(s, name)]
    return sum(lengths) / len(lengths) if lengths else None


def innermost(spans: Sequence, times: List[int]) -> List[int]:
    """For each of ``times``, the index of the innermost span of ``spans``
    (one thread's, so nested) that covers it, -1 where none does."""
    order = sorted(range(len(times)), key=times.__getitem__)
    events = [devtrace.Event(i, s.start_ns, s.end_ns) for i, s in enumerate(spans)]
    out = [-1] * len(times)
    for j, i in zip(order, devtrace._covering(events, [times[j] for j in order])):
        out[j] = -1 if i == "-" else i
    return out


def launch_times(events) -> List[int]:
    """The launch time of every device operation among ``events``
    (``_KinetoEvent``-like: ``device_type()``, ``is_user_annotation()``,
    ``correlation_id()``, ``start_ns()``): the start of the host event with
    the same correlation id.  Operations with no such host event are left
    out."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    host: Dict[int, int] = {}
    device: List[int] = []
    for e in events:
        cid = e.correlation_id()
        if not cid:
            continue
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                device.append(cid)
        else:
            host.setdefault(cid, e.start_ns())
    return [host[c] for c in device if c in host]


def launches_per_span(spans: Sequence, launches: List[int], name: str,
                      ancestor: Optional[str] = None) -> Tuple[int, int]:
    """``(operations, spans)``: the device operations launched inside the
    spans ``name`` (inside ``ancestor``), and how many such spans there are."""
    chosen = set(under(spans, name, ancestor))
    hits = 0
    for i in innermost(spans, launches):
        while i >= 0 and i not in chosen:
            i = spans[i].parent
        hits += i >= 0
    return hits, len(chosen)


# The readers of the per-layer metrics these spans give (PERF.md §3):
# ``passes`` is each unprofiled pass's spans.

def lc_jacobian_s(passes) -> Optional[float]:
    """Seconds per pass in the Jacobians of both LM solves of the LC stage."""
    return seconds_per_pass(passes, "lm.linearize", "loop_closures")


def lc_lm_iters(passes) -> Optional[float]:
    """LM iterations per pass in the LC stage, both solves."""
    return count_per_pass(passes, "lm.iteration", "loop_closures")


def pose_graph_trial_s(passes) -> Optional[float]:
    return mean_seconds(passes, "pose_graph.trial")


def pose_graph_read_wait_s(passes) -> Optional[float]:
    """Seconds per pass the host waits at the pose graph's per-trial read."""
    return seconds_per_pass(passes, "pose_graph.read")


def lc_launches_per_iter(spans, launches) -> Optional[float]:
    """Device operations launched per LM iteration of the LC stage, in a
    profiled stretch's spans."""
    ops, n = launches_per_span(spans, launches, "lm.iteration", "loop_closures")
    return ops / n if n else None
