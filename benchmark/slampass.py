"""One whole-survey pass of the program (``diasss_tpu_torch``), and the
outputs it is judged by.

A pass is keyframes built on the device from the raw numpy survey, then
``pipeline.run_slam``, then a device synchronise."""

import time
from typing import Callable, Dict, NamedTuple

import numpy as np
import torch


def pipeline_config(cfgmod, spec: dict):
    """The package's ``PipelineConfig`` for a configuration's ``pipeline``
    entry: ``profile`` ``"default"`` is ``PipelineConfig()``, the profile the
    plain reference states."""
    if spec.get("profile") != "default" or set(spec) != {"profile"}:
        raise ValueError(f"the plain reference states the default pipeline profile alone, not {spec!r}")
    return cfgmod.PipelineConfig()


def survey_items(survey):
    """``(items, gt_rows, pings)``: the keyframe builder's per-line tuples,
    the ground-truth rows, and the survey's ping count."""
    items = [(l.img_id, l.image, l.dr_poses, l.altitudes, l.ground_ranges, l.annos) for l in survey.lines]
    return items, [l.gt_poses for l in survey.lines], sum(len(l.dr_poses) for l in survey.lines)


class Patches:
    """Replace attributes of modules for the life of a ``with`` block:
    :meth:`wrap` sets ``module.name`` to ``make(the current entry)``."""

    def __init__(self):
        self.saved: list = []

    def wrap(self, module, name: str, make: Callable):
        entry = getattr(module, name)
        self.saved.append((module, name, entry))
        setattr(module, name, make(entry))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for module, name, entry in reversed(self.saved):
            setattr(module, name, entry)
        self.saved = []


class PassRecord(NamedTuple):
    start: float
    end: float
    stages: Dict[str, float]  # "keyframes" and run_slam's timings, seconds
    pings: int
    result: object  # the pass's SlamResult


def make_pass(pkg, items, gt_rows, pings: int, cfg, device: torch.device):
    """A function that runs one pass of ``pkg`` and returns its :class:`PassRecord`."""
    def one_pass() -> PassRecord:
        start = time.perf_counter()
        frames = pkg.frame.build_keyframes_batch(items, device=device)
        pkg.pipeline._sync(device)
        stages = {"keyframes": time.perf_counter() - start}
        result = pkg.pipeline.run_slam(frames, cfg, gt_rows_list=gt_rows, run_eval2=False)
        pkg.pipeline._sync(device)
        end = time.perf_counter()
        stages.update(result.timings)
        return PassRecord(start, end, stages, pings, result)

    return one_pass


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def outputs(rec: PassRecord) -> dict:
    """What the comparison reads of a pass, on the host, in the reference's
    layout (:func:`benchmark.plainref.run`): ``poses_t`` (P, 3), and ``lc``,
    per gated line pair, ``(accepted, rel_t)`` of its keypoint pairs (the
    padding the program adds left out).  A pair whose valid rows do not
    lead its padded batch has ``None`` there, which the comparison fails."""
    lc = {}
    for key, res in rec.result.lc_results.items():
        valid = _host(res.valid).astype(bool)
        n = int(valid.sum())
        if not valid[:n].all():
            lc[key] = None
            continue
        accepted = (_host(res.quality[:n]) > 0) & np.all(np.isfinite(_host(res.variance6[:n])), axis=-1)
        lc[key] = (accepted, _host(res.rel_pose.t[:n]).astype(np.float64))
    return {"poses_t": _host(rec.result.poses.t).astype(np.float64), "lc": lc}
