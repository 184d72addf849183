"""One whole-survey pass of the program (``diasss_tpu_torch``), with the
pipeline profile that a configuration names.

A pass is keyframes built on the device from the raw numpy survey, then
``pipeline.run_slam``, then a device synchronise."""

import inspect
import time
from typing import Dict, NamedTuple

import torch

from . import registry


def pipeline_config(cfgmod, entry: dict):
    """The program's ``PipelineConfig`` for a configuration's ``pipeline``
    entry (:func:`benchmark.registry.profile_of`): ``cfgmod.<profile>_config(**args)``,
    or, where ``cfgmod`` has no such function, its constant ``<PROFILE>``,
    which takes no arguments.  An unknown profile and arguments that the
    profile does not take raise."""
    name, args = registry.profile_of(entry)
    make = getattr(cfgmod, f"{name}_config", None)
    if callable(make):
        try:
            inspect.signature(make).bind(**args)
        except TypeError as e:
            raise ValueError(f"pipeline profile {name!r} does not take the arguments {args!r}: {e}") from None
        cfg = make(**args)
    elif hasattr(cfgmod, name.upper()):
        if args:
            raise ValueError(f"pipeline profile {name!r} is a constant and takes no arguments, not {args!r}")
        cfg = getattr(cfgmod, name.upper())
    else:
        raise ValueError(f"{cfgmod.__name__} has no pipeline profile {name!r}: no function {name}_config "
                         f"and no constant {name.upper()}")
    if not isinstance(cfg, cfgmod.PipelineConfig):
        raise ValueError(f"pipeline profile {name!r} gives a {type(cfg).__name__}, not a PipelineConfig")
    return cfg


def survey_items(survey):
    """``(items, gt_rows, pings)``: the keyframe builder's per-line tuples,
    the ground-truth rows, and the survey's ping count."""
    items = [(l.img_id, l.image, l.dr_poses, l.altitudes, l.ground_ranges, l.annos) for l in survey.lines]
    return items, [l.gt_poses for l in survey.lines], sum(len(l.dr_poses) for l in survey.lines)


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
