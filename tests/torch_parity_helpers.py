"""Shared helpers of the port's parity tests (not collected by pytest).

:class:`JaxRng` is an ``diasss_tpu_torch.rng.Rng`` that makes exactly the
``jax.random`` calls of the JAX package, so both packages see the same draws:

* SCC hypotheses: ``categorical(k, where(matched, 0, -inf)[None], shape=(H, S))``
  with ``k1, k2 = split(PRNGKey(MatcherConfig.rng_seed))``; every matching
  call draws direction 1 with ``k1`` and direction 2 with ``k2``
  (``diasss_tpu/matching/robust.py:120-121, 319-323``), so the adapter
  alternates the two keys;
* initial noise: ``normal(PRNGKey(PoseGraphConfig.seed), (P, 6))``
  (``diasss_tpu/pipeline.py:659-663``, ``solvers/pose_graph.py:664``).

:func:`port_cfg` rebuilds a JAX-package config as the port's config of the
same name, field by field: the parity tests hand the JAX side a JAX config
and the port a port config.
"""


from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from diasss_tpu.synthetic import make_survey

# the suite runs several pytest-xdist workers next to XLA's CPU threads
torch.set_num_threads(2)


class JaxRng:
    def __init__(self, matcher_seed: int = 1, noise_seed: int = 0):
        self._keys = jax.random.split(jax.random.PRNGKey(matcher_seed))
        self._noise_key = jax.random.PRNGKey(noise_seed)
        self.calls = 0

    def categorical_matched(self, matched_mask, n_hyp, n_samples):
        key = self._keys[self.calls % 2]
        self.calls += 1
        m = jnp.asarray(matched_mask.cpu().numpy())

        def one(mm):
            logits = jnp.where(mm, 0.0, -jnp.inf)
            return jax.random.categorical(key, logits[None, :], axis=-1, shape=(n_hyp, n_samples))

        out = jax.vmap(one)(m.reshape(-1, m.shape[-1])).reshape(m.shape[:-1] + (n_hyp, n_samples))
        return torch.as_tensor(np.array(out), dtype=torch.int64, device=matched_mask.device)

    def normal(self, shape):
        return torch.as_tensor(np.array(jax.random.normal(self._noise_key, tuple(shape))))


def port_cfg(cfg):
    """The port's config dataclass equal, field by field, to the JAX
    package's ``cfg`` (recursively)."""
    from diasss_tpu_torch import config as pc

    cls = getattr(pc, type(cfg).__name__)
    return cls(**{f.name: port_cfg(getattr(cfg, f.name)) if dataclasses.is_dataclass(getattr(cfg, f.name))
                  else getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


def small_survey(n_lines=3, n_pings=150, n_bins=256, n_landmarks=40, seed=7):
    return make_survey(n_lines=n_lines, n_pings=n_pings, n_bins=n_bins, n_landmarks=n_landmarks, seed=seed)


def frame_items(survey):
    return [(l.img_id, l.image, l.dr_poses, l.altitudes, l.ground_ranges, l.annos) for l in survey.lines]


def jax_and_port_frames(survey):
    """The JAX package's keyframes and the same state converted to the port,
    so both pipelines start from identical tensors."""
    from diasss_tpu.frame import build_keyframes_batch
    from diasss_tpu_torch.convert import to_torch

    jf = build_keyframes_batch(frame_items(survey))
    return jf, [to_torch(f, device="cpu") for f in jf]


def crop_lines(survey, crops):
    """The survey with ``crops[k]`` outermost bins cut from both sides of
    line ``k``: a survey whose lines differ in bin count, as lines logged at
    different range settings give.  The ground-range table is indexed by
    ``|col - n_bins // 2|``, so it keeps its first ``n_bins // 2 - c``
    entries; every annotation row ``(l_self, l_other, p_self, b_self,
    p_other, b_other, depth)`` loses ``c`` from the bin of a cropped line,
    and rows that fall outside a cropped line go."""
    width = {l.img_id: l.image.shape[1] - 2 * crops.get(l.img_id, 0) for l in survey.lines}

    def cut(a):
        a = a.copy()
        for c_line, c_bin in ((0, 3), (1, 5)):
            a[:, c_bin] -= np.asarray([crops.get(int(i), 0) for i in a[:, c_line]], a.dtype)
        inside = np.ones(len(a), bool)
        for c_line, c_bin in ((0, 3), (1, 5)):
            w = np.asarray([width[int(i)] for i in a[:, c_line]], np.int64)
            inside &= (a[:, c_bin] >= 0) & (a[:, c_bin] < w)
        return a[inside]

    lines = []
    for l in survey.lines:
        c = crops.get(l.img_id, 0)
        n = l.image.shape[1]
        lines.append(dataclasses.replace(l, image=l.image[:, c:n - c], ground_ranges=l.ground_ranges[:n // 2 - c],
                                         annos=cut(l.annos)))
    return dataclasses.replace(survey, lines=lines)


def c13_probe(n_lines_list=(10, 20)):
    """Both packages' two-stage run (``PipelineConfig()``, annotations) on
    the bench's annotation survey at ``n_lines`` lines of 600x512, with the
    same initial noise (:class:`JaxRng`), on the CPU: the pose-graph LM
    trials, stall count, final graph error and ATE of each, one JSON line
    per survey."""
    import json
    import time

    import diasss_tpu.pipeline as jpipe
    from diasss_tpu.config import PipelineConfig
    from diasss_tpu_torch.pipeline import run_slam
    from diasss_tpu_torch.solvers import pose_graph

    def capture(module, name, infos):
        entry = getattr(module, name)

        def wrapped(*args, **kwargs):
            out = entry(*args, **kwargs)
            infos.append(out[-1])
            return out

        setattr(module, name, wrapped)

    jax_infos, port_infos = [], []
    capture(jpipe, "solve_pose_graph", jax_infos)
    capture(pose_graph, "solve_pose_graph", port_infos)
    cfg = PipelineConfig()
    for n_lines in n_lines_list:
        survey = make_survey(n_lines=n_lines, n_pings=600, n_bins=512, n_landmarks=60)
        gt = [l.gt_poses for l in survey.lines]
        jf, tf = jax_and_port_frames(survey)
        out = {"poses": sum(len(g) for g in gt)}
        for label, run, infos in (
                ("jax", lambda: jpipe.run_slam(jf, cfg, gt_rows_list=gt, run_eval2=False), jax_infos),
                ("port", lambda: run_slam(tf, port_cfg(cfg), gt_rows_list=gt, run_eval2=False, rng=JaxRng()),
                 port_infos)):
            t0 = time.perf_counter()
            res = run()
            info = infos[-1]
            out[label] = {"trials": int(info.iterations), "stall": int(info.stall), "error0": float(info.error0),
                          "error": float(info.error), "ate_dr": res.ate_dr, "ate_est": res.ate_est,
                          "solve_capped": bool(res.solve_capped), "seconds": time.perf_counter() - t0}
        out["error_rel_gap"] = abs(out["port"]["error"] - out["jax"]["error"]) / out["jax"]["error"]
        out["ate_gap_m"] = abs(out["port"]["ate_est"] - out["jax"]["ate_est"])
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    # python tests/torch_parity_helpers.py [n_lines ...]  (from the repository root, PYTHONPATH=.)
    import sys

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(4)
    c13_probe(tuple(int(a) for a in sys.argv[1:]) or (10, 20))
