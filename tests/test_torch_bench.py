"""The port's bench entry point (``diasss_tpu_torch.bench``) against the
repository's ``bench.py`` on the CPU.

* ``run(..., device="cpu")`` at ``tests/test_bench.py``'s toy sizes on the
  annotation, full-BA and automatic paths, one timed pass: the pass's
  stages cover its wall, and ``ate_est`` / ``ate_dr`` equal ``bench.run``'s
  on the same arguments within 1e-3 m (automatic 0.02 m, as the other
  parity tests).  The port draws through :class:`JaxRng` (its default
  ``TorchRng`` patched), so both packages see the same random numbers.  The
  automatic path runs with 500 keypoint slots on both sides (the profile's
  2000 cost the port's plain q-correlation half a minute per CPU pass).
* Both ``main()`` functions with their points and proxies stubbed to the
  same values print a last line with the same keys and the same values.
* The proxies, and the numpy normalization equal to the JAX package's bit
  for bit.
* Without CUDA, ``run()`` and ``python -m diasss_tpu_torch.bench`` fail.
"""

import dataclasses
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest
import torch

import bench
import chip_smoke
from diasss_tpu.config import PipelineConfig, automatic_config
from diasss_tpu_torch import bench as port_bench
from torch_parity_helpers import JaxRng, port_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TOY = dict(n_lines=2, n_pings=100, n_bins=256, n_passes=1, with_gt=True)
_AUTO = automatic_config()
PATHS = {
    "annotations": (dict(n_landmarks=15), None, 1e-3),
    "full_ba": (dict(n_landmarks=15, n_tie_lines=1),
                dataclasses.replace(PipelineConfig(), min_overlap=0.1, estimator="full_ba"), 1e-3),
    "automatic": (dict(n_landmarks=20, n_tie_lines=1, drift_xy=0.006, seed=7),
                  dataclasses.replace(_AUTO, detector=dataclasses.replace(_AUTO.detector, n_features=500)), 0.02),
}


class _JaxRngFromConfig:
    """Stands in for the port's ``TorchRng`` class: the same seeds, the JAX
    package's draws."""

    @staticmethod
    def from_config(cfg, device):
        return JaxRng(cfg.matcher.rng_seed, cfg.pose_graph.seed)


@pytest.fixture(scope="module")
def bench_runs():
    """``(JAX result, port result)`` of each path, run once per module."""
    done = {}

    def get(path):
        if path not in done:
            kw, cfg, _ = PATHS[path]
            with pytest.MonkeyPatch.context() as mp:
                # the JAX bench's compile cache would move the suite's own
                mp.setattr("diasss_tpu.cache.enable_compile_cache", lambda path=None: "")
                mp.setattr("diasss_tpu_torch.pipeline.TorchRng", _JaxRngFromConfig)
                ref = bench.run(cfg=cfg, **TOY, **kw)
                ours = port_bench.run(cfg=port_cfg(cfg) if cfg else None, device="cpu", **TOY, **kw)
            done[path] = ref, ours
        return done[path]

    return get


@pytest.mark.parametrize("path", sorted(PATHS))
def test_run_reports_one_pass_and_its_stages(bench_runs, path):
    _, r = bench_runs(path)
    assert r["pings_per_sec"] > 0 and r["total_pings"] == sum(
        TOY["n_pings"] for _ in range(TOY["n_lines"] + PATHS[path][0].get("n_tie_lines", 0)))
    assert len(r["walls"]) == 1 and r["walls"][0] == r["wall"]
    assert 0 < r["timings_sum_frac"] <= 1.05
    assert abs(sum(r["timings"].values()) / r["wall"] - r["timings_sum_frac"]) < 1e-12
    assert "keyframes" in r["timings"]
    if path == "automatic":
        assert "matching" in r["timings"] and "detect" in r["timings"]
    # counters stay apart from the seconds
    assert not set(r["counters"]) & set(r["timings"])
    assert r["counters"]["solver_direct_solves"] >= 1
    json.dumps({k: v for k, v in r.items() if k != "timings"})


@pytest.mark.parametrize("path", sorted(PATHS))
def test_run_ate_matches_the_jax_bench(bench_runs, path):
    ref, ours = bench_runs(path)
    tol = PATHS[path][2]
    assert np.isfinite(ours["ate_est"]) and ours["ate_est"] < ours["ate_dr"]
    assert abs(ours["ate_dr"] - ref["ate_dr"]) <= tol
    assert abs(ours["ate_est"] - ref["ate_est"]) <= tol
    assert ours["total_pings"] == ref["total_pings"]


def _stub_run(split_counters):
    """A ``run`` whose numbers follow from its arguments; the JAX package's
    result keeps its counters among the timings, the port's apart."""

    def run(n_lines=5, n_pings=600, n_bins=512, n_landmarks=60, n_passes=3, n_tie_lines=0, cfg=None,
            with_gt=False, drift_xy=0.004, seed=0, **_):
        p = (n_lines + n_tie_lines) * n_pings
        wall = 0.001 * n_landmarks + seed
        seconds = {"keyframes": 0.25 * wall, "solve": 0.5 * wall + 1e-4 * n_bins}
        kind = "two_stage" if cfg is None else cfg.estimator
        counters = {f"solver_{'direct' if kind == 'two_stage' else 'dense_seg'}_solves": 1,
                    "eval_stacked_pairs": n_lines + seed}
        out = dict(pings_per_sec=p / wall, wall=wall, walls=[wall * (1 + 0.1 * k) for k in range(n_passes)],
                   n_lc=n_landmarks, timings={**seconds, **({} if split_counters else counters)},
                   timings_sum_frac=0.75 + 1e-5 * n_bins, ate_dr=drift_xy * 1000, ate_est=0.01 * n_landmarks + seed,
                   total_pings=p)
        if split_counters:
            out["counters"] = counters
        return out

    return run


def _last_line(module, monkeypatch, split_counters):
    calls = []

    def auto_proxy(survey, pair_count, n_pings_total):
        calls.append((len(survey.lines), pair_count, n_pings_total))
        return 111.125, 42

    monkeypatch.setattr(module, "run", _stub_run(split_counters))
    monkeypatch.setattr(module, "reference_stream_proxy", lambda n_pings=3000: n_pings / 7.0)
    monkeypatch.setattr(module, "reference_auto_proxy", auto_proxy)
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        module.main()
    return json.loads(out.getvalue().strip().splitlines()[-1]), err.getvalue(), calls


def test_main_prints_the_jax_bench_keys(monkeypatch):
    monkeypatch.setattr(port_bench, "card_line", lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    ours, err, our_calls = _last_line(port_bench, monkeypatch, True)
    ref, _, ref_calls = _last_line(bench, monkeypatch, False)
    assert err.splitlines()[0] == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert set(ours) == set(ref) and len(ref) == 31
    # the chip smoke test's copy of the key set (it may not import bench.py)
    assert chip_smoke.BENCH_KEYS == frozenset(ref)
    seconds = {k: v for k, v in ref.pop("timings_auto").items() if not k.endswith(("_solves", "_pairs"))}
    assert ours.pop("timings_auto") == seconds
    assert ours == ref
    assert our_calls == ref_calls == [(4, 10, 1600)]
    assert ours["solver_3k"] == ours["solver_12k"] == "direct" and ours["vs_baseline_auto"] is not None


def test_reference_stream_proxy_positive():
    assert port_bench.reference_stream_proxy(300) > 0


def test_normalize_np_equals_the_jax_package_bit_for_bit():
    from diasss_tpu.config import NormalizeConfig as JaxNormalizeConfig
    from diasss_tpu.frame import _normalize_sss_np as jax_normalize
    from diasss_tpu.synthetic import make_survey
    from diasss_tpu_torch.config import NormalizeConfig
    from diasss_tpu_torch.frame import _normalize_sss_np

    s = make_survey(n_lines=3, n_pings=120, n_bins=256, n_landmarks=30, n_tie_lines=1, seed=3)
    raws = np.stack([l.image for l in s.lines]).astype(np.float32)
    ref = jax_normalize(raws, JaxNormalizeConfig())
    ours = _normalize_sss_np(raws, NormalizeConfig())
    assert ours.dtype == ref.dtype == np.uint8 and ours.shape == raws.shape
    assert np.array_equal(ours, ref)
    assert 0 < int(ours.max()) <= 255


def test_reference_auto_proxy_runs():
    from diasss_tpu_torch.synthetic import make_survey

    s = make_survey(n_lines=2, n_pings=120, n_bins=256, n_landmarks=30, seed=1)
    r, n = port_bench.reference_auto_proxy(s, 1, 240)
    assert (r is None and n is None) or (r > 0 and n >= 0)


def test_run_needs_cuda_unless_given_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        port_bench.run(n_lines=2, n_pings=100, n_bins=256, n_landmarks=15, n_passes=1)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        port_bench.card_line()


def test_module_exits_nonzero_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the bench would run for real")
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA_")}
    proc = subprocess.run([sys.executable, "-m", "diasss_tpu_torch.bench"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == "" and 'device="cpu"' in proc.stderr, proc.stderr[-2000:]
