"""The port imports neither JAX nor the JAX package (on the annotation,
detected and automatic paths with the pose marginals and the mosaic, one
online arrival, a checkpointed solve and the diagnostics, the automatic
path and an online arrival on lines of different bin counts, the native
reader and the pipelined loader, the CLI with ``--trace``, and the match
rendering), and the chip smoke test has no CPU path.

Both run in fresh interpreters: this test process has imported jax already
(tests/conftest.py).
"""

import os
import re
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SLICE = """
import dataclasses
import sys
import torch
import diasss_tpu_torch.cli, diasss_tpu_torch.convert, diasss_tpu_torch.dumps, diasss_tpu_torch.io
import diasss_tpu_torch.features.fast_cuda, diasss_tpu_torch.matching.dense_cuda
from diasss_tpu_torch.config import DetectorConfig, PipelineConfig, PoseGraphConfig, automatic_config
from diasss_tpu_torch.synthetic import make_survey
from diasss_tpu_torch.frame import build_keyframes_batch
from diasss_tpu_torch.mosaic import build_mosaic
from diasss_tpu_torch.pipeline import _estimated_geo, run_slam

torch.set_num_threads(2)
survey = make_survey(n_lines=2, n_pings=120, n_bins=256, n_landmarks=30, seed=2)
frames = build_keyframes_batch(
    [(l.img_id, l.image, l.dr_poses, l.altitudes, l.ground_ranges, l.annos) for l in survey.lines],
    device="cpu")
gt = [l.gt_poses for l in survey.lines]
auto = automatic_config()
auto = dataclasses.replace(auto, detector=dataclasses.replace(auto.detector, n_features=200),
                           full_ba=dataclasses.replace(auto.full_ba, marginals=True))
for cfg in (PipelineConfig(pose_graph=PoseGraphConfig(marginals=True)),
            PipelineConfig(detector=DetectorConfig(n_features=200), pose_graph=PoseGraphConfig(use_anno=False)),
            auto):
    result = run_slam(frames, cfg, gt_rows_list=gt)
    assert result.ate_est is not None
    marginals = cfg.full_ba.marginals if cfg.estimator == "full_ba" else cfg.pose_graph.marginals
    assert (result.pose_sigmas is not None) == marginals
mosaic = build_mosaic(frames, geo_list=_estimated_geo(frames, result.poses))[0]

import os, tempfile
from diasss_tpu_torch.checkpoint import solve_full_ba_checkpointed
from diasss_tpu_torch.diagnostics import check_finite, determinism_report
from diasss_tpu_torch.online import OnlineSlam
from diasss_tpu_torch.pipeline import _assemble_pairs, _overlap_pairs
from diasss_tpu_torch.solvers import full_ba

slam = OnlineSlam(PipelineConfig(), window_frames=2, device="cpu")
assert check_finite(slam.add_frame(frames[0]), "online") == []
pairs = _overlap_pairs(frames, 0.1)
prob = full_ba.build_ba_problem(frames, _assemble_pairs(frames, None, pairs, auto, True)[0], pairs, auto.full_ba,
                                auto.pose_graph)
with tempfile.TemporaryDirectory() as tmp:
    poses, _, info = solve_full_ba_checkpointed(prob, auto.full_ba, auto.kp_noise, os.path.join(tmp, "ck.npz"), chunk=2)
assert determinism_report(lambda: full_ba.solve_full_ba(prob, auto.full_ba, auto.kp_noise)[0])["deterministic"]

# lines of different bin counts: line 1 cropped by 16 bins on each side
import numpy as np
items = [(l.img_id, l.image[:, 16:-16] if k == 1 else l.image, l.dr_poses, l.altitudes,
          l.ground_ranges[:112] if k == 1 else l.ground_ranges, np.zeros((0, 7), np.int64))
         for k, l in enumerate(survey.lines)]
mixed = build_keyframes_batch(items, device="cpu")
assert [int(f.raw.shape[1]) for f in mixed] == [256, 224]
assert run_slam(mixed, auto, gt_rows_list=gt).ate_est is not None
assert check_finite(OnlineSlam(auto, device="cpu").add_frame(mixed[1]), "mixed online") == []

import diasss_tpu_torch.native
from diasss_tpu_torch.cli import main as cli_main
from diasss_tpu_torch.io import save_survey
from diasss_tpu_torch.parallel.prefetch import load_keyframes_pipelined
from diasss_tpu_torch.viz import draw_matches_image, show_annos

with tempfile.TemporaryDirectory() as tmp:
    folders = save_survey(survey, tmp)
    keys = ("image", "pose", "altitude", "groundrange", "annotation")
    load = load_keyframes_pipelined(*[folders[k] for k in keys], detector_cfg=auto.detector, device="cpu")
    assert load.reader == "native" and len(load.feats) == 2
    args = [a for k in keys for a in (f"--{k}", folders[k])]
    assert cli_main(args + ["--device", "cpu", "--trace", os.path.join(tmp, "trace"), "--no-eval2"]) == 0
    assert os.path.exists(os.path.join(tmp, "trace", "trace.json"))
    img = frames[0].norm.numpy()
    show_annos(1, img, frames[1].norm.numpy(), survey.lines[0].annos, os.path.join(tmp, "annos.png"))
leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
print("JAX_MODULES", leaked)
pkg = sorted(m for m in sys.modules if m == "diasss_tpu" or m.startswith("diasss_tpu."))
print("JAX_PACKAGE_MODULES", pkg)
"""


def _run(args, cwd):
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA_")}
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_port_slice_never_imports_jax():
    proc = _run([sys.executable, "-c", SLICE], REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "JAX_MODULES []" in proc.stdout, proc.stdout[-2000:]
    assert "JAX_PACKAGE_MODULES []" in proc.stdout, proc.stdout[-2000:]


def test_no_source_line_imports_the_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+(diasss_tpu|jax)(\s|\.|$)")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "diasss_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    offenders = []
    for path in files:
        with open(path) as f:
            offenders += [f"{path}:{k}: {line.strip()}" for k, line in enumerate(f, 1) if pattern.match(line)]
    assert len(files) > 20
    assert offenders == []


def test_chip_smoke_fails_without_cuda_and_alone(tmp_path):
    import torch

    if torch.cuda.is_available():
        import pytest

        pytest.skip("a CUDA device is present: chip_smoke.py would run for real")
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    for cwd in (REPO, str(tmp_path)):
        proc = _run([sys.executable, "chip_smoke.py"], cwd)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
