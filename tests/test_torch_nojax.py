"""The port imports neither JAX nor the JAX package, and the chip smoke test
has no CPU path.

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
from diasss_tpu_torch.pipeline import run_slam

torch.set_num_threads(2)
survey = make_survey(n_lines=2, n_pings=120, n_bins=256, n_landmarks=30, seed=2)
frames = build_keyframes_batch(
    [(l.img_id, l.image, l.dr_poses, l.altitudes, l.ground_ranges, l.annos) for l in survey.lines],
    device="cpu")
gt = [l.gt_poses for l in survey.lines]
auto = automatic_config()
auto = dataclasses.replace(auto, detector=dataclasses.replace(auto.detector, n_features=200))
for cfg in (PipelineConfig(), PipelineConfig(detector=DetectorConfig(n_features=200),
                                             pose_graph=PoseGraphConfig(use_anno=False)), auto):
    result = run_slam(frames, cfg, gt_rows_list=gt)
    assert result.ate_est is not None
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
