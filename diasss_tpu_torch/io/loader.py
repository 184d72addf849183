"""Survey-folder loader (the port's copy of :mod:`diasss_tpu.io.loader`):
``Util::LoadInputData`` equivalent (util.cpp:45-213).

Reads five folders (sorted by filename, matching the reference's
``boost::filesystem`` sorted directory iteration, util.cpp:49-82):

* images:       OpenCV XML, key ``ct_img``      (N pings x M bins, float64)
* poses:        OpenCV XML, key ``auv_pose``    (N x 6 ``r p y x y z``, float64)
* altitudes:    plain text, one float per line  (N values)
* groundranges: plain text, one float per line  (M/2 values)
* annotations:  OpenCV XML, key ``anno_kps``    (K x 7 int)

The files are read by the native C++ reader (:mod:`..native`) when it
builds and loads, else by the pure-Python parsers, as the JAX package's
loader does; ``SurveyData.reader`` says which one ran, and why the native
one did not.

Also provides :func:`save_survey` to write a synthetic survey in the same
formats — the test_data equivalent for the CLI and golden tests.
"""

from __future__ import annotations

import os
from typing import List, NamedTuple

import numpy as np

from .opencv_xml import read_matrix, write_matrix


class SurveyData(NamedTuple):
    images: List[np.ndarray]
    poses: List[np.ndarray]
    altitudes: List[np.ndarray]
    ground_ranges: List[np.ndarray]
    annotations: List[np.ndarray]
    reader: str = "python"  # which reader ran: "native", or "python (...why...)"


def _sorted_files(folder: str) -> List[str]:
    return [os.path.join(folder, f) for f in sorted(os.listdir(folder))]


def _read_txt_column(path: str) -> np.ndarray:
    vals = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                vals.append(float(line.split()[0]))
    return np.asarray(vals)


def _readers(use_native: bool):
    """``(read_matrix, read_txt_column, reader)``: the native reader's
    functions when ``use_native`` and it is available, else the Python
    parsers', with the reason in ``reader``."""
    if not use_native:
        return read_matrix, _read_txt_column, "python (use_native=False)"
    from .. import native

    if native.available():
        return native.read_matrix, native.read_txt_column, "native"
    return read_matrix, _read_txt_column, f"python (native reader unavailable: {native.unavailable_reason()})"


def load_input_data(
    image_folder: str,
    pose_folder: str,
    altitude_folder: str,
    groundrange_folder: str,
    annotation_folder: str,
    use_native: bool = True,
) -> SurveyData:
    """Load a survey; the C++ native reader when it is available, else the
    pure-Python parsers (``SurveyData.reader`` says which)."""
    read_mat, read_txt, reader = _readers(use_native)
    images = [read_mat(p, "ct_img") for p in _sorted_files(image_folder)]
    poses = [read_mat(p, "auv_pose") for p in _sorted_files(pose_folder)]
    altitudes = [read_txt(p) for p in _sorted_files(altitude_folder)]
    ground_ranges = [read_txt(p) for p in _sorted_files(groundrange_folder)]
    annotations = [read_mat(p, "anno_kps") for p in _sorted_files(annotation_folder)]
    n = len(images)
    if not (len(poses) == len(altitudes) == len(ground_ranges) == len(annotations) == n):
        raise ValueError(
            "inconsistent file counts across folders: "
            f"{n} images, {len(poses)} poses, {len(altitudes)} altitudes, "
            f"{len(ground_ranges)} ground ranges, {len(annotations)} annotations"
        )
    return SurveyData(images, poses, altitudes, ground_ranges, annotations, reader)


def save_survey(survey, out_dir: str) -> dict:
    """Write a :class:`diasss_tpu_torch.synthetic.Survey` in the reference's file layout.

    Returns the folder paths dict usable as CLI arguments.
    """
    folders = {
        "image": os.path.join(out_dir, "img-xml"),
        "pose": os.path.join(out_dir, "pose-xml"),
        "altitude": os.path.join(out_dir, "altitude"),
        "groundrange": os.path.join(out_dir, "groundrange"),
        "annotation": os.path.join(out_dir, "annos-xml"),
    }
    for d in folders.values():
        os.makedirs(d, exist_ok=True)
    for line in survey.lines:
        i = line.img_id
        write_matrix(os.path.join(folders["image"], f"ssh-{170 + i}-img.xml"), "ct_img", line.image.astype(np.float64))
        write_matrix(os.path.join(folders["pose"], f"ssh-{170 + i}-pose.xml"), "auv_pose", line.dr_poses.astype(np.float64))
        with open(os.path.join(folders["altitude"], f"ssh-{170 + i}-alt.txt"), "w") as f:
            for v in line.altitudes:
                f.write(f"{v:.9f}\n")
        with open(os.path.join(folders["groundrange"], f"ssh-{170 + i}-gr.txt"), "w") as f:
            for v in line.ground_ranges:
                f.write(f"{v:.9f}\n")
        write_matrix(
            os.path.join(folders["annotation"], f"SSH-{170 + i:04d}.xml"),
            "anno_kps",
            line.annos.astype(np.int64) if line.annos.size else np.zeros((0, 7), np.int64),
        )
        # ground truth is ours alone (not part of the reference layout) — store
        # it alongside for ATE evaluation
        gt_dir = os.path.join(out_dir, "gt-poses")
        os.makedirs(gt_dir, exist_ok=True)
        np.savetxt(os.path.join(gt_dir, f"ssh-{170 + i}-gt.txt"), line.gt_poses)
    return folders
