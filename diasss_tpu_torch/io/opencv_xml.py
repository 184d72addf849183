"""Pure-Python reader/writer for OpenCV FileStorage XML matrices.

The reference's input files are OpenCV XML storages (util.cpp:86-128, 189-210):
SSS images under key ``ct_img`` (CV_64F), DR poses under ``auv_pose`` (CV_64F),
annotations under ``anno_kps`` (CV_32S).  This module speaks that exact format
without an OpenCV dependency (cv2 is used only in tests to cross-validate).
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

import numpy as np

_DT_TO_NP = {"d": np.float64, "f": np.float32, "i": np.int32, "s": np.int16, "u": np.uint8}
_NP_TO_DT = {
    np.dtype(np.float64): "d",
    np.dtype(np.float32): "f",
    np.dtype(np.int32): "i",
    np.dtype(np.int64): "i",  # stored as CV_32S like the reference annotations
    np.dtype(np.int16): "s",
    np.dtype(np.uint8): "u",
}


def read_matrix(path: str, key: str) -> np.ndarray:
    """Read the matrix stored under ``key`` from an OpenCV XML file."""
    root = ET.parse(path).getroot()
    node = root.find(key)
    if node is None:
        raise KeyError(f"key {key!r} not found in {path}")
    rows = int(node.findtext("rows"))
    cols = int(node.findtext("cols"))
    dt = node.findtext("dt").strip()
    if dt not in _DT_TO_NP:
        raise ValueError(f"unsupported dt {dt!r} in {path}")
    data = np.fromstring(node.findtext("data"), dtype=_DT_TO_NP[dt], sep=" ")  # noqa: NPY201
    if data.size != rows * cols:
        raise ValueError(f"matrix size mismatch in {path}: {data.size} != {rows}x{cols}")
    return data.reshape(rows, cols)


def write_matrix(path: str, key: str, mat: np.ndarray) -> None:
    """Write ``mat`` under ``key`` in OpenCV FileStorage XML format."""
    mat = np.asarray(mat)
    if mat.ndim != 2:
        raise ValueError("only 2-D matrices supported")
    dt = _NP_TO_DT[mat.dtype]
    store = mat.astype(_DT_TO_NP[dt])
    lines = []
    flat = store.reshape(-1)
    if dt in ("d", "f"):
        body = "\n".join(
            " ".join(f"{v:.17g}" for v in flat[k : k + 8]) for k in range(0, len(flat), 8)
        )
    else:
        body = "\n".join(
            " ".join(str(int(v)) for v in flat[k : k + 16]) for k in range(0, len(flat), 16)
        )
    lines.append('<?xml version="1.0"?>')
    lines.append("<opencv_storage>")
    lines.append(f'<{key} type_id="opencv-matrix">')
    lines.append(f"  <rows>{store.shape[0]}</rows>")
    lines.append(f"  <cols>{store.shape[1]}</cols>")
    lines.append(f"  <dt>{dt}</dt>")
    lines.append("  <data>")
    lines.append(body)
    lines.append(f"</data></{key}>")
    lines.append("</opencv_storage>")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
