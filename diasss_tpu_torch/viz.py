"""Headless image output: the port's own copies of the JAX package's numpy
PNG encoder (:func:`diasss_tpu.viz.write_png`) and match rendering
(:func:`diasss_tpu.viz.draw_matches_image`, :func:`diasss_tpu.viz.show_annos`)."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def write_png(path: str, rgb: np.ndarray) -> None:
    """Minimal RGB8 PNG writer."""
    rgb = np.ascontiguousarray(rgb.astype(np.uint8))
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[i].tobytes() for i in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)


def _draw_line(img: np.ndarray, p0, p1, color) -> None:
    """Integer Bresenham-ish line via dense interpolation."""
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]), 1)) * 2
    xs = np.linspace(p0[0], p1[0], n).astype(int)
    ys = np.linspace(p0[1], p1[1], n).astype(int)
    ok = (ys >= 0) & (ys < img.shape[0]) & (xs >= 0) & (xs < img.shape[1])
    img[ys[ok], xs[ok]] = color


def _draw_dot(img: np.ndarray, x: int, y: int, color, r: int = 2) -> None:
    y0, y1 = max(y - r, 0), min(y + r + 1, img.shape[0])
    x0, x1 = max(x - r, 0), min(x + r + 1, img.shape[1])
    img[y0:y1, x0:x1] = color


def draw_matches_image(
    img1: np.ndarray,
    img2: np.ndarray,
    pts1: np.ndarray,  # (M, 2) (x, y) keypoints in img1
    pts2: np.ndarray,  # (M, 2)
    path: str,
    max_matches: int = 200,
) -> None:
    """Side-by-side match rendering -> PNG (ShowAnnos equivalent, headless)."""
    h = max(img1.shape[0], img2.shape[0])
    w = img1.shape[1] + img2.shape[1]
    canvas = np.zeros((h, w, 3), np.uint8)
    canvas[: img1.shape[0], : img1.shape[1]] = img1[..., None]
    canvas[: img2.shape[0], img1.shape[1] :] = img2[..., None]
    off = img1.shape[1]
    rng = np.random.default_rng(0)
    for m in range(min(len(pts1), max_matches)):
        color = rng.integers(80, 255, 3)
        x1, y1 = int(pts1[m][0]), int(pts1[m][1])
        x2, y2 = int(pts2[m][0]) + off, int(pts2[m][1])
        _draw_dot(canvas, x1, y1, color)
        _draw_dot(canvas, x2, y2, color)
        _draw_line(canvas, (x1, y1), (x2, y2), color)
    write_png(path, canvas)


def show_annos(img_id_t: int, norm1: np.ndarray, norm2: np.ndarray, annos1: np.ndarray, path: str) -> None:
    """Annotated-match rendering, selecting rows targeting ``img_id_t``
    (util.cpp:225-251 semantics: columns (2,3)=(ping,bin) source, (4,5) target)."""
    rows = annos1[annos1[:, 1] == img_id_t]
    pts1 = rows[:, [3, 2]]  # (bin, ping) -> (x, y)
    pts2 = rows[:, [5, 4]]
    draw_matches_image(norm1, norm2, pts1, pts2, path)
