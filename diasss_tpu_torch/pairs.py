"""Keypoint-pair assembly (the port's copy of :mod:`diasss_tpu.pairs`): annotation/correspondence rows -> solver inputs.

Replaces ``Optimizer::GetKpsPairs`` (optimizer.cpp:575-639).
Runs host-side in numpy (it is I/O-adjacent bookkeeping over at most a few thousand
rows) and emits fixed-capacity padded arrays so everything downstream is
static-shape for XLA.

Output row format (``Vector7``, optimizer.cpp:625):
``(ping_s, bin_s, slant_range_s, ping_t, bin_t, slant_range_t, drap_depth)``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class KpsPairs(NamedTuple):
    pairs: np.ndarray  # (K, 7) float32, padded
    valid: np.ndarray  # (K,) bool


def _slant(alts: np.ndarray, gras: np.ndarray, ping: np.ndarray, col: np.ndarray) -> np.ndarray:
    g_idx = np.abs(col - len(gras))
    g_idx = np.clip(g_idx, 0, len(gras) - 1)  # reference reads OOB at |idx| >= G (SURVEY §7)
    return np.sqrt(alts[ping] ** 2 + gras[g_idx] ** 2)


def get_kps_pairs(
    rows: np.ndarray,
    id_t: int,
    alts_s: np.ndarray,
    gras_s: np.ndarray,
    alts_t: np.ndarray,
    gras_t: np.ndarray,
    use_anno: bool,
    nadir_threshold: int = 20,
    capacity: int | None = None,
    anno_depth_scale: float = 1e5,
) -> KpsPairs:
    """Select rows targeting frame ``id_t``, compute slant ranges, nadir-filter.

    Args:
      rows: (Ka, >=6) annotation (int) or correspondence (float) rows
            ``(id_s, id_t, ping_s, bin_s, ping_t, bin_t[, depth])``.
      use_anno: annotation rows carry a 7th depth column scaled by 1e5
            (optimizer.cpp:622); detected correspondences have depth 0.
      capacity: pad/truncate to this many pairs (defaults to next power of two).
    """
    rows = np.asarray(rows)
    if rows.size == 0:
        cap = capacity or 1
        return KpsPairs(np.zeros((cap, 7), np.float32), np.zeros(cap, bool))

    sel = rows[:, 1].astype(np.int64) == id_t
    r = rows[sel]
    ping_s = r[:, 2].astype(np.int64)
    bin_s = r[:, 3].astype(np.int64)
    ping_t = r[:, 4].astype(np.int64)
    bin_t = r[:, 5].astype(np.int64)

    # nadir gate (optimizer.cpp:602-609): |bin - G| >= threshold on both sides
    keep = (np.abs(bin_s - len(gras_s)) >= nadir_threshold) & (
        np.abs(bin_t - len(gras_t)) >= nadir_threshold
    )
    # clamp indices defensively (reference warns and reads anyway, optimizer.cpp:694)
    keep &= (ping_s >= 0) & (ping_s < len(alts_s)) & (ping_t >= 0) & (ping_t < len(alts_t))
    r = r[keep]
    ping_s, bin_s, ping_t, bin_t = ping_s[keep], bin_s[keep], ping_t[keep], bin_t[keep]

    sr_s = _slant(alts_s, gras_s, ping_s, bin_s)
    sr_t = _slant(alts_t, gras_t, ping_t, bin_t)
    depth = (
        r[:, 6].astype(np.float64) / anno_depth_scale
        if (use_anno and r.shape[1] > 6)
        else np.zeros(len(r))
    )

    out = np.stack(
        [ping_s, bin_s, sr_s, ping_t, bin_t, sr_t, depth], axis=1
    ).astype(np.float32)

    k = len(out)
    cap = capacity or max(1, int(2 ** np.ceil(np.log2(max(k, 1)))))
    if k > cap:
        out = out[:cap]
        k = cap
    padded = np.zeros((cap, 7), np.float32)
    padded[:k] = out
    valid = np.zeros(cap, bool)
    valid[:k] = True
    return KpsPairs(padded, valid)
