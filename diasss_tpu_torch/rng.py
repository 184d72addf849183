"""Random draws of the pipeline, behind a small protocol.

The JAX package draws from ``jax.random`` in two places: the SCC hypothesis
samples (``diasss_tpu/matching/scc.py:62``) and the pose-graph initial-value
noise (``diasss_tpu/solvers/pose_graph.py:664``).  Torch cannot reproduce those
streams, so the port takes both from an object implementing :class:`Rng`;
tests pass an adapter that makes the JAX package's own calls.
"""

from __future__ import annotations

from typing import Protocol

import torch


class Rng(Protocol):
    def categorical_matched(self, matched_mask: torch.Tensor, n_hyp: int, n_samples: int) -> torch.Tensor:
        """(..., n_hyp, n_samples) int64 indices drawn uniformly from the True
        positions of ``matched_mask`` (..., K); arbitrary in-range values
        where a row has no True position."""

    def normal(self, shape) -> torch.Tensor:
        """Standard-normal float32 tensor of ``shape``."""


class TorchRng:
    """Default :class:`Rng`: two ``torch.Generator`` streams on ``device``,
    seeded from ``MatcherConfig.rng_seed`` (SCC) and ``PoseGraphConfig.seed``
    (initial noise)."""

    def __init__(self, matcher_seed: int, noise_seed: int, device="cuda"):
        self.device = torch.device(device)
        self._scc = torch.Generator(device=self.device).manual_seed(int(matcher_seed))
        self._noise = torch.Generator(device=self.device).manual_seed(int(noise_seed))

    @classmethod
    def from_config(cls, cfg, device="cuda") -> "TorchRng":
        return cls(cfg.matcher.rng_seed, cfg.pose_graph.seed, device)

    def categorical_matched(self, matched_mask, n_hyp, n_samples):
        lead = matched_mask.shape[:-1]
        K = matched_mask.shape[-1]
        counts = matched_mask.sum(-1, keepdim=True)  # (..., 1)
        u = torch.rand((*lead, n_hyp * n_samples), generator=self._scc, device=self.device)
        rank = torch.clamp(torch.floor(u * counts).to(torch.int64), max=torch.clamp(counts - 1, min=0))
        # index of the (rank+1)-th True position
        csum = torch.cumsum(matched_mask.to(torch.int64), dim=-1).contiguous()
        idx = torch.searchsorted(csum, (rank + 1).contiguous())
        return torch.clamp(idx, max=K - 1).reshape(*lead, n_hyp, n_samples)

    def normal(self, shape):
        return torch.randn(tuple(shape), generator=self._noise, device=self.device)
