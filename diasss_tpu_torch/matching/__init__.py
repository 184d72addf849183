"""Robust geo-gated descriptor matching (FEAmatcher equivalents)."""

from .robust import MatchResult, robust_matching, robust_matching_stacked

__all__ = ["MatchResult", "robust_matching", "robust_matching_stacked"]
