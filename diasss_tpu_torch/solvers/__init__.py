"""Solvers: batched LM, loop-closure mini-solves, chain pose graph, triangulation."""

from .lm import LMResult, levenberg_marquardt

__all__ = ["LMResult", "levenberg_marquardt"]
