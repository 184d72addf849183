"""Solvers: batched LM, loop-closure mini-solves, chain pose graph, triangulation."""
