"""The check that nothing the benchmark ran loaded JAX or the JAX package.

Module names are compared by their top-level name (the part before the
first dot) as a whole: ``diasss_tpu_torch`` begins with ``diasss_tpu`` and
is the program, not the JAX package."""

from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "diasss_tpu"})


def forbidden_modules(names: Iterable[str]) -> List[str]:
    """The names among ``names`` whose top-level name is forbidden, sorted."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
