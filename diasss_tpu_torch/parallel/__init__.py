"""Host-side parallelism of the port: :mod:`.prefetch` (the overlap of host
parsing with device work; the JAX package's mesh, ring and
sequence-parallel modules are ROADMAP A14)."""
