"""Host-side parallelism of the port: :func:`.prefetch.prefetch_iter` only
(the JAX package's mesh, ring and sequence-parallel modules are ROADMAP A14)."""
