"""diasss_tpu_torch — the side-scan sonar SLAM engine in PyTorch + CUDA.

A port of :mod:`diasss_tpu` (JAX) that runs on NVIDIA GPUs: plain tensor code
is PyTorch, and the TPU's Pallas kernels are rewritten by hand for Hopper
(``csrc/``).  The JAX package stays the reference each module is tested
against.  The port imports the JAX package's numpy-only modules
(``diasss_tpu.config``, ``pairs``, ``synthetic``, ``io``, ``dumps``), never
``jax`` itself.
"""

__version__ = "0.1.0"
