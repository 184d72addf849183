"""diasss_tpu_torch — the side-scan sonar SLAM engine in PyTorch + CUDA.

A port of :mod:`diasss_tpu` (JAX) that runs on NVIDIA GPUs: plain tensor code
is PyTorch, and the TPU's Pallas kernels are rewritten by hand for Hopper
(``csrc/``).  The JAX package stays the reference each module is tested
against.  The port imports nothing of the JAX package: it keeps its own
copies of the numpy-only modules it needs (``config``, ``pairs``,
``synthetic``, ``io``, ``dumps``), and never imports ``jax``.
"""

__version__ = "0.1.0"
