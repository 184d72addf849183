"""Shared helpers of the port's parity tests (not collected by pytest).

:class:`JaxRng` is an ``diasss_tpu_torch.rng.Rng`` that makes exactly the
``jax.random`` calls of the JAX package, so both packages see the same draws:

* SCC hypotheses: ``categorical(k, where(matched, 0, -inf)[None], shape=(H, S))``
  with ``k1, k2 = split(PRNGKey(MatcherConfig.rng_seed))``; every matching
  call draws direction 1 with ``k1`` and direction 2 with ``k2``
  (``diasss_tpu/matching/robust.py:120-121, 319-323``), so the adapter
  alternates the two keys;
* initial noise: ``normal(PRNGKey(PoseGraphConfig.seed), (P, 6))``
  (``diasss_tpu/pipeline.py:659-663``, ``solvers/pose_graph.py:664``).

:func:`port_cfg` rebuilds a JAX-package config as the port's config of the
same name, field by field: the parity tests hand the JAX side a JAX config
and the port a port config.
"""


from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from diasss_tpu.synthetic import make_survey

# the suite runs several pytest-xdist workers next to XLA's CPU threads
torch.set_num_threads(2)


class JaxRng:
    def __init__(self, matcher_seed: int = 1, noise_seed: int = 0):
        self._keys = jax.random.split(jax.random.PRNGKey(matcher_seed))
        self._noise_key = jax.random.PRNGKey(noise_seed)
        self.calls = 0

    def categorical_matched(self, matched_mask, n_hyp, n_samples):
        key = self._keys[self.calls % 2]
        self.calls += 1
        m = jnp.asarray(matched_mask.cpu().numpy())

        def one(mm):
            logits = jnp.where(mm, 0.0, -jnp.inf)
            return jax.random.categorical(key, logits[None, :], axis=-1, shape=(n_hyp, n_samples))

        out = jax.vmap(one)(m.reshape(-1, m.shape[-1])).reshape(m.shape[:-1] + (n_hyp, n_samples))
        return torch.as_tensor(np.array(out), dtype=torch.int64, device=matched_mask.device)

    def normal(self, shape):
        return torch.as_tensor(np.array(jax.random.normal(self._noise_key, tuple(shape))))


def port_cfg(cfg):
    """The port's config dataclass equal, field by field, to the JAX
    package's ``cfg`` (recursively)."""
    from diasss_tpu_torch import config as pc

    cls = getattr(pc, type(cfg).__name__)
    return cls(**{f.name: port_cfg(getattr(cfg, f.name)) if dataclasses.is_dataclass(getattr(cfg, f.name))
                  else getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


def small_survey(n_lines=3, n_pings=150, n_bins=256, n_landmarks=40, seed=7):
    return make_survey(n_lines=n_lines, n_pings=n_pings, n_bins=n_bins, n_landmarks=n_landmarks, seed=seed)


def frame_items(survey):
    return [(l.img_id, l.image, l.dr_poses, l.altitudes, l.ground_ranges, l.annos) for l in survey.lines]


def jax_and_port_frames(survey):
    """The JAX package's keyframes and the same state converted to the port,
    so both pipelines start from identical tensors."""
    from diasss_tpu.frame import build_keyframes_batch
    from diasss_tpu_torch.convert import to_torch

    jf = build_keyframes_batch(frame_items(survey))
    return jf, [to_torch(f, device="cpu") for f in jf]
