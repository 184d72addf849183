"""Factor residuals of the SSS SLAM factor graph (Jacobians by torch.func.jacfwd)."""

from .between import between_residual, point_prior_residual, prior_residual
from .sss_point import kp_noise_sigmas, sss_point_residual, sss_point_whitened

__all__ = [
    "sss_point_residual",
    "sss_point_whitened",
    "between_residual",
    "prior_residual",
    "point_prior_residual",
    "kp_noise_sigmas",
]
