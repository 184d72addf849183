"""Factor residuals of the SSS SLAM factor graph (Jacobians by torch.func.jacfwd)."""

from .between import between_residual
from .sss_point import kp_noise_sigmas, sss_point_residual

__all__ = [
    "between_residual",
    "kp_noise_sigmas",
    "sss_point_residual",
]
