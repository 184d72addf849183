"""Feature pipeline: pyramid, FAST detection, orientation, SIFT / ORB
descriptors, and the world-aligned geo-patch descriptors."""

from .detector import DetectedFeatures, detect_features
from .geopatch import attach_geo_patch_descriptors, attach_geo_patch_descriptors_batch, geo_patch_descriptors

__all__ = [
    "DetectedFeatures",
    "detect_features",
    "attach_geo_patch_descriptors",
    "attach_geo_patch_descriptors_batch",
    "geo_patch_descriptors",
]
