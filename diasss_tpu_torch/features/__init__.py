"""Feature pipeline: pyramid, FAST detection, orientation, SIFT descriptors."""

from .detector import DetectedFeatures, detect_features

__all__ = ["DetectedFeatures", "detect_features"]
