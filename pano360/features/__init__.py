"""Feature detectors/descriptors (SIFT, MSOP) and keypoint utilities."""

from pano360.features.sift import (  # noqa: F401
    SiftConfig, SiftFeatures, sift_extract,
)
