"""Device image-op kernel library (filters, warps, resampling, color)."""

from pano360.ops.filters import (  # noqa: F401
    gaussian_kernel1d, auto_ksize, feature_ksize, gaussian_blur,
    sobel, harris_response, max_pool3x3, pyr_down, pyr_up, box_filter,
)
from pano360.ops.warp import (  # noqa: F401
    remap_bilinear, warp_perspective, reflect_index,
)
from pano360.ops.resize import resize_bilinear, shrink_area  # noqa: F401
from pano360.ops.color import bgr2gray, add_alpha  # noqa: F401
