"""Image kernels: undistortion remap + edge maps (reference parity:
src/undistorter.cpp, render/shaders/edge_detection.frag)."""

from visma_tpu.image.undistort import (
    AtanModel, RadTanModel, Undistorter, undistorter_from_file,
    CORVIS_ATAN_CALIB,
)
from visma_tpu.image.remap import bilinear_remap
from visma_tpu.image.edges import (
    depth_edge, linearize_gl_depth, soft_threshold,
    sobel_gradients, shi_tomasi_response,
)

__all__ = [
    "AtanModel", "RadTanModel", "Undistorter", "undistorter_from_file",
    "CORVIS_ATAN_CALIB",
    "bilinear_remap",
    "depth_edge", "linearize_gl_depth", "soft_threshold",
    "sobel_gradients", "shi_tomasi_response",
]
