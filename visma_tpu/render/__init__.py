"""Batched mesh renderer: depth / mask / edge without OpenGL
(reference parity: render/renderer.{h,cpp} + shaders)."""

from visma_tpu.render.camera import Intrinsics, to_gl_depth
from visma_tpu.render.likelihood import (
    occlusion_aware_edge_score, scene_depth, score_hypotheses,
)
from visma_tpu.render.raster import (
    MultiMeshRenderer, Renderer, rasterize_depth, rasterize_depth_brute,
    rasterize_depth_multi, sort_faces_morton,
)

__all__ = [
    "Intrinsics", "to_gl_depth", "MultiMeshRenderer", "Renderer",
    "rasterize_depth", "rasterize_depth_brute", "rasterize_depth_multi",
    "sort_faces_morton", "scene_depth", "score_hypotheses",
    "occlusion_aware_edge_score",
]
