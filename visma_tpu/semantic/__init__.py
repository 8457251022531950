"""Semantic object-pose layer.

The reference repo stores this subsystem's OUTPUT (result.json of
per-timestamp object poses, consumed at evaluation.cpp:163-198) but not
the subsystem itself — the papers' semantic mapper tracked CAD-model poses
by rendering hypotheses and scoring them against image edges. This package
provides that capability on the accelerator:

* cem.py: cross-entropy-method SE(3) pose refinement over batched
  render+chamfer scoring (hundreds of hypotheses per iteration on the
  rasterizer's batch axis);
* mapper.py: per-object track management from bounding-box detections +
  result.json export compatible with the reference evaluation pipeline.
"""

from visma_tpu.semantic.cem import (refine_pose_cem,
                                    refine_pose_cem_batched)
from visma_tpu.semantic.mapper import ObjectTrack, SemanticMapper

__all__ = ["refine_pose_cem", "refine_pose_cem_batched",
           "ObjectTrack", "SemanticMapper"]
