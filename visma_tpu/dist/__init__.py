"""Distributed execution layer: device meshes + sharded BA.

TPU-native parallelism (SURVEY.md §2.3): XLA collectives over a
jax.sharding.Mesh — no NCCL/MPI. The flagship component is landmark-
sharded bundle adjustment: each device Schur-reduces its landmark shard
into the (6K x 6K) reduced camera system, one psum over the mesh sums the
blocks across the interconnect, the dense solve is replicated, and landmark
back-substitution stays local to each shard.
"""

from visma_tpu.dist.mesh import make_mesh, device_count
from visma_tpu.dist.pcg_ba import pcg_ba_solve
from visma_tpu.dist.sharded_ba import sharded_ba_solve, sharded_ba_step

__all__ = ["make_mesh", "device_count", "sharded_ba_solve",
           "sharded_ba_step", "pcg_ba_solve"]
