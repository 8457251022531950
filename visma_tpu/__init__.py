"""visma_tpu — a TPU-native visual-inertial semantic SLAM framework.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the
feixh/VISMA reference suite (dataset ingest, undistortion, rendering,
alignment/evaluation) plus the upstream visual-inertial pipeline the VISMA
data model presumes (feature frontend, MSCKF filter, sliding-window BA),
designed for TPU meshes.

Layer map (mirrors reference layers L0..L6, see SURVEY.md):
  proto/     L0  vlslam wire-format data model
  geom/      L1  SO(3)/SE(3), rodrigues + analytic Jacobians
  io/        L2  dataset loaders, mesh/json/binary I/O
  image/     L2+ undistortion and edge kernels (Pallas)
  render/    L3  batched depth/mask/edge rasterizer (no OpenGL)
  frontend/  new feature detection + tracking
  filter/    new MSCKF visual-inertial filter
  ba/        new sliding-window bundle adjustment + pose graph
  dist/      new mesh/collective layer (collective-aware sharded BA)
  align/     L4  ICP / Umeyama / scene registration
  eval/      L4  surface & pose error metrics, result assembly
  cli/       L5  command-line tools mirroring reference examples
  utils/     aux timers, config, logging
"""

__version__ = "0.1.0"
