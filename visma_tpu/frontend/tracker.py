"""Track management: persistent ids over KLT tracks + replenishment.

Produces exactly the (ids, xp, valid) triple the MSCKF filter ingests
(visma_tpu/filter/msckf.py), with ids unique over the sequence.
"""
from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from visma_tpu.frontend.detect import detect_features
from visma_tpu.frontend.klt import track_features
from visma_tpu.frontend.pyramid import build_pyramid


@jax.tree_util.register_pytree_node_class
@dataclass(frozen=True)
class TrackerState:
    ids: jnp.ndarray      # (K,) int32, -1 empty
    pos: jnp.ndarray      # (K,2) float32
    age: jnp.ndarray      # (K,) int32
    next_id: jnp.ndarray  # scalar int32
    pyr: tuple            # previous frame pyramid

    def tree_flatten(self):
        return (self.ids, self.pos, self.age, self.next_id, self.pyr), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


class FeatureTracker:
    """KLT tracker with fixed capacity and grid replenishment."""

    def __init__(self, max_features: int = 64, levels: int = 3,
                 radius: int = 5, cell: int = 16):
        self.max_features = max_features
        self.levels = levels
        self.radius = radius
        self.cell = cell
        self._step = jax.jit(self._step_impl)

    def init(self, image: jnp.ndarray) -> TrackerState:
        """Initialize on the first frame: detect only."""
        pyr = tuple(build_pyramid(image, self.levels))
        xy, score, valid = detect_features(image, self.max_features,
                                           self.cell)
        K = self.max_features
        ids = jnp.where(valid, jnp.arange(K, dtype=jnp.int32), -1)
        return TrackerState(ids=ids, pos=xy,
                            age=jnp.zeros(K, jnp.int32),
                            next_id=jnp.asarray(K, jnp.int32), pyr=pyr)

    def step(self, state: TrackerState, image: jnp.ndarray):
        """Track into the new frame; returns (state, ids, xp, valid)."""
        return self._step(state, image)

    def _step_impl(self, state: TrackerState, image: jnp.ndarray):
        K = self.max_features
        cur_pyr = tuple(build_pyramid(image, self.levels))
        live = state.ids >= 0
        new_pos, ok = track_features(state.pyr, cur_pyr, state.pos, live,
                            radius=self.radius, levels=self.levels)
        ok = ok & live
        ids = jnp.where(ok, state.ids, -1)
        age = jnp.where(ok, state.age + 1, 0)

        # replenish: detect corners away from live tracks
        H, W = image.shape
        gh, gw = H // self.cell, W // self.cell
        cell_x = jnp.clip((new_pos[:, 0] / self.cell).astype(jnp.int32), 0, gw - 1)
        cell_y = jnp.clip((new_pos[:, 1] / self.cell).astype(jnp.int32), 0, gh - 1)
        occupied = jnp.zeros((gh, gw), bool).at[cell_y, cell_x].set(
            ok, mode="drop")
        det_xy, det_score, det_valid = detect_features(
            image, K, self.cell, occupied=occupied)

        # assign detections to empty slots (rank pairing)
        empty = ids < 0
        empty_rank = jnp.cumsum(empty.astype(jnp.int32)) - 1
        det_rank = jnp.cumsum(det_valid.astype(jnp.int32)) - 1
        n_det = jnp.sum(det_valid)
        take = empty & (empty_rank < n_det)

        F = det_xy.shape[0]
        feat_for_rank = jnp.zeros(F, jnp.int32).at[
            jnp.where(det_valid, det_rank, F - 1)
        ].max(jnp.arange(F, dtype=jnp.int32) * det_valid)
        src = feat_for_rank[jnp.clip(empty_rank, 0, F - 1)]

        new_id_for_slot = state.next_id + empty_rank.astype(jnp.int32)
        ids = jnp.where(take, new_id_for_slot, ids)
        pos = jnp.where(take[:, None], det_xy[src], new_pos)
        age = jnp.where(take, 0, age)
        next_id = state.next_id + jnp.sum(take)

        out_state = TrackerState(ids=ids, pos=pos, age=age, next_id=next_id,
                                 pyr=cur_pyr)
        return out_state, ids, pos, ids >= 0
