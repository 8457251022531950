"""Cross-stage pipeline parallelism: frontend on one device, filter on
another (SURVEY §2.3 PP row — "frontend -> filter as pipelined stages over
sequence chunks").

The sequence is cut into chunks; the FRONTEND stage (pyramid + KLT +
detection, the image-heavy half) scans a chunk on device A and emits the
tiny (ids, xp, valid) feature tables; the FILTER stage (IMU scan + EKF
update) scans them on device B. The host dispatch loop issues frontend(c+1)
before blocking on filter(c), so with two real chips JAX's async dispatch
overlaps stage A of chunk c+1 with stage B of chunk c — software pipelining
with the compiler/runtime doing the scheduling, no hand-rolled queues. The
inter-stage payload per frame is ~K*(8+status) bytes (feature table), ~5 KB
at K=96 — negligible on the interconnect.

Numerically IDENTICAL to the single-device VioPipeline.run: stage
boundaries change placement, not math (asserted in tests/test_pp.py).
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from visma_tpu.filter import FilterConfig
from visma_tpu.filter.msckf import _frame_step
from visma_tpu.frontend.tracker import FeatureTracker
from visma_tpu.utils.misc import finite_tree


class TwoStagePipeline:
    """VioPipeline split across two devices at the frontend/filter seam."""

    def __init__(self, cfg: FilterConfig, dev_frontend, dev_filter,
                 levels: int = 3, cell: int = 16, klt_radius: int = 5,
                 chunk: int = 32):
        self.cfg = cfg
        self.dev_a = dev_frontend
        self.dev_b = dev_filter
        self.chunk = chunk
        self.tracker = FeatureTracker(max_features=cfg.max_tracks,
                                      levels=levels, radius=klt_radius,
                                      cell=cell)

        tracker_step = self.tracker._step_impl

        def frontend_chunk(tr_state, images):
            """Scan the tracker over a chunk -> per-frame feature tables."""
            def body(s, image):
                s2, ids, xp, valid = tracker_step(s, image)
                return s2, {"ids": ids, "xp": xp, "valid": valid}

            return jax.lax.scan(body, tr_state, images)

        def filter_chunk(f_state, feats, gyro, accel, dts):
            def body(s, fr):
                s2 = _frame_step(cfg, s, fr)
                return s2, {"R": s2.R, "p": s2.p,
                            "healthy": finite_tree((s2.R, s2.p, s2.v,
                                                    s2.bg, s2.ba, s2.P))}

            frames = {"ids": feats["ids"], "xp": feats["xp"],
                      "valid": feats["valid"], "gyro": gyro,
                      "accel": accel, "dts": dts}
            return jax.lax.scan(body, f_state, frames)

        from jax.sharding import SingleDeviceSharding

        self._frontend = jax.jit(
            frontend_chunk, out_shardings=SingleDeviceSharding(self.dev_a))
        self._filter = jax.jit(
            filter_chunk, out_shardings=SingleDeviceSharding(self.dev_b))

    def init(self, image0, R0=None, p0=None, v0=None):
        from visma_tpu.filter import init_state

        tr = jax.device_put(self.tracker.init(jnp.asarray(image0)),
                            jax.sharding.SingleDeviceSharding(self.dev_a))
        fs = jax.device_put(init_state(self.cfg, R0=R0, p0=p0, v0=v0),
                            jax.sharding.SingleDeviceSharding(self.dev_b))
        return tr, fs

    def run(self, tr_state, f_state, images, gyro, accel, dts):
        """Chunk-pipelined run. images (N,H,W); gyro/accel (N,S,3);
        dts (N,S). Returns (tr_state, f_state, outs {R, p, healthy})."""
        from jax.sharding import SingleDeviceSharding

        sa = SingleDeviceSharding(self.dev_a)
        sb = SingleDeviceSharding(self.dev_b)
        N = images.shape[0]
        C = self.chunk
        outs = []
        feats_q = []  # in-flight frontend outputs (async)
        starts = list(range(0, N, C))

        def submit_frontend(lo):
            nonlocal tr_state
            hi = min(lo + C, N)
            imgs = jax.device_put(jnp.asarray(images[lo:hi]), sa)
            tr_state, feats = self._frontend(tr_state, imgs)
            feats_q.append((lo, hi, feats))

        # prime the pipeline: frontend(chunk 0) in flight before the
        # filter consumes anything; from then on frontend(c+1) is issued
        # before filter(c)'s result is awaited
        submit_frontend(0)
        for idx in range(len(starts)):
            if idx + 1 < len(starts):
                submit_frontend(starts[idx + 1])
            lo, hi, feats = feats_q.pop(0)
            feats_b = jax.device_put(feats, sb)
            f_state, out = self._filter(
                f_state, feats_b,
                jax.device_put(jnp.asarray(gyro[lo:hi]), sb),
                jax.device_put(jnp.asarray(accel[lo:hi]), sb),
                jax.device_put(jnp.asarray(dts[lo:hi]), sb))
            outs.append(out)

        merged = {k: jnp.concatenate([o[k] for o in outs]) for k in outs[0]}
        return tr_state, f_state, merged
