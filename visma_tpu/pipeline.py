"""Full VIO pipeline: images + IMU -> trajectory (BASELINE config 2+3).

Composes image.undistort -> frontend.FeatureTracker -> filter.Msckf into a
single per-frame step. The tracker's persistent ids feed the filter's track
table directly, so the whole step (pyramid build, KLT, detection, IMU scan,
clone, triangulate, EKF update) is one jitted computation per frame.

Also exports filter outputs as vlslam packets (export_packets), closing the
loop with the reference data model: a sequence processed by this pipeline
can be written as a `dataset` file that the reference tools would ingest.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from visma_tpu.filter import FilterConfig, FilterState, Msckf
from visma_tpu.filter.msckf import _frame_step
from visma_tpu.frontend.tracker import FeatureTracker, TrackerState


@jax.tree_util.register_pytree_node_class
@dataclass(frozen=True)
class PipelineState:
    tracker: TrackerState
    filter: FilterState

    def tree_flatten(self):
        return (self.tracker, self.filter), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


class VioPipeline:
    def __init__(self, cfg: FilterConfig, levels: int = 3, cell: int = 16,
                 klt_radius: int = 5):
        self.cfg = cfg
        self.tracker = FeatureTracker(max_features=cfg.max_tracks,
                                      levels=levels, radius=klt_radius,
                                      cell=cell)
        self.msckf = Msckf(cfg)

        def step_full(state: PipelineState, image, gyro, accel, dts):
            """Per-frame step; also returns the tracker's raw (ids, xp,
            valid) observations so run() can record them (the BA builder
            consumes them; ba/from_vio.py)."""
            tr_state, ids, xp, valid = self.tracker._step_impl(
                state.tracker, image)
            frame = {"gyro": gyro, "accel": accel, "dts": dts,
                     "ids": ids, "xp": xp, "valid": valid}
            f_state = _frame_step(cfg, state.filter, frame)
            return PipelineState(tracker=tr_state, filter=f_state), \
                (ids, xp, valid)

        def step(state: PipelineState, image, gyro, accel, dts):
            return step_full(state, image, gyro, accel, dts)[0]

        self._step_fn_full = step_full
        self._step_fn = step
        self._step = jax.jit(step)
        self._run_jit = None  # built lazily; cached on the instance

    def init(self, image0, R0=None, p0=None, v0=None) -> PipelineState:
        tr = self.tracker.init(jnp.asarray(image0))
        fs = self.msckf.init(R0=R0, p0=p0, v0=v0)
        return PipelineState(tracker=tr, filter=fs)

    def step(self, state: PipelineState, image, gyro, accel, dts
             ) -> PipelineState:
        """image (H,W) f32 grayscale (undistorted); gyro/accel (S,3);
        dts (S,) with 0-padding."""
        return self._step(state, jnp.asarray(image), jnp.asarray(gyro),
                          jnp.asarray(accel), jnp.asarray(dts))

    def pose(self, state: PipelineState) -> Tuple[np.ndarray, np.ndarray]:
        return np.asarray(state.filter.R), np.asarray(state.filter.p)

    def run(self, state: PipelineState, images, gyro, accel, dts):
        """Throughput mode: scan the full per-frame step over a device-
        staged chunk of frames — ONE dispatch for the whole chunk, so
        per-frame cost is compute, not dispatch overhead (the Msckf.run
        idiom applied to the image pipeline).

        images (N,H,W) f32; gyro/accel (N,S,3); dts (N,S).
        Returns (final PipelineState, outputs) where outputs carries the
        shared per-frame record (_frame_outputs: R/p/feat_*/healthy) PLUS
        the tracker's raw per-frame observations obs_ids (N,F), obs_xp
        (N,F,2), obs_valid (N,F) — the inputs the BA refinement stage
        rebuilds a BaProblem from (visma_tpu/ba/from_vio.py).
        """
        if self._run_jit is None:
            from visma_tpu.filter.msckf import _frame_outputs

            cfg = self.cfg

            def scan_fn(s, fr):
                s2, (ids, xp, valid) = self._step_fn_full(
                    s, fr["image"], fr["gyro"], fr["accel"], fr["dts"])
                out = _frame_outputs(cfg, s2.filter)
                out.update({"obs_ids": ids, "obs_xp": xp,
                            "obs_valid": valid})
                return s2, out

            @jax.jit
            def run_jit(state, images, gyro, accel, dts):
                return jax.lax.scan(scan_fn, state,
                                    {"image": images, "gyro": gyro,
                                     "accel": accel, "dts": dts})

            self._run_jit = run_jit
        return self._run_jit(state, jnp.asarray(images), jnp.asarray(gyro),
                             jnp.asarray(accel), jnp.asarray(dts))


def export_packets(cfg: FilterConfig, outs: Dict[str, np.ndarray],
                   ts: np.ndarray):
    """Convert Msckf.run / VioPipeline.run outputs into vlslam Packets
    (gwc + features with status, pixel observation, and world point),
    reproducing the reference wire conventions (row-major 3x4 gwc; wg zero
    for a gravity-aligned world frame). Feature.xp is the track's last
    observed pixel (dataloader.cpp:166-194 pairs xp with camera-frame
    depth, so a written dataset is consumable with reference semantics)."""
    from visma_tpu.proto import Feature, FeatureStatus, Packet

    N = len(ts)
    packets = []
    R = np.asarray(outs["R"])
    p = np.asarray(outs["p"])
    for i in range(N):
        gwc = np.concatenate([R[i], p[i][:, None]], axis=1)
        feats = []
        ids = np.asarray(outs["feat_ids"][i])
        status = np.asarray(outs["feat_status"][i])
        xw = np.asarray(outs["feat_xw"][i])
        xp = np.asarray(outs["feat_xp"][i])
        for k in np.nonzero(ids >= 0)[0]:
            feats.append(Feature(id=int(ids[k]),
                                 status=FeatureStatus(int(status[k])),
                                 xp=xp[k].astype(np.float64),
                                 xw=xw[k].astype(np.float64)))
        packets.append(Packet(ts=float(ts[i]), gwc=gwc.reshape(-1),
                              features=feats, wg=np.zeros(2)))
    return packets
