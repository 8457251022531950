"""Stage-split timing of the flagship 500x960 pipeline on the GPU.

Times each sub-stage as a lax.scan over the full device-staged frame chunk
(one dispatch per stage), materializing outputs via np.asarray. Prints one line per stage so the frontend/filter budget is
visible before optimizing anything.
"""
import os
import sys
import time

os.environ.setdefault("JAX_COMPILATION_CACHE_DIR",
                      os.path.join(os.path.dirname(__file__), "..",
                                   ".jax_cache"))

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from visma_tpu.filter import FilterConfig
from visma_tpu.filter.msckf import _frame_step
from visma_tpu.frontend.detect import detect_features
from visma_tpu.frontend.klt import track_features, track_features_gather
from visma_tpu.frontend.pyramid import build_pyramid
from visma_tpu.io.synthetic import SyntheticConfig, make_imu
from visma_tpu.io.synthetic_images import render_blob_frames
from visma_tpu.pipeline import VioPipeline

N_FRAMES = 240
LEVELS = 4
CELL = 32


def timed(name, fn, *args, reps=4):
    fn_j = jax.jit(fn)
    out = fn_j(*args)
    jax.block_until_ready(out)
    ts = []
    for _ in range(reps):
        t = time.time()
        # materialize EVERY leaf: materializing only leaf[0] would
        # under-time stages with multiple outputs
        for x in jax.tree_util.tree_leaves(fn_j(*args)):
            np.asarray(x)
        ts.append(time.time() - t)
    ms = min(ts) / (N_FRAMES - 1) * 1e3
    print(f"{name:34s} {ms:7.3f} ms/frame   reps={[round(x,3) for x in ts]}")
    return ms


def main():
    print(f"backend: {jax.default_backend()} devices: {jax.devices()}")
    syn = SyntheticConfig(num_frames=N_FRAMES, num_landmarks=240,
                          rows=500, cols=960,
                          fx=486.405, fy=535.401, cx=469.199, cy=257.916,
                          seed=7)
    cfg = FilterConfig(window=8, max_tracks=96, max_updates=24,
                       fx=syn.fx, fy=syn.fy, cx=syn.cx, cy=syn.cy,
                       pixel_noise=1.0)
    t0 = time.time()
    frames, gwc, X = render_blob_frames(syn)
    imu = make_imu(syn)
    spf = imu["samples_per_frame"]
    dt = float(np.diff(imu["ts_state"])[0])
    print(f"synthesized in {time.time()-t0:.1f}s")

    N = syn.num_frames - 1
    gyro = jnp.asarray(imu["gyro"][: N * spf].reshape(N, spf, 3))
    accel = jnp.asarray(imu["accel"][: N * spf].reshape(N, spf, 3))
    dts = jnp.asarray(np.full((N, spf), dt, np.float32))
    d_images = jnp.asarray(frames[1:])

    pipe = VioPipeline(cfg, levels=LEVELS, cell=CELL)
    st0 = pipe.init(jnp.asarray(frames[0]), R0=gwc[0, :, :3],
                    p0=gwc[0, :, 3], v0=imu["v0"])
    jax.block_until_ready((d_images, gyro, accel, dts, st0))

    # --- full pipeline (the headline) ---
    def full(st0, images, gyro, accel, dts):
        def f(s, fr):
            s2 = pipe._step_fn(s, fr["image"], fr["gyro"], fr["accel"],
                               fr["dts"])
            return s2, s2.filter.p
        return jax.lax.scan(f, st0, {"image": images, "gyro": gyro,
                                     "accel": accel, "dts": dts})[1]
    timed("full pipeline", full, st0, d_images, gyro, accel, dts)

    # --- pyramid only ---
    def pyr_only(images):
        def f(c, img):
            pyr = build_pyramid(img, LEVELS)
            return c + pyr[-1].sum(), ()
        return jax.lax.scan(f, 0.0, images)[0]
    timed("pyramid only", pyr_only, d_images)

    # --- pyramid + detect (incl occupied-mask replenishment shape) ---
    def pyr_detect(images):
        def f(c, img):
            xy, score, valid = detect_features(img, cfg.max_tracks, CELL)
            return c + xy.sum() + score.sum(), ()
        return jax.lax.scan(f, 0.0, images)[0]
    timed("detect only (incl score kernel)", pyr_detect, d_images)

    # --- pyramid + KLT (no detect) ---
    tr = pipe.tracker

    def pyr_klt(st0, images):
        def f(carry, img):
            prev_pyr, pos, valid = carry
            cur_pyr = tuple(build_pyramid(img, LEVELS))
            new_pos, ok = track_features(prev_pyr, cur_pyr, pos, valid,
                                         radius=tr.radius, levels=LEVELS)
            return (cur_pyr, new_pos, ok), new_pos
        return jax.lax.scan(
            f, (st0.tracker.pyr, st0.tracker.pos, st0.tracker.ids >= 0),
            images)[1]
    timed("pyramid + KLT (windowed)", pyr_klt, st0, d_images)

    # --- pyramid + gather LK (the per-feature dynamic-slice form) ---
    def pyr_klt_gather(st0, images):
        def f(carry, img):
            prev_pyr, pos, valid = carry
            cur_pyr = tuple(build_pyramid(img, LEVELS))
            new_pos, ok = track_features_gather(prev_pyr, cur_pyr, pos,
                                                valid, radius=tr.radius,
                                                levels=LEVELS)
            return (cur_pyr, new_pos, ok), new_pos
        return jax.lax.scan(
            f, (st0.tracker.pyr, st0.tracker.pos, st0.tracker.ids >= 0),
            images)[1]
    timed("pyramid + KLT (gather)", pyr_klt_gather, st0, d_images)

    # --- full tracker step (pyr + KLT + detect + replenish) ---
    def tracker_only(st0, images):
        def f(s, img):
            s2, ids, xp, valid = tr._step_impl(s, img)
            return s2, xp
        return jax.lax.scan(f, st0.tracker, images)[1]
    timed("tracker step (pyr+KLT+detect)", tracker_only, st0, d_images)

    # --- filter only (synthetic ids/xp per frame, realistic shapes) ---
    key = jax.random.PRNGKey(0)
    ids = jnp.tile(jnp.arange(cfg.max_tracks, dtype=jnp.int32)[None], (N, 1))
    xp = jax.random.uniform(key, (N, cfg.max_tracks, 2)) \
        * jnp.array([960.0, 500.0])
    valid = jnp.ones((N, cfg.max_tracks), bool)

    def filt_only(fs0, ids, xp, valid, gyro, accel, dts):
        def f(s, fr):
            s2 = _frame_step(cfg, s, fr)
            return s2, s2.p
        return jax.lax.scan(f, fs0, {"ids": ids, "xp": xp, "valid": valid,
                                     "gyro": gyro, "accel": accel,
                                     "dts": dts})[1]
    timed("filter step only", filt_only, st0.filter, ids, xp, valid,
          gyro, accel, dts)


if __name__ == "__main__":
    main()
