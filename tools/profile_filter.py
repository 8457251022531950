"""On-device sub-stage profile of the MSCKF frame step (bench config:
window=8, max_tracks=96, max_updates=24, IMU on).

Each variant runs as ONE dispatch containing a
512-iteration lax.scan whose carry is the filter state itself (every
iteration's input depends on the previous output, so nothing hoists), and
the scalar summary of the final state is materialized with np.asarray.
Cumulative prefixes of the step are timed; successive differences are the
per-stage costs.

Usage: timeout 1500 python tools/profile_filter.py
"""
import os

os.environ.setdefault("JAX_COMPILATION_CACHE_DIR",
                      os.path.join(os.path.dirname(__file__), "..",
                                   ".jax_cache"))
import time

import jax
import jax.numpy as jnp
import numpy as np

from visma_tpu.filter import FilterConfig, Msckf
from visma_tpu.filter.msckf import (_augment, _frame_step, _ingest,
                                    _select_for_update)
from visma_tpu.filter.imu import propagate
from visma_tpu.filter.triangulate import triangulate
from visma_tpu.filter.update import (chi2_gate, feature_jacobians,
                                     msckf_update, nullspace_project)


def make_frame(cfg, rng, ids_base=0):
    S = cfg.imu_per_frame
    K = cfg.max_tracks
    return {
        "gyro": jnp.asarray(rng.standard_normal((S, 3)) * 0.02, jnp.float32),
        "accel": jnp.asarray([0.0, 0.0, 9.81], jnp.float32)
        + jnp.asarray(rng.standard_normal((S, 3)) * 0.05, jnp.float32),
        "dts": jnp.full((S,), 1.0 / 30.0 / S, jnp.float32),
        "ids": jnp.asarray(ids_base + np.arange(K), jnp.int32),
        "xp": jnp.asarray(rng.uniform(50, 900, (K, 2)), jnp.float32),
        "valid": jnp.asarray(rng.random(K) < 0.9),
    }


def variants(cfg):
    def v_prop(s, f):
        return propagate(cfg, s, f["gyro"], f["accel"], f["dts"])

    def v_aug(s, f):
        s = v_prop(s, f)
        n = jnp.sum(f["dts"] > 0)
        idx = jnp.clip(n - 1, 0, f["gyro"].shape[0] - 1)
        omega = (f["gyro"][idx] - s.bg) * (n > 0)
        return _augment(cfg, s, omega)

    def v_ingest(s, f):
        s = v_aug(s, f)
        tracks, lost = _ingest(cfg, s.tracks, f["ids"], f["xp"], f["valid"])
        return s.replace(tracks=tracks)

    def v_tri(s, f):
        s = v_aug(s, f)
        tracks, lost = _ingest(cfg, s.tracks, f["ids"], f["xp"], f["valid"])
        s = s.replace(tracks=tracks)
        sel, sel_valid = _select_for_update(cfg, tracks, lost)
        obs, mask = tracks.obs[sel], tracks.mask[sel] & s.win_valid[None, :]
        X, ok, _ = jax.vmap(
            lambda o, m: triangulate(cfg, o, m, s.win_R, s.win_p))(obs, mask)
        # fold X into the carry so the triangulation can't be elided
        return s.replace(p=s.p + 0.0 * jnp.sum(X) * jnp.float32(1e-20))

    def v_jac(s, f):
        s = v_aug(s, f)
        tracks, lost = _ingest(cfg, s.tracks, f["ids"], f["xp"], f["valid"])
        s = s.replace(tracks=tracks)
        sel, sel_valid = _select_for_update(cfg, tracks, lost)
        obs, mask = tracks.obs[sel], tracks.mask[sel] & s.win_valid[None, :]
        X, ok, _ = jax.vmap(
            lambda o, m: triangulate(cfg, o, m, s.win_R, s.win_p))(obs, mask)
        r, Hx, Hf = jax.vmap(
            lambda x, o, m: feature_jacobians(cfg, x, o, m, s.win_R,
                                              s.win_p))(X, obs, mask)
        rp, Hp = jax.vmap(nullspace_project)(r, Hx, Hf)
        gate = jax.vmap(lambda rr, hh: chi2_gate(cfg, rr, hh, s.P))(rp, Hp)
        leak = jnp.sum(rp) + jnp.sum(Hp) + jnp.sum(gate)
        return s.replace(p=s.p + 0.0 * leak * jnp.float32(1e-20))

    def v_update(s, f):
        s = v_aug(s, f)
        tracks, lost = _ingest(cfg, s.tracks, f["ids"], f["xp"], f["valid"])
        s = s.replace(tracks=tracks)
        sel, sel_valid = _select_for_update(cfg, tracks, lost)
        obs = tracks.obs[sel]
        mask = tracks.mask[sel]
        s, used, rejected, X = msckf_update(cfg, s, obs, mask, sel_valid)
        return s

    def v_full(s, f):
        return _frame_step(cfg, s, f)

    return [("propagate", v_prop), ("+augment", v_aug),
            ("+ingest", v_ingest), ("+triangulate", v_tri),
            ("+jacobians/nullspace/gate", v_jac), ("+ekf update", v_update),
            ("full step (+bookkeeping)", v_full)]


def main():
    rng = np.random.default_rng(0)
    cfg = FilterConfig(window=8, max_tracks=96, max_updates=24,
                       fx=486.405, fy=535.401, cx=469.199, cy=257.916,
                       pixel_noise=1.0)
    kf = Msckf(cfg)
    s0 = kf.init(R0=np.eye(3), p0=np.zeros(3), v0=np.zeros(3))
    frame = make_frame(cfg, rng)
    # warm the state: a few real steps so the track table is populated
    for i in range(3):
        s0 = kf.step(s0, make_frame(cfg, rng, ids_base=0))

    n, reps = 512, 3
    results = []
    with jax.default_matmul_precision("highest"):
        for name, body in variants(cfg):
            @jax.jit
            def run(s):
                def step(c, _):
                    return body(c, frame), None
                c, _ = jax.lax.scan(step, s, None, length=n)
                return c.p, c.P.sum()
            t0 = time.time()
            np.asarray(run(s0)[1])
            compile_s = time.time() - t0
            ts = []
            for _ in range(reps):
                t0 = time.time()
                np.asarray(run(s0)[1])
                ts.append((time.time() - t0) / n * 1e3)
            results.append((name, min(ts)))
            print(f"{name:30s} {min(ts):7.3f} ms/iter  "
                  f"(compile {compile_s:.0f}s)", flush=True)

    print("\nper-stage deltas:")
    prev = 0.0
    for name, t in results[:-1]:
        print(f"  {name:30s} {t - prev:+7.3f} ms")
        prev = t


if __name__ == "__main__":
    main()
