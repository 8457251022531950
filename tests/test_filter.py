"""MSCKF filter tests: IMU dead-reckoning, track ingest lifecycle, and the
end-to-end trajectory-recovery milestone (SURVEY.md §4: the filter must
recover the synthetic generating trajectory)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from visma_tpu.filter import FilterConfig, Msckf, init_state
from visma_tpu.filter.feed import pack_frames
from visma_tpu.filter.imu import propagate
from visma_tpu.filter.state import TrackTable
from visma_tpu.filter.msckf import _ingest
from visma_tpu.io.synthetic import SyntheticConfig, make_dataset, make_imu, \
    make_trajectory
from visma_tpu.proto import FeatureStatus


def ate_rmse(p_est, p_gt):
    return float(np.sqrt(np.mean(np.sum((p_est - p_gt) ** 2, axis=1))))


class TestImuPropagation:
    def test_static_gravity_cancel(self):
        """Stationary IMU measuring exactly +g stays put."""
        cfg = FilterConfig()
        s = init_state(cfg)
        S = 50
        gyro = jnp.zeros((S, 3))
        accel = jnp.tile(jnp.array([0.0, 0.0, cfg.gravity]), (S, 1))
        dts = jnp.full(S, 0.005)
        out = propagate(cfg, s, gyro, accel, dts)
        np.testing.assert_allclose(np.asarray(out.p), 0.0, atol=1e-5)
        np.testing.assert_allclose(np.asarray(out.v), 0.0, atol=1e-5)
        # covariance must grow and stay symmetric PSD
        P = np.asarray(out.P)
        np.testing.assert_allclose(P, P.T, atol=1e-8)
        assert P[6, 6] > np.asarray(s.P)[6, 6]

    def test_masked_samples_noop(self):
        cfg = FilterConfig()
        s = init_state(cfg)
        gyro = jnp.ones((4, 3)) * 99.0   # garbage in masked slots
        accel = jnp.ones((4, 3)) * 99.0
        dts = jnp.zeros(4)
        out = propagate(cfg, s, gyro, accel, dts)
        np.testing.assert_allclose(np.asarray(out.p), np.asarray(s.p))
        np.testing.assert_allclose(np.asarray(out.R), np.asarray(s.R))

    def test_matches_per_sample_reference(self):
        """The hoisted-conjugation propagate must match the per-sample
        reference implementation (_step) on both state and covariance."""
        from visma_tpu.filter.imu import _step

        cfg = FilterConfig(window=6)
        rng = np.random.default_rng(8)
        s = init_state(cfg, R0=np.eye(3), p0=rng.normal(size=3),
                       v0=rng.normal(size=3))
        # populate off-diagonal covariance so the clone coupling matters
        A = rng.normal(size=(cfg.dim, cfg.dim)).astype(np.float32) * 0.01
        P = np.asarray(s.P) + A @ A.T
        s = s.replace(P=jnp.asarray(P))
        S = 8
        gyro = jnp.asarray(rng.normal(size=(S, 3)) * 0.3, jnp.float32)
        accel = jnp.asarray(rng.normal(size=(S, 3)) * 2.0 +
                            np.array([0, 0, 9.81]), jnp.float32)
        dts = jnp.asarray(np.r_[np.full(6, 0.005), 0.0, 0.0], jnp.float32)

        fast = propagate(cfg, s, gyro, accel, dts)
        ref = s
        for k in range(S):
            ref = _step(cfg, ref, gyro[k], accel[k], dts[k])
        np.testing.assert_allclose(np.asarray(fast.R), np.asarray(ref.R),
                                   atol=1e-6)
        np.testing.assert_allclose(np.asarray(fast.p), np.asarray(ref.p),
                                   atol=1e-6)
        np.testing.assert_allclose(np.asarray(fast.v), np.asarray(ref.v),
                                   atol=1e-6)
        np.testing.assert_allclose(np.asarray(fast.P), np.asarray(ref.P),
                                   atol=1e-6, rtol=1e-4)

    def test_dead_reckoning_tracks_truth(self):
        """Pure IMU integration follows the synthetic trajectory briefly."""
        cfg = FilterConfig()
        syn = SyntheticConfig(num_frames=30)
        imu = make_imu(syn)
        s = init_state(cfg, R0=imu["R"][0], p0=imu["pos"][0], v0=imu["v0"])
        n = min(180, len(imu["ts"]))
        dt = float(np.diff(imu["ts_state"])[0])
        out = propagate(cfg, s, jnp.asarray(imu["gyro"][:n], jnp.float32),
                        jnp.asarray(imu["accel"][:n], jnp.float32),
                        jnp.full(n, dt, jnp.float32))
        err = np.linalg.norm(np.asarray(out.p) - imu["pos"][n])
        assert err < 2e-3, err  # f32 accumulation only


class TestIngest:
    def test_lifecycle(self):
        cfg = FilterConfig(window=4, max_tracks=8)
        tr = TrackTable.empty(8, 4)
        ids = jnp.array([10, 11, -1, -1, -1, -1, -1, -1], jnp.int32)
        xp = jnp.zeros((8, 2), jnp.float32).at[0].set(jnp.array([5.0, 6.0]))
        valid = jnp.array([True, True] + [False] * 6)

        tr, lost = _ingest(cfg, tr, ids, xp, valid)
        live = np.asarray(tr.ids) >= 0
        assert live.sum() == 2
        st = np.asarray(tr.status)[live]
        assert (st == int(FeatureStatus.INITIALIZING)).all()
        assert not np.asarray(lost).any()

        # second frame: same ids -> READY
        tr, lost = _ingest(cfg, tr, ids, xp, valid)
        st = np.asarray(tr.status)[np.asarray(tr.ids) >= 0]
        assert (st == int(FeatureStatus.READY)).all()

        # third frame: only id 10 -> 11 lost with 2 obs < min_track_obs:
        # dropped WITHOUT absorption = REJECT (immature loss); 10 keeps
        # tracking but has no absorbed world point yet, so it stays READY
        # (INSTATE requires xw — the GrabPointCloud contract)
        valid2 = jnp.array([True] + [False] * 7)
        tr, lost = _ingest(cfg, tr, ids, xp, valid2)
        ids_np = np.asarray(tr.ids)
        assert int(np.asarray(lost)[ids_np == 11][0]) == 1
        assert np.asarray(tr.status)[ids_np == 11][0] == int(FeatureStatus.REJECT)
        assert np.asarray(tr.status)[ids_np == 10][0] == int(FeatureStatus.READY)

        # a mature lost track (nobs >= min_track_obs) is GOODDROP
        valid3 = jnp.array([False] * 8)
        tr, lost = _ingest(cfg, tr, ids, xp, valid3)
        ids_np = np.asarray(tr.ids)
        assert np.asarray(tr.status)[ids_np == 10][0] == int(FeatureStatus.GOODDROP)

        # an absorbed continuing track is INSTATE: plant xw and re-observe
        tr = TrackTable(ids=tr.ids, status=tr.status, obs=tr.obs,
                        mask=tr.mask,
                        xw=tr.xw.at[np.nonzero(ids_np == 10)[0][0]].set(
                            jnp.array([1.0, 2.0, 3.0])))
        tr, lost = _ingest(cfg, tr, ids, xp, valid2)
        ids_np = np.asarray(tr.ids)
        assert np.asarray(tr.status)[ids_np == 10][0] == int(FeatureStatus.INSTATE)

    def test_obs_alignment(self):
        """Newest observation sits in window slot M-1 and rolls left."""
        cfg = FilterConfig(window=3, max_tracks=4)
        tr = TrackTable.empty(4, 3)
        ids = jnp.array([7, -1, -1, -1], jnp.int32)
        valid = jnp.array([True, False, False, False])
        for k in range(3):
            xp = jnp.zeros((4, 2), jnp.float32).at[0].set(
                jnp.array([float(k), 0.0]))
            tr, _ = _ingest(cfg, tr, ids, xp, valid)
        slot = int(np.nonzero(np.asarray(tr.ids) == 7)[0][0])
        np.testing.assert_allclose(np.asarray(tr.obs)[slot, :, 0], [0, 1, 2])
        assert np.asarray(tr.mask)[slot].all()


class TestEndToEnd:
    @pytest.mark.parametrize("noise", [0.0, 0.5])
    def test_trajectory_recovery(self, noise):
        """The P3 milestone: sequence in -> trajectory out, ATE small."""
        syn = SyntheticConfig(num_frames=60, num_landmarks=120,
                              pixel_noise=noise, seed=3)
        cfg = FilterConfig(window=8, max_tracks=96, max_updates=24,
                           imu_per_frame=8,
                           fx=syn.fx, fy=syn.fy, cx=syn.cx, cy=syn.cy,
                           pixel_noise=max(noise, 0.5))
        ds = make_dataset(syn)
        imu = make_imu(syn)
        frames = pack_frames(cfg, ds, imu, max_feats=96)

        _, gwc = make_trajectory(syn)
        kf = Msckf(cfg)
        s0 = kf.init(R0=gwc[0, :, :3], p0=gwc[0, :, 3], v0=imu["v0"])
        frames = {k: jnp.asarray(v) for k, v in frames.items() if k != "ts"}
        final, outs = kf.run(s0, frames)

        p_est = np.asarray(outs["p"])
        p_gt = gwc[:, :, 3]
        ate = ate_rmse(p_est, p_gt)
        # dead-reckoning alone drifts; vision must keep it bounded
        limit = 0.01 if noise == 0.0 else 0.03
        assert ate < limit, f"ATE {ate:.4f} m (noise={noise})"
        # filter state stays finite and covariance symmetric
        P = np.asarray(final.P)
        assert np.isfinite(P).all()
        np.testing.assert_allclose(P, P.T, atol=1e-6)

    def test_run_batched_matches_single(self):
        """Serving mode: B identical streams produce the single-stream
        trajectory, batched."""
        syn = SyntheticConfig(num_frames=30, num_landmarks=100,
                              pixel_noise=0.5, seed=3)
        cfg = FilterConfig(window=6, max_tracks=64, max_updates=16,
                           fx=syn.fx, fy=syn.fy, cx=syn.cx, cy=syn.cy,
                           pixel_noise=0.5)
        ds = make_dataset(syn)
        imu = make_imu(syn)
        frames = {k: jnp.asarray(v)
                  for k, v in pack_frames(cfg, ds, imu, max_feats=64).items()
                  if k != "ts"}
        _, gwc = make_trajectory(syn)
        kf = Msckf(cfg)
        s0 = kf.init(R0=gwc[0, :, :3], p0=gwc[0, :, 3], v0=imu["v0"])
        _, single = kf.run(s0, frames)

        B = 3
        bs = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), s0)
        bf = {k: jnp.broadcast_to(v, (B,) + v.shape) for k, v in frames.items()}
        final, outs = kf.run_batched(bs, bf)
        assert outs["p"].shape == (B, syn.num_frames, 3)
        for b in range(B):
            np.testing.assert_allclose(np.asarray(outs["p"][b]),
                                       np.asarray(single["p"]), atol=1e-5)

    def test_vision_only_recovery(self):
        """IMU-less fallback (cfg.use_imu=False): the constant-velocity
        prior + vision updates recover the trajectory up to similarity
        gauge (VISMA sequences carry no raw IMU — SURVEY.md §0)."""
        from visma_tpu.align.umeyama import umeyama
        from visma_tpu.filter.imu import propagate_cv

        # fast orbit (1.2 rad/s): a straight-line CV rollout visibly
        # diverges from the curve, so vision has something to prove
        syn = SyntheticConfig(num_frames=90, num_landmarks=120,
                              pixel_noise=0.5, angular_rate=1.2, seed=5)
        cfg = FilterConfig(use_imu=False, window=8, max_tracks=96,
                           max_updates=24,
                           fx=syn.fx, fy=syn.fy, cx=syn.cx, cy=syn.cy,
                           pixel_noise=0.5,
                           cv_rot_noise=0.3, cv_vel_noise=2.0)
        ds = make_dataset(syn)
        frames_np = pack_frames(cfg, ds, None, max_feats=96)
        _, gwc = make_trajectory(syn)
        dt0 = frames_np["ts"][1] - frames_np["ts"][0]
        v0 = (gwc[1, :, 3] - gwc[0, :, 3]) / dt0

        kf = Msckf(cfg)
        s0 = kf.init(R0=gwc[0, :, :3], p0=gwc[0, :, 3], v0=v0)
        frames = {k: jnp.asarray(v) for k, v in frames_np.items()
                  if k != "ts"}
        final, outs = kf.run(s0, frames)
        p_est = np.asarray(outs["p"])
        p_gt = gwc[:, :, 3]

        # similarity-align (scale is a gauge freedom without an
        # accelerometer), then ATE
        T = np.asarray(umeyama(jnp.asarray(p_est, jnp.float32),
                               jnp.asarray(p_gt, jnp.float32),
                               with_scaling=True))
        p_al = p_est @ T[:3, :3].T + T[:3, 3]
        ate = ate_rmse(p_al, p_gt)
        assert ate < 0.08, f"sim-aligned ATE {ate:.4f} m"

        # must clearly beat the vision-free constant-velocity rollout on
        # the same gauge-free footing (similarity-aligned both): vision
        # recovers the trajectory *shape*, dead reckoning cannot
        s = kf.init(R0=gwc[0, :, :3], p0=gwc[0, :, 3], v0=v0)
        ps = []
        for i in range(len(ds.packets)):
            s = propagate_cv(cfg, s, jnp.sum(frames["dts"][i]))
            ps.append(np.asarray(s.p))
        ps = np.asarray(ps)
        Tc = np.asarray(umeyama(jnp.asarray(ps, jnp.float32),
                                jnp.asarray(p_gt, jnp.float32),
                                with_scaling=True))
        ate_cv = ate_rmse(ps @ Tc[:3, :3].T + Tc[:3, 3], p_gt)
        assert ate < ate_cv * 0.5, (ate, ate_cv)

        P = np.asarray(final.P)
        assert np.isfinite(P).all()

    def test_cv_propagation_semantics(self):
        """propagate_cv: position integrates velocity; attitude, velocity
        and biases are held; covariance grows only in rot/vel blocks."""
        from visma_tpu.filter.imu import propagate_cv
        cfg = FilterConfig(use_imu=False)
        s = init_state(cfg, v0=np.array([1.0, -2.0, 0.5]))
        out = propagate_cv(cfg, s, jnp.float32(0.1))
        np.testing.assert_allclose(np.asarray(out.p),
                                   np.asarray(s.v) * 0.1, atol=1e-6)
        np.testing.assert_allclose(np.asarray(out.R), np.asarray(s.R))
        np.testing.assert_allclose(np.asarray(out.v), np.asarray(s.v))
        P0, P1 = np.asarray(s.P), np.asarray(out.P)
        assert P1[0, 0] > P0[0, 0] and P1[6, 6] > P0[6, 6]
        # bias blocks frozen
        np.testing.assert_allclose(P1[9:15, 9:15], P0[9:15, 9:15],
                                   atol=1e-7)
        np.testing.assert_allclose(P1, P1.T, atol=1e-7)

    def test_vision_beats_dead_reckoning_with_bias(self):
        """With a gyro bias, vision updates must clearly beat pure IMU."""
        syn = SyntheticConfig(num_frames=60, num_landmarks=120, seed=4)
        cfg = FilterConfig(window=8, max_tracks=96, max_updates=24,
                           fx=syn.fx, fy=syn.fy, cx=syn.cx, cy=syn.cy,
                           pixel_noise=0.5)
        ds = make_dataset(syn)
        imu = make_imu(syn, gyro_bias=0.005, accel_bias=0.02)
        frames_np = pack_frames(cfg, ds, imu, max_feats=96)
        _, gwc = make_trajectory(syn)
        v0 = imu["v0"]

        kf = Msckf(cfg)
        s0 = kf.init(R0=gwc[0, :, :3], p0=gwc[0, :, 3], v0=v0)
        frames = {k: jnp.asarray(v) for k, v in frames_np.items() if k != "ts"}
        _, outs = kf.run(s0, frames)
        ate_f = ate_rmse(np.asarray(outs["p"]), gwc[:, :, 3])

        # dead reckoning with the same biased IMU
        from visma_tpu.filter import init_state as mk
        s = mk(cfg, R0=gwc[0, :, :3], p0=gwc[0, :, 3], v0=v0)
        ps = []
        for i in range(len(ds.packets)):
            s = propagate(cfg, s, frames["gyro"][i], frames["accel"][i],
                          frames["dts"][i])
            ps.append(np.asarray(s.p))
        ate_dr = ate_rmse(np.asarray(ps), gwc[:, :, 3])
        assert ate_f < ate_dr * 0.5, (ate_f, ate_dr)
        assert ate_f < 0.1, ate_f


class TestHealthGate:
    """Jitted finite-check + structured divergence abort (SURVEY §5
    sanitizer row)."""

    def _run(self, poison_frame=None):
        from visma_tpu.io.synthetic import (SyntheticConfig, make_dataset,
                                            make_imu)
        from visma_tpu.filter.feed import pack_frames

        syn = SyntheticConfig(num_frames=12)
        cfg = FilterConfig(window=6, max_tracks=32, max_updates=8,
                           fx=syn.fx, fy=syn.fy, cx=syn.cx, cy=syn.cy)
        ds = make_dataset(syn)
        imu = make_imu(syn)
        frames = {k: np.asarray(v)
                  for k, v in pack_frames(cfg, ds, imu, max_feats=32).items()
                  if k != "ts"}
        if poison_frame is not None:
            frames["accel"][poison_frame] = np.nan
        kf = Msckf(cfg)
        s0 = kf.init(v0=imu["v0"])
        frames = {k: jnp.asarray(v) for k, v in frames.items()}
        return kf.run(s0, frames)

    def test_healthy_run_passes(self):
        from visma_tpu.filter.msckf import check_health

        _, outs = self._run()
        assert np.asarray(outs["healthy"]).all()
        check_health(outs)  # no raise

    def test_divergence_aborts_with_frame_index(self):
        from visma_tpu.filter.msckf import check_health
        from visma_tpu.utils.misc import DivergenceError

        _, outs = self._run(poison_frame=5)
        healthy = np.asarray(outs["healthy"])
        assert not healthy[5:].any()
        assert healthy[:5].all()
        with pytest.raises(DivergenceError) as ei:
            check_health(outs)
        assert ei.value.frame == 5


class TestNullspaceProjection:
    def test_householder_matches_qr_oracle(self):
        """The 3-reflection nullspace projection must span the same
        subspace as QR(complete)+N^T: the basis-invariant products
        Hp^T Hp, Hp^T rp, rp^T rp must match, and masked (zero) rows must
        stay exact zeros."""
        import jax.numpy as jnp

        from visma_tpu.filter.update import nullspace_project

        def oracle(r, Hx, Hf):
            Q, _ = jnp.linalg.qr(Hf, mode="complete")
            N = Q[:, 3:]
            return N.T @ r, N.T @ Hx

        rng = np.random.default_rng(4)
        M, D = 8, 63
        for trial in range(4):
            mask = rng.random(M) < (0.99 if trial < 2 else 0.5)
            mask2 = np.repeat(mask, 2)
            r = (rng.standard_normal(2 * M) * mask2).astype(np.float32)
            Hx = (rng.standard_normal((2 * M, D))
                  * mask2[:, None]).astype(np.float32)
            Hf = (rng.standard_normal((2 * M, 3))
                  * mask2[:, None]).astype(np.float32)
            rp, Hp = nullspace_project(jnp.asarray(r), jnp.asarray(Hx),
                                       jnp.asarray(Hf))
            ro, Ho = oracle(jnp.asarray(r), jnp.asarray(Hx),
                            jnp.asarray(Hf))
            rp, Hp, ro, Ho = map(np.asarray, (rp, Hp, ro, Ho))
            np.testing.assert_allclose(Hp.T @ Hp, Ho.T @ Ho,
                                       rtol=2e-3, atol=2e-3)
            np.testing.assert_allclose(Hp.T @ rp, Ho.T @ ro,
                                       rtol=2e-3, atol=2e-3)
            np.testing.assert_allclose(rp @ rp, ro @ ro, rtol=1e-4)
            # the projected rows annihilate Hf
            np.testing.assert_allclose(Hp @ np.zeros(D) + 0.0, 0.0)

    def test_zero_feature_stays_zero(self):
        import jax.numpy as jnp

        from visma_tpu.filter.update import nullspace_project

        M, D = 8, 63
        rp, Hp = nullspace_project(jnp.zeros(2 * M),
                                   jnp.zeros((2 * M, D)),
                                   jnp.zeros((2 * M, 3)))
        assert np.all(np.asarray(rp) == 0.0)
        assert np.all(np.asarray(Hp) == 0.0)
