"""VIO -> BA loop: BaProblems built from real runs, and BA as a measured
trajectory-refinement stage.

The flagship claim is the vision-only configuration — the actual VISMA
distribution ships no raw IMU (SURVEY §0) — where batch BA over the whole
sequence beats the sliding-window filter decisively (sim-aligned, the
meaningful monocular metric; BA inherits the initialization's gauge).
With a good IMU the filter already sits at the vision-information optimum
and BA must at least not damage it.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from visma_tpu.align.umeyama import umeyama
from visma_tpu.ba.from_vio import (ba_problem_from_vio, refine_trajectory,
                                   select_keyframes)
from visma_tpu.ba.gauss_newton import ba_solve, total_cost
from visma_tpu.filter import FilterConfig, Msckf
from visma_tpu.filter.feed import pack_frames
from visma_tpu.io.synthetic import (SyntheticConfig, make_dataset,
                                    make_imu, make_landmarks,
                                    make_trajectory)


def _ate(p, ref):
    return float(np.sqrt(np.mean(np.sum((p - ref) ** 2, axis=1))))


def _aligned_ate(p, ref):
    T = np.asarray(umeyama(jnp.asarray(p, jnp.float32),
                           jnp.asarray(ref, jnp.float32), with_scaling=True))
    return _ate(p @ T[:3, :3].T + T[:3, 3], ref)


def _run_filter(syn, use_imu=True):
    cfg = FilterConfig(window=8, max_tracks=96, fx=syn.fx, fy=syn.fy,
                       cx=syn.cx, cy=syn.cy,
                       pixel_noise=max(syn.pixel_noise, 0.5),
                       use_imu=use_imu)
    ds = make_dataset(syn)
    imu = make_imu(syn) if use_imu else None
    _, gwc = make_trajectory(syn)
    frames = {k: jnp.asarray(v)
              for k, v in pack_frames(cfg, ds, imu, max_feats=96).items()
              if k != "ts"}
    kf = Msckf(cfg)
    v0 = (imu["v0"] if use_imu
          else (gwc[1, :, 3] - gwc[0, :, 3]) * syn.fps)
    s0 = kf.init(R0=gwc[0, :, :3], p0=gwc[0, :, 3], v0=v0)
    _, outs = kf.run(s0, frames)
    return cfg, frames, outs, gwc


def test_select_keyframes():
    kf = select_keyframes(10, 4)
    np.testing.assert_array_equal(kf, [0, 4, 8, 9])
    kf = select_keyframes(9, 4)
    np.testing.assert_array_equal(kf, [0, 4, 8])


def test_problem_construction_matches_observations():
    """The rebuilt problem carries EXACTLY the observations the filter
    ingested, and triangulation from the estimates lands near the true
    landmarks (make_dataset feature id == landmark index)."""
    syn = SyntheticConfig(num_frames=40, num_landmarks=150, pixel_noise=0.5,
                          seed=3)
    cfg, frames, outs, gwc = _run_filter(syn)
    ids = np.asarray(frames["ids"])
    xp = np.asarray(frames["xp"])
    valid = np.asarray(frames["valid"])
    prob, info = ba_problem_from_vio(
        ids, xp, valid, np.asarray(outs["R"]), np.asarray(outs["p"]),
        (cfg.fx, cfg.fy, cfg.cx, cfg.cy), stride=3)
    assert prob is not None
    kf = info["kf"]
    assert kf[0] == 0 and kf[-1] == syn.num_frames - 1
    assert prob.num_poses == len(kf)

    # every masked obs equals the corresponding feed observation
    obs = np.asarray(prob.obs)
    mask = np.asarray(prob.mask)
    checked = 0
    for l, fid in enumerate(info["ids"][:30]):
        for k, fr in enumerate(kf):
            if mask[l, k]:
                j = np.nonzero((ids[fr] == fid) & valid[fr])[0]
                assert len(j) == 1
                np.testing.assert_allclose(obs[l, k], xp[fr, j[0]],
                                           atol=1e-6)
                checked += 1
    assert checked > 50
    # masked-out rows are exact zeros (repo convention)
    assert np.all(obs[~mask] == 0.0)

    X_true = make_landmarks(syn)
    Xerr = np.linalg.norm(np.asarray(prob.X) - X_true[info["ids"]], axis=1)
    assert np.median(Xerr) < 0.06, f"triangulation err {np.median(Xerr)}"


def test_ba_improves_vision_only_filter():
    """BASELINE config 5 on the reference-realistic (no raw IMU) setup:
    batch BA over the run's own tracks must clearly beat the CV-prior
    filter (sim-aligned)."""
    syn = SyntheticConfig(num_frames=60, num_landmarks=200, pixel_noise=1.0)
    cfg, frames, outs, gwc = _run_filter(syn, use_imu=False)
    p_est = np.asarray(outs["p"])
    R_est = np.asarray(outs["R"])
    ref = gwc[:, :, 3]

    prob, info = ba_problem_from_vio(
        np.asarray(frames["ids"]), np.asarray(frames["xp"]),
        np.asarray(frames["valid"]), R_est, p_est,
        (cfg.fx, cfg.fy, cfg.cx, cfg.cy), stride=2)
    c0 = float(total_cost(prob))
    sol, hist = ba_solve(prob, iters=12)
    c1 = float(np.asarray(hist)[-1])
    assert c1 < c0, "BA did not reduce reprojection cost"

    R_ba, p_ba = refine_trajectory(sol, info, R_est, p_est)
    a_filt = _aligned_ate(p_est, ref)
    a_ba = _aligned_ate(p_ba, ref)
    assert a_ba < 0.6 * a_filt, (
        f"BA did not improve: filter {a_filt:.4f} -> BA {a_ba:.4f}")
    # rotations refined too: finite and orthonormal
    err = np.abs(np.einsum("nij,nkj->nik", R_ba, R_ba)
                 - np.eye(3)).max()
    assert err < 1e-4


def test_ba_preserves_imu_filter_accuracy():
    """With a good IMU the filter is already at the vision-information
    optimum; the BA stage must stay within a small factor of it (it cannot
    use the IMU term) and must not diverge."""
    syn = SyntheticConfig(num_frames=50, num_landmarks=180, pixel_noise=1.0,
                          seed=7)
    cfg, frames, outs, gwc = _run_filter(syn, use_imu=True)
    p_est = np.asarray(outs["p"])
    ref = gwc[:, :, 3]
    prob, info = ba_problem_from_vio(
        np.asarray(frames["ids"]), np.asarray(frames["xp"]),
        np.asarray(frames["valid"]), np.asarray(outs["R"]), p_est,
        (cfg.fx, cfg.fy, cfg.cx, cfg.cy), stride=2)
    sol, hist = ba_solve(prob, iters=10)
    R_ba, p_ba = refine_trajectory(sol, info, np.asarray(outs["R"]), p_est)
    ate_f = _ate(p_est, ref)
    ate_b = _ate(p_ba, ref)
    assert np.isfinite(ate_b)
    assert ate_b < 2.5 * ate_f + 0.005, (
        f"BA damaged an already-good trajectory: {ate_f:.4f} -> {ate_b:.4f}")


def test_sharded_ba_from_vio_matches_dense():
    """The distributed solver consumes a REAL pipeline-produced problem
    (not synthetic_ba_problem) and reproduces the single-device solve."""
    from visma_tpu.dist import make_mesh
    from visma_tpu.dist.sharded_ba import sharded_ba_solve

    syn = SyntheticConfig(num_frames=40, num_landmarks=150, pixel_noise=1.0,
                          seed=5)
    cfg, frames, outs, gwc = _run_filter(syn, use_imu=False)
    prob, info = ba_problem_from_vio(
        np.asarray(frames["ids"]), np.asarray(frames["xp"]),
        np.asarray(frames["valid"]), np.asarray(outs["R"]),
        np.asarray(outs["p"]), (cfg.fx, cfg.fy, cfg.cx, cfg.cy), stride=2)
    mesh = make_mesh(jax.device_count())
    sol_d, _ = ba_solve(prob, iters=8)
    sol_s, _ = sharded_ba_solve(prob, mesh, iters=8, solver="dense")
    c_d = float(total_cost(sol_d))
    c_s = float(total_cost(sol_s))
    assert abs(c_s - c_d) / c_d < 1e-3
    assert np.abs(np.asarray(sol_s.p) - np.asarray(sol_d.p)).max() < 2e-2


@pytest.mark.slow
def test_image_pipeline_to_ba():
    """End-to-end: synthetic IMAGES -> tracker -> filter -> BaProblem from
    the tracker's own observations -> BA improves the vision-only
    trajectory (the full loop the data model exists for)."""
    from visma_tpu.io.synthetic_images import render_blob_frames
    from visma_tpu.pipeline import VioPipeline

    syn = SyntheticConfig(num_frames=40, num_landmarks=130, rows=240,
                          cols=320, fx=200.0, fy=200.0, cx=160.0, cy=120.0,
                          seed=11)
    cfg = FilterConfig(window=8, max_tracks=48, max_updates=16,
                       fx=syn.fx, fy=syn.fy, cx=syn.cx, cy=syn.cy,
                       pixel_noise=1.0, use_imu=False)
    frames_img, gwc, X = render_blob_frames(syn)
    N = syn.num_frames - 1
    spf = 8
    dt = 1.0 / syn.fps
    gyro = np.zeros((N, spf, 3), np.float32)
    accel = np.zeros((N, spf, 3), np.float32)
    dts = np.zeros((N, spf), np.float32)
    dts[:, -1] = dt

    pipe = VioPipeline(cfg, levels=3, cell=20)
    v0 = (gwc[1, :, 3] - gwc[0, :, 3]) * syn.fps
    st0 = pipe.init(jnp.asarray(frames_img[0]), R0=gwc[0, :, :3],
                    p0=gwc[0, :, 3], v0=v0)
    _, outs = pipe.run(st0, frames_img[1:], gyro, accel, dts)

    ref = gwc[1:, :, 3]
    p_est = np.asarray(outs["p"])
    prob, info = ba_problem_from_vio(
        np.asarray(outs["obs_ids"]), np.asarray(outs["obs_xp"]),
        np.asarray(outs["obs_valid"]), np.asarray(outs["R"]), p_est,
        (cfg.fx, cfg.fy, cfg.cx, cfg.cy), stride=2)
    assert prob is not None, "pipeline produced too few usable tracks"
    sol, hist = ba_solve(prob, iters=12)
    assert float(np.asarray(hist)[-1]) < float(total_cost(prob))
    R_ba, p_ba = refine_trajectory(sol, info, np.asarray(outs["R"]), p_est)
    a_filt = _aligned_ate(p_est, ref)
    a_ba = _aligned_ate(p_ba, ref)
    assert a_ba < a_filt, (
        f"image-pipeline BA did not improve: {a_filt:.4f} -> {a_ba:.4f}")


def test_run_vio_cli_ba(tmp_path, capsys):
    """run_vio --ba sharded end-to-end on the virtual mesh: report carries
    both trajectories' metrics and both datasets are written."""
    import json

    from visma_tpu.cli.run_vio import main

    out = tmp_path / "est"
    main(["--synthetic", "48", "--pixel-noise", "1.0", "--no-imu",
          "--ba", "sharded", "--ba-stride", "2", "--output", str(out)])
    lines = capsys.readouterr().out.strip().splitlines()
    report = json.loads(lines[0])
    assert report["ba"] == "sharded"
    assert report["ate_ba_sim_aligned_m"] < report["ate_sim_aligned_m"]
    assert (out / "dataset").exists() and (out / "dataset_ba").exists()

    # the BA dataset round-trips through the standard loader
    from visma_tpu.io import VlslamDatasetLoader

    class _Sub:
        pass

    loader = VlslamDatasetLoader(str(out))
    assert len(loader) == 48
