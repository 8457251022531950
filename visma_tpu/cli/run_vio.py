"""Run the MSCKF VIO over a sequence and report ATE
(new capability — the engine the reference dataset presumes; BASELINE
config 3). Three modes:

  feature-feed: consume a vlslam `dataset` (feature tracks as the Corvis
    frontend produced them) + an IMU npz {ts, gyro, accel};
  image-frontend (--images): run the FULL pipeline on the sequence's PNG
    frames — pyramid, KLT, detection, filter — ignoring the dataset's
    packed feature tracks (they become the comparison, not the input);
  synthetic: generate a sequence on the fly (--synthetic N frames).

--no-imu runs the vision-only fallback (constant-velocity process model,
cfg.use_imu=False) for the actual VISMA distribution, which ships no raw
IMU (SURVEY.md §0). Scale is then a gauge freedom; ATE is also reported
after similarity alignment.

Writes the estimated trajectory as a vlslam dataset (loadable by
example_load) and prints ATE vs the reference poses when available.
"""
from __future__ import annotations

import argparse
import json

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataroot", default=None, help="VISMA sequence dir")
    ap.add_argument("--imu", default=None, help="npz with ts/gyro/accel")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="run on an N-frame synthetic sequence instead")
    ap.add_argument("--output", default=None,
                    help="write estimated trajectory dataset here")
    ap.add_argument("--window", type=int, default=8)
    ap.add_argument("--max-tracks", type=int, default=96)
    ap.add_argument("--pixel-noise", type=float, default=0.5)
    ap.add_argument("--no-imu", action="store_true",
                    help="vision-only mode (constant-velocity prior)")
    ap.add_argument("--images", action="store_true",
                    help="image-frontend mode: run the full pipeline on "
                         "the sequence's PNG frames instead of its packed "
                         "feature tracks")
    ap.add_argument("--levels", type=int, default=3,
                    help="image pyramid levels (--images mode)")
    ap.add_argument("--cell", type=int, default=32,
                    help="detection grid cell in px (--images mode)")
    ap.add_argument("--ba", choices=("off", "dense", "sharded"),
                    default="off",
                    help="batch BA trajectory refinement after the filter "
                         "pass (BASELINE config 5): rebuild the problem "
                         "from the run's own observations + estimates "
                         "(ba/from_vio.py) and solve on one device (dense)"
                         " or landmark-sharded over the mesh (sharded)")
    ap.add_argument("--ba-stride", type=int, default=4,
                    help="keyframe stride for the BA problem")
    ap.add_argument("--ba-iters", type=int, default=10)
    ap.add_argument("--profile", default=None, metavar="LOGDIR",
                    help="emit a jax.profiler trace to LOGDIR plus a "
                         "host-side Timer report")
    args = ap.parse_args(argv)

    import jax.numpy as jnp

    from visma_tpu.filter import FilterConfig, Msckf
    from visma_tpu.filter.feed import pack_frames

    if args.synthetic:
        from visma_tpu.io.synthetic import (SyntheticConfig, make_dataset,
                                            make_imu, make_trajectory)

        syn = SyntheticConfig(num_frames=args.synthetic,
                              pixel_noise=args.pixel_noise)
        cfg = FilterConfig(window=args.window, max_tracks=args.max_tracks,
                           fx=syn.fx, fy=syn.fy, cx=syn.cx, cy=syn.cy,
                           pixel_noise=max(args.pixel_noise, 0.5),
                           use_imu=not args.no_imu)
        ds = make_dataset(syn)
        imu = None if args.no_imu else make_imu(syn)
        _, gwc = make_trajectory(syn)
        R0, p0 = gwc[0, :, :3], gwc[0, :, 3]
        ref_p = gwc[:, :, 3]
        v0 = (imu["v0"] if imu is not None
              else (gwc[1, :, 3] - gwc[0, :, 3]) * syn.fps)
    else:
        if not args.dataroot or (args.imu is None and not args.no_imu):
            ap.error("--dataroot and --imu required "
                     "(or --no-imu, or --synthetic N)")
        from visma_tpu.io import VlslamDatasetLoader

        loader = VlslamDatasetLoader(args.dataroot)
        ds = loader.dataset
        p = np.asarray(ds.camera.parameters)
        cfg = FilterConfig(window=args.window, max_tracks=args.max_tracks,
                           fx=float(p[0]), fy=float(p[1]), cx=float(p[2]),
                           cy=float(p[3]),
                           pixel_noise=max(args.pixel_noise, 0.5),
                           use_imu=not args.no_imu)
        if args.no_imu:
            imu = None
        else:
            imu_npz = np.load(args.imu)
            imu = {k: imu_npz[k] for k in ("ts", "gyro", "accel")}
            imu["v0"] = imu_npz.get("v0", np.zeros(3))
        g0 = loader.pose(0)
        R0, p0 = g0[:, :3], g0[:, 3]
        ref_p = np.stack([loader.pose(i)[:, 3] for i in range(len(loader))])
        # VISMA packets stamp microseconds (filenames like
        # 1520535134297896); IMU npz files stamp seconds. Normalize ONCE
        # here and use ts_norm for IMU windowing, v0, and export in BOTH
        # modes so stamp units always agree (ADVICE r3 #1).
        ts_norm = np.asarray([pk.ts for pk in ds.packets], np.float64)
        if len(ts_norm) > 1 and np.median(np.diff(ts_norm)) > 1.0:
            ts_norm = ts_norm * 1e-6
        if imu is not None:
            v0 = imu["v0"]
        else:
            dt0 = max(float(ts_norm[1] - ts_norm[0]), 1e-6)
            v0 = (ref_p[1] - ref_p[0]) / dt0

    from visma_tpu.filter.msckf import check_health
    from visma_tpu.utils.timer import Timer, device_trace

    timer = Timer()
    if args.images:
        # ---- image-frontend mode: images -> tracker -> filter ----------
        from visma_tpu.pipeline import VioPipeline

        if args.synthetic:
            from visma_tpu.io.synthetic_images import render_blob_frames

            images = render_blob_frames(syn)[0]
            ts = np.arange(syn.num_frames) / syn.fps
        else:
            import cv2

            imgs = []
            for i in range(len(loader)):
                fr = loader.grab(i)
                img = fr.image
                if img.ndim == 3:
                    img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
                imgs.append(img.astype(np.float32))
            images = np.stack(imgs)
            ts = ts_norm
        N = len(images)
        S = cfg.imu_per_frame
        gyro = np.zeros((N - 1, S, 3), np.float32)
        accel = np.zeros((N - 1, S, 3), np.float32)
        dts = np.zeros((N - 1, S), np.float32)
        if imu is None:
            dts[:, -1] = np.diff(ts)
        else:
            # normalized ts passed through so IMU windows match frame
            # stamps in the same units (ADVICE r3 #1)
            packed = pack_frames(cfg, ds, imu, max_feats=args.max_tracks,
                                 ts=None if args.synthetic else ts_norm)
            gyro = packed["gyro"][1:]
            accel = packed["accel"][1:]
            dts = packed["dts"][1:]
        if args.no_imu and not args.synthetic:
            dt0 = max(float(ts[1] - ts[0]), 1e-6)
            v0 = (ref_p[1] - ref_p[0]) / dt0

        pipe = VioPipeline(cfg, levels=args.levels, cell=args.cell)
        st0 = pipe.init(jnp.asarray(images[0]), R0=R0, p0=p0, v0=v0)
        if args.profile:
            timer.tick("pipeline_scan")
            with device_trace(args.profile):
                final, outs = pipe.run(st0, images[1:], gyro, accel, dts)
                outs = {k: np.asarray(v) for k, v in outs.items()}
            timer.tock("pipeline_scan")
            print(f"profiler trace written to {args.profile}")
            print(timer)
        else:
            final, outs = pipe.run(st0, images[1:], gyro, accel, dts)
        check_health(outs)
        # frame 0 initializes the pipeline; outputs cover frames 1..N-1
        ref_p = ref_p[1:]
        ts_out = ts[1:]
        obs_ids = np.asarray(outs["obs_ids"])
        obs_xp = np.asarray(outs["obs_xp"])
        obs_valid = np.asarray(outs["obs_valid"])
    else:
        packed = pack_frames(cfg, ds, imu, max_feats=args.max_tracks,
                             ts=None if args.synthetic else ts_norm)
        frames = {k: jnp.asarray(v) for k, v in packed.items()
                  if k != "ts"}
        kf = Msckf(cfg)
        s0 = kf.init(R0=R0, p0=p0, v0=v0)

        if args.profile:
            timer.tick("vio_scan")
            with device_trace(args.profile):
                final, outs = kf.run(s0, frames)
                outs = {k: np.asarray(v) for k, v in outs.items()}
            timer.tock("vio_scan")
            print(f"profiler trace written to {args.profile}")
            print(timer)
        else:
            final, outs = kf.run(s0, frames)
        # health gate: abort with a structured error on divergence instead
        # of exporting NaN poses
        check_health(outs)
        # export stamps in the SAME (normalized) units as --images mode
        ts_out = packed["ts"]
        obs_ids = np.asarray(frames["ids"])
        obs_xp = np.asarray(frames["xp"])
        obs_valid = np.asarray(frames["valid"])

    p_est = np.asarray(outs["p"])
    ate = float(np.sqrt(np.mean(np.sum((p_est - ref_p) ** 2, axis=1))))
    report = {"frames": len(p_est), "ate_rmse_m": round(ate, 5)}

    outs_ba = None
    if args.ba != "off":
        from visma_tpu.ba.from_vio import (ba_problem_from_vio,
                                           refine_trajectory)

        prob, info = ba_problem_from_vio(
            obs_ids, obs_xp, obs_valid, np.asarray(outs["R"]), p_est,
            (cfg.fx, cfg.fy, cfg.cx, cfg.cy),
            R_bc=cfg.cam_R_bc, p_bc=cfg.cam_p_bc, stride=args.ba_stride,
            max_landmarks=2 * args.max_tracks * max(len(p_est)
                                                    // args.ba_stride, 1))
        if prob is None:
            report["ba"] = "skipped: too few landmarks"
        else:
            if args.ba == "sharded":
                import jax

                from visma_tpu.dist import make_mesh
                from visma_tpu.dist.sharded_ba import sharded_ba_solve

                mesh = make_mesh(jax.device_count())
                sol, _ = sharded_ba_solve(prob, mesh, iters=args.ba_iters)
            else:
                from visma_tpu.ba.gauss_newton import ba_solve

                sol, _ = ba_solve(prob, iters=args.ba_iters)
            R_ba, p_ba = refine_trajectory(sol, info, np.asarray(outs["R"]),
                                           p_est, cfg.cam_R_bc, cfg.cam_p_bc)
            kfi = info["kf"]
            ate_ba = float(np.sqrt(np.mean(
                np.sum((p_ba - ref_p) ** 2, axis=1))))
            ate_kf = float(np.sqrt(np.mean(
                np.sum((p_est[kfi] - ref_p[kfi]) ** 2, axis=1))))
            ate_kf_ba = float(np.sqrt(np.mean(
                np.sum((p_ba[kfi] - ref_p[kfi]) ** 2, axis=1))))
            report.update({
                "ba": args.ba, "ba_keyframes": len(kfi),
                "ba_landmarks": int(prob.num_landmarks),
                "ate_ba_m": round(ate_ba, 5),
                "ate_kf_m": round(ate_kf, 5),
                "ate_kf_ba_m": round(ate_kf_ba, 5),
            })
            outs_ba = dict(outs)
            outs_ba["R"], outs_ba["p"] = R_ba, p_ba
    if args.no_imu:
        from visma_tpu.align.umeyama import umeyama

        def aligned_ate(pp):
            T = np.asarray(umeyama(jnp.asarray(pp, jnp.float32),
                                   jnp.asarray(ref_p, jnp.float32),
                                   with_scaling=True))
            pa = pp @ T[:3, :3].T + T[:3, 3]
            return float(np.sqrt(np.mean(np.sum((pa - ref_p) ** 2, axis=1))))

        report["ate_sim_aligned_m"] = round(aligned_ate(p_est), 5)
        if outs_ba is not None:
            # monocular BA inherits the initialization's gauge (pose 0 +
            # scale anchor pin the filter's drifted frame); alignment is
            # the meaningful metric for the vision-only configuration
            report["ate_ba_sim_aligned_m"] = round(
                aligned_ate(outs_ba["p"]), 5)
    print(json.dumps(report))

    if args.output:
        import os

        from visma_tpu.pipeline import export_packets
        from visma_tpu.proto import CameraInfo, Dataset

        packets = export_packets(cfg, outs, ts_out)
        est = Dataset(description="visma_tpu VIO estimate",
                      camera=ds.camera, packets=packets)
        os.makedirs(args.output, exist_ok=True)
        with open(os.path.join(args.output, "dataset"), "wb") as fp:
            fp.write(est.encode())
        print(f"wrote {args.output}/dataset")
        if outs_ba is not None:
            # BOTH trajectories are emitted: the filter estimate above and
            # the BA-refined one here (same wire format)
            est_ba = Dataset(description="visma_tpu VIO estimate (BA)",
                             camera=ds.camera,
                             packets=export_packets(cfg, outs_ba, ts_out))
            with open(os.path.join(args.output, "dataset_ba"), "wb") as fp:
                fp.write(est_ba.encode())
            print(f"wrote {args.output}/dataset_ba")


if __name__ == "__main__":
    main()
