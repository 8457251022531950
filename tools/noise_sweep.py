"""Sweep adversarial-imagery stress parameters and record pipeline ATE.

Justifies the bench/test gate operating points: runs the full image
pipeline over a grid of sensor-noise sigmas,
an occluder on/off axis, and a MOTION-SCALE axis (orbit angular rate
multiplier — drives per-frame feature displacement toward the KLT
window margin) on the adversarial generator, reporting ATE, the mean
track churn / lifetime, and the measured mean/max per-frame feature
displacement. Writes a markdown table (default docs/NOISE_SWEEP.md).

    python tools/noise_sweep.py [--cpu] [--rows 240 --cols 320]
    python tools/noise_sweep.py --headline   # 500x960 VISMA geometry
"""
from __future__ import annotations

import argparse
import sys
import time


def _displacement_stats(syn, gwc, X):
    """Mean/max per-frame px displacement of visible landmarks (numpy)."""
    import numpy as np

    from visma_tpu.io.synthetic import project

    ds = []
    prev_uv = prev_ok = None
    for i in range(syn.num_frames):
        uv = np.empty((len(X), 2))
        R, t = gwc[i, :, :3], gwc[i, :, 3]
        Xc = (X - t) @ R
        z = Xc[:, 2]
        ok = z > 0.1
        zs = np.where(ok, z, 1.0)
        uv[:, 0] = syn.fx * Xc[:, 0] / zs + syn.cx
        uv[:, 1] = syn.fy * Xc[:, 1] / zs + syn.cy
        ok &= ((uv[:, 0] >= 0) & (uv[:, 0] < syn.cols)
               & (uv[:, 1] >= 0) & (uv[:, 1] < syn.rows))
        if prev_uv is not None:
            both = ok & prev_ok
            if both.any():
                ds.append(np.linalg.norm(uv[both] - prev_uv[both], axis=1))
        prev_uv, prev_ok = uv, ok
    import numpy as np
    all_d = np.concatenate(ds) if ds else np.zeros(1)
    return float(all_d.mean()), float(np.percentile(all_d, 99))


def run_point(syn, cfg, noise_sigma, occluders, levels=4, cell=32):
    import jax.numpy as jnp
    import numpy as np

    from visma_tpu.filter.msckf import check_health
    from visma_tpu.io.synthetic import make_imu
    from visma_tpu.io.synthetic_images import render_adversarial_frames
    from visma_tpu.pipeline import VioPipeline

    frames, gwc, X = render_adversarial_frames(
        syn, noise_sigma=noise_sigma, occluders=occluders)
    imu = make_imu(syn)
    spf = imu["samples_per_frame"]
    dt = float(np.diff(imu["ts_state"])[0])
    N = syn.num_frames - 1
    gyro = imu["gyro"][: N * spf].reshape(N, spf, 3)
    accel = imu["accel"][: N * spf].reshape(N, spf, 3)
    dts = np.full((N, spf), dt, np.float32)

    pipe = VioPipeline(cfg, levels=levels, cell=cell)
    st0 = pipe.init(jnp.asarray(frames[0]), R0=gwc[0, :, :3],
                    p0=gwc[0, :, 3], v0=imu["v0"])
    _, outs = pipe.run(st0, frames[1:], gyro, accel, dts)
    ok = True
    try:
        check_health(outs)
    except Exception:
        ok = False
    p = np.asarray(outs["p"])
    ate = float(np.sqrt(np.mean(np.sum((p - gwc[1:, :, 3]) ** 2, axis=1))))
    # track CHURN and LIFETIME, not the live count: replenishment holds
    # the live count pinned at capacity (96.0 in every r4 row), so it
    # cannot distinguish healthy tracking from thrash
    import collections

    ids = np.asarray(outs["feat_ids"])
    valid = np.asarray(outs["obs_valid"]) & (ids >= 0)
    churn = []
    cnt = collections.Counter()
    for i in range(len(ids)):
        cur = set(ids[i][valid[i]].tolist())
        for t in cur:
            cnt[t] += 1
        if i + 1 < len(ids) and cur:
            nxt = set(ids[i + 1][valid[i + 1]].tolist())
            churn.append(len(cur - nxt) / len(cur))
    churn_pct = 100.0 * float(np.mean(churn)) if churn else 0.0
    med_life = float(np.median(list(cnt.values()))) if cnt else 0.0
    d_mean, d_p99 = _displacement_stats(syn, gwc, X)
    return ate, churn_pct, med_life, ok, d_mean, d_p99


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--headline", action="store_true",
                    help="500x960 VISMA geometry with the bench intrinsics")
    ap.add_argument("--rows", type=int, default=240)
    ap.add_argument("--cols", type=int, default=320)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--motions", type=float, nargs="*",
                    default=[1.0, 2.0, 3.0])
    ap.add_argument("--output", default="docs/NOISE_SWEEP.md")
    args = ap.parse_args(argv)

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    from visma_tpu.filter import FilterConfig
    from visma_tpu.io.synthetic import SyntheticConfig

    if args.headline:
        args.rows, args.cols = 500, 960
        intr = dict(fx=486.405, fy=535.401, cx=469.199, cy=257.916)
    else:
        f = 240.0 * args.cols / 320.0
        intr = dict(fx=f, fy=f, cx=(args.cols - 1) / 2,
                    cy=(args.rows - 1) / 2)

    rows = []
    for motion in args.motions:
        syn = SyntheticConfig(num_frames=args.frames, num_landmarks=240,
                              rows=args.rows, cols=args.cols, seed=7,
                              angular_rate=0.35 * motion, **intr)
        cfg = FilterConfig(window=8, max_tracks=96, max_updates=24,
                           fx=syn.fx, fy=syn.fy, cx=syn.cx, cy=syn.cy,
                           pixel_noise=1.0)
        for occluders in (0, 2):
            for ns in (0.0, 4.0, 8.0):
                t0 = time.time()
                ate, churn, life, ok, dm, dp = run_point(syn, cfg, ns,
                                                         occluders)
                rows.append((motion, ns, occluders, ate, churn, life, ok,
                             dm, dp))
                print(f"motion={motion:3.1f} noise={ns:4.1f} "
                      f"occluders={occluders} ATE={ate * 100:6.2f} cm "
                      f"churn={churn:4.1f}%/fr med_life={life:4.0f}fr "
                      f"healthy={ok} "
                      f"disp mean={dm:.1f} p99={dp:.1f} px "
                      f"({time.time() - t0:.0f}s)",
                      file=sys.stderr, flush=True)

    import jax

    lines = [
        "# Adversarial-imagery stress sweep",
        "",
        f"Generated by tools/noise_sweep.py on backend="
        f"{jax.default_backend()} at {args.rows}x{args.cols}, "
        f"{args.frames} frames, 240 landmarks (seed 7). Axes: sensor "
        "noise sigma, textured occluder sweeps, and MOTION SCALE (orbit "
        "angular-rate multiplier; the displacement columns show the "
        "measured per-frame feature motion this produces — the fused-KLT "
        "level-0 window is 24 px with 4 pyramid levels, so p99 "
        "displacement approaching 24*2^3 px is the designed envelope "
        "edge). Justifies the gate operating points: the KLT residual "
        "gate (12 intensity units) and FB gate (1.0 px) hold tracking "
        "through the grid without loosening the bench ATE gate.",
        "",
        "| motion | noise sigma | occluders | disp mean (px) | "
        "disp p99 (px) | ATE (cm) | churn %/frame | med track life (fr) "
        "| healthy |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for mo, ns, occ, ate, churn, life, ok, dm, dp in rows:
        lines.append(f"| {mo:.1f} | {ns:.1f} | {occ} | {dm:.1f} | {dp:.1f} "
                     f"| {ate * 100:.2f} | {churn:.1f} | {life:.0f} |"
                     f" {'yes' if ok else 'NO'} |")
    out = "\n".join(lines) + "\n"
    with open(args.output, "w") as fp:
        fp.write(out)
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
