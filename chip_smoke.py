"""Smoke run of the system's main paths on NVIDIA GPUs.

    python chip_smoke.py          # every one-GPU phase
    python chip_smoke.py --four   # only the four-GPU phase

Phases (one GPU): device, VIO pipeline, semantic mapper, evaluation,
kernel parity. Each drives the public entry points at the bench's sizes
(bench.py) and checks its own gates; any failure exits non-zero. The last
line of standard output is one JSON object naming the device:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
It is printed only when every phase passed on a GPU.

--four runs the distributed bundle adjustment paths and the two-stage
pipeline on four GPUs against their single-device oracles
(__graft_entry__.dryrun_multichip), and nothing else.

The compile cache lives in $JAX_COMPILATION_CACHE_DIR when that is set,
else in .jax_cache beside this file.
"""
import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))


def compile_cache_dir():
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        REPO, ".jax_cache")


def last_line(platform, kind, count):
    return json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": count}})


def log(msg):
    print(msg, flush=True)


def phase_device(bench, need):
    import jax

    info = bench.device_info()
    log(f"device: {info['kind']} x{info['count']} platform={info['platform']}"
        f" jax={info['jax']} XLA_FLAGS={info['xla_flags']!r}")
    log(f"nvidia-smi: {info['nvidia_smi']}")
    if info["platform"] != "gpu":
        raise SystemExit(f"no GPU: JAX runs on {info['platform']}")
    if len(jax.devices()) < need:
        raise SystemExit(f"need {need} GPUs, have {len(jax.devices())}")
    return info


def phase_vio(bench):
    r = bench.bench_pipeline()
    log(f"vio: ATE {r['ate_m']:.4f} m, compile {r['compile_s']:.1f} s, "
        f"run {r['ms_per_frame']} ms/frame, step {r['step_ms_after_first']}")
    f = bench.bench_frontend()
    log(f"frontend: {json.dumps(f)}")
    return r, f


def phase_semantic(bench):
    r = bench.bench_semantic(n_frames=21, window=8)
    log(f"semantic: cold compile {r['cold_compile_s']:.1f} s, spawn frame "
        f"{r['spawn_frame_ms']:.1f} ms, settled {r['settled_ms_per_frame']}"
        f" ms/frame, trans err {r['trans_err_m']} m, rot err "
        f"{r['rot_err_deg']} deg, models {r['models']}")
    return r


def phase_eval(bench):
    r = bench.bench_eval()
    log(f"eval: {json.dumps(r)}")
    return r


def _bench_scene_poses():
    """Chair and desk at bench-like poses (model -> camera)."""
    import numpy as np
    from scipy.spatial.transform import Rotation

    out = []
    for x, z, yaw in ((-0.65, 3.1, 0.35), (0.65, 3.1, -0.4)):
        P = np.zeros((3, 4), np.float32)
        P[:, :3] = Rotation.from_euler("y", yaw).as_matrix()
        P[:, 3] = [x, 0.05, z]
        out.append(P)
    return out


def raster_batches(Cs):
    """Renderer inputs at the semantic mapper's shapes, keyed by label:
    (roi, (Cs, poses, mesh_idx, origins)) around the bench scene."""
    import jax.numpy as jnp
    import numpy as np

    rng = np.random.default_rng(0)
    base = _bench_scene_poses()
    out = {}
    for label, B, roi in (("cem_iter_192x256x384", 192, (256, 384)),
                          ("full_frame_36x500x960", 36, None)):
        poses = np.stack([base[b % 2] for b in range(B)])
        poses[:, :, 3] += rng.normal(0, 0.03, (B, 3)).astype(np.float32)
        org = None if roi is None else jnp.asarray(
            np.tile([[100.0, 120.0], [480.0, 120.0]], (B // 2, 1)),
            jnp.float32)
        out[label] = (roi, (Cs, jnp.asarray(poses),
                            jnp.asarray(np.arange(B) % 2, jnp.int32), org))
    return out


def phase_parity(bench):
    """Kernels as compiled for the card against the plain references."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from visma_tpu.io.procedural import bench_mesh_db
    from visma_tpu.render import Intrinsics
    from visma_tpu.render.raster import (mesh_corner_stack,
                                         rasterize_depth_brute,
                                         rasterize_depth_multi)

    intr = Intrinsics(rows=500, cols=960, z_near=0.05, z_far=8.0,
                      **bench.INTR_500x960)
    db = bench_mesh_db()
    cpu = jax.devices("cpu")[0]

    def on_cpu(fn, *args):
        with jax.default_device(cpu):
            return jax.jit(fn)(*jax.device_put(args, cpu))

    # raster: kernel and XLA form on the card vs the brute-force reference
    # computed on the CPU (triangle setup included), full frame and two
    # ROI windows: one around the object's coverage, one shifted by half a
    # window so that its border cuts the silhouette. 0 coverage
    # mismatches, depth within 1e-4 relative (both sides evaluate the same
    # plane equations; only the max order differs)
    Hr, Wr = 256, 384

    def brute(V, F, P, roi=None, org=None):
        return np.asarray(on_cpu(
            lambda V, F, P, org: rasterize_depth_brute(V, F, P, intr, roi,
                                                       org, chunk=64),
            jnp.asarray(V), jnp.asarray(F), P, org))

    def shifted(o, half, hi):
        return o + half if o + half <= hi else o - half

    with jax.default_matmul_precision("highest"):
        for (name, (V, F)), P in zip(db.items(), _bench_scene_poses()):
            Cs = mesh_corner_stack([(V, F)])
            mi = jnp.zeros((1,), jnp.int32)
            Pd = jnp.asarray(P)
            ref_full = brute(V, F, Pd)
            cov = np.argwhere(np.isfinite(ref_full))
            oy = int(np.clip(cov[:, 0].mean() - Hr // 2, 0, 500 - Hr))
            ox = int(np.clip(cov[:, 1].mean() - Wr // 2, 0, 960 - Wr))
            cases = [("full", None), ("roi", (ox, oy)),
                     ("roi-cut", (shifted(ox, Wr // 2, 960 - Wr),
                                  shifted(oy, Hr // 2, 500 - Hr)))]
            for label, o in cases:
                if o is None:
                    ref = ref_full
                    args = (Cs, Pd[None], mi, intr)
                else:
                    org = jnp.asarray(o, jnp.float32)
                    ref = brute(V, F, Pd, (Hr, Wr), org)
                    args = (Cs, Pd[None], mi, intr, (Hr, Wr), org[None])
                fin = np.isfinite(ref)
                if label == "roi-cut":
                    assert 0 < fin.sum() < len(cov), (
                        f"{name}: window does not cut the silhouette")
                for impl in ("kernel", "xla"):
                    got = np.asarray(rasterize_depth_multi(
                        *args, impl=impl))[0]
                    bad = int((np.isfinite(got) != fin).sum())
                    rel = float(np.max(np.abs(got[fin] - ref[fin])
                                       / ref[fin]))
                    log(f"parity raster {name} {label} origin={o} {impl}: "
                        f"{bad} coverage mismatches of {int(fin.sum())} "
                        f"(full frame {len(cov)}), max rel depth err "
                        f"{rel:.2e}")
                    assert bad == 0 and rel < 1e-4, (name, label, impl)

    # the kernel timed at the semantic mapper's shapes: one CEM iteration
    # (4 objects x 48 hypotheses in (256, 384) windows) and a full-frame
    # batch (9 frames x 4 objects)
    Cs = mesh_corner_stack(list(db.values()))
    for label, (roi, args) in raster_batches(Cs).items():
        f = jax.jit(lambda C, p, m, o, roi=roi: rasterize_depth_multi(
            C, p, m, intr, roi, o))
        ms = bench.ms_stats(bench.timed_ms(f, *args))
        log(f"raster timing {label}: {ms}")

    # corner score vs the same function on the CPU: 25-term box sums of
    # gradient products reassociated differently, so agreement to f32
    # rounding of the response scale
    from visma_tpu.frontend.detect import corner_score

    _, _, frames, _, _ = bench._adversarial_sequence()
    img = jnp.asarray(frames[10])
    cs = lambda im: corner_score(im, 5, 8, 1e-4)  # noqa: E731
    g = np.asarray(jax.jit(cs)(img))
    c = np.asarray(on_cpu(cs, img))
    err = float(np.abs(g - c).max() / np.abs(c).max())
    log(f"parity corner score 500x960: max |gpu-cpu| / max|cpu| = "
        f"{err:.2e} (tol 1e-4), nonzero gpu {int((g > 0).sum())} cpu "
        f"{int((c > 0).sum())}")
    assert err < 1e-4

    # one filter step vs the CPU: a default-precision (TF32) product in
    # the filter would show as ~1e-3 relative error; f32 reassociation
    # stays near 1e-6
    import __graft_entry__

    fn, args = __graft_entry__.entry()
    g = jax.jit(fn)(*args)
    c = on_cpu(fn, *args)
    worst = 0.0
    for name in ("R", "p", "v", "P"):
        a, b = np.asarray(getattr(g, name)), np.asarray(getattr(c, name))
        e = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))
        worst = max(worst, e)
        log(f"parity filter step {name}: max rel err {e:.2e}")
    assert worst < 1e-4, f"filter step differs from the CPU: {worst}"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU phase")
    args = ap.parse_args(argv)

    os.environ["JAX_COMPILATION_CACHE_DIR"] = compile_cache_dir()
    sys.path.insert(0, REPO)
    import bench
    import jax

    t0 = time.time()
    info = phase_device(bench, 4 if args.four else 1)
    if args.four:
        import __graft_entry__

        __graft_entry__.dryrun_multichip(4)
        log(f"four-GPU phase passed in {time.time() - t0:.0f} s")
    else:
        for phase in (phase_vio, phase_semantic, phase_eval, phase_parity):
            t = time.time()
            phase(bench)
            log(f"phase {phase.__name__} passed in {time.time() - t:.0f} s")
    print(last_line(info["platform"], info["kind"], len(jax.devices())))


if __name__ == "__main__":
    main()
