"""Benchmark of the system's main paths on one NVIDIA GPU.

Phases (each a function returning a dict, with its accuracy gate
asserted inside, so a number is only reported for a working system):

  bench_pipeline   the VIO pipeline at VISMA image geometry: 240 synthetic
                   adversarial 500x960 frames + IMU through VioPipeline.run
                   (image pyramid, pyramidal KLT, corner detection and
                   replenishment, IMU propagation, clone augmentation,
                   triangulation, nullspace-projected EKF update); also
                   VioPipeline.step per frame. Gate: ATE < 0.10 m.
  bench_frontend   the frontend kernels alone at the same geometry: the
                   windowed and the gather LK tracker, and the corner score.
  bench_semantic   the multi-object semantic mapper: 4 objects on the
                   bench's 5k-face chair and desk, detection-driven
                   retrieval, spawn CEM and the settled steady state.
                   Gates: per-object translation < 0.05 m, mean rotation
                   < 5 deg, worst < 10 deg, right CAD models retrieved.
  bench_eval       evaluation: surface error (500k samples x 10,164
                   faces), ICP (voxel 0.05 m, radius 0.075 m, 50k samples)
                   and RegisterScenes on 5 objects. Gates: ICP fitness
                   > 0.9, 5/5 matches.
  bench_filter_only  the filter on pre-packed feature tracks.

Image geometry matches the reference's undistorted output (500x960,
example/undistort_images.cpp:22-28) with the generate_depthmaps intrinsics
(fx=486.405 fy=535.401 cx=469.199 cy=257.916,
example/generate_depthmaps.cpp:9-17). The imagery is adversarial: sensor
noise, a geometrically consistent textured background, photometric drift
and two textured occluder sweeps (io/synthetic_images).

`python bench.py` runs every phase and prints one JSON line naming the
device. It refuses to run on anything but a GPU: a CPU number is not a
device number.
"""
import functools
import json
import os
import sys
import time

os.environ.setdefault("JAX_COMPILATION_CACHE_DIR",
                      os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   ".jax_cache"))

N_FRAMES = 240
INTR_500x960 = dict(fx=486.405, fy=535.401, cx=469.199, cy=257.916)


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def timed_ms(fn, *args, reps=10):
    """Run fn(*args) once to compile, then `reps` times; each call ends in
    block_until_ready. Returns per-call milliseconds (list)."""
    import jax

    jax.block_until_ready(fn(*args))
    out = []
    for _ in range(reps):
        t = time.perf_counter()
        jax.block_until_ready(fn(*args))
        out.append((time.perf_counter() - t) * 1e3)
    return out


def ms_stats(ms):
    import numpy as np

    return {"min_ms": float(np.min(ms)), "median_ms": float(np.median(ms))}


@functools.lru_cache(maxsize=1)
def _adversarial_sequence():
    """The VIO bench's sequence and filter config (made once per
    process; callers must not modify the arrays)."""
    from visma_tpu.filter import FilterConfig
    from visma_tpu.io.synthetic import SyntheticConfig, make_imu
    from visma_tpu.io.synthetic_images import render_adversarial_frames

    syn = SyntheticConfig(num_frames=N_FRAMES, num_landmarks=240,
                          rows=500, cols=960, seed=7, **INTR_500x960)
    cfg = FilterConfig(window=8, max_tracks=96, max_updates=24,
                       fx=syn.fx, fy=syn.fy, cx=syn.cx, cy=syn.cy,
                       pixel_noise=1.0)
    t0 = time.time()
    frames, gwc, _ = render_adversarial_frames(syn)
    imu = make_imu(syn)
    log(f"synthesized {N_FRAMES} frames at 500x960 in "
        f"{time.time() - t0:.1f}s")
    return syn, cfg, frames, gwc, imu


def bench_pipeline(steps: int = 8, reps: int = 5):
    """Full images+IMU pipeline at VISMA geometry through VioPipeline.run,
    then `steps` frames through VioPipeline.step, checked against the
    scanned run's poses."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from visma_tpu.filter.msckf import check_health
    from visma_tpu.pipeline import VioPipeline

    syn, cfg, frames, gwc, imu = _adversarial_sequence()
    spf = imu["samples_per_frame"]
    dt = float(np.diff(imu["ts_state"])[0])
    N = syn.num_frames - 1
    gyro = imu["gyro"][: N * spf].reshape(N, spf, 3)
    accel = imu["accel"][: N * spf].reshape(N, spf, 3)
    dts = np.full((N, spf), dt, np.float32)

    pipe = VioPipeline(cfg, levels=4, cell=32)
    st0 = pipe.init(jnp.asarray(frames[0]), R0=gwc[0, :, :3],
                    p0=gwc[0, :, 3], v0=imu["v0"])
    d_images = jnp.asarray(frames[1:])
    d_gyro = jnp.asarray(gyro)
    d_accel = jnp.asarray(accel)
    d_dts = jnp.asarray(dts)
    jax.block_until_ready((d_images, d_gyro, d_accel, d_dts))

    t0 = time.perf_counter()
    final, outs = pipe.run(st0, d_images, d_gyro, d_accel, d_dts)
    p_est = np.asarray(outs["p"])
    compile_s = time.perf_counter() - t0
    check_health(outs)
    ate = float(np.sqrt(np.mean(
        np.sum((p_est - gwc[1:, :, 3]) ** 2, axis=1))))
    log(f"pipeline ATE RMSE: {ate * 100:.2f} cm over {N} frames @ 500x960")
    assert ate < 0.10, f"accuracy gate failed: pipeline ATE {ate:.3f} m"

    run_ms = timed_ms(lambda: pipe.run(st0, d_images, d_gyro, d_accel,
                                       d_dts)[1]["p"], reps=reps)
    per_frame = [x / N for x in run_ms]
    log(f"pipeline run ms/frame: {[round(x, 3) for x in per_frame]}")

    # streaming path: one VioPipeline.step per frame must retrace the
    # scanned run's trajectory
    st = st0
    step_ms = []
    for i in range(steps):
        t = time.perf_counter()
        st = pipe.step(st, d_images[i], d_gyro[i], d_accel[i], d_dts[i])
        jax.block_until_ready(st)
        step_ms.append((time.perf_counter() - t) * 1e3)
        e = float(np.abs(np.asarray(st.filter.p) - p_est[i]).max())
        assert e < 1e-3, f"VioPipeline.step frame {i} off the scan by {e} m"
    return {"ate_m": ate, "compile_s": compile_s,
            "frames_per_s": 1e3 / min(per_frame),
            "ms_per_frame": ms_stats(per_frame),
            "step_ms_after_first": (ms_stats(step_ms[1:]) if steps > 1
                                    else None),
            "frames": N}


def bench_frontend(reps: int = 20):
    """Frontend kernels at 500x960 with 96 features and 4 levels: the
    windowed (one-hot matmul) LK tracker, the gather LK tracker, and the
    corner score. Per-call milliseconds."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from visma_tpu.frontend.detect import corner_score, detect_features
    from visma_tpu.frontend.klt import track_features, track_features_gather
    from visma_tpu.frontend.pyramid import build_pyramid

    _, cfg, frames, _, _ = _adversarial_sequence()
    img0, img1 = jnp.asarray(frames[10]), jnp.asarray(frames[11])
    p0 = tuple(build_pyramid(img0, 4))
    p1 = tuple(build_pyramid(img1, 4))
    xy, _, valid = detect_features(img0, cfg.max_tracks, 32)
    out = {}
    res = {}
    for name, fn in (("klt_windowed", track_features),
                     ("klt_gather", track_features_gather)):
        f = jax.jit(lambda a, b, x, v, fn=fn: fn(a, b, x, v, radius=5,
                                                  levels=4))
        res[name] = [np.asarray(r) for r in f(p0, p1, xy, valid)]
        out[name] = ms_stats(timed_ms(f, p0, p1, xy, valid, reps=reps))
    both = res["klt_windowed"][1] & res["klt_gather"][1]
    assert both.sum() >= 0.5 * np.asarray(valid).sum(), "LK lost tracks"
    e = np.abs(res["klt_windowed"][0][both] - res["klt_gather"][0][both])
    out["klt_forms_max_px_diff"] = float(e.max())
    cs = jax.jit(lambda im: corner_score(im, 5, 8, 1e-4))
    out["corner_score"] = ms_stats(timed_ms(cs, img0, reps=reps))
    log(f"frontend: {out}")
    return out


def bench_semantic(m_objects=4, n_frames=45, cem_iters=5, cem_samples=48,
                   window=8):
    """Multi-object semantic mapping at VISMA geometry on REAL CAD-scale
    meshes: the reference's own 5k-face aeron chair
    (misc/hermanmiller_aeron.obj, the mesh render_depth.cpp and the papers'
    evaluation consume) + a procedural 5.1k-face desk, tracked jointly by
    CEM over batched MultiMeshRenderer renders — the replacement for the
    reference's one-hypothesis-per-GL-draw loop
    (renderer.cpp:321-400).

    DETECTION-DRIVEN SPAWN: tracks are born from
    `.bbox`-style detections — class names that match no CAD model, so
    shape retrieval scores every (mesh, yaw) candidate with the
    detection's azimuth distribution as a prior (vlslam.proto:66-70) and
    depth initialized from the bbox height (scale-from-detection). The
    spawn-frame cost and spawn-to-settle frame count are measured and
    reported.

    THROUGHPUT is the settled steady state, measured over consecutive
    `window`-frame windows, each drained (_sync_dev) before its timer
    stops; min and median are reported.

    Accuracy gates sit INSIDE the reference's own evaluation envelope,
    PER OBJECT: every object's translation error
    < 0.05 m (the reference's ICP matcher radius is 0.075 m,
    cfg/tool.json:25-32), mean rotation < 5 deg, worst < 10 deg, and
    retrieval must have picked the right CAD model.

    Returns a dict of timings and per-object errors.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np
    from scipy.spatial.transform import Rotation

    from visma_tpu.image.edges import depth_edge
    from visma_tpu.io.procedural import bench_mesh_db
    from visma_tpu.proto import BoundingBox, BoundingBoxList
    from visma_tpu.render import Intrinsics
    from visma_tpu.semantic import SemanticMapper

    intr = Intrinsics(rows=500, cols=960, z_near=0.05, z_far=8.0,
                      **INTR_500x960)
    db = bench_mesh_db()
    n_faces = {n: len(F) for n, (_, F) in db.items()}
    names = (["chair", "desk"] * ((m_objects + 1) // 2))[:m_objects]
    rng = np.random.default_rng(3)

    # GT object poses: chairs flanking, desks center, alternating depth,
    # every object fully in view at 500x960 (footprints of neighbors
    # overlap -> the occluder-render path is exercised every frame)
    slots = [(-1.5, 2.75), (-0.65, 3.1), (0.65, 3.1), (1.5, 2.75)]
    T_gt = []
    yaw_gt = []
    for k in range(m_objects):
        yaw = rng.uniform(-0.6, 0.6)
        T = np.eye(4)
        T[:3, :3] = Rotation.from_euler("y", yaw).as_matrix()
        x, z = slots[k % len(slots)]
        T[:3, 3] = [x, rng.uniform(-0.1, 0.1), z]
        T_gt.append(T)
        yaw_gt.append(yaw)

    # roi / annealed settled schedule / async steady state: see
    # SemanticMapper docstring. settled 3x24 @ (0.05, 0.03): more refits
    # beat more samples once settled (measured r4).
    # roi (256, 384): the desk footprint is 273 px wide at the bench
    # geometry — a 256-px window truncated its right edge (and its
    # neighbors' occluder evidence), leaving spawn-scale errors stuck in
    # a local optimum (r5 diagnostic); the wider window costs ~4%.
    # retrieval_yaws=24: 15-deg bins, tight enough for the settled
    # schedule to polish the yaw residual.
    mapper = SemanticMapper(intr, db, cem_iters=cem_iters,
                            cem_samples=cem_samples, roi=(256, 384),
                            retrieval_yaws=24,
                            settle_age=2, settled_iters=3,
                            settled_samples=24,
                            settled_sigma=(0.05, 0.03),
                            async_frames=16, roi_spawn=True)
    mesh_idx = np.array([mapper.mrenderer.index(n) for n in names],
                       np.int32)

    # per-frame GT edges from our own renderer (camera strafes slowly)
    def gwc_at(i):
        return np.hstack([np.eye(3),
                          np.array([[0.015 * i], [0.0], [0.0]])])

    t0 = time.time()
    all_poses = np.empty((n_frames, m_objects, 3, 4), np.float32)
    for i in range(n_frames):
        G = np.eye(4)
        G[:3, :4] = gwc_at(i)
        G_cw = np.linalg.inv(G)
        all_poses[i] = np.stack([(G_cw @ T)[:3, :4] for T in T_gt])
    # ONE dispatch for all frames' GT renders; edge maps stay on the
    # device (production path: depth_edge output is already there)
    mi = jnp.broadcast_to(jnp.asarray(mesh_idx), (n_frames, m_objects))
    d = mapper.mrenderer.render_depth(jnp.asarray(all_poses), mi)
    edge_frames = jax.vmap(lambda di: depth_edge(jnp.min(di, axis=0)))(d)
    jax.block_until_ready(edge_frames)
    log(f"semantic: rendered {n_frames} GT edge frames "
        f"({n_faces} faces) in {time.time() - t0:.1f}s")

    # detector output: bboxes of the projected GT AABBs, a class name
    # matching NO database model (forces the retrieval path), and a noisy
    # 12-bin azimuth distribution peaked at the true yaw
    def gt_bboxes(i):
        boxes = []
        for k in range(m_objects):
            lo, hi = mapper._mesh_aabb[names[k]]
            corners = np.array([[x, y, z] for x in (lo[0], hi[0])
                                for y in (lo[1], hi[1])
                                for z in (lo[2], hi[2])])
            pc = corners @ all_poses[i, k, :3, :3].T + all_poses[i, k, :3, 3]
            u = intr.fx * pc[:, 0] / pc[:, 2] + intr.cx
            v = intr.fy * pc[:, 1] / pc[:, 2] + intr.cy
            nbins = 12
            tb = int(round(yaw_gt[k] / (2 * np.pi) * nbins)) % nbins
            ap = np.full(nbins, 0.02)
            ap[tb] = 0.5
            ap[(tb + 1) % nbins] = ap[(tb - 1) % nbins] = 0.15
            boxes.append(BoundingBox(
                top_left_x=float(u.min()), top_left_y=float(v.min()),
                bottom_right_x=float(u.max()), bottom_right_y=float(v.max()),
                scores=np.array([0.9], np.float32), class_name="furniture",
                azimuth_prob=ap.astype(np.float32)))
        return BoundingBoxList(bounding_boxes=boxes)

    # COLD phase: AOT-compile the executor variants CONCURRENTLY
    # (mapper.warmup), then one spawn+settle pass for the residual jits
    # (compose/crops/retrieval glue)
    warmup = 5
    t0 = time.time()
    aot_s = mapper.warmup(m_objects)
    for i in range(warmup):
        mapper.step(gwc_at(i), edge_frames[i],
                    bboxes=gt_bboxes(i) if i == 0 else None)
    cold_s = time.time() - t0
    log(f"semantic: cold compile {cold_s:.1f}s (parallel AOT {aot_s:.1f}s "
        f"+ residual)")

    # WARM re-spawn on the same mapper (executor caches persist): the
    # measured detection->spawn->settle path
    mapper.tracks.clear()
    mapper.history.clear()
    mapper._dev = None
    mapper._frame_no = 0
    t_spawn = time.time()
    mapper.step(gwc_at(0), edge_frames[0], bboxes=gt_bboxes(0))
    spawn_ms = (time.time() - t_spawn) * 1e3
    spawn_order = sorted(mapper.tracks)
    settle_frame = None
    for i in range(1, warmup):
        mapper.step(gwc_at(i), edge_frames[i])
        mapper._sync_dev()
        errs = [float(np.linalg.norm(
            mapper.tracks[oid].pose_wm[:3, 3] - T_gt[k][:3, 3]))
            for k, oid in enumerate(spawn_order)]
        if settle_frame is None and max(errs) < 0.075:
            settle_frame = i
    log(f"semantic: spawn frame {spawn_ms:.0f} ms (retrieval + windowed "
        f"spawn CEM, {len(mapper.tracks)} tracks), settled by frame "
        f"{settle_frame} (<0.075 m)")

    # steady state: drained windows
    win_times = []
    i = warmup
    while i + window <= n_frames:
        t0 = time.time()
        for j in range(i, i + window):
            mapper.step(gwc_at(j), edge_frames[j])
        mapper._sync_dev()   # drain the pipelined dispatches: honest
        win_times.append(time.time() - t0)
        i += window
    mapper.finalize()
    per_frame_ms = [t / window * 1e3 for t in win_times]
    log(f"semantic: window ms/frame {[round(x, 1) for x in per_frame_ms]}")

    terr, rerr, models = [], [], []
    for k, oid in enumerate(spawn_order):
        tr = mapper.tracks[oid]
        T = tr.pose_wm
        terr.append(float(np.linalg.norm(T[:3, 3] - T_gt[k][:3, 3])))
        rerr.append(float(np.degrees(Rotation.from_matrix(
            T[:3, :3] @ T_gt[k][:3, :3].T).magnitude())))
        models.append(tr.model_name)
    r_mean = float(np.mean(rerr))
    log(f"semantic: {m_objects} objects, retrieved {models}, "
        f"trans err {[round(x, 3) for x in terr]} m, "
        f"rot err {[round(x, 1) for x in rerr]} deg")
    # accuracy gates: the speed is of a WORKING mapper, judged inside the
    # reference's own ICP matching radius (0.075 m) — PER OBJECT
    assert models == names, f"shape retrieval failed: {models} != {names}"
    assert len(mapper.tracks) == m_objects, "spawn/dedup failed"
    assert max(terr) < 0.05, \
        f"semantic per-object trans gate failed: {[round(x,3) for x in terr]} m"
    assert r_mean < 5.0, f"semantic rot gate failed: {r_mean:.1f} deg"
    assert max(rerr) < 10.0, \
        f"semantic worst-object rot gate failed: {max(rerr):.1f} deg"
    return {"settled_ms_per_frame": ms_stats(per_frame_ms),
            "frames_per_s": 1e3 / min(per_frame_ms),
            "window_ms_per_frame": per_frame_ms,
            "spawn_frame_ms": spawn_ms, "settle_frames": settle_frame,
            "cold_compile_s": cold_s, "trans_err_m": terr,
            "rot_err_deg": rerr, "models": models, "mesh_faces": n_faces}


def bench_eval():
    """Evaluation layer on the device at the reference's own operating
    points (the reference's measured hot loops, SURVEY §3.2):

      surface error   <=500k samples, point-to-mesh NN (geometry.h:118-141,
                      igl::AABB -> tiled brute force)
      ICP refinement  voxel 0.05 m, max_distance 0.075 m, 50k
                      samples/model, point-to-point (evaluation.cpp:258-271,
                      cfg/tool.json:25-32)
      RegisterScenes  O(n^2) same-shape pair proposals x greedy
                      correspondence (evaluation.cpp:79-112; host-side)

    Returns a dict of millisecond timings (min and median of N).
    """
    import jax
    import jax.numpy as jnp
    import numpy as np
    from scipy.spatial.transform import Rotation

    from visma_tpu.align.icp import icp
    from visma_tpu.align.registration import register_scenes
    from visma_tpu.align.voxel import voxel_downsample
    from visma_tpu.eval.metrics import _pm_dist, compute_error_metric
    from visma_tpu.eval.sampling import sample_mesh
    from visma_tpu.io.procedural import bench_mesh_db

    rng = np.random.default_rng(11)
    db = bench_mesh_db()
    Vc, Fc = db["chair"]
    Vd, Fd = db["desk"]

    # GT scene: chair + desk at poses; result scene: slightly perturbed
    def place(V, T):
        return np.asarray(V) @ T[:3, :3].T + T[:3, 3]

    T1 = np.eye(4)
    T1[:3, :3] = Rotation.from_euler("y", 0.4).as_matrix()
    T1[:3, 3] = [-0.8, 0.0, 2.5]
    T2 = np.eye(4)
    T2[:3, 3] = [0.8, 0.0, 3.0]
    Vt = np.concatenate([place(Vc, T1), place(Vd, T2)])
    Ft = np.concatenate([np.asarray(Fc), np.asarray(Fd) + len(Vc)])
    dT = np.eye(4)
    dT[:3, :3] = Rotation.from_euler("y", 0.01).as_matrix()
    dT[:3, 3] = [0.01, -0.005, 0.008]
    Vs = place(Vt, dT)

    out = {}

    # --- surface error: 500k samples vs the 10.1k-face scene mesh ---
    n_samp = 500_000
    pts = sample_mesh(Vs, Ft, n_samp, seed=0)
    V_d = jnp.asarray(Vt, jnp.float32)
    F_d = jnp.asarray(Ft, jnp.int32)
    A, B, C = V_d[F_d[:, 0]], V_d[F_d[:, 1]], V_d[F_d[:, 2]]
    P_d = jnp.asarray(pts, jnp.float32)
    jax.block_until_ready((A, P_d))
    times = timed_ms(lambda: _pm_dist(P_d, A, B, C, 1024), reps=3)
    m = compute_error_metric(np.sqrt(np.asarray(_pm_dist(P_d, A, B, C,
                                                         1024))))
    out["surface_500k_x10k_faces"] = ms_stats(times)
    out["surface_mean_m"] = m.mean
    log(f"eval: surface error 500k samples x {len(Ft)} faces: "
        f"{out['surface_500k_x10k_faces']} (mean {m.mean*100:.2f} cm)")

    # --- ICP at the reference operating point ---
    model_pts = sample_mesh(Vc, Fc, 50_000, seed=1)
    scan = place(model_pts, T1) + rng.normal(0, 0.004, (50_000, 3))
    dTi = np.eye(4)
    dTi[:3, :3] = Rotation.from_euler("y", 0.03).as_matrix()
    dTi[:3, 3] = [0.02, -0.01, 0.015]
    src = place(model_pts, dTi @ T1)
    cap = 8192
    s_dn, s_ok = voxel_downsample(jnp.asarray(src, jnp.float32), 0.05,
                                  max_out=cap)
    t_dn, t_ok = voxel_downsample(jnp.asarray(scan, jnp.float32), 0.05,
                                  max_out=cap)
    jax.block_until_ready((s_dn, t_dn))
    def run_icp():
        return icp(s_dn, t_dn, max_distance=0.075, max_iters=30,
                   source_valid=s_ok, target_valid=t_ok)

    res = run_icp()
    times = []
    for _ in range(5):
        t = time.perf_counter()
        res = run_icp()
        times.append((time.perf_counter() - t) * 1e3)
    out["icp_50k_voxel0.05"] = ms_stats(times)
    out["icp_fitness"] = res.fitness
    log(f"eval: ICP (voxel 0.05, 50k samples, 30 iters): "
        f"{out['icp_50k_voxel0.05']}, fitness {res.fitness:.3f}, "
        f"rmse {res.inlier_rmse*100:.2f} cm")
    assert res.fitness > 0.9, f"ICP fitness gate failed: {res.fitness}"

    # --- RegisterScenes pair proposals (host) ---
    objs_t = {}
    objs_s = {}
    T_off = np.eye(4)
    T_off[:3, :3] = Rotation.from_euler("z", 0.3).as_matrix()
    T_off[:3, 3] = [0.5, -0.2, 0.1]
    for i in range(5):
        T = np.eye(4)
        T[:3, :3] = Rotation.from_euler("y", rng.uniform(0, 6)).as_matrix()
        T[:3, 3] = rng.uniform(-2, 2, 3)
        objs_t[i] = {"name": "chair" if i % 2 else "desk", "pose": T}
        objs_s[i] = {"name": objs_t[i]["name"], "pose": T_off @ T}
    t = time.perf_counter()
    T_est, matches = register_scenes(objs_t, objs_s, threshold=0.5)
    out["register_scenes_5obj_ms"] = (time.perf_counter() - t) * 1e3
    assert len(matches) == 5, f"register_scenes found {len(matches)}/5"
    log(f"eval: RegisterScenes 5x5 proposals: "
        f"{out['register_scenes_5obj_ms']:.1f} ms, {len(matches)}/5 matched")
    return out


def bench_filter_only():
    """The filter alone on pre-packed feature tracks (Msckf.run).
    Gate: ATE < 0.10 m."""
    import jax.numpy as jnp
    import numpy as np

    from visma_tpu.filter import FilterConfig, Msckf
    from visma_tpu.filter.feed import pack_frames
    from visma_tpu.io.synthetic import (SyntheticConfig, make_dataset,
                                        make_imu, make_trajectory)

    syn = SyntheticConfig(num_frames=N_FRAMES, num_landmarks=200,
                          pixel_noise=0.5, seed=7)
    cfg = FilterConfig(window=8, max_tracks=96, max_updates=24,
                       fx=syn.fx, fy=syn.fy, cx=syn.cx, cy=syn.cy,
                       pixel_noise=0.5)
    ds = make_dataset(syn)
    imu = make_imu(syn)
    frames = {k: jnp.asarray(v)
              for k, v in pack_frames(cfg, ds, imu, max_feats=96).items()
              if k != "ts"}
    _, gwc = make_trajectory(syn)

    kf = Msckf(cfg)
    s0 = kf.init(R0=gwc[0, :, :3], p0=gwc[0, :, 3], v0=imu["v0"])

    t0 = time.time()
    _, outs = kf.run(s0, frames)
    outs["p"].block_until_ready()
    log(f"filter compile+first run: {time.time() - t0:.1f}s")

    ate = float(np.sqrt(np.mean(
        np.sum((np.asarray(outs["p"]) - gwc[:, :, 3]) ** 2, axis=1))))
    assert ate < 0.10, f"accuracy gate failed: filter ATE {ate:.3f} m"

    times = timed_ms(lambda: kf.run(s0, frames)[1]["p"], reps=5)
    fps = syn.num_frames / (min(times) / 1e3)
    log(f"filter-only ATE {ate * 100:.2f} cm, {fps:.1f} frames/s")
    return {"ate_m": ate, "frames_per_s": fps,
            "run_ms": ms_stats(times), "frames": syn.num_frames}


def device_info():
    """The device as JAX reports it, the card's name and power limit as
    nvidia-smi reports them, and XLA_FLAGS."""
    import subprocess

    import jax

    d = jax.devices()[0]
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"unavailable ({e})"
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices()), "jax": jax.__version__,
            "xla_flags": os.environ.get("XLA_FLAGS", ""), "nvidia_smi": smi}


def main():
    import jax

    dev = device_info()
    log(f"device: {dev}")
    if jax.devices()[0].platform != "gpu":
        log("bench.py measures the GPU; no GPU found")
        sys.exit(2)
    print(json.dumps({
        "device": dev,
        "pipeline": bench_pipeline(),
        "frontend": bench_frontend(),
        "semantic": bench_semantic(),
        "eval": bench_eval(),
        "filter_only": bench_filter_only(),
    }))


if __name__ == "__main__":
    main()
