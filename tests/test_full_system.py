"""FULL-SYSTEM integration: the reference's complete workflow on one
synthetic scene, crossing every seam through the real wire formats.

    images + IMU
      --(run_vio --images: pyramid/KLT/detect/MSCKF)-->
    ESTIMATED-trajectory vlslam dataset (real drift, not GT)
      + .edge / .bbox side files + a CAD .obj database
      --(run_semantic: spawn + fused joint CEM, 2 objects)-->
    result.json object poses (evaluation.cpp:163-198 layout)
      + fragments/alignment.json + test.klg.ply pseudo-GT cloud
      --(quantitative_evaluation: RegisterScenes -> ICP ->
         {surface,translation,rotation}_error.json,
         evaluation.cpp:276-364)-->
    end-game metric JSONs, gated.

This is the chain the reference repo documents as its usage workflow
(README.md:99-123): a VIO front produces dataset gwc (dataloader.cpp),
the semantic mapper consumes it with per-frame edge maps + detections,
and the evaluation tool ingests result.json against an RGB-D pseudo-GT
scene. Every artifact here passes through the on-disk formats — nothing
is handed over in memory. Two objects are planted so scene registration
is over-constrained: with a single object the alignment would absorb the
mapper's entire pose error and the final metrics would be vacuous.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

from visma_tpu.image.edges import depth_edge
from visma_tpu.io.mesh import save_obj, save_ply
from visma_tpu.io.procedural import box_mesh, merge_meshes
from visma_tpu.io.synthetic import SyntheticConfig, make_dataset, make_imu
from visma_tpu.io.synthetic_images import render_adversarial_frames
from visma_tpu.proto import BoundingBox, BoundingBoxList, EdgeMap
from visma_tpu.render import Intrinsics, Renderer


def _stamp(ts: float) -> str:
    """VISMA-style microsecond filename stamp (loader sorts by these)."""
    return f"{1520535100000000 + int(round(ts * 1e6)):d}"


def _cart_mesh():
    """Small asymmetric second object: base slab + off-center tower +
    side plank (no yaw symmetry, ~300 faces — cheap for the CPU tile
    rasterizer)."""
    parts = [
        box_mesh(0.34, 0.1, 0.26, subdiv=2, center=(0.0, -0.1, 0.0)),
        box_mesh(0.12, 0.3, 0.12, subdiv=2, center=(-0.08, 0.1, 0.02)),
        box_mesh(0.05, 0.16, 0.2, subdiv=1, center=(0.13, 0.0, -0.04)),
    ]
    return merge_meshes(parts)


def _pose_err(pose34, T_wm):
    t_err = float(np.linalg.norm(pose34[:, 3] - T_wm[:3, 3]))
    cosang = (np.trace(pose34[:, :3] @ T_wm[:3, :3].T) - 1.0) / 2.0
    r_err = float(np.degrees(np.arccos(np.clip(cosang, -1.0, 1.0))))
    return t_err, r_err


@pytest.mark.slow
def test_images_to_result_json_to_metrics(tmp_path, capsys):
    cv2 = pytest.importorskip("cv2")

    from visma_tpu.cli import run_semantic, run_vio
    from visma_tpu.cli.run_semantic import _demo_meshes

    cfg = SyntheticConfig(num_frames=24, rows=120, cols=160,
                          fx=150.0, fy=150.0, cx=79.5, cy=59.5,
                          num_landmarks=150, seed=5)
    # adversarial imagery (sensor noise, textured background, photometric
    # drift, one occluder sweep): the VIO feeding the semantic stage has
    # honest error, not an idealized zero-drift trajectory
    frames, gwc, _ = render_adversarial_frames(cfg, occluders=1)
    ts = np.arange(cfg.num_frames) / cfg.fps

    # ---- plant TWO CAD objects near the orbit's look-target: the
    # asymmetric L-mesh facing the frame-0 camera and the cart mesh a
    # lateral offset away (both in view over the whole orbit segment)
    db = _demo_meshes()
    db["cart"] = _cart_mesh()
    intr = Intrinsics(fx=cfg.fx, fy=cfg.fy, cx=cfg.cx, cy=cfg.cy,
                      rows=cfg.rows, cols=cfg.cols, z_near=0.05,
                      z_far=10.0)
    T_wm1 = np.eye(4)
    T_wm1[:3, :3] = gwc[0][:, :3]
    T_wm1[:3, 3] = [0.0, 0.0, 0.3]
    T_wm2 = np.eye(4)
    T_wm2[:3, :3] = gwc[0][:, :3]
    T_wm2[:3, 3] = [0.55, -0.45, 0.15]
    planted = {"lchair": T_wm1, "cart": T_wm2}

    renderers = {}
    for name in planted:
        r = Renderer(intr)
        r.set_mesh(*db[name])
        renderers[name] = r

    dataroot = tmp_path / "seq"
    dataroot.mkdir()
    edges_by_frame = []
    for i in range(cfg.num_frames):
        G = np.eye(4)
        G[:3, :4] = gwc[i]
        G_inv = np.linalg.inv(G)
        depths = []
        img = frames[i].copy()
        for shade, (name, T_wm) in zip((210.0, 60.0), planted.items()):
            pose_cm = (G_inv @ T_wm)[:3, :4].astype(np.float32)
            d = np.asarray(renderers[name].render_depth(
                jnp.asarray(pose_cm)))
            assert np.isfinite(d).any(), f"{name} out of view at frame {i}"
            depths.append(d)
        joint = np.minimum(depths[0], depths[1])
        # matte silhouettes composited by depth: occludes blobs behind
        for shade, d in zip((210.0, 60.0), depths):
            img[np.isfinite(d) & (d <= joint)] = shade
        cv2.imwrite(str(dataroot / (_stamp(ts[i]) + ".png")),
                    np.clip(img, 0, 255).astype(np.uint8))
        edges_by_frame.append(np.asarray(
            depth_edge(jnp.asarray(joint)), np.float32))

    ds = make_dataset(cfg)
    (dataroot / "dataset").write_bytes(ds.encode())
    imu = make_imu(cfg)
    np.savez(tmp_path / "imu.npz", ts=imu["ts"], gyro=imu["gyro"],
             accel=imu["accel"], v0=imu["v0"])

    # ---- stage 1: images + IMU -> VIO -> estimated-trajectory dataset
    est = tmp_path / "est"
    run_vio.main(["--dataroot", str(dataroot),
                  "--imu", str(tmp_path / "imu.npz"),
                  "--images", "--output", str(est)])
    out_lines = [ln for ln in capsys.readouterr().out.strip().splitlines()
                 if ln.startswith("{")]
    report = json.loads(out_lines[0])
    assert report["ate_rmse_m"] < 0.05, report  # the fed dataset is REAL VIO

    # ---- stage 2: side files for the semantic pass, NEXT TO the
    # ESTIMATED dataset (packets cover frames 1..N-1; the loader pairs
    # side files to packets by sorted index)
    from visma_tpu.io import VlslamDatasetLoader

    for i in range(1, cfg.num_frames):
        e = edges_by_frame[i]
        em = EdgeMap(rows=e.shape[0], cols=e.shape[1], data=e.ravel())
        (est / (_stamp(ts[i]) + ".edge")).write_bytes(em.encode())

    # detector output at the first semantic frame: bboxes of the TRUE
    # projected object centers with detector-like imprecision
    G1 = np.eye(4)
    G1[:3, :4] = gwc[1]
    G1_inv = np.linalg.inv(G1)
    boxes, depths_c = [], []
    for jitter, (name, T_wm) in zip(((4.0, -3.0), (-3.0, 2.0)),
                                    planted.items()):
        c_c = (G1_inv @ T_wm)[:3, 3]
        u = cfg.fx * c_c[0] / c_c[2] + cfg.cx + jitter[0]
        v = cfg.fy * c_c[1] / c_c[2] + cfg.cy + jitter[1]
        assert 10 < u < cfg.cols - 10 and 10 < v < cfg.rows - 10, (name, u, v)
        boxes.append(BoundingBox(
            top_left_x=float(u - 20), top_left_y=float(v - 20),
            bottom_right_x=float(u + 20), bottom_right_y=float(v + 20),
            scores=np.array([0.9], np.float32), class_name=name,
            shape_id=name))
        depths_c.append(float(c_c[2]))
    bl = BoundingBoxList(bounding_boxes=boxes)
    (est / (_stamp(ts[1]) + ".bbox")).write_bytes(bl.encode())

    models = tmp_path / "models"
    models.mkdir()
    for name, (Vm, Fm) in db.items():
        save_obj(str(models / f"{name}.obj"), Vm, Fm)

    # ---- stage 3: semantic mapping over the ESTIMATED trajectory
    result = tmp_path / "result.json"
    run_semantic.main(["--dataroot", str(est), "--models", str(models),
                       "--output", str(result),
                       "--depth-prior",
                       f"{float(np.mean(depths_c)) * 1.03:.3f}",
                       "--cem-iters", "4", "--cem-samples", "32"])
    sem_report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sem_report["tracks"] == 2, sem_report

    # ---- stage 4: result.json carries the reference layout and the
    # recovered model->world poses match the planted ground truth
    packets = json.loads(result.read_text())
    assert len(packets) == cfg.num_frames - 1
    objs = {o["model_name"]: o for o in packets[-1]}
    assert set(objs) == set(planted), objs.keys()
    for name, T_wm in planted.items():
        pose = np.asarray(objs[name]["model_pose"],
                          np.float64).reshape(3, 4)
        t_err, r_err = _pose_err(pose, T_wm)
        assert t_err < 0.10, (name, t_err, r_err)
        assert r_err < 10.0, (name, t_err, r_err)

    # the estimated dataset itself must remain loader-consumable with the
    # side files attached (reference Grab semantics, dataloader.cpp:92-134)
    loader = VlslamDatasetLoader(str(est))
    fr = loader.grab(0, load_image=False)
    assert fr.edgemap is not None and fr.bboxlist is not None
    assert fr.edgemap.shape == (cfg.rows, cfg.cols)

    # ---- stage 5: the reference's END GAME (evaluation.cpp:276-364) on
    # the mapper's own output: result.json + pseudo-GT RGB-D scene ->
    # RegisterScenes -> ICP -> {surface,translation,rotation}_error.json.
    # The pseudo-GT scene lives in its own "EF" frame (a deliberate rigid
    # offset from the corvis/world frame, as RGB-D fragments are), so the
    # alignment stage has real work to do.
    from scipy.spatial.transform import Rotation

    from visma_tpu.eval.evaluate import quantitative_evaluation
    from visma_tpu.eval.sampling import sample_mesh

    scene_dir = tmp_path / "eval" / "scene1"
    fragment_dir = scene_dir / "fragments"
    fragment_dir.mkdir(parents=True)
    (scene_dir / "result.json").write_text(result.read_text())

    T_ef = np.eye(4)
    T_ef[:3, :3] = Rotation.from_euler("xyz", [0.06, -0.1, 0.2]).as_matrix()
    T_ef[:3, 3] = [0.3, -0.2, 0.15]

    alignment = {}
    cloud_pts = []
    rng = np.random.default_rng(11)
    for k, (name, T_wm) in enumerate(planted.items()):
        T_gt_ef = T_ef @ T_wm
        alignment[f"{name}_{k}"] = [float(x)
                                    for x in T_gt_ef[:3, :4].reshape(-1)]
        V, F = db[name]
        pts = sample_mesh(V, F, 20000) @ T_gt_ef[:3, :3].T + T_gt_ef[:3, 3]
        cloud_pts.append(pts + rng.normal(0.0, 0.003, pts.shape))
    (fragment_dir / "alignment.json").write_text(json.dumps(alignment))
    save_ply(str(scene_dir / "test.klg.ply"),
             np.concatenate(cloud_pts).astype(np.float32))

    config = {
        "dataroot": str(tmp_path / "eval"),
        "dataset": "scene1",
        "CAD_database_root": str(models),
        "visualization": {"model_samples": 4000},
        "evaluation": {"ICP_refinement": True, "max_distance": 0.075,
                       "voxel_size": 0.05, "samples_per_model": 20000,
                       "use_point_to_plane": False},
    }
    metrics = quantitative_evaluation(config)

    # gates: registration + ICP must land the mapper's scene inside the
    # reference's own matching radius; per-object residuals reflect REAL
    # mapper error (2 objects -> the transform cannot absorb it)
    assert metrics["translation"]["max"] < 0.15, metrics
    assert metrics["rotation"]["max"] < 15.0, metrics
    assert metrics["surface"]["mean"] < 0.05, metrics
    for name in ("surface_error.json", "translation_error.json",
                 "rotation_error.json", "result_alignment.json"):
        assert (scene_dir / name).exists(), name
