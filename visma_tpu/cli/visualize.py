"""Visualize a sequence: camera trajectory + INSTATE point cloud +
optional result.json objects (reference parity: VisualizeResult,
src/visualization.cpp:226-313 — Open3D's live window replaced by two
headless exports: a static 3-D matplotlib figure, and `--animate DIR`, an
animated per-frame overlay render (object edges rasterized by the repo's
own TPU rasterizer at each frame's camera pose, plus the INSTATE feature
observations) written as PNG frames + an mp4 when the cv2 codec allows —
the full capability of the interactive window in exported form."""
from __future__ import annotations

import argparse
import os

import numpy as np

# per-object BGR overlay colors (cycled)
_COLORS = [(0, 64, 255), (0, 200, 0), (255, 128, 0), (200, 0, 200),
           (0, 220, 220), (255, 0, 96)]


def _animate(loader, result, mesh_db, out_dir: str, max_frames: int,
             feature_dots: bool = True) -> int:
    """Per-frame overlay renders: each result.json packet's objects are
    rasterized (edge maps, render.raster.MultiMeshRenderer — one dispatch
    per frame covering all objects) at that frame's camera pose and
    alpha-blended onto the frame image; INSTATE/GOODDROP feature pixels
    drawn as dots (the reference window's point cloud, in image space).
    Returns the number of frames written."""
    import cv2
    import jax.numpy as jnp

    from visma_tpu.io.json_io import matrix_from_json
    from visma_tpu.proto import FeatureStatus
    from visma_tpu.render import Intrinsics
    from visma_tpu.render.raster import MultiMeshRenderer

    cam = loader.grab_camera_info()
    p = np.asarray(cam.parameters)
    intr = Intrinsics(fx=float(p[0]), fy=float(p[1]), cx=float(p[2]),
                      cy=float(p[3]), rows=cam.rows, cols=cam.cols,
                      z_near=0.05, z_far=10.0)
    mr = MultiMeshRenderer(intr)
    mr.set_meshes(mesh_db)

    os.makedirs(out_dir, exist_ok=True)
    n = min(len(loader), max_frames or len(loader))
    writer = None
    video_path = os.path.join(out_dir, "overlay.mp4")
    try:
        writer = cv2.VideoWriter(video_path,
                                 cv2.VideoWriter_fourcc(*"mp4v"), 15.0,
                                 (cam.cols, cam.rows))
        if not writer.isOpened():
            writer = None
    except Exception:
        writer = None

    for i in range(n):
        fr = loader.grab(i)
        img = fr.image
        if img is None:
            img = np.full((cam.rows, cam.cols, 3), 32, np.uint8)
        img = img.copy()

        # result.json is a list of per-timestamp packets; hold the last
        # packet once the sequence outruns it (evaluation.cpp:163 reads
        # only the final packet — the animation plays the whole history)
        packet = result[min(i, len(result) - 1)] if result else []
        if packet:
            G = np.eye(4)
            G[:3, :4] = fr.gwc
            G_cw = np.linalg.inv(G)
            poses, midx, colors = [], [], []
            for obj in packet:
                name = obj["model_name"]
                if name not in mesh_db:
                    continue
                T_wm = np.eye(4)
                T_wm[:3, :4] = matrix_from_json(obj, "model_pose", 3, 4)
                poses.append((G_cw @ T_wm)[:3, :4])
                midx.append(mr.index(name))
                colors.append(_COLORS[int(obj.get("id", 0)) % len(_COLORS)])
            if poses:
                edges = np.asarray(mr.render_edge(
                    jnp.asarray(np.stack(poses), jnp.float32),
                    jnp.asarray(np.array(midx, np.int32))))
                for e, c in zip(edges, colors):
                    a = np.clip(e, 0.0, 1.0)[:, :, None]
                    img = (img * (1 - 0.85 * a)
                           + 0.85 * a * np.array(c)[None, None, :]
                           ).astype(np.uint8)

        if feature_dots and i < len(loader.dataset.packets):
            for f in loader.dataset.packets[i].features:
                if len(f.xp) >= 2 and f.status in (
                        FeatureStatus.INSTATE, FeatureStatus.GOODDROP):
                    cv2.circle(img, (int(f.xp[0]), int(f.xp[1])), 2,
                               (0, 255, 255), -1)

        cv2.imwrite(os.path.join(out_dir, f"overlay_{i:06d}.png"), img)
        if writer is not None:
            writer.write(img)
    if writer is not None:
        writer.release()
        print(f"wrote {video_path}")
    return n


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("dataroot")
    ap.add_argument("--result-index", type=int, default=-1,
                    help="which result.json packet to overlay (default last)")
    ap.add_argument("--cad-root", default=None)
    ap.add_argument("--output", default="scene.png")
    ap.add_argument("--model-samples", type=int, default=2000)
    ap.add_argument("--animate", default=None, metavar="DIR",
                    help="export an animated per-frame overlay render "
                         "(PNG sequence + mp4) via the TPU rasterizer")
    ap.add_argument("--max-frames", type=int, default=0)
    args = ap.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from visma_tpu.io import VlslamDatasetLoader
    from visma_tpu.proto import FeatureStatus

    loader = VlslamDatasetLoader(args.dataroot)
    traj = np.stack([loader.pose(i)[:, 3] for i in range(len(loader))])

    # INSTATE/GOODDROP world points over the sequence
    pts = {}
    for i in range(len(loader)):
        for f in loader.dataset.packets[i].features:
            if f.status in (FeatureStatus.INSTATE, FeatureStatus.GOODDROP) \
                    and len(f.xw) >= 3:
                pts[f.id] = f.xw[:3]
    cloud = np.asarray(list(pts.values())) if pts else np.zeros((0, 3))

    fig = plt.figure(figsize=(10, 8))
    ax = fig.add_subplot(111, projection="3d")
    ax.plot(traj[:, 0], traj[:, 1], traj[:, 2], "b-", lw=2,
            label=f"trajectory ({len(traj)} frames)")
    ax.scatter(traj[0, 0], traj[0, 1], traj[0, 2], c="g", s=60,
               label="start")
    if len(cloud):
        ax.scatter(cloud[:, 0], cloud[:, 1], cloud[:, 2], s=2, c="gray",
                   alpha=0.5, label=f"{len(cloud)} map points")

    result_path = os.path.join(args.dataroot, "result.json")
    if args.cad_root and os.path.exists(result_path):
        from visma_tpu.eval import sample_mesh
        from visma_tpu.io import load_json, load_mesh
        from visma_tpu.io.json_io import matrix_from_json

        packet = load_json(result_path)[args.result_index]
        for obj in packet:
            pose34 = matrix_from_json(obj, "model_pose", 3, 4)
            V, F = load_mesh(os.path.join(args.cad_root,
                                          obj["model_name"] + ".obj"))
            s = sample_mesh(V, F, args.model_samples)
            s = s @ pose34[:, :3].T + pose34[:, 3]
            ax.scatter(s[:, 0], s[:, 1], s[:, 2], s=1,
                       label=f"{obj['model_name']}#{obj['id']}")

    ax.set_xlabel("x"); ax.set_ylabel("y"); ax.set_zlabel("z")
    ax.legend(loc="upper left", fontsize=8)
    plt.tight_layout()
    plt.savefig(args.output, dpi=110)
    print(f"saved {args.output}")

    if args.animate:
        from visma_tpu.io import load_json, load_mesh

        result = []
        if os.path.exists(result_path):
            result = load_json(result_path)
        mesh_db = {}
        if args.cad_root:
            names = {obj["model_name"] for pk in result for obj in pk}
            for name in sorted(names):
                for ext in (".obj", ".ply"):
                    path = os.path.join(args.cad_root, name + ext)
                    if os.path.exists(path):
                        mesh_db[name] = load_mesh(path)
                        break
        n = _animate(loader, result, mesh_db, args.animate,
                     args.max_frames)
        print(f"wrote {n} overlay frames to {args.animate}")


if __name__ == "__main__":
    main()
