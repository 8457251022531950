"""Object-level semantic mapping over a VISMA sequence — the papers' main
loop, whose OUTPUT the reference repo consumes as `result.json`
(evaluation.cpp:163-198; README.md:141 describes the format).

Per frame: detections spawn object tracks (detection-driven CAD retrieval
when the bbox carries no shape_id), tracks refine with CEM over batched
edge-likelihood renders, occlusion-aware when several objects overlap;
the per-timestamp object sets are written as a reference-compatible
result.json that `evaluate` (QuantitativeEvaluation parity) ingests.

Modes:
  --dataroot DIR --models DIR   real sequence (dataset + *.edge + *.bbox)
                                with a CAD database of .obj/.ply meshes
  --synthetic N                 built-in demo scene: two CAD models on a
                                small orbit, ground-truth edges rendered
                                on the fly; reports recovered pose error
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np


def _mesh_db(models_dir: str):
    from visma_tpu.io.mesh import load_mesh

    db = {}
    for f in sorted(os.listdir(models_dir)):
        stem, ext = os.path.splitext(f)
        if ext.lower() in (".obj", ".ply"):
            db[stem] = load_mesh(os.path.join(models_dir, f))
    return db


def _demo_meshes():
    """Two distinguishable CAD stand-ins (same construction as the test
    fixtures): an asymmetric L and a flat box."""
    def cube(s):
        V = np.array([[x, y, z] for x in (-s, s) for y in (-s, s)
                      for z in (-s, s)], np.float32) * 0.5
        F = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
                      [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
                      [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]],
                     np.int32)
        return V, F

    V1, F1 = cube(1.0)
    V1 = V1 * np.array([0.25, 0.6, 0.25], np.float32)
    V2, F2 = cube(1.0)
    V2 = V2 * np.array([0.45, 0.15, 0.2], np.float32) + \
        np.array([0.35, -0.2, 0.0], np.float32)
    lmesh = (np.concatenate([V1, V2]).astype(np.float32),
             np.concatenate([F1, F2 + len(V1)]).astype(np.int32))
    Vb, Fb = cube(1.0)
    box = (Vb * np.array([0.2, 0.35, 0.2], np.float32), Fb)
    return {"lchair": lmesh, "box": box}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataroot", default=None)
    ap.add_argument("--models", default=None, help="CAD mesh directory")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="run the N-frame built-in demo scene")
    ap.add_argument("--output", default="result.json")
    ap.add_argument("--depth-prior", type=float, default=2.0)
    ap.add_argument("--cem-iters", type=int, default=5)
    ap.add_argument("--cem-samples", type=int, default=48)
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--roi", type=int, nargs=2, default=None,
                    metavar=("ROWS", "COLS"),
                    help="render+score settled tracks in a fixed window "
                         "of this size around each object instead of the "
                         "full frame (exact while footprints fit; large "
                         "speedup at VISMA resolution)")
    ap.add_argument("--roi-spawn", action="store_true",
                    help="refine fresh detection spawns inside the ROI "
                         "window too (depth-from-height init bounds the "
                         "error; skips the full-frame executor)")
    ap.add_argument("--settled", type=int, nargs=2, default=None,
                    metavar=("ITERS", "SAMPLES"),
                    help="annealed schedule once all tracks settle "
                         "(e.g. 3 24); sigma anneals to (0.05, 0.03)")
    ap.add_argument("--async-frames", type=int, default=0,
                    help="device-resident settled steady state: pipeline "
                         "one fused dispatch per frame, sync the host "
                         "mirror every N frames (see SemanticMapper)")
    ap.add_argument("--warmup-objects", type=int, default=0,
                    help="AOT-compile the executor variants for this "
                         "many objects before the first frame")
    args = ap.parse_args(argv)

    import jax.numpy as jnp

    from visma_tpu.render import Intrinsics, Renderer
    from visma_tpu.semantic import SemanticMapper

    if args.synthetic:
        from visma_tpu.proto import BoundingBox, BoundingBoxList

        intr = Intrinsics(fx=150.0, fy=150.0, cx=79.5, cy=59.5,
                          rows=120, cols=160, z_near=0.05, z_far=10.0)
        db = _demo_meshes()
        mapper = SemanticMapper(intr, db, depth_prior=args.depth_prior,
                                cem_iters=args.cem_iters,
                                cem_samples=args.cem_samples,
                                roi=args.roi,
                                roi_spawn=args.roi_spawn,
                                settled_iters=(args.settled[0] if args.settled
                                               else None),
                                settled_samples=(args.settled[1]
                                                 if args.settled else None),
                                settled_sigma=((0.05, 0.03) if args.settled
                                               else None),
                                async_frames=args.async_frames)

        # ground truth: the L-mesh 2 m ahead, slightly off-axis
        true_T = np.eye(4)
        true_T[:3, 3] = [0.1, -0.05, 2.0]
        gt_renderer = Renderer(intr)
        gt_renderer.set_mesh(*db["lchair"])

        N = args.synthetic
        for i in range(N):
            # camera strafes slowly; world pose of frame i
            gwc = np.hstack([np.eye(3),
                             np.array([[0.02 * i], [0.0], [0.0]])])
            G_cw = np.eye(4)
            G_cw[:3, :3] = gwc[:, :3].T
            G_cw[:3, 3] = -gwc[:, :3].T @ gwc[:, 3]
            pose_cm = (G_cw @ true_T)[:3, :4]
            edges = np.asarray(gt_renderer.render_edge(
                jnp.asarray(pose_cm.astype(np.float32))))
            bl = None
            if i == 0:  # single detection, no shape_id -> retrieval path
                # tight detector-style bbox from the frame's edges: the
                # spawn depth comes from the bbox height
                ys, xs = np.nonzero(edges > 0.2)
                bl = BoundingBoxList(bounding_boxes=[BoundingBox(
                    top_left_x=float(xs.min()), top_left_y=float(ys.min()),
                    bottom_right_x=float(xs.max()),
                    bottom_right_y=float(ys.max()), class_name="chair")])
            mapper.step(gwc, edges, bl)

        mapper.write_result_json(args.output)
        tr = next(iter(mapper.tracks.values()))
        err = float(np.linalg.norm(tr.pose_wm[:3, 3] - true_T[:3, 3]))
        print(json.dumps({"frames": N, "tracks": len(mapper.tracks),
                          "model": tr.model_name,
                          "pos_err_m": round(err, 4),
                          "result": args.output}))
        return

    if not args.dataroot or not args.models:
        ap.error("--dataroot and --models required (or --synthetic N)")

    from visma_tpu.io import VlslamDatasetLoader

    loader = VlslamDatasetLoader(args.dataroot)
    cam = loader.grab_camera_info()
    p = np.asarray(cam.parameters)
    intr = Intrinsics(fx=float(p[0]), fy=float(p[1]), cx=float(p[2]),
                      cy=float(p[3]), rows=cam.rows, cols=cam.cols,
                      z_near=0.05, z_far=10.0)
    db = _mesh_db(args.models)
    mapper = SemanticMapper(intr, db, depth_prior=args.depth_prior,
                            cem_iters=args.cem_iters,
                            cem_samples=args.cem_samples, roi=args.roi,
                            roi_spawn=args.roi_spawn,
                            settled_iters=(args.settled[0] if args.settled
                                           else None),
                            settled_samples=(args.settled[1]
                                             if args.settled else None),
                            settled_sigma=((0.05, 0.03) if args.settled
                                           else None),
                            async_frames=args.async_frames)

    if args.warmup_objects:
        mapper.warmup(args.warmup_objects)
    n = len(loader)
    if args.max_frames:
        n = min(n, args.max_frames)
    for i in range(n):
        fr = loader.grab(i, load_image=False)
        if fr.edgemap is None:
            continue
        mapper.step(fr.gwc, fr.edgemap, fr.bboxlist)

    mapper.write_result_json(args.output)
    print(json.dumps({"frames": n, "tracks": len(mapper.tracks),
                      "result": args.output}))


if __name__ == "__main__":
    main()
