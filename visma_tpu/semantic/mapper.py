"""Semantic mapper: per-object pose tracks from detections + edge evidence.

Workflow per frame (the papers' object-level mapping loop):
  1. new detections (BoundingBoxList with shape_id) spawn object tracks,
     initialized by back-projecting the bbox center at a depth prior and
     sweeping yaw (annotation-tool idiom);
  2. existing tracks refine their pose against the frame's edge map with
     CEM over batched render+score — ALL tracks jointly: one render+score
     dispatch per CEM iteration covers every track's hypothesis batch
     (render.raster.MultiMeshRenderer over the padded mesh stack), so the
     per-frame dispatch count is O(1) in the number of objects;
  3. tracks export as reference-compatible result.json packets
     (model_pose is model->WORLD, composed through the frame's gwc —
     matching MeshAlignment's "ALREADY IN CORVIS FRAME" convention,
     evaluation.cpp:194).

Occlusion handling: each track's hypotheses score against the joint
z-buffer of the OTHER tracks at their poses at the START of the frame
(one batched render). The r1 implementation instead settled tracks
sequentially front-to-back, updating occluders as it went — one dispatch
chain per object; the joint refinement converges
to the same poses over the 2-3 frames a track takes to settle while
keeping the frame cost flat in object count.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from visma_tpu.render import Intrinsics
from visma_tpu.render.raster import MultiMeshRenderer
from visma_tpu.semantic.cem import refine_pose_cem_batched


@dataclass
class ObjectTrack:
    oid: int
    model_name: str
    pose_wm: np.ndarray              # (4,4) model -> world
    score: float = np.inf
    age: int = 0
    status: int = 2                  # reference result.json status int


class SemanticMapper:
    def __init__(self, intr: Intrinsics, mesh_db: Dict[str, tuple],
                 depth_prior: float = 2.0, cem_iters: int = 5,
                 cem_samples: int = 48, retrieval_yaws: int = 12,
                 azimuth_prior_weight: float = 1.0,
                 roi: Optional[tuple] = None,
                 init_sigma: tuple = (0.15, 0.08),
                 settle_age: int = 2,
                 settled_iters: Optional[int] = None,
                 settled_samples: Optional[int] = None,
                 settled_sigma: Optional[tuple] = None,
                 async_frames: int = 0,
                 coverage_radius: int = 2,
                 roi_spawn: bool = False):
        """mesh_db: model_name -> (V, F).

        retrieval_yaws / azimuth_prior_weight control detection-driven
        shape retrieval (see retrieve_shape). roi: optional (Hr, Wr)
        screen window for CEM render+score of SETTLED tracks (age >= 1;
        fresh spawns refine full-frame since their init error can exceed
        the window margin) — per-hypothesis cost drops from rows*cols to
        Hr*Wr pixels, exact while footprints stay inside the window.

        Annealed settled schedule: once every track has age >=
        settle_age, the per-frame CEM switches to settled_iters x
        settled_samples at settled_sigma (rot rad, trans m) — a settled
        track only corrects the residual drift since last frame (object
        static in world, camera motion known from the VIO pose), so the
        full spawn-width search is wasted work. Leave the settled_*
        parameters None to disable annealing.

        async_frames > 0 enables DEVICE-RESIDENT steady state: once all
        tracks are settled (ROI mode, no new detections), track poses
        stay on the device, each frame enqueues one fused CEM dispatch
        without waiting for the previous one, and the host mirror
        (ObjectTrack.pose_wm / score / result packets) refreshes every
        `async_frames` frames or at finalize(). A per-frame host<->device
        sync would serialize dispatches; pipelining them hides it.
        Call finalize() (write_result_json does) before reading poses."""
        self.intr = intr
        self.mesh_db = mesh_db
        self.depth_prior = depth_prior
        self.cem_iters = cem_iters
        self.cem_samples = cem_samples
        self.retrieval_yaws = retrieval_yaws
        self.azimuth_prior_weight = azimuth_prior_weight
        self.roi = None if roi is None else (int(roi[0]), int(roi[1]))
        self.init_sigma = (float(init_sigma[0]), float(init_sigma[1]))
        self.settle_age = int(settle_age)
        self.settled_iters = settled_iters
        self.settled_samples = settled_samples
        self.settled_sigma = (None if settled_sigma is None else
                              (float(settled_sigma[0]),
                               float(settled_sigma[1])))
        # coverage dilation radius (px) of the edge score: the score is
        # flat over ~radius px of silhouette-scale slack, which maps to a
        # depth slack of ~z*radius/footprint_px per object — radius=1
        # halves the along-ray error the diagnostic decomposition showed
        # dominating every object (tools/diag_semantic.py)
        self.coverage_radius = int(coverage_radius)
        # roi_spawn: refine FRESH spawns in the ROI window too (age-0
        # tracks normally go full-frame since their init error can exceed
        # the window margin). Safe when spawns come from detections with
        # depth-from-height init (error bounded ~0.15 m << window margin)
        # — and it removes the full-frame CEM executor entirely (one
        # fewer jit variant to compile; the spawn frame rasters ~5x
        # fewer pixels).
        self.roi_spawn = bool(roi_spawn)
        self.tracks: Dict[int, ObjectTrack] = {}
        self.mrenderer = MultiMeshRenderer(intr)
        self._mesh_aabb: Dict[str, tuple] = {}
        if mesh_db:
            self.mrenderer.set_meshes(mesh_db)
            self._mesh_aabb = {
                n: (np.asarray(V, np.float64).min(0),
                    np.asarray(V, np.float64).max(0))
                for n, (V, _) in mesh_db.items()}
        self._next_id = 0
        self.history: List = []
        self.async_frames = int(async_frames)
        self._dev: Optional[dict] = None   # device-resident track state
        self._frame_no = 0

    def warmup(self, n_objects: int, occ_modes=("poses",),
               retrieval_candidates: Optional[int] = None,
               max_workers: int = 3) -> float:
        """AOT-compile the CEM/retrieval executors for an `n_objects`
        scene CONCURRENTLY (three XLA compiles in flight overlap most of
        the wall time). The
        executors land in the renderer caches, so the first real frames
        skip straight to execution. Returns elapsed seconds.

        occ_modes: which occlusion variants to warm ("poses" for
        overlapping footprints in ROI mode, "none" for disjoint scenes).
        retrieval_candidates: candidate meshes per detection to warm the
        retrieval executor for (default: the whole database)."""
        import concurrent.futures
        import time as _time

        import jax
        import jax.numpy as jnp

        from visma_tpu.semantic.cem import (CEM_TAU, cem_n_elite,
                                            fused_cem_executor,
                                            retrieval_executor)

        t0 = _time.time()
        n = int(n_objects)
        H, W = self.intr.rows, self.intr.cols
        scheds = [(self.cem_iters, self.cem_samples, self.init_sigma)]
        if self.settled_iters and self.settled_samples:
            scheds.append((self.settled_iters, self.settled_samples,
                           self.settled_sigma or self.init_sigma))
        jobs = []
        for iters, samples, _sig in scheds:
            for mode in occ_modes:
                run = fused_cem_executor(
                    self.intr, CEM_TAU, iters, samples,
                    cem_n_elite(samples), self.roi, mode,
                    self.coverage_radius)
                args = [self.mrenderer.Cs, jnp.zeros((n,), jnp.int32),
                        jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32),
                                         (n, 3, 3)),
                        jnp.zeros((n, 3), jnp.float32),
                        jnp.ones((n, 6), jnp.float32),
                        jnp.zeros((H, W), jnp.float32),
                        jax.random.PRNGKey(0)]
                if mode == "poses":
                    args.append(jnp.zeros((n, 3, 4), jnp.float32))
                elif mode == "depths":
                    args.append(jnp.zeros((n, H, W), jnp.float32))
                jobs.append((run, tuple(args)))
        if self.roi is not None and self.mesh_db:
            mc = retrieval_candidates or len(self.mesh_db)
            B = mc * self.retrieval_yaws
            run = retrieval_executor(self.intr, self.roi, B)
            jobs.append((run, (self.mrenderer.Cs,
                               jnp.zeros((B, 3, 4), jnp.float32),
                               jnp.zeros((B,), jnp.int32),
                               jnp.zeros((2,), jnp.float32),
                               jnp.zeros((H, W), jnp.float32),
                               jnp.zeros((H, W), jnp.float32),
                               jnp.zeros((4,), jnp.float32))))

        def compile_one(job):
            run, args = job
            run.lower(*args).compile()

        with concurrent.futures.ThreadPoolExecutor(max_workers) as ex:
            list(ex.map(compile_one, jobs))
        return _time.time() - t0

    def _init_pose_cm(self, bbox, model_name: Optional[str] = None
                      ) -> np.ndarray:
        """Back-project the detection center at a depth estimate.

        When the model is known, depth comes from the bbox height and the
        model's physical height (z ~ fy * H_model / h_px — monocular
        scale-from-detection; the detection is the papers' own spawn
        signal, vlslam.proto bbox fields); otherwise the static
        depth_prior. The spawn CEM closes the residual."""
        cx = 0.5 * (bbox.top_left_x + bbox.bottom_right_x)
        cy = 0.5 * (bbox.top_left_y + bbox.bottom_right_y)
        h_px = abs(bbox.bottom_right_y - bbox.top_left_y)
        z = self.depth_prior
        c0 = np.zeros(3)
        if model_name in self._mesh_aabb and h_px > 4:
            lo, hi = self._mesh_aabb[model_name]
            c0 = 0.5 * (np.asarray(lo) + hi)   # model AABB center
            # initial pinhole estimate, then Newton-refine against the
            # PROJECTED AABB height: a 3D object's bbox spans more than
            # fy*H/z (front corners sit closer than the centroid), which
            # under-estimated depth by ~15-20% at the bench geometry.
            # Yaw rotation is about y, so the model's y-extent (and this
            # estimate) is yaw-invariant. The AABB CENTER (not the model
            # origin, which can sit far off-center) is what lands on the
            # detection's center ray.
            z = float(np.clip(self.intr.fy * (hi[1] - lo[1]) / h_px,
                              0.3, 0.9 * self.intr.z_far))
            corners = np.array([[x, y, zz] for x in (lo[0], hi[0])
                                for y in (lo[1], hi[1])
                                for zz in (lo[2], hi[2])]) - c0
            for _ in range(3):
                c = corners + [(cx - self.intr.cx) / self.intr.fx * z,
                               (cy - self.intr.cy) / self.intr.fy * z, z]
                zc = np.maximum(c[:, 2], 0.1)
                v = self.intr.fy * c[:, 1] / zc + self.intr.cy
                h_proj = v.max() - v.min()
                z = float(np.clip(z * h_proj / h_px, 0.3,
                                  0.9 * self.intr.z_far))
        X_cam = np.array([(cx - self.intr.cx) / self.intr.fx * z,
                          (cy - self.intr.cy) / self.intr.fy * z, z])
        T_cm = np.eye(4)
        T_cm[:3, 3] = X_cam - c0
        return T_cm

    def retrieve_shape(self, bbox, edge_map, dt=None):
        """Detection-driven CAD retrieval (the papers' detector->shape
        step; the reference only ships its OUTPUT as BoundingBox.shape_id,
        vlslam.proto azimuth/shape fields). For a detection with no usable
        shape_id: score every candidate mesh (class-substring filtered)
        over a yaw sweep at the back-projected detection pose in ONE
        batched render across ALL (mesh, yaw) pairs, with the detection's
        azimuth distribution as a -log prior when present. dt: optionally
        pass a precomputed edge_distance_transform(edge_map) (step()
        shares one across all detections of a frame). When `roi` is set,
        candidates render into a window centered on the detection instead
        of the full frame (~5x fewer pixels; scoring masks coverage to
        the window-clipped bbox, identical argmax semantics). Returns
        (name, pose_cm (4,4), score) or None if the database is empty."""
        import jax.numpy as jnp

        from visma_tpu.render.likelihood import (edge_distance_transform,
                                                 symmetric_edge_score)

        cls = (bbox.class_name or "").lower()
        cands = [n for n in self.mesh_db if cls and cls in n.lower()] \
            or list(self.mesh_db)
        if not cands:
            return None
        B = self.retrieval_yaws
        yaws = np.arange(B) * (2 * np.pi / B)
        # rotate about the model/camera Y axis (same convention as the
        # CEM's yaw_only mode): right-multiply = about the object center
        cs, sn = np.cos(yaws), np.sin(yaws)
        Ry = np.zeros((B, 4, 4))
        Ry[:, 0, 0] = cs
        Ry[:, 0, 2] = sn
        Ry[:, 2, 0] = -sn
        Ry[:, 2, 2] = cs
        Ry[:, 1, 1] = 1.0
        Ry[:, 3, 3] = 1.0
        # per-candidate depth from the bbox height + candidate's physical
        # height (see _init_pose_cm) — candidates of different size test
        # at their own consistent depth. Yaw rotates about each model's
        # AABB CENTER (t = X_cam - Ry @ c0): composing T0 @ Ry would swing
        # an off-center model (e.g. a chair whose origin sits at a leg)
        # off the detection ray as yaw is enumerated.
        T0s = [self._init_pose_cm(bbox, c) for c in cands]
        hyp_list = []
        for c, T0 in zip(cands, T0s):
            lo, hi = self._mesh_aabb.get(
                c, (np.full(3, -0.5), np.full(3, 0.5)))
            c0 = 0.5 * (np.asarray(lo) + hi)
            X_cam = T0[:3, 3] + c0
            h = np.broadcast_to(np.eye(3, 4), (B, 3, 4)).copy()
            h[:, :3, :3] = Ry[:, :3, :3]
            h[:, :3, 3] = X_cam[None] - Ry[:, :3, :3] @ c0
            hyp_list.append(h)
        hyps = np.concatenate(hyp_list)

        # bbox aspect consistency: every candidate is height-fitted to the
        # detection, so a wrong-shape candidate becomes a scale-fitted
        # decoy; the detection's WIDTH is independent evidence. Penalize
        # |log(aspect_proj / aspect_bbox)| per (candidate, yaw) — host
        # arithmetic on 8 AABB corners, no dispatch.
        bb_w = max(abs(bbox.bottom_right_x - bbox.top_left_x), 1e-6)
        bb_h = max(abs(bbox.bottom_right_y - bbox.top_left_y), 1e-6)
        aspect_pen = np.zeros((len(cands), B), np.float32)
        for ci, c in enumerate(cands):
            lo, hi = self._mesh_aabb.get(
                c, (np.full(3, -0.5), np.full(3, 0.5)))
            corners = np.array([[x, y, z] for x in (lo[0], hi[0])
                                for y in (lo[1], hi[1])
                                for z in (lo[2], hi[2])])
            for bi in range(B):
                P = hyp_list[ci][bi]
                pc = corners @ P[:, :3].T + P[:, 3]
                zc = np.maximum(pc[:, 2], 0.1)
                u = self.intr.fx * pc[:, 0] / zc
                v = self.intr.fy * pc[:, 1] / zc
                asp = (u.max() - u.min()) / max(v.max() - v.min(), 1e-6)
                aspect_pen[ci, bi] = 2.0 * abs(
                    np.log(max(asp, 1e-6) / (bb_w / bb_h)))

        prior = np.zeros(B, np.float32)
        ap = np.asarray(bbox.azimuth_prob, np.float32).ravel()
        if ap.size > 0 and self.azimuth_prior_weight > 0:
            p = ap / max(float(ap.sum()), 1e-6)
            bins = np.minimum((yaws / (2 * np.pi) * ap.size).astype(int),
                              ap.size - 1)
            prior = -self.azimuth_prior_weight * np.log(p[bins] + 1e-3)

        em = jnp.asarray(edge_map)
        if dt is None:
            dt = edge_distance_transform(em)
        # coverage LOCAL to the detection: only edges inside the (20%-
        # expanded) bbox count as "this object's" evidence — with several
        # objects in frame, full-frame coverage barely discriminates
        # between candidate meshes (each explains ~1/n of global mass
        # regardless of shape); the chamfer term still uses the full dt
        H, W = self.intr.rows, self.intr.cols
        mx = 0.2 * (bbox.bottom_right_x - bbox.top_left_x)
        my = 0.2 * (bbox.bottom_right_y - bbox.top_left_y)
        x0 = int(np.clip(bbox.top_left_x - mx, 0, W))
        x1 = int(np.clip(bbox.bottom_right_x + mx, 0, W))
        y0 = int(np.clip(bbox.top_left_y - my, 0, H))
        y1 = int(np.clip(bbox.bottom_right_y + my, 0, H))
        idxs = np.array([self.mrenderer.index(n) for n in cands], np.int32)
        Mc = len(cands)
        mi = jnp.asarray(np.repeat(idxs, B))
        hyps_d = jnp.asarray(hyps, jnp.float32)
        mr = self.mrenderer
        if self.roi is not None:
            # window centered on the detection: candidates render into
            # (Hr, Wr) instead of the full frame; the scoring region is
            # the window (same region for every candidate -> same argmax)
            from visma_tpu.semantic.cem import retrieval_executor

            Hr, Wr = self.roi
            cx = 0.5 * (bbox.top_left_x + bbox.bottom_right_x)
            cy = 0.5 * (bbox.top_left_y + bbox.bottom_right_y)
            ox = float(np.clip(round(cx - Wr / 2), 0, W - Wr))
            oy = float(np.clip(round(cy - Hr / 2), 0, H - Hr))
            org1 = jnp.asarray([ox, oy], jnp.float32)
            box = jnp.asarray([x0, y0, x1, y1], jnp.float32)
            run = retrieval_executor(mr.intr, (Hr, Wr), hyps.shape[0])
            scores = np.asarray(run(mr.Cs, hyps_d, mi, org1, dt, em, box)
                                ).reshape(Mc, B) \
                + prior[None, :] + aspect_pen
        else:
            # one full-frame dispatch over all (mesh, yaw) hypotheses
            box_mask = np.zeros((H, W), np.float32)
            box_mask[y0:y1, x0:x1] = 1.0
            em_box = em * jnp.asarray(box_mask)
            edges = mr.render_edge(hyps_d, mi)
            scores = np.asarray(symmetric_edge_score(edges, dt, em_box)
                                ).reshape(Mc, B) \
                + prior[None, :] + aspect_pen
        m, b = np.unravel_index(int(np.argmin(scores)), scores.shape)
        T = np.eye(4)
        T[:3, :4] = hyps[m * B + b]
        return cands[m], T, float(scores[m, b])

    def _spawn(self, bbox, gwc: np.ndarray,
               edge_map=None, dt=None) -> Optional[ObjectTrack]:
        name = bbox.shape_id or bbox.class_name
        if name in self.mesh_db:
            T_cm = self._init_pose_cm(bbox, name)
        elif edge_map is not None:
            got = self.retrieve_shape(bbox, edge_map, dt=dt)
            if got is None:
                return None
            name, T_cm, _ = got
        else:
            return None
        T_wm = np.eye(4)
        T_wm[:3, :4] = gwc @ T_cm
        tr = ObjectTrack(oid=self._next_id, model_name=name, pose_wm=T_wm)
        self._next_id += 1
        self.tracks[tr.oid] = tr
        return tr

    def step(self, gwc: np.ndarray, edge_map: np.ndarray,
             bboxes=None) -> None:
        """gwc (3,4) camera->world; edge_map (H,W) in [0,1]; bboxes
        optional BoundingBoxList for spawning.

        Edge maps may be stored at a different resolution than the camera
        (EdgeMap carries its own rows/cols, vlslam.proto:49-53); resample
        to the render resolution so scores compare pixels to pixels.
        Device-resident edge maps of the right shape pass through without
        a host round-trip (the production path: depth_edge output stays
        on-chip)."""
        H, W = self.intr.rows, self.intr.cols
        if edge_map.shape != (H, W):
            edge_map = np.asarray(edge_map, np.float32)
            ri = (np.arange(H) * edge_map.shape[0] // H).astype(np.int64)
            ci = (np.arange(W) * edge_map.shape[1] // W).astype(np.int64)
            edge_map = edge_map[ri][:, ci]
        gwc = np.asarray(gwc, np.float64)
        G = np.eye(4)
        G[:3, :4] = gwc
        G_cw = np.linalg.inv(G)

        if bboxes is not None:
            # breaking the async steady state: refresh the host mirror
            # first so _covered dedups and spawns against the freshest
            # device-resident poses, not a mirror stale by up to
            # async_frames-1 frames (ADVICE r4 #4)
            self._sync_dev()
            dt = None
            for bb in bboxes.bounding_boxes:
                if not self._covered(bb, gwc):
                    if (dt is None
                            and (bb.shape_id or bb.class_name)
                            not in self.mesh_db):
                        # one distance transform shared by every
                        # retrieval this frame (it depends only on the
                        # observation)
                        import jax.numpy as jnp

                        from visma_tpu.render.likelihood import \
                            edge_distance_transform
                        dt = edge_distance_transform(jnp.asarray(edge_map))
                    self._spawn(bb, gwc, edge_map, dt=dt)

        tracks = list(self.tracks.values())
        if tracks:
            settled = (self.settle_age >= 0 and
                       all(tr.age >= self.settle_age for tr in tracks))
            iters = (self.settled_iters if settled and self.settled_iters
                     else self.cem_iters)
            samples = (self.settled_samples
                       if settled and self.settled_samples
                       else self.cem_samples)
            sigma = (self.settled_sigma if settled and self.settled_sigma
                     else self.init_sigma)
            roi = (self.roi if self.roi_spawn
                   or all(tr.age >= 1 for tr in tracks) else None)

            oids = [tr.oid for tr in tracks]
            can_async = (self.async_frames > 0 and settled
                         and roi is not None and bboxes is None
                         and self._dev is not None
                         and self._dev["oids"] == oids)
            if not can_async:
                # falling back to the sync path while dispatches are
                # pending: pull the device-resident refinements down so
                # CEM re-initializes from them (ADVICE r4 #4)
                self._sync_dev()
            if can_async:
                self._step_async(tracks, G, G_cw, edge_map, iters, samples,
                                 sigma, roi)
            else:
                self._step_sync(tracks, G, G_cw, edge_map, iters, samples,
                                sigma, roi, oids)
        else:
            self.history.append([])
        self._frame_no += 1

    def _step_sync(self, tracks, G, G_cw, edge_map, iters, samples, sigma,
                   roi, oids) -> None:
        import jax.numpy as jnp

        poses_cm = np.stack([(G_cw @ tr.pose_wm)[:3, :4]
                             for tr in tracks]).astype(np.float32)
        mesh_idx = np.array(
            [self.mrenderer.index(tr.model_name) for tr in tracks],
            np.int32)

        need_occ = len(tracks) > 1 and self._footprints_may_overlap(
            poses_cm, [tr.model_name for tr in tracks], sigma)
        occ = occ_poses = None
        if need_occ and roi is not None:
            # ROI mode: occluders render inside each track's window
            # within the SAME fused dispatch — no separate full-frame
            # render (see cem._render_score_nS occ_poses)
            occ_poses = poses_cm
        elif need_occ:
            # full-frame mode (fresh spawns): one dispatch for all
            # current depths + per-track exclusive min over the others
            occ = _exclusive_min_depths(
                self.mrenderer.Cs, jnp.asarray(poses_cm),
                jnp.asarray(mesh_idx), intr=self.mrenderer.intr)
        # disjoint screen footprints: no occluder work at all —
        # occ=None scores identically (occluder edge term is 0)

        refined, scores = refine_pose_cem_batched(
            self.mrenderer, jnp.asarray(edge_map), poses_cm, mesh_idx,
            iters=iters, samples=samples, init_sigma=sigma,
            seed=min(tr.age for tr in tracks),
            occluder_depths=occ, roi=roi, occluder_poses=occ_poses,
            radius=self.coverage_radius)
        for i, tr in enumerate(tracks):
            T_cm = np.eye(4)
            T_cm[:3, :4] = refined[i]
            tr.pose_wm = G @ T_cm
            tr.score = float(scores[i])
            tr.age += 1
        # seed the device-resident state for a possible async steady state
        if self.async_frames > 0:
            self._dev = {
                "poses": jnp.asarray(refined), "G": G.copy(),
                "oids": oids, "pending": 0,
                "scores": jnp.asarray(scores),
                "mi": jnp.asarray(np.array(
                    [self.mrenderer.index(tr.model_name)
                     for tr in tracks], np.int32)),
            }
        self.history.append(self.export_packet())

    def _step_async(self, tracks, G, G_cw, edge_map, iters, samples, sigma,
                    roi, ) -> None:
        """Device-resident settled-state step: ONE enqueued fused-CEM
        dispatch, no host sync (see __init__ docstring)."""
        import jax
        import jax.numpy as jnp

        from visma_tpu.semantic.cem import (CEM_TAU, cem_n_elite,
                                            fused_cem_executor)

        dev = self._dev
        dG = (G_cw @ dev["G"])[:3, :4].astype(np.float32)
        poses_dev = _compose_dg(jnp.asarray(dG), dev["poses"])

        # conservative occlusion decision from the host mirror (stale by
        # <= async_frames frames; the 3-sigma margin covers the drift)
        mirror_cm = np.stack([(G_cw @ tr.pose_wm)[:3, :4]
                              for tr in tracks]).astype(np.float32)
        need_occ = len(tracks) > 1 and self._footprints_may_overlap(
            mirror_cm, [tr.model_name for tr in tracks], sigma)

        n = len(tracks)
        # schedule constants shared with refine_pose_cem_batched's
        # defaults (cem.CEM_TAU / cem_n_elite): the async and sync paths
        # must not silently diverge (ADVICE r4 #5)
        n_elite = cem_n_elite(samples)
        sig_key = ("sig", sigma, n)
        if dev.get(sig_key) is None:
            dev[sig_key] = jnp.asarray(np.tile(np.concatenate(
                [np.full(3, sigma[1]), np.full(3, sigma[0])]
            ).astype(np.float32), (n, 1)))
        run = fused_cem_executor(self.intr, CEM_TAU, iters, samples,
                                 n_elite, roi,
                                 "poses" if need_occ else "none",
                                 self.coverage_radius)
        args = (self.mrenderer.Cs, dev["mi"], poses_dev[:, :, :3],
                poses_dev[:, :, 3],
                dev[sig_key], jnp.asarray(edge_map, jnp.float32),
                jax.random.PRNGKey(self._frame_no))
        if need_occ:
            refined_dev, scores_dev = run(*args, poses_dev)
        else:
            refined_dev, scores_dev = run(*args)

        dev.update(poses=refined_dev, G=G.copy(), scores=scores_dev,
                   pending=dev["pending"] + 1)
        for tr in tracks:
            tr.age += 1
        # lazy history packet: materialized by finalize()
        self.history.append(("dev", G.copy(), refined_dev,
                             [(tr.oid, tr.model_name, tr.status)
                              for tr in tracks]))
        if dev["pending"] >= self.async_frames:
            self._sync_dev()

    def _sync_dev(self) -> None:
        """Refresh the host mirror (ObjectTrack poses/scores) from the
        device-resident state. Blocks on the pipelined dispatches."""
        if self._dev is None or self._dev["pending"] == 0:
            return
        poses = np.asarray(self._dev["poses"])
        scores = np.asarray(self._dev["scores"])
        G = self._dev["G"]
        for i, oid in enumerate(self._dev["oids"]):
            tr = self.tracks.get(oid)
            if tr is None:
                continue
            T_cm = np.eye(4)
            T_cm[:3, :4] = poses[i]
            tr.pose_wm = G @ T_cm
            tr.score = float(scores[i])
        self._dev["pending"] = 0

    def finalize(self) -> None:
        """Sync the host mirror and materialize lazy history packets.
        Idempotent; called by write_result_json."""
        self._sync_dev()
        for k, packet in enumerate(self.history):
            if not (isinstance(packet, tuple) and packet
                    and packet[0] == "dev"):
                continue
            _, G, refined_dev, metas = packet
            poses = np.asarray(refined_dev)
            out = []
            for i, (oid, name, status) in enumerate(metas):
                T_cm = np.eye(4)
                T_cm[:3, :4] = poses[i]
                T_wm = G @ T_cm
                out.append({"id": oid, "model_name": name,
                            "status": status,
                            "model_pose": [float(x) for x in
                                           T_wm[:3, :4].reshape(-1)]})
            self.history[k] = out

    def _footprints_may_overlap(self, poses_cm: np.ndarray,
                                names: List[str],
                                sigma: Optional[tuple] = None) -> bool:
        """Conservative screen-space disjointness test: each object's
        model-frame AABB corners are projected at its current pose and the
        screen rectangle is expanded by the 3-sigma CEM search radius —
        translation sigma plus the rotational sigma times the object's
        AABB half-diagonal, since a rotation perturbation moves extremal
        points by up to sigma_rot*radius (ADVICE r4 #3). sigma: the
        ACTIVE (rot, trans) schedule sigmas; defaults to init_sigma.
        True = some pair may overlap -> render occluder z-buffers. (Host
        arithmetic on 8 points per object — no dispatch.)"""
        s_rot, s_trans = sigma if sigma is not None else self.init_sigma
        rects = []
        for pose, name in zip(poses_cm, names):
            lo, hi = self._mesh_aabb.get(
                name, (np.full(3, -1.0), np.full(3, 1.0)))
            corners = np.array([[x, y, z] for x in (lo[0], hi[0])
                                for y in (lo[1], hi[1])
                                for z in (lo[2], hi[2])])
            half_diag = 0.5 * float(np.linalg.norm(np.asarray(hi) - lo))
            margin = 3.0 * (s_trans + s_rot * half_diag)
            pc = corners @ np.asarray(pose[:3, :3]).T + pose[:3, 3]
            z = pc[:, 2]
            if np.any(z <= 0.1):
                return True          # degenerate: be conservative
            u = self.intr.fx * pc[:, 0] / z + self.intr.cx
            v = self.intr.fy * pc[:, 1] / z + self.intr.cy
            mpx = max(self.intr.fx, self.intr.fy) * margin / float(z.min())
            rects.append((u.min() - mpx, u.max() + mpx,
                          v.min() - mpx, v.max() + mpx))
        for i in range(len(rects)):
            for j in range(i + 1, len(rects)):
                a, b = rects[i], rects[j]
                if a[0] <= b[1] and b[0] <= a[1] \
                        and a[2] <= b[3] and b[2] <= a[3]:
                    return True
        return False

    def _covered(self, bbox, gwc: np.ndarray, iou_thresh: float = 0.5
                 ) -> bool:
        """Does an existing track already explain this detection?

        IoU between the detection box and each track's PROJECTED AABB
        rectangle. (The r4 test used an 80-px center-distance radius,
        which merged genuinely distinct adjacent objects — half the
        random scenes in tools/spawn_sweep.py lost tracks to it; two
        neighboring objects have distinct, partially-overlapping boxes
        and IoU separates them.)"""
        bx0, bx1 = sorted((bbox.top_left_x, bbox.bottom_right_x))
        by0, by1 = sorted((bbox.top_left_y, bbox.bottom_right_y))
        b_area = max(bx1 - bx0, 0.0) * max(by1 - by0, 0.0)
        if b_area <= 0:
            return True          # degenerate detection: nothing to spawn
        G = np.eye(4)
        G[:3, :4] = gwc
        G_cw = np.linalg.inv(G)
        for tr in self.tracks.values():
            lo, hi = self._mesh_aabb.get(
                tr.model_name, (np.full(3, -0.5), np.full(3, 0.5)))
            corners = np.array([[x, y, z] for x in (lo[0], hi[0])
                                for y in (lo[1], hi[1])
                                for z in (lo[2], hi[2])])
            P = G_cw @ tr.pose_wm
            pc = corners @ P[:3, :3].T + P[:3, 3]
            z = pc[:, 2]
            if np.any(z <= 0.1):
                continue         # behind-camera track: it cannot explain
                                 # an in-image detection (suppressing ALL
                                 # spawns here would be wrong)
            u = self.intr.fx * pc[:, 0] / z + self.intr.cx
            v = self.intr.fy * pc[:, 1] / z + self.intr.cy
            ix0, ix1 = max(u.min(), bx0), min(u.max(), bx1)
            iy0, iy1 = max(v.min(), by0), min(v.max(), by1)
            inter = max(ix1 - ix0, 0.0) * max(iy1 - iy0, 0.0)
            t_area = (u.max() - u.min()) * (v.max() - v.min())
            union = max(b_area + t_area - inter, 1e-6)
            if inter / union > iou_thresh:
                return True
        return False

    def export_packet(self) -> List[dict]:
        """One result.json packet (evaluation.cpp:163-198 layout)."""
        out = []
        for tr in self.tracks.values():
            out.append({
                "id": tr.oid,
                "model_name": tr.model_name,
                "status": tr.status,
                "model_pose": [float(x)
                               for x in tr.pose_wm[:3, :4].reshape(-1)],
            })
        return out

    def write_result_json(self, path: str) -> None:
        self.finalize()
        with open(path, "w") as fp:
            json.dump(self.history, fp, indent=1)


def _make_compose_dg():
    import functools

    import jax
    import jax.numpy as jnp

    @jax.jit
    def run(dG34, poses):
        """pose_cm' = dG @ pose_cm for a (n,3,4) stack; dG34 (3,4) is the
        relative camera transform G'_cw @ G (HIGHEST precision — rotation
        roundoff would otherwise perturb every CEM init)."""
        hp = functools.partial(jnp.einsum,
                               precision=jax.lax.Precision.HIGHEST)
        Rp = hp("ij,njk->nik", dG34[:, :3], poses[:, :, :3])
        tp = hp("ij,nj->ni", dG34[:, :3], poses[:, :, 3]) + dG34[:, 3]
        return jnp.concatenate([Rp, tp[:, :, None]], axis=2)

    return run


_compose_dg = _make_compose_dg()


def _make_exclusive_min():
    import functools

    import jax
    import jax.numpy as jnp

    from visma_tpu.render.raster import rasterize_depth_multi

    @functools.partial(jax.jit, static_argnames=("intr",))
    def run(Cs, poses, mesh_idx, intr):
        """Render all n tracks' current depths and return, per track, the
        min depth over the OTHER tracks (+inf background) — one
        dispatch."""
        d = rasterize_depth_multi(Cs, poses, mesh_idx, intr)
        n = d.shape[0]
        mask = ~jnp.eye(n, dtype=bool)                       # (n,n)
        dd = jnp.where(mask[:, :, None, None], d[None], jnp.inf)
        return jnp.min(dd, axis=1)                           # (n,H,W)

    return run


_exclusive_min_depths = _make_exclusive_min()
