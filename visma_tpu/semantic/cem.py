"""Cross-entropy-method SE(3) pose refinement by batched edge likelihood.

Each iteration samples N pose perturbations around the current mean in
se(3), renders+scores all of them in one batched pass (the replacement
for the reference renderer's one-hypothesis-at-a-time loop, SURVEY §3.3),
and refits the sampling distribution to the elite fraction.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from visma_tpu.geom import SE3
from visma_tpu.render.likelihood import (edge_distance_transform,
                                          occlusion_aware_edge_score,
                                          symmetric_edge_score)

# Shared CEM schedule constants: the mapper's async fast path and the
# public refine_pose_cem_batched defaults MUST agree (the documented
# async==sync parity breaks silently otherwise; ADVICE r4 #5).
CEM_TAU = 10.0
CEM_ELITE_FRAC = 0.25


def cem_n_elite(samples: int, elite_frac: float = CEM_ELITE_FRAC) -> int:
    return max(2, int(samples * elite_frac))


def refine_pose_cem(renderer, observed_edges: jnp.ndarray,
                    init_pose: np.ndarray,
                    iters: int = 6, samples: int = 64,
                    elite_frac: float = CEM_ELITE_FRAC,
                    init_sigma: Tuple[float, float] = (0.15, 0.08),
                    yaw_only: bool = False,
                    seed: int = 0,
                    tau: float = CEM_TAU,
                    occluder_depth: Optional[jnp.ndarray] = None,
                    ) -> Tuple[np.ndarray, float]:
    """Refine a (3,4) or (4,4) model->camera pose against observed edges.

    init_sigma: (rotation rad, translation m) initial sampling stddevs.
    yaw_only: restrict rotation sampling to the camera-Y axis (gravity-
    aligned object assumption, as in the annotation tool's yaw sweep).
    occluder_depth: optional (H, W) joint depth of all other scene objects;
    when given, hypotheses are scored occlusion-aware (composited z-buffer).
    Returns (refined (3,4) pose, best score).
    """
    dt = edge_distance_transform(jnp.asarray(observed_edges))
    n_elite = max(2, int(samples * elite_frac))
    rng = np.random.default_rng(seed)

    mean = SE3.from_matrix3x4(jnp.asarray(np.asarray(init_pose)[:3, :4],
                                          np.float32))
    sig = np.concatenate([np.full(3, init_sigma[1]),
                          np.full(3, init_sigma[0])]).astype(np.float32)
    if yaw_only:
        sig[3] = sig[5] = 1e-4

    best_pose, best_score = np.asarray(mean.matrix3x4()), np.inf
    for _ in range(iters):
        xi = rng.standard_normal((samples, 6)).astype(np.float32) * sig
        xi[0] = 0.0  # always include the current mean
        # RIGHT-multiplied perturbations: rotations act about the MODEL
        # frame (object center), not the camera origin
        perturb = SE3.exp(jnp.asarray(xi))
        hyps = jax.vmap(lambda d: (mean @ d).matrix3x4())(perturb)
        obs = jnp.asarray(observed_edges)
        if occluder_depth is not None:
            depths = renderer.render_depth(hyps)
            scores = np.asarray(occlusion_aware_edge_score(
                depths, jnp.asarray(occluder_depth), dt, obs, tau=tau))
        else:
            edges = renderer.render_edge(hyps)
            scores = np.asarray(symmetric_edge_score(edges, dt, obs, tau=tau))

        order = np.argsort(scores)
        elite = xi[order[:n_elite]]
        if scores[order[0]] < best_score:
            best_score = float(scores[order[0]])
            best_pose = np.asarray(
                (mean @ SE3.exp(jnp.asarray(xi[order[0]]))).matrix3x4())

        mu = elite.mean(axis=0)
        sig = elite.std(axis=0) * 1.1 + 1e-4
        if yaw_only:
            sig[3] = sig[5] = 1e-4
        mean = mean @ SE3.exp(jnp.asarray(mu))

    return best_pose, best_score


# ---------------------------------------------------------------------------
# Batched multi-object CEM: ALL tracks' hypothesis batches render and score
# in ONE device dispatch per iteration (the mapper previously looped tracks
# sequentially, one dispatch each).
# ---------------------------------------------------------------------------

def _se3_exp_np(xi: np.ndarray) -> np.ndarray:
    """Numpy SE(3) exp, (...,6) [rho, w] -> (...,4,4). Host-side mirror of
    geom.lie.SE3.exp so the CEM's tiny per-track pose refits don't cost a
    device dispatch each."""
    xi = np.asarray(xi, np.float64)
    rho, w = xi[..., :3], xi[..., 3:]
    th = np.linalg.norm(w, axis=-1, keepdims=True)[..., None]  # (...,1,1)
    K = np.zeros((*xi.shape[:-1], 3, 3))
    K[..., 0, 1], K[..., 0, 2] = -w[..., 2], w[..., 1]
    K[..., 1, 0], K[..., 1, 2] = w[..., 2], -w[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -w[..., 1], w[..., 0]
    K2 = K @ K
    eye = np.broadcast_to(np.eye(3), K.shape)
    small = th < 1e-6
    ths = np.where(small, 1.0, th)
    A = np.where(small, 1.0 - th**2 / 6.0, np.sin(ths) / ths)
    B = np.where(small, 0.5 - th**2 / 24.0, (1 - np.cos(ths)) / ths**2)
    C = np.where(small, 1.0 / 6.0 - th**2 / 120.0,
                 (ths - np.sin(ths)) / ths**3)
    R = eye + A * K + B * K2
    V = eye + B * K + C * K2
    t = (V @ rho[..., None])[..., 0]
    out = np.zeros((*xi.shape[:-1], 4, 4))
    out[..., :3, :3] = R
    out[..., :3, 3] = t
    out[..., 3, 3] = 1.0
    return out


def _roi_origins(t_cm, intr, roi):
    """Window top-left (x0, y0) per object: centered on the projected
    object origin, clipped inside the image. t_cm (n,3) camera-frame
    object centers; returns (n,2) float32 (integral values)."""
    z = jnp.maximum(t_cm[:, 2], 1e-3)
    u = intr.fx * t_cm[:, 0] / z + intr.cx
    v = intr.fy * t_cm[:, 1] / z + intr.cy
    ox = jnp.clip(jnp.round(u - roi[1] / 2), 0, intr.cols - roi[1])
    oy = jnp.clip(jnp.round(v - roi[0] / 2), 0, intr.rows - roi[0])
    return jnp.stack([ox, oy], axis=1).astype(jnp.float32)


def _crop(img, origin, roi):
    """(H,W) -> (roi[0], roi[1]) window at global top-left origin=(x0,y0)."""
    return jax.lax.dynamic_slice(
        img, (origin[1].astype(jnp.int32), origin[0].astype(jnp.int32)),
        (roi[0], roi[1]))


@functools.partial(jax.jit, static_argnames=("intr", "tau", "roi", "radius"))
def _cem_render_score(Cs, mesh_idx, mean_R, mean_t, xi, occ, dt, obs,
                      intr, tau, roi=None, origins=None, occ_poses=None,
                      radius=2):
    """Render+score (n, S) hypotheses of n objects in one computation.

    Cs: mesh corner stack (render.raster.mesh_corner_stack);
    mesh_idx (n,); mean_R (n,3,3), mean_t (n,3); xi (n,S,6) tangent
    perturbations (RIGHT-multiplied); occ (n,H,W) per-track occluder depth
    (+inf rows for unoccluded); dt/obs (H,W). Returns scores (n,S).
    roi/origins: optional (Hr,Wr) static window + (n,2) top-lefts — see
    _render_score_nS.
    """
    return _render_score_nS(Cs, mesh_idx, mean_R, mean_t, xi, occ, dt, obs,
                            intr, tau, roi=roi, origins=origins,
                            occ_poses=occ_poses, radius=radius)[1]


def _render_score_nS(Cs, mesh_idx, mean_R, mean_t, xi, occ, dt, obs, intr,
                     tau, roi=None, origins=None, occ_poses=None, radius=2):
    """Shared body: render+score all (n, S) hypotheses. Returns
    (hyp34 (n,S,3,4), scores (n,S)).

    roi (static (Hr,Wr)) + origins (n,2): render and score each object's
    hypotheses inside a fixed-size screen window instead of the full
    frame. EXACT for footprints inside the window (chamfer mass lives on
    rendered pixels; the coverage denominator stays the global edge mass)
    — the per-hypothesis cost drops from H*W to Hr*Wr pixels.

    occ_poses (n,3,4), ROI path only: instead of cropping a precomputed
    full-frame occluder z-buffer, render each track's occluders (the
    OTHER n-1 objects at these frame-start poses) directly into its
    window — n*(n-1) window renders fused into the same dispatch,
    replacing a separate full-frame render dispatch. Identical values: a
    windowed render equals the full-frame render cropped at the same
    origin.
    """
    from visma_tpu.render.raster import rasterize_depth_multi

    n, S = xi.shape[:2]
    mean = SE3(mean_R[:, None], mean_t[:, None])       # (n,1)
    hyp = mean @ SE3.exp(xi)                           # (n,S)
    poses = hyp.matrix3x4()
    mi = jnp.repeat(mesh_idx, S)
    flat = poses.reshape(n * S, 3, 4)
    if roi is None:
        depths = rasterize_depth_multi(Cs, flat, mi, intr)
        depths = depths.reshape(n, S, intr.rows, intr.cols)
        scores = jax.vmap(
            lambda d, o: occlusion_aware_edge_score(d, o, dt, obs, tau=tau,
                                                    radius=radius)
        )(depths, occ)
        return poses, scores

    org = jnp.repeat(origins, S, axis=0)               # (n*S, 2)
    obs_mass = jnp.sum(obs)
    dt_w = jax.vmap(lambda o: _crop(dt, o, roi))(origins)
    obs_w = jax.vmap(lambda o: _crop(obs, o, roi))(origins)
    if occ_poses is not None and n > 1:
        oi = np.stack([[j for j in range(n) if j != i]
                       for i in range(n)])                 # (n, n-1)
        op = occ_poses[oi.reshape(-1)]
        om = mesh_idx[jnp.asarray(oi.reshape(-1))]
        oorg = jnp.repeat(origins, n - 1, axis=0)
        od = rasterize_depth_multi(Cs, op, om, intr, roi, oorg)
        occ_w = od.reshape(n, n - 1, roi[0], roi[1]).min(axis=1)
    else:
        occ_w = jax.vmap(lambda im, o: _crop(im, o, roi))(occ, origins)

    depths = rasterize_depth_multi(Cs, flat, mi, intr, roi, org)
    depths = depths.reshape(n, S, roi[0], roi[1])
    scores = jax.vmap(
        lambda d, o, dw, ow: occlusion_aware_edge_score(
            d, o, dw, ow, tau=tau, obs_mass=obs_mass, radius=radius)
    )(depths, occ_w, dt_w, obs_w)
    return poses, scores


@functools.lru_cache(maxsize=None)
def retrieval_executor(intr, roi, B):
    """Cached jitted executor for detection-driven shape retrieval:
    render B (mesh, yaw) candidate windows at one shared origin and
    score them against the window-cropped evidence. One dispatch in
    place of ~50 small eager ones per detection. Keyed by (intr, roi, B);
    the mesh stack Cs is the first argument of every call."""
    from visma_tpu.image.edges import depth_edge
    from visma_tpu.render.raster import rasterize_depth_multi

    @jax.jit
    def run(Cs, hyps, mi, org1, dt, em, box):
        """box = (x0, y0, x1, y1) f32: the coverage mask is built on
        device from these scalars (no host-built (H, W) mask upload per
        detection)."""
        origins = jnp.broadcast_to(org1, (B, 2))
        d = rasterize_depth_multi(Cs, hyps, mi, intr, roi, origins)
        edges = depth_edge(d)
        dt_w = _crop(dt, org1, roi)
        em_w = _crop(em, org1, roi)
        yy = org1[1] + jnp.arange(roi[0], dtype=jnp.float32)[:, None]
        xx = org1[0] + jnp.arange(roi[1], dtype=jnp.float32)[None, :]
        in_box = ((xx >= box[0]) & (xx < box[2])
                  & (yy >= box[1]) & (yy < box[3]))
        return symmetric_edge_score(edges, dt_w,
                                    jnp.where(in_box, em_w, 0.0))

    return run


def _cem_fused_body(Cs, mesh_idx, R0, t0, sig0, occ, obs, key, intr, tau,
                    iters, samples, n_elite, roi=None, occ_poses=None,
                    radius=2):
    """The WHOLE batched CEM as one device computation: sampling, render,
    score, elite refit, and best-pose tracking for every iteration — ONE
    dispatch per frame instead of one host-synced dispatch per CEM
    iteration. roi: optional static (Hr, Wr) screen window per object,
    recentered on the current mean's projected center every iteration.
    Returns (best_pose (n,3,4), best_score (n,)).

    Called through fused_cem_executor, which caches one jitted executor
    per schedule."""
    n = R0.shape[0]
    # sweeps sized to the truncation: chamfer takes min(dt, tau), so any
    # pixel farther than the propagation radius reads as big -> tau —
    # identical scores; int(tau)+6 sweeps cover tau in euclidean distance
    # with margin (a 1 px/iter 8-neighborhood relaxation reaches a
    # distance-tau point within tau chebyshev steps). Halves the EDT's
    # ~0.9 ms/frame at the default tau=10.
    dt = edge_distance_transform(obs, iters=int(tau) + 6)
    idx = jnp.arange(n)

    def body(carry):
        mean_R, mean_t, sig, best_pose, best_score, key = carry
        key, sub = jax.random.split(key)
        # NOTE: plain normal sampling, NOT antithetic (+z,-z) pairs —
        # antithetic elites cancel in the mean refit and stall the CEM
        # (measured on chip: trans err 0.019 -> 0.158 m at the bench scene)
        xi = jax.random.normal(sub, (n, samples, 6), jnp.float32) \
            * sig[:, None, :]
        xi = xi.at[:, 0].set(0.0)  # always include the current mean
        # ...and the best-so-far pose, expressed in the current mean's
        # tangent: re-anchors the search when the mean wanders and makes
        # the best score monotone by construction (sample 1 re-scores it)
        rel = SE3(mean_R, mean_t).inv() @ SE3.from_matrix3x4(best_pose)
        xi = xi.at[:, 1].set(rel.log())
        # window RECENTERED on the current mean each iteration (crops are
        # dynamic_slice — cheap), so the object keeps its full margin as
        # the mean migrates
        origins = None if roi is None else _roi_origins(mean_t, intr, roi)
        hyp34, scores = _render_score_nS(
            Cs, mesh_idx, mean_R, mean_t, xi, occ, dt, obs, intr, tau,
            roi=roi, origins=origins, occ_poses=occ_poses, radius=radius)
        order = jnp.argsort(scores, axis=1)
        top = order[:, 0]
        top_score = scores[idx, top]
        top_pose = hyp34[idx, top]
        better = top_score < best_score
        best_pose = jnp.where(better[:, None, None], top_pose, best_pose)
        best_score = jnp.minimum(best_score, top_score)

        elite = xi[idx[:, None], order[:, :n_elite]]    # (n,E,6)
        mu = elite.mean(axis=1)
        sig = elite.std(axis=1) * 1.1 + 1e-4
        step = SE3(mean_R, mean_t) @ SE3.exp(mu)
        return step.R, step.t, sig, best_pose, best_score, key

    best_pose0 = jnp.concatenate([R0, t0[:, :, None]], axis=2)
    carry = (R0, t0, sig0, best_pose0, jnp.full((n,), jnp.inf, jnp.float32),
             key)
    # unrolled: iters is static and small
    for _ in range(iters):
        carry = body(carry)
    return carry[3], carry[4]


@functools.lru_cache(maxsize=None)
def fused_cem_executor(intr, tau, iters, samples, n_elite, roi, occ_mode,
                       radius=2):
    """Cached jitted CEM executor; every call takes the mesh stack Cs
    (MultiMeshRenderer.Cs) as its first argument. occ_mode selects the
    occlusion handling baked into the trace: "none" (no occluders),
    "depths" (precomputed full-frame z-buffers), "poses" (in-window
    occluder renders; requires roi). Executors are keyed by every static
    knob, so each schedule compiles once per process."""
    if occ_mode == "poses":
        @jax.jit
        def run(Cs, mesh_idx, R0, t0, sig0, obs, key, occ_poses):
            occ = jnp.zeros((R0.shape[0], 1, 1), jnp.float32)  # unused
            return _cem_fused_body(Cs, mesh_idx, R0, t0, sig0, occ, obs,
                                   key, intr, tau, iters, samples, n_elite,
                                   roi, occ_poses, radius)
    elif occ_mode == "depths":
        @jax.jit
        def run(Cs, mesh_idx, R0, t0, sig0, obs, key, occ):
            return _cem_fused_body(Cs, mesh_idx, R0, t0, sig0, occ, obs,
                                   key, intr, tau, iters, samples, n_elite,
                                   roi, None, radius)
    else:
        @jax.jit
        def run(Cs, mesh_idx, R0, t0, sig0, obs, key):
            occ = jnp.full((R0.shape[0], intr.rows, intr.cols), jnp.inf,
                           jnp.float32)
            return _cem_fused_body(Cs, mesh_idx, R0, t0, sig0, occ, obs,
                                   key, intr, tau, iters, samples, n_elite,
                                   roi, None, radius)
    return run


def refine_pose_cem_batched(mrenderer, observed_edges: jnp.ndarray,
                            init_poses: np.ndarray, mesh_idx: np.ndarray,
                            iters: int = 6, samples: int = 48,
                            elite_frac: float = CEM_ELITE_FRAC,
                            init_sigma: Tuple[float, float] = (0.15, 0.08),
                            seed: int = 0, tau: float = CEM_TAU,
                            occluder_depths: Optional[jnp.ndarray] = None,
                            device_loop: bool = True,
                            roi: Optional[Tuple[int, int]] = None,
                            occluder_poses: Optional[np.ndarray] = None,
                            radius: int = 2,
                            ):
    """Jointly refine n (3,4)/(4,4) model->camera poses of n objects.

    mrenderer: render.raster.MultiMeshRenderer with the mesh database set;
    mesh_idx (n,) database indices; occluder_depths optional (n,H,W).
    device_loop=True (default) runs the ENTIRE CEM — sampling, render,
    score, refit — as one jitted dispatch (fused_cem_executor);
    device_loop=False keeps the host-refit loop (one dispatch per
    iteration, numpy refit), retained as the test oracle for the fused
    path. roi: optional static (Hr, Wr) per-object screen window — exact
    when each object's footprint + search radius fits the window; cost
    per hypothesis drops from rows*cols to Hr*Wr pixels.
    occluder_poses (n,3,4), ROI mode only: frame-start model->camera
    poses from which each track's occluder z-buffer is rendered INSIDE
    its window per iteration (see _render_score_nS) — pass this instead
    of occluder_depths to avoid a separate full-frame occluder dispatch.
    Returns (poses (n,3,4), scores (n,)).
    """
    if roi is not None:
        roi = (min(int(roi[0]), mrenderer.intr.rows),
               min(int(roi[1]), mrenderer.intr.cols))
        if roi == (mrenderer.intr.rows, mrenderer.intr.cols):
            roi = None  # window >= frame: the plain path is the same
    if occluder_poses is not None and np.asarray(init_poses).shape[0] == 1:
        # a single object has no occluders; the occ_poses trace would
        # _crop() a placeholder (1,1) array (ADVICE r4 #2)
        occluder_poses = None
    if occluder_poses is not None and roi is None:
        raise ValueError("occluder_poses requires roi mode; pass "
                         "occluder_depths for full-frame refinement")
    if device_loop:
        init_poses = np.asarray(init_poses, np.float32)
        n = init_poses.shape[0]
        sig0 = np.tile(np.concatenate([np.full(3, init_sigma[1]),
                                       np.full(3, init_sigma[0])]
                                      ).astype(np.float32), (n, 1))
        n_elite = max(2, int(samples * elite_frac))
        args = (mrenderer.Cs, jnp.asarray(mesh_idx, jnp.int32),
                jnp.asarray(init_poses[:, :3, :3]),
                jnp.asarray(init_poses[:, :3, 3]), jnp.asarray(sig0),
                jnp.asarray(observed_edges, jnp.float32),
                jax.random.PRNGKey(seed))
        if occluder_poses is not None:
            run = fused_cem_executor(mrenderer.intr, tau, iters, samples,
                                     n_elite, roi, "poses", radius)
            pose, score = run(*args, jnp.asarray(
                np.asarray(occluder_poses, np.float32).reshape(n, 3, 4)))
        elif occluder_depths is not None:
            run = fused_cem_executor(mrenderer.intr, tau, iters, samples,
                                     n_elite, roi, "depths", radius)
            pose, score = run(*args,
                              jnp.asarray(occluder_depths, jnp.float32))
        else:
            run = fused_cem_executor(mrenderer.intr, tau, iters, samples,
                                     n_elite, roi, "none", radius)
            pose, score = run(*args)
        return np.asarray(pose), np.asarray(score)
    init_poses = np.asarray(init_poses, np.float32)
    n = init_poses.shape[0]
    dt = edge_distance_transform(jnp.asarray(observed_edges))
    obs = jnp.asarray(observed_edges)
    n_elite = max(2, int(samples * elite_frac))
    rng = np.random.default_rng(seed)

    mean_R = init_poses[:, :3, :3].copy()
    mean_t = init_poses[:, :3, 3].copy()
    sig = np.tile(np.concatenate([np.full(3, init_sigma[1]),
                                  np.full(3, init_sigma[0])]
                                 ).astype(np.float32), (n, 1))
    occ_poses = (None if occluder_poses is None else
                 jnp.asarray(np.asarray(occluder_poses, np.float32)
                             .reshape(n, 3, 4)))
    if occ_poses is not None:
        occ = jnp.zeros((n, 1, 1), jnp.float32)  # unused, never traced
    elif occluder_depths is None:
        occ = jnp.full((n, mrenderer.intr.rows, mrenderer.intr.cols),
                       jnp.inf, jnp.float32)
    else:
        occ = jnp.asarray(occluder_depths, jnp.float32)

    best_pose = np.concatenate([mean_R, mean_t[:, :, None]], axis=2)
    best_score = np.full(n, np.inf)

    mi = jnp.asarray(mesh_idx, jnp.int32)
    for _ in range(iters):
        xi = rng.standard_normal((n, samples, 6)).astype(np.float32) \
            * sig[:, None, :]
        xi[:, 0] = 0.0  # always include the current means
        # recenter the window on the CURRENT mean each iteration, matching
        # the fused executor (ADVICE r3 #5: origins frozen at init diverge from
        # the fused path when the mean migrates toward a window edge)
        origins = None if roi is None else _roi_origins(
            jnp.asarray(mean_t), mrenderer.intr, roi)
        scores = np.asarray(_cem_render_score(
            mrenderer.Cs, mi, jnp.asarray(mean_R), jnp.asarray(mean_t),
            jnp.asarray(xi), occ, dt, obs, mrenderer.intr, tau, roi=roi,
            origins=origins, occ_poses=occ_poses, radius=radius))  # (n,S)

        order = np.argsort(scores, axis=1)
        # host-side refit (numpy: zero extra dispatches)
        G_mean = np.zeros((n, 4, 4))
        G_mean[:, :3, :3] = mean_R
        G_mean[:, :3, 3] = mean_t
        G_mean[:, 3, 3] = 1.0
        hyp = np.einsum("nij,nsjk->nsik", G_mean, _se3_exp_np(xi))
        for i in range(n):
            top = order[i, 0]
            if scores[i, top] < best_score[i]:
                best_score[i] = float(scores[i, top])
                best_pose[i] = hyp[i, top, :3, :4]
            elite = xi[i, order[i, :n_elite]]
            mu = elite.mean(axis=0)
            sig[i] = elite.std(axis=0) * 1.1 + 1e-4
            step = G_mean[i] @ _se3_exp_np(mu)
            mean_R[i], mean_t[i] = step[:3, :3], step[:3, 3]

    return best_pose, best_score
