"""Submap (keyframe-sharded) distributed BA — the sequence-parallel axis.

Complements visma_tpu.dist.sharded_ba (landmark sharding): here the
SEQUENCE is partitioned — each device owns a contiguous keyframe chunk
(map block) plus a one-keyframe halo shared with its right neighbor
(SURVEY §2.3 / §5: "partition sliding-window BA keyframes and map blocks
per host; halo exchange of shared features between neighboring keyframe
shards"). Pipeline:

  1. local solve: every device runs the full damped-GN Schur BA on its own
     chunk simultaneously (shard_map, zero collectives inside);
  2. stitch: the relative pose across each shared boundary keyframe is
     measured in both neighboring chunks; a global pose graph over chunk
     anchors (tiny: D nodes) aligns the chunks;
  3. apply: each chunk's poses/landmarks move by its anchor correction.

Chunking trades global optimality for sequence-parallel throughput — the
standard submapping compromise; a final few global iterations (landmark-
sharded) can polish if needed.
"""
from __future__ import annotations

import functools

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from visma_tpu.ba.gauss_newton import ba_step, total_cost
from visma_tpu.ba.problem import BaProblem
from visma_tpu.geom.rotations import mm, rodrigues


def split_into_chunks(prob: BaProblem, n_chunks: int, halo: int = 1):
    """Partition poses into n contiguous chunks with `halo` shared frames.

    Landmarks are DUPLICATED into every chunk where they carry >= 2
    observations (each chunk optimizes its own copy — the halo-exchange
    analog); the chunk with most observations "owns" the landmark and
    writes it back at stitch time.

    Returns stacked per-chunk problems (leading axis = chunk) + bookkeeping
    {pose_idx (D,Kc), land_idx (D,Lc), land_valid (D,Lc), land_owner
    (D,Lc) bool}.
    """
    K = prob.num_poses
    L = prob.num_landmarks
    bounds = np.linspace(0, K, n_chunks + 1).astype(int)
    Kc = int(np.max(bounds[1:] - bounds[:-1])) + halo

    mask_np = np.asarray(prob.mask)
    votes = np.zeros((L, n_chunks), np.int32)
    for d in range(n_chunks):
        lo, hi = bounds[d], min(bounds[d + 1] + halo, K)
        votes[:, d] = mask_np[:, lo:hi].sum(axis=1)
    present = votes >= 2          # duplicated membership
    owner = votes.argmax(axis=1)  # write-back ownership
    Lc = max(int(present.sum(axis=0).max()), 1)

    pose_idx = np.zeros((n_chunks, Kc), np.int32)
    land_idx = np.zeros((n_chunks, Lc), np.int32)
    land_valid = np.zeros((n_chunks, Lc), bool)
    land_owner = np.zeros((n_chunks, Lc), bool)
    for d in range(n_chunks):
        lo, hi = bounds[d], min(bounds[d + 1] + halo, K)
        idx = np.arange(lo, hi)
        idx = np.pad(idx, (0, Kc - len(idx)), mode="edge")
        pose_idx[d] = idx
        mine = np.nonzero(present[:, d])[0]
        land_idx[d, : len(mine)] = mine
        land_valid[d, : len(mine)] = True
        land_owner[d, : len(mine)] = owner[mine] == d

    R = np.asarray(prob.R)[pose_idx]                    # (D,Kc,3,3)
    p = np.asarray(prob.p)[pose_idx]
    X = np.asarray(prob.X)[land_idx]
    obs = np.asarray(prob.obs)[land_idx[:, :, None],
                               pose_idx[:, None, :]]    # (D,Lc,Kc,2)
    mask = mask_np[land_idx[:, :, None], pose_idx[:, None, :]] \
        & land_valid[:, :, None]
    # padded duplicate pose columns (mode="edge") must not double-count
    for d in range(n_chunks):
        seen = set()
        for c, g in enumerate(pose_idx[d]):
            if g in seen:
                mask[d, :, c] = False
            seen.add(g)

    chunks = BaProblem(
        R=jnp.asarray(R, jnp.float32), p=jnp.asarray(p, jnp.float32),
        X=jnp.asarray(X, jnp.float32), obs=jnp.asarray(obs, jnp.float32),
        mask=jnp.asarray(mask),
        intr=jnp.broadcast_to(prob.intr, (n_chunks, 4)))
    info = {"pose_idx": pose_idx, "land_idx": land_idx,
            "land_valid": land_valid, "land_owner": land_owner,
            "land_votes": votes, "bounds": bounds, "halo": halo}
    return chunks, info


def _local_solve(chunk: BaProblem, iters: int, axis: str = None) -> BaProblem:
    """Damped-GN loop on one chunk (runs per device inside shard_map)."""
    anchor = jnp.linalg.norm(chunk.p[-1] - chunk.p[0])

    def body(carry, _):
        cur, lam, cost = carry
        cand, cand_cost = ba_step(cur, lam, anchor)
        better = cand_cost < cost
        nxt = jax.tree.map(lambda a, b: jnp.where(better, a, b), cand, cur)
        lam_new = jnp.where(better, jnp.maximum(lam * 0.5, 1e-6),
                            jnp.minimum(lam * 4.0, 1e2))
        return (nxt, lam_new, jnp.where(better, cand_cost, cost)), None

    lam0 = jnp.asarray(1e-3, jnp.float32)
    if axis is not None:
        # inside shard_map the scan carry becomes device-varying after the
        # first iteration; mark the invariant initial value accordingly
        lam0 = jax.lax.pcast(lam0, (axis,), to="varying")
    c0 = total_cost(chunk)
    (sol, _, _), _ = jax.lax.scan(body, (chunk, lam0, c0), None,
                                  length=iters)
    return sol


@functools.lru_cache(maxsize=16)
def _jitted_local_solver(mesh: Mesh, iters: int):
    """Per-(mesh, iters) cached executable — a jit closure rebuilt per
    call would redo persistent-cache deserialization on every solve."""
    spec = BaProblem(R=P("d"), p=P("d"), X=P("d"), obs=P("d"), mask=P("d"),
                     intr=P("d"))

    @jax.jit
    @jax.shard_map(mesh=mesh, in_specs=(spec,), out_specs=spec)
    def solve_all(ch: BaProblem) -> BaProblem:
        with jax.default_matmul_precision("highest"):
            squeezed = jax.tree.map(lambda x: x[0], ch)
            sol = _local_solve(squeezed, iters, axis="d")
            return jax.tree.map(lambda x: x[None], sol)

    return solve_all


def submap_ba_solve(prob: BaProblem, mesh: Mesh, iters: int = 10,
                    polish_iters: int = 3, halo: int = 1,
                    consensus: bool = True,
                    polish_solver: str = "auto") -> Tuple[BaProblem, dict]:
    """Keyframe-sharded BA over the mesh. Returns (stitched problem, info).

    polish_iters: after stitching, run a few GLOBAL landmark-sharded
    iterations (visma_tpu.dist.sharded_ba) — submapping has solved the
    bulk of the nonlinearity chunk-locally in parallel; the polish removes
    the residual cross-chunk coupling the per-chunk gauges can't see.
    polish_solver: "dense" | "pcg" | "auto" — forwarded to
    sharded_ba_solve; "auto" switches to the matrix-free PCG path past
    PCG_CROSSOVER_K keyframes (submap runs are exactly the long-sequence
    regime where the dense (6K)^2 psum stops scaling).

    halo: shared boundary frames per chunk pair; with halo > 1 the stitch
    edge averages the relative transform over every shared frame (chordal
    rotation mean), damping single-frame estimation noise.

    consensus: landmarks duplicated across chunks are written back as the
    observation-count-weighted average of the corrected per-chunk
    estimates instead of owner-takes-all.
    """
    D = mesh.devices.size
    chunks, info = split_into_chunks(prob, D, halo=halo)
    info["consensus"] = consensus

    sharded = jax.device_put(chunks, NamedSharding(mesh, P("d")))
    sol = _jitted_local_solver(mesh, iters)(sharded)
    stitched = _pin_scale(_stitch(prob, sol, info), prob)
    if polish_iters > 0:
        from visma_tpu.dist.sharded_ba import sharded_ba_solve

        stitched, _ = sharded_ba_solve(stitched, mesh, iters=polish_iters,
                                       solver=polish_solver)
    return stitched, info


def _pin_scale(stitched: BaProblem, prob: BaProblem) -> BaProblem:
    """Scale the stitched scene about pose 0 so its end-to-end baseline
    ||p_last - p0|| equals the input's, the anchor `ba_solve` pins.

    Each chunk pins only its own baseline, and the SE(3) stitch cannot
    correct scale, so the composed trajectory drifts along the monocular
    scale gauge (about 5% with 8 keyframes per chunk); the global polish
    then holds whatever scale it is handed. Reprojection cost is invariant
    under this similarity, so only the gauge moves."""
    p = np.asarray(stitched.p)
    p0 = np.asarray(prob.p)
    s = np.linalg.norm(p0[-1] - p0[0]) / max(
        np.linalg.norm(p[-1] - p[0]), 1e-9)
    c = p[0]
    return BaProblem(
        R=stitched.R, p=jnp.asarray(c + s * (p - c), jnp.float32),
        X=jnp.asarray(c + s * (np.asarray(stitched.X) - c), jnp.float32),
        obs=stitched.obs, mask=stitched.mask, intr=stitched.intr)


def _stitch(prob: BaProblem, sol: BaProblem, info) -> BaProblem:
    """Pose-graph alignment of chunks via shared halo keyframes, then
    write corrected poses/landmarks back into the global problem."""
    from visma_tpu.ba.pose_graph import pose_graph_solve

    from visma_tpu.geom.rotations import project_so3

    pose_idx = info["pose_idx"]
    bounds = info["bounds"]
    halo = info["halo"]
    K = np.asarray(prob.R).shape[0]
    D = pose_idx.shape[0]
    R = np.asarray(sol.R)        # (D,Kc,3,3)
    p = np.asarray(sol.p)

    # chunk-anchor graph: node d = correction T_d applied to chunk d.
    # Boundary keyframes b in [bounds[d+1], bounds[d+1]+halo) appear as
    # the halo (trailing) frames of chunk d and the leading frames of
    # chunk d+1. The edge measures the transform between the two chunk
    # estimates, averaged over all shared frames (chordal mean rotation,
    # arithmetic mean translation).
    ei, ej, Rm, pm = [], [], [], []
    for d in range(D - 1):
        R_acc = np.zeros((3, 3))
        p_acc = np.zeros(3)
        n = 0
        for b in range(bounds[d + 1], min(bounds[d + 1] + halo, K)):
            hit_l = np.nonzero(pose_idx[d] == b)[0]
            hit_r = np.nonzero(pose_idx[d + 1] == b)[0]
            if len(hit_l) == 0 or len(hit_r) == 0:
                continue
            # T_left = (R,p) of b per chunk d; correction satisfies
            # T_d * T_left == T_{d+1} * T_right
            Rl, pl = R[d, int(hit_l[0])], p[d, int(hit_l[0])]
            Rr, pr = R[d + 1, int(hit_r[0])], p[d + 1, int(hit_r[0])]
            # relative measurement between node frames: T_l T_r^-1
            R_rel = Rl @ Rr.T
            R_acc += R_rel
            p_acc += pl - R_rel @ pr
            n += 1
        assert n > 0, "no shared boundary frame between chunks"
        R_rel = np.asarray(project_so3(jnp.asarray(R_acc / n, jnp.float32)))
        ei.append(d)
        ej.append(d + 1)
        # edge: T_j = T_i * (T_rel); with residual log(Tm^-1 Ti^-1 Tj),
        # measurement Tm = Ti^-1 Tj = T_rel
        Rm.append(R_rel)
        pm.append(p_acc / n)

    if D > 1:
        R0 = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (D, 3, 3))
        p0 = jnp.zeros((D, 3), jnp.float32)
        Rc, pc = pose_graph_solve(
            R0, p0, jnp.asarray(ei, jnp.int32), jnp.asarray(ej, jnp.int32),
            jnp.asarray(np.asarray(Rm), jnp.float32),
            jnp.asarray(np.asarray(pm), jnp.float32), iters=8)
        Rc, pc = np.asarray(Rc), np.asarray(pc)
    else:
        Rc = np.broadcast_to(np.eye(3, dtype=np.float32), (1, 3, 3))
        pc = np.zeros((1, 3), np.float32)

    # apply corrections and write back (chunk owns frames [lo, hi);
    # halo frame belongs to the right chunk)
    R_out = np.asarray(prob.R).copy()
    p_out = np.asarray(prob.p).copy()
    X_out = np.asarray(prob.X).copy()
    L = X_out.shape[0]
    X_acc = np.zeros((L, 3))
    w_acc = np.zeros(L)
    for d in range(D):
        lo, hi = bounds[d], bounds[d + 1]
        for local, g in enumerate(pose_idx[d]):
            if lo <= g < hi:
                R_out[g] = Rc[d] @ R[d, local]
                p_out[g] = Rc[d] @ p[d, local] + pc[d]
        if info.get("consensus", False):
            # observation-count-weighted average of every chunk's
            # corrected estimate of each duplicated landmark
            valid = info["land_valid"][d]
            li = info["land_idx"][d][valid]
            Xd = np.asarray(sol.X)[d][valid] @ Rc[d].T + pc[d]
            w = info["land_votes"][li, d].astype(np.float64)
            np.add.at(X_acc, li, Xd * w[:, None])
            np.add.at(w_acc, li, w)
        else:
            own = info["land_owner"][d]
            li = info["land_idx"][d][own]
            Xd = np.asarray(sol.X)[d][own]
            X_out[li] = Xd @ Rc[d].T + pc[d]
    if info.get("consensus", False):
        upd = w_acc > 0
        X_out[upd] = X_acc[upd] / w_acc[upd, None]

    return BaProblem(R=jnp.asarray(R_out), p=jnp.asarray(p_out),
                     X=jnp.asarray(X_out), obs=prob.obs, mask=prob.mask,
                     intr=prob.intr)
