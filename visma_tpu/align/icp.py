"""Iterative closest point (Open3D RegistrationICP parity:
evaluation.cpp:260-271, annotation.cpp:45-57).

Point-to-point (Umeyama inner solve) and point-to-plane (linear 6-dof
solve) variants; correspondences by tiled brute-force NN with a
max_distance gate; fixed iteration count under lax.scan. Reports
`fitness` (inlier fraction) and `inlier_rmse` exactly as Open3D defines
them (the numbers the reference prints, evaluation.cpp:272).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from visma_tpu.align.nn import nearest_neighbors
from visma_tpu.align.umeyama import umeyama
from visma_tpu.geom.rotations import hat, mm, rodrigues


@dataclass
class IcpResult:
    transformation: np.ndarray  # (4,4)
    fitness: float
    inlier_rmse: float
    correspondences: int


@functools.partial(jax.jit, static_argnames=("k", "chunk"))
def _estimate_normals(points: jnp.ndarray, valid, k: int = 12,
                      chunk: int = 512):
    """PCA normals from k-NN (for point-to-plane).

    Tiled over query chunks so peak memory is chunk*N, not N*N — the
    reference operating point is 50k samples/model (cfg/tool.json:31,
    evaluation.cpp:258-271), where a dense N^2 matrix would be ~10 GB.
    Distances are a matmul (||a-b||^2 expansion).
    """
    N = points.shape[0]
    pad = (-N) % chunk
    q = jnp.pad(points, ((0, pad), (0, 0)))
    r2 = jnp.sum(points * points, axis=1)
    r2 = jnp.where(valid, r2, jnp.inf)

    def body(qc):
        q2 = jnp.sum(qc * qc, axis=1)
        d2 = q2[:, None] + r2[None, :] - 2.0 * qc @ points.T
        _, idx = jax.lax.top_k(-d2, k)
        neigh = points[idx]                   # (chunk,k,3)
        mu = neigh.mean(axis=1, keepdims=True)
        cov = jnp.einsum("nki,nkj->nij", neigh - mu, neigh - mu)
        _, vecs = jnp.linalg.eigh(cov)
        return vecs[..., 0]                   # smallest eigenvector

    normals = jax.lax.map(body, q.reshape(-1, chunk, 3))
    return normals.reshape(-1, 3)[:N]


def _transform(T, pts):
    return pts @ T[:3, :3].T + T[:3, 3]


@functools.partial(jax.jit, static_argnames=("max_iters", "point_to_plane"))
def _icp_core(src, src_valid, dst, dst_valid, dst_normals, T0,
              max_distance, max_iters: int, point_to_plane: bool):
    max_d2 = max_distance * max_distance

    def body(T, _):
        cur = _transform(T, src)
        idx, d2 = nearest_neighbors(cur, dst, dst_valid)
        w = (d2 < max_d2) & src_valid
        tgt = dst[idx]

        if point_to_plane:
            n = dst_normals[idx]
            r = jnp.sum((tgt - cur) * n, axis=1)
            J = jnp.concatenate([jnp.cross(cur, n), n], axis=1)  # (N,6)
            wf = w.astype(jnp.float32)
            H = mm((J * wf[:, None]).T, J)
            # Levenberg damping keeps null-space directions (e.g. in-plane
            # motion on planar scenes) from exploding
            H = H + (1e-3 * jnp.trace(H) / 6.0 + 1e-8) * jnp.eye(6)
            g = (J * wf[:, None]).T @ r
            xi = jnp.linalg.solve(H, g)
            dT = jnp.eye(4).at[:3, :3].set(rodrigues(xi[:3])).at[:3, 3].set(xi[3:])
            T_new = mm(dT, T)
        else:
            T_new = mm(umeyama(cur, tgt, weights=w.astype(jnp.float32)), T)
        return T_new, None

    T, _ = jax.lax.scan(body, T0, None, length=max_iters)

    cur = _transform(T, src)
    idx, d2 = nearest_neighbors(cur, dst, dst_valid)
    inlier = (d2 < max_d2) & src_valid
    n_in = jnp.sum(inlier)
    n_src = jnp.maximum(jnp.sum(src_valid), 1)
    fitness = n_in / n_src
    rmse = jnp.sqrt(jnp.sum(jnp.where(inlier, d2, 0.0))
                    / jnp.maximum(n_in, 1))
    return T, fitness, rmse, n_in


def icp(source, target, max_distance: float, init=None,
        max_iters: int = 30, point_to_plane: bool = False,
        source_valid=None, target_valid=None) -> IcpResult:
    """Align source onto target. Arrays are (N,3)/(M,3) jnp or numpy."""
    src = jnp.asarray(source, jnp.float32)
    dst = jnp.asarray(target, jnp.float32)
    sv = jnp.ones(src.shape[0], bool) if source_valid is None else source_valid
    dv = jnp.ones(dst.shape[0], bool) if target_valid is None else target_valid
    T0 = jnp.eye(4, dtype=jnp.float32) if init is None else \
        jnp.asarray(init, jnp.float32)
    normals = (_estimate_normals(dst, dv) if point_to_plane
               else jnp.zeros_like(dst))
    T, fit, rmse, n = _icp_core(src, sv, dst, dv, normals, T0,
                                float(max_distance), max_iters,
                                point_to_plane)
    return IcpResult(transformation=np.asarray(T), fitness=float(fit),
                     inlier_rmse=float(rmse), correspondences=int(n))
