"""Brute-force nearest neighbors as matmuls.

No trees on the device: pairwise distances are a matmul
(||a-b||^2 = ||a||^2 + ||b||^2 - 2 a.b), tiled over query chunks so memory
stays bounded. O(N*M) flops run as dense matmuls, which suit the
accelerator better than tree traversal for the point counts the eval
pipeline uses (<= 500k x 50k).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("chunk",))
def nearest_neighbors(query: jnp.ndarray, ref: jnp.ndarray,
                      ref_valid=None, chunk: int = 2048):
    """For each query point, index + squared distance of nearest ref point.

    query (N,3), ref (M,3); ref_valid optional (M,) bool (padded refs).
    Returns (idx (N,) int32, d2 (N,) float32).
    """
    N = query.shape[0]
    pad = (-N) % chunk
    q = jnp.pad(query, ((0, pad), (0, 0)))
    r2 = jnp.sum(ref * ref, axis=1)
    if ref_valid is not None:
        r2 = jnp.where(ref_valid, r2, jnp.inf)

    def body(qc):
        q2 = jnp.sum(qc * qc, axis=1)
        d2 = q2[:, None] + r2[None, :] - 2.0 * qc @ ref.T
        idx = jnp.argmin(d2, axis=1)
        best = jnp.take_along_axis(d2, idx[:, None], axis=1)[:, 0]
        return idx.astype(jnp.int32), jnp.maximum(best, 0.0)

    idx, d2 = jax.lax.map(body, q.reshape(-1, chunk, 3))
    return idx.reshape(-1)[:N], d2.reshape(-1)[:N]
