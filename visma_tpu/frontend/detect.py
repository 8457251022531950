"""Corner detection: Shi-Tomasi response + NMS + grid-distributed top-k.

Grid bucketing (best corner per cell, then global top-k over cells) gives
spatially spread features with fully static shapes — no dynamic
suppression loops.

The response chain (Sobel, structure tensor, box sums, min-eigenvalue,
3x3 NMS, border/threshold mask) is plain XLA stencil code, which fuses.
Cell bucketing avoids the (gh,cell,gw,cell) transpose relayout with two
stride-`cell` reduce_windows (per-cell max, then per-cell argmax of the
masked linear index).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from visma_tpu.image.edges import shi_tomasi_response


def corner_score(image: jnp.ndarray, window: int, border: int,
                      min_response: float) -> jnp.ndarray:
    resp = shi_tomasi_response(image, window=window)
    neigh = jax.lax.reduce_window(resp, -jnp.inf, jax.lax.max, (3, 3),
                                  (1, 1), "SAME")
    is_max = resp >= neigh
    H, W = image.shape
    row = jnp.arange(H)[:, None]
    col = jnp.arange(W)[None, :]
    inside = ((row >= border) & (row < H - border)
              & (col >= border) & (col < W - border))
    return jnp.where(is_max & inside & (resp > min_response), resp, 0.0)


@functools.partial(jax.jit, static_argnames=("max_features", "cell",
                                             "border"))
def detect_features(image: jnp.ndarray, max_features: int = 64,
                    cell: int = 16, border: int = 8,
                    min_response: float = 1e-4,
                    occupied: jnp.ndarray = None):
    """Detect up to `max_features` corners.

    image: (H, W) float32 (grayscale, any scale).
    occupied: optional (H//cell, W//cell) bool — cells to skip (cells
    already holding live tracks, for replenishment).

    Returns (xy (N,2) float32 pixel coords, score (N,), valid (N,)).
    """
    H, W = image.shape
    score = corner_score(image, 5, border, min_response)

    # best corner per cell without the (gh,cell,gw,cell) transpose:
    # stride-`cell` reduce_windows give the per-cell max and the per-cell
    # argmax (max of the masked linear index; ties -> last)
    gh, gw = H // cell, W // cell
    Hc, Wc = gh * cell, gw * cell
    sc = score[:Hc, :Wc]
    cellmax = jax.lax.reduce_window(sc, -jnp.inf, jax.lax.max,
                                    (cell, cell), (cell, cell), "VALID")
    up = jnp.repeat(jnp.repeat(cellmax, cell, axis=0), cell, axis=1)
    row = jnp.arange(Hc, dtype=jnp.int32)[:, None]
    col = jnp.arange(Wc, dtype=jnp.int32)[None, :]
    lin = jnp.where((sc == up) & (sc > 0), row * Wc + col, -1)
    cell_idx = jax.lax.reduce_window(lin, jnp.int32(-1),
                                     jax.lax.max, (cell, cell),
                                     (cell, cell), "VALID")

    best_score = jnp.maximum(cellmax, 0.0).reshape(-1)
    best_score = jnp.where(cell_idx.reshape(-1) >= 0, best_score, 0.0)
    if occupied is not None:
        best_score = jnp.where(occupied.reshape(-1), 0.0, best_score)

    idx_flat = cell_idx.reshape(-1)
    cy = jnp.maximum(idx_flat, 0) // Wc
    cx = jnp.maximum(idx_flat, 0) % Wc

    k = min(max_features, gh * gw)
    top_score, top_idx = jax.lax.top_k(best_score, k)
    xy = jnp.stack([cx[top_idx], cy[top_idx]], axis=-1).astype(jnp.float32)
    valid = top_score > 0
    if k < max_features:
        pad = max_features - k
        xy = jnp.pad(xy, ((0, pad), (0, 0)))
        top_score = jnp.pad(top_score, (0, pad))
        valid = jnp.pad(valid, (0, pad))
    return xy, top_score, valid
