"""Bilinear remap (undistortion gather) on device.

Reference parity: the scalar CPU loop at undistorter.cpp:410-434, with
identical blend weights (xxyy formulation) and invalid-pixel -> 0 semantics.

The op is a pure random gather: four flat takes, which XLA fuses into
one gather kernel.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def _remap_single(image: jnp.ndarray, remap: jnp.ndarray) -> jnp.ndarray:
    """image (H, W) or (H, W, C); remap (oh, ow, 2) of source (x, y)."""
    H, W = image.shape[:2]
    chan = image.ndim == 3
    img = image if chan else image[..., None]
    img_f = img.astype(jnp.float32)

    sx = remap[..., 0]
    sy = remap[..., 1]
    valid = sx >= 0

    x0 = jnp.clip(jnp.floor(sx), 0, W - 2).astype(jnp.int32)
    y0 = jnp.clip(jnp.floor(sy), 0, H - 2).astype(jnp.int32)
    fx = jnp.clip(sx - x0, 0.0, 1.0)
    fy = jnp.clip(sy - y0, 0.0, 1.0)
    fxy = fx * fy

    flat = img_f.reshape(H * W, -1)
    base = y0 * W + x0
    p00 = jnp.take(flat, base, axis=0)
    p01 = jnp.take(flat, base + 1, axis=0)
    p10 = jnp.take(flat, base + W, axis=0)
    p11 = jnp.take(flat, base + W + 1, axis=0)

    # reference weights (undistorter.cpp:429-432)
    out = (
        fxy[..., None] * p11
        + (fy - fxy)[..., None] * p10
        + (fx - fxy)[..., None] * p01
        + (1.0 - fx - fy + fxy)[..., None] * p00
    )
    out = jnp.where(valid[..., None], out, 0.0)
    if jnp.issubdtype(image.dtype, jnp.integer):
        out = jnp.clip(jnp.round(out), 0, 255)
    out = out.astype(image.dtype)
    return out if chan else out[..., 0]


@jax.jit
def bilinear_remap(image: jnp.ndarray, remap: jnp.ndarray) -> jnp.ndarray:
    """Remap image(s) through a source-coordinate table.

    image: (..., H, W) or (..., H, W, C); remap: (oh, ow, 2).
    Batched leading dims are vmapped.
    """
    chan_dims = 3 if (image.ndim >= 3 and image.shape[-1] in (1, 2, 3, 4)) else 2
    batch_dims = image.ndim - chan_dims
    fn = _remap_single
    for _ in range(batch_dims):
        fn = jax.vmap(fn, in_axes=(0, None))
    return fn(image, remap)

