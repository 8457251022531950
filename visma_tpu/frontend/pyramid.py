"""Image pyramids (2x2 average pooling per level)."""
from __future__ import annotations

import functools
from typing import List

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("levels",))
def build_pyramid(image: jnp.ndarray, levels: int = 3) -> List[jnp.ndarray]:
    """Grayscale (H, W) float32 -> list of `levels` images, level 0 full res.

    H, W must be divisible by 2^(levels-1).
    """
    img = image.astype(jnp.float32)
    pyr = [img]
    for _ in range(levels - 1):
        # 2x2 average pool as one reduce_window (no reshape relayout)
        img = jax.lax.reduce_window(img, 0.0, jax.lax.add, (2, 2), (2, 2),
                                    "VALID") * 0.25
        pyr.append(img)
    return pyr
