"""Edge maps and gradient kernels.

Reference parity: render/shaders/edge_detection.frag (3x3 neighborhood
average-absolute-difference on linearized depth with soft threshold
[0.05, 0.10] and a 5-pixel border guard). The op is a pure stencil,
expressed as fused XLA shifts (`depth_edge`) batched over pose
hypotheses — the inner loop of object-pose likelihood evaluation.

Divergence from the reference renderer: our rasterizer produces *linear*
depth directly (no OpenGL nonlinear z-buffer), so `depth_edge` takes metric
depth with `inf`/<=0 marking background. `linearize_gl_depth` reproduces
the GL depth-buffer transform (edge_detection.frag:33-36) for parity tests
against GL-convention data.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

THRESH_LOW = 0.05   # edge_detection.frag:14
THRESH_HIGH = 0.10  # edge_detection.frag:15
BORDER = 5          # edge_detection.frag:43-44


def linearize_gl_depth(z: jnp.ndarray, z_near: float, z_far: float) -> jnp.ndarray:
    """GL depth-buffer value in [0,1] -> metric depth; z==1 (far plane /
    background) -> -1 (edge_detection.frag:33-36)."""
    lin = 2.0 * z_near * z_far / (z_far + z_near - (2.0 * z - 1.0) * (z_far - z_near))
    return jnp.where(z == 1.0, -1.0, lin)


def soft_threshold(value: jnp.ndarray, lo: float = THRESH_LOW,
                   hi: float = THRESH_HIGH) -> jnp.ndarray:
    """<lo -> 0, >=hi -> 1, else linear ramp (edge_detection.frag:22-26)."""
    return jnp.clip((value - lo) / (hi - lo), 0.0, 1.0)


def _edge_from_linear(v: jnp.ndarray, lo: float, hi: float) -> jnp.ndarray:
    """Core stencil on a linear-depth image v (H, W); background <= 0."""
    H, W = v.shape[-2:]

    def sh(dy, dx):
        # shift with edge replication; border is masked out anyway
        return jnp.roll(v, (-dy, -dx), axis=(-2, -1))

    # frag indices: value[i] at (pos.x + ox*dx, pos.y + oy*dy) where
    # x ~ cols. delta = .25*(|v1-v7| + |v5-v3| + |v0-v8| + |v2-v6|)
    # v1=(x-1,y), v7=(x+1,y); v5=(x,y+1), v3=(x,y-1); diagonals.
    delta = 0.25 * (
        jnp.abs(sh(0, -1) - sh(0, 1))
        + jnp.abs(sh(1, 0) - sh(-1, 0))
        + jnp.abs(sh(-1, -1) - sh(1, 1))
        + jnp.abs(sh(1, -1) - sh(-1, 1))
    )
    out = soft_threshold(delta, lo, hi)
    out = jnp.where(v > 0, out, 0.0)  # background (frag:60)

    row = jnp.arange(H)[:, None]
    col = jnp.arange(W)[None, :]
    # frag border guard in normalized coords: pos < 5*d or > 1 - 5*d
    inside = ((col >= BORDER) & (col <= W - 1 - BORDER)
              & (row >= BORDER) & (row <= H - 1 - BORDER))
    return jnp.where(inside, out, 0.0)


@functools.partial(jax.jit, static_argnames=("lo", "hi"))
def depth_edge(depth: jnp.ndarray, lo: float = THRESH_LOW,
               hi: float = THRESH_HIGH) -> jnp.ndarray:
    """Edge map from linear depth (..., H, W); background: <=0 or inf."""
    v = jnp.where(jnp.isfinite(depth) & (depth > 0), depth, -1.0)
    fn = _edge_from_linear
    for _ in range(depth.ndim - 2):
        fn = jax.vmap(fn, in_axes=(0, None, None))
    return fn(v, lo, hi)


# ---------------------------------------------------------------------------
# Frontend gradient kernels (for corner detection / photometric tracking)
# ---------------------------------------------------------------------------

SOBEL_X = jnp.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], jnp.float32) / 8.0
SOBEL_Y = SOBEL_X.T


@jax.jit
def sobel_gradients(image: jnp.ndarray):
    """(H, W) float image -> (gx, gy), same shape, zero padding.

    Expressed as padded static shifts + elementwise adds, which XLA fuses
    into one pass, instead of a 1-input-channel conv."""
    img = image.astype(jnp.float32)
    H, W = img.shape
    xp = jnp.pad(img, 1)

    def s(dy, dx):
        return xp[1 + dy : 1 + dy + H, 1 + dx : 1 + dx + W]

    east_west = s(0, 1) - s(0, -1)
    ne_nw = s(-1, 1) - s(-1, -1)
    se_sw = s(1, 1) - s(1, -1)
    gx = (ne_nw + 2.0 * east_west + se_sw) / 8.0
    south_north = s(1, 0) - s(-1, 0)
    gy = ((s(1, -1) - s(-1, -1)) + 2.0 * south_north
          + (s(1, 1) - s(-1, 1))) / 8.0
    return gx, gy


def _box_sum(x: jnp.ndarray, window: int) -> jnp.ndarray:
    """Separable zero-padded `window`x`window` box sum via shift-adds."""
    r = window // 2
    H, W = x.shape

    def sum_axis(v, axis):
        pad = [(0, 0), (0, 0)]
        pad[axis] = (r, r)
        vp = jnp.pad(v, pad)
        acc = None
        for k in range(window):
            sl = (slice(k, k + H), slice(None)) if axis == 0 \
                else (slice(None), slice(k, k + W))
            acc = vp[sl] if acc is None else acc + vp[sl]
        return acc

    return sum_axis(sum_axis(x, 0), 1)


@functools.partial(jax.jit, static_argnames=("window",))
def shi_tomasi_response(image: jnp.ndarray, window: int = 5) -> jnp.ndarray:
    """Min-eigenvalue corner response (the frontend's detector score).

    lambda_min of the structure tensor summed over a `window` box; computed
    in closed form: 0.5*(a+c - sqrt((a-c)^2 + 4b^2)).
    """
    gx, gy = sobel_gradients(image)
    a, b, c = gx * gx, gx * gy, gy * gy

    A, B, C = (_box_sum(a, window), _box_sum(b, window),
               _box_sum(c, window))
    disc = jnp.sqrt(jnp.maximum((A - C) ** 2 + 4.0 * B * B, 0.0))
    return 0.5 * (A + C - disc)
