"""Pyramidal inverse-compositional Lucas-Kanade tracking.

Windowed formulation (the production path): instead of one per-feature
random access per LK iteration,

  1. per pyramid level, extract one (WIN x WIN) window per feature with
     ONE-HOT SELECTION MATMULS (rows then columns);
  2. every LK iteration samples its patch INSIDE the windows with
     separable bilinear interpolation expressed as two tiny batched
     matmuls (P = A @ W @ B^T, where A/B carry the two-tap bilinear
     weights) — no gathers, fully batched over features.

Window margins bound the refinement each level may add on top of the
coarse-to-fine initial guess; samples clamp to the window (features that
really moved further fail the residual / forward-backward gates, matching
the old implementation's border-clamp behavior).

Selection/sampling matmuls run at HIGHEST precision: at a reduced
precision (TF32 or bf16 passes), "selecting" a pixel would round its
intensity and corrupt the subpixel solve.

The pre-r2 gather-based implementation is kept as
`track_features_gather` (the correctness oracle in tests/test_frontend).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_HI = jax.lax.Precision.HIGHEST


def _sample_patch(img: jnp.ndarray, center: jnp.ndarray, radius: int):
    """Bilinear (2r+1)^2 patch around `center` (x, y).

    TPU-shaped: ONE dynamic_slice of a (2r+2)^2 window + 4 shifted
    sub-window multiplies, instead of 4*(2r+1)^2 scattered element
    gathers (the patch grid is regular, so the fractional offset is
    uniform across the patch). Near the image border the window clamps
    (slides inward) rather than clamping per pixel — features that close
    to the border are rejected by track_features' in-bounds gate anyway.
    """
    H, W = img.shape
    r = radius
    n = 2 * r + 2
    x0 = jnp.clip(jnp.floor(center[0]) - r, 0, W - n)
    y0 = jnp.clip(jnp.floor(center[1]) - r, 0, H - n)
    fx = jnp.clip(center[0] - r - x0, 0.0, 1.0)
    fy = jnp.clip(center[1] - r - y0, 0.0, 1.0)
    win = jax.lax.dynamic_slice(
        img, (y0.astype(jnp.int32), x0.astype(jnp.int32)), (n, n))
    m = 2 * r + 1
    return (win[0:m, 0:m] * (1 - fx) * (1 - fy)
            + win[0:m, 1 : m + 1] * fx * (1 - fy)
            + win[1 : m + 1, 0:m] * (1 - fx) * fy
            + win[1 : m + 1, 1 : m + 1] * fx * fy)


def _template_and_grads(img: jnp.ndarray, center: jnp.ndarray, radius: int):
    """Template patch + its spatial gradients from ONE (2r+4)^2 window.

    T is the bilinear patch; Tx/Ty are central differences of the
    bilinear surface, which reduce to differences of shifted sub-windows
    of the same slice (no extra dynamic_slices)."""
    H, W = img.shape
    r = radius
    n = 2 * r + 4                       # +1 px margin each side
    x0 = jnp.clip(jnp.floor(center[0]) - r - 1, 0, W - n)
    y0 = jnp.clip(jnp.floor(center[1]) - r - 1, 0, H - n)
    fx = jnp.clip(center[0] - r - 1 - x0, 0.0, 1.0)
    fy = jnp.clip(center[1] - r - 1 - y0, 0.0, 1.0)
    win = jax.lax.dynamic_slice(
        img, (y0.astype(jnp.int32), x0.astype(jnp.int32)), (n, n))
    m = 2 * r + 1

    def interp(i0, j0):
        return (win[i0 : i0 + m, j0 : j0 + m] * (1 - fx) * (1 - fy)
                + win[i0 : i0 + m, j0 + 1 : j0 + m + 1] * fx * (1 - fy)
                + win[i0 + 1 : i0 + m + 1, j0 : j0 + m] * (1 - fx) * fy
                + win[i0 + 1 : i0 + m + 1, j0 + 1 : j0 + m + 1] * fx * fy)

    T = interp(1, 1)
    Tx = 0.5 * (interp(1, 2) - interp(1, 0))
    Ty = 0.5 * (interp(2, 1) - interp(0, 1))
    return T, Tx, Ty


def _track_level(prev_img, cur_img, pt_prev, guess, radius, iters):
    """One pyramid level of inverse-compositional LK for one feature
    (gather-based single-feature path; see _track_level_batched for the
    production windowed form)."""
    T, Tx, Ty = _template_and_grads(prev_img, pt_prev, radius)
    Gxx = jnp.sum(Tx * Tx)
    Gxy = jnp.sum(Tx * Ty)
    Gyy = jnp.sum(Ty * Ty)
    det = Gxx * Gyy - Gxy * Gxy
    ok = det > 1e-6
    inv_det = jnp.where(ok, 1.0 / jnp.maximum(det, 1e-12), 0.0)

    def body(_, d):
        I = _sample_patch(cur_img, pt_prev + d, radius)
        e = I - T
        bx = jnp.sum(Tx * e)
        by = jnp.sum(Ty * e)
        dx = inv_det * (Gyy * bx - Gxy * by)
        dy = inv_det * (-Gxy * bx + Gxx * by)
        return d - jnp.stack([dx, dy])

    d = jax.lax.fori_loop(0, iters, body, guess)
    I = _sample_patch(cur_img, pt_prev + d, radius)
    res = jnp.sqrt(jnp.mean((I - T) ** 2))
    return d, res, ok


@functools.partial(jax.jit, static_argnames=("radius", "iters", "levels"))
def track_features_gather(prev_pyr, cur_pyr, pts: jnp.ndarray,
                          valid: jnp.ndarray, radius: int = 5,
                          iters: int = 8, levels: int = 3,
                          max_residual: float = 12.0,
                          fb_thresh: float = 1.0):
    """Pre-r2 gather-based tracker (vmap of per-feature dynamic slices).

    Same contract as track_features; kept as the test oracle (one gather
    per LK iteration)."""
    H, W = cur_pyr[0].shape

    def one(pt, ok_in):
        d = jnp.zeros(2)
        ok = ok_in
        for lv in range(levels - 1, -1, -1):
            scale = 2.0 ** lv
            dl, res, ok_l = _track_level(prev_pyr[lv], cur_pyr[lv],
                                         pt / scale, d / scale, radius, iters)
            d = dl * scale
            ok = ok & ok_l
        new_pt = pt + d

        db, _, _ = _track_level(cur_pyr[0], prev_pyr[0], new_pt, -d, radius,
                                iters)
        fb_err = jnp.linalg.norm(db + d)

        I = _sample_patch(cur_pyr[0], new_pt, radius)
        Tp = _sample_patch(prev_pyr[0], pt, radius)
        res0 = jnp.sqrt(jnp.mean((I - Tp) ** 2))

        inb = ((new_pt[0] >= radius + 1) & (new_pt[0] < W - radius - 1)
               & (new_pt[1] >= radius + 1) & (new_pt[1] < H - radius - 1))
        ok = ok & inb & (res0 < max_residual) & (fb_err < fb_thresh) \
             & jnp.all(jnp.isfinite(new_pt))
        return jnp.where(ok, new_pt, pt), ok

    return jax.vmap(one)(pts, valid)


# ---------------------------------------------------------------------------
# Windowed batched implementation (the production path)
# ---------------------------------------------------------------------------

def _extract_windows(img: jnp.ndarray, centers: jnp.ndarray, win: int):
    """One (win, win) window per feature via one-hot selection matmuls.

    img (H, W); centers (K, 2) as (x, y) float. Window origins are
    round(center) - win//2, clipped to the image. Returns
    (windows (K, win, win), origin_xy (K, 2) int32).
    """
    H, W = img.shape
    cx, cy = centers[:, 0], centers[:, 1]
    y0 = jnp.clip(jnp.round(cy).astype(jnp.int32) - win // 2, 0, H - win)
    x0 = jnp.clip(jnp.round(cx).astype(jnp.int32) - win // 2, 0, W - win)

    rows = y0[:, None] + jnp.arange(win, dtype=jnp.int32)[None, :]  # (K,win)
    A = (rows[:, :, None]
         == jnp.arange(H, dtype=jnp.int32)[None, None, :]).astype(img.dtype)
    # rows-then-columns: the matmul unit does the gathering
    R = jnp.einsum("kih,hw->kiw", A, img, precision=_HI)

    cols = x0[:, None] + jnp.arange(win, dtype=jnp.int32)[None, :]
    B = (cols[:, :, None]
         == jnp.arange(W, dtype=jnp.int32)[None, None, :]).astype(img.dtype)
    wins = jnp.einsum("kiw,kjw->kij", R, B, precision=_HI)
    return wins, jnp.stack([x0, y0], axis=-1)


def _bilinear_taps(off: jnp.ndarray, m: int, win: int):
    """Two-tap bilinear selection matrix (K, m, win) for per-feature float
    offsets `off` (K,): row i selects (1-f)*w[i+o] + f*w[i+o+1]."""
    # max origin: floor(off) + (m-1) + 1 <= win-1  =>  off < win - m
    off = jnp.clip(off, 0.0, win - m - 1e-4)
    o = jnp.floor(off)
    f = (off - o)[:, None, None]
    rows = o[:, None].astype(jnp.int32) \
        + jnp.arange(m, dtype=jnp.int32)[None, :]            # (K,m)
    idx = jnp.arange(win, dtype=jnp.int32)[None, None, :]
    t0 = (rows[:, :, None] == idx).astype(jnp.float32)
    t1 = (rows[:, :, None] + 1 == idx).astype(jnp.float32)
    return (1.0 - f) * t0 + f * t1


def _sample_windows(wins: jnp.ndarray, off_xy: jnp.ndarray, m: int):
    """Sample an (m, m) bilinear patch from each window; patch pixel (i,j)
    sits at window coord (off_y + i, off_x + j). wins (K, win, win);
    off_xy (K, 2) float. Separable: P = A @ W @ B^T."""
    win = wins.shape[-1]
    A = _bilinear_taps(off_xy[:, 1], m, win)                  # rows
    B = _bilinear_taps(off_xy[:, 0], m, win)                  # cols
    P = jnp.einsum("kiw,kwv->kiv", A, wins, precision=_HI)
    return jnp.einsum("kiv,kjv->kij", P, B, precision=_HI)


def _track_level_batched(winsP, orgP, winsC, orgC, pts_l, guess, radius,
                         iters):
    """One pyramid level of inverse-compositional LK for ALL features.

    winsP/winsC (K, win, win): prev/cur windows with integer origins
    orgP/orgC (K, 2) (x, y); pts_l (K, 2): feature positions at this
    level's scale; guess (K, 2): incoming displacement estimate.
    Returns (d (K, 2), residual (K,), ok (K,)).
    """
    m = 2 * radius + 1
    # template top-left continuous coord = pt - r
    offT = pts_l - radius - orgP.astype(jnp.float32)
    T = _sample_windows(winsP, offT, m)
    Tx = 0.5 * (_sample_windows(winsP, offT + jnp.array([1.0, 0.0]), m)
                - _sample_windows(winsP, offT - jnp.array([1.0, 0.0]), m))
    Ty = 0.5 * (_sample_windows(winsP, offT + jnp.array([0.0, 1.0]), m)
                - _sample_windows(winsP, offT - jnp.array([0.0, 1.0]), m))
    Gxx = jnp.sum(Tx * Tx, axis=(1, 2))
    Gxy = jnp.sum(Tx * Ty, axis=(1, 2))
    Gyy = jnp.sum(Ty * Ty, axis=(1, 2))
    det = Gxx * Gyy - Gxy * Gxy
    ok = det > 1e-6
    inv_det = jnp.where(ok, 1.0 / jnp.maximum(det, 1e-12), 0.0)

    orgCf = orgC.astype(jnp.float32)

    def body(_, d):
        I = _sample_windows(winsC, pts_l + d - radius - orgCf, m)
        e = I - T
        bx = jnp.sum(Tx * e, axis=(1, 2))
        by = jnp.sum(Ty * e, axis=(1, 2))
        dx = inv_det * (Gyy * bx - Gxy * by)
        dy = inv_det * (-Gxy * bx + Gxx * by)
        return d - jnp.stack([dx, dy], axis=-1)

    d = jax.lax.fori_loop(0, iters, body, guess)
    I = _sample_windows(winsC, pts_l + d - radius - orgCf, m)
    res = jnp.sqrt(jnp.mean((I - T) ** 2, axis=(1, 2)))
    return d, res, ok


@functools.partial(jax.jit, static_argnames=("radius", "iters", "levels",
                                             "win"))
def track_features(prev_pyr, cur_pyr, pts: jnp.ndarray, valid: jnp.ndarray,
                   radius: int = 5, iters: int = 8, levels: int = 3,
                   max_residual: float = 12.0, fb_thresh: float = 1.0,
                   win: int = 40):
    """Track `pts` (N,2) from prev to cur pyramid (windowed batched LK).

    Returns (new_pts (N,2), still_valid (N,)). Validity requires LK
    convergence at every level, in-bounds result, residual below
    `max_residual` (intensity units), and forward-backward error below
    `fb_thresh` pixels.

    win: per-feature window size; its margin (win/2 - radius - 1) bounds
    how far a level's refinement may move beyond the coarse-level guess.
    """
    H, W = cur_pyr[0].shape
    r = radius

    d = jnp.zeros_like(pts)
    ok = valid
    winsP0 = orgP0 = winsC0 = orgC0 = None
    pts0 = None
    for lv in range(levels - 1, -1, -1):
        scale = 2.0 ** lv
        Hl, Wl = prev_pyr[lv].shape
        wl = min(win, (Hl // 8) * 8 or Hl, (Wl // 8) * 8 or Wl)
        pts_l = pts / scale
        winsP, orgP = _extract_windows(prev_pyr[lv], pts_l, wl)
        winsC, orgC = _extract_windows(cur_pyr[lv], pts_l + d / scale, wl)
        dl, res, ok_l = _track_level_batched(
            winsP, orgP, winsC, orgC, pts_l, d / scale, r, iters)
        d = dl * scale
        ok = ok & ok_l
        if lv == 0:
            winsP0, orgP0, winsC0, orgC0, pts0 = (winsP, orgP, winsC,
                                                  orgC, pts_l)
    new_pt = pts + d

    # forward-backward check at level 0: template from CUR at new_pt,
    # iterate sampling PREV — both windows already extracted (new_pt is
    # within winsC0's margin of its center; -d lands back inside winsP0)
    db, _, _ = _track_level_batched(winsC0, orgC0, winsP0, orgP0,
                                    new_pt, -d, r, iters)
    fb_err = jnp.linalg.norm(db + d, axis=-1)

    m = 2 * r + 1
    I = _sample_windows(winsC0, new_pt - r - orgC0.astype(jnp.float32), m)
    Tp = _sample_windows(winsP0, pts0 - r - orgP0.astype(jnp.float32), m)
    res0 = jnp.sqrt(jnp.mean((I - Tp) ** 2, axis=(1, 2)))

    inb = ((new_pt[:, 0] >= r + 1) & (new_pt[:, 0] < W - r - 1)
           & (new_pt[:, 1] >= r + 1) & (new_pt[:, 1] < H - r - 1))
    ok = ok & inb & (res0 < max_residual) & (fb_err < fb_thresh) \
        & jnp.all(jnp.isfinite(new_pt), axis=-1)
    return jnp.where(ok[:, None], new_pt, pts), ok
