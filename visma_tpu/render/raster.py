"""Exact triangle rasterizer: depth / mask / edge images from meshes.

Replaces the reference's OpenGL pipeline (render/renderer.cpp: hidden GLFW
window + FBO + glReadPixels) with one batched renderer: B hypotheses, each
a mesh at a pose, rendered into a window of the image (the full frame or a
per-hypothesis ROI). The papers' object-pose likelihood renders hundreds of
hypotheses per frame, which is the batch axis here.

Algorithm (static shapes throughout):
  1. triangle setup, batched over B: project the face corners and turn
     each triangle into affine plane coefficients in a pixel frame of its
     own (see _triangle_planes);
  2. binning: faces are Morton-sorted once per mesh, so CHUNK consecutive
     faces are spatially local; for every SUB x SUB subtile of the window,
     pack the ids of the chunks whose screen bbox overlaps it, plus their
     count;
  3. per (pose, subtile): loop over that subtile's chunks only, evaluate
     the 4 planes for every (pixel, triangle) pair and max-reduce 1/z
     (the z-buffer as a reduction, no scatter);
  4. lay the subtiles out as an image and invert 1/z.

Exact: every triangle is tested against every subtile its bbox touches —
no fixed-capacity drop. Step 3 has two forms over the same chunk lists,
chosen in one place (_raster_chunks): a Pallas kernel through Triton on the
GPU, and an XLA loop of elementwise updates on the CPU (~36x slower on the
GPU at the semantic mapper's shapes, so it serves only the CPU).

No backface culling (the reference doesn't enable GL_CULL_FACE).
Depth is metric with +inf background (see render/camera.py).
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from visma_tpu.render.camera import Intrinsics

SUB = 16      # binning subtile edge (px): one kernel program per subtile
CHUNK = 32    # consecutive (Morton-sorted) faces binned and tested together
NPL = 14      # values per triangle: 4 planes (a, b, c) + frame origin (x, y)

_HIGHEST = jax.lax.Precision.HIGHEST


def _project(V: jnp.ndarray, pose_cw: jnp.ndarray, intr: Intrinsics):
    """V (N,3) world/model -> screen xy (N,2), camera z (N,).

    pose_cw: (3,4) model/world -> camera transform. HIGHEST precision: a
    TF32 product moves a projected vertex by up to ~1 px at 960 px.
    """
    R, t = pose_cw[:, :3], pose_cw[:, 3]
    Vc = jnp.matmul(V, R.T, precision=_HIGHEST) + t
    z = Vc[:, 2]
    safe_z = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    u = intr.fx * Vc[:, 0] / safe_z + intr.cx
    v = intr.fy * Vc[:, 1] / safe_z + intr.cy
    return jnp.stack([u, v], axis=-1), z


# ---------------------------------------------------------------------------
# Triangle setup. For a triangle with screen vertices p0,p1,p2 and signed
# area A, each edge function w_i(p) and the perspective-correct 1/z are
# AFFINE in pixel coordinates d = p - o, relative to an integer pixel o at
# the triangle's first corner:
#     w_i(p)/A = a_i*dx + b_i*dy + c_i          (normalized barycentric)
#     1/z(p)   = az*dx + bz*dy + cz             (sum of barycentrics * 1/z_i)
# Dividing by A folds both windings into one test (inside <=> all w_i/A >= 0,
# no backface culling), and z-buffering becomes max(1/z), so the per-pixel
# work has no division. The local frame keeps the coefficients on the
# triangle's own scale: written for pixel (0, 0), cz extrapolates the
# gradient ~1000 px and f32 loses ~4e-4 relative depth at 960 px wide
# (float64 reference, bench meshes); with it, CPU and GPU agree to ~1e-6.
# d is exact in f32 (integer pixels minus an integer origin).
# ---------------------------------------------------------------------------

def _triangle_planes(C, poses_cw, intr: Intrinsics, origins=None):
    """C (B,T,3,3) model-frame face corners; poses_cw (B,3,4); origins (B,2)
    optional window top-lefts subtracted from the projected coords.

    Returns planes (B,T,NPL) = [a0,b0,c0, a1,b1,c1, a2,b2,c2, az,bz,cz,
    ox,oy] (o the triangle's frame origin), ok (B,T) and the screen bbox
    x0, x1, y0, y1 (each (B,T)). Degenerate or z-clipped triangles get the
    always-fail plane c0 = -1 and an empty bbox."""
    B, T = C.shape[:2]
    xy, z = jax.vmap(lambda V, P: _project(V, P, intr))(
        C.reshape(B, T * 3, 3), poses_cw)
    xy = xy.reshape(B, T, 3, 2)
    z = z.reshape(B, T, 3)
    if origins is not None:
        xy = xy - origins[:, None, None, :]
    o = jnp.floor(xy[..., 0, :])                              # (B,T,2)
    d = xy - o[..., None, :]
    x0, x1, x2 = d[..., 0, 0], d[..., 1, 0], d[..., 2, 0]
    y0, y1, y2 = d[..., 0, 1], d[..., 1, 1], d[..., 2, 1]
    z0, z1, z2 = z[..., 0], z[..., 1], z[..., 2]

    area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    zmin = jnp.minimum(jnp.minimum(z0, z1), z2)
    ok = (zmin > intr.z_near) & (zmin < intr.z_far) & (jnp.abs(area) > 1e-12)
    inv_area = jnp.where(ok, 1.0 / jnp.where(jnp.abs(area) > 1e-12, area,
                                             1.0), 0.0)

    def edge(xa, ya, xb, yb):
        # w(p) = (xb-xa)*(py-ya) - (yb-ya)*(px-xa)
        a = -(yb - ya)
        b = xb - xa
        c = (yb - ya) * xa - (xb - xa) * ya
        return a * inv_area, b * inv_area, c * inv_area

    a0, b0, c0 = edge(x1, y1, x2, y2)
    a1, b1, c1 = edge(x2, y2, x0, y0)
    a2, b2, c2 = edge(x0, y0, x1, y1)
    iz0 = jnp.where(ok, 1.0 / jnp.maximum(z0, 1e-9), 0.0)
    iz1 = jnp.where(ok, 1.0 / jnp.maximum(z1, 1e-9), 0.0)
    iz2 = jnp.where(ok, 1.0 / jnp.maximum(z2, 1e-9), 0.0)
    az = a0 * iz0 + a1 * iz1 + a2 * iz2
    bz = b0 * iz0 + b1 * iz1 + b2 * iz2
    cz = c0 * iz0 + c1 * iz1 + c2 * iz2
    c0 = jnp.where(ok, c0, -1.0)  # fail the inside test for dead triangles
    planes = jnp.stack([a0, b0, c0, a1, b1, c1, a2, b2, c2, az, bz, cz,
                        o[..., 0], o[..., 1]], -1)

    big = jnp.float32(1e9)
    xs = jnp.moveaxis(xy[..., 0], -1, 0)
    ys = jnp.moveaxis(xy[..., 1], -1, 0)
    bx0 = jnp.where(ok, jnp.min(xs, 0), big)
    bx1 = jnp.where(ok, jnp.max(xs, 0), -big)
    by0 = jnp.where(ok, jnp.min(ys, 0), big)
    by1 = jnp.where(ok, jnp.max(ys, 0), -big)
    return planes, ok, bx0, bx1, by0, by1


def _grid(intr: Intrinsics):
    """Subtile grid of a (rows, cols) window: (nsy, nsx)."""
    return -(-intr.rows // SUB), -(-intr.cols // SUB)


def _bin_chunks(C, poses_cw, intr: Intrinsics, origins=None):
    """Triangle setup + binning for B poses. Returns planes (B,nc,16,CHUNK)
    (rows NPL.. zero), ids (B,nsub,nc) i32 — per subtile, the overlapping
    chunk ids first, in chunk order — and counts (B,nsub) i32."""
    nsy, nsx = _grid(intr)
    B, T = C.shape[:2]
    pad = (-T) % CHUNK
    nc = (T + pad) // CHUNK

    planes, _, x0, x1, y0, y1 = _triangle_planes(C, poses_cw, intr, origins)
    fail = jnp.zeros((NPL,), jnp.float32).at[2].set(-1.0)
    planes = jnp.concatenate(
        [planes, jnp.broadcast_to(fail, (B, pad, NPL))], axis=1)
    big = jnp.float32(1e9)
    x0 = jnp.pad(x0, ((0, 0), (0, pad)), constant_values=big)
    x1 = jnp.pad(x1, ((0, 0), (0, pad)), constant_values=-big)
    y0 = jnp.pad(y0, ((0, 0), (0, pad)), constant_values=big)
    y1 = jnp.pad(y1, ((0, 0), (0, pad)), constant_values=-big)
    cx0 = x0.reshape(B, nc, CHUNK).min(-1)
    cx1 = x1.reshape(B, nc, CHUNK).max(-1)
    cy0 = y0.reshape(B, nc, CHUNK).min(-1)
    cy1 = y1.reshape(B, nc, CHUNK).max(-1)

    ty0 = jnp.arange(nsy) * SUB
    tx0 = jnp.arange(nsx) * SUB
    ov_x = (cx0[:, None, :] <= (tx0[None, :, None] + SUB - 1)) \
        & (cx1[:, None, :] >= tx0[None, :, None])               # (B,nsx,nc)
    ov_y = (cy0[:, None, :] <= (ty0[None, :, None] + SUB - 1)) \
        & (cy1[:, None, :] >= ty0[None, :, None])               # (B,nsy,nc)
    ov = (ov_y[:, :, None, :] & ov_x[:, None, :, :]).reshape(
        B, nsy * nsx, nc)
    score = ov.astype(jnp.int32) * (nc - jnp.arange(nc, dtype=jnp.int32))
    _, ids = jax.lax.top_k(score, nc)
    counts = jnp.sum(ov, axis=-1, dtype=jnp.int32)

    cpl = planes.reshape(B, nc, CHUNK, NPL).transpose(0, 1, 3, 2)
    cpl = jnp.pad(cpl, ((0, 0), (0, 0), (0, 16 - NPL), (0, 0)))
    return cpl, ids.astype(jnp.int32), counts


def _subtile_pixels(s, nsx):
    """Pixel centers (P,) x and y of subtile s (row-major over nsx)."""
    p = jax.lax.broadcasted_iota(jnp.int32, (SUB * SUB,), 0)
    px = ((s % nsx) * SUB + p % SUB).astype(jnp.float32)
    py = ((s // nsx) * SUB + p // SUB).astype(jnp.float32)
    return px, py


def _chunk_kernel(counts_ref, ids_ref, planes_ref, out_ref, *, nsx: int,
                  inv_near: float, inv_far: float):
    """One program per (pose b, subtile s): loops over the chunks binned to
    s, holds a (pixels, CHUNK) running max of 1/z in registers and reduces
    it over the triangle axis once at the end."""
    b = pl.program_id(0)
    s = pl.program_id(1)
    px, py = _subtile_pixels(s, nsx)
    px, py = px[:, None], py[:, None]

    def body(i, best):
        cid = ids_ref[b, s, i]
        dx = px - planes_ref[b, cid, 12, :][None, :]
        dy = py - planes_ref[b, cid, 13, :][None, :]

        def plane(k):
            return (dx * planes_ref[b, cid, 3 * k, :][None, :]
                    + dy * planes_ref[b, cid, 3 * k + 1, :][None, :]
                    + planes_ref[b, cid, 3 * k + 2, :][None, :])

        inside = (plane(0) >= 0) & (plane(1) >= 0) & (plane(2) >= 0)
        iz = plane(3)
        inside &= (iz > inv_far) & (iz < inv_near)
        return jnp.maximum(best, jnp.where(inside, iz, 0.0))

    best = jax.lax.fori_loop(0, counts_ref[b, s], body,
                             jnp.zeros((SUB * SUB, CHUNK), jnp.float32))
    out_ref[b, s, :] = jnp.max(best, axis=1)


def _raster_chunks_kernel(planes, ids, counts, intr: Intrinsics,
                          interpret: bool = False):
    """Pallas (Triton) form of step 3: inverse depth (B, nsub, SUB*SUB)."""
    B, nsub = counts.shape
    _, nsx = _grid(intr)
    return pl.pallas_call(
        functools.partial(_chunk_kernel, nsx=nsx,
                          inv_near=1.0 / intr.z_near,
                          inv_far=1.0 / intr.z_far),
        grid=(B, nsub),
        out_shape=jax.ShapeDtypeStruct((B, nsub, SUB * SUB), jnp.float32),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="chunk_raster",
    )(counts, ids, planes)


def _raster_chunks_xla(planes, ids, counts, intr: Intrinsics):
    """XLA form of step 3 over the same chunk lists: step (k, t) tests
    triangle t of the k-th listed chunk of every subtile at once (masked
    where k >= count) as one elementwise max update of the
    (B, nsub, pixels) image, for max(counts) * CHUNK steps."""
    B, nsub = counts.shape
    _, nsx = _grid(intr)
    px, py = _subtile_pixels(jnp.arange(nsub)[:, None], nsx)  # (nsub, P)
    inv_near, inv_far = 1.0 / intr.z_near, 1.0 / intr.z_far

    def body(i, best):
        k, t = i // CHUNK, i % CHUNK
        cid = jax.lax.dynamic_index_in_dim(ids, k, axis=2, keepdims=False)
        tri = jax.lax.dynamic_index_in_dim(planes, t, axis=3,
                                           keepdims=False)   # (B,nc,16)
        c = jnp.take_along_axis(tri, cid[:, :, None], axis=1)  # (B,nsub,16)
        dx, dy = px - c[..., 12, None], py - c[..., 13, None]

        def plane(j):
            return (dx * c[..., 3 * j, None] + dy * c[..., 3 * j + 1, None]
                    + c[..., 3 * j + 2, None])                 # (B,nsub,P)

        inside = (plane(0) >= 0) & (plane(1) >= 0) & (plane(2) >= 0)
        iz = plane(3)
        inside &= (iz > inv_far) & (iz < inv_near) \
            & (k < counts)[:, :, None]
        return jnp.maximum(best, jnp.where(inside, iz, 0.0))

    return jax.lax.fori_loop(0, jnp.max(counts) * CHUNK, body,
                             jnp.zeros((B, nsub, SUB * SUB), jnp.float32))


def _raster_chunks(planes, ids, counts, intr: Intrinsics, impl: str):
    """Step 3, the one place that picks its form. impl "auto": the Triton
    kernel on CUDA and the XLA form on the CPU, fixed when the computation
    is lowered for its platform (any other platform is an error).
    "kernel" / "interpret" / "xla" force one form — parity checks and
    CPU tests of the kernel ask for it by name."""
    kernel = functools.partial(_raster_chunks_kernel, intr=intr)
    xla = functools.partial(_raster_chunks_xla, intr=intr)
    if impl == "auto":
        return jax.lax.platform_dependent(planes, ids, counts, cuda=kernel,
                                          cpu=xla)
    if impl == "kernel":
        return kernel(planes, ids, counts)
    if impl == "interpret":
        return kernel(planes, ids, counts, interpret=True)
    if impl == "xla":
        return xla(planes, ids, counts)
    raise ValueError(f"unknown raster impl {impl!r}")


def _to_depth(inv, intr: Intrinsics):
    """(B, nsub, SUB*SUB) subtile-major inverse depth -> (B, rows, cols)
    metric depth, +inf background."""
    B = inv.shape[0]
    nsy, nsx = _grid(intr)
    img = inv.reshape(B, nsy, nsx, SUB, SUB).transpose(0, 1, 3, 2, 4)
    img = img.reshape(B, nsy * SUB, nsx * SUB)[:, :intr.rows, :intr.cols]
    return jnp.where(img > 0, 1.0 / jnp.maximum(img, 1e-12), jnp.inf)


def _roi_intr(intr: Intrinsics, roi) -> Intrinsics:
    return Intrinsics(fx=intr.fx, fy=intr.fy, cx=intr.cx, cy=intr.cy,
                      rows=roi[0], cols=roi[1],
                      z_near=intr.z_near, z_far=intr.z_far)


@functools.partial(jax.jit, static_argnames=("intr", "roi", "impl"))
def rasterize_depth_multi(Cs: jnp.ndarray, poses_cw: jnp.ndarray,
                          mesh_idx: jnp.ndarray, intr: Intrinsics,
                          roi=None, origins: Optional[jnp.ndarray] = None,
                          impl: str = "auto") -> jnp.ndarray:
    """The renderer: hypothesis b renders database mesh mesh_idx[b] at
    poses_cw[b] (B,3,4) model->camera. Returns depth (B, rows, cols), or
    (B, roi[0], roi[1]) windows whose top-left GLOBAL pixels are
    origins (B,2) = (x0, y0) when roi is given.

    Cs (M,Tmax,3,3): per-face corner positions of the padded, Morton-sorted
    mesh stack (mesh_corner_stack). A window equals the full-frame render
    cropped at the same origin up to float roundoff (the planes are affine
    in pixel coords; a window is a screen-space translation), for all
    geometry — the semantic CEM's key economy: object hypotheses cover a
    small screen region, so the per-hypothesis cost drops from H*W to the
    window size (the reference renders full frames per hypothesis,
    renderer.cpp:353-400)."""
    if roi is not None:
        intr = _roi_intr(intr, roi)
        origins = jnp.asarray(origins, jnp.float32)
    C = Cs[mesh_idx.astype(jnp.int32)]
    planes, ids, counts = _bin_chunks(C, poses_cw, intr, origins)
    return _to_depth(_raster_chunks(planes, ids, counts, intr, impl), intr)


def rasterize_depth(V: jnp.ndarray, F: jnp.ndarray, pose_cw: jnp.ndarray,
                    intr: Intrinsics, impl: str = "auto") -> jnp.ndarray:
    """Depth image (rows, cols) f32, +inf background, of one mesh at one
    pose: V (N,3) model vertices, F (T,3) int32 faces, pose_cw (3,4)
    model->camera. Batches go through rasterize_depth_multi."""
    C = jnp.asarray(V, jnp.float32)[jnp.asarray(F)][None]
    return rasterize_depth_multi(C, jnp.asarray(pose_cw)[None],
                                 jnp.zeros((1,), jnp.int32), intr,
                                 impl=impl)[0]


@functools.partial(jax.jit, static_argnames=("intr", "roi", "chunk"))
def rasterize_depth_brute(V: jnp.ndarray, F: jnp.ndarray, pose_cw: jnp.ndarray,
                          intr: Intrinsics, roi=None,
                          origin: Optional[jnp.ndarray] = None,
                          chunk: int = 8) -> jnp.ndarray:
    """Reference implementation: every pixel against every triangle's
    planes, scanned in triangle chunks — no binning, no kernel (the
    correctness oracle for rasterize_depth_multi, window included: roi +
    origin (x0, y0) as there)."""
    if roi is not None:
        intr = _roi_intr(intr, roi)
        origin = jnp.asarray(origin, jnp.float32)[None]
    H, W = intr.rows, intr.cols
    C = jnp.asarray(V, jnp.float32)[F][None]
    planes = _triangle_planes(C, pose_cw[None], intr, origin)[0][0]
    T = planes.shape[0]
    fail = jnp.zeros((NPL,), jnp.float32).at[2].set(-1.0)
    planes = jnp.concatenate(
        [planes, jnp.broadcast_to(fail, ((-T) % chunk, NPL))])
    yy, xx = jnp.mgrid[0:H, 0:W]
    px = xx.reshape(1, -1).astype(jnp.float32)
    py = yy.reshape(1, -1).astype(jnp.float32)

    def body(best, c):
        dx, dy = px - c[:, 12, None], py - c[:, 13, None]

        def plane(k):
            return (dx * c[:, 3 * k, None] + dy * c[:, 3 * k + 1, None]
                    + c[:, 3 * k + 2, None])                 # (chunk, P)

        inside = (plane(0) >= 0) & (plane(1) >= 0) & (plane(2) >= 0)
        iz = plane(3)
        inside &= (iz > 1.0 / intr.z_far) & (iz < 1.0 / intr.z_near)
        return jnp.maximum(best, jnp.max(jnp.where(inside, iz, 0.0), 0)), \
            None

    inv, _ = jax.lax.scan(body, jnp.zeros(H * W, jnp.float32),
                          planes.reshape(-1, chunk, NPL))
    inv = inv.reshape(H, W)
    return jnp.where(inv > 0, 1.0 / jnp.maximum(inv, 1e-12), jnp.inf)


def sort_faces_morton(V: np.ndarray, F: np.ndarray) -> np.ndarray:
    """Reorder faces by Morton code of their centroid (host-side, once per
    mesh), so consecutive faces — one chunk — are spatially local. The
    rendered image is identical for any face order."""
    V = np.asarray(V, np.float64)
    F = np.asarray(F, np.int64)
    cent = V[F].mean(axis=1)
    lo, hi = cent.min(0), cent.max(0)
    q = ((cent - lo) / np.maximum(hi - lo, 1e-12) * 1023).astype(np.uint64)

    def spread(x):
        x &= 0x3FF
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    code = (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])
    return np.asarray(F[np.argsort(code, kind="stable")], np.int32)


def mesh_corner_stack(meshes) -> jnp.ndarray:
    """Per-face corner positions (M,Tmax,3,3) f32 of a list of (V, F)
    meshes, faces Morton-sorted per mesh. Shorter meshes are padded with
    all-zero faces (zero area, rejected by the triangle setup). Built on
    the host once per mesh database, so no per-call V[F] gather exists."""
    Tmax = max(len(F) for _, F in meshes)
    Cs = np.zeros((len(meshes), Tmax, 3, 3), np.float32)
    for i, (V, F) in enumerate(meshes):
        V = np.asarray(V, np.float32)
        Fm = sort_faces_morton(V, np.asarray(F))
        Cs[i, : len(Fm)] = V[Fm]
    return jnp.asarray(Cs)


def _batch_poses(g_cm):
    g = jnp.asarray(g_cm, jnp.float32)
    if g.shape[-2:] == (4, 4):
        g = g[..., :3, :]
    return g.reshape(-1, 3, 4), g.shape[:-2]


class MultiMeshRenderer:
    """Renderer over a DATABASE of meshes: every call takes a per-hypothesis
    mesh index, so one dispatch renders hypothesis batches of different
    objects (the semantic mapper's whole frame at once — the reference
    renders one mesh per GL pass, renderer.cpp:303-351).

    Pose convention: `g_cm` maps model coords to camera coords (the
    reference passes `model` to the shader and `view = vision_to_graphics`,
    renderer.cpp:293; with the GL flip dropped, model->camera is the single
    transform).
    """

    def __init__(self, intr: Intrinsics):
        self.intr = intr
        self.names: list = []
        self.Cs: Optional[jnp.ndarray] = None

    def set_meshes(self, mesh_db) -> None:
        """mesh_db: {name: (V, F)} (insertion order fixes indices)."""
        self.names = list(mesh_db.keys())
        self.Cs = mesh_corner_stack([mesh_db[n] for n in self.names])

    def index(self, name: str) -> int:
        return self.names.index(name)

    def render_depth(self, g_cm, mesh_idx) -> jnp.ndarray:
        """g_cm (...,3,4)/(...,4,4) model->camera; mesh_idx (...,) int —
        which database mesh each hypothesis renders. Returns (...,H,W)."""
        poses, batch = _batch_poses(g_cm)
        mi = jnp.asarray(mesh_idx, jnp.int32).reshape(-1)
        if mi.shape[0] == 1 and poses.shape[0] > 1:
            mi = jnp.broadcast_to(mi, (poses.shape[0],))
        out = rasterize_depth_multi(self.Cs, poses, mi, self.intr)
        return (out.reshape(*batch, self.intr.rows, self.intr.cols)
                if batch else out[0])

    def render_mask(self, g_cm, mesh_idx) -> jnp.ndarray:
        """uint8 mask: 255 where the mesh covers the pixel (RenderMask
        parity, renderer.cpp:403-433)."""
        d = self.render_depth(g_cm, mesh_idx)
        return (jnp.isfinite(d) * 255).astype(jnp.uint8)

    def render_edge(self, g_cm, mesh_idx) -> jnp.ndarray:
        """Edge image in [0,1] from linearized depth (RenderEdge parity:
        depth pass + edge_detection.frag; renderer.cpp:353-400)."""
        from visma_tpu.image.edges import depth_edge

        d = self.render_depth(g_cm, mesh_idx)
        return depth_edge(d)


class Renderer:
    """Drop-in equivalent of the reference Renderer
    (render/renderer.h:41-158): set camera + mesh once, then render depth /
    mask / edge per pose — except poses are batched. A one-mesh
    MultiMeshRenderer."""

    def __init__(self, intr: Intrinsics):
        self.intr = intr
        self._multi = MultiMeshRenderer(intr)

    def set_mesh(self, V, F):
        self._multi.set_meshes({"mesh": (V, F)})

    def render_depth(self, g_cm) -> jnp.ndarray:
        """g_cm: (...,3,4) or (...,4,4) model->camera. Returns (...,H,W)."""
        return self._multi.render_depth(g_cm, 0)

    def render_mask(self, g_cm) -> jnp.ndarray:
        return self._multi.render_mask(g_cm, 0)

    def render_edge(self, g_cm) -> jnp.ndarray:
        return self._multi.render_edge(g_cm, 0)
