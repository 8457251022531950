"""Rasterizer tests: analytic depth checks, binned-vs-brute equivalence,
mask/edge parity semantics (reference: render/renderer.cpp)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from visma_tpu.render import Intrinsics, Renderer, rasterize_depth, \
    rasterize_depth_brute, to_gl_depth
from visma_tpu.image.edges import linearize_gl_depth

INTR = Intrinsics(fx=100.0, fy=100.0, cx=47.5, cy=31.5, rows=64, cols=96,
                  z_near=0.05, z_far=10.0)


def quad(z=2.0, half=1.0):
    """Two triangles forming a square at depth z, facing the camera."""
    V = np.array([[-half, -half, z], [half, -half, z],
                  [half, half, z], [-half, half, z]], np.float32)
    F = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    return V, F


def icosphere(subdiv=1, r=0.5):
    """Tiny icosphere for a curved test mesh."""
    t = (1 + 5**0.5) / 2
    V = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
                  [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
                  [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float32)
    F = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
                  [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
                  [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
                  [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]],
                 np.int32)
    for _ in range(subdiv):
        newF, mid, verts = [], {}, V.tolist()

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                m = (np.asarray(verts[a]) + np.asarray(verts[b])) / 2
                verts.append(m.tolist())
                mid[key] = len(verts) - 1
            return mid[key]

        for f in F:
            a, b, c = int(f[0]), int(f[1]), int(f[2])
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            newF += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        V, F = np.asarray(verts, np.float32), np.asarray(newF, np.int32)
    V = V / np.linalg.norm(V, axis=1, keepdims=True) * r
    return V, F


IDENTITY = jnp.asarray(np.hstack([np.eye(3), np.zeros((3, 1))]).astype(np.float32))


class TestDepth:
    def test_flat_quad_depth(self):
        V, F = quad(z=2.0, half=0.2)  # +-0.2m at 2m, f=100 -> +-10 px
        d = np.asarray(rasterize_depth(jnp.asarray(V), jnp.asarray(F),
                                       IDENTITY, INTR))
        # center pixel: principal point looks at quad center -> depth 2.0
        assert abs(d[31, 47] - 2.0) < 1e-3
        # background is +inf
        assert np.isinf(d[0, 0])
        # footprint is the expected ~20x20 px square
        area = np.isfinite(d).sum()
        assert abs(area - 20 * 20) < 90, area

    def test_slanted_quad_perspective_correct(self):
        """Depth varies linearly in 1/z across a slanted quad."""
        V = np.array([[-1, -1, 1.5], [1, -1, 3.0],
                      [1, 1, 3.0], [-1, 1, 1.5]], np.float32)
        F = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
        d = np.asarray(rasterize_depth(jnp.asarray(V), jnp.asarray(F),
                                       IDENTITY, INTR))
        row = d[31]
        xs = np.nonzero(np.isfinite(row))[0]
        # analytic: pixel u maps to ray x/z=(u-cx)/fx; plane z = 2.25 + .75x
        for u in (xs[2], xs[len(xs) // 2], xs[-3]):
            a = (u - INTR.cx) / INTR.fx
            z_expected = 2.25 / (1 - 0.75 * a)
            assert abs(row[u] - z_expected) < 0.02, (u, row[u], z_expected)

    def test_occlusion_nearest_wins(self):
        Vf, Ff = quad(z=1.0, half=0.3)
        Vb, Fb = quad(z=3.0, half=2.0)
        V = np.vstack([Vf, Vb])
        F = np.vstack([Ff, Fb + 4])
        d = np.asarray(rasterize_depth(jnp.asarray(V), jnp.asarray(F),
                                       IDENTITY, INTR))
        assert abs(d[32, 48] - 1.0) < 1e-3     # front quad wins at center
        assert abs(d[2, 2] - 3.0) < 1e-2       # back quad elsewhere

    def test_binned_matches_brute(self):
        V, F = icosphere(subdiv=1, r=0.5)
        V = V + np.array([0, 0, 2.0], np.float32)
        a = np.asarray(rasterize_depth(jnp.asarray(V), jnp.asarray(F),
                                       IDENTITY, INTR))
        b = np.asarray(rasterize_depth_brute(jnp.asarray(V), jnp.asarray(F),
                                             IDENTITY, INTR))
        mask = np.isfinite(a) | np.isfinite(b)
        assert (np.isfinite(a) == np.isfinite(b)).mean() > 0.995
        both = np.isfinite(a) & np.isfinite(b)
        np.testing.assert_allclose(a[both], b[both], atol=1e-3)

    def test_chunked_pallas_matches_binned(self):
        """The Triton chunk kernel (interpret mode) must agree with the XLA
        form over the same chunk lists pixel-for-pixel."""
        from visma_tpu.render.raster import (mesh_corner_stack,
                                             rasterize_depth_multi)

        V, F = icosphere(subdiv=2, r=0.5)
        V = V + np.array([0, 0, 2.0], np.float32)
        Cs = mesh_corner_stack([(V, F)])
        rng = np.random.default_rng(3)
        poses = []
        for _ in range(3):
            th = rng.uniform(0, 2 * np.pi)
            c, s = np.cos(th), np.sin(th)
            P = np.zeros((3, 4), np.float32)
            P[:, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
            poses.append(P)
        poses = jnp.asarray(np.stack(poses))
        mi = jnp.zeros((3,), jnp.int32)
        ref = np.asarray(rasterize_depth_multi(Cs, poses, mi, INTR,
                                               impl="xla"))
        new = np.asarray(rasterize_depth_multi(Cs, poses, mi, INTR,
                                               impl="interpret"))
        assert np.isfinite(ref).sum() > 500
        assert (np.isfinite(ref) == np.isfinite(new)).all()
        both = np.isfinite(ref) & np.isfinite(new)
        np.testing.assert_allclose(ref[both], new[both], rtol=1e-6)

    def test_morton_sort_is_permutation(self):
        from visma_tpu.render.raster import sort_faces_morton

        V, F = icosphere(subdiv=1, r=0.5)
        Fs = sort_faces_morton(V, F)
        assert Fs.shape == F.shape
        assert {tuple(sorted(f)) for f in Fs.tolist()} == \
            {tuple(sorted(f)) for f in F.tolist()}

    def test_chunked_clipping(self):
        from visma_tpu.render.raster import rasterize_depth

        for z in (0.01, -2.0):  # near-plane violation / behind camera
            V, F = quad(z=z)
            d = np.asarray(rasterize_depth(
                jnp.asarray(V), jnp.asarray(F), IDENTITY, INTR,
                impl="interpret"))
            assert np.isinf(d).all()

    def test_near_plane_clipping(self):
        V, F = quad(z=0.01)  # in front of near plane
        d = np.asarray(rasterize_depth(jnp.asarray(V), jnp.asarray(F),
                                       IDENTITY, INTR))
        assert np.isinf(d).all()

    def test_behind_camera_clipped(self):
        V, F = quad(z=-2.0)
        d = np.asarray(rasterize_depth(jnp.asarray(V), jnp.asarray(F),
                                       IDENTITY, INTR))
        assert np.isinf(d).all()


class TestRenderer:
    def make(self):
        r = Renderer(INTR)
        V, F = icosphere(subdiv=1, r=0.5)
        r.set_mesh(V + np.array([0, 0, 2.0], np.float32), F)
        return r

    def test_batched_poses(self):
        r = self.make()
        poses = np.stack([np.hstack([np.eye(3), [[0], [0], [z]]])
                          for z in (0.0, 0.5, 1.0)]).astype(np.float32)
        d = np.asarray(r.render_depth(jnp.asarray(poses)))
        assert d.shape == (3, 64, 96)
        # pushing the object away increases center depth by the offset
        assert abs((d[1, 32, 48] - d[0, 32, 48]) - 0.5) < 1e-2
        assert abs((d[2, 32, 48] - d[0, 32, 48]) - 1.0) < 1e-2

    def test_mask(self):
        r = self.make()
        m = np.asarray(r.render_mask(IDENTITY))
        assert m.dtype == np.uint8
        assert m[32, 48] == 255 and m[0, 0] == 0
        # mask area ~ projected disk area: r=0.5 at z=2, f=100 -> 25px radius
        area = (m > 0).sum()
        assert abs(area - np.pi * 25**2) / (np.pi * 25**2) < 0.15

    def test_edge_on_silhouette(self):
        r = self.make()
        e = np.asarray(r.render_edge(IDENTITY))
        m = np.asarray(r.render_mask(IDENTITY)) > 0
        # edges concentrate on the silhouette ring: dilate mask minus erode
        import scipy.ndimage as ndi

        ring = ndi.binary_dilation(m, iterations=2) & ~ndi.binary_erosion(m, iterations=2)
        assert e[ring].max() == 1.0
        interior = ndi.binary_erosion(m, iterations=5)
        assert e[interior].mean() < 0.05

    def test_gl_depth_roundtrip(self):
        r = self.make()
        d = r.render_depth(IDENTITY)
        gl = to_gl_depth(d, INTR.z_near, INTR.z_far)
        back = linearize_gl_depth(gl, INTR.z_near, INTR.z_far)
        fin = np.isfinite(np.asarray(d))
        np.testing.assert_allclose(np.asarray(back)[fin], np.asarray(d)[fin],
                                   rtol=1e-3)
        assert float(np.asarray(gl)[~fin].min()) == 1.0


class TestMultiMesh:
    """MultiMeshRenderer: one dispatch over per-hypothesis mesh indices must
    equal per-mesh Renderer calls (pads faces with degenerate rows)."""

    def make_db(self):
        Vq, Fq = quad(z=0.0, half=0.6)      # 2 faces
        Vs_, Fs_ = icosphere(subdiv=1, r=0.4)  # 80 faces (forces padding)
        return {"quad": (Vq, Fq), "sphere": (Vs_, Fs_)}

    def poses(self):
        rng = np.random.default_rng(9)
        out = []
        for i in range(5):
            th = rng.uniform(0, 2 * np.pi)
            c, s = np.cos(th), np.sin(th)
            P = np.zeros((3, 4), np.float32)
            P[:, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
            P[2, 3] = 2.0 + 0.2 * i
            out.append(P)
        return np.stack(out)

    def test_xla_path_matches_per_mesh(self):
        from visma_tpu.render.raster import MultiMeshRenderer

        db = self.make_db()
        m = MultiMeshRenderer(INTR)
        m.set_meshes(db)
        poses = self.poses()
        mi = np.array([0, 1, 0, 1, 1])
        got = np.asarray(m.render_depth(jnp.asarray(poses), mi))
        for i, name in enumerate(["quad", "sphere", "quad", "sphere",
                                  "sphere"]):
            r = Renderer(INTR)
            r.set_mesh(*db[name])
            want = np.asarray(r.render_depth(jnp.asarray(poses[i])))
            both = np.isfinite(got[i]) & np.isfinite(want)
            assert (np.isfinite(got[i]) == np.isfinite(want)).all(), i
            np.testing.assert_allclose(got[i][both], want[both], atol=1e-3)

    def test_pallas_multi_matches_xla(self):
        from visma_tpu.render.raster import (MultiMeshRenderer,
                                             rasterize_depth_multi)

        db = self.make_db()
        m = MultiMeshRenderer(INTR)
        m.set_meshes(db)
        poses = jnp.asarray(self.poses())
        mi = jnp.asarray([1, 0, 1, 1, 0], jnp.int32)
        ref = np.asarray(m.render_depth(poses, mi))
        new = np.asarray(rasterize_depth_multi(m.Cs, poses, mi, INTR,
                                               impl="interpret"))
        assert (np.isfinite(ref) == np.isfinite(new)).all()
        both = np.isfinite(ref) & np.isfinite(new)
        np.testing.assert_allclose(ref[both], new[both], atol=1e-3)

    def test_single_mesh_chunked_unchanged(self):
        """One mesh through the Triton kernel (interpret mode) matches the
        brute-force oracle, pose by pose."""
        V, F = icosphere(subdiv=1, r=0.5)
        V = V + np.array([0, 0, 2.0], np.float32)
        for P in self.poses():
            ref = np.asarray(rasterize_depth_brute(
                jnp.asarray(V), jnp.asarray(F), jnp.asarray(P), INTR))
            new = np.asarray(rasterize_depth(
                jnp.asarray(V), jnp.asarray(F), jnp.asarray(P), INTR,
                impl="interpret"))
            assert (np.isfinite(ref) == np.isfinite(new)).all()
            both = np.isfinite(ref) & np.isfinite(new)
            np.testing.assert_allclose(ref[both], new[both], rtol=1e-6)


class TestRoiRaster:
    """ROI-windowed rendering must equal the full-frame render cropped at
    the same window — for ALL geometry (rasterization is per-pixel; the
    window is a screen-space translation)."""

    def _roi_vs_crop(self, impl, roi, origins):
        from visma_tpu.render.raster import (MultiMeshRenderer,
                                             rasterize_depth_multi)

        db = TestMultiMesh().make_db()
        m = MultiMeshRenderer(INTR)
        m.set_meshes(db)
        poses = jnp.asarray(TestMultiMesh().poses())
        mi = jnp.asarray([1, 0, 1, 1, 0], jnp.int32)
        full = np.asarray(rasterize_depth_multi(m.Cs, poses, mi, INTR,
                                                impl=impl))
        origins = jnp.asarray(origins, jnp.float32)
        w = np.asarray(rasterize_depth_multi(m.Cs, poses, mi, INTR, roi,
                                             origins, impl=impl))
        for b in range(5):
            ox, oy = int(origins[b, 0]), int(origins[b, 1])
            crop = full[b, oy:oy + roi[0], ox:ox + roi[1]]
            assert (np.isfinite(w[b]) == np.isfinite(crop)).mean() > 0.999
            both = np.isfinite(w[b]) & np.isfinite(crop)
            np.testing.assert_allclose(w[b][both], crop[both], atol=1e-3)

    def test_roi_equals_crop_xla(self):
        self._roi_vs_crop("xla", (48, 64), [[0, 0], [16, 8], [32, 16],
                                            [8, 4], [30, 10]])

    def test_roi_equals_crop_chunked_interpret(self):
        self._roi_vs_crop("interpret", (32, 64),
                          [[0, 0], [8, 16], [16, 8], [32, 32], [4, 4]])


class TestBenchMeshExact:
    """The renderer is exact on the bench's own 5k-face meshes at bench
    geometry: 0 coverage mismatches vs the brute-force oracle and depth
    within 1e-4 relative (both evaluate the same plane equations; only the
    order of the max-reduction differs), full frame and ROI (256, 384).
    A per-tile triangle cap drops thousands of pixels here."""

    BENCH = Intrinsics(fx=486.405, fy=535.401, cx=469.199, cy=257.916,
                       rows=500, cols=960, z_near=0.05, z_far=8.0)

    @pytest.fixture(scope="class")
    def scenes(self):
        from scipy.spatial.transform import Rotation

        from visma_tpu.io.procedural import bench_mesh_db

        out = {}
        for name, (V, F), (x, z, yaw) in zip(
                ("chair", "desk"), bench_mesh_db().values(),
                ((-0.65, 3.1, 0.35), (0.65, 3.1, -0.4))):
            P = np.zeros((3, 4), np.float32)
            P[:, :3] = Rotation.from_euler("y", yaw).as_matrix()
            P[:, 3] = [x, 0.05, z]
            ref = np.asarray(rasterize_depth_brute(
                jnp.asarray(V), jnp.asarray(F), jnp.asarray(P), self.BENCH,
                chunk=64))
            out[name] = (V, F, P, ref)
        return out

    @pytest.mark.parametrize("name", ["chair", "desk"])
    @pytest.mark.parametrize("roi", [None, (256, 384), "cut"])
    def test_exact_vs_brute(self, scenes, name, roi):
        """roi "cut": a (256, 384) window shifted half its size off the
        object's coverage, so its border cuts the silhouette as CEM
        windows do when the mean drifts."""
        from visma_tpu.render.raster import (mesh_corner_stack,
                                             rasterize_depth_multi)

        V, F, P, ref = scenes[name]
        Cs = mesh_corner_stack([(V, F)])
        mi = jnp.zeros((1,), jnp.int32)
        if roi is None:
            got = np.asarray(rasterize_depth_multi(
                Cs, jnp.asarray(P)[None], mi, self.BENCH))[0]
            assert np.isfinite(ref).sum() > 5000
        else:
            cut, roi = roi == "cut", (256, 384)
            cov = np.argwhere(np.isfinite(ref))
            oy = int(np.clip(cov[:, 0].mean() - roi[0] / 2, 0, 500 - roi[0]))
            ox = int(np.clip(cov[:, 1].mean() - roi[1] / 2, 0, 960 - roi[1]))
            if cut:
                ox += roi[1] // 2 if ox + roi[1] // 2 <= 960 - roi[1] \
                    else -(roi[1] // 2)
                oy += roi[0] // 2 if oy + roi[0] // 2 <= 500 - roi[0] \
                    else -(roi[0] // 2)
            org = jnp.asarray([ox, oy], jnp.float32)
            got = np.asarray(rasterize_depth_multi(
                Cs, jnp.asarray(P)[None], mi, self.BENCH, roi,
                org[None]))[0]
            ref = np.asarray(rasterize_depth_brute(
                jnp.asarray(V), jnp.asarray(F), jnp.asarray(P), self.BENCH,
                roi, org, chunk=64))
            n = np.isfinite(ref).sum()
            assert 500 < n < len(cov) - 500 if cut else n > 5000
        assert (np.isfinite(got) != np.isfinite(ref)).sum() == 0
        both = np.isfinite(ref)
        np.testing.assert_allclose(got[both], ref[both], rtol=1e-4)


class TestDepthAccuracy:
    @pytest.mark.parametrize("impl", ["auto", "interpret"])
    def test_far_corner_plane_depth(self, impl):
        """~1 px triangles of a slanted plane near the right edge of a
        960 px frame: depth within 1e-5 relative of the analytic ray-plane
        intersection. Planes written for pixel (0, 0) lose ~3e-4 here in
        f32; each triangle's own pixel frame keeps ~2e-7."""
        intr = TestBenchMeshExact.BENCH
        n = np.array([0.3, -0.2, 1.0])
        n /= np.linalg.norm(n)
        X0 = np.array([1.8, 0.75, 2.5])
        e1 = np.cross(n, [0, 1, 0])
        e1 /= np.linalg.norm(e1)
        e2 = np.cross(n, e1)
        k = 48
        g = (np.arange(k + 1) - k / 2) * 0.004
        V = (X0 + g[:, None, None] * e1 + g[None, :, None] * e2).reshape(-1, 3)
        i = np.arange(k)[:, None] * (k + 1) + np.arange(k)[None, :]
        F = np.concatenate([
            np.stack([i, i + 1, i + k + 2], -1).reshape(-1, 3),
            np.stack([i, i + k + 2, i + k + 1], -1).reshape(-1, 3)])
        d = np.asarray(rasterize_depth(
            jnp.asarray(V, jnp.float32), jnp.asarray(F, jnp.int32),
            IDENTITY, intr, impl=impl))
        vv, uu = np.nonzero(np.isfinite(d))
        assert len(uu) > 1000 and uu.min() > 750
        ray = np.stack([(uu - intr.cx) / intr.fx, (vv - intr.cy) / intr.fy,
                        np.ones(len(uu))], -1)
        z = (n @ X0) / (ray @ n)
        np.testing.assert_allclose(d[vv, uu], z, rtol=1e-5)


class TestProjectPrecision:
    def test_project_is_highest_precision(self):
        """_project asks for HIGHEST: a TF32 product moves a projected
        vertex by up to ~1 px at 960 px wide."""
        from visma_tpu.render.raster import _project

        intr = TestBenchMeshExact.BENCH
        rng = np.random.default_rng(0)
        V = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
        P = np.zeros((3, 4), np.float32)
        P[:, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        P[:, 3] = [0.1, -0.2, 4.0]
        hlo = jax.jit(lambda v, p: _project(v, p, intr)).lower(
            jnp.asarray(V), jnp.asarray(P)).as_text()
        assert "HIGHEST" in hlo
        xy, z = _project(jnp.asarray(V), jnp.asarray(P), intr)
        Vc = V.astype(np.float64) @ P[:, :3].T.astype(np.float64) + P[:, 3]
        u = intr.fx * Vc[:, 0] / Vc[:, 2] + intr.cx
        v = intr.fy * Vc[:, 1] / Vc[:, 2] + intr.cy
        np.testing.assert_allclose(np.asarray(xy), np.stack([u, v], -1),
                                   atol=1e-3)
        np.testing.assert_allclose(np.asarray(z), Vc[:, 2], atol=1e-5)
