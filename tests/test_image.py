"""Image kernel tests: undistortion remap (vs cv2 oracle) and edge maps
(reference parity: src/undistorter.cpp, render/shaders/edge_detection.frag)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from visma_tpu.image import (
    AtanModel, RadTanModel, Undistorter, CORVIS_ATAN_CALIB,
    bilinear_remap,
    depth_edge, linearize_gl_depth, soft_threshold,
    sobel_gradients, shi_tomasi_response,
)
from visma_tpu.image.undistort import corvis_undistorter, undistorter_from_file


def checkerboard(h, w, sq=16):
    y, x = np.mgrid[0:h, 0:w]
    return (((y // sq) + (x // sq)) % 2 * 255).astype(np.uint8)


class TestRemap:
    def test_identity_map(self):
        img = checkerboard(64, 96).astype(np.float32)
        y, x = np.mgrid[0:64, 0:96].astype(np.float32)
        rm = np.stack([x, y], axis=-1)
        # interior must be exact; the -1 invalid marks only appear outside
        out = np.asarray(bilinear_remap(jnp.asarray(img), jnp.asarray(rm)))
        np.testing.assert_allclose(out[:-1, :-1], img[:-1, :-1], atol=1e-4)

    def test_against_cv2_remap(self):
        import cv2

        rng = np.random.default_rng(0)
        img = rng.uniform(0, 255, (80, 120)).astype(np.float32)
        sx = rng.uniform(1, 118, (60, 100)).astype(np.float32)
        sy = rng.uniform(1, 78, (60, 100)).astype(np.float32)
        ours = np.asarray(bilinear_remap(jnp.asarray(img),
                                         jnp.asarray(np.stack([sx, sy], -1))))
        ref = cv2.remap(img, sx, sy, cv2.INTER_LINEAR)
        np.testing.assert_allclose(ours, ref, atol=1e-2)

    def test_invalid_pixels_zero(self):
        img = np.full((32, 32), 200.0, np.float32)
        rm = np.full((8, 8, 2), -1.0, np.float32)
        out = np.asarray(bilinear_remap(jnp.asarray(img), jnp.asarray(rm)))
        assert (out == 0).all()

    def test_batch_and_channels(self):
        img = np.stack([checkerboard(40, 40)] * 3, axis=-1)  # H,W,3
        y, x = np.mgrid[0:40, 0:40].astype(np.float32)
        rm = jnp.asarray(np.stack([x, y], -1))
        out = bilinear_remap(jnp.asarray(img), rm)
        assert out.shape == (40, 40, 3) and out.dtype == jnp.uint8
        batch = jnp.asarray(np.stack([img, img]))
        out2 = bilinear_remap(batch, rm)
        assert out2.shape == (2, 40, 40, 3)

class TestUndistorter:
    def test_atan_corvis_K(self):
        """Output K of the Corvis crop solve must reproduce the constants
        baked into generate_depthmaps.cpp:9-17 (fx=486.405 fy=535.401
        cx=469.199 cy=257.916 after the 50px crop)."""
        und = corvis_undistorter()
        fx, fy = und.K[0, 0], und.K[1, 1]
        cx, cy = und.K[0, 2], und.K[1, 2] - CORVIS_ATAN_CALIB["crop_top"]
        assert abs(fx - 486.405) < 0.5, fx
        assert abs(fy - 535.401) < 0.5, fy
        assert abs(cx - 469.199) < 0.5, cx
        assert abs(cy - 257.916) < 0.5, cy

    def test_atan_zero_distortion_identityish(self):
        m = AtanModel(fx=0.5, fy=0.5, cx=0.5, cy=0.5, s=0.0,
                      in_rows=64, in_cols=64)
        und = Undistorter(m, mode="crop", out_rows=64, out_cols=64)
        img = checkerboard(64, 64).astype(np.float32)
        out = np.asarray(und(jnp.asarray(img)))
        # with s=0 the mapping is identity: interior pixels unchanged
        np.testing.assert_allclose(out[8:-8, 8:-8], img[8:-8, 8:-8], atol=1e-2)

    def test_radtan_against_cv2(self):
        import cv2

        m = RadTanModel(fx=300.0, fy=300.0, cx=160.0, cy=120.0,
                        k1=-0.2, k2=0.05, p1=0.001, p2=-0.001,
                        in_rows=240, in_cols=320)
        und = Undistorter(m, mode="crop", out_rows=240, out_cols=320)
        img = checkerboard(240, 320).astype(np.float32)
        ours = np.asarray(und(jnp.asarray(img)))

        K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]])
        dist = np.array([-0.2, 0.05, 0.001, -0.001], np.float32)
        K_new, _ = cv2.getOptimalNewCameraMatrix(K, dist, (320, 240), 0,
                                                 (320, 240))
        mx, my = cv2.initUndistortRectifyMap(K, dist, None, K_new, (320, 240),
                                             cv2.CV_32FC1)
        ref = cv2.remap(img, mx, my, cv2.INTER_LINEAR)
        # compare where both valid (cv2 extrapolates at borders, we zero)
        mask = np.asarray(und.remap[..., 0]) >= 0
        diff = np.abs(ours - ref)[mask]
        assert np.median(diff) < 1.0

    def test_calib_file_sniffing(self, tmp_path):
        atan = tmp_path / "atan.txt"
        atan.write_text("0.5 0.5 0.5 0.5 0.7\n64 48\ncrop\n64 48\n")
        u1 = undistorter_from_file(str(atan))
        assert isinstance(u1.model, AtanModel)

        ocv = tmp_path / "ocv.txt"
        ocv.write_text("300 300 160 120 -0.2 0.05 0 0\n320 240\ncrop\n320 240\n")
        u2 = undistorter_from_file(str(ocv))
        assert isinstance(u2.model, RadTanModel)


class TestEdges:
    def make_depth(self):
        """A box at 1m on a 3m background plane."""
        d = np.full((64, 96), 3.0, np.float32)
        d[20:44, 30:66] = 1.0
        return d

    def test_silhouette_detected(self):
        d = self.make_depth()
        e = np.asarray(depth_edge(jnp.asarray(d)))
        assert e.shape == d.shape
        # strong edge at the box boundary
        assert e[20, 40] == 1.0 or e[19, 40] == 1.0
        # flat interior: no edge
        assert e[32, 48] == 0.0
        assert e[10, 10] == 0.0

    def test_border_guard(self):
        d = np.full((32, 32), 1.0, np.float32)
        d[:, :16] = 0.5
        e = np.asarray(depth_edge(jnp.asarray(d)))
        assert (e[:BORDER_TEST] == 0).all() and (e[:, :BORDER_TEST] == 0).all()

    def test_soft_threshold_ramp(self):
        v = jnp.asarray(np.array([0.0, 0.05, 0.075, 0.1, 0.5], np.float32))
        out = np.asarray(soft_threshold(v))
        np.testing.assert_allclose(out, [0, 0, 0.5, 1, 1], atol=1e-6)

    def test_linearize_gl_depth(self):
        zn, zf = 0.05, 5.0
        # metric depth m -> gl z value: inverse of linearize
        m = 2.0
        z = ((zf + zn) / (zf - zn) - 2 * zn * zf / (m * (zf - zn)) + 1) / 2
        lin = float(linearize_gl_depth(jnp.asarray(z), zn, zf))
        assert abs(lin - m) < 1e-3
        assert float(linearize_gl_depth(jnp.asarray(1.0), zn, zf)) == -1.0

    def test_background_no_edge(self):
        d = np.zeros((32, 32), np.float32)  # all background
        e = np.asarray(depth_edge(jnp.asarray(d)))
        assert (e == 0).all()


BORDER_TEST = 5


class TestGradients:
    def test_sobel_on_ramp(self):
        x = np.tile(np.arange(32, dtype=np.float32), (32, 1))
        gx, gy = sobel_gradients(jnp.asarray(x))
        np.testing.assert_allclose(np.asarray(gx)[8:-8, 8:-8], 1.0, atol=1e-4)
        np.testing.assert_allclose(np.asarray(gy)[8:-8, 8:-8], 0.0, atol=1e-4)

    def test_shi_tomasi_corner_peak(self):
        img = np.zeros((48, 48), np.float32)
        img[24:, 24:] = 1.0  # a corner at (24, 24)
        resp = np.asarray(shi_tomasi_response(jnp.asarray(img)))
        peak = np.unravel_index(np.argmax(resp), resp.shape)
        assert abs(peak[0] - 24) <= 2 and abs(peak[1] - 24) <= 2
        # edges (not corners) must score lower than the corner
        assert resp[24, 36] < resp[peak] * 0.5
