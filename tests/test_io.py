"""I/O layer tests: glob ordering, loader Grab semantics, mesh/json/binary
round-trips, synthetic sequence end-to-end (reference parity:
src/dataloader.cpp, scripts/example_load.py conventions)."""
import os

import numpy as np
import pytest

from visma_tpu.io import (
    VlslamDatasetLoader, glob_by_timestamp, load_json, save_json, merge_json,
    matrix_from_json, matrix_to_json, save_mat, load_mat,
    load_mesh, save_obj, save_ply, load_obj, load_ply,
)
from visma_tpu.io.loader import edge_u8
from visma_tpu.io.synthetic import SyntheticConfig, write_sequence, make_imu
from visma_tpu.proto import FeatureStatus


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    root = tmp_path_factory.mktemp("seq")
    cfg = SyntheticConfig(num_frames=12, num_landmarks=60)
    ds = write_sequence(str(root), cfg)
    return str(root), cfg, ds


class TestGlob:
    def test_sorts_by_float_value(self, tmp_path):
        # timestamps where lexicographic != numeric order
        names = ["9.5", "10.2", "100.0", "2.0"]
        for n in names:
            (tmp_path / f"{n}.png").write_bytes(b"x")
        got = glob_by_timestamp(str(tmp_path), ".png")
        stems = [os.path.basename(p)[:-4] for p in got]
        assert stems == ["2.0", "9.5", "10.2", "100.0"]

    def test_prefix_and_fallback(self, tmp_path):
        for n in ["b", "a", "c"]:
            (tmp_path / f"{n}.edge").write_bytes(b"x")
        got = glob_by_timestamp(str(tmp_path), "edge")
        assert [os.path.basename(p) for p in got] == ["a.edge", "b.edge", "c.edge"]


class TestLoader:
    def test_len_and_grab(self, seq):
        root, cfg, ds = seq
        loader = VlslamDatasetLoader(root)
        assert len(loader) == cfg.num_frames
        fr = loader.grab(3)
        assert fr.gwc.shape == (3, 4)
        assert fr.Rg.shape == (3, 3)
        np.testing.assert_allclose(
            fr.gwc, np.asarray(ds.packets[3].gwc).reshape(3, 4), atol=1e-6)
        # gwc rotation block is a rotation
        R = fr.gwc[:, :3]
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)

    def test_rg_convention(self, seq):
        """Rg = exp([wg0, wg1, 0]) — cv2.Rodrigues convention
        (scripts/example_load.py:51, dataloader.cpp:107-109)."""
        import cv2

        root, _, ds = seq
        loader = VlslamDatasetLoader(root)
        wg = np.asarray(ds.packets[5].wg)
        expected, _ = cv2.Rodrigues(np.array([wg[0], wg[1], 0.0]))
        np.testing.assert_allclose(loader.grab(5).Rg, expected, atol=1e-6)

    def test_edgemap_loaded(self, seq):
        root, cfg, _ = seq
        loader = VlslamDatasetLoader(root)
        fr = loader.grab(0)
        assert fr.edgemap is not None
        assert fr.edgemap.shape == (cfg.rows // 4, cfg.cols // 4)
        u8 = edge_u8(fr.edgemap)
        assert u8.dtype == np.uint8 and u8.max() == 255

    def test_bboxes_loaded(self, seq):
        root, _, _ = seq
        loader = VlslamDatasetLoader(root)
        bl = loader.grab(0).bboxlist
        assert bl is not None and bl.bounding_boxes[0].class_name == "chair"

    def test_sparse_depth_positive(self, seq):
        root, _, _ = seq
        loader = VlslamDatasetLoader(root)
        sd = loader.grab_sparse_depth(5)
        assert len(sd) > 0
        for fid, (x, y, z) in sd.items():
            assert z > 0  # all synthetic features are in front of the camera

    def test_pointcloud_status_filter(self, seq):
        root, _, ds = seq
        loader = VlslamDatasetLoader(root)
        pc = loader.grab_pointcloud(5)
        instate = {f.id for f in ds.packets[5].features
                   if f.status in (FeatureStatus.INSTATE, FeatureStatus.GOODDROP)}
        assert set(pc.keys()) == instate

    def test_packed_packets(self, seq):
        root, cfg, ds = seq
        loader = VlslamDatasetLoader(root)
        packed = loader.packed_packets(max_features=128)
        N = cfg.num_frames
        assert packed["gwc"].shape == (N, 3, 4)
        assert packed["feat_xp"].shape == (N, 128, 2)
        # EMPTY masks unused slots
        n_real = len(ds.packets[0].features)
        assert (packed["feat_status"][0, :n_real] != 0).all()
        assert (packed["feat_status"][0, n_real:] == 0).all()
        np.testing.assert_allclose(
            packed["feat_xw"][0, 0], ds.packets[0].features[0].xw, atol=1e-6)


class TestMeshIO:
    def test_obj_roundtrip(self, tmp_path):
        V = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
        F = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
        p = str(tmp_path / "m.obj")
        save_obj(p, V, F)
        V2, F2 = load_mesh(p)
        np.testing.assert_allclose(V2, V, atol=1e-6)
        np.testing.assert_array_equal(F2, F)

    def test_obj_polygon_fan(self, tmp_path):
        p = tmp_path / "quad.obj"
        p.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3 4\n")
        V, F = load_obj(str(p))
        assert F.shape == (2, 3)

    def test_ply_binary_roundtrip(self, tmp_path):
        V = np.random.default_rng(0).normal(size=(10, 3)).astype(np.float32)
        F = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
        p = str(tmp_path / "m.ply")
        save_ply(p, V, F, binary=True)
        V2, F2 = load_ply(p)
        np.testing.assert_allclose(V2, V, atol=1e-6)
        np.testing.assert_array_equal(F2, F)

    def test_ply_ascii_with_colors(self, tmp_path):
        V = np.zeros((4, 3), np.float32)
        C = np.full((4, 3), 128, np.uint8)
        p = str(tmp_path / "c.ply")
        save_ply(p, V, colors=C, binary=False)
        V2, _ = load_ply(p)
        assert V2.shape == (4, 3)

    def test_reference_fixture_meshes(self):
        """Load the reference's own fixture meshes if present."""
        cube = "/root/reference/misc/cube.ply"
        chair = "/root/reference/misc/hermanmiller_aeron.obj"
        if os.path.exists(cube):
            V, F = load_mesh(cube)
            assert V.shape[1] == 3 and len(V) > 0
        if os.path.exists(chair):
            V, F = load_mesh(chair)
            assert len(V) > 100 and len(F) > 100


class TestJsonBinary:
    def test_matrix_roundtrip(self, tmp_path):
        d = {}
        m = np.arange(12, dtype=np.float64).reshape(3, 4)
        matrix_to_json(d, "T_ef_corvis", m)
        np.testing.assert_allclose(matrix_from_json(d, "T_ef_corvis"), m)
        p = str(tmp_path / "x.json")
        save_json(d, p)
        np.testing.assert_allclose(matrix_from_json(load_json(p), "T_ef_corvis"), m)

    def test_merge_json(self):
        a = {"icp": {"voxel": 0.01, "iters": 24}, "name": "a"}
        b = {"icp": {"voxel": 0.05}, "extra": 1}
        merge_json(a, b)
        assert a["icp"]["voxel"] == 0.05 and a["icp"]["iters"] == 24
        assert a["extra"] == 1

    def test_save_load_mat(self, tmp_path):
        m = np.random.default_rng(0).normal(size=(5, 7)).astype(np.float32)
        p = str(tmp_path / "d.depth")
        save_mat(p, m)
        np.testing.assert_allclose(load_mat(p), m)


class TestSyntheticIMU:
    def test_imu_discrete_consistency(self):
        """The filter's exact discrete integrator must reproduce the
        closed-form trajectory from the synthetic measurements."""
        cfg = SyntheticConfig(num_frames=30)
        imu = make_imu(cfg)
        dt = np.diff(imu["ts_state"])[0]
        from scipy.spatial.transform import Rotation

        R = imu["R"][0].copy()
        v = imu["v0"].copy()
        p = imu["pos"][0].copy()
        g = np.array([0, 0, -cfg.gravity])
        for k in range(len(imu["ts"])):
            a_w = R @ imu["accel"][k] + g
            p = p + v * dt + 0.5 * a_w * dt * dt
            v = v + a_w * dt
            R = R @ Rotation.from_rotvec(imu["gyro"][k] * dt).as_matrix()
        r_err = Rotation.from_matrix(imu["R"][-1].T @ R).magnitude()
        p_err = np.linalg.norm(p - imu["pos"][-1])
        assert r_err < 1e-8, f"rotation drift {r_err}"
        assert p_err < 1e-8, f"position drift {p_err}"

    def test_imu_frame_alignment(self):
        """IMU sample stamps partition exactly into per-frame groups."""
        cfg = SyntheticConfig(num_frames=10)
        imu = make_imu(cfg, samples_per_frame=8)
        frame_ts = np.arange(10) / cfg.fps
        for i in range(1, 10):
            sel = (imu["ts"] > frame_ts[i - 1] + 1e-12) & \
                  (imu["ts"] <= frame_ts[i] + 1e-12)
            assert sel.sum() == 8, sel.sum()


class TestJsonComments:
    """jsoncpp-style comment tolerance (reference loads cfg/tool.json, which
    is full of // comments, via core/utils.cpp:148)."""

    def test_line_and_block_comments(self, tmp_path):
        from visma_tpu.io.json_io import load_json

        p = tmp_path / "c.json"
        p.write_text(
            '{\n'
            '  // leading comment\n'
            '  "a": 1, // trailing comment\n'
            '  /* block\n     comment */\n'
            '  "b": "has // no comment /* inside */ strings",\n'
            '  "c": "escaped \\" quote // still string"\n'
            '}\n')
        d = load_json(str(p))
        assert d["a"] == 1
        assert d["b"] == "has // no comment /* inside */ strings"
        assert d["c"] == 'escaped " quote // still string'

    def test_plain_json_unaffected(self, tmp_path):
        from visma_tpu.io.json_io import load_json

        p = tmp_path / "p.json"
        p.write_text('{"url": "http://x//y", "n": [1, 2]}')
        d = load_json(str(p))
        assert d["url"] == "http://x//y" and d["n"] == [1, 2]

    def test_loads_reference_tool_json(self):
        """The shipped reference config parses as-is."""
        import os

        from visma_tpu.io.json_io import load_json

        ref = "/root/reference/cfg/tool.json"
        if not os.path.exists(ref):
            import pytest
            pytest.skip("reference tree not present")
        cfg = load_json(ref)
        assert cfg["dataset"] == "clutter1"
        assert cfg["evaluation"]["samples_per_model"] == 50000
        assert cfg["evaluation"]["voxel_size"] == 0.05
        assert cfg["evaluation"]["max_distance"] == 0.075
        assert cfg["result_visualization"]["result_index"] == -1


class TestSyntheticImagesWithoutCv2:
    """The adversarial bench imagery is made with numpy/scipy alone. It
    stays close to the earlier cv2 rendition of the same scene: that one
    upsampled the texture with Keys cubic interpolation where scipy uses a
    cubic B-spline, so pixels differ by a few gray levels on average
    (bounded below at 3 of 255), and the frames keep their contrast."""

    CFG = SyntheticConfig(num_frames=6, num_landmarks=60, rows=96,
                          cols=128, fx=90.0, fy=90.0, cx=64.0, cy=48.0,
                          seed=7)

    @staticmethod
    def _cv2_texture(rng, size=512, octaves=4):
        import cv2

        tex = np.zeros((size, size), np.float32)
        for o in range(octaves):
            n = 8 << o
            coarse = rng.standard_normal((n, n)).astype(np.float32)
            coarse = np.concatenate([coarse, coarse[:, :1]], axis=1)
            up = cv2.resize(coarse, (size + size // n, size),
                            interpolation=cv2.INTER_CUBIC)[:, :size]
            tex += up / (1.6 ** o)
        return tex / (np.abs(tex).max() + 1e-6)

    def test_frames_without_cv2(self, monkeypatch):
        import sys

        from visma_tpu.io import synthetic_images as S

        monkeypatch.setitem(sys.modules, "cv2", None)   # import -> error
        frames, _, _ = S.render_adversarial_frames(self.CFG)
        monkeypatch.delitem(sys.modules, "cv2")
        assert frames.shape == (6, 96, 128)
        assert np.isfinite(frames).all()
        assert frames.min() >= 0 and frames.max() <= 255

        import cv2

        def cv2_wrap(tex, mu, mv):
            return cv2.remap(tex, mu, mv, interpolation=cv2.INTER_LINEAR,
                             borderMode=cv2.BORDER_WRAP)

        # the bilinear sampler alone agrees with cv2's to f32 rounding
        tex = S._bg_texture(np.random.default_rng(0), size=64, octaves=2)
        rng = np.random.default_rng(1)
        mu = rng.uniform(-64, 128, (40, 50)).astype(np.float32)
        mv = rng.uniform(0, 63, (40, 50)).astype(np.float32)
        np.testing.assert_allclose(S._sample_wrap(tex, mu, mv),
                                   cv2_wrap(tex, mu, mv), atol=2e-3)

        monkeypatch.setattr(S, "_bg_texture", self._cv2_texture)
        monkeypatch.setattr(S, "_sample_wrap", cv2_wrap)
        ref, _, _ = S.render_adversarial_frames(self.CFG)
        diff = np.abs(frames - ref)
        assert diff.mean() < 3.0, diff.mean()
        np.testing.assert_allclose(frames.std(axis=(1, 2)),
                                   ref.std(axis=(1, 2)), rtol=0.05)
