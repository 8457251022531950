"""Golden-fixture tests: the checked-in tests/data/golden_seq directory was
encoded ONCE with the protoc-compiled reference schema
(/root/reference/protocols/vlslam.proto via tests/data/make_golden.py), so
these tests pin the loader, native decoder, and CLI tools against real
upstream wire bytes without protoc at test time.

Conventions verified against src/dataloader.cpp:49-194.
"""
import json
import os
import pathlib

import numpy as np
import pytest

GOLDEN = pathlib.Path(__file__).parent / "data" / "golden_seq"


@pytest.fixture(scope="module")
def expected():
    return json.loads((GOLDEN / "expected.json").read_text())


@pytest.fixture(scope="module")
def loader():
    from visma_tpu.io import VlslamDatasetLoader

    return VlslamDatasetLoader(str(GOLDEN))


class TestGoldenLoader:
    def test_size_and_camera(self, loader, expected):
        assert len(loader) == expected["n_frames"]
        cam = loader.grab_camera_info()
        assert cam.rows == expected["rows"] and cam.cols == expected["cols"]
        p = np.asarray(cam.parameters)
        np.testing.assert_allclose(
            p[:4], [expected["fx"], expected["fy"],
                    expected["cx"], expected["cy"]])

    def test_pose_and_gravity(self, loader, expected):
        gwc = loader.pose(3)
        np.testing.assert_allclose(
            gwc, np.asarray(expected["gwc_frame3"]).reshape(3, 4),
            rtol=1e-6)
        # Rg = exp([wg0, wg1, 0]) (dataloader.cpp:107-109)
        from scipy.spatial.transform import Rotation

        Rg = loader.gravity_rotation(0)
        want = Rotation.from_rotvec([0.02, -0.01, 0.0]).as_matrix()
        np.testing.assert_allclose(Rg, want, atol=1e-6)

    def test_grab_full_frame(self, loader, expected):
        fr = loader.grab(0)
        assert fr.ts == expected["first_ts"]
        assert fr.image is not None and fr.image.shape == (
            expected["rows"], expected["cols"], 3)
        assert fr.edgemap is not None and fr.edgemap.shape == (
            expected["rows"], expected["cols"])
        assert 0.0 <= fr.edgemap.min() and fr.edgemap.max() <= 1.0
        assert fr.bboxlist is not None
        bbs = fr.bboxlist.bounding_boxes
        assert len(bbs) == 2
        assert bbs[0].class_name == "chair" and bbs[0].label == 62
        assert bbs[0].shape_id == "aeron"
        np.testing.assert_allclose(np.asarray(bbs[0].scores), [0.9, 0.05],
                                   atol=1e-6)
        np.testing.assert_allclose(np.asarray(bbs[0].azimuth_prob),
                                   [0.2, 0.8], atol=1e-6)

    def test_feature_geometry_consistent(self, loader, expected):
        """Stored xp must equal the projection of xw through gwc — the
        invariant the fixture was built with; decoding errors anywhere in
        the chain would break it."""
        fr = loader.grab(5, load_image=False)
        pk = loader.dataset.packets[5]
        R, t = fr.gwc[:, :3], fr.gwc[:, 3]
        fx, fy, cx, cy = expected["fx"], expected["fy"], \
            expected["cx"], expected["cy"]
        for f in pk.features:
            Xc = R.T @ (np.asarray(f.xw[:3]) - t)
            xp = [fx * Xc[0] / Xc[2] + cx, fy * Xc[1] / Xc[2] + cy]
            np.testing.assert_allclose(np.asarray(f.xp[:2]), xp, atol=1e-4)

    def test_sparse_depth_positive(self, loader):
        sd = loader.grab_sparse_depth(0)
        assert len(sd) > 0
        for fid, (x, y, z) in sd.items():
            assert z > 0  # all fixture points are in front of the camera

    def test_packed_python_path(self, loader, expected):
        packed = loader.packed_packets(max_features=16, native=False)
        N = expected["n_frames"]
        assert packed["gwc"].shape == (N, 3, 4)
        assert packed["feat_xw"].shape == (N, 16, 3)
        np.testing.assert_allclose(
            packed["feat_xw"][0, 0], expected["feat0_xw"], rtol=1e-6)
        # EMPTY (=0) marks unused slots beyond the real 12 features
        assert (packed["feat_status"][:, expected["n_features"]:] == 0).all()
        assert (packed["feat_status"][:, :expected["n_features"]] > 0).all()

    def test_native_decoder_matches_python(self, loader):
        from visma_tpu.io import native_loader

        if not native_loader.available():
            pytest.skip("native decoder not built")
        py = loader.packed_packets(max_features=16, native=False)
        nat = loader.packed_packets(max_features=16, native=True)
        for k in py:
            np.testing.assert_allclose(
                np.asarray(nat[k], np.float64),
                np.asarray(py[k], np.float64), rtol=1e-6,
                err_msg=k)

    def test_native_edgemap_matches_python(self):
        from visma_tpu.io import native_loader
        from visma_tpu.proto import EdgeMap

        if not native_loader.available():
            pytest.skip("native decoder not built")
        edges = sorted(GOLDEN.glob("*.edge"))
        data = edges[0].read_bytes()
        nat = native_loader.load_edgemap_native(data)
        py = EdgeMap.decode(data).as_image()
        np.testing.assert_allclose(nat, py, rtol=1e-6)


class TestVlslamPb2Shim:
    """The vlslam_pb2 compatibility shim must consume the golden wire
    bytes exactly the way the reference's protoc-generated bindings do in
    scripts/example_load.py:29-51 and scripts/utils.py:4-9."""

    def test_dataset_parse_like_reference_script(self, expected):
        from visma_tpu.proto import vlslam_pb2

        dataset = vlslam_pb2.Dataset()
        n = dataset.ParseFromString((GOLDEN / "dataset").read_bytes())
        assert n > 0
        assert len(dataset.packets) == expected["n_frames"]
        # the reference script's exact consumption pattern
        packet = dataset.packets[3]
        gwc = np.array(packet.gwc).reshape(3, 4)
        np.testing.assert_allclose(
            gwc.ravel(), expected["gwc_frame3"], rtol=1e-6)
        wg = np.array([packet.wg[0], packet.wg[1], 0.0])
        assert wg.shape == (3,)
        f = packet.features[0]
        assert f.id == 1000
        np.testing.assert_allclose(np.array(f.xw)[:3], expected["feat0_xw"],
                                   rtol=1e-6)
        assert dataset.camera.rows == expected["rows"]

    def test_edgemap_parse_like_reference_utils(self):
        from visma_tpu.proto import vlslam_pb2

        path = sorted(GOLDEN.glob("*.edge"))[0]
        edgemap = vlslam_pb2.EdgeMap()
        edgemap.ParseFromString(path.read_bytes())
        em = np.array(edgemap.data).reshape(edgemap.rows, edgemap.cols)
        assert em.shape == (48, 64)
        assert 0.0 <= em.min() and em.max() <= 1.0

    def test_enum_constants_and_roundtrip(self):
        from visma_tpu.proto import vlslam_pb2
        from visma_tpu.proto import Dataset as InternalDataset

        assert vlslam_pb2.Feature.INSTATE == 6
        assert vlslam_pb2.Feature.EMPTY == 0
        ds = vlslam_pb2.Dataset()
        ds.ParseFromString((GOLDEN / "dataset").read_bytes())
        blob = ds.SerializeToString()
        again = InternalDataset.decode(blob)
        assert len(again.packets) == len(ds.packets)
        np.testing.assert_allclose(np.array(again.packets[3].gwc),
                                   np.array(ds.packets[3].gwc))

    def test_bbox_parse(self):
        from visma_tpu.proto import vlslam_pb2

        path = sorted(GOLDEN.glob("*.bbox"))[0]
        bl = vlslam_pb2.BoundingBoxList()
        bl.ParseFromString(path.read_bytes())
        assert len(bl.bounding_boxes) == 2
        bb = bl.bounding_boxes[0]
        assert bb.class_name == "chair" and bb.shape_id == "aeron"


class TestGoldenCli:
    def test_example_load(self, capsys):
        from visma_tpu.cli.example_load import main

        main([str(GOLDEN), "--max-frames", "2"])
        out = capsys.readouterr().out
        assert "10 frames" in out and "bbox chair" in out

    def test_example_dump(self, tmp_path):
        from visma_tpu.cli.example_dump import main

        main([str(GOLDEN), str(tmp_path / "out")])
        K = np.loadtxt(tmp_path / "out" / "K.txt")
        assert K[0, 0] == 60.0
        G = np.loadtxt(tmp_path / "out" / "pose" / "000000.txt")
        assert G.shape == (4, 4)
        np.testing.assert_allclose(G[:3, :3], np.eye(3), atol=1e-6)
        assert (tmp_path / "out" / "image" / "000000.jpg").exists()
        assert (tmp_path / "out" / "depth" / "000003.txt").exists()

    def test_full_image_pipeline_on_golden(self, tmp_path, capsys):
        """End-to-end images -> tracker -> filter -> export on the golden
        fixture (run_vio --images): the closest possible stand-in for
        real-data hardening in this container. The
        golden PNGs are static-texture gradients, so vision-only tracking
        gates most features out — the assertion is finite poses and a
        reference-semantics round-trip of the written dataset, not ATE."""
        from visma_tpu.cli.run_vio import main

        out = tmp_path / "est"
        main(["--dataroot", str(GOLDEN), "--no-imu", "--images",
              "--levels", "2", "--cell", "12", "--max-tracks", "32",
              "--window", "4", "--output", str(out)])
        rep = json.loads(capsys.readouterr().out.splitlines()[0])
        assert rep["frames"] == 9  # frame 0 initializes the pipeline
        assert np.isfinite(rep["ate_rmse_m"])

        # round-trip: the written dataset is loadable with reference
        # semantics (Grab/GrabSparseDepth, dataloader.cpp:92-194)
        from visma_tpu.io import VlslamDatasetLoader

        est = VlslamDatasetLoader(str(out))
        assert len(est) == 9
        for i in range(len(est)):
            g = est.pose(i)
            assert np.all(np.isfinite(g))
            # rotation block stays orthonormal through the wire format
            np.testing.assert_allclose(g[:, :3] @ g[:, :3].T, np.eye(3),
                                       atol=1e-4)
        sd = est.grab_sparse_depth(len(est) - 1)
        for v in sd.values():
            assert np.all(np.isfinite(v))
