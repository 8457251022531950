"""Full-pipeline test: synthetic IMAGES + IMU -> trajectory (config 2+3)."""
import numpy as np
import jax.numpy as jnp
import pytest

from visma_tpu.filter import FilterConfig
from visma_tpu.io.synthetic import SyntheticConfig, make_imu
from visma_tpu.io.synthetic_images import render_blob_frames
from visma_tpu.pipeline import VioPipeline, export_packets


@pytest.mark.slow
def test_images_to_trajectory():
    syn = SyntheticConfig(num_frames=45, num_landmarks=130, rows=240,
                          cols=320, fx=200.0, fy=200.0, cx=160.0, cy=120.0,
                          seed=11)
    cfg = FilterConfig(window=8, max_tracks=48, max_updates=16,
                       fx=syn.fx, fy=syn.fy, cx=syn.cx, cy=syn.cy,
                       pixel_noise=1.0)
    frames, gwc, X = render_blob_frames(syn)
    imu = make_imu(syn)
    spf = imu["samples_per_frame"]
    dt = float(np.diff(imu["ts_state"])[0])

    pipe = VioPipeline(cfg, levels=3, cell=20)
    st = pipe.init(jnp.asarray(frames[0]), R0=gwc[0, :, :3],
                   p0=gwc[0, :, 3], v0=imu["v0"])
    ps = []
    for i in range(1, syn.num_frames):
        lo, hi = (i - 1) * spf, i * spf
        st = pipe.step(st, frames[i], imu["gyro"][lo:hi],
                       imu["accel"][lo:hi], np.full(spf, dt, np.float32))
        R, p = pipe.pose(st)
        ps.append(p)
    ps = np.asarray(ps)
    ate = float(np.sqrt(np.mean(np.sum((ps - gwc[1:, :, 3]) ** 2, axis=1))))
    assert ate < 0.08, f"image-pipeline ATE {ate:.4f} m"


@pytest.mark.slow
def test_images_to_trajectory_adversarial():
    """The pipeline must hold accuracy on adversarial imagery: sensor
    noise, geometrically-consistent textured background (distractor
    features at ~12 m), photometric drift, and two textured occluder
    sweeps. The gate matches the clean-imagery test's ATE threshold;
    tools/noise_sweep.py sweeps the operating points."""
    from visma_tpu.filter.msckf import check_health
    from visma_tpu.io.synthetic_images import render_adversarial_frames

    syn = SyntheticConfig(num_frames=60, num_landmarks=240, rows=240,
                          cols=320, fx=240.0, fy=240.0, cx=159.5, cy=119.5,
                          seed=7)
    cfg = FilterConfig(window=8, max_tracks=96, max_updates=24,
                       fx=syn.fx, fy=syn.fy, cx=syn.cx, cy=syn.cy,
                       pixel_noise=1.0)
    frames, gwc, X = render_adversarial_frames(syn)
    imu = make_imu(syn)
    spf = imu["samples_per_frame"]
    dt = float(np.diff(imu["ts_state"])[0])
    N = syn.num_frames - 1
    gyro = imu["gyro"][: N * spf].reshape(N, spf, 3)
    accel = imu["accel"][: N * spf].reshape(N, spf, 3)
    dts = np.full((N, spf), dt, np.float32)

    pipe = VioPipeline(cfg, levels=3, cell=32)
    st0 = pipe.init(jnp.asarray(frames[0]), R0=gwc[0, :, :3],
                    p0=gwc[0, :, 3], v0=imu["v0"])
    _, outs = pipe.run(st0, frames[1:], gyro, accel, dts)
    check_health(outs)
    p = np.asarray(outs["p"])
    ate = float(np.sqrt(np.mean(np.sum((p - gwc[1:, :, 3]) ** 2, axis=1))))
    assert ate < 0.08, f"adversarial image-pipeline ATE {ate:.4f} m"


def test_run_chunked_matches_steps():
    """Throughput mode (one scanned dispatch) reproduces the per-frame
    step path exactly."""
    syn = SyntheticConfig(num_frames=12, num_landmarks=80, rows=128,
                          cols=160, fx=120.0, fy=120.0, cx=80.0, cy=64.0,
                          seed=13)
    cfg = FilterConfig(window=6, max_tracks=32, max_updates=8,
                       fx=syn.fx, fy=syn.fy, cx=syn.cx, cy=syn.cy,
                       pixel_noise=1.0)
    frames, gwc, X = render_blob_frames(syn)
    imu = make_imu(syn)
    spf = imu["samples_per_frame"]
    dt = float(np.diff(imu["ts_state"])[0])

    pipe = VioPipeline(cfg, levels=2, cell=20)
    st0 = pipe.init(jnp.asarray(frames[0]), R0=gwc[0, :, :3],
                    p0=gwc[0, :, 3], v0=imu["v0"])

    N = syn.num_frames - 1
    gyro = np.stack([imu["gyro"][i * spf:(i + 1) * spf] for i in range(N)])
    accel = np.stack([imu["accel"][i * spf:(i + 1) * spf] for i in range(N)])
    dts = np.full((N, spf), dt, np.float32)

    st = st0
    ps = []
    for i in range(N):
        st = pipe.step(st, frames[i + 1], gyro[i], accel[i], dts[i])
        ps.append(np.asarray(st.filter.p))

    _, outs = pipe.run(st0, frames[1:], gyro, accel, dts)
    np.testing.assert_allclose(np.asarray(outs["p"]), np.asarray(ps),
                               atol=1e-5)


def test_full_lifecycle_export(tmp_path):
    """The exported dataset exercises the proto's FULL feature lifecycle
    (vlslam.proto:11-19) and the reference's GrabPointCloud filter
    (dataloader.cpp:136-164) selects exactly the absorbed tracks.

    Outliers are injected into the feed (gross pixel offsets on a few ids
    over consecutive frames) so the chi2 gate fires and REJECT is
    produced; KEEP comes from window-filling continuation; INSTATE /
    GOODDROP / INITIALIZING / READY occur naturally."""
    from visma_tpu.filter import Msckf
    from visma_tpu.filter.feed import pack_frames
    from visma_tpu.io.synthetic import make_dataset, make_trajectory
    from visma_tpu.proto import CameraInfo, Dataset, FeatureStatus

    syn = SyntheticConfig(num_frames=30, num_landmarks=60, seed=5)
    cfg = FilterConfig(window=6, max_tracks=64, max_updates=16,
                       fx=syn.fx, fy=syn.fy, cx=syn.cx, cy=syn.cy)
    ds = make_dataset(syn)
    imu = make_imu(syn)
    packed = pack_frames(cfg, ds, imu)
    # corrupt: ids observed at frame 12 get +18 px for 3 frames — enough
    # to blow the chi2 gate (sigma=1 px) but not the 30 px triangulation
    # sanity gate
    bad_ids = packed["ids"][12][packed["valid"][12]][:4]
    for i in (12, 13, 14):
        hit = np.isin(packed["ids"][i], bad_ids) & packed["valid"][i]
        packed["xp"][i][hit] += 18.0
    # terminate a handful of mature tracks (simulates leaving the FOV —
    # this synthetic keeps all landmarks visible): absorbed tracks lost
    # while mature export GOODDROP
    gone_ids = packed["ids"][20][packed["valid"][20]][10:16]
    for i in range(20, 30):
        packed["valid"][i][np.isin(packed["ids"][i], gone_ids)] = False
    frames = {k: jnp.asarray(v) for k, v in packed.items() if k != "ts"}
    _, gwc = make_trajectory(syn)
    kf = Msckf(cfg)
    s0 = kf.init(R0=gwc[0, :, :3], p0=gwc[0, :, 3], v0=imu["v0"])
    _, outs = kf.run(s0, frames)

    packets = export_packets(cfg, outs, np.array([p.ts for p in ds.packets]))
    out = Dataset(description="lifecycle",
                  camera=CameraInfo(rows=syn.rows, cols=syn.cols,
                                    parameters=np.array([syn.fx, syn.fy,
                                                         syn.cx, syn.cy])),
                  packets=packets)
    (tmp_path / "dataset").write_bytes(out.encode())

    from visma_tpu.io import VlslamDatasetLoader

    loader = VlslamDatasetLoader(str(tmp_path))
    seen = set()
    for pk in loader.dataset.packets:
        for f in pk.features:
            seen.add(FeatureStatus(f.status))
    expected = {FeatureStatus.INITIALIZING, FeatureStatus.READY,
                FeatureStatus.INSTATE, FeatureStatus.GOODDROP,
                FeatureStatus.KEEP, FeatureStatus.REJECT}
    assert expected <= seen, f"missing statuses: {expected - seen}"

    # GrabPointCloud contract: every INSTATE|GOODDROP feature carries an
    # absorbed (nonzero) world point; REJECT features were never absorbed
    n_cloud = 0
    for i, pk in enumerate(loader.dataset.packets):
        cloud = loader.grab_pointcloud(i)
        for f in pk.features:
            if f.status in (FeatureStatus.INSTATE, FeatureStatus.GOODDROP):
                assert np.linalg.norm(f.xw) > 0, \
                    f"frame {i}: {FeatureStatus(f.status).name} id " \
                    f"{f.id} has zero xw"
                assert f.id in cloud
                n_cloud += 1
            else:
                assert f.id not in cloud
    assert n_cloud > 50, f"only {n_cloud} absorbed points exported"

    # absorbed world points are near their true landmarks: the exported
    # cloud is usable the way the reference uses it (visualization.cpp)
    from visma_tpu.io.synthetic import make_landmarks

    X = make_landmarks(syn)
    errs = []
    for i in (20, 29):
        for f in loader.dataset.packets[i].features:
            if f.status in (FeatureStatus.INSTATE, FeatureStatus.GOODDROP):
                d = np.linalg.norm(X - np.asarray(f.xw), axis=1).min()
                errs.append(d)
    assert np.median(errs) < 0.1, f"median point error {np.median(errs)}"


def test_export_packets_roundtrip(tmp_path):
    """Filter outputs -> vlslam packets -> decodable dataset file."""
    from visma_tpu.filter import Msckf
    from visma_tpu.filter.feed import pack_frames
    from visma_tpu.io.synthetic import make_dataset, make_trajectory
    from visma_tpu.proto import CameraInfo, Dataset

    syn = SyntheticConfig(num_frames=20, num_landmarks=60, seed=5)
    cfg = FilterConfig(window=6, max_tracks=64, max_updates=16,
                       fx=syn.fx, fy=syn.fy, cx=syn.cx, cy=syn.cy)
    ds = make_dataset(syn)
    imu = make_imu(syn)
    frames = {k: jnp.asarray(v) for k, v in
              pack_frames(cfg, ds, imu).items() if k != "ts"}
    _, gwc = make_trajectory(syn)
    kf = Msckf(cfg)
    s0 = kf.init(R0=gwc[0, :, :3], p0=gwc[0, :, 3], v0=imu["v0"])
    _, outs = kf.run(s0, frames)

    ts = np.array([p.ts for p in ds.packets])
    packets = export_packets(cfg, outs, ts)
    out = Dataset(description="visma_tpu output",
                  camera=CameraInfo(rows=syn.rows, cols=syn.cols,
                                    parameters=np.array([syn.fx, syn.fy,
                                                         syn.cx, syn.cy])),
                  packets=packets)
    path = tmp_path / "dataset"
    path.write_bytes(out.encode())

    # reload through the standard loader
    from visma_tpu.io import VlslamDatasetLoader

    loader = VlslamDatasetLoader(str(tmp_path))
    assert len(loader) == 20
    fr = loader.grab(10, load_image=False)
    # exported gwc matches the filter estimate for that frame
    np.testing.assert_allclose(fr.gwc[:, 3], np.asarray(outs["p"][10]),
                               atol=1e-6)

    # xp round-trip parity: a feature currently
    # observed at frame i (INITIALIZING/READY/INSTATE) must carry the SAME
    # pixel observation the filter ingested for that id at that frame —
    # i.e. a dataset written by export_packets is consumable with the
    # reference's GrabSparseDepth semantics (dataloader.cpp:166-194).
    from visma_tpu.proto import FeatureStatus

    in_ids = np.asarray(frames["ids"])
    in_xp = np.asarray(frames["xp"])
    checked = 0
    for i in (5, 10, 15, 19):
        pk = loader.dataset.packets[i]
        for f in pk.features:
            if f.status in (FeatureStatus.INITIALIZING, FeatureStatus.READY,
                            FeatureStatus.INSTATE):
                j = np.nonzero(in_ids[i] == f.id)[0]
                assert len(j) == 1, f"exported id {f.id} not in frame {i}"
                np.testing.assert_allclose(np.asarray(f.xp),
                                           in_xp[i, j[0]], atol=1e-4)
                checked += 1
    assert checked >= 20, f"only {checked} live features round-tripped"
