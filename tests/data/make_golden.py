"""Generate the checked-in golden VISMA-format fixture (tests/data/golden_seq).

Run ONCE (requires protoc + the reference schema); the output binaries are
committed so loader/CLI/native-decoder tests pin against real protobuf
wire bytes without needing protoc at test time.

The encoder is the protoc-compiled REFERENCE schema
(/root/reference/protocols/vlslam.proto) — i.e. genuine upstream wire
format, not our own codec — so these files also lock wire compatibility
permanently.

    python tests/data/make_golden.py
"""
import importlib.util
import os
import pathlib
import subprocess
import sys
import tempfile

import numpy as np

REF_PROTO = pathlib.Path("/root/reference/protocols/vlslam.proto")
OUT = pathlib.Path(__file__).parent / "golden_seq"

N_FRAMES = 10
H, W = 48, 64
N_FEATURES = 12


def compile_pb2():
    tmp = tempfile.mkdtemp()
    subprocess.run(
        ["protoc", f"-I{REF_PROTO.parent}", f"--python_out={tmp}",
         REF_PROTO.name], check=True)
    spec = importlib.util.spec_from_file_location(
        "vlslam_pb2", os.path.join(tmp, "vlslam_pb2.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules["vlslam_pb2"] = mod
    spec.loader.exec_module(mod)
    return mod


def main():
    import cv2

    pb2 = compile_pb2()
    OUT.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(42)

    # a smooth synthetic trajectory + static world points
    Xw = rng.uniform([-1, -1, 2], [1, 1, 5], (N_FEATURES, 3))
    fx, fy, cx, cy = 60.0, 60.0, W / 2.0, H / 2.0

    ds = pb2.Dataset()
    ds.description = "visma_tpu golden fixture (synthetic, seed 42)"
    ds.camera.rows = H
    ds.camera.cols = W
    ds.camera.parameters.extend([fx, fy, cx, cy, 0.9])

    base_ts = 1520535134297896.0  # VISMA-style microsecond timestamp names
    statuses = [1, 2, 3, 4, 5, 6]  # GOODDROP..INSTATE

    for i in range(N_FRAMES):
        ts = base_ts + i * 33333.0
        # camera pose: slow arc
        th = 0.03 * i
        Rwc = np.array([[np.cos(th), 0, np.sin(th)],
                        [0, 1, 0],
                        [-np.sin(th), 0, np.cos(th)]])
        twc = np.array([0.05 * i, 0.01 * i, 0.0])
        gwc = np.hstack([Rwc, twc[:, None]])

        pkt = ds.packets.add()
        pkt.ts = ts
        pkt.gwc.extend([float(v) for v in gwc.ravel()])  # row-major 3x4
        pkt.wg.extend([0.02, -0.01])

        Rcw, tcw = Rwc.T, -Rwc.T @ twc
        for j in range(N_FEATURES):
            Xc = Rcw @ Xw[j] + tcw
            xp = np.array([fx * Xc[0] / Xc[2] + cx, fy * Xc[1] / Xc[2] + cy])
            f = pkt.features.add()
            f.id = 1000 + j
            f.status = statuses[(i + j) % len(statuses)]
            f.xp.extend([float(xp[0]), float(xp[1])])
            f.xw.extend([float(v) for v in Xw[j]])

        # .png: deterministic gradient + per-frame stripe
        img = np.zeros((H, W, 3), np.uint8)
        img[..., 0] = np.linspace(0, 255, W, dtype=np.uint8)[None, :]
        img[..., 1] = np.linspace(0, 255, H, dtype=np.uint8)[:, None]
        img[i * 4 : i * 4 + 3, :, 2] = 255
        cv2.imwrite(str(OUT / f"{ts:.0f}.png"), img)

        # .edge: EdgeMap proto, float rows x cols in [0,1]
        em = pb2.EdgeMap()
        em.rows, em.cols = H, W
        edge = (np.abs(np.sin(0.3 * np.arange(W)))[None, :]
                * np.abs(np.cos(0.2 * np.arange(H) + i))[:, None])
        em.data.extend([float(v) for v in edge.astype(np.float32).ravel()])
        (OUT / f"{ts:.0f}.edge").write_bytes(em.SerializeToString())

        # .bbox: two boxes per frame
        bl = pb2.BoundingBoxList()
        bl.description = f"frame {i}"
        for b in range(2):
            bb = bl.bounding_boxes.add()
            bb.top_left_x = 2.0 + 3 * b + i
            bb.top_left_y = 4.0 + 2 * b
            bb.bottom_right_x = 30.0 + 3 * b + i
            bb.bottom_right_y = 40.0 + 2 * b
            bb.scores.extend([0.9 - 0.1 * b, 0.05])
            bb.class_name = "chair"
            bb.label = 62
            bb.azimuth = 0.5 + 0.1 * i
            bb.shape_id = "aeron"
            bb.azimuth_prob.extend([0.2, 0.8])
        (OUT / f"{ts:.0f}.bbox").write_bytes(bl.SerializeToString())

    # a Track so the tracks field is exercised too
    tr = ds.tracks.add()
    tr.ts = base_ts
    tl = tr.tracklets.add()
    tl.id = 7
    tl.status = 2
    tl.xp.extend([1.0, 2.0])

    (OUT / "dataset").write_bytes(ds.SerializeToString())

    # expected values for the pin test
    import json

    expect = {
        "n_frames": N_FRAMES,
        "rows": H, "cols": W,
        "fx": fx, "fy": fy, "cx": cx, "cy": cy,
        "first_ts": base_ts,
        "gwc_frame3": [float(v) for v in np.asarray(
            ds.packets[3].gwc)],
        "feat0_xw": [float(v) for v in Xw[0]],
        "n_features": N_FEATURES,
    }
    (OUT / "expected.json").write_text(json.dumps(expect, indent=1))
    print(f"wrote {OUT}: {sorted(p.name for p in OUT.iterdir())[:6]} ...")


if __name__ == "__main__":
    main()
