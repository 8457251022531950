"""Project an aligned GT point cloud into each frame -> sparse .depth files
(reference parity: example/generate_depthmaps.cpp — z-buffer min projection
+ 3x3 erode min filter, MAX_DEPTH=5 background, {rows,cols,float32} binary).
"""
from __future__ import annotations

import argparse
import os

import numpy as np

# reference constants (generate_depthmaps.cpp:9-17)
IMH, IMW = 500, 960
FX, FY, CX, CY = 486.405, 535.401, 469.199, 257.916
MAX_DEPTH = 5.0


def depth_from_pointcloud(V: np.ndarray, K: np.ndarray, g_cw: np.ndarray,
                          rows: int = IMH, cols: int = IMW) -> np.ndarray:
    """Vectorized z-buffer projection + 3x3 min filter."""
    X = (V @ g_cw[:3, :3].T + g_cw[:3, 3]) @ K.T
    z = X[:, 2]
    ok = z > 0
    u = (X[:, 0] / np.where(ok, z, 1.0)).astype(np.int32)
    v = (X[:, 1] / np.where(ok, z, 1.0)).astype(np.int32)
    ok &= (u >= 0) & (u < cols) & (v >= 0) & (v < rows)

    depth = np.full((rows, cols), MAX_DEPTH, np.float32)
    # z-buffer min via sorted scatter (last write wins -> sort descending z)
    idx = v[ok] * cols + u[ok]
    zz = z[ok]
    order = np.argsort(-zz)
    depth.reshape(-1)[idx[order]] = zz[order]

    import cv2

    return cv2.erode(depth, np.ones((3, 3), np.uint8))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("cloud", help=".xyz point cloud (3 floats per line)")
    ap.add_argument("alignment", help="result_alignment.json with T_ef_corvis")
    ap.add_argument("dataroot", help="sequence directory")
    ap.add_argument("--output", default=None, help="default: dataroot")
    args = ap.parse_args(argv)

    from visma_tpu.io import VlslamDatasetLoader, load_json, save_mat
    from visma_tpu.io.json_io import matrix_from_json

    V = np.loadtxt(args.cloud, dtype=np.float32).reshape(-1, 3)
    al = load_json(args.alignment)
    T34 = matrix_from_json(al, "T_ef_corvis", 3, 4)
    T_ef_corvis = np.eye(4)
    T_ef_corvis[:3, :4] = T34
    # move the EF cloud into the corvis world frame
    T = np.linalg.inv(T_ef_corvis)
    Vw = V @ T[:3, :3].T + T[:3, 3]

    K = np.array([[FX, 0, CX], [0, FY, CY], [0, 0, 1]])
    loader = VlslamDatasetLoader(args.dataroot)
    outdir = args.output or args.dataroot
    os.makedirs(outdir, exist_ok=True)

    for i in range(len(loader)):
        g = np.eye(4)
        g[:3, :4] = loader.pose(i)
        g_cw = np.linalg.inv(g)
        depth = depth_from_pointcloud(Vw, K, g_cw)
        stem = os.path.splitext(os.path.basename(
            loader.png_files[i]))[0] if loader.png_files else f"{i:06d}"
        save_mat(os.path.join(outdir, stem + ".depth"), depth)
    print(f"wrote {len(loader)} .depth files to {outdir}")


if __name__ == "__main__":
    main()
