"""Render a mesh's depth/mask from a json config
(reference parity: render/tools/render_depth.cpp + misc/render_depth.json:
keys image_height/width, z_near/z_far, fx/fy/cx/cy, mesh, translation,
save/output_path/mask; writes depthmap.bin / mask.bin in the {rows, cols,
data} binary format)."""
from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("config", help="json configuration")
    args = ap.parse_args(argv)

    import jax.numpy as jnp

    from visma_tpu.io import load_json, load_mesh, save_mat
    from visma_tpu.render import Intrinsics, Renderer

    cfg = load_json(args.config)
    rows = int(cfg.get("image_height", 480))
    cols = int(cfg.get("image_width", 640))
    intr = Intrinsics(
        fx=float(cfg.get("fx", 400)), fy=float(cfg.get("fy", 400)),
        cx=float(cfg.get("cx", cols / 2)), cy=float(cfg.get("cy", rows / 2)),
        rows=rows, cols=cols,
        z_near=float(cfg.get("z_near", 0.05)),
        z_far=float(cfg.get("z_far", 10.0)))

    V, F = load_mesh(cfg.get("mesh", "misc/hermanmiller_aeron.obj"))
    print(f"mesh: {len(V)} verts, {len(F)} faces")
    print("center=", V.mean(axis=0), "max=", V.max(axis=0), "min=",
          V.min(axis=0))

    r = Renderer(intr)
    r.set_mesh(V, F)
    t = np.asarray(cfg.get("translation", [0, 0, 1]), np.float32)
    pose = np.hstack([np.eye(3, dtype=np.float32), t[:, None]])

    depth = np.asarray(r.render_depth(jnp.asarray(pose)))
    # background -> z_far-ish like a GL clear; keep metric values
    depth_out = np.where(np.isfinite(depth), depth, intr.z_far).astype(
        np.float32)

    outdir = cfg.get("output_path", ".")
    os.makedirs(outdir, exist_ok=True)
    if cfg.get("save", True):
        save_mat(os.path.join(outdir, "depthmap.bin"), depth_out)
        print(f"wrote {outdir}/depthmap.bin")
        if cfg.get("mask", False):
            mask = np.asarray(r.render_mask(jnp.asarray(pose)))
            save_mat(os.path.join(outdir, "mask.bin"),
                     mask.astype(np.float32))
            print(f"wrote {outdir}/mask.bin")


if __name__ == "__main__":
    main()
