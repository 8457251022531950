"""Batch-undistort Corvis camera images to VGA-ish size
(reference parity: example/undistort_images.cpp — hardcoded ATAN calib,
600x960 -> crop solve -> keep central 500 rows; writes in place unless
--output is given)."""
from __future__ import annotations

import argparse
import os


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("directory", help="directory of .png images")
    ap.add_argument("--output", default=None,
                    help="output dir (default: overwrite in place, like the "
                         "reference)")
    ap.add_argument("--calib", default=None,
                    help="calibration file (default: hardcoded Corvis ATAN)")
    args = ap.parse_args(argv)

    import cv2
    import jax.numpy as jnp
    import numpy as np

    from visma_tpu.image.undistort import (CORVIS_ATAN_CALIB,
                                           corvis_undistorter,
                                           undistorter_from_file)
    from visma_tpu.io import glob_by_timestamp

    und = (undistorter_from_file(args.calib) if args.calib
           else corvis_undistorter())
    crop_top = CORVIS_ATAN_CALIB["crop_top"] if args.calib is None else 0
    final_rows = (CORVIS_ATAN_CALIB["final_rows"] if args.calib is None
                  else und.out_rows)

    K = und.K.copy()
    K[1, 2] -= crop_top
    print(f"output K: fx={K[0,0]:.3f} fy={K[1,1]:.3f} "
          f"cx={K[0,2]:.3f} cy={K[1,2]:.3f} rows={final_rows} "
          f"cols={und.out_cols}")

    files = glob_by_timestamp(args.directory, ".png")
    remap = jnp.asarray(und.remap)
    from visma_tpu.image import bilinear_remap

    for path in files:
        img = cv2.imread(path)
        out = np.asarray(bilinear_remap(jnp.asarray(img), remap))
        out = out[crop_top : crop_top + final_rows]
        dst = (path if args.output is None else
               os.path.join(args.output, os.path.basename(path)))
        if args.output:
            os.makedirs(args.output, exist_ok=True)
        cv2.imwrite(dst, out)
        print(dst)


if __name__ == "__main__":
    main()
