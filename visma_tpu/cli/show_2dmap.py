"""Render a {int32 h, int32 w, float32 data} binary map to an image
(reference parity: misc/show_2Dmap.py)."""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("path", help=".bin / .depth binary map file")
    ap.add_argument("--output", default=None,
                    help="save a PNG instead of showing a window")
    args = ap.parse_args(argv)

    import matplotlib

    if args.output:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from visma_tpu.io import load_mat

    data = load_mat(args.path)
    print(f"map {data.shape}, range [{data.min():.4f}, {data.max():.4f}]")
    plt.figure(figsize=(8, 5))
    plt.imshow(data)
    plt.colorbar()
    if args.output:
        plt.savefig(args.output, dpi=100, bbox_inches="tight")
        print(f"saved {args.output}")
    else:
        plt.show()


if __name__ == "__main__":
    main()
